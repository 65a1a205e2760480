"""Public API of the PyTorch port — the reference library entry points
(the reference library's ``include/msb_64.h:37-41``, as in
``inplacemsdradixsort_tpu/api.py``):

    sort(keys, rids=None, config=..., timing=False) -> SortResult
    check(keys, rids=None, same=False)              -> checksum
    mamalloc(n, dtype, fudge, device)               -> padded buffer

This slice sorts uint32 keys only.  Payload rids, the i32/f32/u64/i64
key types and ``sort_with_indices`` raise ``NotImplementedError`` naming
the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SortConfig
from .ops import engine_v4
from .ops.kernels_v4 import LANES
from .utils.checking import check  # re-exported
from .utils.timing import PhaseTimer

__all__ = ["SortResult", "sort", "sort_with_indices", "check", "mamalloc"]


@dataclasses.dataclass
class SortResult:
    keys: torch.Tensor
    rids: Optional[torch.Tensor]
    times: List[Tuple[str, float]]          # the 10-row phase report
    # True when the engine already synchronised on the result (v4's
    # overflow-flag fetch is the completion barrier)
    synced: bool = False

    def pretty_times(self) -> str:
        out = [f"{'phase':<14}{'seconds':>12}"]
        for lbl, t in self.times:
            out.append(f"{lbl:<14}{t:>12.6f}")
        return "\n".join(out)


def mamalloc(n: int, dtype=torch.uint32, fudge: float = 1.0,
             device=None) -> torch.Tensor:
    """Zeroed, lane-aligned buffer (reference mamalloc analog,
    msb_64.c:111-115: 64-byte alignment becomes 128-lane rows)."""
    cap = int(np.ceil(n * fudge / LANES)) * LANES
    return torch.zeros(cap, dtype=dtype, device=device)


def _select_engine(cfg: SortConfig, keys: torch.Tensor) -> str:
    """``auto``: v4 on a CUDA tensor, plain ``torch.sort`` on a CPU one.
    ``v4`` on a CPU tensor runs the kernels' plain versions."""
    engine = cfg.engine
    if engine == "auto":
        return "v4" if keys.is_cuda else "torch"
    if engine not in ("v4", "torch"):
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet (ROADMAP.md A7-A13); "
            "the port has 'auto', 'v4' and 'torch'")
    return engine


def sort(
    keys,
    rids: Optional[torch.Tensor] = None,
    config: SortConfig = DEFAULT_CONFIG,
    timing: bool = False,
) -> SortResult:
    """Sort 1-D uint32 ``keys`` on the tensor's device.

    ``timing=True`` synchronises at phase edges and fills the 10-row report
    (msb_64.c:2384-2412 contract)."""
    keys = torch.as_tensor(keys)
    if rids is not None:
        raise NotImplementedError(
            "payload rids are not ported yet (ROADMAP.md A5)")
    if keys.dtype != torch.uint32:
        raise NotImplementedError(
            f"{keys.dtype} keys are not ported yet: the slice sorts "
            "torch.uint32 (keycodecs and u64 keys: ROADMAP.md A5)")
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    timer = PhaseTimer(enabled=timing)
    engine = _select_engine(config, keys)
    raw = keys.contiguous().view(torch.int32)
    if engine == "v4":
        out, _ = engine_v4.sort_v4(raw, (), config, timer=timer)
    else:
        with timer.phase("local_sort"):
            out = engine_v4._torch_fallback(raw)
            timer.sync(out)
    return SortResult(keys=out.view(torch.uint32), rids=None,
                      times=timer.report(), synced=engine == "v4")


def sort_with_indices(keys, config: SortConfig = DEFAULT_CONFIG):
    """Sorted keys + the stable sorting permutation — not ported yet."""
    raise NotImplementedError(
        "sort_with_indices needs payload planes (ROADMAP.md A5)")
