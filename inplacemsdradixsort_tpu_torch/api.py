"""Public API of the PyTorch port — the reference library entry points
(the reference library's ``include/msb_64.h:37-41``, as in
``inplacemsdradixsort_tpu/api.py``):

    sort(keys, rids=None, config=..., timing=False) -> SortResult
    sort_with_indices(keys, config=...)             -> (keys, permutation)
    check(keys, rids=None, same=False)              -> checksum
    check_fits(n, nplanes, device, config, held)    -> "v4" or "v5"
    mamalloc(n, dtype, fudge, device)               -> padded buffer

Keys are uint32, int32, float32, uint64 or int64; rids any integer type,
64-bit rids included.  Both are split into uint32 planes (int32/float32
through order-preserving codecs, 64-bit values as (hi, lo) words), which
the v4 engine (or, where v4 does not fit, the in-place v5 engine) sorts
lexicographically by (key, *rid words), and joined back.  Data that is
not a tensor goes to the CUDA device; a CPU tensor stays on the CPU,
where ``engine="auto"`` runs plain ``torch.sort``.

``engine="pallas"`` (the v1 MSD engine, ``ops/pallas_engine.py``) and
``engine="v3"`` (``ops/engine_v3.py``) run as the reference routes them:
uint32 keys with no rids or rids of at most 32 bits, and uint64 keys
without rids (as (hi, lo) words); every other key type, and uint64 keys
with rids, go to ``torch.sort``.  64-bit rids with uint32 keys raise
``ValueError``: the reference keeps only their low words there
(ROADMAP.md C11, C13).  ``engine="xla"`` is the reference's portable
engine (``ops/xla_engine.py``): one library sort, pairs stable by key
only.  ``engine="lsb"`` (``ops/engine_lsb.py``) takes every key type and
rids of any width as the v4 engine does, and sorts them by LSB digit
passes: stable by key only, as ``xla`` (ROADMAP.md C15).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .config import DEFAULT_CONFIG, SortConfig
from .ops import (engine_lsb, engine_v3, engine_v4, engine_v5, keycodec,
                  pallas_engine, xla_engine)
from .ops.kernels_v4 import LANES
from .utils.checking import check  # re-exported
from .utils.timing import PhaseTimer

__all__ = ["SortResult", "sort", "sort_with_indices", "check", "check_fits",
           "fits_v5", "held_bytes", "mamalloc"]

KEY_DTYPES = (torch.uint32, torch.int32, torch.float32, torch.uint64,
              torch.int64)
# v4's out-of-place working set, in bytes per element per uint32 plane
# (input + two packed arenas + output; ``inplacemsdradixsort_tpu/api.py``)
V4_BYTES_PER_PLANE_ELEM = 4.3 * 4


@dataclasses.dataclass
class SortResult:
    keys: torch.Tensor
    rids: Optional[torch.Tensor]
    times: List[Tuple[str, float]]          # the 10-row phase report
    # True when the engine already synchronised on the result (v4's
    # overflow-flag fetch is the completion barrier; v5 synchronises last)
    synced: bool = False

    def pretty_times(self) -> str:
        out = [f"{'phase':<14}{'seconds':>12}"]
        for lbl, t in self.times:
            out.append(f"{lbl:<14}{t:>12.6f}")
        return "\n".join(out)


def _card() -> torch.device:
    """The default device: the CUDA card, as the reference's arrays live
    on the accelerator.  Raises without one (pass a CPU tensor to sort on
    the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port places data that is not a tensor on "
            "the card; pass a CPU tensor (or device='cpu') to run on the "
            "CPU")
    return torch.device("cuda")


def _as_tensor(x, device=None) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    return torch.as_tensor(x, device=device or _card())


def mamalloc(n: int, dtype=torch.uint32, fudge: float = 1.0,
             device=None) -> torch.Tensor:
    """Zeroed, lane-aligned buffer on the card unless ``device`` says
    otherwise (reference mamalloc analog, msb_64.c:111-115: 64-byte
    alignment becomes 128-lane rows)."""
    cap = int(np.ceil(n * fudge / LANES)) * LANES
    return torch.zeros(cap, dtype=dtype, device=device or _card())


def _select_engine(cfg: SortConfig, keys: torch.Tensor, nplanes: int,
                   held: Optional[int] = None) -> str:
    """``auto``: on a CUDA tensor the engine ``check_fits`` picks (v4, or
    v5 where v4 does not fit), on a CPU tensor plain ``torch.sort``.
    ``v4``, ``v5``, ``v3``, ``pallas`` and ``lsb`` on a CPU tensor run
    the kernels' plain versions;
    ``v5`` on the card must pass v5's own fit check (``fits_v5``).
    ``held``: as in ``fits_v5``."""
    engine = cfg.engine
    if engine == "auto":
        if not keys.is_cuda:
            return "torch"
        return check_fits(keys.shape[0], nplanes, keys.device, cfg, held)
    if engine not in ("v4", "v5", "v3", "pallas", "xla", "lsb", "torch"):
        raise NotImplementedError(
            f"engine {engine!r} is not ported yet (ROADMAP.md A11, the "
            "distributed sort); the port has 'auto', 'v4', 'v5', 'v3', "
            "'pallas', 'xla', 'lsb' and 'torch'")
    if engine == "v5" and keys.is_cuda:
        fits_v5(keys.shape[0], nplanes, keys.device, cfg, held)
    return engine


def held_bytes(n: int, key_dtype, rid_dtype=None) -> int:
    """Device bytes ``sort`` holds beside the engine through a sort of n
    keys of ``key_dtype`` (and rids of ``rid_dtype``): the caller's
    tensors, and for each that is not passed as its own uint32 words
    (uint32 keys, 32-bit rids) the planes made from it and the output
    joined back from the engine's planes."""
    def one(dtype, own):
        size = dtype.itemsize
        return n * (size if own else 2 * size + 4 * max(1, size // 4))

    held = one(key_dtype, key_dtype == torch.uint32)
    if rid_dtype is not None:
        held += one(rid_dtype, rid_dtype.itemsize == 4)
    return held


def check_fits(n: int, nplanes: int, device=None,
               config: SortConfig = DEFAULT_CONFIG,
               held: Optional[int] = None) -> str:
    """The size switch of ``engine="auto"``: the engine that sorts n
    elements of ``nplanes`` uint32 planes on ``device``.  "v4", unless
    - the planner asks for more buckets than v4's topology holds
      (ROADMAP.md C9: 2^30 (u32 key, u64 rid) pairs want ~13,571 of
      rmax^2 = 9,216), or
    - v4's working set (4.3 x the plane bytes) is over 75% of the
      device's memory;
    then "v5", the in-place engine, as the reference's switch hands such
    inputs to it.  Raises ``ValueError`` where v5 does not fit either
    (``fits_v5``, with ``held``), and for n past ``engine_v5.MAX_N``,
    which neither engine's int32 output offsets reach."""
    engine_v5.check_n(n)
    wanted, room = engine_v4.bucket_room(n, nplanes, config)
    total = torch.cuda.mem_get_info(device)[1]
    if wanted <= room and V4_BYTES_PER_PLANE_ELEM * nplanes * n \
            <= 0.75 * total:
        return "v4"
    fits_v5(n, nplanes, device, config, held)
    return "v5"


def fits_v5(n: int, nplanes: int, device=None,
            config: SortConfig = DEFAULT_CONFIG,
            held: Optional[int] = None) -> None:
    """v5's fit check: its engine buffers (W, the scratch arena S and the
    terminal's scratch, ``engine_v5.v5_bytes``) plus ``held``, the bytes
    the caller keeps on the device through the sort (``held_bytes``; by
    default the ``nplanes`` planes themselves), against 75% of the
    device's memory.  Raises ``ValueError`` naming what does not fit,
    or for n past ``engine_v5.MAX_N``, before anything is allocated."""
    engine_v5.check_n(n)
    total = torch.cuda.mem_get_info(device)[1]
    engine = engine_v5.v5_bytes(n, nplanes, config)
    if held is None:
        held = 4 * nplanes * n
    if engine + held > 0.75 * total:
        raise ValueError(
            f"{n} elements x {nplanes} planes do not fit the in-place v5 "
            f"engine: W, S and the terminal scratch ~{engine:.4g} B plus "
            f"the caller's inputs, planes and outputs {held:.4g} B exceed "
            f"75% of the device's {total} B")


def _key_planes(keys: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Raw uint32 words (as int32) whose unsigned lexicographic order is
    the order of ``keys``."""
    if keys.dtype == torch.uint32:
        words = (keys,)
    elif keys.dtype == torch.int32:
        words = (keycodec.encode_i32(keys),)
    elif keys.dtype == torch.float32:
        words = (keycodec.encode_f32(keys),)
    elif keys.dtype == torch.uint64:
        words = keycodec.split_u64(keys)
    elif keys.dtype == torch.int64:
        words = keycodec.encode_i64(keys)
    else:
        raise TypeError(f"unsupported key dtype {keys.dtype}; the port "
                        f"sorts {', '.join(map(str, KEY_DTYPES))}")
    return tuple(w.view(torch.int32) for w in words)


def _join_keys(planes, dtype) -> torch.Tensor:
    if dtype == torch.uint32:
        return planes[0].view(torch.uint32)
    if dtype == torch.int32:
        return keycodec.decode_i32(planes[0])
    if dtype == torch.float32:
        return keycodec.decode_f32(planes[0])
    if dtype == torch.uint64:
        return keycodec.join_u64(*planes)
    return keycodec.decode_i64(*planes)


def _rid_planes(rids: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Payload planes for an integer rid tensor of any width: one uint32
    word, or (hi, lo) for 64-bit rids — values >= 2^32 round-trip
    exactly (the reference's 64-bit rids, msb_64.h:37)."""
    if rids.dtype.is_floating_point or rids.dtype.is_complex \
            or rids.dtype == torch.bool:
        raise TypeError(f"rids must be integers, got {rids.dtype}")
    if rids.element_size() == 8:
        return tuple(w.view(torch.int32) for w in keycodec.split_u64(rids))
    if rids.element_size() == 4:
        return (rids.contiguous().view(torch.int32),)
    return (rids.to(torch.int32),)


def _join_rids(planes, dtype) -> torch.Tensor:
    if len(planes) == 2:
        return keycodec.join_u64(*planes).view(dtype)
    if torch.empty((), dtype=dtype).element_size() == 4:
        return planes[0].view(dtype)
    return planes[0].to(dtype)


def sort(
    keys,
    rids=None,
    config: SortConfig = DEFAULT_CONFIG,
    timing: bool = False,
) -> SortResult:
    """Sort 1-D ``keys`` (optionally permuting ``rids`` along) on their
    device: the card, unless ``keys`` is a CPU tensor.

    - dtype uint32, int32, float32, uint64 or int64 (float32 in IEEE
      total order: -0 < +0, NaNs by payload above +inf);
    - ``rids`` any integer payload of the same length; ties of equal keys
      are ordered by rid value (a stable sort when rids are the indices,
      as in ``sort_with_indices``), except under ``engine="lsb"`` and
      ``engine="xla"``, where equal keys keep their input order;
    - ``timing=True`` synchronises at phase edges and fills the 10-row
      report (msb_64.c:2384-2412 contract).
    """
    keys = _as_tensor(keys)
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    if rids is not None:
        rids = _as_tensor(rids, keys.device)
        if rids.shape != keys.shape or rids.device != keys.device:
            raise ValueError(
                f"rids {tuple(rids.shape)} on {rids.device} do not match "
                f"keys {tuple(keys.shape)} on {keys.device}")
    timer = PhaseTimer(enabled=timing)
    if config.engine in ("pallas", "v3") and (
            keys.dtype == torch.uint32
            or (keys.dtype == torch.uint64 and rids is None)):
        return _sort_words(keys, rids, config, timer)
    if config.engine == "xla":
        return _sort_xla(keys, rids, timer)
    kplanes = _key_planes(keys.contiguous())
    vplanes = _rid_planes(rids) if rids is not None else ()
    engine = _select_engine(
        config, keys, len(kplanes) + len(vplanes),
        held_bytes(keys.shape[0], keys.dtype,
                   rids.dtype if rids is not None else None))
    if engine == "v4":
        outs, vouts = engine_v4.sort_v4(kplanes[0], kplanes[1:] + vplanes,
                                        config, timer=timer)
    elif engine == "v5":
        outs, vouts = engine_v5.sort_v5(kplanes[0], kplanes[1:] + vplanes,
                                        config, timer=timer)
    elif engine == "lsb":
        outs, vouts = engine_lsb.sort_lsb(kplanes[0], kplanes[1:] + vplanes,
                                          config, timer=timer,
                                          nkey=len(kplanes))
    else:   # "torch", and "pallas"/"v3" for the key types they do not take
        with timer.phase("local_sort"):
            outs, vouts = engine_v4._torch_fallback(
                kplanes[0], kplanes[1:] + vplanes)
            timer.sync(outs)
    nk = len(kplanes)
    out_k = _join_keys((outs,) + vouts[: nk - 1], keys.dtype)
    out_r = (_join_rids(vouts[nk - 1:], rids.dtype)
             if rids is not None else None)
    return SortResult(keys=out_k, rids=out_r, times=timer.report(),
                      synced=engine in ("v4", "v5"))


def _sort_words(keys: torch.Tensor, rids: Optional[torch.Tensor],
                config: SortConfig, timer: PhaseTimer) -> SortResult:
    """``engine="pallas"`` (``msd_sort``) or ``engine="v3"``
    (``sort_v3``) for uint32 keys (rids of at most 32 bits, carried as one
    uint32 word and returned in their dtype) and for uint64 keys without
    rids (split into (hi, lo) words: ``msd_sort_u64``, or v3's pairs
    path).  v3 synchronises on its overflow flag, so its result is
    synced."""
    v3 = config.engine == "v3"
    if keys.dtype == torch.uint64:
        hi, lo = keycodec.split_u64(keys.contiguous())
        sort_hi_lo = engine_v3.sort_v3 if v3 else pallas_engine.msd_sort_u64
        shi, slo = sort_hi_lo(hi, lo, config, timer=timer)
        return SortResult(keys=keycodec.join_u64(shi, slo), rids=None,
                          times=timer.report(), synced=v3)
    if rids is not None and rids.element_size() == 8:
        raise ValueError(
            f"engine={config.engine!r} carries rids as one uint32 word; "
            f"{rids.dtype} rids would lose their high words (the reference "
            "keeps only the low word): use engine='v4', which carries "
            "64-bit rids (ROADMAP.md C11, C13)")
    words = _rid_planes(rids)[0] if rids is not None else None
    sort_words = engine_v3.sort_v3 if v3 else pallas_engine.msd_sort
    out_k, out_r = sort_words(keys, words, config, timer=timer)
    if rids is not None:
        out_r = _join_rids((out_r.view(torch.int32),), rids.dtype)
    return SortResult(keys=out_k, rids=out_r, times=timer.report(),
                      synced=v3)


def _sort_xla(keys: torch.Tensor, rids: Optional[torch.Tensor],
              timer: PhaseTimer) -> SortResult:
    """``engine="xla"``: ``xla_engine.sort_keys`` / ``sort_pairs`` (stable
    by key only, ROADMAP.md C12) on any key type the port sorts."""
    if keys.dtype not in KEY_DTYPES:
        raise TypeError(f"unsupported key dtype {keys.dtype}; the port "
                        f"sorts {', '.join(map(str, KEY_DTYPES))}")
    with timer.phase("local_sort"):
        if rids is None:
            out_k, out_r = xla_engine.sort_keys(keys), None
        else:
            out_k, out_r = xla_engine.sort_pairs(keys, rids)
        timer.sync(out_k)
    return SortResult(keys=out_k, rids=out_r, times=timer.report())


def sort_with_indices(keys, config: SortConfig = DEFAULT_CONFIG
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted keys + the stable sorting permutation (int64 row ids).

    The reference carries explicit rowid payloads; the identity payload
    here mirrors its benchmark setup, where rids start as a permutation
    to be dragged along.  Below 2^31 rows the ids ride as one uint32
    plane."""
    keys = _as_tensor(keys)
    n = keys.shape[0]
    idx = torch.arange(n, device=keys.device,
                       dtype=torch.int32 if n < 2**31 else torch.int64)
    res = sort(keys, idx, config=config)
    return res.keys, res.rids.long()
