"""The reference's portable engine (``inplacemsdradixsort_tpu/ops/
xla_engine.py``), on PyTorch: one library sort, ``engine="xla"``.

Pairs are stable by key only, as the reference's ``lax.sort(...,
num_keys=1, is_stable=True)``: equal keys keep their input order,
whatever their rids (the port's engines order them by rid, ROADMAP.md
C12).  Unsigned keys sort through a signed view with their order;
float32 keys sort as ``lax.sort`` sorts them (NaNs last, -0 equal to +0,
so ties keep their order).
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIAS32 = -0x80000000
_BIAS64 = -0x8000000000000000
# dtypes whose indexing goes through a signed view of the same width
_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
         torch.uint64: torch.int64}


def _order(keys: torch.Tensor) -> torch.Tensor:
    """A tensor torch.sort orders as ``keys`` are ordered."""
    if keys.dtype == torch.uint32:
        return keys.view(torch.int32) ^ _BIAS32
    if keys.dtype == torch.uint64:
        return keys.view(torch.int64) ^ _BIAS64
    return keys


def _take(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    if x.dtype in _VIEW:
        return x.view(_VIEW[x.dtype])[perm].view(x.dtype)
    return x[perm]


def _perm(keys: torch.Tensor) -> torch.Tensor:
    return torch.sort(_order(keys.contiguous()), stable=True).indices


def sort_keys(keys: torch.Tensor) -> torch.Tensor:
    return _take(keys.contiguous(), _perm(keys))


def sort_pairs(keys: torch.Tensor, rids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable key+payload sort: equal keys keep their input order."""
    perm = _perm(keys)
    return _take(keys.contiguous(), perm), _take(rids.contiguous(), perm)


def argsort_u32(keys: torch.Tensor) -> torch.Tensor:
    """Stable sorting permutation as uint32 row ids (n < 2^32)."""
    return _perm(keys).to(torch.int32).view(torch.uint32)
