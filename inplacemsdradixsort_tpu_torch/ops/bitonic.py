"""The v1 engine's in-tile order and key bias, on PyTorch.

``bitonic_sort`` is the plain version of the sorting network inside the
reference's ``tile_sort`` and ``ragged_sort`` kernels
(``inplacemsdradixsort_tpu/ops/bitonic.py``): it orders a block of
elements ascending in flat C order, lexicographically by (key, val) as
signed int32.  ``bitonic_merge`` is the plain version of that module's
merge stage.  Tuples equal in both are identical, so every correct sort
gives the network's output bit for bit; this one is ``torch.sort`` on
one int64 composite.  The CUDA kernels run a bitonic network of their
own (``csrc/pallas_kernels.cu``).

Keys are int32 in the sign-biased encoding: ``bias_u32`` maps uint32
words to int32 whose signed order is their unsigned order.  The biasing
works on int32 views, since CPU torch has no ``>>`` or ``<=`` on uint32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

BIAS = -0x80000000


def bias_u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 (or raw int32 words) -> order-preserving biased int32."""
    return x.view(torch.int32) ^ BIAS


def unbias_u32(x: torch.Tensor) -> torch.Tensor:
    """Biased int32 -> the uint32 words."""
    return (x ^ BIAS).view(torch.uint32)


def bitonic_sort(key: torch.Tensor, val: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sort each block of int32 ``key`` (shape (..., rows, 128); every
    leading index is its own block) ascending in flat C order, by (key,
    val) when ``val`` rides along.  Returns new tensors of the input
    shapes."""
    shape = key.shape
    k = key.reshape(*shape[:-2], -1) if key.dim() >= 2 else key
    if val is None:
        return torch.sort(k, dim=-1).values.reshape(shape), None
    comp = (k.long() << 32) | (val.reshape(k.shape).long() - BIAS)
    comp = torch.sort(comp, dim=-1).values
    return ((comp >> 32).to(torch.int32).reshape(shape),
            ((comp & 0xFFFFFFFF) + BIAS).to(torch.int32).reshape(shape))


def bitonic_merge(key: torch.Tensor, val: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The reference's merge stage over one (rows, 128) block, rows*128 a
    power of two: compare-exchange steps at distances n/2, n/4, ..., 1 of
    the flat order, each keeping the smaller (key, val) at the lower
    index.  On a bitonic block (first half ascending, second descending)
    that sorts it ascending; on other input it gives what the network
    gives, step for step."""
    shape = key.shape
    k = key.reshape(-1).clone()
    v = None if val is None else val.reshape(-1).clone()
    n = k.numel()
    if n & (n - 1):
        raise ValueError(f"block size must be a power of two, got {n}")
    h = n >> 1
    while h >= 1:
        lo = k.view(-1, 2, h)
        a, b = lo[:, 0].clone(), lo[:, 1].clone()
        if v is None:
            swap = b < a
        else:
            vv = v.view(-1, 2, h)
            va, vb = vv[:, 0].clone(), vv[:, 1].clone()
            swap = (b < a) | ((b == a) & (vb < va))
            vv[:, 0] = torch.where(swap, vb, va)
            vv[:, 1] = torch.where(swap, va, vb)
        lo[:, 0] = torch.where(swap, b, a)
        lo[:, 1] = torch.where(swap, a, b)
        h >>= 1
    return k.reshape(shape), (None if v is None else v.reshape(shape))
