"""The v1 engine's in-tile order and key bias, on PyTorch.

``bitonic_sort`` is the plain version of the sorting network inside the
reference's ``tile_sort`` and ``ragged_sort`` kernels
(``inplacemsdradixsort_tpu/ops/bitonic.py``): it orders a block of
elements ascending in flat C order, lexicographically by (key, val) as
signed int32.  Tuples equal in both are identical, so every correct sort
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
