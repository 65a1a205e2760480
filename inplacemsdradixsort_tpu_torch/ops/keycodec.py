"""Order-preserving key codecs on tensors.

The engine sorts uint32 words.  These bijections map the other key types
onto uint32 words so that the same machinery covers them, as
``inplacemsdradixsort_tpu/ops/keycodec.py`` does: int32 and float32 keys
become one order-preserving uint32 word, u64 keys two words (hi, lo)
that the engine orders lexicographically.

PyTorch on the CPU has no ``>>``, ``<=`` or ``searchsorted`` for
``uint32`` and few operators for ``uint64``, so the arithmetic runs on
``int32``/``int64`` views of the same bits and only the results are
viewed back as unsigned.  ``split_u64``/``join_u64`` reinterpret each
64-bit word as two 32-bit words (little-endian, as on x86 hosts and
NVIDIA GPUs) instead of shifting, so no int64 temporary is made.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIAS32 = -0x80000000


def encode_i32(x: torch.Tensor) -> torch.Tensor:
    """int32 -> order-preserving uint32."""
    return (x ^ _BIAS32).view(torch.uint32)


def decode_i32(u: torch.Tensor) -> torch.Tensor:
    return u.view(torch.int32) ^ _BIAS32


def encode_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> order-preserving uint32 (IEEE total order; -0 < +0,
    NaNs sort above +inf by payload, negative NaNs below -inf)."""
    i = x.view(torch.int32)
    mask = torch.where(i < 0, -1, _BIAS32).to(torch.int32)
    return (i ^ mask).view(torch.uint32)


def decode_f32(u: torch.Tensor) -> torch.Tensor:
    i = u.view(torch.int32)
    mask = torch.where(i < 0, _BIAS32, -1).to(torch.int32)
    return (i ^ mask).view(torch.float32)


def split_u64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint64 (or int64 bits) -> (hi, lo) uint32 words."""
    words = x.contiguous().view(torch.int32).view(-1, 2)
    return (words[:, 1].contiguous().view(torch.uint32),
            words[:, 0].contiguous().view(torch.uint32))


def join_u64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) uint32 words (or their int32 views) -> uint64."""
    words = torch.stack([lo.view(torch.int32), hi.view(torch.int32)], 1)
    return words.view(torch.int64).view(-1).view(torch.uint64)


def encode_i64(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """int64 -> order-preserving (hi, lo) uint32 words (sign bit flipped)."""
    return split_u64(x ^ torch.iinfo(torch.int64).min)


def decode_i64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return join_u64(hi, lo).view(torch.int64) ^ torch.iinfo(torch.int64).min

