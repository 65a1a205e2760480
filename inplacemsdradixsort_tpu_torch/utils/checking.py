"""Post-hoc verification — the reference ``check()`` analog
(msb_64.c:2432-2505) for single tensors: ascending order, the optional
key == rid payload check, and the additive mod-2^64 checksum.
"""

from __future__ import annotations

from typing import Optional

import torch

_BIAS = -0x80000000


def _ordered(keys: torch.Tensor) -> torch.Tensor:
    """A signed view with the same order as ``keys`` (uint32 has no
    comparison operators on the CPU)."""
    if keys.dtype == torch.uint32:
        return keys.view(torch.int32) ^ _BIAS
    return keys


def checksum(keys: torch.Tensor) -> int:
    """Additive mod-2^64 checksum (msb_64.c:2456-2466 ``sum += key``)."""
    if keys.dtype == torch.uint32:
        words = keys.view(torch.int32).long() & 0xFFFFFFFF
    elif keys.dtype.is_floating_point:
        raise TypeError(f"checksum of {keys.dtype} is not defined")
    else:
        words = keys.long()
    # int64 sums wrap mod 2^64 (two's complement): the same bits as the
    # reference's uint64_t accumulator
    return int(words.sum().item()) % (1 << 64)


def is_sorted(keys: torch.Tensor) -> bool:
    """True iff keys are ascending (msb_64.c:2461 ``assert(key >= pkey)``)."""
    if keys.shape[0] <= 1:
        return True
    k = _ordered(keys)
    return bool((k[1:] >= k[:-1]).all().item())


def check(
    keys: torch.Tensor,
    rids: Optional[torch.Tensor] = None,
    same: bool = False,
    input_checksum=None,
) -> int:
    """Verify a sorted result; return its checksum.

    Asserts ascending order; with ``same``, asserts key == rid elementwise
    (the reference's payload-integrity trick); with ``input_checksum``,
    asserts the checksums agree."""
    if not is_sorted(keys):
        raise AssertionError("keys are not ascending")
    if same:
        if rids is None:
            raise AssertionError("same=True requires rids")
        if not bool((_ordered(keys) == _ordered(rids.to(keys.dtype)))
                    .all().item()):
            raise AssertionError("key != rid payload mismatch")
    total = checksum(keys)
    if input_checksum is not None and total != int(input_checksum) % (1 << 64):
        raise AssertionError(
            f"checksum mismatch: {total} != {int(input_checksum)}")
    return total
