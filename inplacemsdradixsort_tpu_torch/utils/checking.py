"""Post-hoc verification — the reference ``check()`` analog
(msb_64.c:2432-2505): ascending order within each shard and across shard
boundaries, the optional key == rid payload check, and the additive
mod-2^64 checksum; ``raw_check_2d``, the same check of v5's raw 2-D
output slab by slab; and ``check_permutation``, which verifies that a
rid payload is exactly the permutation that sorts the input.
"""

from __future__ import annotations

import torch

_BIAS32 = -0x80000000
_BIAS64 = -0x8000000000000000


def _ordered(keys: torch.Tensor) -> torch.Tensor:
    """A signed view with the same order as ``keys`` (unsigned types have
    no comparison operators on the CPU)."""
    if keys.dtype == torch.uint32:
        return keys.view(torch.int32) ^ _BIAS32
    if keys.dtype == torch.uint64:
        return keys.view(torch.int64) ^ _BIAS64
    return keys


def checksum(keys: torch.Tensor) -> int:
    """Additive mod-2^64 checksum (msb_64.c:2456-2466 ``sum += key``)."""
    if keys.dtype == torch.uint32:
        words = keys.view(torch.int32).long() & 0xFFFFFFFF
    elif keys.dtype == torch.uint64:
        words = keys.view(torch.int64)
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
    keys,
    rids=None,
    same: bool = False,
    input_checksum=None,
) -> int:
    """Verify a sorted (keys, rids) result; return its checksum.

    Asserts ascending order; with ``same``, asserts key == rid elementwise
    (the reference's payload-integrity trick, where rids start equal to
    the keys); with ``input_checksum``, asserts the checksums agree.
    ``keys`` (and ``rids``) may be a list of per-shard tensors (the
    reference's per-NUMA-node arrays, include/msb_64.h:37): then the
    boundaries between shards must be ascending too."""
    shards = list(keys) if isinstance(keys, (list, tuple)) else [keys]
    rshards = (list(rids) if isinstance(rids, (list, tuple))
               else [rids] * len(shards))
    total, prev_last = 0, None
    for k, r in zip(shards, rshards):
        if not is_sorted(k):
            raise AssertionError("keys are not ascending within shard")
        if same:
            if r is None:
                raise AssertionError("same=True requires rids")
            if not bool((_ordered(k) == _ordered(r.to(k.dtype)))
                        .all().item()):
                raise AssertionError("key != rid payload mismatch")
        if k.shape[0]:
            if prev_last is not None and \
                    bool((_ordered(k[:1]) < prev_last).item()):
                raise AssertionError("cross-shard boundary out of order")
            prev_last = _ordered(k[-1:])
        total = (total + checksum(k)) % (1 << 64)
    if input_checksum is not None and total != int(input_checksum) % (1 << 64):
        raise AssertionError(
            f"checksum mismatch: {total} != {int(input_checksum)}")
    return total


def check_permutation(sorted_keys: torch.Tensor, sorted_rids: torch.Tensor,
                      orig_keys: torch.Tensor) -> bool:
    """Payload-permutation integrity: sorted_keys == orig_keys[sorted_rids].

    Stronger than the reference's key == rid trick: verifies that the rid
    payload is exactly the permutation that sorts the input."""
    gathered = orig_keys[sorted_rids.long()]
    return bool((_ordered(gathered) == _ordered(sorted_keys)).all().item())


def raw_check_2d(k: torch.Tensor, n: int, k2=None,
                 slab_rows: int = 1 << 15):
    """``check`` for raw 2-D engine output without N-sized temporaries.

    ``k`` is a (rows, 128) int32 plane of raw uint32 words whose
    row-major first n elements are the result (what
    ``engine_v5.sort_v5_from_chunks(raw=True)`` returns).  Walks it in
    slabs of ``slab_rows`` rows and returns (checksum mod 2^64, sorted,
    payload equal): ``k2``, a second plane, enables the reference's
    rids == keys integrity mode.  The reference sums mod 2^32; this one
    sums mod 2^64, as ``check`` does."""
    flat = k.reshape(-1)[:n]
    flat2 = None if k2 is None else k2.reshape(-1)[:n]
    step = slab_rows * k.shape[-1]
    total, ok, pay, prev = 0, True, True, None
    for i in range(0, n, step):
        sl = flat[i:i + step]
        o = sl ^ _BIAS32                    # unsigned order as signed
        total = (total + int((sl.long() & 0xFFFFFFFF).sum().item())) \
            % (1 << 64)
        ok &= bool((o[1:] >= o[:-1]).all().item())
        if prev is not None:
            ok &= bool((o[0] >= prev).item())
        prev = o[-1]
        if flat2 is not None:
            pay &= bool(torch.equal(sl, flat2[i:i + step]))
    return total, ok, pay
