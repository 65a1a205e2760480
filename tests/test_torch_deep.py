"""The port's deep tier (``ops/deep.py``) on the CPU: the four inputs of
``tests/test_deep.py`` (the JAX package's deep-tier tests) against
``np.lexsort``, with no whole-array fallback; ``_deep_bounds`` against the
JAX one where that one does not assert, and the port's repair where it
does (ROADMAP C).

The deep parity is held against numpy, not the JAX ``deep_sort``: that
one asserts on the first input (``deep.py:101``) and takes minutes in
interpret mode.  Inputs come from ``np.random.default_rng(7)`` as there;
every comparison is exact.
"""

import numpy as np
import pytest
import torch

from inplacemsdradixsort_tpu.ops import deep as jdeep

from inplacemsdradixsort_tpu_torch.config import SortConfig
from inplacemsdradixsort_tpu_torch.ops import deep
from inplacemsdradixsort_tpu_torch.ops import engine_v4 as te

TINY = dict(min_engine_n=1, v3_sort_rows=64, v3_rmax=8, v3_cap_rows=64)
HIS = np.array([3, 9, 17, 40, 1000, 2**31, 2**32 - 5, 77], dtype=np.uint64)


def _u64_few_hi(rng, n, nhi=8):
    hi = rng.choice(HIS[:nhi], n).astype(np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return hi, lo


def _heavy_pairs(rng, n):
    keys = np.concatenate([
        np.full(n // 2, 7, np.uint32),
        rng.integers(0, 2**32, n - n // 2, dtype=np.uint32),
    ])
    rng.shuffle(keys)
    rids = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return keys, rids


def _t(x):
    return torch.from_numpy(x.view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def test_deep_sort_u64_few_distinct_hi(rng):
    """u64 with 8 distinct hi words: every plane-0 bucket is a single
    heavy value, so every bucket re-enters keyed by the lo plane (the
    input on which the JAX deep tier asserts)."""
    n = 1 << 14
    hi, lo = _u64_few_hi(rng, n)
    te.reset_fallback_stats()
    ok, ov = deep.deep_sort(_t(hi), (_t(lo),), SortConfig(**TINY))
    got = (_u32(ok).astype(np.uint64) << 32) | _u32(ov[0])
    np.testing.assert_array_equal(got, np.sort((hi.astype(np.uint64) << 32)
                                               | lo))
    assert te.FALLBACK_STATS["overflow"] == 0
    assert te.FALLBACK_STATS["deep"] == 1


def test_deep_sort_heavy_pairs(rng):
    """A heavy key value in pairs mode: the heavy bucket re-enters keyed
    by the rid plane, the rest sorts as pairs."""
    n = 1 << 14
    keys, rids = _heavy_pairs(rng, n)
    order = np.lexsort((rids, keys))
    te.reset_fallback_stats()
    ok, ov = deep.deep_sort(_t(keys), (_t(rids),), SortConfig(**TINY))
    np.testing.assert_array_equal(_u32(ok), keys[order])
    np.testing.assert_array_equal(_u32(ov[0]), rids[order])
    assert te.FALLBACK_STATS["overflow"] == 0


def test_deep_sort_three_planes(rng):
    """u64 keys + a rid (3 planes): one hi word and a heavy lo under it,
    so the planes drop one after the other."""
    n = 1 << 13
    hi = np.full(n, 42, np.uint32)
    lo = np.concatenate([
        np.full(n // 2, 5, np.uint32),
        rng.integers(0, 2**32, n - n // 2, dtype=np.uint32),
    ])
    rng.shuffle(lo)
    rid = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    order = np.lexsort((rid, lo, hi))
    te.reset_fallback_stats()
    ok, ov = deep.deep_sort(_t(hi), (_t(lo), _t(rid)), SortConfig(**TINY))
    np.testing.assert_array_equal(_u32(ok), hi[order])
    np.testing.assert_array_equal(_u32(ov[0]), lo[order])
    np.testing.assert_array_equal(_u32(ov[1]), rid[order])
    assert te.FALLBACK_STATS["overflow"] == 0


def test_ladder_reaches_deep_not_fallback(rng):
    """The v4 retry ladder on adversarial u64 ends in the deep tier: with
    cap_rows=8 each single-hi bucket (~2048 elements plus pads) exceeds
    the XL capacity 2*8*128, so no plane-0 refinement fits it."""
    n = 1 << 14
    hi, lo = _u64_few_hi(rng, n)
    cfg = dict(TINY, v3_cap_rows=8)
    te.reset_fallback_stats()
    ok, ov = te.sort_v4(_t(hi), (_t(lo),), SortConfig(**cfg))
    got = (_u32(ok).astype(np.uint64) << 32) | _u32(ov[0])
    np.testing.assert_array_equal(got, np.sort((hi.astype(np.uint64) << 32)
                                               | lo))
    assert te.FALLBACK_STATS["overflow"] == 0
    assert te.FALLBACK_STATS["retry"] == 2
    assert te.FALLBACK_STATS["deep"] >= 1


def _sample(x, S, seed):
    return np.sort(x[np.random.default_rng(seed).integers(0, len(x), S)])


def _stats(s):
    """Quantile stats of a shared numpy sample (as the deep tier fetches
    them): the same array reaches both packages."""
    return te._stats_of_sorted(torch.from_numpy(s.view(np.int32)),
                               deep.NBQ).numpy()


def test_deep_bounds_match_jax(rng):
    """Where the reference's bounds fit the level, the port's are equal
    (the heavy-pairs input: one heavy value, thinned free bounds)."""
    keys, _ = _heavy_pairs(rng, 1 << 16)
    S = 4096
    stats = _stats(_sample(keys, S, 1))
    for rmax in (8, 32):
        jb, js = jdeep._deep_bounds(stats, S, rmax)
        tb, ts = deep._deep_bounds(stats, S, rmax)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(ts, js)
        assert 7 in tb and ts[list(tb).index(7)]


def test_deep_bounds_keep_heavy_where_jax_asserts(rng):
    """8 heavy values need 8 heavy + 8 isolation bounds + the last: 17 >
    16.  The reference asserts; the port keeps every heavy bound and
    drops the isolation bounds of the lightest heavy values (by their
    share of the sample)."""
    hi, _ = _u64_few_hi(rng, 1 << 16)
    S = 4096
    sample = _sample(hi, S, 2)
    stats = _stats(sample)
    with pytest.raises(AssertionError):
        jdeep._deep_bounds(stats, S, 16)
    bounds, single = deep._deep_bounds(stats, S, 16)
    assert len(bounds) <= 16 and bounds[-1] == 0xFFFFFFFF
    assert set(HIS.astype(np.uint32)) <= set(bounds.tolist())
    assert 6 <= int(single.sum()) < 8     # one or two lose isolation
    counts = {v: int((sample == v).sum()) for v in HIS.astype(np.uint32)}
    mixed = [v for v, s in zip(bounds, single) if v in counts and not s]
    assert mixed and min(counts[v] for v in mixed) <= min(
        counts[v] for v, s in zip(bounds, single) if v in counts and s)


def test_deep_sort_narrow_level_sorts_mixed_heavy_buckets(rng):
    """The same input through a 16-wide deep level (v3_sort_rows=32): the
    bucket that lost its isolation bound re-enters the engine mixed, and
    the result is still exact."""
    n = 1 << 14
    hi, lo = _u64_few_hi(rng, n)
    te.reset_fallback_stats()
    cfg = dict(TINY, v3_sort_rows=32)
    assert deep._deep_geometry(32) == (32, 16)
    ok, ov = deep.deep_sort(_t(hi), (_t(lo),), SortConfig(**cfg))
    got = (_u32(ok).astype(np.uint64) << 32) | _u32(ov[0])
    np.testing.assert_array_equal(got, np.sort((hi.astype(np.uint64) << 32)
                                               | lo))
    assert te.FALLBACK_STATS["overflow"] == 0


def test_deep_depth_cap_is_counted(rng):
    """At MAX_DEEP_DEPTH, and for <= 128 elements, the deep tier sorts
    with torch.sort locally and counts it."""
    keys, rids = _heavy_pairs(rng, 1000)
    te.reset_fallback_stats()
    ok, ov = deep.deep_sort(_t(keys), (_t(rids),), SortConfig(**TINY),
                            deep_depth=deep.MAX_DEEP_DEPTH)
    order = np.lexsort((rids, keys))
    np.testing.assert_array_equal(_u32(ok), keys[order])
    np.testing.assert_array_equal(_u32(ov[0]), rids[order])
    assert te.FALLBACK_STATS["deep_local"] == 1
    assert te.FALLBACK_STATS["deep"] == 0
