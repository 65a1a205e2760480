"""The port's v5 engine against the JAX package and numpy.

- Planner parity (numpy only): from one shared stats array and one
  histogram, ``_bounds_hybrid``, ``_v5_geometry``, ``_v5_plan``,
  ``_seqroute_tables``, ``_plan_batches`` and ``_batch_tables`` equal the
  reference's array for array (keys only, pairs, a heavy-value plan),
  and ``permute_cycles`` follows the cycles of ``permute_schedule``.
- End to end: one keys-only case through the JAX ``sort_v5`` (interpret
  mode) and the port's, both equal to ``np.sort`` with the same fallback
  counters.  Every other case runs the port only, against numpy: the JAX
  engine with payload takes about a minute a case in interpret mode.

The port's cases run at the reference tests' geometry (64-row L1 tiles,
rmax 8) with a terminal class of 256 rows, which holds a region's pads,
so that the whole path runs without retries unless a case asks for them.
Inputs come from ``np.random.default_rng(seed)``; comparisons are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inplacemsdradixsort_tpu.config import SortConfig as JConfig
from inplacemsdradixsort_tpu.ops import engine_v4 as je4
from inplacemsdradixsort_tpu.ops import engine_v5 as je5
from inplacemsdradixsort_tpu.utils.checking import raw_check_2d as jraw

import inplacemsdradixsort_tpu_torch as rt
from inplacemsdradixsort_tpu_torch.config import SortConfig
from inplacemsdradixsort_tpu_torch.ops import engine_v4 as te4
from inplacemsdradixsort_tpu_torch.ops import engine_v5 as te5
from inplacemsdradixsort_tpu_torch.ops import plan_util
from inplacemsdradixsort_tpu_torch.utils.checking import raw_check_2d

LANES = 128
BLK = te5.BLK
REF_GEOM = dict(min_engine_n=1, v5_pitch_rows=64, v3_sort_rows=512,
                v3_rmax=8, v3_cap_rows=32)      # tests/test_engine_v5.py
V5 = SortConfig(**dict(REF_GEOM, v3_cap_rows=256))
DISTS = ["uniform", "zipf", "dup8", "sorted", "reverse", "allequal",
         "maxheavy"]


def _dist(name, n, rng):
    if name == "uniform":
        return rng.integers(0, 2**32, n, dtype=np.uint32)
    if name == "zipf":
        return rng.zipf(1.3, n).astype(np.uint32)
    if name == "dup8":
        return rng.integers(0, 8, n, dtype=np.uint32)
    if name == "sorted":
        return np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    if name == "reverse":
        return np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))[::-1].copy()
    if name == "allequal":
        return np.full(n, 0xCAFEBABE, np.uint32)
    x = np.where(rng.random(n) < 0.3, 0xFFFFFFFF,
                 rng.integers(0, 2**32, n, dtype=np.uint32))
    return x.astype(np.uint32)                  # maxheavy


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------ planners

# name: (distribution, planes, geometry kwargs)
PLAN_CASES = {
    "keys": ("uniform", 1, dict(REF_GEOM, v3_rmax=16)),
    "pairs": ("uniform", 2, dict(REF_GEOM, v3_cap_rows=256)),
    "heavy": ("maxheavy", 1, dict(REF_GEOM, v3_cap_rows=256)),
    "dup_heavy": ("dup8", 1, dict(REF_GEOM, v3_rmax=None)),
}


def _assert_same(a, b, what):
    if dataclasses.is_dataclass(a):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)


@pytest.fixture(scope="module", params=list(PLAN_CASES))
def plan_case(request):
    dist, nplanes, kw = PLAN_CASES[request.param]
    n = 6 * BLK + 777
    x = _dist(dist, n, np.random.default_rng(len(request.param)))
    jcfg, tcfg = JConfig(**kw), SortConfig(**kw)
    jg = je5._v5_geometry(n, nplanes, jcfg)
    tg = te5._v5_geometry(n, nplanes, tcfg)
    # one shared sample, one stats array (the port's _stats_of_sorted)
    rng = np.random.default_rng(99)
    S = tg.ssz
    s = np.sort(x[rng.integers(0, n, S)])
    stats = te4._stats_of_sorted(torch.from_numpy(s.view(np.int32)),
                                 tg.nbq).numpy()
    return dict(name=request.param, x=x, n=n, nplanes=nplanes, jcfg=jcfg,
                tcfg=tcfg, jg=jg, tg=tg, S=S, stats=stats)


def test_planner_geometry_and_bounds(plan_case):
    c = plan_case
    _assert_same(c["jg"], c["tg"], "geometry")
    _assert_same(
        je4._bounds_hybrid(c["stats"], c["S"], c["tg"].nb_want, c["jcfg"]),
        plan_util._bounds_hybrid(c["stats"], c["S"], c["tg"].nb_want,
                                 c["tcfg"]), "bounds")


def test_planner_tables_match(plan_case):
    """Plan, seqroute tables, batches and batch tables, array for array,
    from the histogram of the plan's L1 bounds."""
    c = plan_case
    g = c["tg"]
    args = (c["stats"], c["S"], c["nplanes"])
    jplan = je5._v5_plan(*args, c["jcfg"], g.nb_want, g.rmax)
    tplan = te5._v5_plan(*args, c["tcfg"], g.nb_want, g.rmax)
    _assert_same(jplan, tplan, "plan")
    h = np.zeros((g.ntiles1, g.rmax), np.int64)
    for t in range(g.ntiles1):
        tile = c["x"][t * g.pitch1 * LANES:(t + 1) * g.pitch1 * LANES]
        d = np.searchsorted(tplan.l1_bounds_u, tile.astype(np.uint64))
        h[t] = np.bincount(d, minlength=g.rmax)[: g.rmax]
    jt = je5._seqroute_tables(h, c["jg"], jplan)
    tt = te5._seqroute_tables(h, g, tplan)
    _assert_same(jt, tt, "seqroute tables")
    cnt, nblk, Fbase = tt[5:8]
    frac = c["tcfg"].v5_batch_frac
    jb, jbg = je5._plan_batches(c["jg"], jplan, nblk, frac)
    tb, tbg = te5._plan_batches(g, tplan, nblk, frac)
    _assert_same(jb, tb, "batches")
    _assert_same(jbg, tbg, "batch geometry")
    out_base = 0
    for batch in tb:
        _assert_same(
            je5._batch_tables(c["jg"], jplan, jbg, batch, nblk, Fbase, cnt,
                              out_base),
            te5._batch_tables(g, tplan, tbg, batch, nblk, Fbase, cnt,
                              out_base), f"batch {batch}")
        out_base += int(cnt[batch].sum())


def test_plan_cases_cover_heavy_values(plan_case):
    """The heavy cases plan value-fill regions or children (heavy1,
    drop2), the others none."""
    c = plan_case
    g = c["tg"]
    plan = te5._v5_plan(c["stats"], c["S"], c["nplanes"], c["tcfg"],
                        g.nb_want, g.rmax)
    heavy = bool(plan.heavy1.any() or plan.drop2.any())
    assert heavy == (c["name"] in ("heavy", "dup_heavy"))


@pytest.mark.parametrize("nslots,seed", [(37, 0), (300, 1), (24, 2)])
def test_permute_cycles_follow_the_schedule(nslots, seed):
    """The cycles of the reference's DMA schedule, read back from its
    entries, are the port's cycles, in the same order."""
    rng = np.random.default_rng(seed)
    src = np.arange(nslots)
    moved = rng.choice(nslots, nslots // 2, replace=False)
    src[moved] = rng.permutation(moved)
    sched = je5.permute_schedule(src).reshape(-1, 4)
    cycles, cur = [], None
    for rd, _, wr, _ in sched:
        if wr == -2:                    # a cycle's head is saved
            cur = [int(rd)]
        elif rd >= 0:                   # a move
            cur.append(int(rd))
        elif wr >= 0:                   # the head closes the cycle
            cycles.append(cur)
    off, slots = te5.permute_cycles(src)
    assert [list(slots[off[i]:off[i + 1]]) for i in range(len(off) - 1)] \
        == cycles


# ---------------------------------------------------------- end to end

def test_sort_v5_keys_only_matches_jax():
    """The reference tests' geometry: both engines take the same path
    (an L2 overflow on the first plan, a retry whose plan outgrows the
    topology, the fallback) and both equal np.sort."""
    n = 5 * BLK + 321
    x = _dist("uniform", n, np.random.default_rng(0))
    je4.reset_fallback_stats()
    jout, _ = je5.sort_v5(jnp.asarray(x), (),
                          JConfig(interpret=True, **REF_GEOM))
    te4.reset_fallback_stats()
    tout, _ = te5.sort_v5(_t(x), (), SortConfig(**REF_GEOM))
    np.testing.assert_array_equal(np.asarray(jout), np.sort(x))
    np.testing.assert_array_equal(_u(tout), np.sort(x))
    assert {k: te4.FALLBACK_STATS[k] for k in je4.FALLBACK_STATS} \
        == je4.FALLBACK_STATS


@pytest.mark.parametrize("dist", DISTS)
def test_v5_keys_only_distributions(dist):
    n = 5 * BLK + 321
    x = _dist(dist, n, np.random.default_rng(DISTS.index(dist)))
    te4.reset_fallback_stats()
    out, vals = te5.sort_v5(_t(x), (), V5)
    assert vals == ()
    np.testing.assert_array_equal(_u(out), np.sort(x))
    assert te4.FALLBACK_STATS == dict.fromkeys(te4.FALLBACK_STATS, 0)


def test_v5_pairs_lexicographic():
    rng = np.random.default_rng(10)
    n = 3 * BLK + 99
    keys = rng.integers(0, 50_000, n, dtype=np.uint32)
    rids = rng.integers(0, 2**32, n, dtype=np.uint32)
    order = np.lexsort((rids, keys))
    te4.reset_fallback_stats()
    out_k, out_v = te5.sort_v5(_t(keys), (_t(rids),), V5)
    np.testing.assert_array_equal(_u(out_k), keys[order])
    np.testing.assert_array_equal(_u(out_v[0]), rids[order])
    assert te4.FALLBACK_STATS == dict.fromkeys(te4.FALLBACK_STATS, 0)


def test_v5_batch_frac_half(monkeypatch):
    """``v5_batch_frac`` sizes the scratch arena S of one L2 batch: at 0.5
    the regions go in fewer, larger batches than at the default 0.25,
    and the pairs come out the same, equal to numpy."""
    rng = np.random.default_rng(12)
    n = 24 * BLK + 99
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    rids = rng.integers(0, 2**32, n, dtype=np.uint32)
    order = np.lexsort((rids, keys))
    plan_batches, nbatches = te5._plan_batches, []

    def spy(*args):
        out = plan_batches(*args)
        nbatches.append(len(out[0]))
        return out
    monkeypatch.setattr(te5, "_plan_batches", spy)
    for frac in (0.25, 0.5):
        te4.reset_fallback_stats()
        cfg = dataclasses.replace(V5, v5_batch_frac=frac)
        out_k, out_v = te5.sort_v5(_t(keys), (_t(rids),), cfg)
        np.testing.assert_array_equal(_u(out_k), keys[order])
        np.testing.assert_array_equal(_u(out_v[0]), rids[order])
        assert te4.FALLBACK_STATS == dict.fromkeys(te4.FALLBACK_STATS, 0)
    assert nbatches[0] > nbatches[1] >= 1, nbatches


@pytest.mark.parametrize("nplanes", [2, 4])
def test_v5_u64_planes(nplanes):
    """u64 keys as (hi, lo); with a u64 rid, (key hi, key lo, rid hi,
    rid lo): four planes."""
    rng = np.random.default_rng(nplanes)
    n = 3 * BLK + 11
    words = [rng.integers(0, 2**32, n, dtype=np.uint32)
             for _ in range(nplanes)]
    out_k, out_v = te5.sort_v5(_t(words[0]),
                               tuple(_t(w) for w in words[1:]), V5)
    order = np.lexsort(words[::-1])
    for got, w in zip((out_k,) + out_v, words):
        np.testing.assert_array_equal(_u(got), w[order])


def test_v5_five_planes_refused():
    x = _t(np.zeros(BLK, np.uint32))
    with pytest.raises(ValueError, match="1-4 planes"):
        te5.sort_v5(x, (x,) * 4, V5)


def test_v5_retry_is_lossless():
    """Half the keys one value, with a payload: the value cannot be
    value-filled, its bucket overflows every plan, the compacted W
    retries and then enters the deep tier — nothing is lost and nothing
    falls back to torch.sort."""
    rng = np.random.default_rng(12)
    n = 4 * BLK
    keys = np.concatenate([np.full(n // 2, 7, np.uint32),
                           _dist("uniform", n - n // 2, rng)])
    rng.shuffle(keys)
    rids = rng.integers(0, 2**32, n, dtype=np.uint32)
    order = np.lexsort((rids, keys))
    te4.reset_fallback_stats()
    out_k, out_v = te5.sort_v5(_t(keys), (_t(rids),), V5)
    np.testing.assert_array_equal(_u(out_k), keys[order])
    np.testing.assert_array_equal(_u(out_v[0]), rids[order])
    assert te4.FALLBACK_STATS["overflow"] == 0
    assert te4.FALLBACK_STATS["retry"] >= 1
    assert te4.FALLBACK_STATS["deep"] >= 1


def test_v5_from_chunks_exact_and_raw():
    """W assembled chunk by chunk; raw=True returns W's (w_rows, 128)
    int32 planes, whose first n elements are the result, checked slab by
    slab by raw_check_2d (its flags equal the reference's; its checksum
    is mod 2^64, the reference's mod 2^32)."""
    rng = np.random.default_rng(13)
    n = 3 * BLK + 640
    chunks = [rng.integers(0, 2**32, min(BLK, n - i * BLK), dtype=np.uint32)
              for i in range(-(-n // BLK))]
    ref = np.sort(np.concatenate(chunks))

    def chunk_fn(i):
        return (_t(chunks[i]), _t(chunks[i]))       # rids == keys

    ok, vo = te5.sort_v5_from_chunks(chunk_fn, len(chunks), n, V5)
    np.testing.assert_array_equal(_u(ok), ref)
    np.testing.assert_array_equal(_u(vo[0]), ref)

    ok2, vo2 = te5.sort_v5_from_chunks(chunk_fn, len(chunks), n, V5,
                                       raw=True)
    assert ok2.dim() == 2 and ok2.shape[1] == LANES
    assert ok2.dtype == torch.int32
    np.testing.assert_array_equal(_u(ok2).reshape(-1)[:n], ref)
    total, srt, pay = raw_check_2d(ok2, n, vo2[0], slab_rows=64)
    assert srt and pay
    assert total == int(ref.astype(np.uint64).sum()) % 2**64
    js, jsrt, jpay = jraw(jnp.asarray(ok2.numpy()), n,
                          jnp.asarray(vo2[0].numpy()), slab_rows=64)
    assert (bool(jax.device_get(jsrt)), bool(jax.device_get(jpay))) \
        == (srt, pay)
    assert int(jax.device_get(js)) % 2**32 == total % 2**32
    bad = ok2.clone()
    bad.view(-1)[5] = -1
    assert not raw_check_2d(bad, n, slab_rows=64)[1]


def test_api_sort_engine_v5():
    """api.sort(engine="v5") on CPU tensors: u32 keys with u64 rids
    (three planes), lexicographic by (key, rid)."""
    rng = np.random.default_rng(14)
    n = 3 * BLK + 5
    keys = rng.integers(0, 20_000, n, dtype=np.uint32)
    rids = rng.integers(0, 2**64, n, dtype=np.uint64)
    te4.reset_fallback_stats()
    res = rt.sort(torch.from_numpy(keys), torch.from_numpy(rids),
                  config=dataclasses.replace(V5, engine="v5"))
    order = np.lexsort((rids, keys))
    np.testing.assert_array_equal(res.keys.numpy(), keys[order])
    np.testing.assert_array_equal(res.rids.numpy(), rids[order])
    assert res.synced
    assert te4.FALLBACK_STATS == dict.fromkeys(te4.FALLBACK_STATS, 0)


def test_sort_v5_below_threshold_runs_v4():
    x = _dist("uniform", 5000, np.random.default_rng(15))
    te4.reset_fallback_stats()
    out, _ = te5.sort_v5(_t(x), (), SortConfig())
    np.testing.assert_array_equal(_u(out), np.sort(x))
    assert te4.FALLBACK_STATS["small_n"] == 1
