"""The v3 engine's CPU checks against the JAX package and numpy, run
inside existing grouped tests: each added test item would push the
tier-1 collection past 383, which changes how xdist's ``load``
scheduler deals the reference's slow tests and cost three fifths of a
cold tier-1 run's passes (ROADMAP.md A0).  Hosts:
``test_torch_kernels_v4.py::test_terminal_write_matches_jax`` runs
``check_v3_kernels_match_jax`` (the v3 terminal launches that kernel);
``test_torch_api.py::test_engine_pallas_routing`` runs
``check_v3_plan_and_pipeline_match_jax`` and
``check_v3_sort_against_numpy`` (engine="v3" through the API).

Kernels (``check_v3_kernels_match_jax``): the port's v3 kernels (plain
PyTorch versions, CPU) against the JAX Pallas kernels in interpret mode,
at the reference tests' geometry (v3_sort_rows=32, v3_rmax=8,
v3_cap_rows=32, so pitch 24).

Cases: ``partition_level`` on an L1-shaped call (``bias_input``, pad sinks
cycling over 1-3 sub-bounds, a dropped range) and an L2-shaped call
(eight parents, dead tiles, a dropped range, an overflowing child);
``terminal_sort_write`` with mode-0 buckets (trimmed, empty, one whose
real count is above cap_rows*128) and value-fill buckets; keys only
and pairs.  The keys-only L1 call runs the reference kernel as it is;
every other case runs it with ``lax.sort`` as its in-tile sort
(``torch_parity.lax_network_v3``: the same order; a network compile
costs ~10 s in interpret mode, and the network is held at both levels
and the terminal by ``check_v3_plan_and_pipeline_match_jax``).

Inputs come from ``np.random.default_rng(seed)`` and reach both sides as
the same numpy arrays.  Every comparison is exact: occ, real, padcnt and
the flag; the arenas on every child's [start, start+occ) rows (the JAX
kernel leaves the rest undefined); the terminal output on the elements
the buckets write.  ``canonical_children`` is checked to see only each
child's multiset.

Engine parity (``check_v3_plan_and_pipeline_match_jax``): one numpy sample gives
one stats array (``_stats_of_sorted`` of both packages, required equal);
both ``make_plan`` must agree on it array for array and both
``_pack_tables`` layouts must be equal.  Then ``_pipeline`` runs on the
shared tables: the JAX one in interpret mode (a fresh ``jax.jit`` of it,
with its two ``partition_level`` calls recorded through
``jax.debug.callback``), the port's on the CPU, where its kernels run
their plain versions.  Keys only at n = 70,000 with the reference's
sorting network, and pairs at 6,000 with ``lax.sort`` as the reference
kernels' in-tile sort (``torch_parity.lax_network_v3``).  Exact: the
level outputs occ/real/pads/over, the arenas on every child's
[start, start+occ) rows, and the output, bitwise equal to the JAX output
and to ``np.sort`` / ``np.lexsort``.  The geometry is the reference
tests' (``tests/test_engine_v3.py``: sort_rows 32, rmax 8, cap_rows 32).

The port alone (``check_v3_sort_against_numpy``): ``api.sort(engine=
"v3")`` on the reference tests' eight distributions and stable pairs,
with u32 and u16 rids and u64 keys, the small-n fallback, an overflow
and its retry, and the ``ValueError``s of ``fudge < 1`` and of 64-bit
rids.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inplacemsdradixsort_tpu.config import SortConfig as JConfig
from inplacemsdradixsort_tpu.ops import engine_v3 as je3
from inplacemsdradixsort_tpu.ops import engine_v4 as je4
from inplacemsdradixsort_tpu.ops import kernels_v3 as jk
from torch_parity import lax_network_v3

import inplacemsdradixsort_tpu_torch as rt
from inplacemsdradixsort_tpu_torch.config import SortConfig
from inplacemsdradixsort_tpu_torch.ops import engine_v3 as te3
from inplacemsdradixsort_tpu_torch.ops import engine_v4 as te4
from inplacemsdradixsort_tpu_torch.ops import kernels_v3 as tk
from inplacemsdradixsort_tpu_torch.ops.plan_util import _bias_np

SORT_ROWS, RMAX, CAP = 32, 8, 32
PITCH = SORT_ROWS - RMAX
LANES = 128
GAP = tk.CHUNK_ROWS
SENT = 0x7FFFFFFF


def _t(a):
    return None if a is None else torch.from_numpy(
        np.array(a, dtype=np.int32))


def _j(a):
    return None if a is None else jnp.asarray(np.array(a, dtype=np.int32))


def _layout(caps):
    """Child starts with the engine's CHUNK_ROWS gap after each child
    (the TPU's chunk stores overshoot into it), and the arena rows."""
    caps = np.asarray(caps, np.int64)
    alloc = np.where(caps > 0, caps + GAP, 0)
    start = np.concatenate([[0], np.cumsum(alloc)[:-1]])
    return start.astype(np.int32), int(alloc.sum()) + GAP


def _ranges_between(rng, lo, hi, k):
    """k sorted distinct biased bounds in (lo, hi], the last = hi."""
    inner = np.unique(rng.integers(lo + 1, hi, 4 * k))[: k - 1]
    return np.concatenate([inner, [hi]]).astype(np.int32)


def _l1_case(seed, pairs):
    """Keys 0..2^32 with ties and extremes over 6 tiles (the last
    partial); 5 live L1 ranges and 3 empty ones (bound SENT repeated);
    pad values of child c cycle over group_len[c] values inside range c;
    range 2 is dropped (cap 0)."""
    rng = np.random.default_rng(seed)
    n = 6 * PITCH * LANES - 500
    raw = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    raw[1::7] = raw[::7][: len(raw[1::7])]           # ties
    raw[:4] = [0, 0xFFFFFFFF, 0x80000000, 0xFFFFFFFF]
    b = _bias_np(raw)
    qs = np.quantile(b.astype(np.int64), [0.2, 0.4, 0.55, 0.8]).astype(
        np.int64)
    bounds = np.concatenate([qs, [SENT] * 4]).astype(np.int32)
    glen = np.array([3, 1, 2, 3, 2, 1, 1, 1], np.int32)
    lo = np.concatenate([[-2**31 - 1], bounds[:-1].astype(np.int64)])
    padsrc = np.full((RMAX, RMAX), SENT, np.int32)
    for c in range(5):
        padsrc[c, :glen[c]] = _ranges_between(rng, int(lo[c]),
                                              int(bounds[c]),
                                              glen[c])[::-1]
    caps = np.full(RMAX, -(-n // LANES) + 8, np.int64)
    caps[2] = 0
    start, rows = _layout(caps)
    ntiles = -(-n // (PITCH * LANES))
    src = np.zeros(ntiles * PITCH * LANES, np.uint32)
    src[:n] = raw
    tiles = np.array([(0, t * PITCH, t * PITCH * LANES, 0)
                      for t in range(ntiles)], np.int32)
    vals = None
    if pairs:
        vals = _bias_np(rng.integers(0, 2**32, src.size, dtype=np.uint64)
                        .astype(np.uint32))
        vals[5] = SENT                                # a rid of 0xFFFFFFFF
        vals = vals.reshape(-1, LANES)
    return dict(
        src=src.view(np.int32).reshape(-1, LANES), vsrc=vals,
        tile_tbl=tiles, child_base=np.zeros(1, np.int32),
        bounds=bounds.reshape(1, RMAX), dst_start=start,
        dst_cap=caps.astype(np.int32), dst_rows=rows, pitch=PITCH,
        rmax=RMAX, parent_fill=np.array([n], np.int32),
        sink_base=(np.arange(RMAX) * RMAX).astype(np.int32),
        sink_cnt=glen, padsrc=padsrc, nsinks=RMAX * RMAX,
        pad_stride=RMAX, bias_input=True)


def _l2_case(seed, pairs):
    """Eight parent regions of biased keys inside their L1 ranges (parent
    5 empty), each cut into pitch-row tiles, plus 3 dead tiles
    (local_off 2^30); per-parent sub-bounds with trailing repeats; child
    9 dropped (cap 0), child 18 with one row for its ~5 rows of data
    (overflow)."""
    rng = np.random.default_rng(seed)
    l1 = _ranges_between(rng, -2**31, SENT, RMAX).astype(np.int64)
    l1lo = np.concatenate([[-2**31 - 1], l1[:-1]])
    occ1 = np.array([30, 5, 49, 12, 0, 0, 26, 3])
    pcap = occ1 + 4
    pstart, src_rows = _layout(pcap)
    src_rows += PITCH
    src = np.zeros((src_rows * LANES,), np.int64)
    bounds = np.zeros((RMAX, RMAX), np.int32)
    tiles = []
    for p in range(RMAX):
        lo, hi = int(l1lo[p]), int(l1[p])
        vals_p = rng.integers(lo + 1, hi + 1, occ1[p] * LANES)
        vals_p[1::5] = vals_p[::5][: len(vals_p[1::5])]     # ties
        if p == 7:
            vals_p[:3] = SENT                               # max keys
        src[pstart[p] * LANES:(pstart[p] + occ1[p]) * LANES] = vals_p
        k = 1 + p % 4
        bounds[p, :k] = _ranges_between(rng, lo, hi, k)
        bounds[p, k:] = hi
        for t in range(-(-pcap[p] // PITCH)):
            tiles.append((p, pstart[p] + t * PITCH, t * PITCH * LANES, 0))
    tiles += [(0, 0, 1 << 30, 0)] * 3
    nchild = RMAX * RMAX
    caps = np.full(nchild, 60, np.int64)
    caps[[9]] = 0
    caps[18] = 1
    start, rows = _layout(caps)
    vals = None
    if pairs:
        vals = rng.integers(-2**31, 2**31, src.size).astype(np.int32)
        vals = vals.reshape(-1, LANES)
    return dict(
        src=src.astype(np.int32).reshape(-1, LANES), vsrc=vals,
        tile_tbl=np.array(tiles, np.int32),
        child_base=(np.arange(RMAX) * RMAX).astype(np.int32),
        bounds=bounds, dst_start=start, dst_cap=caps.astype(np.int32),
        dst_rows=rows, pitch=PITCH, rmax=RMAX,
        parent_fill=(occ1 * LANES).astype(np.int32),
        sink_base=np.arange(nchild, dtype=np.int32),
        sink_cnt=np.ones(nchild, np.int32), padsrc=bounds.reshape(-1, 1),
        nsinks=nchild, pad_stride=1, bias_input=False)


def _terminal_case(seed, pairs):
    """Buckets of 1-33 rows at their arena rows (src_row + cap_rows rows
    inside the arena), contiguous ascending output offsets: trimmed
    (real < occ*128), empty (real 0), real above cap_rows*128 (written
    as cap_rows*128), occ above cap_rows, and, keys only, two value-fill
    buckets."""
    rng = np.random.default_rng(seed)
    spec = [(5, 5 * 128 - 40, 0), (0, 300, 1), (32, 32 * 128 + 500, 0),
            (3, 0, 0), (1, 100, 0), (33, 4000, 0), (0, 129, 1),
            (7, 7 * 128, 0)]
    if pairs:
        spec = [(o, r, 0) if m else (o, r, m) for o, r, m in spec]
        spec[1] = (3, 300, 0)
        spec[6] = (2, 129, 0)
    occ = np.array([s[0] for s in spec])
    real = np.array([s[1] for s in spec])
    mode = np.array([s[2] for s in spec])
    src_row = np.concatenate([[0], np.cumsum(occ + 2)[:-1]])
    rows = int(src_row[-1]) + CAP + 8
    arena = rng.integers(-2**31, 2**31, rows * LANES).astype(np.int32)
    arena[1::3] = arena[::3][: len(arena[1::3])]           # ties
    arena[:2] = [SENT, -2**31]
    varena = (rng.integers(-4, 4, rows * LANES).astype(np.int32)
              if pairs else None)
    eff = np.where(mode == 0, np.minimum(real, np.minimum(occ, CAP) * LANES),
                   real)
    off = np.concatenate([[0], np.cumsum(eff)[:-1]])
    fill = _bias_np(np.array([0xDEADBEEF if m else 0 for m in mode],
                             np.uint32))
    btbl = np.stack([src_row, occ, real, mode], 1).astype(np.int32)
    total = int(eff.sum())
    return dict(src=arena.reshape(rows, LANES),
                vsrc=None if varena is None else varena.reshape(rows, LANES),
                btbl=btbl, fillval=fill, out_off=off.astype(np.int32),
                out_rows=-(-total // LANES) + 2 * GAP + 2, cap_rows=CAP,
                unbias_output=True), total


def _check_partition(case):
    a = dict(case)
    jargs = {k: (_j(v) if isinstance(v, np.ndarray) else v)
             for k, v in a.items()}
    targs = {k: (_t(v) if isinstance(v, np.ndarray) else v)
             for k, v in a.items()}
    want = jk.partition_level(**jargs, interpret=True)
    got = tk.partition_level(**targs)
    pairs = a["vsrc"] is not None
    assert (got[1] is None) == (not pairs)
    occ = np.asarray(want[2])
    for i, name in ((2, "occ"), (3, "real"), (4, "padcnt"), (5, "over")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=name)
    start = a["dst_start"].astype(np.int64)
    for q in range(2 if pairs else 1):
        w = np.asarray(want[q]).reshape(-1)
        g = got[q].numpy().reshape(-1)
        for c in np.flatnonzero(occ):
            s = slice(start[c] * LANES, (start[c] + occ[c]) * LANES)
            np.testing.assert_array_equal(g[s], w[s], err_msg=f"plane {q} "
                                          f"child {c}")
    # canonical_children sees each child's multiset only
    planes = tuple(p for p in got[:2] if p is not None)
    base = tk.canonical_children(planes, _t(start), got[2])
    shuffled = tuple(p.clone().reshape(-1) for p in planes)
    c = int(np.argmax(occ))
    s = slice(start[c] * LANES, (start[c] + occ[c]) * LANES)
    perm = torch.from_numpy(np.random.default_rng(0).permutation(
        int(occ[c]) * LANES))
    for p in shuffled:
        p[s] = p[s][perm]
    again = tk.canonical_children(shuffled, _t(start), got[2])
    for x, y in zip(base, again):
        assert torch.equal(x, y)
    return got, want


def _check_terminal(case, total):
    jargs = {k: (_j(v) if isinstance(v, np.ndarray) else v)
             for k, v in case.items()}
    targs = {k: (_t(v) if isinstance(v, np.ndarray) else v)
             for k, v in case.items()}
    want = jk.terminal_sort_write(**jargs, interpret=True)
    got = tk.terminal_sort_write(**targs)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(
                g.numpy().reshape(-1)[:total],
                np.asarray(w).reshape(-1)[:total])
    return got


def check_v3_kernels_match_jax():
    # the L1 call against the reference kernel as it is (its network)
    got, _ = _check_partition(_l1_case(1, False))
    assert int(got[4].sum()) > 0 and got[3].numpy()[2] > 0     # dropped
    # the rest with lax.sort as the reference's in-tile sort: each network
    # compile costs ~10 s here, and the network is held at both levels and
    # the terminal by check_v3_plan_and_pipeline_match_jax
    with lax_network_v3():
        got, _ = _check_partition(_l2_case(2, False))
        assert int(got[5][0]) == 1 and int(got[2][18]) == 1    # overflow
        assert int(got[3][9]) > 0 and int(got[2][9]) == 0      # dropped
        case, total = _terminal_case(3, False)
        out, _ = _check_terminal(case, total)
        bt, off = case["btbl"], case["out_off"]
        fill = out.numpy().reshape(-1)[off[1]:off[1] + bt[1, 2]]
        assert np.all(fill.view(np.uint32) == 0xDEADBEEF)
        _check_partition(_l1_case(4, True))
        got, _ = _check_partition(_l2_case(5, True))
        assert int(got[5][0]) == 1
        _check_terminal(*_terminal_case(6, True))


# ------------------------------------------------ the engine

TINY = dict(v3_sort_rows=32, v3_rmax=8, v3_cap_rows=32)
STATIC = ("layout", "pairs", "pitch", "rmax", "nparents", "arena1_rows",
          "arena2_rows", "cap_rows", "out_rows", "n", "interpret")


def _keys(dist, n, seed):
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
    elif dist == "zipf":
        x = rng.zipf(1.3, n).astype(np.uint32)
    elif dist == "dup8":
        x = rng.integers(0, 8, n, dtype=np.uint32)
    elif dist == "sorted":
        x = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    elif dist == "reverse":
        x = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))[::-1].copy()
    elif dist == "allequal":
        x = np.full(n, 0xCAFEBABE, np.uint32)
    elif dist == "maxheavy":   # 30% of the keys are the maximum value
        x = np.where(rng.random(n) < 0.3, 0xFFFFFFFF,
                     rng.integers(0, 2**32, n, dtype=np.uint32))
        x = x.astype(np.uint32)
    elif dist == "dup3000":    # ~2 copies a value, spread over u32
        x = (rng.integers(0, 3000, n) * 1431655).astype(np.uint32)
    else:  # rowcorr
        x = ((np.arange(n, 0, -1, dtype=np.uint64) % 997)
             .astype(np.uint32) * np.uint32(44257))
    return x


def _shared_plan(x, pairs, seed):
    """One numpy sample -> one stats array -> both packages' plans."""
    n = len(x)
    cfg, jcfg = SortConfig(**TINY), JConfig(interpret=True, **TINY)
    ssz = min(int(min(max(cfg.sample_rate * n, 4096), cfg.sample_cap)), n)
    rows = max(n // LANES, 1)
    neff = max(1, min(ssz, rows))
    S = min(n, ssz) if (rows <= 1 or neff >= rows) else neff
    _, nb_want = te3._plan_geometry(n, pairs, max(cfg.fudge, 1.2), cfg)
    assert (_, nb_want) == je3._plan_geometry(n, pairs, 1.2, jcfg)
    s = np.sort(x[np.random.default_rng(seed).integers(0, n, S)])
    jstats = np.array(je4._stats_of_sorted(jnp.asarray(s), 4 * nb_want))
    tstats = te4._stats_of_sorted(torch.from_numpy(s.view(np.int32)),
                                  4 * nb_want).numpy()
    np.testing.assert_array_equal(tstats, jstats)
    jplan = je3.make_plan(n, jstats, S, pairs, jcfg)
    tplan = te3.make_plan(n, jstats, S, pairs, cfg)
    jd, td = dataclasses.asdict(jplan), dataclasses.asdict(tplan)
    assert jd.keys() == td.keys()
    for k in jd:
        np.testing.assert_array_equal(np.asarray(td[k]), np.asarray(jd[k]),
                                      err_msg=k)
    jpacked, jlayout = je3._pack_tables(jplan)
    tpacked, tlayout = te3._pack_tables(tplan)
    assert tlayout == jlayout
    np.testing.assert_array_equal(tpacked, jpacked)
    return jplan, jpacked, jlayout


def _jax_pipeline(plan, packed, layout, keys, rids):
    """The reference's ``_pipeline``, freshly traced (so that the kernel
    swap of ``lax_network_v3`` applies), with its two partition levels
    recorded."""
    rec = []
    real = je3.partition_level

    def recording(*a, **kw):
        out = real(*a, **kw)
        lvl = len(rec)
        rec.append({})
        jax.debug.callback(
            lambda *xs: rec[lvl].update(zip(
                ("dst", "vdst", "occ", "real", "pads", "over"),
                [None if x is None else np.asarray(x) for x in xs])),
            *out, ordered=True)
        return out

    fn = jax.jit(je3._pipeline.__wrapped__, static_argnames=STATIC)
    je3.partition_level = recording
    try:
        k, v, over = fn(
            jnp.asarray(keys),
            jnp.asarray(rids) if rids is not None
            else jnp.zeros((1,), jnp.uint32),
            jnp.asarray(packed), layout=layout, pairs=rids is not None,
            pitch=plan.pitch, rmax=plan.rmax, nparents=plan.nparents,
            arena1_rows=plan.arena1_rows, arena2_rows=plan.arena2_rows,
            cap_rows=plan.cap_rows, out_rows=plan.out_rows, n=plan.n,
            interpret=True)
        k = np.asarray(k)
        v = np.asarray(v) if rids is not None else None
        jax.effects_barrier()
    finally:
        je3.partition_level = real
    return k, v, int(over), rec


def _check_pipeline(x, rids, seed):
    pairs = rids is not None
    plan, packed, layout = _shared_plan(x, pairs, seed)
    with lax_network_v3() if pairs else contextlib.nullcontext():
        jk, jv, jover, jrec = _jax_pipeline(plan, packed, layout, x, rids)
    trec = []
    tk, tv, tover = te3._pipeline(
        torch.from_numpy(x.view(np.int32)),
        torch.from_numpy(rids.view(np.int32)) if pairs else None,
        te3._unpack(torch.from_numpy(packed), layout), pairs=pairs,
        pitch=plan.pitch, rmax=plan.rmax, nparents=plan.nparents,
        arena1_rows=plan.arena1_rows, arena2_rows=plan.arena2_rows,
        cap_rows=plan.cap_rows, out_rows=plan.out_rows, n=plan.n,
        record=trec)
    assert len(jrec) == len(trec) == 2
    starts = (plan.l1_dst_start, plan.l2_dst_start)
    for lvl, (want, got) in enumerate(zip(jrec, trec)):
        for i, name in enumerate(("occ", "real", "pads", "over"), 2):
            np.testing.assert_array_equal(got[i].numpy(), want[name],
                                          err_msg=f"L{lvl + 1} {name}")
        occ = want["occ"]
        for q, name in enumerate(("dst", "vdst")[: 1 + pairs]):
            w, g = want[name].reshape(-1), got[q].numpy().reshape(-1)
            for c in np.flatnonzero(occ):
                s = slice(starts[lvl][c] * LANES,
                          (starts[lvl][c] + occ[c]) * LANES)
                np.testing.assert_array_equal(g[s], w[s], err_msg=(
                    f"L{lvl + 1} {name} child {c}"))
    assert tover.item() == jover == 0
    np.testing.assert_array_equal(tk.numpy().view(np.uint32), jk)
    order = np.lexsort((rids, x)) if pairs else np.argsort(x, kind="stable")
    np.testing.assert_array_equal(jk, x[order])
    if pairs:
        np.testing.assert_array_equal(tv.numpy().view(np.uint32), jv)
        np.testing.assert_array_equal(jv, rids[order])
    return plan, jrec


def check_v3_plan_and_pipeline_match_jax():
    x = _keys("uniform", 70_000, 61)
    plan, rec = _check_pipeline(x, None, 62)
    assert plan.l2_tiles.shape[0] > int((plan.l2_tiles[:, 2] < 1 << 30)
                                        .sum())            # dead tiles
    assert rec[0]["pads"].sum() > 0 and rec[1]["pads"].sum() > 0
    # pairs: many equal keys with random rids (lexicographic ties)
    x = _keys("dup3000", 6_000, 63)
    r = np.random.default_rng(64).integers(0, 2**32, len(x),
                                           dtype=np.uint32)
    _check_pipeline(x, r, 65)


# ------------------------------------------------ the port alone

DISTS = ["uniform", "zipf", "dup8", "sorted", "reverse", "allequal",
         "maxheavy", "rowcorr"]


def _sort(x, rids=None, **kw):
    cfg = SortConfig(engine="v3", **{**TINY, **kw})
    return rt.sort(torch.from_numpy(x),
                   None if rids is None else torch.from_numpy(rids),
                   config=cfg)


def check_v3_sort_against_numpy():
    n = 70_000
    for i, dist in enumerate(DISTS):
        x = _keys(dist, n, 70 + i)
        te4.reset_fallback_stats()
        res = _sort(x)
        assert res.keys.dtype == torch.uint32 and res.synced
        np.testing.assert_array_equal(res.keys.numpy(), np.sort(x), dist)
        assert te4.FALLBACK_STATS["small_n"] == 0, dist
    # stable pairs (the reference test's input): rids are the indices;
    # as u16 they wrap, and ties are ordered by rid value
    x = np.random.default_rng(7).integers(0, 500, n, dtype=np.uint32)
    for dt in (np.uint32, np.uint16):
        r = np.arange(n).astype(dt)
        order = np.lexsort((r, x))
        res = _sort(x, r)
        assert res.rids.dtype == torch.from_numpy(r).dtype
        np.testing.assert_array_equal(res.keys.numpy(), x[order])
        np.testing.assert_array_equal(res.rids.numpy(), r[order])
    # uint64 keys through the (hi, lo) pairs path
    rng = np.random.default_rng(8)
    k64 = rng.integers(0, 2**64, n, dtype=np.uint64)
    k64[::3] = (k64[::3] & np.uint64(0xFFFFFFFF)) | np.uint64(5 << 32)
    k64[:2] = [2**64 - 1, 0]
    res = _sort(k64)
    np.testing.assert_array_equal(res.keys.numpy(), np.sort(k64))
    # below 2^16: torch.sort, whatever min_engine_n says
    te4.reset_fallback_stats()
    x = _keys("uniform", 1000, 9)
    np.testing.assert_array_equal(_sort(x, min_engine_n=1).keys.numpy(),
                                  np.sort(x))
    assert te4.FALLBACK_STATS["small_n"] == 1
    # an overflow, then one retry with fudge x 1.6 that fits: the sample is
    # the first 4,096 keys at this n, and a tenth of the later keys are
    # moved into the lowest sixteenth of the key space, so the first plan
    # gives those children too little room
    rng = np.random.default_rng(10)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    moved = rng.random(n) < 0.1
    moved[:4096] = False
    x[moved] = rng.integers(0, 2**28, int(moved.sum()), dtype=np.uint32)
    te4.reset_fallback_stats()
    np.testing.assert_array_equal(_sort(x, v3_rmax=16).keys.numpy(),
                                  np.sort(x))
    assert te4.FALLBACK_STATS["retry"] == 1
    assert te4.FALLBACK_STATS["overflow"] == te4.FALLBACK_STATS["plan"] == 0
    # refusals
    with pytest.raises(ValueError, match="fudge"):
        SortConfig(fudge=0.5)
    with pytest.raises(ValueError, match="'v4'"):
        _sort(x, rng.integers(0, 2**40, n, dtype=np.uint64))
