"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode).  The file imports torch and numpy only, so it
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import functools
import inspect

import numpy as np
import pytest
import torch

from inplacemsdradixsort_tpu_torch import SortConfig, sort, sort_with_indices
from inplacemsdradixsort_tpu_torch.ops import (chunked, deep, engine_v4,
                                               engine_v5)
from inplacemsdradixsort_tpu_torch.ops import kernels_v3 as kv3
from inplacemsdradixsort_tpu_torch.ops import kernels_v4 as kv4
from inplacemsdradixsort_tpu_torch.ops import kernels_v5 as kv5
from inplacemsdradixsort_tpu_torch.ops import pallas_engine
from inplacemsdradixsort_tpu_torch.ops import pallas_kernels as pk

pytestmark = pytest.mark.cuda

LANES = 128
TINY = dict(v3_sort_rows=32, v3_rmax=8, v3_cap_rows=32, min_engine_n=1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _keys(n, seed, dist="uniform"):
    rng = np.random.default_rng(seed)
    if dist == "dup8":
        return rng.integers(0, 8, n, dtype=np.uint32)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    if dist == "maxheavy":
        x[rng.random(n) < 0.3] = 0xFFFFFFFF
    return x


@pytest.mark.parametrize("dist", ["uniform", "dup8", "maxheavy"])
@pytest.mark.parametrize("geom", [TINY, dict(v3_sort_rows=128, v3_rmax=48,
                                             v3_cap_rows=64,
                                             min_engine_n=1)])
def test_sort_tiny_geometry_on_card(cuda, dist, geom):
    """Small buckets: the terminal's shared-memory path, both levels."""
    x = _keys(70_000, 1, dist)
    kv4.reset_launches()
    res = sort(torch.from_numpy(x).to(cuda),
               config=SortConfig(engine="v4", **geom))
    np.testing.assert_array_equal(res.keys.cpu().numpy(), np.sort(x))
    # the deep tier's splice_runs is the only range-mode kernel a
    # keys-only sort skips (the ".digit" and ".accumulate" modes are the
    # LSB and chunked sorts')
    assert all(v for k, v in kv4.LAUNCHES.items()
               if k != "splice_runs" and "." not in k), kv4.LAUNCHES


@pytest.mark.parametrize("dist", ["uniform", "zipf", "sorted", "dup8"])
def test_sort_default_geometry_odd_n(cuda, dist):
    """Default geometry, n not a multiple of 128, skewed and presorted
    inputs: bitwise equal to torch.sort on the card."""
    n = (1 << 22) + 77
    rng = np.random.default_rng(7)
    x = {"uniform": lambda: rng.integers(0, 2**32, n, dtype=np.uint32),
         "zipf": lambda: rng.zipf(1.1, n).astype(np.uint32),
         "sorted": lambda: np.sort(rng.integers(0, 2**32, n,
                                                dtype=np.uint32)),
         "dup8": lambda: rng.integers(0, 8, n, dtype=np.uint32)}[dist]()
    keys = torch.from_numpy(x).to(cuda)
    engine_v4.reset_fallback_stats()
    res = sort(keys)
    want = torch.sort(keys.view(torch.int32) ^ -0x80000000).values \
        ^ -0x80000000
    assert torch.equal(res.keys.view(torch.int32), want)
    assert engine_v4.FALLBACK_STATS["small_n"] == 0


def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(t) for t in x)
    return x


KV4_WRAPPERS = ("hist_level", "route_level", "terminal_write", "splice_runs")


def _record(fn):
    """Run ``fn`` with every kernel wrapper recording its inputs; return
    (the wrappers, the recorded calls)."""
    calls = []
    wrappers = {k: getattr(kv4, k) for k in KV4_WRAPPERS}

    def rec(name):
        def run(*a, **kw):
            calls.append((name, [_clone(t) for t in a],
                          {k: _clone(v) for k, v in kw.items()}))
            return wrappers[name](*a, **kw)
        return run
    for k in wrappers:
        setattr(kv4, k, rec(k))
    try:
        fn()
    finally:
        for k, f in wrappers.items():
            setattr(kv4, k, f)
    return wrappers, calls


def _replay(wrappers, calls):
    """Rerun every recorded kernel call and its plain version on the same
    CUDA tensors; both must agree exactly."""
    for name, a, kw in calls:
        if name == "hist_level":
            got = (wrappers[name](*a, **kw),)
            want = (kv4.hist_level_ref(*a, **kw),)
        elif name == "route_level":
            before = kw.get("arenas")
            got = wrappers[name](*a, **dict(kw, arenas=_clone(before)))
            want = kv4.route_level_ref(*a, **dict(kw, arenas=_clone(before)))
            rix, _ = kv4.run_rows(a[4], a[3])
            if before is not None:      # accumulate: other rows unchanged
                keep = torch.ones(a[6], dtype=torch.bool, device=rix.device)
                keep[rix] = False
                assert all(torch.equal(g[keep], b[keep])
                           for g, b in zip(got, before)), (name, kw.keys())
            if kw.get("digit_shift") is not None:
                # stable digit mode: every run row bit for bit
                got, want = (tuple(t[rix] for t in x) for x in (got, want))
            else:
                got, want = (kv4.canonical_runs(x, a[4], a[3], a[6])
                             for x in (got, want))
        elif name == "terminal_write":
            src, btbl, out, cap = a
            got = wrappers[name](src, btbl, _clone(out), cap, **kw)
            want = kv4.terminal_write_ref(src, btbl, _clone(out), cap, **kw)
        else:
            got, want = wrappers[name](*a, **kw), kv4.splice_runs_ref(*a, **kw)
            off = a[1][:, 5].long() + a[1][:, 2].long()
            end = int(off.max().item()) if off.numel() else 0
            got, want = (tuple(t[:end] for t in x) for x in (got, want))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (name, kw)


def _level_call(cuda, rng, nplanes, rmax, nels, keys=None, bias=False,
                digit=None, drop=(), accumulate=False, offset=0,
                narrow=False):
    """One hist_level and one route_level call on tiles of ``nels``
    elements (tile t at row t * pitch of the planes, parent t % 2), each
    held against its plain version as ``_replay`` does.  ``keys(n)``
    makes plane 0 (default uniform); bounds lie below 2^30, so the
    largest keys are above every bound; ``narrow`` draws bounds (with
    repeats) and keys from a span of a few thousand values, as an L2
    tile's parent has them.  ``digit`` = (shift, bits,
    plane) runs the digit modes; ``drop`` lists the ranges whose runs are
    not stored ("heavy": each tile's largest); ``accumulate`` routes into
    random arenas with a free row between runs; ``offset`` moves every
    plane one element off its 16-byte alignment."""
    pitch = max(1, -(-max(nels) // LANES))
    ntiles, n = len(nels), len(nels) * pitch * LANES
    planes = [rng.integers(-2**31, 2**31, n + offset, dtype=np.int64)
              .astype(np.int32) for _ in range(nplanes)]
    if keys is not None:
        planes[0][offset:] = keys(n)
    elif narrow:
        planes[0][offset:] = rng.integers(900, 4100, n)
    srcs = tuple(torch.from_numpy(p).to(cuda)[offset:] for p in planes)
    meta = torch.tensor([[t % 2, t * pitch, nel] for t, nel in
                         enumerate(nels)], dtype=torch.int32,
                        device=cuda).reshape(-1)
    shift, bits, dp = digit if digit else (None, 0, 0)
    if digit:
        bounds = torch.arange(rmax, dtype=torch.int32, device=cuda)
    else:
        lo, hi = (1000, 4000) if narrow else (-2**31, 2**30)
        bounds = torch.from_numpy(np.sort(rng.integers(
            lo, hi, (2, rmax)), axis=1).astype(np.int32)) \
            .to(cuda).reshape(-1)
    mode = dict(bias_input=bias, digit_shift=shift, digit_bits=bits)
    hargs = [srcs[dp], meta, bounds, ntiles, pitch, rmax]
    cnt = kv4.hist_level_ref(*hargs, **mode)
    keep = torch.ones_like(cnt, dtype=torch.bool)
    if drop == "heavy":
        keep[torch.arange(ntiles), cnt.argmax(1)] = False
    elif drop:
        keep[:, list(drop)] = False
    rows = torch.where(keep, (cnt.long() + LANES - 1) // LANES + 1, 0)
    dst = torch.where(keep, torch.cumsum(rows.reshape(-1), 0).view_as(rows)
                      - rows, -1).to(torch.int32)
    dst_rows = max(int(rows.sum().item()), 1)
    padv = torch.from_numpy(rng.integers(-2**31, 2**31, (ntiles, rmax))
                            .astype(np.int32)).to(cuda)
    arenas = tuple(torch.from_numpy(rng.integers(
        -2**31, 2**31, (dst_rows, LANES)).astype(np.int32)).to(cuda)
                   for _ in srcs) if accumulate else None
    _replay({k: getattr(kv4, k) for k in ("hist_level", "route_level")},
            [("hist_level", hargs, mode),
             ("route_level", [srcs, meta, bounds, cnt, dst, padv, dst_rows,
                              ntiles, pitch, rmax],
              dict(mode, digit_plane=dp, arenas=arenas))])


def _check_level_edges(cuda, nplanes):
    """hist_level and route_level with ``nplanes`` planes at their edges:
    tiles shorter than a chunk, one element past one, a partial third
    chunk, empty and of 3 elements (no 16-byte vector); bounds and keys
    in a narrow span, all keys in one range, all above every bound, a
    dropped heavy range, dropped ranges
    in accumulate mode (unowned rows unchanged), bias_input on planes off
    their 16-byte alignment; rmax 1, the widest with per-warp count
    tables and the widest that runs (one shared table); the digit modes
    with digits >= rmax, a heavy digit, rmax 1 and the widest digit
    route (11-bit digits, those past rmax counted nowhere)."""
    rng = np.random.default_rng(60 + nplanes)
    c = kv4.ROUTE_CHUNK
    edges = [1000, c + 1, 2 * c + 5, 0, 3]
    warp_max, flat_max, digit_max = (
        kv4.route_max_rmax(False, kv4.ROUTE_WARPS),
        kv4.route_max_rmax(False, 1), kv4.route_max_rmax(True,
                                                         kv4.ROUTE_WARPS))

    def const(v, frac=1.0):
        def make(n):
            x = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(
                np.int32)
            x[rng.random(n) < frac] = v
            return x
        return make
    cases = [dict(rmax=96, nels=edges),
             dict(rmax=96, nels=edges, narrow=True),
             dict(rmax=96, nels=edges, bias=True, offset=1),
             dict(rmax=96, nels=edges, keys=const(12345)),
             dict(rmax=96, nels=edges, keys=const(2**31 - 1)),
             dict(rmax=96, nels=edges, keys=const(-7, 0.5), drop="heavy"),
             dict(rmax=96, nels=edges, drop=(0, 5, 95), accumulate=True),
             dict(rmax=1, nels=edges),
             dict(rmax=warp_max, nels=[c + 1, 1000]),
             dict(rmax=flat_max, nels=[c + 1, 1000], keys=const(5, 0.3)),
             dict(rmax=256, nels=edges, digit=(0, 8, nplanes - 1)),
             dict(rmax=200, nels=edges, digit=(24, 8, 0), offset=1),
             dict(rmax=256, nels=edges, digit=(8, 8, 0),
                  keys=const(0xAB00, 0.7)),
             dict(rmax=1, nels=edges, digit=(28, 4, 0)),
             dict(rmax=digit_max, nels=[c + 1], digit=(21, 11, 0))]
    for case in cases:
        _level_call(cuda, rng, nplanes, **case)


def test_kernels_match_plain_versions(cuda):
    """Record one tiny-geometry sort's kernel calls; rerun each kernel and
    its plain version on the same CUDA tensors.  Then the v3 kernels
    (``_check_v3_on_card``), the LSB engine (``_check_lsb_on_card``) and
    the chunked sort (``_check_chunked_on_card``), and the level
    kernels' edges, keys only (``_check_level_edges``)."""
    x = torch.from_numpy(_keys(70_000, 2).view(np.int32)).to(cuda)
    wrappers, calls = _record(
        lambda: engine_v4.sort_v4(x, (), SortConfig(**TINY)))
    assert {c[0] for c in calls} == set(wrappers) - {"splice_runs"}
    _replay(wrappers, calls)
    _check_v3_on_card(cuda)
    _check_lsb_on_card(cuda)
    _check_chunked_on_card(cuda)
    _check_level_edges(cuda, 1)


@pytest.mark.parametrize("nvals", [1, 2, 3])
def test_multiplane_kernels_match_plain_versions(cuda, nvals):
    """A pairs sort with 1-3 payload planes (u32 rid; u64 rid; u64 key +
    u64 rid): every kernel call equal to its plain version; then the
    level kernels' edges with 2-4 planes (``_check_level_edges``)."""
    planes = [torch.from_numpy(_keys(70_000, 10 + p).view(np.int32))
              .to(cuda) for p in range(1 + nvals)]
    wrappers, calls = _record(lambda: engine_v4.sort_v4(
        planes[0], tuple(planes[1:]), SortConfig(**TINY)))
    assert {c[0] for c in calls} == set(wrappers) - {"splice_runs"}
    _replay(wrappers, calls)
    _check_level_edges(cuda, 1 + nvals)


def test_deep_kernels_match_plain_versions(cuda):
    """The deep tier on u64 keys with 8 distinct hi words: its route and
    splice calls equal their plain versions.  Then the level kernels on
    tiles of the engines' geometry (928 rows, rmax 96) with half the keys
    one value, its range stored and dropped."""
    rng = np.random.default_rng(3)
    n = 1 << 18
    hi = rng.choice(np.array([3, 9, 17, 40, 1000, 2**31, 2**32 - 5, 77],
                             np.uint32), n)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    p = [torch.from_numpy(a.view(np.int32)).to(cuda) for a in (hi, lo)]
    wrappers, calls = _record(
        lambda: deep.deep_sort(p[0], (p[1],), SortConfig()))
    assert "splice_runs" in {c[0] for c in calls}
    _replay(wrappers, calls)
    heavy = rng.integers(0, 2**31, 1 << 18).astype(np.int32)
    heavy[rng.random(heavy.size) < 0.5] = 777
    for drop in ((), "heavy"):
        _level_call(cuda, rng, 2, 96, [928 * LANES, 928 * LANES - 77],
                    keys=lambda n: heavy[:n], drop=drop)


@pytest.mark.parametrize("kind", ["pairs_u64", "u64", "i64", "f32", "i32",
                                  "heavy_pairs", "few_hi"])
def test_api_types_on_card(cuda, kind):
    """Every key type and 64-bit rids through api.sort on the card, equal
    to numpy's lexicographic (key, rid) order."""
    rng = np.random.default_rng(5)
    n = (1 << 20) + 3
    rid = rng.integers(0, 2**64, n, dtype=np.uint64)
    if kind in ("pairs_u64", "heavy_pairs"):
        key = rng.integers(0, 2**32, n, dtype=np.uint32)
        if kind == "heavy_pairs":
            key[rng.random(n) < 0.5] = 7
    elif kind == "u64":
        key = rng.integers(0, 2**64, n, dtype=np.uint64)
    elif kind == "few_hi":
        key = (rng.choice(np.array([3, 9, 2**31], np.uint64), n)
               << np.uint64(32)) | rng.integers(0, 2**32, n, np.uint64)
        rid = None
    elif kind == "i64":
        key = rng.integers(-2**63, 2**63, n, dtype=np.int64)
    elif kind == "f32":
        key = rng.normal(size=n).astype(np.float32)
        key[:4] = [0.0, -0.0, np.inf, -np.inf]
    else:
        key = rng.integers(-2**31, 2**31, n, dtype=np.int32)
    engine_v4.reset_fallback_stats()
    res = sort(torch.from_numpy(key).to(cuda),
               None if rid is None else torch.from_numpy(rid).to(cuda))
    order_key = key.view(np.uint32) if kind == "f32" else key
    if kind == "f32":     # IEEE total order through the bits
        u = key.view(np.int32)
        order_key = np.where(u < 0, ~u, u ^ np.int32(-2**31)).view(np.uint32)
    order = (np.argsort(order_key, kind="stable") if rid is None
             else np.lexsort((rid, order_key)))
    np.testing.assert_array_equal(res.keys.cpu().numpy().view(np.uint8),
                                  key[order].view(np.uint8))
    if rid is not None:
        np.testing.assert_array_equal(res.rids.cpu().numpy(), rid[order])
    assert engine_v4.FALLBACK_STATS["overflow"] == 0
    if kind in ("heavy_pairs", "few_hi"):
        assert engine_v4.FALLBACK_STATS["deep"] >= 1


def test_sort_with_indices_on_card(cuda):
    x = torch.from_numpy(_keys(1 << 20, 9, "dup8")).to(cuda)
    keys, perm = sort_with_indices(x)
    want = torch.sort(x.view(torch.int32), stable=True).indices
    assert torch.equal(perm, want)
    assert torch.equal(keys.view(torch.int32), x.view(torch.int32)[perm])


def _terminal_caps(nplanes):
    """A class capacity (rows) for every cluster size of the terminal's
    cluster path, 1-16 CTAs, and the smallest one past it (the global
    path)."""
    caps = [1 << (kv4.CS_CTA_LOG[nplanes] - 7 + b) for b in range(6)]
    assert [kv4.terminal_path(nplanes, c) for c in caps] == \
        [("cluster", 1 << b) for b in range(5)] + [("global", 0)]
    return caps


def _terminal_check(cuda, srcs, btbl, outs, cap, class_id=None):
    want = kv4.terminal_write_ref(srcs, btbl, tuple(o.clone() for o in outs),
                                  cap, class_id)
    got = kv4.terminal_write(tuple(s.to(cuda) for s in srcs), btbl.to(cuda),
                             tuple(o.to(cuda) for o in outs), cap, class_id)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), \
        (len(srcs), cap, kv4.terminal_path(len(srcs), cap))


@pytest.mark.parametrize("nplanes", [2, 3, 4])
def test_terminal_global_path_multiplane(cuda, nplanes):
    """A bucket of 3000 rows (above every shared tile) with plane-0 ties
    broken by the lower planes and SENT keys in its real prefix: at a
    capacity of 4096 rows it takes the global path; then the same bucket
    at the capacity of every cluster size (1-16 CTAs; the class capacity
    clamps it), real not a multiple of 128."""
    rng = np.random.default_rng(nplanes)
    occ = 3000
    planes = [rng.integers(-2**31, 2**31, (occ + 8) * LANES)
              .astype(np.int32) for _ in range(nplanes)]
    planes[0] //= 1 << 20                     # many plane-0 ties
    planes[0][4 * LANES + 50:4 * LANES + 90] = 0x7FFFFFFF   # SENT keys
    srcs = tuple(torch.from_numpy(p) for p in planes)
    assert kv4.terminal_path(nplanes, 4096) == ("global", 0)
    for cap in [4096] + _terminal_caps(nplanes):
        real = min(occ, cap) * LANES - 17
        btbl = torch.tensor([[4, occ, real, 0, 0, 3, 0, 0]],
                            dtype=torch.int32)
        outs = tuple(torch.zeros(real + 8, dtype=torch.int32)
                     for _ in planes)
        _terminal_check(cuda, srcs, btbl, outs, cap)


@pytest.mark.parametrize("occ", [1, 127, 128, 129, 1500, 4096])
def test_terminal_global_path(cuda, occ):
    """One bucket per size: up to 2^19 keys (the XL class at n >= 2^28),
    including lengths that are not a power of two, with a value-fill
    bucket beside it; at a capacity of 4096 rows (16 CTAs a bucket) and
    at the capacity of every other cluster size and of the global path
    (8192 rows)."""
    rng = np.random.default_rng(occ)
    arena = rng.integers(-2**31, 2**31, (occ + 8) * LANES).astype(np.int32)
    arena[4 * LANES:4 * LANES + 100] = 0x7FFFFFFF   # SENT keys
    src = torch.from_numpy(arena)
    for cap in [4096] + _terminal_caps(1):
        real = min(occ, cap) * LANES - 17
        btbl = torch.tensor([[4, occ, real, 0, 0, 3, 0, 0],
                             [0, 0, 5, 1, 12345, 3 + real, 0, 0]],
                            dtype=torch.int32)
        out0 = torch.zeros(real + 8 + 5, dtype=torch.int32)
        _terminal_check(cuda, (src,), btbl, (out0,), cap, 0)


@pytest.mark.parametrize("nplanes", [1, 3])
def test_terminal_scratch_several_large_buckets(cuda, nplanes):
    """One launch with several buckets above the shared tile, one below
    it and one of another class: at the first capacity past the largest
    cluster (the global path) each large bucket sorts in its own packed
    scratch segment; the same table on the cluster path at 4096 (1
    plane: 16 CTAs), 1024 and 256 rows (buckets of classes 0 and 1
    interleaved, every class and class 1 alone); then every plane count
    at its largest cluster with buckets of three classes interleaved,
    one of them exactly half the class's network."""
    rng = np.random.default_rng(40 + nplanes)
    occs = np.array([300, 40, 1000, 129, 500])
    src_row = np.cumsum(occs) - occs
    real = occs * LANES - 3
    off = np.cumsum(real) - real
    z = np.zeros(len(occs), np.int64)
    btbl = torch.from_numpy(np.stack(
        [src_row, occs, real, z, z, off, [0, 0, 0, 0, 1], z],
        1).astype(np.int32))
    srcs = tuple(torch.from_numpy(rng.integers(
        -2**31, 2**31, int(occs.sum()) * LANES).astype(np.int32) // 4096)
        for _ in range(nplanes))
    outs = tuple(torch.zeros(int(real.sum()), dtype=torch.int32)
                 for _ in range(nplanes))
    gcap = _terminal_caps(nplanes)[5]
    assert kv4.terminal_path(nplanes, gcap) == ("global", 0)
    for cap in sorted({gcap, 4096}, reverse=True):
        _terminal_check(cuda, srcs, btbl, outs, cap, 0)
    for cap, cls in ((1024, 0), (1024, None), (256, 1)):
        bt = btbl.clone()
        bt[:, 2] = torch.minimum(bt[:, 2], bt[:, 1].clamp(max=cap) * LANES
                                 - 3)
        _terminal_check(cuda, srcs, bt, outs, cap, cls)
    for np_ in (1, 2, 3, 4):
        cap = _terminal_caps(np_)[4]
        occs = np.array([cap, 7, cap // 2 + 1, 3, cap - 1, cap // 4, 2 * cap,
                         cap // 2])
        cls = np.array([1, 3, 1, 2, 1, 2, 0, 1])
        src_row = np.cumsum(occs) - occs
        real = np.minimum(occs, cap) * LANES - rng.integers(1, 127, len(occs))
        off = np.cumsum(real) - real
        z = np.zeros(len(occs), np.int64)
        bt = torch.from_numpy(np.stack([src_row, occs, real, z, z, off, cls,
                                        z], 1).astype(np.int32))
        ss = tuple(torch.from_numpy(rng.integers(
            -2**31, 2**31, int(occs.sum()) * LANES).astype(np.int32)
            // (1 << 24)) for _ in range(np_))
        oo = tuple(torch.zeros(int(real.sum()), dtype=torch.int32)
                   for _ in range(np_))
        _terminal_check(cuda, ss, bt, oo, cap, 1)


def test_wrappers_raise_on_mixed_devices(cuda):
    src = torch.zeros(LANES, dtype=torch.int32, device=cuda)
    meta = torch.zeros(6, dtype=torch.int32)
    bounds = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kv4.hist_level(src, meta, bounds, 1, 24, 8)


# ----------------------------------------------------------------- v5

# the reference tests' v5 geometry with a terminal class that holds a
# region's pads, so that the path runs without retries
V5_TINY = dict(v5_pitch_rows=64, v3_sort_rows=512, v3_rmax=8,
               v3_cap_rows=256, min_engine_n=1)


def _record_v5(fn):
    """Run ``fn`` with the v5 wrappers recording their inputs, W cloned
    before each in-place launch."""
    calls = []
    wrappers = {k: getattr(kv5, k) for k in kv5.LAUNCHES}

    def rec(name):
        def run(*a, **kw):
            calls.append((name, [_clone(t) for t in a], kw))
            return wrappers[name](*a, **kw)
        return run
    for k in wrappers:
        setattr(kv5, k, rec(k))
    try:
        fn()
    finally:
        for k, f in wrappers.items():
            setattr(kv5, k, f)
    return wrappers, calls


def _canonical_w(w, cnt, base, slot, ntiles, pitch, rmax):
    """W with every range's stream replaced by its canonical form."""
    boff, bslot = kv5.block_slots(cnt, base, slot, ntiles, pitch, rmax,
                                  w[0].numel() // kv5.BLK + rmax)
    total = base.reshape(ntiles, rmax)[-1].long()
    out = tuple(p.clone() for p in w)
    for d, planes in kv5.canonical_regions(w, boff, bslot, total):
        nb = int(total[d].item()) // kv5.BLK + 1
        rows = bslot[int(boff[d].item()):][:nb]
        for o, p in zip(out, planes):
            kv5.blocks_of(o)[rows] = p.view(nb, kv5.BLK)
    return out


def _replay_v5(wrappers, calls):
    """Rerun every recorded v5 launch and its plain version on clones of
    the same W: block_permute bitwise, seqroute_level region by region
    (sorted real prefix, then the pads) and bitwise outside the
    regions."""
    for name, a, kw in calls:
        got = wrappers[name](_clone(a[0]), *a[1:], **kw)
        if name == "block_permute":
            want = kv5.block_permute_ref(_clone(a[0]), *a[1:], **kw)
        else:
            want = kv5.seqroute_level_ref(_clone(a[0]), *a[1:], **kw)
            got, want = (_canonical_w(x, *a[2:4], a[4], *a[6:9])
                         for x in (got, want))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


@pytest.mark.parametrize("nvals", [0, 1, 3])
def test_v5_kernels_match_plain_versions(cuda, nvals):
    """A tiny-geometry v5 sort with 0, 1 and 3 payload planes: every
    seqroute_level and block_permute launch equal to its plain version,
    and the sort equal to numpy's lexicographic order.  Then seqroute at
    its edges: tiles of four route chunks (runs from several chunks, runs
    that straddle a block boundary), rmax 32 with 8 distinct keys (empty
    ranges) in windows of one tile, rmax 128 in windows of two; 3 planes
    beside the 2-plane case."""
    n = 5 * kv5.BLK + 321
    _check_v5_sort(cuda, [_keys(n, 20 + p) for p in range(1 + nvals)],
                   V5_TINY, every_kernel=True)
    n = 9 * kv5.BLK + 77
    for nv in (1, 2) if nvals == 1 else (nvals,):
        for rmax, dist, window in ((32, "dup8", 1), (128, "uniform", 2)):
            planes = [_keys(n, 30 + q, dist if q == 0 else "uniform")
                      for q in range(1 + nv)]
            cfg = dict(V5_TINY, v5_pitch_rows=256, v3_rmax=rmax)
            stage = kv5.STAGE_ELEMS
            kv5.STAGE_ELEMS = window * 256 * LANES
            try:
                _check_v5_sort(cuda, planes, cfg)
            finally:
                kv5.STAGE_ELEMS = stage


def _check_v5_sort(cuda, planes, cfg, every_kernel=False):
    """sort_v5 of the numpy uint32 planes with every v5 launch replayed
    against its plain version (``_replay_v5``); the sort equal to numpy's
    lexicographic order."""
    t = [torch.from_numpy(x.view(np.int32)).to(cuda) for x in planes]
    out = []
    wrappers, calls = _record_v5(lambda: out.append(engine_v5.sort_v5(
        t[0], tuple(t[1:]), SortConfig(**cfg))))
    names = {c[0] for c in calls}
    assert names == set(wrappers) if every_kernel \
        else "seqroute_level" in names, names
    _replay_v5(wrappers, calls)
    order = np.lexsort(planes[::-1])
    keys, vals = out[0]
    for got, x in zip((keys,) + vals, planes):
        np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                      x[order])


def _permute_case(cuda, src, nplanes, seed):
    """block_permute of W's blocks by ``src`` (slot f takes slot
    src[f]'s block): bitwise equal to the plain version and to the
    gather."""
    nslots = len(src)
    w = tuple(torch.from_numpy(_keys(nslots * kv5.BLK, seed + p)
                               .view(np.int32)).view(-1, LANES).to(cuda)
              for p in range(nplanes))
    off, slots = (torch.from_numpy(x).to(cuda)
                  for x in engine_v5.permute_cycles(src))
    got = kv5.block_permute(_clone(w), off, slots)
    want = kv5.block_permute_ref(_clone(w), off, slots)
    assert all(torch.equal(g, x) for g, x in zip(got, want)), (src, nplanes)
    for g, x in zip(got, w):
        assert torch.equal(g.view(nslots, -1), x.view(nslots, -1)[
            torch.from_numpy(src).to(cuda)])


def test_block_permute_long_cycle(cuda):
    """One cycle through every slot but a fixed one, and 2-cycles, on 3
    planes; then, against the chunks of S positions the CUDA kernel cuts
    the cycle table into, one cycle of exactly S slots, of S + 1, of
    several S plus a remainder, and several long cycles beside 2-cycles
    (chunk boundaries inside cycles, at their starts and their ends), on
    1, 2 and 4 planes: bitwise equal to the plain version."""
    nslots = 70
    src = np.arange(nslots)
    ring = [s for s in range(nslots) if s not in (5, 60, 61)]
    src[ring] = np.roll(ring, -1)
    src[[60, 61]] = [61, 60]
    _permute_case(cuda, src, 3, 30)
    S = kv5.PERMUTE_MIN_CHUNK
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    cases = []
    for length in (S, S + 1, 3 * S + 5):
        src = np.arange(length + 3)
        ring = np.arange(1, length + 1)
        src[ring] = np.roll(ring, -1)
        cases.append(src)
    src = np.arange(6 * S)
    pos = 0
    for length in (2, 2 * S + 3, 2, 2, S - 1, 2, 2 * S, 2, 3):
        ring = np.arange(pos, pos + length)
        src[ring] = np.roll(ring, -1)
        pos += length
    cases.append(src)
    for src in cases:
        moved = int((src != np.arange(len(src))).sum())
        assert kv5.permute_chunk(moved, sms) == S
        for nplanes in (1, 2, 4):
            _permute_case(cuda, src, nplanes, 31)


@pytest.mark.parametrize("kind", ["pairs_u64", "u32", "maxheavy"])
def test_v5_default_geometry_on_card(cuda, kind):
    """api.sort(engine="v5") at the default geometry (2048-row tiles,
    several staging windows): equal to numpy, no fallback."""
    rng = np.random.default_rng(11)
    n = (1 << 24) + 77
    key = rng.integers(0, 2**32, n, dtype=np.uint32)
    if kind == "maxheavy":
        key[rng.random(n) < 0.3] = 0xFFFFFFFF
    rid = (rng.integers(0, 2**64, n, dtype=np.uint64)
           if kind == "pairs_u64" else None)
    engine_v4.reset_fallback_stats()
    kv5.reset_launches()
    res = sort(torch.from_numpy(key).to(cuda),
               None if rid is None else torch.from_numpy(rid).to(cuda),
               config=SortConfig(engine="v5"))
    assert all(kv5.LAUNCHES.values()), kv5.LAUNCHES
    order = (np.argsort(key, kind="stable") if rid is None
             else np.lexsort((rid, key)))
    np.testing.assert_array_equal(res.keys.cpu().numpy(), key[order])
    if rid is not None:
        np.testing.assert_array_equal(res.rids.cpu().numpy(), rid[order])
    assert engine_v4.FALLBACK_STATS == dict.fromkeys(
        engine_v4.FALLBACK_STATS, 0), engine_v4.FALLBACK_STATS


# ------------------------------------------------------------------ v1

V1_TINY = SortConfig(tile_elems=1024, range_bits=3, engine="pallas")
V1_INPLACE = {"tile_sort", "ragged_sort"}


def _v1_replay(fn):
    """Run ``fn`` with every v1 kernel wrapper checked: each call runs
    the kernel, then its plain version on a copy of the same CUDA inputs
    taken before the call; the defined elements of every output plane
    (and tile_sort's counts) must be equal.  Returns the kernels called."""
    import inspect
    wrappers = {k: getattr(pk, k) for k in pk.LAUNCHES}
    seen = set()

    def checked(name):
        kern, ref = wrappers[name], getattr(pk, name + "_ref")

        def run(*args, **kw):
            a = inspect.signature(kern).bind(*args, **kw)
            a.apply_defaults()
            a = dict(a.arguments)
            before = {k: _clone(v) for k, v in a.items()}
            out = kern(*args, **kw)
            want = ref(**before)
            mask = pk.defined_elems(name, a, out[0].numel())
            for g, w in zip(out[:2], want[:2]):
                if g is not None:
                    assert torch.equal(g.reshape(-1)[mask],
                                       w.reshape(-1)[mask]), name
            if name == "tile_sort":
                assert torch.equal(out[2], want[2]), "tile_sort counts"
            seen.add(name)
            return out
        return run
    for k in wrappers:
        setattr(pk, k, checked(k))
    try:
        fn()
    finally:
        for k, f in wrappers.items():
            setattr(pk, k, f)
    return seen


def test_v1_kernels_match_plain_versions(cuda):
    """Every v1 kernel call of a sort at the reference tests' tiny
    geometry and at the default one equals its plain version on the same
    CUDA inputs; the sort equals numpy.  distribute's and tile_sort's
    edge cases too."""
    for cfg in (V1_TINY, SortConfig(engine="pallas")):
        for kind in ("uniform", "dup8", "maxheavy", "pairs"):
            _check_v1_sort(cuda, kind, cfg)
    _check_distribute_edges(cuda)
    _check_tile_sort_edges(cuda)


def _check_tile_sort_edges(cuda):
    """tile_sort against its plain version, keys and pairs: data counts
    0, 1, 129 and full in one launch; all-equal keys; equal keys with
    distinct vals (ties broken by val); real keys equal to SENT beside
    the slack; a tile where a single bit varies; tiles of several CTAs'
    tuples; and tiles larger than the single-pass limit (2^17 pairs at
    1,029 rows, 2^18 keys at 2,053: runs joined by merges), sorted tiles
    and counts bit for bit."""
    rng = np.random.default_rng(40)
    sent = np.int32(2**31 - 1)

    def tiles(tile_rows, ntiles, kind):
        n = tile_rows * LANES * ntiles
        k = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
        v = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
        if kind == "equal":
            k[:] = 77
        elif kind == "ties":
            k = rng.integers(-3, 3, n).astype(np.int32)
        elif kind == "sent":
            k[rng.random(n) < 0.4] = sent
            v[rng.random(n) < 0.4] = sent
        elif kind == "onebit":
            k = np.where(rng.random(n) < 0.5, 0x5000, 0x5000 | (1 << 22)) \
                .astype(np.int32)
            v[:] = 9
        return k, v

    cases = [(256, "uniform", [0, 1, 129, 256 * LANES]),
             (256, "equal", [256 * LANES, 1000]),
             (256, "ties", [256 * LANES, 30000]),
             (256, "sent", [256 * LANES, 20000]),
             (256, "onebit", [256 * LANES, 5]),
             (384, "uniform", [384 * LANES, 40000]),
             (1029, "uniform", [1029 * LANES, 1029 * LANES - 300]),
             (1029, "ties", [1029 * LANES, 70000]),
             (2053, "sent", [2053 * LANES - 5, 200000])]
    for tile_rows, kind, data in cases:
        k, v = tiles(tile_rows, len(data), kind)
        b = np.sort(rng.integers(-2**31, 2**31, (len(data), 6),
                                 dtype=np.int64), 1).astype(np.int32)
        b[:, 0] = np.int32(-2**31)
        b[:, 1] = k[0]
        b[:, -1] = sent
        for pairs in (False, True):
            args = [torch.from_numpy(x).view(-1, LANES).to(cuda)
                    for x in (k, v)]
            if not pairs:
                args[1] = None
            tables = (torch.from_numpy(b).to(cuda),
                      torch.tensor(data, dtype=torch.int32, device=cuda))
            got = pk.tile_sort(_clone(args[0]), _clone(args[1]), *tables,
                               tile_rows)
            want = pk.tile_sort_ref(_clone(args[0]), _clone(args[1]),
                                    *tables, tile_rows)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                assert g is None or torch.equal(g, w), \
                    (tile_rows, kind, pairs)


def _check_v1_sort(cuda, kind, cfg):
    n = 30_000 if cfg is V1_TINY else (1 << 21) + 77
    x = _keys(n, 21, "dup8" if kind == "dup8" else
              "maxheavy" if kind == "maxheavy" else "uniform")
    k = torch.from_numpy(x).to(cuda)
    rid = (torch.arange(n, dtype=torch.int32, device=cuda)
           if kind == "pairs" else None)
    box = {}
    seen = _v1_replay(lambda: box.update(
        r=pallas_engine.msd_sort(k, rid, cfg)))
    # dup8 at the default geometry: eight all-equal buckets above the
    # largest class end 'done', so nothing reaches ragged_sort
    done = kind == "dup8" and cfg is not V1_TINY
    assert seen == set(pk.LAUNCHES) - ({"ragged_sort"} if done else set()), \
        (kind, seen)
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(box["r"][0].cpu().numpy(), x[order])
    if rid is not None:
        np.testing.assert_array_equal(
            box["r"][1].cpu().numpy().astype(np.int64), order)


def _distribute_tables(rng, tile_rows, ntiles, r, kind):
    """(slot_rows, run_starts, run_lens, out_rows) as int64 numpy tables:
    "edges" gives tiles runs of length 1, of one row, of a whole tile and
    ending on a row edge; "one_range" gives each tile one run in range 0
    holding the whole tile (the engine's forward repack); "random" any
    in-tile runs.  Slots follow each other in a shuffled order."""
    te = tile_rows * LANES
    ln = np.zeros((ntiles, r), np.int64)
    st = np.zeros_like(ln)
    for t in range(ntiles):
        if kind == "edges":
            c = t % 4
            if c == 0:
                st[t, :3] = (rng.integers(0, te), 5, te - LANES)
                ln[t, :3] = (1, LANES, LANES)
            elif c == 1:
                ln[t, r - 1] = te
            elif c == 2:
                st[t, 1] = LANES - 7
                ln[t, 1] = 7 + 2 * LANES
        elif kind == "one_range":
            ln[t, 0] = te
        else:
            for d in range(r):
                if rng.random() < 0.5:
                    s = int(rng.integers(0, te))
                    st[t, d] = s
                    ln[t, d] = rng.integers(1, te - s + 1)
    rows = ((ln + LANES - 1) // LANES).reshape(-1)
    perm = rng.permutation(rows.size)
    slot = np.zeros_like(ln)
    slot.reshape(-1)[perm] = np.cumsum(rows[perm]) - rows[perm]
    return slot, st, ln, int(rows.sum()) + 5


def _check_distribute_edges(cuda):
    """distribute on its edge cases equals its plain version, with the
    tables on the host and on the card; both refuse bad tables alike."""
    rng = np.random.default_rng(9)
    for tile_rows, ntiles, r, kind, pairs in [
            (8, 12, 8, "edges", False), (8, 12, 8, "edges", True),
            (256, 6, 256, "edges", True), (256, 5, 256, "one_range", False),
            (256, 4, 64, "random", True), (512, 3, 16, "random", False)]:
        slot, st, ln, out_rows = _distribute_tables(rng, tile_rows, ntiles,
                                                    r, kind)
        n = ntiles * tile_rows * LANES
        planes = [torch.from_numpy(rng.integers(-2**31, 2**31, n)
                                   .astype(np.int32)).view(-1, LANES).to(cuda)
                  for _ in range(2 if pairs else 1)]
        vals = planes[1] if pairs else None
        host = [torch.from_numpy(t.astype(np.int32)) for t in (slot, st, ln)]
        want = pk.distribute_ref(planes[0], vals, *host, out_rows, tile_rows)
        mask = pk.defined_elems("distribute", dict(
            keys=planes[0], slot_rows=host[0], run_lens=host[2]),
            out_rows * LANES)
        for tables in (host, [t.to(cuda) for t in host]):
            got = pk.distribute(planes[0], vals, *tables, out_rows,
                                tile_rows)
            for g, w in zip(got, want):
                if w is not None:
                    assert torch.equal(g.reshape(-1)[mask],
                                       w.reshape(-1)[mask]), (kind, r)
    k = torch.zeros((16, LANES), dtype=torch.int32, device=cuda)
    t = functools.partial(torch.tensor, dtype=torch.int32)
    for dev in (cuda, "cpu"):
        with pytest.raises(ValueError, match="run"):
            pk.distribute(k, None, t([[0, 0]], device=dev),
                          t([[0, 2000]], device=dev),
                          t([[0, 100]], device=dev), 16, 16)
        with pytest.raises(ValueError, match="slot"):
            pk.distribute(k, None, t([[0, 15]], device=dev),
                          t([[0, 0]], device=dev),
                          t([[0, 200]], device=dev), 16, 16)
        # an empty entry may hold anything
        pk.distribute(k, None, t([[-5, 0]], device=dev),
                      t([[-9, 0]], device=dev), t([[0, 3]], device=dev),
                      16, 16)


def _ragged_case(rng, cuda, class_rows, pairs, nlive, ndummy, fill=None):
    """ragged_sort against its plain version: nlive buckets (the first
    full, the rest with random pads), then ndummy pad-0 buckets pointing
    at one slack region that holds data and must stay as it was.
    ``fill`` "equal" makes every key one value; "sent" makes a third of
    the keys SENT with values below SENT."""
    nb = nlive + ndummy
    rows = (nlive + 1) * class_rows
    kp = [torch.from_numpy(rng.integers(-2**31, 2**31, rows * LANES)
                           .astype(np.int32)).view(rows, LANES).to(cuda)
          for _ in range(2 if pairs else 1)]
    if fill == "equal":
        kp[0].fill_(12345)
    elif fill == "sent":
        kp[0].view(-1)[::3] = 2**31 - 1
    m = class_rows * LANES
    starts = np.full(nb, nlive * class_rows, np.int32)
    starts[:nlive] = np.arange(nlive) * class_rows
    pads = np.zeros(nb, np.int32)
    pads[:nlive] = rng.integers(1, m + 1, nlive)
    pads[0] = m
    vals = kp[1] if pairs else None
    for tables in ((torch.from_numpy(starts), torch.from_numpy(pads)),
                   (torch.from_numpy(starts).to(cuda),
                    torch.from_numpy(pads).to(cuda))):
        want = pk.ragged_sort_ref(_clone(kp[0]), _clone(vals), *tables,
                                  class_rows)
        got = pk.ragged_sort(_clone(kp[0]), _clone(vals), *tables,
                             class_rows)
        for g, w, x in zip(got, want, kp):
            assert torch.equal(g, w), (class_rows, pairs, nlive, fill)
            assert torch.equal(g[nlive * class_rows:],
                               x[nlive * class_rows:])


def _compact_edges(rng, cuda):
    """compact against its plain version, keys and pairs, tables on the
    host and on the card: empty segments, segments shorter than one
    16-byte vector, segments that start the output at every 16-byte
    phase, one CUDA block's output covering hundreds of tiny segments,
    and totals that are no multiple of a block's output (one segment
    longer than it)."""
    rows = 512
    kp = [torch.from_numpy(rng.integers(-2**31, 2**31, rows * LANES)
                           .astype(np.int32)).view(rows, LANES).to(cuda)
          for _ in range(2)]
    tiny = rng.integers(0, 9, 400)
    tiny[::7] = 0
    cases = [([0, 2, 3, 5, 9], [0, 3, 128, 0, 7]),
             ([0, 1, 2, 3, 4, 5, 6], [1, 2, 3, 4, 5, 6, 128]),
             (np.arange(400), tiny),
             ([0, 100, 300, 301], [12345, 0, 100, 4097]),
             ([7], [pk.COMPACT_SPAN[1] + 1])]
    for starts, lens in cases:
        total = int(np.sum(lens))
        out_rows = -(-total // LANES) + 1
        for vals in (None, kp[1]):
            for dev in ("cpu", cuda):
                st = torch.tensor(np.asarray(starts), dtype=torch.int32,
                                  device=dev)
                ln = torch.tensor(np.asarray(lens), dtype=torch.int32,
                                  device=dev)
                want = pk.compact_ref(kp[0], vals, st, ln, out_rows)
                got = pk.compact(kp[0], vals, st, ln, out_rows)
                for g, x in zip(got, want):
                    if x is not None:
                        assert torch.equal(g.view(-1)[:total],
                                           x.view(-1)[:total]), \
                            (starts, lens, vals is None, dev)


def test_v1_ragged_edges_and_sort_vmem(cuda):
    """ragged_sort leaves pad-0 dummy buckets alone (here all pointing at
    one region that holds data), and sorts every class: one cluster of
    1, 2, 4 and 8 CTAs (keys up to 2048 rows, pairs up to 1024), classes
    above a cluster (runs merged by global steps and merge launches) and
    of a size that is no power of two, many live buckets before the
    dummies, all-equal buckets and pairs whose keys are SENT with values
    below it, with tables on the host and on the card; compact's edges
    (``_compact_edges``); sort_vmem is one ragged_sort launch over the
    whole input.  Tables that place a live
    bucket, a run or a segment outside its arena raise ValueError on the
    card too, whether the tables lie on the card or on the host."""
    rng = np.random.default_rng(5)
    k = torch.zeros((16, LANES), dtype=torch.int32, device=cuda)
    t = functools.partial(torch.tensor, dtype=torch.int32, device=cuda)
    for dev in (cuda, "cpu"):      # tables on the card or on the host
        with pytest.raises(ValueError, match="bucket"):
            pk.ragged_sort(k, None, t([0, 12], device=dev),
                           t([5, 1], device=dev), 8)
    with pytest.raises(ValueError, match="run"):
        pk.distribute(k, None, t([[0]]), t([[2000]]), t([[100]]), 16, 16)
    with pytest.raises(ValueError, match="segment"):
        pk.compact(k, None, t([15]), t([200]), 8)
    for class_rows, pairs in [(256, False), (512, False), (1024, False),
                              (2048, False), (128, True), (256, True),
                              (512, True), (1024, True), (96, False),
                              (384, True), (3072, False), (4096, False),
                              (1536, True), (2048, True)]:
        _ragged_case(rng, cuda, class_rows, pairs, 2, 2)
    _ragged_case(rng, cuda, 256, False, 40, 24)
    _ragged_case(rng, cuda, 128, True, 21, 11)
    _ragged_case(rng, cuda, 1024, False, 3, 1, "equal")
    _ragged_case(rng, cuda, 512, True, 3, 1, "equal")
    _ragged_case(rng, cuda, 1024, True, 3, 1, "sent")
    _ragged_case(rng, cuda, 2048, True, 2, 0, "sent")
    _compact_edges(rng, cuda)
    for logn in (10, 15, 20):
        x = _keys((1 << logn) - 3, logn)
        pk.reset_launches()
        got = pallas_engine.sort_vmem(torch.from_numpy(x).to(cuda))
        assert pk.LAUNCHES["ragged_sort"] == 1
        np.testing.assert_array_equal(got.cpu().numpy(), np.sort(x))


def test_api_pallas_on_card(cuda):
    """api.sort(engine="pallas") on CUDA tensors runs the v1 kernels (the
    counters move) and equals numpy; rids come back in their dtype."""
    for kind in ("u32", "pairs_i16", "u64", "u64_max"):
        _check_api_pallas(cuda, kind)


def _check_api_pallas(cuda, kind):
    rng = np.random.default_rng(8)
    n = (1 << 20) + 5
    if kind.startswith("u64"):
        hi = rng.choice(np.array([3, 9, 2**32 - 1], np.uint64), n)
        x = (hi << np.uint64(32)) | rng.integers(0, 2**32, n,
                                                 dtype=np.uint64)
        if kind == "u64_max":
            x[rng.random(n) < 0.1] = np.uint64(2**64 - 1)
    else:   # many ties, every key's bucket below the largest class
        x = rng.integers(0, 4096, n, dtype=np.uint32)
    rid = (rng.integers(-2**15, 2**15, n).astype(np.int16)
           if kind == "pairs_i16" else None)
    pk.reset_launches()
    res = sort(torch.from_numpy(x).to(cuda),
               None if rid is None else torch.from_numpy(rid).to(cuda),
               config=SortConfig(engine="pallas"))
    assert pk.LAUNCHES["tile_sort"] and pk.LAUNCHES["ragged_sort"], \
        (kind, pk.LAUNCHES)
    order = (np.argsort(x, kind="stable") if rid is None
             else np.lexsort((rid.astype(np.uint32), x)))
    np.testing.assert_array_equal(res.keys.cpu().numpy(), x[order])
    if rid is not None:
        assert res.rids.dtype == torch.int16
        np.testing.assert_array_equal(res.rids.cpu().numpy(), rid[order])


V3_TINY = dict(v3_sort_rows=32, v3_rmax=8, v3_cap_rows=32)


def _v3_replay(cuda, fn):
    """Run ``fn`` with every v3 kernel call replayed on its plain version
    on the same CUDA tensors: partition counts and flag exactly, arenas
    child by child through ``canonical_children`` (order inside a child
    is not part of the contract; nor, under overflow, which tuples an
    overflowing child keeps), the terminal output on every element the
    buckets write.  Returns the kernels seen."""
    wrappers = {k: getattr(kv3, k) for k in kv3.LAUNCHES}
    seen = set()

    def checked(name):
        def run(*args, **kw):
            out = wrappers[name](*args, **kw)
            a = inspect.signature(wrappers[name]).bind(*args, **kw)
            a.apply_defaults()
            a = a.arguments
            if name == "partition_level":
                claimed = torch.zeros(a["dst_start"].numel(),
                                      dtype=torch.long, device=cuda)
                ref = kv3.partition_level_ref(*args, **kw, claimed=claimed)
                for i in range(2, 6):
                    assert torch.equal(out[i], ref[i]), (name, i)
                # which tuples an overflowing child keeps is not defined
                fits = claimed <= a["dst_cap"]
                planes = [p for p in out[:2] if p is not None]
                want = [p for p in ref[:2] if p is not None]
                start = a["dst_start"][fits]
                for g, w in zip(
                        kv3.canonical_children(planes, start, out[2][fits]),
                        kv3.canonical_children(want, start, out[2][fits])):
                    assert torch.equal(g, w), name
            else:
                ref = kv3.terminal_sort_write_ref(*args, **kw)
                bt = a["btbl"].long()
                occ, real, mode = bt[:, 1], bt[:, 2], bt[:, 3]
                eff = torch.where(mode == 0, torch.minimum(
                    real, occ.clamp(0, a["cap_rows"]) * LANES), real)
                pos = kv4._spans(a["out_off"].long(), eff.clamp(min=0))
                for g, w in zip(out, ref):
                    if g is not None:
                        assert torch.equal(g.view(-1)[pos],
                                           w.view(-1)[pos]), name
            seen.add(name)
            return out
        return run
    for k in wrappers:
        setattr(kv3, k, checked(k))
    try:
        fn()
    finally:
        for k, f in wrappers.items():
            setattr(kv3, k, f)
    return seen


def _check_v3_on_card(cuda):
    """api.sort(engine="v3") on the card: every partition_level and
    terminal_sort_write call equals its plain version on the same
    tensors, at the reference tests' geometry (keys, 30% 0xFFFFFFFF with
    value-fill buckets, stable pairs) and at the default one (buckets
    above the terminal's shared tile); the results equal numpy, and a
    uniform sort is two partition launches and one terminal launch."""
    cases = [(V3_TINY, 70_000, "uniform", False),
             (V3_TINY, 70_000, "maxheavy", False),
             (V3_TINY, 70_000, "dup8", True),
             ({}, (1 << 22) + 77, "uniform", False),
             ({}, (1 << 22) + 77, "uniform", True)]
    for geom, n, dist, pairs in cases:
        x = _keys(n, 31, dist)
        rid = np.arange(n, dtype=np.uint32) if pairs else None
        box = {}
        kv3.reset_launches()
        seen = _v3_replay(cuda, lambda: box.update(r=sort(
            torch.from_numpy(x).to(cuda),
            None if rid is None else torch.from_numpy(rid).to(cuda),
            config=SortConfig(engine="v3", **geom))))
        assert seen == set(kv3.LAUNCHES), (dist, seen)
        if dist == "uniform":
            assert kv3.LAUNCHES == {"partition_level": 2,
                                    "terminal_sort_write": 1}, kv3.LAUNCHES
        order = np.argsort(x, kind="stable")
        np.testing.assert_array_equal(box["r"].keys.cpu().numpy(), x[order])
        if pairs:
            np.testing.assert_array_equal(box["r"].rids.cpu().numpy(),
                                          rid[order])
    # uint64 keys through (hi, lo), default geometry
    rng = np.random.default_rng(3)
    k64 = rng.integers(0, 2**64, (1 << 21) + 3, dtype=np.uint64)
    k64[::4] = np.uint64(2**64 - 1)
    res = sort(torch.from_numpy(k64).to(cuda), config=SortConfig(
        engine="v3"))
    np.testing.assert_array_equal(res.keys.cpu().numpy(), np.sort(k64))


LSB_TINY = dict(v3_sort_rows=32, lsb_digit_bits=4, min_engine_n=512)


def _check_lsb_on_card(cuda):
    """api.sort(engine="lsb") on the card: every digit-mode hist_level,
    route_level (bit for bit on every run row) and splice_runs call
    equals its plain version, at the reference tests' geometry (4-bit
    digits; a tile of 2048 elements, one partial chunk of the route), at
    6-bit digits (a last pass at shift 30, keys >= 2^31) and at the
    default one (tiles of 12 chunks, the last tile's last chunk partial;
    1-4 planes, the digit plane 1 on the u64 keys' low passes); the
    results equal numpy's stable sort by key, rids in input order among
    equal keys."""
    rng = np.random.default_rng(41)
    n = (1 << 21) + 77
    perm = rng.permutation(n).astype(np.uint32)
    few = rng.integers(0, 3, n, dtype=np.uint32) * 0x01010101
    cases = [(LSB_TINY, _keys(70_000, 5), None),
             (LSB_TINY, few[:70_000], perm[:70_000]),
             (dict(v3_sort_rows=128, lsb_digit_bits=6),
              rng.integers(2**31, 2**32, n, dtype=np.uint32), None),
             ({}, few, perm),
             ({}, rng.integers(0, 2**64, n, dtype=np.uint64),
              rng.integers(0, 2**64, n, dtype=np.uint64)),
             ({}, rng.integers(0, 2**64, n, dtype=np.uint64), perm),
             ({}, rng.standard_normal(n).astype(np.float32), None),
             ({}, rng.integers(-2**31, 2**31, n).astype(np.int32), perm)]
    for geom, x, rid in cases:
        box = {}
        kv4.reset_launches()
        wrappers, calls = _record(lambda: box.update(r=sort(
            torch.from_numpy(x).to(cuda),
            None if rid is None else torch.from_numpy(rid).to(cuda),
            config=SortConfig(engine="lsb", **geom))))
        assert {c[0] for c in calls} == {"hist_level", "route_level",
                                         "splice_runs"}, x.dtype
        assert kv4.LAUNCHES["hist_level.digit"] and \
            kv4.LAUNCHES["route_level.digit"], kv4.LAUNCHES
        _replay(wrappers, calls)
        order = np.argsort(_f32_key(x) if x.dtype == np.float32 else x,
                           kind="stable")
        np.testing.assert_array_equal(
            box["r"].keys.cpu().numpy().view(x.dtype), x[order])
        if rid is not None:
            np.testing.assert_array_equal(box["r"].rids.cpu().numpy(),
                                          rid[order])


def _f32_key(x):
    """float32 in IEEE total order (-0 < +0) as uint32."""
    u = x.view(np.uint32)
    return np.where(u >> 31, ~u, u | np.uint32(0x80000000))


def _check_chunked_on_card(cuda):
    """sort_external on the card: every hist_level and accumulate
    route_level call equals its plain version (arenas through
    canonical_runs on the call's runs, every other row unchanged), and
    the concatenated pieces equal numpy, keys only and (key, rid) pairs
    lexicographic; the local v4 sorts run at the default geometry."""
    rng = np.random.default_rng(43)
    n = (1 << 22) + 5
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    x[rng.random(n) < 0.2] = 12345
    rid = rng.integers(0, 2**32, n, dtype=np.uint32)
    for planes in ((x,), (x, rid)):
        splits = np.array_split(np.arange(n), 3)

        def chunk_fn(i):
            return tuple(torch.from_numpy(p[splits[i]]).to(cuda)
                         for p in planes)
        kv4.reset_launches()
        box = {}
        wrappers, calls = _record(lambda: box.update(p=list(
            chunked.sort_external(chunk_fn, 3, n, SortConfig(),
                                  nranges=6))))
        assert kv4.LAUNCHES["route_level.accumulate"] == 3, kv4.LAUNCHES
        _replay(wrappers, calls)
        outs = [np.concatenate([p[j].cpu().numpy() for p in box["p"]])
                for j in range(len(planes))]
        order = (np.argsort(x, kind="stable") if len(planes) == 1
                 else np.lexsort((rid, x)))
        for o, p in zip(outs, planes):
            np.testing.assert_array_equal(o, p[order])
