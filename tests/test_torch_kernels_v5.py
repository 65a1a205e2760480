"""The port's v5 kernels (plain PyTorch versions, CPU) against the JAX
Pallas kernels in interpret mode, at the reference tests' tiny geometry
(64-row L1 tiles, rmax 8; ``tests/test_engine_v5.py``).

- ``seqroute_level_ref`` equals the JAX ``seqroute_level`` bitwise, W
  slot by slot, on the same W and the tables of ``_seqroute_tables``
  (one plane, uniform and dup8).  The reference's two-plane seqroute
  compiles its multi-plane tile network for minutes in interpret mode,
  so the two-plane plain version is held against a numpy model of the
  partition instead.
- ``block_permute_ref`` applied along ``permute_cycles(src)`` equals the
  JAX ``block_permute(permute_schedule(src))`` bitwise (a random
  permutation, back-to-back 2-cycles, three planes), and so does the
  CUDA kernel's plan (``permute_plan``) applied in numpy for several
  chunk sizes: its head blocks saved first, then the chunks moved one
  after another, last chunk first.
- ``permute_cycles`` covers every moved slot once; ``canonical_regions``
  is blind to the order inside a stream and to nothing else.

Inputs come from ``np.random.default_rng(seed)``; comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inplacemsdradixsort_tpu.ops import engine_v5 as je5
from inplacemsdradixsort_tpu.ops import kernels_v5 as jk5
from inplacemsdradixsort_tpu_torch.ops import engine_v5 as te5
from inplacemsdradixsort_tpu_torch.ops import kernels_v5 as tk5

LANES = 128
BLK, BLKROWS = tk5.BLK, tk5.BLKROWS
RMAX, PITCH = 8, 64


def _t(a):
    return torch.from_numpy(np.array(a, np.int32))


def _keys(dist, n, rng):
    if dist == "uniform":
        return rng.integers(0, 2**32, n, dtype=np.uint32)
    return rng.integers(0, 8, n, dtype=np.uint32)          # dup8


def _bounds(keys):
    """rmax inclusive upper bounds from the keys' quantiles, the last
    0xFFFFFFFF (the reference test's bounds)."""
    qs = np.quantile(keys.astype(np.float64), np.linspace(0, 1, RMAX))
    b = np.unique(np.concatenate([qs.astype(np.uint64)[1:-1],
                                  [np.uint64(0xFFFFFFFF)]]))
    return np.sort(np.pad(b, (0, RMAX - len(b)),
                          constant_values=np.uint64(0xFFFFFFFF)))


def _setup(keys, nplanes):
    """Geometry, plan and seqroute tables for keys at the tiny geometry,
    with the histogram counted in numpy."""
    n = len(keys)
    bounds_u = _bounds(keys)
    rows_in = -(-n // LANES)
    ntiles = -(-rows_in // PITCH)
    h = np.zeros((ntiles, RMAX), np.int64)
    for t in range(ntiles):
        tile = keys[t * PITCH * LANES:(t + 1) * PITCH * LANES]
        h[t] = np.bincount(np.searchsorted(bounds_u, tile.astype(np.uint64)),
                           minlength=RMAX)[:RMAX]
    kw = dict(n=n, nplanes=nplanes, rmax=RMAX, pitch1=PITCH,
              sort_rows2=512, pitch2=512 - RMAX, cap_rows=32,
              rows_in=rows_in, nblocks=-(-n // BLK), ntiles1=ntiles,
              w_rows=(-(-n // BLK) + RMAX) * BLKROWS + 512 + 64, ssz=4096,
              nbq=64, nb_want=16)
    plan_kw = dict(ng=RMAX, l1_bounds_u=bounds_u,
                   l2_bounds_u=np.tile(bounds_u[:, None], (1, RMAX)),
                   glen=np.ones(RMAX, np.int64),
                   heavy1=np.zeros(RMAX, bool),
                   drop2=np.zeros((RMAX, RMAX), np.int32))
    jg, tg = je5._GeomV5(**kw), te5._GeomV5(**kw)
    jt = je5._seqroute_tables(h, jg, je5._PlanV5(**plan_kw))
    tt = te5._seqroute_tables(h, tg, te5._PlanV5(**plan_kw))
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a, b)
    return tg, bounds_u, tt


def _w(planes, w_rows):
    out = []
    for p in planes:
        w = np.zeros(w_rows * LANES, np.uint32)
        w[: len(p)] = p
        out.append(w.view(np.int32).reshape(w_rows, LANES))
    return out


def _port_seqroute(w, g, tables, nplanes):
    meta5, cnt_tbl, base_tbl, slot_tbl, padv_tbl = tables[:5]
    return tk5.seqroute_level(
        tuple(_t(x) for x in w), _t(meta5), _t(cnt_tbl), _t(base_tbl),
        _t(slot_tbl), _t(padv_tbl), g.ntiles1 + 1, PITCH, RMAX,
        nlex=nplanes - 1, bias_input=True)


@pytest.mark.parametrize("dist", ["uniform", "dup8"])
def test_seqroute_matches_jax(dist):
    rng = np.random.default_rng(["uniform", "dup8"].index(dist))
    n = 6 * BLK + 777
    keys = _keys(dist, n, rng)
    g, _, tables = _setup(keys, 1)
    w = _w([keys], g.w_rows)
    meta5, cnt_tbl, base_tbl, slot_tbl, padv_tbl = tables[:5]
    (jout,) = jk5.seqroute_level(
        (jnp.asarray(w[0]),), jnp.asarray(meta5), jnp.asarray(cnt_tbl),
        jnp.asarray(base_tbl), jnp.asarray(slot_tbl), jnp.asarray(padv_tbl),
        g.ntiles1 + 1, PITCH, RMAX, bias_input=True, interpret=True)
    (tout,) = _port_seqroute(w, g, tables, 1)
    jout = np.asarray(jout)
    nslots = g.w_rows // BLKROWS
    for s in range(nslots):
        np.testing.assert_array_equal(
            tout.numpy()[s * BLKROWS:(s + 1) * BLKROWS],
            jout[s * BLKROWS:(s + 1) * BLKROWS], err_msg=f"slot {s}")
    np.testing.assert_array_equal(tout.numpy(), jout)


def _oracle(planes, bounds_u):
    """The partition modelled in numpy (the reference test's oracle,
    over tuples): per tile, sorted by tuple, each range's run appended
    to its stream; full blocks take sequential slots in (tile, range,
    block) order, the open blocks padded with (bound, SENT) the slots
    past them.  Returns {slot: biased planes}."""
    keys = planes[0]
    n = len(keys)
    ntiles = -(-(-(-n // LANES)) // PITCH)
    streams = [[] for _ in range(RMAX)]
    h = np.zeros((ntiles, RMAX), np.int64)
    for t in range(ntiles):
        sl = slice(t * PITCH * LANES, (t + 1) * PITCH * LANES)
        tile = [p[sl] for p in planes]
        order = np.lexsort(tile[::-1])
        tile = [p[order] for p in tile]
        ids = np.searchsorted(bounds_u, tile[0].astype(np.uint64))
        for d in range(RMAX):
            streams[d].append(np.stack([p[ids == d] for p in tile]))
            h[t, d] = int((ids == d).sum())
    slots, s = {}, 0
    C = np.zeros(RMAX, np.int64)
    for t in range(ntiles):
        for d in range(RMAX):
            for k in range(C[d] // BLK, (C[d] + h[t, d]) // BLK):
                slots[(d, k)] = s
                s += 1
            C[d] += h[t, d]
    out = {}
    for d in range(RMAX):
        stream = np.concatenate(streams[d], axis=1)
        nb = stream.shape[1] // BLK
        for k in range(nb):
            out[slots[(d, k)]] = stream[:, k * BLK:(k + 1) * BLK]
        tail = stream[:, nb * BLK:]
        pad = np.full((len(planes), BLK - tail.shape[1]), 0xFFFFFFFF,
                      np.uint32)
        pad[0] = bounds_u[d]
        out[s + d] = np.concatenate([tail, pad], axis=1)
    return {k: (v ^ np.uint32(1 << 31)).view(np.int32)
            for k, v in out.items()}


def test_seqroute_two_planes_matches_numpy_model():
    rng = np.random.default_rng(5)
    n = 6 * BLK + 777
    planes = [rng.integers(0, 50, n, dtype=np.uint32),
              rng.integers(0, 2**32, n, dtype=np.uint32)]
    g, bounds_u, tables = _setup(planes[0], 2)
    out = _port_seqroute(_w(planes, g.w_rows), g, tables, 2)
    for slot, want in _oracle(planes, bounds_u).items():
        for p in range(2):
            np.testing.assert_array_equal(
                out[p].numpy()[slot * BLKROWS:(slot + 1) * BLKROWS]
                .reshape(-1), want[p], err_msg=f"slot {slot} plane {p}")


def _perm_cases():
    rng = np.random.default_rng(3)
    short = np.arange(24)
    short[::2], short[1::2] = np.arange(24)[1::2], np.arange(24)[::2]
    return {"random": (rng.permutation(37), 1),
            "short_cycles": (short, 1),
            "three_planes": (rng.permutation(9), 3)}


def _apply_plan(blocks, off, slots, S):
    """``permute_plan`` applied in numpy to (slots, ...) blocks: the first
    launch's head copies, then chunk by chunk (last first: chunks are
    independent) each position in order, a cycle's head read from
    ``blocks`` as the chunk reaches the cycle's start."""
    saves, src = tk5.permute_plan(off, S)
    b = blocks.copy()
    heads = {int(h): b[slots[p]].copy() for h, p in saves}
    starts = set(off[:-1].tolist())
    moved = len(slots)
    for j in reversed(range(-(-moved // S))):
        head = None
        for i in range(j * S, min(j * S + S, moved)):
            if i in starts:
                head = b[slots[i]].copy()
            p = int(src[i])
            b[slots[i]] = heads[-1 - p] if p < 0 else \
                b[slots[p]].copy() if p == i + 1 else head
    return b


@pytest.mark.parametrize("case", list(_perm_cases()))
def test_block_permute_matches_jax(case):
    perm, nplanes = _perm_cases()[case]
    nslots = len(perm)
    rng = np.random.default_rng(nslots)
    data = [rng.integers(-2**31, 2**31, (nslots * BLKROWS, LANES),
                         dtype=np.int64).astype(np.int32)
            for _ in range(nplanes)]
    jout = jk5.block_permute(tuple(jnp.asarray(d) for d in data),
                             jnp.asarray(je5.permute_schedule(perm)),
                             interpret=True)
    off, slots = te5.permute_cycles(perm)
    tout = tk5.block_permute(tuple(_t(d) for d in data), _t(off),
                             _t(slots))
    for j, t, d in zip(jout, tout, data):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(
            t.numpy().reshape(nslots, -1), d.reshape(nslots, -1)[perm])
        for S in (1, 2, 3, 5, len(slots)):
            saves, _ = tk5.permute_plan(off, S)
            assert len(saves) <= 2 * -(-len(slots) // S)
            np.testing.assert_array_equal(
                _apply_plan(d.reshape(nslots, -1), off, slots, S),
                np.asarray(j).reshape(nslots, -1))


def test_permute_cycles_cover_moved_slots():
    rng = np.random.default_rng(9)
    src = np.arange(300)
    moved = rng.choice(300, 120, replace=False)
    src[moved] = rng.permutation(moved)
    off, slots = te5.permute_cycles(src)
    assert off[0] == 0 and off[-1] == len(slots)
    assert np.all(np.diff(off) >= 2)
    np.testing.assert_array_equal(np.sort(slots),
                                  np.flatnonzero(src != np.arange(300)))
    for c in range(len(off) - 1):
        cyc = slots[off[c]:off[c + 1]]
        assert cyc[0] == cyc.min()
        np.testing.assert_array_equal(src[cyc], np.roll(cyc, -1))
    with pytest.raises(ValueError):
        te5.permute_cycles(np.array([0, 0, 1]))


def test_canonical_regions_see_only_the_multiset():
    rng = np.random.default_rng(4)
    n = 3 * BLK + 500
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    g, _, tables = _setup(keys, 1)
    out = _port_seqroute(_w([keys], g.w_rows), g, tables, 1)
    cnt_tbl, base_tbl, slot_tbl = (_t(x) for x in tables[1:4])
    boff, bslot = tk5.block_slots(cnt_tbl, base_tbl, slot_tbl,
                                  g.ntiles1 + 1, PITCH, RMAX,
                                  out[0].numel() // BLK + RMAX)
    total = base_tbl[-1].long()
    base = tk5.canonical_regions(out, boff, bslot, total)
    # shuffle the real prefix of region 2's stream: same canonical form
    d = 2
    nb = int(total[d]) // BLK + 1
    rows = bslot[int(boff[d]):][:nb]
    blocks = tk5.blocks_of(out[0])
    stream = blocks[rows].reshape(-1)
    c = int(total[d])
    stream[:c] = stream[:c][torch.from_numpy(rng.permutation(c))]
    blocks[rows] = stream.view(nb, BLK)
    again = tk5.canonical_regions(out, boff, bslot, total)
    assert all(torch.equal(a[1][0], b[1][0]) for a, b in zip(base, again))
    stream[0] ^= 1
    blocks[rows] = stream.view(nb, BLK)
    changed = tk5.canonical_regions(out, boff, bslot, total, ranges=[d])
    assert not torch.equal(changed[0][1][0], base[d][1][0])
