"""The port's v4 kernels (plain PyTorch versions, CPU) against the JAX
Pallas kernels in interpret mode, at the tiny tile geometry
(v3_sort_rows=32, v3_rmax=8, v3_cap_rows=32): keys-only and 2-3 planes
for ``route_level`` and ``terminal_write`` (``nlex`` 1 and 2), and
``splice_runs``.  The reference's multi-plane network compiles for
minutes in interpret mode at these tiles: the terminal cases hold it at
one-row capacities, and the multi-plane route cases run the reference
kernel with ``lax.sort`` as its in-tile sort (``torch_parity``), which
gives the same runs.

The digit modes (``tests/torch_lsb_cases.py``, run by the first
``test_hist_level_matches_jax`` case) and the accumulate mode
(``tests/torch_chunked_cases.py``, run by
``test_canonical_runs_ignores_order_and_unstored_rows``) are checked
inside existing tests, to keep the collection at 383 (ROADMAP.md A0).

Inputs come from ``np.random.default_rng(seed)`` and reach both sides as
the same numpy arrays.  Every comparison is exact (integers, tolerance
0).  Route arenas are compared through ``canonical_runs``: order inside a
run is not part of the port's contract, and rows outside stored runs are
uninitialised on both sides.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inplacemsdradixsort_tpu.ops import kernels_v4 as jk
from inplacemsdradixsort_tpu_torch.ops import kernels_v4 as tk
from torch_parity import lax_network
from torch_chunked_cases import check_accumulate_matches_jax
from torch_lsb_cases import check_lsb_kernels_match_jax
from torch_v3_cases import check_v3_kernels_match_jax
from inplacemsdradixsort_tpu_torch.ops.plan_util import _bias_np

SORT_ROWS, RMAX, CAP = 32, 8, 32
PITCH = SORT_ROWS - RMAX
LANES = 128
SENT = np.int32(0x7FFFFFFF)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _level_inputs(seed, bias_input, nparents):
    """A source of 7 tiles: full, slack (nelems < pitch*128) and dead
    (nelems == 0) tiles; per-parent non-decreasing biased bounds with a
    repeated bound (an empty range) and a last bound below SENT in parent
    0 (keys past every bound)."""
    rng = np.random.default_rng(seed)
    nel = [PITCH * LANES, 1000, 0, PITCH * LANES, 77, 0, 2500]
    ntiles = len(nel)
    src_rows = ntiles * PITCH + 8
    raw = rng.integers(0, 2**32, src_rows * LANES, dtype=np.uint64)
    raw = raw.astype(np.uint32)
    # boundary values: the extremes and exact bound hits
    raw[:6] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0xFFFFFFFF, 1]
    biased = _bias_np(raw)
    meta = np.zeros((ntiles + 1) * 3, np.int32)
    for t in range(ntiles):
        meta[3 * t:3 * t + 3] = (t % nparents, t * PITCH, nel[t])
    bounds = []
    for p in range(nparents):
        b = np.sort(rng.choice(biased[: PITCH * LANES], RMAX,
                               replace=False))
        b[2] = b[1]                      # an empty range
        if p != 0:
            b[-1] = SENT
        bounds.append(b)
    raw[7] = (np.int32(bounds[0][3]).view(np.uint32)
              ^ np.uint32(0x80000000))    # a key equal to a bound
    src = raw.view(np.int32) if bias_input else _bias_np(raw)
    return (src.reshape(src_rows, LANES), meta,
            np.concatenate(bounds).astype(np.int32), ntiles)


def _jax_hist(src, meta, bounds, ntiles, bias_input):
    return np.asarray(jk.hist_level(
        jnp.asarray(src), jnp.asarray(meta), jnp.asarray(bounds), ntiles,
        PITCH, RMAX, bias_input=bias_input, interpret=True))


@pytest.mark.parametrize("bias_input,nparents",
                         [(True, 1), (False, 3)])
def test_hist_level_matches_jax(bias_input, nparents):
    src, meta, bounds, ntiles = _level_inputs(1, bias_input, nparents)
    want = _jax_hist(src, meta, bounds, ntiles, bias_input)
    got = tk.hist_level(_t(src), _t(meta), _t(bounds), ntiles, PITCH,
                        RMAX, bias_input=bias_input)
    assert got.dtype == torch.int32 and tuple(got.shape) == (ntiles, RMAX)
    np.testing.assert_array_equal(got.numpy(), want)
    # dead tiles count nothing; slack lanes are not counted
    assert not want[2].any() and not want[5].any()
    assert want[4].sum() <= 77
    if nparents == 1:
        # the digit modes of hist_level and route_level, once
        # (tests/torch_lsb_cases.py)
        check_lsb_kernels_match_jax()


def _route_tables(hist, meta, nparents, drop):
    """Child-major packed destinations, as the engine's level glue lays
    them out: child c = parent*rmax + d, its runs in tile order, a
    CHUNK_ROWS gap after every child; ``drop`` children get dst -1."""
    ntiles = hist.shape[0]
    parent = meta[0:3 * ntiles:3]
    dst = np.full((ntiles, RMAX), -1, np.int32)
    row = 0
    for c in range(nparents * RMAX):
        p, d = divmod(c, RMAX)
        if c in drop:
            continue
        for t in range(ntiles):
            if parent[t] == p:
                dst[t, d] = row
                row += -(-int(hist[t, d]) // LANES)
        row += tk.CHUNK_ROWS
    return dst, row + tk.CHUNK_ROWS


@pytest.mark.parametrize("bias_input,nparents,drop",
                         [(True, 1, (3,)), (False, 3, (1, 12))])
def test_route_level_matches_jax(bias_input, nparents, drop):
    src, meta, bounds, ntiles = _level_inputs(2, bias_input, nparents)
    hist = _jax_hist(src, meta, bounds, ntiles, bias_input)
    dst, dst_rows = _route_tables(hist, meta, nparents, drop)
    # a pad value lies in its own range: the range's upper bound
    parent = meta[0:3 * ntiles:3]
    padv = bounds.reshape(nparents, RMAX)[parent]
    (want,) = jk.route_level(
        (jnp.asarray(src),), jnp.asarray(meta), jnp.asarray(hist),
        jnp.asarray(dst), jnp.asarray(padv), dst_rows, ntiles, PITCH,
        RMAX, nlex=0, bias_input=bias_input, interpret=True)
    (got,) = tk.route_level((_t(src),), _t(meta), _t(bounds), _t(hist),
                            _t(dst), _t(padv), dst_rows, ntiles, PITCH, RMAX,
                            bias_input=bias_input)
    assert tuple(got.shape) == (dst_rows, LANES)
    canon = [tk.canonical_runs((a,), _t(dst), _t(hist), dst_rows)[0].numpy()
             for a in (torch.from_numpy(np.array(want)), got)]
    np.testing.assert_array_equal(canon[1], canon[0])
    assert (dst >= 0).sum() > 0 and np.any(canon[0] != 0)


def _payload(rng, shape, nvals, ties=True):
    """Payload planes.  With ``ties`` (for a sort over every plane) plane
    1 repeats a few values, so that ties on planes 0 and 1 are broken by
    plane 2; without, no tuple ties on the compared planes."""
    vals = [rng.integers(-2**31, 2**31, shape).astype(np.int32)
            for _ in range(nvals)]
    if nvals > 1 and ties:
        vals[0] = rng.integers(0, 4, shape).astype(np.int32)
    return vals


@pytest.mark.parametrize("nplanes,bias_input,nparents,drop",
                         [(2, True, 1, (3,)), (3, False, 3, (1, 12))])
def test_route_level_multiplane_matches_jax(nplanes, bias_input, nparents,
                                            drop):
    """Plane 0 classifies, every plane is stored; pads carry padv in plane
    0 and SENT in the others.  The canonical form sorts each run by the
    whole tuple."""
    src, meta, bounds, ntiles = _level_inputs(6 + nplanes, bias_input,
                                              nparents)
    rng = np.random.default_rng(nplanes)
    srcs = [src] + _payload(rng, src.shape, nplanes - 1)
    hist = _jax_hist(src, meta, bounds, ntiles, bias_input)
    dst, dst_rows = _route_tables(hist, meta, nparents, drop)
    parent = meta[0:3 * ntiles:3]
    padv = bounds.reshape(nparents, RMAX)[parent]
    with lax_network():
        want = jk.route_level(
            tuple(jnp.asarray(p) for p in srcs), jnp.asarray(meta),
            jnp.asarray(hist), jnp.asarray(dst), jnp.asarray(padv),
            dst_rows, ntiles, PITCH, RMAX, nlex=nplanes - 1,
            bias_input=bias_input, interpret=True)
        want = [np.asarray(w) for w in want]
    got = tk.route_level(tuple(_t(p) for p in srcs), _t(meta), _t(bounds),
                         _t(hist), _t(dst), _t(padv), dst_rows, ntiles,
                         PITCH, RMAX, bias_input=bias_input)
    assert len(got) == nplanes
    canon = [tk.canonical_runs(tuple(torch.from_numpy(np.array(a))
                                     for a in arenas), _t(dst), _t(hist),
                               dst_rows)
             for arenas in (want, got)]
    for p in range(nplanes):
        np.testing.assert_array_equal(canon[1][p].numpy(),
                                      canon[0][p].numpy(), err_msg=str(p))
    # the plain version lays runs out as the TPU does: exactly equal
    # inside every stored run
    stored = canon[0][0].numpy() != 0
    for p in range(nplanes):
        np.testing.assert_array_equal(got[p].numpy()[stored],
                                      np.asarray(want[p])[stored])
    # pads reached the payload planes as SENT
    assert np.any(got[1].numpy()[stored] == SENT)


def test_canonical_runs_ignores_order_and_unstored_rows():
    rng = np.random.default_rng(3)
    arena = rng.integers(-2**31, 2**31, (10, LANES)).astype(np.int32)
    dst = np.array([[0, 3, -1]], np.int32)
    cnt = np.array([[300, 128, 50]], np.int32)
    a = torch.from_numpy(arena)
    (c0,) = tk.canonical_runs((a,), _t(dst), _t(cnt), 10)
    shuffled = arena.copy()
    shuffled[0:3] = rng.permutation(arena[0:3].reshape(-1)).reshape(3, -1)
    shuffled[4:] = 0
    (c1,) = tk.canonical_runs((torch.from_numpy(shuffled),), _t(dst),
                              _t(cnt), 10)
    np.testing.assert_array_equal(c0.numpy(), c1.numpy())
    np.testing.assert_array_equal(
        c0.numpy()[0:3].reshape(-1), np.sort(arena[0:3].reshape(-1)))
    assert not c0.numpy()[4:].any()
    # route_level's accumulate mode against the reference's chunked
    # route, through canonical_runs (tests/torch_chunked_cases.py)
    check_accumulate_matches_jax()


def _terminal_case(seed, fill=True, cap=CAP):
    """Buckets in every class incl. XL (occ > cap) and one value-fill
    bucket (keys only, ``fill``); reals below occ*128 (trailing pads
    trimmed)."""
    rng = np.random.default_rng(seed)
    occs = [2 * cap, 3, cap, 0, cap // 2 + 1, 1, max(cap // 4, 1), 9]
    modes = [0, 0, 0, int(fill), 0, 0, 0, 0]
    src_rows = sum(occs) + 2 * CAP + 8
    arena = _bias_np(rng.integers(0, 2**32, src_rows * LANES,
                                  dtype=np.uint64).astype(np.uint32))
    arena[:40] = [SENT, -2**31] * 20
    rows, reals, src_row = 0, [], []
    for occ, mode in zip(occs, modes):
        src_row.append(rows)
        rows += occ
        reals.append(12345 if mode else
                     max(occ * LANES - int(rng.integers(0, LANES)), 0))
    reals = np.array(reals, np.int64)
    off = np.concatenate([[0], np.cumsum(reals)[:-1]])
    caps = [2 * cap, cap, cap // 2, cap // 4]
    occ_a = np.array(occs)
    cls = np.full(len(occs), len(caps) - 1)
    for ci in range(len(caps) - 2, -1, -1):
        cls = np.where((np.array(modes) == 0) & (occ_a > caps[ci + 1]),
                       ci, cls)
    fill = _bias_np(np.array([0, 0, 0, 0xDEADBEEF, 0, 0, 0, 0],
                             np.uint32))
    btbl = np.stack([src_row, occs, reals, modes, fill, off, cls,
                     np.zeros(len(occs))], 1).astype(np.int32)
    n = int(reals.sum())
    return arena.reshape(src_rows, LANES), btbl, caps, n


def test_terminal_write_matches_jax():
    """The terminal per capacity class against the reference's; then the
    v3 kernels, whose terminal launches this kernel
    (``torch_v3_cases.check_v3_kernels_match_jax``)."""
    arena, btbl, caps, n = _terminal_case(4)
    out_rows = -(-n // LANES) + 2 * tk.CHUNK_ROWS + 2
    outs = None
    for ci, cap_c in enumerate(caps):
        outs = jk.terminal_write(
            (jnp.asarray(arena),), jnp.asarray(btbl), out_rows, cap_c,
            nlex=0, unbias_output=True, interpret=True, class_id=ci,
            prev_outs=outs)
    want = np.asarray(outs[0]).reshape(-1)[:n]
    got = torch.empty(n, dtype=torch.int32)
    for ci, cap_c in enumerate(caps):
        tk.terminal_write((_t(arena),), _t(btbl), (got,), cap_c,
                          class_id=ci)
    np.testing.assert_array_equal(got.numpy(), want)
    # the value-fill bucket wrote its unbiased fill value
    o, r = int(btbl[3, 5]), int(btbl[3, 2])
    assert np.all(got.numpy()[o:o + r].view(np.uint32) == 0xDEADBEEF)
    check_v3_kernels_match_jax()


def test_terminal_write_sorts_each_bucket():
    """Plain-version semantics alone: each mode-0 bucket's output is the
    first ``real`` of its sorted keys, unbiased."""
    arena, btbl, caps, n = _terminal_case(5)
    got = torch.empty(n, dtype=torch.int32)
    for ci, cap_c in enumerate(caps):
        tk.terminal_write((_t(arena),), _t(btbl), (got,), cap_c,
                          class_id=ci)
    flat = arena.reshape(-1)
    for row in btbl:
        src_row, occ, real, mode, _, off, cls, _ = (int(x) for x in row)
        if mode == 0 and real > 0:
            occ = min(occ, caps[cls])
            ref = np.sort(flat[src_row * LANES:(src_row + occ) * LANES])
            np.testing.assert_array_equal(
                got.numpy()[off:off + real], ref[:real] ^ np.int32(-2**31))


# the reference's multi-plane networks compile slowly in interpret mode
# (tens of seconds a capacity): one small capacity that clamps every
# bucket; the class chain is covered keys-only above
@pytest.mark.parametrize("nplanes,nlex,cap,unbias", [(2, 1, 1, True),
                                                     (3, 1, 1, False),
                                                     (3, 2, 1, True)])
def test_terminal_write_multiplane_matches_jax(nplanes, nlex, cap, unbias):
    """Tuples sorted lexicographically over planes 0..nlex, every plane
    written, unbiased or not, at one capacity that clamps every
    bucket."""
    arena, btbl, _, _ = _terminal_case(10 + nplanes, fill=False, cap=cap)
    rng = np.random.default_rng(nlex)
    arenas = [arena] + _payload(rng, arena.shape, nplanes - 1,
                                ties=nlex == nplanes - 1)
    # the output holds the clamped buckets exactly
    real = np.minimum(btbl[:, 2], np.minimum(btbl[:, 1], cap) * LANES)
    btbl[:, 2] = real
    btbl[:, 5] = np.cumsum(real) - real
    n = int(real.sum())
    out_rows = -(-n // LANES) + 2 * tk.CHUNK_ROWS + 2
    want = jk.terminal_write(
        tuple(jnp.asarray(a) for a in arenas), jnp.asarray(btbl), out_rows,
        cap, nlex=nlex, unbias_output=unbias, interpret=True)
    got = tuple(torch.empty(n, dtype=torch.int32) for _ in arenas)
    tk.terminal_write(tuple(_t(a) for a in arenas), _t(btbl), got, cap,
                      nlex=nlex, unbias_output=unbias)
    for p in range(nplanes):
        np.testing.assert_array_equal(
            got[p].numpy(), np.asarray(want[p]).reshape(-1)[:n],
            err_msg=str(p))


def test_terminal_write_rejects_fill_with_payload():
    arena, btbl, caps, n = _terminal_case(4)
    outs = (torch.empty(n, dtype=torch.int32),) * 2
    with pytest.raises(ValueError, match="mode 1"):
        tk.terminal_write((_t(arena),) * 2, _t(btbl), outs, caps[-1],
                          class_id=len(caps) - 1)


def _scratch_table(occs, classes, modes):
    """A terminal table of buckets ``occs`` rows long, packed from row 0."""
    occs = np.array(occs)
    src_row = np.cumsum(occs) - occs
    real = occs * LANES - 3
    off = np.cumsum(real) - real
    z = np.zeros(len(occs), np.int64)
    return _t(np.stack([src_row, occs, real, modes, z, off, classes, z],
                       1).astype(np.int32)), int(occs.sum()) * LANES


@pytest.mark.parametrize("cap_rows", [4096, 200])
def test_terminal_scratch_packs_large_buckets(cap_rows):
    """The terminal's global scratch holds, packed in table order, only
    the sorted buckets of the launch's class that the shared tile cannot
    (16K tuples = 128 rows, one plane), each as long as the class
    capacity lets it be; value-fill buckets and other classes take none.
    Which classes take that path at all (``terminal_path``), and the
    cluster path's network (``terminal_geometry``)."""
    btbl, src_len = _scratch_table([300, 40, 1000, 129, 500, 900],
                                   [0, 0, 0, 0, 1, 0], [0, 0, 0, 0, 0, 1])
    soff, total = tk._scratch_offsets(btbl, src_len, cap_rows, 0,
                                      tk.TERM_TILE[1])
    m = [min(o, cap_rows) * LANES for o in (300, 1000, 129)]
    assert total == sum(m)
    assert soff.dtype == torch.int64
    assert soff[[0, 2, 3]].tolist() == [0, m[0], m[0] + m[1]]
    # only a class that fits no cluster of 16 CTAs takes the global path
    # with its scratch: of the engines' classes, v5's 3-plane XL class
    # (cap_rows 4096); the rest sort on 1-16 CTAs
    for (nplanes, cap), want in {
            (1, 256): ("cluster", 1), (1, 2048): ("cluster", 8),
            (1, 4096): ("cluster", 16), (1, 8192): ("global", 0),
            (2, 1024): ("cluster", 8), (3, 1024): ("cluster", 8),
            (3, 2048): ("cluster", 16), (3, 4096): ("global", 0),
            (4, 512): ("cluster", 8), (4, 1024): ("cluster", 16),
            (4, 2048): ("global", 0), (3, 1): ("cluster", 1)}.items():
        assert tk.terminal_path(nplanes, cap) == want, (nplanes, cap)
    # the network the launch is given: (log2 of its tuples, of a CTA's)
    assert [tk.terminal_geometry(p, c) for p, c in
            ((1, 2048), (2, 1024), (3, 1), (4, 2048))] == \
        [(18, 15), (17, 14), (7, 7), (18, 13)]


def _splice_case(seed, nplanes):
    """Runs of a routed arena: row-aligned, ``occ`` rows each (some above
    max_occ, some empty), real counts below occ*128, out offsets
    cumulative as the reference requires."""
    rng = np.random.default_rng(seed)
    max_occ = 6
    occs = [3, 0, 6, 1, 9, 2, 6, 4]
    src_rows = sum(occs) + 16
    src_row = np.concatenate([[0], np.cumsum(occs)[:-1]]) + 2
    real = np.array([max(o * LANES - int(rng.integers(0, 300)), 0)
                     for o in occs])
    real[4] = 9 * LANES                       # clipped to max_occ rows
    real_e = np.minimum(real, np.minimum(occs, max_occ) * LANES)
    off = np.cumsum(real_e) - real_e
    z = np.zeros(len(occs), np.int64)
    btbl = np.stack([src_row, occs, real, z, z, off, z, z],
                    1).astype(np.int32)
    srcs = [rng.integers(-2**31, 2**31, (src_rows, LANES)).astype(np.int32)
            for _ in range(nplanes)]
    return srcs, btbl, max_occ, int(real_e.sum())


@pytest.mark.parametrize("nplanes,unbias", [(1, False), (3, True)])
def test_splice_runs_matches_jax(nplanes, unbias):
    srcs, btbl, max_occ, n = _splice_case(20 + nplanes, nplanes)
    out_rows = -(-n // LANES) + jk.LCH + 1
    want = jk.splice_runs(tuple(jnp.asarray(a) for a in srcs),
                          jnp.asarray(btbl), out_rows, max_occ,
                          unbias_output=unbias, interpret=True)
    got = tk.splice_runs(tuple(_t(a) for a in srcs), _t(btbl), n, max_occ,
                         unbias_output=unbias)
    assert len(got) == nplanes
    for p in range(nplanes):
        np.testing.assert_array_equal(
            got[p].numpy(), np.asarray(want[p]).reshape(-1)[:n])
    # the first run's prefix, unbiased when asked
    x = np.int32(-2**31) if unbias else np.int32(0)
    r0 = int(btbl[0, 2])
    np.testing.assert_array_equal(
        got[0].numpy()[:r0], srcs[0].reshape(-1)[2 * LANES:2 * LANES + r0] ^ x)


def test_lex_order_is_lexicographic_and_stable():
    rng = np.random.default_rng(8)
    cols = [rng.integers(-3, 3, 500).astype(np.int32) for _ in range(3)]
    perm = tk._lex_order([torch.from_numpy(c) for c in cols]).numpy()
    np.testing.assert_array_equal(perm, np.lexsort(cols[::-1]))


def test_wrappers_validate_inputs():
    src = torch.zeros((4, LANES), dtype=torch.int32)
    meta = torch.zeros(6, dtype=torch.int32)
    bounds = torch.zeros(RMAX, dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.hist_level(src.float(), meta, bounds, 1, PITCH, RMAX)
    with pytest.raises(ValueError):
        tk.hist_level(src, meta, bounds[:5], 1, PITCH, RMAX)
    with pytest.raises(ValueError):
        tk.terminal_write((src,), torch.zeros((2, 7), dtype=torch.int32),
                          (torch.zeros(8, dtype=torch.int32),), CAP)
    with pytest.raises(ValueError):        # planes of unequal length
        tk.route_level((src, src[:2]), meta, bounds,
                       torch.zeros((1, RMAX), dtype=torch.int32),
                       torch.zeros((1, RMAX), dtype=torch.int32),
                       torch.zeros((1, RMAX), dtype=torch.int32),
                       4, 1, PITCH, RMAX)
    with pytest.raises(ValueError):        # at most four planes
        tk.splice_runs((src,) * 5, torch.zeros((1, 8), dtype=torch.int32),
                       8, 4)
    before = dict(tk.LAUNCHES)
    tk.hist_level(src, meta, bounds, 1, PITCH, RMAX)
    assert tk.LAUNCHES == before      # plain versions count no launches
    _check_level_widths()


def _check_level_widths():
    """The level kernels' widths on the card (ROADMAP C16): count tables
    a warp up to 1,683 ranges or 1,117 digits (with mask tables), one
    shared count table (range mode) up to 3,979 ranges; wider ones
    are refused with a ValueError by the engines' geometry, before
    anything is allocated or launched; v3_rmax 2,500 (past the first
    range route's 48 KiB) and 10-bit digits sort (here on the plain
    versions)."""
    from inplacemsdradixsort_tpu_torch import SortConfig, sort
    from inplacemsdradixsort_tpu_torch.ops import (engine_lsb, engine_v4,
                                                   engine_v5)
    assert (tk.route_max_rmax(True, 16), tk.route_max_rmax(False, 16),
            tk.route_max_rmax(False, 1)) == (1117, 1683, 3979)
    assert tk.route_layout(96) == (16, 67334)
    assert tk.route_layout(256, True) == (16, 91140)
    assert tk.route_layout(1684)[0] == 1
    assert tk.hist_layout(96) == (16, 14722)
    assert tk.hist_layout(1024, True)[0] == 8
    for rmax, digit in ((1118, True), (3980, False)):
        with pytest.raises(ValueError, match="shared memory"):
            tk.route_layout(rmax, digit)
    with pytest.raises(ValueError, match="shared memory"):
        tk.hist_layout(29057, True)
    wide = SortConfig(v3_rmax=3980, v3_sort_rows=8192)
    for geometry in (engine_v4._dev_geometry, engine_v5._v5_geometry):
        with pytest.raises(ValueError, match="v3_rmax"):
            geometry(1 << 20, 1, wide)
    with pytest.raises(ValueError, match="lsb_digit_bits"):
        engine_lsb._geometry(1 << 20, 11, 4096)
    with pytest.raises(ValueError, match="lsb_digit_bits"):
        sort(torch.zeros(1 << 15, dtype=torch.int32), config=SortConfig(
            engine="lsb", lsb_digit_bits=11, v3_sort_rows=4096,
            min_engine_n=1))
    x = np.random.default_rng(16).integers(0, 2**32, 70_000,
                                           dtype=np.uint32)
    for cfg in (dict(engine="v4", v3_rmax=2500, v3_sort_rows=2560),
                dict(engine="lsb", lsb_digit_bits=10, v3_sort_rows=2048)):
        res = sort(torch.from_numpy(x),
                   config=SortConfig(min_engine_n=1, **cfg))
        np.testing.assert_array_equal(res.keys.numpy(), np.sort(x))
