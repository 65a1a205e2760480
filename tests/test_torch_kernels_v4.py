"""The port's v4 kernels (plain PyTorch versions, CPU) against the JAX
Pallas kernels in interpret mode, at the tiny tile geometry
(v3_sort_rows=32, v3_rmax=8, v3_cap_rows=32).

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
    got = tk.route_level(_t(src), _t(meta), _t(bounds), _t(hist), _t(dst),
                         _t(padv), dst_rows, ntiles, PITCH, RMAX,
                         bias_input=bias_input)
    assert tuple(got.shape) == (dst_rows, LANES)
    canon = [tk.canonical_runs(a, _t(dst), _t(hist), dst_rows).numpy()
             for a in (torch.from_numpy(np.array(want)), got)]
    np.testing.assert_array_equal(canon[1], canon[0])
    assert (dst >= 0).sum() > 0 and np.any(canon[0] != 0)


def test_canonical_runs_ignores_order_and_unstored_rows():
    rng = np.random.default_rng(3)
    arena = rng.integers(-2**31, 2**31, (10, LANES)).astype(np.int32)
    dst = np.array([[0, 3, -1]], np.int32)
    cnt = np.array([[300, 128, 50]], np.int32)
    a = torch.from_numpy(arena)
    c0 = tk.canonical_runs(a, _t(dst), _t(cnt), 10)
    shuffled = arena.copy()
    shuffled[0:3] = rng.permutation(arena[0:3].reshape(-1)).reshape(3, -1)
    shuffled[4:] = 0
    c1 = tk.canonical_runs(torch.from_numpy(shuffled), _t(dst), _t(cnt), 10)
    np.testing.assert_array_equal(c0.numpy(), c1.numpy())
    np.testing.assert_array_equal(
        c0.numpy()[0:3].reshape(-1), np.sort(arena[0:3].reshape(-1)))
    assert not c0.numpy()[4:].any()


def _terminal_case(seed):
    """Buckets in every class incl. XL (occ > CAP) and one value-fill
    bucket; reals below occ*128 (trailing pads trimmed)."""
    rng = np.random.default_rng(seed)
    occs = [2 * CAP, 3, CAP, 0, CAP // 2 + 1, 1, CAP // 4, 9]
    modes = [0, 0, 0, 1, 0, 0, 0, 0]
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
    caps = [2 * CAP, CAP, CAP // 2, CAP // 4]
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
        tk.terminal_write(_t(arena), _t(btbl), got, cap_c, class_id=ci)
    np.testing.assert_array_equal(got.numpy(), want)
    # the value-fill bucket wrote its unbiased fill value
    o, r = int(btbl[3, 5]), int(btbl[3, 2])
    assert np.all(got.numpy()[o:o + r].view(np.uint32) == 0xDEADBEEF)


def test_terminal_write_sorts_each_bucket():
    """Plain-version semantics alone: each mode-0 bucket's output is the
    first ``real`` of its sorted keys, unbiased."""
    arena, btbl, caps, n = _terminal_case(5)
    got = torch.empty(n, dtype=torch.int32)
    for ci, cap_c in enumerate(caps):
        tk.terminal_write(_t(arena), _t(btbl), got, cap_c, class_id=ci)
    flat = arena.reshape(-1)
    for row in btbl:
        src_row, occ, real, mode, _, off, cls, _ = (int(x) for x in row)
        if mode == 0 and real > 0:
            occ = min(occ, caps[cls])
            ref = np.sort(flat[src_row * LANES:(src_row + occ) * LANES])
            np.testing.assert_array_equal(
                got.numpy()[off:off + real], ref[:real] ^ np.int32(-2**31))


def test_wrappers_validate_inputs():
    src = torch.zeros((4, LANES), dtype=torch.int32)
    meta = torch.zeros(6, dtype=torch.int32)
    bounds = torch.zeros(RMAX, dtype=torch.int32)
    with pytest.raises(TypeError):
        tk.hist_level(src.float(), meta, bounds, 1, PITCH, RMAX)
    with pytest.raises(ValueError):
        tk.hist_level(src, meta, bounds[:5], 1, PITCH, RMAX)
    with pytest.raises(ValueError):
        tk.terminal_write(src, torch.zeros((2, 7), dtype=torch.int32),
                          torch.zeros(8, dtype=torch.int32), CAP)
    before = dict(tk.LAUNCHES)
    tk.hist_level(src, meta, bounds, 1, PITCH, RMAX)
    assert tk.LAUNCHES == before      # plain versions count no launches
