"""The port's v1 kernels (plain PyTorch versions, CPU) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs, at
the reference tests' tiny geometry (8-row tiles of 1024 elements, 8
ranges), keys only and pairs:

- ``tile_sort``: sorted tiles and counts, with slack tiles (data count
  below the tile, and 0), duplicates and keys equal to 0xFFFFFFFF;
- ``distribute``: every stored run's rows, runs that end mid-row;
- ``ragged_sort``: every live bucket, with a pad below the class and
  pad-0 dummy buckets on one slack region;
- ``compact``: the first n elements, segments whose lengths are not
  multiples of 128;
- ``bitonic_sort`` against the reference network, ties included.

Only the defined rows of an arena are compared
(``pallas_kernels.defined_elems``); comparisons are exact.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inplacemsdradixsort_tpu.ops import bitonic as jbit
from inplacemsdradixsort_tpu.ops import pallas_kernels as jpk
from inplacemsdradixsort_tpu_torch.config import SortConfig
from inplacemsdradixsort_tpu_torch.ops import bitonic as tbit
from inplacemsdradixsort_tpu_torch.ops import pallas_kernels as tpk

LANES = 128
TR = 8                       # tile rows (1024-element tiles)
R = 8                        # ranges per tile
SENT = 0x7FFFFFFF
PAIRS = (False, True)        # keys only, then (key, val) pairs


def _arena(rows, seed, dup=False):
    """(rows, 128) biased int32 keys with ties and biased 0xFFFFFFFF."""
    rng = np.random.default_rng(seed)
    hi = 40 if dup else 2**32
    raw = rng.integers(0, hi, rows * LANES, dtype=np.uint32)
    raw[rng.random(rows * LANES) < 0.05] = 0xFFFFFFFF
    return (raw ^ np.uint32(0x80000000)).view(np.int32).reshape(rows, LANES)


def _vals(rows, seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(-2**31, 2**31, rows * LANES).astype(np.int32)
    v[rng.random(rows * LANES) < 0.05] = SENT
    return v.reshape(rows, LANES)


def _pair(pairs, rows, seed, dup=True):
    k = _arena(rows, seed, dup)
    return k, (_vals(rows, seed + 1) if pairs else None)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x, np.int32))


def _check_defined(name, targs, got, want):
    mask = tpk.defined_elems(name, targs, got[0].numel()).numpy()
    for g, w in zip(got[:2], want[:2]):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy().reshape(-1)[mask],
                                          np.asarray(w).reshape(-1)[mask])


def test_bitonic_sort_and_bias_match_jax():
    """Ties of keys, and of whole (key, val) tuples, sort as the
    reference network sorts them, and ``bitonic_merge`` merges as the
    reference's merge stage does; the key bias round-trips as the
    reference's does."""
    rng = np.random.default_rng(2)
    for pairs in PAIRS:
        k = rng.integers(-3, 3, (2, 8, LANES)).astype(np.int32)
        k[0, 0, :5] = SENT
        v = rng.integers(-2, 2, (2, 8, LANES)).astype(np.int32) if pairs \
            else None
        gk, gv = tbit.bitonic_sort(_t(k), _t(v))
        for b in range(2):
            wk, wv = jbit.bitonic_sort(_j(k[b]),
                                       _j(None if v is None else v[b]))
            np.testing.assert_array_equal(gk[b].numpy(), np.asarray(wk))
            if pairs:
                np.testing.assert_array_equal(gv[b].numpy(), np.asarray(wv))
    # the merge stage alone: on bitonic blocks (it sorts them) and on
    # arbitrary ones (it gives what the network's steps give)
    for rows in (1, 4):
        k = rng.integers(-3, 3, (rows, LANES)).astype(np.int32)
        v = rng.integers(-2, 2, (rows, LANES)).astype(np.int32)
        h = rows * LANES // 2
        kb = np.concatenate([np.sort(k.reshape(-1)[:h]),
                             np.sort(k.reshape(-1)[h:])[::-1]])
        for kk, vv in ((kb.reshape(rows, LANES), None), (k, v), (k, None)):
            gk, gv = tbit.bitonic_merge(_t(kk), _t(vv))
            wk, wv = jbit.bitonic_merge(_j(kk), _j(vv))
            np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
            if vv is not None:
                np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(
            tbit.bitonic_merge(_t(kb))[0].numpy().reshape(-1), np.sort(kb))
    x = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    b = tbit.bias_u32(torch.from_numpy(x))
    np.testing.assert_array_equal(b.numpy(), np.asarray(
        jbit.bias_u32(jnp.asarray(x))))
    np.testing.assert_array_equal(tbit.unbias_u32(b).numpy(), x)


def test_tile_sort_matches_jax():
    """Sorted tiles (slack tiles masked to SENT) and cnt, every column,
    keys and pairs, spread and duplicate keys.  The wrapper's single-pass
    limits (it zeroes the counts of a tile sorted in several runs) are
    the CUDA source's: 8 CTAs of 1024 threads, 32 keys or 16 pairs a
    thread."""
    src = (Path(tpk.__file__).parents[1] / "csrc" /
           "pallas_kernels.cu").read_text()
    c = {k: int(v) for k, v in re.findall(
        r"constexpr int (RS_THREADS|RS_TUPLES|RS_CLOG_MAX) = (\d+);", src)}
    for planes in (1, 2):
        assert tpk.TILE_SORT_RUN[planes] == (
            c["RS_THREADS"] * c["RS_TUPLES"] // planes << c["RS_CLOG_MAX"])
    ntiles = 5
    data = np.array([1024, 700, 0, 1024, 129], np.int32)
    for pairs in PAIRS:
        for dup in (False, True):
            k, v = _pair(pairs, ntiles * TR, 10 + dup, dup)
            rng = np.random.default_rng(4)
            bounds = np.sort(rng.integers(-2**31, 2**31, (ntiles, R)),
                             axis=1).astype(np.int32)
            bounds[:, -1] = SENT
            bounds[3] = np.sort(k[3 * TR:4 * TR].reshape(-1))[::128][:R]
            want = jpk.tile_sort(_j(k), _j(v), _j(bounds), _j(data), TR,
                                 interpret=True)
            got = tpk.tile_sort(_t(k), _t(v), _t(bounds), _t(data), TR)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _runs(ntiles, data, rng):
    """Runs of sorted tiles laid out as the engine lays them: each tile's
    first data[t] elements cut into R runs; slots packed per range, each
    range's slots followed by 8 rows of slack (``block_rows``: the
    reference's chunked stores overshoot a run by up to 7 rows, which
    only the next tile's run of the range, stored later, or this slack
    absorbs)."""
    lens = np.zeros((ntiles, R), np.int64)
    for t in range(ntiles):
        cuts = np.sort(rng.integers(0, data[t] + 1, R - 1))
        lens[t] = np.diff(np.concatenate([[0], cuts, [data[t]]]))
    starts = np.cumsum(lens, 1) - lens
    srows = (lens + LANES - 1) // LANES
    within = np.cumsum(srows, 0) - srows
    base = np.cumsum(srows.sum(0) + 8) - (srows.sum(0) + 8)
    slot = base[None, :] + within
    out_rows = int(base[-1] + srows[:, -1].sum() + 8)
    return slot, starts, lens, out_rows


def test_distribute_matches_jax():
    """Every stored run's rows: the run, then SENT to its row's end,
    keys and pairs."""
    ntiles = 4
    for pairs in PAIRS:
        k, v = _pair(pairs, ntiles * TR, 20)
        slot, starts, lens, out_rows = _runs(
            ntiles, [1024, 777, 0, 300], np.random.default_rng(5))
        want = jpk.distribute(_j(k), _j(v), _j(slot.astype(np.int32)),
                              _j(starts.astype(np.int32)),
                              _j(lens.astype(np.int32)), out_rows, TR,
                              interpret=True)
        targs = dict(keys=_t(k), vals=_t(v), slot_rows=_t(slot),
                     run_starts=_t(starts), run_lens=_t(lens),
                     out_rows=out_rows, tile_rows=TR)
        got = tpk.distribute(**targs)
        assert tpk.defined_elems("distribute", targs,
                                 out_rows * LANES).sum() \
            == int(((lens + 127) // 128).sum()) * LANES
        _check_defined("distribute", targs, got, want)


def test_ragged_sort_matches_jax():
    """Live buckets (one full, one with its pad below the class at 300
    elements) sorted, their tails SENT; two pad-0 dummies on the slack
    region, which the port leaves alone; keys and pairs."""
    crows = 16
    starts = np.array([0, 2 * crows, 4 * crows, 4 * crows], np.int32)
    pads = np.array([crows * LANES, 300, 0, 0], np.int32)
    for pairs in PAIRS:
        k, v = _pair(pairs, 5 * crows, 30)
        want = jpk.ragged_sort(_j(k), _j(v), _j(starts), _j(pads), crows,
                               interpret=True)
        targs = dict(keys=_t(k), vals=_t(v), starts_row=_t(starts),
                     pad_elems=_t(pads), class_rows=crows)
        got = tpk.ragged_sort(**targs)
        _check_defined("ragged_sort", targs, got, want)
        for g, x in zip(got, (k, v)):
            if g is not None:
                np.testing.assert_array_equal(g.numpy()[4 * crows:],
                                              x[4 * crows:])


def test_compact_matches_jax():
    """Valid prefixes of segments of 200, 5, 129 and 1 elements, in
    segment order, keys and pairs.  The arena holds chr_rows rows past
    the last segment's start, as the engine's arenas do: the reference
    reads whole chunks."""
    starts = np.array([0, 3, 10, 20], np.int32)
    lens = np.array([200, 5, 129, 1], np.int32)
    n = int(lens.sum())
    out_rows = -(-n // LANES) + 8 + 1
    for pairs in PAIRS:
        k, v = _pair(pairs, 20 + 8, 40, dup=False)
        want = jpk.compact(_j(k), _j(v), _j(starts), _j(lens), out_rows,
                           interpret=True)
        targs = dict(keys=_t(k), vals=_t(v), starts_row=_t(starts),
                     lens=_t(lens), out_rows=out_rows)
        got = tpk.compact(**targs)
        _check_defined("compact", targs, got, want)


def test_v1_refuses_bad_configs_and_tables():
    """The reference's SortConfig checks, the v1 fields' defaults, and
    ``distribute``'s table limit 3 * R <= 1024, which the reference
    asserts (range_bits <= 8).  Tables that place a run, slot, live
    bucket or segment outside its arena raise ValueError before either
    version runs, with the same message whether ``compact``'s tables lie
    on the host or on the card; pad-0 dummy buckets may point anywhere."""
    with pytest.raises(ValueError, match="num_ranges"):
        tpk.distribute(_t(np.zeros((8, LANES))), None,
                       *(_t(np.zeros((1, 512))),) * 3, 16, TR)
    k = _t(np.zeros((2 * TR, LANES)))
    z = np.zeros((2, R))
    for slot, start, ln, what in ((z, z + 1000, z + 100, "run"),
                                  (z, z - 1, z + 1, "run"),
                                  (z + 15, z, z + 200, "slot")):
        with pytest.raises(ValueError, match=what):
            tpk.distribute(k, k.clone(), _t(slot), _t(start), _t(ln), 16,
                           TR)
    for starts, pads in (([0, 12], [5, 1]), ([-1], [1])):
        with pytest.raises(ValueError, match="bucket"):
            tpk.ragged_sort(k, None, _t(starts), _t(pads), 8)
    tpk.ragged_sort(k, None, _t([0, 99, -5]), _t([5, 0, 0]), 8)
    for starts, lens, what in (([15], [200], "segment"),
                               ([0], [-1], "lengths"),
                               ([0, 8], [1024, 1024], "lengths")):
        with pytest.raises(ValueError, match=what):
            tpk.compact(k, None, _t(starts), _t(lens), 8)
        # the checks of tables on the card (torch reductions, their flags
        # read at once) refuse with the same message as those on the host
        msgs = []
        for st, ln in ((np.array(starts, np.int64), np.array(lens, np.int64)),
                       (torch.tensor(starts).long(), torch.tensor(lens).long())):
            with pytest.raises(ValueError) as e:
                tpk._refuse("compact", *tpk._compact_checks(
                    st, ln, 8, k.numel()))
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] and what in msgs[0]
    cfg = SortConfig()
    assert (cfg.tile_elems, cfg.block_rows, cfg.range_bits,
            cfg.tile_rows) == (1 << 15, 8, 8, 256)
    with pytest.raises(ValueError, match="tile_elems"):
        SortConfig(tile_elems=1000)
    for bits in (0, 13):
        with pytest.raises(ValueError, match="range_bits"):
            SortConfig(range_bits=bits)
