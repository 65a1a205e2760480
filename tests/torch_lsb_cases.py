"""The LSB engine's CPU checks against the JAX package and numpy, run
inside existing tests: each added test item would push the tier-1
collection past 383, which changes how xdist's ``load`` scheduler deals
the reference's slow tests (ROADMAP.md A0).  Hosts:
``test_torch_kernels_v4.py::test_hist_level_matches_jax`` (its first
case) runs ``check_lsb_kernels_match_jax``;
``test_torch_engine_v4.py::test_not_implemented`` (its "lsb" case, the
engine that test found missing before) runs ``check_sort_lsb_matches_jax``
and ``check_lsb_api_against_numpy``.

Kernels (``check_lsb_kernels_match_jax``): the digit modes of the port's
``hist_level`` and ``route_level`` (plain PyTorch versions, CPU) against
the JAX Pallas kernels in interpret mode, at the reference tests'
geometry (v3_sort_rows=32, lsb_digit_bits=4: 16 digits, pitch 16), on
one source of three tiles (two full, the last with slack) shaped as
``sort_lsb`` shapes a 6,000-element pass.  Shifts 0 and 28 (a third of
the keys >= 2^31: the top digit), keys only; and digit plane 1 of two
planes (the u64 case's first pass).  Exact: the hist counts, and the arenas
on every run row, real prefix and pads, with no canonical form: the
digit mode's order is part of its contract.  The reference's route runs
with ``lax.sort`` as its in-tile sort (``torch_parity.lax_network``;
its digit-mode composite is unique, so the order is the network's), since
the network's interpret-mode compile takes 30 s a shape.

``sort_lsb`` (``check_sort_lsb_matches_jax``): the port's against the
reference's on the same arrays, bitwise: keys only, (key, payload) pairs
with 50 distinct keys and a permuted payload (stable by key), both at
key_bits=8 (two passes), and u64 keys as (hi, lo) planes with 36
significant bits, half of them on one hi word (nine passes, the lo word
first).

The port alone (``check_lsb_api_against_numpy``): ``api.sort(engine=
"lsb")`` for every key type with u32 and u64 rids, ties in input order
(``np.argsort(kind="stable")``); 6-bit digits with keys >= 2^31 (the last
pass's shift + bits passes 32); a digit-heavy input (3 distinct digits);
and the small-n path.
"""

import numpy as np
import torch

import jax.numpy as jnp

from inplacemsdradixsort_tpu.config import SortConfig as JConfig
from inplacemsdradixsort_tpu.ops import engine_lsb as jl
from inplacemsdradixsort_tpu.ops import kernels_v4 as jk
from torch_parity import lax_network

import inplacemsdradixsort_tpu_torch as rt
from inplacemsdradixsort_tpu_torch.config import SortConfig
from inplacemsdradixsort_tpu_torch.ops import engine_lsb as tl
from inplacemsdradixsort_tpu_torch.ops import kernels_v4 as tk
from inplacemsdradixsort_tpu_torch.ops.engine_v4 import _level_tables

SORT_ROWS, BITS, N = 32, 4, 6000
LANES = 128
GEOM = dict(v3_sort_rows=SORT_ROWS, lsb_digit_bits=BITS, min_engine_n=512)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _pass_inputs(planes_u32, bits, sort_rows):
    """The dense source planes, tile table and arena rows of one pass of
    ``sort_lsb`` over ``planes_u32``: the reference's geometry."""
    n = len(planes_u32[0])
    pitch, ntiles, arena_rows = tl._geometry(n, bits, sort_rows)
    rows = ntiles * pitch
    src = [np.zeros(rows * LANES, np.int32) for _ in planes_u32]
    for s, p in zip(src, planes_u32):
        s[:n] = p.view(np.int32)
    meta = tl._meta(n, ntiles, pitch, "cpu").numpy()
    return ([s.reshape(rows, LANES) for s in src], meta, pitch, ntiles,
            arena_rows)


def _check_pass(planes_u32, shift, dp, bits, sort_rows):
    src, meta, pitch, ntiles, arena_rows = _pass_inputs(planes_u32, bits,
                                                        sort_rows)
    nbins = 1 << bits
    bounds = np.arange(nbins, dtype=np.int32)
    want_h = np.asarray(jk.hist_level(
        jnp.asarray(src[dp]), jnp.asarray(meta), jnp.asarray(bounds), ntiles,
        pitch, nbins, interpret=True, digit_shift=shift, digit_bits=bits))
    got_h = tk.hist_level(_t(src[dp]), _t(meta), _t(bounds), ntiles, pitch,
                          nbins, digit_shift=shift, digit_bits=bits)
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    h = torch.from_numpy(want_h)
    _, _, _, dst = _level_tables(h, torch.ones(nbins, dtype=torch.int32),
                                 tk.CHUNK_ROWS)
    padv = (np.arange(nbins, dtype=np.uint64) << np.uint64(shift)).astype(
        np.uint32).view(np.int32)
    padv = np.ascontiguousarray(np.broadcast_to(padv, (ntiles, nbins)))
    with lax_network():
        want = jk.route_level(
            tuple(jnp.asarray(s) for s in src), jnp.asarray(meta),
            jnp.asarray(want_h), jnp.asarray(dst.numpy()), jnp.asarray(padv),
            arena_rows, ntiles, pitch, nbins, nlex=0, interpret=True,
            digit_shift=shift, digit_bits=bits, digit_plane=dp)
    got = tk.route_level(tuple(_t(s) for s in src), _t(meta), _t(bounds), h,
                         dst, _t(padv), arena_rows, ntiles, pitch, nbins,
                         digit_shift=shift, digit_bits=bits, digit_plane=dp)
    rix, _ = tk.run_rows(dst, h)
    assert rix.numel() > ntiles          # runs of several rows
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[rix].numpy(), np.asarray(w)[rix])
    return want_h


def _inputs():
    rng = np.random.default_rng(71)
    keys = rng.integers(0, 2**32, N, dtype=np.uint32)
    keys[::3] |= np.uint32(0xF0000000)       # the top digit, keys >= 2^31
    return rng, keys


def check_lsb_kernels_match_jax():
    rng, keys = _inputs()
    for shift in (0, 28):
        h = _check_pass([keys], shift, 0, BITS, SORT_ROWS)
        assert (h > 0).sum() >= 16
    hi = rng.integers(0, 16, N, dtype=np.uint32)
    lo = rng.integers(0, 2**32, N, dtype=np.uint32)
    _check_pass([hi, lo], 0, 1, BITS, SORT_ROWS)


def _run_both(planes_u32, nkey, key_bits, geom):
    want = jl.sort_lsb(jnp.asarray(planes_u32[0]),
                       tuple(jnp.asarray(p) for p in planes_u32[1:]),
                       JConfig(interpret=True, **geom), nkey=nkey,
                       key_bits=key_bits)
    got = tl.sort_lsb(torch.from_numpy(planes_u32[0].view(np.int32)),
                      tuple(torch.from_numpy(p.view(np.int32))
                            for p in planes_u32[1:]),
                      SortConfig(**geom), nkey=nkey, key_bits=key_bits)
    for g, w in zip((got[0],) + got[1], (want[0],) + tuple(want[1])):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))
    return [g.numpy().view(np.uint32) for g in (got[0],) + got[1]]


def check_sort_lsb_matches_jax():
    rng = np.random.default_rng(73)
    x = rng.integers(0, 256, N, dtype=np.uint32)
    with lax_network():
        (out,) = _run_both([x], 1, 8, GEOM)
        np.testing.assert_array_equal(out, np.sort(x))
        k = rng.integers(0, 50, N, dtype=np.uint32)
        v = rng.permutation(N).astype(np.uint32)
        ok, ov = _run_both([k, v], 1, 8, GEOM)
        perm = np.argsort(k, kind="stable")
        np.testing.assert_array_equal(ok, k[perm])
        np.testing.assert_array_equal(ov, v[perm])
        x64 = rng.integers(0, 2**36, N, dtype=np.uint64)
        x64[: N // 2] = (x64[: N // 2] & np.uint64(0xFFFFFFFF)) | (
            np.uint64(0xA) << np.uint64(32))
        hi = (x64 >> np.uint64(32)).astype(np.uint32)
        lo = (x64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        ohi, olo = _run_both([hi, lo], 2, 36, GEOM)
        np.testing.assert_array_equal(
            (ohi.astype(np.uint64) << np.uint64(32)) | olo, np.sort(x64))


def _stable_order(x):
    if x.dtype == np.float32:       # IEEE total order: -0 < +0, NaN last
        u = x.view(np.uint32)
        x = np.where(u >> 31, ~u, u | np.uint32(0x80000000))
    return np.argsort(x, kind="stable")


def check_lsb_api_against_numpy():
    rng = np.random.default_rng(75)
    n = 20_000
    cfg = SortConfig(engine="lsb", **GEOM)
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[:6] = [0.0, -0.0, np.nan, -np.inf, np.inf, -0.0]
    keys = {"u32": rng.integers(0, 40, n, dtype=np.uint32) * 0x04000001,
            "i32": rng.integers(-30, 30, n).astype(np.int32) * 65599,
            "f32": f32,
            "u64": rng.choice(np.array([0, 7, 2**40, 2**64 - 1], np.uint64),
                              n),
            "i64": rng.integers(-5, 5, n).astype(np.int64) << np.int64(33)}
    rids = {"u32": rng.permutation(n).astype(np.uint32),
            "u64": rng.permutation(n).astype(np.uint64) << np.uint64(32)}
    for kind, x in keys.items():
        order = _stable_order(x)
        res = rt.sort(torch.from_numpy(x), config=cfg)
        np.testing.assert_array_equal(res.keys.numpy().view(x.dtype),
                                      x[order])
        assert not res.synced
        for rk, r in rids.items():
            res = rt.sort(torch.from_numpy(x), torch.from_numpy(r),
                          config=cfg)
            np.testing.assert_array_equal(res.keys.numpy().view(x.dtype),
                                          x[order])
            np.testing.assert_array_equal(res.rids.numpy(), r[order],
                                          err_msg=f"{kind} + {rk}")
    # 6-bit digits: the last pass over a word has shift 30, where an
    # arithmetic shift would leak sign bits into the digit
    x = rng.integers(2**31, 2**32, n, dtype=np.uint32)
    x[::5] = rng.integers(0, 2**31, n // 5, dtype=np.uint32)
    res = rt.sort(torch.from_numpy(x), config=SortConfig(
        engine="lsb", v3_sort_rows=128, lsb_digit_bits=6, min_engine_n=512))
    np.testing.assert_array_equal(res.keys.numpy(), np.sort(x))
    assert tl._pass_schedule(1, 6)[-1] == (0, 30)
    # 3 distinct digits in every pass: a tile's runs are long and stable
    k = rng.integers(0, 3, n, dtype=np.uint32) * np.uint32(0x01010101)
    r = np.arange(n, dtype=np.uint32)[::-1].copy()
    res = rt.sort(torch.from_numpy(k), torch.from_numpy(r), config=cfg)
    np.testing.assert_array_equal(res.rids.numpy(), r[_stable_order(k)])
    # below min_engine_n: a stable sort by the key planes
    res = rt.sort(torch.from_numpy(k[:300]), torch.from_numpy(r[:300]),
                  config=cfg)
    np.testing.assert_array_equal(res.rids.numpy(),
                                  r[:300][_stable_order(k[:300])])
