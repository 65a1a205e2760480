"""The chunked sort's CPU checks against the JAX package and numpy, run
inside existing tests (each added item would push the tier-1 collection
past 383; ROADMAP.md A0).  Hosts: ``test_torch_kernels_v4.py``'s
``test_canonical_runs_ignores_order_and_unstored_rows`` runs
``check_accumulate_matches_jax``;
``test_torch_api.py::test_engine_pallas_routing`` runs
``check_sort_external_matches_jax``.

Accumulate (``check_accumulate_matches_jax``): two chunks of (key,
payload) pairs routed into one SENT-filled arena, by the port's
``route_level(arenas=...)`` (through ``chunked._route_into``, plain
version on the CPU) and by the reference's ``chunked._route_into``
(interpret mode, ``lax.sort`` as its in-tile sort:
``torch_parity.lax_network``), on the same tables: bounds from one numpy
sample, both packages' exact histograms (required equal) and the
range-major layout.  The arenas are compared through ``canonical_runs``
on the runs of both calls (order inside a run is not part of the range
mode's contract); every other row of the port's arena is still SENT.
The reference's arena is not compared there: its 64-row chunk stores
overshoot into the gaps.

``sort_external`` (``check_sort_external_matches_jax``):
``_bounds_from_sample`` equal to the reference's on one numpy sample;
then the concatenated pieces of the port and of the reference bitwise
equal (they do not depend on the sample: each range is contiguous and
fully sorted) at 25,000 elements in 3 chunks, keys only and with a
payload plane (lexicographic by (key, payload)), at the reference tests'
geometry (v3_sort_rows=32, v3_rmax=8, v3_cap_rows=32; 4 ranges, rmax
class 16, pitch 16), and equal to numpy.  There ``min_engine_n`` is
raised to 2^18, so that both packages sort each range's 2^17-element
window on their library tier (the reference's interpret-mode v4
pipeline takes ~16 s here).  Then once with ``min_engine_n`` lowered, so
that each range's local sort runs the v4 pipeline, as
``tests/test_chunked.py::test_local_v4_engine`` does (the port against
numpy there: that test holds the reference's).
"""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from inplacemsdradixsort_tpu.config import SortConfig as JConfig
from inplacemsdradixsort_tpu.ops import chunked as jc
from inplacemsdradixsort_tpu.ops import kernels_v4 as jk
from torch_parity import lax_network

from inplacemsdradixsort_tpu_torch.config import SortConfig
from inplacemsdradixsort_tpu_torch.ops import chunked as tc
from inplacemsdradixsort_tpu_torch.ops import kernels_v4 as tk
from inplacemsdradixsort_tpu_torch.ops.plan_util import _bias_np

GEOM = dict(v3_sort_rows=32, v3_rmax=8, v3_cap_rows=32)
LANES = 128


def _tables(chunks, rmax, bounds_biased, pitch):
    """Per chunk: (meta, ntiles, the reference's hist, the port's hist)."""
    out = []
    for planes in chunks:
        n = len(planes[0])
        meta, ntiles = tc._chunk_meta(n, pitch, "cpu")
        k2d = jc._to2d((jnp.asarray(planes[0]),), ntiles * pitch)[0]
        want = np.asarray(jk.hist_level(
            k2d, jnp.asarray(meta.numpy()), jnp.asarray(bounds_biased),
            ntiles, pitch, rmax, bias_input=True, interpret=True))
        got = tk.hist_level(torch.from_numpy(planes[0].view(np.int32)),
                            meta, torch.from_numpy(bounds_biased), ntiles,
                            pitch, rmax, bias_input=True)
        np.testing.assert_array_equal(got.numpy(), want)
        out.append((meta, ntiles, want))
    return out


def check_accumulate_matches_jax():
    rng = np.random.default_rng(81)
    chunks = [(rng.integers(0, 2**32, n, dtype=np.uint32),
               rng.integers(0, 2**32, n, dtype=np.uint32))
              for n in (5000, 2900)]
    sample = np.concatenate([c[0][:700] for c in chunks])
    bounds, _, _ = tc._bounds_from_sample(sample, 4)
    rmax = tc._rmax_class(len(bounds))
    bounds_pad = np.full(rmax, 0xFFFFFFFF, np.uint64)
    bounds_pad[: len(bounds)] = bounds
    bb = _bias_np(bounds_pad.astype(np.uint32))
    pitch = GEOM["v3_sort_rows"] - rmax
    tabs = _tables(chunks, rmax, bb, pitch)
    lay = tc._layout([t[2] for t in tabs], rmax)
    rows = lay["arena_rows"]
    want = tuple(jnp.full((rows, LANES), jk.SENT, jnp.int32)
                 for _ in range(2))
    got = tuple(torch.full((rows, LANES), tk.SENT, dtype=torch.int32)
                for _ in range(2))
    dsts, cnts = [], []
    with lax_network():
        for i, (planes, (meta, ntiles, h)) in enumerate(zip(chunks, tabs)):
            rr = lay["rrows"][i]
            dst = (lay["range_start"][None, :] + lay["chunk_base"][i][None, :]
                   + np.cumsum(rr, axis=0) - rr).astype(np.int32)
            padv = np.ascontiguousarray(np.broadcast_to(bb, (ntiles, rmax)))
            want = jc._route_into(
                want, jc._to2d(tuple(jnp.asarray(p) for p in planes),
                               ntiles * pitch),
                jnp.asarray(meta.numpy()), jnp.asarray(h), jnp.asarray(dst),
                jnp.asarray(padv), arena_rows=rows, ntiles=ntiles,
                pitch=pitch, rmax=rmax, nlex=1, interpret=True)
            res = tc._route_into(
                got, tc._to2d(tuple(torch.from_numpy(p) for p in planes)),
                meta, torch.from_numpy(bb), torch.from_numpy(h),
                torch.from_numpy(dst), torch.from_numpy(padv),
                arena_rows=rows, ntiles=ntiles, pitch=pitch, rmax=rmax)
            assert all(r is g for r, g in zip(res, got))   # in place
            dsts.append(torch.from_numpy(dst))
            cnts.append(torch.from_numpy(h))
    dst, cnt = torch.cat(dsts), torch.cat(cnts)
    for g, w in zip(tk.canonical_runs(got, dst, cnt, rows),
                    tk.canonical_runs(tuple(torch.from_numpy(np.asarray(w))
                                            for w in want), dst, cnt, rows)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    rix, _ = tk.run_rows(dst, cnt)
    other = torch.ones(rows, dtype=torch.bool)
    other[rix] = False
    assert rix.numel() > 2 * len(chunks) and other.any()
    for g in got:
        assert bool((g[other] == tk.SENT).all())


def _run(mod, x, nchunks, vals=(), cfg=None, nranges=4):
    """Drive one package's sort_external over even splits of the numpy
    planes; the concatenated pieces, per plane, as numpy."""
    splits = np.array_split(np.arange(len(x)), nchunks)
    planes_np = (x,) + tuple(vals)
    if mod is jc:
        def chunk_fn(i):
            return tuple(jnp.asarray(p[splits[i]]) for p in planes_np)
    else:
        def chunk_fn(i):
            return tuple(torch.from_numpy(p[splits[i]]) for p in planes_np)
    pieces = list(mod.sort_external(chunk_fn, nchunks, len(x), cfg,
                                    nranges=nranges))
    return [np.concatenate([np.asarray(p[j]) for p in pieces])
            for j in range(len(planes_np))]


def check_sort_external_matches_jax():
    rng = np.random.default_rng(83)
    sample = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    sample[::4] = 0xFFFFFFFF
    sample[1::9] = 77
    for nb in (4, 8):
        for got, want in zip(tc._bounds_from_sample(sample, nb),
                             jc._bounds_from_sample(sample, nb)):
            np.testing.assert_array_equal(got, np.asarray(want))
    n = 25_000
    k = rng.integers(0, 2**20, n).astype(np.uint32)
    v = rng.integers(0, 2**32, n, dtype=np.uint32)
    # each range's window is P >= 1024 rows, past sort_v4's threshold:
    # a raised min_engine_n keeps the reference's local sorts on its XLA
    # tier (its interpret-mode v4 pipeline takes ~16 s here)
    jcfg = JConfig(interpret=True, min_engine_n=1 << 18, **GEOM)
    tcfg = SortConfig(min_engine_n=1 << 18, **GEOM)
    with lax_network():
        for vals in ((), (v,)):
            want = _run(jc, k, 3, vals, jcfg)
            got = _run(tc, k, 3, vals, tcfg)
            order = np.lexsort((v, k)) if vals else np.argsort(k)
            for g, w, p in zip(got, want, (k,) + vals):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, p[order])
    x = rng.integers(0, 2**32, 24_000, dtype=np.uint32)
    (out,) = _run(tc, x, 2, cfg=dataclasses.replace(tcfg, min_engine_n=1024))
    np.testing.assert_array_equal(out, np.sort(x))
