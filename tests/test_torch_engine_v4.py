"""The port's v4 planner and pipeline against the JAX package.

Parity method: both sides get the same sample (numpy), so the same
stats and tables; the JAX ``_pipeline_core`` runs in interpret mode once
per case (module-scoped fixture) and the port's on the CPU, where its
kernels run their plain versions.  Keys-only cases and 2- and 3-plane
cases (key + rid; u64 key + rid).  Integers are compared exactly; route
arenas through ``canonical_runs``.  The port's own ``sort_v4`` and API are
held against ``np.sort`` / ``np.lexsort``.

In the multi-plane cases the reference pipeline runs with ``lax.sort``
as its kernels' in-tile sort (``torch_parity.lax_network``: the same
order, without the network's minutes-long interpret-mode compile);
these cases test the glue around the kernels: tables, L2 tiling,
classes and output.
"""

import contextlib

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inplacemsdradixsort_tpu.config import SortConfig as JConfig
from inplacemsdradixsort_tpu.ops import engine_v4 as je
from torch_lsb_cases import (check_lsb_api_against_numpy,
                             check_sort_lsb_matches_jax)
from torch_parity import lax_network

import inplacemsdradixsort_tpu_torch as rt
from inplacemsdradixsort_tpu_torch.config import SortConfig
from inplacemsdradixsort_tpu_torch.ops import engine_v4 as te
from inplacemsdradixsort_tpu_torch.ops import kernels_v4 as tk

TINY = dict(v3_sort_rows=32, v3_rmax=8, v3_cap_rows=32)
SMALL = dict(v3_sort_rows=16, v3_rmax=8, v3_cap_rows=2)
# name: (geometry kwargs, n, distribution, seed, planes, terminal classes)
CASES = {
    "uniform_two_level": (TINY, 70_000, "uniform", 21, 1, 3),
    "uniform_one_level": (dict(v3_sort_rows=128, v3_rmax=48,
                               v3_cap_rows=64), 40_000, "uniform", 11, 1, 3),
    "maxheavy": (TINY, 70_000, "maxheavy", 23, 1, 3),
    "pairs_2planes": (SMALL, 6_000, "dup3000", 31, 2, 1),
    "u64_rid_3planes": (SMALL, 6_000, "dup3000", 37, 3, 1),
}
REPO = Path(__file__).resolve().parents[1]


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
    elif dist == "dup3000":      # ~2 copies a value, spread over u32
        x = (rng.integers(0, 3000, n) * 1431655).astype(np.uint32)
    elif dist == "maxheavy":
        x = np.where(rng.random(n) < 0.3, 0xFFFFFFFF,
                     rng.integers(0, 2**32, n, dtype=np.uint32))
        x = x.astype(np.uint32)
    else:  # rowcorr
        x = ((np.arange(n, 0, -1, dtype=np.uint64) % 997)
             .astype(np.uint32) * np.uint32(44257))
    return x


def _np(d):
    return {k: np.array(v) for k, v in d.items()}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    geom_kw, n, dist, seed, nplanes, nclasses = CASES[request.param]
    x = _keys(dist, n, seed)
    rng = np.random.default_rng(seed + 2)
    vals = [rng.integers(0, 2**32, n, dtype=np.uint32)
            for _ in range(nplanes - 1)]
    jg = je._dev_geometry(n, nplanes, JConfig(**geom_kw))
    tg = te._dev_geometry(n, nplanes, SortConfig(**geom_kw))
    # one shared sample: the stats are computed from it on both sides
    rng = np.random.default_rng(seed + 1)
    s = np.sort(x[rng.integers(0, n, jg.S)])
    jstats = np.array(je._stats_of_sorted(jnp.asarray(s), jg.nbq))
    tstats = te._stats_of_sorted(torch.from_numpy(s.view(np.int32)),
                                 tg.nbq).numpy()
    jtb = _np(je._tables_from_stats(jnp.asarray(jstats), jg))
    ttb = _np(te._tables_from_stats(torch.from_numpy(jstats), tg))
    jtb["l1_meta"] = je._l1_meta_np(jg)
    ttb["l1_meta"] = te._l1_meta_np(tg)

    planes = [x] + vals
    with lax_network() if nplanes > 1 else contextlib.nullcontext():
        jfinal, jover, jdbg = je._pipeline_core(
            tuple(jnp.asarray(p) for p in planes),
            {k: jnp.asarray(v) for k, v in jtb.items()},
            n=n, nplanes=nplanes, nlex=nplanes - 1, rmax=jg.rmax,
            pitch=jg.pitch, cap_rows=jg.cap_rows, ntiles1=jg.ntiles1,
            t2max=jg.t2max, arena1_rows=jg.arena1_rows,
            arena2_rows=jg.arena2_rows, out_rows=jg.out_rows,
            two_level=jg.two_level, interpret=True, debug=True,
            nclasses=nclasses)
        jfinal = [np.asarray(f) for f in jfinal]
    tfinal, tover, tdbg = te._pipeline_core(
        tuple(torch.from_numpy(p.view(np.int32)) for p in planes),
        te.tables_from_numpy(jtb, "cpu"), tg, debug=True, nclasses=nclasses)
    return dict(
        x=x, planes=planes, jg=jg, tg=tg, jstats=jstats, tstats=tstats,
        jtb=jtb, ttb=ttb, name=request.param,
        jfinal=jfinal, jover=int(jover),
        jdbg=_np(jdbg),
        tfinal=[f.numpy().view(np.uint32) for f in tfinal], tover=int(tover),
        tdbg={k: (v[0] if isinstance(v, tuple) else v).numpy()
              for k, v in tdbg.items()})


def test_geometry_matches(case):
    assert dataclasses.asdict(case["tg"]) == dataclasses.asdict(case["jg"])


def test_stats_and_tables_match(case):
    np.testing.assert_array_equal(case["tstats"], case["jstats"])
    assert case["ttb"].keys() == case["jtb"].keys()
    for k, v in case["jtb"].items():
        np.testing.assert_array_equal(case["ttb"][k], v, err_msg=k)


def test_pipeline_counts_and_tables_match(case):
    j, t = case["jdbg"], case["tdbg"]
    keys = ["hist1", "start1", "rows_c1", "btbl"]
    if case["jg"].two_level:
        keys += ["hist2", "real2", "start2", "rows_c2"]
    assert set(j) == set(keys) | {"a1"} | ({"a2"} if "a2" in j else set())
    for k in keys:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert j["hist1"].sum() == len(case["x"])


def test_pipeline_arenas_match(case):
    j, t, g = case["jdbg"], case["tdbg"], case["tg"]
    levels = [("a1", "dst1", "hist1", g.arena1_rows)]
    if g.two_level:
        levels.append(("a2", "dst2", "hist2", g.arena2_rows))
    # the reference's debug dict holds plane 0 of each arena
    for arena, dst, cnt, rows in levels:
        dst_t, cnt_t = torch.from_numpy(t[dst]), torch.from_numpy(t[cnt])
        (want,) = tk.canonical_runs((torch.from_numpy(j[arena]),), dst_t,
                                    cnt_t, rows)
        (got,) = tk.canonical_runs((torch.from_numpy(t[arena]),), dst_t,
                                   cnt_t, rows)
        np.testing.assert_array_equal(got.numpy(), want.numpy(),
                                      err_msg=arena)


def test_pipeline_output_matches(case):
    assert case["tover"] == case["jover"] == 0
    order = np.lexsort(case["planes"][::-1])
    assert len(case["tfinal"]) == len(case["planes"])
    for p, (t, j, x) in enumerate(zip(case["tfinal"], case["jfinal"],
                                      case["planes"])):
        np.testing.assert_array_equal(t, j, err_msg=str(p))
        np.testing.assert_array_equal(t, x[order], err_msg=str(p))


def test_cases_cover_the_slice(case):
    """The cases together run one and two levels, value fill, and 2 and
    3 planes with no value fill."""
    tb, g, name = case["ttb"], case["tg"], case["name"]
    if name == "uniform_one_level":
        assert not g.two_level
    else:
        assert g.two_level
    if name == "maxheavy":
        assert tb["term_mode"].any()
        assert (tb["drop1"].any() or tb["drop2"].any())
        assert case["tdbg"]["btbl"][:, 3].any()
    if g.nplanes > 1:       # payload: every bucket is sorted
        assert not (tb["drop1"].any() or tb["drop2"].any()
                    or tb["term_mode"].any())
        # plane-0 ties were broken by the payload planes
        assert len(np.unique(case["x"])) < len(case["x"])


# ------------------------------------------- the port's own sort_v4 / API

DISTS = ["uniform", "zipf", "dup8", "sorted", "reverse", "allequal",
         "maxheavy", "rowcorr"]


@pytest.mark.parametrize("dist", DISTS)
def test_sort_v4_distributions(dist):
    x = _keys(dist, 70_000, DISTS.index(dist))
    te.reset_fallback_stats()
    out, vals = te.sort_v4(torch.from_numpy(x.view(np.int32)), (),
                           SortConfig(**TINY))
    assert vals == ()
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.sort(x))
    assert te.FALLBACK_STATS["small_n"] == 0
    # presorted input at this n: the sampler takes the first ssz keys when
    # ssz >= rows (engine_v4.py:94-95 of the reference), so every plan
    # misses the upper keys and the ladder ends in the fallback — on the
    # reference as well (ROADMAP.md C6)
    if dist != "sorted":
        assert te.FALLBACK_STATS["overflow"] == 0, dict(te.FALLBACK_STATS)


def test_api_sort_v4_and_auto():
    x = _keys("uniform", 70_000, 5)
    te.reset_fallback_stats()
    res = rt.sort(torch.from_numpy(x), config=SortConfig(engine="v4",
                                                         **TINY),
                  timing=True)
    assert res.keys.dtype == torch.uint32 and res.synced
    np.testing.assert_array_equal(res.keys.numpy(), np.sort(x))
    assert [lbl for lbl, _ in res.times][0] == "sample"
    assert te.FALLBACK_STATS == dict.fromkeys(te.FALLBACK_STATS, 0)
    auto = rt.sort(torch.from_numpy(x))        # CPU tensor: torch.sort
    assert not auto.synced
    np.testing.assert_array_equal(auto.keys.numpy(), np.sort(x))
    assert rt.check(res.keys, input_checksum=int(x.astype(np.uint64).sum())
                    ) == int(x.astype(np.uint64).sum()) % 2**64


def test_one_level_sort():
    cfg = SortConfig(v3_sort_rows=128, v3_rmax=48, v3_cap_rows=64,
                     min_engine_n=1)
    assert not te._dev_geometry(40_000, 1, cfg).two_level
    x = _keys("uniform", 40_000, 8)
    out, _ = te.sort_v4(torch.from_numpy(x.view(np.int32)), (), cfg)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.sort(x))


def test_small_n_fallback_counted():
    x = _keys("uniform", 1000, 3)
    te.reset_fallback_stats()
    out, _ = te.sort_v4(torch.from_numpy(x.view(np.int32)))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.sort(x))
    assert te.FALLBACK_STATS["small_n"] == 1


def test_retry_ladder_then_fallback(monkeypatch):
    """An overflowing terminal retries twice with finer buckets and fresh
    salts, then falls back to torch.sort, counted as overflow."""
    seen = []
    real_finish = te._finish

    def always_over(*args, **kw):
        out, _, btbl = real_finish(*args, **kw)
        seen.append(btbl.shape[0])
        return out, torch.tensor(1, dtype=torch.int32), btbl
    monkeypatch.setattr(te, "_finish", always_over)
    x = _keys("uniform", 70_000, 9)
    te.reset_fallback_stats()
    out, _ = te.sort_v4(torch.from_numpy(x.view(np.int32)), (),
                        SortConfig(**TINY))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), np.sort(x))
    assert len(seen) == 3
    assert te.FALLBACK_STATS["retry"] == 2
    assert te.FALLBACK_STATS["overflow"] == 1


@pytest.mark.parametrize("engine", ["v5", "lsb"])
def test_not_implemented(engine):
    """The engines this test found not ported, v5 and then lsb, now sort;
    an engine that is not ported (the distributed sort's) raises, naming
    its ROADMAP item.  The lsb case also runs the LSB engine's checks
    against the JAX package and numpy (``tests/torch_lsb_cases.py``)."""
    x = _keys("uniform", 100, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rt.sort(torch.from_numpy(x), config=SortConfig(engine="dsort"))
    if engine == "lsb":
        res = rt.sort(torch.from_numpy(x), config=SortConfig(
            engine=engine, min_engine_n=1, v3_sort_rows=32,
            lsb_digit_bits=4))
        np.testing.assert_array_equal(res.keys.numpy(), np.sort(x))
        check_sort_lsb_matches_jax()
        check_lsb_api_against_numpy()
        return
    res = rt.sort(torch.from_numpy(x), config=SortConfig(
        engine=engine, min_engine_n=1, v5_pitch_rows=64, v3_sort_rows=512,
        v3_rmax=8, v3_cap_rows=256))
    np.testing.assert_array_equal(res.keys.numpy(), np.sort(x))


@pytest.mark.parametrize("nvals", [1, 2, 3])
def test_sort_v4_with_payload_planes(nvals):
    """sort_v4 with 1-3 payload planes (formerly NotImplementedError):
    lexicographic by (key, *vals), plane-0 ties broken by the payload."""
    x = _keys("dup8", 70_000, 40 + nvals)
    rng = np.random.default_rng(nvals)
    vals = [rng.integers(0, 2**32, len(x), dtype=np.uint32)
            for _ in range(nvals)]
    te.reset_fallback_stats()
    out, vout = te.sort_v4(torch.from_numpy(x.view(np.int32)),
                           tuple(torch.from_numpy(v.view(np.int32))
                                 for v in vals), SortConfig(**TINY))
    order = np.lexsort(vals[::-1] + [x])
    np.testing.assert_array_equal(out.numpy().view(np.uint32), x[order])
    assert len(vout) == nvals
    for v, w in zip(vout, vals):
        np.testing.assert_array_equal(v.numpy().view(np.uint32), w[order])
    # eight key values carry ~1/8 of the mass each: with payload no value
    # fill applies, so the ladder ends in the deep tier, not the fallback
    assert te.FALLBACK_STATS["overflow"] == 0
    assert te.FALLBACK_STATS["deep"] >= 1


def test_checking_helpers():
    from inplacemsdradixsort_tpu_torch.utils.checking import (
        checksum, is_sorted)
    x = np.array([0xFFFFFFFF, 1, 0x80000000], np.uint32)
    t = torch.from_numpy(x)
    assert checksum(t) == int(x.astype(np.uint64).sum())
    assert not is_sorted(t)
    assert is_sorted(torch.from_numpy(np.sort(x)))
    with pytest.raises(AssertionError):
        rt.check(t)
    buf = rt.mamalloc(130, device="cpu")
    assert buf.shape == (256,) and buf.device.type == "cpu"


def test_mamalloc_defaults_to_the_card():
    """Without a device, mamalloc allocates on the CUDA card, as the
    reference's mamalloc allocates device memory; here there is none."""
    if torch.cuda.is_available():
        assert rt.mamalloc(130).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.mamalloc(130)


def test_import_leaves_jax_out():
    code = ("import sys, inplacemsdradixsort_tpu_torch, "
            "inplacemsdradixsort_tpu_torch.ops.engine_v4, "
            "inplacemsdradixsort_tpu_torch.ops.engine_v5, "
            "inplacemsdradixsort_tpu_torch.ops.engine_v3, "
            "inplacemsdradixsort_tpu_torch.ops.kernels_v3, "
            "inplacemsdradixsort_tpu_torch.ops.xla_engine, "
            "inplacemsdradixsort_tpu_torch.ops.kernels_v5, "
            "inplacemsdradixsort_tpu_torch.ops.pallas_engine, "
            "inplacemsdradixsort_tpu_torch.ops.pallas_kernels, "
            "inplacemsdradixsort_tpu_torch.ops.bitonic, "
            "inplacemsdradixsort_tpu_torch.ops.deep, "
            "inplacemsdradixsort_tpu_torch.ops.keycodec, "
            "inplacemsdradixsort_tpu_torch.utils.checking, "
            "inplacemsdradixsort_tpu_torch.ops._build; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'inplacemsdradixsort_tpu.')) "
            "or m == 'inplacemsdradixsort_tpu']; "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
