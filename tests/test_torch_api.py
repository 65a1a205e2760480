"""The port's public API on the CPU: the key codecs against
``inplacemsdradixsort_tpu/ops/keycodec.py``, every key type and rid width
through ``api.sort`` (the kernels' plain versions) against numpy's
lexicographic order, ``sort_with_indices``, the checking helpers, and
the device rules (data that is not a tensor goes to the card).

Inputs come from ``np.random.default_rng(seed)``; every comparison is
exact.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from inplacemsdradixsort_tpu.ops import keycodec as jkc

import inplacemsdradixsort_tpu_torch as rt
from inplacemsdradixsort_tpu_torch import api
from inplacemsdradixsort_tpu_torch.config import SortConfig
from inplacemsdradixsort_tpu_torch.ops import engine_v4 as te
from inplacemsdradixsort_tpu_torch.ops import engine_v5 as te5
from inplacemsdradixsort_tpu_torch.ops import keycodec as tkc
from inplacemsdradixsort_tpu_torch.utils.checking import check_permutation
from torch_chunked_cases import check_sort_external_matches_jax
from torch_v3_cases import (check_v3_plan_and_pipeline_match_jax,
                            check_v3_sort_against_numpy)

V4 = SortConfig(engine="v4", v3_sort_rows=32, v3_rmax=8, v3_cap_rows=32)
N = 70_000

EDGE_U32 = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1],
                    np.uint32)
EDGE_U64 = np.array([0, 1, 2**32 - 1, 2**32, 2**63 - 1, 2**63,
                     2**64 - 2, 2**64 - 1], np.uint64)
EDGE_F32 = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45,
                     np.finfo(np.float32).max, -np.finfo(np.float32).max],
                    np.float32)
NAN_BITS = np.array([0x7FC00000, 0x7F800001, 0xFFC00000, 0xFF800001,
                     0x7FFFFFFF, 0xFFFFFFFF], np.uint32)


def _values(kind, rng, n):
    """Seeded keys of one type with its edge values (and NaN payloads)
    at the front and repeats, so that ties occur."""
    if kind == "u32":
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
        x[: len(EDGE_U32)] = EDGE_U32
    elif kind == "i32":
        x = rng.integers(-2**31, 2**31, n, dtype=np.int32)
        x[: len(EDGE_U32)] = EDGE_U32.view(np.int32)
    elif kind == "f32":
        x = rng.normal(scale=1e3, size=n).astype(np.float32)
        x[: len(EDGE_F32)] = EDGE_F32
        x[len(EDGE_F32): len(EDGE_F32) + len(NAN_BITS)] = \
            NAN_BITS.view(np.float32)
    elif kind == "u64":
        x = rng.integers(0, 2**64, n, dtype=np.uint64)
        x[: len(EDGE_U64)] = EDGE_U64
    else:   # i64
        x = rng.integers(-2**63, 2**63, n, dtype=np.int64)
        x[: len(EDGE_U64)] = EDGE_U64.view(np.int64)
    x[-n // 8:] = x[: n // 8]          # repeated keys
    return x


def _order_key(x):
    """A numpy key with the order the codecs promise: unsigned for u32 and
    u64, signed for i32 and i64, IEEE total order (by the bits) for f32."""
    if x.dtype == np.float32:
        u = x.view(np.int32)
        return np.where(u < 0, ~u, u ^ np.int32(-2**31)).view(np.uint32)
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("kind", ["i32", "f32", "u64", "i64"])
def test_codecs_match_jax(kind):
    """Encodings bit for bit equal to the reference's keycodec (its
    api.py:137-181 for i64), and decodings that undo them."""
    x = _values(kind, np.random.default_rng(1), 4096)
    with jax.enable_x64(True):
        if kind == "i32":
            want = [np.asarray(jkc.encode_i32(jnp.asarray(x)))]
            got = [tkc.encode_i32(_t(x))]
            back = tkc.decode_i32(got[0])
        elif kind == "f32":
            want = [np.asarray(jkc.encode_f32(jnp.asarray(x)))]
            got = [tkc.encode_f32(_t(x))]
            back = tkc.decode_f32(got[0])
            np.testing.assert_array_equal(
                np.asarray(jkc.decode_f32(jnp.asarray(want[0])))
                .view(np.uint32), back.numpy().view(np.uint32))
        elif kind == "u64":
            want = [np.asarray(w) for w in jkc.split_u64(jnp.asarray(x))]
            got = list(tkc.split_u64(_t(x)))
            back = tkc.join_u64(*got)
        else:
            flip = jax.lax.bitcast_convert_type(
                jnp.asarray(x), jnp.uint64) ^ jnp.uint64(1 << 63)
            want = [np.asarray(w) for w in jkc.split_u64(flip)]
            got = list(tkc.encode_i64(_t(x)))
            back = tkc.decode_i64(*got)
    for g, w in zip(got, want):
        assert g.dtype == torch.uint32
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(back.numpy().view(np.uint8),
                                  x.view(np.uint8))


@pytest.mark.parametrize("kind", ["u32", "i32", "f32", "u64", "i64"])
def test_codecs_preserve_order(kind):
    """Sorting the encoded words sorts the keys: equal to numpy's order
    (signed/unsigned, or IEEE total order for float32)."""
    x = _values(kind, np.random.default_rng(2), 4096)
    words = api._key_planes(_t(x))
    cols = [w.numpy().view(np.uint32) for w in words]
    order = np.lexsort(cols[::-1])
    np.testing.assert_array_equal(_order_key(x)[order],
                                  np.sort(_order_key(x)))
    np.testing.assert_array_equal(
        api._join_keys(tuple(words), _t(x).dtype).numpy().view(np.uint8),
        x.view(np.uint8))


RID_TYPES = [np.uint32, np.int64, np.uint64, np.int16, np.uint8]


@pytest.mark.parametrize("kind", ["u32", "i32", "f32", "u64", "i64"])
@pytest.mark.parametrize("rid_type", [None] + RID_TYPES,
                         ids=lambda r: "keys" if r is None else r.__name__)
def test_sort_types_on_cpu(kind, rid_type):
    """api.sort with the v4 engine's plain versions: every key type, alone
    and with rids of 8-64 bits (64-bit rids >= 2^32), lexicographic by
    (key, rid), equal to the torch engine's result."""
    rng = np.random.default_rng(3)
    x = _values(kind, rng, N)
    rid = None
    if rid_type is not None:
        info = np.iinfo(rid_type)
        rid = rng.integers(info.min, info.max, N, dtype=rid_type,
                           endpoint=True)
        if info.bits == 64:
            rid[:3] = [2**32, info.max, info.min]
    te.reset_fallback_stats()
    res = rt.sort(_t(x), None if rid is None else _t(rid), config=V4)
    key = _order_key(x)
    if rid is None:
        order = np.argsort(key, kind="stable")
    else:      # rid words order as unsigned (the reference's rid planes)
        order = np.lexsort((rid.astype(np.uint64) if rid.dtype.itemsize
                            == 8 else rid.astype(np.uint32), key))
    assert res.keys.dtype == _t(x).dtype
    np.testing.assert_array_equal(res.keys.numpy().view(np.uint8),
                                  x[order].view(np.uint8))
    if rid is not None:
        assert res.rids.dtype == _t(rid).dtype
        np.testing.assert_array_equal(res.rids.numpy(), rid[order])
    assert te.FALLBACK_STATS["small_n"] == 0
    alt = rt.sort(_t(x), None if rid is None else _t(rid),
                  config=SortConfig(engine="torch"))
    assert torch.equal(alt.keys.view(torch.uint8),
                       res.keys.view(torch.uint8))
    if rid is not None:
        assert torch.equal(alt.rids, res.rids)


def test_pairs_u64_rids_above_2_32():
    """The BASELINE pair shape, (u32 key, u64 rid), with rids far above
    2^32 and equal keys: rids round-trip exactly and order the ties."""
    rng = np.random.default_rng(4)
    key = rng.integers(0, 1000, N, dtype=np.uint32)
    rid = (np.uint64(1) << np.uint64(40)) + rng.permutation(N).astype(
        np.uint64) * np.uint64(2**33 + 7)
    res = rt.sort(_t(key), _t(rid), config=V4)
    order = np.lexsort((rid, key))
    np.testing.assert_array_equal(res.keys.numpy(), key[order])
    np.testing.assert_array_equal(res.rids.numpy(), rid[order])
    assert check_permutation(res.keys, torch.from_numpy(
        np.argsort(key, kind="stable")), _t(key))
    assert rt.check(res.keys, res.rids) == int(key.astype(np.uint64).sum())


def test_sort_with_indices_is_stable():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 50, N, dtype=np.uint32)
    keys, perm = rt.sort_with_indices(_t(x), config=V4)
    assert perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), np.argsort(x, kind="stable"))
    np.testing.assert_array_equal(keys.numpy(), np.sort(x))
    assert check_permutation(keys, perm, _t(x))
    # the same through the torch engine (auto on a CPU tensor)
    k2, p2 = rt.sort_with_indices(_t(x.view(np.int32)))
    np.testing.assert_array_equal(
        p2.numpy(), np.argsort(x.view(np.int32), kind="stable"))
    assert k2.dtype == torch.int32


def test_numpy_input_asks_for_the_card():
    """Data that is not a tensor goes to the CUDA card, as the reference
    puts it on the accelerator; a CPU tensor stays the caller's choice."""
    x = np.random.default_rng(6).integers(0, 2**32, 1000, dtype=np.uint32)
    if torch.cuda.is_available():
        assert rt.sort(x).keys.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.sort(x)
        with pytest.raises(RuntimeError, match="CUDA"):
            rt.sort_with_indices(list(x[:10]))
    assert rt.sort(_t(x)).keys.device.type == "cpu"


def _card_keys(n):
    """A stand-in for an n-element tensor on the card: the size switch
    reads only its length, device and ``is_cuda``."""
    return types.SimpleNamespace(shape=(n,), device="cuda", is_cuda=True)


def test_size_switch_names_v5(monkeypatch):
    """engine='auto' on the card: a v4 working set over 75% of the card's
    memory selects the in-place v5 engine (formerly a raise naming
    ROADMAP A10); where v5 does not fit either, v5's own check raises
    naming its buffers before anything is allocated."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (1 << 29, 1 << 30))
    auto = SortConfig()
    assert api.check_fits(20_000_000, 2) == "v4"   # 688 MB of v4
    assert api.check_fits(20_000_000, 3) == "v5"   # 1.03 GB > 0.75 GiB
    assert api._select_engine(auto, _card_keys(20_000_000), 3) == "v5"
    assert api._select_engine(auto, _card_keys(20_000_000), 2) == "v4"
    with pytest.raises(ValueError, match="v5.*W, S"):
        api.check_fits(60_000_000, 3)
    with pytest.raises(ValueError, match="v5"):
        api._select_engine(SortConfig(engine="v5"), _card_keys(60_000_000),
                           3)
    api.fits_v5(20_000_000, 3)


def test_fits_v5_counts_held_bytes_and_n(monkeypatch):
    """v5's fit check counts what the caller holds on the card beside the
    engine (its keys and rids, the planes split from them, the outputs
    joined back), so an input whose planes alone fit can still be
    refused before anything is allocated; and n past 2^31 - 1, which the
    int32 output offsets cannot reach, is refused by the size switch, by
    v5's check and by the engine itself."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (80 << 30, 80 << 30))
    n = 1 << 30
    assert api.held_bytes(n, torch.uint32) == 4 * n
    assert api.held_bytes(n, torch.uint32, torch.int32) == 8 * n
    # u64 rids: the caller's 8 bytes, two split planes, the joined output
    assert api.held_bytes(n, torch.uint32, torch.uint64) == 28 * n
    assert api.held_bytes(n, torch.float32, torch.int16) == 20 * n
    held = api.held_bytes(n, torch.uint32, torch.uint64)
    assert api.check_fits(n, 3, held=held) == "v5"
    engine = te5.v5_bytes(n, 3, SortConfig())
    room = int(0.75 * (80 << 30))
    api.fits_v5(n, 3, held=room - engine)
    with pytest.raises(ValueError, match="inputs, planes and outputs"):
        api.fits_v5(n, 3, held=room - engine + 1)
    with pytest.raises(ValueError, match="v5"):
        api._select_engine(SortConfig(engine="v5"), _card_keys(n), 3,
                           room - engine + 1)
    big = te5.MAX_N + 1
    assert big == 1 << 31
    for call in (lambda: api.check_fits(big, 1),
                 lambda: api.fits_v5(big, 1),
                 lambda: te5.sort_v5_from_chunks(
                     lambda i: (torch.zeros(128, dtype=torch.int32),),
                     1, big)):
        with pytest.raises(ValueError, match="int32 output offsets"):
            call()
    api.fits_v5(te5.MAX_N, 1)


def test_size_switch_topology(monkeypatch):
    """Bytes are not all: 2^30 (u32 key, u64 rid) pairs fit an 80 GB
    card's memory but ask for more buckets than v4's rmax^2 topology
    holds, so engine='auto' selects v5 (formerly a raise naming ROADMAP
    C9 and A10), whose topology holds them; keys only, 2^30 stays on
    v4."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (80 << 30, 80 << 30))
    wanted, room = te.bucket_room(1 << 30, 3, SortConfig())
    assert wanted > room == 96 * 96
    assert api.check_fits(1 << 30, 3) == "v5"
    assert api._select_engine(SortConfig(), _card_keys(1 << 30), 3) == "v5"
    g = te5._v5_geometry(1 << 30, 3, SortConfig())
    assert g.nb_want * 1.3 < g.rmax * g.rmax
    assert api.check_fits(1 << 29, 3) == "v4"
    assert api.check_fits(1 << 30, 1) == "v4"
    # W, S and the terminal scratch of 2^30 pairs, with the planes, fit
    # under 60 GiB; the CPU tensors of the same call stay on torch.sort
    assert te5.v5_bytes(1 << 30, 3, SortConfig()) + 12 * (1 << 30) \
        < 0.75 * (80 << 30)
    assert api._select_engine(SortConfig(), torch.zeros(4), 3) == "torch"


def test_check_payload_shards_and_errors():
    x = np.sort(np.random.default_rng(7).integers(0, 2**32, 500,
                                                  dtype=np.uint32))
    t = _t(x)
    total = int(x.astype(np.uint64).sum())
    assert rt.check(t, t.clone(), same=True, input_checksum=total) == total
    assert rt.check([t[:200], t[200:]], [t[:200], t[200:]], same=True) \
        == total
    with pytest.raises(AssertionError, match="boundary"):
        rt.check([t[200:], t[:200]])
    with pytest.raises(AssertionError, match="payload"):
        rt.check(t, _t(x[::-1]), same=True)
    with pytest.raises(AssertionError, match="checksum"):
        rt.check(t, input_checksum=total + 1)
    u = _t(np.sort(EDGE_U64))
    assert rt.check(u) == int(EDGE_U64.sum(dtype=np.uint64))
    with pytest.raises(TypeError):
        rt.sort(t, torch.zeros(500, dtype=torch.float32))


V1 = SortConfig(engine="pallas", tile_elems=1024, range_bits=3)


def test_engine_pallas_routing(monkeypatch):
    """engine="pallas" and engine="v3" as the reference routes them:
    uint32 keys (rids of at most 32 bits, returned in their own dtype)
    through msd_sort / sort_v3, uint64 keys without rids through
    msd_sort_u64 / sort_v3 on (hi, lo), every other key type to
    torch.sort; 64-bit rids with uint32 keys raise ValueError naming v4
    (the reference would keep their low words, ROADMAP.md C11, C13).
    engine="xla" sorts every key type stably by key only, as the
    reference's xla_engine (ROADMAP.md C12).  Then the v3 engine against
    the JAX one and against numpy (``torch_v3_cases``), and the chunked
    sort against the JAX one and numpy (``torch_chunked_cases``)."""
    from inplacemsdradixsort_tpu_torch.ops import engine_v3 as te3
    from inplacemsdradixsort_tpu_torch.ops import pallas_engine as tpe
    ran = []
    for mod, fn in ((tpe, "msd_sort"), (tpe, "msd_sort_u64"),
                    (te3, "sort_v3")):
        f = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _f=f, _n=fn, **k: (
            ran.append(_n), _f(*a, **k))[1])
    for cfg, want in ((V1, {"u32": ["msd_sort"], "u64": ["msd_sort_u64"]}),
                      (V3, {"u32": ["sort_v3"], "u64": ["sort_v3"]})):
        for kind in ("u32", "u32+u32", "u32+i16", "u32+u8", "u64", "i32",
                     "f32", "u64+u32", "u32+u64"):
            ran.clear()
            _check_pallas_route(kind, ran, cfg, want)
    _check_xla_route()
    monkeypatch.undo()
    check_v3_plan_and_pipeline_match_jax()
    check_v3_sort_against_numpy()
    check_sort_external_matches_jax()


V3 = SortConfig(engine="v3")


def _check_xla_route():
    """engine="xla" against the reference's xla_engine: equal keys keep
    their input order whatever their rids; NaNs last, -0 equal to +0."""
    from inplacemsdradixsort_tpu.ops import xla_engine as jx
    from inplacemsdradixsort_tpu_torch.ops import xla_engine as tx
    rng = np.random.default_rng(14)
    n = 3000
    rids = rng.integers(0, 2**32, n, dtype=np.uint32)
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[:6] = [0.0, -0.0, np.nan, -np.inf, 0.0, -0.0]
    keys = {"u32": rng.integers(0, 50, n, dtype=np.uint32) * 85899345,
            "i32": rng.integers(-20, 20, n).astype(np.int32),
            "f32": f32}
    xla = SortConfig(engine="xla")
    for kind, k in keys.items():
        wk, wr = jx.sort_pairs(jnp.asarray(k), jnp.asarray(rids))
        res = rt.sort(_t(k), _t(rids), config=xla)
        np.testing.assert_array_equal(res.keys.numpy().view(np.uint32),
                                      np.asarray(wk).view(np.uint32))
        np.testing.assert_array_equal(res.rids.numpy(), np.asarray(wr))
        np.testing.assert_array_equal(
            rt.sort(_t(k), config=xla).keys.numpy().view(np.uint32),
            np.asarray(jx.sort_keys(jnp.asarray(k))).view(np.uint32))
        np.testing.assert_array_equal(
            tx.argsort_u32(_t(k)).numpy(),
            np.asarray(jx.argsort_u32(jnp.asarray(k))))
    k64 = rng.integers(0, 4, n, dtype=np.uint64) << np.uint64(62)
    for dt in (np.uint64, np.int64):
        res = rt.sort(_t(k64.view(dt)), _t(rids), config=xla)
        order = np.argsort(k64.view(dt), kind="stable")
        np.testing.assert_array_equal(res.keys.numpy(), k64.view(dt)[order])
        np.testing.assert_array_equal(res.rids.numpy(), rids[order])


def _check_pallas_route(kind, ran, cfg, want_ran):
    rng = np.random.default_rng(12)
    n = 3000
    key_t, _, rid_t = kind.partition("+")
    keys = {"u32": rng.integers(0, 50, n, dtype=np.uint32),
            "u64": rng.choice(np.array([5, 2**64 - 1, 2**40], np.uint64), n)
            | rng.integers(0, 4, n, dtype=np.uint64),
            "i32": rng.integers(-2**31, 2**31, n).astype(np.int32),
            "f32": rng.standard_normal(n).astype(np.float32)}[key_t]
    rids = None
    if rid_t:
        dt = {"u32": np.uint32, "i16": np.int16, "u8": np.uint8,
              "u64": np.uint64}[rid_t]
        rids = rng.integers(0, min(np.iinfo(dt).max, 2**62), n,
                            dtype=np.int64).astype(dt)
    if kind == "u32+u64":
        with pytest.raises(ValueError, match="'v4'"):
            rt.sort(_t(keys), _t(rids), config=cfg)
        assert not ran, kind
        return
    res = rt.sort(_t(keys), None if rids is None else _t(rids), config=cfg)
    want = want_ran.get(key_t if kind != "u64+u32" else "", [])
    assert ran[:1] == want, (kind, ran)
    # ties of equal keys in rid order (rids here are non-negative)
    order = (np.argsort(keys, kind="stable") if rids is None
             else np.lexsort((rids, keys)))
    np.testing.assert_array_equal(res.keys.numpy(), keys[order])
    if rids is not None:
        assert res.rids.dtype == _t(rids).dtype
        np.testing.assert_array_equal(res.rids.numpy(), rids[order])
