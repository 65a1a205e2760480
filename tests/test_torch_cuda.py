"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode).  The file imports torch and numpy only, so it
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from inplacemsdradixsort_tpu_torch import SortConfig, sort
from inplacemsdradixsort_tpu_torch.ops import engine_v4
from inplacemsdradixsort_tpu_torch.ops import kernels_v4 as kv4

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
    assert all(kv4.LAUNCHES.values()), kv4.LAUNCHES


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


def test_kernels_match_plain_versions(cuda):
    """Record one tiny-geometry sort's kernel calls; rerun each kernel and
    its plain version on the same CUDA tensors."""
    calls = []
    wrappers = {k: getattr(kv4, k) for k in kv4.LAUNCHES}

    def rec(name):
        def run(*a, **kw):
            calls.append((name, [t.clone() if torch.is_tensor(t) else t
                                 for t in a], kw))
            return wrappers[name](*a, **kw)
        return run
    for k in wrappers:
        setattr(kv4, k, rec(k))
    try:
        x = torch.from_numpy(_keys(70_000, 2).view(np.int32)).to(cuda)
        engine_v4.sort_v4(x, (), SortConfig(**TINY))
    finally:
        for k, f in wrappers.items():
            setattr(kv4, k, f)
    assert {c[0] for c in calls} == set(wrappers)
    for name, a, kw in calls:
        if name == "hist_level":
            got, want = wrappers[name](*a, **kw), kv4.hist_level_ref(*a, **kw)
        elif name == "route_level":
            got = kv4.canonical_runs(wrappers[name](*a, **kw), a[4], a[3],
                                     a[6])
            want = kv4.canonical_runs(kv4.route_level_ref(*a, **kw), a[4],
                                      a[3], a[6])
        else:
            src, btbl, out, cap = a
            got = wrappers[name](src, btbl, out.clone(), cap, **kw)
            want = kv4.terminal_write_ref(src, btbl, out.clone(), cap, **kw)
        assert torch.equal(got, want), (name, kw)


@pytest.mark.parametrize("occ", [1, 127, 128, 129, 1500, 4096])
def test_terminal_global_path(cuda, occ):
    """One bucket per size: up to 2^19 keys (the XL class at n >= 2^28),
    including lengths that are not a power of two."""
    rng = np.random.default_rng(occ)
    arena = rng.integers(-2**31, 2**31, (occ + 8) * LANES).astype(np.int32)
    arena[4 * LANES:4 * LANES + 100] = 0x7FFFFFFF   # SENT keys
    real = occ * LANES - 17
    btbl = torch.tensor([[4, occ, real, 0, 0, 3, 0, 0],
                         [0, 0, 5, 1, 12345, 3 + real, 0, 0]],
                        dtype=torch.int32)
    src = torch.from_numpy(arena)
    out0 = torch.zeros(real + 8 + 5, dtype=torch.int32)
    want = kv4.terminal_write_ref(src, btbl, out0.clone(), 4096, 0)
    got = kv4.terminal_write(src.to(cuda), btbl.to(cuda), out0.to(cuda),
                             4096, 0)
    assert torch.equal(got.cpu(), want)


def test_wrappers_raise_on_mixed_devices(cuda):
    src = torch.zeros(LANES, dtype=torch.int32, device=cuda)
    meta = torch.zeros(6, dtype=torch.int32)
    bounds = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        kv4.hist_level(src, meta, bounds, 1, 24, 8)
