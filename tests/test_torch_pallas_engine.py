"""The port's v1 engine (``engine="pallas"``) against the JAX package's,
launch by launch, on the CPU (the port's kernels run their plain
versions, the reference's Pallas kernels run in interpret mode), at the
reference tests' tiny geometry (``tests/test_pallas_engine.py``:
1024-element tiles, 3 range bits).

Every kernel call of both packages is recorded (arguments copied before
the call: the reference's executables donate their buffers).  For each
input:
- both make the same launches with equal tables (bounds, data counts,
  slot rows, run starts and lengths, bucket starts and pads, segment
  starts and lengths, arena sizes);
- every launch's defined output rows (``pallas_kernels.defined_elems``)
  and ``tile_sort``'s counts are bitwise equal;
- the outputs are bitwise equal to each other and to numpy.

Inputs are made with numpy from a seed.  The reference run of an input
costs seconds of interpret-mode compiles, a few seconds for each new
shape, so the inputs run in four groups, one test each: a group's
inputs share compiled shapes in one process.  The collection is kept
small on purpose: the test runner's first batch of work is a quarter
of all collected tests, dealt out one by one, and a longer collection
deals the reference's slow interpret-mode tests to every worker at
once (ROADMAP.md A0).
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from inplacemsdradixsort_tpu.config import SortConfig as JConfig
from inplacemsdradixsort_tpu.ops import pallas_engine as jpe
from inplacemsdradixsort_tpu.ops import pallas_kernels as jpk
from inplacemsdradixsort_tpu_torch.config import SortConfig
from inplacemsdradixsort_tpu_torch.ops import pallas_engine as tpe
from inplacemsdradixsort_tpu_torch.ops import pallas_kernels as tpk

GEOM = dict(tile_elems=1024, range_bits=3, engine="pallas")
JCFG = JConfig(interpret=True, **GEOM)
TCFG = SortConfig(**GEOM)
KERNELS = ("tile_sort", "distribute", "ragged_sort", "compact")
ARENAS = ("keys", "vals")


def _zipf(rng, n, theta=0.75, items=4096):
    p = 1.0 / np.arange(1, items + 1) ** theta
    rank = rng.choice(items, n, p=p / p.sum()).astype(np.uint64)
    return ((rank * np.uint64(2654435761)) % np.uint64(2**32)) \
        .astype(np.uint32)


def _keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    uni = rng.integers(0, 2**32, n, dtype=np.uint32)
    if kind == "uniform":
        return uni
    if kind == "zipf":
        return _zipf(rng, n)
    if kind == "dup_heavy":
        return rng.choice(uni[:17], n)
    if kind == "sorted":
        return np.sort(uni)
    if kind == "reverse":
        return np.sort(uni)[::-1].copy()
    if kind == "all_equal":
        return np.full(n, 0xDEADBEEF, np.uint32)
    uni[rng.random(n) < 0.3] = 0xFFFFFFFF          # maxheavy
    return uni


def _u64_words(kind, n, seed):
    """(hi, lo) words: all ones, or few distinct high words, one of them
    on 85% of the keys (a bucket above the largest class whose 32 high
    bits run out: 'done', its low words finished by a keys-only pass),
    with some all-ones keys among them."""
    rng = np.random.default_rng(seed)
    if kind == "all_ones":
        return (np.full(n, 0xFFFFFFFF, np.uint32),) * 2
    hi = rng.choice(np.array([9, 17, 2**31, 2**32 - 5, 2**32 - 1],
                             np.uint32), n)
    hi[rng.random(n) < 0.85] = 3
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    lo[: n // 50] = 0xFFFFFFFF
    hi[: n // 100] = 0xFFFFFFFF                 # all-ones keys among them
    return hi, lo


# (name, kind, n) by group: keys-only and pairs (rids = arange) through
# msd_sort, u64 through msd_sort_u64, sort_vmem.  One test per group:
# its inputs run in one process, so they share the reference's compiled
# shapes, and the collection stays small (see the module docstring).
# Each size is above the largest terminal class (8192 keys, 4096 pairs),
# so every msd_sort input but uniform-500/4096 and all-ones splits; the
# sizes are picked so that the inputs reuse each other's kernel shapes
# (a new shape costs ~3 s of interpret-mode compile): the distributions
# at 14000 make 6 distinct kernel shapes where at 9000 they made 11.
GROUPS = {
    "uniform": [("uniform", "keys", 500), ("uniform", "keys", 4096),
                ("uniform", "keys", 30000)],
    "distributions": [("zipf", "keys", 14000),
                      ("dup_heavy", "keys", 14000),
                      ("sorted", "keys", 14000), ("reverse", "keys", 14000),
                      ("all_equal", "keys", 14000),
                      ("maxheavy", "keys", 14000)],
    "pairs_u64": [("pairs_stable", "pairs", 4000),
                  ("pairs_max", "pairs", 4000), ("few_hi", "u64", 4000),
                  ("all_ones", "u64", 3000)],
    "sort_vmem": [("vmem", "vmem", 1 << 10), ("vmem", "vmem", 1 << 12),
                  ("vmem", "vmem", 1 << 15)],
}


def _inputs(name, kind, n):
    if kind == "u64":
        return _u64_words(name, n, 7)
    if kind == "pairs":
        rng = np.random.default_rng(3)
        # 64 distinct keys spread over 32 bits: ~94 ties each
        keys = rng.choice(rng.integers(0, 2**32, 64, dtype=np.uint32), n)
        if name == "pairs_max":
            keys = rng.integers(0, 2**32, n, dtype=np.uint32)
            keys[:100] = 0xFFFFFFFF
        return keys, np.arange(n, dtype=np.uint32)
    return (_keys(name if kind == "keys" else "uniform", n, 11),)


def _recorded(mod, calls, copy):
    """Patch ``mod``'s kernels to append (name, args by name, outputs),
    arguments copied with ``copy`` before the call; returns the undo."""
    saved = {k: getattr(mod, k) for k in KERNELS}

    def rec(name, f):
        sig = inspect.signature(f)

        def run(*args, **kw):
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            a = {k: copy(v) for k, v in a.arguments.items()
                 if k != "interpret"}
            out = f(*args, **kw)
            calls.append((name, a, [copy(o) for o in out]))
            return out
        return run
    for k, f in saved.items():
        setattr(mod, k, rec(k, f))
    return lambda: [setattr(mod, k, f) for k, f in saved.items()]


def _np(x):
    return np.array(x) if hasattr(x, "shape") else x


def _torch(x):
    return x.clone() if torch.is_tensor(x) else x


def _run_jax(kind, ins):
    calls = []
    undo = _recorded(jpk, calls, _np)
    try:
        if kind == "vmem":
            out = (jpe.sort_vmem(jnp.asarray(ins[0]), interpret=True),)
        elif kind == "u64":
            out = jpe.msd_sort_u64(jnp.asarray(ins[0]), jnp.asarray(ins[1]),
                                   JCFG)
        else:
            rids = jnp.asarray(ins[1]) if kind == "pairs" else None
            out = jpe.msd_sort(jnp.asarray(ins[0]), rids, JCFG)
    finally:
        undo()
    return calls, [None if o is None else np.asarray(o) for o in out]


def _run_port(kind, ins):
    calls = []
    undo = _recorded(tpk, calls, _torch)
    t = [torch.from_numpy(x.copy()) for x in ins]
    try:
        if kind == "vmem":
            out = (tpe.sort_vmem(t[0]),)
        elif kind == "u64":
            out = tpe.msd_sort_u64(t[0], t[1], TCFG)
        else:
            out = tpe.msd_sort(t[0], t[1] if kind == "pairs" else None, TCFG)
    finally:
        undo()
    return calls, [None if o is None else o.numpy() for o in out]


@pytest.mark.parametrize("group", GROUPS)
def test_v1_matches_jax_launch_by_launch(group):
    """For every input of the group: the same launches, in the same
    order, with equal tables; every launch's defined output rows (and
    tile_sort's counts) bitwise equal, and the first launch's input;
    outputs bitwise equal to the reference's and in numpy's (stable)
    order."""
    for name, kind, n in GROUPS[group]:
        _check_input(name, kind, n)


def _check_input(name, kind, n):
    at = f"{name}-{n}"
    ins = _inputs(name, kind, n)
    jcalls, jout = _run_jax(kind, ins)
    tcalls, tout = _run_port(kind, ins)
    assert tcalls and [c[0] for c in tcalls] == [c[0] for c in jcalls], at
    for i, ((kern, ja, jo), (_, ta, to)) in enumerate(zip(jcalls, tcalls)):
        where = f"{at}: launch {i} {kern}"
        assert ja.keys() == ta.keys(), where
        for k in ja:
            if k not in ARENAS:
                got = ta[k].numpy() if torch.is_tensor(ta[k]) else ta[k]
                np.testing.assert_array_equal(got, ja[k],
                                              err_msg=f"{where} {k}")
            elif i == 0 and ja[k] is not None:
                np.testing.assert_array_equal(ta[k].numpy(), ja[k],
                                              err_msg=f"{where} {k}")
        mask = tpk.defined_elems(kern, ta, to[0].numel()).numpy()
        for p in range(2):
            assert (jo[p] is None) == (to[p] is None), where
            if jo[p] is not None:
                np.testing.assert_array_equal(
                    to[p].numpy().reshape(-1)[mask], jo[p].reshape(-1)[mask],
                    err_msg=f"{where} plane {p}")
        if kern == "tile_sort":
            np.testing.assert_array_equal(to[2].numpy(), jo[2],
                                          err_msg=f"{where} cnt")
    for j, t in zip(jout, tout):
        assert (j is None) == (t is None), at
        if j is not None:
            assert t.dtype == np.uint32, at
            np.testing.assert_array_equal(t, j, err_msg=at)
    if kind == "u64":
        key = (ins[0].astype(np.uint64) << np.uint64(32)) | ins[1]
        got = (tout[0].astype(np.uint64) << np.uint64(32)) | tout[1]
        np.testing.assert_array_equal(got, np.sort(key), err_msg=at)
        return
    order = np.argsort(ins[0], kind="stable")
    np.testing.assert_array_equal(tout[0], ins[0][order], err_msg=at)
    if kind == "pairs":
        np.testing.assert_array_equal(tout[1], ins[1][order], err_msg=at)
