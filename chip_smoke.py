#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Setup: builds the CUDA kernels from ``inplacemsdradixsort_tpu_torch/csrc``,
prints the card's name and power limit, and warms every kernel up on
small sorts of 1-4 planes and one deep-tier sort (not checked, not
counted).

Main paths (each with the launch counts set to 0 just before it and read
just after), ``api.sort`` on seeded data on the card, every result
bitwise equal to a plain ``torch.sort`` reference (keys and rids,
lexicographic by (key, rid)):
- keys only: uint32 2^28 uniform (two levels, rmax 48, cap_rows 2048),
  2^22 uniform (one level, rmax 96), 2^24 with 30% 0xFFFFFFFF; equal
  mod-2^64 checksums; no small-n or overflow fallback on the uniform
  inputs;
- payload: (u32 key, u64 rid) pairs at 2^28 and at 2^30, or at 2^29
  where ``api.check_fits`` says v4 cannot take 2^30 (u64 key, u64 rid) at
  2^27; no fallback;
- deep tier: 2^26 u64 keys with 8 distinct high words, and 2^26 (u32
  key, u32 rid) pairs with half the keys one value; each reports
  ``FALLBACK_STATS["deep"] >= 1`` and ``["overflow"] == 0``.

The first sort of every input is checked launch by launch: each call of
``hist_level``, ``route_level``, ``terminal_write`` and ``splice_runs``
in it (1-4 planes, at the shapes that path gives them) is held against
the kernel's plain PyTorch version on the same CUDA tensors, exactly
(route arenas through ``canonical_runs``).  The plain version replays
the call in chunks of at most ``CHECK_CHUNK`` elements (tiles, buckets
or runs), so the check fits beside the sort at every size.  Each call's
kernel time (CUDA events around the wrapper), plain time (host clock,
synchronised) and bound (the bytes it must move, each input element read
once and each output written once, at the H100 SXM's 3.35 TB/s) are
summed per kernel.  Then: the port's peak memory in a second sort, its
time against what a user would otherwise run (``torch.sort`` on the
keys; stable, plus a gather of the rids), and each kernel's time inside
one 2^28 sort, keys only and pairs.

Per-call check lines go to ``chiprun_out/chip_smoke_calls.log``; stdout
has one line per (input, kernel, plane count).  Any failure raises
(non-zero exit).  The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero before printing any result.
"""

import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import torch

BIAS = -0x80000000
I64_MIN = -0x8000000000000000
SEED = 20240
HBM_BYTES_PER_S = 3.35e12          # H100 SXM at 700 W (NVIDIA data sheet)
CHECK_CHUNK = 1 << 25              # elements per plain-version replay
CALL_LOG = os.path.join("chiprun_out", "chip_smoke_calls.log")
# (log2 n, key kind, rid kind): one small sort per plane count, and a
# deep-tier input, run before the main paths so that no checked launch
# is a kernel's first
WARMUP = [(17, "u32", None), (17, "u32", "u32"), (17, "u32", "u64"),
          (17, "u64", "u64"), (22, "few_hi", None)]
# (label, log2 n, share of 0xFFFFFFFF, two levels, rmax, cap_rows, timed)
CASES = [("uniform 2^28", 28, 0.0, True, 48, 2048, True),
         ("uniform 2^22", 22, 0.0, False, 96, 1024, False),
         ("maxheavy 2^24", 24, 0.3, True, None, 1024, False)]
# (label, log2 n, key kind, rid kind); the first is timed kernel by kernel
PAYLOAD_CASES = [("pairs u32+u64 2^28", 28, "u32", "u64"),
                 ("u64+u64 2^27", 27, "u64", "u64")]
BIG_PAIRS_LOGN = 30                # BASELINE.md's size; 2^29 if v4 can't
# (label, log2 n, kind): inputs whose buckets no plane-0 bound can shrink
DEEP_CASES = [("deep u64 few-hi 2^26", 26, "few_hi"),
              ("deep heavy pairs 2^26", 26, "heavy_pairs")]
KERNELS = {
    # name: (source, the TPU kernel's pallas_call it replaces)
    "hist_level": ("inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                   "inplacemsdradixsort_tpu/ops/kernels_v4.py:168"),
    "route_level": ("inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                    "inplacemsdradixsort_tpu/ops/kernels_v4.py:431"),
    "terminal_write": ("inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                       "inplacemsdradixsort_tpu/ops/kernels_v4.py:765"),
    "splice_runs": ("inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                    "inplacemsdradixsort_tpu/ops/kernels_v4.py:997"),
}
LANES = 128


# ------------------------------------------------------------- data

def _gen(seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def make_keys(n, heavy, seed, dev):
    """Seeded uint32 keys on the card; a ``heavy`` share is 0xFFFFFFFF."""
    g = _gen(seed, dev)
    u = torch.randint(0, 2**32, (n,), dtype=torch.int64, device=dev,
                      generator=g)
    raw = (u - 2**31).to(torch.int32) ^ BIAS      # raw words as int32
    del u
    if heavy:
        raw[torch.rand(n, device=dev, generator=g) < heavy] = -1
    return raw.view(torch.uint32)


def make_u64(n, seed, dev):
    """Seeded uint64 values on the card (every bit pattern but 2^64-1)."""
    g = _gen(seed, dev)
    return torch.randint(I64_MIN, 2**63 - 1, (n,), dtype=torch.int64,
                         device=dev, generator=g).view(torch.uint64)


def make_input(n, key, rid, seed, dev):
    """(keys, rids or None) of the named kinds: "u32", "u64", "few_hi"
    (u64 keys with 8 distinct high words) or "heavy_pairs" (u32 keys,
    half of them 7, with u32 rids)."""
    if key == "u32":
        keys = make_keys(n, 0.0, seed, dev)
    elif key == "u64":
        keys = make_u64(n, seed, dev)
    elif key == "few_hi":
        his = torch.tensor([3, 9, 17, 40, 1000, 2**31, 2**32 - 5, 77],
                           dtype=torch.int64, device=dev)
        g = _gen(seed, dev)
        hi = his[torch.randint(0, 8, (n,), device=dev, generator=g)]
        lo = torch.randint(0, 2**32, (n,), dtype=torch.int64, device=dev,
                           generator=g)
        keys = ((hi << 32) | lo).view(torch.uint64)
        del hi, lo
    else:   # heavy_pairs
        keys = make_keys(n, 0.0, seed, dev)
        g = _gen(seed + 1, dev)
        keys.view(torch.int32)[torch.rand(n, device=dev, generator=g)
                               < 0.5] = 7
        rid = "u32"
    rids = None
    if rid == "u32":
        rids = make_keys(n, 0.0, seed + 2, dev)
    elif rid == "u64":
        rids = make_u64(n, seed + 2, dev)
    return keys, rids


# -------------------------------------------------------- references

def _order_col(x):
    """A signed tensor with the unsigned order of uint32/uint64 ``x``."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32) ^ BIAS
    return x.view(torch.int64) ^ I64_MIN


def torch_reference(keys, rids):
    """Plain torch.sort reference: keys ascending as unsigned and, with
    rids, pairs lexicographic by (key, rid), by stable sorts from the rid
    to the key."""
    kc = _order_col(keys)
    if rids is None:
        out = torch.sort(kc).values
        return (out ^ (BIAS if keys.dtype == torch.uint32 else I64_MIN))\
            .view(keys.dtype), None
    rc = _order_col(rids)
    perm = torch.sort(rc, stable=True).indices
    del rc
    perm = perm[torch.sort(kc[perm], stable=True).indices]
    del kc
    return _gather(keys, perm), _gather(rids, perm)


def _gather(x, perm):
    """x[perm] for uint32/uint64 (indexing is not defined on those)."""
    return _words(x)[perm].view(x.dtype)


def library_sort(keys, rids):
    """What a user would otherwise call: torch.sort of the keys (stable
    when rids ride along) plus a gather of the rids."""
    s = torch.sort(_order_col(keys), stable=rids is not None)
    if rids is None:
        return s.values
    return s.values, _gather(rids, s.indices)


def _words(x):
    return x.view(torch.int32 if x.element_size() == 4 else torch.int64)


def assert_equal(got, want, label, chunk=1 << 26):
    """Bitwise equality of two tensors, the reference possibly on the host
    (compared in chunks on the card)."""
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (label, got.shape, want.shape, got.dtype, want.dtype)
    g, w = _words(got), _words(want)
    for i in range(0, g.shape[0], chunk):
        assert torch.equal(g[i:i + chunk], w[i:i + chunk].to(g.device)), \
            f"{label}: differs from the torch reference in [{i}, {i + chunk})"


# ------------------------------------------------------------- timing

def host_ms(fns, rounds=2):
    """Median host-clock ms of each named callable, run in turns
    (a, b, b, a per round), each call ending synchronised."""
    times = {name: [] for name in fns}
    names = list(fns)
    for _ in range(rounds):
        for name in names + names[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def _plain(fn, *args):
    """(fn(*args), its host-clock ms, synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


# ------------------------------------------ kernels vs plain versions

def _clone(x):
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        return tuple(_clone(t) for t in x)
    return x


def named(fn, args, kw):
    """A wrapper call's arguments by name, defaults included."""
    bound = inspect.signature(fn).bind(*args, **kw)
    bound.apply_defaults()
    return bound.arguments


def _err(got, want):
    """Largest absolute difference of two plane tuples (0 if equal)."""
    err = 0
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            err = max(err, int((g.long() - w.long()).abs().max().item()))
    return err


def _groups(weight):
    """(group id of every row, number of groups): consecutive rows
    whose weights add up to about CHECK_CHUNK share a group."""
    if not weight.numel():
        return weight, 0
    gid = (torch.cumsum(weight, 0) - weight) // CHECK_CHUNK
    return gid, int(gid[-1].item()) + 1


def _tile_chunks(a):
    per = max(1, CHECK_CHUNK // (a["pitch"] * LANES))
    return [(t0, min(a["ntiles"], t0 + per))
            for t0 in range(0, a["ntiles"], per)]


def check_hist(kv4, a, out, _):
    err = ms = 0
    for t0, t1 in _tile_chunks(a):
        want, t = _plain(kv4.hist_level_ref, a["src"], a["meta"][3 * t0:],
                         a["bounds"], t1 - t0, a["pitch"], a["rmax"],
                         a["bias_input"])
        ms += t
        err = max(err, _err((out[t0:t1],), (want,)))
    return err, ms


def check_route(kv4, a, out, _):
    """Tile chunk by tile chunk, the chunk's runs are laid out packed
    (same order, every run at the next free row), both by the plain
    version and by gathering them from the kernel's arenas, and compared
    through ``canonical_runs``."""
    nt, rmax = a["ntiles"], a["rmax"]
    cnt, dst, padv = (a[k].reshape(nt, rmax) for k in ("cnt", "dst", "padv"))
    err = ms = 0
    for t0, t1 in _tile_chunks(a):
        c = cnt[t0:t1].contiguous()
        d = dst[t0:t1].reshape(-1).long()
        rows = torch.where(d >= 0, (c.reshape(-1).long() + LANES - 1)
                           // LANES, 0)
        total = int(rows.sum().item())
        if not total:
            continue
        packed = torch.where(d >= 0, torch.cumsum(rows, 0) - rows, -1) \
            .to(torch.int32).view(t1 - t0, rmax)
        want, t = _plain(kv4.route_level_ref, a["srcs"], a["meta"][3 * t0:],
                         a["bounds"], c, packed, padv[t0:t1].contiguous(),
                         total, t1 - t0, a["pitch"], rmax, a["bias_input"])
        ms += t
        live = rows > 0
        rix = kv4._spans(d[live], rows[live])
        got = tuple(x.reshape(-1, LANES)[rix] for x in out)
        err = max(err, _err(kv4.canonical_runs(got, packed, c, total),
                            kv4.canonical_runs(want, packed, c, total)))
    return err, ms


def check_terminal(kv4, a, out, before):
    """Bucket group by bucket group, the plain version writes into the
    copy of the outputs taken before the launch."""
    bt, sel = kv4._selected(a["btbl"], a["class_id"])
    m = bt[:, 1].clamp(min=0, max=a["cap_rows"]) * LANES
    gid, ngroups = _groups(torch.where(
        sel, torch.where(bt[:, 3] == 0, m, bt[:, 2]), 0))
    ms = 0
    for k in range(ngroups):
        btk = a["btbl"].clone()
        btk[:, 2] = torch.where(sel & (gid == k), btk[:, 2], 0)
        _, t = _plain(kv4.terminal_write_ref, a["srcs"], btk, before,
                      a["cap_rows"], a["class_id"], a["nlex"],
                      a["unbias_output"])
        ms += t
    return _err(out, before), ms


def check_splice(kv4, a, out, _):
    """Run group by run group, on the elements those runs cover."""
    bt = a["btbl"].long()
    real = torch.minimum(bt[:, 2], bt[:, 1].clamp(max=a["max_occ"])
                         * LANES).clamp(min=0)
    gid, ngroups = _groups(real)
    err = ms = 0
    for k in range(ngroups):
        ink = gid == k
        btk = a["btbl"].clone()
        btk[:, 2] = torch.where(ink, btk[:, 2], 0)
        want, t = _plain(kv4.splice_runs_ref, a["srcs"], btk, a["out_n"],
                         a["max_occ"], a["unbias_output"])
        ms += t
        pos = kv4._spans(bt[ink, 5], real[ink])
        err = max(err, _err(tuple(o[pos] for o in out),
                            tuple(w[pos] for w in want)))
    return err, ms


CHECKS = {"hist_level": check_hist, "route_level": check_route,
          "terminal_write": check_terminal, "splice_runs": check_splice}


def _live(meta, ntiles, pitch):
    m = meta[: 3 * ntiles].view(ntiles, 3).long()
    return int(m[:, 2].clamp(0, pitch * LANES).sum().item())


def call_bytes(name, a):
    """Bytes one call (arguments ``a`` by name) must move: each input
    element it reads once, each output element it writes once, and its
    tables."""
    if name == "hist_level":
        return 4 * (_live(a["meta"], a["ntiles"], a["pitch"])
                    + a["ntiles"] * a["rmax"] + 3 * a["ntiles"]
                    + a["bounds"].numel())
    if name == "route_level":
        cnt, ntiles = a["cnt"].long(), a["ntiles"]
        stored = cnt + (-cnt) % LANES
        wrote = int(stored[a["dst"] >= 0].sum().item())
        return 4 * (len(a["srcs"]) * (_live(a["meta"], ntiles, a["pitch"])
                                      + wrote)
                    + 3 * ntiles * a["rmax"] + 3 * ntiles
                    + a["bounds"].numel())
    bt = a["btbl"].long()
    if name == "terminal_write":
        sel = bt[:, 2] > 0
        if a["class_id"] is not None:
            sel &= bt[:, 6] == a["class_id"]
        mode0 = sel & (bt[:, 3] == 0)
        m = bt[:, 1].clamp(max=a["cap_rows"]) * LANES
        read = int(m[mode0].sum().item())
        wrote = int(torch.minimum(bt[:, 2], m)[mode0].sum().item())
        fill = int(bt[:, 2][sel & (bt[:, 3] != 0)].sum().item())
        return 4 * (len(a["srcs"]) * (read + wrote) + fill + bt.numel())
    real = torch.minimum(bt[:, 2], bt[:, 1].clamp(max=a["max_occ"]) * LANES)
    return 4 * (2 * len(a["srcs"]) * int(real.clamp(min=0).sum().item())
                + bt.numel())


class Checker:
    """While ``run`` drives a sort, every call of the kernel wrappers
    launches the kernel as the path asked, then replays the call on its
    plain version and requires equality."""

    def __init__(self, kv4, wrappers, log):
        self.kv4, self.wrappers, self.log = kv4, wrappers, log
        self.totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                  max_abs_err=0) for name in wrappers}
        self.by_input = {}      # (input, kernel, planes) -> sums

    def run(self, label, fn):
        self.label = label
        for name in self.wrappers:
            setattr(self.kv4, name, self._checked(name))
        try:
            return fn()
        finally:
            for name, f in self.wrappers.items():
                setattr(self.kv4, name, f)
            for (lbl, name, planes), r in self.by_input.items():
                if lbl == label:
                    print(f"check [{label}] {name} planes={planes}: "
                          f"{r['calls']} calls, max_abs_err {r['err']}, "
                          f"kernel {r['ms']:.3f} ms, plain {r['pms']:.3f} "
                          f"ms, bound {r['bound']:.4f} ms")

    def _checked(self, name):
        kern = self.wrappers[name]

        def call(*args, **kw):
            a = named(kern, args, kw)
            before = (_clone(tuple(a["outs"])) if name == "terminal_write"
                      else None)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = kern(*args, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1])
            err, pms = CHECKS[name](self.kv4, a, out, before)
            del before
            bound = call_bytes(name, a) / HBM_BYTES_PER_S * 1e3
            planes = 1 if name == "hist_level" else len(a["srcs"])
            extra = {k: a[k] for k in ("ntiles", "rmax", "cap_rows",
                                       "class_id", "nlex") if k in a}
            print(f"[{self.label}] {name} planes={planes} {extra}: "
                  f"max_abs_err {err} kernel {ms:.4f} ms plain {pms:.4f} "
                  f"ms bound {bound:.5f} ms", file=self.log)
            t = self.totals[name]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            t["ms"] += ms
            t["plain_ms"] += pms
            t["bound_ms"] += bound
            r = self.by_input.setdefault(
                (self.label, name, planes),
                dict(calls=0, err=0, ms=0.0, pms=0.0, bound=0.0))
            r["calls"] += 1
            r["err"] = max(r["err"], err)
            r["ms"] += ms
            r["pms"] += pms
            r["bound"] += bound
            assert err == 0, (f"{name} ({planes} planes, {extra}) on "
                              f"{self.label} disagrees with its plain "
                              f"version")
            return out
        return call


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from inplacemsdradixsort_tpu_torch import SortConfig, sort
    from inplacemsdradixsort_tpu_torch.api import check_fits
    from inplacemsdradixsort_tpu_torch.ops import _build, engine_v4
    from inplacemsdradixsort_tpu_torch.ops import kernels_v4 as kv4
    from inplacemsdradixsort_tpu_torch.utils.checking import checksum

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ------------------------------------------------------------ build
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    cfg = SortConfig()
    wrappers = {name: getattr(kv4, name) for name in KERNELS}
    os.makedirs(os.path.dirname(CALL_LOG), exist_ok=True)
    log = open(CALL_LOG, "w")
    checker = Checker(kv4, wrappers, log)

    # ---------------------------------------------------------- warm-up
    for logn, kk, rk in WARMUP:
        keys, rids = make_input(1 << logn, kk, rk, SEED - logn, dev)
        sort(keys, rids, config=cfg)
        del keys, rids
    torch.cuda.synchronize()

    # ------------------------------------------------------ main paths
    launches = dict.fromkeys(KERNELS, 0)
    kernel_ms = {}

    def timed(name):
        def run(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = wrappers[name](*args, **kw)
            b.record()
            kernel_ms.setdefault(name, []).append((a, b))
            return out
        return run

    def breakdown(label, fn):
        """Each kernel's CUDA-event time inside one run of ``fn``."""
        kernel_ms.clear()
        for name in KERNELS:
            setattr(kv4, name, timed(name))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            for name, f in wrappers.items():
                setattr(kv4, name, f)
        for name, evs in kernel_ms.items():
            each = [a.elapsed_time(b) for a, b in evs]
            print(f"main {label} {name}: {len(each)} calls, "
                  f"{sum(each):.3f} ms "
                  f"({', '.join(f'{e:.3f}' for e in each)})")
        print(f"main {label} one sort: {total * 1e3:.3f} ms")

    def path(label, names):
        """Open a main path: counts to 0; returns the closing check."""
        kv4.reset_launches()
        engine_v4.reset_fallback_stats()

        def close():
            got = dict(kv4.LAUNCHES)
            print(f"main {label} launches: {got}")
            for name in names:
                assert got[name] > 0, f"{name} was not launched on {label}"
            for name in KERNELS:
                launches[name] += got[name]
        return close

    def run_case(label, keys, rids, timed_runs, expect):
        """Sort on the card with every launch checked, compare with the
        torch reference (computed first and kept on the host), report
        fallbacks, then peak memory and times of unchecked sorts."""
        ref = torch_reference(keys, rids)
        ref = tuple(None if t is None else t.cpu() for t in ref)
        torch.cuda.synchronize()
        before = dict(engine_v4.FALLBACK_STATS)
        res = checker.run(label, lambda: sort(keys, rids, config=cfg))
        stats = {k: engine_v4.FALLBACK_STATS[k] - before[k] for k in before}
        assert_equal(res.keys, ref[0], label)
        if rids is not None:
            assert_equal(res.rids, ref[1], label + " rids")
        else:
            assert checksum(res.keys) == checksum(keys), label
        del res, ref
        expect(stats)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        sort(keys, rids, config=cfg)
        peak = torch.cuda.max_memory_allocated(dev) - base
        print(f"main {label}: bitwise equal to the torch reference, "
              f"fallbacks {stats}, port peak {peak / 2**30:.3f} GiB over "
              f"its inputs")
        if timed_runs:
            t = host_ms({"port": lambda: sort(keys, rids, config=cfg),
                         "torch": lambda: library_sort(keys, rids)},
                        rounds=timed_runs)
            n = keys.shape[0]
            what = "torch.sort" if rids is None else \
                "torch.sort(stable) + rid gather"
            print(f"main {label} port: median {t['port']:.3f} ms "
                  f"({n / t['port'] * 1e3:.4e} keys/s); {what}: median "
                  f"{t['torch']:.3f} ms ({n / t['torch'] * 1e3:.4e} "
                  f"keys/s); {2 * timed_runs} runs each, alternated")

    def no_fallback(label):
        def expect(stats):
            assert stats["small_n"] == 0 and stats["overflow"] == 0 \
                and stats["deep"] == 0, (label, stats)
        return expect

    # ---- keys only (uint32)
    close = path("keys-only", ["hist_level", "route_level",
                               "terminal_write"])
    for label, logn, heavy, two_level, rmax, cap_rows, timed_ in CASES:
        n = 1 << logn
        g = engine_v4._dev_geometry(n, 1, cfg)
        assert g.two_level == two_level, (label, g)
        assert rmax is None or g.rmax == rmax, (label, g)
        assert g.cap_rows == cap_rows, (label, g)
        x = make_keys(n, heavy, SEED + logn, dev)
        run_case(label, x, None, 2 if timed_ else 0,
                 (lambda s: None) if heavy else no_fallback(label))
        print(f"main {label}: checksum {checksum(x)}, rmax {g.rmax} "
              f"two_level {g.two_level} cap_rows {g.cap_rows}")
        if timed_:
            res = sort(x, config=cfg, timing=True)
            print(f"main {label} phases (host clock, synchronised):")
            print(res.pretty_times())
            del res
            breakdown(label, lambda: sort(x, config=cfg))
        del x
    close()

    # ---- payload planes
    close = path("payload", ["hist_level", "route_level", "terminal_write"])
    for i, (label, logn, kk, rk) in enumerate(PAYLOAD_CASES):
        keys, rids = make_input(1 << logn, kk, rk, SEED + logn, dev)
        run_case(label, keys, rids, 2, no_fallback(label))
        if i == 0:
            breakdown(label, lambda: sort(keys, rids, config=cfg))
        del keys, rids
    # BASELINE's 2^30 rows where engine="auto" would take them, else 2^29
    big = BIG_PAIRS_LOGN
    try:
        check_fits(1 << big, 3, dev, cfg)
    except NotImplementedError as e:
        print(f"main pairs at 2^{big}: {e}")
        big -= 1
        check_fits(1 << big, 3, dev, cfg)
    label = f"pairs u32+u64 2^{big}"
    keys, rids = make_input(1 << big, "u32", "u64", SEED + big, dev)
    run_case(label, keys, rids, 1, no_fallback(label))
    del keys, rids
    close()

    # ---- deep tier
    close = path("deep", list(KERNELS))

    def deep_expect(label):
        def expect(stats):
            assert stats["deep"] >= 1 and stats["overflow"] == 0, \
                (label, stats)
        return expect
    for label, logn, kind in DEEP_CASES:
        keys, rids = make_input(1 << logn, kind, None, SEED + 3 + logn, dev)
        run_case(label, keys, rids, 1, deep_expect(label))
        del keys, rids
    close()

    log.close()
    checked = {name for _, name, _ in checker.by_input}
    assert checked == set(KERNELS), f"kernels never checked: {checked}"
    print(f"main launches (all paths): {launches}")
    totals = checker.totals
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": totals[name]["max_abs_err"],
         "ms": round(totals[name]["ms"], 4),
         "plain_ms": round(totals[name]["plain_ms"], 4),
         "bound_ms": round(totals[name]["bound_ms"], 4),
         "bound_by": "bytes", "library_ms": None}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
