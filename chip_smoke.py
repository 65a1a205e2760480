#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Setup: builds the CUDA kernels from ``inplacemsdradixsort_tpu_torch/csrc``
and prints the card's name and power limit.

Phase 1 (kernels against their plain versions): records the inputs of
every ``hist_level`` / ``route_level`` / ``terminal_write`` call during one
``sort`` of 2^24 uniform uint32 keys, reruns each kernel and its plain
PyTorch version on those CUDA tensors and requires equality (exact for
counts and output; through ``canonical_runs`` for route arenas); times
both with CUDA events.

Phase 2 (main path): ``api.sort`` on seeded uint32 keys on the card —
2^28 uniform (two levels, rmax 48, cap_rows 2048), 2^22 uniform (one
level, rmax 96), 2^24 with 30% 0xFFFFFFFF — each bitwise equal to
``torch.sort`` and with an equal mod-2^64 checksum; no small-n or
overflow fallback on the uniform inputs; every kernel launched.  Times
the port and ``torch.sort`` at 2^28 (median of warm runs, keys/s) and
each kernel inside one 2^28 sort.

Any failure raises (non-zero exit).  The last two lines are the per-kernel
JSON record and ``{"ok": true, "device": {...}}``.  Without a CUDA device
it exits non-zero before printing any result.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

BIAS = -0x80000000
SEED = 20240
PHASE1_LOGN = 24
# (label, log2 n, share of 0xFFFFFFFF, two levels, rmax, cap_rows, timed)
CASES = [("uniform 2^28", 28, 0.0, True, 48, 2048, True),
         ("uniform 2^22", 22, 0.0, False, 96, 1024, False),
         ("maxheavy 2^24", 24, 0.3, True, None, 1024, False)]
KERNELS = {
    # name: (source, the TPU kernel's pallas_call it replaces)
    "hist_level": ("inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                   "inplacemsdradixsort_tpu/ops/kernels_v4.py:168"),
    "route_level": ("inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                    "inplacemsdradixsort_tpu/ops/kernels_v4.py:431"),
    "terminal_write": ("inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                       "inplacemsdradixsort_tpu/ops/kernels_v4.py:765"),
}


def make_keys(n, heavy, seed, dev):
    """Seeded uint32 keys on the card; a ``heavy`` share is 0xFFFFFFFF."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u = torch.randint(0, 2**32, (n,), dtype=torch.int64, device=dev,
                      generator=g)
    raw = (u - 2**31).to(torch.int32) ^ BIAS      # raw words as int32
    del u
    if heavy:
        raw[torch.rand(n, device=dev, generator=g) < heavy] = -1
    return raw.view(torch.uint32)


def torch_sorted(keys):
    """torch.sort of uint32 keys on the card (as order-preserving int32)."""
    return (torch.sort(keys.view(torch.int32) ^ BIAS).values ^ BIAS) \
        .view(torch.uint32)


def cuda_ms(fn, reps=5):
    """Median milliseconds of ``fn`` on the card (CUDA events), warm."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from inplacemsdradixsort_tpu_torch import SortConfig, sort
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

    # ----------------------------------- phase 1: kernels vs plain versions
    wrappers = {name: getattr(kv4, name) for name in KERNELS}
    captured = []

    def recorder(name):
        def rec(*args, **kw):
            # snapshot the inputs (terminal_write updates ``out`` in place)
            captured.append((name, [a.clone() if torch.is_tensor(a) else a
                                    for a in args], dict(kw)))
            return wrappers[name](*args, **kw)
        return rec

    x24 = make_keys(1 << PHASE1_LOGN, 0.0, SEED, dev)
    for name in KERNELS:
        setattr(kv4, name, recorder(name))
    try:
        res = sort(x24, config=cfg)
    finally:
        for name, fn in wrappers.items():
            setattr(kv4, name, fn)
    assert torch.equal(res.keys.view(torch.int32),
                       torch_sorted(x24).view(torch.int32)), "phase 1 sort"
    assert {c[0] for c in captured} == set(KERNELS), "a kernel was not called"

    record = {name: dict(ms=0.0, plain_ms=0.0, max_abs_err=0)
              for name in KERNELS}
    for name, args, kw in captured:
        if name == "terminal_write":
            src, btbl, out, cap = args

            def kern(out=out):
                return wrappers[name](src, btbl, out.clone(), cap, **kw)

            def plain(out=out):
                return kv4.terminal_write_ref(src, btbl, out.clone(), cap,
                                              **kw)
            got, want = kern(), plain()
        elif name == "route_level":
            def kern():
                return wrappers[name](*args, **kw)

            def plain():
                return kv4.route_level_ref(*args, **kw)
            dst, cnt, rows = args[4], args[3], args[6]
            got = kv4.canonical_runs(kern(), dst, cnt, rows)
            want = kv4.canonical_runs(plain(), dst, cnt, rows)
        else:
            def kern():
                return wrappers[name](*args, **kw)

            def plain():
                return kv4.hist_level_ref(*args, **kw)
            got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        r = record[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        ms, pms = cuda_ms(kern), cuda_ms(plain)
        r["ms"] += ms
        r["plain_ms"] += pms
        print(f"phase1 {name} {kw}: max_abs_err {err} kernel {ms:.3f} ms "
              f"plain {pms:.3f} ms")
        assert err == 0, f"{name} disagrees with its plain version"
    del captured, x24, res

    # ------------------------------------------------ phase 2: main path
    kv4.reset_launches()
    engine_v4.reset_fallback_stats()
    for label, logn, heavy, two_level, rmax, cap_rows, timed in CASES:
        n = 1 << logn
        g = engine_v4._dev_geometry(n, 1, cfg)
        assert g.two_level == two_level, (label, g)
        assert rmax is None or g.rmax == rmax, (label, g)
        assert g.cap_rows == cap_rows, (label, g)
        x = make_keys(n, heavy, SEED + logn, dev)
        before = dict(engine_v4.FALLBACK_STATS)
        res = sort(x, config=cfg)
        stats = {k: engine_v4.FALLBACK_STATS[k] - before[k]
                 for k in before}
        want = torch_sorted(x)
        assert torch.equal(res.keys.view(torch.int32),
                           want.view(torch.int32)), label
        assert checksum(res.keys) == checksum(x), label
        if not heavy:
            assert stats["small_n"] == 0 and stats["overflow"] == 0, \
                (label, stats)
        print(f"phase2 {label}: bitwise equal to torch.sort, checksum "
              f"{checksum(res.keys)}, rmax {g.rmax} two_level "
              f"{g.two_level} cap_rows {g.cap_rows}, fallbacks {stats}")
        if timed:
            port_s, torch_s = [], []
            for order in ("port", "torch", "torch", "port") * 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if order == "port":
                    sort(x, config=cfg)
                else:
                    torch_sorted(x)
                torch.cuda.synchronize()
                (port_s if order == "port" else torch_s).append(
                    time.perf_counter() - t0)
            pm, tm = statistics.median(port_s), statistics.median(torch_s)
            print(f"phase2 {label} port: median {pm * 1e3:.3f} ms "
                  f"({n / pm:.4e} keys/s) over {len(port_s)} runs; "
                  f"torch.sort: median {tm * 1e3:.3f} ms "
                  f"({n / tm:.4e} keys/s)")
            res = sort(x, config=cfg, timing=True)
            print(f"phase2 {label} phases (host clock, synchronised):")
            print(res.pretty_times())
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
            for name in KERNELS:
                setattr(kv4, name, timed(name))
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sort(x, config=cfg)
                torch.cuda.synchronize()
                total = time.perf_counter() - t0
            finally:
                for name, fn in wrappers.items():
                    setattr(kv4, name, fn)
            for name, evs in kernel_ms.items():
                each = [a.elapsed_time(b) for a, b in evs]
                print(f"phase2 {label} {name}: {len(each)} calls, "
                      f"{sum(each):.3f} ms ({', '.join(f'{e:.3f}' for e in each)})")
            print(f"phase2 {label} one sort: {total * 1e3:.3f} ms")
        del x, want, res

    launches = dict(kv4.LAUNCHES)
    print(f"phase2 launches: {launches}")
    for name in KERNELS:
        assert launches[name] > 0, f"{name} was not launched on the main path"

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": record[name]["max_abs_err"],
         "ms": round(record[name]["ms"], 4),
         "plain_ms": round(record[name]["plain_ms"], 4)}
        for name, (src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
