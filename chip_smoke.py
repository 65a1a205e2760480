#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--paths keys,payload,deep,v5,v1,v3,lsb,chunked]

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
- payload: (u32 key, u64 rid) pairs at 2^28 and 2^29, (u64 key, u64
  rid) at 2^27; no fallback;
- deep tier: 2^26 u64 keys with 8 distinct high words, and 2^26 (u32
  key, u32 rid) pairs with half the keys one value; each reports
  ``FALLBACK_STATS["deep"] >= 1`` and ``["overflow"] == 0``;
- the in-place v5 engine: 2^30 (u32 key, u64 rid) pairs through
  ``engine="auto"``, which ``api.check_fits`` hands to v5 (v4's topology
  holds too few buckets); 2^28 uniform keys on v5 beside v4; 2^24 keys
  with 30% 0xFFFFFFFF (value-fill regions and children); 2^24 pairs with
  half the keys one value (retry, then the deep tier); and
  ``sort_v5_from_chunks(raw=True)`` at 2^26 keys, checked slab by slab
  with ``raw_check_2d``.  The 2^30 sort needs about 60 GB of the card
  while it is checked (inputs, W and two copies of W), about 36 GB
  without the check;
- the v1 engine (``engine="pallas"`` at its default config: 2^15-element
  tiles, 8 range bits, 8 block rows): uint32 keys at 2^28, (u32 key,
  u32 rid = arange) pairs at 2^28, 2^24 keys with 30% 0xFFFFFFFF and
  2^26 u64 keys with 8 distinct high words (done buckets, the low words
  finished per bucket), each with its phase split; and ``sort_vmem`` at
  2^15 and 2^20 (one ``ragged_sort`` launch over the whole input);
- the v3 engine (``engine="v3"`` at its default config: 1024-row tiles,
  rmax and cap_rows from the plan): uint32 keys at 2^28 (cap_rows 2048,
  rmax 48, 2,149 L1 tiles), (u32 key, u32 rid = arange) pairs at 2^28,
  uint64 keys at 2^27 through (hi, lo), and 2^24 keys with 30%
  0xFFFFFFFF (value-fill buckets, counted), each with its phase split;
  the uniform inputs must take exactly two ``partition_level`` launches
  and one ``terminal_sort_write`` launch (no retry, no fallback);
- the LSB engine (``engine="lsb"`` at its default config: 8-bit digits,
  pitch 768 rows): uint32 keys at 2^28 (2,731 tiles, 4 passes), (u32
  key, u32 rid = a seeded permutation) pairs at 2^28, uint64 keys at
  2^27 (8 passes), int32 and float32 keys at 2^24, each pass exactly one
  ``hist_level.digit``, ``route_level.digit`` and ``splice_runs``
  launch; pairs are held to a reference stable by key (equal keys keep
  their rids' input order);
- the chunked sort (``chunked.sort_external``): 2^32 uint32 keys in 16
  chunks of 2^28 generated on the card from (seed, i) (BASELINE.md's
  config 2, past v4's n < 2^31), checked piece by piece (sorted within
  and across pieces, the count, mod-2^64 sums of x and of a fixed mix of
  x against the generated chunks'), with its peak against the input;
  and 2^30 (u32 key, u32 rid) pairs in 4 chunks, bitwise equal to a
  lexicographic ``torch.sort`` reference.

The first sort of every input is checked launch by launch: each call of
``hist_level`` and ``route_level`` (their digit modes and the route's
accumulate mode counted and reported apart, as ``hist_level.digit``,
``route_level.digit`` and ``route_level.accumulate``),
``terminal_write``, ``splice_runs``,
``seqroute_level``, ``block_permute``, ``partition_level``,
``terminal_sort_write``, ``tile_sort``, ``distribute``, ``ragged_sort``
and ``compact`` in it (at the shapes that path gives them) is held
against the kernel's plain PyTorch version on the same CUDA tensors,
exactly (range-mode route arenas through ``canonical_runs``, digit-mode
ones bit for bit on every run row, accumulate-mode ones also with every
row the call does not own unchanged, the arena copied before the
launch; seqroute's W region by
region through ``canonical_regions`` and the v3 arenas child by child
through ``canonical_children``, since the order inside a stream or a
child is not part of their contract; the v1 arenas on the rows each call
defines; W and the v1 arenas are copied before the in-place launches).
The plain version replays the call in chunks of at most ``CHECK_CHUNK``
elements (tiles, buckets, runs, segments or cycles; ``partition_level``
with its cursors carried from chunk to chunk), so the check fits beside
the sort at every size.  Each call's
kernel time (CUDA events around the wrapper), plain time (host clock,
synchronised) and bound (the bytes it must move, each input element read
once and each output written once, at the H100 SXM's 3.35 TB/s) are
summed per kernel, and, where one PyTorch call computes a launch's
function, that call's time on the same inputs, its result required
equal to the kernel's (the library time; the port never calls it):
``index_select`` for ``splice_runs``, ``block_permute`` (W's blocks, on
the pre-launch copy), ``distribute`` and ``compact`` (gather indices
built outside the timed call); ``torch.sort`` for ``tile_sort``
launches (by row of tiles, pairs as order-preserving int64 words as
below), keys-only ``ragged_sort`` launches and the 1- and 2-plane
``terminal_sort_write`` and ``terminal_write`` launches (the buckets
gathered, outside the timed
call, into rows of class_rows*128 or cap_rows*128 with SENT after each
bucket's pad, two planes packed into order-preserving int64 words
(key << 32) | (val + 2^31), then sorted by row; summed by plane count
at the end);
``torch.bincount`` of tile * rmax + bin for ``hist_level`` and
``hist_level.digit``; a stable ``torch.sort`` of (tile, bin) keys for
``route_level``, ``route_level.accumulate`` and ``route_level.digit``
(the order of the partition; the planes gathered by it must equal the
runs' real prefixes, bit for bit in the digit mode and up to the order
inside each run in the others); the bin is the digit or, in range mode,
the range from ``torch.searchsorted`` on the parent's bounds, built
outside the timed call, on the level launches of at most
``LIBRARY_MAX`` live elements whose index tables fit the card's free
memory beside the sort.  Where the library call
covers only some launches, the JSON record gives their count
(``library_calls``) and the kernel's time on them
(``library_kernel_ms``) beside ``library_ms``.  ``hist_level``,
``hist_level.digit``, ``route_level`` (every mode), ``compact``,
``block_permute``, ``terminal_write``, ``terminal_sort_write``,
``seqroute_level`` and ``tile_sort`` also report their launch alone
(CUDA events around the C launcher, without the wrapper's host work,
uploads and
syncs) as ``launch_ms``, per call in the log and summed in the JSON
record; the log gives each terminal launch's path and cluster size
(``kernels_v4.terminal_path``) and its resident clusters.  Then:
the port's peak memory
in a second sort, its time against what a user would otherwise run
(``torch.sort`` on the keys; stable, plus a gather of the rids), and
each kernel's time inside one 2^28 sort, keys only and pairs (v4, v1,
v3 and LSB), and one 2^30 v5 sort of pairs; the host ms of the check of
the largest tables v1 hands ``distribute`` at 2^28 keys, on the host as
the engine passes them and on the card; the chunked sorts' time, phase
split and peak memory in a second, unchecked run.

Per-call check lines go to ``chiprun_out/chip_smoke_calls.log``; stdout
has one line per (input, kernel, plane count).  Any failure raises
(non-zero exit).  The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits
non-zero before printing any result.  ``--paths`` runs only the named
main paths (and skips the check that every kernel was checked); with no
arguments every path runs.
"""

import dataclasses
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
import types

import torch

BIAS = -0x80000000
I64_MIN = -0x8000000000000000
SEED = 20240
HBM_BYTES_PER_S = 3.35e12          # H100 SXM at 700 W (NVIDIA data sheet)
CHECK_CHUNK = 1 << 25              # elements per plain-version replay
# the largest level launch (live elements) that gets a library time
LIBRARY_MAX = 1 << 28
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
BIG_PAIRS_LOGN = 29                # v4's largest pairs (2^30 goes to v5)
# (label, log2 n, kind): inputs whose buckets no plane-0 bound can shrink
DEEP_CASES = [("deep u64 few-hi 2^26", 26, "few_hi"),
              ("deep heavy pairs 2^26", 26, "heavy_pairs")]
# v5 warm-up sorts (log2 n, key kind, rid kind), run with engine="v5"
WARMUP_V5 = [(22, "u32", None), (22, "u32", "u64")]
V5_PAIRS_LOGN = 30                 # BASELINE.md's shape and size
V5_KEYS_LOGN = 28                  # keys on v5 beside v4
V5_SMALL_LOGN = 24                 # value fill; retry into the deep tier
V5_RAW_LOGN = 26                   # sort_v5_from_chunks(raw=True)
# v1 (engine="pallas", default config): (label, log2 n, key kind, rid
# kind, share of 0xFFFFFFFF, timed rounds); then sort_vmem sizes
V1_CASES = [("v1 keys 2^28", 28, "u32", None, 0.0, 2),
            ("v1 pairs u32+u32(arange) 2^28", 28, "u32", "arange", 0.0, 1),
            ("v1 maxheavy 2^24", 24, "u32", None, 0.3, 1),
            ("v1 u64 few-hi 2^26", 26, "few_hi", None, 0.0, 1)]
V1_VMEM_LOGN = [15, 20]
# v3 (engine="v3", default config): (label, log2 n, key kind, rid kind,
# share of 0xFFFFFFFF, timed rounds)
V3_CASES = [("v3 keys 2^28", 28, "u32", None, 0.0, 2),
            ("v3 pairs u32+u32(arange) 2^28", 28, "u32", "arange", 0.0, 1),
            ("v3 u64 2^27", 27, "u64", None, 0.0, 1),
            ("v3 maxheavy 2^24", 24, "u32", None, 0.3, 1)]
# LSB (engine="lsb", default config: 8-bit digits, pitch 768 rows):
# (label, log2 n, key kind, rid kind, timed rounds); pairs are stable by
# key, so their rids are a seeded permutation
LSB_CASES = [("lsb keys 2^28", 28, "u32", None, 2),
             ("lsb pairs u32+u32(perm) 2^28", 28, "u32", "perm", 1),
             ("lsb u64 2^27", 27, "u64", None, 1),
             ("lsb i32 2^24", 24, "i32", None, 0),
             ("lsb f32 2^24", 24, "f32", None, 0)]
# chunked sort_external: (label, log2 n, chunks, with u32 rids); the
# first is BASELINE.md's config 2 (past v4's n < 2^31), checked by
# order, count and mod-2^64 sums; the second bitwise against torch.sort
CHUNKED_CASES = [("chunked keys 2^32", 32, 16, False),
                 ("chunked pairs u32+u32 2^30", 30, 4, True)]
KERNELS = {
    # name: (wrapper module, source, the TPU kernel's pallas_call); a
    # name "wrapper.mode" is a mode of that wrapper with its own kernel
    # or launch count (kernels_v4.LAUNCHES)
    "hist_level": ("kv4", "inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                   "inplacemsdradixsort_tpu/ops/kernels_v4.py:168"),
    "hist_level.digit": ("kv4",
                         "inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                         "inplacemsdradixsort_tpu/ops/kernels_v4.py:168"),
    "route_level": ("kv4",
                    "inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                    "inplacemsdradixsort_tpu/ops/kernels_v4.py:431"),
    "route_level.digit": ("kv4",
                          "inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                          "inplacemsdradixsort_tpu/ops/kernels_v4.py:431"),
    "route_level.accumulate": (
        "kv4", "inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
        "inplacemsdradixsort_tpu/ops/kernels_v4.py:431"),
    "terminal_write": ("kv4",
                       "inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                       "inplacemsdradixsort_tpu/ops/kernels_v4.py:765"),
    "splice_runs": ("kv4",
                    "inplacemsdradixsort_tpu_torch/csrc/kernels_v4.cu",
                    "inplacemsdradixsort_tpu/ops/kernels_v4.py:997"),
    "seqroute_level": ("kv5",
                       "inplacemsdradixsort_tpu_torch/csrc/kernels_v5.cu",
                       "inplacemsdradixsort_tpu/ops/kernels_v5.py:307"),
    "block_permute": ("kv5",
                      "inplacemsdradixsort_tpu_torch/csrc/kernels_v5.cu",
                      "inplacemsdradixsort_tpu/ops/kernels_v5.py:501"),
    "partition_level": ("kv3",
                        "inplacemsdradixsort_tpu_torch/csrc/kernels_v3.cu",
                        "inplacemsdradixsort_tpu/ops/kernels_v3.py:307"),
    # launches the v4 terminal kernel (ops/kernels_v3.py says why)
    "terminal_sort_write": ("kv3",
                            "inplacemsdradixsort_tpu_torch/csrc/"
                            "kernels_v4.cu",
                            "inplacemsdradixsort_tpu/ops/kernels_v3.py:577"),
    "tile_sort": ("pk",
                  "inplacemsdradixsort_tpu_torch/csrc/pallas_kernels.cu",
                  "inplacemsdradixsort_tpu/ops/pallas_kernels.py:115"),
    "distribute": ("pk",
                   "inplacemsdradixsort_tpu_torch/csrc/pallas_kernels.cu",
                   "inplacemsdradixsort_tpu/ops/pallas_kernels.py:314"),
    "ragged_sort": ("pk",
                    "inplacemsdradixsort_tpu_torch/csrc/pallas_kernels.cu",
                    "inplacemsdradixsort_tpu/ops/pallas_kernels.py:430"),
    "compact": ("pk",
                "inplacemsdradixsort_tpu_torch/csrc/pallas_kernels.cu",
                "inplacemsdradixsort_tpu/ops/pallas_kernels.py:620"),
}
# kernels whose launch alone (CUDA events around the C launcher, the
# wrapper's host work and uploads outside) is timed beside the wrapper
LAUNCH_TIMED = ("hist_level", "hist_level.digit", "route_level",
                "route_level.digit", "route_level.accumulate", "compact",
                "block_permute", "terminal_write", "terminal_sort_write",
                "seqroute_level", "tile_sort")
LANES = 128
BLK = 256 * LANES                  # v5's exchange block, in elements
# the wrapper functions behind the KERNELS entries
WRAPPERS = tuple(dict.fromkeys(name.split(".")[0] for name in KERNELS))


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
    """(keys, rids or None) of the named kinds: "u32", "u64", "i32",
    "f32" (standard normal), "few_hi" (u64 keys with 8 distinct high
    words) or "heavy_pairs" (u32 keys, half of them 7, with u32 rids);
    rids "u32", "u64", "arange" (the uint32 indices) or "perm" (a seeded
    permutation of them)."""
    if key in ("u32", "i32"):
        keys = make_keys(n, 0.0, seed, dev)
        if key == "i32":
            keys = keys.view(torch.int32)
    elif key == "f32":
        keys = torch.randn(n, device=dev, generator=_gen(seed, dev))
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
    if rid == "perm":
        rids = torch.randperm(n, device=dev, generator=_gen(seed + 2, dev)) \
            .to(torch.int32).view(torch.uint32)
    elif rid == "arange":
        rids = torch.arange(n, dtype=torch.int32, device=dev) \
            .view(torch.uint32)
    elif rid == "u32":
        rids = make_keys(n, 0.0, seed + 2, dev)
    elif rid == "u64":
        rids = make_u64(n, seed + 2, dev)
    return keys, rids


# -------------------------------------------------------- references

def _order_col(x):
    """A signed tensor with the order of ``x``: uint32/uint64 as
    unsigned, int32 as it is, float32 in IEEE total order (-0 < +0).
    Each map is its own inverse: ``_order_col(c.view(x.dtype))`` of a
    sorted column ``c``, viewed as x's dtype, is x sorted."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32) ^ BIAS
    if x.dtype == torch.int32:
        return x
    if x.dtype == torch.float32:
        i = x.view(torch.int32)
        return i ^ ((i >> 31) & 0x7FFFFFFF)
    return x.view(torch.int64) ^ I64_MIN


def torch_reference(keys, rids, stable=False):
    """Plain torch.sort reference: keys ascending (``_order_col``) and,
    with rids, pairs lexicographic by (key, rid), by stable sorts from the
    rid to the key; ``stable``: pairs stable by key (rids in input order
    among equal keys), as ``engine="lsb"`` orders them."""
    kc = _order_col(keys)
    if rids is None:
        return _order_col(torch.sort(kc).values.view(keys.dtype)) \
            .view(keys.dtype), None
    if stable:
        perm = torch.sort(kc, stable=True).indices
        return _gather(keys, perm), _gather(rids, perm)
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


def check_hist(m, a, out, _):
    err = ms = 0
    for t0, t1 in _tile_chunks(a):
        want, t = _plain(m.kv4.hist_level_ref, a["src"], a["meta"][3 * t0:],
                         a["bounds"], t1 - t0, a["pitch"], a["rmax"],
                         a["bias_input"], a["digit_shift"], a["digit_bits"])
        ms += t
        err = max(err, _err((out[t0:t1],), (want,)))
    return err, ms


def check_route(m, a, out, before):
    """Tile chunk by tile chunk, the chunk's runs are laid out packed
    (same order, every run at the next free row), both by the plain
    version and by gathering them from the kernel's arenas, and compared:
    bit for bit in the stable digit mode, else through
    ``canonical_runs``.  In accumulate mode every row that no run of the
    call owns must still hold what it held before the launch."""
    nt, rmax = a["ntiles"], a["rmax"]
    cnt, dst, padv = (a[k].reshape(nt, rmax) for k in ("cnt", "dst", "padv"))
    digit = a["digit_shift"] is not None
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
        want, t = _plain(m.kv4.route_level_ref, a["srcs"], a["meta"][3 * t0:],
                         a["bounds"], c, packed, padv[t0:t1].contiguous(),
                         total, t1 - t0, a["pitch"], rmax, a["bias_input"],
                         a["digit_shift"], a["digit_bits"], a["digit_plane"])
        ms += t
        live = rows > 0
        rix = m.kv4._spans(d[live], rows[live])
        got = tuple(x.reshape(-1, LANES)[rix] for x in out)
        if digit:
            err = max(err, _err(got, want))
        else:
            err = max(err, _err(m.kv4.canonical_runs(got, packed, c, total),
                                m.kv4.canonical_runs(want, packed, c,
                                                     total)))
    if before is not None:
        err = max(err, _untouched(m, out, before, dst, cnt))
    return err, ms


def _untouched(m, out, before, dst, cnt):
    """1 if a row that no run of the call owns changed, else 0 (compared
    in blocks of 2^20 rows)."""
    rows = out[0].shape[0]
    owned = torch.zeros(rows, dtype=torch.bool, device=out[0].device)
    owned[m.kv4.run_rows(dst, cnt)[0]] = True
    for r0 in range(0, rows, 1 << 20):
        keep = ~owned[r0:r0 + (1 << 20)]
        for o, b in zip(out, before):
            diff = (o[r0:r0 + (1 << 20)] != b[r0:r0 + (1 << 20)]).any(1)
            if bool((diff & keep).any().item()):
                return 1
    return 0


def check_terminal(m, a, out, before):
    """Bucket group by bucket group, the plain version writes into the
    copy of the outputs taken before the launch."""
    bt, sel = m.kv4._selected(a["btbl"], a["class_id"])
    size = bt[:, 1].clamp(min=0, max=a["cap_rows"]) * LANES
    gid, ngroups = _groups(torch.where(
        sel, torch.where(bt[:, 3] == 0, size, bt[:, 2]), 0))
    ms = 0
    for k in range(ngroups):
        btk = a["btbl"].clone()
        btk[:, 2] = torch.where(sel & (gid == k), btk[:, 2], 0)
        _, t = _plain(m.kv4.terminal_write_ref, a["srcs"], btk, before,
                      a["cap_rows"], a["class_id"], a["nlex"],
                      a["unbias_output"])
        ms += t
    return _err(out, before), ms


def check_splice(m, a, out, _):
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
        want, t = _plain(m.kv4.splice_runs_ref, a["srcs"], btk, a["out_n"],
                         a["max_occ"], a["unbias_output"])
        ms += t
        pos = m.kv4._spans(bt[ink, 5], real[ink])
        err = max(err, _err(tuple(o[pos] for o in out),
                            tuple(w[pos] for w in want)))
    return err, ms


def _v5_slots(m, a, nslots):
    return m.kv5.block_slots(a["cnt_tbl"], a["base_tbl"], a["slot_tbl"],
                             a["ntiles"], a["pitch"], a["rmax"], nslots)


def check_seqroute(m, a, out, before):
    """The plain version replays the call tile group by tile group,
    reading the copy of W taken before the launch and writing a second
    copy; then every region (range d's stream, gathered from its blocks)
    is compared through ``canonical_regions``: its first cnt[d] tuples as
    a sorted multiset, the pads after them exactly.  Slots outside the
    streams must be as they were."""
    nt, pitch, rmax = a["ntiles"], a["pitch"], a["rmax"]
    want = _clone(before)
    per = max(1, CHECK_CHUNK // (pitch * LANES))
    ms = 0
    for t0 in range(0, nt - 1, per):
        _, t = _plain(m.kv5.seqroute_level_ref, before, a["meta"],
                      a["cnt_tbl"], a["base_tbl"], a["slot_tbl"],
                      a["padv_tbl"], nt, pitch, rmax, a["nlex"],
                      a["bias_input"], want, (t0, min(nt - 1, t0 + per)))
        ms += t
    nslots = out[0].numel() // m.kv5.BLK + rmax
    boff, bslot = _v5_slots(m, a, nslots)
    total = a["base_tbl"].reshape(nt, rmax)[-1].long()
    err = 0
    for d in range(rmax):
        (_, g), = m.kv5.canonical_regions(out, boff, bslot, total, [d])
        (_, w), = m.kv5.canonical_regions(want, boff, bslot, total, [d])
        err = max(err, _err(g, w))
    used = torch.zeros(nslots + 1, dtype=torch.bool, device=bslot.device)
    used[torch.where(bslot >= 0, bslot, nslots)] = True
    idle = ~used[: out[0].numel() // m.kv5.BLK]
    for g, b in zip(out, before):
        gb, bb = m.kv5.blocks_of(g), m.kv5.blocks_of(b)
        tail = gb.numel()
        err = max(err, _err((gb[idle], g.view(-1)[tail:]),
                            (bb[idle], b.view(-1)[tail:])))
    return err, ms


def check_permute(m, a, out, before):
    """Cycle group by cycle group, the plain version moves the blocks of
    the copy of W taken before the launch (cycles are independent, so
    each group is exact on its own); W must then be bitwise equal."""
    off = a["cyc_off"].long().cpu()
    moved = off[1:] - off[:-1]
    gid, ngroups = _groups(moved * m.kv5.BLK)
    first = torch.searchsorted(gid, torch.arange(ngroups + 1)).tolist()
    ms = 0
    for k in range(ngroups):
        c0, c1 = first[k], first[k + 1]
        o0, o1 = int(off[c0]), int(off[c1])
        sub_off = (a["cyc_off"][c0:c1 + 1] - o0).contiguous()
        _, t = _plain(m.kv5.block_permute_ref, before, sub_off,
                      a["cyc_slots"][o0:o1])
        ms += t
    return _err(out, before), ms


def library_permute(m, a, out, before):
    """One PyTorch call per plane computes block_permute's function out
    of place: ``index_select`` of W's blocks by ``src_of_final``, built
    from the cycles (slot cyc[i] takes the block of slot cyc[i+1]).  Its
    host-clock ms on the copy of W taken before the launch, summed over
    the planes; each result must equal the kernel's blocks."""
    off = a["cyc_off"].long()
    slots = a["cyc_slots"].long()
    nslots = m.kv5.blocks_of(before[0]).shape[0]
    src = torch.arange(nslots, device=slots.device)
    if slots.numel():
        nxt = torch.arange(1, slots.numel() + 1, device=slots.device)
        nxt[off[1:] - 1] = off[:-1]
        src[slots] = slots[nxt]
    ms = 0
    for g, b in zip(out, before):
        lib, t = _plain(torch.index_select, m.kv5.blocks_of(b), 0, src)
        ms += t
        assert torch.equal(lib, m.kv5.blocks_of(g)), "index_select differs"
        del lib
    return ms


def library_splice(m, a, out, _):
    """One PyTorch call per plane computes splice_runs' gather:
    ``index_select`` of the flattened source by the index of every run's
    real prefix (built first, not timed); the result (unbiased when the
    call asks, outside the timed call) must equal the kernel's elements
    at the runs' output offsets."""
    bt = a["btbl"].long()
    real = torch.minimum(bt[:, 2], bt[:, 1].clamp(max=a["max_occ"])
                         * LANES).clamp(min=0)
    idx = m.kv4._spans(bt[:, 0] * LANES, real)
    pos = m.kv4._spans(bt[:, 5], real)
    ms = 0
    for o, src in zip(out, a["srcs"]):
        lib, t = _plain(torch.index_select, src.reshape(-1), 0, idx)
        ms += t
        if a["unbias_output"]:
            lib ^= BIAS
        assert torch.equal(lib, o[pos]), "splice index_select differs"
        del lib
    return ms


def _level_bins(m, a, src):
    """(tile index, flat source index, bin) of every live element of a
    level launch whose bin is below rmax: the digit, or the range from
    ``torch.searchsorted`` on its parent's bounds (``bias_input`` applied
    first)."""
    nt, rmax = a["ntiles"], a["rmax"]
    parent, idx, live = m.kv4._tile_index(src, a["meta"], nt, a["pitch"])
    k = src.reshape(-1)[idx]
    if a["digit_shift"] is None:
        b = m.kv4._classify(a["bounds"], parent,
                            k ^ BIAS if a["bias_input"] else k, rmax)
    else:
        b = m.kv4._digits(k, a["digit_shift"], a["digit_bits"])
    del parent, k
    live &= b < rmax
    t = torch.arange(nt, device=b.device)[:, None].expand_as(b)
    return t[live], idx[live], b[live]


def _library_room(a, per_elem):
    """Whether a level launch gets a library time: at most
    ``LIBRARY_MAX`` live elements, and ``per_elem`` bytes for each of
    them free on the card (with 4 GiB to spare) beside the sort and its
    check."""
    live = _live(a["meta"], a["ntiles"], a["pitch"])
    free = (torch.cuda.mem_get_info()[0] + torch.cuda.memory_reserved()
            - torch.cuda.memory_allocated())
    return live <= LIBRARY_MAX and live * per_elem + (4 << 30) <= free


def library_hist(m, a, out, _):
    """``torch.bincount`` of tile * rmax + bin over the live elements
    (the bins built first, not timed: ``_level_bins``), required equal to
    the kernel's counts; None where ``_library_room`` says no."""
    nt, rmax = a["ntiles"], a["rmax"]
    if not _library_room(a, 48):
        return None
    t, _, b = _level_bins(m, a, a["src"])
    key = t * rmax + b
    del t, b
    lib, ms = _plain(torch.bincount, key, None, nt * rmax)
    assert torch.equal(lib.view(nt, rmax).to(torch.int32), out), \
        "hist bincount differs"
    return ms


def library_route(m, a, out, _):
    """``torch.sort(tile * rmax + bin, stable=True)`` over the live
    elements whose run is stored (the keys built first, not timed:
    ``_level_bins``): the order of a stable partition by run.  The planes
    gathered by its indices (not timed) must equal the runs' real
    prefixes, bit for bit in the stable digit mode, and in range and
    accumulate modes once both are sorted by run and tuple, as
    ``canonical_runs`` compares.  No one call also pads and places the
    runs.  None where ``_library_room`` says no."""
    nt, rmax = a["ntiles"], a["rmax"]
    if not _library_room(a, 64 + 16 * len(a["srcs"])):
        return None
    digit = a["digit_shift"] is not None
    t, flat, b = _level_bins(m, a, a["srcs"][a["digit_plane"] if digit
                                             else 0])
    key = t * rmax + b
    del t, b
    dst = a["dst"].reshape(-1).long()
    stored = dst[key] >= 0
    key, flat = key[stored].to(torch.int32), flat[stored]
    lib, ms = _plain(lambda k: torch.sort(k, stable=True), key)
    del key
    src = flat[lib.indices]
    del lib, flat
    sel = dst >= 0
    cnt = a["cnt"].reshape(-1).long()[sel]
    pos = m.kv4._spans(dst[sel] * LANES, cnt)
    xor = BIAS if a["bias_input"] else 0
    want = [p.reshape(-1)[src] ^ xor for p in a["srcs"]]
    del src
    got = [o.reshape(-1)[pos] for o in out]
    del pos
    if not digit:
        run = torch.repeat_interleave(
            torch.arange(cnt.numel(), device=cnt.device), cnt)

        def canonical(x):
            perm = m.kv4._lex_order([run] + x)
            return [v[perm] for v in x]
        want, got = canonical(want), canonical(got)
        del run
    for w, g in zip(want, got):
        assert torch.equal(w, g), "route stable sort differs"
    return ms


def _bucket_rows(m, planes, rows, lens, width):
    """The buckets of ``planes`` (flat, 1 or 2) from element ``rows`` on,
    ``lens`` each, gathered into rows of ``width`` elements with SENT
    after each bucket (outside any timed call): the keys for one plane;
    for two, int64 words (key << 32) | (val + 2^31), whose signed order
    is the (key, val) order."""
    e = torch.arange(width, device=rows.device)
    n = planes[0].numel()
    idx = torch.where(e[None, :] < lens[:, None], rows[:, None] + e[None, :],
                      n)
    ext = [torch.cat([p.reshape(-1), p.new_full((1,), m.kv4.SENT)])
           for p in planes]
    if len(planes) == 1:
        return ext[0][idx]
    mat = ext[0][idx].long() << 32
    mat |= ext[1][idx].long() - BIAS
    return mat


def _sorted_planes(vals, nplanes, unbias):
    """The planes of ``_bucket_rows``' sorted rows, unbiased if asked."""
    if nplanes == 1:
        outs = [vals]
    else:
        outs = [(vals >> 32).to(torch.int32),
                ((vals & 0xFFFFFFFF) + BIAS).to(torch.int32)]
    if unbias:
        for o in outs:
            o ^= BIAS
    return outs


def library_terminal(m, a, out, before):
    """Launches of 1 or 2 planes: ``torch.sort(x, dim=1)`` of the launch's
    mode-0 buckets gathered (not timed) into rows of cap_rows*128
    elements, SENT after each bucket's min(occ, cap_rows)*128, as row 8's
    yardstick (two planes packed into order-preserving int64 words,
    ``_bucket_rows``); each row's first ``written`` tuples (unpacked and
    unbiased as the call asks, outside the timed call) must equal the
    kernel's output at the bucket's offset.  3-4 planes: None (no one
    call sorts those tuples)."""
    if len(a["srcs"]) > 2:
        return None
    bt, sel = m.kv4._selected(a["btbl"], a["class_id"])
    src = a["srcs"][0].reshape(-1)
    lens = (bt[:, 1].clamp(0, a["cap_rows"]) * LANES).clamp(
        max=src.numel() - bt[:, 0] * LANES).clamp(min=0)
    live = sel & (bt[:, 3] == 0) & (lens > 0)
    if not bool(live.any()):
        return None
    width = a["cap_rows"] * LANES
    mat = _bucket_rows(m, a["srcs"], bt[live, 0] * LANES, lens[live], width)
    lib, ms = _plain(torch.sort, mat, 1)
    del mat
    vals = _sorted_planes(lib.values, len(a["srcs"]), a["unbias_output"])
    del lib
    w = torch.minimum(bt[live, 2], lens[live])
    flat = torch.arange(w.numel(), device=w.device).repeat_interleave(w) \
        * width + m.kv4._spans(torch.zeros_like(w), w)
    pos = m.kv4._spans(bt[live, 5], w)
    for v, o in zip(vals, out):
        assert torch.equal(v.view(-1)[flat], o.view(-1)[pos]), \
            "terminal torch.sort differs"
    return ms


def _pair_planes(p):
    """The non-None planes of a (keys, vals) pair."""
    return tuple(t for t in p[:2] if t is not None)


def check_tile_sort(m, a, out, before):
    """Tile chunk by tile chunk, the plain version sorts a copy of the
    pre-launch tiles; sorted tiles and counts must be equal."""
    tr = a["tile_rows"]
    nt = a["keys"].shape[0] // tr
    per = max(1, CHECK_CHUNK // (tr * LANES))
    err = ms = 0
    for t0 in range(0, nt, per):
        t1 = min(nt, t0 + per)
        rows = slice(t0 * tr, t1 * tr)
        k = before["keys"][rows].clone()
        v = None if before["vals"] is None else before["vals"][rows].clone()
        want, t = _plain(m.pk.tile_sort_ref, k, v, a["bounds"][t0:t1],
                         a["data_elems"][t0:t1], tr)
        ms += t
        got = tuple(x[rows] for x in _pair_planes(out)) + (out[2][t0:t1],)
        err = max(err, _err(got, _pair_planes(want) + (want[2],)))
    return err, ms


def check_distribute(m, a, out, _):
    """Tile chunk by tile chunk, the plain version stores the chunk's runs
    into a fresh arena; the stored rows must be equal."""
    tr = a["tile_rows"]
    nt, r = a["slot_rows"].shape
    per = max(1, CHECK_CHUNK // (tr * LANES))
    err = ms = 0
    for t0 in range(0, nt, per):
        t1 = min(nt, t0 + per)
        rows = slice(t0 * tr, t1 * tr)
        sub = {k: a[k][t0:t1].contiguous()
               for k in ("slot_rows", "run_starts", "run_lens")}
        want, t = _plain(
            m.pk.distribute_ref, a["keys"][rows],
            None if a["vals"] is None else a["vals"][rows], sub["slot_rows"],
            sub["run_starts"], sub["run_lens"], a["out_rows"], tr)
        ms += t
        pos = _distribute_positions(m, sub)
        err = max(err, _err(tuple(x.view(-1)[pos] for x in _pair_planes(out)),
                            tuple(x.view(-1)[pos]
                                  for x in _pair_planes(want))))
        del want
    return err, ms


def _distribute_positions(m, a):
    """Flat output positions of every stored run's rows, run by run."""
    ln = a["run_lens"].reshape(-1).long()
    live = ln > 0
    return m.kv4._spans(a["slot_rows"].reshape(-1).long()[live] * LANES,
                        (ln[live] + LANES - 1) // LANES * LANES)


def check_ragged(m, a, out, before):
    """Bucket group by bucket group, the plain version sorts the live
    buckets of the pre-launch copy in place (dummies are skipped, by both
    versions); the whole arenas must then be equal."""
    pads = a["pad_elems"].long()
    gid, ngroups = _groups(torch.where(pads > 0, a["class_rows"] * LANES,
                                       0))
    k, v = before["keys"], before["vals"]
    ms = 0
    for g in range(ngroups):
        sel = torch.where(gid == g, pads, 0).to(torch.int32)
        _, t = _plain(m.pk.ragged_sort_ref, k, v, a["starts_row"], sel,
                      a["class_rows"])
        ms += t
    return _err(_pair_planes(out), _pair_planes((k, v))), ms


def check_compact(m, a, out, _):
    """Segment group by segment group, the plain version joins the
    group's segments; they must equal the kernel's output at the group's
    offset."""
    ln = a["lens"].long()
    gid, ngroups = _groups(ln)
    first = torch.searchsorted(gid, torch.arange(ngroups + 1,
                                                 device=gid.device)).tolist()
    off = (torch.cumsum(ln, 0) - ln).tolist() + [int(ln.sum().item())]
    err = ms = 0
    for g in range(ngroups):
        s0, s1 = first[g], first[g + 1]
        n = off[s1] - off[s0]
        want, t = _plain(m.pk.compact_ref, a["keys"], a["vals"],
                         a["starts_row"][s0:s1], a["lens"][s0:s1],
                         -(-n // LANES))
        ms += t
        err = max(err, _err(
            tuple(x.view(-1)[off[s0]:off[s1]] for x in _pair_planes(out)),
            tuple(x.view(-1)[:n] for x in _pair_planes(want))))
    return err, ms


def check_partition(m, a, out, _):
    """The plain version replays the call tile group by tile group into
    one fresh arena per plane, its cursors (rows claimed per child)
    carried from group to group; counts, pads and the flag must be
    equal, and the arenas child group by child group through
    ``canonical_children`` (every child but an overflowing one, whose
    kept tuples are not defined)."""
    tiles = a["tile_tbl"]
    nt = tiles.shape[0]
    per = max(1, CHECK_CHUNK // (a["pitch"] * LANES))
    planes = tuple(p for p in out[:2] if p is not None)
    want = tuple(torch.empty_like(p) for p in planes)
    nchild = a["dst_start"].numel()
    claimed = torch.zeros(nchild, dtype=torch.long, device=tiles.device)
    real = torch.zeros_like(out[3])
    pads = torch.zeros_like(out[4])
    over = torch.zeros_like(out[5])
    occ = torch.zeros_like(out[2])
    keys = ("src", "vsrc", "tile_tbl", "child_base", "bounds", "dst_start",
            "dst_cap", "dst_rows", "pitch", "rmax", "parent_fill",
            "sink_base", "sink_cnt", "padsrc", "nsinks", "pad_stride",
            "bias_input")
    ms = 0
    for t0 in range(0, nt, per):
        args = [a[k] for k in keys]
        args[2] = tiles[t0:t0 + per]
        r, t = _plain(lambda: m.kv3.partition_level_ref(
            *args, out=want, t0=t0, claimed=claimed))
        ms += t
        occ, real, pads, over = r[2], real + r[3], pads + r[4], over | r[5]
    err = _err(out[2:], (occ, real, pads, over))
    # which tuples an overflowing child keeps is not defined
    fits = claimed <= a["dst_cap"]
    gid, ngroups = _groups(torch.where(fits, out[2].long() * LANES, 0))
    for k in range(ngroups):
        sel = (gid == k) & fits
        st, oc = a["dst_start"][sel], out[2][sel]
        err = max(err, _err(m.kv3.canonical_children(planes, st, oc),
                            m.kv3.canonical_children(want, st, oc)))
    return err, ms


def _v3_written(a):
    """(btbl as int64, elements each bucket writes): mode 0 at most
    min(occ, cap_rows) rows, mode 1 its real count."""
    bt = a["btbl"].long()
    occ, real, mode = bt[:, 1], bt[:, 2].clamp(min=0), bt[:, 3]
    return bt, torch.where(mode == 0, torch.minimum(
        real, occ.clamp(0, a["cap_rows"]) * LANES), real)


def check_terminal_v3(m, a, out, _):
    """Bucket group by bucket group, the plain version writes into one
    fresh output per plane; the elements each group's buckets write must
    be equal."""
    bt, eff = _v3_written(a)
    gid, ngroups = _groups(torch.where(
        bt[:, 3] == 0, bt[:, 1].clamp(0, a["cap_rows"]) * LANES, eff))
    planes = tuple(p for p in out if p is not None)
    want = tuple(torch.empty_like(p) for p in planes)
    err = ms = 0
    for k in range(ngroups):
        ink = gid == k
        btk = a["btbl"].clone()
        btk[:, 2] = torch.where(ink, btk[:, 2], 0)
        _, t = _plain(lambda: m.kv3.terminal_sort_write_ref(
            a["src"], a["vsrc"], btk, a["fillval"], a["out_off"],
            a["out_rows"], a["cap_rows"], a["unbias_output"], outs=want))
        ms += t
        pos = m.kv4._spans(a["out_off"].long()[ink], eff[ink])
        err = max(err, _err(tuple(p.view(-1)[pos] for p in planes),
                            tuple(w.view(-1)[pos] for w in want)))
    return err, ms


def library_terminal_v3(m, a, out, _):
    """``torch.sort(x, dim=1)`` of the mode-0 buckets gathered (not timed)
    into rows of cap_rows*128 elements, SENT after each bucket's
    min(occ, cap_rows)*128 (pairs packed into order-preserving int64
    words, ``_bucket_rows``); each row's first ``written`` tuples
    (unpacked and unbiased as the call asks, outside the timed call)
    must equal the kernel's output at the bucket's offset."""
    bt, eff = _v3_written(a)
    live = (bt[:, 3] == 0) & (eff > 0)
    width = a["cap_rows"] * LANES
    planes = _pair_planes((a["src"], a["vsrc"]))
    mat = _bucket_rows(m, planes, bt[live, 0] * LANES,
                       bt[live, 1].clamp(0, a["cap_rows"]) * LANES, width)
    lib, t = _plain(torch.sort, mat, 1)
    del mat
    vals = _sorted_planes(lib.values, len(planes), a["unbias_output"])
    del lib
    w = eff[live]
    nb = w.numel()
    flat = torch.arange(nb, device=w.device).repeat_interleave(w) * width \
        + m.kv4._spans(torch.zeros_like(w), w)
    pos = m.kv4._spans(a["out_off"].long()[live], w)
    for v, o in zip(vals, _pair_planes(out)):
        assert torch.equal(v.view(-1)[flat], o.view(-1)[pos]), \
            "terminal torch.sort differs"
    return t


def library_tile_sort(m, a, out, before):
    """``torch.sort(x, dim=1)`` by row of the pre-launch tiles, their
    slack masked to SENT first (not timed): the keys for keys-only
    launches; for pairs, int64 words (key << 32) | (val + 2^31), whose
    signed order is the (key, val) order (as ``_bucket_rows`` packs
    them).  Its values (unpacked outside the timed call) must equal the
    kernel's tiles."""
    te = a["tile_rows"] * LANES
    k = before["keys"].view(-1, te)
    live = torch.arange(te, device=k.device)[None, :] \
        < a["data_elems"].long()[:, None]
    mat = torch.where(live, k, m.kv4.SENT)
    if a["vals"] is not None:
        v = torch.where(live, before["vals"].view(-1, te), m.kv4.SENT)
        mat = (mat.long() << 32) | (v.long() - BIAS)
        del v
    del live
    lib, t = _plain(torch.sort, mat, 1)
    del mat
    planes = 1 if a["vals"] is None else 2
    for v, o in zip(_sorted_planes(lib.values, planes, False),
                    _pair_planes(out)):
        assert torch.equal(v, o.view(-1, te)), "tile torch.sort differs"
    return t


def library_distribute(m, a, out, _):
    """``index_select`` of the flattened source (with one SENT appended,
    for the lanes after each run) by the index of every stored row's
    elements (built first, not timed); it must equal the kernel's stored
    rows."""
    te = a["tile_rows"] * LANES
    nt, r = a["slot_rows"].shape
    ln = a["run_lens"].reshape(-1).long()
    live = ln > 0
    ln = ln[live]
    padded = (ln + LANES - 1) // LANES * LANES
    src0 = (torch.arange(nt, device=ln.device).repeat_interleave(r) * te
            + a["run_starts"].reshape(-1).long())[live]
    e = m.kv4._spans(torch.zeros_like(src0), padded)
    sent = a["keys"].numel()
    idx = torch.where(e < torch.repeat_interleave(ln, padded),
                      torch.repeat_interleave(src0, padded) + e, sent)
    pos = _distribute_positions(m, a)
    ms = 0
    for o, x in zip(_pair_planes(out), _pair_planes((a["keys"],
                                                     a["vals"]))):
        ext = torch.cat([x.view(-1), x.new_full((1,), m.kv4.SENT)])
        lib, t = _plain(torch.index_select, ext, 0, idx)
        ms += t
        assert torch.equal(lib, o.view(-1)[pos]), "distribute differs"
        del ext, lib
    return ms


def library_ragged(m, a, out, before):
    """Keys-only launches: ``torch.sort(x, dim=1)`` of the live buckets
    gathered (not timed) from the pre-launch arena into rows of
    class_rows*128 elements, each tail past its pad masked to SENT, as
    ``library_terminal`` does; its values must equal the kernel's
    buckets.  Pairs: None (no one call sorts by (key, val))."""
    if a["vals"] is not None:
        return None
    pads = a["pad_elems"].long()
    live = pads > 0
    if not bool(live.any()):
        return None
    cr = a["class_rows"]
    rows = a["starts_row"].long()[live][:, None] \
        + torch.arange(cr, device=pads.device)[None, :]
    e = torch.arange(cr * LANES, device=pads.device)[None, :]
    mat = before["keys"][rows].view(-1, cr * LANES)
    mat = torch.where(e < pads[live][:, None], mat, m.kv4.SENT)
    lib, t = _plain(torch.sort, mat, 1)
    del mat
    assert torch.equal(lib.values,
                       out[0][rows].view(-1, cr * LANES)), \
        "bucket torch.sort differs"
    return t


def library_compact(m, a, out, _):
    """``index_select`` of the flattened source by the index of every
    segment's elements (built first, not timed); it must equal the
    kernel's first n elements."""
    ln = a["lens"].long()
    idx = m.kv4._spans(a["starts_row"].long() * LANES, ln)
    ms = 0
    for o, x in zip(_pair_planes(out), _pair_planes((a["keys"],
                                                     a["vals"]))):
        lib, t = _plain(torch.index_select, x.view(-1), 0, idx)
        ms += t
        assert torch.equal(lib, o.view(-1)[:idx.numel()]), "compact differs"
        del lib
    return ms


CHECKS = {"hist_level": check_hist, "route_level": check_route,
          "hist_level.digit": check_hist, "route_level.digit": check_route,
          "route_level.accumulate": check_route,
          "terminal_write": check_terminal, "splice_runs": check_splice,
          "seqroute_level": check_seqroute, "block_permute": check_permute,
          "partition_level": check_partition,
          "terminal_sort_write": check_terminal_v3,
          "tile_sort": check_tile_sort, "distribute": check_distribute,
          "ragged_sort": check_ragged, "compact": check_compact}
# kernels with a one-call PyTorch equivalent (on some or all launches:
# None where a launch has none)
LIBRARY = {"hist_level": library_hist, "hist_level.digit": library_hist,
           "route_level": library_route, "route_level.digit": library_route,
           "route_level.accumulate": library_route,
           "terminal_write": library_terminal,
           "splice_runs": library_splice, "block_permute": library_permute,
           "terminal_sort_write": library_terminal_v3,
           "tile_sort": library_tile_sort, "distribute": library_distribute,
           "ragged_sort": library_ragged, "compact": library_compact}


def _live(meta, ntiles, pitch):
    m = meta[: 3 * ntiles].view(ntiles, 3).long()
    return int(m[:, 2].clamp(0, pitch * LANES).sum().item())


def call_bytes(name, a):
    """Bytes one call (arguments ``a`` by name) must move: each input
    element it reads once, each output element it writes once, and its
    tables."""
    if name.startswith(("hist_level", "route_level")):
        bounds = a["bounds"].numel() if a["digit_shift"] is None else 0
    if name.startswith("hist_level"):
        return 4 * (_live(a["meta"], a["ntiles"], a["pitch"])
                    + a["ntiles"] * a["rmax"] + 3 * a["ntiles"] + bounds)
    if name.startswith("route_level"):
        cnt, ntiles = a["cnt"].long(), a["ntiles"]
        stored = cnt + (-cnt) % LANES
        wrote = int(stored[a["dst"] >= 0].sum().item())
        return 4 * (len(a["srcs"]) * (_live(a["meta"], ntiles, a["pitch"])
                                      + wrote)
                    + 3 * ntiles * a["rmax"] + 3 * ntiles + bounds)
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


def call_bytes_v5(name, a):
    """``call_bytes`` of the in-place v5 kernels: seqroute reads every
    live element and writes every range's blocks (its elements and the
    pads of its open block), block_permute reads and writes every block
    it moves, every plane."""
    if name == "seqroute_level":
        nt, rmax = a["ntiles"], a["rmax"]
        m = a["meta"][: 4 * nt].view(nt, 4).long()
        live = int(m[:, 1].clamp(0, a["pitch"] * LANES).sum().item())
        total = a["base_tbl"].reshape(nt, rmax)[-1].long()
        wrote = int(((total // BLK + 1) * BLK).sum().item())
        return 4 * (len(a["w"]) * (live + wrote) + 4 * nt * rmax + 4 * nt)
    moved = a["cyc_slots"].numel()
    return 4 * (2 * len(a["w"]) * moved * BLK + a["cyc_off"].numel()
                + moved)


def call_bytes_v1(name, a, out):
    """``call_bytes`` of the v1 kernels, every plane: tile_sort reads each
    tile's data elements (the slack past them is taken as SENT, not read)
    and writes every tile; distribute reads each run and writes its rows;
    ragged_sort reads each live bucket's pad and writes the bucket;
    compact reads and writes each segment; and their tables."""
    planes = 1 if a["vals"] is None else 2
    if name == "tile_sort":
        nt, r = a["bounds"].shape
        read = int(a["data_elems"].long().clamp(
            0, a["tile_rows"] * LANES).sum().item())
        return 4 * (planes * (read + a["keys"].numel()) + 2 * nt * r + nt)
    if name == "distribute":
        ln = a["run_lens"].long()
        wrote = int(((ln + LANES - 1) // LANES * LANES).sum().item())
        return 4 * (planes * (int(ln.sum().item()) + wrote) + 3 * ln.numel())
    if name == "ragged_sort":
        pads = a["pad_elems"].long()
        live = pads > 0
        read = int(pads.clamp(max=a["class_rows"] * LANES).sum().item())
        wrote = int(live.sum().item()) * a["class_rows"] * LANES
        return 4 * (planes * (read + wrote) + 2 * pads.numel())
    ln = a["lens"].long()
    return 4 * (2 * planes * int(ln.sum().item()) + 2 * ln.numel())


def call_bytes_v3(name, a, out):
    """``call_bytes`` of the v3 kernels, every plane: partition_level reads
    every live element of its tiles and writes the rows each child
    stores (occ); terminal_sort_write reads min(occ, cap_rows) rows of
    each mode-0 bucket and writes what each bucket writes (the fill
    buckets the key plane only); and their tables."""
    planes = 1 if a["vsrc"] is None else 2
    if name == "partition_level":
        tt = a["tile_tbl"].long()
        nel = (a["parent_fill"].long()[tt[:, 0]] - tt[:, 2]).clamp(
            0, a["pitch"] * LANES)
        nel = torch.minimum(nel, (a["src"].numel() - tt[:, 1] * LANES)
                            .clamp(min=0))
        live = int(nel.sum().item())
        stored = int(out[2].long().sum().item()) * LANES
        tables = sum(a[k].numel() for k in (
            "tile_tbl", "child_base", "bounds", "dst_start", "dst_cap",
            "parent_fill", "sink_base", "sink_cnt")) + 3 * out[2].numel()
        return 4 * (planes * (live + stored) + tables + out[4].numel())
    bt, eff = _v3_written(a)
    mode0 = (bt[:, 3] == 0) & (bt[:, 2] > 0)
    read = int((bt[:, 1].clamp(0, a["cap_rows"]) * LANES)[mode0].sum()
               .item())
    wrote = int(eff[mode0].sum().item())
    fill = int(eff[bt[:, 3] != 0].sum().item())
    return 4 * (planes * (read + wrote) + fill + 6 * bt.shape[0])


def entry(fname, a):
    """The KERNELS entry of one call of wrapper ``fname`` (arguments
    ``a`` by name): the level kernels' modes count apart."""
    if fname in ("hist_level", "route_level") \
            and a["digit_shift"] is not None:
        return fname + ".digit"
    if fname == "route_level" and a["arenas"] is not None:
        return fname + ".accumulate"
    return fname


class Checker:
    """While ``run`` drives a sort, every call of the kernel wrappers
    launches the kernel as the path asked, then replays the call on its
    plain version and requires equality."""

    def __init__(self, mods, wrappers, log):
        self.mods, self.wrappers, self.log = mods, wrappers, log
        self.totals = {name: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                  library_ms=0.0, max_abs_err=0,
                                  library_calls=0, library_kernel_ms=0.0,
                                  launch_ms=0.0)
                       for name in KERNELS}
        self.by_input = {}      # (input, kernel, planes) -> sums
        self.fill_buckets = {}  # input -> v3 value-fill buckets written

    def _module(self, name):
        return getattr(self.mods, KERNELS[name][0])

    def run(self, label, fn):
        self.label = label
        for name in self.wrappers:
            setattr(self._module(name), name, self._checked(name))
        try:
            return fn()
        finally:
            for name, f in self.wrappers.items():
                setattr(self._module(name), name, f)
            for (lbl, name, planes), r in self.by_input.items():
                if lbl == label:
                    print(f"check [{label}] {name} planes={planes}: "
                          f"{r['calls']} calls, max_abs_err {r['err']}, "
                          f"kernel {r['ms']:.3f} ms"
                          + (f" (launch {r['launch']:.3f} ms)"
                             if name in LAUNCH_TIMED else "")
                          + f", plain {r['pms']:.3f} "
                          f"ms, bound {r['bound']:.4f} ms"
                          + (f", library {r['lib']:.3f} ms"
                             if name in LIBRARY else ""))

    def _checked(self, fname):
        kern = self.wrappers[fname]
        inplace_v1 = fname in ("tile_sort", "ragged_sort")

        def call(*args, **kw):
            a = named(kern, args, kw)
            name = entry(fname, a)
            inplace = {"terminal_write": "outs", "seqroute_level": "w",
                       "block_permute": "w",
                       "route_level.accumulate": "arenas"}.get(name)
            if KERNELS[name][0] == "pk":
                # msd_sort and sort_vmem pass their tables on the host
                a = {k: v.to(a["keys"].device) if torch.is_tensor(v) else v
                     for k, v in a.items()}
            before = _clone(tuple(a[inplace])) if inplace else None
            if inplace_v1:
                before = {k: _clone(a[k]) for k in ("keys", "vals")}
            kmod = self._module(name)
            launch_ev, inner = [], kmod._launch
            if name in LAUNCH_TIMED:
                def timed_launch(*la):
                    e = [torch.cuda.Event(enable_timing=True)
                         for _ in range(2)]
                    e[0].record()
                    inner(*la)
                    e[1].record()
                    launch_ev.append(e)
                kmod._launch = timed_launch
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            try:
                out = kern(*args, **kw)
            finally:
                kmod._launch = inner
            ev[1].record()
            torch.cuda.synchronize()
            ms = ev[0].elapsed_time(ev[1])
            launch_ms = (sum(e[0].elapsed_time(e[1]) for e in launch_ev)
                         if name in LAUNCH_TIMED else None)
            lms = (LIBRARY[name](self.mods, a, out, before)
                   if name in LIBRARY else None)
            err, pms = CHECKS[name](self.mods, a, out, before)
            del before
            mod = KERNELS[name][0]
            bound = (call_bytes_v5(name, a) if mod == "kv5"
                     else call_bytes_v1(name, a, out) if mod == "pk"
                     else call_bytes_v3(name, a, out) if mod == "kv3"
                     else call_bytes(name, a)) / HBM_BYTES_PER_S * 1e3
            if mod == "pk":
                planes = 1 if a["vals"] is None else 2
            elif mod == "kv3":
                planes = 1 if a["vsrc"] is None else 2
            else:
                planes = 1 if name.startswith("hist_level") else len(
                    a["w"] if "w" in a else a["srcs"])
            extra = {k: a[k] for k in ("ntiles", "rmax", "cap_rows",
                                       "class_id", "nlex", "tile_rows",
                                       "out_rows", "class_rows",
                                       "digit_shift", "digit_plane")
                     if a.get(k) is not None}
            if mod == "pk":
                extra["rows"] = a["keys"].shape[0]
                if name in ("ragged_sort", "compact"):
                    extra["buckets"] = a["starts_row"].numel()
            if name == "partition_level":
                extra["ntiles"] = a["tile_tbl"].shape[0]
                extra["children"] = a["dst_start"].numel()
                extra["over"] = int(out[5][0].item())
            if name in ("terminal_write", "terminal_sort_write") \
                    and hasattr(self.mods.kv4, "terminal_path"):
                # the path and CTAs a bucket the class's size picks
                path, ctas = self.mods.kv4.terminal_path(planes,
                                                         a["cap_rows"])
                extra["path"] = f"{path}/{ctas}"
                if path == "cluster":
                    extra["resident"] = self.mods.kv4.terminal_resident(
                        planes, a["cap_rows"])
            if name == "terminal_sort_write":
                bt = a["btbl"]
                extra["buckets"] = int((bt[:, 2] > 0).sum().item())
                extra["fill_buckets"] = int(((bt[:, 3] != 0)
                                             & (bt[:, 2] > 0)).sum().item())
                if hasattr(self.mods.kv4, "terminal_geometry"):
                    # sorted buckets on half the class's network or less
                    lr = self.mods.kv4.terminal_geometry(
                        planes, a["cap_rows"])[0]
                    m = bt[:, 1].long().clamp(max=a["cap_rows"]) * 128
                    extra["half_net"] = int(((bt[:, 3] == 0) & (bt[:, 2] > 0)
                                             & (m <= 1 << (lr - 1)))
                                            .sum().item())
                self.fill_buckets[self.label] = \
                    self.fill_buckets.get(self.label, 0) \
                    + extra["fill_buckets"]
            if name == "block_permute":
                off = a["cyc_off"].long()
                extra = dict(cycles=off.numel() - 1,
                             moved=a["cyc_slots"].numel(),
                             longest=int((off[1:] - off[:-1]).max().item())
                             if off.numel() > 1 else 0)
            print(f"[{self.label}] {name} planes={planes} {extra}: "
                  f"max_abs_err {err} kernel {ms:.4f} ms plain {pms:.4f} "
                  f"ms bound {bound:.5f} ms library {lms} ms"
                  + (f" launch {launch_ms:.4f} ms" if launch_ms is not None
                     else ""),
                  file=self.log)
            t = self.totals[name]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            t["ms"] += ms
            t["plain_ms"] += pms
            t["bound_ms"] += bound
            t["library_ms"] += lms or 0.0
            t["launch_ms"] += launch_ms or 0.0
            if lms is not None:
                t["library_calls"] += 1
                t["library_kernel_ms"] += ms
            r = self.by_input.setdefault(
                (self.label, name, planes),
                dict(calls=0, err=0, ms=0.0, pms=0.0, bound=0.0, lib=0.0,
                     launch=0.0))
            r["calls"] += 1
            r["err"] = max(r["err"], err)
            r["ms"] += ms
            r["pms"] += pms
            r["bound"] += bound
            r["lib"] += lms or 0.0
            r["launch"] += launch_ms or 0.0
            if name == "block_permute":
                print(f"check [{self.label}] block_permute {extra}: "
                      f"kernel {ms:.3f} ms (launch {launch_ms:.3f} ms), "
                      f"index_select {lms:.3f} ms")
            assert err == 0, (f"{name} ({planes} planes, {extra}) on "
                              f"{self.label} disagrees with its plain "
                              f"version")
            return out
        return call


PATHS = ("keys", "payload", "deep", "v5", "v1", "v3", "lsb", "chunked")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    # ``--paths lsb,chunked`` runs only those main paths (a check of a
    # change to them); with no arguments every path runs
    paths = PATHS
    if sys.argv[1:2] == ["--paths"] and len(sys.argv) == 3:
        paths = tuple(sys.argv[2].split(","))
    elif sys.argv[1:]:
        raise SystemExit(f"usage: chip_smoke.py [--paths "
                         f"{','.join(PATHS)}]")
    assert set(paths) <= set(PATHS), paths
    from inplacemsdradixsort_tpu_torch import SortConfig, sort
    from inplacemsdradixsort_tpu_torch.api import check_fits, held_bytes
    from inplacemsdradixsort_tpu_torch.ops import _build, engine_v3, engine_v4
    from inplacemsdradixsort_tpu_torch.ops import (chunked, engine_lsb,
                                                   engine_v5)
    from inplacemsdradixsort_tpu_torch.ops import kernels_v3 as kv3
    from inplacemsdradixsort_tpu_torch.ops import kernels_v4 as kv4
    from inplacemsdradixsort_tpu_torch.ops import kernels_v5 as kv5
    from inplacemsdradixsort_tpu_torch.ops import pallas_engine
    from inplacemsdradixsort_tpu_torch.ops import pallas_kernels as pk
    from inplacemsdradixsort_tpu_torch.utils.checking import (
        checksum, raw_check_2d)
    from inplacemsdradixsort_tpu_torch.utils.timing import PhaseTimer

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
    print(f"build: {_build.build(verbose=True).name}")   # nvcc per source
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    cfg = SortConfig()
    v5cfg = dataclasses.replace(cfg, engine="v5")
    v1cfg = dataclasses.replace(cfg, engine="pallas")
    v3cfg = dataclasses.replace(cfg, engine="v3")
    lsbcfg = dataclasses.replace(cfg, engine="lsb")
    mods = types.SimpleNamespace(kv4=kv4, kv5=kv5, pk=pk, kv3=kv3)
    wrappers = {fn: getattr(getattr(mods, KERNELS[fn][0]), fn)
                for fn in WRAPPERS}
    os.makedirs(os.path.dirname(CALL_LOG), exist_ok=True)
    log = open(CALL_LOG, "w")
    checker = Checker(mods, wrappers, log)

    # ---------------------------------------------------------- warm-up
    for logn, kk, rk in WARMUP:
        keys, rids = make_input(1 << logn, kk, rk, SEED - logn, dev)
        sort(keys, rids, config=cfg)
        del keys, rids
    for logn, kk, rk in WARMUP_V5:
        keys, rids = make_input(1 << logn, kk, rk, SEED - 7 - logn, dev)
        sort(keys, rids, config=v5cfg)
        del keys, rids
    for kk, rk in [("u32", None), ("u32", "arange"), ("few_hi", None)]:
        keys, rids = make_input(1 << 20, kk, rk, SEED - 11, dev)
        sort(keys, rids, config=v1cfg)
        del keys, rids
    pallas_engine.sort_vmem(make_keys(1 << 12, 0.0, SEED - 12, dev))
    for kk, rk in [("u32", None), ("u32", "arange"), ("u64", None)]:
        keys, rids = make_input(1 << 20, kk, rk, SEED - 13, dev)
        sort(keys, rids, config=v3cfg)
        del keys, rids
    for kk, rk in [("u32", None), ("u32", "perm"), ("u64", None)]:
        keys, rids = make_input(1 << 20, kk, rk, SEED - 14, dev)
        sort(keys, rids, config=lsbcfg)
        del keys, rids
    for pairs in (False, True):
        for _ in chunked.sort_external(
                lambda i: tuple(make_keys(1 << 21, 0.0, SEED - 15 - 2 * i
                                          - j, dev)
                                for j in range(1 + pairs)), 2, 1 << 22, cfg):
            pass
    torch.cuda.synchronize()

    # ------------------------------------------------------ main paths
    launches = dict.fromkeys(KERNELS, 0)
    kernel_ms = {}

    def set_wrappers(make):
        for fn in WRAPPERS:
            setattr(getattr(mods, KERNELS[fn][0]), fn, make(fn))

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
        set_wrappers(timed)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            set_wrappers(wrappers.get)
        for name, evs in kernel_ms.items():
            each = [a.elapsed_time(b) for a, b in evs]
            print(f"main {label} {name}: {len(each)} calls, "
                  f"{sum(each):.3f} ms "
                  f"({', '.join(f'{e:.3f}' for e in each)})")
        print(f"main {label} one sort: {total * 1e3:.3f} ms")

    def table_checks(label, fn):
        """Host ms of the check of the largest ``distribute`` call's tables
        in one run of ``fn``: the wrapper's host check (the engine's
        path) alone and with the upload of its packed tables, the check
        of the same tables on the card (one sync) alone and with their
        upload, and an int64 check on the host (int64 copies of the whole
        tables); median of 5 each; then the kernel alone on those tables
        (CUDA events)."""
        calls = []

        def rec(*args, **kw):
            calls.append(named(wrappers["distribute"], args, kw))
            return wrappers["distribute"](*args, **kw)
        pk.distribute = rec
        try:
            fn()
        finally:
            pk.distribute = wrappers["distribute"]
        a = max(calls, key=lambda c: c["slot_rows"].numel())
        te, out = a["tile_rows"] * LANES, a["out_rows"]
        host = tuple(a[k] for k in ("slot_rows", "run_starts", "run_lens"))
        card = tuple(t.to(dev) for t in host)

        def int64_check(sl, st, ln):
            ln = pk._i64(ln)
            pk._refuse("distribute", ("run", pk._outside(pk._i64(st), ln, te)),
                       ("slot", pk._outside(pk._i64(sl) * LANES,
                                            (ln + LANES - 1) // LANES * LANES,
                                            out * LANES)))
        ms = {}
        def host_path(upload):
            p = pk._runs_on_host(*host, te, out)
            if upload:
                p.to(dev, non_blocking=True)
        for name, f in (("host", lambda: host_path(False)),
                        ("host_up", lambda: host_path(True)),
                        ("card", lambda: int64_check(*card)),
                        ("card_up", lambda: int64_check(
                            *(t.to(dev) for t in host))),
                        ("host_int64", lambda: int64_check(*host))):
            each = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                f()
                torch.cuda.synchronize()
                each.append((time.perf_counter() - t0) * 1e3)
            ms[name] = statistics.median(each)
        # the kernel alone on the uploaded used columns, CUDA events
        tabs = tuple(pk._runs_on_host(*host, te, out).to(dev))
        outs = [torch.empty((out, LANES), dtype=torch.int32, device=dev)
                for p in (a["keys"], a["vals"]) if p is not None]
        ru = tabs[0].shape[1]
        each = []
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            kv4._call("distribute", "kv1_distribute", dev, pk._p(a["keys"]),
                      pk._vp(a["vals"]), a["keys"].numel(), *map(pk._p, tabs),
                      pk._p(outs[0]), pk._vp(outs[1] if len(outs) > 1
                                             else None), outs[0].numel(),
                      tabs[0].numel(), ru, te, len(outs))
            ev[1].record()
            torch.cuda.synchronize()
            each.append(ev[0].elapsed_time(ev[1]))
        print(f"main {label} distribute kernel alone on the largest "
              f"call: {statistics.median(each):.3f} ms (CUDA events)")
        print(f"main {label} distribute table check "
              f"{tuple(host[0].shape)}, {len(calls)} calls: host "
              f"{ms['host']:.3f} ms ({ms['host_up']:.3f} with the upload "
              f"of its used columns), on the card (one sync) "
              f"{ms['card']:.3f} ms ({ms['card_up']:.3f} with the upload "
              f"of the tables), host int64 {ms['host_int64']:.3f} ms")

    def counts():
        return {**kv4.LAUNCHES, **kv5.LAUNCHES, **pk.LAUNCHES,
                **kv3.LAUNCHES}

    def path(label, names):
        """Open a main path: counts to 0; returns the closing check."""
        kv4.reset_launches()
        kv5.reset_launches()
        pk.reset_launches()
        kv3.reset_launches()
        engine_v4.reset_fallback_stats()

        def close():
            got = counts()
            print(f"main {label} launches: {got}")
            for name in names:
                assert got[name] > 0, f"{name} was not launched on {label}"
            for name in KERNELS:
                launches[name] += got[name]
        return close

    def peak_of(fn):
        """Peak device memory of ``fn()`` above what was allocated
        before it, in GiB."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated(dev) - base) / 2**30

    def run_case(label, keys, rids, timed_runs, expect, config=cfg,
                 engine=None, also=None):
        """Sort on the card with every launch checked, compare with the
        torch reference (computed first and kept on the host), report
        fallbacks, then peak memory and times of unchecked sorts.
        ``engine="v5"`` asserts that the checked sort ran v5's kernels,
        ``"v1"``, ``"v3"`` and ``"lsb"`` those of that engine (LSB pairs
        are held to a reference stable by key);
        ``also`` names another config to time and measure beside it."""
        ref = torch_reference(keys, rids, stable=engine == "lsb")
        ref = tuple(None if t is None else t.cpu() for t in ref)
        torch.cuda.synchronize()
        before = dict(engine_v4.FALLBACK_STATS)
        seq0 = kv5.LAUNCHES["seqroute_level"]
        dig0 = kv4.LAUNCHES["route_level.digit"]
        res = checker.run(label, lambda: sort(keys, rids, config=config))
        ran_v5 = kv5.LAUNCHES["seqroute_level"] > seq0
        stats = {k: engine_v4.FALLBACK_STATS[k] - before[k] for k in before}
        if engine == "v1":
            assert pk.LAUNCHES["tile_sort"] > 0 and not ran_v5, label
        elif engine == "v3":
            assert kv3.LAUNCHES["partition_level"] > 0 and not ran_v5, label
        elif engine == "lsb":
            assert kv4.LAUNCHES["route_level.digit"] > dig0 \
                and not ran_v5, label
        elif engine is not None:
            assert ran_v5 == (engine == "v5"), (label, engine, ran_v5)
        assert_equal(res.keys, ref[0], label)
        if rids is not None:
            assert_equal(res.rids, ref[1], label + " rids")
        else:
            assert checksum(_words(res.keys)) == checksum(_words(keys)), label
        del res, ref
        expect(stats)
        peak = peak_of(lambda: sort(keys, rids, config=config))
        print(f"main {label}: bitwise equal to the torch reference, "
              f"engine {engine or ('v5' if ran_v5 else 'v4')}, fallbacks "
              f"{stats}, port "
              f"peak {peak:.3f} GiB over its inputs")
        fns = {"port": lambda: sort(keys, rids, config=config),
               "torch": lambda: library_sort(keys, rids)}
        if also is not None:
            name, other = also
            fns[name] = lambda: sort(keys, rids, config=other)
            print(f"main {label} {name}: peak "
                  f"{peak_of(fns[name]):.3f} GiB over its inputs")
        if timed_runs:
            t = host_ms(fns, rounds=timed_runs)
            n = keys.shape[0]
            what = "torch.sort" if rids is None else \
                "torch.sort(stable) + rid gather"
            if engine == "lsb":
                res = sort(keys, rids, config=config, timing=True)
                print(f"main {label} phases (host clock, synchronised):")
                print(res.pretty_times())
                del res
            print(f"main {label} port: median {t['port']:.3f} ms "
                  f"({n / t['port'] * 1e3:.4e} keys/s); {what}: median "
                  f"{t['torch']:.3f} ms ({n / t['torch'] * 1e3:.4e} "
                  f"keys/s); {2 * timed_runs} runs each, alternated")
            if also is not None:
                print(f"main {label} {also[0]}: median {t[also[0]]:.3f} ms "
                      f"({n / t[also[0]] * 1e3:.4e} keys/s)")

    def no_fallback(label):
        def expect(stats):
            assert stats["small_n"] == 0 and stats["overflow"] == 0 \
                and stats["deep"] == 0 and stats["plan"] == 0 \
                and stats["retry"] == 0, (label, stats)
        return expect

    def deep_expect(label):
        def expect(stats):
            assert stats["deep"] >= 1 and stats["overflow"] == 0, \
                (label, stats)
        return expect

    if "keys" in paths:
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
                     (lambda s: None) if heavy else no_fallback(label),
                     engine="v4")
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

    if "payload" in paths:
        # ---- payload planes (v4 up to 2^29; 2^30 pairs go to v5)
        close = path("payload", ["hist_level", "route_level",
                                 "terminal_write"])
        for i, (label, logn, kk, rk) in enumerate(PAYLOAD_CASES):
            keys, rids = make_input(1 << logn, kk, rk, SEED + logn, dev)
            run_case(label, keys, rids, 2, no_fallback(label), engine="v4")
            if i == 0:
                breakdown(label, lambda: sort(keys, rids, config=cfg))
            del keys, rids
        big = BIG_PAIRS_LOGN
        assert check_fits(1 << big, 3, dev, cfg) == "v4", big
        label = f"pairs u32+u64 2^{big}"
        keys, rids = make_input(1 << big, "u32", "u64", SEED + big, dev)
        run_case(label, keys, rids, 1, no_fallback(label), engine="v4")
        del keys, rids
        close()

    if "deep" in paths:
        # ---- deep tier
        close = path("deep", ["hist_level", "route_level", "terminal_write",
                              "splice_runs"])
        for label, logn, kind in DEEP_CASES:
            keys, rids = make_input(1 << logn, kind, None, SEED + 3 + logn,
                                    dev)
            run_case(label, keys, rids, 1, deep_expect(label))
            del keys, rids
        close()

    if "v5" in paths:
        # ---- the in-place v5 engine
        torch.cuda.empty_cache()
        close = path("v5", [k for k, (mod, _, _) in KERNELS.items()
                            if mod in ("kv4", "kv5") and "." not in k])
        big = V5_PAIRS_LOGN
        held = held_bytes(1 << big, torch.uint32, torch.uint64)
        fits = check_fits(1 << big, 3, dev, cfg, held)
        print(f"main v5: check_fits(2^{big} pairs, held {held} B) -> {fits!r}")
        assert fits == "v5", fits
        label = f"v5 auto pairs u32+u64 2^{big}"
        keys, rids = make_input(1 << big, "u32", "u64", SEED + 5 + big, dev)
        run_case(label, keys, rids, 1, no_fallback(label), engine="v5")
        breakdown(label, lambda: sort(keys, rids, config=cfg))
        del keys, rids
        torch.cuda.empty_cache()

        lk, ls, lr = V5_KEYS_LOGN, V5_SMALL_LOGN, V5_RAW_LOGN
        x = make_keys(1 << lk, 0.0, SEED + lk, dev)
        run_case(f"v5 keys 2^{lk}", x, None, 2, no_fallback(f"v5 keys 2^{lk}"),
                 config=v5cfg, engine="v5", also=("v4", cfg))
        del x
        x = make_keys(1 << ls, 0.3, SEED + ls, dev)
        run_case(f"v5 maxheavy 2^{ls}", x, None, 0, lambda s: None,
                 config=v5cfg, engine="v5")
        del x
        keys, rids = make_input(1 << ls, "heavy_pairs", None, SEED + 9, dev)

        def retry_expect(stats):
            assert stats["retry"] >= 1 and stats["deep"] >= 1 \
                and stats["overflow"] == 0, ("v5 retry", stats)
        run_case(f"v5 heavy pairs 2^{ls} (retry, deep)", keys, rids, 0,
                 retry_expect, config=v5cfg, engine="v5")
        del keys, rids

        n = 1 << lr
        chunks = [make_keys(n // 4, 0.0, SEED + 40 + i, dev) for i in range(4)]
        want = sum(checksum(c) for c in chunks) % (1 << 64)
        label = f"v5 from_chunks raw 2^{lr}"
        res = checker.run(label, lambda: (
            engine_v5.sort_v5_from_chunks(
                lambda i: (chunks[i].view(torch.int32),), 4, n, cfg,
                raw=True)))
        total, srt, _ = raw_check_2d(res[0], n)
        assert srt and total == want, ("raw", srt, total, want)
        print(f"main {label}: W {tuple(res[0].shape)} int32, raw_check_2d "
              f"sorted {srt}, checksum {total} (input {want})")
        del res, chunks
        close()

    if "v1" in paths:
        # ---- the v1 engine (engine="pallas", default config)
        torch.cuda.empty_cache()
        close = path("v1", ["tile_sort", "distribute", "ragged_sort",
                            "compact"])
        for label, logn, kk, rk, heavy, rounds in V1_CASES:
            keys, rids = ((make_keys(1 << logn, heavy, SEED + 13 + logn, dev),
                           None) if heavy else
                          make_input(1 << logn, kk, rk, SEED + 13 + logn, dev))
            run_case(label, keys, rids, rounds, no_fallback(label),
                     config=v1cfg, engine="v1")
            res = sort(keys, rids, config=v1cfg, timing=True)
            print(f"main {label} phases (host clock, synchronised):")
            print(res.pretty_times())
            del res
            if logn == 28:
                breakdown(label, lambda: sort(keys, rids, config=v1cfg))
                if rids is None:
                    table_checks(label, lambda: sort(keys, rids,
                                                     config=v1cfg))
            del keys, rids
        for logn in V1_VMEM_LOGN:
            label = f"v1 sort_vmem 2^{logn}"
            x = make_keys(1 << logn, 0.0, SEED + 17 + logn, dev)
            got = checker.run(label, lambda: pallas_engine.sort_vmem(x))
            assert_equal(got, torch_reference(x, None)[0], label)
            t = host_ms({"port": lambda: pallas_engine.sort_vmem(x),
                         "torch": lambda: library_sort(x, None)})
            print(f"main {label}: bitwise equal to the torch reference; port "
                  f"median {t['port']:.3f} ms, torch.sort median "
                  f"{t['torch']:.3f} ms; 4 runs each, alternated")
            del x, got
        close()

    if "v3" in paths:
        # ---- the v3 engine (engine="v3", default config)
        torch.cuda.empty_cache()
        close = path("v3", ["partition_level", "terminal_sort_write"])
        for label, logn, kk, rk, heavy, rounds in V3_CASES:
            n = 1 << logn
            keys, rids = ((make_keys(n, heavy, SEED + 19 + logn, dev), None)
                          if heavy else
                          make_input(n, kk, rk, SEED + 19 + logn, dev))
            plans = []
            make_plan = engine_v3.make_plan
            engine_v3.make_plan = lambda *a, **kw: (
                plans.append(make_plan(*a, **kw)), plans[-1])[1]
            try:
                run_case(label, keys, rids, rounds,
                         (lambda s: None) if heavy else no_fallback(label),
                         config=v3cfg, engine="v3")
            finally:
                engine_v3.make_plan = make_plan
            g = plans[0]        # the checked sort's plan
            print(f"main {label}: plan cap_rows {g.cap_rows} rmax {g.rmax} "
                  f"pitch {g.pitch}, {g.l1_tiles.shape[0]} L1 tiles, "
                  f"{int((g.l2_tiles[:, 2] < (1 << 30)).sum())} live of "
                  f"{g.l2_tiles.shape[0]} L2 tiles, "
                  f"{int(g.term_valid.sum())} terminal buckets")
            per_sort = {name: sum(r["calls"] for (lbl, nm, _), r
                                  in checker.by_input.items()
                                  if lbl == label and nm == name)
                        for name in ("partition_level", "terminal_sort_write")}
            print(f"main {label}: launches in the checked sort {per_sort}, "
                  f"value-fill buckets {checker.fill_buckets.get(label, 0)}")
            if not heavy:
                assert per_sort == {"partition_level": 2,
                                    "terminal_sort_write": 1}, \
                    (label, per_sort)
            if heavy:
                assert checker.fill_buckets.get(label, 0) > 0, label
            res = sort(keys, rids, config=v3cfg, timing=True)
            print(f"main {label} phases (host clock, synchronised):")
            print(res.pretty_times())
            del res
            if logn == 28:
                breakdown(label, lambda: sort(keys, rids, config=v3cfg))
            del keys, rids
        close()

    if "lsb" in paths:
        # ---- the LSB engine (engine="lsb", default config)
        torch.cuda.empty_cache()
        close = path("lsb", ["hist_level.digit", "route_level.digit",
                             "splice_runs"])
        bits = lsbcfg.lsb_digit_bits
        for label, logn, kk, rk, rounds in LSB_CASES:
            n = 1 << logn
            keys, rids = make_input(n, kk, rk, SEED + 23 + logn, dev)
            pitch, ntiles, arena_rows = engine_lsb._geometry(
                n, bits, lsbcfg.v3_sort_rows)
            npass = len(engine_lsb._pass_schedule(2 if kk == "u64" else 1,
                                                  bits))
            run_case(label, keys, rids, rounds, no_fallback(label),
                     config=lsbcfg, engine="lsb")
            per_sort = {name: sum(r["calls"] for (lbl, nm, _), r
                                  in checker.by_input.items()
                                  if lbl == label and nm == name)
                        for name in ("hist_level.digit", "route_level.digit",
                                     "splice_runs")}
            print(f"main {label}: pitch {pitch} rows, {ntiles} tiles, arena "
                  f"{arena_rows} rows, {npass} passes; launches in the "
                  f"checked sort {per_sort}")
            assert per_sort == dict.fromkeys(per_sort, npass), \
                (label, per_sort)
            if logn == 28:
                breakdown(label, lambda: sort(keys, rids, config=lsbcfg))
            del keys, rids
        close()

    if "chunked" in paths:
        # ---- the chunked out-of-core sort (chunked.sort_external)
        torch.cuda.empty_cache()
        close = path("chunked", ["hist_level", "route_level.accumulate",
                                 "splice_runs", "terminal_write"])
        mask32 = 0xFFFFFFFF

        def sums(x):
            """(count, mod-2^64 sums of x and of a fixed mix of x)."""
            w = x.view(torch.int32).long() & mask32
            mix = ((w ^ (w >> 16)) * 0x45D9F3B) & mask32
            return (w.numel(), int(w.sum().item()), int(mix.sum().item()))

        for label, logn, nchunks, pairs in CHUNKED_CASES:
            n, csz = 1 << logn, (1 << logn) // nchunks
            seed0 = SEED + 29 + logn

            def chunk_fn(i, seed0=seed0, csz=csz, pairs=pairs):
                """Chunk i from (seed, i): the same data at every call."""
                return tuple(make_keys(csz, 0.0, seed0 + 2 * i + j, dev)
                             for j in range(1 + pairs))

            ref = None
            want = [0, 0, 0]
            for i in range(nchunks):
                c = sums(chunk_fn(i)[0])
                want = [a + b for a, b in zip(want, c)]
            if pairs:
                planes = [chunk_fn(i) for i in range(nchunks)]
                k = torch.cat([p[0] for p in planes])
                r = torch.cat([p[1] for p in planes])
                del planes
                ref = tuple(t.cpu() for t in torch_reference(k, r))
                t = host_ms({"torch": lambda: library_sort(k, r)}, rounds=1)
                print(f"main {label}: torch.sort(stable) + rid gather of the "
                      f"whole input: median {t['torch']:.3f} ms "
                      f"({n / t['torch'] * 1e3:.4e} keys/s)")
                del k, r
            torch.cuda.synchronize()
            got = dict(count=0, sx=0, smix=0, last=None, pieces=0)

            def consume(piece, got=got, ref=ref, label=label):
                x = piece[0]
                col = _order_col(x)
                assert bool((col[1:] >= col[:-1]).all().item()), \
                    f"{label}: piece {got['pieces']} is not sorted"
                if got["last"] is not None:
                    assert int(col[0].item()) >= got["last"], \
                        f"{label}: piece {got['pieces']} starts below the last"
                got["last"] = int(col[-1].item())
                if ref is not None:
                    o = got["count"]
                    for p, w in zip(piece, ref):
                        assert_equal(p, w[o:o + x.numel()],
                                     f"{label} piece {got['pieces']}")
                c, sx, smix = sums(x)
                got["count"] += c
                got["sx"] += sx
                got["smix"] += smix
                got["pieces"] += 1

            def drive(chunk_fn=chunk_fn, nchunks=nchunks, n=n,
                      consume=consume):
                for piece in chunked.sort_external(chunk_fn, nchunks, n, cfg):
                    consume(piece)
                    del piece

            checker.run(label, drive)
            assert got["count"] == want[0] == n, (label, got, want)
            assert got["sx"] % 2**64 == want[1] % 2**64 \
                and got["smix"] % 2**64 == want[2] % 2**64, (label, got, want)
            print(f"main {label}: {got['pieces']} pieces, sorted within "
                  f"and across pieces, {got['count']} elements, mod-2^64 "
                  f"sums of x and of mix(x) equal to the input's"
                  + (", bitwise equal to the torch reference "
                     "(lexicographic by (key, rid))" if pairs else ""))
            del ref
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            timer = PhaseTimer(enabled=True)
            t0 = time.perf_counter()
            for piece in chunked.sort_external(chunk_fn, nchunks, n, cfg,
                                               timer=timer):
                del piece
            torch.cuda.synchronize()
            total = (time.perf_counter() - t0) * 1e3
            peak = (torch.cuda.max_memory_allocated(dev) - base)
            nbytes = 4 * n * (1 + pairs)
            print(f"main {label}: unchecked sort {total:.3f} ms "
                  f"({n / total * 1e3:.4e} keys/s), peak "
                  f"{peak / 2**30:.3f} GiB = {peak / nbytes:.3f} x the "
                  f"input's {nbytes / 2**30:.1f} GiB (the docstring's ~1.3 "
                  f"x; one generated chunk and its int64 draw included)")
            print(f"main {label} phases (host clock, synchronised):")
            print("\n".join(f"{lbl:<14}{sec:>12.6f}"
                            for lbl, sec in timer.report()))
        close()

    log.close()
    checked = {name for _, name, _ in checker.by_input}
    assert checked == set(KERNELS) or paths != PATHS, \
        f"kernels never checked: {set(KERNELS) - checked}"
    print(f"main launches (all paths): {launches}")
    totals = checker.totals
    for name in LIBRARY:
        t = totals[name]
        print(f"library {name}: {t['library_ms']:.4f} ms over "
              f"{t['library_calls']} checked launches, whose kernel time is "
              f"{t['library_kernel_ms']:.4f} ms (all checked launches: "
              f"{t['ms']:.4f} ms)")
    # the library comparison by plane count (keys-only launches apart)
    by_planes = {}
    for (_, name, planes), r in checker.by_input.items():
        if name in LIBRARY and r["lib"]:
            b = by_planes.setdefault((name, planes), [0.0, 0.0, 0])
            b[0] += r["lib"]
            b[1] += r["ms"]
            b[2] += r["calls"]
    for (name, planes), (lib, ms, calls) in sorted(by_planes.items()):
        print(f"library {name} planes={planes}: {lib:.4f} ms against the "
              f"kernel's {ms:.4f} ms over the {calls} checked launches of "
              f"the inputs where the library call ran")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": totals[name]["max_abs_err"],
         "ms": round(totals[name]["ms"], 4),
         "plain_ms": round(totals[name]["plain_ms"], 4),
         "bound_ms": round(totals[name]["bound_ms"], 4),
         "bound_by": "bytes",
         "library_ms": (round(totals[name]["library_ms"], 4)
                        if name in LIBRARY else None),
         # the launches library_ms covers, and the kernel's time on them
         "library_calls": (totals[name]["library_calls"]
                           if name in LIBRARY else None),
         "library_kernel_ms": (round(totals[name]["library_kernel_ms"], 4)
                               if name in LIBRARY else None),
         # CUDA events around the launch alone, summed like "ms"
         "launch_ms": (round(totals[name]["launch_ms"], 4)
                       if name in LAUNCH_TIMED else None)}
        for name, (_, src, rep) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
