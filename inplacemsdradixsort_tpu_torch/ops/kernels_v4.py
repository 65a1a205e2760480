"""The v4 engine's partition, terminal and splice kernels, on PyTorch.

Each public function dispatches on the device of its input tensors: a
CPU tensor runs the plain PyTorch version (``*_ref``, the reference
semantics the tests hold the JAX kernels against), a CUDA tensor
launches the hand-written kernel in ``csrc/kernels_v4.cu`` and raises if
that fails.  Nothing falls back from one to the other.

Keys are int32 in the sign-biased encoding (``kernels_v4.py:32`` of the
JAX package): biased = raw ^ BIAS orders the raw uint32 words as signed
int32.  SENT = biased +inf.

Planes: a sort carries 1-4 int32 planes of equal length (the key, then
payload words: rids, or the (hi, lo) words of u64 keys and rids).
Plane 0 classifies; tuples order lexicographically over planes
``0..nlex`` (``nlex = nplanes - 1`` on the engine's path, where equal
tuples are identical, so an unstable sort still gives one bitwise
result).

The level kernels have two more modes.  The digit modes (``digit_shift``
set) classify by a radix digit of the raw word: ``hist_level`` counts by
it and ``route_level`` partitions stably by it, the LSB engine's passes.
The accumulate mode (``arenas`` given) routes into arenas that earlier
calls filled, the chunked sort's routes.

Order inside a range-mode route run is not part of the contract: the TPU
sorts the whole tile because it has no scatter, the CUDA kernel places
elements in the order its shared-memory atomics give them.
``canonical_runs`` sorts every stored run so that two arenas
compare.  The order does reach one thing downstream: level-2 tiles are
cut from the level-1 arena every ``pitch`` rows, through runs, so the
per-tile L2 counts (and from them ``rows_c2``, ``start2`` and the number
of L2 pads) follow the arrangement; the per-child totals and the sorted
output do not.  ``route_level_ref`` lays every run out as the TPU does
(tuples sorted, pads sorted in), so the CPU pipeline matches the
reference's tables bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build

LANES = 128
CHUNK_ROWS = 64        # arena gap after each child (kept: the arena layout
                       # and the start tables equal the reference's)
BIAS = -0x80000000
SENT = 0x7FFFFFFF
MAX_PLANES = 4
# the terminal's global path: its shared-memory tile in tuples, by plane
# count (``smem_tile`` in csrc/bitonic.cuh)
TERM_TILE = {1: 16384, 2: 8192, 3: 8192, 4: 4096}
# the terminal's cluster path (csrc/cluster_sort.cuh): log2 of the tuples
# one CTA holds and the network's register window, by plane count, and
# the largest cluster
CS_CTA_LOG = {1: 15, 2: 14, 3: 14, 4: 13}
CS_W = {1: 5, 2: 4, 3: 4, 4: 4}
CS_MAX_CTAS = 16
# the level kernels (csrc/kernels_v4.cu): the shared memory a block may
# take on the H100, hist_kernel's budget for its sub-histograms (the
# default a launch may take without an attribute), and the route
# kernels' warps and chunk of elements ranked and staged at once
SMEM_MAX = 227 * 1024
HIST_SMEM = 48 * 1024
ROUTE_WARPS = 16
ROUTE_CHUNK = 8192
LUT_CELLS = 4096       # the range lookup's cells over the parent's bounds

# launches of each kernel since the last reset (plain versions not
# counted); the modes of the level kernels count apart: ".digit" (the LSB
# passes) and ".accumulate" (a route into arenas the caller passes)
LAUNCHES = {"hist_level": 0, "hist_level.digit": 0, "route_level": 0,
            "route_level.digit": 0, "route_level.accumulate": 0,
            "terminal_write": 0, "splice_runs": 0}

Planes = Tuple[torch.Tensor, ...]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_planes(name: str, planes: Sequence[torch.Tensor],
                  device: torch.device) -> Planes:
    planes = tuple(planes)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"{name}: 1-{MAX_PLANES} planes, got "
                         f"{len(planes)}")
    for p, t in enumerate(planes):
        _check(f"{name}[{p}]", t, device)
        if t.numel() != planes[0].numel():
            raise ValueError(f"{name}[{p}]: {t.numel()} elements, plane 0 "
                             f"has {planes[0].numel()}")
    return planes


def _check_nlex(nlex: Optional[int], nplanes: int) -> int:
    nlex = nplanes - 1 if nlex is None else nlex
    if not 0 <= nlex < nplanes:
        raise ValueError(f"nlex={nlex} outside [0, {nplanes})")
    return nlex


def _call(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Run one C launcher of the kernel library on ``device``'s current
    stream; raise on the CUDA error it returns."""
    if device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {device}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(_build.library(), fn_name)(*args,
                                                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{kernel}: CUDA error {err} ({_build.error_string(err)})")


def _launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    _call(kernel, fn_name, device, *args)
    LAUNCHES[kernel] += 1


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _pp(planes: Sequence[torch.Tensor]):
    """The pointer of every plane, padded with NULL to MAX_PLANES."""
    ptrs = [_p(t) for t in planes]
    return ptrs + [ctypes.c_void_p(0)] * (MAX_PLANES - len(ptrs))


def _check_level(src, meta, bounds, ntiles, rmax, tables=()):
    dev = src.device
    for name, t in (("src", src), ("meta", meta), ("bounds", bounds)) \
            + tuple(tables):
        _check(name, t, dev)
    if meta.numel() < 3 * ntiles:
        raise ValueError(f"meta holds {meta.numel()} < 3*{ntiles} entries")
    if bounds.numel() % rmax:
        raise ValueError(f"bounds ({bounds.numel()}) not a multiple of "
                         f"rmax={rmax}")
    for name, t in tables:
        if t.numel() != ntiles * rmax:
            raise ValueError(f"{name}: {tuple(t.shape)} != ({ntiles}, "
                             f"{rmax})")


# ----------------------------------------------------- plain versions

def _lex_order(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation that sorts rows lexicographically by ``cols``
    (integer tensors whose values fit in int32, compared as signed).
    Neighbouring columns are folded into one int64 key, so k columns
    take ceil(k/2) stable sorts."""
    keys, cols = [], list(cols)
    while cols:
        b = cols.pop().long()
        if cols:
            keys.append((cols.pop().long() << 32) | (b - BIAS))
        else:
            keys.append(b)
    perm = None
    for k in keys:                  # least significant key first
        if perm is None:
            perm = torch.sort(k, stable=True).indices
        else:
            perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _tile_index(src, meta, ntiles, pitch):
    """(parent, idx, live) of every tile: idx (ntiles, pitch*128) flat
    source indices, with the lanes at or past the tile's element count
    marked not live."""
    m = meta[: 3 * ntiles].view(ntiles, 3).long()
    parent, row, nel = m.unbind(1)
    e = torch.arange(pitch * LANES, device=src.device)
    idx = row[:, None] * LANES + e[None, :]
    live = (e[None, :] < nel[:, None]) & (idx < src.numel())
    return parent, idx.clamp_(0, max(src.numel() - 1, 0)), live


def _tile_keys(src, meta, ntiles, pitch, bias_input):
    parent, idx, live = _tile_index(src, meta, ntiles, pitch)
    k = src.reshape(-1)[idx]
    return parent, (k ^ BIAS if bias_input else k), live


def _check_digit(digit_shift, digit_bits, bias_input):
    """Validate a digit mode: a shift inside the 32-bit word, 1-16 bits,
    and raw (unbiased) words."""
    if digit_shift is None:
        return
    if not 0 <= digit_shift < 32 or not 1 <= digit_bits <= 16:
        raise ValueError(f"digit_shift={digit_shift}, digit_bits="
                         f"{digit_bits}: need 0 <= shift < 32 and 1-16 bits")
    if bias_input:
        raise ValueError("digit mode reads raw words: bias_input must be "
                         "False")


def _digits(k, shift, bits):
    """(raw >> shift) & (2^bits - 1) of raw uint32 words held in int32,
    shifted logically (on int64, so that no sign bit leaks into a digit
    whose shift + bits passes 32)."""
    return ((k.long() & 0xFFFFFFFF) >> shift) & ((1 << bits) - 1)


def _classify(bounds, parent, k, rmax):
    """First range d with k <= bound[parent, d] (rmax if none)."""
    b = bounds.reshape(-1, rmax)[parent].contiguous()
    return torch.searchsorted(b, k.contiguous())


def hist_level_ref(src, meta, bounds, ntiles, pitch, rmax,
                   bias_input=False, digit_shift=None, digit_bits=0):
    parent, k, live = _tile_keys(src, meta, ntiles, pitch, bias_input)
    if digit_shift is None:
        d = _classify(bounds, parent, k, rmax)
    else:
        d = _digits(k, digit_shift, digit_bits)
    t = torch.arange(ntiles, device=src.device)[:, None]
    ok = live & (d < rmax)
    flat = (t * rmax + d)[ok]
    return torch.bincount(flat, minlength=ntiles * rmax).view(
        ntiles, rmax).to(torch.int32)


def route_level_ref(srcs, meta, bounds, cnt, dst, padv, dst_rows, ntiles,
                    pitch, rmax, bias_input=False, digit_shift=None,
                    digit_bits=0, digit_plane=0, arenas=None):
    srcs = tuple(srcs)
    dev = srcs[0].device
    parent, idx, live = _tile_index(srcs[0], meta, ntiles, pitch)
    vals = [s.reshape(-1)[idx] for s in srcs]
    if bias_input:
        vals = [v ^ BIAS for v in vals]
    digit = digit_shift is not None
    dp = digit_plane if digit else 0
    if digit:
        d = _digits(vals[dp], digit_shift, digit_bits)
    else:
        d = _classify(bounds, parent, vals[0], rmax)
    dst_l = dst.reshape(ntiles, rmax).long()
    cnt_l = cnt.reshape(-1).long()
    t = torch.arange(ntiles, device=dev)[:, None]
    # keys past every bound or digit (d >= rmax) belong to no run
    keep = live & (d < rmax)
    d.clamp_(max=rmax - 1)
    keep &= torch.gather(dst_l, 1, d) >= 0
    # phantom pads: (-cnt) % 128 copies of (padv in plane dp, SENT in the
    # others) per stored run
    dv = dst_l.reshape(-1)
    lane = torch.arange(LANES, device=dev)
    npad = (-cnt_l) % LANES
    pm = (dv[:, None] >= 0) & (lane[None, :] < npad[:, None])
    pad_run = torch.arange(ntiles * rmax, device=dev)[:, None].expand(
        -1, LANES)[pm]
    pad_val = padv.reshape(-1, 1).expand(-1, LANES)[pm]
    run = torch.cat([(t * rmax + d)[keep], pad_run])
    vals = [torch.cat([v[keep], pad_val if p == dp
                       else torch.full_like(pad_val, SENT)])
            for p, v in enumerate(vals)]
    if digit:
        # stable by run: each run's tuples in input order, its pads last
        perm = torch.sort(run, stable=True).indices
    else:
        # every run's tuples sorted (pads sorted in): the layout the
        # reference's sorted tile leaves, so the CPU pipeline reproduces
        # its L2 tiling bit for bit
        perm = _lex_order([run] + vals)
    run = run[perm]
    counts = torch.bincount(run, minlength=ntiles * rmax)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(run.numel(), device=dev) - first[run]
    ok = slot < (cnt_l + npad)[run]
    pos = (dv[run] * LANES + slot)[ok]
    if arenas is None:
        arenas = tuple(torch.empty((dst_rows, LANES), dtype=torch.int32,
                                   device=dev) for _ in vals)
    for a, v in zip(arenas, vals):
        a.view(-1)[pos] = v[perm][ok]
    return tuple(arenas)


def _spans(starts, lens):
    """Concatenated index ranges [starts[i], starts[i] + lens[i])."""
    total = torch.arange(int(lens.sum().item()), device=lens.device)
    first = torch.cumsum(lens, 0) - lens
    return (torch.repeat_interleave(starts, lens)
            + total - torch.repeat_interleave(first, lens))


def _selected(btbl, class_id):
    bt = btbl.long()
    sel = bt[:, 2] > 0
    if class_id is not None:
        sel &= bt[:, 6] == class_id
    return bt, sel


def _scratch_offsets(btbl, src_len, cap_rows, class_id, tile):
    """Where each bucket's segment lies in the terminal's global scratch
    ((nb,) int64 element offsets, packed over the buckets of this launch
    that the shared tile cannot hold), and the segments' total length,
    which is fetched to the host."""
    bt, sel = _selected(btbl, class_id)
    m = (bt[:, 1].clamp(max=cap_rows) * LANES).clamp(
        max=src_len - bt[:, 0] * LANES).clamp(min=0)
    size = torch.where(sel & (bt[:, 3] == 0) & (m > tile), m, 0)
    ends = torch.cumsum(size, 0)
    return (ends - size).contiguous(), int(ends[-1].item())


def terminal_geometry(nplanes: int, cap_rows: int) -> Tuple[int, int]:
    """(lr, sb): log2 of the tuples of the network a class of ``cap_rows``
    rows sorts on (cap_rows * 128 rounded up to a power of two, at least
    2^(W + 2)) and of those one CTA of the cluster path holds.  The one
    place of this rule: the launch takes both."""
    cap = max(cap_rows, 1) * LANES
    lr = max((cap - 1).bit_length(), CS_W[nplanes] + 2)
    return lr, min(lr, CS_CTA_LOG[nplanes])


def terminal_path(nplanes: int, cap_rows: int) -> Tuple[str, int]:
    """How ``terminal_write`` sorts a class of ``cap_rows`` rows: ("cluster",
    CTAs per bucket) when the network over its capacity
    (``terminal_geometry``) fits one thread-block cluster of at most
    CS_MAX_CTAS CTAs, else ("global", 0), the one-block network over a
    global scratch.  A host rule on the class's size, decided before the
    launch."""
    lr, sb = terminal_geometry(nplanes, cap_rows)
    ctas = 1 << (lr - sb)
    return ("cluster", ctas) if ctas <= CS_MAX_CTAS else ("global", 0)


def terminal_resident(nplanes: int, cap_rows: int) -> int:
    """The clusters the cluster path keeps resident (its persistent grid)
    for a class of ``cap_rows`` rows on the current CUDA device, from the
    occupancy calculator; for the per-call log."""
    n = _build.library().kv4_terminal_resident(
        nplanes, *terminal_geometry(nplanes, cap_rows))
    if n < 0:
        raise RuntimeError(f"terminal_resident: CUDA error {-n} "
                           f"({_build.error_string(-n)})")
    return n


def terminal_write_ref(srcs, btbl, outs, cap_rows, class_id=None,
                       nlex=None, unbias_output=True):
    srcs, outs = tuple(srcs), tuple(outs)
    nlex = _check_nlex(nlex, len(srcs))
    xor = BIAS if unbias_output else 0
    bt, sel = _selected(btbl, class_id)
    src_row, occ, real, mode, fill, off = bt[:, :6].unbind(1)
    f = sel & (mode != 0)
    if bool(f.any()):
        pos = _spans(off[f], real[f])
        outs[0].view(-1)[pos] = torch.repeat_interleave(
            fill[f].to(torch.int32) ^ xor, real[f])
    s = sel & (mode == 0)
    if not bool(s.any()):
        return outs
    lens = occ[s].clamp(max=cap_rows) * LANES
    real_e = torch.minimum(real[s], lens)
    idx = _spans(src_row[s] * LANES, lens)
    bid = torch.repeat_interleave(
        torch.arange(lens.numel(), device=idx.device), lens)
    vals = [x.reshape(-1)[idx] for x in srcs]
    perm = _lex_order([bid] + vals[: nlex + 1])
    rank = idx - torch.repeat_interleave(src_row[s] * LANES, lens)
    w = rank < torch.repeat_interleave(real_e, lens)
    pos = (torch.repeat_interleave(off[s], lens) + rank)[w]
    for o, v in zip(outs, vals):
        o.view(-1)[pos] = v[perm][w] ^ xor
    return outs


def splice_runs_ref(srcs, btbl, out_n, max_occ, unbias_output=False):
    srcs = tuple(srcs)
    xor = BIAS if unbias_output else 0
    bt = btbl.long()
    src_row, occ, real, off = bt[:, 0], bt[:, 1], bt[:, 2], bt[:, 5]
    real = torch.minimum(real, occ.clamp(max=max_occ) * LANES).clamp(min=0)
    pos = _spans(off, real)
    idx = _spans(src_row * LANES, real)
    outs = []
    for s in srcs:
        o = torch.empty(out_n, dtype=torch.int32, device=s.device)
        o[pos] = s.reshape(-1)[idx] ^ xor
        outs.append(o)
    return tuple(outs)


def run_rows(dst, cnt):
    """The arena rows of every stored run (``dst >= 0``; a run spans
    ceil(cnt/128) rows from row ``dst``), run after run, and the run
    each row belongs to (int64 tensors)."""
    dv = dst.reshape(-1).long()
    nrows = (cnt.reshape(-1).long() + LANES - 1) // LANES
    st = (dv >= 0) & (nrows > 0)
    lens = nrows[st]
    return _spans(dv[st], lens), torch.repeat_interleave(
        torch.arange(lens.numel(), device=lens.device), lens)


def canonical_runs(arenas, dst, cnt, rows):
    """Arena rows [0, rows) of every plane with every stored run
    (``dst >= 0``; a run spans ceil(cnt/128) rows from row ``dst``)
    sorted ascending by tuple, and every element outside a stored run set
    to 0.  Two route outputs are equal under the port's contract iff
    their canonical forms are equal."""
    flats = [a.reshape(-1)[: rows * LANES] for a in arenas]
    dev = flats[0].device
    row_run = torch.full((rows,), -1, dtype=torch.long, device=dev)
    rix, rid = run_rows(dst, cnt)
    row_run[rix] = rid
    elem_run = row_run.repeat_interleave(LANES)
    pos = torch.nonzero(elem_run >= 0).squeeze(1)
    run = elem_run[pos]
    by_run = torch.sort(run, stable=True).indices
    vals = [f[pos] for f in flats]
    perm = _lex_order([run] + vals)
    outs = []
    for v in vals:
        out = torch.zeros(rows * LANES, dtype=torch.int32, device=dev)
        out[pos[by_run]] = v[perm]
        outs.append(out.view(rows, LANES))
    return tuple(outs)


# ------------------------------------------- level kernel layouts

def hist_layout(rmax: int, digit: bool = False) -> Tuple[int, int]:
    """(copies, shared bytes) of a ``hist_level`` launch at ``rmax``
    bins: ``copies`` sub-histograms (16 / copies warps share one), the
    bounds and, in range mode, the lookup table; the most copies of 16,
    8, 4, 2, 1 that fit HIST_SMEM, else one up to SMEM_MAX.  The one
    place of this rule: the launch takes both."""
    lut = 0 if digit else 2 * (LUT_CELLS + 1)
    for copies in (16, 8, 4, 2, 1):
        shm = 4 * rmax * (copies + 1) + lut
        if shm <= HIST_SMEM or (copies == 1 and shm <= SMEM_MAX):
            return copies, shm
    raise ValueError(f"hist_level: rmax={rmax} bins need {shm} bytes of "
                     f"shared memory a block, past the H100's {SMEM_MAX}")


def _route_per_bin(rows: int, digit: bool) -> int:
    # three int64 and three int32 tables a bin, the bounds (range mode),
    # and rows count tables (digit mode: count and mask tables)
    return 36 + 8 * rows if digit else 40 + 4 * rows


def route_smem(rmax: int, rows: int, digit: bool) -> int:
    """Shared bytes of a ``route_level`` launch at ``rmax`` bins with
    ``rows`` tables, in its kernel's layout (``route_digit_kernel``,
    ``route_range_kernel``): the per-bin tables, the staged chunk (int32
    words and uint16 bins), one int and, in range mode, the lookup
    table."""
    return (_route_per_bin(rows, digit) * rmax + 6 * ROUTE_CHUNK + 4
            + (0 if digit else 2 * (LUT_CELLS + 1)))


def route_max_rmax(digit: bool, rows: int) -> int:
    """The widest rmax a ``route_level`` launch with ``rows`` tables
    holds: 1,117 digits, 1,683 ranges with a table a warp, 3,979 ranges
    with one shared table."""
    return (SMEM_MAX - route_smem(0, 0, digit)) // _route_per_bin(rows,
                                                                   digit)


def route_layout(rmax: int, digit: bool = False) -> Tuple[int, int]:
    """(rows, shared bytes) of a ``route_level`` launch at ``rmax`` bins:
    a count table per warp (ROUTE_WARPS rows; the digit mode's stable
    ranking also a mask table) when they fit SMEM_MAX, else, in range
    mode, one count table the warps share.  A width neither holds raises
    ``ValueError`` naming the limit; the engines call this from their
    geometry, before anything is allocated or launched.  The one place
    of this rule: the launch takes both."""
    for rows in (ROUTE_WARPS,) if digit else (ROUTE_WARPS, 1):
        shm = route_smem(rmax, rows, digit)
        if shm <= SMEM_MAX:
            return rows, shm
    widest = route_max_rmax(digit, rows)
    raise ValueError(
        f"route_level: rmax={rmax} {'digits' if digit else 'ranges'} need "
        f"{shm} bytes of shared memory a block, past the H100's "
        f"{SMEM_MAX}: at most {widest} "
        f"{'digits (lsb_digit_bits <= 10)' if digit else 'ranges (v3_rmax)'}")


_SM_COUNT = {}


def level_split(ntiles: int, pitch: int, device: torch.device) -> int:
    """Blocks a tile gets in a level launch: one, unless the launch has
    fewer tiles than two blocks for every SM of the card; then enough
    for that, at most one for each ROUTE_CHUNK elements of a tile.  The
    blocks of a tile take its chunks in turn (hist_level adds their
    counts into a zeroed row; the range route takes each chunk's run
    segments with global atomics on zeroed run cursors, so the order
    inside a run is not stable).  A host rule on the launch's shape."""
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    chunks = -(-pitch * LANES // ROUTE_CHUNK)
    return max(1, min(chunks, -(-2 * _SM_COUNT[device] // max(ntiles, 1))))


def check_level_width(rmax: int, digit: bool = False) -> None:
    """Raise ``ValueError`` if the level kernels cannot run ``rmax``
    bins on the card (``route_layout`` binds before ``hist_layout``)."""
    route_layout(rmax, digit)
    hist_layout(rmax, digit)


# ---------------------------------------------------------- kernels

def hist_level(src: torch.Tensor, meta: torch.Tensor, bounds: torch.Tensor,
               ntiles: int, pitch: int, rmax: int,
               bias_input: bool = False, digit_shift: Optional[int] = None,
               digit_bits: int = 0) -> torch.Tensor:
    """Exact per-(tile, range) counts, (ntiles, rmax) int32.

    Tile t is ``meta[3t:3t+3] = (parent, src_row, nelems)``: its elements
    are src.flat[src_row*128 + i] for i < min(nelems, pitch*128).  Range d
    of the parent holds the keys k with bound[d-1] < k <= bound[d]
    (``bounds`` is (nparents*rmax,), non-decreasing per parent, biased).

    Digit mode (``digit_shift`` set; the LSB engine's passes): the bin of
    an element is the digit ``(raw >> digit_shift) & (2^digit_bits - 1)``
    of its raw, unbiased word, shifted logically; digits >= rmax and
    slack lanes count nowhere, and ``bounds`` is not read (the reference
    passes ``arange(rmax)``).

    Replaces ``kernels_v4.py:77-204`` (``_hist_kernel``, both modes).  On
    the H100 it is bound by reading the keys once from device memory (4
    bytes a key), if the counting keeps up.  Design (``hist_kernel``, one
    template for both modes): one block of 512 threads per tile reads the
    tile with 16-byte loads, four a thread per step (element by element
    where a plane view's tile start is not 16-byte aligned; the tail past
    the tile's count is skipped by index, since SENT equals a real biased
    0xFFFFFFFF); range mode finds each key's range through the lookup
    table of ``route_level``'s range mode and the parent's bounds in
    shared memory, digit mode takes the digit by a logical shift
    (``bounds`` not read).  Each warp counts into its own shared-memory
    sub-histogram (``hist_layout`` picks how many from rmax), summed at
    the end, so warps do not contend for a counter under a heavy key.  A
    warp's lanes add one each: aggregating a warp's equal bins first
    (warp ballots, an atomicOr mask, or a whole-warp test) measured
    slower on every input tried, all-equal keys included (a first version
    with ballots and a search over all the bounds took 264-270 ms over
    ``chip_smoke.py``'s checked range-mode launches where this one takes
    113-125, NVIDIA H100 80GB HBM3, 700 W).  A launch with fewer tiles
    than two blocks for every SM gives each tile several blocks
    (``level_split``), which add their counts into a zeroed row.  CUDA
    rather than Triton: the counters live in shared memory with shared
    atomics, which Triton's block model does not express, and the kernel
    shares
    ``route_level``'s tile layout, lookup table and launcher.
    """
    _check_level(src, meta, bounds, ntiles, rmax)
    _check_digit(digit_shift, digit_bits, bias_input)
    if src.device.type == "cpu":
        return hist_level_ref(src, meta, bounds, ntiles, pitch, rmax,
                              bias_input, digit_shift, digit_bits)
    digit = digit_shift is not None
    copies, shm = hist_layout(rmax, digit)
    split = level_split(ntiles, pitch, src.device)
    hist = (torch.zeros if split > 1 else torch.empty)(
        (ntiles, rmax), dtype=torch.int32, device=src.device)
    if ntiles:
        _launch("hist_level.digit" if digit else "hist_level",
                "kv4_hist_level", src.device, _p(src), src.numel(), _p(meta),
                _p(bounds), _p(hist), ntiles, pitch, rmax, int(bias_input),
                digit_shift if digit else -1, digit_bits, copies, shm, split)
    return hist


def route_level(srcs: Sequence[torch.Tensor], meta: torch.Tensor,
                bounds: torch.Tensor, cnt: torch.Tensor, dst: torch.Tensor,
                padv: torch.Tensor, dst_rows: int, ntiles: int, pitch: int,
                rmax: int, bias_input: bool = False,
                digit_shift: Optional[int] = None, digit_bits: int = 0,
                digit_plane: int = 0,
                arenas: Optional[Sequence[torch.Tensor]] = None) -> Planes:
    """One partition level of 1-4 planes to exact precomputed
    destinations.

    Plane 0 classifies.  Each (tile, range) run lands at arena row
    ``dst[t, r]`` in every plane as its ``cnt[t, r]`` tuples plus
    ``(-cnt) % 128`` pad tuples (``padv[t, r]`` in plane 0, SENT in the
    others), filling exactly ceil(cnt/128) rows; ``dst < 0`` skips the
    run.  ``bias_input`` biases every plane on load.  Returns one
    (dst_rows, 128) int32 arena per plane; rows outside the stored runs
    are uninitialised.  Tiles and ranges are those of ``hist_level``,
    which must have produced ``cnt``.  The kernel leaves the order inside
    a run undefined; the plain version sorts each run by whole tuples.

    Stable digit mode (``digit_shift`` set; the LSB passes): plane
    ``digit_plane`` classifies, by the digit of ``hist_level``'s digit
    mode, and ``bounds`` is not read.  Each run holds its real tuples in
    input order, then its pad tuples, whose plane ``digit_plane`` holds
    ``padv[t, d]`` (a word whose digit is d) and every other plane SENT.
    The contract is fully determined: kernel, plain version and the
    reference agree bit for bit on every run row.

    Accumulate mode (``arenas`` given, one (dst_rows, 128) int32 tensor
    per plane; the chunked sort's routes): the call stores into those
    tensors, in place, and returns them.  It writes only the rows of its
    own runs and allocates nothing, so k calls fill one shared arena.

    Replaces ``kernels_v4.py:209-499`` (``_route_body``, every mode; its
    profiling switch ``nosort`` is not ported).  The TPU finds runs by
    sorting the padded tile, because it has no scatter: by whole tuples
    in range mode, by a (digit, arrival rank) composite in digit mode.
    On the H100 every mode is bound by one read and one scattered write
    of every plane of every element.

    Range mode design (``route_range_kernel``, chunk-ranked as in
    one-sweep radix sorts): one block of 512 threads per tile walks the
    tile a chunk of 8,192 elements at a time for every plane count (16 a
    thread); warp w owns a contiguous span of the chunk and its lanes take
    it row by row, so loads are coalesced.  Each key's range comes from a
    4,096-cell lookup table over the span of the parent's bounds, built
    per block in shared memory, which leaves a search over the few bounds
    of the key's cell instead of all of them.  An element takes the next
    count of its range in its warp's shared-memory count table with one
    atomicAdd (a warp row whose lanes all share a
    range, a heavy key, takes 32 at once); one pass over (range, warp) and
    a warp-0 scan of the ranges give every element its slot in the chunk
    and each run's cursor, which carries from chunk to chunk; the chunk
    then goes plane by plane into shared memory in range order and
    consecutive threads store consecutive elements of a run, so stores
    come as runs of sectors (~85 elements a chunk at rmax 96) instead of
    one 4-byte store per element.  3 + 2 x planes block barriers a chunk.
    A launch with fewer tiles than two blocks for every SM (the deep
    tier's and v5's small routes) gives each tile several blocks
    (``level_split``), which take its chunks in turn and their place in
    each run with a global atomicAdd on the run's cursor (a zeroed table
    the wrapper allocates; no sync).  Ranking by shared-memory atomicOr
    masks (stable) and by warp ballots (one a bit of the range) measured
    slower than the per-warp atomics at the engines' shapes, and the
    order inside a run is free in range mode.  Accumulate mode is the
    same kernel storing into the caller's arenas: since its stores are
    element-exact, rows outside its runs keep what earlier calls wrote.

    Digit mode design (``route_digit_kernel``): the same chunked
    skeleton, ranked stably by a per-(warp, digit) shared-memory
    ``atomicOr`` mask (the lanes sharing the digit; ``__match_any_sync``
    is microcoded and was its first version's bottleneck): an element's
    rank is its warp's running count of the digit plus the mask's lanes
    below it, so each run holds its tuples in input order.  A version
    that shared one template with the range mode (ranking by warp
    ballots) took 66.3-66.8 ms over ``chip_smoke.py``'s 24 checked digit
    routes where this kernel takes 53.4-54.2 (NVIDIA H100 80GB HBM3,
    700 W), so the two stay apart.

    Shared memory (``route_layout``, decided on the host before the
    launch, the launch setting its attribute): 66 KiB at rmax 96 in range
    mode, 89 KiB at 8-bit digits, so two blocks an SM.  A count table a
    warp fits up to 1,683 ranges or 1,117 digits; past 1,683 the range
    mode shares one table among the warps, up to 3,979.  Wider launches
    raise ``ValueError``, and the engines refuse such widths in their
    geometry (``v3_rmax`` above 3,979, ``lsb_digit_bits`` above 10).

    All modes are templated on the plane count, so a keys-only launch
    does no per-plane work; stores are element-exact (the TPU's 64-row
    chunk stores overshoot and rely on an in-order grid) and addresses
    are 64-bit, so an arena may pass 2^31 elements.  CUDA rather than
    Triton: each element's slot comes from per-warp shared-memory counts
    and masks and an in-order scan across the warps of a block, and the
    stores are a data-dependent scatter; Triton's block model expresses
    none of these.
    """
    srcs = _check_planes("srcs", srcs, meta.device)
    tables = (("cnt", cnt), ("dst", dst), ("padv", padv))
    _check_level(srcs[0], meta, bounds, ntiles, rmax, tables)
    _check_digit(digit_shift, digit_bits, bias_input)
    if not 0 <= digit_plane < len(srcs):
        raise ValueError(f"digit_plane={digit_plane} outside [0, "
                         f"{len(srcs)})")
    dev = srcs[0].device
    if arenas is not None:
        arenas = _check_planes("arenas", arenas, dev)
        if len(arenas) != len(srcs) or any(
                a.numel() != dst_rows * LANES for a in arenas):
            raise ValueError(f"arenas: need {len(srcs)} tensors of "
                             f"{dst_rows} x {LANES} elements")
    if dev.type == "cpu":
        return route_level_ref(srcs, meta, bounds, cnt, dst, padv, dst_rows,
                               ntiles, pitch, rmax, bias_input, digit_shift,
                               digit_bits, digit_plane, arenas)
    digit = digit_shift is not None
    rows, shm = route_layout(rmax, digit)
    split = 1 if digit else level_split(ntiles, pitch, dev)
    outs = arenas if arenas is not None else tuple(
        torch.empty((dst_rows, LANES), dtype=torch.int32, device=dev)
        for _ in srcs)
    if not ntiles:
        return outs
    if digit:
        _launch("route_level.digit", "kv4_route_digit", dev,
                *_pp(srcs), srcs[0].numel(), _p(meta), _p(cnt), _p(dst),
                _p(padv), *_pp(outs), outs[0].numel(), len(srcs), ntiles,
                pitch, rmax, digit_shift, digit_bits, digit_plane, shm)
        return outs
    # the run cursors, when blocks share a tile
    gcur = (torch.zeros(ntiles * rmax, dtype=torch.int32, device=dev)
            if split > 1 else None)
    _launch("route_level" if arenas is None else "route_level.accumulate",
            "kv4_route_level", dev, *_pp(srcs), srcs[0].numel(), _p(meta),
            _p(bounds), _p(cnt), _p(dst), _p(padv), *_pp(outs),
            outs[0].numel(), len(srcs), ntiles, pitch, rmax, int(bias_input),
            rows, shm, split,
            ctypes.c_void_p(0) if gcur is None else _p(gcur))
    return outs


def terminal_write(srcs: Sequence[torch.Tensor], btbl: torch.Tensor,
                   outs: Sequence[torch.Tensor], cap_rows: int,
                   class_id: Optional[int] = None, nlex: Optional[int] = None,
                   unbias_output: bool = True) -> Planes:
    """Sort every bucket's tuples and write its real prefix in place into
    ``outs`` (one flat int32 tensor per plane); returns ``outs``.

    ``btbl`` (nb, 8) int32 rows are (src_row, occ_rows, real, mode, fill,
    out_off, class, 0).  Mode 0: sort the min(occ_rows, cap_rows)*128
    tuples at arena row src_row lexicographically over planes
    ``0..nlex`` and write the first ``real`` of them to
    out[out_off:out_off+real] of every plane; mode 1 (keys only): write
    ``real`` copies of ``fill``.  ``unbias_output`` undoes the sign bias
    on the way out.  With ``class_id``, only the buckets of that class.

    Replaces ``kernels_v4.py:504-811`` (``_terminal_body`` with its in-kernel
    ``netsort.net_sort_multi``); its head/tail read-modify-write and
    rotate exist because TPU DMA writes whole rows and are not ported.
    On the H100 a class bucket does not fit one block's shared memory
    (class 1 holds cap_rows*128 = 2^17-2^18 tuples on the engines' large
    inputs), so one block would sort it by passes over global memory.

    Design: two paths, picked on the host from the class's size alone
    (``terminal_path``), with no device sync to decide.  The cluster
    path, every class whose network (cap_rows*128 tuples rounded up to a
    power of two) fits a thread-block cluster of 1-16 CTAs: a persistent
    launch of as many clusters as can be resident (``terminal_resident``)
    walks the table, each cluster taking every G-th bucket of the class,
    reads its bucket once into the cluster's shared memory, sorts it
    there with the bitonic network ``ragged_sort`` uses
    (``csrc/cluster_sort.cuh``: register windows, passes across CTAs in
    distributed shared memory) and writes the real prefix once; no
    scratch, no sync.  With 1-2 planes each bucket sorts on the smallest
    power-of-two network that holds its min(occ_rows, cap_rows)*128
    tuples, spread over all the cluster's CTAs, so one at most half the
    class's capacity (v3's buckets) costs every CTA half a full bucket's
    work; 3-4 planes keep the class's network (their class buckets fill
    more than half of it, and the per-bucket one cost them 4%).  Keys and pairs sort their tuple words (an int32,
    a uint64).  3-4 planes sort one uint64 a tuple as well, (key, top
    bits of plane 1, index in the bucket), then order each run of equal
    words by the remaining planes read from the arena (runs of up to 32
    tuples, by one thread each; a bucket with a longer one is sorted
    again as whole 96- or 128-bit tuples) and gather the other planes by
    the index on the way out; a 96-bit compare would cost twice a pair's.
    Every plane is compared, so the order is lexicographic over all
    planes: for ``nlex < nplanes - 1`` the order of ties is not defined,
    as it was not before.  The global path, a class that fits no cluster
    (v5's 3-plane XL class, 6 MiB a bucket): one block per bucket, an
    all-ascending bitonic network over the bucket virtually padded with
    all-SENT tuples to a power of two; steps with a partner distance
    below the shared tile (``TERM_TILE``) in shared memory, longer ones on
    a global scratch copy of the bucket packed over this launch's large
    buckets, whose size costs one device sync.  One launch per capacity
    class, as ``_finish`` calls it, so that the class capacity clamps
    exactly as on the reference.  Mode 1 never occurs with payload
    planes (the planner drops no range then): the wrapper raises if it
    does, which costs a device sync per multi-plane call.  CUDA rather
    than Triton: thread-block clusters, distributed shared memory and
    cluster barriers, which Triton does not expose.
    """
    dev = btbl.device
    srcs = _check_planes("srcs", srcs, dev)
    outs = _check_planes("outs", outs, dev)
    _check("btbl", btbl, dev)
    if len(outs) != len(srcs):
        raise ValueError(f"{len(srcs)} source planes, {len(outs)} outputs")
    if btbl.dim() != 2 or btbl.shape[1] != 8:
        raise ValueError(f"btbl must be (nb, 8), got {tuple(btbl.shape)}")
    nlex = _check_nlex(nlex, len(srcs))
    if len(srcs) > 1:
        bt, sel = _selected(btbl, class_id)
        if bool((sel & (bt[:, 3] != 0)).any()):
            raise ValueError("terminal_write: value-fill buckets (mode 1) "
                             "cannot carry payload planes")
    if dev.type == "cpu":
        return terminal_write_ref(srcs, btbl, outs, cap_rows, class_id,
                                  nlex, unbias_output)
    nb = btbl.shape[0]
    if nb:
        launch_terminal(_launch, "terminal_write", srcs, btbl, outs,
                        cap_rows, -1 if class_id is None else int(class_id),
                        nlex, unbias_output)
    return outs


def launch_terminal(launch, kernel, srcs, btbl, outs, cap_rows, class_id,
                    nlex, unbias_output):
    """One terminal launch (``btbl`` (nb, 8) on the card, ``class_id`` -1
    for every class) on the path ``terminal_path`` picks, through
    ``launch`` (a module's ``_launch``, which counts it as ``kernel``).
    The cluster path allocates nothing and does not synchronise; the
    global path sizes its scratch on the host, one device sync."""
    dev, nb = btbl.device, btbl.shape[0]
    if terminal_path(len(srcs), cap_rows)[0] == "cluster":
        launch(kernel, "kv4_terminal_cluster", dev,
               *_pp(srcs), srcs[0].numel(), _p(btbl), nb, *_pp(outs),
               outs[0].numel(), len(srcs), int(unbias_output), cap_rows,
               class_id, *terminal_geometry(len(srcs), cap_rows))
        return
    soff, nscratch = _scratch_offsets(btbl, srcs[0].numel(), cap_rows,
                                      None if class_id < 0 else class_id,
                                      TERM_TILE[len(srcs)])
    scratch = torch.empty((len(srcs), max(nscratch, 1)), dtype=torch.int32,
                          device=dev)
    launch(kernel, "kv4_terminal_write", dev,
           *_pp(srcs), srcs[0].numel(), _p(btbl), nb, *_pp(outs),
           outs[0].numel(), _p(scratch), _p(soff), scratch.shape[1],
           len(srcs), nlex, int(unbias_output), cap_rows, class_id)


def splice_runs(srcs: Sequence[torch.Tensor], btbl: torch.Tensor, out_n: int,
                max_occ: int, unbias_output: bool = False) -> Planes:
    """Concatenate the real prefixes of row-aligned runs into dense
    planes of ``out_n`` elements (element-exact).

    ``btbl`` (nruns, 8) int32 rows are (src_row, occ_rows, real, ·, ·,
    out_off, ·, ·): the first min(real, min(occ_rows, max_occ)*128)
    elements at arena row src_row go to [out_off, out_off + that) of every
    plane, unbiased when asked.  Elements of the output that no run
    covers are uninitialised.

    Replaces ``kernels_v4.py:819-1027`` (``_splice_body``).  The TPU kernel
    writes whole rows, so it rotates each run by its lane phase, carries
    the partial last row in VMEM from one grid step to the next and
    flushes it at the end, which needs runs in output order; element-exact
    stores make all of that unnecessary, and runs may land in any order.
    On the H100 it is a pure copy, bound by one read and one write of 4
    bytes per element per plane.  Design: one block per run, a
    block-stride copy of every plane.  CUDA rather than Triton: it lives
    beside the level kernels and shares their launcher and build.
    """
    dev = btbl.device
    srcs = _check_planes("srcs", srcs, dev)
    _check("btbl", btbl, dev)
    if btbl.dim() != 2 or btbl.shape[1] != 8:
        raise ValueError(f"btbl must be (nruns, 8), got "
                         f"{tuple(btbl.shape)}")
    if dev.type == "cpu":
        return splice_runs_ref(srcs, btbl, out_n, max_occ, unbias_output)
    outs = tuple(torch.empty(out_n, dtype=torch.int32, device=dev)
                 for _ in srcs)
    if btbl.shape[0]:
        _launch("splice_runs", "kv4_splice_runs", dev,
                *_pp(srcs), srcs[0].numel(), _p(btbl), btbl.shape[0],
                *_pp(outs), out_n, len(srcs), max_occ, int(unbias_output))
    return outs
