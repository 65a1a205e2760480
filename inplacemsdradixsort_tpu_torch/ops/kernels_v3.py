"""The v3 engine's two kernels, on PyTorch: the fused partition level
(``partition_level``) and the terminal sort + write (``terminal_sort_write``),
with the signatures of ``inplacemsdradixsort_tpu/ops/kernels_v3.py``
(without ``interpret``) and every table an int32 tensor.

Each public function dispatches on the device of its input tensors: a
CPU tensor runs the plain PyTorch version (``*_ref``), a CUDA tensor
launches a hand-written kernel and raises if that fails.  Nothing falls
back from one to the other.  Both are CUDA C++ rather than Triton:
``partition_level`` (``csrc/kernels_v3.cu``) shares the launcher and the
one-``nvcc`` build of the v4 level kernels, and ``terminal_sort_write``
launches the v4 terminal kernel (``csrc/kernels_v4.cu``).

Keys are int32 in the sign-biased encoding (biased = raw ^ BIAS orders
the raw uint32 words as signed int32); SENT = biased +inf.  A v3 sort
carries one plane (keys) or two (keys, then rids); tuples order
lexicographically by (key, val).

Phantom pads: each (tile, range) run is padded to whole rows with
``(-h) % 128`` pad tuples (a pad value of the range's child, SENT in the
value plane); the pads are data to the next level and are counted per
pad sink so that the engine can subtract them (``engine_v3._pipeline``).

Order inside a child region is not part of the contract.  The TPU sorts
each padded tile, because it has no scatter, and stores each range's run
sorted at its child's cursor, tiles in grid order.  The CUDA kernel
claims each run's rows with a global atomic and scatters with shared
atomics, so runs land in any order and elements in any order within
them.  ``canonical_children`` sorts every child region so that two
arenas compare.  The order reaches one thing downstream: level-2 tiles
are cut every ``pitch`` rows through level-1 runs, so ``occ2`` and the
level-2 pad counts follow the arrangement; ``real2``, the corrected
real counts and the sorted output do not.  ``partition_level_ref`` lays
every run out as the TPU does, so the CPU pipeline matches the
reference's tables and arenas exactly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernels_v4 as kv4
from .kernels_v4 import (BIAS, CHUNK_ROWS, LANES, SENT, _check,
                         _check_planes, _p, _pp)

MAX_RMAX = 1024        # ranges a partition block holds in shared memory

# launches of each kernel since the last reset (plain versions not counted)
LAUNCHES = {"partition_level": 0, "terminal_sort_write": 0}

Planes = Tuple[torch.Tensor, ...]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    kv4._call(kernel, fn_name, device, *args)
    LAUNCHES[kernel] += 1


def _check_len(name: str, t: torch.Tensor, n: int) -> None:
    if t.numel() != n:
        raise ValueError(f"{name}: {t.numel()} entries, expected {n}")


def _pair(src, vsrc) -> Planes:
    return (src,) if vsrc is None else (src, vsrc)


# ----------------------------------------------------- plain versions

def _tile_index(src: torch.Tensor, tile_tbl, parent_fill, pitch):
    """(parent, flat source index, live mask) of every tile element: tile
    t reads src.flat[src_row*128 + e] for e < nelems, nelems =
    clip(parent_fill[parent] - local_off, 0, pitch*128)."""
    tt = tile_tbl.long()
    parent, row, off = tt[:, 0], tt[:, 1], tt[:, 2]
    nel = (parent_fill.long()[parent] - off).clamp(0, pitch * LANES)
    e = torch.arange(pitch * LANES, device=src.device)
    idx = row[:, None] * LANES + e[None, :]
    live = (e[None, :] < nel[:, None]) & (idx < src.numel()) & (idx >= 0)
    return parent, idx.clamp(0, max(src.numel() - 1, 0)), live


def partition_level_ref(src, vsrc, tile_tbl, child_base, bounds, dst_start,
                        dst_cap, dst_rows, pitch, rmax, parent_fill,
                        sink_base, sink_cnt, padsrc, nsinks, pad_stride=1,
                        bias_input=False, out=None, t0=0, claimed=None):
    """The TPU kernel's result, run by run: tile by tile in grid order,
    range d of tile t (child c = child_base[parent] + d) holds its h real
    tuples and (-h) % 128 pads (padsrc[c*pad_stride + t % sink_cnt[c]],
    SENT), sorted by tuple as the sorted padded tile holds them; the run
    claims ceil(h/128) rows at the child's cursor, of which as many as
    the child's capacity has left are stored (the flag is set when that
    is fewer and the capacity is not 0).

    A caller can replay a large call in tile groups: ``out`` (the arena
    planes to write into), ``t0`` (the grid index of ``tile_tbl``'s first
    row) and ``claimed`` ((nchild,) int64 rows the earlier tiles claimed,
    advanced in place).  ``real``, ``padcnt`` and ``over`` then cover
    this group's tiles, ``occ`` every tile so far."""
    planes = _pair(src, vsrc)
    dev = src.device
    ntiles = tile_tbl.shape[0]
    nchild = dst_start.numel()
    if claimed is None:
        claimed = torch.zeros(nchild, dtype=torch.long, device=dev)
    parent, idx, live = _tile_index(src, tile_tbl, parent_fill, pitch)
    vals = [p.reshape(-1)[idx] for p in planes]
    if bias_input:
        vals[0] = vals[0] ^ BIAS
    d = kv4._classify(bounds, parent, vals[0], rmax)
    t = torch.arange(ntiles, device=dev)
    ok = live & (d < rmax)
    run = (t[:, None] * rmax + d)[ok]
    vals = [v[ok] for v in vals]
    h = torch.bincount(run, minlength=ntiles * rmax)
    # per run (tile-major, as the cursors advance): child, rows claimed
    # before it, rows stored, pads
    c = (child_base.long()[parent][:, None]
         + torch.arange(rmax, device=dev)[None, :]).reshape(-1)
    rrows = (h + LANES - 1) // LANES
    cap = dst_cap.long()[c]
    by_child = torch.sort(c, stable=True).indices
    excl = torch.cumsum(rrows[by_child], 0) - rrows[by_child]
    nper = torch.bincount(c, minlength=nchild)
    first = torch.cumsum(nper, 0) - nper
    before = torch.empty_like(rrows)
    before[by_child] = excl - excl[first[c[by_child]]]
    before += claimed[c]
    used = torch.minimum(before, cap.clamp(min=0))
    w = (torch.minimum(before + rrows, cap) - used).clamp(min=0)
    over = ((w < rrows) & (cap > 0)).any().to(torch.int32).reshape(1)
    claimed.index_add_(0, c, rrows)
    occ = torch.minimum(claimed, dst_cap.long()).clamp(min=0) \
        .to(torch.int32)
    real = torch.zeros(nchild, dtype=torch.long, device=dev) \
        .index_add(0, c, h).to(torch.int32)
    npad = (-h) % LANES
    j = (t0 + t).repeat_interleave(rmax) % sink_cnt.long()[c].clamp(min=1)
    padded = npad > 0           # only these runs read their sink's entries
    padcnt = torch.zeros(nsinks, dtype=torch.long, device=dev).index_add(
        0, torch.where(padded, sink_base.long()[c] + j, 0), npad) \
        .to(torch.int32)
    # pads join their runs; every run sorted by tuple
    padv = padsrc.reshape(-1)[torch.where(padded, c * pad_stride + j, 0)]
    lane = torch.arange(LANES, device=dev)
    pm = lane[None, :] < npad[:, None]
    pad_run = torch.arange(ntiles * rmax, device=dev)[:, None].expand(
        -1, LANES)[pm]
    pad_val = padv[:, None].expand(-1, LANES)[pm]
    run = torch.cat([run, pad_run])
    vals = [torch.cat([v, pad_val if q == 0 else torch.full_like(pad_val,
                                                                 SENT)])
            for q, v in enumerate(vals)]
    perm = kv4._lex_order([run] + vals)
    run = run[perm]
    counts = torch.bincount(run, minlength=ntiles * rmax)
    slot = torch.arange(run.numel(), device=dev) \
        - (torch.cumsum(counts, 0) - counts)[run]
    keep = slot < w[run] * LANES
    pos = ((dst_start.long()[c] + used)[run] * LANES + slot)[keep]
    if out is None:
        out = tuple(torch.empty((dst_rows, LANES), dtype=torch.int32,
                                device=dev) for _ in planes)
    for o, v in zip(out, vals):
        o.view(-1)[pos] = v[perm][keep]
    return (out[0], out[1] if vsrc is not None else None, occ, real,
            padcnt, over)


def terminal_sort_write_ref(src, vsrc, btbl, fillval, out_off, out_rows,
                            cap_rows, unbias_output=True, outs=None):
    """The TPU kernel's result: bucket b (btbl row (src_row, occ, real,
    mode)) with real > 0 in mode 0 loads ``cap_rows`` rows at src_row,
    takes rows >= occ as SENT, sorts by tuple and writes its first
    min(real, min(occ, cap_rows)*128) tuples at out_off[b]; in mode 1 it
    writes ``real`` copies of fillval[b] to the key plane.  Unbiased on
    the way out when asked.  Output elements no bucket writes are
    uninitialised; ``outs`` (the planes to write into) lets a caller
    replay a large call in bucket groups."""
    planes = _pair(src, vsrc)
    dev = src.device
    xor = BIAS if unbias_output else 0
    if outs is None:
        outs = tuple(torch.empty((out_rows, LANES), dtype=torch.int32,
                                 device=dev) for _ in planes)
    flat = [o.view(-1) for o in outs]
    bt = btbl.long()
    src_row, occ, real, mode = bt.unbind(1)
    off = out_off.long()
    f = (mode != 0) & (real > 0)
    if bool(f.any()):
        pos = kv4._spans(off[f], real[f])
        flat[0][pos] = torch.repeat_interleave(fillval[f] ^ xor, real[f])
    # mode 0: the rows >= occ are SENT and sort last, so only the first
    # min(occ, cap_rows) rows can reach the written prefix
    lens = occ.clamp(0, cap_rows) * LANES
    s = (mode == 0) & (real > 0) & (lens > 0)
    if bool(s.any()):
        lens = lens[s]
        keep = torch.minimum(real[s], lens)
        idx = kv4._spans(src_row[s] * LANES, lens)
        bid = torch.repeat_interleave(
            torch.arange(lens.numel(), device=dev), lens)
        vals = [p.reshape(-1)[idx] for p in planes]
        perm = kv4._lex_order([bid] + vals)
        rank = torch.arange(idx.numel(), device=dev) \
            - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
        w = rank < torch.repeat_interleave(keep, lens)
        pos = (torch.repeat_interleave(off[s], lens) + rank)[w]
        for o, v in zip(flat, vals):
            o[pos] = v[perm][w] ^ xor
    return outs[0], (outs[1] if vsrc is not None else None)


def canonical_children(arena: Planes, start: torch.Tensor,
                       occ: torch.Tensor) -> Planes:
    """Every child region [start[c], start[c] + occ[c]) rows of the
    arena planes, each sorted ascending by tuple and concatenated in
    child order.  Two partition results hold the same tuples in every
    child region iff their canonical forms (with the same ``occ``) are
    equal."""
    arena = tuple(a.reshape(-1) for a in arena)
    dev = arena[0].device
    st, oc = start.long(), occ.long().clamp(min=0)
    live = oc > 0
    idx = kv4._spans(st[live] * LANES, oc[live] * LANES)
    child = torch.repeat_interleave(
        torch.arange(int(live.sum().item()), device=dev), oc[live] * LANES)
    vals = [a[idx] for a in arena]
    perm = kv4._lex_order([child] + vals)
    return tuple(v[perm] for v in vals)


# ---------------------------------------------------------- kernels

def partition_level(src: torch.Tensor, vsrc: Optional[torch.Tensor],
                    tile_tbl: torch.Tensor, child_base: torch.Tensor,
                    bounds: torch.Tensor, dst_start: torch.Tensor,
                    dst_cap: torch.Tensor, dst_rows: int, pitch: int,
                    rmax: int, parent_fill: torch.Tensor,
                    sink_base: torch.Tensor, sink_cnt: torch.Tensor,
                    padsrc: torch.Tensor, nsinks: int, pad_stride: int = 1,
                    bias_input: bool = False):
    """One partition level; returns (dst, vdst, occ, real, padcnt, over).

    Tile t is ``tile_tbl[t] = (parent, src_row, local_off, ·)``: its
    elements are src.flat[src_row*128 + e] for e < clip(parent_fill[parent]
    - local_off, 0, pitch*128) (``src`` is any contiguous int32 tensor,
    read flat; ``vsrc``, when given, is the value plane of the same
    shape).  Range d of the parent holds the keys k with bound[d-1] < k <=
    bound[d] (``bounds`` (nparents, rmax), biased, non-decreasing per
    parent; ``bias_input`` biases the key plane on load, not the value
    plane).  Its h tuples plus (-h) % 128 pad tuples go to child c =
    child_base[parent] + d as one run of ceil(h/128) rows at the child's
    cursor (``dst_start[c]`` at first), of which at most the rows the
    capacity ``dst_cap[c]`` has left are stored; ``dst_cap == 0`` drops
    the range.  Pads are (padsrc.flat[c*pad_stride + j], SENT) with j = t
    % max(sink_cnt[c], 1), and are counted in padcnt[sink_base[c] + j].
    Returns the (dst_rows, 128) arenas (rows outside the stored runs
    uninitialised), occ[c] = min(rows claimed, cap) (nchild,), real[c] =
    Σ h (nchild,), padcnt (nsinks,) and over (1,), set when a child with
    a capacity got fewer rows than its runs claimed (which tuples such a
    child keeps is then not defined: the reference keeps each run's
    smallest, the kernel those that claimed a slot first; the engine
    retries).

    Replaces ``kernels_v3.py:63-265`` (``_partition_kernel``; its
    ``pallas_call`` at ``:307``).  The TPU counts ranges by compare-reduce,
    writes pad rows, sorts the padded tile with ``netsort.net_sort`` and
    streams each run to a cursor kept in SMEM across a grid that runs in
    order, in 64-row chunks that overshoot into the next child's gap.  On
    the H100 blocks run in no order, so the count is fused with
    ``route_level``'s scatter instead: it is bound by reading every live
    element's key twice (once to count, once to store) and every other
    plane once, and by one scattered write of every element and pad, per
    plane.
    Design: one block per tile; binary search over the parent's bounds in
    shared memory and shared-memory counters; one global ``atomicAdd`` on
    the child's cursor per run claims its rows, each element then claims
    a slot of its run with a shared ``atomicAdd`` and the pads fill the
    run's tail.  Stores are element-exact and addresses 64-bit.  Results
    that do not depend on order (occ, real, pad counts, the flag) equal
    the reference's; order inside a child region is undefined.  The
    cursors are an int32 scratch set to ``dst_start`` on the stream
    before the launch; occ is taken from them after it.
    """
    dev = src.device
    planes = _check_planes("src", _pair(src, vsrc), dev)
    if vsrc is not None and vsrc.shape != src.shape:
        raise ValueError(f"vsrc {tuple(vsrc.shape)} != src "
                         f"{tuple(src.shape)}")
    tabs = dict(tile_tbl=tile_tbl, child_base=child_base, bounds=bounds,
                dst_start=dst_start, dst_cap=dst_cap,
                parent_fill=parent_fill, sink_base=sink_base,
                sink_cnt=sink_cnt, padsrc=padsrc)
    for name, t in tabs.items():
        _check(name, t, dev)
    if tile_tbl.dim() != 2 or tile_tbl.shape[1] != 4:
        raise ValueError(f"tile_tbl must be (ntiles, 4), got "
                         f"{tuple(tile_tbl.shape)}")
    if not 1 <= rmax <= MAX_RMAX:
        raise ValueError(f"rmax={rmax} outside [1, {MAX_RMAX}]")
    if bounds.numel() % rmax:
        raise ValueError(f"bounds ({bounds.numel()}) not a multiple of "
                         f"rmax={rmax}")
    nparents = bounds.numel() // rmax
    nchild = dst_start.numel()
    _check_len("child_base", child_base, nparents)
    _check_len("parent_fill", parent_fill, nparents)
    for name in ("dst_cap", "sink_base", "sink_cnt"):
        _check_len(name, tabs[name], nchild)
    if dev.type == "cpu":
        return partition_level_ref(src, vsrc, tile_tbl, child_base, bounds,
                                   dst_start, dst_cap, dst_rows, pitch,
                                   rmax, parent_fill, sink_base, sink_cnt,
                                   padsrc, nsinks, pad_stride, bias_input)
    dst = tuple(torch.empty((dst_rows, LANES), dtype=torch.int32,
                            device=dev) for _ in planes)
    cursor = dst_start.clone()
    real = torch.zeros(nchild, dtype=torch.int32, device=dev)
    padcnt = torch.zeros(nsinks, dtype=torch.int32, device=dev)
    over = torch.zeros(1, dtype=torch.int32, device=dev)
    ntiles = tile_tbl.shape[0]
    if ntiles:
        _launch("partition_level", "kv3_partition_level", dev,
                *_pp(planes)[:2], src.numel(), _p(tile_tbl), _p(child_base),
                _p(bounds), _p(dst_start), _p(dst_cap), _p(cursor),
                _p(parent_fill), _p(sink_base), _p(sink_cnt), _p(padsrc),
                padsrc.numel(), *_pp(dst)[:2], dst[0].numel(), _p(real),
                _p(padcnt), _p(over), len(planes), ntiles, nparents, nchild,
                nsinks, pitch, rmax, pad_stride, int(bias_input))
    occ = torch.minimum(cursor - dst_start, dst_cap).clamp_(min=0)
    return (dst[0], dst[1] if vsrc is not None else None, occ, real, padcnt,
            over)


def terminal_sort_write(src: torch.Tensor, vsrc: Optional[torch.Tensor],
                        btbl: torch.Tensor, fillval: torch.Tensor,
                        out_off: torch.Tensor, out_rows: int, cap_rows: int,
                        unbias_output: bool = True):
    """Sort every bucket and write its real prefix at its exact output
    offset; returns (out, vout), (out_rows, 128) int32 each.

    ``btbl`` (nb, 4) int32 rows are (src_row, occ_rows, real, mode).
    Mode 0: the min(occ_rows, cap_rows)*128 tuples at arena row src_row,
    sorted lexicographically by (key, val), give their first min(real,
    that) to out[out_off:out_off+...] of both planes (the reference
    writes SENT past occ_rows*128 when asked for more; the engine never
    asks).  Mode 1 (keys only): ``real`` copies of ``fillval`` (biased).
    ``unbias_output`` undoes the bias on the way out.  Buckets may come
    in any order; output elements no bucket writes are uninitialised.

    Replaces ``kernels_v3.py:380-545`` (``_terminal_kernel``; its
    ``pallas_call`` at ``:577``).  The TPU writes whole rows, so it rotates
    each bucket by its lane phase and read-modify-writes the head row,
    which needs the buckets in ascending ``out_off`` and a grid that runs
    in order; element-exact stores make all of that unnecessary.  The
    function is v4's ``terminal_write`` without its class mode, so the
    wrapper widens the table on the device to v4's 8 columns (src_row,
    occ, real, mode, fill, out_off, 0, 0), with mode 0's real clamped to
    cap_rows*128 as the reference clamps it, and launches the v4 terminal
    (``kernels_v4.launch_terminal``) rather than a third bitonic driver:
    the cluster path of ``csrc/kernels_v4.cu`` (one cluster a bucket, the
    network of ``csrc/cluster_sort.cuh``; v3 buckets reach cap_rows*128 =
    2^18 keys at n >= 2^28, 8 CTAs), or the global path with its scratch
    and one sync where the capacity fits no cluster.  v3 plans its buckets
    to 60% of cap_rows over a fudge of at least 1.2, about half of it, and
    the cluster path sorts each bucket on the smallest power-of-two
    network that holds it, over all the cluster's CTAs: a bucket of at
    most half the capacity costs every CTA half the work.  A pairs call checks on the device that no bucket is in
    mode 1 (v4's kernel fills the key plane only), one sync.  Counted under
    ``LAUNCHES["terminal_sort_write"]``, not under v4's count.
    """
    dev = src.device
    planes = _check_planes("src", _pair(src, vsrc), dev)
    for name, t in (("btbl", btbl), ("fillval", fillval),
                    ("out_off", out_off)):
        _check(name, t, dev)
    if btbl.dim() != 2 or btbl.shape[1] != 4:
        raise ValueError(f"btbl must be (nb, 4), got {tuple(btbl.shape)}")
    nb = btbl.shape[0]
    _check_len("fillval", fillval, nb)
    _check_len("out_off", out_off, nb)
    if len(planes) > 1 and bool(((btbl[:, 3] != 0) & (btbl[:, 2] > 0))
                                .any()):
        raise ValueError("terminal_sort_write: value-fill buckets (mode 1) "
                         "cannot carry a value plane")
    if dev.type == "cpu":
        return terminal_sort_write_ref(src, vsrc, btbl, fillval, out_off,
                                       out_rows, cap_rows, unbias_output)
    outs = tuple(torch.empty((out_rows, LANES), dtype=torch.int32,
                             device=dev) for _ in planes)
    if nb:
        mode = btbl[:, 3]
        real = torch.where(mode == 0, btbl[:, 2].clamp(max=cap_rows * LANES),
                           btbl[:, 2])
        zero = torch.zeros_like(real)
        wide = torch.stack([btbl[:, 0], btbl[:, 1], real, mode, fillval,
                            out_off, zero, zero], 1).contiguous()
        kv4.launch_terminal(_launch, "terminal_sort_write", planes, wide,
                            outs, cap_rows, -1, len(planes) - 1,
                            unbias_output)
    return outs[0], (outs[1] if vsrc is not None else None)
