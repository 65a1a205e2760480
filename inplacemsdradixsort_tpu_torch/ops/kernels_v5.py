"""The v5 engine's in-place kernels, on PyTorch: the sequential-block
partition (``seqroute_level``) and the cycle block permute
(``block_permute``) over the working buffer W.

Each public function dispatches on the device of W: a CPU tensor runs
the plain PyTorch version (``*_ref``), a CUDA tensor launches the
hand-written kernels in ``csrc/kernels_v5.cu`` and raises if that fails.
Nothing falls back from one to the other.  Both update W in place and
return it: v5 exists to keep the peak near (1 + ``v5_batch_frac``) x N,
so no W-sized output is ever made.

W is 1-4 int32 planes of (w_rows, 128); a block is ``BLKROWS`` rows,
``BLK`` elements, and slot k of W is its elements [k*BLK, (k+1)*BLK).
Keys are in the sign-biased encoding of ``kernels_v4`` once partitioned.

Order inside a range's stream is not part of the CUDA kernel's contract
(as for ``route_level``): the TPU sorts each tile, so each (tile, range)
run comes out sorted; the CUDA kernel claims stream positions with
atomics.  A region therefore holds the same tuples in another order;
``canonical_regions`` sorts the real prefix of every region so that two
results compare.  ``seqroute_level_ref`` lays the stream out as the TPU
does, bit for bit.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels_v4 as kv4
from .kernels_v4 import BIAS, LANES, SENT, _check, _check_planes, _p, _pp

BLKROWS = 256                  # rows per exchange block
BLK = BLKROWS * LANES          # elements per block
# the CUDA seqroute stages this many elements of every plane per window
# of tiles (64 MiB a plane; rounded down to whole tiles, at least one)
STAGE_ELEMS = 1 << 24

# the CUDA block_permute cuts the cycle table into chunks of S positions:
# at least PERMUTE_MIN_CHUNK, about PERMUTE_CHUNKS_PER_SM chunks an SM,
# and few enough that their head blocks (two a chunk) stay within
# HEAD_BLOCKS a plane, the staging seqroute_level held just before
PERMUTE_MIN_CHUNK = 16
PERMUTE_CHUNKS_PER_SM = 4
HEAD_BLOCKS = STAGE_ELEMS // BLK

# launches of each kernel since the last reset (plain versions not counted)
LAUNCHES = {"seqroute_level": 0, "block_permute": 0}

Planes = Tuple[torch.Tensor, ...]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    kv4._call(kernel, fn_name, device, *args)
    LAUNCHES[kernel] += 1


def _check_w(name: str, w: Sequence[torch.Tensor]) -> Planes:
    w = tuple(w)
    if not w:
        raise ValueError(f"{name}: no planes")
    w = _check_planes(name, w, w[0].device)
    for p, t in enumerate(w):
        if t.dim() != 2 or t.shape[1] != LANES:
            raise ValueError(f"{name}[{p}]: expected (rows, {LANES}), got "
                             f"{tuple(t.shape)}")
    return w


# ----------------------------------------------------- shared glue

def blocks_of(plane: torch.Tensor) -> torch.Tensor:
    """The whole blocks of a W plane as a (slots, BLK) view."""
    flat = plane.reshape(-1)
    return flat[: flat.numel() // BLK * BLK].view(-1, BLK)


def block_slots(cnt_tbl: torch.Tensor, base_tbl: torch.Tensor,
                slot_tbl: torch.Tensor, ntiles: int, pitch: int, rmax: int,
                nslots: int):
    """Where every block of every range's stream lands in W.

    From the (ntiles, rmax) tables of ``_seqroute_tables`` (the last row
    is the drain tile's): block b of range d is completed by the tile t
    whose run reaches stream position (b+1)*BLK, and goes to slot
    ``slot[t, d] + b - base[t, d] // BLK``; the open block cnt[d] // BLK
    goes to the drain slot ``slot[ntiles-1, d]``.  Returns (boff (rmax,)
    int64: the first entry of range d, bslot (nslots,) int64 with
    bslot[boff[d] + b] = slot), built without a host sync: a run of one
    tile completes at most pitch*128 // BLK + 1 blocks."""
    dev = cnt_tbl.device
    ndata = ntiles - 1
    cnt = cnt_tbl.reshape(ntiles, rmax)[:ndata].long()
    base = base_tbl.reshape(ntiles, rmax).long()
    slot = slot_tbl.reshape(ntiles, rmax).long()
    total = base[ndata]                           # stream length per range
    nblk = total // BLK + 1                       # full blocks + the drain
    boff = torch.cumsum(nblk, 0) - nblk
    first = base[:ndata] // BLK
    ev = (base[:ndata] + cnt) // BLK - first       # blocks each run completes
    k = torch.arange(pitch * LANES // BLK + 1, device=dev)
    ok = k[None, None, :] < ev[:, :, None]
    idx = boff[None, :, None] + first[:, :, None] + k[None, None, :]
    val = slot[:ndata, :, None] + k[None, None, :]
    bslot = torch.full((nslots + 1,), -1, dtype=torch.long, device=dev)
    bslot[torch.where(ok, idx, nslots).reshape(-1)] = val.reshape(-1)
    bslot[boff + total // BLK] = slot[ndata]
    return boff, bslot[:nslots]


def canonical_regions(w: Sequence[torch.Tensor], boff: torch.Tensor,
                      bslot: torch.Tensor, total: torch.Tensor,
                      ranges=None) -> list:
    """Every range's stream gathered from its blocks (the layout
    ``block_slots`` gives), its first total[d] tuples sorted ascending:
    [(region d, plane tuple)], for the ranges ``ranges`` (all by
    default).  Two seqroute results hold the same tuples in each region
    iff their canonical regions are equal."""
    rmax = boff.numel()
    out = []
    for d in range(rmax) if ranges is None else ranges:
        nb = int(total[d].item()) // BLK + 1
        rows = bslot[int(boff[d].item()):][:nb]
        planes = [blocks_of(p)[rows].reshape(-1) for p in w]
        c = int(total[d].item())
        perm = kv4._lex_order([p[:c] for p in planes])
        out.append((d, tuple(torch.cat([p[:c][perm], p[c:]])
                             for p in planes)))
    return out


# ----------------------------------------------------- plain versions

def seqroute_level_ref(w, meta, cnt_tbl, base_tbl, slot_tbl, padv_tbl,
                       ntiles, pitch, rmax, nlex=None, bias_input=False,
                       out=None, tiles=None):
    """The TPU kernel's result: each data tile sorted by tuple (planes
    0..nlex), range d's run (its ``cnt`` tuples, consecutive in the
    sorted tile) appended to range d's stream at ``base``, every block
    at the slot ``block_slots`` gives, the open blocks padded with
    (padv, SENT, ...) in their drain slots.  Slots outside the streams
    are left as they were.

    Reads W and writes ``out`` (W itself by default: every tile is read
    before anything is written).  ``tiles=(t0, t1)`` restricts the work
    to those data tiles (the drain pads go with the last one), so that a
    caller can replay a large call in groups into a separate ``out``."""
    w = tuple(w)
    out = w if out is None else tuple(out)
    dev = w[0].device
    nplanes = len(w)
    nlex = kv4._check_nlex(nlex, nplanes)
    ndata = ntiles - 1
    t0, t1 = (0, ndata) if tiles is None else tiles
    xor = BIAS if bias_input else 0
    m = meta[: 4 * ntiles].view(ntiles, 4).long()
    flats = [p.reshape(-1) for p in w]
    oflats = [p.reshape(-1) for p in out]
    boff, bslot = block_slots(cnt_tbl, base_tbl, slot_tbl, ntiles, pitch,
                              rmax, flats[0].numel() // BLK + rmax)
    base = base_tbl.reshape(ntiles, rmax).long()
    writes = []
    if t1 > t0:
        nt = t1 - t0
        e = torch.arange(pitch * LANES, device=dev)
        idx = m[t0:t1, 0:1] * LANES + e[None, :]
        live = e[None, :] < m[t0:t1, 1:2]
        idx = idx.clamp_(0, flats[0].numel() - 1)
        vals = [torch.where(live, f[idx] ^ xor, SENT).reshape(-1)
                for f in flats]
        tile = torch.arange(nt, device=dev)[:, None].expand(-1, pitch * LANES)
        perm = kv4._lex_order([tile.reshape(-1)] + vals[: nlex + 1])
        vals = [v[perm].view(nt, -1) for v in vals]
        cnt = cnt_tbl.reshape(ntiles, rmax)[t0:t1].long()
        cum = torch.cumsum(cnt, 1)
        r = e[None, :].expand(nt, -1).contiguous()
        d = torch.searchsorted(cum, r, right=True)
        ok = d < rmax
        dc = d.clamp(max=rmax - 1)
        s = (torch.gather(base[t0:t1], 1, dc) + r
             - torch.gather(cum - cnt, 1, dc))
        b = s // BLK
        addr = bslot[(boff[dc] + b).clamp(0, bslot.numel() - 1)] * BLK \
            + s % BLK
        writes = [(addr[ok], [v[ok] for v in vals])]
    if t1 == ndata:
        total = base[ndata]
        fill = total % BLK
        j = torch.arange(BLK, device=dev)
        pm = j[None, :] >= fill[:, None]
        addr = bslot[boff + total // BLK][:, None] * BLK + j[None, :]
        padv = padv_tbl.reshape(ntiles, rmax)[ndata]
        pads = [padv[:, None].expand(-1, BLK)[pm]]
        pads += [torch.full_like(pads[0], SENT)] * (nplanes - 1)
        writes.append((addr[pm], pads))
    for addr, vs in writes:
        for o, v in zip(oflats, vs):
            o[addr] = v
    return out


def block_permute_ref(w, cyc_off, cyc_slots):
    """Apply the cycles of ``permute_cycles``: slot cyc[i] takes the
    block of slot cyc[i+1], the last slot of a cycle takes its head."""
    w = tuple(w)
    off = cyc_off.long()
    slots = cyc_slots.long()
    if slots.numel() == 0:
        return w
    # the successor of every position in its cycle (wrapping to the head)
    nxt = torch.arange(1, slots.numel() + 1, device=slots.device)
    last = off[1:] - 1
    nxt[last] = off[:-1]
    for p in w:
        blocks = blocks_of(p)
        blocks[slots] = blocks[slots[nxt]]
    return w


def permute_chunk(moved: int, sms: int) -> int:
    """The chunk size S of the CUDA ``block_permute`` for ``moved``
    positions on a card of ``sms`` SMs (see the constants above)."""
    return max(PERMUTE_MIN_CHUNK, -(-moved // (PERMUTE_CHUNKS_PER_SM * sms)),
               -(-2 * moved // HEAD_BLOCKS))


def permute_plan(cyc_off, S: int):
    """The CUDA ``block_permute``'s two launches for chunks of S
    positions, in numpy (the kernels derive the same from ``cyc_off`` on
    the card).  Position i of the cycle table is slot cyc[i]; chunk j
    holds positions [j*S, (j+1)*S).

    Returns (saves, src).  ``saves`` (k, 2) lists the (head, position)
    pairs the first launch copies, head h taking the block of slot
    cyc[position]: head 2j for chunk j's first position when no cycle
    starts there, head 2j+1 for the head of the cycle that starts in
    chunk j and ends past it.  ``src`` (moved,) says where position i's
    new block comes from in the second launch: a position p >= 0 (the
    block at slot cyc[p] when the chunk reaches i: p = i + 1, or the head
    of a cycle that ends in the chunk it starts in, read before the chunk
    writes it), or -1 - h for head h."""
    off = np.asarray(cyc_off, np.int64)
    moved = int(off[-1])
    i = np.arange(moved)
    c = np.searchsorted(off, i, side="right") - 1
    start, end = off[c], off[c + 1]
    last = i + 1 == end
    src = np.where(last, start, i + 1)
    src = np.where(~last & ((i + 1) % S == 0), -1 - 2 * ((i + 1) // S), src)
    src = np.where(last & (start // S != i // S), -2 - 2 * (start // S), src)
    j = np.arange(S, moved, S)
    first = j[~np.isin(j, off)]
    cross = off[:-1][off[:-1] // S != (off[1:] - 1) // S]
    saves = np.concatenate([np.stack([2 * (first // S), first], 1),
                            np.stack([2 * (cross // S) + 1, cross], 1)])
    return saves, src


# ---------------------------------------------------------- kernels

def seqroute_level(w: Sequence[torch.Tensor], meta: torch.Tensor,
                   cnt_tbl: torch.Tensor, base_tbl: torch.Tensor,
                   slot_tbl: torch.Tensor, padv_tbl: torch.Tensor,
                   ntiles: int, pitch: int, rmax: int,
                   nlex: Optional[int] = None,
                   bias_input: bool = False) -> Planes:
    """In-place sequential-block partition of W into per-range streams.

    Tiles are ``meta[4t:4t+4] = (src_row, nelems, drain_flag, 0)``: data
    tiles 0..ntiles-2, whose elements are W.flat[src_row*128 + i] for i <
    nelems, then one drain tile.  The (ntiles, rmax) int32 tables are
    those of ``engine_v5._seqroute_tables``: per (tile, range) the run's
    count, its offset in the range's stream, and the slot of the first
    block it completes; the drain row holds the stream lengths, the drain
    slots and the pad values, which are the ranges' inclusive upper
    bounds (biased) — the CUDA kernel classifies by them, as
    ``hist_level`` did when it counted.  Every full block of range d's
    stream goes to its slot, the open block, padded with (padv, SENT,
    ...), to the drain slot.  ``bias_input`` biases every plane.

    Replaces ``kernels_v5.py:77-357`` (``_seqroute_body``).  The TPU
    reads tiles in order, sorts each in VMEM and flushes full blocks from
    VMEM accumulators to the next W slot, so the writer never overtakes
    the reader.  On the H100, blocks run in no order and a tile (2048
    rows, 1 MiB a plane) does not fit a block's shared memory.  Bound on
    the H100 by one read and one write of every plane of every element
    (7.7 ms at 2^30 pairs, 3 planes), plus the staging copy's read and
    write.  Design: windows of tiles (``STAGE_ELEMS`` elements a plane)
    are first copied to a staging buffer, then routed from it, so every W
    slot written in a window lies in rows already read (the kernel's
    comment says why); the staging is kept because a slot that a tile's
    run completes may lie in rows of a later tile of the same window, and
    smaller windows cost more in accumulator flushes and launches than
    they save in staging.  The route (``route_kernel``) is chunk-ranked as
    ``route_level``'s
    range mode: one block of 512 threads per 8,192 staged elements
    classifies each key once through the range lookup table of
    ``csrc/range_lut.cuh``, ranks it in its warp's count table, stages
    the chunk in shared memory by range and claims each (chunk, range)
    segment's share of its tile's run with one global atomic; consecutive
    threads then store a segment's consecutive stream positions, which
    cross at most one block boundary: whole sectors into the block's W
    slot when the block completes by the window's end, else into the
    range's two-parity accumulator (rmax x 2 x BLK a plane), which is
    flushed in the window that completes the block.  After the last
    window the open blocks are padded into their drain slots.  Extra
    memory is a constant: staging plus accumulators.  CUDA rather than
    Triton: data movement with table-driven addresses and warp-level
    ranking, beside the v4 kernels it shares the lookup table with.
    """
    w = _check_w("w", w)
    dev = w[0].device
    nlex = kv4._check_nlex(nlex, len(w))
    for name, t in (("meta", meta), ("cnt_tbl", cnt_tbl),
                    ("base_tbl", base_tbl), ("slot_tbl", slot_tbl),
                    ("padv_tbl", padv_tbl)):
        _check(name, t, dev)
    if meta.numel() < 4 * ntiles:
        raise ValueError(f"meta holds {meta.numel()} < 4*{ntiles} entries")
    for name, t in (("cnt_tbl", cnt_tbl), ("base_tbl", base_tbl),
                    ("slot_tbl", slot_tbl), ("padv_tbl", padv_tbl)):
        if t.numel() != ntiles * rmax:
            raise ValueError(f"{name}: {tuple(t.shape)} != ({ntiles}, "
                             f"{rmax})")
    if ntiles < 1:
        raise ValueError("seqroute_level needs the drain tile")
    if dev.type == "cpu":
        return seqroute_level_ref(w, meta, cnt_tbl, base_tbl, slot_tbl,
                                  padv_tbl, ntiles, pitch, rmax, nlex,
                                  bias_input)
    numel = w[0].numel()
    boff, bslot = block_slots(cnt_tbl, base_tbl, slot_tbl, ntiles, pitch,
                              rmax, numel // BLK + rmax)
    wt = max(1, STAGE_ELEMS // (pitch * LANES))
    wt = min(wt, max(ntiles - 1, 1))
    stage = torch.empty((len(w), wt * pitch * LANES), dtype=torch.int32,
                        device=dev)
    acc = torch.empty((len(w), rmax * 2 * BLK), dtype=torch.int32,
                      device=dev)
    cursor = torch.empty((wt * rmax,), dtype=torch.int32, device=dev)
    _launch("seqroute_level", "kv5_seqroute_level", dev,
            *_pp(w), numel, _p(meta), _p(cnt_tbl), _p(base_tbl),
            _p(padv_tbl), _p(boff), _p(bslot), _p(stage), _p(acc),
            _p(cursor), len(w), ntiles, pitch, rmax, wt, int(bias_input))
    return w


def block_permute(w: Sequence[torch.Tensor], cyc_off: torch.Tensor,
                  cyc_slots: torch.Tensor) -> Planes:
    """Move whole blocks of W in place along the cycles of
    ``engine_v5.permute_cycles``: (cyc_off (ncyc+1,), cyc_slots) int32,
    cycle c = cyc_slots[cyc_off[c]:cyc_off[c+1]]; slot cyc[i] takes the
    block of slot cyc[i+1] and the last slot takes the head's block.

    Replaces ``kernels_v5.py:362-533`` (``_permute_body``): the TPU streams
    one linearised schedule through a 16-slot read ring and 4 stage
    buffers with DMA semaphores.  On the H100 every element offset of a
    block is a chain of its own, and the move is bound by one read and
    one write of every moved block; what keeps it from that bound is
    latency when one long cycle (half the moved blocks at 2^30 pairs)
    runs on a few SMs.  Design: the cycle table is cut into chunks of S
    positions (``permute_chunk``: a few chunks an SM), so a chunk holds a
    piece of a long cycle or several short ones, each chunk run by
    ``PERMUTE_SPLIT`` thread blocks that own a slice of the block's
    offsets; a thread walks its chunk reading a few blocks ahead of its
    writes.  The only blocks one chunk reads and another writes are the
    first block of a chunk that starts inside a cycle and the head of a
    cycle that crosses a chunk's end: a first launch copies those to a
    head scratch (two blocks a chunk at most, ``permute_plan``), the
    second moves every chunk at once, so stream order is the only
    ordering needed (no grid barrier, no atomics).  A cycle that ends in
    the chunk it starts in keeps its head in registers, as one chunk
    holding every position does (then the first launch is skipped).  The
    chunk count comes from the table's length and the SM count and the
    cycles are found on the card by binary search over ``cyc_off``, so
    the tables stay on the card and nothing syncs.  The head scratch is
    at most ``HEAD_BLOCKS`` blocks a plane, the staging buffer that
    ``seqroute_level`` allocated for the same W and freed just before, so
    v5's peak does not rise.  The result is deterministic (each element
    moves once, to one place).  CUDA rather than Triton: each thread
    walks a chunk of data-dependent cycles, reading ahead and writing
    behind through a table of slots, a serial gather-scatter with no
    block shape that Triton's model could tile.
    """
    w = _check_w("w", w)
    dev = w[0].device
    _check("cyc_off", cyc_off, dev)
    _check("cyc_slots", cyc_slots, dev)
    if dev.type == "cpu":
        return block_permute_ref(w, cyc_off, cyc_slots)
    ncyc = cyc_off.numel() - 1
    moved = cyc_slots.numel()
    if ncyc > 0 and moved > 0:
        S = permute_chunk(moved, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        heads = torch.empty((len(w), 2 * -(-moved // S) * BLK),
                            dtype=torch.int32, device=dev)
        _launch("block_permute", "kv5_block_permute", dev,
                *_pp(w), _p(cyc_off), _p(cyc_slots), ncyc, moved, S,
                *_pp(heads), len(w))
    return w
