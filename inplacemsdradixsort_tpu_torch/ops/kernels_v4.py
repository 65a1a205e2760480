"""The v4 engine's three partition/terminal kernels, on PyTorch.

Each public function dispatches on the device of its input tensor: a CPU
tensor runs the plain PyTorch version (``*_ref``, the reference
semantics the tests hold the JAX kernels against), a CUDA tensor
launches the hand-written kernel in ``csrc/kernels_v4.cu`` and raises if
that fails.  Nothing falls back from one to the other.

Keys are int32 in the sign-biased encoding (``kernels_v4.py:32`` of the
JAX package): biased = raw ^ BIAS orders the raw uint32 words as signed
int32.  SENT = biased +inf.

Order inside a route run is not part of the contract: the TPU sorts the
whole tile because it has no scatter, the CUDA kernel scatters with
atomics.  ``canonical_runs`` sorts every stored run so that two arenas
compare.  The order does reach one thing downstream: level-2 tiles are
cut from the level-1 arena every ``pitch`` rows, through runs, so the
per-tile L2 counts (and from them ``rows_c2``, ``start2`` and the number
of L2 pads) follow the arrangement; the per-child totals and the sorted
output do not.  ``route_level_ref`` lays every run out as the TPU does
(sorted, pads sorted in), so the CPU pipeline matches the reference's
tables bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

LANES = 128
CHUNK_ROWS = 64        # arena gap after each child (kept: the arena layout
                       # and the start tables equal the reference's)
BIAS = -0x80000000
SENT = 0x7FFFFFFF

# launches of each kernel since the last reset (plain versions not counted)
LAUNCHES = {"hist_level": 0, "route_level": 0, "terminal_write": 0}


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


def _launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    if device.type != "cuda":
        raise ValueError(f"{kernel}: no kernel for device {device}")
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"{kernel}: CUDA error {err} "
            f"({lib.kv4_error_string(err).decode()})")
    LAUNCHES[kernel] += 1


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


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

def _tile_keys(src, meta, ntiles, pitch, bias_input):
    """(parent, keys, live) of every tile: keys (ntiles, pitch*128), with
    the lanes at or past the tile's element count marked not live."""
    m = meta[: 3 * ntiles].view(ntiles, 3).long()
    parent, row, nel = m.unbind(1)
    flat = src.reshape(-1)
    e = torch.arange(pitch * LANES, device=src.device)
    idx = row[:, None] * LANES + e[None, :]
    live = (e[None, :] < nel[:, None]) & (idx < flat.numel())
    k = flat[idx.clamp_(0, max(flat.numel() - 1, 0))]
    if bias_input:
        k = k ^ BIAS
    return parent, k, live


def _classify(bounds, parent, k, rmax):
    """First range d with k <= bound[parent, d] (rmax if none)."""
    b = bounds.reshape(-1, rmax)[parent].contiguous()
    return torch.searchsorted(b, k.contiguous())


def hist_level_ref(src, meta, bounds, ntiles, pitch, rmax,
                   bias_input=False):
    parent, k, live = _tile_keys(src, meta, ntiles, pitch, bias_input)
    d = _classify(bounds, parent, k, rmax)
    t = torch.arange(ntiles, device=src.device)[:, None]
    ok = live & (d < rmax)
    flat = (t * rmax + d)[ok]
    return torch.bincount(flat, minlength=ntiles * rmax).view(
        ntiles, rmax).to(torch.int32)


def route_level_ref(src, meta, bounds, cnt, dst, padv, dst_rows, ntiles,
                    pitch, rmax, bias_input=False):
    dev = src.device
    parent, k, live = _tile_keys(src, meta, ntiles, pitch, bias_input)
    d = _classify(bounds, parent, k, rmax)
    dst_l = dst.reshape(ntiles, rmax).long()
    cnt_l = cnt.reshape(-1).long()
    t = torch.arange(ntiles, device=dev)[:, None]
    # keys past every bound (d == rmax) belong to no run
    keep = live & (d < rmax)
    d.clamp_(max=rmax - 1)
    keep &= torch.gather(dst_l, 1, d) >= 0
    # phantom pads: (-cnt) % 128 copies of padv for each stored run
    dv = dst_l.reshape(-1)
    lane = torch.arange(LANES, device=dev)
    npad = (-cnt_l) % LANES
    pm = (dv[:, None] >= 0) & (lane[None, :] < npad[:, None])
    pad_run = torch.arange(ntiles * rmax, device=dev)[:, None].expand(
        -1, LANES)[pm]
    pad_val = padv.reshape(-1, 1).expand(-1, LANES)[pm]
    # keys and pads of every run sorted by (run, value): one int64
    # composite key.  This is the layout the reference's sorted tile
    # leaves, so the CPU pipeline reproduces its L2 tiling bit for bit.
    run = torch.cat([(t * rmax + d)[keep], pad_run])
    val = torch.cat([k[keep], pad_val])
    comp = torch.sort((run << 32) | (val.long() - BIAS)).values
    run = comp >> 32
    val = ((comp & 0xFFFFFFFF) + BIAS).to(torch.int32)
    counts = torch.bincount(run, minlength=ntiles * rmax)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(run.numel(), device=dev) - first[run]
    ok = slot < (cnt_l + npad)[run]
    out = torch.empty(dst_rows * LANES, dtype=torch.int32, device=dev)
    out[(dv[run] * LANES + slot)[ok]] = val[ok]
    return out.view(dst_rows, LANES)


def _spans(starts, lens):
    """Concatenated index ranges [starts[i], starts[i] + lens[i])."""
    total = torch.arange(int(lens.sum().item()), device=lens.device)
    first = torch.cumsum(lens, 0) - lens
    return (torch.repeat_interleave(starts, lens)
            + total - torch.repeat_interleave(first, lens))


def terminal_write_ref(src, btbl, out, cap_rows, class_id=None):
    bt = btbl.long()
    src_row, occ, real, mode, fill, off, cls = bt[:, :7].unbind(1)
    sel = real > 0
    if class_id is not None:
        sel &= cls == class_id
    o = out.view(-1)
    f = sel & (mode != 0)
    if bool(f.any()):
        pos = _spans(off[f], real[f])
        o[pos] = torch.repeat_interleave(
            fill[f].to(torch.int32) ^ BIAS, real[f])
    s = sel & (mode == 0)
    if not bool(s.any()):
        return out
    occ_e = occ[s].clamp(max=cap_rows)
    lens = occ_e * LANES
    real_e = torch.minimum(real[s], lens)
    idx = _spans(src_row[s] * LANES, lens)
    bid = torch.repeat_interleave(
        torch.arange(lens.numel(), device=src.device), lens)
    comp = torch.sort(
        (bid << 32) | (src.reshape(-1)[idx].long() - BIAS)).values
    val = ((comp & 0xFFFFFFFF) + BIAS).to(torch.int32) ^ BIAS
    rank = idx - torch.repeat_interleave(src_row[s] * LANES, lens)
    w = rank < torch.repeat_interleave(real_e, lens)
    o[(torch.repeat_interleave(off[s], lens) + rank)[w]] = val[w]
    return out


def canonical_runs(arena, dst, cnt, rows):
    """Arena rows [0, rows) with every stored run (``dst >= 0``; a run
    spans ceil(cnt/128) rows from row ``dst``) sorted ascending, and every
    element outside a stored run set to 0.  Two route outputs are equal
    under the port's contract iff their canonical forms are equal."""
    flat = arena.reshape(-1)[: rows * LANES]
    dev = flat.device
    dv = dst.reshape(-1).long()
    nrows = (cnt.reshape(-1).long() + LANES - 1) // LANES
    st = (dv >= 0) & (nrows > 0)
    row_run = torch.full((rows,), -1, dtype=torch.long, device=dev)
    lens = nrows[st]
    row_run[_spans(dv[st], lens)] = torch.repeat_interleave(
        torch.arange(lens.numel(), device=dev), lens)
    elem_run = row_run.repeat_interleave(LANES)
    pos = torch.nonzero(elem_run >= 0).squeeze(1)
    run = elem_run[pos]
    by_run = torch.sort(run, stable=True).indices
    comp = torch.sort((run << 32) | (flat[pos].long() - BIAS)).values
    out = torch.zeros(rows * LANES, dtype=torch.int32, device=dev)
    out[pos[by_run]] = ((comp & 0xFFFFFFFF) + BIAS).to(torch.int32)
    return out.view(rows, LANES)


# ---------------------------------------------------------- kernels

def hist_level(src: torch.Tensor, meta: torch.Tensor, bounds: torch.Tensor,
               ntiles: int, pitch: int, rmax: int,
               bias_input: bool = False) -> torch.Tensor:
    """Exact per-(tile, range) counts, (ntiles, rmax) int32.

    Tile t is ``meta[3t:3t+3] = (parent, src_row, nelems)``: its elements
    are src.flat[src_row*128 + i] for i < min(nelems, pitch*128).  Range d
    of the parent holds the keys k with bound[d-1] < k <= bound[d]
    (``bounds`` is (nparents*rmax,), non-decreasing per parent, biased).

    Replaces ``kernels_v4.py:77-204`` (``_hist_kernel``, digit mode not
    ported).  On the H100 it is bound by reading the keys once from device
    memory (4 bytes a key) and by shared-memory atomics under skew.
    Design: one block per tile, binary search over the parent's bounds in
    shared memory, shared-memory counters; slack lanes are skipped by
    index, since SENT equals a real biased 0xFFFFFFFF.
    """
    _check_level(src, meta, bounds, ntiles, rmax)
    if src.device.type == "cpu":
        return hist_level_ref(src, meta, bounds, ntiles, pitch, rmax,
                              bias_input)
    hist = torch.empty((ntiles, rmax), dtype=torch.int32, device=src.device)
    if ntiles:
        _launch("hist_level", "kv4_hist_level", src.device,
                _p(src), src.numel(), _p(meta), _p(bounds), _p(hist),
                ntiles, pitch, rmax, int(bias_input))
    return hist


def route_level(src: torch.Tensor, meta: torch.Tensor, bounds: torch.Tensor,
                cnt: torch.Tensor, dst: torch.Tensor, padv: torch.Tensor,
                dst_rows: int, ntiles: int, pitch: int, rmax: int,
                bias_input: bool = False) -> torch.Tensor:
    """One partition level to exact precomputed destinations.

    Each (tile, range) run lands at arena row ``dst[t, r]`` as its
    ``cnt[t, r]`` keys (biased) plus ``(-cnt) % 128`` copies of
    ``padv[t, r]``, filling exactly ceil(cnt/128) rows; ``dst < 0`` skips
    the run.  Returns the (dst_rows, 128) int32 arena; rows outside the
    stored runs are uninitialised.  Tiles and ranges are those of
    ``hist_level``, which must have produced ``cnt``.

    Replaces ``kernels_v4.py:209-499`` (``_route_body``; accumulate and
    digit modes not ported).  The TPU finds runs by sorting the padded
    tile, because it has no scatter; the port classifies by the same
    bounds as ``hist_level`` and scatters.  On the H100 it is bound by one
    read and one scattered write of every key.  Design: one block per
    tile; each key claims a slot of its run with a shared-memory
    ``atomicAdd`` (order inside a run is therefore not defined), then the
    pads fill the run's tail.  Stores are element-exact (the TPU's 64-row
    chunk stores overshoot and rely on an in-order grid) and addresses are
    64-bit.
    """
    tables = (("cnt", cnt), ("dst", dst), ("padv", padv))
    _check_level(src, meta, bounds, ntiles, rmax, tables)
    if src.device.type == "cpu":
        return route_level_ref(src, meta, bounds, cnt, dst, padv, dst_rows,
                               ntiles, pitch, rmax, bias_input)
    out = torch.empty((dst_rows, LANES), dtype=torch.int32,
                      device=src.device)
    if ntiles:
        _launch("route_level", "kv4_route_level", src.device,
                _p(src), src.numel(), _p(meta), _p(bounds), _p(cnt),
                _p(dst), _p(padv), _p(out), out.numel(), ntiles, pitch,
                rmax, int(bias_input))
    return out


def terminal_write(src: torch.Tensor, btbl: torch.Tensor, out: torch.Tensor,
                   cap_rows: int, class_id: Optional[int] = None
                   ) -> torch.Tensor:
    """Sort every bucket and write its real prefix, unbiased, in place
    into ``out`` (flat int32); returns ``out``.

    ``btbl`` (nb, 8) int32 rows are (src_row, occ_rows, real, mode, fill,
    out_off, class, 0).  Mode 0: sort the min(occ_rows, cap_rows)*128
    biased keys at arena row src_row and write the first ``real`` of them
    to out[out_off:out_off+real]; mode 1: write ``real`` copies of
    fill ^ BIAS.  With ``class_id``, only the buckets of that class.

    Replaces ``kernels_v4.py:504-811`` (``_terminal_body`` with its in-kernel
    ``netsort.net_sort_multi``); its head/tail read-modify-write and
    rotate exist because TPU DMA writes whole rows and are not ported.
    On the H100 a bucket does not fit a block's shared memory (the XL class
    holds up to 2*cap_rows*128 = 2^19 keys at n >= 2^28), so the sort is
    bound by the passes a bitonic network makes over global memory.
    Design: one block per bucket, an all-ascending bitonic network over
    the bucket virtually padded with +inf to a power of two; steps with a
    partner distance below the 16K-key shared-memory tile run in shared
    memory, longer ones on a global scratch copy of the bucket.  One
    launch per capacity class, as ``_finish`` calls it, so that the
    class capacity clamps exactly as on the reference.
    """
    dev = src.device
    _check("src", src, dev)
    _check("btbl", btbl, dev)
    _check("out", out, dev)
    if btbl.dim() != 2 or btbl.shape[1] != 8:
        raise ValueError(f"btbl must be (nb, 8), got {tuple(btbl.shape)}")
    if dev.type == "cpu":
        return terminal_write_ref(src, btbl, out, cap_rows, class_id)
    nb = btbl.shape[0]
    if nb:
        scratch = torch.empty_like(src)
        _launch("terminal_write", "kv4_terminal_write", dev,
                _p(src), src.numel(), _p(btbl), nb, _p(out), out.numel(),
                _p(scratch), cap_rows,
                -1 if class_id is None else int(class_id))
    return out
