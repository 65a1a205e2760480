"""The v1 MSD engine (``engine="pallas"``) on PyTorch: a host-orchestrated
recursion over the four kernels of ``pallas_kernels``
(``inplacemsdradixsort_tpu/ops/pallas_engine.py``).

Each level tile-sorts the arena and counts every tile's range bounds
(``tile_sort``), lays the children out on the host from those exact
counts, and moves every (tile, range) run to its slot (``distribute``);
buckets small enough are sorted per capacity class (``ragged_sort``) and
the valid prefixes are joined into one dense output (``compact``).  Skew
is handled by splitting oversized buckets again on the next bits; a
bucket whose 32 bits are spent is all-equal and done.

The host layout is a deterministic function of the exact counts, with
no sampling, so every table and capacity here equals the reference's
for the same input, the ``+ chr_rows`` slack included (it kept the
reference's chunked DMA in bounds; element-exact stores do not need it,
and equal tables are what the parity tests compare).  The
``PhaseTimer`` labels are the reference's.

Pairs sort lexicographically by (key, rid); with rid = original index
that is a stable sort.  Keys-only sorts are exact for keys equal to
0xFFFFFFFF, which coincide with the sentinel: valid counts are kept on
the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SortConfig
from ..utils.timing import PhaseTimer
from . import pallas_kernels as pk
from .bitonic import bias_u32, unbias_u32
from .kernels_v4 import SENT

LANES = 128


@dataclasses.dataclass
class _Bucket:
    start_row: int          # row offset in the current arena
    cap_rows: int           # region size in rows (multiple of tile rows)
    valid: int              # true element count (non-sentinel)
    prefix: int             # key-range prefix (original uint32 domain)
    bits_left: int          # unsorted low bits
    kind: str               # 'split' | 'terminal' | 'done'
    slot_lens: np.ndarray   # element counts of its row-aligned slots


def _rows_per(lens: np.ndarray) -> np.ndarray:
    return (lens + LANES - 1) // LANES


def _row_valid(slot_lens: np.ndarray, cap_rows: int) -> np.ndarray:
    """Per-row valid-element counts of a bucket region."""
    lens = np.asarray(slot_lens, np.int64)
    rows = _rows_per(lens)
    starts = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64)
    used = int(rows.sum())
    rv = np.zeros(cap_rows, np.int32)
    rv[:used] = LANES
    rem = lens % LANES
    has_part = rem > 0
    last = (starts + rows - 1)[has_part]
    rv[last] = rem[has_part]
    return rv


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _shape_class_rows(rows: int, tr: int) -> int:
    """Round arena row counts to a coarse class (the reference bounds its
    recompilation with it; here it keeps the arenas equal)."""
    rows = max(rows, tr)
    p = 1 << max(0, math.ceil(math.log2(rows)))
    if p // 2 >= rows:
        p //= 2
    if rows <= p // 4 * 3:
        p = p // 4 * 3
    return _round_up(p, tr)


def _terminal_cap(pad_rows: int, chr_rows: int, tr: int,
                  vmax_rows: int) -> int:
    need = pad_rows + chr_rows
    cap = tr
    while cap < need:
        cap *= 2
    return cap


def _child_kind_cap(pad_rows: int, chr_rows: int, tr: int, vmax_rows: int,
                    bits_left: int) -> Tuple[str, int]:
    if pad_rows + chr_rows <= vmax_rows:
        return "terminal", _terminal_cap(pad_rows, chr_rows, tr, vmax_rows)
    if bits_left <= 0:
        return "done", _round_up(pad_rows + chr_rows, tr)
    return "split", _round_up(pad_rows + chr_rows, tr)


def _u32_words(x: torch.Tensor, what: str) -> torch.Tensor:
    """The uint32 words of an integer tensor of at most 32 bits, as int32
    (narrower types widen as the reference's ``astype(uint32)`` does)."""
    if x.dtype.is_floating_point or x.dtype.is_complex \
            or x.dtype == torch.bool or x.element_size() > 4:
        raise ValueError(f"{what}: the v1 engine takes integers of at most "
                         f"32 bits, got {x.dtype}")
    if x.element_size() == 4:
        return x.contiguous().view(torch.int32)
    return x.to(torch.int32)


def _arena(words: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, 128) biased arena: the words, then SENT."""
    a = torch.full((rows * LANES,), SENT, dtype=torch.int32,
                   device=words.device)
    a[: words.numel()] = bias_u32(words)
    return a.view(rows, LANES)


def _host(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def _dev(a: np.ndarray, device) -> torch.Tensor:
    return _host(a).to(device)


def msd_sort(keys: torch.Tensor, rids: Optional[torch.Tensor],
             cfg: SortConfig, timer: Optional[PhaseTimer] = None,
             return_meta: bool = False):
    """Sort uint32 keys (and optional rids of at most 32 bits, carried as
    uint32 words) on their device; returns uint32 tensors.

    With ``return_meta``, also returns the output extents (offset,
    length) of 'done' buckets (all key bits equal; used by the u64 path to
    finish the low words, the recursion floor of the reference)."""
    timer = timer or PhaseTimer(enabled=False)
    n = int(keys.shape[0])
    if n == 0:
        return (keys, rids, []) if return_meta else (keys, rids)
    pairs = rids is not None
    dev = keys.device
    tr = cfg.tile_rows                     # tile rows
    chr_rows = cfg.block_rows
    # largest sorted bucket: 8 tiles keys-only (2^18 elements at the
    # default tile), halved for pairs (the reference's VMEM budget)
    vmax_rows = (8 if rids is None else 4) * tr
    rb_cfg = cfg.range_bits

    kw = _u32_words(keys, "keys")
    vw = _u32_words(rids, "rids") if pairs else None

    # ---------------- arena 0: one root bucket, sentinel padded
    data_rows = -(-n // LANES)
    root_cap = _round_up(data_rows + chr_rows, tr)
    if root_cap <= vmax_rows:
        root_cap = _terminal_cap(data_rows, chr_rows, tr, vmax_rows)
    arena_rows = _shape_class_rows(root_cap + vmax_rows + chr_rows, tr)
    kb = _arena(kw, arena_rows)
    vb = _arena(vw, arena_rows) if pairs else None
    del kw, vw

    root_kind = "terminal" if root_cap <= vmax_rows else "split"
    buckets: List[_Bucket] = [_Bucket(
        start_row=0, cap_rows=root_cap, valid=n, prefix=0, bits_left=32,
        kind=root_kind, slot_lens=np.array([n], np.int64))]

    # ---------------- level loop
    # the reference caps a level's fan-out at 6 bits (each (tile, range)
    # run was one DMA descriptor on its chip) and spreads bits evenly over
    # the levels a bucket still needs; kept for equal tables
    rb_dma_cap = min(rb_cfg, 6)

    def _split_bits(b: _Bucket) -> int:
        """Bits this level: land children near vmax/2, evenly over the
        remaining levels."""
        pad_rows = int(_rows_per(b.slot_lens).sum())
        need = max(1, math.ceil(math.log2(max(
            2.0, pad_rows / (vmax_rows // 2)))))
        need = min(need, b.bits_left)
        levels = math.ceil(need / rb_dma_cap)
        return min(rb_cfg, b.bits_left, math.ceil(need / levels))

    while any(b.kind == "split" for b in buckets):
        r = 1 << rb_cfg                     # table width (fixed per config)
        ntiles = arena_rows // tr

        # --- host: per-tile bounds + valid/data counts
        bounds = np.zeros((ntiles, r), np.uint32)
        tile_valid = np.zeros(ntiles, np.int64)
        tile_data = np.zeros(ntiles, np.int64)
        for b in buckets:
            t0 = b.start_row // tr
            nt = b.cap_rows // tr
            rv = _row_valid(b.slot_lens, b.cap_rows)
            tile_valid[t0: t0 + nt] = rv.reshape(nt, tr).sum(1)
            used = int(_rows_per(b.slot_lens).sum()) * LANES
            tile_data[t0: t0 + nt] = np.clip(
                used - np.arange(nt) * (tr * LANES), 0, tr * LANES)
            if b.kind == "split":
                rbl = _split_bits(b)
                shift = b.bits_left - rbl
                d = np.arange(1, (1 << rbl) + 1, dtype=np.uint64)
                bb = np.uint64(b.prefix) + (d << np.uint64(shift)) - 1
                bounds[t0: t0 + nt, : (1 << rbl)] = bb.astype(np.uint32)
        bounds_biased = _dev((bounds ^ np.uint32(0x80000000)).view(np.int32),
                             dev)

        # --- device: tile sort + range counts
        with timer.phase("part_blocks"):
            kb, vb, cnt = pk.tile_sort(kb, vb, bounds_biased,
                                       _dev(tile_data, dev), tr)
            timer.sync(cnt)
        cnt_np = cnt.cpu().numpy().astype(np.int64)

        # --- host: child layout (the combine/compact/balance analog)
        with timer.phase("combine"):
            # int32, as the kernel takes them: no conversion before the call
            slot_rows = np.zeros((ntiles, r), np.int32)
            run_starts = np.zeros((ntiles, r), np.int32)
            run_lens = np.zeros((ntiles, r), np.int32)
            new_buckets: List[_Bucket] = []
            cursor = 0  # output rows allocated so far

            for b in buckets:
                t0 = b.start_row // tr
                nt = b.cap_rows // tr
                tv = tile_valid[t0: t0 + nt]
                if b.kind == "split":
                    rbl = _split_bits(b)
                    nr = 1 << rbl
                    c = cnt_np[t0: t0 + nt, :nr].copy()
                    c[:, nr - 1] = tv               # host-exact last column
                    hist = np.diff(np.concatenate(
                        [np.zeros((nt, 1), np.int64), c], axis=1), axis=1)
                    hist = np.maximum(hist, 0)
                    starts_in_tile = np.concatenate(
                        [np.zeros((nt, 1), np.int64), c[:, :-1]], axis=1)
                    srows = _rows_per(hist)
                    within = np.cumsum(srows, axis=0) - srows
                    for d in range(nr):
                        valid_d = int(hist[:, d].sum())
                        if valid_d == 0:
                            continue
                        pad_rows = int(srows[:, d].sum())
                        kind, cap = _child_kind_cap(
                            pad_rows, chr_rows, tr, vmax_rows,
                            b.bits_left - rbl)
                        slot_rows[t0: t0 + nt, d] = cursor + within[:, d]
                        run_starts[t0: t0 + nt, d] = starts_in_tile[:, d]
                        run_lens[t0: t0 + nt, d] = hist[:, d]
                        new_buckets.append(_Bucket(
                            start_row=cursor, cap_rows=cap, valid=valid_d,
                            prefix=int(np.uint64(b.prefix) + (
                                np.uint64(d) << np.uint64(b.bits_left - rbl))),
                            bits_left=b.bits_left - rbl, kind=kind,
                            slot_lens=hist[:, d].copy()))
                        cursor += cap
                else:
                    # forward: repack the bucket (one run per tile)
                    pad_rows = int(_rows_per(tv).sum())
                    kind, cap = _child_kind_cap(
                        pad_rows, chr_rows, tr, vmax_rows, b.bits_left)
                    if b.kind == "done":
                        kind = "done" if kind == "split" else kind
                    srows = _rows_per(tv)
                    within = np.cumsum(srows) - srows
                    slot_rows[t0: t0 + nt, 0] = cursor + within
                    run_starts[t0: t0 + nt, 0] = 0
                    run_lens[t0: t0 + nt, 0] = tv
                    new_buckets.append(_Bucket(
                        start_row=cursor, cap_rows=cap, valid=b.valid,
                        prefix=b.prefix, bits_left=b.bits_left, kind=kind,
                        slot_lens=tv.copy()))
                    cursor += cap

            out_rows = _shape_class_rows(cursor + vmax_rows + chr_rows, tr)

        # --- device: distribute runs to slots (host tables: the wrapper
        # checks them there, with no device sync)
        with timer.phase("swap_online"):
            kb, vb = pk.distribute(
                kb, vb, _host(slot_rows), _host(run_starts),
                _host(run_lens), out_rows, tr, chr_rows)
            timer.sync(kb)
        buckets = new_buckets
        arena_rows = out_rows

    # ---------------- terminal: batched sorts per size class
    with timer.phase("local_sort"):
        classes = {}
        for b in buckets:
            if b.kind == "terminal":
                classes.setdefault(b.cap_rows, []).append(b)
        slack_start = max((b.start_row + b.cap_rows for b in buckets),
                          default=0)
        for crows, bs in sorted(classes.items()):
            starts = np.array([b.start_row for b in bs], np.int64)
            pads = np.array(
                [int(_rows_per(b.slot_lens).sum()) * LANES for b in bs],
                np.int64)
            nb = 1 << max(0, math.ceil(math.log2(len(starts))))
            if nb > len(starts):  # the reference's grid padding: dummies
                starts = np.concatenate([
                    starts, np.full(nb - len(starts), slack_start, np.int64)])
                pads = np.concatenate(
                    [pads, np.zeros(nb - len(pads), np.int64)])
            kb, vb = pk.ragged_sort(kb, vb, _host(starts), _host(pads),
                                    crows)
            for b in bs:
                b.slot_lens = np.array([b.valid], np.int64)  # dense now
        timer.sync(kb)

    # ---------------- compact the valid prefixes in bucket order
    with timer.phase("inject"):
        seg_starts, seg_lens = [], []
        done_segs = []          # (output offset, length) of 'done' buckets
        out_off = 0
        for b in buckets:
            if b.kind == "terminal":
                seg_starts.append(b.start_row)
                seg_lens.append(b.valid)
            else:  # 'done' (all-equal, oversized): one segment per slot
                done_segs.append((out_off, b.valid))
                rows = _rows_per(b.slot_lens)
                offs = b.start_row + np.cumsum(rows) - rows
                for o, ln in zip(offs, b.slot_lens):
                    if ln > 0:
                        seg_starts.append(int(o))
                        seg_lens.append(int(ln))
            out_off += b.valid
        if len(seg_starts) == 1 and seg_starts[0] == 0:
            out_k, out_v = kb, vb            # already dense at row 0
        else:
            cchr = 4 * chr_rows              # the reference's chunk
            out_rows = -(-n // LANES) + cchr + 1
            out_k, out_v = pk.compact(
                kb, vb, _host(np.array(seg_starts)),
                _host(np.array(seg_lens)), out_rows, cchr)
        timer.sync(out_k)

    final_k = unbias_u32(out_k.reshape(-1)[:n])
    final_v = unbias_u32(out_v.reshape(-1)[:n]) if pairs else None
    if return_meta:
        return final_k, final_v, done_segs
    return final_k, final_v


def msd_sort_u64(keys_u64_hi: torch.Tensor, keys_u64_lo: torch.Tensor,
                 cfg: SortConfig, timer: Optional[PhaseTimer] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort uint64 keys given as (hi, lo) uint32 words on their device.

    The (key, val) order sorts (hi, lo) pairs directly; the low words of
    oversized all-equal-hi buckets (bits spent in the high word) are
    finished by a keys-only pass each."""
    n = keys_u64_hi.shape[0]
    # the all-ones u64 key coincides with the sentinel pair; count it and
    # put it back at the tail (it is the maximum)
    hi32 = keys_u64_hi.view(torch.int32)
    lo32 = keys_u64_lo.view(torch.int32)
    nmax = int(((hi32 == -1) & (lo32 == -1)).sum().item())
    hi, lo, done = msd_sort(keys_u64_hi, keys_u64_lo, cfg, timer=timer,
                            return_meta=True)
    for off, ln in done:
        seg_sorted, _ = msd_sort(lo[off: off + ln], None, cfg)
        lo.view(torch.int32)[off: off + ln] = seg_sorted.view(torch.int32)
    if nmax:
        hi.view(torch.int32)[n - nmax:] = -1
        lo.view(torch.int32)[n - nmax:] = -1
    return hi, lo


def sort_vmem(keys, tile_rows: int = 256) -> torch.Tensor:
    """Sort uint32 keys with one ``ragged_sort`` launch: pad to a
    power-of-two class of at least ``tile_rows`` rows, sort, slice (the
    reference's single-kernel sort and its compile-check entry point).
    ``keys`` may lie on any device; data that is not a tensor goes to
    the card."""
    if not torch.is_tensor(keys):
        from ..api import _card
        keys = torch.as_tensor(keys, device=_card())
    n = keys.shape[0]
    rows = max(tile_rows, -(-n // LANES))
    cap = 1 << math.ceil(math.log2(rows))
    kb = _arena(_u32_words(keys, "keys"), cap)
    # host tables: the wrapper checks them there, with no device sync
    kb, _ = pk.ragged_sort(kb, None, torch.zeros(1, dtype=torch.int32),
                           torch.full((1,), n, dtype=torch.int32), cap)
    return unbias_u32(kb.reshape(-1)[:n])
