"""LSB radix sort engine on PyTorch: out-of-place passes over fixed-width
digits — ``inplacemsdradixsort_tpu``'s ``ops/engine_lsb.py``.

It covers the reference suite's ``lsb_32``/``lsb_64`` variants
(msb_64.c's ``partition_keys``, :1037-1142): per pass a per-tile digit
histogram, cross-tile prefix sums for exact write cursors, and a stable
scatter.  No sampling, no splitters, no overflow paths: counts are exact
by construction.  Each pass runs three kernels:

1. ``hist_level`` in digit mode: exact per-(tile, digit) counts.
2. ``route_level`` in stable digit mode: per tile, a partition stable by
   the digit, each (tile, digit) run padded to whole 128-lane rows at an
   exact destination row.
3. ``splice_runs``: back to a dense array in (digit, tile) order, so the
   next pass sees no pads.

Stability is inherent, so payload planes ride along without an index
plane, and multi-word keys (u64 as (hi, lo) planes) sort by running the
passes over the less significant word first.  Equal keys keep their
input order whatever their payload: the result is stable by the key
planes only, not lexicographic over the payload as v4's is.

Planes are int32 tensors holding raw uint32 words (``x.view(int32)``);
the digit kernels read raw words, so nothing is biased.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..config import SortConfig
from ..utils.timing import PhaseTimer
from . import kernels_v4 as kv4
from .engine_v4 import _level_tables
from .kernels_v4 import BIAS, CHUNK_ROWS, LANES
from .plan_util import _ceil_div, _shape_class


def _pass_schedule(nkey: int, bits: int,
                   key_bits: Optional[int] = None
                   ) -> Tuple[Tuple[int, int], ...]:
    """(plane, shift) per pass, least significant digit first.

    Planes are most significant word first (u64 = (hi, lo)), so passes
    walk the planes in reverse.  ``key_bits`` (the significant LOW bits
    across the key planes) skips passes over constant-zero high digits."""
    if key_bits is None:
        key_bits = 32 * nkey
    passes = []
    for w in range(nkey - 1, -1, -1):
        wbits = min(32, max(0, key_bits - 32 * (nkey - 1 - w)))
        for shift in range(0, wbits, bits):
            passes.append((w, shift))
    return tuple(passes)


def _geometry(n: int, bits: int, sort_rows: int):
    """(pitch, ntiles, arena_rows) of an n-element sort with ``bits``-bit
    digits: the reference's tile pitch (``sort_rows`` less one pad row
    per digit) and arena size.  The reference's dense planes have
    ``rows_in + LCH + 2`` rows for its row-granular splice; the port's
    splice is element-exact and writes n elements."""
    pitch = sort_rows - (1 << bits)
    if pitch <= 0:
        raise ValueError(f"v3_sort_rows={sort_rows} leaves no tile rows "
                         f"beside {1 << bits} digits")
    kv4.check_level_width(1 << bits, digit=True)
    ntiles = _ceil_div(_ceil_div(n, LANES), pitch)
    rows_in = ntiles * pitch
    arena_rows = _shape_class(
        rows_in + ntiles * (1 << bits) + ((1 << bits) + 1) * CHUNK_ROWS)
    return pitch, ntiles, arena_rows


def _meta(n: int, ntiles: int, pitch: int, device) -> torch.Tensor:
    """The static dense-tile table: tile t reads rows [t*pitch, ...) of
    the dense planes, min(n - t*pitch*128, pitch*128) elements."""
    t = torch.arange(ntiles, dtype=torch.int64)
    nel = torch.clamp(n - t * pitch * LANES, max=pitch * LANES)
    m = torch.stack([torch.zeros_like(t), t * pitch, nel], 1).reshape(-1)
    return torch.cat([m, torch.zeros(3, dtype=torch.int64)]).to(
        torch.int32).to(device)


def _pipeline_lsb(planes, *, n: int, nkey: int, bits: int,
                  key_bits: Optional[int], pitch: int, ntiles: int,
                  arena_rows: int):
    """Every pass over the flat int32 planes; returns the sorted planes."""
    cur = tuple(planes)
    dev = cur[0].device
    nbins = 1 << bits
    meta = _meta(n, ntiles, pitch, dev)
    dig_bounds = torch.arange(nbins, dtype=torch.int32, device=dev)
    keep = torch.ones(nbins, dtype=torch.int32, device=dev)
    digits = torch.arange(nbins, dtype=torch.int64, device=dev)
    for dp, shift in _pass_schedule(nkey, bits, key_bits):
        h = kv4.hist_level(cur[dp], meta, dig_bounds, ntiles, pitch, nbins,
                           digit_shift=shift, digit_bits=bits)
        pads, _, _, dst = _level_tables(h, keep, CHUNK_ROWS)
        # a pad's word has the run's digit: d << shift, as uint32 bits
        padv = (((digits << shift) & 0xFFFFFFFF) + BIAS).to(torch.int32) \
            ^ BIAS
        padv = padv[None, :].expand(ntiles, nbins).contiguous()
        arena = kv4.route_level(cur, meta, dig_bounds, h, dst, padv,
                                arena_rows, ntiles, pitch, nbins,
                                digit_shift=shift, digit_bits=bits,
                                digit_plane=dp)
        # splice the runs in (digit-major, tile-minor) order back to dense
        occ = (h + pads) // LANES
        real_f = h.T.reshape(-1)
        off = torch.cumsum(real_f, 0, dtype=torch.int64) - real_f
        zeros = torch.zeros_like(real_f)
        btbl = torch.stack([dst.T.reshape(-1), occ.T.reshape(-1), real_f,
                            zeros, zeros, off.to(torch.int32), zeros, zeros],
                           1).contiguous()
        del cur
        cur = kv4.splice_runs(arena, btbl, n, max_occ=pitch)
        del arena
    return cur


def sort_lsb(keys: torch.Tensor, vals=(), cfg: Optional[SortConfig] = None,
             timer: Optional[PhaseTimer] = None, nkey: int = 1,
             key_bits: Optional[int] = None):
    """Sort raw uint32 words held in 1-D int32 tensors by LSB radix passes
    over the first ``nkey`` planes (most significant word first); the
    remaining planes of ``(keys, *vals)`` are payload.

    Stable by the key planes only: equal keys keep their input order
    whatever their payload.  ``key_bits`` (the significant LOW key bits)
    skips passes over constant-zero high digits.  Below ``min_engine_n``
    (default 2^14) a stable ``torch.sort`` by the key planes gives the
    same order.  Returns (sorted keys, tuple of sorted vals)."""
    cfg = cfg or SortConfig()
    timer = timer or PhaseTimer(enabled=False)
    planes = tuple(p.contiguous() for p in (keys,) + tuple(vals))
    if len(planes) > kv4.MAX_PLANES or not 1 <= nkey <= len(planes):
        raise ValueError(f"{len(planes)} planes with nkey={nkey}: need "
                         f"1 <= nkey <= planes <= {kv4.MAX_PLANES}")
    for p in planes:
        if p.dtype != torch.int32 or p.dim() != 1 \
                or p.shape != keys.shape or p.device != keys.device:
            raise TypeError(
                "sort_lsb takes 1-D int32 tensors of raw uint32 words of "
                f"one length on one device, got {p.dtype} "
                f"{tuple(p.shape)} on {p.device}")
    n = int(keys.shape[0])
    if n >= 1 << 31:
        raise ValueError(f"n={n}: the splice table's int32 output offsets "
                         "reach 2^31 - 1")
    thr = cfg.min_engine_n if cfg.min_engine_n is not None else (1 << 14)
    with timer.phase("part_blocks"):
        if n < thr:
            # stable by the key planes only, like the passes
            perm = kv4._lex_order([p ^ BIAS for p in planes[:nkey]])
            outs = tuple(p[perm] for p in planes)
        else:
            pitch, ntiles, arena_rows = _geometry(
                n, cfg.lsb_digit_bits, cfg.v3_sort_rows)
            outs = _pipeline_lsb(planes, n=n, nkey=nkey,
                                 bits=cfg.lsb_digit_bits, key_bits=key_bits,
                                 pitch=pitch, ntiles=ntiles,
                                 arena_rows=arena_rows)
        timer.sync(outs[0])
    return outs[0], tuple(outs[1:])
