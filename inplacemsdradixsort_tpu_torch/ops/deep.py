"""Deep-key recursion into lower key planes (``inplacemsdradixsort_tpu``'s
``ops/deep.py`` on PyTorch).

The v4 engine bounds every final bucket by 32-bit plane-0 bounds, so
multi-plane inputs whose buckets no plane-0 refinement can shrink — u64
keys with few distinct hi words, or a heavy key value in pairs mode
(payload must ride, so the keys-only value fill cannot apply) — exhaust
the retry ladder.  ``deep_sort`` is the recursion tier the reference
plans over the full remaining key width (``schedule_passes``,
msb_64.c:1334-1400, and the ``local_radixsort`` recursion,
:1007-1035), built from the level kernels:

1. sample plane 0, duplicate-aware equal-depth bounds with heavy values
   isolated as single-value buckets (``extract_delimiters`` + the v-1
   shift, msb_64.c:1304-1322): ONE partition level, <= rmax wide;
2. ``hist_level`` exact counts (one small fetch to the host) ->
   ``route_level`` of every plane into a packed arena -> ``splice_runs``
   back to a dense element-exact layout in which every bucket occupies a
   host-known contiguous span (the ``inject`` role, msb_64.c:1278-1302);
3. per bucket: a single-value bucket drops its constant plane and
   re-enters the engine keyed by the NEXT plane (a u64 hi-word bucket
   sorts by lo, a heavy pairs bucket by rid); a mixed bucket re-enters
   the engine whole (strictly smaller n).  Slices are padded to coarse
   size classes with +inf tuples, which sort to the tail and are cut.

Progress is guaranteed: a non-heavy bucket carries ~1/32 of the mass and
a heavy bucket loses a plane; ``MAX_DEEP_DEPTH`` caps pathological sample
noise with a bucket-local ``torch.sort``, counted in
``FALLBACK_STATS["deep_local"]`` (never whole-array).

Two departures from the reference, both faults there (ROADMAP A7, C):
the (bucket, tile) splice table is an ordinary device tensor, so the
TPU's scalar-prefetch budget (``NRUNS_MAX``) does not exist here; and
``_deep_bounds`` never asserts — when heavy and isolation bounds exceed
the level width, it drops the isolation bounds of the lightest heavy
values, whose buckets then re-enter the engine as mixed buckets.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import SortConfig
from ..utils.timing import PhaseTimer
from . import kernels_v4 as kv4
from .kernels_v4 import CHUNK_ROWS, LANES, SENT
from .plan_util import _bias_np, _ceil_div, _quantile_bounds, _shape_class

RMAX = 96                 # one wide level (sort_rows // 2 for tiny tiles)
NBQ = 256                 # quantile candidates (4x the ~32 bucket target)
MAX_DEEP_DEPTH = 3


def _deep_geometry(sort_rows: int):
    """(sort_rows, rmax) of the one-wide deep level: the engine's tile,
    and a level width that keeps the tile's pitch positive.  (The
    reference grows the tile and sheds width with n to fit the TPU's
    scalar-prefetch budget for the splice table; the card has none.)"""
    return sort_rows, min(RMAX, sort_rows // 2)


def _deep_bounds(stats: np.ndarray, S: int, rmax: int):
    """<= rmax inclusive upper bounds (uint32) with heavy plane-0 values
    isolated as single-value buckets; returns (bounds, single).

    When the set is wider than rmax, bounds are kept in this order: the
    last (0xFFFFFFFF), every heavy value's bound (heaviest first), the
    isolation bound before each heavy value (heaviest first), other
    single-value bounds, then free bounds thinned evenly.  So every heavy
    bound survives while it fits, and a heavy value that loses its
    isolation bound becomes part of a mixed bucket that re-enters the
    engine.  (The reference asserts instead, ``deep.py:101``.)"""
    heavy_frac = max(1.0 / 32, 12.0 / max(S, 1))
    bounds, est, is_heavy = _quantile_bounds(
        stats[0].view(np.uint32), stats[1], stats[2], S, heavy_frac,
        cap_frac=1.0 / 32,
    )
    if len(bounds) > rmax:
        b64 = bounds.astype(np.int64)
        lo = np.concatenate([[-1], b64[:-1]])
        iso = np.concatenate([is_heavy[1:], [False]])  # bound before heavy
        single = b64 == lo + 1
        nb = len(bounds)
        # priority classes (lower first), ties broken by heavier mass
        mass = np.where(iso, np.concatenate([est[1:], [0.0]]), est)
        cls = np.full(nb, 4)
        cls[single] = 3
        cls[iso] = 2
        cls[is_heavy] = 1
        cls[-1] = 0
        ranked = np.lexsort((-mass, cls))
        essential = ranked[cls[ranked] < 4][:rmax]
        keep = np.zeros(nb, bool)
        keep[essential] = True
        free = np.flatnonzero(~keep)
        room = rmax - int(keep.sum())
        if room > 0 and len(free):
            step = _ceil_div(len(free), room)
            keep[free[step - 1::step][:room]] = True
        bounds = bounds[keep]
    lo = np.concatenate([[-1], bounds[:-1].astype(np.int64)])
    single = bounds.astype(np.int64) == lo + 1
    return bounds, single


def _pad_to_class(planes, cnt: int):
    """Pad every plane to a coarse size class with +inf tuples (raw
    0xFFFFFFFF on every plane).  Pads tie-or-exceed every real tuple, so
    they sort to the tail and the caller cuts [:cnt]."""
    m = _shape_class(max(cnt, LANES))
    if m == cnt:
        return planes
    tail = torch.full((m - cnt,), -1, dtype=torch.int32,
                      device=planes[0].device)
    return tuple(torch.cat([p, tail]) for p in planes)


def deep_sort(keys: torch.Tensor, vals, cfg: Optional[SortConfig] = None,
              timer: Optional[PhaseTimer] = None, deep_depth: int = 0):
    """Sort (key, *vals) lexicographically when plane-0 refinement is
    exhausted (see the module docstring).  Same contract as
    ``engine_v4.sort_v4``: raw uint32 words in 1-D int32 tensors; returns
    (keys, vals)."""
    from . import engine_v4

    cfg = cfg or SortConfig()
    timer = timer or PhaseTimer(enabled=False)
    n = int(keys.shape[0])
    planes = (keys,) + tuple(vals)
    nplanes = len(planes)
    if nplanes == 1 or n <= LANES or deep_depth >= MAX_DEEP_DEPTH:
        engine_v4.FALLBACK_STATS["deep_local"] += 1
        return engine_v4._torch_fallback(keys, vals)
    engine_v4.FALLBACK_STATS["deep"] += 1
    dev = keys.device

    sort_rows, rmax = _deep_geometry(cfg.v3_sort_rows)
    with timer.phase("sample"):
        ssz = int(min(max(cfg.sample_rate * n, 4096), cfg.sample_cap, n))
        stats = engine_v4._sample_stats(
            keys, ssz=ssz, nbq=NBQ, salt=16 + deep_depth).cpu().numpy()
        rows = max(n // LANES, 1)
        neff = max(1, min(ssz, rows))
        S = min(n, ssz) if (rows <= 1 or neff >= rows) else neff
        bounds, single = _deep_bounds(stats, S, rmax)
        nb = len(bounds)
        bounds_np = np.full((rmax,), SENT, np.int32)
        bounds_np[:nb] = _bias_np(bounds)
        bounds_b = torch.from_numpy(bounds_np).to(dev)

    # one exact partition level + dense regrouping
    with timer.phase("part_blocks"):
        pitch = sort_rows - rmax
        rows_in = _ceil_div(n, LANES)
        ntiles = _ceil_div(rows_in, pitch)
        arena_rows = _shape_class(
            rows_in + ntiles * rmax + rmax * CHUNK_ROWS
            + max(pitch, CHUNK_ROWS) + CHUNK_ROWS)
        t = np.arange(ntiles, dtype=np.int64)
        meta_np = np.zeros((ntiles + 1, 3), np.int32)
        meta_np[:-1, 1] = t * pitch
        meta_np[:-1, 2] = np.minimum(n - t * pitch * LANES, pitch * LANES)
        meta = torch.from_numpy(meta_np.reshape(-1)).to(dev)
        hist = kv4.hist_level(keys, meta, bounds_b, ntiles, pitch, rmax,
                              bias_input=True)
        h = hist.cpu().numpy().astype(np.int64)
        assert int(h.sum()) == n, (int(h.sum()), n)

        # host tables: packed arena destinations + (bucket, tile) splice
        rrows = (h + ((-h) % LANES)) // LANES
        rows_c = rrows.sum(0)
        start = np.concatenate([[0], np.cumsum(rows_c + CHUNK_ROWS)[:-1]])
        dst = (start[None, :] + np.cumsum(rrows, 0) - rrows).astype(np.int32)
        real = h.T.reshape(-1)
        z = np.zeros_like(real)
        btbl = np.stack([dst.T.reshape(-1), rrows.T.reshape(-1), real, z, z,
                         np.cumsum(real) - real, z, z], 1).astype(np.int32)
        padv = bounds_b[None, :].expand(ntiles, rmax).contiguous()
        arena = kv4.route_level(
            planes, meta, bounds_b, hist, torch.from_numpy(dst).to(dev),
            padv, arena_rows, ntiles, pitch, rmax, bias_input=True)
        dense = kv4.splice_runs(arena, torch.from_numpy(btbl).to(dev), n,
                                max_occ=pitch, unbias_output=True)
        del arena

    # per-bucket recursion at host-known offsets
    with timer.phase("local_sort"):
        cnt = h.sum(0)
        off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        out_parts = [[] for _ in range(nplanes)]
        for b in range(nb):
            c = int(cnt[b])
            if c == 0:
                continue
            o = int(off[b])
            sl = tuple(p[o: o + c] for p in dense)
            if c <= LANES:
                engine_v4.FALLBACK_STATS["deep_local"] += 1
                sk, sv = engine_v4._torch_fallback(sl[0], sl[1:])
                parts = (sk,) + sv
            elif single[b]:
                # single plane-0 value: recurse keyed by the next plane
                sk, sv = _engine_entry(_pad_to_class(sl[1:], c), cfg, timer,
                                       deep_depth)
                parts = (sl[0], sk[:c]) + tuple(v[:c] for v in sv)
            else:
                sk, sv = _engine_entry(_pad_to_class(sl, c), cfg, timer,
                                       deep_depth)
                parts = (sk[:c],) + tuple(v[:c] for v in sv)
            for p in range(nplanes):
                out_parts[p].append(parts[p])
        outs = tuple(torch.cat(parts) for parts in out_parts)
        timer.sync(outs[0])
    if outs[0].is_cuda:
        torch.cuda.synchronize(dev)
    return outs[0], tuple(outs[1:])


def _engine_entry(planes, cfg, timer, deep_depth):
    """Bucket re-entry: the ordinary engine ladder, whose own exhausted
    retries recurse back into deep_sort one level deeper."""
    from . import engine_v4
    return engine_v4.sort_v4(planes[0], planes[1:], cfg, timer,
                             _deep_depth=deep_depth + 1)
