"""v5 engine on PyTorch: the in-place single-device MSD range sort of
``inplacemsdradixsort_tpu``'s ``ops/engine_v5.py``.

v4 keeps the input, two level arenas and the output alive at once; v5
partitions inside one working buffer W (the caller's planes, row-padded,
plus one block per range and a tile of slack), so its engine peak is
about (1 + ``v5_batch_frac``) x N:

1. SAMPLE + PLAN (host): the hybrid bounds (``plan_util._bounds_hybrid``)
   grouped into <= rmax L1 ranges of <= rmax sub-ranges (``_v5_plan``).
2. L1 HIST: exact per-(tile, range) counts (``kernels_v4.hist_level``),
   fetched; every block's slot is computed on the host from them
   (``_seqroute_tables``).
3. L1 SEQROUTE in place (``kernels_v5.seqroute_level``): each range's
   stream of full blocks goes to sequential W slots, its open block,
   padded, to a drain slot past them.
4. BLOCK PERMUTE in place (``kernels_v5.block_permute``) along the
   cycles of ``permute_cycles``: afterwards every L1 range is a
   block-contiguous region of W, its real tuples first, then pads.
5. L2 BATCHES: consecutive regions grouped so that their blocks fit a
   scratch arena S of about ``v5_batch_frac`` x N.  The L2 histogram of
   every batch is taken, and the overflow flag fetched, before any
   terminal write, so an overflow is seen while W still holds every
   element (lossless retry).  Then per batch: ``route_level`` W -> S, and
   ``engine_v4._finish`` sorts every final bucket into W at its exact
   global offset (writes trail reads: a batch's output never passes the
   start of its first region).
6. EXTRACTION: the first n elements of W's flat planes, a view (no copy).

Heavy single-value ranges (keys only) are not sorted: the terminal fills
them from their exact count.  On overflow W's regions are compacted
(``_compact``) and the sort retries with finer buckets, then goes to
``engine_v4._exhausted`` (the deep tier with payload).

Planes are int32 tensors of raw uint32 words, 1-4 of them (key, then
payload words), ordered lexicographically by (key, *vals).  The planners
are numpy and equal the reference's array for array on the same stats;
the sample comes from a ``torch.Generator`` and cannot equal
``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config import SortConfig
from ..utils.timing import PhaseTimer
from . import engine_v4
from . import kernels_v4 as kv4
from . import kernels_v5 as kv5
from .kernels_v4 import BIAS, CHUNK_ROWS, LANES
from .kernels_v5 import BLK, BLKROWS
from .plan_util import _bias_np, _bounds_hybrid, _ceil_div, _shape_class

U32_MAX = np.uint32(0xFFFFFFFF)
# the most elements a sort may hold: output offsets (``_batch_tables``'
# out_base, ``engine_v4._finish``'s cumsum, the terminal's tables) are int32
MAX_N = (1 << 31) - 1


def check_n(n: int) -> None:
    """Raise ``ValueError`` for n past ``MAX_N``."""
    if n > MAX_N:
        raise ValueError(f"{n} elements: the engines' int32 output offsets "
                         f"hold at most {MAX_N}")


def _qclass(x: int, steps: int = 4) -> int:
    """Coarse pow2-octave size class without _shape_class's 1024 floor."""
    if x <= 8:
        return 8
    e = math.floor(math.log2(x))
    step = max(1, (1 << e) // steps)
    return _ceil_div(x, step) * step


# ===================================================== permute cycles

def permute_cycles(src_of_final: np.ndarray):
    """The block permutation as cycles, for ``kernels_v5.block_permute``:
    the counterpart of the reference's ``permute_schedule``, which
    linearises the same cycles into a TPU DMA schedule (ring slots,
    semaphores, stage buffers) the port does not need.

    ``src_of_final[f]`` is the current slot of the block that must end at
    slot f.  Cycles are followed from their smallest slot, in the order
    the reference emits them; self-loops are skipped.  Returns (cyc_off
    (ncyc+1,), cyc_slots) int32 in CSR form: cycle c is
    cyc_slots[cyc_off[c]:cyc_off[c+1]] = [f0, src[f0], src[src[f0]], ...],
    and slot cyc[i] takes the block of slot cyc[i+1]."""
    src = np.asarray(src_of_final, np.int64)
    if not np.array_equal(np.sort(src), np.arange(len(src))):
        raise ValueError("src_of_final is not a permutation")
    visited = np.zeros(len(src), bool)
    off, slots = [0], []
    for f0 in range(len(src)):
        if visited[f0]:
            continue
        visited[f0] = True
        if src[f0] == f0:
            continue
        f = f0
        while True:
            visited[f] = True
            slots.append(f)
            f = int(src[f])
            if f == f0:
                break
        off.append(len(slots))
    return np.array(off, np.int32), np.array(slots, np.int32)


# ===================================================== geometry / plan

@dataclasses.dataclass(frozen=True)
class _GeomV5:
    n: int
    nplanes: int
    rmax: int
    pitch1: int
    sort_rows2: int
    pitch2: int
    cap_rows: int
    rows_in: int
    nblocks: int
    ntiles1: int
    w_rows: int
    ssz: int
    nbq: int
    nb_want: int


def _v5_geometry(n: int, nplanes: int, cfg: SortConfig,
                 nb_mult: float = 1.0) -> _GeomV5:
    cap_rows = cfg.v3_cap_rows
    if not cap_rows:
        cap_rows = 2048 if n >= (1 << 28) else 1024
        # beyond a 128-wide topology: double the terminal class rather
        # than overflow the plan
        while (cap_rows < 8192
               and _ceil_div(n, int(cap_rows * LANES * 0.80))
               * nb_mult * 1.4 > 128 * 128):
            cap_rows *= 2
    target = int(cap_rows * LANES * 0.80)
    nb_want = max(16, int(_ceil_div(n, target) * nb_mult))
    rmax = cfg.v3_rmax or next(
        (r for r in (32, 48, 64, 96, 128) if r * r >= nb_want * 1.4), 128)
    sort_rows2 = cfg.v3_sort_rows
    pitch2 = sort_rows2 - rmax
    kv4.check_level_width(rmax)
    pitch1 = cfg.v5_pitch_rows or 2048
    if (pitch1 * LANES) & (pitch1 * LANES - 1):
        raise ValueError(f"v5_pitch_rows={pitch1}: rows x 128 must be a "
                         "power of two")
    rows_in = _ceil_div(n, LANES)
    nblocks = _ceil_div(n, BLK)
    ntiles1 = _ceil_div(rows_in, pitch1)
    # slots for all full blocks + one padded drain block per range, plus
    # a tile of load-overshoot slack past the last region
    w_rows = ((nblocks + rmax) * BLKROWS
              + max(pitch1, pitch2) + CHUNK_ROWS)
    ssz = int(min(max(cfg.sample_rate * n, 4096), cfg.sample_cap))
    ssz = min(ssz, n)
    return _GeomV5(
        n=n, nplanes=nplanes, rmax=rmax, pitch1=pitch1,
        sort_rows2=sort_rows2, pitch2=pitch2, cap_rows=cap_rows,
        rows_in=rows_in, nblocks=nblocks, ntiles1=ntiles1, w_rows=w_rows,
        ssz=ssz, nbq=4 * nb_want, nb_want=nb_want,
    )


@dataclasses.dataclass
class _PlanV5:
    """Host-side bound tables (uint64-typed uint32 values, unbiased)."""
    ng: int
    l1_bounds_u: np.ndarray       # (rmax,)
    l2_bounds_u: np.ndarray       # (rmax, rmax)
    glen: np.ndarray              # (rmax,)
    heavy1: np.ndarray            # (rmax,) bool: fill-only region
    drop2: np.ndarray             # (rmax, rmax) int32


def _v5_plan(stats: np.ndarray, S: int, nplanes: int, cfg: SortConfig,
             nb_want: int, rmax: int) -> _PlanV5:
    keys_only = nplanes == 1
    bounds, is_heavy, _ = _bounds_hybrid(stats, S, nb_want, cfg)
    nb = len(bounds)
    if nb > rmax * rmax:
        raise ValueError(f"too many buckets {nb} for topology {rmax}")
    per = _ceil_div(nb, rmax)
    groups = [list(range(i, min(i + per, nb))) for i in range(0, nb, per)]
    ng = len(groups)
    l1_bounds_u = np.full(rmax, int(U32_MAX), np.uint64)
    l2_bounds_u = np.full((rmax, rmax), int(U32_MAX), np.uint64)
    glen = np.ones(rmax, np.int64)
    heavy1 = np.zeros(rmax, bool)
    drop2 = np.zeros((rmax, rmax), np.int32)
    for gi, g in enumerate(groups):
        l1_bounds_u[gi] = bounds[g[-1]]
        glen[gi] = len(g)
        for sj, j in enumerate(g):
            l2_bounds_u[gi, sj] = bounds[j]
        for sj in range(len(g), rmax):
            l2_bounds_u[gi, sj] = l2_bounds_u[gi, len(g) - 1]
        if keys_only and len(g) == 1 and bool(is_heavy[g[0]]):
            heavy1[gi] = True
        elif keys_only:
            for sj, j in enumerate(g):
                if is_heavy[j]:
                    drop2[gi, sj] = 1
    return _PlanV5(ng=ng, l1_bounds_u=l1_bounds_u, l2_bounds_u=l2_bounds_u,
                   glen=glen, heavy1=heavy1, drop2=drop2)


# ===================================================== host glue (L1)

def _seqroute_tables(h: np.ndarray, g: _GeomV5, plan: _PlanV5):
    """Exact seqroute tables, the final block layout and the permutation
    source, from the fetched (ntiles1, rmax) L1 histogram: per-(tile,
    range) stream bases, the flush-slot assignment (events in (tile,
    range) order claim sequential W slots), the drain slots past the
    full-block frontier, the region layout (nblk[d] = full blocks + 1
    padded drain) and src_of_final for the cycle permute
    (identity-preferring, with each drain block pinned last in its
    region: region d reads as cnt[d] real tuples, then pads)."""
    ntiles1, rmax = h.shape
    cnt = h.sum(0, dtype=np.int64)
    C = np.cumsum(h, 0, dtype=np.int64) - h
    ev = (C + h) // BLK - C // BLK
    flat = ev.reshape(-1)
    slot0 = (np.cumsum(flat) - flat).reshape(ev.shape)
    nfull = int(ev.sum())

    meta = np.zeros(((g.ntiles1 + 2) * 4,), np.int32)
    for t in range(ntiles1):
        meta[t * 4] = t * g.pitch1
        meta[t * 4 + 1] = min(g.n - t * g.pitch1 * LANES, g.pitch1 * LANES)
    meta[ntiles1 * 4 + 2] = 1          # drain tile

    cnt_tbl = np.concatenate(
        [h, np.zeros((1, rmax), np.int64)]).astype(np.int32)
    base_tbl = np.concatenate([C, cnt[None]]).astype(np.int32)
    slot_tbl = np.concatenate(
        [slot0, (nfull + np.arange(rmax))[None]]).astype(np.int32)
    padv_tbl = np.zeros_like(cnt_tbl)
    padv_tbl[-1] = _bias_np(plan.l1_bounds_u.astype(np.uint32))

    tt, dd = np.nonzero(ev)
    d_of_slot = np.concatenate(
        [np.repeat(dd, ev[tt, dd]), np.arange(rmax)])
    nblk = (cnt // BLK + 1).astype(np.int64)
    Fbase = np.concatenate([[0], np.cumsum(nblk)[:-1]]).astype(np.int64)
    F = int(nblk.sum())
    assert F == nfull + rmax
    order = np.argsort(d_of_slot, kind="stable")
    starts = np.concatenate(
        [[0], np.cumsum(np.bincount(d_of_slot, minlength=rmax))[:-1]])
    src = np.empty(F, np.int64)
    for d in range(rmax):
        fin_last = int(Fbase[d] + nblk[d] - 1)
        src[fin_last] = nfull + d
        cur = np.sort(order[starts[d]: starts[d] + nblk[d]])
        cur = cur[cur != nfull + d]
        fin = np.arange(Fbase[d], Fbase[d] + nblk[d] - 1)
        common = np.intersect1d(cur, fin)
        src[common] = common
        src[np.setdiff1d(fin, common)] = np.setdiff1d(cur, common)
    return (meta, cnt_tbl, base_tbl, slot_tbl, padv_tbl,
            cnt, nblk, Fbase, src)


# ===================================================== batches (L2)

@dataclasses.dataclass(frozen=True)
class _BatchGeom:
    nreg_cap: int
    t2cap: int
    s_rows: int
    nb_batch: int


def _plan_batches(g: _GeomV5, plan: _PlanV5, nblk: np.ndarray,
                  frac: float):
    """Greedy consecutive-region batching under the scratch budget."""
    ng, rmax = plan.ng, g.rmax
    route_blocks = [0 if plan.heavy1[gi] else int(nblk[gi])
                    for gi in range(ng)]
    total = sum(route_blocks)
    sblocks = _qclass(max(_ceil_div(max(total, 1),
                                    max(1, round(1.0 / frac))),
                          max(route_blocks) if route_blocks else 1, 1))
    batches = []
    cur, blocks = [], 0
    for gi in range(ng):
        if cur and blocks + route_blocks[gi] > sblocks:
            batches.append(cur)
            cur, blocks = [], 0
        cur.append(gi)
        blocks += route_blocks[gi]
    if cur:
        batches.append(cur)
    nreg_cap = min(_qclass(max(len(b) for b in batches)), rmax * rmax)
    t2cap = _qclass(
        _ceil_div(sblocks * BLKROWS, g.pitch2) + nreg_cap + 1)
    nb_batch = nreg_cap * rmax
    s_rows = _shape_class(
        sblocks * BLKROWS + t2cap * rmax + nb_batch * CHUNK_ROWS
        + 2 * g.cap_rows + CHUNK_ROWS
    )
    return batches, _BatchGeom(nreg_cap=nreg_cap, t2cap=t2cap,
                               s_rows=s_rows, nb_batch=nb_batch)


def _batch_tables(g: _GeomV5, plan: _PlanV5, bg: _BatchGeom, batch,
                  nblk: np.ndarray, Fbase: np.ndarray, cnt: np.ndarray,
                  out_base: int):
    rmax = g.rmax
    meta2 = np.zeros(((bg.t2cap + 1) * 3,), np.int32)
    parent2 = np.zeros((bg.t2cap,), np.int32)
    tbase = np.zeros((bg.nreg_cap,), np.int32)
    l2b = np.full((bg.nreg_cap, rmax), int(U32_MAX), np.uint64)
    pads_into = np.zeros((bg.nreg_cap, rmax), np.int32)
    drop2 = np.zeros((bg.nreg_cap, rmax), np.int32)
    term_valid = np.zeros((bg.nreg_cap, rmax), np.int32)
    term_mode = np.zeros((bg.nreg_cap, rmax), np.int32)
    term_fill_u = np.zeros((bg.nreg_cap, rmax), np.uint32)
    heavy_mask = np.zeros((bg.nreg_cap, rmax), np.int32)
    heavy_real = np.zeros((bg.nreg_cap, rmax), np.int32)
    ti = 0
    for li, gi in enumerate(batch):
        l2b[li] = plan.l2_bounds_u[gi]
        gl = int(plan.glen[gi])
        tbase[li] = ti
        if plan.heavy1[gi]:
            term_valid[li, 0] = 1
            term_mode[li, 0] = 1
            term_fill_u[li, 0] = plan.l1_bounds_u[gi]
            heavy_mask[li, 0] = 1
            heavy_real[li, 0] = int(cnt[gi])
            continue
        pads_into[li, gl - 1] = int(nblk[gi] * BLK - cnt[gi])
        for sj in range(gl):
            term_valid[li, sj] = 1
            if plan.drop2[gi, sj]:
                term_mode[li, sj] = 1
                term_fill_u[li, sj] = plan.l2_bounds_u[gi, sj]
                drop2[li, sj] = 1
        region_rows = int(nblk[gi]) * BLKROWS
        nt = _ceil_div(region_rows, g.pitch2)
        for j in range(nt):
            meta2[ti * 3 + 0] = li
            meta2[ti * 3 + 1] = int(Fbase[gi]) * BLKROWS + j * g.pitch2
            meta2[ti * 3 + 2] = min(
                region_rows * LANES - j * g.pitch2 * LANES,
                g.pitch2 * LANES)
            parent2[ti] = li
            ti += 1
    assert ti <= bg.t2cap, (ti, bg.t2cap)
    return dict(
        meta2=meta2,
        parent2=parent2,
        tbase=tbase,
        l2b=_bias_np(l2b.reshape(-1).astype(np.uint32)),
        pads_into=pads_into.reshape(-1),
        drop2=drop2.reshape(-1),
        term_valid=term_valid.reshape(-1),
        term_mode=term_mode.reshape(-1),
        term_fill=_bias_np(term_fill_u.reshape(-1)),
        heavy_mask=heavy_mask.reshape(-1),
        heavy_real=heavy_real.reshape(-1),
        out_base=np.int32(out_base),
    )


def v5_bytes(n: int, nplanes: int, cfg: SortConfig) -> int:
    """Device bytes v5's engine holds at its peak for n elements of
    ``nplanes`` planes, before the plan is known: W, the scratch arena S
    of one batch (``_plan_batches``' formula with the batch budget of
    ``v5_batch_frac`` x W, or twice a mean region where that is larger,
    and rmax x frac + 1 regions a batch) and the terminal's global
    scratch (at most the batch's blocks)."""
    g = _v5_geometry(n, nplanes, cfg)
    blocks = g.nblocks + g.rmax
    sblocks = _qclass(max(
        _ceil_div(blocks, max(1, round(1.0 / cfg.v5_batch_frac))),
        2 * _ceil_div(blocks, g.rmax), 1))
    nreg = math.ceil(g.rmax * cfg.v5_batch_frac) + 1
    t2cap = _ceil_div(sblocks * BLKROWS, g.pitch2) + nreg + 1
    s_rows = (sblocks * BLKROWS + t2cap * g.rmax
              + nreg * g.rmax * CHUNK_ROWS + 2 * g.cap_rows + CHUNK_ROWS)
    return 4 * nplanes * LANES * (g.w_rows + s_rows + sblocks * BLKROWS)


# ===================================================== device steps

def _table(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)


def _put(w, planes, row0: int) -> None:
    """Copy one chunk's planes into W from row ``row0``."""
    e0 = row0 * LANES
    for wp, p in zip(w, planes):
        wp.view(-1)[e0:e0 + p.shape[0]] = p


def _hist2(w, tbl, g: _GeomV5, bg: _BatchGeom):
    """Non-destructive L2 precheck of one batch: exact histogram over its
    regions and the terminal-capacity overflow flag."""
    rmax = g.rmax
    hist2 = kv4.hist_level(w[0], tbl["meta2"], tbl["l2b"], bg.t2cap,
                           g.pitch2, rmax, bias_input=False)
    g2, keep2 = _l2_children(tbl, rmax)
    rrows2 = (hist2 + ((-hist2) % LANES)) // LANES
    rows_c2 = torch.zeros(bg.nb_batch, dtype=torch.int32,
                          device=hist2.device).index_add_(
        0, g2.reshape(-1), (rrows2 * keep2).reshape(-1))
    over = ((tbl["term_valid"] != 0) & (tbl["term_mode"] == 0)
            & (rows_c2 > 2 * g.cap_rows)).any().to(torch.int32)
    return hist2, over


def _l2_children(tbl, rmax):
    """(g2 (t2cap, rmax): the batch child of every (tile, range); keep2:
    0 for a dropped heavy child)."""
    parent2 = tbl["parent2"].long()
    ar = torch.arange(rmax, device=parent2.device)
    g2 = parent2[:, None] * rmax + ar[None, :]
    keep2 = 1 - tbl["drop2"][g2.reshape(-1)].reshape(g2.shape)
    return g2, keep2


def _batch(w, hist2, tbl, g: _GeomV5, bg: _BatchGeom, nclasses: int):
    """One L2 batch: route its regions W -> S, then the terminal sorts or
    fills every final bucket into W at its global offset."""
    rmax = g.rmax
    nchild = bg.nb_batch
    dev = hist2.device
    g2, keep2 = _l2_children(tbl, rmax)
    g2f = g2.reshape(-1)
    cnt2 = torch.zeros(nchild, dtype=torch.int32, device=dev).index_add_(
        0, g2f, hist2.reshape(-1))
    real2 = cnt2 - tbl["pads_into"]
    rrows2 = (hist2 + ((-hist2) % LANES)) // LANES
    stored2 = rrows2 * keep2
    rows_c2 = torch.zeros(nchild, dtype=torch.int32, device=dev).index_add_(
        0, g2f, stored2.reshape(-1))
    alloc2 = rows_c2 + CHUNK_ROWS
    start2 = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                        torch.cumsum(alloc2, 0, dtype=torch.int32)[:-1]])
    excl2 = torch.cumsum(stored2, 0, dtype=torch.int32) - stored2
    base2 = excl2[tbl["tbase"].long()[tbl["parent2"].long()]]
    dst2 = torch.where(keep2 != 0,
                       start2[g2f].reshape(g2.shape) + excl2 - base2,
                       -1).to(torch.int32)
    padv2 = tbl["l2b"][g2f].reshape(g2.shape).contiguous()
    s_planes = kv4.route_level(w, tbl["meta2"], tbl["l2b"], hist2, dst2,
                               padv2, bg.s_rows, bg.t2cap, g.pitch2, rmax,
                               bias_input=False)
    reals_t = torch.where(tbl["heavy_mask"] != 0, tbl["heavy_real"], real2)
    occ_t = torch.where(tbl["term_mode"] == 0, rows_c2, 0)
    engine_v4._finish(s_planes, reals_t, occ_t, start2, tbl["term_mode"],
                      tbl["term_fill"], tbl["term_valid"] != 0, g.n,
                      g.cap_rows, nclasses, out_base=tbl["out_base"],
                      outs0=w, slice_n=False)


def _compact(w, spans):
    """Lossless retry: the element multiset of the post-L1 W (region d =
    cnt[d] real tuples, then pads), unbiased into fresh planes.
    ``spans`` = ((start element, length), ...)."""
    return tuple(torch.cat([p.view(-1)[s:s + ln] for s, ln in spans]) ^ BIAS
                 for p in w)


# ===================================================== sort_v5

def _check_planes(planes) -> None:
    if not 1 <= len(planes) <= kv4.MAX_PLANES:
        raise ValueError(f"1-{kv4.MAX_PLANES} planes, got {len(planes)}")
    n, dev = planes[0].shape[0], planes[0].device
    for p in planes:
        if p.dtype != torch.int32 or p.dim() != 1 or p.device != dev:
            raise TypeError(
                "sort_v5 takes 1-D int32 tensors of raw uint32 words on one "
                f"device, got {p.dtype} {tuple(p.shape)} on {p.device}")
        if p.shape[0] != n:
            raise ValueError(f"planes of {p.shape[0]} and {n} elements")


def sort_v5(keys: torch.Tensor, vals=(), cfg: Optional[SortConfig] = None,
            timer: Optional[PhaseTimer] = None, _nb_mult: float = 1.0,
            _depth: int = 0):
    """Sort raw uint32 words held in 1-D int32 tensors as unsigned, with
    0-3 payload planes ``vals``, in place on one device: the engine's
    peak is about (1 + ``v5_batch_frac``) x the planes' bytes beside them.

    The order is lexicographic by (key, *vals), as ``sort_v4``'s.  The
    inputs are not consumed.  Below ``min_engine_n`` (2^22 by default)
    the sort goes to ``sort_v4``.  Returns (sorted keys, tuple of sorted
    vals): views of W's first n elements."""
    planes = (keys,) + tuple(vals)
    _check_planes(planes)
    cfg = cfg or SortConfig()
    timer = timer or PhaseTimer(enabled=False)
    n = int(keys.shape[0])
    thr = cfg.min_engine_n if cfg.min_engine_n is not None else (1 << 22)
    if n < thr and _depth == 0:
        return engine_v4.sort_v4(keys, tuple(vals), cfg, timer)
    return _sort_v5_core(lambda i: planes, 1, cfg, timer, _nb_mult, _depth,
                         n, len(planes))


def sort_v5_from_chunks(chunk_fn, nchunks: int, n: int,
                        cfg: Optional[SortConfig] = None,
                        timer: Optional[PhaseTimer] = None,
                        raw: bool = False):
    """In-place sort of n elements delivered as ``nchunks`` plane tuples
    by ``chunk_fn(i)``: W is assembled chunk by chunk, so the caller
    need never hold the whole input beside W.  Every chunk but the last
    must hold a multiple of 128 elements.

    ``raw=True`` returns W's planes themselves, (w_rows, 128) int32 raw
    uint32 words whose row-major first n elements are the result and
    whose slack past n is junk: no copy.  Check it slab by slab with
    ``utils.checking.raw_check_2d``.  The default returns views of W's
    first n elements, which costs no copy either (unlike the reference's
    XLA extraction)."""
    cfg = cfg or SortConfig()
    timer = timer or PhaseTimer(enabled=False)
    first = chunk_fn(0)
    _check_planes(tuple(first))
    return _sort_v5_core(chunk_fn, nchunks, cfg, timer, 1.0, 0, n,
                         len(first), raw=raw)


def _sort_v5_core(chunk_fn, nchunks, cfg, timer, nb_mult, depth, n,
                  nplanes, raw=False):
    check_n(n)
    g = _v5_geometry(n, nplanes, cfg, nb_mult)
    rmax = g.rmax

    with timer.phase("part_first"):
        row0 = 0
        for i in range(nchunks):
            planes_i = tuple(chunk_fn(i))
            if len(planes_i) != nplanes:
                raise ValueError(f"chunk {i}: {len(planes_i)} planes, "
                                 f"expected {nplanes}")
            if i == 0:
                dev = planes_i[0].device
                w = tuple(torch.zeros((g.w_rows, LANES), dtype=torch.int32,
                                      device=dev) for _ in range(nplanes))
            celems = int(planes_i[0].shape[0])
            if i < nchunks - 1 and celems % LANES:
                raise ValueError(f"chunk {i}: {celems} elements, not a "
                                 f"multiple of {LANES}")
            if row0 * LANES + celems > n:
                raise ValueError(f"chunks hold more than n={n} elements")
            _put(w, planes_i, row0)
            row0 += _ceil_div(celems, LANES)
        del planes_i

    with timer.phase("sample"):
        stats = engine_v4._sample_stats(
            w[0].view(-1)[:n], ssz=g.ssz, nbq=g.nbq, salt=depth
        ).cpu().numpy()
        rows = max(n // LANES, 1)
        neff = max(1, min(g.ssz, rows))
        S = min(n, g.ssz) if (rows <= 1 or neff >= rows) else neff
        try:
            plan = _v5_plan(stats, S, nplanes, cfg, g.nb_want, rmax)
        except ValueError:
            engine_v4.FALLBACK_STATS["plan"] += 1
            planes = tuple(p.view(-1)[:n] for p in w)
            return engine_v4._torch_fallback(planes[0], planes[1:])

    with timer.phase("part_first"):
        l1b = _table(_bias_np(plan.l1_bounds_u.astype(np.uint32)), dev)
        meta1 = np.zeros((g.ntiles1 + 1, 3), np.int64)
        t = np.arange(g.ntiles1, dtype=np.int64)
        meta1[:-1, 1] = t * g.pitch1
        meta1[:-1, 2] = np.minimum(n - t * g.pitch1 * LANES,
                                   g.pitch1 * LANES)
        hist1 = kv4.hist_level(w[0], _table(meta1.reshape(-1), dev), l1b,
                               g.ntiles1,
                               g.pitch1, rmax, bias_input=True)
        h = hist1.cpu().numpy().astype(np.int64)

    (meta5, cnt_tbl, base_tbl, slot_tbl, padv_tbl, cnt, nblk, Fbase,
     src) = _seqroute_tables(h, g, plan)
    cyc_off, cyc_slots = permute_cycles(src)
    batches, bg = _plan_batches(g, plan, nblk, cfg.v5_batch_frac)

    with timer.phase("part_blocks"):
        kv5.seqroute_level(
            w, _table(meta5, dev), _table(cnt_tbl, dev),
            _table(base_tbl, dev), _table(slot_tbl, dev),
            _table(padv_tbl, dev), g.ntiles1 + 1, g.pitch1, rmax,
            nlex=nplanes - 1, bias_input=True)
        kv5.block_permute(w, _table(cyc_off, dev), _table(cyc_slots, dev))
        timer.sync(w[0])

    with timer.phase("local_sort"):
        # the precheck of every batch, then one flag fetch, before any
        # terminal write: an overflow is seen while W holds every element
        tbls, hist2s, overs = [], [], []
        out_base = 0
        for batch in batches:
            tbl = {k: _table(v, dev) for k, v in _batch_tables(
                g, plan, bg, batch, nblk, Fbase, cnt, out_base).items()}
            tbl["out_base"] = out_base
            h2, ov = _hist2(w, tbl, g, bg)
            tbls.append(tbl)
            hist2s.append(h2)
            overs.append(ov)
            out_base += int(sum(int(cnt[gi]) for gi in batch))
        over = int(torch.stack(overs).max().item()) if overs else 0

        if over:
            spans = tuple((int(Fbase[d]) * BLK, int(cnt[d]))
                          for d in range(plan.ng) if int(cnt[d]) > 0)
            planes2 = _compact(w, spans)
            del w, tbls, hist2s
            if depth < 2:
                engine_v4.FALLBACK_STATS["retry"] += 1
                return _sort_v5_core(lambda i: planes2, 1, cfg, timer,
                                     nb_mult * 2.0, depth + 1, n, nplanes)
            # plane-0 refinement exhausted: multi-plane inputs recurse
            # into the lower planes (the deep tier), keys only fall back
            return engine_v4._exhausted(planes2[0], planes2[1:], cfg, timer,
                                        0)

        for h2, tbl in zip(hist2s, tbls):
            _batch(w, h2, tbl, g, bg, cfg.term_classes)
        final = w if raw else tuple(p.view(-1)[:n] for p in w)
        if final[0].is_cuda:
            torch.cuda.synchronize(final[0].device)
    return final[0], tuple(final[1:])
