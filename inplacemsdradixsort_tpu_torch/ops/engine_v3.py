"""v3 engine on PyTorch: sample-planned, device-resident MSD range sort —
``inplacemsdradixsort_tpu``'s ``ops/engine_v3.py``.

Pipeline (as the reference's):

1. SAMPLE (device) + PLAN (host), one round trip: a random element
   sample gives quantile stats (``engine_v4._sample_stats``); the host
   derives duplicate-aware equal-depth final-bucket bounds with
   heavy-value isolation, a two-level grouping (L1 ranges x L2
   sub-ranges), per-child capacities with ``fudge`` slack and every tile
   and terminal table (``make_plan``), packed into one upload
   (``_pack_tables``).
2. L1 and L2 ``partition_level``: every tile's ranges, padded to whole
   rows with phantom pads, land at their children's cursors.
3. The glue: L2 counted the L1 pads as data, so ``real2 - pads1`` is the
   exact real count of every child; output offsets are the cumulative
   real counts.
4. TERMINAL (``terminal_sort_write``): each final bucket sorted, trimmed
   to its real count and written at its exact output offset, or
   value-filled (a heavy key, keys only).

Capacities are estimates from the sample: the kernels flag an overflow
and ``sort_v3`` retries with fudge x 1.6, twice at most, then falls back
to ``torch.sort``, as it does on a planner ``ValueError`` and below 2^16
keys (the reference's fixed threshold; ``min_engine_n`` is not read).

Keys and rids are raw uint32 words; the engine biases the key plane in
the first kernel, the rids in the glue, and unbiases both in the last.
Pairs order lexicographically by (key, rid): a stable key sort when the
rids are the indices, a full uint64 sort when (key, rid) are the (hi, lo)
words.
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
from . import kernels_v3 as kv3
from .kernels_v3 import BIAS, CHUNK_ROWS, LANES
from .plan_util import U32_MAX, _bias_np, _ceil_div, _quantile_bounds, \
    _shape_class

SMALL_N = 1 << 16      # below this, torch.sort (``engine_v3.py:568``)


# ============================================================== plan

@dataclasses.dataclass
class _Plan:
    """Host-side static structure of one sort (the reference's fields)."""
    n: int
    pairs: bool
    # topology
    nparents: int            # padded L1 range count (static class)
    rmax: int                # ranges per parent at both levels
    pitch: int               # tile data rows (sort_rows - rmax)
    sort_rows: int
    cap_rows: int            # terminal bucket capacity (rows)
    one_level: bool
    # level 1
    l1_bounds: np.ndarray    # (1, rmax) biased
    arena1_rows: int
    l1_dst_start: np.ndarray  # (nparents,)
    l1_dst_cap: np.ndarray
    l1_tiles: np.ndarray      # (ntiles1, 4)
    # level 2
    l2_bounds: np.ndarray     # (nparents, rmax) biased
    arena2_rows: int
    l2_dst_start: np.ndarray  # (nchild,)
    l2_dst_cap: np.ndarray
    l2_tiles: np.ndarray      # (ntiles2, 4): parent, src_row, local_off
    # terminal
    term_src_row: np.ndarray  # (nb,) bucket start row in the L2 arena
    term_child: np.ndarray    # (nb,) child of the bucket; -1-g: group g
    term_mode: np.ndarray     # (nb,) 0 sort / 1 value fill
    term_fill: np.ndarray     # (nb,) raw uint32 fill value
    term_valid: np.ndarray    # (nb,) False for grid-padding entries
    group_len: np.ndarray     # (nparents,) sub-ranges per L1 group
    out_rows: int


def _plan_geometry(n: int, pairs: bool, fudge: float, cfg: SortConfig):
    """(terminal capacity rows, wanted final buckets)."""
    if cfg.v3_cap_rows:
        cap_rows = cfg.v3_cap_rows
    else:
        cap_rows = 1024 if not pairs else 512
        if n >= (1 << 28):
            cap_rows *= 2        # keep the bucket count in topology range
    target = int(cap_rows * LANES * 0.60 / fudge)
    return cap_rows, max(1, _ceil_div(n, target))


def make_plan(n: int, stats: np.ndarray, S: int, pairs: bool,
              cfg: SortConfig, fudge: Optional[float] = None) -> _Plan:
    """Every static table of one sort from the (3, nbq) quantile stats of
    a sample of size S (``engine_v3.py:224-399``).  Raises ``ValueError``
    when the buckets exceed the (rmax x rmax) topology."""
    fudge = fudge if fudge is not None else max(cfg.fudge, 1.2)
    cap_rows, nb_want = _plan_geometry(n, pairs, fudge, cfg)

    heavy_frac = max(0.3 / nb_want, 0.002)
    bounds, est, is_heavy = _quantile_bounds(
        stats[0].view(np.uint32), stats[1], stats[2], S, heavy_frac,
        cap_frac=1.0 / nb_want)
    nb = len(bounds)
    rmax = cfg.v3_rmax or (
        32 if nb <= 1024 else (48 if nb <= 2304 else (
            64 if nb <= 4096 else 96)))
    nparents = rmax                                 # square topology
    sort_rows = cfg.v3_sort_rows
    pitch = sort_rows - rmax
    if pitch <= 0:
        raise ValueError(f"v3_sort_rows={sort_rows} must exceed rmax={rmax}")

    # ---- consecutive final buckets grouped into L1 ranges, evenly
    if nb > nparents * rmax:
        raise ValueError(f"too many buckets {nb} for topology")
    per = _ceil_div(nb, nparents)
    groups = [list(range(i, min(i + per, nb))) for i in range(0, nb, per)]
    ng = len(groups)
    ntiles1 = _ceil_div(_ceil_div(n, LANES), pitch)

    def rows_for(frac: float, ntiles_feeding: int) -> int:
        """Usable capacity in rows: estimate x fudge + 4-sigma sampling
        slack + phantom growth (one row a feeding tile)."""
        est_elems = frac * n * fudge
        est_elems += 4.0 * n * math.sqrt(max(frac, 1e-12) / max(S, 1))
        return int(_ceil_div(int(est_elems), LANES) + ntiles_feeding)

    group_est = np.array([sum(est[j] for j in g) for g in groups])
    group_heavy_drop = [(not pairs) and len(g) == 1 and bool(is_heavy[g[0]])
                        for g in groups]

    l1_cap = np.zeros(nparents, np.int64)
    for gi, g in enumerate(groups):
        l1_cap[gi] = 0 if group_heavy_drop[gi] else rows_for(
            group_est[gi], ntiles1)
    l1_alloc = np.where(l1_cap > 0, l1_cap + CHUNK_ROWS, 0)
    l1_start = np.zeros(nparents, np.int64)
    l1_start[1:] = np.cumsum(l1_alloc)[:-1]
    arena1_rows = _shape_class(int(np.cumsum(l1_alloc)[-1]) + pitch + 1)

    l1_bounds_u = np.full(rmax, U32_MAX, np.uint64)
    for gi, g in enumerate(groups):
        l1_bounds_u[gi] = bounds[g[-1]]
    l1_bounds = _bias_np(l1_bounds_u.astype(np.uint32)).reshape(1, rmax)

    l1_tiles = np.zeros((max(ntiles1, 1), 4), np.int32)
    for t in range(ntiles1):
        l1_tiles[t] = (0, t * pitch, t * pitch * LANES, 0)

    # ---- level 2
    nchild = nparents * rmax
    l2_bounds_u = np.full((nparents, rmax), U32_MAX, np.uint64)
    l2_cap = np.zeros(nchild, np.int64)
    term_child, term_mode, term_fill = [], [], []
    for gi, g in enumerate(groups):
        if group_heavy_drop[gi]:
            # dropped at L1: the terminal value-fills it, no child storage
            l2_bounds_u[gi, :] = bounds[g[0]]   # pad values stay in range
            term_child.append(-1 - gi)          # real count from L1
            term_mode.append(1)
            term_fill.append(int(bounds[g[0]]))
            continue
        ntiles_g = _ceil_div(int(l1_cap[gi]), pitch)
        for sj, j in enumerate(g):
            c = gi * rmax + sj
            l2_bounds_u[gi, sj] = bounds[j]
            if (not pairs) and is_heavy[j] and len(g) > 1:
                l2_cap[c] = 0
                term_child.append(c)
                term_mode.append(1)
                term_fill.append(int(bounds[j]))
            else:
                # + the inflow of L1 pads cycled over the group's children
                inflow = _ceil_div(ntiles1, max(len(g), 1)) + 4
                l2_cap[c] = min(rows_for(float(est[j]), ntiles_g) + inflow,
                                cap_rows)
                term_child.append(c)
                term_mode.append(0)
                term_fill.append(0)
        # trailing empty ranges keep the group's last bound (count 0)
        for sj in range(len(g), rmax):
            l2_bounds_u[gi, sj] = l2_bounds_u[gi, len(g) - 1]

    l2_alloc = np.where(l2_cap > 0, l2_cap + CHUNK_ROWS, 0)
    l2_start = np.zeros(nchild, np.int64)
    l2_start[1:] = np.cumsum(l2_alloc)[:-1]
    arena2_rows = _shape_class(int(np.cumsum(l2_alloc)[-1]) + cap_rows + 1)
    l2_bounds = _bias_np(
        l2_bounds_u.reshape(-1).astype(np.uint32)).reshape(nparents, rmax)

    l2_tiles_list = []
    for gi in range(ng):
        for t in range(_ceil_div(int(l1_cap[gi]), pitch)):
            l2_tiles_list.append(
                (gi, int(l1_start[gi]) + t * pitch, t * pitch * LANES, 0))
    # the tile grid padded to a size class with dead tiles (local offset
    # past any fill: no elements)
    nt2 = _shape_class(max(len(l2_tiles_list), 1))
    l2_tiles_list += [(0, 0, 1 << 30, 0)] * (nt2 - len(l2_tiles_list))
    l2_tiles = np.array(l2_tiles_list, np.int32).reshape(-1, 4)

    # the terminal grid padded to a size class with empty buckets
    nb_total = _shape_class(max(len(term_child), 1))
    term_valid = [True] * len(term_child) \
        + [False] * (nb_total - len(term_child))
    pad = nb_total - len(term_child)
    term_child += [0] * pad
    term_mode += [0] * pad
    term_fill += [0] * pad
    term_src = np.array([l2_start[c] if c >= 0 else 0 for c in term_child],
                        np.int64)

    return _Plan(
        n=n, pairs=pairs,
        nparents=nparents, rmax=rmax, pitch=pitch, sort_rows=sort_rows,
        cap_rows=cap_rows, one_level=False,  # always both levels
        l1_bounds=l1_bounds.astype(np.int32),
        arena1_rows=arena1_rows,
        l1_dst_start=l1_start.astype(np.int32),
        l1_dst_cap=l1_cap.astype(np.int32),
        l1_tiles=l1_tiles,
        l2_bounds=l2_bounds.astype(np.int32),
        arena2_rows=arena2_rows,
        l2_dst_start=l2_start.astype(np.int32),
        l2_dst_cap=l2_cap.astype(np.int32),
        l2_tiles=l2_tiles,
        term_src_row=term_src.astype(np.int32),
        term_child=np.array(term_child, np.int32),
        term_mode=np.array(term_mode, np.int32),
        term_fill=np.array(term_fill, np.int64),   # raw uint32 values
        term_valid=np.array(term_valid, bool),
        group_len=np.array([max(len(g), 1) for g in groups]
                           + [1] * (nparents - ng), np.int32),
        out_rows=_ceil_div(n, LANES) + 2 * CHUNK_ROWS + 2,
    )


# ============================================================== tables

def _pack_tables(plan: _Plan):
    """Every plan table in ONE int32 array (one upload) and its static
    (name, offset, shape) layout."""
    fill_biased = _bias_np(plan.term_fill.astype(np.uint32))
    tables = dict(
        l1_tiles=plan.l1_tiles, l1_bounds=plan.l1_bounds,
        l1_start=plan.l1_dst_start, l1_cap=plan.l1_dst_cap,
        l2_tiles=plan.l2_tiles, l2_bounds=plan.l2_bounds,
        l2_start=plan.l2_dst_start, l2_cap=plan.l2_dst_cap,
        group_len=plan.group_len,
        term_src=plan.term_src_row, term_child=plan.term_child,
        term_mode=plan.term_mode, term_fill=fill_biased,
        term_valid=plan.term_valid.astype(np.int32),
    )
    layout, chunks, off = [], [], 0
    for name, arr in tables.items():
        a = np.ascontiguousarray(arr, dtype=np.int32)
        layout.append((name, off, a.shape))
        chunks.append(a.reshape(-1))
        off += a.size
    return np.concatenate(chunks), tuple(layout)


def _unpack(packed: torch.Tensor, layout) -> dict:
    """The tables of ``_pack_tables`` as contiguous views of ``packed``."""
    out = {}
    for name, off, shape in layout:
        size = int(np.prod(shape)) if shape else 1
        out[name] = packed[off:off + size].view(shape)
    return out


# ============================================================== pipeline

def _pipeline(keys: torch.Tensor, rids: Optional[torch.Tensor], tb: dict,
              *, pairs: bool, pitch: int, rmax: int, nparents: int,
              arena1_rows: int, arena2_rows: int, cap_rows: int,
              out_rows: int, n: int, record: Optional[list] = None):
    """L1 partition, L2 partition, phantom-count correction, terminal
    (``engine_v3.py:451-547``) on the unpacked tables ``tb``.  ``keys``
    and ``rids`` are raw uint32 words as int32; returns (keys, rids or
    None, over (1,) int32) with the outputs as raw words.  ``record``, a
    list, receives the two partition levels' outputs."""
    dev = keys.device
    i32 = dict(dtype=torch.int32, device=dev)
    nchild2 = nparents * rmax
    l2_bounds = tb["l2_bounds"]
    # the L1 tiles read the keys in place: no tile reads past n
    v = rids ^ BIAS if pairs else None
    lvl1 = kv3.partition_level(
        keys, v, tb["l1_tiles"], torch.zeros(1, **i32), tb["l1_bounds"],
        tb["l1_start"], tb["l1_cap"], arena1_rows, pitch, rmax,
        parent_fill=torch.full((1,), n, **i32),
        sink_base=torch.arange(nparents, **i32) * rmax,
        sink_cnt=tb["group_len"], padsrc=l2_bounds, nsinks=nchild2,
        pad_stride=rmax, bias_input=True)
    del v
    a1, va1, occ1, real1, pads1, over1 = lvl1
    lvl2 = kv3.partition_level(
        a1, va1, tb["l2_tiles"], torch.arange(nparents, **i32) * rmax,
        l2_bounds, tb["l2_start"], tb["l2_cap"], arena2_rows, pitch, rmax,
        parent_fill=occ1 * LANES,
        sink_base=torch.arange(nchild2, **i32),
        sink_cnt=torch.ones(nchild2, **i32),
        padsrc=l2_bounds, nsinks=nchild2, pad_stride=1, bias_input=False)
    if record is not None:
        record += [lvl1, lvl2]
    del lvl1, a1, va1
    a2, va2, occ2, real2, pads2, over2 = lvl2
    del lvl2

    # L2 counted the L1 pads as data; the pad sinks make the correction
    # exact per child
    real2c = real2 - pads1
    term_child, term_mode = tb["term_child"], tb["term_mode"]
    child = term_child.clamp(min=0).long()
    reals_t = torch.where(term_child >= 0, real2c[child],
                          real1[(-1 - term_child).clamp(min=0).long()])
    reals_t = torch.where(tb["term_valid"] != 0, reals_t, 0)
    occ_t = torch.where(term_child >= 0, occ2[child], 0)
    # every terminal read stays inside its bucket even under overflow
    # (the host retries then): a sorted bucket gives at most occ*128
    reals_t = torch.where(term_mode == 0,
                          torch.minimum(reals_t, occ_t * LANES), reals_t)
    ends = torch.cumsum(reals_t, 0).clamp(max=n)
    out_off = torch.cat([ends.new_zeros(1), ends[:-1]])
    reals_t = ends - out_off
    btbl = torch.stack([tb["term_src"], occ_t.to(torch.int32),
                        reals_t.to(torch.int32), term_mode], 1)
    out, vout = kv3.terminal_sort_write(
        a2, va2, btbl, tb["term_fill"], out_off.to(torch.int32), out_rows,
        cap_rows, unbias_output=True)
    return (out.view(-1)[:n], vout.view(-1)[:n] if pairs else None,
            over1 | over2)


# ============================================================== driver

def _words(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dim() != 1 or x.element_size() != 4 or x.dtype.is_floating_point:
        raise TypeError(f"sort_v3: {what} must be a 1-D tensor of 32-bit "
                        f"integer words, got {x.dtype} {tuple(x.shape)}")
    return x.contiguous().view(torch.int32)


def sort_v3(keys: torch.Tensor, rids: Optional[torch.Tensor] = None,
            cfg: Optional[SortConfig] = None,
            timer: Optional[PhaseTimer] = None,
            _fudge: Optional[float] = None, _depth: int = 0):
    """Sort uint32 keys (1-D, any 32-bit integer dtype read as its raw
    words), optionally with uint32 rids, on their device.  Returns
    (keys, rids or None) as uint32 tensors; pairs order lexicographically
    by (key, rid)."""
    cfg = cfg or SortConfig()
    timer = timer or PhaseTimer(enabled=False)
    kw = _words(keys, "keys")
    vw = _words(rids, "rids") if rids is not None else None
    if vw is not None and (vw.shape != kw.shape or vw.device != kw.device):
        raise ValueError("sort_v3: rids must match keys in length and "
                         "device")
    n = int(kw.shape[0])
    if n < SMALL_N and _fudge is None:
        engine_v4.FALLBACK_STATS["small_n"] += 1
        return _fallback(kw, vw)
    return _sort_v3_body(kw, vw, cfg, timer, _fudge, _depth, n)


def _sort_v3_body(keys, rids, cfg, timer, _fudge, _depth, n):
    pairs = rids is not None
    # ---- sample, plan: one host round trip of a few KB
    with timer.phase("sample"):
        ssz = min(int(min(max(cfg.sample_rate * n, 4096), cfg.sample_cap)),
                  n)
        fudge_now = _fudge if _fudge is not None else max(cfg.fudge, 1.2)
        _, nb_want = _plan_geometry(n, pairs, fudge_now, cfg)
        stats = engine_v4._sample_stats(keys, ssz=ssz, nbq=4 * nb_want,
                                        salt=0).cpu().numpy()
        rows = max(n // LANES, 1)
        neff = max(1, min(ssz, rows))
        S = min(n, ssz) if (rows <= 1 or neff >= rows) else neff
        try:
            plan = make_plan(n, stats, S, pairs, cfg, _fudge)
        except ValueError:
            # skew beyond the planner's topology
            engine_v4.FALLBACK_STATS["plan"] += 1
            return _fallback(keys, rids)

    # ---- the device pipeline, its tables as one upload
    with timer.phase("part_blocks"):
        packed, layout = _pack_tables(plan)
        tb = _unpack(torch.from_numpy(packed).to(keys.device), layout)
        out_k, out_v, over = _pipeline(
            keys, rids, tb, pairs=pairs, pitch=plan.pitch, rmax=plan.rmax,
            nparents=plan.nparents, arena1_rows=plan.arena1_rows,
            arena2_rows=plan.arena2_rows, cap_rows=plan.cap_rows,
            out_rows=plan.out_rows, n=n)
        timer.sync(out_k)

    # ---- the overflow flag (fetched with the result); retry if set
    if int(over.item()):
        del out_k, out_v
        if _depth < 2:
            engine_v4.FALLBACK_STATS["retry"] += 1
            return sort_v3(keys, rids, cfg, timer, _fudge=fudge_now * 1.6,
                           _depth=_depth + 1)
        engine_v4.FALLBACK_STATS["overflow"] += 1
        return _fallback(keys, rids)
    return (out_k.view(torch.uint32),
            out_v.view(torch.uint32) if pairs else None)


def _fallback(keys: torch.Tensor, rids: Optional[torch.Tensor]):
    """``torch.sort``, lexicographic by (key, rid) as the engine is
    (``engine_v3._xla_fallback``)."""
    k, v = engine_v4._torch_fallback(keys, () if rids is None else (rids,))
    return k.view(torch.uint32), (v[0].view(torch.uint32) if v else None)
