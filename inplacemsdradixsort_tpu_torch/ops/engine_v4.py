"""v4 engine on PyTorch: exact-histogram-planned, device-resident MSD range
sort — the device-planned path of ``inplacemsdradixsort_tpu``'s
``ops/engine_v4.py``.

Pipeline (as the reference's):

1. SAMPLE + PLAN on the device: a random element sample, equal-depth
   duplicate-aware bounds with heavy-value isolation merged with
   radix-equidistant delimiters (``_sample_stats``, ``_tables_from_stats``).
2. Per level: ``hist_level`` (exact per-(tile, range) counts), prefix sums
   into exact destination rows and phantom-pad values (``_level_tables``),
   ``route_level`` (scatter of every run to its destination).  Two levels
   when the bucket estimate exceeds one rmax-wide level.
3. TERMINAL: ``terminal_write`` per capacity class sorts every final
   bucket and writes its real prefix to its exact output offset, or
   value-fills a heavy bucket.

A bucket beyond the XL class capacity sets the ``over`` flag; ``sort_v4``
retries with finer buckets and a fresh sample; when the ladder is out of
refinements, a multi-plane input recurses into the deep tier
(``deep.deep_sort``) and a keys-only one falls back to ``torch.sort``.

Planes are int32 tensors holding raw uint32 words (``keys.view(int32)``);
the kernels bias them on load.  ``vals`` are 0-3 payload planes carried
with the keys (rids, or the (hi, lo) words of u64 keys and rids); the
order is lexicographic by (key, *vals).  Value fill is keys-only: with
payload every bucket is sorted.  The host planner and the debug
invariant suite are not ported yet (``ROADMAP.md`` A2, A4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..config import SortConfig
from ..utils.timing import PhaseTimer
from . import kernels_v4 as kv4
from .kernels_v4 import BIAS, CHUNK_ROWS, LANES, SENT
from .plan_util import _bias_np, _ceil_div, _shape_class

# engine-path observability: tests and probes assert that no input class
# reaches the whole-array fallback.  "deep" counts deep-tier entries,
# "deep_local" the deep tier's bucket-local torch.sort (at its depth cap
# or for <= 128 elements), "plan" a v5 plan that outgrew the topology.
FALLBACK_STATS = {"small_n": 0, "plan": 0, "overflow": 0, "retry": 0,
                  "deep": 0, "deep_local": 0}


def reset_fallback_stats() -> None:
    for k in FALLBACK_STATS:
        FALLBACK_STATS[k] = 0


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


# ============================================================== sample

def _stats_of_sorted(s: torch.Tensor, nbq: int) -> torch.Tensor:
    """Equal-depth quantile picks with left/right ranks, (3, nbq) int32,
    from a sample ``s`` of raw uint32 words (int32 view) sorted as
    unsigned.  Row 0 holds the picks' raw words."""
    S = s.shape[0]
    pos = np.clip(
        (np.arange(1, nbq + 1, dtype=np.int64) * S) // nbq - 1, 0, S - 1)
    sb = s ^ BIAS                           # biased: ascending as signed
    picks = sb[torch.from_numpy(pos).to(s.device)]
    picks[-1] = SENT
    left = torch.searchsorted(sb, picks, side="left").to(torch.int32)
    right = torch.searchsorted(sb, picks, side="right").to(torch.int32)
    return torch.stack([picks ^ BIAS, left, right])


def _sample_stats(keys: torch.Tensor, *, ssz: int, nbq: int,
                  salt: int) -> torch.Tensor:
    """Element-granular random sample -> sorted -> ``_stats_of_sorted``.

    The generator lives on the keys' device and is seeded from (n, salt)
    as the reference seeds its PRNG key; ``salt`` is the retry depth, so a
    retry draws a fresh sample.  The draws differ from ``jax.random``'s,
    so samples are never compared between the two packages."""
    n = keys.shape[0]
    rows = max(n // LANES, 1)
    neff = max(1, min(ssz, rows))
    if rows <= 1 or neff >= rows:
        s = keys[: min(n, ssz)]
    else:
        gen = torch.Generator(device=keys.device)
        gen.manual_seed((n & 0xFFFFFF)
                        ^ (salt * 2654435761 & 0x7FFFFFFF))
        idx = torch.randint(0, rows, (neff,), generator=gen,
                            device=keys.device)
        lane = (idx * 89 + torch.arange(neff, device=keys.device) * 37) \
            % LANES
        s = keys[idx * LANES + lane]
    s = torch.sort(s ^ BIAS).values ^ BIAS
    return _stats_of_sorted(s, nbq)


# ============================================================== geometry

def _geometry(n: int, nplanes: int, cfg: SortConfig):
    if cfg.v3_cap_rows:
        cap_rows = cfg.v3_cap_rows
    else:
        cap_rows = 1024 if nplanes == 1 else 512
        if n >= (1 << 28):
            cap_rows *= 2
    target = int(cap_rows * LANES * 0.80)
    nb_want = max(1, _ceil_div(n, target))
    return cap_rows, nb_want


@dataclasses.dataclass(frozen=True)
class _GeomV4:
    """Static geometry of the device-planned pipeline — shapes only;
    every data-dependent quantity lives in on-device tables."""
    n: int
    nplanes: int
    rmax: int
    pitch: int
    sort_rows: int
    cap_rows: int
    ntiles1: int
    t2max: int
    arena1_rows: int
    arena2_rows: int
    out_rows: int
    ssz: int
    S: int
    nbq: int
    nrad: int
    prefix_bits: int
    heavy_cnt: int
    cap_S: int
    nb_want: int
    two_level: bool = True


def _dev_geometry(n: int, nplanes: int, cfg: SortConfig,
                  nb_mult: float = 1.0) -> _GeomV4:
    """Static topology from the target bucket count (the reference's
    ``_dev_geometry``; the ``schedule_passes`` analog, msb_64.c:1334-1400,
    picks one level when the bucket estimate fits one rmax-wide level)."""
    cap_rows, nb_want = _geometry(n, nplanes, cfg)
    nb_want = max(16, int(nb_want * nb_mult))
    ssz = int(min(max(cfg.sample_rate * n, 4096), cfg.sample_cap))
    ssz = min(ssz, n)
    rows = max(n // LANES, 1)
    neff = max(1, min(ssz, rows))
    S = min(n, ssz) if (rows <= 1 or neff >= rows) else neff
    nbq = 4 * nb_want
    prefix_bits = nrad = 0
    if cfg.use_sample_splitters and nb_want >= 16:
        prefix_bits = min(8, max(2, int(math.log2(max(nb_want // 4, 4)))))
        nrad = 1 << prefix_bits
    est_nb = _est_buckets(nb_want, nrad)
    if cfg.v3_rmax:
        rmax = cfg.v3_rmax
        two_level = est_nb > max(1, (3 * rmax) // 4)
    elif est_nb > 64:
        two_level = True
        rmax = (32 if est_nb <= 1024 else (
            48 if est_nb <= 2304 else (64 if est_nb <= 4096 else 96)))
    else:
        two_level = False
        rmax = 64 if est_nb <= 42 else 96
    sort_rows = cfg.v3_sort_rows
    pitch = sort_rows - rmax
    if pitch <= 0:
        raise ValueError(f"v3_sort_rows={sort_rows} must exceed rmax={rmax}")
    kv4.check_level_width(rmax)
    rows_in = _ceil_div(n, LANES)
    ntiles1 = _ceil_div(rows_in, pitch)
    rows1_max = rows_in + ntiles1 * rmax
    arena1_rows = _shape_class(
        rows1_max + rmax * CHUNK_ROWS
        + max(pitch, 2 * cap_rows) + CHUNK_ROWS
    )
    if two_level:
        t2max = max(_ceil_div(rows1_max, pitch) + rmax, 1)
        rows2_max = rows1_max + t2max * rmax
        arena2_rows = _shape_class(
            rows2_max + rmax * rmax * CHUNK_ROWS
            + 2 * cap_rows + CHUNK_ROWS
        )
    else:
        t2max, arena2_rows = 1, 8
    out_rows = rows_in + 2 * CHUNK_ROWS + 2
    # capacity-tied heavy threshold + sample-noise floor
    heavy_frac = max(0.3 / nb_want, 12.0 / max(S, 1))
    return _GeomV4(
        n=n, nplanes=nplanes, rmax=rmax, pitch=pitch,
        sort_rows=sort_rows, cap_rows=cap_rows, ntiles1=ntiles1,
        t2max=t2max, arena1_rows=arena1_rows, arena2_rows=arena2_rows,
        out_rows=out_rows, ssz=ssz, S=S, nbq=nbq, nrad=nrad,
        prefix_bits=prefix_bits,
        heavy_cnt=max(1, int(math.ceil(heavy_frac * S))),
        cap_S=max(1, S // nb_want), nb_want=nb_want,
        two_level=two_level,
    )


def _est_buckets(nb_want: int, nrad: int) -> int:
    """The planner's estimate of the final buckets: the target count
    with sample slack, plus the radix-equidistant bounds."""
    return int(nb_want * 1.3) + nrad + 2


def bucket_room(n: int, nplanes: int, cfg: SortConfig):
    """(buckets the planner asks for at n elements, buckets v4's
    topology can hold: rmax with one level, rmax^2 with two).  The plan
    is clamped to the topology, so where the first exceeds the second the
    buckets outgrow the XL class and the retry ladder cannot help
    (ROADMAP.md C9)."""
    g = _dev_geometry(n, nplanes, cfg)
    return (_est_buckets(g.nb_want, g.nrad),
            g.rmax * g.rmax if g.two_level else g.rmax)


def _l1_meta_np(g: _GeomV4) -> np.ndarray:
    """L1 tile table ((ntiles1+1)*3,): (parent 0, src_row, nelems)."""
    meta = np.zeros((g.ntiles1 + 1, 3), np.int32)
    t = np.arange(g.ntiles1, dtype=np.int64)
    meta[:-1, 1] = t * g.pitch
    meta[:-1, 2] = np.minimum(g.n - t * g.pitch * LANES, g.pitch * LANES)
    return meta.reshape(-1)


# ============================================================== planner

def _plan_tables_dev(keys: torch.Tensor, g: _GeomV4, salt: int) -> dict:
    """The v4 planner on the device: sample -> stats -> tables, with no
    host round trip."""
    stats = _sample_stats(keys, ssz=g.ssz, nbq=g.nbq, salt=salt)
    return _tables_from_stats(stats, g)


def _tables_from_stats(stats: torch.Tensor, g: _GeomV4) -> dict:
    """Bound/terminal tables from quantile stats (the reference's
    ``_tables_from_stats`` without the dsort-only ``S_dyn`` branch).

    Equal-depth duplicate-aware bounds with heavy-value isolation
    (extract_delimiters, msb_64.c:1304-1322) merged with radix-equidistant
    delimiters (:1545-1564), coalesced on a cap_frac rank grid, clamped to
    the topology and grouped in fixed stride for the two levels."""
    dev = stats.device
    # value fill is keys-only: a heavy range with payload is sorted
    keys_only = g.nplanes == 1
    rmax, nbq = g.rmax, g.nbq
    pv = stats[0] ^ BIAS                 # biased, ascending
    left, right = stats[1], stats[2]
    one_t = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one_t, pv[1:] != pv[:-1]])
    hv = first & ((right - left) >= g.heavy_cnt)

    # ---- candidates: picks; v-1 isolation bounds before heavy values;
    # radix-equidistant bounds.  pv - 1 wraps at the lowest value as the
    # reference's int32 does; that candidate is never valid.
    iso_ok = hv & (pv > BIAS)
    pv_m1 = torch.where(pv == BIAS, torch.full_like(pv, SENT), pv - 1)
    zeros_b = torch.zeros(nbq, dtype=torch.bool, device=dev)
    vs, rs = [pv, pv_m1], [right, left]
    aks, hvs, oks = [zeros_b, iso_ok], [hv, zeros_b], [first, iso_ok]
    if g.nrad:
        radu = ((np.arange(1, g.nrad + 1, dtype=np.uint64)
                 << np.uint64(32 - g.prefix_bits)) - np.uint64(1))
        radv = torch.from_numpy(_bias_np(radu.astype(np.uint32))).to(dev)
        ridx = torch.searchsorted(pv, radv, side="right").to(torch.int32)
        rrank = torch.where(
            ridx > 0, right[(ridx - 1).clamp(0, nbq - 1).long()], 0)
        ones_r = torch.ones(g.nrad, dtype=torch.bool, device=dev)
        vs.append(radv)
        rs.append(rrank)
        aks.append(ones_r)
        hvs.append(torch.zeros_like(ones_r))
        oks.append(ones_r)
    v = torch.cat(vs)
    r = torch.cat(rs).to(torch.int32)
    a = torch.cat(aks).to(torch.int32)
    h = torch.cat(hvs).to(torch.int32)
    inval = 1 - torch.cat(oks).to(torch.int32)
    NBD = int(v.shape[0])

    # sort by (validity, value, rank), stable: stable sorts from the last
    # key to the first (the reference's lax.sort with num_keys=3)
    order = torch.sort(r, stable=True).indices
    order = order[torch.sort(v[order], stable=True).indices]
    order = order[torch.sort(inval[order], stable=True).indices]
    inval, v, r, a, h = (x[order] for x in (inval, v, r, a, h))
    valid = inval == 0
    uniq = valid & torch.cat([one_t, v[1:] != v[:-1]])
    for k in (1, 2):        # dup runs are <= 3 (pick, isolation, radix)
        eq = torch.cat([v[k:] == v[:-k],
                        torch.zeros(k, dtype=torch.bool, device=dev)])
        zk = torch.zeros(k, dtype=torch.int32, device=dev)
        a = a | (torch.cat([a[k:], zk]) * eq)
        h = h | (torch.cat([h[k:], zk]) * eq)

    # ---- dense compaction of unique valid candidates.  Every discarded
    # candidate goes to the one dump slot NBD, cut off after the scatter:
    # only that slot has colliding writes, so index_put_ is exact.
    pos = torch.cumsum(uniq.to(torch.int32), 0, dtype=torch.int32) - 1
    tgt = torch.where(uniq, pos, NBD).long()

    def _scat(x, fill):
        out = torch.full((NBD + 1,), fill, dtype=x.dtype, device=dev)
        out[tgt] = x
        return out[:NBD]
    dv = _scat(v, SENT)
    dr = _scat(r, g.S)
    da = _scat(a, 0)
    dh = _scat(h, 0)
    m = uniq.to(torch.int32).sum()

    # ---- coalesce on the cap_frac rank grid
    idx = torch.arange(NBD, dtype=torch.int32, device=dev)
    kb = dr // g.cap_S
    kb_next = torch.cat([kb[1:], _i32([1 << 30], dev)])
    keep = (idx < m) & (
        (da != 0) | (dh != 0) | (idx == m - 1) | (kb_next > kb))

    # ---- clamp to the topology (rmax one-level, rmax^2 two-level) and
    # force full coverage (same dump-slot scatter as above, at NBF)
    NBF = min(NBD, rmax if not g.two_level else rmax * rmax)
    kpos = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    keep2 = keep & (kpos < NBF)
    nbk = torch.clamp(keep2.to(torch.int32).sum(), max=NBF)
    tgt2 = torch.where(keep2, kpos.clamp(max=NBF), NBF).long()
    fb = torch.full((NBF + 1,), SENT, dtype=torch.int32, device=dev)
    fb[tgt2] = dv
    fb = fb[:NBF]
    fhr = torch.zeros(NBF + 1, dtype=torch.int32, device=dev)
    fhr[tgt2] = dh
    fhr = fhr[:NBF]
    fb[(nbk - 1).clamp(0, NBF - 1).long()] = SENT
    fidx = torch.arange(NBF, dtype=torch.int32, device=dev)
    prev = torch.cat([_i32([0], dev), fb[:-1]])
    adj = torch.where(fidx == 0, fb == BIAS, fb == prev + 1)
    fh = (fhr != 0) & adj & (fidx < nbk)

    # ---- fixed-stride grouping (groups = L1 ranges, members = L2)
    per = torch.clamp((nbk + rmax - 1) // rmax, min=1)
    gidx = torch.arange(rmax, dtype=torch.int32, device=dev)
    glen = torch.minimum(torch.clamp(nbk - gidx * per, min=1), per)
    lasti = torch.minimum(torch.clamp(gidx * per + per - 1, min=0),
                          torch.clamp(nbk - 1, min=0))
    l1b = torch.where(gidx * per < nbk, fb[lasti.long()], SENT)
    jj = gidx[None, :]
    fi = gidx[:, None] * per + jj
    in_group = (jj < per) & (fi < nbk)
    fi_c = fi.clamp(0, NBF - 1).long()
    l2b = torch.where(in_group, fb[fi_c], SENT)
    hvb = in_group & fh[fi_c]

    # ---- drop flags + terminal tables at static slots c = g*rmax + j
    drop1 = (keys_only & (glen == 1) & hvb[:, 0]
             & (gidx * per < nbk)).to(torch.int32)
    drop2 = (keys_only & hvb & (glen[:, None] > 1)).to(torch.int32)
    # one-level: the terminal child IS the L1 range; two-level: the
    # L2-flattened slot
    cidx = (gidx[:, None] * rmax + jj if g.two_level
            else gidx[:, None].expand(rmax, rmax))
    d1 = drop1[:, None] != 0
    term_valid = in_group & torch.where(d1, jj == 0, True)
    term_child = torch.where(d1, -1 - gidx[:, None], cidx)
    term_mode = (d1 | (drop2 != 0)).to(torch.int32)
    return dict(
        l1_bounds=l1b, l2_bounds=l2b, group_len=glen,
        drop1=drop1, drop2=drop2.reshape(-1),
        term_child=term_child.reshape(-1).to(torch.int32),
        term_mode=term_mode.reshape(-1),
        term_fill=l2b.reshape(-1),
        term_valid=term_valid.reshape(-1).to(torch.int32),
    )


def tables_from_numpy(tb: Dict[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """The reference's table dict (``_tables_from_stats`` output plus
    ``l1_meta``, as numpy arrays) as the port's int32 tensors on
    ``device``: the state both packages share in the parity tests."""
    return {k: torch.from_numpy(np.array(v, dtype=np.int32)).to(device)
            for k, v in tb.items()}


# ============================================================== glue

def _level_tables(h, keep, gap_rows):
    """Exact per-(tile, range) destination rows from a count matrix.

    h: (ntiles, rmax) true counts; keep: (rmax,) 0/1 — a dropped (heavy,
    value-filled) range stores nothing: its dst is -1 and it takes no
    arena rows.  Children are packed [start_c, start_c + rows_c) with a
    ``gap_rows`` gap after each (the reference's chunk-overshoot slack,
    kept so the start tables are equal)."""
    pads = (-h) % LANES
    rrows = (h + pads) // LANES
    stored = rrows * keep[None, :]
    rows_c = stored.sum(0, dtype=torch.int32)
    alloc = rows_c + gap_rows
    start = torch.cat([_i32([0], h.device),
                       torch.cumsum(alloc, 0, dtype=torch.int32)[:-1]])
    excl = torch.cumsum(stored, 0, dtype=torch.int32) - stored
    dst = torch.where(keep[None, :] != 0, start[None, :] + excl, -1)
    return pads * keep[None, :], rows_c, start, dst.to(torch.int32)


def _pipeline_core(planes, tb: dict, g: _GeomV4, *, debug: bool = False,
                   nclasses: int = 1, timer: Optional[PhaseTimer] = None):
    """Levels + terminal from a table dict ``tb``.

    ``planes``: the key plane and its payload planes, 1-D int32 raw
    words of equal length, sorted lexicographically over all of them.
    Returns (sorted planes, over flag (0-dim int32), debug dict).  With ``debug`` the dict holds the reference's
    keys (hist1, start1, rows_c1, a1, hist2, real2, start2, rows_c2, a2,
    btbl; the arenas as plane tuples) plus the destination tables
    dst1/dst2 that ``canonical_runs`` needs."""
    timer = timer or PhaseTimer(enabled=False)
    planes = tuple(planes)
    dev = planes[0].device
    rmax, pitch, ntiles1, t2max = g.rmax, g.pitch, g.ntiles1, g.t2max
    l1_meta = tb["l1_meta"]
    l1_bounds, l2_bounds = tb["l1_bounds"], tb["l2_bounds"]
    group_len = tb["group_len"]
    drop1, drop2 = tb["drop1"], tb["drop2"]
    term_child, term_mode = tb["term_child"], tb["term_mode"]
    term_fill, term_valid = tb["term_fill"], tb["term_valid"] != 0
    nchild2 = rmax * rmax
    ar = torch.arange(rmax, dtype=torch.int32, device=dev)
    dbg = {}

    with timer.phase("part_blocks"):
        # ---------------- level 1 (planes are read in place: tiles past n
        # are masked by their element counts, so no padded copy is made)
        hist1 = kv4.hist_level(planes[0], l1_meta, l1_bounds, ntiles1, pitch,
                               rmax, bias_input=True)
        real1 = hist1.sum(0, dtype=torch.int32)   # pre-drop true counts
        pads1, rows_c1, start1, dst1 = _level_tables(
            hist1, 1 - drop1, CHUNK_ROWS)
        # pad values cycle over the child's next-level sub-bounds so
        # inherited phantoms spread across that level's children
        tt = torch.arange(ntiles1, dtype=torch.int32, device=dev)[:, None]
        jsink = (tt % torch.clamp(group_len, min=1)[None, :]).long()
        if g.two_level:
            padv1 = l2_bounds[ar.long()[None, :], jsink].contiguous()
            g_sink = ar.long()[None, :] * rmax + jsink
            pads1_into = torch.zeros(
                nchild2, dtype=torch.int32, device=dev).index_add_(
                0, g_sink.reshape(-1), pads1.reshape(-1))
        else:
            padv1 = l1_bounds[None, :].expand(ntiles1, rmax).contiguous()
        a1 = kv4.route_level(planes, l1_meta, l1_bounds, hist1, dst1, padv1,
                             g.arena1_rows, ntiles1, pitch, rmax,
                             bias_input=True)
        if debug:
            dbg.update(hist1=hist1, start1=start1, rows_c1=rows_c1, a1=a1,
                       dst1=dst1)

        if g.two_level:
            # ---------------- level 2: tile table over the packed children
            tc = (rows_c1 + pitch - 1) // pitch
            tbase = torch.cat([_i32([0], dev),
                               torch.cumsum(tc, 0, dtype=torch.int32)[:-1]])
            total2 = tbase[-1] + tc[-1]
            ti = torch.arange(t2max, dtype=torch.int32, device=dev)
            p_of = (torch.searchsorted(tbase, ti, right=True) - 1).clamp(
                0, rmax - 1)
            jloc = ti - tbase[p_of]
            live_t = ti < total2
            src_row2 = torch.where(live_t, start1[p_of] + jloc * pitch, 0)
            nel2 = torch.where(
                live_t,
                torch.clamp(rows_c1[p_of] * LANES - jloc * pitch * LANES,
                            0, pitch * LANES),
                0)
            parent2 = torch.where(live_t, p_of.to(torch.int32), 0)
            meta2 = torch.cat([
                torch.stack([parent2, src_row2, nel2], 1).reshape(-1),
                torch.zeros(3, dtype=torch.int32, device=dev),
            ]).to(torch.int32)
            l2_flat = l2_bounds.reshape(-1).contiguous()
            hist2 = kv4.hist_level(a1[0], meta2, l2_flat, t2max, pitch, rmax,
                                   bias_input=False)
            g2 = (parent2.long()[:, None] * rmax + ar.long()[None, :])
            g2f = g2.reshape(-1)
            cnt2 = torch.zeros(nchild2, dtype=torch.int32,
                               device=dev).index_add_(0, g2f,
                                                      hist2.reshape(-1))
            real2 = cnt2 - pads1_into
            keep2 = 1 - drop2[g2f].reshape(g2.shape)
            rrows2 = (hist2 + ((-hist2) % LANES)) // LANES   # true rows
            stored2 = rrows2 * keep2
            rows_c2 = torch.zeros(nchild2, dtype=torch.int32,
                                  device=dev).index_add_(
                0, g2f, stored2.reshape(-1))
            alloc2 = rows_c2 + CHUNK_ROWS
            start2 = torch.cat([_i32([0], dev),
                                torch.cumsum(alloc2, 0,
                                             dtype=torch.int32)[:-1]])
            excl2 = torch.cumsum(stored2, 0, dtype=torch.int32) - stored2
            base2 = excl2[tbase[parent2.long()].long()]
            dst2 = torch.where(keep2 != 0,
                               start2[g2f].reshape(g2.shape) + excl2 - base2,
                               -1).to(torch.int32)
            padv2 = l2_flat[g2f].reshape(g2.shape).contiguous()
            a2 = kv4.route_level(a1, meta2, l2_flat, hist2, dst2, padv2,
                                 g.arena2_rows, t2max, pitch, rmax,
                                 bias_input=False)
            if debug:
                dbg.update(hist2=hist2, real2=real2, start2=start2,
                           rows_c2=rows_c2, a2=a2, dst2=dst2)
        timer.sync(hist1)

    if g.two_level:
        del a1          # the terminal reads only the L2 arena
        src, real_c, rows_c, start_c, nchild = (
            a2, real2, rows_c2, start2, nchild2)
    else:
        src, real_c, rows_c, start_c, nchild = (
            a1, real1, rows_c1, start1, rmax)
    cidx = term_child.clamp(0, nchild - 1).long()
    gidx = (-1 - term_child).clamp(0, rmax - 1).long()
    is_child = term_child >= 0
    reals_t = torch.where(is_child, real_c[cidx], real1[gidx])
    occ_t = torch.where(is_child, rows_c[cidx], 0)
    src_t = torch.where(is_child, start_c[cidx], 0)
    with timer.phase("local_sort"):
        final, over, btbl = _finish(
            src, reals_t, occ_t, src_t, term_mode, term_fill, term_valid,
            g.n, g.cap_rows, nclasses)
        timer.sync(final[0])
    if debug:
        dbg["btbl"] = btbl
    return final, over, dbg


def _finish(src_planes, reals_t, occ_t, src_t, term_mode, term_fill,
            term_valid, n, cap_rows, nclasses=1, out_base=0, outs0=None,
            slice_n=True):
    """Terminal tier: class-chained ``terminal_write`` launches into one
    n-element output per plane.

    v5's extensions of the v4 defaults (as the reference's): ``out_base``
    offsets the buckets' output positions (a batch continues the global
    output stream), ``outs0`` are existing flat planes to write into in
    place (v5's working buffer W) instead of fresh n-element outputs, and
    ``slice_n=False`` returns those planes whole instead of their first n
    elements."""
    dev = src_planes[0].device
    reals_t = torch.where(term_valid, reals_t, 0).to(torch.int32)
    occ_t = occ_t.to(torch.int32)
    # the XL rescue class sorts up to 2*cap_rows, so only a bucket beyond
    # that triggers the retry ladder
    over = (term_valid & (term_mode == 0) & (occ_t > 2 * cap_rows)).any() \
        .to(torch.int32)
    reals_t = torch.where(term_mode == 0,
                          torch.minimum(reals_t, occ_t * LANES), reals_t)
    ends = torch.clamp(out_base + torch.cumsum(reals_t, 0, dtype=torch.int32),
                       max=n)
    out_off = torch.cat([_i32([out_base], dev), ends[:-1]])
    reals_t = ends - out_off
    # capacity classes (schedule_passes pass sizing, msb_64.c:1334-1400):
    # class 0 is the XL rescue tier (2*cap), then nclasses halving caps;
    # value-fill buckets go to the smallest class
    caps = [2 * cap_rows] + [cap_rows, cap_rows // 2,
                             cap_rows // 4][:nclasses]
    cls = torch.full_like(occ_t, len(caps) - 1)
    for ci in range(len(caps) - 2, -1, -1):
        cls = torch.where((term_mode == 0) & (occ_t > caps[ci + 1]), ci, cls)
    btbl = torch.stack([src_t, occ_t, reals_t, term_mode, term_fill,
                        out_off, cls, torch.zeros_like(reals_t)],
                       1).to(torch.int32).contiguous()
    if outs0 is None:
        outs = tuple(torch.empty(n, dtype=torch.int32, device=dev)
                     for _ in src_planes)
    else:
        outs = tuple(o.reshape(-1) for o in outs0)
    for ci, cap_c in enumerate(caps):
        kv4.terminal_write(src_planes, btbl, outs, cap_c, class_id=ci)
    if slice_n:
        outs = tuple(o[:n] for o in outs)
    return outs, over, btbl


# ============================================================== sort_v4

def sort_v4(keys: torch.Tensor, vals=(), cfg: Optional[SortConfig] = None,
            timer: Optional[PhaseTimer] = None, _nb_mult: float = 1.0,
            _depth: int = 0, _deep_depth: int = 0):
    """Sort raw uint32 words held in 1-D int32 tensors as unsigned, with
    0-3 payload planes ``vals`` of the same length.

    The order is lexicographic by (key, *vals): a stable key sort when
    vals[0] is the original index, a full u64 sort when the planes are
    (hi, lo) words.  Returns (sorted keys, tuple of sorted vals)."""
    planes = (keys,) + tuple(vals)
    if len(planes) > kv4.MAX_PLANES:
        raise ValueError(f"at most {kv4.MAX_PLANES} planes, got "
                         f"{len(planes)}")
    for p in planes:
        if p.dtype != torch.int32 or p.dim() != 1 \
                or p.shape != keys.shape or p.device != keys.device:
            raise TypeError(
                "sort_v4 takes 1-D int32 tensors of raw uint32 words of one "
                f"length on one device, got {p.dtype} {tuple(p.shape)} on "
                f"{p.device}")
    cfg = cfg or SortConfig()
    timer = timer or PhaseTimer(enabled=False)
    planes = tuple(p.contiguous() for p in planes)
    n = int(keys.shape[0])
    thr = cfg.min_engine_n if cfg.min_engine_n is not None else (1 << 16)
    if n < thr and _depth == 0:
        FALLBACK_STATS["small_n"] += 1
        return _torch_fallback(planes[0], planes[1:])
    return _sort_v4_body_dev(planes[0], planes[1:], cfg, timer, _nb_mult,
                             _depth, n, _deep_depth)


def _sort_v4_body_dev(keys, vals, cfg, timer, nb_mult, depth, n,
                      deep_depth=0):
    """Device-planned sort with the retry ladder; the ``over`` fetch is
    the completion sync."""
    planes = (keys,) + tuple(vals)
    g = _dev_geometry(n, len(planes), cfg, nb_mult)
    with timer.phase("sample"):
        tb = _plan_tables_dev(keys, g, salt=depth)
        tb["l1_meta"] = torch.from_numpy(_l1_meta_np(g)).to(keys.device)
        timer.sync(tb["l1_bounds"])
    final, over, _ = _pipeline_core(planes, tb, g, nclasses=cfg.term_classes,
                                    timer=timer)
    if int(over.item()):
        del final
        if depth < 2:
            FALLBACK_STATS["retry"] += 1
            return _sort_v4_body_dev(keys, vals, cfg, timer, nb_mult * 2.0,
                                     depth + 1, n, deep_depth)
        return _exhausted(keys, vals, cfg, timer, deep_depth)
    return final[0], tuple(final[1:])


def _exhausted(keys, vals, cfg, timer, deep_depth):
    """The retry ladder is out of plane-0 refinements.  Multi-plane
    inputs recurse into the lower planes (``deep.deep_sort``, the
    ``schedule_passes`` tier over the remaining key bits,
    msb_64.c:1334-1400); keys-only inputs have their heavy values
    value-filled already, so this means the sample missed
    pathologically: sort with ``torch.sort``."""
    if len(vals):
        from .deep import deep_sort
        return deep_sort(keys, vals, cfg, timer, deep_depth)
    FALLBACK_STATS["overflow"] += 1
    return _torch_fallback(keys, vals)


def _torch_fallback(keys: torch.Tensor, vals=()):
    """``torch.sort`` of raw uint32 word planes, lexicographic by
    (key, *vals): stable sorts from the least significant pair of planes
    to the most (``kernels_v4._lex_order``).  Returns (keys, vals) and
    synchronises on CUDA, as the engine path does
    (``SortResult.synced``)."""
    if not len(vals):
        out = torch.sort(keys ^ BIAS).values ^ BIAS
        outs = (out,)
    else:
        planes = (keys,) + tuple(vals)
        perm = kv4._lex_order([p ^ BIAS for p in planes])
        outs = tuple(p[perm] for p in planes)
    if outs[0].is_cuda:
        torch.cuda.synchronize(outs[0].device)
    return outs[0], tuple(outs[1:])
