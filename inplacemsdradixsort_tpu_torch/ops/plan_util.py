"""Host-side planner helpers shared by the engines (numpy only).

Counterparts of ``inplacemsdradixsort_tpu/ops/engine_v3.py``'s
``_bias_np``, ``_ceil_div``, ``_shape_class`` and ``_quantile_bounds``,
which the v3 and v4 planners and the deep tier import, and of
``engine_v4.py``'s host-side ``_bounds_hybrid``, which the v5 planner
builds on.
"""

from __future__ import annotations

import math

import numpy as np

from ..config import SortConfig

U32_MAX = 0xFFFFFFFF


def _bias_np(u: np.ndarray) -> np.ndarray:
    """uint32 -> sign-biased int32 (order preserving)."""
    return (u.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)


def _ceil_div(a, b):
    return -(-a // b)


def _shape_class(x: int, steps_per_octave: int = 8) -> int:
    """Round up to a coarse size class (the reference recompiles only
    across classes; the port keeps the classes so its geometry equals
    the reference's)."""
    if x <= 1024:
        return 1024
    e = math.floor(math.log2(x))
    step = max(1, (1 << e) // steps_per_octave)
    return _ceil_div(x, step) * step


def _quantile_bounds(picks_u32: np.ndarray, left: np.ndarray,
                     right: np.ndarray, S: int, heavy_frac: float,
                     cap_frac: float):
    """Duplicate-aware equal-depth bounds (inclusive uppers, uint32) from
    sampled quantile picks with their left/right ranks in the sample.

    Heavy values (a share of the sample >= ``heavy_frac``) get an
    isolated single-value bucket [v, v] by a bound inserted at v-1 (the
    reference's splitter extraction + duplicate shifting,
    msb_64.c:1304-1322); finer bounds are then merged greedily while the
    merged bucket stays under ``cap_frac`` of the sample.
    Returns (bounds (nb,), est_frac (nb,), is_heavy (nb,))."""
    picks = picks_u32.astype(np.uint64)
    order = np.argsort(picks, kind="stable")
    picks, left, right = picks[order], left[order], right[order]
    uniq, first = np.unique(picks, return_index=True)
    u_left, u_right = left[first], right[first]
    cnt = u_right - u_left

    heavy = cnt / S >= heavy_frac
    # candidates: unique picks, plus v-1 before each heavy value v; each
    # keeps its right rank in the sample (rank of v-1 == left rank of v)
    hv = uniq[heavy]
    hl = u_left[heavy]
    keep = hv >= 1
    b = np.concatenate([uniq, hv[keep] - 1])
    r = np.concatenate([u_right, hl[keep]])
    o = np.argsort(b, kind="stable")
    b, r = b[o], r[o]
    b, idx = np.unique(b, return_index=True)
    r = r[idx]
    if b[-1] != U32_MAX:
        b = np.concatenate([b, [np.uint64(U32_MAX)]])
        r = np.concatenate([r, [S]])
    else:
        r[-1] = S

    # greedy coalesce, closing a bucket BEFORE it would exceed cap_frac
    est0 = np.diff(np.concatenate([[0], r])) / S
    lo0 = np.concatenate([[-1], b[:-1].astype(np.int64)])
    heavy0 = (b.astype(np.int64) == lo0 + 1) & (est0 >= heavy_frac)
    keep_idx = []
    acc = 0.0
    for j in range(len(b)):
        if acc > 0.0 and acc + est0[j] > cap_frac and not heavy0[j]:
            keep_idx.append(j - 1)
            acc = 0.0
        acc += est0[j]
        if heavy0[j] or j == len(b) - 1 or (
            j + 1 < len(b) and heavy0[j + 1]
        ):
            keep_idx.append(j)
            acc = 0.0
    ki = np.unique(np.array(keep_idx))
    b, r = b[ki], r[ki]

    est = np.diff(np.concatenate([[0], r])) / S
    lo_excl = np.concatenate([[-1], b[:-1].astype(np.int64)])
    is_heavy = (b.astype(np.int64) == lo_excl + 1) & (est >= heavy_frac)
    return b.astype(np.uint32), est, is_heavy


def _bounds_hybrid(stats: np.ndarray, S: int, nb_want: int,
                   cfg: SortConfig):
    """Duplicate-aware equal-depth bounds merged with radix-equidistant
    delimiters (the hybrid delimiter set, msb_64.c:1545-1564), from the
    (3, nbq) int32 quantile stats (raw picks, left and right ranks).

    Returns (bounds uint32 ascending incl. 0xFFFFFFFF, is_heavy bool,
    prefix_bits).  The heavy threshold is tied to the capacity: a value
    above 0.3/nb_want of the mass is isolated, with a sample-noise floor
    of 12 hits."""
    heavy_frac = max(0.3 / nb_want, 12.0 / max(S, 1))
    bounds, _, is_heavy = _quantile_bounds(
        stats[0].view(np.uint32), stats[1], stats[2], S, heavy_frac,
        cap_frac=1.0 / nb_want,
    )
    prefix_bits = 0
    if cfg.use_sample_splitters and nb_want >= 16:
        prefix_bits = min(8, max(2, int(math.log2(nb_want // 4))))
        nrad = 1 << prefix_bits
        rad = ((np.arange(1, nrad + 1, dtype=np.uint64)
                << np.uint64(32 - prefix_bits)) - np.uint64(1))
        heavy_set = set(bounds[is_heavy].astype(np.uint64).tolist())
        merged = np.unique(np.concatenate([bounds.astype(np.uint64), rad]))
        lo = np.concatenate([[-1], merged[:-1].astype(np.int64)])
        is_heavy = np.array(
            [int(v) in heavy_set and int(v) == int(lv) + 1
             for v, lv in zip(merged, lo)], bool)
        bounds = merged.astype(np.uint32)
    return bounds, is_heavy, prefix_bits
