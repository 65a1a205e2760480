"""Host-side planner helpers shared by the engines (numpy only).

Counterparts of ``inplacemsdradixsort_tpu/ops/engine_v3.py``'s
``_bias_np``, ``_ceil_div``, ``_shape_class`` and ``_quantile_bounds``,
which the v4 planner and the deep tier import; ``engine_v3`` itself is
not ported.
"""

from __future__ import annotations

import math

import numpy as np

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
