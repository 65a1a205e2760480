"""Host-side planner helpers shared by the engines (numpy only).

Counterparts of ``inplacemsdradixsort_tpu/ops/engine_v3.py``'s
``_bias_np``, ``_ceil_div`` and ``_shape_class``, which the v4 planner
imports; ``engine_v3`` itself is not ported.
"""

from __future__ import annotations

import math

import numpy as np


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
