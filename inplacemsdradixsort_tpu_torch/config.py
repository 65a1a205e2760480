"""Typed configuration of the PyTorch port.

The fields keep the names and defaults of ``inplacemsdradixsort_tpu``'s
``SortConfig``, so that one kwargs dict configures both packages in the
parity tests.  Only the fields that the ported v4 and v5 paths read are
here; the fields of engines not yet ported (v3, LSB, v1, distributed)
join with their engines.  ``interpret`` has no counterpart: a kernel runs its
plain PyTorch version when its input lies on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Configuration of the single-device sort."""

    # --- planner (sample -> bounds) ---
    sample_rate: float = 0.005    # sample fraction of N (msb_64.c:2320)
    sample_cap: int = 500_000     # max sample size       (msb_64.c:2321-2322)
    use_sample_splitters: bool = True   # hybrid sample+radix delimiters

    # --- v4 engine geometry (None = auto) ---
    v3_sort_rows: int = 1024          # tile rows (x128) incl. rmax pad rows
    v3_rmax: Optional[int] = None     # ranges per parent per level
    v3_cap_rows: Optional[int] = None  # terminal bucket capacity rows

    # --- v5 in-place engine geometry (None = auto) ---
    # L1 tile rows of the sequential-block partition (rows x 128 must be
    # a power of two)
    v5_pitch_rows: Optional[int] = None
    # L2 scratch budget as a fraction of the input blocks: regions are
    # batched so that each batch's blocks fit ceil(frac * total)
    v5_batch_frac: float = 0.25

    # below this size the engine dispatches straight to ``torch.sort``;
    # None = the engine default (2^16).  Tests lower it to exercise the
    # pipeline at tiny n.
    min_engine_n: Optional[int] = None

    # terminal capacity classes below the XL rescue class (cap, cap/2,
    # cap/4): one terminal launch per class
    term_classes: int = 3

    # "auto" (v4 for a CUDA tensor, v5 where v4 does not fit, torch for a
    # CPU tensor) | "v4" | "v5" | "torch"
    engine: str = "auto"


DEFAULT_CONFIG = SortConfig()
