"""Typed configuration of the PyTorch port.

The fields keep the names and defaults of ``inplacemsdradixsort_tpu``'s
``SortConfig``, so that one kwargs dict configures both packages in the
parity tests.  Only the fields that the ported v4, v5, v3, v1, LSB and
chunked paths read are here; the fields of the distributed sort, not yet
ported, join with it.  ``interpret`` has no counterpart: a kernel runs its
plain PyTorch version when its input lies on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

LANES = 128


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Configuration of the single-device sort."""

    # --- v1 engine layout (``engine="pallas"``) ---
    tile_elems: int = 1 << 15     # elements per tile of the level tile sort
    block_rows: int = 8           # rows of arena slack after every bucket
    range_bits: int = 8           # log2(ranges) per distribution level

    # --- planner (sample -> bounds) ---
    fudge: float = 1.125          # v3 per-range over-allocation slack
    sample_rate: float = 0.005    # sample fraction of N (msb_64.c:2320)
    sample_cap: int = 500_000     # max sample size       (msb_64.c:2321-2322)
    use_sample_splitters: bool = True   # hybrid sample+radix delimiters

    # --- v3/v4 engine geometry (None = auto) ---
    v3_sort_rows: int = 1024          # tile rows (x128) incl. rmax pad rows
    v3_rmax: Optional[int] = None     # ranges per parent per level
    v3_cap_rows: Optional[int] = None  # terminal bucket capacity rows

    # --- LSB engine (``engine="lsb"``) ---
    lsb_digit_bits: int = 8       # digit width per LSB pass (msb_64.c:1533)

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
    # CPU tensor) | "v4" | "v5" | "v3" | "pallas" (the v1 engine) |
    # "xla" (the reference's portable engine: stable by key) | "lsb"
    # (LSB digit passes: stable by key) | "torch"
    engine: str = "auto"

    def __post_init__(self):
        # the reference's checks (``inplacemsdradixsort_tpu/config.py``)
        if self.tile_elems % LANES:
            raise ValueError(f"tile_elems={self.tile_elems} is not a "
                             f"multiple of {LANES}")
        if not 1 <= self.range_bits <= 12:
            raise ValueError(f"range_bits={self.range_bits} outside [1, 12]")
        if not self.fudge >= 1.0:
            raise ValueError(f"fudge={self.fudge} is below 1.0")

    @property
    def tile_rows(self) -> int:
        return self.tile_elems // LANES


DEFAULT_CONFIG = SortConfig()
