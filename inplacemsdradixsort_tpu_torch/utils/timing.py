"""Phase timing & the 10-row report (the reference's ``times[0..9]``,
msb_64.c:2384-2412), on PyTorch.

The port runs eagerly, so a phase is a host-clock span that ends with
``sync``; on a CUDA tensor ``sync`` waits for the device.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List

import torch

# Reference row labels, msb_64.c:2384-2412.
PHASE_LABELS: List[str] = [
    "sample",          # P1-P3: sampling + sample sort + splitters
    "part_first",      # P4: first-chunk partition
    "part_blocks",     # P5: partition levels (hist + route)
    "combine",         # P6: combine open blocks
    "compact",         # P7: per-node compaction
    "balance",         # P8: inter-node balance
    "swap_online",     # P9: online block permute
    "swap_offline",    # P10: offline block place
    "inject",          # P11: splice half blocks
    "local_sort",      # P12: local sort -> terminal bucket sort
]


class PhaseTimer:
    """Accumulates wall-clock seconds per named phase."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times: Dict[str, float] = {}

    @contextmanager
    def phase(self, label: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        yield
        self.times[label] = self.times.get(label, 0.0) + (
            time.perf_counter() - t0
        )

    def sync(self, *values) -> None:
        """Wait for the device work behind ``values`` (phase boundary)."""
        if self.enabled:
            for v in values:
                if isinstance(v, torch.Tensor) and v.is_cuda:
                    torch.cuda.synchronize(v.device)

    def report(self) -> List[tuple]:
        """The 10-row (description, seconds) report, reference order."""
        return [(lbl, self.times.get(lbl, 0.0)) for lbl in PHASE_LABELS]
