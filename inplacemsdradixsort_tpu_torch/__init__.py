"""inplacemsdradixsort_tpu_torch — the radix partitioning & sort engine on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``inplacemsdradixsort_tpu`` (JAX/Pallas on a TPU), which stays
in the repository as the reference the port is tested against.  This
package imports torch and numpy only.

Public API:
    sort, sort_with_indices, check, mamalloc, SortConfig, SortResult
"""

from .api import SortResult, check, mamalloc, sort, sort_with_indices
from .config import DEFAULT_CONFIG, SortConfig

__all__ = [
    "sort",
    "sort_with_indices",
    "check",
    "mamalloc",
    "SortConfig",
    "DEFAULT_CONFIG",
    "SortResult",
]

__version__ = "0.1.0"
