"""Helpers shared by the port's parity tests against the JAX package.

``lax_network`` runs the reference's v4 kernels with ``lax.sort`` as
their in-tile sort in place of ``netsort.net_sort_multi``: for ``nlex =
nplanes - 1`` both give the one ascending order of the tuples, and the
network's interpret-mode compile takes minutes for three planes.  The
network itself is held against the port's plain versions at small
capacities in ``tests/test_torch_kernels_v4.py``.
"""

import contextlib

import jax

from inplacemsdradixsort_tpu.ops import kernels_v4 as jk


def lax_sort_multi(planes, nlex=None):
    """``net_sort_multi``'s order by ``lax.sort``: (rows, 128) planes
    sorted in flat order, lexicographic over planes 0..nlex."""
    nlex = len(planes) - 1 if nlex is None else nlex
    shape = planes[0].shape
    out = jax.lax.sort(tuple(p.reshape(-1) for p in planes),
                       num_keys=nlex + 1, is_stable=True)
    return tuple(o.reshape(shape) for o in out)


@contextlib.contextmanager
def lax_network():
    """Run the reference kernels with ``lax_sort_multi`` as their in-tile
    sort; the kernel caches are cleared on both sides so that no kernel
    built with it outlives the block."""
    saved = jk.net_sort_multi
    jk.net_sort_multi = lax_sort_multi
    jk._route_exe.cache_clear()
    jk._terminal_exe.cache_clear()
    try:
        yield
    finally:
        jk.net_sort_multi = saved
        jk._route_exe.cache_clear()
        jk._terminal_exe.cache_clear()
