"""Helpers shared by the port's parity tests against the JAX package.

``lax_network`` runs the reference's v4 kernels with ``lax.sort`` as
their in-tile sort in place of ``netsort.net_sort_multi``: for ``nlex =
nplanes - 1`` both give the one ascending order of the tuples, and the
network's interpret-mode compile takes minutes for three planes.  The
network itself is held against the port's plain versions at small
capacities in ``tests/test_torch_kernels_v4.py``.  ``lax_network_v3``
does the same for the v3 kernels' ``netsort.net_sort`` (pairs cases;
the keys-only cases keep the network).
"""

import contextlib

import jax

from inplacemsdradixsort_tpu.ops import kernels_v3 as jk3
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


def lax_sort_pairs(key, val=None):
    """``net_sort``'s order by ``lax.sort``: a (rows, 128) block sorted in
    flat order, by (key, val) when ``val`` rides along."""
    planes = (key,) if val is None else (key, val)
    out = lax_sort_multi(planes)
    return out[0], (out[1] if val is not None else None)


@contextlib.contextmanager
def lax_network_v3():
    """Run the reference's v3 kernels with ``lax_sort_pairs`` as their
    in-tile sort; their kernel caches are cleared on both sides."""
    saved = jk3.net_sort
    jk3.net_sort = lax_sort_pairs
    jk3._partition_exe.cache_clear()
    jk3._terminal_exe.cache_clear()
    try:
        yield
    finally:
        jk3.net_sort = saved
        jk3._partition_exe.cache_clear()
        jk3._terminal_exe.cache_clear()
