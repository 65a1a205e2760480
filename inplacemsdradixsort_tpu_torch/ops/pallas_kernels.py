"""The v1 engine's four kernels, on PyTorch: ``tile_sort``,
``distribute``, ``ragged_sort`` and ``compact`` (the reference's
``inplacemsdradixsort_tpu/ops/pallas_kernels.py``, same signatures
without ``interpret``).

Each public function dispatches on the device of its input tensors: a
CPU tensor runs the plain PyTorch version (``*_ref``), a CUDA tensor
launches the hand-written kernels in ``csrc/pallas_kernels.cu`` and
raises if that fails.  Nothing falls back from one to the other.  All
four are CUDA C++ rather than Triton: they share the cluster launcher,
the bitonic network of ``ragged_sort`` (whose merges also join the runs
of a tile too large for one ``tile_sort`` cluster) and the build of the
v4 terminal kernel.

Arenas are (rows, 128) int32 planes: keys in the sign-biased encoding
(``bitonic.bias_u32``), and optionally one value plane; tuples order
lexicographically by (key, val), and SENT (biased +inf in both planes)
pads tiles, slots and buckets and sorts last.

``tile_sort`` and ``ragged_sort`` sort in place and return their input
tensors (the reference's executables donate them); ``distribute`` and
``compact`` return new arenas, whose rows outside the runs or segments
they store are uninitialised.

The int32 tables of one call lie together on the arena's device or on
the CPU.  ``distribute``, ``ragged_sort`` and ``compact`` raise
``ValueError`` on tables that place a run, slot, live bucket or segment
outside its arena, before either version runs: a few reductions over
the tables where they lie and one read of their flags, which costs a
sync for tables on the card and none for tables on the host (then
copied to the card with ``non_blocking``).  The engine passes all three
their tables on the host.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import kernels_v4 as kv4
from .bitonic import bitonic_sort
from .kernels_v4 import LANES, SENT, _check, _p, _spans

# the reference keeps a tile's R bounds, R counts and data count in one
# (8, 128) SMEM table; the port keeps its limit so both refuse the same
# configs (range_bits <= 8)
TABLE_ENTRIES = 8 * LANES

# output elements one CUDA block of ``compact`` writes, by plane count,
# and a first-segment entry of its table covers (csrc/pallas_kernels.cu's
# compact_span and COMPACT_GROUP)
COMPACT_SPAN = {1: 32768, 2: 4096}
COMPACT_GROUP = 32768

# the CUDA tile_sort sorts a tile of up to TILE_SORT_RUN[planes] tuples in
# one pass, in the shared memory of one cluster of at most 8 CTAs of 2^15
# keys or 2^14 pairs (csrc/pallas_kernels.cu's rs_cap_log); a larger tile
# is sorted as runs of that size, which merge launches then join
TILE_SORT_RUN = {1: 1 << 18, 2: 1 << 17}

# launches of each kernel since the last reset (plain versions not counted)
LAUNCHES = {"tile_sort": 0, "distribute": 0, "ragged_sort": 0,
            "compact": 0}

Pair = Tuple[torch.Tensor, Optional[torch.Tensor]]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    kv4._call(kernel, fn_name, device, *args)
    LAUNCHES[kernel] += 1


def _check_arena(name: str, keys: torch.Tensor,
                 vals: Optional[torch.Tensor]) -> torch.device:
    dev = keys.device
    _check(name, keys, dev)
    if keys.dim() != 2 or keys.shape[1] != LANES:
        raise ValueError(f"{name}: expected (rows, {LANES}), got "
                         f"{tuple(keys.shape)}")
    if vals is not None:
        _check(f"{name} vals", vals, dev)
        if vals.shape != keys.shape:
            raise ValueError(f"{name}: vals {tuple(vals.shape)} != keys "
                             f"{tuple(keys.shape)}")
    return dev


def _tables(dev: torch.device, **tables) -> None:
    """Check a call's tables: int32, contiguous, all on ``dev`` or all
    on the CPU."""
    where = next(iter(tables.values())).device
    if where.type != "cpu":
        where = dev
    for name, t in tables.items():
        _check(name, t, where)


def _on(dev: torch.device, *tables: torch.Tensor):
    return tuple(t.to(dev, non_blocking=True) for t in tables)


def _i64(t: torch.Tensor):
    """A table as int64 for its checks: a numpy array for a table on the
    host, a tensor for one on the card."""
    return t.numpy().astype(np.int64) if t.device.type == "cpu" \
        else t.long()


def _outside(start, size, limit: int):
    """True if a span [start, start + size) with size > 0 leaves
    [0, limit) (int64 element offsets, numpy or torch)."""
    return ((size > 0) & ((start < 0) | (start + size > limit))).any()


def _refuse(name: str, *checks) -> None:
    """Raise ValueError with the message of the first (message, flag)
    whose flag is true; flags on the card are read at once."""
    flags = [flag for _, flag in checks]
    if torch.is_tensor(flags[0]):
        flags = torch.stack(flags).tolist()
    for (msg, _), bad in zip(checks, flags):
        if bad:
            raise ValueError(f"{name}: {msg}")


def _compact_checks(starts_row, lens, out_rows: int, numel: int):
    """``compact``'s (message, flag) refusals over int64 tables (numpy on
    the host, torch on the card)."""
    return (("negative lengths, or lengths past the output's rows",
             (lens < 0).any() | (lens.sum() > out_rows * LANES)),
            ("a segment lies outside the arena",
             _outside(starts_row * LANES, lens, numel)))


def _compact_table(starts_row: np.ndarray, lens: np.ndarray, group: int):
    """The CUDA ``compact``'s int64 table from host tables: each
    segment's first source element, the output offsets (the exclusive
    prefix sum of ``lens``, then the total) and the segment that holds
    the first element of each group of ``group`` output elements, then
    the last segment.  Returns (table, total)."""
    nseg = lens.size
    offs = np.zeros(nseg + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    # group g starts in segment s when ceil(offs[s] / group) <= g <
    # ceil(offs[s + 1] / group)
    first = np.repeat(np.arange(nseg), np.diff(-(-offs // group)))
    return (np.concatenate([starts_row.astype(np.int64) * LANES, offs,
                            first, [nseg - 1]]), int(offs[-1]))


def _runs_on_host(slot_rows, run_starts, run_lens, tile_elems: int,
                  out_rows: int) -> torch.Tensor:
    """Check ``distribute``'s host tables and pack their used columns.

    Returns a (3, ntiles, ru) int32 tensor of (slot_rows, run_starts,
    run_lens) over the first ``ru`` columns, past which every run is
    empty (ru is 0 if all are).  Raises ValueError as the checks on the
    card do.  It reads the length table once whole and the other two in
    the used columns only, with numpy in one thread (torch's threaded CPU
    ops stalled unpredictably on an H100 host): every entry, empty ones
    included, must pass the bounds in uint32 (a negative value wraps
    past them); only tables where one does not are checked entry by
    entry in int64, so that an empty entry may hold anything.
    """
    ln = run_lens.numpy()
    colmax = ln.max(axis=0) if ln.size else np.zeros(ln.shape[1], np.int32)
    used = np.flatnonzero(colmax > 0)
    ru = int(used[-1]) + 1 if used.size else 0
    packed = np.empty((3, ln.shape[0], ru), np.int32)
    for p, t in enumerate((slot_rows, run_starts, run_lens)):
        packed[p] = t.numpy()[:, :ru]
    if not packed.size:
        return torch.from_numpy(packed)
    slot, start, ln = packed
    u = packed.view(np.uint32)
    tmp = np.empty_like(u[0])
    # runs: start + len <= tile_elems, each in [0, tile_elems]
    bad = (colmax.max() > tile_elems or u[1].max() > tile_elems
           or np.add(u[1], u[2], out=tmp).max() > tile_elems)
    if bad:
        start64 = start.astype(np.int64)
        bad = ((ln > 0) & ((start64 < 0) | (start64 + ln > tile_elems))).any()
    if bad:
        raise ValueError("distribute: a run lies outside its tile")
    # slots: slot + rows(len) <= out_rows
    np.add(u[2], LANES - 1, out=tmp)
    np.right_shift(tmp, 7, out=tmp)
    bad = (u[0].max() > out_rows
           or np.add(tmp, u[0], out=tmp).max() > out_rows)
    if bad:
        rows = (ln.astype(np.int64) + LANES - 1) // LANES
        bad = ((ln > 0) & ((slot < 0) | (slot + rows > out_rows))).any()
    if bad:
        raise ValueError("distribute: a slot lies outside the output arena")
    return torch.from_numpy(packed)


def _planes(keys, vals):
    return (keys,) if vals is None else (keys, vals)


def _vp(vals):
    """The value plane's pointer, NULL when keys sort alone."""
    return ctypes.c_void_p(0) if vals is None else _p(vals)


# ----------------------------------------------------- plain versions

def _sort_masked(k, v, live):
    """Blocks (nb, m) with the elements at or past ``live`` (nb,) taken as
    SENT, sorted by (key, val)."""
    mask = torch.arange(k.shape[1], device=k.device)[None, :] \
        < live[:, None]
    blocks = (k.shape[0], -1, LANES)
    k = torch.where(mask, k, SENT).view(blocks)
    v = None if v is None else torch.where(mask, v, SENT).view(blocks)
    k, v = bitonic_sort(k, v)
    return k.view(k.shape[0], -1), (None if v is None
                                    else v.view(v.shape[0], -1))


def tile_sort_ref(keys, vals, bounds, data_elems, tile_rows):
    bounds, data_elems = _on(keys.device, bounds, data_elems)
    ntiles = keys.shape[0] // tile_rows
    te = tile_rows * LANES
    k, v = _sort_masked(keys.view(ntiles, te),
                        None if vals is None else vals.view(ntiles, te),
                        data_elems.long())
    keys.view(ntiles, te).copy_(k)
    if vals is not None:
        vals.view(ntiles, te).copy_(v)
    cnt = torch.searchsorted(k, bounds.contiguous(), right=True)
    return keys, vals, cnt.to(torch.int32)


def distribute_ref(keys, vals, slot_rows, run_starts, run_lens, out_rows,
                   tile_rows, chr_rows=8):
    ntiles, r = slot_rows.shape
    dev = keys.device
    slot_rows, run_starts, run_lens = _on(dev, slot_rows, run_starts,
                                          run_lens)
    ln = run_lens.reshape(-1).long()
    live = ln > 0
    ln = ln[live]
    padded = (ln + LANES - 1) // LANES * LANES
    tile = torch.arange(ntiles, device=dev).repeat_interleave(r)[live]
    src0 = tile * (tile_rows * LANES) + run_starts.reshape(-1).long()[live]
    dst0 = slot_rows.reshape(-1).long()[live] * LANES
    pos = _spans(dst0, padded)
    e = pos - torch.repeat_interleave(dst0, padded)
    ok = e < torch.repeat_interleave(ln, padded)
    idx = torch.where(ok, torch.repeat_interleave(src0, padded) + e, 0)
    outs = []
    for x in _planes(keys, vals):
        out = torch.empty(out_rows * LANES, dtype=torch.int32, device=dev)
        out[pos] = torch.where(ok, x.reshape(-1)[idx], SENT)
        outs.append(out.view(out_rows, LANES))
    return outs[0], (outs[1] if vals is not None else None)


def ragged_sort_ref(keys, vals, starts_row, pad_elems, class_rows):
    starts_row, pad_elems = _on(keys.device, starts_row, pad_elems)
    pads = pad_elems.long()
    live = pads > 0                     # pad 0: the grid's dummy buckets
    if not bool(live.any()):
        return keys, vals
    m = class_rows * LANES
    idx = starts_row.long()[live][:, None] * LANES \
        + torch.arange(m, device=keys.device)[None, :]
    v = None if vals is None else vals.reshape(-1)[idx]
    k, v = _sort_masked(keys.reshape(-1)[idx], v, pads[live])
    keys.view(-1)[idx] = k
    if vals is not None:
        vals.view(-1)[idx] = v
    return keys, vals


def compact_ref(keys, vals, starts_row, lens, out_rows, chr_rows=8):
    starts_row, lens = _on(keys.device, starts_row, lens)
    ln = lens.long()
    pos = _spans(torch.cumsum(ln, 0) - ln, ln)
    idx = _spans(starts_row.long() * LANES, ln)
    outs = []
    for x in _planes(keys, vals):
        out = torch.empty(out_rows * LANES, dtype=torch.int32,
                          device=keys.device)
        out[pos] = x.reshape(-1)[idx]
        outs.append(out.view(out_rows, LANES))
    return outs[0], (outs[1] if vals is not None else None)


def defined_elems(name: str, a: dict, numel: int) -> torch.Tensor:
    """Bool mask over the flat output planes of one call of kernel
    ``name`` (its arguments ``a`` by name) that is True where the output
    is defined: everything after ``tile_sort``; each stored run's rows
    after ``distribute``; each live bucket after ``ragged_sort``; the
    first sum(lens) elements after ``compact``."""
    dev = a["keys"].device
    a = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in a.items()}
    if name == "tile_sort":
        return torch.ones(numel, dtype=torch.bool, device=dev)
    if name == "compact":
        return torch.arange(numel, device=dev) < a["lens"].long().sum()
    if name == "distribute":
        ln = a["run_lens"].reshape(-1).long()
        live = ln > 0
        start = a["slot_rows"].reshape(-1).long()[live] * LANES
        size = (ln[live] + LANES - 1) // LANES * LANES
    else:
        live = a["pad_elems"].long() > 0
        start = a["starts_row"].long()[live] * LANES
        size = torch.full_like(start, a["class_rows"] * LANES)
    mask = torch.zeros(numel, dtype=torch.bool, device=dev)
    mask[_spans(start, size)] = True
    return mask


# ---------------------------------------------------------- kernels

def tile_sort(keys: torch.Tensor, vals: Optional[torch.Tensor],
              bounds: torch.Tensor, data_elems: torch.Tensor,
              tile_rows: int
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Sort every (tile_rows, 128) tile of ``keys`` (by (key, val) when
    ``vals`` rides along) in place, the elements at or past
    ``data_elems[t]`` taken as SENT; count each tile's range bounds.

    bounds: (ntiles, R) int32 biased inclusive upper bounds.  Returns
    (keys, vals, cnt) with cnt[t, d] the number of elements of sorted tile
    t (SENT included) that are <= bounds[t, d]; the engine overrides
    column R-1 with its exact valid count.

    Replaces ``pallas_kernels.py:59-170`` (``_tile_sort_exe``).  The TPU
    sorts a tile in VMEM with ``bitonic.bitonic_sort`` and counts each
    bound with a full-tile reduction (R x tile compares).  On the H100 the
    bound is one read and one write of every tile (0.64 ms for 2^28 keys,
    1.28 ms for pairs), if the sort keeps up on chip.  A tile of 2^15 pairs
    (256 KiB) fills no one CTA's shared memory, and a bitonic network over
    device memory made six passes over it.  Design (``tile_radix_kernel``):
    one thread-block cluster per tile (a CTA of 1024 threads holds 2^15
    keys or 2^14 pairs, so one CTA keys-only and two with pairs at the
    default 2^15-element tile, and 1-8 CTAs for any tile up to
    ``TILE_SORT_RUN`` tuples, the largest single-pass tile: 2^18 keys, 2^17
    pairs) keeps the tile in shared memory from one read to one write and
    sorts it there by a least-significant-digit radix sort: 8-bit digits
    over only the bits that vary among the tile's live tuples (the OR of x
    ^ x[0]: 4 passes for uniform u32 keys, fewer where a level's tile
    shares its top bits), first the value's, then the key's.  Every pass
    but the first is stable: it is ranked row by row through per-(warp,
    digit) peer masks, the first (whose input order does not matter) by one
    shared atomic a tuple; tuples go to the CTA that holds their new
    position, through distributed shared memory between CTAs, a pair as one
    8-byte word.  The slack past ``data_elems[t]`` is not read, ranked or
    sorted: it is written as SENT after the live tuples.  Each bound is
    then counted by a binary search on the sorted tile while it is still on
    chip.  A larger tile is sorted as runs of ``TILE_SORT_RUN`` tuples
    (their counts added into a zeroed table), which the bitonic merges of
    ``ragged_sort`` join (``global_step_kernel`` and a cluster launch in
    merge mode).  What bounds it on the card is the ranking and the scatter
    through shared memory, not device memory.  CUDA rather than Triton: the
    passes live in one cluster's shared memory between cluster barriers,
    with warp-level ranking and stores into other CTAs' shared memory,
    which Triton's block model does not express.
    """
    dev = _check_arena("tile_sort", keys, vals)
    _tables(dev, bounds=bounds, data_elems=data_elems)
    if keys.shape[0] % tile_rows:
        raise ValueError(f"tile_sort: {keys.shape[0]} rows is not a "
                         f"multiple of tile_rows={tile_rows}")
    ntiles = keys.shape[0] // tile_rows
    if bounds.dim() != 2 or bounds.shape[0] != ntiles \
            or data_elems.numel() != ntiles:
        raise ValueError(f"tile_sort: bounds {tuple(bounds.shape)} and "
                         f"data_elems {tuple(data_elems.shape)} for "
                         f"{ntiles} tiles")
    if dev.type == "cpu":
        return tile_sort_ref(keys, vals, bounds, data_elems, tile_rows)
    r = bounds.shape[1]
    te = tile_rows * LANES
    nplanes = len(_planes(keys, vals))
    cnt = (torch.zeros if te > TILE_SORT_RUN[nplanes] else torch.empty)(
        (ntiles, r), dtype=torch.int32, device=dev)
    bounds, data_elems = _on(dev, bounds, data_elems)
    if ntiles:
        _launch("tile_sort", "kv1_tile_sort", dev, _p(keys), _vp(vals),
                _p(bounds), _p(data_elems), _p(cnt), ntiles, te, r,
                nplanes)
    return keys, vals, cnt


def distribute(keys: torch.Tensor, vals: Optional[torch.Tensor],
               slot_rows: torch.Tensor, run_starts: torch.Tensor,
               run_lens: torch.Tensor, out_rows: int, tile_rows: int,
               chr_rows: int = 8) -> Pair:
    """Copy every (tile, range) run to its row-aligned slot of a new
    (out_rows, 128) arena.

    Run (t, d) is the ``run_lens[t, d]`` elements at element
    ``run_starts[t, d]`` of tile t; it lands at row ``slot_rows[t, d]``,
    and the lanes after it in its last row are SENT.  Rows that no run
    stores are uninitialised.  ``chr_rows`` is the reference's DMA chunk
    and is unused.

    Replaces ``pallas_kernels.py:186-360`` (``_distribute_kernel``).  The
    TPU writes each run in whole ``chr_rows`` chunks masked to SENT, so a
    run overshoots into the next tile's slot rows, which is right only
    because its grid runs tiles in order; here every store is
    element-exact (the run, then SENT to the end of its last row) and
    64-bit addressed, so runs may land in any order.  On the H100 it is a
    copy, bound by reading each run and writing its rows once.  Design:
    one CTA per tile stages the tile's non-empty runs in shared memory,
    brings the tile's extent (first run start to furthest run end) into
    shared memory with TMA bulk copies, 16K elements of one plane at a
    time (three CTAs an SM), and writes each run to its row-aligned slot
    with 16-byte stores.  CUDA C++ rather than Triton: Triton has no TMA
    bulk copy into an mbarrier.

    Tables on the host (the engine's) are checked there, and only their
    used columns (``_runs_on_host``) go to the card, with no sync; tables
    on the card are checked there, with one sync.
    """
    dev = _check_arena("distribute", keys, vals)
    _tables(dev, slot_rows=slot_rows, run_starts=run_starts,
            run_lens=run_lens)
    ntiles, r = slot_rows.shape
    if 3 * r > TABLE_ENTRIES:
        raise ValueError("num_ranges too large for table")
    if run_starts.shape != slot_rows.shape \
            or run_lens.shape != slot_rows.shape \
            or ntiles * tile_rows != keys.shape[0]:
        raise ValueError(f"distribute: tables {tuple(slot_rows.shape)} do "
                         f"not match {keys.shape[0]} rows of "
                         f"{tile_rows}-row tiles")
    if run_lens.device.type == "cpu":
        packed = _runs_on_host(slot_rows, run_starts, run_lens,
                               tile_rows * LANES, out_rows)
    else:
        ln = _i64(run_lens)
        _refuse("distribute",
                ("a run lies outside its tile",
                 _outside(_i64(run_starts), ln, tile_rows * LANES)),
                ("a slot lies outside the output arena",
                 _outside(_i64(slot_rows) * LANES,
                          (ln + LANES - 1) // LANES * LANES,
                          out_rows * LANES)))
        packed = None
    if dev.type == "cpu":
        return distribute_ref(keys, vals, slot_rows, run_starts, run_lens,
                              out_rows, tile_rows, chr_rows)
    outs = [torch.empty((out_rows, LANES), dtype=torch.int32, device=dev)
            for _ in _planes(keys, vals)]
    ov = outs[1] if vals is not None else None
    if packed is None:
        tables = _on(dev, slot_rows, run_starts, run_lens)
    else:
        r = packed.shape[2]
        tables = tuple(packed.to(dev, non_blocking=True))
    if ntiles * r:
        _launch("distribute", "kv1_distribute", dev, _p(keys), _vp(vals),
                keys.numel(), *map(_p, tables), _p(outs[0]), _vp(ov),
                outs[0].numel(), ntiles * r, r, tile_rows * LANES, len(outs))
    return outs[0], ov


def ragged_sort(keys: torch.Tensor, vals: Optional[torch.Tensor],
                starts_row: torch.Tensor, pad_elems: torch.Tensor,
                class_rows: int) -> Pair:
    """Sort ``nb`` buckets of ``class_rows`` rows in place, bucket b at
    row ``starts_row[b]``, its elements at or past ``pad_elems[b]`` taken
    as SENT.  Buckets with ``pad_elems[b] == 0`` are left as they are:
    the engine pads the grid to a power of two with such dummies, all
    pointing at one slack region.

    Replaces ``pallas_kernels.py:365-471`` (``_ragged_sort_kernel``), a
    whole bucket in VMEM.  On the H100 a class of up to 2048 rows (2^18
    keys, 1 MiB a plane) does not fit one block's shared memory, but it
    fits a thread-block cluster's: 8 CTAs x 128 KiB hold 2^18 keys or
    2^17 pairs.  The sort is bound by its passes over shared memory; the
    bound counts one read and one write of each live bucket.  Design: one
    cluster of 1, 2, 4 or 8 CTAs per live bucket, chosen per launch from
    the class's bytes, loads the bucket once (16-byte loads; the tail
    past its pad as SENT; a pair packed into one 64-bit word), sorts it
    in shared memory with a bitonic network whose steps run in
    registers, 32 keys or 16 pairs a thread at a time, and in
    distributed shared memory for the distances across CTAs (the network
    of ``csrc/cluster_sort.cuh``, which v4's ``terminal_write`` shares),
    and stores it once: one launch a call.  A class above 8 x 128
    KiB (``sort_vmem``'s one bucket of 2^20 keys) is sorted as cluster
    runs of that size and then merged: global steps for the distances of
    a run or more, the cluster kernel in merge mode for the shorter ones.
    Dummy buckets exit at once.  CUDA C++ rather than Triton: Triton has
    no thread-block clusters or distributed shared memory.
    """
    dev = _check_arena("ragged_sort", keys, vals)
    _tables(dev, starts_row=starts_row, pad_elems=pad_elems)
    if starts_row.numel() != pad_elems.numel():
        raise ValueError(f"ragged_sort: {starts_row.numel()} starts, "
                         f"{pad_elems.numel()} pads")
    _refuse("ragged_sort",
            ("a live bucket lies outside the arena",
             _outside(_i64(starts_row) * LANES,
                      (_i64(pad_elems) > 0) * (class_rows * LANES),
                      keys.numel())))
    if dev.type == "cpu":
        return ragged_sort_ref(keys, vals, starts_row, pad_elems,
                               class_rows)
    starts_row, pad_elems = _on(dev, starts_row, pad_elems)
    if starts_row.numel():
        _launch("ragged_sort", "kv1_ragged_sort", dev, _p(keys), _vp(vals),
                keys.numel(), _p(starts_row), _p(pad_elems),
                starts_row.numel(), class_rows * LANES,
                len(_planes(keys, vals)))
    return keys, vals


def compact(keys: torch.Tensor, vals: Optional[torch.Tensor],
            starts_row: torch.Tensor, lens: torch.Tensor, out_rows: int,
            chr_rows: int = 8) -> Pair:
    """Concatenate the first ``lens[s]`` elements at row ``starts_row[s]``
    of every segment s, in segment order, into a new (out_rows, 128)
    arena; elements past their total are uninitialised.  ``chr_rows`` is
    the reference's DMA chunk and is unused.

    Replaces ``pallas_kernels.py:476-663`` (``_compact_kernel``).  The TPU
    writes whole rows, so it shifts each segment by its lane phase and
    carries the partial row across grid steps, which must run in order.
    On the H100 it is a copy, bound by one read and one write of each
    element.  Design: output-tiled, so the work does not depend on how
    many segments there are or how long they are.  Each CUDA block writes
    ``COMPACT_SPAN`` output elements with aligned 16-byte stores, in
    rounds of 8 vectors a thread (4 with a value plane), all loads of a
    round in flight before its stores; a vector's segment comes from a
    binary search from the first segment of the block's group, and its
    elements from the aligned 16-byte source vector that holds its first
    element and the next one, which a shuffle takes from the next lane
    where that lane's vector follows in the same segment (segments start
    on rows).  Vectors that span segments are copied element by element.
    The offsets and the first segment of every ``COMPACT_GROUP`` output
    elements are made on the host (int64) and go to the card as one table
    with ``non_blocking`` from pageable memory (a pinned copy costs a
    page-locked allocation whenever the allocator's cache lacks one): no
    sync with tables on the host (the engine's), one with tables on the
    card (their check reads its flags there).  CUDA C++ rather than
    Triton: table-driven data movement with data-dependent spans, beside
    the v1 kernels that share its launcher and build.
    """
    dev = _check_arena("compact", keys, vals)
    _tables(dev, starts_row=starts_row, lens=lens)
    if starts_row.numel() != lens.numel():
        raise ValueError(f"compact: {starts_row.numel()} starts, "
                         f"{lens.numel()} lengths")
    _refuse("compact", *_compact_checks(_i64(starts_row), _i64(lens),
                                        out_rows, keys.numel()))
    if dev.type == "cpu":
        return compact_ref(keys, vals, starts_row, lens, out_rows, chr_rows)
    outs = [torch.empty((out_rows, LANES), dtype=torch.int32, device=dev)
            for _ in _planes(keys, vals)]
    ov = outs[1] if vals is not None else None
    if lens.numel():
        span = COMPACT_SPAN[len(outs)]
        table, total = _compact_table(starts_row.cpu().numpy(),
                                      lens.cpu().numpy(), COMPACT_GROUP)
        if total:
            table = torch.from_numpy(table).to(dev, non_blocking=True)
            _launch("compact", "kv1_compact", dev, _p(keys), _vp(vals),
                    _p(table), lens.numel(), -(-total // span), total,
                    span, COMPACT_GROUP, _p(outs[0]), _vp(ov), len(outs))
    return outs[0], ov
