"""Out-of-core chunked sort on PyTorch: inputs larger than one resident
sort takes — ``inplacemsdradixsort_tpu``'s ``ops/chunked.py``.

``sort_external`` is the reference's range exchange (msb_64.c:1672-2158)
with the card as the one compute domain and the caller's source as the
other, over caller-supplied chunks:

1. SAMPLE (``sample``): stream the chunks once, draw a sample of each,
   and cut duplicate-aware equal-depth bounds with heavy-value isolation
   from the combined sample (msb_64.c:1304-1322).
2. COUNT (``part_first``): stream the chunks again; ``hist_level`` gives
   each chunk's exact per-(tile, range) counts.
3. LAYOUT (``combine``, host): exact positions of every (chunk, tile,
   range) run in ONE range-major arena, with a 64-row gap after each
   range.
4. ROUTE (``part_blocks``): stream the chunks a third time; each chunk's
   ``route_level`` call in accumulate mode stores its runs into the
   shared arena in place.  Peak memory is the arena and one chunk, about
   1.3 x the input at 16 chunks.
5. LOCAL (``local_sort``): per range, ``splice_runs`` gathers the real
   prefix of each of the range's runs, chunk by chunk and tile by tile,
   into dense planes (the row-alignment pads dropped, the words
   unbiased), the v4 engine sorts them, and the piece is yielded.

The reference sorts each range's window of P arena rows instead, with
the rows past the range's own masked to SENT, and trims the pads
(value = the range's upper bound, payload SENT) and the SENT tail from
the sorted window: a static shape for its jit.  With payload planes
those are heavy tuples that v4 may not value-fill, and on the card the
window sort of 2^30 pairs fell into the deep tier (41.8 s, PERF.md);
the splice gives the same sorted pieces.

The output is a stream of contiguous sorted pieces in ascending key-range
order; their concatenation is the sorted input.  Pairs are ordered
lexicographically by (key, payload), as v4 orders them.  A heavy
single-value range of a keys-only input is filled with its value instead
of sorted.

``chunk_fn(i)`` is called three times per chunk (sample, count, route),
and must give the same data each time.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..config import SortConfig
from ..utils.timing import PhaseTimer
from . import kernels_v4 as kv4
from .engine_v4 import sort_v4
from .kernels_v4 import CHUNK_ROWS, LANES
from .plan_util import U32_MAX, _bias_np, _ceil_div, _quantile_bounds

Planes = Tuple[torch.Tensor, ...]


def _rmax_class(nb: int) -> int:
    for c in (16, 32, 48, 64, 96):
        if nb <= c:
            return c
    raise ValueError(f"too many ranges {nb}")


def _draw_sample(chunk: torch.Tensor, ssz: int, salt: int) -> np.ndarray:
    """Element-granular uniform sample of one chunk (drawn on its device
    by a generator seeded from the chunk's length and ``salt``), as
    uint32 on the host."""
    n = int(chunk.shape[0])
    words = chunk.view(torch.int32)
    rows = max(n // LANES, 1)
    if rows <= 1 or ssz >= rows:
        s = words[: min(n, ssz)]
    else:
        g = torch.Generator(device=chunk.device)
        g.manual_seed((n & 0xFFFFFF) ^ (salt * 2654435761 & 0x7FFFFFFF))
        idx = torch.randint(0, rows, (ssz,), generator=g,
                            device=chunk.device)
        picked = words[: rows * LANES].view(rows, LANES)[idx]
        lane = (idx * 89 + torch.arange(ssz, device=chunk.device) * 37) \
            % LANES
        s = torch.gather(picked, 1, lane[:, None]).reshape(-1)
    return s.cpu().numpy().view(np.uint32)


def _bounds_from_sample(sample: np.ndarray, nb_want: int):
    """Host: duplicate-aware equal-depth bounds from the combined sample
    (the reference's ``extract_delimiters``, msb_64.c:1304-1322).
    Returns (bounds, est_frac, is_heavy), as ``_quantile_bounds``."""
    s = np.sort(sample.astype(np.uint64))
    S = len(s)
    nbq = 4 * nb_want
    pos = np.clip((np.arange(1, nbq + 1, dtype=np.int64) * S) // nbq - 1,
                  0, S - 1)
    picks = s[pos].astype(np.uint64)
    picks[-1] = np.uint64(U32_MAX)
    left = np.searchsorted(s, picks, side="left").astype(np.int32)
    right = np.searchsorted(s, picks, side="right").astype(np.int32)
    heavy_frac = max(0.3 / nb_want, 0.002)
    return _quantile_bounds(picks.astype(np.uint32), left, right, S,
                            heavy_frac, cap_frac=1.0 / nb_want)


def _route_into(arenas: Planes, p2d: Planes, meta, bounds, h, dst, padv, *,
                arena_rows: int, ntiles: int, pitch: int, rmax: int
                ) -> Planes:
    """Route one chunk's runs into the shared arena, in place
    (``route_level``'s accumulate mode)."""
    return kv4.route_level(p2d, meta, bounds, h, dst, padv, arena_rows,
                           ntiles, pitch, rmax, bias_input=True,
                           arenas=arenas)


def _to2d(planes: Planes) -> Planes:
    """A chunk's planes as the route reads them: int32 views of the raw
    words.  The reference pads each plane with SENT to whole tiles of
    (rows, 128), because its kernels copy whole tiles; the port's kernels
    read each tile's element count, so no copy is made."""
    return tuple(p.contiguous().view(torch.int32) for p in planes)


def _chunk_meta(n_i: int, pitch: int, device) -> Tuple[torch.Tensor, int]:
    """The tile table of one chunk's dense planes, and its tile count."""
    ntiles = _ceil_div(_ceil_div(n_i, LANES), pitch)
    m = np.zeros(((ntiles + 1) * 3,), np.int64)
    t = np.arange(ntiles, dtype=np.int64)
    m[1:3 * ntiles:3] = t * pitch
    m[2:3 * ntiles:3] = np.minimum(n_i - t * pitch * LANES, pitch * LANES)
    return torch.from_numpy(m.astype(np.int32)).to(device), ntiles


def _layout(hists, rmax: int):
    """Host: the range-major arena layout of every chunk's runs (the
    reference's ``combine`` phase).  Returns a dict of numpy arrays:
    ``rrows`` (per chunk (ntiles, rmax) rows of each run), ``real_r`` and
    ``range_start`` (rmax,), ``chunk_base`` (nchunks, rmax), and
    ``arena_rows``.  The reference's arena also holds P more rows, for
    its local sort's window."""
    rrows = [(h + (-h) % LANES) // LANES for h in hists]
    rows_ci = np.stack([r.sum(axis=0) for r in rrows])      # (nchunks, rmax)
    range_rows = rows_ci.sum(axis=0)
    real_r = np.stack([h.sum(axis=0) for h in hists]).sum(axis=0)
    alloc = range_rows + CHUNK_ROWS                          # gap per range
    range_start = np.concatenate([[0], np.cumsum(alloc)[:-1]]).astype(
        np.int64)
    chunk_base = np.concatenate(
        [np.zeros((1, rmax), np.int64), np.cumsum(rows_ci, axis=0)[:-1]],
        axis=0)
    return dict(rrows=rrows, real_r=real_r, range_start=range_start,
                chunk_base=chunk_base, arena_rows=int(alloc.sum()))


def _planes_of(x) -> Planes:
    return x if isinstance(x, tuple) else (x,)


def sort_external(
    chunk_fn: Callable[[int], Tuple[torch.Tensor, ...]],
    nchunks: int,
    total_n: int,
    cfg: Optional[SortConfig] = None,
    nranges: Optional[int] = None,
    timer: Optional[PhaseTimer] = None,
) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Sort ``total_n`` uint32 keys supplied as ``nchunks`` chunks.

    ``chunk_fn(i)`` returns chunk i's planes (keys, *payload planes) as
    uint32 tensors on one device, the same each time: it is called three
    times per chunk.  Yields the sorted result as a stream of contiguous
    uint32 plane tuples in ascending key-range order (the concatenation
    is the sorted sequence, lexicographic by (key, *payload)).  Heavy
    single-value ranges of a keys-only input are value-filled without a
    sort."""
    cfg = cfg or SortConfig()
    timer = timer or PhaseTimer(enabled=False)
    if nchunks < 1:
        raise ValueError(f"nchunks={nchunks}")

    # ---- ranges: about 2^27 elements each, so that every local sort's
    # own arenas stay far below the card's memory
    if nranges is None:
        nranges = max(4, min(64, _ceil_div(total_n, 1 << 27)))

    # ---------------- pass 1a: sample
    with timer.phase("sample"):
        ssz = int(min(max(cfg.sample_rate * total_n, 4096),
                      cfg.sample_cap)) // nchunks + 1
        samples, chunk_elems = [], []
        for i in range(nchunks):
            planes = _planes_of(chunk_fn(i))
            nplanes, dev = len(planes), planes[0].device
            chunk_elems.append(int(planes[0].shape[0]))
            samples.append(_draw_sample(planes[0], ssz, salt=i))
            del planes
        if sum(chunk_elems) != total_n:
            raise ValueError(f"chunks hold {sum(chunk_elems)} elements, "
                             f"total_n={total_n}")
        bounds, _, is_heavy = _bounds_from_sample(np.concatenate(samples),
                                                  nranges)
        nb = len(bounds)
        rmax = _rmax_class(nb)
        bounds_pad = np.full(rmax, U32_MAX, np.uint64)
        bounds_pad[:nb] = bounds
        bounds_biased = _bias_np(bounds_pad.astype(np.uint32))
        bounds_t = torch.from_numpy(bounds_biased.copy()).to(dev)
        pitch = cfg.v3_sort_rows - rmax
        if pitch <= 0:
            raise ValueError(f"v3_sort_rows={cfg.v3_sort_rows} leaves no "
                             f"tile rows beside rmax={rmax}")

    # ---------------- pass 1b: exact histograms
    with timer.phase("part_first"):
        hists = []
        for i in range(nchunks):
            planes = _planes_of(chunk_fn(i))
            meta, ntiles = _chunk_meta(chunk_elems[i], pitch, dev)
            h = kv4.hist_level(_to2d(planes[:1])[0], meta, bounds_t, ntiles,
                               pitch, rmax, bias_input=True)
            hists.append(h.cpu().numpy())
            del planes

    # ---------------- host layout: exact range-major arena positions
    with timer.phase("combine"):
        lay = _layout(hists, rmax)
        range_start, arena_rows = lay["range_start"], lay["arena_rows"]

    # ---------------- pass 2: route the chunks into the shared arena
    with timer.phase("part_blocks"):
        # only the runs' rows are ever read (the reference fills the
        # arena with SENT for its window sort)
        arenas = tuple(torch.empty((arena_rows, LANES), dtype=torch.int32,
                                   device=dev) for _ in range(nplanes))
        dsts = []
        for i in range(nchunks):
            planes = _planes_of(chunk_fn(i))
            meta, ntiles = _chunk_meta(chunk_elems[i], pitch, dev)
            rr = lay["rrows"][i]
            dst = (range_start[None, :] + lay["chunk_base"][i][None, :]
                   + np.cumsum(rr, axis=0) - rr).astype(np.int32)
            dsts.append(dst)
            padv = np.ascontiguousarray(
                np.broadcast_to(bounds_biased[None, :], (ntiles, rmax)))
            arenas = _route_into(
                arenas, _to2d(planes), meta, bounds_t,
                torch.from_numpy(hists[i]).to(dev),
                torch.from_numpy(dst).to(dev), torch.from_numpy(padv).to(dev),
                arena_rows=arena_rows, ntiles=ntiles, pitch=pitch, rmax=rmax)
            del planes
        timer.sync(arenas[0])

    # ---------------- per range: splice + local sort, yielded in order
    for r in range(nb):
        real = int(lay["real_r"][r])
        if real == 0:
            continue
        with timer.phase("local_sort"):
            if bool(is_heavy[r]) and nplanes == 1:
                word = int(np.uint32(bounds[r]).view(np.int32))
                piece = (torch.full((real,), word, dtype=torch.int32,
                                    device=dev).view(torch.uint32),)
            else:
                # the range's runs in (chunk, tile) order: (src_row, occ,
                # real, ., ., out_off, ., .)
                cnt = np.concatenate([h[:, r] for h in hists])
                btbl = np.zeros((cnt.shape[0], 8), np.int32)
                btbl[:, 0] = np.concatenate([d[:, r] for d in dsts])
                btbl[:, 1] = np.concatenate([x[:, r] for x in lay["rrows"]])
                btbl[:, 2] = cnt
                btbl[:, 5] = np.cumsum(cnt) - cnt
                dense = kv4.splice_runs(arenas, torch.from_numpy(btbl).to(dev),
                                        real, max_occ=pitch,
                                        unbias_output=True)
                out0, outs = sort_v4(dense[0], dense[1:], cfg)
                del dense
                piece = tuple(x.view(torch.uint32)
                              for x in (out0,) + tuple(outs))
                del out0, outs
            timer.sync(piece[0])
        yield piece
