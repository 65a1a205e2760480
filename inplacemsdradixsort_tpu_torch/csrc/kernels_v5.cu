// Hand-written Hopper (sm_90a) kernels of the v5 in-place engine: the
// sequential-block partition (seqroute_level) and the cycle block permute
// (block_permute), both in place over the working buffer W.
//
// Built by ops/_build.py, with the other sources of csrc/: one
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -c
// per source, all run together, then one link with -shared into one
// library with a plain C interface, loaded with ctypes.
// Every launcher takes PyTorch's current stream, allocates nothing (the
// wrapper passes staging, accumulators and cursors), does not
// synchronise, and returns cudaGetLastError().
//
// W is 1-4 int32 planes; a block is 256 rows x 128 lanes = 32768
// elements, and slot k of W holds elements [k * 32768, (k + 1) * 32768).
// Addresses are 64-bit: W passes 2^31 elements near the top size.
// The Python wrappers and their plain PyTorch versions live in
// ops/kernels_v5.py; the notes there say which TPU kernel each replaces
// and what bounds it on the H100.

#include <cuda_runtime.h>
#include <stdint.h>

#include "range_lut.cuh"

namespace {

constexpr int LANES = 128;
constexpr int32_t BIAS = INT32_MIN;
constexpr int32_t SENT = INT32_MAX;
constexpr int BLK_SHIFT = 15;
constexpr long long BLK = 1LL << BLK_SHIFT;
constexpr int MAX_PLANES = 4;
constexpr int COPY_THREADS = 256;    // stage / flush / drain blocks
constexpr int COPY_PARTS = 8;        // flush / drain blocks per range
constexpr int STAGE_U = 4;           // vectors a plane a staging step
constexpr int ROUTE_THREADS = 512;
constexpr int ROUTE_WARPS = ROUTE_THREADS / 32;
constexpr int ROUTE_E = 16;          // elements a thread holds of a chunk
constexpr int ROUTE_CHUNK = ROUTE_THREADS * ROUTE_E;  // 8192 a route block
constexpr size_t SMEM_MAX = 227 * 1024;  // shared memory a block may take
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int PERMUTE_THREADS = 256;
// blocks per chunk: each thread of them owns one int4 of every plane
constexpr int PERMUTE_SPLIT = (int)(BLK / 4 / PERMUTE_THREADS);
constexpr int PERMUTE_MAX_CHUNK = 1024;   // positions a chunk, at most

template <int NP>
struct Planes {
  int32_t* p[NP];
};

template <int NP>
Planes<NP> planes_of(void* const* ptrs) {
  Planes<NP> v;
  for (int q = 0; q < NP; ++q) v.p[q] = (int32_t*)ptrs[q];
  return v;
}

// Planes of one buffer laid out one after another, `stride` elements apart.
template <int NP>
Planes<NP> planes_at(int32_t* base, long long stride) {
  Planes<NP> v;
  for (int q = 0; q < NP; ++q) v.p[q] = base + q * stride;
  return v;
}

// Live elements of data tile t: meta[4t:4t+4] = (src_row, nelems, ., .),
// clamped to the tile and to W.
__device__ __forceinline__ long long tile_live(const int32_t* meta, int t,
                                               long long tile_elems,
                                               long long w_len) {
  const long long src = (long long)meta[4 * t] * LANES;
  long long nel = min((long long)meta[4 * t + 1], tile_elems);
  return max(0LL, min(nel, w_len - src));
}

// ----------------------------------------------------- seqroute_level
// Per window of tiles [t0, tend), in stream order:
// 1. stage_kernel copies the window's live elements out of W (and zeroes
//    the window's run cursors);
// 2. flush_kernel writes, for every range whose open block (the one its
//    stream reached before the window) completes inside the window, the
//    part of that block held in the accumulator to the block's slot;
// 3. route_kernel sends every staged element to its stream position:
//    straight to its block's W slot when the block completes by the
//    window's end, else into the range's accumulator (parity = block & 1;
//    a range has one open block at a window's end, and the flush of
//    step 2 ran before any element of the window lands in the parity
//    that block used).
// Every slot written in a window belongs to a block completed by a tile
// of the window or earlier, so it lies in rows those tiles have read:
// blocks are numbered in (tile, range) order of completion and a tile
// completes no more blocks than it holds elements.  After the last
// window drain_kernel pads every open block into its drain slot.

// One block per ROUTE_CHUNK elements of a window tile: the chunk goes to
// the staging buffer and, for the tile's first chunk, the tile's run
// cursors are zeroed.  Every load of a step (STAGE_U vectors of every
// plane) is issued before its first store.
template <int NP>
__global__ void __launch_bounds__(COPY_THREADS) stage_kernel(
    Planes<NP> w, long long w_len, const int32_t* __restrict__ meta, int t0,
    int pitch, Planes<NP> stage, int cpt, int* __restrict__ cursor,
    int rmax) {
  constexpr int U = STAGE_U;
  const int lt = blockIdx.x / cpt, part = blockIdx.x % cpt;
  if (part == 0) {
    for (int d = threadIdx.x; d < rmax; d += blockDim.x)
      cursor[(long long)lt * rmax + d] = 0;
  }
  const long long te = (long long)pitch * LANES;
  const long long nel = tile_live(meta, t0 + lt, te, w_len);
  const long long lo = (long long)part * ROUTE_CHUNK;
  const long long hi = min(lo + ROUTE_CHUNK, nel);
  if (lo >= hi) return;
  const long long src = (long long)meta[4 * (t0 + lt)] * LANES + lo;
  const long long dst = lt * te + lo;
  const int nv = (int)((hi - lo) / 4);
  constexpr int nt = COPY_THREADS;
  for (int i0 = threadIdx.x; i0 < nv; i0 += U * nt) {
    int4 v[NP][U];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * nt;
        if (i < nv) v[q][u] = ((const int4*)(w.p[q] + src))[i];
      }
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * nt;
        if (i < nv) ((int4*)(stage.p[q] + dst))[i] = v[q][u];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    for (long long i = nv * 4LL + threadIdx.x; i < hi - lo; i += nt)
      stage.p[q][dst + i] = w.p[q][src + i];
  }
}

template <int NP>
__global__ void __launch_bounds__(COPY_THREADS) flush_kernel(
    Planes<NP> w, Planes<NP> acc, const int32_t* __restrict__ base_tbl,
    const long long* __restrict__ boff, const long long* __restrict__ bslot,
    int t0, int tend, int rmax) {
  const int d = blockIdx.x / COPY_PARTS, part = blockIdx.x % COPY_PARTS;
  const long long c0 = base_tbl[(long long)t0 * rmax + d];
  const long long c1 = base_tbl[(long long)tend * rmax + d];
  const long long b0 = c0 >> BLK_SHIFT, fill = c0 & (BLK - 1);
  if (fill == 0 || ((b0 + 1) << BLK_SHIFT) > c1) return;
  const long long dst = bslot[boff[d] + b0] << BLK_SHIFT;
  const long long src = ((long long)d * 2 + (b0 & 1)) << BLK_SHIFT;
  const long long per = BLK / COPY_PARTS;
  const long long hi = min((part + 1) * per, fill);
  for (long long i = part * per + threadIdx.x; i < hi; i += blockDim.x) {
#pragma unroll
    for (int q = 0; q < NP; ++q) w.p[q][dst + i] = acc.p[q][src + i];
  }
}

// One block per ROUTE_CHUNK elements of a staged tile, chunk-ranked as the
// range route of kernels_v4.cu.  Warp v owns the span [v * 32 * ROUTE_E,
// (v + 1) * 32 * ROUTE_E) of the chunk and its lanes take it row by row,
// so the loads are coalesced.  Each key is classified once, by the lookup
// table of range_lut.cuh over the ranges' bounds in shared memory, and
// takes the next count of its range in its warp's count table (one
// shared atomicAdd; a warp row whose lanes share a range takes 32 at
// once).  One pass over (range, warp) turns the counts into offsets
// inside each range's segment of the chunk; warp 0 scans the segments'
// starts and claims each segment's share of its (tile, range) run with
// one global atomicAdd on the run's cursor (the order inside a run is
// therefore not defined).  The chunk then goes, plane by plane, into
// shared memory in range order, and consecutive threads store
// consecutive elements of a segment at consecutive stream positions: a
// segment's stream positions cross at most one block boundary, so its
// stores are runs of whole sectors into at most two places, the W slot
// of a block that completes by the window's end or the range's
// accumulator.  A claim past the run's count (a histogram that does not
// match) is dropped; keys above every bound are not stored.  `rows`
// count tables: one a warp, or one that the warps share where rmax is
// too wide for those (route_smem).
template <int NP>
__global__ void __launch_bounds__(ROUTE_THREADS, 2) route_kernel(
    Planes<NP> stage, long long w_len, const int32_t* __restrict__ meta,
    const int32_t* __restrict__ cnt_tbl, const int32_t* __restrict__ base_tbl,
    const int32_t* __restrict__ bounds, const long long* __restrict__ boff,
    const long long* __restrict__ bslot, Planes<NP> acc, Planes<NP> w,
    int* __restrict__ cursor, int t0, int tend, int pitch, int rmax, int cpt,
    int rows, int32_t xor_in) {
  extern __shared__ long long sm64[];
  long long* obase = sm64;                 // rmax: stream position - slot
  long long* send = obase + rmax;          // rmax: stream length at the end
  int32_t* sb = (int32_t*)(send + rmax);   // rmax bounds
  int* slim = sb + rmax;                   // rmax: slots past it dropped
  int* dstart = slim + rmax;               // rmax segment lengths, starts
  int* wcnt = dstart + rmax;               // [rows][range] counts, offsets
  int32_t* chunk = wcnt + rows * rmax;     // ROUTE_CHUNK words, one plane
  uint16_t* sdig = (uint16_t*)(chunk + ROUTE_CHUNK);  // their ranges
  int* nstaged = (int*)(sdig + ROUTE_CHUNK);
  uint16_t* lut = (uint16_t*)(nstaged + 1);  // LUT_CELLS + 1
  const int lt = blockIdx.x / cpt, part = blockIdx.x % cpt;
  const int t = t0 + lt;
  const long long te = (long long)pitch * LANES;
  const long long nel = tile_live(meta, t, te, w_len);
  const long long lo = (long long)part * ROUTE_CHUNK;
  if (lo >= nel) return;
  const long long row = (long long)t * rmax;
  for (int d = threadIdx.x; d < rmax; d += blockDim.x) {
    sb[d] = bounds[d];
    send[d] = base_tbl[(long long)tend * rmax + d];
  }
  for (int q = threadIdx.x; q < rows * rmax; q += blockDim.x) wcnt[q] = 0;
  __syncthreads();
  build_lut(lut, sb, rmax);
  __syncthreads();
  const RangeLut rl = range_lut(lut, sb, rmax);
  const int lane = threadIdx.x & 31, v = threadIdx.x >> 5;
  int* wc = wcnt + (rows > 1 ? v : 0) * rmax;
  const long long span = lo + (long long)v * 32 * ROUTE_E + lane;
  const long long sbase = lt * te;         // the tile's first staged word
  // per element one register: its key, then (range + 1) << 16 | its slot
  // (the rank in the warp, then the slot in the chunk), 0 where nothing
  // is stored
  int ds[ROUTE_E];
#pragma unroll
  for (int j = 0; j < ROUTE_E; ++j) {
    const long long i = span + 32 * j;
    ds[j] = i < nel ? stage.p[0][sbase + i] : 0;
  }
#pragma unroll
  for (int j = 0; j < ROUTE_E; ++j) {
    const int g = range_of(rl, ds[j] ^ xor_in);
    ds[j] = span + 32 * j < nel && g < rmax ? g : -1;
  }
#pragma unroll
  for (int j = 0; j < ROUTE_E; ++j) {
    const int d = ds[j];
    const int d0 = __shfl_sync(FULL_MASK, d, 0);
    int rank;
    if (__all_sync(FULL_MASK, d == d0)) {
      int b = 0;
      if (lane == 0 && d0 >= 0) b = atomicAdd(&wc[d0], 32);
      rank = __shfl_sync(FULL_MASK, b, 0) + lane;
    } else {
      rank = d >= 0 ? atomicAdd(&wc[d], 1) : 0;
    }
    ds[j] = d >= 0 ? ((d + 1) << 16) | rank : 0;
  }
  __syncthreads();
  // each range's count over the tables, in warp order: offsets of the
  // warps inside the range's segment, and the segment's length
  for (int g = threadIdx.x; g < rmax; g += blockDim.x) {
    int run = 0;
    for (int r = 0; r < rows; ++r) {
      const int c = wcnt[r * rmax + g];
      wcnt[r * rmax + g] = run;
      run += c;
    }
    dstart[g] = run;
  }
  __syncthreads();
  if (v == 0) {
    // the segments' starts: an exclusive scan of the lengths, each lane
    // over a contiguous share of the ranges; each segment's place in its
    // run from the run's cursor
    const int per = (rmax + 31) / 32, g0 = min(lane * per, rmax),
              g1 = min(g0 + per, rmax);
    int sum = 0;
    for (int g = g0; g < g1; ++g) sum += dstart[g];
    int incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - sum;
    for (int g = g0; g < g1; ++g) {
      const int len = dstart[g];
      const int at = len ? atomicAdd(&cursor[(long long)lt * rmax + g], len)
                         : 0;
      dstart[g] = run;
      obase[g] = (long long)base_tbl[row + g] + at - run;
      slim[g] = cnt_tbl[row + g] - at + run;
      run += len;
    }
    if (lane == 31) *nstaged = incl;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < ROUTE_E; ++j) {
    const int d = (ds[j] >> 16) - 1;
    if (d >= 0) ds[j] += dstart[d] + wc[d];
  }
  const int ns = *nstaged;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
#pragma unroll
    for (int j = 0; j < ROUTE_E; ++j) {
      if (!ds[j]) continue;
      const int at = ds[j] & 0xFFFF;
      chunk[at] = stage.p[q][sbase + span + 32 * j] ^ xor_in;
      if (q == 0) sdig[at] = (uint16_t)((ds[j] >> 16) - 1);
    }
    __syncthreads();
    for (int s = threadIdx.x; s < ns; s += blockDim.x) {
      const int d = sdig[s];
      if (s >= slim[d]) continue;
      const long long pos = obase[d] + s;
      const long long b = pos >> BLK_SHIFT, off = pos & (BLK - 1);
      if (((b + 1) << BLK_SHIFT) <= send[d])
        w.p[q][(bslot[boff[d] + b] << BLK_SHIFT) + off] = chunk[s];
      else
        acc.p[q][(((long long)d * 2 + (b & 1)) << BLK_SHIFT) + off] =
            chunk[s];
    }
    __syncthreads();
  }
}

template <int NP>
__global__ void __launch_bounds__(COPY_THREADS) drain_kernel(
    Planes<NP> w, Planes<NP> acc, const int32_t* __restrict__ base_tbl,
    const int32_t* __restrict__ padv_tbl, const long long* __restrict__ boff,
    const long long* __restrict__ bslot, int ndata, int rmax) {
  const int d = blockIdx.x / COPY_PARTS, part = blockIdx.x % COPY_PARTS;
  const long long row = (long long)ndata * rmax + d;
  const long long total = base_tbl[row];
  const long long b = total >> BLK_SHIFT, fill = total & (BLK - 1);
  const long long dst = bslot[boff[d] + b] << BLK_SHIFT;
  const long long src = ((long long)d * 2 + (b & 1)) << BLK_SHIFT;
  const int32_t padv = padv_tbl[row];
  const long long per = BLK / COPY_PARTS;
  for (long long i = part * per + threadIdx.x; i < (part + 1) * per;
       i += blockDim.x) {
    const bool real = i < fill;
#pragma unroll
    for (int q = 0; q < NP; ++q)
      w.p[q][dst + i] = real ? acc.p[q][src + i] : (q == 0 ? padv : SENT);
  }
}

// route_kernel's shared memory at rmax ranges and `rows` count tables, in
// its layout: two int64 and three int32 tables a range, the count
// tables, the chunk's words and ranges, one int and the lookup table.
size_t route_smem(int rmax, int rows) {
  return (size_t)rmax * (28 + 4 * rows) + 6 * ROUTE_CHUNK + 4 +
         2 * (LUT_CELLS + 1);
}

template <int NP>
int launch_seqroute(void* const* wp, long long w_len, const int32_t* meta,
                    const int32_t* cnt, const int32_t* base,
                    const int32_t* padv, const long long* boff,
                    const long long* bslot, int32_t* stage, int32_t* acc,
                    int* cursor, int ntiles, int pitch, int rmax, int wt,
                    int32_t xor_in, cudaStream_t st) {
  if (rmax < 1 || rmax >= (1 << 15) || wt < 1)
    return (int)cudaErrorInvalidValue;
  const int rows =
      route_smem(rmax, ROUTE_WARPS) <= SMEM_MAX ? ROUTE_WARPS : 1;
  const size_t shm = route_smem(rmax, rows);
  if (shm > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      route_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  const int ndata = ntiles - 1;
  const long long te = (long long)pitch * LANES;
  const int cpt = (int)((te + ROUTE_CHUNK - 1) / ROUTE_CHUNK);
  const Planes<NP> w = planes_of<NP>(wp);
  const Planes<NP> S = planes_at<NP>(stage, wt * te);
  const Planes<NP> A = planes_at<NP>(acc, (long long)rmax * 2 * BLK);
  // the ranges' inclusive upper bounds are the drain tile's pad values
  const int32_t* bounds = padv + (long long)ndata * rmax;
  for (int t0 = 0; t0 < ndata; t0 += wt) {
    const int tend = min(t0 + wt, ndata);
    const int nt = tend - t0;
    stage_kernel<NP><<<nt * cpt, COPY_THREADS, 0, st>>>(
        w, w_len, meta, t0, pitch, S, cpt, cursor, rmax);
    flush_kernel<NP><<<rmax * COPY_PARTS, COPY_THREADS, 0, st>>>(
        w, A, base, boff, bslot, t0, tend, rmax);
    route_kernel<NP><<<nt * cpt, ROUTE_THREADS, shm, st>>>(
        S, w_len, meta, cnt, base, bounds, boff, bslot, A, w, cursor, t0,
        tend, pitch, rmax, cpt, rows, xor_in);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  drain_kernel<NP><<<rmax * COPY_PARTS, COPY_THREADS, 0, st>>>(
      w, A, base, padv, boff, bslot, ndata, rmax);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ block_permute
// The cycles lie end to end in cyc_slots: position i of the table is a
// slot, and slot cyc[i] takes the block of cyc[i + 1] (the cycle's last
// position takes its head's).  The positions are cut into chunks of S,
// one group of PERMUTE_SPLIT blocks each; thread t of block `part` of a
// group owns the int4 at element offset (part * PERMUTE_THREADS + t) * 4
// of every W block, and walks its chunk in order.  A chunk so holds a
// piece of a long cycle, or several short cycles, and every SM has work
// whatever the longest cycle.  Only two kinds of block are read by a
// chunk other than the one that writes them, and the first launch
// (permute_heads_kernel) saves both to the head scratch H before the
// second (permute_kernel) writes any slot; stream order is the only
// ordering needed:
// - H[2j], chunk j's first position when it is no cycle's start (the
//   last position of chunk j - 1 reads it);
// - H[2j + 1], the head of the cycle that starts in chunk j and ends past
//   it (that cycle's last position reads it).
// The head of a cycle that ends in the chunk it starts in stays in
// registers: the thread reads it before it writes the head's slot.
// Every other read is of a slot the same thread writes later, and reads
// run ahead of writes along the chunk, PD blocks at a time.

// The cycle that holds position i: the largest c with off[c] <= i.
__device__ __forceinline__ int cycle_of(const int32_t* __restrict__ off,
                                        int ncyc, int i) {
  int lo = 0, hi = ncyc - 1;
  while (lo < hi) {
    const int m = (lo + hi + 1) >> 1;
    if (off[m] <= i) lo = m; else hi = m - 1;
  }
  return lo;
}

template <int NP>
__device__ __forceinline__ void copy_int4(const Planes<NP>& to, long long a,
                                          const Planes<NP>& from,
                                          long long b) {
#pragma unroll
  for (int q = 0; q < NP; ++q)
    *(int4*)(to.p[q] + a) = *(const int4*)(from.p[q] + b);
}

template <int NP>
__global__ void __launch_bounds__(PERMUTE_THREADS) permute_heads_kernel(
    Planes<NP> w, const int32_t* __restrict__ off,
    const int32_t* __restrict__ slots, int ncyc, int moved, int S,
    Planes<NP> H) {
  const int j = blockIdx.x / PERMUTE_SPLIT;
  const int part = blockIdx.x % PERMUTE_SPLIT;
  const long long e = ((long long)part * PERMUTE_THREADS + threadIdx.x) * 4;
  const int i0 = j * S, i1 = min(i0 + S, moved);
  if (j > 0 && off[cycle_of(off, ncyc, i0)] != i0)
    copy_int4(H, ((long long)(2 * j) << BLK_SHIFT) + e, w,
              ((long long)slots[i0] << BLK_SHIFT) + e);
  const int c = cycle_of(off, ncyc, i1 - 1);
  if (off[c] >= i0 && off[c + 1] > i1)
    copy_int4(H, ((long long)(2 * j + 1) << BLK_SHIFT) + e, w,
              ((long long)slots[off[c]] << BLK_SHIFT) + e);
}

template <int NP>
__global__ void __launch_bounds__(PERMUTE_THREADS) permute_kernel(
    Planes<NP> w, const int32_t* __restrict__ off,
    const int32_t* __restrict__ slots, int ncyc, int moved, int S,
    Planes<NP> H) {
  constexpr int PD = NP <= 2 ? 8 : 4;
  __shared__ int32_t cyc[PERMUTE_MAX_CHUNK];
  const int j = blockIdx.x / PERMUTE_SPLIT;
  const int part = blockIdx.x % PERMUTE_SPLIT;
  const long long e = ((long long)part * PERMUTE_THREADS + threadIdx.x) * 4;
  const int i0 = j * S, i1 = min(i0 + S, moved);
  for (int i = i0 + threadIdx.x; i < i1; i += blockDim.x)
    cyc[i - i0] = slots[i];
  __syncthreads();
  // one piece [a, b) of one cycle at a time (positions past the last
  // cycle, which a well-formed table has none of, are left alone)
  for (int c = cycle_of(off, ncyc, i0), a = i0; a < i1 && c < ncyc; ++c) {
    const int start = off[c], end = off[c + 1];
    const int b = min(end, i1);
    if (b <= a) continue;
    // the block the piece's last position takes: the next chunk's first
    // (saved), the head of a cycle that started in an earlier chunk
    // (saved), or the head of this chunk's own cycle, read from W before
    // the piece writes its slot
    const bool own = b == end && start >= i0;
    const long long la =
        b < end ? (long long)(2 * j + 2) << BLK_SHIFT
        : !own  ? (long long)(2 * (start / S) + 1) << BLK_SHIFT
                : (long long)cyc[start - i0] << BLK_SHIFT;
    int4 last[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q)
      last[q] = *(const int4*)((own ? w.p[q] : H.p[q]) + la + e);
    for (int i = a; i < b - 1; i += PD) {
      int4 v[PD][NP];
#pragma unroll
      for (int k = 0; k < PD; ++k) {
        if (i + k < b - 1) {
          const long long s =
              ((long long)cyc[i + 1 + k - i0] << BLK_SHIFT) + e;
#pragma unroll
          for (int q = 0; q < NP; ++q) v[k][q] = *(const int4*)(w.p[q] + s);
        }
      }
#pragma unroll
      for (int k = 0; k < PD; ++k) {
        if (i + k < b - 1) {
          const long long d = ((long long)cyc[i + k - i0] << BLK_SHIFT) + e;
#pragma unroll
          for (int q = 0; q < NP; ++q) *(int4*)(w.p[q] + d) = v[k][q];
        }
      }
    }
    const long long d = ((long long)cyc[b - 1 - i0] << BLK_SHIFT) + e;
#pragma unroll
    for (int q = 0; q < NP; ++q) *(int4*)(w.p[q] + d) = last[q];
    a = b;
  }
}

template <int NP>
int launch_permute(void* const* wp, const int32_t* cyc_off,
                   const int32_t* cyc_slots, int ncyc, int moved, int S,
                   void* const* hp, cudaStream_t st) {
  if (ncyc <= 0 || moved <= 0) return (int)cudaGetLastError();
  if (S < 1 || S > PERMUTE_MAX_CHUNK) return (int)cudaErrorInvalidValue;
  const long long nchunks = ((long long)moved + S - 1) / S;
  const long long grid = nchunks * PERMUTE_SPLIT;
  if (grid > INT32_MAX) return (int)cudaErrorInvalidValue;
  const Planes<NP> w = planes_of<NP>(wp), H = planes_of<NP>(hp);
  if (nchunks > 1)
    permute_heads_kernel<NP><<<(unsigned)grid, PERMUTE_THREADS, 0, st>>>(
        w, cyc_off, cyc_slots, ncyc, moved, S, H);
  permute_kernel<NP><<<(unsigned)grid, PERMUTE_THREADS, 0, st>>>(
      w, cyc_off, cyc_slots, ncyc, moved, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Plane pointers come as four arguments each (NULL past nplanes).
int kv5_seqroute_level(void* w0, void* w1, void* w2, void* w3,
                       long long w_len, const void* meta, const void* cnt,
                       const void* base, const void* padv, const void* boff,
                       const void* bslot, void* stage, void* acc,
                       void* cursor, int nplanes, int ntiles, int pitch,
                       int rmax, int wt, int bias_input, void* stream) {
  void* const w[MAX_PLANES] = {w0, w1, w2, w3};
  const int32_t x = bias_input ? BIAS : 0;
  cudaStream_t st = (cudaStream_t)stream;
#define KV5_SEQROUTE(NP)                                                   \
  launch_seqroute<NP>(w, w_len, (const int32_t*)meta, (const int32_t*)cnt, \
                      (const int32_t*)base, (const int32_t*)padv,          \
                      (const long long*)boff, (const long long*)bslot,     \
                      (int32_t*)stage, (int32_t*)acc, (int*)cursor,        \
                      ntiles, pitch, rmax, wt, x, st)
  switch (nplanes) {
    case 1: return KV5_SEQROUTE(1);
    case 2: return KV5_SEQROUTE(2);
    case 3: return KV5_SEQROUTE(3);
    case 4: return KV5_SEQROUTE(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef KV5_SEQROUTE
}

// heads: 2 * ceil(moved / S) blocks a plane, laid out like W's planes
// (NULL past nplanes; unused when one chunk holds every position).
int kv5_block_permute(void* w0, void* w1, void* w2, void* w3,
                      const void* cyc_off, const void* cyc_slots, int ncyc,
                      int moved, int S, void* h0, void* h1, void* h2,
                      void* h3, int nplanes, void* stream) {
  void* const w[MAX_PLANES] = {w0, w1, w2, w3};
  void* const h[MAX_PLANES] = {h0, h1, h2, h3};
  const int32_t* off = (const int32_t*)cyc_off;
  const int32_t* slots = (const int32_t*)cyc_slots;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nplanes) {
    case 1: return launch_permute<1>(w, off, slots, ncyc, moved, S, h, st);
    case 2: return launch_permute<2>(w, off, slots, ncyc, moved, S, h, st);
    case 3: return launch_permute<3>(w, off, slots, ncyc, moved, S, h, st);
    case 4: return launch_permute<4>(w, off, slots, ncyc, moved, S, h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
