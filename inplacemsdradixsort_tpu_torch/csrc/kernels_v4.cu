// Hand-written Hopper (sm_90a) kernels of the v4 engine: the partition
// level (hist_level, route_level), the terminal sort (terminal_write: a
// cluster path on the network of cluster_sort.cuh, and a global path for
// classes no cluster holds) and the run splice of the deep tier
// (splice_runs).
//
// The level kernels have a range mode, which classifies by the parent's
// bounds (hist_kernel<true>, route_range_kernel), and the digit mode of
// the LSB engine's passes (hist_kernel<false>, route_digit_kernel):
// counts by a radix digit of the raw word, and a partition that is
// stable by that digit.
//
// Built by ops/_build.py, with the other sources of csrc/: one
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -c
// per source, all run together, then one link with -shared into one
// library with a plain C interface, loaded with ctypes.
// Every launcher takes PyTorch's current stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().
//
// Keys are int32 in the sign-biased encoding (biased = raw ^ 0x80000000,
// so signed order = unsigned order of the raw words); SENT = biased +inf.
// A sort carries 1-4 planes of equal length (key, then payload words);
// plane 0 classifies, tuples order lexicographically over planes 0..nlex.
// The multi-plane kernels are templates on the plane count NP, so the
// keys-only launch does no per-plane work.
// The Python wrappers and their plain PyTorch versions live in
// ops/kernels_v4.py; the per-kernel notes there say which TPU kernel each
// replaces and what bounds it on the H100.

#include <algorithm>

#include "cluster_sort.cuh"
#include "range_lut.cuh"

namespace {

constexpr int HIST_THREADS = 512;    // hist_level block
constexpr int HIST_U = 4;            // 16-byte vectors a thread per step
constexpr int TERM_THREADS = 1024;   // terminal_write block
constexpr int SPLICE_THREADS = 256;  // splice_runs block
constexpr int ROUTE_THREADS = 512;   // route_level block, both kernels
constexpr int ROUTE_WARPS = ROUTE_THREADS / 32;
constexpr int ROUTE_E = 16;          // elements a thread holds of a chunk
constexpr int ROUTE_CHUNK = ROUTE_THREADS * ROUTE_E;  // 8192, any NP
constexpr size_t SMEM_MAX = 227 * 1024;  // shared memory a block may take
constexpr unsigned FULL_MASK = 0xffffffffu;

// The radix digit (raw >> shift) & mask of a raw uint32 word held in an
// int32, shifted logically so that no sign bit leaks into the digit.
__device__ __forceinline__ unsigned digit_of(int32_t raw, int shift,
                                             unsigned mask) {
  return ((uint32_t)raw >> shift) & mask;
}

// Tile t of a level: (parent, first element, live element count), with
// the count clamped to the tile's pitch and to the source length so that
// no read leaves the source.
struct TileMeta {
  int parent;
  long long base;
  long long nel;
};

__device__ __forceinline__ TileMeta tile_meta(const int32_t* meta, int t,
                                              int pitch, long long src_len) {
  TileMeta m;
  m.parent = meta[3 * t];
  m.base = (long long)meta[3 * t + 1] * LANES;
  long long nel = meta[3 * t + 2];
  nel = min(nel, (long long)pitch * LANES);
  nel = min(nel, src_len - m.base);
  m.nel = max(nel, 0LL);
  return m;
}

// ------------------------------------------------------------ hist_level
// One block per tile, both modes: each live element's bin (range mode:
// its range through the lookup table and the parent's bounds in shared
// memory, range_of; digit mode: the digit of its raw word, shifted
// logically; bounds not read) is counted in shared memory.  The tile is
// read with 16-byte loads, HIST_U a thread per step, when its start is
// 16-byte aligned (a tile starts at src_row * 128 elements, but a plane
// may be a view), else element by element; lanes past nel are skipped by
// index, never by value (SENT equals a real biased 0xFFFFFFFF), and bins
// >= rmax count nowhere.  Warp w counts into sub-histogram w % copies
// (the host picks copies from rmax: kernels_v4.hist_layout), so warps do
// not contend for a counter under a heavy key; the copies are summed
// into the tile's row at the end.  Shared memory: the copies, the bounds
// and, range mode, the lookup table.
template <bool RANGE>
__global__ void __launch_bounds__(HIST_THREADS) hist_kernel(
    const int32_t* __restrict__ src, long long src_len,
    const int32_t* __restrict__ meta, const int32_t* __restrict__ bounds,
    int32_t* __restrict__ hist, int pitch, int rmax, int32_t xor_in,
    int shift, unsigned mask, int copies, int split) {
  extern __shared__ int32_t smem[];
  int* cnt = smem;                          // copies x rmax counters
  int32_t* sb = cnt + copies * rmax;        // rmax bounds (range mode)
  uint16_t* lut = (uint16_t*)(sb + rmax);   // LUT_CELLS + 1 (range mode)
  const int t = blockIdx.x / split, sub = blockIdx.x % split;
  const TileMeta m = tile_meta(meta, t, pitch, src_len);
  for (int q = threadIdx.x; q < copies * rmax; q += blockDim.x) cnt[q] = 0;
  if (RANGE) {
    for (int d = threadIdx.x; d < rmax; d += blockDim.x)
      sb[d] = bounds[(long long)m.parent * rmax + d];
    __syncthreads();
    build_lut(lut, sb, rmax);
  }
  __syncthreads();
  const RangeLut rl = RANGE ? range_lut(lut, sb, rmax) : RangeLut{};
  int* my = cnt + ((threadIdx.x >> 5) & (copies - 1)) * rmax;
  const int32_t* s = src + m.base;
  const bool vec = ((uintptr_t)s & 15) == 0;
  constexpr int STEP = HIST_THREADS * 4 * HIST_U;
  for (long long i0 = (long long)sub * STEP; i0 < m.nel;
       i0 += (long long)split * STEP) {
    int32_t x[HIST_U][4];
#pragma unroll
    for (int u = 0; u < HIST_U; ++u) {
      const long long i = i0 + 4LL * (u * HIST_THREADS + threadIdx.x);
      if (vec && i + 4 <= m.nel) {
        const int4 v = *(const int4*)(s + i);
        x[u][0] = v.x; x[u][1] = v.y; x[u][2] = v.z; x[u][3] = v.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) x[u][c] = i + c < m.nel ? s[i + c] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < HIST_U; ++u) {
      const long long i = i0 + 4LL * (u * HIST_THREADS + threadIdx.x);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = RANGE ? range_of(rl, x[u][c] ^ xor_in)
                            : (int)digit_of(x[u][c], shift, mask);
        if (i + c < m.nel && d < rmax) atomicAdd(&my[d], 1);
      }
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < rmax; d += blockDim.x) {
    int sum = 0;
    for (int c = 0; c < copies; ++c) sum += cnt[c * rmax + d];
    if (split == 1)
      hist[(long long)t * rmax + d] = sum;
    else if (sum)                           // into the zeroed row
      atomicAdd(&hist[(long long)t * rmax + d], sum);
  }
}

// ----------------------------------------------------------- route_level
// One block per tile in range mode: a partition of the tile's elements
// into the runs of their ranges (plane 0 classifies), chunk-ranked as the
// digit mode below is.  The block walks its tile, one chunk of
// ROUTE_CHUNK elements at a time.  Warp w owns the contiguous span [w *
// 32 * ROUTE_E, (w + 1) * 32 * ROUTE_E) of the chunk and its lanes take it
// row by row, so the loads are coalesced.  Each key's range comes from
// range_of (the lookup table and the parent's bounds in shared memory).
// Ranking: every element takes the next count of its range in its
// warp's count table with one shared atomicAdd; a warp row whose lanes
// all share a range (a heavy key) takes 32 at once through lane 0, so a
// heavy range does not serialise a warp's atomics.  Then one pass over
// (range, warp) turns the warps' counts into offsets inside each range's
// segment of the chunk, and warp 0 scans the segments' starts (dstart)
// and where each segment goes in its run: the run's cursor, which
// carries from chunk to chunk, or, when a tile has several blocks
// (split > 1: they take its chunks in turn), a global atomicAdd on the
// run's cursor in gcur.  The chunk then goes, plane by plane, into shared
// memory in that order, and consecutive threads store consecutive
// elements of a segment at dst[t, d] * 128 + its place: runs of whole
// sectors instead of one 4-byte store per element.  The order inside a
// run is not defined (the contract leaves it free).  Every run holds its
// cnt[t, d] tuples, then (-cnt) % 128 pad tuples (padv[t, d] in plane 0,
// SENT in the others), which the tile's first block writes.
//
// `rows` is the number of count tables: one a warp, or one that the
// warps share where rmax is too wide for those.  The host picks rows,
// split and the shared memory, laid out as below, from the launch's shape
// (kernels_v4.route_layout and level_split).  Slack lanes, keys above
// every bound (d == rmax) and runs with dst < 0 (value-filled ranges) are
// skipped by index, never by value (SENT is a real key).  xor_in
// (bias_input) applies to every plane on load.  Stores are element-exact
// with 64-bit addresses, so an accumulate launch writes only its own
// runs' rows.
template <int NP>
__global__ void __launch_bounds__(ROUTE_THREADS, 2) route_range_kernel(
    Planes<NP> src, long long src_len, const int32_t* __restrict__ meta,
    const int32_t* __restrict__ bounds, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ padv,
    Planes<NP> out, long long out_len, int pitch, int rmax, int32_t xor_in,
    int rows, int split, int* __restrict__ gcur) {
  extern __shared__ long long smem64[];
  long long* sdst = smem64;                  // rmax run bases (-1: no store)
  long long* oend = sdst + rmax;             // rmax ends of the real tuples
  long long* obase = oend + rmax;            // rmax: out index - staged slot
  int* scnt = (int*)(obase + rmax);          // rmax run counts
  int* cur = scnt + rmax;                    // rmax cursors
  int* dstart = cur + rmax;                  // rmax segment starts
  int32_t* sb = dstart + rmax;               // rmax bounds
  int* wcnt = sb + rmax;                     // [rows][range] counts, offsets
  int32_t* stage = wcnt + rows * rmax;       // ROUTE_CHUNK
  uint16_t* sdig = (uint16_t*)(stage + ROUTE_CHUNK);  // their ranges
  int* nstaged = (int*)(sdig + ROUTE_CHUNK);
  uint16_t* lut = (uint16_t*)(nstaged + 1);  // LUT_CELLS + 1
  const int t = blockIdx.x / split, sub = blockIdx.x % split;
  const TileMeta m = tile_meta(meta, t, pitch, src_len);
  const long long row0 = (long long)t * rmax;
  for (int d = threadIdx.x; d < rmax; d += blockDim.x) {
    const int c = cnt[row0 + d];
    const int dr = dst[row0 + d];
    scnt[d] = c;
    sdst[d] = dr >= 0 ? (long long)dr * LANES : -1;
    oend[d] = dr >= 0 ? (long long)dr * LANES + c : -1;
    cur[d] = 0;
    sb[d] = bounds[(long long)m.parent * rmax + d];
  }
  for (int q = threadIdx.x; q < rows * rmax; q += blockDim.x) wcnt[q] = 0;
  __syncthreads();
  build_lut(lut, sb, rmax);
  __syncthreads();
  const RangeLut rl = range_lut(lut, sb, rmax);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int* wc = wcnt + (rows > 1 ? w : 0) * rmax;
  for (long long c0 = (long long)sub * ROUTE_CHUNK; c0 < m.nel;
       c0 += (long long)split * ROUTE_CHUNK) {
    const long long span = c0 + (long long)w * 32 * ROUTE_E + lane;
    // per element one register: its key, then (range + 1) << 16 | its
    // slot (the rank in the warp, then the slot in the stage), 0 where
    // nothing is stored
    int ds[ROUTE_E];
#pragma unroll
    for (int j = 0; j < ROUTE_E; ++j) {
      const long long i = span + 32 * j;
      ds[j] = i < m.nel ? src.p[0][m.base + i] : 0;
    }
#pragma unroll
    for (int j = 0; j < ROUTE_E; ++j) {
      const int g = range_of(rl, ds[j] ^ xor_in);
      ds[j] = span + 32 * j < m.nel && g < rmax && sdst[g] >= 0 ? g : -1;
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
      for (int ww = 0; ww < rows; ++ww) {
        const int c = wcnt[ww * rmax + g];
        wcnt[ww * rmax + g] = run;
        run += c;
      }
      dstart[g] = run;
    }
    __syncthreads();
    if (w == 0) {
      // the segments' starts: an exclusive scan of the lengths, each lane
      // over a contiguous share of the ranges
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
        int at = cur[g];              // where the segment goes in its run
        if (split > 1) {
          at = len ? atomicAdd(&gcur[row0 + g], len) : 0;
        } else {
          cur[g] += len;
        }
        dstart[g] = run;
        obase[g] = sdst[g] + at - run;
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
        stage[at] = src.p[q][m.base + span + 32 * j] ^ xor_in;
        if (q == 0) sdig[at] = (uint16_t)((ds[j] >> 16) - 1);
      }
      __syncthreads();
      for (int s = threadIdx.x; s < ns; s += blockDim.x) {
        const int d = sdig[s];
        const long long o = obase[d] + s;
        if (o < oend[d] && o < out_len) out.p[q][o] = stage[s];
      }
      if (q == NP - 1) {
        for (int x = threadIdx.x; x < rows * rmax; x += blockDim.x)
          wcnt[x] = 0;
      }
      __syncthreads();
    }
  }
  // pads occupy [cnt, cnt + npad) of each run, disjoint from the slots;
  // the tile's first block writes them
  for (int q = threadIdx.x; sub == 0 && q < rmax * LANES; q += blockDim.x) {
    const int d = q / LANES, j = q % LANES;
    if (sdst[d] < 0) continue;
    const int c = scnt[d];
    if (j < ((-c) & (LANES - 1))) {
      const long long o = sdst[d] + c + j;
      if (o < out_len) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
          out.p[p][o] = p == 0 ? padv[row0 + d] : SENT;
      }
    }
  }
}


// One block per tile, digit mode: a partition that is STABLE by the digit
// of plane dp, chunk-ranked as in one-sweep radix sorts.  The block walks
// its tile in input order, one chunk of ROUTE_CHUNK elements at a time.
// Warp w owns the contiguous span [w * 32 * ROUTE_E, (w + 1) * 32 *
// ROUTE_E) of the chunk and its lanes take it row by row (element j of
// lane l is span element j * 32 + l), so the loads are coalesced and a
// warp meets its elements in input order.  Ranking, per row: every lane
// sets its bit in the warp's mask word of its digit (a shared-memory
// atomicOr, as CUB's match-by-atomic-or ranking does: __match_any_sync
// is microcoded and costs hundreds of cycles a call on the H100), so the
// word is the lanes with the element's digit, `peers`; its rank is the
// warp's running count of the digit plus __popc(peers & lanes below), and
// the lowest peer adds __popc(peers) to that count and clears the word.  Then one pass
// over (digit, warp) turns the warps' counts into offsets inside each
// digit's segment of the chunk, and warp 0 scans the digits' totals into
// the segments' starts (dstart) and the cursor of every run (which
// carries from chunk to chunk).  The chunk then goes, plane by plane,
// into shared memory in stable digit order, and consecutive threads
// store consecutive elements of a segment at dst[t, d] * 128 + cursor +
// j: runs of whole sectors instead of one 4-byte store per element.  So
// each element's slot is the number of earlier elements of the tile with
// its digit, and every run holds its cnt[t, d] tuples in input order,
// then (-cnt) % 128 pad tuples (padv[t, d] in plane dp, SENT in the
// others).  Slack lanes, digits >= rmax and runs with dst < 0 are
// skipped by index, never by value (SENT is a real key).  Stores are
// element-exact with 64-bit addresses.
template <int NP>
__global__ void __launch_bounds__(ROUTE_THREADS, 2) route_digit_kernel(
    Planes<NP> src, long long src_len, const int32_t* __restrict__ meta,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ padv, Planes<NP> out, long long out_len,
    int pitch, int rmax, int shift, unsigned mask, int dp) {
  extern __shared__ long long smem64[];
  long long* sdst = smem64;                  // rmax run bases (-1: no store)
  long long* oend = sdst + rmax;             // rmax ends of the real tuples
  long long* obase = oend + rmax;            // rmax: out index - staged slot
  int* scnt = (int*)(obase + rmax);          // rmax run counts
  int* cur = scnt + rmax;                    // rmax cursors
  int* dstart = cur + rmax;                  // rmax segment starts
  int* wcnt = dstart + rmax;                 // [warp][digit] counts, offsets
  unsigned* wmask = (unsigned*)(wcnt + ROUTE_WARPS * rmax);  // [warp][digit]
  int32_t* stage = (int32_t*)(wmask + ROUTE_WARPS * rmax);  // ROUTE_CHUNK
  uint16_t* sdig = (uint16_t*)(stage + ROUTE_CHUNK);  // their digits
  int* nstaged = (int*)(sdig + ROUTE_CHUNK);
  const int t = blockIdx.x;
  const TileMeta m = tile_meta(meta, t, pitch, src_len);
  const long long row0 = (long long)t * rmax;
  for (int d = threadIdx.x; d < rmax; d += blockDim.x) {
    const int c = cnt[row0 + d];
    const int dr = dst[row0 + d];
    scnt[d] = c;
    sdst[d] = dr >= 0 ? (long long)dr * LANES : -1;
    oend[d] = dr >= 0 ? (long long)dr * LANES + c : -1;
    cur[d] = 0;
  }
  for (int q = threadIdx.x; q < ROUTE_WARPS * rmax; q += blockDim.x) {
    wcnt[q] = 0;
    wmask[q] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  int* wc = wcnt + w * rmax;
  unsigned* wm = wmask + w * rmax;
  for (long long c0 = 0; c0 < m.nel; c0 += ROUTE_CHUNK) {
    const long long span = c0 + (long long)w * 32 * ROUTE_E + lane;
    // per element one register: (digit + 1) << 16 | its slot (the rank in
    // the warp, then the slot in the stage), 0 where nothing is stored
    int ds[ROUTE_E];
#pragma unroll
    for (int j = 0; j < ROUTE_E; ++j) {
      const long long i = span + 32 * j;
      ds[j] = i < m.nel ? (int)digit_of(src.p[dp][m.base + i], shift, mask)
                        : -1;
    }
#pragma unroll
    for (int j = 0; j < ROUTE_E; ++j) {
      const int g = ds[j];
      const int d = g >= 0 && g < rmax && sdst[g] >= 0 ? g : -1;
      if (d >= 0) atomicOr(&wm[d], 1u << lane);
      __syncwarp();
      const unsigned peers = d >= 0 ? wm[d] : 0;
      const int leader = __ffs(peers) - 1;
      const bool lead = d >= 0 && lane == leader;
      const int b = __shfl_sync(FULL_MASK, lead ? wc[d] : 0, leader & 31);
      __syncwarp();
      if (lead) {
        wc[d] = b + __popc(peers);
        wm[d] = 0;
      }
      __syncwarp();
      ds[j] = d >= 0 ? ((d + 1) << 16) | (b + __popc(peers & below)) : 0;
    }
    __syncthreads();
    // each digit's count over the warps, in warp order: offsets of the
    // warps inside the digit's segment, and the segment's length
    for (int g = threadIdx.x; g < rmax; g += blockDim.x) {
      int run = 0;
#pragma unroll
      for (int ww = 0; ww < ROUTE_WARPS; ++ww) {
        const int c = wcnt[ww * rmax + g];
        wcnt[ww * rmax + g] = run;
        run += c;
      }
      dstart[g] = run;
    }
    __syncthreads();
    if (w == 0) {
      // the segments' starts: an exclusive scan of the lengths, each lane
      // over a contiguous share of the digits
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
        dstart[g] = run;
        obase[g] = sdst[g] + cur[g] - run;
        cur[g] += len;
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
        stage[at] = src.p[q][m.base + span + 32 * j];
        if (q == 0) sdig[at] = (uint16_t)((ds[j] >> 16) - 1);
      }
      __syncthreads();
      for (int s = threadIdx.x; s < ns; s += blockDim.x) {
        const int d = sdig[s];
        const long long o = obase[d] + s;
        if (o < oend[d] && o < out_len) out.p[q][o] = stage[s];
      }
      if (q == NP - 1) {
        for (int x = threadIdx.x; x < ROUTE_WARPS * rmax; x += blockDim.x)
          wcnt[x] = 0;
      }
      __syncthreads();
    }
  }
  // pads occupy [cnt, cnt + npad) of each run, disjoint from the slots
  for (int q = threadIdx.x; q < rmax * LANES; q += blockDim.x) {
    const int d = q / LANES, j = q % LANES;
    if (sdst[d] < 0) continue;
    const int c = scnt[d];
    if (j < ((-c) & (LANES - 1))) {
      const long long o = sdst[d] + c + j;
      if (o < out_len) {
#pragma unroll
        for (int p = 0; p < NP; ++p)
          out.p[p][o] = p == dp ? padv[row0 + d] : SENT;
      }
    }
  }
}


// --------------------------------------------- terminal_write, global path
// The terminal sort of a class whose capacity fits no thread-block
// cluster (the cluster path below takes every other class): one block
// per bucket row of btbl = (src_row, occ_rows, real, mode, fill, out_off,
// class, 0).  Mode 0 sorts the bucket's occ_rows*128 tuples ascending
// (lexicographic over planes 0..nlex) and writes the first `real` of
// them, xor xor_out, to out[out_off, out_off + real) of every plane;
// mode 1 (keys only) writes `real` copies of fill to plane 0.
//
// Sort: the network of bitonic.cuh over the bucket padded to a power of
// two N with virtual all-SENT tuples.  A bucket of up to smem_tile<NP>()
// tuples sorts in shared memory.  A larger one sorts in a global scratch
// segment of m tuples, one per plane, at scratch + q * scratch_len +
// soff[bucket] (the wrapper packs the segments of the launch's large
// buckets only): shared-memory tiles are sorted first; then for every
// k > tile the steps with a partner distance >= tile run on global
// memory and the rest of the steps of that k run on each tile in shared
// memory.  One block owns the bucket, so __syncthreads() orders the
// global steps.

// One global step over tuples [0, N) with pair distance h; `flip` pairs i
// with i ^ (2h - 1), otherwise with i + h.  Pairs reaching past m are
// no-ops.
template <int NP>
__device__ void global_step(const Planes<NP>& g, int N, int m, int h,
                            bool flip, int nlex) {
  for (int q = threadIdx.x; q < (N >> 1); q += blockDim.x) {
    const int i = pair_lo(q, h);
    const int p = flip ? (i ^ (2 * h - 1)) : (i + h);
    if (p < m) cmpswap<NP>(g, i, p, nlex);
  }
  __syncthreads();
}

template <int NP>
__device__ void load_tile(const Planes<NP>& s, const Planes<NP>& g, int c,
                          int m) {
  constexpr int T = smem_tile<NP>();
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const int e = c * T + i;
#pragma unroll
    for (int q = 0; q < NP; ++q) s.p[q][i] = e < m ? g.p[q][e] : SENT;
  }
  __syncthreads();
}

template <int NP>
__device__ void store_tile(const Planes<NP>& s, const Planes<NP>& g, int c,
                           int m) {
  constexpr int T = smem_tile<NP>();
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const int e = c * T + i;
    if (e < m) {
#pragma unroll
      for (int q = 0; q < NP; ++q) g.p[q][e] = s.p[q][i];
    }
  }
  __syncthreads();
}

template <int NP>
__global__ void __launch_bounds__(TERM_THREADS) terminal_write_kernel(
    Planes<NP> src, long long src_len, const int32_t* __restrict__ btbl,
    Planes<NP> out, long long out_len, int32_t* __restrict__ scratch,
    const long long* __restrict__ soff, long long scratch_len, int nlex,
    int32_t xor_out, int cap_rows, int class_id) {
  constexpr int T = smem_tile<NP>();
  extern __shared__ int32_t smem[];   // NP planes of T tuples
  const int32_t* row = btbl + 8LL * blockIdx.x;
  const long long src_row = row[0];
  int occ = row[1];
  long long real = row[2];
  const int mode = row[3];
  const int32_t fill = row[4];
  const long long off = row[5];
  const int cls = row[6];
  if (real <= 0 || (class_id >= 0 && cls != class_id)) return;
  real = min(real, out_len - off);

  if (mode != 0) {                       // value fill (keys only)
    const int32_t v = fill ^ xor_out;
    for (long long i = threadIdx.x; i < real; i += blockDim.x)
      out.p[0][off + i] = v;
    return;
  }

  // the class capacity bounds what is sorted, as on the reference
  occ = min(occ, cap_rows);
  const long long base = src_row * LANES;
  const int m = (int)max(0LL, min((long long)occ * LANES, src_len - base));
  real = min(real, (long long)m);
  if (m == 0) return;
  int N = 1;
  while (N < m) N <<= 1;

  Planes<NP> s, in;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    s.p[q] = smem + q * T;
    in.p[q] = src.p[q] + base;
  }

  if (N <= T) {
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
#pragma unroll
      for (int q = 0; q < NP; ++q) s.p[q][i] = i < m ? in.p[q][i] : SENT;
    }
    __syncthreads();
    smem_sort<NP>(s, N, nlex);
    for (int i = threadIdx.x; i < real; i += blockDim.x) {
#pragma unroll
      for (int q = 0; q < NP; ++q) out.p[q][off + i] = s.p[q][i] ^ xor_out;
    }
    return;
  }

  Planes<NP> g;
#pragma unroll
  for (int q = 0; q < NP; ++q)
    g.p[q] = scratch + q * scratch_len + soff[blockIdx.x];
  const int ntile = (m + T - 1) / T;
  for (int c = 0; c < ntile; ++c) {      // sorted tiles: merges up to T
    load_tile<NP>(s, in, c, m);
    smem_sort<NP>(s, T, nlex);
    store_tile<NP>(s, g, c, m);
  }
  for (int k = 2 * T; k <= N; k <<= 1) {
    global_step<NP>(g, N, m, k >> 1, true, nlex);
    for (int j = k >> 2; j >= T; j >>= 1)
      global_step<NP>(g, N, m, j, false, nlex);
    for (int c = 0; c < ntile; ++c) {
      load_tile<NP>(s, g, c, m);
      smem_half_steps<NP>(s, T, T >> 1, nlex);
      store_tile<NP>(s, g, c, m);
    }
  }
  for (int i = threadIdx.x; i < real; i += blockDim.x) {
#pragma unroll
    for (int q = 0; q < NP; ++q) out.p[q][off + i] = g.p[q][i] ^ xor_out;
  }
}

// ------------------------------------------- terminal_write, cluster path
// The terminal sort of a class whose capacity fits a thread-block
// cluster (2^lr >= cap_rows * 128 tuples on C = 2^(lr - sb) CTAs of 2^sb
// tuples each, C <= 16; ops/kernels_v4.py's terminal_geometry picks lr
// and sb): every bucket is read once from the arena into the cluster's
// shared memory, sorted there by the network of csrc/cluster_sort.cuh,
// and its first `real` tuples are written once,
// xor xor_out, to out[out_off, ...) of every plane; the source is only
// read, and nothing goes through a global scratch.  The launch is
// persistent: G resident clusters walk btbl in blocks of CS_THREADS rows,
// every CTA counting the launch's buckets (real > 0 and, with a class,
// that class) in row order, and cluster c takes the buckets whose count
// is c mod G, so rows of other classes cost a read of the table and no
// cluster.  Mode 1 (keys only) writes `real` copies of the fill, the
// cluster's CTAs taking turns.
//
// With 1-2 planes a bucket of m = min(occ, cap_rows) * 128 tuples sorts
// on the smallest network that holds it, 2^lb >= m tuples (at least
// 2^(W + 2) a CTA), spread over all C CTAs of the cluster, 2^(lb - log2
// C) each; tuples past m are virtual SENT.  A bucket at most half the
// class's capacity (v3, 1-2 planes, plans its buckets to about half of
// it) so costs every CTA half the work of a full one.  3-4 planes (v4
// and v5 classes, whose buckets fill more than half) keep the class's
// network: a bucket's own made their launches 4% slower.
//
// 1 and 2 planes sort their tuple words (cluster_sort.cuh).  3 and 4
// planes sort one uint64 a tuple instead, as a pair does, so a compare
// costs what a pair's does and not a 96- or 128-bit one: the key, the top
// 32 - lr bits of plane 1 and the tuple's index i in the bucket (lr bits,
// term_pack).  Then runs of words equal but for the index are put in the
// order of their remaining planes: the thread holding a run's first
// tuple reads the run's planes from the arena and sorts it by insertion
// (runs are short: equal uniform 32-bit keys in a bucket come in twos
// and threes, and the route's pad tuples, SENT in plane 1, sort after
// the real ones and are never written); and
// the store writes the key from the word and gathers every other plane
// from the arena by the index.  A bucket with a run longer than TERM_RUN
// below `real` is sorted again as whole tuples (the words of
// cluster_sort.cuh), which is what the 1- and 2-plane launches do.  Every
// plane is compared, so the order is lexicographic over all planes
// whatever nlex (the engines pass nplanes - 1; for a smaller nlex the
// order of ties is not defined, as on the global path).
constexpr int TERM_RUN = 32;

struct TermArgs {
  const int32_t* btbl;
  int nb;
  long long src_len, out_len;
  int cap_rows, class_id;
  int32_t xor_out;
  int lr, sb;
};

// This CTA's share [x0, x0 + 2^sb) of a bucket of m tuples at `base` of
// `src` into shared memory as tuple words (past m: SENT), with 16-byte
// loads where the planes allow.
template <int NP>
__device__ void term_load(const CsView<NP>& view, const Planes<NP>& src,
                          long long base, long long m, long long x0) {
  constexpr int U = CS_UNROLL;
  const int S = 1 << view.sb;
  bool vec = true;
#pragma unroll
  for (int q = 0; q < NP; ++q)
    vec &= ((uintptr_t)(src.p[q] + base) & 15) == 0;
  for (int v0 = threadIdx.x; v0 < (S >> 2); v0 += U * blockDim.x) {
    int32_t wv[U][NP][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * blockDim.x;
      const long long x = x0 + 4 * v;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int32_t* g = src.p[q] + base + x;
#pragma unroll
        for (int c = 0; c < 4; ++c) wv[u][q][c] = SENT;
        if (v < (S >> 2) && x < m) {
          if (vec && x + 4 <= m) {
            const int4 t = *(const int4*)g;
            wv[u][q][0] = t.x; wv[u][q][1] = t.y;
            wv[u][q][2] = t.z; wv[u][q][3] = t.w;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (x + c < m) wv[u][q][c] = g[c];
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v >= (S >> 2)) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int at = cs_pad<NP>(4 * v) + c;
        if (x0 + 4 * v + c < m) {
          int32_t t[NP];
#pragma unroll
          for (int q = 0; q < NP; ++q) t[q] = wv[u][q][c];
          cs_put<NP>(view.sm, at, view.ps, t);
        } else {
          cs_put_sent<NP>(view.sm, at, view.ps);
        }
      }
    }
  }
}

// The share's sorted tuple words below `real` to out[off + ...], every
// plane; consecutive threads, consecutive tuples: coalesced stores at
// any output offset.
template <int NP>
__device__ void term_store(const CsView<NP>& view, const Planes<NP>& out,
                           long long off, long long real, long long x0,
                           int32_t xor_out) {
  const int S = 1 << view.sb;
  for (int v = threadIdx.x; v < S && x0 + v < real; v += blockDim.x) {
    int32_t t[NP];
    cs_get<NP>(view.sm, cs_pad<NP>(v), view.ps, t);
#pragma unroll
    for (int q = 0; q < NP; ++q) out.p[q][off + x0 + v] = t[q] ^ xor_out;
  }
}

// 3-4 planes: the word of run position e, wherever in the cluster it
// lies (this CTA's own shares through its shared window).
__device__ __forceinline__ unsigned long long* term_word(
    const CsView<2>& kv, long long e) {
  const int cta = (int)(e >> kv.sb);
  const int at = cs_pad<2>((int)(e & ((1 << kv.sb) - 1)));
  return (cta == kv.rank ? kv.sm : kv.rwords[cta]) + at;
}

// 3-4 planes: the word of tuple i of a bucket (lr index bits): the key,
// the top 32 - lr bits of plane 1, the index, compared as one uint64.
__device__ __forceinline__ unsigned long long term_pack(int32_t k, int32_t p1,
                                                        uint32_t i, int lr) {
  return ((unsigned long long)(uint32_t)(k ^ BIAS) << 32) |
         ((((uint32_t)(p1 ^ BIAS)) >> lr) << lr) | i;
}

// 3-4 planes: order every run of words equal but for the index that
// starts in this CTA's share below `real` (a run that starts past it is
// not written) by the remaining planes (read from the arena at `base`);
// returns false if such a run is longer than TERM_RUN.
template <int NP>
__device__ bool term_fix_runs(const CsView<2>& kv, const Planes<NP>& src,
                              long long base, long long m, long long real,
                              long long x0) {
  const int S = 1 << kv.sb, lr = kv.lr;
  const uint32_t imask = (1u << lr) - 1;
  bool ok = true;
  for (int v = threadIdx.x; v < S && x0 + v < real; v += blockDim.x) {
    const long long p = x0 + v;
    const unsigned long long top = kv.sm[cs_pad<2>(v)] >> lr;
    if (p + 1 >= m || (*term_word(kv, p + 1) >> lr) != top) continue;
    if (p > 0 && (*term_word(kv, p - 1) >> lr) == top) continue;
    long long e = p + 2;
    while (e < m && e - p <= TERM_RUN && (*term_word(kv, e) >> lr) == top)
      ++e;
    const int len = (int)(e - p);
    if (len > TERM_RUN) {
      ok = false;
      continue;
    }
    uint32_t idx[TERM_RUN];
    int32_t low[TERM_RUN][NP - 1];
    for (int i = 0; i < len; ++i) {       // every load before the sort
      idx[i] = (uint32_t)*term_word(kv, p + i) & imask;
#pragma unroll
      for (int q = 1; q < NP; ++q) low[i][q - 1] = src.p[q][base + idx[i]];
    }
    for (int i = 1; i < len; ++i) {
      const uint32_t x = idx[i];
      int32_t l[NP - 1];
#pragma unroll
      for (int q = 0; q < NP - 1; ++q) l[q] = low[i][q];
      int j = i;
      for (; j > 0; --j) {      // insertion: lexicographic over the planes
        int c = 0;
#pragma unroll
        for (int q = 0; q < NP - 1; ++q)
          if (c == 0) c = (low[j - 1][q] > l[q]) - (low[j - 1][q] < l[q]);
        if (c <= 0) break;
        idx[j] = idx[j - 1];
#pragma unroll
        for (int q = 0; q < NP - 1; ++q) low[j][q] = low[j - 1][q];
      }
      idx[j] = x;
#pragma unroll
      for (int q = 0; q < NP - 1; ++q) low[j][q] = l[q];
    }
    for (int i = 0; i < len; ++i)
      *term_word(kv, p + i) = (top << lr) | idx[i];
  }
  return ok;
}

// 3-4 planes: the share's words below `real` to out[off + ...]: the key
// from the word, every other plane gathered from the arena at `base` by
// the index; a thread's eight gathers go out before its stores.
template <int NP>
__device__ void term_gather(const CsView<2>& kv, const Planes<NP>& src,
                            const Planes<NP>& out, long long base,
                            long long off, long long real, long long x0,
                            int32_t xor_out) {
  constexpr int U = 8;
  const int S = 1 << kv.sb;
  const uint32_t imask = (1u << kv.lr) - 1;
  for (int v0 = threadIdx.x; v0 < S && x0 + v0 < real;
       v0 += U * blockDim.x) {
    unsigned long long t[U];
    int32_t g[U][NP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * blockDim.x;
      t[u] = v < S && x0 + v < real ? kv.sm[cs_pad<2>(v)] : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * blockDim.x;
      g[u][0] = cs_hi(t[u]);
      if (v < S && x0 + v < real) {
#pragma unroll
        for (int q = 1; q < NP; ++q)
          g[u][q] = src.p[q][base + ((uint32_t)t[u] & imask)];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < S && x0 + v < real) {
#pragma unroll
        for (int q = 0; q < NP; ++q)
          out.p[q][off + x0 + v] = g[u][q] ^ xor_out;
      }
    }
  }
}

template <int NP>
__global__ void __launch_bounds__(CS_THREADS, 1) terminal_cluster_kernel(
    Planes<NP> src, Planes<NP> out, TermArgs k) {
  extern __shared__ __align__(16) unsigned char cs_smem[];
  const int cbits = k.lr - k.sb, C = 1 << cbits;
  const int cid = blockIdx.x >> cbits, G = gridDim.x >> cbits;
  const int rank = blockIdx.x & (C - 1);
  cg::cluster_group cl = cg::this_cluster();
  // the tuples (1-2 planes: a bucket sets its own sb and lr) and, 3-4
  // planes, the (key, index) words over the same shared memory
  CsView<NP> view = cs_view<NP>(cs_smem, cl, k.lr, k.sb, rank);
  const CsView<2> kv{(unsigned long long*)view.sm,
                     (unsigned long long**)view.rwords, cs_pad<2>(1 << k.sb),
                     k.sb, k.lr, rank};
  int* list = (int*)(view.sm + CsTypes<NP>::units * view.ps);  // buckets
  int* wsum = list + CS_THREADS;                          // warp counts
  int* longrun = wsum + CS_THREADS / 32;                  // 2 parities
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // the buckets among the first n of the launch that cluster cid takes
  auto taken = [&](long long n) {
    return n > cid ? (n - cid + G - 1) / G : 0LL;
  };
  auto sync_cluster = [&]() {
    if (C > 1) cl.sync(); else __syncthreads();
  };
  long long seen = 0;
  int sorted = 0;
  for (int r0 = 0; r0 < k.nb; r0 += CS_THREADS) {
    const int i = r0 + threadIdx.x;
    bool in = false;
    if (i < k.nb) {
      const int32_t* row = k.btbl + 8LL * i;
      in = row[2] > 0 && (k.class_id < 0 || row[6] == k.class_id);
    }
    const unsigned bal = __ballot_sync(FULL_MASK, in);
    if (lane == 0) wsum[w] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
    for (int ww = 0; ww < CS_THREADS / 32; ++ww) {
      const int c = wsum[ww];
      before += ww < w ? c : 0;
      total += c;
    }
    const long long kk = seen + before + __popc(bal & ((1u << lane) - 1));
    if (in && kk % G == cid) list[taken(kk) - taken(seen)] = i;
    __syncthreads();
    const int nmine = (int)(taken(seen + total) - taken(seen));
    seen += total;
    for (int j = 0; j < nmine; ++j) {
      // the same row for every CTA of the cluster: all skip or none
      const int32_t* row = k.btbl + 8LL * list[j];
      const long long base = (long long)row[0] * LANES;
      const long long off = row[5];
      long long real = min((long long)row[2], k.out_len - off);
      if (row[3] != 0) {                  // value fill (keys only)
        const int32_t v = row[4] ^ k.xor_out;
        for (long long e = (long long)rank * blockDim.x + threadIdx.x;
             e < real; e += (long long)C * blockDim.x)
          out.p[0][off + e] = v;
        continue;
      }
      // the class capacity bounds what is sorted, as on the reference
      const long long m = max(0LL, min((long long)min(row[1], k.cap_rows)
                                       * LANES, k.src_len - base));
      real = min(real, m);
      if (m == 0 || real <= 0) continue;
      long long x0 = (long long)rank << k.sb;
      if constexpr (NP <= 2) {            // this bucket's network
        int lb = cbits + cs_w<NP>() + 2;
        while ((1LL << lb) < m) ++lb;
        view.lr = min(lb, k.lr);
        view.sb = view.lr - cbits;
        x0 = (long long)rank << view.sb;
      } else {
        const int par = sorted++ & 1;
        if (threadIdx.x == 0) longrun[par] = 0;
        const int S = 1 << k.sb;
        for (int v = threadIdx.x; v < S; v += blockDim.x) {
          const long long x = x0 + v;
          kv.sm[cs_pad<2>(v)] =
              x < m ? term_pack(src.p[0][base + x], src.p[1][base + x],
                                (uint32_t)x, k.lr)
                    : ~0ULL;
        }
        cs_network<2, cs_cta_log<NP>()>(kv, cl, false);
        sync_cluster();                   // every share sorted
        if (!term_fix_runs<NP>(kv, src, base, m, real, x0)) longrun[par] = 1;
        sync_cluster();                   // every run ordered, flags set
        // thread c reads CTA c's flag: one remote read a CTA, not a
        // remote read of every flag by every thread
        const bool whole = __syncthreads_or(
            (int)threadIdx.x < C &&
            *cl.map_shared_rank(longrun + par, (int)threadIdx.x) != 0);
        if (!whole) {
          term_gather<NP>(kv, src, out, base, off, real, x0, k.xor_out);
          __syncthreads();                // reads done before the next load
          continue;
        }
        // a long run of equal keys: sort whole tuples (no CTA reads
        // another's shared memory past the barrier above)
      }
      term_load<NP>(view, src, base, m, x0);
      cs_network<NP>(view, cl, false);
      term_store<NP>(view, out, off, real, x0, k.xor_out);
      __syncthreads();                    // reads done before the next load
    }
    __syncthreads();                      // list and wsum reused
  }
  // a CTA's shared memory must outlive the others' reads of it (the
  // long-run flags of the last bucket)
  if (C > 1) cl.sync();
}

// Dynamic shared memory of a CTA of the cluster path: the tuples, then
// the bucket list, the warp counts and the two long-run flags.
template <int NP>
size_t terminal_smem(int sb) {
  return cs_smem_bytes<NP>(sb)
         + (CS_THREADS + CS_THREADS / 32 + 2) * sizeof(int);
}

// Whether a class of cap_rows rows can sort on a network of 2^lr tuples,
// 2^sb a CTA (the host picks lr and sb: ops/kernels_v4.py's
// terminal_geometry).
template <int NP>
bool terminal_fits(int cap_rows, int lr, int sb) {
  return sb >= cs_w<NP>() + 2 && sb <= cs_cta_log<NP>() && lr >= sb &&
         (1 << (lr - sb)) <= CS_MAX_CTAS &&
         (long long)cap_rows * LANES <= (1LL << lr);
}

// ----------------------------------------------------------- splice_runs
// One block per run row of btbl = (src_row, occ_rows, real, ., ., out_off,
// ., .): the first min(real, min(occ_rows, max_occ) * 128) elements at
// src_row * 128 go, xor xor_out, to [out_off, ...) of every plane.  A
// pure copy with element-exact stores, so runs may land in any order.
template <int NP>
__global__ void __launch_bounds__(SPLICE_THREADS) splice_runs_kernel(
    Planes<NP> src, long long src_len, const int32_t* __restrict__ btbl,
    Planes<NP> out, long long out_len, int max_occ, int32_t xor_out) {
  const int32_t* row = btbl + 8LL * blockIdx.x;
  const long long base = (long long)row[0] * LANES;
  const long long occ = max(0, min(row[1], max_occ));
  const long long off = row[5];
  long long real = min((long long)row[2], occ * LANES);
  real = min(real, min(out_len - off, src_len - base));
  if (real <= 0 || base < 0 || off < 0) return;
  for (long long i = threadIdx.x; i < real; i += blockDim.x) {
#pragma unroll
    for (int q = 0; q < NP; ++q)
      out.p[q][off + i] = src.p[q][base + i] ^ xor_out;
  }
}

// A range-mode route launch; rows, shm (route_range_kernel's shared
// memory) and split (blocks a tile, with gcur: ntiles x rmax zeroed run
// cursors when it is above 1) come from the host.
template <int NP>
int launch_route(void* const* src, long long src_len, const void* meta,
                 const void* bounds, const void* cnt, const void* dst,
                 const void* padv, void* const* out, long long out_len,
                 int ntiles, int pitch, int rmax, int32_t xor_in, int rows,
                 long long shm, int split, void* gcur, cudaStream_t stream) {
  if (rmax < 1 || rmax >= (1 << 16) || rows < 1 || shm < 1 ||
      shm > (long long)SMEM_MAX || split < 1 ||
      (split > 1 && gcur == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      route_range_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  route_range_kernel<NP><<<(long long)ntiles * split, ROUTE_THREADS,
                           (size_t)shm, stream>>>(
      planes_of<NP>(src), src_len, (const int32_t*)meta,
      (const int32_t*)bounds, (const int32_t*)cnt, (const int32_t*)dst,
      (const int32_t*)padv, planes_of<NP>(out), out_len, pitch, rmax, xor_in,
      rows, split, (int*)gcur);
  return (int)cudaGetLastError();
}

// A digit-mode route launch; shm (route_digit_kernel's shared memory)
// comes from the host.
template <int NP>
int launch_route_digit(void* const* src, long long src_len,
                       const void* meta, const void* cnt, const void* dst,
                       const void* padv, void* const* out, long long out_len,
                       int ntiles, int pitch, int rmax, int shift,
                       unsigned mask, int dp, long long shm,
                       cudaStream_t stream) {
  if (rmax < 1 || rmax >= (1 << 16) || shm < 1 ||
      shm > (long long)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      route_digit_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  route_digit_kernel<NP><<<ntiles, ROUTE_THREADS, (size_t)shm, stream>>>(
      planes_of<NP>(src), src_len, (const int32_t*)meta, (const int32_t*)cnt,
      (const int32_t*)dst, (const int32_t*)padv, planes_of<NP>(out), out_len,
      pitch, rmax, shift, mask, dp);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_terminal(void* const* src, long long src_len, const void* btbl,
                    int nb, void* const* out, long long out_len,
                    void* scratch, const void* soff, long long scratch_len,
                    int nlex, int32_t xor_out, int cap_rows, int class_id,
                    cudaStream_t stream) {
  const size_t shm = (size_t)NP * smem_tile<NP>() * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      terminal_write_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  terminal_write_kernel<NP><<<nb, TERM_THREADS, shm, stream>>>(
      planes_of<NP>(src), src_len, (const int32_t*)btbl, planes_of<NP>(out),
      out_len, (int32_t*)scratch, (const long long*)soff, scratch_len, nlex,
      xor_out, cap_rows, class_id);
  return (int)cudaGetLastError();
}

// Clusters of the cluster path that are resident at once for a network
// of 2^lr tuples, 2^sb a CTA (the persistent grid), or a negative CUDA
// error.
template <int NP>
int terminal_resident(int lr, int sb) {
  int resident = 0;
  if (!terminal_fits<NP>(1, lr, sb)) return -(int)cudaErrorInvalidValue;
  const cudaError_t err =
      cs_max_clusters(terminal_cluster_kernel<NP>, 1 << (lr - sb),
                      terminal_smem<NP>(sb), &resident);
  return err != cudaSuccess ? -(int)err : resident;
}

template <int NP>
int launch_terminal_cluster(void* const* src, long long src_len,
                            const void* btbl, int nb, void* const* out,
                            long long out_len, int32_t xor_out, int cap_rows,
                            int class_id, int lr, int sb,
                            cudaStream_t stream) {
  if (!terminal_fits<NP>(cap_rows, lr, sb)) return (int)cudaErrorInvalidValue;
  if (nb <= 0) return (int)cudaGetLastError();
  const int ctas = 1 << (lr - sb);
  const int resident = terminal_resident<NP>(lr, sb);
  if (resident < 0) return -resident;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  const TermArgs k{(const int32_t*)btbl, nb, src_len, out_len, cap_rows,
                   class_id, xor_out, lr, sb};
  const cudaError_t err = cs_launch(
      terminal_cluster_kernel<NP>, (long long)std::min(nb, resident) * ctas,
      ctas, terminal_smem<NP>(sb), stream, planes_of<NP>(src),
      planes_of<NP>(out), k);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NP>
int launch_splice(void* const* src, long long src_len, const void* btbl,
                  int nruns, void* const* out, long long out_len,
                  int max_occ, int32_t xor_out, cudaStream_t stream) {
  splice_runs_kernel<NP><<<nruns, SPLICE_THREADS, 0, stream>>>(
      planes_of<NP>(src), src_len, (const int32_t*)btbl, planes_of<NP>(out),
      out_len, max_occ, xor_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// CUDA's text for an error code a launcher of any source returned.
const char* kv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// hist_level: range mode when shift < 0, else digit mode; copies, shm
// (hist_kernel's shared memory) and split (blocks a tile; hist zeroed
// when it is above 1) come from the host.
int kv4_hist_level(const void* src, long long src_len, const void* meta,
                   const void* bounds, void* hist, int ntiles, int pitch,
                   int rmax, int bias_input, int shift, int bits, int copies,
                   long long shm, int split, void* stream) {
  if (rmax < 1 || copies < 1 || (copies & (copies - 1)) || shm < 1 ||
      shm > (long long)SMEM_MAX || split < 1)
    return (int)cudaErrorInvalidValue;
  void (*kernel)(const int32_t*, long long, const int32_t*, const int32_t*,
                 int32_t*, int, int, int32_t, int, unsigned, int, int) =
      shift < 0 ? hist_kernel<true> : hist_kernel<false>;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(long long)ntiles * split, HIST_THREADS, (size_t)shm,
           (cudaStream_t)stream>>>(
      (const int32_t*)src, src_len, (const int32_t*)meta,
      (const int32_t*)bounds, (int32_t*)hist, pitch, rmax,
      bias_input ? BIAS : 0, shift < 0 ? 0 : shift,
      (unsigned)((1ull << bits) - 1), copies, split);
  return (int)cudaGetLastError();
}

int kv4_route_digit(void* s0, void* s1, void* s2, void* s3,
                    long long src_len, const void* meta, const void* cnt,
                    const void* dst, const void* padv, void* o0, void* o1,
                    void* o2, void* o3, long long out_len, int nplanes,
                    int ntiles, int pitch, int rmax, int shift, int bits,
                    int digit_plane, long long shm, void* stream) {
  void* const src[MAX_PLANES] = {s0, s1, s2, s3};
  void* const out[MAX_PLANES] = {o0, o1, o2, o3};
  const unsigned mask = (unsigned)((1ull << bits) - 1);
  cudaStream_t st = (cudaStream_t)stream;
  switch (nplanes) {
    case 1: return launch_route_digit<1>(src, src_len, meta, cnt, dst, padv,
                                         out, out_len, ntiles, pitch, rmax,
                                         shift, mask, digit_plane, shm, st);
    case 2: return launch_route_digit<2>(src, src_len, meta, cnt, dst, padv,
                                         out, out_len, ntiles, pitch, rmax,
                                         shift, mask, digit_plane, shm, st);
    case 3: return launch_route_digit<3>(src, src_len, meta, cnt, dst, padv,
                                         out, out_len, ntiles, pitch, rmax,
                                         shift, mask, digit_plane, shm, st);
    case 4: return launch_route_digit<4>(src, src_len, meta, cnt, dst, padv,
                                         out, out_len, ntiles, pitch, rmax,
                                         shift, mask, digit_plane, shm, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// route_level's range and accumulate modes.  Plane pointers come as four
// arguments each (NULL past nplanes).
int kv4_route_level(void* s0, void* s1, void* s2, void* s3,
                    long long src_len, const void* meta, const void* bounds,
                    const void* cnt, const void* dst, const void* padv,
                    void* o0, void* o1, void* o2, void* o3,
                    long long out_len, int nplanes, int ntiles, int pitch,
                    int rmax, int bias_input, int rows, long long shm,
                    int split, void* gcur, void* stream) {
  void* const src[MAX_PLANES] = {s0, s1, s2, s3};
  void* const out[MAX_PLANES] = {o0, o1, o2, o3};
  const int32_t x = bias_input ? BIAS : 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nplanes) {
    case 1: return launch_route<1>(src, src_len, meta, bounds, cnt, dst,
                                   padv, out, out_len, ntiles, pitch, rmax,
                                   x, rows, shm, split, gcur, st);
    case 2: return launch_route<2>(src, src_len, meta, bounds, cnt, dst,
                                   padv, out, out_len, ntiles, pitch, rmax,
                                   x, rows, shm, split, gcur, st);
    case 3: return launch_route<3>(src, src_len, meta, bounds, cnt, dst,
                                   padv, out, out_len, ntiles, pitch, rmax,
                                   x, rows, shm, split, gcur, st);
    case 4: return launch_route<4>(src, src_len, meta, bounds, cnt, dst,
                                   padv, out, out_len, ntiles, pitch, rmax,
                                   x, rows, shm, split, gcur, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int kv4_terminal_write(void* s0, void* s1, void* s2, void* s3,
                       long long src_len, const void* btbl, int nb,
                       void* o0, void* o1, void* o2, void* o3,
                       long long out_len, void* scratch, const void* soff,
                       long long scratch_len, int nplanes, int nlex,
                       int unbias_output, int cap_rows, int class_id,
                       void* stream) {
  void* const src[MAX_PLANES] = {s0, s1, s2, s3};
  void* const out[MAX_PLANES] = {o0, o1, o2, o3};
  const int32_t x = unbias_output ? BIAS : 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nplanes) {
    case 1: return launch_terminal<1>(src, src_len, btbl, nb, out, out_len,
                                      scratch, soff, scratch_len, nlex, x,
                                      cap_rows, class_id, st);
    case 2: return launch_terminal<2>(src, src_len, btbl, nb, out, out_len,
                                      scratch, soff, scratch_len, nlex, x,
                                      cap_rows, class_id, st);
    case 3: return launch_terminal<3>(src, src_len, btbl, nb, out, out_len,
                                      scratch, soff, scratch_len, nlex, x,
                                      cap_rows, class_id, st);
    case 4: return launch_terminal<4>(src, src_len, btbl, nb, out, out_len,
                                      scratch, soff, scratch_len, nlex, x,
                                      cap_rows, class_id, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The cluster path of terminal_write (no scratch) on a network of 2^lr
// tuples, 2^sb a CTA: refused when that does not hold the class's
// capacity or needs more than CS_MAX_CTAS CTAs.
int kv4_terminal_cluster(void* s0, void* s1, void* s2, void* s3,
                         long long src_len, const void* btbl, int nb,
                         void* o0, void* o1, void* o2, void* o3,
                         long long out_len, int nplanes, int unbias_output,
                         int cap_rows, int class_id, int lr, int sb,
                         void* stream) {
  void* const src[MAX_PLANES] = {s0, s1, s2, s3};
  void* const out[MAX_PLANES] = {o0, o1, o2, o3};
  const int32_t x = unbias_output ? BIAS : 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nplanes) {
    case 1: return launch_terminal_cluster<1>(src, src_len, btbl, nb, out,
                                              out_len, x, cap_rows, class_id,
                                              lr, sb, st);
    case 2: return launch_terminal_cluster<2>(src, src_len, btbl, nb, out,
                                              out_len, x, cap_rows, class_id,
                                              lr, sb, st);
    case 3: return launch_terminal_cluster<3>(src, src_len, btbl, nb, out,
                                              out_len, x, cap_rows, class_id,
                                              lr, sb, st);
    case 4: return launch_terminal_cluster<4>(src, src_len, btbl, nb, out,
                                              out_len, x, cap_rows, class_id,
                                              lr, sb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The persistent grid of the cluster path on a network of 2^lr tuples,
// 2^sb a CTA, in clusters (a negative CUDA error if that is no cluster
// or the query fails).
int kv4_terminal_resident(int nplanes, int lr, int sb) {
  switch (nplanes) {
    case 1: return terminal_resident<1>(lr, sb);
    case 2: return terminal_resident<2>(lr, sb);
    case 3: return terminal_resident<3>(lr, sb);
    case 4: return terminal_resident<4>(lr, sb);
    default: return -(int)cudaErrorInvalidValue;
  }
}

int kv4_splice_runs(void* s0, void* s1, void* s2, void* s3,
                    long long src_len, const void* btbl, int nruns,
                    void* o0, void* o1, void* o2, void* o3,
                    long long out_len, int nplanes, int max_occ,
                    int unbias_output, void* stream) {
  void* const src[MAX_PLANES] = {s0, s1, s2, s3};
  void* const out[MAX_PLANES] = {o0, o1, o2, o3};
  const int32_t x = unbias_output ? BIAS : 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nplanes) {
    case 1: return launch_splice<1>(src, src_len, btbl, nruns, out, out_len,
                                    max_occ, x, st);
    case 2: return launch_splice<2>(src, src_len, btbl, nruns, out, out_len,
                                    max_occ, x, st);
    case 3: return launch_splice<3>(src, src_len, btbl, nruns, out, out_len,
                                    max_occ, x, st);
    case 4: return launch_splice<4>(src, src_len, btbl, nruns, out, out_len,
                                    max_occ, x, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
