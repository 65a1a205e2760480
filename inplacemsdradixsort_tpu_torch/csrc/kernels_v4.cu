// Hand-written Hopper (sm_90a) kernels of the v4 engine: the partition
// level (hist_level, route_level), the terminal sort (terminal_write) and
// the run splice of the deep tier (splice_runs).
//
// The LSB engine's passes run the digit modes of the level kernels
// (hist_digit_kernel, route_digit_kernel): counts by a radix digit of the
// raw word, and a partition that is stable by that digit.
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

#include "bitonic.cuh"

namespace {

constexpr int LEVEL_THREADS = 512;   // hist_level / route_level block
constexpr int TERM_THREADS = 1024;   // terminal_write block
constexpr int SPLICE_THREADS = 256;  // splice_runs block
constexpr int DIGIT_THREADS = 512;   // route_digit_kernel block
constexpr int DIGIT_WARPS = DIGIT_THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The radix digit (raw >> shift) & mask of a raw uint32 word held in an
// int32, shifted logically so that no sign bit leaks into the digit.
__device__ __forceinline__ unsigned digit_of(int32_t raw, int shift,
                                             unsigned mask) {
  return ((uint32_t)raw >> shift) & mask;
}

// First d in [0, rmax) with k <= b[d] for non-decreasing inclusive upper
// bounds b; rmax when k exceeds every bound.
__device__ __forceinline__ int find_range(const int32_t* b, int rmax,
                                          int32_t k) {
  int lo = 0, hi = rmax;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (k <= b[mid]) hi = mid; else lo = mid + 1;
  }
  return lo;
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
// One block per tile: classify each live element by binary search over
// the parent's bounds, count in shared memory, write the tile's row.
// Slack lanes are skipped by index, never by value: SENT equals a real
// biased 0xFFFFFFFF.
__global__ void __launch_bounds__(LEVEL_THREADS) hist_level_kernel(
    const int32_t* __restrict__ src, long long src_len,
    const int32_t* __restrict__ meta, const int32_t* __restrict__ bounds,
    int32_t* __restrict__ hist, int pitch, int rmax, int32_t xor_in) {
  extern __shared__ int32_t smem[];
  int32_t* sb = smem;            // rmax bounds
  int* cnt = smem + rmax;        // rmax counters
  const int t = blockIdx.x;
  const TileMeta m = tile_meta(meta, t, pitch, src_len);
  for (int d = threadIdx.x; d < rmax; d += blockDim.x) {
    sb[d] = bounds[(long long)m.parent * rmax + d];
    cnt[d] = 0;
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < m.nel; i += blockDim.x) {
    int d = find_range(sb, rmax, src[m.base + i] ^ xor_in);
    if (d < rmax) atomicAdd(&cnt[d], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < rmax; d += blockDim.x)
    hist[(long long)t * rmax + d] = cnt[d];
}


// One block per tile, digit mode: count each live element by the digit
// of its raw word; digits >= rmax and slack lanes count nowhere.  The
// lanes of a warp that share a digit add their count once
// (__match_any_sync), which keeps the shared atomics off the critical
// path when few digits occur.
__global__ void __launch_bounds__(LEVEL_THREADS) hist_digit_kernel(
    const int32_t* __restrict__ src, long long src_len,
    const int32_t* __restrict__ meta, int32_t* __restrict__ hist, int pitch,
    int rmax, int shift, unsigned mask) {
  extern __shared__ int32_t smem[];
  int* cnt = smem;               // rmax counters
  const int t = blockIdx.x;
  const TileMeta m = tile_meta(meta, t, pitch, src_len);
  for (int d = threadIdx.x; d < rmax; d += blockDim.x) cnt[d] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (long long i0 = 0; i0 < m.nel; i0 += blockDim.x) {
    const long long i = i0 + threadIdx.x;
    const int d = i < m.nel ? (int)digit_of(src[m.base + i], shift, mask)
                            : -1;
    const unsigned peers = __match_any_sync(FULL_MASK, d);
    if (d >= 0 && d < rmax && lane == __ffs(peers) - 1)
      atomicAdd(&cnt[d], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < rmax; d += blockDim.x)
    hist[(long long)t * rmax + d] = cnt[d];
}

// ----------------------------------------------------------- route_level
// One block per tile: each live element claims the next slot of its
// range's run (plane 0 classifies) with a shared-memory atomic and is
// stored at dst[t, d] * 128 + slot in every plane (64-bit addresses).
// The run's tail gets (-cnt) % 128 pad tuples (padv[t, d], SENT, ...), so
// the run fills exactly ceil(cnt / 128) rows.  Every store is
// element-exact: blocks run in no order, so nothing may be written
// outside the block's own runs.  dst < 0 marks a dropped (value-filled)
// range: nothing is stored.
template <int NP>
__global__ void __launch_bounds__(LEVEL_THREADS) route_level_kernel(
    Planes<NP> src, long long src_len,
    const int32_t* __restrict__ meta, const int32_t* __restrict__ bounds,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ padv, Planes<NP> out, long long out_len,
    int pitch, int rmax, int32_t xor_in) {
  extern __shared__ long long smem64[];
  long long* sdst = smem64;                          // rmax run bases
  int32_t* sb = (int32_t*)(smem64 + rmax);           // rmax bounds
  int* scnt = sb + rmax;                             // rmax run counts
  int* cur = scnt + rmax;                            // rmax cursors
  const int t = blockIdx.x;
  const TileMeta m = tile_meta(meta, t, pitch, src_len);
  const long long row0 = (long long)t * rmax;
  for (int d = threadIdx.x; d < rmax; d += blockDim.x) {
    sb[d] = bounds[(long long)m.parent * rmax + d];
    scnt[d] = cnt[row0 + d];
    const int dr = dst[row0 + d];
    sdst[d] = dr >= 0 ? (long long)dr * LANES : -1;
    cur[d] = 0;
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < m.nel; i += blockDim.x) {
    const int32_t k = src.p[0][m.base + i] ^ xor_in;
    const int d = find_range(sb, rmax, k);
    if (d < rmax && sdst[d] >= 0) {
      const int slot = atomicAdd(&cur[d], 1);
      const long long o = sdst[d] + slot;
      if (slot < scnt[d] && o < out_len) {
        out.p[0][o] = k;
#pragma unroll
        for (int q = 1; q < NP; ++q)
          out.p[q][o] = src.p[q][m.base + i] ^ xor_in;
      }
    }
  }
  // pads occupy [cnt, cnt + npad) of each run: disjoint from the element
  // slots above, so no barrier is needed between the two loops
  for (int q = threadIdx.x; q < rmax * LANES; q += blockDim.x) {
    const int d = q / LANES, j = q % LANES;
    if (sdst[d] < 0) continue;
    const int c = scnt[d];
    if (j < ((-c) & (LANES - 1))) {
      const long long o = sdst[d] + c + j;
      if (o < out_len) {
        out.p[0][o] = padv[row0 + d];
#pragma unroll
        for (int p = 1; p < NP; ++p) out.p[p][o] = SENT;
      }
    }
  }
}


// One block per tile, digit mode: a partition that is STABLE by the digit
// of plane dp.  The block walks its tile in input order, one chunk of
// DIGIT_THREADS elements at a time (thread i takes element i of the
// chunk).  Inside a warp, an element's rank among the earlier lanes with
// its digit is __popc(peers & lanes below), peers from __match_any_sync;
// the warp's per-digit totals go to shared memory and one thread per
// digit scans them in warp order, starting at the digit's running cursor,
// which carries from chunk to chunk.  So each element's slot is the
// number of earlier elements of the tile with its digit, and every run
// holds its cnt[t, d] tuples in input order, then (-cnt) % 128 pad tuples
// (padv[t, d] in plane dp, SENT in the others).  Stores are element-exact
// with 64-bit addresses.
template <int NP>
__global__ void __launch_bounds__(DIGIT_THREADS) route_digit_kernel(
    Planes<NP> src, long long src_len, const int32_t* __restrict__ meta,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ padv, Planes<NP> out, long long out_len,
    int pitch, int rmax, int shift, unsigned mask, int dp) {
  extern __shared__ long long smem64[];
  long long* sdst = smem64;                          // rmax run bases
  int* scnt = (int*)(smem64 + rmax);                 // rmax run counts
  int* cur = scnt + rmax;                            // rmax cursors
  int* wcnt = cur + rmax;                            // [warp][digit] counts
  int* woff = wcnt + DIGIT_WARPS * rmax;             // [warp][digit] slots
  const int t = blockIdx.x;
  const TileMeta m = tile_meta(meta, t, pitch, src_len);
  const long long row0 = (long long)t * rmax;
  for (int d = threadIdx.x; d < rmax; d += blockDim.x) {
    scnt[d] = cnt[row0 + d];
    const int dr = dst[row0 + d];
    sdst[d] = dr >= 0 ? (long long)dr * LANES : -1;
    cur[d] = 0;
  }
  for (int q = threadIdx.x; q < DIGIT_WARPS * rmax; q += blockDim.x)
    wcnt[q] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1;
  for (long long i0 = 0; i0 < m.nel; i0 += blockDim.x) {
    const long long i = i0 + threadIdx.x;
    int d = -1;                    // slack, a digit past rmax or no store
    if (i < m.nel) {
      const int g = (int)digit_of(src.p[dp][m.base + i], shift, mask);
      if (g < rmax && sdst[g] >= 0) d = g;
    }
    const unsigned peers = __match_any_sync(FULL_MASK, d);
    const int rank = __popc(peers & below);
    if (d >= 0 && rank == 0) wcnt[w * rmax + d] = __popc(peers);
    __syncthreads();
    // counts are read and cleared here, offsets go to woff: the next
    // chunk's counts may land as soon as this chunk's slots are read
    for (int g = threadIdx.x; g < rmax; g += blockDim.x) {
      int run = cur[g];
#pragma unroll
      for (int ww = 0; ww < DIGIT_WARPS; ++ww) {
        const int c = wcnt[ww * rmax + g];
        wcnt[ww * rmax + g] = 0;
        woff[ww * rmax + g] = run;
        run += c;
      }
      cur[g] = run;
    }
    __syncthreads();
    if (d >= 0) {
      const int slot = woff[w * rmax + d] + rank;
      const long long o = sdst[d] + slot;
      if (slot < scnt[d] && o < out_len) {
#pragma unroll
        for (int q = 0; q < NP; ++q) out.p[q][o] = src.p[q][m.base + i];
      }
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

// -------------------------------------------------------- terminal_write
// One block per bucket row of btbl = (src_row, occ_rows, real, mode,
// fill, out_off, class, 0).  Mode 0 sorts the bucket's occ_rows*128
// tuples ascending (lexicographic over planes 0..nlex) and writes the
// first `real` of them, xor xor_out, to out[out_off, out_off + real) of
// every plane; mode 1 (keys only) writes `real` copies of fill to plane 0.
//
// Sort: the network of bitonic.cuh over the bucket padded to a power of
// two N with virtual all-SENT tuples.  A bucket of up to smem_tile<NP>()
// tuples sorts in shared memory.  A larger one (up to 2*cap_rows*128 =
// 2^19 keys at n >= 2^28; a block has at most 227 KB) sorts in a global
// scratch segment of m tuples, one per plane, at scratch + q * scratch_len +
// soff[bucket] (the wrapper packs the segments of the launch's large
// buckets only): shared-memory tiles are sorted first; then for
// every k > tile the steps with a partner distance >= tile run on global
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

template <int NP>
int launch_route(void* const* src, long long src_len, const void* meta,
                 const void* bounds, const void* cnt, const void* dst,
                 const void* padv, void* const* out, long long out_len,
                 int ntiles, int pitch, int rmax, int32_t xor_in,
                 cudaStream_t stream) {
  const size_t shm = (size_t)rmax * (sizeof(long long) + 3 * sizeof(int));
  route_level_kernel<NP><<<ntiles, LEVEL_THREADS, shm, stream>>>(
      planes_of<NP>(src), src_len, (const int32_t*)meta,
      (const int32_t*)bounds, (const int32_t*)cnt, (const int32_t*)dst,
      (const int32_t*)padv, planes_of<NP>(out), out_len, pitch, rmax,
      xor_in);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_route_digit(void* const* src, long long src_len,
                       const void* meta, const void* cnt, const void* dst,
                       const void* padv, void* const* out, long long out_len,
                       int ntiles, int pitch, int rmax, int shift,
                       unsigned mask, int dp, cudaStream_t stream) {
  const size_t shm = (size_t)rmax * (sizeof(long long) + 2 * sizeof(int))
                     + 2 * (size_t)DIGIT_WARPS * rmax * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      route_digit_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  route_digit_kernel<NP><<<ntiles, DIGIT_THREADS, shm, stream>>>(
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

int kv4_hist_level(const void* src, long long src_len, const void* meta,
                   const void* bounds, void* hist, int ntiles, int pitch,
                   int rmax, int bias_input, void* stream) {
  const size_t shm = 2 * (size_t)rmax * sizeof(int32_t);
  hist_level_kernel<<<ntiles, LEVEL_THREADS, shm, (cudaStream_t)stream>>>(
      (const int32_t*)src, src_len, (const int32_t*)meta,
      (const int32_t*)bounds, (int32_t*)hist, pitch, rmax,
      bias_input ? BIAS : 0);
  return (int)cudaGetLastError();
}

int kv4_hist_digit(const void* src, long long src_len, const void* meta,
                   void* hist, int ntiles, int pitch, int rmax, int shift,
                   int bits, void* stream) {
  const size_t shm = (size_t)rmax * sizeof(int32_t);
  hist_digit_kernel<<<ntiles, LEVEL_THREADS, shm, (cudaStream_t)stream>>>(
      (const int32_t*)src, src_len, (const int32_t*)meta, (int32_t*)hist,
      pitch, rmax, shift, (unsigned)((1ull << bits) - 1));
  return (int)cudaGetLastError();
}

int kv4_route_digit(void* s0, void* s1, void* s2, void* s3,
                    long long src_len, const void* meta, const void* cnt,
                    const void* dst, const void* padv, void* o0, void* o1,
                    void* o2, void* o3, long long out_len, int nplanes,
                    int ntiles, int pitch, int rmax, int shift, int bits,
                    int digit_plane, void* stream) {
  void* const src[MAX_PLANES] = {s0, s1, s2, s3};
  void* const out[MAX_PLANES] = {o0, o1, o2, o3};
  const unsigned mask = (unsigned)((1ull << bits) - 1);
  cudaStream_t st = (cudaStream_t)stream;
  switch (nplanes) {
    case 1: return launch_route_digit<1>(src, src_len, meta, cnt, dst, padv,
                                         out, out_len, ntiles, pitch, rmax,
                                         shift, mask, digit_plane, st);
    case 2: return launch_route_digit<2>(src, src_len, meta, cnt, dst, padv,
                                         out, out_len, ntiles, pitch, rmax,
                                         shift, mask, digit_plane, st);
    case 3: return launch_route_digit<3>(src, src_len, meta, cnt, dst, padv,
                                         out, out_len, ntiles, pitch, rmax,
                                         shift, mask, digit_plane, st);
    case 4: return launch_route_digit<4>(src, src_len, meta, cnt, dst, padv,
                                         out, out_len, ntiles, pitch, rmax,
                                         shift, mask, digit_plane, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Plane pointers come as four arguments each (NULL past nplanes).
int kv4_route_level(void* s0, void* s1, void* s2, void* s3,
                    long long src_len, const void* meta, const void* bounds,
                    const void* cnt, const void* dst, const void* padv,
                    void* o0, void* o1, void* o2, void* o3,
                    long long out_len, int nplanes, int ntiles, int pitch,
                    int rmax, int bias_input, void* stream) {
  void* const src[MAX_PLANES] = {s0, s1, s2, s3};
  void* const out[MAX_PLANES] = {o0, o1, o2, o3};
  const int32_t x = bias_input ? BIAS : 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nplanes) {
    case 1: return launch_route<1>(src, src_len, meta, bounds, cnt, dst,
                                   padv, out, out_len, ntiles, pitch, rmax,
                                   x, st);
    case 2: return launch_route<2>(src, src_len, meta, bounds, cnt, dst,
                                   padv, out, out_len, ntiles, pitch, rmax,
                                   x, st);
    case 3: return launch_route<3>(src, src_len, meta, bounds, cnt, dst,
                                   padv, out, out_len, ntiles, pitch, rmax,
                                   x, st);
    case 4: return launch_route<4>(src, src_len, meta, bounds, cnt, dst,
                                   padv, out, out_len, ntiles, pitch, rmax,
                                   x, st);
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
