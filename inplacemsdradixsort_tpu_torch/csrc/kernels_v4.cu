// Hand-written Hopper (sm_90a) kernels of the v4 engine's main path.
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.
// Every launcher takes PyTorch's current stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().
//
// Keys are int32 in the sign-biased encoding (biased = raw ^ 0x80000000,
// so signed order = unsigned order of the raw words); SENT = biased +inf.
// The Python wrappers and their plain PyTorch versions live in
// ops/kernels_v4.py; the per-kernel notes there say which TPU kernel each
// replaces and what bounds it on the H100.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int32_t BIAS = INT32_MIN;
constexpr int32_t SENT = INT32_MAX;
constexpr int LEVEL_THREADS = 512;   // hist_level / route_level block
constexpr int TERM_THREADS = 1024;   // terminal_write block
constexpr int TILE = 16384;          // terminal shared-memory tile (64 KiB)

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

// ----------------------------------------------------------- route_level
// One block per tile: each live element claims the next slot of its
// range's run with a shared-memory atomic and is stored at
// dst[t, d] * 128 + slot (64-bit addresses).  The run's tail gets
// (-cnt) % 128 copies of padv[t, d], so the run fills exactly
// ceil(cnt / 128) rows.  Every store is element-exact: blocks run in no
// order, so nothing may be written outside the block's own runs.
// dst < 0 marks a dropped (value-filled) range: nothing is stored.
__global__ void __launch_bounds__(LEVEL_THREADS) route_level_kernel(
    const int32_t* __restrict__ src, long long src_len,
    const int32_t* __restrict__ meta, const int32_t* __restrict__ bounds,
    const int32_t* __restrict__ cnt, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ padv, int32_t* __restrict__ out,
    long long out_len, int pitch, int rmax, int32_t xor_in) {
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
    const int32_t k = src[m.base + i] ^ xor_in;
    const int d = find_range(sb, rmax, k);
    if (d < rmax && sdst[d] >= 0) {
      const int slot = atomicAdd(&cur[d], 1);
      const long long o = sdst[d] + slot;
      if (slot < scnt[d] && o < out_len) out[o] = k;
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
      if (o < out_len) out[o] = padv[row0 + d];
    }
  }
}

// -------------------------------------------------------- terminal_write
// One block per bucket row of btbl = (src_row, occ_rows, real, mode,
// fill, out_off, class, 0).  Mode 0 sorts the bucket's occ_rows*128
// elements ascending and writes the first `real` of them, unbiased, to
// out[out_off, out_off + real); mode 1 writes `real` copies of fill.
//
// Sort: a bitonic network in its all-ascending form (the first step of
// each merge size k compares i with i ^ (k-1), the rest i with i ^ j).
// Every compare moves the smaller value to the lower index, so the
// bucket is padded to a power of two N with virtual +inf that is never
// stored: a pair whose upper index is >= m (the bucket's length) is a
// no-op.  A bucket of up to TILE elements sorts in shared memory.  A
// larger one (up to 2*cap_rows*128 = 2^19 keys at n >= 2^28; a block has
// at most 227 KB) sorts in a global scratch segment: shared-memory tiles
// are sorted first; then for every k > TILE the steps with a partner
// distance >= TILE run on global memory and the rest of the steps of
// that k run on each tile in shared memory.  One block owns the bucket,
// so __syncthreads() orders the global steps.

__device__ __forceinline__ void cmpswap_smem(int32_t* s, int i, int p) {
  const int32_t a = s[i], b = s[p];
  if (a > b) { s[i] = b; s[p] = a; }
}

// Lower index of pair q for a step with partner distance h (power of 2).
__device__ __forceinline__ int pair_lo(int q, int h) {
  return ((q & ~(h - 1)) << 1) | (q & (h - 1));
}

// Steps j = jtop, jtop/2, ..., 1 (i <-> i + j) over s[0, size).
__device__ void smem_half_steps(int32_t* s, int size, int jtop) {
  for (int j = jtop; j >= 1; j >>= 1) {
    for (int q = threadIdx.x; q < (size >> 1); q += blockDim.x) {
      const int i = pair_lo(q, j);
      cmpswap_smem(s, i, i + j);
    }
    __syncthreads();
  }
}

// Full sort of s[0, size), size a power of two.
__device__ void smem_sort(int32_t* s, int size) {
  for (int k = 2; k <= size; k <<= 1) {
    for (int q = threadIdx.x; q < (size >> 1); q += blockDim.x) {
      const int i = pair_lo(q, k >> 1);
      cmpswap_smem(s, i, i ^ (k - 1));
    }
    __syncthreads();
    smem_half_steps(s, size, k >> 2);
  }
}

// One global step over g[0, N) with pair distance h; `flip` pairs i with
// i ^ (2h - 1), otherwise with i + h.  Pairs reaching past m are no-ops.
__device__ void global_step(int32_t* g, int N, int m, int h, bool flip) {
  for (int q = threadIdx.x; q < (N >> 1); q += blockDim.x) {
    const int i = pair_lo(q, h);
    const int p = flip ? (i ^ (2 * h - 1)) : (i + h);
    if (p < m) {
      const int32_t a = g[i], b = g[p];
      if (a > b) { g[i] = b; g[p] = a; }
    }
  }
  __syncthreads();
}

__device__ void load_tile(int32_t* s, const int32_t* g, int c, int m) {
  for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
    const int e = c * TILE + i;
    s[i] = e < m ? g[e] : SENT;
  }
  __syncthreads();
}

__device__ void store_tile(const int32_t* s, int32_t* g, int c, int m) {
  for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
    const int e = c * TILE + i;
    if (e < m) g[e] = s[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(TERM_THREADS) terminal_write_kernel(
    const int32_t* __restrict__ src, long long src_len,
    const int32_t* __restrict__ btbl, int32_t* __restrict__ out,
    long long out_len, int32_t* __restrict__ scratch, int cap_rows,
    int class_id) {
  extern __shared__ int32_t s[];   // TILE
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

  if (mode != 0) {                       // value fill
    const int32_t v = fill ^ BIAS;
    for (long long i = threadIdx.x; i < real; i += blockDim.x)
      out[off + i] = v;
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

  if (N <= TILE) {
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      s[i] = i < m ? src[base + i] : SENT;
    __syncthreads();
    smem_sort(s, N);
    for (int i = threadIdx.x; i < real; i += blockDim.x)
      out[off + i] = s[i] ^ BIAS;
    return;
  }

  int32_t* g = scratch + base;
  const int ntile = (m + TILE - 1) / TILE;
  for (int c = 0; c < ntile; ++c) {      // sorted tiles: merges up to TILE
    load_tile(s, src + base, c, m);
    smem_sort(s, TILE);
    store_tile(s, g, c, m);
  }
  for (int k = 2 * TILE; k <= N; k <<= 1) {
    global_step(g, N, m, k >> 1, true);
    for (int j = k >> 2; j >= TILE; j >>= 1) global_step(g, N, m, j, false);
    for (int c = 0; c < ntile; ++c) {
      load_tile(s, g, c, m);
      smem_half_steps(s, TILE, TILE >> 1);
      store_tile(s, g, c, m);
    }
  }
  for (int i = threadIdx.x; i < real; i += blockDim.x)
    out[off + i] = g[i] ^ BIAS;
}

}  // namespace

extern "C" {

const char* kv4_error_string(int err) {
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

int kv4_route_level(const void* src, long long src_len, const void* meta,
                    const void* bounds, const void* cnt, const void* dst,
                    const void* padv, void* out, long long out_len,
                    int ntiles, int pitch, int rmax, int bias_input,
                    void* stream) {
  const size_t shm = (size_t)rmax * (sizeof(long long) + 3 * sizeof(int));
  route_level_kernel<<<ntiles, LEVEL_THREADS, shm, (cudaStream_t)stream>>>(
      (const int32_t*)src, src_len, (const int32_t*)meta,
      (const int32_t*)bounds, (const int32_t*)cnt, (const int32_t*)dst,
      (const int32_t*)padv, (int32_t*)out, out_len, pitch, rmax,
      bias_input ? BIAS : 0);
  return (int)cudaGetLastError();
}

int kv4_terminal_write(const void* src, long long src_len, const void* btbl,
                       int nb, void* out, long long out_len, void* scratch,
                       int cap_rows, int class_id, void* stream) {
  const size_t shm = TILE * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      terminal_write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  terminal_write_kernel<<<nb, TERM_THREADS, shm, (cudaStream_t)stream>>>(
      (const int32_t*)src, src_len, (const int32_t*)btbl, (int32_t*)out,
      out_len, (int32_t*)scratch, cap_rows, class_id);
  return (int)cudaGetLastError();
}

}  // extern "C"
