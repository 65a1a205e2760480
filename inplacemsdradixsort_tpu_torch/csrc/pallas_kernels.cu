// Hand-written Hopper (sm_90a) kernels of the v1 engine: the level tile
// sort (tile_sort), the run distribution (distribute), the bucket sort
// (ragged_sort) and the splice of valid prefixes (compact).
//
// Built by ops/_build.py, with the other sources of csrc/, by one
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into one shared library with a plain C interface, loaded with ctypes.
// Every launcher takes PyTorch's current stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError().
//
// Arenas are (rows, 128) int32 planes: biased keys and, for pairs, one
// value plane; tuples order by (key, val) and SENT pads.  Addresses are
// 64-bit.  The Python wrappers and their plain PyTorch versions live in
// ops/pallas_kernels.py; the notes there say which TPU kernel each
// replaces and what bounds it on the H100.

#include <limits.h>

#include <algorithm>

#include "bitonic.cuh"

namespace {

constexpr int SORT_THREADS = 1024;   // blocks that sort a shared tile
constexpr int STEP_THREADS = 256;    // one global network step
constexpr int STEP_BLOCKS = 65536;   // grid cap of a global step
constexpr int COPY_THREADS = 256;    // distribute / compact / count

// The regions one sort launch orders in place: region b holds m tuples
// from element base(b) = start_rows[b] * 128 (or b * m when start_rows is
// NULL); its tuples at or past live[b] sort as SENT and are stored as
// SENT.  With skip_empty, a region whose live count is <= 0 is not
// touched (ragged_sort's dummy buckets all point at one slack region).
// The wrappers refuse tables that place a region outside the arena's len
// elements; the test here only keeps a kernel inside it.
struct Regions {
  const int32_t* start_rows;
  const int32_t* live;
  long long m;
  long long len;
  int skip_empty;
};

__device__ __forceinline__ bool region_of(const Regions& r, long long b,
                                          long long* base, int* live) {
  const long long l = r.live[b];
  if (r.skip_empty && l <= 0) return false;
  *base = r.start_rows ? (long long)r.start_rows[b] * LANES : b * r.m;
  *live = (int)max(0LL, min(l, r.m));
  return *base >= 0 && *base + r.m <= r.len;
}

template <int NP>
__device__ __forceinline__ Planes<NP> shifted(const Planes<NP>& a,
                                              long long base) {
  Planes<NP> v;
#pragma unroll
  for (int q = 0; q < NP; ++q) v.p[q] = a.p[q] + base;
  return v;
}

// One block per (region, tile of tsz tuples): load the tile into shared
// memory, then either sort it (the first pass: tuples at or past the
// region's live count load as SENT) or run a merge's steps shorter than
// the tile on it (merge != 0: the region is already masked), and store
// the part of the tile below m.
template <int NP>
__global__ void __launch_bounds__(SORT_THREADS) tile_pass_kernel(
    Planes<NP> a, Regions r, int tsz, int ntile, int nlex, int merge) {
  extern __shared__ int32_t smem[];
  const long long b = blockIdx.x / ntile;
  const int c = blockIdx.x % ntile;
  long long base;
  int live;
  if (!region_of(r, b, &base, &live)) return;
  if (merge) live = (int)r.m;
  const Planes<NP> g = shifted<NP>(a, base);
  Planes<NP> s;
#pragma unroll
  for (int q = 0; q < NP; ++q) s.p[q] = smem + q * tsz;
  for (int i = threadIdx.x; i < tsz; i += blockDim.x) {
    const int e = c * tsz + i;
#pragma unroll
    for (int q = 0; q < NP; ++q) s.p[q][i] = e < live ? g.p[q][e] : SENT;
  }
  __syncthreads();
  if (merge)
    smem_half_steps<NP>(s, tsz, tsz >> 1, nlex);
  else
    smem_sort<NP>(s, tsz, nlex);
  for (int i = threadIdx.x; i < tsz; i += blockDim.x) {
    const int e = c * tsz + i;
    if (e < r.m) {
#pragma unroll
      for (int q = 0; q < NP; ++q) g.p[q][e] = s.p[q][i];
    }
  }
}

// One step of the network with partner distance h >= the shared tile,
// over every pair of every region (2^lhalf pairs a region): `flip` pairs
// i with i ^ (2h - 1), otherwise with i + h.  Pairs reaching past m are
// no-ops.
template <int NP>
__global__ void __launch_bounds__(STEP_THREADS) global_step_kernel(
    Planes<NP> a, Regions r, long long nb, int lhalf, int h, int flip,
    int nlex) {
  const long long total = nb << lhalf;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       x < total; x += stride) {
    const long long b = x >> lhalf;
    long long base;
    int live;
    if (!region_of(r, b, &base, &live)) continue;
    const int i = pair_lo((int)(x & ((1LL << lhalf) - 1)), h);
    const int p = flip ? (i ^ (2 * h - 1)) : (i + h);
    if (p < r.m) cmpswap<NP>(shifted<NP>(a, base), i, p, nlex);
  }
}

// Sort every region of r in place: sorted shared tiles first, then for
// every merge size k above the tile the steps with a partner distance of
// a tile or more as global launches and the shorter ones per tile in
// shared memory.  Any number of blocks works on one region.
template <int NP>
int sort_regions(void* const* planes, const Regions& r, long long nb,
                 int nlex, cudaStream_t st) {
  if (nb <= 0 || r.m <= 0) return (int)cudaGetLastError();
  if (r.m > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const Planes<NP> a = planes_of<NP>(planes);
  int N = 1, lN = 0;
  while (N < r.m) {
    N <<= 1;
    ++lN;
  }
  const int tsz = std::min(N, smem_tile<NP>());
  const long long ntile = (r.m + tsz - 1) / tsz;
  const long long blocks = nb * ntile;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t shm = (size_t)NP * tsz * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      tile_pass_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shm);
  if (err != cudaSuccess) return (int)err;
  tile_pass_kernel<NP><<<(int)blocks, SORT_THREADS, shm, st>>>(
      a, r, tsz, (int)ntile, nlex, 0);
  const int lhalf = lN - 1;
  const long long pairs = nb << std::max(lhalf, 0);
  const int sgrid = (int)std::min((pairs + STEP_THREADS - 1) / STEP_THREADS,
                                  (long long)STEP_BLOCKS);
  for (int k = 2 * tsz; k <= N; k <<= 1) {
    global_step_kernel<NP><<<sgrid, STEP_THREADS, 0, st>>>(
        a, r, nb, lhalf, k >> 1, 1, nlex);
    for (int j = k >> 2; j >= tsz; j >>= 1)
      global_step_kernel<NP><<<sgrid, STEP_THREADS, 0, st>>>(
          a, r, nb, lhalf, j, 0, nlex);
    tile_pass_kernel<NP><<<(int)blocks, SORT_THREADS, shm, st>>>(
        a, r, tsz, (int)ntile, nlex, 1);
  }
  return (int)cudaGetLastError();
}

int sort_planes(void* keys, void* vals, const Regions& r, long long nb,
                int nplanes, cudaStream_t st) {
  void* const planes[2] = {keys, vals};
  switch (nplanes) {
    case 1: return sort_regions<1>(planes, r, nb, 0, st);
    case 2: return sort_regions<2>(planes, r, nb, 1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ tile_sort
// One thread per (tile, bound): the number of tuples of the sorted tile
// whose key is <= the bound, by an upper-bound search.
__global__ void __launch_bounds__(COPY_THREADS) count_kernel(
    const int32_t* __restrict__ keys, long long tile_elems,
    const int32_t* __restrict__ bounds, int32_t* __restrict__ cnt,
    long long total, int r) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= total) return;
  const int32_t* k = keys + (x / r) * tile_elems;
  const int32_t bound = bounds[x];
  long long lo = 0, hi = tile_elems;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (k[mid] <= bound) lo = mid + 1; else hi = mid;
  }
  cnt[x] = (int32_t)lo;
}

// ----------------------------------------------------------- distribute
// One warp per (tile, range) run: its len tuples from element start of
// the tile go to row slot of the output, and SENT fills the rest of its
// last row.  Stores are element-exact, so runs may land in any order.
// The wrapper refuses runs and slots outside their arenas; the test
// below only keeps the kernel inside them.
template <int NP>
__global__ void __launch_bounds__(COPY_THREADS) distribute_kernel(
    Planes<NP> src, long long src_len, const int32_t* __restrict__ slot_rows,
    const int32_t* __restrict__ run_starts,
    const int32_t* __restrict__ run_lens, Planes<NP> out, long long out_len,
    long long nruns, int r, long long tile_elems) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= nruns) return;
  const long long ln = run_lens[w];
  if (ln <= 0) return;
  const long long s = (w / r) * tile_elems + run_starts[w];
  const long long d = (long long)slot_rows[w] * LANES;
  const long long end = (ln + LANES - 1) / LANES * LANES;
  if (s < 0 || d < 0 || s + ln > src_len || d + end > out_len) return;
  for (long long i = lane; i < end; i += 32) {
#pragma unroll
    for (int q = 0; q < NP; ++q)
      out.p[q][d + i] = i < ln ? src.p[q][s + i] : SENT;
  }
}

// -------------------------------------------------------------- compact
// One block per segment: its len tuples from row start go to element off
// (the exclusive prefix sum of the lengths) of the output.  The wrapper
// refuses segments outside their arenas; the test below only keeps the
// kernel inside them.
template <int NP>
__global__ void __launch_bounds__(COPY_THREADS) compact_kernel(
    Planes<NP> src, long long src_len, const int32_t* __restrict__ starts,
    const int32_t* __restrict__ lens, const long long* __restrict__ offs,
    Planes<NP> out, long long out_len) {
  const long long ln = lens[blockIdx.x];
  const long long base = (long long)starts[blockIdx.x] * LANES;
  const long long off = offs[blockIdx.x];
  if (ln <= 0 || base < 0 || off < 0 || base + ln > src_len ||
      off + ln > out_len)
    return;
  for (long long i = threadIdx.x; i < ln; i += blockDim.x) {
#pragma unroll
    for (int q = 0; q < NP; ++q) out.p[q][off + i] = src.p[q][base + i];
  }
}

long long blocks_for(long long threads) {
  return (threads + COPY_THREADS - 1) / COPY_THREADS;
}

}  // namespace

extern "C" {

// nplanes is 1 (keys) or 2 (keys, vals); vals is NULL for 1.
int kv1_tile_sort(void* keys, void* vals, const void* bounds,
                  const void* data_elems, void* cnt, int ntiles,
                  long long tile_elems, int r, int nplanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Regions reg{nullptr, (const int32_t*)data_elems, tile_elems,
                    ntiles * tile_elems, 0};
  const int err = sort_planes(keys, vals, reg, ntiles, nplanes, st);
  if (err != 0) return err;
  const long long total = (long long)ntiles * r;
  if (total > 0)
    count_kernel<<<(int)blocks_for(total), COPY_THREADS, 0, st>>>(
        (const int32_t*)keys, tile_elems, (const int32_t*)bounds,
        (int32_t*)cnt, total, r);
  return (int)cudaGetLastError();
}

int kv1_distribute(void* keys, void* vals, long long src_len,
                   const void* slot_rows, const void* run_starts,
                   const void* run_lens, void* out_keys, void* out_vals,
                   long long out_len, long long nruns, int r,
                   long long tile_elems, int nplanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  void* const src[2] = {keys, vals};
  void* const out[2] = {out_keys, out_vals};
  const int grid = (int)blocks_for(nruns * 32);
#define KV1_DISTRIBUTE(NP)                                                  \
  distribute_kernel<NP><<<grid, COPY_THREADS, 0, st>>>(                     \
      planes_of<NP>(src), src_len, (const int32_t*)slot_rows,               \
      (const int32_t*)run_starts, (const int32_t*)run_lens,                 \
      planes_of<NP>(out), out_len, nruns, r, tile_elems)
  switch (nplanes) {
    case 1: KV1_DISTRIBUTE(1); break;
    case 2: KV1_DISTRIBUTE(2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef KV1_DISTRIBUTE
  return (int)cudaGetLastError();
}

int kv1_ragged_sort(void* keys, void* vals, long long len,
                    const void* starts_row, const void* pad_elems, int nb,
                    long long class_elems, int nplanes, void* stream) {
  const Regions reg{(const int32_t*)starts_row, (const int32_t*)pad_elems,
                    class_elems, len, 1};
  return sort_planes(keys, vals, reg, nb, nplanes, (cudaStream_t)stream);
}

int kv1_compact(void* keys, void* vals, long long src_len,
                const void* starts_row, const void* lens, const void* offs,
                int nseg, void* out_keys, void* out_vals, long long out_len,
                int nplanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  void* const src[2] = {keys, vals};
  void* const out[2] = {out_keys, out_vals};
#define KV1_COMPACT(NP)                                                     \
  compact_kernel<NP><<<nseg, COPY_THREADS, 0, st>>>(                        \
      planes_of<NP>(src), src_len, (const int32_t*)starts_row,              \
      (const int32_t*)lens, (const long long*)offs, planes_of<NP>(out),     \
      out_len)
  switch (nplanes) {
    case 1: KV1_COMPACT(1); break;
    case 2: KV1_COMPACT(2); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef KV1_COMPACT
  return (int)cudaGetLastError();
}

}  // extern "C"
