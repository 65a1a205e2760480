// Hand-written Hopper (sm_90a) kernel of the v3 engine: the fused
// partition level (partition_level).  The v3 terminal sort launches the
// v4 terminal kernel of kernels_v4.cu.
//
// Built by ops/_build.py, with the other sources of csrc/ (one nvcc -c
// per source, all run together, then one link) into one shared library
// with a plain C interface, loaded with ctypes.
// The launcher takes PyTorch's current stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError().
//
// Keys are int32 in the sign-biased encoding (biased = raw ^ 0x80000000);
// SENT = biased +inf.  A v3 sort carries the key plane and optionally one
// value plane; the kernel is a template on the plane count NP.  The Python
// wrapper and its plain PyTorch version live in ops/kernels_v3.py; the
// note there says which TPU kernel this replaces and what bounds it.

#include "bitonic.cuh"

namespace {

constexpr int PART_THREADS = 512;

// First d in [0, rmax) with k <= b[d] for non-decreasing inclusive upper
// bounds b; rmax when k exceeds every bound.
__device__ __forceinline__ int part_range(const int32_t* b, int rmax,
                                          int32_t k) {
  int lo = 0, hi = rmax;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (k <= b[mid]) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// ------------------------------------------------------- partition_level
// One block per tile row of tile_tbl = (parent, src_row, local_off, .).
// The tile's live elements are src[src_row*128 + e] for
// e < clip(parent_fill[parent] - local_off, 0, pitch*128), clamped to the
// source; slack is skipped by index, never by value (SENT equals a real
// biased 0xFFFFFFFF).
//  1. count each range d of the parent (binary search over its bounds,
//     shared counters);
//  2. per range with h > 0, child c = child_base[parent] + d: add h to
//     real[c], (-h) % 128 to padcnt[sink_base[c] + j] with
//     j = t % max(sink_cnt[c], 1), and, when dst_cap[c] > 0, claim
//     ceil(h/128) rows with one atomicAdd on cursor[c]; of those, the rows
//     below dst_start[c] + dst_cap[c] are stored, and *over is set when
//     that is fewer;
//  3. each element claims the next slot of its run (shared atomicAdd) and
//     is stored there, in every plane (the value plane is never biased);
//  4. the run's tail, slots [h, ceil(h/128)*128), gets the pad value
//     padsrc[c*pad_stride + j] in the key plane and SENT in the value
//     plane.
// Every store is element-exact and lies in a run the block claimed, so
// blocks may run in any order; the order inside a child is undefined.
template <int NP>
__global__ void __launch_bounds__(PART_THREADS) partition_level_kernel(
    Planes<NP> src, long long src_len, const int32_t* __restrict__ tile_tbl,
    const int32_t* __restrict__ child_base,
    const int32_t* __restrict__ bounds,
    const int32_t* __restrict__ dst_start,
    const int32_t* __restrict__ dst_cap, int32_t* __restrict__ cursor,
    const int32_t* __restrict__ parent_fill,
    const int32_t* __restrict__ sink_base,
    const int32_t* __restrict__ sink_cnt,
    const int32_t* __restrict__ padsrc, long long padsrc_len,
    Planes<NP> dst, long long dst_len, int32_t* __restrict__ real,
    int32_t* __restrict__ padcnt, int32_t* __restrict__ over, int nparents,
    int nchild, int nsinks, int pitch, int rmax, int pad_stride,
    int32_t xor_in) {
  extern __shared__ long long smem64[];
  long long* sbase = smem64;                   // rmax run bases (elements)
  int32_t* sb = (int32_t*)(smem64 + rmax);     // rmax bounds
  int* cnt = sb + rmax;                        // rmax counts
  int* cur = cnt + rmax;                       // rmax slot cursors
  int* lim = cur + rmax;                       // rmax stored slots per run
  int32_t* spad = lim + rmax;                  // rmax pad values
  const int t = blockIdx.x;
  const int parent = tile_tbl[4LL * t];
  if (parent < 0 || parent >= nparents) return;
  const long long base = (long long)tile_tbl[4LL * t + 1] * LANES;
  long long nel = (long long)parent_fill[parent] - tile_tbl[4LL * t + 2];
  nel = min(nel, (long long)pitch * LANES);
  nel = min(nel, src_len - base);
  if (nel <= 0 || base < 0) return;            // the same for the block

  for (int d = threadIdx.x; d < rmax; d += blockDim.x) {
    sb[d] = bounds[(long long)parent * rmax + d];
    cnt[d] = 0;
    cur[d] = 0;
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < nel; i += blockDim.x) {
    const int d = part_range(sb, rmax, src.p[0][base + i] ^ xor_in);
    if (d < rmax) atomicAdd(&cnt[d], 1);
  }
  __syncthreads();

  const int cb = child_base[parent];
  for (int d = threadIdx.x; d < rmax; d += blockDim.x) {
    const int h = cnt[d];
    const int c = cb + d;
    sbase[d] = -1;
    lim[d] = 0;
    if (h == 0 || c < 0 || c >= nchild) continue;
    atomicAdd(&real[c], h);
    const int npad = (-h) & (LANES - 1);
    const int j = t % max(sink_cnt[c], 1);
    const long long s = (long long)sink_base[c] + j;
    if (npad && s >= 0 && s < nsinks) atomicAdd(&padcnt[s], npad);
    const long long pi = (long long)c * pad_stride + j;
    spad[d] = (pi >= 0 && pi < padsrc_len) ? padsrc[pi] : SENT;
    const int cap = dst_cap[c];
    if (cap <= 0) continue;                    // dropped range
    const int rrows = (h + LANES - 1) / LANES;
    const int old = atomicAdd(&cursor[c], rrows);
    const int w = max(0, min(rrows, dst_start[c] + cap - old));
    if (w < rrows) atomicExch(over, 1);
    sbase[d] = (long long)old * LANES;
    lim[d] = w * LANES;
  }
  __syncthreads();

  for (long long i = threadIdx.x; i < nel; i += blockDim.x) {
    const int32_t k = src.p[0][base + i] ^ xor_in;
    const int d = part_range(sb, rmax, k);
    if (d < rmax && sbase[d] >= 0) {
      const int slot = atomicAdd(&cur[d], 1);
      const long long o = sbase[d] + slot;
      if (slot < lim[d] && o < dst_len) {
        dst.p[0][o] = k;
#pragma unroll
        for (int q = 1; q < NP; ++q) dst.p[q][o] = src.p[q][base + i];
      }
    }
  }
  // pads occupy [h, h + npad) of each run: disjoint from the element
  // slots above, so no barrier is needed between the two loops
  for (int q = threadIdx.x; q < rmax * LANES; q += blockDim.x) {
    const int d = q / LANES, j = q % LANES;
    if (sbase[d] < 0) continue;
    const int h = cnt[d];
    if (j < ((-h) & (LANES - 1)) && h + j < lim[d]) {
      const long long o = sbase[d] + h + j;
      if (o < dst_len) {
        dst.p[0][o] = spad[d];
#pragma unroll
        for (int p = 1; p < NP; ++p) dst.p[p][o] = SENT;
      }
    }
  }
}

template <int NP>
int launch_partition(void* const* src, long long src_len, const void* tile,
                     const void* child_base, const void* bounds,
                     const void* dst_start, const void* dst_cap,
                     void* cursor, const void* parent_fill,
                     const void* sink_base, const void* sink_cnt,
                     const void* padsrc, long long padsrc_len,
                     void* const* dst, long long dst_len, void* real,
                     void* padcnt, void* over, int ntiles, int nparents,
                     int nchild, int nsinks, int pitch, int rmax,
                     int pad_stride, int32_t xor_in, cudaStream_t stream) {
  const size_t shm = (size_t)rmax * (sizeof(long long) + 5 * sizeof(int));
  partition_level_kernel<NP><<<ntiles, PART_THREADS, shm, stream>>>(
      planes_of<NP>(src), src_len, (const int32_t*)tile,
      (const int32_t*)child_base, (const int32_t*)bounds,
      (const int32_t*)dst_start, (const int32_t*)dst_cap, (int32_t*)cursor,
      (const int32_t*)parent_fill, (const int32_t*)sink_base,
      (const int32_t*)sink_cnt, (const int32_t*)padsrc, padsrc_len,
      planes_of<NP>(dst), dst_len, (int32_t*)real, (int32_t*)padcnt,
      (int32_t*)over, nparents, nchild, nsinks, pitch, rmax, pad_stride,
      xor_in);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Plane pointers come as two arguments each (the second NULL keys-only).
int kv3_partition_level(void* s0, void* s1, long long src_len,
                        const void* tile_tbl, const void* child_base,
                        const void* bounds, const void* dst_start,
                        const void* dst_cap, void* cursor,
                        const void* parent_fill, const void* sink_base,
                        const void* sink_cnt, const void* padsrc,
                        long long padsrc_len, void* d0, void* d1,
                        long long dst_len, void* real, void* padcnt,
                        void* over, int nplanes, int ntiles, int nparents,
                        int nchild, int nsinks, int pitch, int rmax,
                        int pad_stride, int bias_input, void* stream) {
  void* const src[2] = {s0, s1};
  void* const dst[2] = {d0, d1};
  const int32_t x = bias_input ? BIAS : 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (nplanes) {
    case 1: return launch_partition<1>(
        src, src_len, tile_tbl, child_base, bounds, dst_start, dst_cap,
        cursor, parent_fill, sink_base, sink_cnt, padsrc, padsrc_len, dst,
        dst_len, real, padcnt, over, ntiles, nparents, nchild, nsinks,
        pitch, rmax, pad_stride, x, st);
    case 2: return launch_partition<2>(
        src, src_len, tile_tbl, child_base, bounds, dst_start, dst_cap,
        cursor, parent_fill, sink_base, sink_cnt, padsrc, padsrc_len, dst,
        dst_len, real, padcnt, over, ntiles, nparents, nchild, nsinks,
        pitch, rmax, pad_stride, x, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
