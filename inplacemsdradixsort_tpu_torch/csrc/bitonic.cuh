// The bitonic compare-exchange network shared by the terminal sort's
// global path in kernels_v4.cu and the global merge steps of the v1 sorts
// in pallas_kernels.cu, and the plane layout all kernels use.
//
// Keys are int32 in the sign-biased encoding (biased = raw ^ 0x80000000,
// so signed order = unsigned order of the raw words); SENT = biased +inf.
// A sort carries 1-4 planes of equal length (key, then payload words);
// tuples order lexicographically over planes 0..nlex.  The network is in
// its all-ascending form: the first step of each merge size k compares i
// with i ^ (k-1), the rest i with i ^ j, and every compare moves the
// smaller tuple to the lower index.  A sort of m tuples therefore runs on
// a power of two N >= m with virtual all-SENT tuples past m that are
// never stored: a pair whose upper index is >= m is a no-op.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int32_t BIAS = INT32_MIN;
constexpr int32_t SENT = INT32_MAX;
constexpr int MAX_PLANES = 4;

// shared-memory tile of the network in tuples: NP * 4 bytes * tile <=
// 96 KiB, so two blocks of 1024 threads fit an SM (227 KB a block at most)
template <int NP>
__host__ __device__ constexpr int smem_tile() {
  return NP == 1 ? 16384 : (NP <= 3 ? 8192 : 4096);
}

// The planes of one array, as NP pointers.
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

// Compare-exchange of tuples i < p: plane 0 first, the next plane only
// on a tie (up to plane nlex); a swap moves every plane.
template <int NP>
__device__ __forceinline__ void cmpswap(const Planes<NP>& v, int i, int p,
                                        int nlex) {
  int32_t a = v.p[0][i], b = v.p[0][p];
  bool gt = a > b;
  if (a == b) {
#pragma unroll
    for (int q = 1; q < NP; ++q) {
      if (q > nlex) break;
      a = v.p[q][i];
      b = v.p[q][p];
      if (a != b) {
        gt = a > b;
        break;
      }
    }
  }
  if (gt) {
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int32_t x = v.p[q][i];
      v.p[q][i] = v.p[q][p];
      v.p[q][p] = x;
    }
  }
}

// Lower index of pair q for a step with partner distance h (power of 2).
__device__ __forceinline__ int pair_lo(int q, int h) {
  return ((q & ~(h - 1)) << 1) | (q & (h - 1));
}

// Steps j = jtop, jtop/2, ..., 1 (i <-> i + j) over tuples [0, size) of
// shared memory, by the whole block.
template <int NP>
__device__ void smem_half_steps(const Planes<NP>& s, int size, int jtop,
                                int nlex) {
  for (int j = jtop; j >= 1; j >>= 1) {
    for (int q = threadIdx.x; q < (size >> 1); q += blockDim.x) {
      const int i = pair_lo(q, j);
      cmpswap<NP>(s, i, i + j, nlex);
    }
    __syncthreads();
  }
}

// Full sort of tuples [0, size) of shared memory, size a power of two.
template <int NP>
__device__ void smem_sort(const Planes<NP>& s, int size, int nlex) {
  for (int k = 2; k <= size; k <<= 1) {
    for (int q = threadIdx.x; q < (size >> 1); q += blockDim.x) {
      const int i = pair_lo(q, k >> 1);
      cmpswap<NP>(s, i, i ^ (k - 1), nlex);
    }
    __syncthreads();
    smem_half_steps<NP>(s, size, k >> 2, nlex);
  }
}

}  // namespace
