// The range lookup of the partition kernels' range mode, shared by the
// level route and histogram of kernels_v4.cu and the in-place partition
// of kernels_v5.cu: a key's range among a parent's non-decreasing
// inclusive upper bounds, through a table of cells over the bounds' span.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// First d in [0, rmax) with k <= b[d] for non-decreasing inclusive upper
// bounds b, rmax when k exceeds every bound: the count of bounds below k,
// by a branch-free binary search of floor(log2 rmax) + 1 steps (top is
// the highest power of two <= rmax).
__device__ __forceinline__ int find_range(const int32_t* b, int rmax,
                                          int top, int32_t k) {
  int pos = 0;
  for (int s = top; s > 0; s >>= 1)
    if (pos + s <= rmax && b[pos + s - 1] < k) pos += s;
  return pos;
}

// The range lookup of the partition kernels' range mode.  The parent's
// bounds span [lo, hi] = [b[0], b[rmax - 1]], cut into LUT_CELLS cells of
// 2^sh keys (the least sh that covers the span); lut[c] is the count of
// bounds below the first key of cell c, so a key k in (lo, hi] lies in
// cell (k - lo) >> sh and its range in [lut[c], lut[c + 1]]: one or two
// shared loads where the bounds are spread, a search over the few bounds
// of the cell where they crowd.  Keys at or below lo are in range 0,
// keys above hi in none (rmax).  The cells follow the parent's bounds, so
// a level whose parent covers a narrow key range (an L2 tile, a chunked
// sort's window) is served as well as L1.
constexpr int LUT_BITS = 12;
constexpr int LUT_CELLS = 1 << LUT_BITS;

struct RangeLut {
  const uint16_t* lut;
  const int32_t* b;
  int rmax, sh;
  int32_t lo, hi;
};

__device__ __forceinline__ int lut_shift(const int32_t* b, int rmax) {
  const long long span = (long long)b[rmax - 1] - b[0];
  return max(0, 64 - __clzll(span) - LUT_BITS);
}

__device__ void build_lut(uint16_t* lut, const int32_t* b, int rmax) {
  const int top = 1 << (31 - __clz(rmax)), sh = lut_shift(b, rmax);
  for (int c = threadIdx.x; c <= LUT_CELLS; c += blockDim.x) {
    const long long k = (long long)b[0] + ((long long)c << sh);
    lut[c] = k > 0x7fffffffLL ? rmax : find_range(b, rmax, top, (int32_t)k);
  }
}

__device__ __forceinline__ RangeLut range_lut(const uint16_t* lut,
                                              const int32_t* b, int rmax) {
  return RangeLut{lut, b, rmax, lut_shift(b, rmax), b[0], b[rmax - 1]};
}

__device__ __forceinline__ int range_of(const RangeLut& r, int32_t k) {
  if (k <= r.lo) return 0;
  if (k > r.hi) return r.rmax;
  const int c = (int)((uint32_t)((long long)k - r.lo) >> r.sh);
  int pos = r.lut[c], n = r.lut[c + 1] - pos;
  while (n > 0) {
    const int h = n >> 1;
    if (r.b[pos + h] < k) {
      pos += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return pos;
}

}  // namespace
