// Hand-written Hopper (sm_90a) kernels of the v1 engine: the level tile
// sort (tile_sort), the run distribution (distribute), the bucket sort
// (ragged_sort) and the splice of valid prefixes (compact).
//
// Built by ops/_build.py, with the other sources of csrc/: one
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -c
// per source, all run together, then one link with -shared into one
// library with a plain C interface, loaded with ctypes.
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

#include "cluster_sort.cuh"

namespace {

constexpr int STEP_THREADS = 256;    // one global network step
constexpr int STEP_BLOCKS = 65536;   // grid cap of a global step
constexpr unsigned FULL_MASK = 0xffffffffu;

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

// One step of the network with partner distance h of a run or more (the
// runs of ragged_sort and tile_sort), over every pair of every region
// (2^lhalf pairs a region): `flip` pairs i with i ^ (2h - 1), otherwise
// with i + h.  Pairs reaching past m are no-ops.
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

// ---------------------------------------------------------- ragged_sort
// One thread-block cluster per (live bucket, run): the run's tuples stay
// in the shared memory of the cluster's C CTAs (128 KiB each: 2^15 keys
// or 2^14 pairs) from one read to one write, and the bitonic network of
// csrc/cluster_sort.cuh sorts them there.  A run is the whole bucket up
// to 8 CTAs (2^18 keys, 2^17 pairs); a larger bucket is sorted as runs
// of that size which global steps and merge launches then join.  A pair
// is one uint64 word (cs_pack) whose unsigned order is the pair's order.
// The network is shared with the terminal sort of csrc/kernels_v4.cu;
// this kernel's policy: load a run in place (tuples at or past the
// bucket's pad as SENT, the slack past the pad not read), sort, and
// store it back in place, every tuple of the run below m.
struct CsArgs {
  const int32_t* start_rows;   // bucket b starts at row start_rows[b]
                               // (NULL: at element b * m)
  const int32_t* live;         // its pad: tuples at or past it are SENT
  long long m;                 // tuples of a bucket (class_rows * 128)
  long long len;               // elements of the arena
  int lr;                      // log2 tuples of a run
  int sb;                      // log2 tuples of one CTA (lr - sb cluster bits)
  int nruns;                   // runs per bucket
  int merge;                   // 0: sort each run; 1: merge-tail steps only
};

// Sort mode: load the run (tuples at or past the bucket's pad as SENT,
// tuples past m as virtual SENT that are never stored), sort it
// ascending, store it.  Merge mode: load the run as it is and run the
// steps of its last stage, which finish a merge whose longer steps the
// global launches made.
template <int NP>
__global__ void __launch_bounds__(CS_THREADS, 1)
    cluster_sort_kernel(Planes<NP> a, CsArgs k) {
  extern __shared__ __align__(16) unsigned char cs_smem[];
  constexpr int U = CS_UNROLL;
  const int cbits = k.lr - k.sb;
  const long long cid = blockIdx.x >> cbits;      // (bucket, run)
  const long long b = cid / k.nruns;
  const long long r0 = (cid % k.nruns) << k.lr;   // run's first tuple
  const long long pad = k.live[b];
  const long long base =
      k.start_rows ? (long long)k.start_rows[b] * LANES : b * k.m;
  // the same for every CTA of the cluster: all exit or none
  if (pad <= 0 || base < 0 || base + k.m > k.len || r0 >= k.m) return;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)(blockIdx.x & ((1 << cbits) - 1));
  const CsView<NP> view = cs_view<NP>(cs_smem, cl, k.lr, k.sb, rank);
  cs_u<NP>* sm = view.sm;
  const int S = 1 << k.sb;
  const long long x0 = r0 + ((long long)rank << k.sb);
  const long long lim = k.merge ? k.m : min(pad, k.m);
  bool vec = true;
#pragma unroll
  for (int q = 0; q < NP; ++q) vec &= ((uintptr_t)(a.p[q] + base) & 15) == 0;
  for (int v0 = threadIdx.x; v0 < (S >> 2); v0 += U * blockDim.x) {
    int32_t w[U][NP][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int v = v0 + u * blockDim.x;
      const long long x = x0 + 4 * v;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int32_t* g = a.p[q] + base + x;
#pragma unroll
        for (int c = 0; c < 4; ++c) w[u][q][c] = SENT;
        // lim is m (a multiple of 128) or the pad: the slack past the
        // pad is not read
        if (v < (S >> 2) && x < lim) {
          if (vec) {
            const int4 t = *(const int4*)g;
            w[u][q][0] = t.x; w[u][q][1] = t.y;
            w[u][q][2] = t.z; w[u][q][3] = t.w;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) w[u][q][c] = g[c];
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
        const int i = cs_pad<NP>(4 * v) + c;
        if (x0 + 4 * v + c < lim) {
          int32_t t[NP];
#pragma unroll
          for (int q = 0; q < NP; ++q) t[q] = w[u][q][c];
          cs_put<NP>(sm, i, view.ps, t);
        } else {
          cs_put_sent<NP>(sm, i, view.ps);
        }
      }
    }
  }
  cs_network<NP>(view, cl, k.merge != 0);
  for (int v = threadIdx.x; v < (S >> 2); v += blockDim.x) {
    const long long x = x0 + 4 * v;
    if (x >= k.m) break;
    int32_t w[4][NP];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      cs_get<NP>(sm, cs_pad<NP>(4 * v) + c, view.ps, w[c]);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      int32_t* g = a.p[q] + base + x;
      if (vec) {
        *(int4*)g = make_int4(w[0][q], w[1][q], w[2][q], w[3][q]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) g[c] = w[c][q];
      }
    }
  }
}

// Launch cluster_sort_kernel over nb buckets of nruns runs of 2^lr tuples.
template <int NP>
cudaError_t cluster_sort(const Planes<NP>& a, const Regions& r, long long nb,
                         int lr, int nruns, int merge, cudaStream_t st) {
  const int sb = std::min(lr, cs_cta_log<NP>());
  const long long grid = (nb * nruns) << (lr - sb);
  const CsArgs k{r.start_rows, r.live, r.m, r.len, lr, sb, nruns, merge};
  return cs_launch(cluster_sort_kernel<NP>, grid, 1 << (lr - sb),
                   cs_smem_bytes<NP>(sb), st, a, k);
}

// Join the ascending runs of 2^lr tuples of every region of r, N = 2^lN
// >= m tuples a region, by the network's all-ascending merges (the first
// step of merge size k pairs i with i ^ (k - 1), the others i with i + j,
// the smaller tuple to the lower index, so virtual SENT tuples past m stay
// in place): global_step_kernel for distances of a run or more, a cluster
// launch in merge mode for the shorter ones.
template <int NP>
int merge_runs(const Planes<NP>& a, const Regions& r, long long nb, int lr,
               int lN, cudaStream_t st) {
  const long long pairs = nb << (lN - 1);
  const int sgrid = (int)std::min((pairs + STEP_THREADS - 1) / STEP_THREADS,
                                  (long long)STEP_BLOCKS);
  for (long long k = 2LL << lr; k <= (1LL << lN); k <<= 1) {
    global_step_kernel<NP><<<sgrid, STEP_THREADS, 0, st>>>(
        a, r, nb, lN - 1, (int)(k >> 1), 1, NP - 1);
    for (long long j = k >> 2; j >= (1LL << lr); j >>= 1)
      global_step_kernel<NP><<<sgrid, STEP_THREADS, 0, st>>>(
          a, r, nb, lN - 1, (int)j, 0, NP - 1);
    const cudaError_t err =
        cluster_sort<NP>(a, r, nb, lr, 1 << (lN - lr), 1, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Sort every live bucket of r.  Up to 8 CTAs of tuples a bucket is one
// cluster launch.  Larger buckets (N = 2^lN >= m tuples) are sorted as
// ascending runs of 2^lr, then joined by merge_runs.
template <int NP>
int ragged_sort_regions(void* const* planes, const Regions& r, long long nb,
                        cudaStream_t st) {
  if (nb <= 0 || r.m <= 0) return (int)cudaGetLastError();
  if (r.m > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const Planes<NP> a = planes_of<NP>(planes);
  int lN = 0;
  while ((1LL << lN) < r.m) ++lN;
  lN = std::max(lN, cs_w<NP>() + 2);
  const int lr = std::min(lN, cs_cta_log<NP>() + 3);
  const cudaError_t err =
      cluster_sort<NP>(a, r, nb, lr, 1 << (lN - lr), 0, st);
  if (err != cudaSuccess) return (int)err;
  return merge_runs<NP>(a, r, nb, lr, lN, st);
}

// ------------------------------------------------------------ tile_sort
// One thread-block cluster of C = 1-8 CTAs per (tile, run) sorts the run
// by a least-significant-digit radix sort over the bits that vary among
// its live tuples, and counts the tile's bounds on the sorted run.  A CTA
// holds 2^15 keys or 2^14 pairs (rs_cap_log), so the default 2^15-element
// tile is one CTA keys-only and a cluster of two with pairs.  A run is
// the whole tile up to 8 CTAs' tuples (2^18 keys, 2^17 pairs), else runs
// of that size which merge_runs then joins.  CTA c holds the run's
// positions [c * cap, (c + 1) * cap) in shared memory, a tuple's planes
// side by side (a pair is one 8-byte word, moved by one load and one
// store), from one read of device memory to one write:
// - load: the live tuples (those below the tile's data count; the rest
//   is SENT and not read), with the OR of x ^ (the run's first tuple)
//   over them, plane by plane, which the cluster's CTAs combine;
// - passes: 8-bit digits of the raw word (biased ^ 2^31, whose unsigned
//   order is the signed order of the biased word) from the lowest to
//   the highest varying bit, first of the value plane, then of the key,
//   so the run ends ordered by (key, val).  A pass reads each thread's
//   rs_e tuples (warp v owns the span [v * 32 * rs_e, (v + 1) * 32 *
//   rs_e) of its CTA's positions, row by row) and ranks them row by row
//   in its warp's count table of the digit.  Every pass but the first is
//   stable, ranked as the stable digit route of kernels_v4.cu does (each
//   lane sets its bit in its warp's mask word of the digit, so the word
//   is the row's lanes with that digit; the rank is the warp's running
//   count of the digit plus the peers in lower lanes); the first, whose
//   input order does not matter, takes one shared atomicAdd a tuple (32
//   at once for a row whose lanes share the digit).  The (warp, digit)
//   counts become offsets and the CTA's digit totals, and after a
//   cluster barrier every CTA's totals place each digit's segment in the
//   run, ordered by (digit, CTA, warp, rank): the old order among equal
//   digits.  Every tuple then goes to the shared memory of the CTA that
//   holds its new position (distributed shared memory), and a second
//   cluster barrier ends the pass.  Live tuples stay at positions [0,
//   live) of the run through every pass; SENT tuples are placed by
//   position, never ranked, so no pass needs their bits;
// - store: positions below live from shared memory, SENT after them up
//   to the run's end, with 16-byte stores where the planes allow;
// - count: each bound of the tile by an upper-bound search over the
//   run's sorted live keys (through distributed shared memory), plus
//   the SENT tuples when the bound is SENT; added into a zeroed table
//   when the tile has several runs (a count is the same in any order).
constexpr int RS_THREADS = 1024;
constexpr int RS_WARPS = RS_THREADS / 32;
constexpr int RS_TUPLES = 32;                     // words a thread ranks
constexpr int RS_CLOG_MAX = 3;                    // 8 CTAs a cluster
constexpr int RS_BITS = 8;                        // digit width
constexpr int RS_DIGITS = 1 << RS_BITS;
constexpr int RS_GROUPS = RS_THREADS / RS_DIGITS;  // threads a digit

// tuples a thread ranks (32 keys or 16 pairs) and log2 tuples a CTA holds
template <int NP>
__host__ __device__ constexpr int rs_e() { return RS_TUPLES / NP; }
template <int NP>
__host__ __device__ constexpr int rs_cap_log() { return NP == 1 ? 15 : 14; }
static_assert(RS_THREADS * rs_e<1>() == 1 << rs_cap_log<1>(), "keys");
static_assert(RS_THREADS * rs_e<2>() == 1 << rs_cap_log<2>(), "pairs");

// Bytes of tile_radix_kernel's dynamic shared memory: the tuples, the
// (warp, digit) count and mask tables, the digit totals, bases and group
// sums, the varying-bit masks and the warp sums of the digit scan.
template <int NP>
__host__ __device__ constexpr size_t rs_smem_bytes() {
  return sizeof(int32_t) *
         (((size_t)NP << rs_cap_log<NP>()) + 2 * RS_WARPS * RS_DIGITS +
          (2 + RS_GROUPS) * RS_DIGITS + 4 + RS_WARPS);
}

struct RsArgs {
  const int32_t* bounds;   // (ntiles, R) biased inclusive upper bounds
  const int32_t* data;     // tile t's data elements; the rest is SENT
  int32_t* cnt;            // (ntiles, R) counts
  long long te;            // elements of a tile
  int nruns;               // runs a tile
  int clog;                // log2 CTAs a cluster
  int R;
  int accumulate;          // add each run's counts into a zeroed cnt
};

// The shared tables of one CTA of tile_radix_kernel.
struct RsShared {
  int32_t* buf;            // 2^rs_cap_log tuples, planes side by side
  int* wcnt;               // [warp][digit] counts, then offsets
  unsigned* wmask;         // [warp][digit] peer masks, zero between rows
  int* ctot;               // [digit] the CTA's totals
  int* dbase;              // [digit] the CTA's first position of a digit
  int* gpart;              // [group][digit] counts of a group of warps
  unsigned* vary;          // [plane] varying bits (4)
  int* wsum;               // [warp] sums of the digit scan
};

// One pass over the digit (raw >> shift) & 255 of plane q, by the whole
// cluster (stable unless it is the first); returns after its second
// cluster barrier.
template <int NP>
__device__ __forceinline__ void rs_pass(const RsShared& sh,
                                        cg::cluster_group& cl, int q,
                                        int shift, bool stable, int nlive,
                                        int c, int C) {
  constexpr int E = rs_e<NP>();
  constexpr int CAP_LOG = rs_cap_log<NP>();
  constexpr int CAP = 1 << CAP_LOG;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const unsigned below = (1u << lane) - 1;
  int* wc = sh.wcnt + wp * RS_DIGITS;
  unsigned* wm = sh.wmask + wp * RS_DIGITS;
  for (int i = lane; i < RS_DIGITS; i += 32) wc[i] = 0;
  __syncwarp();
  const int pw = wp * 32 * E + lane;             // row 0's position
  const int live = nlive - (c << CAP_LOG) - pw;  // row j live: 32j < live
  int32_t x[NP][E];
  uint32_t rk[E / 2];                            // two 16-bit ranks a word
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if constexpr (NP == 2) {
      const int2 t = ((const int2*)sh.buf)[pw + 32 * j];
      x[0][j] = t.x;
      x[1][j] = t.y;
    } else {
      x[0][j] = sh.buf[pw + 32 * j];
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int32_t key = (NP == 1 || q == 0) ? x[0][j] : x[NP - 1][j];
    const int d = 32 * j < live
                      ? (int)((((uint32_t)key ^ 0x80000000u) >> shift) &
                              (RS_DIGITS - 1))
                      : -1;
    uint32_t r;
    if (stable) {
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
      r = (uint32_t)(b + __popc(peers & below));
    } else {
      const int d0 = __shfl_sync(FULL_MASK, d, 0);
      if (__all_sync(FULL_MASK, d == d0)) {
        int b = 0;
        if (lane == 0 && d0 >= 0) b = atomicAdd(&wc[d0], 32);
        r = (uint32_t)(__shfl_sync(FULL_MASK, b, 0) + lane);
      } else {
        r = d >= 0 ? (uint32_t)atomicAdd(&wc[d], 1) : 0;
      }
    }
    if (j & 1) rk[j >> 1] |= r << 16; else rk[j >> 1] = r;
  }
  __syncthreads();
  {
    // the (warp, digit) counts in warp order: RS_GROUPS threads a digit,
    // each over RS_WARPS / RS_GROUPS warps, give the warps' offsets inside
    // the CTA's segment of the digit and the CTA's total
    constexpr int WG = RS_WARPS / RS_GROUPS;
    const int d = tid % RS_DIGITS, g = tid / RS_DIGITS;
    int run = 0;
#pragma unroll
    for (int v = g * WG; v < (g + 1) * WG; ++v) {
      const int n = sh.wcnt[v * RS_DIGITS + d];
      sh.wcnt[v * RS_DIGITS + d] = run;
      run += n;
    }
    sh.gpart[g * RS_DIGITS + d] = run;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int gg = 0; gg < RS_GROUPS; ++gg) {
      const int n = sh.gpart[gg * RS_DIGITS + d];
      before += gg < g ? n : 0;
      total += n;
    }
    if (before) {
#pragma unroll
      for (int v = g * WG; v < (g + 1) * WG; ++v)
        sh.wcnt[v * RS_DIGITS + d] += before;
    }
    if (g == 0) sh.ctot[d] = total;
  }
  cl.sync();
  // the digit's segment in the run: the totals of lower digits over the
  // cluster, then the digit's counts in lower CTAs
  int tot = 0, bef = 0;
  if (tid < RS_DIGITS) {
    for (int cc = 0; cc < C; ++cc) {
      const int n = cl.map_shared_rank(sh.ctot, cc)[tid];
      tot += n;
      if (cc < c) bef += n;
    }
  }
  int incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += y;
  }
  if (tid < RS_DIGITS && lane == 31) sh.wsum[wp] = incl;
  __syncthreads();
  if (tid < RS_DIGITS) {
    int before = 0;
    for (int v = 0; v < wp; ++v) before += sh.wsum[v];
    sh.dbase[tid] = before + incl - tot + bef;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < E; ++j) {
    if (32 * j >= live) continue;
    const int32_t key = (NP == 1 || q == 0) ? x[0][j] : x[NP - 1][j];
    const int d = (int)((((uint32_t)key ^ 0x80000000u) >> shift) &
                        (RS_DIGITS - 1));
    const int dest = sh.dbase[d] + wc[d] +
                     (int)((rk[j >> 1] >> (16 * (j & 1))) & 0xFFFF);
    int32_t* to = (C == 1 ? sh.buf
                          : cl.map_shared_rank(sh.buf, dest >> CAP_LOG)) +
                  (dest & (CAP - 1)) * NP;
    if constexpr (NP == 2)
      *(int2*)to = make_int2(x[0][j], x[1][j]);
    else
      *to = x[0][j];
  }
  cl.sync();
}

template <int NP>
__global__ void __launch_bounds__(RS_THREADS, 1)
    tile_radix_kernel(Planes<NP> a, RsArgs k) {
  constexpr int CAP_LOG = rs_cap_log<NP>();
  constexpr int CAP = 1 << CAP_LOG;
  extern __shared__ __align__(16) int32_t rs_smem[];
  RsShared sh;
  sh.buf = rs_smem;
  sh.wcnt = sh.buf + NP * CAP;
  sh.wmask = (unsigned*)(sh.wcnt + RS_WARPS * RS_DIGITS);
  sh.ctot = (int*)(sh.wmask + RS_WARPS * RS_DIGITS);
  sh.dbase = sh.ctot + RS_DIGITS;
  sh.gpart = sh.dbase + RS_DIGITS;
  sh.vary = (unsigned*)(sh.gpart + RS_GROUPS * RS_DIGITS);
  sh.wsum = (int*)(sh.vary + 4);
  cg::cluster_group cl = cg::this_cluster();
  const int C = 1 << k.clog;
  const int c = (int)(blockIdx.x & (C - 1));
  const long long cid = blockIdx.x >> k.clog;         // (tile, run)
  const long long t = cid / k.nruns;
  const long long r0 = (cid % k.nruns) << (CAP_LOG + k.clog);
  const int runlen = (int)min((long long)C << CAP_LOG, k.te - r0);
  const int nlive =
      (int)max(0LL, min((long long)k.data[t] - r0, (long long)runlen));
  const long long tb = t * k.te + r0;                  // the run's first
  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = c << CAP_LOG;                         // the CTA's first
  for (int i = tid; i < RS_WARPS * RS_DIGITS; i += RS_THREADS)
    sh.wmask[i] = 0;
  if (tid < 4) sh.vary[tid] = 0;
  __syncthreads();
  int32_t ref[NP];
  bool vec = true;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    ref[p] = nlive > 0 ? a.p[p][tb] : 0;
    vec &= ((uintptr_t)(a.p[p] + tb) & 15) == 0;
  }
  const int lim = min(CAP, max(0, nlive - p0));       // live positions held
  unsigned orv[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) orv[p] = 0;
  for (int i = 4 * tid; i < lim; i += 4 * RS_THREADS) {
    int32_t e[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int32_t* g = a.p[p] + tb + p0 + i;
      if (vec && i + 4 <= lim) {
        const int4 v = *(const int4*)g;
        e[p][0] = v.x; e[p][1] = v.y; e[p][2] = v.z; e[p][3] = v.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) e[p][u] = i + u < lim ? g[u] : ref[p];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) orv[p] |= (uint32_t)(e[p][u] ^ ref[p]);
    }
    int4* to = (int4*)(sh.buf + i * NP);
    if constexpr (NP == 2) {
      to[0] = make_int4(e[0][0], e[1][0], e[0][1], e[1][1]);
      to[1] = make_int4(e[0][2], e[1][2], e[0][3], e[1][3]);
    } else {
      to[0] = make_int4(e[0][0], e[0][1], e[0][2], e[0][3]);
    }
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const unsigned m = __reduce_or_sync(FULL_MASK, orv[p]);
    if (lane == 0 && m) atomicOr(&sh.vary[p], m);
  }
  cl.sync();
  unsigned vm[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    vm[p] = 0;
    for (int cc = 0; cc < C; ++cc)
      vm[p] |= *cl.map_shared_rank(&sh.vary[p], cc);
  }
  bool first = true;
  for (int q = NP - 1; q >= 0; --q) {
    const unsigned m = q == 0 ? vm[0] : vm[NP - 1];
    if (!m) continue;
    const int lo = __ffs((int)m) - 1, hi = 31 - __clz((int)m);
    for (int s = lo; s <= hi; s += RS_BITS) {
      rs_pass<NP>(sh, cl, q, s, !first, nlive, c, C);
      first = false;
    }
  }
  // the sorted run: live tuples, then SENT to the run's end
  const int hold = min(CAP, max(0, runlen - p0));
  for (int i = 4 * tid; i < hold; i += 4 * RS_THREADS) {
    int32_t t[4 * NP];
    const int4* from = (const int4*)(sh.buf + i * NP);
#pragma unroll
    for (int h = 0; h < NP; ++h) {
      const int4 v = from[h];
      t[4 * h] = v.x; t[4 * h + 1] = v.y; t[4 * h + 2] = v.z;
      t[4 * h + 3] = v.w;
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      int32_t e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        e[u] = p0 + i + u < nlive ? t[u * NP + p] : SENT;
      int32_t* g = a.p[p] + tb + p0 + i;
      if (vec) {
        *(int4*)g = make_int4(e[0], e[1], e[2], e[3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) g[u] = e[u];
      }
    }
  }
  const long long row = t * k.R;
  for (int d = c + C * tid; d < k.R; d += C * RS_THREADS) {
    const int32_t bd = k.bounds[row + d];
    int lo = 0, hi = nlive;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int32_t km = cl.map_shared_rank(
          sh.buf, mid >> CAP_LOG)[(mid & (CAP - 1)) * NP];
      if (km <= bd) lo = mid + 1; else hi = mid;
    }
    const int n = lo + (bd == SENT ? runlen - nlive : 0);
    if (k.accumulate) atomicAdd(&k.cnt[row + d], n); else k.cnt[row + d] = n;
  }
  // no CTA leaves while another may read its shared memory
  cl.sync();
}

// Sort every tile of te tuples in place and count its bounds: one cluster
// launch of tile_radix_kernel, then, for tiles of several runs,
// merge_runs.
template <int NP>
int tile_sort_planes(void* const* planes, const int32_t* bounds,
                     const int32_t* data, int32_t* cnt, int ntiles,
                     long long te, int R, cudaStream_t st) {
  constexpr int CAP_LOG = rs_cap_log<NP>();
  if (ntiles <= 0 || te <= 0) return (int)cudaGetLastError();
  if (te > (1LL << 30) || te % LANES || R < 0)
    return (int)cudaErrorInvalidValue;
  const Planes<NP> a = planes_of<NP>(planes);
  int clog = 0;
  while ((1LL << (CAP_LOG + clog)) < te && clog < RS_CLOG_MAX) ++clog;
  const long long run = 1LL << (CAP_LOG + clog);
  const int nruns = (int)((te + run - 1) / run);
  const RsArgs k{bounds, data, cnt, te, nruns, clog, R, nruns > 1};
  const cudaError_t err = cs_launch_n(
      tile_radix_kernel<NP>, ((long long)ntiles * nruns) << clog, 1 << clog,
      RS_THREADS, rs_smem_bytes<NP>(), st, a, k);
  if (err != cudaSuccess) return (int)err;
  if (nruns == 1) return (int)cudaGetLastError();
  int lN = 0;
  while ((1LL << lN) < te) ++lN;
  const Regions r{nullptr, data, te, ntiles * te, 0};
  return merge_runs<NP>(a, r, ntiles, CAP_LOG + RS_CLOG_MAX, lN, st);
}

// ----------------------------------------------------------- distribute
// One CTA per tile.  Its (range) entries are staged in shared memory,
// the empty ones dropped; the tile's extent, from its first run start
// to its furthest run end, comes into shared memory by TMA bulk copies
// (cp.async.bulk into an mbarrier), DIST_WIN tuples of one plane at a
// time; then every run goes from there to its slot with 16-byte stores,
// SENT after the run to the end of its last row.  A slot starts on a row,
// so its stores are aligned whatever the run's phase in the tile.  A
// store vector belongs to the window that holds its first element (the
// run's last for the SENT vectors); elements of it past the window are
// read from device memory.  Stores are element-exact, so runs may land
// in any order.  The wrapper refuses runs and slots outside their
// arenas; the tests below only keep the kernel inside them.
constexpr int DIST_THREADS = 512;
constexpr int DIST_WIN = 16384;      // 64 KiB of one plane: 3 CTAs an SM
constexpr int DIST_MAX_RUNS = 352;   // table width (the wrapper: 3r <= 1024)
constexpr int BULK_CHUNK = 16384;    // bytes of one bulk copy

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

template <int NP>
__global__ void __launch_bounds__(DIST_THREADS) distribute_kernel(
    Planes<NP> src, long long src_len, const int32_t* __restrict__ slot_rows,
    const int32_t* __restrict__ run_starts,
    const int32_t* __restrict__ run_lens, Planes<NP> out, long long out_len,
    int r, long long tile_elems, int win) {
  extern __shared__ __align__(128) int32_t win_smem[];
  __shared__ int s_start[DIST_MAX_RUNS], s_len[DIST_MAX_RUNS];
  __shared__ long long s_dst[DIST_MAX_RUNS];
  __shared__ int s_vec[DIST_MAX_RUNS + 1];   // exclusive prefix of vectors
  __shared__ int s_n, s_lo, s_hi;
  __shared__ __align__(8) uint64_t bar;
  const long long tb = (long long)blockIdx.x * tile_elems;
  if (threadIdx.x == 0) {
    s_n = 0;
    s_lo = INT_MAX;
    s_hi = 0;
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(&bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int d = threadIdx.x; d < r; d += blockDim.x) {
    const long long i = (long long)blockIdx.x * r + d;
    const int ln = run_lens[i];
    if (ln <= 0) continue;
    const long long s = run_starts[i];
    const long long dst = (long long)slot_rows[i] * LANES;
    const long long end = ((long long)ln + LANES - 1) / LANES * LANES;
    if (s < 0 || s + ln > tile_elems || tb + s + ln > src_len || dst < 0 ||
        dst + end > out_len)
      continue;
    const int j = atomicAdd(&s_n, 1);
    s_start[j] = (int)s;
    s_len[j] = ln;
    s_dst[j] = dst;
    atomicMin(&s_lo, (int)s);
    atomicMax(&s_hi, (int)(s + ln));
  }
  __syncthreads();
  const int n = s_n;
  if (n == 0) return;
  if (threadIdx.x < 32) {   // warp 0: prefix sum of the runs' vectors
    const int lane = threadIdx.x;
    int carry = 0;
    for (int c = 0; c < n; c += 32) {
      const int j = c + lane;
      int v = j < n ? (s_len[j] + LANES - 1) / LANES * (LANES / 4) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (j < n) s_vec[j + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) s_vec[0] = 0;
  }
  __syncthreads();
  const int nvec = s_vec[n];
  const int lo = s_lo & ~3, hi = (s_hi + 3) & ~3;  // tile_elems % 128 == 0
  const uint32_t bar_at = smem_addr(&bar);
  uint32_t phase = 0;
  for (int w0 = lo; w0 < hi; w0 += win) {
    const int w1 = min(hi, w0 + win);
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const int32_t* g = src.p[q] + tb;
      if (((uintptr_t)src.p[q] & 15) == 0) {
        if (threadIdx.x == 0) {
          const uint32_t bytes = (uint32_t)(w1 - w0) * 4;
          // the window's earlier reads are ordered before the copy's
          // writes by the barrier that ended them
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
              :: "r"(bar_at), "r"(bytes) : "memory");
          for (uint32_t o = 0; o < bytes; o += BULK_CHUNK) {
            const uint32_t sz = min((uint32_t)BULK_CHUNK, bytes - o);
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                "::bytes [%0], [%1], %2, [%3];\n"
                :: "r"(smem_addr(win_smem) + o),
                   "l"((uint64_t)(uintptr_t)(g + w0) + o), "r"(sz), "r"(bar_at)
                : "memory");
          }
        }
        mbar_wait(bar_at, phase);
        phase ^= 1;
      } else {
        for (int i = w0 + threadIdx.x; i < w1; i += blockDim.x)
          win_smem[i - w0] = g[i];
        __syncthreads();
      }
      int j = 0;
      for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
        while (s_vec[j + 1] <= v) ++j;
        const int e = 4 * (v - s_vec[j]);      // first element of the vector
        const int ln = s_len[j], s = s_start[j];
        const int first = s + min(e, ln - 1);
        if (first < w0 || first >= w1) continue;
        int32_t x[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int at = s + e + c;
          x[c] = e + c >= ln ? SENT
                 : at < w1 ? win_smem[at - w0] : g[at];
        }
        int32_t* o = out.p[q] + s_dst[j] + e;
        if (((uintptr_t)out.p[q] & 15) == 0) {
          *(int4*)o = make_int4(x[0], x[1], x[2], x[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) o[c] = x[c];
        }
      }
      __syncthreads();
    }
  }
}

// -------------------------------------------------------------- compact
// Output-tiled: block c writes output elements [c * span, (c + 1) *
// span), span = compact_span(NP), whatever segments they come from, in
// rounds of COMPACT_THREADS x COMPACT_VEC / NP vectors of 4 elements.
// The wrapper's int64 table holds each segment's first source element
// (nseg), the output offsets (nseg + 1: the exclusive prefix sum of the
// lengths, then the total) and the segment of the first element of each
// group of COMPACT_GROUP output elements (ngroups + 1, the last the last
// segment).  Each thread finds the segment of each of its vectors
// (COMPACT_THREADS vectors apart) by a binary search from the previous
// one's (the first from its group's first segment), up to the next
// group's first segment.  A vector inside one segment comes from the aligned 16-byte
// source vector that holds its first element and the next one, which is
// the next lane's when that lane's vector follows in the same segment (a
// shuffle) and is loaded otherwise (a segment starts on a row, so
// neither leaves the arena); every load of a round is issued before its
// first store, and the vector is re-aligned in registers and stored as
// one aligned vector.  A vector that spans segments or the total is
// copied element by element; elements past the total are not written.
// The wrapper refuses segments outside their arenas and totals past the
// output; the kernel trusts the table.
constexpr int COMPACT_THREADS = 256;
constexpr int COMPACT_VEC = 8;       // vectors a thread a round, keys only

// Output elements one block writes: four rounds keys only, one with a
// value plane (the faster on the v1 engine's shapes).
__host__ __device__ constexpr int compact_span(int np) {
  return COMPACT_THREADS * COMPACT_VEC * 4 / np * (np == 1 ? 4 : 1);
}
// Output elements a first-segment entry of the table covers: whole blocks
constexpr int COMPACT_GROUP = compact_span(1);
static_assert(COMPACT_GROUP % compact_span(2) == 0, "blocks split a group");

// The largest s in [lo, hi] with v[s] <= x, given v[lo] <= x.
__device__ __forceinline__ int last_at_most(const long long* __restrict__ v,
                                            int lo, int hi, long long x) {
  while (lo < hi) {
    const int m = (lo + hi + 1) >> 1;
    if (v[m] <= x) lo = m; else hi = m - 1;
  }
  return lo;
}

// Elements ph..ph+3 of the eight in (a, b).
__device__ __forceinline__ int4 funnel(const int4& a, const int4& b, int ph) {
  switch (ph) {
    case 0: return a;
    case 1: return make_int4(a.y, a.z, a.w, b.x);
    case 2: return make_int4(a.z, a.w, b.x, b.y);
    default: return make_int4(a.w, b.x, b.y, b.z);
  }
}

template <int NP>
__global__ void __launch_bounds__(COMPACT_THREADS) compact_kernel(
    Planes<NP> src, Planes<NP> out, const long long* __restrict__ tbl,
    int nseg, long long total, int vec_ok) {
  constexpr int V = COMPACT_VEC / NP;
  constexpr int ROUND = COMPACT_THREADS * V * 4;
  constexpr int SPAN = compact_span(NP);
  const long long* __restrict__ base = tbl;
  const long long* __restrict__ offs = tbl + nseg;
  const long long* __restrict__ first = offs + nseg + 1;
  const long long g = (long long)blockIdx.x * SPAN / COMPACT_GROUP;
  const int lo = (int)first[g], hi = (int)first[g + 1];
  const int lane = threadIdx.x & 31;
  int seg = lo;
  for (long long t0 = (long long)blockIdx.x * SPAN;
       t0 < (long long)(blockIdx.x + 1) * SPAN && t0 < total; t0 += ROUND) {
    // the source element of each vector's first element; -1: element by
    // element; -2: past the total
    long long from[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const long long o = t0 + 4LL * (k * COMPACT_THREADS + threadIdx.x);
      from[k] = -2;
      if (o < total) {
        seg = last_at_most(offs, seg, hi, o);
        from[k] = vec_ok && o + 4 <= offs[seg + 1]
                      ? base[seg] + (o - offs[seg]) : -1;
      }
    }
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      int4 a[V], b[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[k] = make_int4(0, 0, 0, 0);
        if (from[k] >= 0)
          a[k] = __ldg((const int4*)(src.p[q] + (from[k] & ~3LL)));
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const long long next = __shfl_down_sync(0xffffffffu, from[k], 1);
        b[k].x = __shfl_down_sync(0xffffffffu, a[k].x, 1);
        b[k].y = __shfl_down_sync(0xffffffffu, a[k].y, 1);
        b[k].z = __shfl_down_sync(0xffffffffu, a[k].z, 1);
        b[k].w = __shfl_down_sync(0xffffffffu, a[k].w, 1);
        if (from[k] >= 0 && (from[k] & 3) &&
            (lane == 31 || next != from[k] + 4))
          b[k] = __ldg((const int4*)(src.p[q] + (from[k] & ~3LL)) + 1);
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        if (from[k] >= 0) {
          const long long o = t0 + 4LL * (k * COMPACT_THREADS + threadIdx.x);
          *(int4*)(out.p[q] + o) = funnel(a[k], b[k], (int)(from[k] & 3));
        }
      }
    }
    for (int k = 0; k < V; ++k) {
      if (from[k] != -1) continue;
      const long long o = t0 + 4LL * (k * COMPACT_THREADS + threadIdx.x);
      const long long end = o + 4 < total ? o + 4 : total;
      int s = lo;
      for (long long e = o; e < end; ++e) {
        s = last_at_most(offs, s, hi, e);
        const long long at = base[s] + (e - offs[s]);
#pragma unroll
        for (int q = 0; q < NP; ++q) out.p[q][e] = src.p[q][at];
      }
    }
  }
}

}  // namespace

extern "C" {

// nplanes is 1 (keys) or 2 (keys, vals); vals is NULL for 1.  cnt must
// be zeroed when a tile has several runs (more than 2^18 keys or 2^17
// pairs).
int kv1_tile_sort(void* keys, void* vals, const void* bounds,
                  const void* data_elems, void* cnt, int ntiles,
                  long long tile_elems, int r, int nplanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  void* const planes[2] = {keys, vals};
  const int32_t* b = (const int32_t*)bounds;
  const int32_t* d = (const int32_t*)data_elems;
  switch (nplanes) {
    case 1:
      return tile_sort_planes<1>(planes, b, d, (int32_t*)cnt, ntiles,
                                 tile_elems, r, st);
    case 2:
      return tile_sort_planes<2>(planes, b, d, (int32_t*)cnt, ntiles,
                                 tile_elems, r, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int kv1_distribute(void* keys, void* vals, long long src_len,
                   const void* slot_rows, const void* run_starts,
                   const void* run_lens, void* out_keys, void* out_vals,
                   long long out_len, long long nruns, int r,
                   long long tile_elems, int nplanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (r <= 0 || nruns <= 0) return (int)cudaGetLastError();
  if (r > DIST_MAX_RUNS || tile_elems % LANES || tile_elems > INT_MAX ||
      nruns / r > INT_MAX)
    return (int)cudaErrorInvalidValue;
  void* const src[2] = {keys, vals};
  void* const out[2] = {out_keys, out_vals};
  const int win = (int)std::min(tile_elems, (long long)DIST_WIN);
  const size_t shm = (size_t)win * sizeof(int32_t);
#define KV1_DISTRIBUTE(NP)                                                  \
  {                                                                         \
    const cudaError_t err = cudaFuncSetAttribute(                           \
        distribute_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
        (int)shm);                                                          \
    if (err != cudaSuccess) return (int)err;                                \
    distribute_kernel<NP><<<(int)(nruns / r), DIST_THREADS, shm, st>>>(     \
        planes_of<NP>(src), src_len, (const int32_t*)slot_rows,             \
        (const int32_t*)run_starts, (const int32_t*)run_lens,               \
        planes_of<NP>(out), out_len, r, tile_elems, win);                   \
  }
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
  void* const planes[2] = {keys, vals};
  cudaStream_t st = (cudaStream_t)stream;
  switch (nplanes) {
    case 1: return ragged_sort_regions<1>(planes, reg, nb, st);
    case 2: return ragged_sort_regions<2>(planes, reg, nb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// table: int64, nseg segment starts (elements), nseg + 1 output offsets,
// ngroups + 1 first segments (compact_kernel); span and group must be
// compact_span(nplanes) and COMPACT_GROUP, the wrapper's.
int kv1_compact(void* keys, void* vals, const void* table, int nseg,
                int nblocks, long long total, int span, int group,
                void* out_keys, void* out_vals, int nplanes, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nplanes < 1 || nplanes > 2 || span != compact_span(nplanes) ||
      group != COMPACT_GROUP || nseg <= 0 || nblocks < 0)
    return (int)cudaErrorInvalidValue;
  if (nblocks == 0) return (int)cudaGetLastError();
  void* const src[2] = {keys, vals};
  void* const out[2] = {out_keys, out_vals};
  int vec_ok = 1;
  for (int q = 0; q < nplanes; ++q)
    if (((uintptr_t)src[q] | (uintptr_t)out[q]) & 15) vec_ok = 0;
  const long long* tbl = (const long long*)table;
#define KV1_COMPACT(NP)                                                     \
  compact_kernel<NP><<<nblocks, COMPACT_THREADS, 0, st>>>(                  \
      planes_of<NP>(src), planes_of<NP>(out), tbl, nseg, total, vec_ok)
  switch (nplanes) {
    case 1: KV1_COMPACT(1); break;
    default: KV1_COMPACT(2); break;
  }
#undef KV1_COMPACT
  return (int)cudaGetLastError();
}

}  // extern "C"
