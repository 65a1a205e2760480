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

constexpr int SORT_THREADS = 1024;   // blocks that sort a shared tile
constexpr int STEP_THREADS = 256;    // one global network step
constexpr int STEP_BLOCKS = 65536;   // grid cap of a global step
constexpr int COPY_THREADS = 256;    // count

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
  const long long base = (long long)k.start_rows[b] * LANES;
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

// Sort every live bucket of r.  Up to 8 CTAs of tuples a bucket is one
// cluster launch.  Larger buckets (N = 2^lN >= m tuples) are sorted as
// ascending runs of 2^lr, then joined by the network's all-ascending
// merges (the first step of merge size k pairs i with i ^ (k - 1), the
// others i with i + j, the smaller tuple to the lower index, so virtual
// SENT tuples past m stay in place): global_step_kernel for distances of
// a run or more, a cluster launch in merge mode for the shorter ones.
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
  cudaError_t err = cluster_sort<NP>(a, r, nb, lr, 1 << (lN - lr), 0, st);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = nb << (lN - 1);
  const int sgrid = (int)std::min((pairs + STEP_THREADS - 1) / STEP_THREADS,
                                  (long long)STEP_BLOCKS);
  for (long long k = 2LL << lr; k <= (1LL << lN); k <<= 1) {
    global_step_kernel<NP><<<sgrid, STEP_THREADS, 0, st>>>(
        a, r, nb, lN - 1, (int)(k >> 1), 1, NP - 1);
    for (long long j = k >> 2; j >= (1LL << lr); j >>= 1)
      global_step_kernel<NP><<<sgrid, STEP_THREADS, 0, st>>>(
          a, r, nb, lN - 1, (int)j, 0, NP - 1);
    err = cluster_sort<NP>(a, r, nb, lr, 1 << (lN - lr), 1, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
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
