// The cluster-resident bitonic sort shared by the v1 bucket sort
// (ragged_sort, csrc/pallas_kernels.cu) and the v4/v3 terminal sort
// (terminal_write's cluster path, csrc/kernels_v4.cu): the tuples of a run
// stay in the shared memory of one thread-block cluster of C = 1-16 CTAs
// from one read to one write, and a bitonic network sorts them there.
// The kernels that include it own their load and store policies (which
// tuples a run holds, where the sorted ones go); this header holds the
// tuple words, their shared-memory layout and the network's passes.
//
// A tuple is one word in registers whose unsigned (or, keys only,
// signed) order is the tuples' lexicographic order over every plane:
//   1 plane: the biased key, int32;
//   2 planes: (key, val) packed into a uint64 (cs_pack);
//   3 planes: a 96-bit word, (plane 0, plane 1) in a uint64 and plane 2;
//   4 planes: a 128-bit word, two uint64s;
// compared high to low, so that min and max (or a compare and two
// selects) order them.  In shared memory a 1- or 2-plane tuple is one
// unit (int32, uint64); a 3-plane tuple is three uint32 planes and a
// 4-plane tuple two uint64 planes, ps units apart, so that every access
// is a 4- or 8-byte one with the padding below.
//
// The network is addressed by the bits of a tuple's index e in the run.
// A pass loads 2^W tuples into each thread's registers (W = 5 keys-only,
// 4 otherwise): a group, the tuples whose index bits outside a window
// [wlo, wlo + W) are equal.  It runs every step whose partner distance is
// a bit of the window in registers and stores the group back.  A step of
// merge stage kappa compares e with e ^ 2^b and puts the smaller tuple
// at the lower index where bit kappa of e is 0, the larger one where it
// is 1; a tuple whose bit kappa is 1 is complemented on load and store
// (which reverses the order), so every step in registers is an
// ascending min/max.  Stage kappa takes ceil(kappa / W) passes.  Local
// passes (the window below the CTA's bits) have their window and
// directions fixed at compile time, so a group's shared-memory addresses
// are one base and immediate offsets; one __syncthreads separates them.
// The passes whose steps cross CTAs (the first pass of each stage above
// a CTA) read and write the other CTAs' shared memory (distributed
// shared memory) between cluster barriers.  Tuples equal under the order
// are identical (every plane is compared), so any correct network gives
// a plain stable sort's result bit for bit.

#pragma once

#include <cooperative_groups.h>
#include <limits.h>

#include "bitonic.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CS_THREADS = 512;
constexpr int CS_MAX_CTAS = 16;       // above 8: a non-portable cluster
constexpr int CS_UNROLL = 4;          // 16-byte loads in flight per thread
constexpr int CS_HEAD = 16 * CS_MAX_CTAS;  // bytes before the tuples: the
                                           // mapped CTA bases, and slack

struct CsW3 {
  unsigned long long hi;
  uint32_t lo;
};
struct CsW4 {
  unsigned long long hi, lo;
};

// word: a tuple in registers; unit: one shared-memory element; mask: the
// type of a complement mask; units: shared planes of a tuple
template <int NP> struct CsTypes;
template <> struct CsTypes<1> {
  using word = int32_t; using unit = int32_t; using mask = int32_t;
  static constexpr int units = 1;
};
template <> struct CsTypes<2> {
  using word = unsigned long long; using unit = unsigned long long;
  using mask = unsigned long long;
  static constexpr int units = 1;
};
template <> struct CsTypes<3> {
  using word = CsW3; using unit = uint32_t; using mask = unsigned long long;
  static constexpr int units = 3;
};
template <> struct CsTypes<4> {
  using word = CsW4; using unit = unsigned long long;
  using mask = unsigned long long;
  static constexpr int units = 2;
};
template <int NP> using cs_t = typename CsTypes<NP>::word;
template <int NP> using cs_u = typename CsTypes<NP>::unit;
template <int NP> using cs_m = typename CsTypes<NP>::mask;

__device__ __forceinline__ CsW3 operator^(CsW3 a, unsigned long long m) {
  return CsW3{a.hi ^ m, a.lo ^ (uint32_t)m};
}
__device__ __forceinline__ CsW4 operator^(CsW4 a, unsigned long long m) {
  return CsW4{a.hi ^ m, a.lo ^ m};
}
__device__ __forceinline__ CsW3& operator^=(CsW3& a, unsigned long long m) {
  return a = a ^ m;
}
__device__ __forceinline__ CsW4& operator^=(CsW4& a, unsigned long long m) {
  return a = a ^ m;
}

// a <- the smaller, b <- the larger of (a, b)
template <class T>
__device__ __forceinline__ void cs_order(T& a, T& b) {
  const T lo = min(a, b);
  b = max(a, b);
  a = lo;
}
__device__ __forceinline__ void cs_order(CsW3& a, CsW3& b) {
  const bool s = b.hi < a.hi || (b.hi == a.hi && b.lo < a.lo);
  const CsW3 t = a;
  a = s ? b : a;
  b = s ? t : b;
}
__device__ __forceinline__ void cs_order(CsW4& a, CsW4& b) {
  const bool s = b.hi < a.hi || (b.hi == a.hi && b.lo < a.lo);
  const CsW4 t = a;
  a = s ? b : a;
  b = s ? t : b;
}

template <int NP>
__host__ __device__ constexpr int cs_w() { return NP == 1 ? 5 : 4; }
// log2 of the tuples one CTA holds at most: 128 KiB of words, 192 KiB
// with 3 planes
template <int NP>
__host__ __device__ constexpr int cs_cta_log() {
  return NP == 1 ? 15 : (NP <= 3 ? 14 : 13);
}

// Shared-memory unit of tuple l: one pad unit after every 128 bytes, so
// a warp reading 32 consecutive tuples, or one tuple from each of 32
// consecutive groups, meets no bank twice; and a tuple e0 + x with
// disjoint bits lies at cs_pad(e0) + cs_pad(x).
template <int NP>
__host__ __device__ constexpr int cs_pad(int l) {
  return l + (l >> (sizeof(cs_u<NP>) == 4 ? 5 : 4));
}

// Bytes of dynamic shared memory of a CTA holding 2^sb tuples.
template <int NP>
__host__ __device__ constexpr size_t cs_smem_bytes(int sb) {
  return CS_HEAD + (size_t)CsTypes<NP>::units * sizeof(cs_u<NP>) *
                       cs_pad<NP>(1 << sb);
}

__device__ __forceinline__ unsigned long long cs_pack(int32_t k, int32_t v) {
  return ((unsigned long long)(uint32_t)(k ^ BIAS) << 32) |
         (uint32_t)(v ^ BIAS);
}
__device__ __forceinline__ int32_t cs_hi(unsigned long long t) {
  return (int32_t)(uint32_t)(t >> 32) ^ BIAS;
}
__device__ __forceinline__ int32_t cs_lo(unsigned long long t) {
  return (int32_t)(uint32_t)t ^ BIAS;
}

// The tuple at unit i of shared planes ps units apart, as a word.
template <int NP>
__device__ __forceinline__ cs_t<NP> cs_ld(const cs_u<NP>* s, int i, int ps) {
  if constexpr (NP <= 2) {
    return s[i];
  } else if constexpr (NP == 3) {
    return CsW3{((unsigned long long)s[i] << 32) | s[i + ps], s[i + 2 * ps]};
  } else {
    return CsW4{s[i], s[i + ps]};
  }
}
template <int NP>
__device__ __forceinline__ void cs_st(cs_u<NP>* s, int i, int ps,
                                      cs_t<NP> v) {
  if constexpr (NP <= 2) {
    s[i] = v;
  } else if constexpr (NP == 3) {
    s[i] = (uint32_t)(v.hi >> 32);
    s[i + ps] = (uint32_t)v.hi;
    s[i + 2 * ps] = v.lo;
  } else {
    s[i] = v.hi;
    s[i + ps] = v.lo;
  }
}

// A tuple of NP biased int32 plane values into shared memory at unit i,
// and back; cs_put_sent stores the all-SENT tuple (the largest word).
template <int NP>
__device__ __forceinline__ void cs_put(cs_u<NP>* s, int i, int ps,
                                       const int32_t* v) {
  if constexpr (NP == 1) {
    s[i] = v[0];
  } else if constexpr (NP == 2) {
    s[i] = cs_pack(v[0], v[1]);
  } else if constexpr (NP == 3) {
#pragma unroll
    for (int q = 0; q < 3; ++q) s[i + q * ps] = (uint32_t)(v[q] ^ BIAS);
  } else {
    s[i] = cs_pack(v[0], v[1]);
    s[i + ps] = cs_pack(v[2], v[3]);
  }
}
template <int NP>
__device__ __forceinline__ void cs_put_sent(cs_u<NP>* s, int i, int ps) {
  if constexpr (NP == 1) {
    s[i] = SENT;
  } else {
#pragma unroll
    for (int q = 0; q < CsTypes<NP>::units; ++q) s[i + q * ps] = ~cs_u<NP>(0);
  }
}
template <int NP>
__device__ __forceinline__ void cs_get(const cs_u<NP>* s, int i, int ps,
                                       int32_t* v) {
  if constexpr (NP == 1) {
    v[0] = s[i];
  } else if constexpr (NP == 2) {
    v[0] = cs_hi(s[i]);
    v[1] = cs_lo(s[i]);
  } else if constexpr (NP == 3) {
#pragma unroll
    for (int q = 0; q < 3; ++q) v[q] = (int32_t)s[i + q * ps] ^ BIAS;
  } else {
    v[0] = cs_hi(s[i]);
    v[1] = cs_lo(s[i]);
    v[2] = cs_hi(s[i + ps]);
    v[3] = cs_lo(s[i + ps]);
  }
}

// One ascending network step on a group's registers: partner distance
// 2^B in register indices, the smaller tuple to the lower one.
template <int NP, int B>
__device__ __forceinline__ void cs_step(cs_t<NP> (&x)[1 << cs_w<NP>()]) {
#pragma unroll
  for (int r = 0; r < (1 << cs_w<NP>()); ++r)
    if (!(r & (1 << B))) cs_order(x[r], x[r | (1 << B)]);
}

template <int NP>
__device__ __forceinline__ void cs_step_at(cs_t<NP> (&x)[1 << cs_w<NP>()],
                                           int b) {
  switch (b) {
    case 0: cs_step<NP, 0>(x); break;
    case 1: cs_step<NP, 1>(x); break;
    case 2: cs_step<NP, 2>(x); break;
    case 3: cs_step<NP, 3>(x); break;
    default:
      if constexpr (cs_w<NP>() > 4) cs_step<NP, 4>(x);
      break;
  }
}

// Complement mask of register r's tuple in a window whose direction bit
// is bit P of r (P < W), or the group's flip gflip (P == W).
template <int NP, int P>
__device__ __forceinline__ cs_m<NP> cs_flip(int r, cs_m<NP> gflip) {
  return P == cs_w<NP>() ? gflip : ((r >> P) & 1 ? ~cs_m<NP>(0) : 0);
}

// First tuple of group g of a window at wlo.
template <int W>
__device__ __forceinline__ int cs_e0(int g, int wlo) {
  return ((g >> wlo) << (wlo + W)) | (g & ((1 << wlo) - 1));
}

// A local pass of stage kappa over window [WLO, WLO + W), steps on bits
// hi..stop; the direction bit kappa is bit P of the window (P < W) or
// above it (P == W, from the group's index in the run, CTA rank
// included).  sm is the CTA's units, ps its plane stride.
template <int NP, int WLO, int P>
__device__ __forceinline__ void cs_local(cs_u<NP>* sm, int ps, int sb,
                                         int rank, int hi, int stop,
                                         int kappa) {
  constexpr int W = cs_w<NP>(), T = 1 << W;
  const int mask = (1 << sb) - 1;
  for (int gi = threadIdx.x; gi < (1 << (sb - W)); gi += blockDim.x) {
    const int e0 = cs_e0<W>((rank << (sb - W)) + gi, WLO);
    const cs_m<NP> gflip = P == W ? -(cs_m<NP>)((e0 >> kappa) & 1) : 0;
    // an ascending group (gflip 0) skips the complement
    const bool flip = P < W || gflip;
    cs_u<NP>* base = sm + cs_pad<NP>(e0 & mask);
    cs_t<NP> x[T];
#pragma unroll
    for (int r = 0; r < T; ++r) x[r] = cs_ld<NP>(base, cs_pad<NP>(r << WLO), ps);
    if (flip) {
#pragma unroll
      for (int r = 0; r < T; ++r) x[r] ^= cs_flip<NP, P>(r, gflip);
    }
    for (int b = hi - WLO; b >= stop - WLO; --b) cs_step_at<NP>(x, b);
    if (flip) {
#pragma unroll
      for (int r = 0; r < T; ++r) x[r] ^= cs_flip<NP, P>(r, gflip);
    }
#pragma unroll
    for (int r = 0; r < T; ++r) cs_st<NP>(base, cs_pad<NP>(r << WLO), ps, x[r]);
  }
}

template <int NP, int WLO>
__device__ __forceinline__ bool cs_local_p(cs_u<NP>* sm, int ps, int sb,
                                           int rank, int hi, int stop,
                                           int kappa) {
  constexpr int W = cs_w<NP>();
  const int p = kappa - WLO;
  if (p == 1)
    cs_local<NP, WLO, 1>(sm, ps, sb, rank, hi, stop, kappa);
  else if (p == 2)
    cs_local<NP, WLO, 2>(sm, ps, sb, rank, hi, stop, kappa);
  else if (p == 3)
    cs_local<NP, WLO, 3>(sm, ps, sb, rank, hi, stop, kappa);
  else if (W > 4 && p == 4)
    cs_local<NP, WLO, (W > 4 ? 4 : W)>(sm, ps, sb, rank, hi, stop, kappa);
  else
    cs_local<NP, WLO, W>(sm, ps, sb, rank, hi, stop, kappa);
  return true;
}

// The local pass at a window base of 0, W, 2W or a full CTA's top
// window (every local pass of a CTA that holds its full share); false
// for other bases.
template <int NP, int SBL>
__device__ __forceinline__ bool cs_local_fixed(cs_u<NP>* sm, int ps, int sb,
                                               int rank, int wlo, int hi,
                                               int stop, int kappa) {
  constexpr int W = cs_w<NP>(), TOP = SBL - W;
  if (wlo == 0)
    return cs_local_p<NP, 0>(sm, ps, sb, rank, hi, stop, kappa);
  if (wlo == W)
    return cs_local_p<NP, W>(sm, ps, sb, rank, hi, stop, kappa);
  if (wlo == 2 * W)
    return cs_local_p<NP, 2 * W>(sm, ps, sb, rank, hi, stop, kappa);
  if (wlo == TOP)
    return cs_local_p<NP, TOP>(sm, ps, sb, rank, hi, stop, kappa);
  return false;
}

// A remote pass of a cluster of full CTAs (2^SB tuples each) over the
// run's top window [WLO, WLO + W) (WLO + W = lr): group g's tuples are
// g + (r << WLO), in CTA (r << WLO) >> SB at a fixed offset from the
// group's, so each address is a mapped CTA base and an immediate offset.
template <int NP, int SB, int WLO, int P>
__device__ __forceinline__ void cs_remote(cs_u<NP>* const* words, int ps,
                                          int rank, int hi, int stop) {
  constexpr int W = cs_w<NP>(), T = 1 << W;
  constexpr int C = 1 << (WLO + W - SB), MASK = (1 << SB) - 1;
  for (int gi = threadIdx.x; gi < (1 << (SB - W)); gi += blockDim.x) {
    const int e0 = (rank << (SB - W)) + gi;     // below 2^WLO
    cs_u<NP>* base[C];
#pragma unroll
    for (int c = 0; c < C; ++c) base[c] = words[c] + cs_pad<NP>(e0);
    cs_t<NP> x[T];
#pragma unroll
    for (int r = 0; r < T; ++r)
      x[r] = cs_ld<NP>(base[(r << WLO) >> SB],
                       cs_pad<NP>((r << WLO) & MASK), ps) ^
             cs_flip<NP, P>(r, 0);
    for (int b = hi - WLO; b >= stop - WLO; --b) cs_step_at<NP>(x, b);
#pragma unroll
    for (int r = 0; r < T; ++r)
      cs_st<NP>(base[(r << WLO) >> SB], cs_pad<NP>((r << WLO) & MASK), ps,
                x[r] ^ cs_flip<NP, P>(r, 0));
  }
}

template <int NP, int SB, int WLO>
__device__ __forceinline__ bool cs_remote_p(cs_u<NP>* const* words, int ps,
                                            int rank, int hi, int stop,
                                            int kappa) {
  constexpr int W = cs_w<NP>();
  const int p = kappa - WLO;
  if (p == 1)
    cs_remote<NP, SB, WLO, 1>(words, ps, rank, hi, stop);
  else if (p == 2)
    cs_remote<NP, SB, WLO, 2>(words, ps, rank, hi, stop);
  else if (p == 3)
    cs_remote<NP, SB, WLO, 3>(words, ps, rank, hi, stop);
  else if (W > 4 && p == 4)
    cs_remote<NP, SB, WLO, (W > 4 ? 4 : W)>(words, ps, rank, hi, stop);
  else
    cs_remote<NP, SB, WLO, W>(words, ps, rank, hi, stop);
  return true;
}

// The remote pass over the top window of a run of 2, 4 or 8 full CTAs;
// false for other windows (16 CTAs take the general pass).
template <int NP, int SB>
__device__ __forceinline__ bool cs_remote_fixed(cs_u<NP>* const* words,
                                                int ps, int sb, int lr,
                                                int rank, int wlo, int hi,
                                                int stop, int kappa) {
  constexpr int W = cs_w<NP>();
  if (sb != SB || wlo != lr - W) return false;
  if (lr == SB + 1)
    return cs_remote_p<NP, SB, SB + 1 - W>(words, ps, rank, hi, stop, kappa);
  if (lr == SB + 2)
    return cs_remote_p<NP, SB, SB + 2 - W>(words, ps, rank, hi, stop, kappa);
  if (lr == SB + 3)
    return cs_remote_p<NP, SB, SB + 3 - W>(words, ps, rank, hi, stop, kappa);
  return false;
}

// Stages K..W of the first pass, over window [0, W): the direction bit
// of stage k < W is bit k of r, of stage W bit 0 of the group.
template <int NP, int K>
__device__ __forceinline__ void cs_prefix_stage(
    cs_t<NP> (&x)[1 << cs_w<NP>()], cs_m<NP> gflip) {
  constexpr int W = cs_w<NP>(), T = 1 << W;
  if constexpr (K <= W) {
#pragma unroll
    for (int r = 0; r < T; ++r)
      x[r] ^= (K == 1 ? 0 : cs_flip<NP, K - 1>(r, gflip)) ^
              cs_flip<NP, K>(r, gflip);
#pragma unroll
    for (int b = K - 1; b >= 0; --b) cs_step_at<NP>(x, b);
    cs_prefix_stage<NP, K + 1>(x, gflip);
  } else {
#pragma unroll
    for (int r = 0; r < T; ++r) x[r] ^= gflip;
  }
}

template <int NP>
__device__ __forceinline__ void cs_prefix(cs_u<NP>* sm, int ps, int sb) {
  constexpr int W = cs_w<NP>(), T = 1 << W;
  for (int g = threadIdx.x; g < (1 << (sb - W)); g += blockDim.x) {
    cs_u<NP>* base = sm + cs_pad<NP>(g << W);
    cs_t<NP> x[T];
#pragma unroll
    for (int r = 0; r < T; ++r) x[r] = cs_ld<NP>(base, r, ps);
    cs_prefix_stage<NP, 1>(x, -(cs_m<NP>)(g & 1));
#pragma unroll
    for (int r = 0; r < T; ++r) cs_st<NP>(base, r, ps, x[r]);
  }
}

// The general pass, window and direction at run time: a remote window
// (words[rank] is CTA rank's units, mapped into this CTA's view of the
// cluster) or a local window at another base (words[0] this CTA's).
// Each CTA takes an equal share of the groups.
template <int NP, bool REMOTE>
__device__ __forceinline__ void cs_pass(cs_u<NP>* const* words, int ps,
                                        int sb, int rank, int wlo, int hi,
                                        int stop, int kappa) {
  constexpr int W = cs_w<NP>(), T = 1 << W;
  const int mask = (1 << sb) - 1;
  for (int gi = threadIdx.x; gi < (1 << (sb - W)); gi += blockDim.x) {
    const int e0 = cs_e0<W>((rank << (sb - W)) + gi, wlo);
    cs_t<NP> x[T];
#pragma unroll
    for (int r = 0; r < T; ++r) {
      const int e = e0 | (r << wlo);
      x[r] = cs_ld<NP>(words[REMOTE ? e >> sb : 0], cs_pad<NP>(e & mask), ps) ^
             -(cs_m<NP>)((e >> kappa) & 1);
    }
    for (int b = hi - wlo; b >= stop - wlo; --b) cs_step_at<NP>(x, b);
#pragma unroll
    for (int r = 0; r < T; ++r) {
      const int e = e0 | (r << wlo);
      cs_st<NP>(words[REMOTE ? e >> sb : 0], cs_pad<NP>(e & mask), ps,
                x[r] ^ -(cs_m<NP>)((e >> kappa) & 1));
    }
  }
}

// A CTA's view of its cluster for the network: its own units, the
// mapped bases of every CTA's (head of the dynamic shared memory), the
// plane stride, and the run's geometry (2^lr tuples, 2^sb a CTA).
template <int NP>
struct CsView {
  cs_u<NP>* sm;
  cs_u<NP>** rwords;
  int ps, sb, lr, rank;
};

// Carve the dynamic shared memory and map every CTA's units; the caller
// must pass a cluster barrier before the first remote pass.
template <int NP>
__device__ __forceinline__ CsView<NP> cs_view(unsigned char* smem,
                                              cg::cluster_group& cl, int lr,
                                              int sb, int rank) {
  CsView<NP> v;
  v.rwords = (cs_u<NP>**)smem;
  v.sm = (cs_u<NP>*)(smem + CS_HEAD);
  v.ps = cs_pad<NP>(1 << sb);
  v.sb = sb;
  v.lr = lr;
  v.rank = rank;
  if ((int)threadIdx.x < (1 << (lr - sb)))
    v.rwords[threadIdx.x] = cl.map_shared_rank(v.sm, threadIdx.x);
  return v;
}

// The network over the run the cluster's CTAs hold (each loaded its
// share and passed nothing since): sort mode sorts the run ascending;
// merge mode runs the steps of its last stage only (distances run/2 ..
// 1, all ascending), which finish a merge whose longer steps global
// launches made.  Returns after a barrier, so each CTA may read its own
// share; before it loads a new run, a __syncthreads must separate that
// read from the new stores.  SBL is the full CTA's log2 tuples, whose
// windows are fixed at compile time.
template <int NP, int SBL = cs_cta_log<NP>()>
__device__ void cs_network(const CsView<NP>& v, cg::cluster_group& cl,
                           bool merge) {
  constexpr int W = cs_w<NP>();
  const int sb = v.sb, lr = v.lr, rank = v.rank, ps = v.ps;
  bool was_remote = lr > sb;
  auto barrier = [&](bool remote) {
    if (remote) cl.sync(); else __syncthreads();
  };
  auto stage = [&](int kappa) {
    for (int hi = kappa - 1; hi >= 0;) {
      // steps on bits hi..stop, in a window inside the CTA where they
      // fit, else in one that reaches into the cluster's bits
      const int stop = hi / W * W;
      const bool remote = hi >= sb;
      const int wlo = min(stop, (remote ? lr : sb) - W);
      barrier(remote || was_remote);
      if (remote) {
        if (!cs_remote_fixed<NP, SBL>(v.rwords, ps, sb, lr, rank, wlo, hi,
                                      stop, kappa))
          cs_pass<NP, true>(v.rwords, ps, sb, rank, wlo, hi, stop, kappa);
      } else if (!cs_local_fixed<NP, SBL>(v.sm, ps, sb, rank, wlo, hi, stop,
                                          kappa)) {
        cs_u<NP>* own = v.sm;
        cs_pass<NP, false>(&own, ps, sb, rank, wlo, hi, stop, kappa);
      }
      was_remote = remote;
      hi = stop - 1;
    }
  };
  if (merge) {
    stage(lr);
  } else {
    barrier(was_remote);
    cs_prefix<NP>(v.sm, ps, sb);                  // stages 1..W
    was_remote = false;
    for (int kappa = W + 1; kappa <= lr; ++kappa) stage(kappa);
  }
  barrier(was_remote);
}

// Launch a cluster kernel over `grid` CTAs of `threads` threads in
// clusters of `ctas` with `shm` bytes of dynamic shared memory each
// (clusters above 8 CTAs are allowed as non-portable).
template <class Kernel, class... Args>
cudaError_t cs_launch_n(Kernel kernel, long long grid, int ctas, int threads,
                        size_t shm, cudaStream_t st, Args... args) {
  if (grid > INT_MAX || ctas < 1 || ctas > CS_MAX_CTAS)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return err;
  if (ctas > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = shm;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The same with CS_THREADS threads a CTA, the network's block.
template <class Kernel, class... Args>
cudaError_t cs_launch(Kernel kernel, long long grid, int ctas, size_t shm,
                      cudaStream_t st, Args... args) {
  return cs_launch_n(kernel, grid, ctas, CS_THREADS, shm, st, args...);
}

// How many clusters of `ctas` CTAs with `shm` bytes each can be resident
// at once (0 if none can).
template <class Kernel>
cudaError_t cs_max_clusters(Kernel kernel, int ctas, size_t shm, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
  if (err != cudaSuccess) return err;
  if (ctas > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(CS_THREADS);
  cfg.dynamicSmemBytes = shm;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, (void*)kernel, &cfg);
}

}  // namespace
