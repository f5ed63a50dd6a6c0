// Batched banded dual affine-gap extension (ksw_extd2, approx-max H0) with
// an int16 lane state, two lanes in each 32-bit register, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel gdiet_tpu/ops/dp_pallas.py::_dp_kernel
// (_dp_kernel_body, full lane width) run with state_dtype = "int16"
// (extd2_batch_pallas, sdt = int16: the seven lane-state arrays 16-bit, H0
// and the score int32). It computes exactly what
// gdiet_tpu_torch/ops/dp.py::extd2_batch computes with
// state_dtype="int16", which under ops/dp.py::safe_state_dtype's bound is
// what csrc/extd2.cu computes: dirs[N][R][T] (T = round16(Lt)) in the
// layout of ops/dp.py, every byte written.
//
// What bounds it on this card. Two things, by the call:
//   - The dirs stream: N x R x T bytes, written once. At the generic
//     short-read call (65,536 rows x 511 wavefronts x 256 lanes, 8.6 GB)
//     that is the whole bound, and about two thirds of it are zeros: the
//     dead rows (qlen or tlen 0), every row's wavefronts after its last live
//     one (qlen + tlen - 1, about 299 of 511 for a 150 bp read), and at 256
//     lanes the lanes past a 150 bp read's target.
//   - The instructions a row's wavefronts issue (qlen + tlen - 1 serial
//     wavefronts a row, ~57 lane operations a live lane, two lanes an
//     instruction): the integer pipe, two warp instructions a clock an SM,
//     is what the short-read calls saturate (chip_smoke.py's kernel_int16
//     and band_ablation.py give the time per wavefront and its parts).
//
// Design, the warp route (T <= 512):
//   - Two rows a warp. A row is G threads (8, 16 or 32) of NS lane pairs
//     each, 32 / G rows a warp: at the SE width 16 threads x 5 pairs = 160
//     lanes, two rows a warp, where one row a warp left a 64-lane slot half
//     empty. A call takes the narrowest layout that covers T
//     (ops/extd2.py::I16_LAYOUTS; this file's instances: by_layout).
//   - Slots. Thread g's pair k is the row's pair k G + g, so slot k is the
//     2G lanes [2kG, 2kG + 2G) across the row's threads, and a slot whose
//     lanes all lie outside both rows' live range [st, max(en, span end)]
//     skips its body (one warp-uniform branch) and stores its zero bytes:
//     about a third of the slots at a 150 x 150 DP, whose anti-diagonals
//     are half the row on average. (A thread's pairs as contiguous lanes,
//     one shuffle a state a wavefront instead of one a slot, ran slower
//     at every width on the card: no slot can be skipped; PERF.md §6.)
//   - The lane t-1 neighbours: a rotate of the slot by one thread within
//     the row (__shfl_sync, width G), thread 0 taking thread G-1's of the
//     slot before from that slot's rotate. A pair is in band or out as a
//     whole (st a multiple of 16, en one below one or T - 1: the test of
//     tests/test_torch_full_i16.py), so the pair step runs under a branch
//     on it.
//   - The band start. Lane st takes the boundary values as its lane t-1
//     neighbours unless the previous live wavefront covered lane st-1; lane
//     st-1 then lies below the band for good and is read as that neighbour
//     only, so its owner writes the values into it once per band start (a
//     branch the warp rarely takes), not a fixup per pair and wavefront.
//   - The substitution scores: the reversed 16-bit query (entry i holds the
//     query codes i and i - 1, XOR 4) in shared memory, one load a pair, and
//     the target codes XOR 4 in registers: an XOR and two subtractions give
//     "differ" and "not N" per half, and sign-replicating byte permutes the
//     masks (csrc/extd2_band_i16.cu's scheme).
//   - Zeros beside the DP. The first launch's leading warps (two an SM) write
//     the zero wavefronts of every row, from its last live one on (dead rows
//     whole, with their NEG_INF score), as runs of 16-byte stores, while
//     the DP warps run. A DP warp takes a chunk of rows, keeps the live ones
//     (a ballot) and aligns them 32 / G at a time, each to its own last live
//     wavefront. ops/extd2.py::i16_full_plan sizes the chunks from the rows
//     and SMs and passes each launch's layout, rows and warps
//     (gdiet_extd2_i16_warp): the plan has one source, in Python.
//   - The narrow rows. Above 160 lanes, a row whose target fits 160 lanes
//     (round16(tlen) <= 160: every 150 bp read) never has a lane past 159 in
//     band, its walk never reads one, and its dirs there are zero: such rows
//     run in the 160-lane layout (a 16-byte store a thread zeroes the rest
//     of each wavefront), the others in T's own, in a second launch.
//   - The H0 walk: the taps v[lt] and u[lt+1] are a select over the slots
//     (PTX selp) and one __shfl_sync within the row's threads each, read one
//     wavefront behind, so that their latency hides behind the next
//     wavefront's slots.
// The chain of a pair is dp_pair.cuh's pair_step (its direction code per
// half from the __vibmax_u16x2 predicates), the relu maxima's floor operand
// held in a register.
//
// The block route (T > 512: the long-read (512, 1024) bucket): one block
// per row, one thread per pair, the lane t-1 neighbours and the H0 taps
// exchanged through shared memory behind two barriers per wavefront, as
// csrc/extd2.cu's block route.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_pair.cuh"

namespace {

using namespace pair16;

constexpr int kNegInf = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;           // warps a block of the warp route
constexpr int kMaxWarpLanes = 512;  // the warp route's widest layout
constexpr int kDead = 0x7ffff;      // band start and end of a dead wavefront: past every lane

struct Scoring {
  int a, b, q, e, q2, e2, long_thres, long_diff;
};

__device__ __forceinline__ int boundary_u(int r, const Scoring& sc) {
  return r == 0 ? -(sc.q + sc.e)
       : r < sc.long_thres ? -sc.e
       : r == sc.long_thres ? sc.long_diff : -sc.e2;
}

// p ? a : b as one PTX selp: a chain of these over the slots stays in
// registers (the compiler turns a chain of C++ selects on the slot index
// into an indexed array in local memory)
__device__ __forceinline__ uint32_t select_if(bool p, uint32_t a, uint32_t b) {
  uint32_t r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\tselp.b32 %0, %1, %2, q;\n\t}"
      : "=r"(r) : "r"(a), "r"(b), "r"((int)p));
  return r;
}

// prmt.b32 in its default mode: a selector nibble with bit 3 set
// replicates the sign bit of the byte it selects
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t sel) {
  uint32_t out;
  asm("prmt.b32 %0, %1, 0, %2;\n" : "=r"(out) : "r"(a), "r"(sel));
  return out;
}

// v in a register the compiler cannot see into (a loop-invariant operand
// it would otherwise rebuild at each use)
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  uint32_t r;
  asm("mov.b32 %0, %1;\n" : "=r"(r) : "r"(v));
  return r;
}

// The layout of a warp-route instance: a row is G threads, and thread g's
// pair k (k < NS) is the row's lane pair k G + g (lanes 2(kG + g) and
// 2(kG + g) + 1), so slot k is the 2G lanes [2kG, 2kG + 2G) across the
// row's threads: W = 2G NS lanes a row, 32 / G rows a warp.
template <int G_, int NS_>
struct Lanes {
  static constexpr int G = G_, NS = NS_;
  static constexpr int SL = 2 * G_;   // a slot's lanes
  static constexpr int W = SL * NS_;  // a row's lanes
  static constexpr int RPW = 32 / G_;  // rows a warp
};

// the shared bytes of a row's reversed query: 16-bit entries of indices -1
// .. Lmax + 1, a 16-byte multiple
__host__ __device__ inline int query_bytes(int Lmax) { return (2 * (Lmax + 3) + 15) & ~15; }

struct Args {
  const uint8_t *query, *target;
  const int32_t *qlens, *tlens, *bands;
  int32_t* score;
  uint8_t* dirs;
  int N, Lmax, Lt, T, R;
};

// one launch of the warp route
struct Launch {
  int tl_lo, tl_hi;  // the rows its DP warps align: tl_lo < round16(tlen) <= tl_hi
  int chunk;         // rows a DP warp takes below row `split`, a multiple of its rows a warp
  int split;         // from this row on a DP warp takes its rows a warp
  int head_warps;    // the DP warps below `split`
  int zero_warps;    // its leading warps, which write the zero tails and the dead rows
};

// The zero warps: rows z, z + Z, z + 2Z, ...: the wavefronts from the
// row's last live one on (r_end = qlen + tlen - 1, 0 for a row with qlen or
// tlen 0, whose score is NEG_INF), one run of 16-byte stores a row (T is a
// multiple of 16).
__device__ __forceinline__ void zero_rows(const Args& g, int z, int Z, int lane) {
  const int T16 = g.T / 16;
  for (int n0 = z; n0 < g.N; n0 += 32 * Z) {
    const int nl = n0 + lane * Z;
    int re = 0;
    if (nl < g.N) {
      const int ql = g.qlens[nl];
      const int tl = g.tlens != nullptr ? g.tlens[nl] : ql;
      re = (ql > 0 && tl > 0) ? min(g.R, ql + tl - 1) : 0;
      if (re == 0) g.score[nl] = kNegInf;
    }
    for (int i = 0; i < 32 && n0 + i * Z < g.N; ++i) {
      const int n = n0 + i * Z;
      const int r_end = __shfl_sync(kFull, re, i);
      uint4* z4 = reinterpret_cast<uint4*>(g.dirs + ((size_t)n * g.R + r_end) * g.T);
      const int nz = (g.R - r_end) * T16;
#pragma unroll 4
      for (int j = lane; j < nz; j += 32) z4[j] = make_uint4(0, 0, 0, 0);
    }
  }
}

// the substitution scores of a pair as one offset-binary word: a where
// the codes agree, -b where they differ, -e2 where either is N; q16 the
// reversed query entry (q(i) ^ 4, q(i - 1) ^ 4) of i = r - lane0, tcode the
// pair's target codes XOR 4 in the halves, tn the halves whose code is N
__device__ __forceinline__ uint32_t subst16(uint32_t q16, uint32_t tcode, uint32_t tn,
                                            uint32_t sa, uint32_t sb, uint32_t se2) {
  const uint32_t qh = prmt(q16, 0x4140u);  // one code a half
  // bit 15 of a half of (h | 0x8000) - 1 is h != 0 (h <= 255: no borrow)
  const uint32_t differ = ((qh ^ tcode) | 0x80008000u) - 0x00010001u;
  const uint32_t q_not_n = (qh | 0x80008000u) - 0x00010001u;
  const uint32_t sc = blend(prmt(differ, 0xbb99u), sb, sa);
  return blend(prmt(q_not_n, 0xbb99u) & ~tn, sc, se2);
}

// The DP of one warp's rows: row h of the warp (threads h G .. h G + G - 1)
// aligns row n (-1: none) over wavefronts 0 .. r_end - 1, and the warp runs
// to its longest row. A slot whose lanes all lie outside every row's [st,
// max(en, span end)] at a wavefront skips its body (a warp-uniform branch)
// and stores its zero dirs bytes. The lane t-1 neighbours are a rotate of
// the slot by one thread within the row (__shfl_sync, width G); thread 0
// takes thread G-1's of the slot before, from that slot's rotate. The
// substitution scores come from the reversed 16-bit query, one shared load
// a pair. qrev: the row's query entries in shared memory.
template <class L>
__device__ __forceinline__ void align_rows(const Args& g, const Scoring& sc, int n, int qlen,
                                           int tlen, uint16_t* qrev, int lane) {
  constexpr int G = L::G, NS = L::NS, SL = L::SL;
  const int gl = lane % G;
  const int w = n >= 0 ? g.bands[n] : 0;
  const int qlim = n >= 0 ? min(qlen, g.Lmax) : 0;
  const int r_end = n >= 0 ? min(g.R, qlen + tlen - 1) : 0;
  const int r_max = __reduce_max_sync(kFull, r_end);
  const int qe = sc.q + sc.e;
  const PairScoring ps = pair_scoring(sc.a, sc.q, sc.e, sc.q2, sc.e2);
  const uint32_t init = splat(-qe), init2 = splat(-(sc.q2 + sc.e2));
  const uint32_t sa = splat(sc.a), sb = splat(-sc.b), se2 = splat(-sc.e2);
  const uint32_t floor = opaque(kBias);  // the relu maxima's third operand

  // qrev[i + 1] = (q(i) ^ 4) | (q(i - 1) ^ 4) << 8 for i in [-1, qlim + 1],
  // q(i) the query code, 0 outside the read
  __syncwarp();  // the previous round's reads are done
  const uint8_t* qrow = g.query + (size_t)max(n, 0) * g.Lmax;
  for (int k = gl; k <= qlim + 2; k += G) {
    const int i = k - 1;
    const int a = (i >= 0 && i < qlim) ? qrow[i] : 0;
    const int c = (i >= 1 && i <= qlim) ? qrow[i - 1] : 0;
    qrev[k] = (uint16_t)((a ^ 4) | ((c ^ 4) << 8));
  }
  __syncwarp();

  // each pair's target codes XOR 4 (0 past Lt) and the halves whose code is N
  uint32_t tcode[NS], tn[NS];
  uint32_t u[NS], v[NS], x[NS], y[NS], x2[NS], y2[NS], s[NS];
  const uint8_t* trow = g.target + (size_t)max(n, 0) * g.Lt;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int l0 = k * SL + 2 * gl;
    const int t0 = (n >= 0 && l0 < g.Lt) ? trow[l0] : 0;
    const int t1 = (n >= 0 && l0 + 1 < g.Lt) ? trow[l0 + 1] : 0;
    tcode[k] = (uint32_t)(t0 ^ 4) | ((uint32_t)(t1 ^ 4) << 16);
    tn[k] = (t0 == 4 ? 0x0000ffffu : 0u) | (t1 == 4 ? 0xffff0000u : 0u);
    u[k] = v[k] = x[k] = y[k] = init;
    x2[k] = y2[k] = init2;
    s[k] = kBias;  // 0
  }
  uint8_t* drow = g.dirs + ((size_t)max(n, 0) * g.R) * g.T;

  int H0 = 0, lt = 0, last_st = -1, last_en = -1, score = kNegInf;
  // the band start whose lane below already holds the boundary values
  int patched_st = 0;
  bool p_live = false;
  int p_st0 = 0, p_en0 = 0, v_lt = 0, u_lt1 = 0;
  // lt as (slot, lane in the slot): lt_k * SL + lt_j. lt <= en0 <= tlen - 1
  // < T after every live wavefront, and the walk reads u at lt + 1 only
  // where lt + 1 <= en0, so neither tap needs a clamp; a tap past the row's
  // lanes (a narrow row's) is never read
  int lt_k = 0, lt_j = 0;
  auto lane_value = [&](const uint32_t(&a)[NS], int k, int j) {
    uint32_t sel = a[0];
#pragma unroll
    for (int kk = 1; kk < NS; ++kk) sel = select_if(k == kk, a[kk], sel);
    return half(__shfl_sync(kFull, sel, j >> 1, G), j & 1);
  };
  auto taps = [&]() {
    v_lt = lane_value(v, lt_k, lt_j);
    const bool wrap = lt_j + 1 == SL;
    u_lt1 = lane_value(u, lt_k + wrap, wrap ? 0 : lt_j + 1);
  };
  auto walk = [&](int rw) {  // walk wavefront rw = r-1 on the taps
    if (!p_live) return;
    if (rw == 0) {  // lt == 0 here, so the tap is v[0]
      H0 = v_lt - qe;
    } else {
      const bool lt_in = lt >= p_st0 && lt <= p_en0;
      const bool lt1_in = lt + 1 >= p_st0 && lt + 1 <= p_en0;
      if (lt_in && lt1_in ? v_lt > u_lt1 : lt_in) {
        H0 += v_lt;
      } else {
        H0 += u_lt1;
        lt += 1;
        lt_j += 1;
        if (lt_j == SL) {
          lt_j = 0;
          lt_k += 1;
        }
      }
    }
    if (rw == qlen + tlen - 2 && p_en0 == tlen - 1) score = H0;
  };

  for (int r = 0; r < r_max; ++r, drow += g.T) {
    taps();
    const int st0 = __vimax3_s32(0, r - qlen + 1, (r - w + 1) >> 1);
    const int en0 = __vimin3_s32(tlen - 1, r, (r + w) >> 1);
    const bool live = r < r_end && st0 <= en0;
    const int st = live ? st0 & ~15 : kDead;
    const int en = live ? min(((en0 + 16) & ~15) - 1, g.T - 1) : kDead;
    const int s_end = live ? st0 + ((en0 - st0) & ~15) + 16 : 0;  // the span [st0, s_end)
    // the warp's lanes with work: its rows' [st, max(en, s_end - 1)]
    const int w_lo = __reduce_min_sync(kFull, st);
    const int w_hi = __reduce_max_sync(kFull, live ? max(en, s_end - 1) : -1);
    const bool prev_ok = (st > 0) && (st - 1 >= last_st) && (st - 1 <= last_en);
    const int bu = boundary_u(r, sc);
    const uint32_t e_m = live && en >= r ? half_mask(r & 1) : 0u;  // the edge lane r
    const uint32_t ubu = splat(bu);
    const bool row_live = n >= 0 && r < r_end;
    // Lane st takes the boundary values x, x2 = init and v = -qe as its
    // lane t-1 neighbours unless prev_ok (lane st-1 was in band at the last
    // live wavefront). Lane st-1 lies below the band from then on (st never
    // falls) and its x, v, x2 are read as that neighbour only, so its
    // owner writes them there once per band start, in a branch the warp
    // rarely takes; lane 0 (st = 0) reads thread 0's carry below.
    const bool patch = live && st > 0 && !prev_ok && st != patched_st;
    if (__any_sync(kFull, patch)) {
      const int l = st - 1;  // the high half of pair l / 2
#pragma unroll
      for (int k = 0; k < NS; ++k)
        if (patch && l >> 1 == k * G + gl) {
          x[k] = blend(0xffff0000u, init, x[k]);
          v[k] = blend(0xffff0000u, splat(-qe), v[k]);
          x2[k] = blend(0xffff0000u, init2, x2[k]);
        }
      if (patch) patched_st = st;
    }

    // pair k G - 1 of the slot before (thread G-1's), old x, v, x2; lane
    // 0's are the boundary values (in band only as st = 0, never prev_ok)
    uint32_t cx = init, cv = ubu, cx2 = init2;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const bool act = k * SL + SL - 1 >= w_lo && k * SL <= w_hi;  // warp-uniform
      const bool next = k + 1 < NS && k * SL + 2 * SL - 1 >= w_lo && k * SL + SL <= w_hi;
      const int lane0 = k * SL + 2 * gl;
      uint32_t d = 0;
      if (act || next) {
        const uint32_t rx = __shfl_sync(kFull, x[k], (gl + G - 1) % G, G);
        const uint32_t rv = __shfl_sync(kFull, v[k], (gl + G - 1) % G, G);
        const uint32_t rx2 = __shfl_sync(kFull, x2[k], (gl + G - 1) % G, G);
        if (act) {
          const uint32_t q16 = qrev[__vimin_s32_relu(r - lane0 + 1, qlim + 2)];
          s[k] = blend(span_mask(lane0, st0, s_end),
                       subst16(q16, tcode[k], tn[k], sa, sb, se2), s[k]);
          // a pair is in band or out as a whole (st even, en odd); the
          // slot's pairs outside keep their state
          if ((unsigned)(lane0 - st) <= (unsigned)(en - st)) {
            const uint32_t em = lane0 == (r & ~1) ? e_m : 0u;
            const uint32_t yk = blend(em, init, y[k]);
            const uint32_t y2k = blend(em, init2, y2[k]);
            const uint32_t uk = blend(em, ubu, u[k]);
            const PairOut o = pair_step(s[k], prev_lanes(gl == 0 ? cx : rx, x[k]),
                                        prev_lanes(gl == 0 ? cv : rv, v[k]),
                                        prev_lanes(gl == 0 ? cx2 : rx2, x2[k]), uk, yk, y2k,
                                        ps, floor);
            u[k] = o.u;
            v[k] = o.v;
            x[k] = o.x;
            y[k] = o.y;
            x2[k] = o.x2;
            y2[k] = o.y2;
            d = o.d;
          }
        }
        cx = rx;
        cv = rv;
        cx2 = rx2;
      }
      if (row_live && lane0 < g.T) *reinterpret_cast<uint16_t*>(drow + lane0) = (uint16_t)d;
    }
    // a narrow row's lanes past W are zero
    if (L::W < g.T && row_live)
      for (int c = gl; c < (g.T - L::W) / 16; c += G)
        *reinterpret_cast<uint4*>(drow + L::W + 16 * c) = make_uint4(0, 0, 0, 0);

    walk(r - 1);
    p_live = live;
    p_st0 = st0;
    p_en0 = en0;
    if (live) {
      last_st = st;
      last_en = en;
    }
  }
  taps();  // the last wavefront
  walk(r_max - 1);
  if (gl == 0 && n >= 0) g.score[n] = score;
}

template <class L>
__global__ void __launch_bounds__(32 * kWarps)
extd2_i16_warp_kernel(Args g, Launch p, Scoring sc) {
  constexpr int G = L::G;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31;
  const int wi = threadIdx.x >> 5;
  const int gw = blockIdx.x * kWarps + wi;
  if (gw < p.zero_warps) {
    zero_rows(g, gw, p.zero_warps, lane);
    return;
  }
  // the warp's rows [c0, c0 + cn): a chunk below row p.split, one round above
  const int dw = gw - p.zero_warps;
  const int c0 = dw < p.head_warps ? dw * p.chunk : p.split + (dw - p.head_warps) * L::RPW;
  const int cn = dw < p.head_warps ? min(p.chunk, p.split - c0) : L::RPW;
  if (c0 >= g.N) return;
  const int QB = query_bytes(g.Lmax);
  uint16_t* const qrev = reinterpret_cast<uint16_t*>(smem + (size_t)(wi * L::RPW + lane / G) * QB);
  // the rows of the warp's chunk that this launch aligns, one a lane
  int ql = 0, tl = 0;
  bool mine = false;
  if (lane < cn && c0 + lane < g.N) {
    ql = g.qlens[c0 + lane];
    tl = g.tlens != nullptr ? g.tlens[c0 + lane] : ql;
    const int t16 = (tl + 15) & ~15;
    mine = ql > 0 && tl > 0 && t16 > p.tl_lo && t16 <= p.tl_hi;
  }
  unsigned todo = __ballot_sync(kFull, mine);
  while (todo) {  // RPW of them a round, one a row of the warp
    int off = -1;
#pragma unroll
    for (int k = 0; k < L::RPW; ++k) {
      if (k == lane / G) off = __ffs(todo) - 1;
      todo &= todo - 1;
    }
    const int qlen = __shfl_sync(kFull, ql, off & 31);
    const int tlen = __shfl_sync(kFull, tl, off & 31);
    align_rows<L>(g, sc, off >= 0 ? c0 + off : -1, qlen, tlen, qrev, lane);
  }
}

// the substitution score of target code tq against query[qi] (0 outside
// the read): a, -b, or -e2 where either base is N (code 4)
__device__ __forceinline__ int subst(int tq, const uint8_t* sq, int qi,
                                     int qlim, const Scoring& sc) {
  const int qv = (qi >= 0 && qi < qlim) ? (int)sq[qi] : 0;
  return (tq == 4 || qv == 4) ? -sc.e2 : (tq == qv ? sc.a : -sc.b);
}

// the substitution scores of lanes (lane0, lane0 + 1), target codes in
// bytes 0 and 1 of tq2, at wavefront r, as one offset-binary word
__device__ __forceinline__ uint32_t subst_pair(int tq2, const uint8_t* sq, int r,
                                               int lane0, int qlim, const Scoring& sc) {
  return pack2(subst(tq2 & 0xff, sq, r - lane0, qlim, sc),
               subst(tq2 >> 8, sq, r - lane0 - 1, qlim, sc));
}

__device__ __forceinline__ int target_pair(const uint8_t* trow, int lane, int Lt) {
  return (lane < Lt ? (int)trow[lane] : 0) | ((lane + 1 < Lt ? (int)trow[lane + 1] : 0) << 8);
}


// The block route: one block per row, one thread per pair (T/2 rounded up
// to 32 threads). The per-row scalars are computed redundantly by every
// thread. Each wavefront publishes the old x, v, x2 words to shared memory
// for the lane t-1 neighbours (barrier 1), then the two H0 taps (barrier
// 2). The query sits in shared memory; the target bytes of a pair in a
// register.
__global__ void extd2_i16_block_kernel(const uint8_t* __restrict__ query,
                                       const uint8_t* __restrict__ target,
                                       const int32_t* __restrict__ qlens,
                                       const int32_t* __restrict__ tlens,
                                       const int32_t* __restrict__ bands,
                                       int32_t* __restrict__ score_out,
                                       uint8_t* __restrict__ dirs, int Lmax, int Lt,
                                       int T, int R, Scoring sc) {
  extern __shared__ uint32_t bsm[];
  const int NP = T / 2;
  uint32_t* sx = bsm;       // [NP] old x
  uint32_t* sv = sx + NP;   // [NP] old v
  uint32_t* sx2 = sv + NP;  // [NP] old x2
  int* taps = reinterpret_cast<int*>(sx2 + NP);  // [2] updated v[lt], u[lt+1]
  uint8_t* sq = reinterpret_cast<uint8_t*>(taps + 2);  // [Lmax] query

  const int n = blockIdx.x;
  const int t = threadIdx.x;  // the pair
  const bool pair = t < NP;
  const int lane0 = 2 * t;
  const int qlen = qlens[n];
  const int tlen = tlens != nullptr ? tlens[n] : qlen;
  const int w = bands[n];
  for (int i = t; i < Lmax; i += blockDim.x) sq[i] = query[(size_t)n * Lmax + i];

  const int qlim = min(qlen, Lmax);
  const int qe = sc.q + sc.e;
  const PairScoring ps = pair_scoring(sc.a, sc.q, sc.e, sc.q2, sc.e2);
  const uint32_t init = splat(-qe), init2 = splat(-(sc.q2 + sc.e2));
  uint32_t u = init, v = init, x = init, y = init, x2 = init2, y2 = init2, s = kBias;
  const int tq = pair ? target_pair(target + (size_t)n * Lt, lane0, Lt) : 0;
  int H0 = 0, lt = 0, last_st = -1, last_en = -1, score = kNegInf;
  uint16_t* drow = reinterpret_cast<uint16_t*>(dirs + (size_t)n * R * T);

  for (int r = 0; r < R; ++r) {
    const int st0 = max(max(0, r - qlen + 1), (r - w + 1) >> 1);
    const int en0 = min(min(tlen - 1, r), (r + w) >> 1);
    const bool live = (st0 <= en0) && (r < qlen + tlen - 1) && (qlen > 0);
    const int st = st0 & ~15;
    const int en = min(((en0 + 16) & ~15) - 1, T - 1);
    const bool prev_ok = (st > 0) && (st - 1 >= last_st) && (st - 1 <= last_en);
    const int bu = boundary_u(r, sc);

    if (pair) {
      sx[t] = x;
      sv[t] = v;
      sx2[t] = x2;
    }
    __syncthreads();  // barrier 1: old x/v/x2 visible (also the query)

    if (pair) {
      uint32_t dout = 0;
      if (live && (lane0 >> 1) == (r >> 1) && en >= r) {  // edge-lane init
        y = set_half(y, r & 1, init);
        y2 = set_half(y2, r & 1, init2);
        u = set_half(u, r & 1, splat(bu));
      }
      const int s_end = st0 + ((en0 - st0) & ~15) + 16;  // st0 + span16
      if (live)
        s = blend(span_mask(lane0, st0, s_end),
                  subst_pair(tq, sq, r, lane0, qlim, sc), s);
      if (live && lane0 >= st && lane0 <= en) {
        // the pair below (lane st's pair takes the boundary values in
        // its low half; its neighbour is read only where prev_ok)
        const int jp = t > 0 ? t - 1 : 0;
        uint32_t xp = prev_lanes(sx[jp], x), vp = prev_lanes(sv[jp], v),
                 x2p = prev_lanes(sx2[jp], x2);
        if (lane0 == st) {
          if (!prev_ok) {
            xp = set_half(xp, 0, init);
            x2p = set_half(x2p, 0, init2);
          }
          if (!(st > 0 && prev_ok)) vp = set_half(vp, 0, splat(st > 0 ? -qe : bu));
        }
        const PairOut o = pair_step(s, xp, vp, x2p, u, y, y2, ps);
        u = o.u;
        v = o.v;
        x = o.x;
        y = o.y;
        x2 = o.x2;
        y2 = o.y2;
        dout = o.d;
      }
      drow[(size_t)r * NP + t] = (uint16_t)dout;
      // H0 taps of the wavefront just computed
      const int l0 = min(max(lt, 0), T - 1), l1 = min(max(lt + 1, 0), T - 1);
      if (t == l0 >> 1) taps[0] = half(v, l0 & 1);
      if (t == l1 >> 1) taps[1] = half(u, l1 & 1);
    }
    __syncthreads();  // barrier 2: taps visible

    if (live) {
      const int v_lt = taps[0];
      const int u_lt1 = taps[1];
      if (r == 0) {  // lt == 0 here, so taps[0] is v[0]
        H0 = v_lt - qe;
        lt = 0;
      } else {
        const bool lt_in = lt >= st0 && lt <= en0;
        const bool lt1_in = lt + 1 >= st0 && lt + 1 <= en0;
        if (lt_in && lt1_in ? v_lt > u_lt1 : lt_in) {
          H0 += v_lt;
        } else {
          H0 += u_lt1;
          lt += 1;
        }
      }
      if (r == qlen + tlen - 2 && en0 == tlen - 1) score = H0;
      last_st = st;
      last_en = en;
    }
  }
  if (t == 0) score_out[n] = score;
}

template <class L>
size_t block_shared(int Lmax) {
  return (size_t)kWarps * L::RPW * query_bytes(Lmax);
}

template <class L>
int launch_lanes(const Args& g, const Launch& l, int warps, const Scoring& sc, cudaStream_t s) {
  const size_t shm = block_shared<L>(g.Lmax);
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_i16_warp_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_i16_warp_kernel<L><<<(warps + kWarps - 1) / kWarps, 32 * kWarps, shm, s>>>(g, l, sc);
  return (int)cudaGetLastError();
}

// the instance's resident blocks an SM, registers and local bytes a thread
template <class L>
int occupancy(int T, int Lmax, int32_t* out) {
  const size_t shm = block_shared<L>(Lmax);
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_i16_warp_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, extd2_i16_warp_kernel<L>, 32 * kWarps, shm);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, extd2_i16_warp_kernel<L>);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)shm;
  return 0;
}

// fn(Lanes<G, NS>{}) for the layout of W lanes (ops/extd2.py::I16_LAYOUTS)
template <class F>
int by_layout(int W, F&& fn) {
  switch (W) {
    case 64: return fn(Lanes<8, 4>{});
    case 128: return fn(Lanes<16, 4>{});
    case 160: return fn(Lanes<16, 5>{});
    case 192: return fn(Lanes<16, 6>{});
    case 256: return fn(Lanes<32, 4>{});
    case 512: return fn(Lanes<32, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points (bound with ctypes), with the arguments of csrc/extd2.cu's
// gdiet_extd2. Pointers are device pointers (dirs 16-byte aligned);
// scoring is the derived (a, b, q, e, q2, e2, long_thres, long_diff) of
// gdiet_tpu_torch/ops/dp.py::derive_scoring, inside safe_state_dtype's
// bound (the wrapper checks it). tlens may be null (= qlens). T =
// round16(Lt), R = Lmax + Lt - 1. Each launches on `stream` and returns a
// CUDA error code (0 on success).

// The block route, T in (512, 2048]: one block per row.
extern "C" int gdiet_extd2_i16(const void* query, const void* target,
                               const void* qlens, const void* tlens,
                               const void* bands, void* score, void* dirs,
                               int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                               int64_t R, int a, int b, int q, int e, int q2,
                               int e2, int long_thres, int long_diff,
                               void* stream) {
  if (N <= 0) return 0;
  if (T <= kMaxWarpLanes || T % 16 != 0 || T < Lt || R <= 0 || T > 2048 || N > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  const int threads = (int)((T / 2 + 31) / 32 * 32);
  const size_t shm = (3 * (size_t)(T / 2) + 2) * sizeof(uint32_t) + (size_t)Lmax;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_i16_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_i16_block_kernel<<<(unsigned)N, threads, shm, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(target),
      static_cast<const int32_t*>(qlens), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(bands), static_cast<int32_t*>(score),
      static_cast<uint8_t*>(dirs), (int)Lmax, (int)Lt, (int)T, (int)R, sc);
  return (int)cudaGetLastError();
}

// One launch of the warp route, T <= 512: one entry of
// ops/extd2.py::i16_full_plan. The layout of W lanes and G threads a row;
// its DP warps align the rows with tl_lo < round16(tlen) <= tl_hi (W < T
// only for rows that fit W: tl_hi <= W), `chunk` rows a DP warp below row
// `split` (head_warps of them), one round a warp from there; its leading
// zero_warps write the zero wavefronts and the dead rows. dp_warps +
// zero_warps warps in blocks of kWarps.
extern "C" int gdiet_extd2_i16_warp(const void* query, const void* target,
                                    const void* qlens, const void* tlens,
                                    const void* bands, void* score, void* dirs,
                                    int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                                    int64_t R, int a, int b, int q, int e, int q2,
                                    int e2, int long_thres, int long_diff, int W, int G,
                                    int tl_lo, int tl_hi, int chunk, int split,
                                    int head_warps, int zero_warps, int dp_warps,
                                    void* stream) {
  if (N <= 0) return 0;
  if (T <= 0 || T % 16 != 0 || T < Lt || R <= 0 || T > kMaxWarpLanes || N > 0x7fffffff ||
      (uintptr_t)dirs % 16 != 0 || (W < T && tl_hi > W) || chunk <= 0 || split < 0 ||
      split > N || head_warps < 0 || zero_warps < 0 || dp_warps < 0 ||
      zero_warps + dp_warps <= 0)
    return (int)cudaErrorInvalidValue;
  const Args g{static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(target),
               static_cast<const int32_t*>(qlens),  static_cast<const int32_t*>(tlens),
               static_cast<const int32_t*>(bands),  static_cast<int32_t*>(score),
               static_cast<uint8_t*>(dirs),         (int)N, (int)Lmax, (int)Lt, (int)T, (int)R};
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  const Launch l{tl_lo, tl_hi, chunk, split, head_warps, zero_warps};
  return by_layout(W, [&](auto lanes) {
    using L = decltype(lanes);
    if (G != L::G || chunk % L::RPW != 0) return (int)cudaErrorInvalidValue;
    return launch_lanes<L>(g, l, zero_warps + dp_warps, sc, (cudaStream_t)stream);
  });
}

// The warp route's instance of W lanes launched for rows of T lanes and a
// query budget of Lmax, on the current device: out[0] its resident blocks
// an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers a
// thread, out[2] local (spilled) bytes a thread, out[3] shared bytes a block.
extern "C" int gdiet_extd2_i16_resident(int64_t W, int64_t T, int64_t Lmax, int32_t* out) {
  return by_layout((int)W, [&](auto lanes) {
    return occupancy<decltype(lanes)>((int)T, (int)Lmax, out);
  });
}
