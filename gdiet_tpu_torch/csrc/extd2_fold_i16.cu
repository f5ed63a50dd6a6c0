// Time-folded DP with an int16 lane state, two lanes in each 32-bit
// register, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gdiet_tpu/ops/dp_pallas.py::_dp_kernel_fold
// (_dp_kernel_fold_body, driven by _extd2_fold) run with state_dtype =
// "int16" (sdt = int16: the seven lane-state arrays 16-bit, the per-row
// scalars int32). It computes exactly what
// gdiet_tpu_torch/ops/dp_fold.py::extd2_fold computes with
// state_dtype="int16", which under ops/dp.py::safe_state_dtype's bound is
// what csrc/extd2_fold.cu computes on the same row split: the fold
// semantics listed there (pass transition, both halves' edge lanes, the
// frontier reset of lane r+16 with the mixed target vector, the lane 0 and
// lane T-1 wraps, one H0 walk per half, band clamps at Tn) and the raw
// folded dirs[(C+1)*H][Nrows][T].
//
// Design: csrc/extd2_fold.cu's (one block per kernel row, one barrier per
// wavefront, each warp's last lane published double-buffered by the parity
// of r, the query byte loaded one wavefront ahead) on lane pairs
// (csrc/dp_pair.cuh): compute thread t of warp w holds pair j = w*32 + t,
// lanes 2j and 2j + 1, one offset-binary word per state array and the two
// target bytes in one register, so a block has the int32 kernel's T/2
// threads at about half its instructions per lane. The band starts
// (multiples of 16, A's at 0 and B's shifted by GAP = 32) are even and the
// band ends odd, so a pair is updated or kept as a whole; the edge lanes,
// the frontier reset, the band's first lanes (low halves) and the
// substitution spans act per half; the chain is dp_pair.cuh's pair_step,
// the two direction bytes one 16-bit store. The lane t-1 neighbours are the
// high half of pair j-1 (a __shfl_sync per state x, v, x2, lane 0 taking
// the warp before's published last pair) under the pair's own low half. The
// pass transition's 32-lane shift is 16 pairs, through shared memory (once
// per pass).
//
// The filler and walker warps (the block's last two). The row scalars of a
// wavefront (both halves' band limits, live flags, edge lanes and values,
// band-start fixups, substitution spans) are the same for every pair, and
// the H0 walk is a serial chain of its own (step r reads v at lane lt and u
// at lane lt + 1 of wavefront r's output and moves lt by 0 or 1). Every
// thread used to recompute both halves' scalars and walk both halves' H0
// each wavefront. Now the filler warp's lane h (0: half A, 1: half B; one
// formula for both, B's wavefront r + H and lanes + GAP) computes them
// once, one wavefront ahead, into a ring of kRing rows in shared memory
// (three 16-byte words a half), which the compute threads read with
// broadcast loads; and the walker warp's lane h walks its half's H0 two
// barriers behind the pair steps, from a tap ring to which each compute
// thread stores its pair's (v, u) after the step (one 8-byte store). Two
// warps, not one: one warp doing both finished its share of a wavefront
// after the compute warps on an H100 (the walk then cost ~10% of the
// kernel), as in csrc/extd2_band_i16.cu. Both take the block's one barrier
// a wavefront with the compute threads (plus one a pass, and one at the
// end for the last wavefront's taps), so the ring slots' reuse needs no
// other sync: a row slot is written in the interval before the one in
// which the compute threads first read it and rewritten four intervals
// later; a tap slot is read one interval after it is written.
//
// What bounds it on this card: as csrc/extd2_fold.cu, (C+1)*H serial
// wavefronts per kernel row and the instructions a row issues per
// wavefront; packing halves the chain's instructions per lane, and the
// filler and walker take the row scalars and the walks off the compute
// threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_pair.cuh"

namespace {

using namespace pair16;

constexpr int kNegInf = -0x40000000;
constexpr int kGap = 32;
constexpr int kGapPairs = kGap / 2;
constexpr unsigned kFull = 0xffffffffu;
// one pair a compute thread: on an H100 one ran faster than two (whose
// 64-register cap at 1,024 threads spills, and which at 512 threads leaves
// fewer warps to issue from), and the per-half fixups as branches taken by
// one pair faster than as mask blends in every pair
constexpr int kMaxThreads = 1024;

struct Scoring {
  int a, b, q, e, q2, e2, long_thres, long_diff;
};

__device__ __forceinline__ int boundary_u(int r, bool first, const Scoring& sc) {
  if (first && r == 0) return -(sc.q + sc.e);
  return r < sc.long_thres ? -sc.e : r == sc.long_thres ? sc.long_diff : -sc.e2;
}

// j in [lo, lo + n) (n = 0: never)
__device__ __forceinline__ bool in_range(int j, int lo, int n) {
  return (unsigned)(j - lo) < (unsigned)n;
}

// one half's H0 walk step (ksw2_extd2_sse.c:367-383) with the taps vl =
// v[lt], ul = u[min(lt+1, T-1)] of the wavefront it walks: the value added
// is max(vl, ul) when both lanes are in band, else the in-band one
__device__ __forceinline__ void h0_step(int vl, int ul, int st0, int en0, int& H0,
                                        int& lt) {
  const bool lt_in = lt >= st0 && lt <= en0;
  const bool lt1_in = lt + 1 >= st0 && lt + 1 <= en0;
  const bool stay = (lt_in && lt1_in) ? vl > ul : lt_in;
  H0 += (lt_in && lt1_in) ? max(vl, ul) : (lt_in ? vl : ul);
  lt = stay ? lt : lt + 1;
}

__device__ __forceinline__ int subst(int tk, int q, const Scoring& sc) {
  return ((tk == 4) | (q == 4)) ? -sc.e2 : (tk == q ? sc.a : -sc.b);
}

// one half's row scalars of a wavefront (the walker fills, the compute
// threads read): lanes are global (B's + GAP), -1 where none
struct HalfRow {
  int edge_lane;     // the edge-lane init: u takes edge_u, y and y2 the inits
  uint32_t edge_u;
  int bad_lane;      // the band's first lane: x, x2 take the inits
  int va_lane;       // its v takes va_val
  uint32_t va_val;
  int sp_st, sp_n;   // the substitution span [sp_st, sp_st + sp_n)
  int al_st;         // the updated lanes [al_st, al_st + al_n)
  int al_n;
  int st0, en0;      // the walk's band limits
  int flags;         // kLive | kFirst (wavefront 0) | kScoreTap
};
enum : int { kLive = 1, kFirst = 2, kScoreTap = 4 };
constexpr int kRing = 4;  // row slots: written one interval ahead, read over two

// the walker lane's half (h = 0: A, candidate (row, p); 1: B, (row, p-1))
struct Filler {
  int lst = -1, len = -1;  // the last live wavefront's band start and end
  int ql = 0, tl = 0, wb = 0;
  // the row of wavefront r of this pass; rr = r + h H, o = h GAP
  __device__ __forceinline__ HalfRow row(int rr, int o, int Tn, int qe, const Scoring& sc) {
    const int st0 = __vimax3_s32(0, rr - ql + 1, (rr - wb + 1) >> 1);
    const int en0 = __vimin3_s32(tl - 1, rr, (rr + wb) >> 1);
    const bool live = (st0 <= en0) && (rr < ql + tl - 1) && (ql > 0);
    const int st = (st0 & ~15) + o;
    const int en = min(((en0 + 16) & ~15) - 1, Tn - 1) + o;
    const bool prev_ok = (st > 0) && (st - 1 >= lst) && (st - 1 <= len);
    // B's wavefront is >= H > 0, so only A's wavefront 0 takes -(q + e)
    const int bu = boundary_u(rr, true, sc);
    HalfRow w;
    w.edge_lane = live && en >= rr + o ? rr + o : -1;
    w.edge_u = splat(bu);
    w.bad_lane = prev_ok ? -1 : st;
    w.va_lane = (st > 0 && prev_ok) ? -1 : st;  // B: st > 0, the bad lane, the init
    w.va_val = splat(st > 0 ? -qe : bu);
    w.sp_st = st0 + o;
    w.sp_n = live ? ((en0 - st0) & ~15) + 16 : 0;
    w.al_st = st;
    w.al_n = live ? en - st + 1 : 0;
    w.st0 = st0 + o;
    w.en0 = en0 + o;
    w.flags = (live ? kLive : 0) | (rr == 0 ? kFirst : 0) |
              (rr == ql + tl - 2 && en0 == tl - 1 ? kScoreTap : 0);
    if (live) {
      lst = st;
      len = en;
    }
    return w;
  }
};

__global__ void __launch_bounds__(kMaxThreads)
extd2_fold_i16_kernel(const uint8_t* __restrict__ query,
                      const uint8_t* __restrict__ target,
                      const int32_t* __restrict__ qlens,
                      const int32_t* __restrict__ tlens,
                      const int32_t* __restrict__ bands,
                      int32_t* __restrict__ score_out, uint8_t* __restrict__ dirs,
                      int N, int Lmax, int Lt, int T, int Tn, int H, int Nrows, int C,
                      Scoring sc) {
  extern __shared__ __align__(16) uint32_t fsm[];
  const int NP = T / 2;  // pairs, one a compute thread
  const int W = NP / 32;  // compute warps; the filler and walker warps follow
  HalfRow* rows = reinterpret_cast<HalfRow*>(fsm);          // [kRing][2]
  uint2* taps = reinterpret_cast<uint2*>(rows + 2 * kRing);  // [2][NP] (v, u) of each pair
  uint32_t* shb = reinterpret_cast<uint32_t*>(taps + 2 * NP);  // [8][NP] the pass shift's words
  uint32_t* xb = shb + 8 * NP;          // [2][W][3] each warp's last pair: x, v, x2
  uint8_t* sq = reinterpret_cast<uint8_t*>(xb + 2 * W * 3);  // [2][Lmax] A's, B's query
  uint8_t* stg = sq + 2 * Lmax;         // [T] the pass's (A's) target, 0 past Lt
  const int row = blockIdx.x;
  const int tid = threadIdx.x, t = tid & 31, w = tid >> 5;
  const int qe = sc.q + sc.e;

  if (w >= W) {
    // The filler warp (w == W) and the walker warp (w == W + 1): lane h
    // fills its half's rows, or walks its half's H0; the other lanes only
    // take the barriers. Barrier order (the compute threads'): per pass
    // one after the loads, then one a wavefront; one at the end.
    const bool fills = w == W;
    const int h = t & 1;
    const bool on = t < 2;
    const int o = h * kGap;
    Filler fl;
    int H0 = 0, lt = 0, sco = kNegInf;
    // walk wavefront r of pass p (its taps in slot g & 1, its row in slot g % kRing)
    auto walk = [&](int p, int r) {
      const int g = p * H + r;
      const HalfRow& rw = rows[(g % kRing) * 2 + h];
      if (!(rw.flags & kLive)) return;
      const uint2* tp = taps + (g & 1) * NP;
      const int la = min(max(lt, 0), T - 1), la1 = min(la + 1, T - 1);
      const int vl = half(tp[la >> 1].x, la & 1), ul = half(tp[la1 >> 1].y, la1 & 1);
      if (rw.flags & kFirst) {  // lt == 0 here, so the tap is v[0]
        H0 = vl - qe;
        lt = 0;
      } else {
        h0_step(vl, ul, rw.st0, rw.en0, H0, lt);
      }
      if (rw.flags & kScoreTap) sco = H0;
    };
    auto fill = [&](int p, int r) {
      rows[((p * H + r) % kRing) * 2 + h] = fl.row(r + h * H, o, Tn, qe, sc);
    };
    for (int p = 0; p <= C; ++p) {
      if (fills) {  // the pass transition: B takes A's half, A the new row
        const int n = p * Nrows + row;
        const int ql = n < N ? qlens[n] : 0;
        const int wb = n < N ? bands[n] : 0;
        const int tl = n < N ? (tlens != nullptr ? tlens[n] : ql) : 0;
        const int lst = __shfl_sync(kFull, fl.lst, t & ~1), len = __shfl_sync(kFull, fl.len, t & ~1);
        const int pql = __shfl_sync(kFull, fl.ql, t & ~1), ptl = __shfl_sync(kFull, fl.tl, t & ~1);
        const int pwb = __shfl_sync(kFull, fl.wb, t & ~1);
        if (h == 0) {
          fl = Filler{-1, -1, ql, tl, wb};
        } else if (p > 0) {
          fl = Filler{lst + kGap, len + kGap, pql, ptl, pwb};
        }
        if (on) fill(p, 0);
      } else if (on && p > 0) {
        walk(p - 1, H - 2);
      }
      __syncthreads();  // the pass's loads
      for (int r = 0; r < H; ++r) {
        if (fills) {
          if (on && r + 1 < H) fill(p, r + 1);
        } else {
          if (r == 0 && p > 0) {  // pass p - 1's last wavefront, then its B score
            if (on) walk(p - 1, H - 1);
            const int sa = __shfl_sync(kFull, sco, t & ~1);
            if (t == 1) score_out[(size_t)(p - 1) * Nrows + row] = sco;
            const int h0a = __shfl_sync(kFull, H0, t & ~1), lta = __shfl_sync(kFull, lt, t & ~1);
            if (h == 0) {
              H0 = 0;
              lt = 0;
              sco = kNegInf;
            } else {
              H0 = h0a;
              lt = lta + kGap;
              sco = sa;
            }
          }
          if (on && r >= 2) walk(p, r - 2);
        }
        __syncthreads();  // wavefront r
      }
    }
    if (!fills && on) walk(C, H - 2);
    __syncthreads();  // the last wavefront's taps
    if (!fills) {
      if (on) walk(C, H - 1);
      if (t == 1) score_out[(size_t)C * Nrows + row] = sco;
    }
    return;
  }

  const int j = tid;  // the pair
  const int lane0 = 2 * j;
  const PairScoring ps = pair_scoring(sc.a, sc.q, sc.e, sc.q2, sc.e2);
  const uint32_t init = splat(-qe), init2 = splat(-(sc.q2 + sc.e2));
  // qv: the pair's query bytes at the next wavefront (A's, else B's), the
  // low lane's in bits 0-7 and the high lane's in bits 8-15; tm: its mixed
  // target bytes, likewise
  uint32_t u = init, v = init, x = init, y = init, x2 = init2, y2 = init2, s = kBias;
  int tm = 0, qv;
  int qla = 0, qlb = 0;  // qlen 0 = dead

  for (int p = 0; p <= C; ++p) {
    const int n = p * Nrows + row;
    const bool real = n < N;  // n < N implies p < C
    uint8_t* sqa = sq + (p & 1) * Lmax;
    const uint8_t* sqb = sq + ((p + 1) & 1) * Lmax;  // last pass's A query
    for (int i = tid; i < Lmax; i += NP) sqa[i] = real ? query[(size_t)n * Lmax + i] : 0;
    for (int i = tid; i < T; i += NP) stg[i] = (real && i < Lt) ? target[(size_t)n * Lt + i] : 0;
    if (p > 0) {  // every pair's words, for the pair GAP lanes above it
      shb[0 * NP + j] = u;
      shb[1 * NP + j] = v;
      shb[2 * NP + j] = x;
      shb[3 * NP + j] = y;
      shb[4 * NP + j] = x2;
      shb[5 * NP + j] = y2;
      shb[6 * NP + j] = s;
      shb[7 * NP + j] = (uint32_t)tm;
    }
    __syncthreads();  // the pass's query and target, the pairs' words
    if (p > 0 && j >= kGapPairs) {  // pass transition: every pair takes the one GAP lanes below
      const int src = j - kGapPairs;
      u = shb[0 * NP + src];
      v = shb[1 * NP + src];
      x = shb[2 * NP + src];
      y = shb[3 * NP + src];
      x2 = shb[4 * NP + src];
      y2 = shb[5 * NP + src];
      s = shb[6 * NP + src];
      tm = (int)shb[7 * NP + src];
    } else {  // lanes < GAP (and the first pass): the init values and A's target
      if (p > 0) {
        u = v = x = y = init;
        x2 = y2 = init2;
        s = kBias;
      }
      tm = stg[2 * j] | (stg[2 * j + 1] << 8);
    }
    qlb = qla;
    qla = real ? qlens[n] : 0;
    const int qlima = min(qla, Lmax), qlimb = min(qlb, Lmax);
    // A reads query[r - lane], B reads query[rB + GAP - lane]; both loads
    // clamp into the buffers and the lane takes A's byte where A's index
    // is in its read, else B's where B's is, else 0
    const int ob = H + kGap;
    auto query_byte = [&](int ia) {
      const int ib = ia + ob;
      const int qa = sqa[__vimin_s32_relu(ia, Lmax - 1)];
      const int qb = sqb[__vimin_s32_relu(ib, Lmax - 1)];
      return in_range(ia, 0, qlima) ? qa : (in_range(ib, 0, qlimb) ? qb : 0);
    };
    auto query_pair = [&](int r) {  // the pair's query bytes at wavefront r
      return query_byte(r - lane0) | (query_byte(r - lane0 - 1) << 8);
    };
    qv = query_pair(0);
    uint8_t* drow = dirs + ((size_t)p * H * Nrows + row) * T;

    for (int r = 0; r < H; ++r, drow += (size_t)Nrows * T) {
      const int g = p * H + r;
      const HalfRow* rw = rows + (g % kRing) * 2;
      const int4 a0 = reinterpret_cast<const int4*>(rw)[0];  // A: edge, edge_u, bad, va
      const int4 a1 = reinterpret_cast<const int4*>(rw)[1];  // va_val, sp_st, sp_n, al_st
      const int a_al_n = rw[0].al_n;
      const int4 b0 = reinterpret_cast<const int4*>(rw + 1)[0];
      const int4 b1 = reinterpret_cast<const int4*>(rw + 1)[1];
      const int b_al_n = rw[1].al_n;
      uint32_t* xo = xb + 3 * W * (r & 1);
      const int r16 = r + 16;  // the frontier reset
      const int tn16 = stg[min(r16, T - 1)];

      // edge-lane init for both halves, then the frontier reset (before
      // the neighbours are read: they see the reset lane)
      uint32_t uk = u, yk = y, y2k = y2, vk = v, xk = x, x2k = x2, sk = s;
      int tk = tm;
      if (j == a0.x >> 1) {
        uk = set_half(uk, a0.x & 1, (uint32_t)a0.y);
        yk = set_half(yk, a0.x & 1, init);
        y2k = set_half(y2k, a0.x & 1, init2);
      }
      if (j == b0.x >> 1) {
        uk = set_half(uk, b0.x & 1, (uint32_t)b0.y);
        yk = set_half(yk, b0.x & 1, init);
        y2k = set_half(y2k, b0.x & 1, init2);
      }
      if (j == r16 >> 1) {
        const int hh = r16 & 1;
        uk = set_half(uk, hh, init);
        yk = set_half(yk, hh, init);
        y2k = set_half(y2k, hh, init2);
        vk = set_half(vk, hh, init);
        xk = set_half(xk, hh, init);
        x2k = set_half(x2k, hh, init2);
        sk = set_half(sk, hh, kBias);
        tk = hh ? (tk & 0xff) | (tn16 << 8) : (tk & 0xff00) | tn16;
      }
      // the old x, v, x2 of the warp's last pair, after the frontier reset
      if (t == 31) {
        xo[3 * w + 0] = xk;
        xo[3 * w + 1] = vk;
        xo[3 * w + 2] = x2k;
      }
      __syncthreads();  // the one barrier of a wavefront
      // pair 31 of the warp before (old words)
      uint32_t cx = 0, cv = 0, cx2 = 0;
      if (w > 0) {
        cx = xo[3 * (w - 1) + 0];
        cv = xo[3 * (w - 1) + 1];
        cx2 = xo[3 * (w - 1) + 2];
      }
      const uint32_t rx = __shfl_sync(kFull, xk, (t + 31) & 31);
      const uint32_t rv = __shfl_sync(kFull, vk, (t + 31) & 31);
      const uint32_t rx2 = __shfl_sync(kFull, x2k, (t + 31) & 31);
      uint32_t xp = prev_lanes(t == 0 ? cx : rx, xk);
      uint32_t vp = prev_lanes(t == 0 ? cv : rv, vk);
      uint32_t x2p = prev_lanes(t == 0 ? cx2 : rx2, x2k);
      // lanes st of both halves are low halves
      if (j == a0.z >> 1 || j == b0.z >> 1) {
        xp = set_half(xp, 0, init);
        x2p = set_half(x2p, 0, init2);
      }
      if (j == a0.w >> 1) vp = set_half(vp, 0, (uint32_t)a1.x);
      if (j == b0.w >> 1) vp = set_half(vp, 0, (uint32_t)b1.x);
      // substitution scores for both halves' 16-blocks
      const uint32_t sval = pack2(subst(tk & 0xff, qv & 0xff, sc), subst(tk >> 8, qv >> 8, sc));
      const uint32_t skk = blend(span_mask(lane0, a1.y, a1.y + a1.z) |
                                 span_mask(lane0, b1.y, b1.y + b1.z), sval, sk);
      const bool in_al = in_range(lane0, a1.w, a_al_n) | in_range(lane0, b1.w, b_al_n);
      const PairOut po = pair_step(skk, xp, vp, x2p, uk, yk, y2k, ps);
      u = in_al ? po.u : uk;
      v = in_al ? po.v : vk;
      x = in_al ? po.x : xk;
      y = in_al ? po.y : yk;
      x2 = in_al ? po.x2 : x2k;
      y2 = in_al ? po.y2 : y2k;
      s = skk;
      tm = tk;
      reinterpret_cast<uint16_t*>(drow)[j] = in_al ? (uint16_t)po.d : (uint16_t)0;
      taps[(g & 1) * NP + j] = make_uint2(v, u);  // for the walker, two barriers on
      qv = query_pair(r + 1);
    }
  }
  __syncthreads();  // the last wavefront's taps, for the walker
}

}  // namespace

// C entry point (bound with ctypes), the arguments of csrc/extd2_fold.cu's
// gdiet_extd2_fold. Pointers are device pointers; scoring is the derived
// (a, b, q, e, q2, e2, long_thres, long_diff) of
// gdiet_tpu_torch/ops/dp.py::derive_scoring, inside safe_state_dtype's
// bound (the wrapper checks it); (T, Tn, H, Nrows, C) come from
// ops/dp_fold.py's fold_geometry and fold_split(state_dtype="int16"). tlens
// may be null (= qlens). score holds (C+1)*Nrows entries, dirs
// (C+1)*H*Nrows*T bytes. One block per kernel row: T / 2 compute threads
// and the filler and walker warps.
// Launches on `stream` and returns a CUDA error code (0 on success).
extern "C" int gdiet_extd2_fold_i16(const void* query, const void* target,
                                    const void* qlens, const void* tlens,
                                    const void* bands, void* score, void* dirs,
                                    int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                                    int64_t Tn, int64_t H, int64_t Nrows, int64_t C,
                                    int a, int b, int q, int e, int q2, int e2,
                                    int long_thres, int long_diff, void* stream) {
  if (Nrows <= 0) return 0;
  if (T <= 0 || T % 64 != 0 || T / 2 + 64 > kMaxThreads || T < Lt + kGap + 16 || H < Lmax ||
      H < 2)
    return (int)cudaErrorInvalidValue;
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  const int NP = (int)(T / 2), W = NP / 32;
  // the row ring, the tap ring, the shift words, the warps' last pairs,
  // the two queries and the target
  const size_t shm = 2 * kRing * sizeof(HalfRow) + 2 * (size_t)NP * sizeof(uint2) +
                     (8 * (size_t)NP + 2 * W * 3) * sizeof(uint32_t) + 2 * (size_t)Lmax +
                     (size_t)T;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_fold_i16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_fold_i16_kernel<<<(unsigned)Nrows, (unsigned)(NP + 64), shm, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(target),
      static_cast<const int32_t*>(qlens), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(bands), static_cast<int32_t*>(score),
      static_cast<uint8_t*>(dirs), (int)N, (int)Lmax, (int)Lt, (int)T, (int)Tn,
      (int)H, (int)Nrows, (int)C, sc);
  return (int)cudaGetLastError();
}
