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
// wavefront, each warp's last lane and the H0 taps published double-
// buffered by the parity of r, the walks one wavefront behind in every
// thread, the query byte loaded one wavefront ahead) on lane pairs
// (csrc/dp_pair.cuh): thread t of warp w holds pair j = w*32 + t, lanes 2j
// and 2j + 1, one offset-binary word per state array and the two target
// bytes in one register, so a block has the int32 kernel's T/2 threads at
// about half its instructions per lane. The band starts (multiples of 16,
// A's at 0 and B's shifted by GAP = 32) are even and the band ends odd, so a
// pair is updated or kept as a whole; the edge lanes, the frontier reset,
// the band's first lanes (low halves) and the substitution spans act per
// half; the chain is dp_pair.cuh's pair_step, the two direction bytes one
// 16-bit store. The lane t-1 neighbours are the high half of pair j-1 (a
// __shfl_sync per state x, v, x2, lane 0 taking the warp before's published
// last pair) under the pair's own low half. The pass transition's 32-lane
// shift is 16 pairs, through shared memory (once per pass).
//
// What bounds it on this card: as csrc/extd2_fold.cu, (C+1)*H serial
// wavefronts per kernel row and the instructions a row issues per
// wavefront; packing halves the chain's instructions per lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_pair.cuh"

namespace {

using namespace pair16;

constexpr int kNegInf = -0x40000000;
constexpr int kGap = 32;
constexpr int kGapPairs = kGap / 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 1024;
// pairs per thread (lane pairs j = (w * kSlots + k) * 32 + t): on an H100
// one ran faster than two (whose 64-register cap at 1,024 threads spills,
// and which at 512 threads leaves fewer warps to issue from), and the
// per-half fixups as branches taken by one pair faster than as mask blends
// in every pair (the full width's warp route, one warp per row, the other
// way round)
constexpr int kSlots = 1;

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

template <int NSW>
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
  const int W = blockDim.x >> 5;
  const int NP = T / 2;  // pairs
  uint32_t* shb = fsm;                  // [8][NP] the pass shift's words
  uint32_t* xb = shb + 8 * NP;          // [2][W][3] each warp's last pair: x, v, x2
  int* tapb = reinterpret_cast<int*>(xb + 2 * W * 3);  // [2][4] H0 taps: A's v, u; B's v, u
  uint8_t* sq = reinterpret_cast<uint8_t*>(tapb + 8);  // [2][Lmax] A's, B's query
  uint8_t* stg = sq + 2 * Lmax;         // [T] the pass's (A's) target, 0 past Lt
  const int row = blockIdx.x;
  const int tid = threadIdx.x, t = tid & 31, w = tid >> 5;
  const int j0 = w * NSW * 32 + t;  // slot k holds pair j0 + 32 k
  const int qe = sc.q + sc.e;
  const PairScoring ps = pair_scoring(sc.a, sc.q, sc.e, sc.q2, sc.e2);
  const uint32_t init = splat(-qe), init2 = splat(-(sc.q2 + sc.e2));
  // qv: the pair's query bytes at the next wavefront (A's, else B's), the
  // low lane's in bits 0-7 and the high lane's in bits 8-15; tm: its mixed
  // target bytes, likewise
  uint32_t u[NSW], v[NSW], x[NSW], y[NSW], x2[NSW], y2[NSW], s[NSW];
  int tm[NSW], qv[NSW];
#pragma unroll
  for (int k = 0; k < NSW; ++k) {
    u[k] = v[k] = x[k] = y[k] = init;
    x2[k] = y2[k] = init2;
    s[k] = kBias;  // 0
  }
  // row scalars: A = candidate (row, p), B = candidate (row, p-1); qlen 0 = dead
  int H0a = 0, lta = 0, lsta = -1, lena = -1, scoa = kNegInf, qla = 0, wba = 0, tla = 0;
  int H0b = 0, ltb = 0, lstb = -1, lenb = -1, scob = kNegInf, qlb = 0, wbb = 0, tlb = 0;

  for (int p = 0; p <= C; ++p) {
    const int n = p * Nrows + row;
    const bool real = n < N;  // n < N implies p < C
    uint8_t* sqa = sq + (p & 1) * Lmax;
    const uint8_t* sqb = sq + ((p + 1) & 1) * Lmax;  // last pass's A query
    for (int i = tid; i < Lmax; i += blockDim.x)
      sqa[i] = real ? query[(size_t)n * Lmax + i] : 0;
    for (int i = tid; i < T; i += blockDim.x)
      stg[i] = (real && i < Lt) ? target[(size_t)n * Lt + i] : 0;
    if (p > 0) {  // every pair's words, for the pair GAP lanes above it
#pragma unroll
      for (int k = 0; k < NSW; ++k) {
        const int j = j0 + 32 * k;
        shb[0 * NP + j] = u[k];
        shb[1 * NP + j] = v[k];
        shb[2 * NP + j] = x[k];
        shb[3 * NP + j] = y[k];
        shb[4 * NP + j] = x2[k];
        shb[5 * NP + j] = y2[k];
        shb[6 * NP + j] = s[k];
        shb[7 * NP + j] = (uint32_t)tm[k];
      }
    }
    __syncthreads();  // the pass's query and target, the pairs' words
    if (p > 0) {  // pass transition: every pair takes the one GAP lanes below
#pragma unroll
      for (int k = 0; k < NSW; ++k) {
        const int j = j0 + 32 * k;
        if (j >= kGapPairs) {
          const int src = j - kGapPairs;
          u[k] = shb[0 * NP + src];
          v[k] = shb[1 * NP + src];
          x[k] = shb[2 * NP + src];
          y[k] = shb[3 * NP + src];
          x2[k] = shb[4 * NP + src];
          y2[k] = shb[5 * NP + src];
          s[k] = shb[6 * NP + src];
          tm[k] = (int)shb[7 * NP + src];
        } else {  // lanes < GAP: the init values and A's target
          u[k] = v[k] = x[k] = y[k] = init;
          x2[k] = y2[k] = init2;
          s[k] = kBias;
          tm[k] = stg[2 * j] | (stg[2 * j + 1] << 8);
        }
      }
      H0b = H0a;
      ltb = lta + kGap;
      lstb = lsta + kGap;
      lenb = lena + kGap;
      scob = scoa;
      qlb = qla;
      wbb = wba;
      tlb = tla;
    } else {
#pragma unroll
      for (int k = 0; k < NSW; ++k) {
        const int j = j0 + 32 * k;
        tm[k] = stg[2 * j] | (stg[2 * j + 1] << 8);
      }
    }
    H0a = 0;
    lta = 0;
    lsta = -1;
    lena = -1;
    scoa = kNegInf;
    qla = real ? qlens[n] : 0;
    wba = real ? bands[n] : 0;
    tla = real ? (tlens != nullptr ? tlens[n] : qla) : 0;
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
    auto query_pair = [&](int r, int lane0) {  // a pair's query bytes at wavefront r
      return query_byte(r - lane0) | (query_byte(r - lane0 - 1) << 8);
    };
#pragma unroll
    for (int k = 0; k < NSW; ++k) qv[k] = query_pair(0, 2 * (j0 + 32 * k));
    uint8_t* drow = dirs + ((size_t)p * H * Nrows + row) * T;
    // the H0 walks run one wavefront behind: wavefront r publishes the
    // taps of r-1 before its pairs update the lanes and walks r-1 after
    // them. pa/pb: wavefront r-1's halves live; its st0, en0 (global lanes)
    bool pa = false, pb = false;
    int p_st0a = 0, p_en0a = 0, p_st0bg = 0, p_en0bg = 0;
    auto publish_taps = [&](int* tb) {
      const int la = min(max(lta, 0), T - 1), lb = min(max(ltb, 0), T - 1);
      const int la1 = min(la + 1, T - 1), lb1 = min(lb + 1, T - 1);
#pragma unroll
      for (int k = 0; k < NSW; ++k) {
        const int j = j0 + 32 * k;
        if (pa && j == la >> 1) tb[0] = half(v[k], la & 1);
        if (pa && j == la1 >> 1) tb[1] = half(u[k], la1 & 1);
        if (pb && j == lb >> 1) tb[2] = half(v[k], lb & 1);
        if (pb && j == lb1 >> 1) tb[3] = half(u[k], lb1 & 1);
      }
    };
    // walk wavefront rw = r-1 on its taps va/ua (A's v, u) and vb/ub (B's)
    auto walk = [&](int va, int ua, int vb, int ub, int rw) {
      if (pa) {
        if (rw == 0) {  // lta == 0 here, so the tap is v[0]
          H0a = va - qe;
          lta = 0;
        } else {
          h0_step(va, ua, p_st0a, p_en0a, H0a, lta);
        }
        if (rw == qla + tla - 2 && p_en0a == tla - 1) scoa = H0a;
      }
      if (pb) {
        h0_step(vb, ub, p_st0bg, p_en0bg, H0b, ltb);
        if (rw + H == qlb + tlb - 2 && p_en0bg - kGap == tlb - 1) scob = H0b;
      }
    };

    for (int r = 0; r < H; ++r, drow += (size_t)Nrows * T) {
      const int par = r & 1;
      int* tb = tapb + 4 * par;
      uint32_t* xo = xb + 3 * W * par;
      const int rB = r + H;
      // first half (A): local == global lanes
      const int st0a = __vimax3_s32(0, r - qla + 1, (r - wba + 1) >> 1);
      const int en0a = __vimin3_s32(tla - 1, r, (r + wba) >> 1);
      const bool livea = (st0a <= en0a) && (r < qla + tla - 1) && (qla > 0);
      const int sta = st0a & ~15;
      const int ena = min(((en0a + 16) & ~15) - 1, Tn - 1);
      // second half (B): global = local + GAP
      const int st0b = __vimax3_s32(0, rB - qlb + 1, (rB - wbb + 1) >> 1);
      const int en0b = __vimin3_s32(tlb - 1, rB, (rB + wbb) >> 1);
      const bool liveb = (st0b <= en0b) && (rB < qlb + tlb - 1) && (qlb > 0);
      const int stb = (st0b & ~15) + kGap;
      const int enb = min(((en0b + 16) & ~15) - 1, Tn - 1) + kGap;
      const int st0bg = st0b + kGap, en0bg = en0b + kGap;
      const bool prev_oka = (sta > 0) && (sta - 1 >= lsta) && (sta - 1 <= lena);
      const bool prev_okb = (stb - 1 >= lstb) && (stb - 1 <= lenb);
      const int bu = boundary_u(r, true, sc);
      const int bub = boundary_u(rB, false, sc);
      // the lanes where this wavefront acts (-1: none; -1 >> 1 is no pair)
      const int ea_lane = livea && ena >= r ? r : -1;  // edge-lane init
      const int eb_lane = liveb && enb >= rB + kGap ? rB + kGap : -1;
      const int r16 = r + 16;  // the frontier reset
      const int tn16 = stg[min(r16, T - 1)];
      const int bad_a = prev_oka ? -1 : sta;  // x, x2 take the init values
      const int bad_b = prev_okb ? -1 : stb;
      const int va_lane = (sta > 0 && prev_oka) ? -1 : sta;  // v takes va_val
      const uint32_t va_val = splat(sta > 0 ? -qe : bu);
      const int sa_n = livea ? ((en0a - st0a) & ~15) + 16 : 0;  // score spans
      const int sb_n = liveb ? ((en0b - st0b) & ~15) + 16 : 0;
      const int ala_n = livea ? ena - sta + 1 : 0;  // updated lanes
      const int alb_n = liveb ? enb - stb + 1 : 0;

      // edge-lane init for both halves, then the frontier reset (before
      // the neighbours are read: they see the reset lane)
      uint32_t uk[NSW], yk[NSW], y2k[NSW], vk[NSW], xk[NSW], x2k[NSW], sk[NSW];
      int tk[NSW];
#pragma unroll
      for (int k = 0; k < NSW; ++k) {
        const int j = j0 + 32 * k;
        uk[k] = u[k];
        yk[k] = y[k];
        y2k[k] = y2[k];
        vk[k] = v[k];
        xk[k] = x[k];
        x2k[k] = x2[k];
        sk[k] = s[k];
        tk[k] = tm[k];
        if (j == ea_lane >> 1) {
          uk[k] = set_half(uk[k], ea_lane & 1, splat(bu));
          yk[k] = set_half(yk[k], ea_lane & 1, init);
          y2k[k] = set_half(y2k[k], ea_lane & 1, init2);
        }
        if (j == eb_lane >> 1) {
          uk[k] = set_half(uk[k], eb_lane & 1, splat(bub));
          yk[k] = set_half(yk[k], eb_lane & 1, init);
          y2k[k] = set_half(y2k[k], eb_lane & 1, init2);
        }
        if (j == r16 >> 1) {
          const int h = r16 & 1;
          uk[k] = set_half(uk[k], h, init);
          yk[k] = set_half(yk[k], h, init);
          y2k[k] = set_half(y2k[k], h, init2);
          vk[k] = set_half(vk[k], h, init);
          xk[k] = set_half(xk[k], h, init);
          x2k[k] = set_half(x2k[k], h, init2);
          sk[k] = set_half(sk[k], h, kBias);
          tk[k] = h ? (tk[k] & 0xff) | (tn16 << 8) : (tk[k] & 0xff00) | tn16;
        }
      }

      publish_taps(tb);
      // the old x, v, x2 of the warp's last pair, after the frontier reset
      if (t == 31) {
        xo[3 * w + 0] = xk[NSW - 1];
        xo[3 * w + 1] = vk[NSW - 1];
        xo[3 * w + 2] = x2k[NSW - 1];
      }
      __syncthreads();  // the one barrier of a wavefront
      // pair 31 of the previous slot (old words); slot 0 takes the warp
      // before's last pair
      uint32_t cx = 0, cv = 0, cx2 = 0;
      if (w > 0) {
        cx = xo[3 * (w - 1) + 0];
        cv = xo[3 * (w - 1) + 1];
        cx2 = xo[3 * (w - 1) + 2];
      }
      const int tva = tb[0], tua = tb[1], tvb = tb[2], tub = tb[3];

#pragma unroll
      for (int k = 0; k < NSW; ++k) {
        const int j = j0 + 32 * k;
        const int lane0 = 2 * j;
        const uint32_t rx = __shfl_sync(kFull, xk[k], (t + 31) & 31);
        const uint32_t rv = __shfl_sync(kFull, vk[k], (t + 31) & 31);
        const uint32_t rx2 = __shfl_sync(kFull, x2k[k], (t + 31) & 31);
        uint32_t xp = prev_lanes(t == 0 ? cx : rx, xk[k]);
        uint32_t vp = prev_lanes(t == 0 ? cv : rv, vk[k]);
        uint32_t x2p = prev_lanes(t == 0 ? cx2 : rx2, x2k[k]);
        cx = rx;
        cv = rv;
        cx2 = rx2;
        // lanes st of both halves are low halves
        if (j == bad_a >> 1 || j == bad_b >> 1) {
          xp = set_half(xp, 0, init);
          x2p = set_half(x2p, 0, init2);
        }
        if (j == va_lane >> 1) vp = set_half(vp, 0, va_val);
        if (j == bad_b >> 1) vp = set_half(vp, 0, init);
        // substitution scores for both halves' 16-blocks
        const int q2b = qv[k];
        const uint32_t sval = pack2(subst(tk[k] & 0xff, q2b & 0xff, sc),
                                    subst(tk[k] >> 8, q2b >> 8, sc));
        const uint32_t skk = blend(span_mask(lane0, st0a, st0a + sa_n) |
                                   span_mask(lane0, st0bg, st0bg + sb_n), sval, sk[k]);
        const bool in_al = in_range(lane0, sta, ala_n) | in_range(lane0, stb, alb_n);
        const PairOut o = pair_step(skk, xp, vp, x2p, uk[k], yk[k], y2k[k], ps);
        u[k] = in_al ? o.u : uk[k];
        v[k] = in_al ? o.v : vk[k];
        x[k] = in_al ? o.x : xk[k];
        y[k] = in_al ? o.y : yk[k];
        x2[k] = in_al ? o.x2 : x2k[k];
        y2[k] = in_al ? o.y2 : y2k[k];
        s[k] = skk;
        tm[k] = tk[k];
        reinterpret_cast<uint16_t*>(drow)[j] = in_al ? (uint16_t)o.d : (uint16_t)0;
        qv[k] = query_pair(r + 1, lane0);
      }

      walk(tva, tua, tvb, tub, r - 1);
      pa = livea;
      pb = liveb;
      p_st0a = st0a;
      p_en0a = en0a;
      p_st0bg = st0bg;
      p_en0bg = en0bg;
      if (livea) {
        lsta = sta;
        lena = ena;
      }
      if (liveb) {
        lstb = stb;
        lenb = enb;
      }
    }
    {  // the pass's last wavefront's walks
      int* tb = tapb + 4 * (H & 1);
      publish_taps(tb);
      __syncthreads();
      walk(tb[0], tb[1], tb[2], tb[3], H - 1);
    }
    // the pass's second-half candidate (row, p-1) just completed
    if (tid == 0) score_out[(size_t)p * Nrows + row] = scob;
  }
}

}  // namespace

// C entry point (bound with ctypes), the arguments of csrc/extd2_fold.cu's
// gdiet_extd2_fold. Pointers are device pointers; scoring is the derived
// (a, b, q, e, q2, e2, long_thres, long_diff) of
// gdiet_tpu_torch/ops/dp.py::derive_scoring, inside safe_state_dtype's
// bound (the wrapper checks it); (T, Tn, H, Nrows, C) come from
// ops/dp_fold.py's fold_geometry and fold_split(state_dtype="int16"). tlens
// may be null (= qlens). score holds (C+1)*Nrows entries, dirs
// (C+1)*H*Nrows*T bytes. One block of T / 2 threads per kernel row.
// Launches on `stream` and returns a CUDA error code (0 on success).
extern "C" int gdiet_extd2_fold_i16(const void* query, const void* target,
                                    const void* qlens, const void* tlens,
                                    const void* bands, void* score, void* dirs,
                                    int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                                    int64_t Tn, int64_t H, int64_t Nrows, int64_t C,
                                    int a, int b, int q, int e, int q2, int e2,
                                    int long_thres, int long_diff, void* stream) {
  if (Nrows <= 0) return 0;
  if (T <= 0 || T % (64 * kSlots) != 0 || T / (2 * kSlots) > kMaxThreads ||
      T < Lt + kGap + 16 || H < Lmax)
    return (int)cudaErrorInvalidValue;
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  const int threads = (int)(T / (2 * kSlots));
  const int W = threads / 32;
  const size_t shm = (4 * (size_t)T + 2 * W * 3 + 8) * sizeof(uint32_t) +
                     2 * (size_t)Lmax + (size_t)T;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_fold_i16_kernel<kSlots>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_fold_i16_kernel<kSlots><<<(unsigned)Nrows, (unsigned)threads, shm, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(target),
      static_cast<const int32_t*>(qlens), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(bands), static_cast<int32_t*>(score),
      static_cast<uint8_t*>(dirs), (int)N, (int)Lmax, (int)Lt, (int)T, (int)Tn,
      (int)H, (int)Nrows, (int)C, sc);
  return (int)cudaGetLastError();
}
