// Time-folded batched banded dual affine-gap extension (ksw_extd2,
// approx-max H0) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gdiet_tpu/ops/dp_pallas.py::_dp_kernel_fold
// (_dp_kernel_fold_body, driven by _extd2_fold). It computes exactly what
// gdiet_tpu_torch/ops/dp_fold.py::extd2_fold computes: the recurrence of
// csrc/extd2.cu, with two candidates sharing each kernel row. Row k runs a
// pipeline of candidates n = p*Nrows + k, p = 0..C-1, plus a drain pass C.
// In pass p the first half A = (k, p) takes its wavefronts [0, H) at lanes
// from 0 up, and the second half B = (k, p-1) takes its wavefronts [H, 2H)
// at lanes shifted up by GAP = 32. The lane footprints of the two halves are
// disjoint (H >= Lmax), so one set of lane state serves both. The fold
// semantics carried over bit for bit:
//   - the pass transition rolls the lane state (and the mixed target
//     vector) up by GAP, resets lanes < GAP, and turns A's row scalars into
//     B's, with +GAP on the lane coordinates lt, last_st, last_en;
//   - the edge-lane init runs for both halves (t == r and t == rB + GAP);
//   - the frontier reset returns lane r+16 to its init values and flips its
//     target byte from B's candidate to A's;
//   - the lane t-1 neighbour of lane 0 is lane T-1 (the TPU lane rotate
//     wraps), and u[t+1] of lane T-1 is u[T-1];
//   - each half's H0 walk reads v[lt] and u[min(lt+1, T-1)];
//   - band clamps use the nominal width Tn = round128(Lt).
// The score of candidate (k, p-1) is written at the end of pass p, into
// score[p*Nrows + k]; the wrapper drops pass 0's. Direction bytes go to the
// raw folded layout dirs[(C+1)*H][Nrows][T], which the folded backtrack
// reads.
//
// What bounds it on this card: (C+1)*H serial wavefronts per kernel row
// (1,920 at the 6,272-row short-read batch, 2,400 at the PE batch's 5,120
// rows), ~57 integer operations per live band lane of either half, and the
// dirs stream, (C+1)*H*Nrows*T bytes (283 MB at 6,272 rows) written once
// in coalesced rows, a tenth of a millisecond of HBM bandwidth. Only 384 to
// 576 kernel rows exist, 3 to 4 per SM. Measured on an H100: register caps
// that made all blocks of a one-thread-per-lane design (two barriers per
// wavefront) resident gained 5%; one warp per kernel row (8 lanes per
// thread, no barrier) ran slower than that design at 384 rows, each warp
// alone on its scheduler waiting on its own chain. So the instructions a
// row issues per wavefront, and the warps an SM has to issue from while one
// waits, set the time.
//
// Design: one block per kernel row, W = T / (32 * kSlots) warps, kSlots
// lanes per thread: lane j = (w * kSlots + k) * 32 + t for warp w, slot k,
// thread t. The lane state u/v/x/y/x2/y2/s and the mixed target byte live
// in registers. Per wavefront:
//   - ONE block barrier. Before it each warp publishes the old x, v, x2 of
//     its last lane (the next warp's first lane reads them) and the owners
//     of the H0 tap lanes publish them, into buffers double-buffered by the
//     parity of r (a buffer is written again two barriers after it was
//     read). Within a warp the lane j-1 neighbour is a rotate of the slot
//     by one lane (__shfl_sync), lane 0 of slot k taking lane 31 of slot
//     k-1. Lane 0's own neighbour, lane T-1 (the TPU rotate wraps), is never
//     read: lane 0 is in band only as A's first lane st = 0, which takes
//     the boundary values.
//   - The H0 walks run one wavefront behind, in every thread on the
//     published taps (warp-uniform), after the slot bodies, so the taps'
//     latency hides behind them.
//   - The row scalars of both halves are warp-uniform and computed once per
//     wavefront, with no division; the per-lane conditions are lane ranges
//     and lane indices set up from them.
//   - The slot body has no branch (selects on the lane's band membership),
//     so the compiler interleaves a thread's slots.
//   - The max-plus chain and its direction code in two __vimax3_s32 (DPX):
//     each candidate's key is value * 8 + (7 - its rank), so the maximum key
//     holds the maximum value and, among equal values, the first in rank
//     order (the strict tie rule); __viaddmax_s32_relu gives the max(a - (z
//     - q), 0) of the four gap states.
//   - Each lane's query byte (of A or B) is loaded from shared memory one
//     wavefront ahead, off the chain; the score is formed at use, since the
//     frontier reset can change the lane's target byte.
//   - The pass transition's 32-lane shift moves each thread's registers up
//     one slot; a warp's slot 0 takes the last slot of the warp before it
//     through shared memory (two barriers per pass).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegInf = -0x40000000;
constexpr int kGap = 32;
constexpr unsigned kFull = 0xffffffffu;
// lanes per thread: 2 measured faster on an H100 than 4 and 8 (which leave
// fewer warps to issue from), and a bound of 1,024 threads per block (ptxas
// then keeps a thread within 64 registers) faster than one of 512
constexpr int kSlots = 2;
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

template <int NSW>
__global__ void __launch_bounds__(kMaxThreads)
extd2_fold_kernel(const uint8_t* __restrict__ query,
                  const uint8_t* __restrict__ target,
                  const int32_t* __restrict__ qlens,
                  const int32_t* __restrict__ tlens,
                  const int32_t* __restrict__ bands,
                  int32_t* __restrict__ score_out, uint8_t* __restrict__ dirs,
                  int N, int Lmax, int Lt, int T, int Tn, int H, int Nrows, int C,
                  Scoring sc) {
  extern __shared__ __align__(16) int fsm[];
  const int W = blockDim.x >> 5;
  int* shb = fsm;                  // [W][8][32] the pass shift's last slots
  int* xb = shb + W * 8 * 32;      // [2][W][3] each warp's last lane: x, v, x2
  int* tapb = xb + 2 * W * 3;      // [2][4] H0 taps: A's v, u; B's v, u
  uint8_t* sq = reinterpret_cast<uint8_t*>(tapb + 8);  // [2][Lmax] A's, B's query
  uint8_t* stg = sq + 2 * Lmax;    // [T] the pass's (A's) target, 0 past Lt
  const int row = blockIdx.x;
  const int tid = threadIdx.x, t = tid & 31, w = tid >> 5;
  const int j0 = w * NSW * 32 + t;  // slot k holds lane j0 + 32 k
  const int qe = sc.q + sc.e;
  const int qe2 = sc.q2 + sc.e2;
  // qv: each lane's query byte at the next wavefront (A's, else B's)
  int u[NSW], v[NSW], x[NSW], y[NSW], x2[NSW], y2[NSW], s[NSW], tm[NSW], qv[NSW];
#pragma unroll
  for (int k = 0; k < NSW; ++k) {
    u[k] = v[k] = x[k] = y[k] = -qe;
    x2[k] = y2[k] = -qe2;
    s[k] = 0;
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
    if (p > 0) {  // the last slot of each warp, for the next warp's slot 0
      int* o = shb + w * 8 * 32 + t;
      o[0 * 32] = u[NSW - 1];
      o[1 * 32] = v[NSW - 1];
      o[2 * 32] = x[NSW - 1];
      o[3 * 32] = y[NSW - 1];
      o[4 * 32] = x2[NSW - 1];
      o[5 * 32] = y2[NSW - 1];
      o[6 * 32] = s[NSW - 1];
      o[7 * 32] = tm[NSW - 1];
    }
    __syncthreads();  // the pass's query and target, the last slots
    if (p > 0) {  // pass transition: every slot takes the one below it
#pragma unroll
      for (int k = NSW - 1; k > 0; --k) {
        u[k] = u[k - 1];
        v[k] = v[k - 1];
        x[k] = x[k - 1];
        y[k] = y[k - 1];
        x2[k] = x2[k - 1];
        y2[k] = y2[k - 1];
        s[k] = s[k - 1];
        tm[k] = tm[k - 1];
      }
      if (w > 0) {
        const int* o = shb + (w - 1) * 8 * 32 + t;
        u[0] = o[0 * 32];
        v[0] = o[1 * 32];
        x[0] = o[2 * 32];
        y[0] = o[3 * 32];
        x2[0] = o[4 * 32];
        y2[0] = o[5 * 32];
        s[0] = o[6 * 32];
        tm[0] = o[7 * 32];
      } else {  // lanes < GAP: the init values and A's target
        u[0] = v[0] = x[0] = y[0] = -qe;
        x2[0] = y2[0] = -qe2;
        s[0] = 0;
        tm[0] = stg[t];
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
      for (int k = 0; k < NSW; ++k) tm[k] = stg[j0 + 32 * k];
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
#pragma unroll
    for (int k = 0; k < NSW; ++k) qv[k] = query_byte(-(j0 + 32 * k));
    uint8_t* drow = dirs + ((size_t)p * H * Nrows + row) * T;
    // the H0 walks run one wavefront behind: wavefront r publishes the
    // taps of r-1 before its slots update the lanes and walks r-1 after
    // them. pa/pb: wavefront r-1's halves live; its st0, en0 (global lanes)
    bool pa = false, pb = false;
    int p_st0a = 0, p_en0a = 0, p_st0bg = 0, p_en0bg = 0;
    auto publish_taps = [&](int* tb) {
      const int la = min(max(lta, 0), T - 1), lb = min(max(ltb, 0), T - 1);
      const int la1 = min(la + 1, T - 1), lb1 = min(lb + 1, T - 1);
#pragma unroll
      for (int k = 0; k < NSW; ++k) {
        const int j = j0 + 32 * k;
        if (pa && j == la) tb[0] = v[k];
        if (pa && j == la1) tb[1] = u[k];
        if (pb && j == lb) tb[2] = v[k];
        if (pb && j == lb1) tb[3] = u[k];
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
      int* xo = xb + 3 * W * par;
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
      // the lanes and lane ranges where this wavefront acts
      const int ea_lane = livea && ena >= r ? r : -1;  // edge-lane init
      const int eb_lane = liveb && enb >= rB + kGap ? rB + kGap : -1;
      const int r16 = r + 16;  // the frontier reset
      const int tn16 = stg[min(r16, T - 1)];
      const int bad_a = prev_oka ? -1 : sta;  // x, x2 take the init values
      const int bad_b = prev_okb ? -1 : stb;
      const int va_lane = (sta > 0 && prev_oka) ? -1 : sta;  // v takes va_val
      const int va_val = sta > 0 ? -qe : bu;
      const int sa_n = livea ? ((en0a - st0a) & ~15) + 16 : 0;  // score spans
      const int sb_n = liveb ? ((en0b - st0b) & ~15) + 16 : 0;
      const int ala_n = livea ? ena - sta + 1 : 0;  // updated lanes
      const int alb_n = liveb ? enb - stb + 1 : 0;

      publish_taps(tb);
      // the old x, v, x2 of the warp's last lane, after the frontier reset
      {
        const int j = j0 + 32 * (NSW - 1);
        const bool rs = j == r16;
        if (t == 31) {
          xo[3 * w + 0] = rs ? -qe : x[NSW - 1];
          xo[3 * w + 1] = rs ? -qe : v[NSW - 1];
          xo[3 * w + 2] = rs ? -qe2 : x2[NSW - 1];
        }
      }
      __syncthreads();  // the one barrier of a wavefront
      // lane 31 of the previous slot (old values); slot 0 takes the warp
      // before's last lane
      int cx = 0, cv = 0, cx2 = 0;
      if (w > 0) {
        cx = xo[3 * (w - 1) + 0];
        cv = xo[3 * (w - 1) + 1];
        cx2 = xo[3 * (w - 1) + 2];
      }
      const int tva = tb[0], tua = tb[1], tvb = tb[2], tub = tb[3];

#pragma unroll
      for (int k = 0; k < NSW; ++k) {
        const int j = j0 + 32 * k;
        // edge-lane init for both halves, then the frontier reset
        const bool ea = j == ea_lane, eb = j == eb_lane, rs = j == r16;
        int uk = ea ? bu : (eb ? bub : u[k]);
        int yk = (ea | eb) ? -qe : y[k];
        int y2k = (ea | eb) ? -qe2 : y2[k];
        uk = rs ? -qe : uk;
        yk = rs ? -qe : yk;
        y2k = rs ? -qe2 : y2k;
        const int vk = rs ? -qe : v[k], xk = rs ? -qe : x[k], x2k = rs ? -qe2 : x2[k];
        int sk = rs ? 0 : s[k];
        const int tk = rs ? tn16 : tm[k];
        const int rx = __shfl_sync(kFull, xk, (t + 31) & 31);
        const int rv = __shfl_sync(kFull, vk, (t + 31) & 31);
        const int rx2 = __shfl_sync(kFull, x2k, (t + 31) & 31);
        int xp = t == 0 ? cx : rx, vp = t == 0 ? cv : rv, x2p = t == 0 ? cx2 : rx2;
        cx = rx;
        cv = rv;
        cx2 = rx2;
        const bool bad = (j == bad_a) | (j == bad_b);
        xp = bad ? -qe : xp;
        x2p = bad ? -qe2 : x2p;
        vp = j == va_lane ? va_val : vp;
        vp = j == bad_b ? -qe : vp;
        // substitution scores for both halves' 16-blocks
        const int q = qv[k];
        const int sval = ((tk == 4) | (q == 4)) ? -sc.e2 : (tk == q ? sc.a : -sc.b);
        sk = (in_range(j, st0a, sa_n) | in_range(j, st0bg, sb_n)) ? sval : sk;
        const bool in_al = in_range(j, sta, ala_n) | in_range(j, stb, alb_n);
        const int a_ = xp + vp, b_ = yk + uk, a2_ = x2p + vp, b2_ = y2k + uk;
        // the maximum and its first rank (d = 0 for s, 1-4 for the terms)
        const int key = __vimax3_s32(__vimax3_s32(sk * 8 + 7, a_ * 8 + 6, b_ * 8 + 5),
                                     a2_ * 8 + 4, b2_ * 8 + 3);
        const int zv = min(key >> 3, sc.a);
        const int mq = sc.q - zv, mq2 = sc.q2 - zv;
        // max(term - (zv - q), 0): positive exactly when the gap extends
        const int xr = __viaddmax_s32_relu(a_, mq, 0);
        const int yr = __viaddmax_s32_relu(b_, mq, 0);
        const int x2r = __viaddmax_s32_relu(a2_, mq2, 0);
        const int y2r = __viaddmax_s32_relu(b2_, mq2, 0);
        const int ext = ((min(y2r, 1) * 2 + min(x2r, 1)) * 2 + min(yr, 1)) * 2 + min(xr, 1);
        const int d = ext * 8 + (7 - (key & 7));
        u[k] = in_al ? zv - vp : uk;
        v[k] = in_al ? zv - uk : vk;
        x[k] = in_al ? xr - qe : xk;
        y[k] = in_al ? yr - qe : yk;
        x2[k] = in_al ? x2r - qe2 : x2k;
        y2[k] = in_al ? y2r - qe2 : y2k;
        s[k] = sk;
        tm[k] = tk;
        drow[j] = in_al ? (uint8_t)d : (uint8_t)0;
        qv[k] = query_byte(r + 1 - j);
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

// C entry point (bound with ctypes). Pointers are device pointers; scoring
// is the derived (a, b, q, e, q2, e2, long_thres, long_diff) of
// gdiet_tpu_torch/ops/dp.py::derive_scoring; (T, Tn, H, Nrows, C) come from
// ops/dp_fold.py's fold_geometry and fold_split. tlens may be null (=
// qlens). score holds (C+1)*Nrows entries, dirs (C+1)*H*Nrows*T bytes. One
// block of T / kSlots threads per kernel row. Launches on `stream` and
// returns a CUDA error code (0 on success).
extern "C" int gdiet_extd2_fold(const void* query, const void* target,
                                const void* qlens, const void* tlens,
                                const void* bands, void* score, void* dirs,
                                int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                                int64_t Tn, int64_t H, int64_t Nrows, int64_t C,
                                int a, int b, int q, int e, int q2, int e2,
                                int long_thres, int long_diff, void* stream) {
  if (Nrows <= 0) return 0;
  if (T <= 0 || T % (32 * kSlots) != 0 || T / kSlots > kMaxThreads ||
      T < Lt + kGap + 16 || H < Lmax)
    return (int)cudaErrorInvalidValue;
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  const int threads = (int)(T / kSlots);
  const int W = threads / 32;
  const size_t shm = (W * 8 * 32 + 2 * W * 3 + 8) * sizeof(int) + 2 * (size_t)Lmax + (size_t)T;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_fold_kernel<kSlots>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_fold_kernel<kSlots><<<(unsigned)Nrows, (unsigned)threads, shm, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(target),
      static_cast<const int32_t*>(qlens), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(bands), static_cast<int32_t*>(score),
      static_cast<uint8_t*>(dirs), (int)N, (int)Lmax, (int)Lt, (int)T, (int)Tn,
      (int)H, (int)Nrows, (int)C, sc);
  return (int)cudaGetLastError();
}
