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
// Design: one thread block per kernel row k, one thread per lane of T (256
// at Lmax 160). Lane state u/v/x/y/x2/y2/s, the mixed target byte and the
// current pass's target byte live in registers. The per-row scalars of both
// halves are recomputed by every thread, so they need no broadcast. The
// pass transition's 32-lane shift goes through shared memory behind one
// barrier. Each wavefront publishes x, v, x2 for the lane t-1 neighbours
// (barrier 1) and the updated v, u for the two H0 walks (barrier 2). The
// queries of A and B sit in shared memory, in two buffers that swap roles
// each pass.
//
// What bounds it on this card: (C+1)*H serial wavefronts per block (1,920
// at the 6,272-row short-read batch), each behind two block barriers, with
// ~90 integer operations per lane. The dirs stream is (C+1)*H*Nrows*T bytes
// (283 MB at that batch), written once as one coalesced T-byte row per
// wavefront, far below the card's HBM bandwidth. So, like extd2.cu, it is
// bound by barrier latency and integer instruction throughput, with ~11x
// fewer, longer blocks (Nrows = 576 of 256 threads). Measured on an H100:
// capping registers so that all 576 blocks are resident at once gains
// only 5%, so the instructions each thread runs per wavefront (the body on
// all 256 lanes, both halves' row scalars) set the time. Threads for the
// live lanes only, two int16 lanes per thread and warp-uniform row scalars
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegInf = -0x40000000;
constexpr int kGap = 32;

struct Scoring {
  int a, b, q, e, q2, e2, long_thres, long_diff;
};

__device__ __forceinline__ int floor16(int x) {
  // floor(x / 16) * 16 for any sign (the JAX code uses floor division)
  return (x >= 0 ? x / 16 : -((-x + 15) / 16)) * 16;
}

__device__ __forceinline__ int boundary_u(int r, bool first, const Scoring& sc) {
  if (first && r == 0) return -(sc.q + sc.e);
  return r < sc.long_thres ? -sc.e : r == sc.long_thres ? sc.long_diff : -sc.e2;
}

__global__ void extd2_fold_kernel(const uint8_t* __restrict__ query,
                                  const uint8_t* __restrict__ target,
                                  const int32_t* __restrict__ qlens,
                                  const int32_t* __restrict__ tlens,
                                  const int32_t* __restrict__ bands,
                                  int32_t* __restrict__ score_out,
                                  uint8_t* __restrict__ dirs, int N, int Lmax,
                                  int Lt, int T, int Tn, int H, int Nrows,
                                  int C, Scoring sc) {
  extern __shared__ int smem[];
  int* sx = smem;        // [T] x after the resets, for lane t+1
  int* sv = sx + T;      // [T] v
  int* sx2 = sv + T;     // [T] x2
  int* sv2 = sx2 + T;    // [T] updated v, for the H0 walks
  int* su2 = sv2 + T;    // [T] updated u
  int* sh = su2 + T;     // [8][T] pass transition
  uint8_t* sq = reinterpret_cast<uint8_t*>(sh + 8 * T);  // [2][Lmax] queries

  const int k = blockIdx.x;
  const int t = threadIdx.x;
  const int qe = sc.q + sc.e;
  const int qe2 = sc.q2 + sc.e2;
  int u = -qe, v = -qe, x = -qe, y = -qe, x2 = -qe2, y2 = -qe2, s = 0;
  int tmix = 0;
  // row scalars: A = candidate (k, p), B = candidate (k, p-1); qlen 0 = dead
  int H0a = 0, lta = 0, lsta = -1, lena = -1, scoa = kNegInf, qla = 0, wba = 0, tla = 0;
  int H0b = 0, ltb = 0, lstb = -1, lenb = -1, scob = kNegInf, qlb = 0, wbb = 0, tlb = 0;

  for (int p = 0; p <= C; ++p) {
    const int n = p * Nrows + k;
    const bool real = n < N;  // n < N implies p < C
    const int tnew = (real && t < Lt) ? (int)target[(size_t)n * Lt + t] : 0;
    uint8_t* sqa = sq + (p & 1) * Lmax;
    const uint8_t* sqb = sq + ((p + 1) & 1) * Lmax;  // last pass's A query
    for (int i = t; i < Lmax; i += blockDim.x)
      sqa[i] = real ? query[(size_t)n * Lmax + i] : 0;
    if (p > 0) {
      sh[0 * T + t] = u;
      sh[1 * T + t] = v;
      sh[2 * T + t] = x;
      sh[3 * T + t] = y;
      sh[4 * T + t] = x2;
      sh[5 * T + t] = y2;
      sh[6 * T + t] = s;
      sh[7 * T + t] = tmix;
    }
    __syncthreads();  // the queries (and the state to shift) are visible
    if (p > 0) {  // pass transition
      if (t >= kGap) {
        const int o = t - kGap;
        u = sh[0 * T + o];
        v = sh[1 * T + o];
        x = sh[2 * T + o];
        y = sh[3 * T + o];
        x2 = sh[4 * T + o];
        y2 = sh[5 * T + o];
        s = sh[6 * T + o];
        tmix = sh[7 * T + o];
      } else {
        u = v = x = y = -qe;
        x2 = y2 = -qe2;
        s = 0;
        tmix = tnew;
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
      tmix = tnew;
    }
    H0a = 0;
    lta = 0;
    lsta = -1;
    lena = -1;
    scoa = kNegInf;
    qla = real ? qlens[n] : 0;
    wba = real ? bands[n] : 0;
    tla = real ? (tlens != nullptr ? tlens[n] : qla) : 0;

    for (int r = 0; r < H; ++r) {
      const int rB = r + H;
      // first half (A): local == global lanes
      const int st0a = max(max(0, r - qla + 1), (r - wba + 1) >> 1);
      const int en0a = min(min(tla - 1, r), (r + wba) >> 1);
      const bool livea = (st0a <= en0a) && (r < qla + tla - 1) && (qla > 0);
      const int sta = floor16(st0a);
      const int ena = min(floor16(en0a + 16) - 1, Tn - 1);
      // second half (B): global = local + GAP
      const int st0b = max(max(0, rB - qlb + 1), (rB - wbb + 1) >> 1);
      const int en0b = min(min(tlb - 1, rB), (rB + wbb) >> 1);
      const bool liveb = (st0b <= en0b) && (rB < qlb + tlb - 1) && (qlb > 0);
      const int stb = floor16(st0b) + kGap;
      const int enb = min(floor16(en0b + 16) - 1, Tn - 1) + kGap;
      const int st0bg = st0b + kGap, en0bg = en0b + kGap;
      const bool prev_oka = (sta > 0) && (sta - 1 >= lsta) && (sta - 1 <= lena);
      const bool prev_okb = (stb - 1 >= lstb) && (stb - 1 <= lenb);
      const int bu = boundary_u(r, true, sc);

      // edge-lane init for both halves, then the frontier reset
      if (t == r && ena >= r && livea) {
        y = -qe;
        y2 = -qe2;
        u = bu;
      }
      if (t == rB + kGap && enb >= rB + kGap && liveb) {
        y = -qe;
        y2 = -qe2;
        u = boundary_u(rB, false, sc);
      }
      if (t == r + 16) {
        u = v = x = y = -qe;
        x2 = y2 = -qe2;
        s = 0;
        tmix = tnew;
      }
      // substitution scores for both halves' 16-blocks
      const int span16a = floor16(en0a - st0a) + 16;
      const int span16b = floor16(en0b - st0b) + 16;
      if ((livea && t >= st0a && t < st0a + span16a) ||
          (liveb && t >= st0bg && t < st0bg + span16b)) {
        const int ia = r - t;
        const int ib = rB + kGap - t;
        int qv = 0;
        if (ia >= 0 && ia < qla && ia < Lmax) {
          qv = sqa[ia];
        } else if (ib >= 0 && ib < qlb && ib < Lmax) {
          qv = sqb[ib];
        }
        int sval = tmix == qv ? sc.a : -sc.b;
        if (tmix == 4 || qv == 4) sval = -sc.e2;
        s = sval;
      }

      sx[t] = x;
      sv[t] = v;
      sx2[t] = x2;
      __syncthreads();  // barrier 1: lane t-1 neighbours visible

      const bool in_al = (livea && t >= sta && t <= ena) ||
                         (liveb && t >= stb && t <= enb);
      uint8_t dout = 0;
      if (in_al) {
        const int tp = t == 0 ? T - 1 : t - 1;
        int xp = sx[tp], vp = sv[tp], x2p = sx2[tp];
        if ((t == sta && !prev_oka) || (t == stb && !prev_okb)) {
          xp = -qe;
          x2p = -qe2;
        }
        if (t == sta) vp = sta > 0 ? (prev_oka ? vp : -qe) : bu;
        if (t == stb && !prev_okb) vp = -qe;
        const int a_ = xp + vp, b_ = y + u, a2_ = x2p + vp, b2_ = y2 + u;
        int zv = s;
        int d = a_ > zv ? 1 : 0;
        zv = max(zv, a_);
        d = b_ > zv ? 2 : d;
        zv = max(zv, b_);
        d = a2_ > zv ? 3 : d;
        zv = max(zv, a2_);
        d = b2_ > zv ? 4 : d;
        zv = max(zv, b2_);
        zv = min(zv, sc.a);
        const int u_new = zv - vp;
        const int v_new = zv - u;
        const int a_p = a_ - (zv - sc.q), b_p = b_ - (zv - sc.q);
        const int a2_p = a2_ - (zv - sc.q2), b2_p = b2_ - (zv - sc.q2);
        u = u_new;
        v = v_new;
        x = max(a_p, 0) - qe;
        y = max(b_p, 0) - qe;
        x2 = max(a2_p, 0) - qe2;
        y2 = max(b2_p, 0) - qe2;
        d |= (a_p > 0 ? 0x08 : 0) | (b_p > 0 ? 0x10 : 0) |
             (a2_p > 0 ? 0x20 : 0) | (b2_p > 0 ? 0x40 : 0);
        dout = (uint8_t)d;
      }
      dirs[((size_t)(p * H + r) * Nrows + k) * T + t] = dout;
      sv2[t] = v;
      su2[t] = u;
      __syncthreads();  // barrier 2: the wavefront just computed is visible

      // approximate H0 walks (ksw2_extd2_sse.c:367-383), one per half
      {
        const int l = min(max(lta, 0), T - 1);
        const int vl = sv2[l], ul = su2[min(l + 1, T - 1)];
        const bool lt_in = lta >= st0a && lta <= en0a;
        const bool lt1_in = lta + 1 >= st0a && lta + 1 <= en0a;
        const bool stay = (lt_in && lt1_in) ? vl > ul : lt_in;
        const int inc = (lt_in && lt1_in) ? max(vl, ul) : (lt_in ? vl : ul);
        if (livea) {
          if (r == 0) {
            H0a = sv2[0] - qe;
            lta = 0;
          } else {
            H0a += inc;
            lta = stay ? lta : lta + 1;
          }
        }
      }
      {
        const int l = min(max(ltb, 0), T - 1);
        const int vl = sv2[l], ul = su2[min(l + 1, T - 1)];
        const bool lt_in = ltb >= st0bg && ltb <= en0bg;
        const bool lt1_in = ltb + 1 >= st0bg && ltb + 1 <= en0bg;
        const bool stay = (lt_in && lt1_in) ? vl > ul : lt_in;
        const int inc = (lt_in && lt1_in) ? max(vl, ul) : (lt_in ? vl : ul);
        if (liveb) {
          H0b += inc;
          ltb = stay ? ltb : ltb + 1;
        }
      }
      if (livea && r == qla + tla - 2 && en0a == tla - 1) scoa = H0a;
      if (liveb && rB == qlb + tlb - 2 && en0b == tlb - 1) scob = H0b;
      if (livea) {
        lsta = sta;
        lena = ena;
      }
      if (liveb) {
        lstb = stb;
        lenb = enb;
      }
    }
    // the pass's second-half candidate (k, p-1) just completed
    if (t == 0) score_out[(size_t)p * Nrows + k] = scob;
  }
}

}  // namespace

// C entry point (bound with ctypes). Pointers are device pointers; scoring
// is the derived (a, b, q, e, q2, e2, long_thres, long_diff) of
// gdiet_tpu_torch/ops/dp.py::derive_scoring; (T, Tn, H, Nrows, C) come from
// ops/dp_fold.py's fold_geometry and fold_split. tlens may be null (=
// qlens). score holds (C+1)*Nrows entries, dirs (C+1)*H*Nrows*T bytes.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int gdiet_extd2_fold(const void* query, const void* target,
                                const void* qlens, const void* tlens,
                                const void* bands, void* score, void* dirs,
                                int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                                int64_t Tn, int64_t H, int64_t Nrows, int64_t C,
                                int a, int b, int q, int e, int q2, int e2,
                                int long_thres, int long_diff, void* stream) {
  if (Nrows <= 0) return 0;
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  const size_t shm = 13 * (size_t)T * sizeof(int) + 2 * (size_t)Lmax;
  extd2_fold_kernel<<<(unsigned)Nrows, (unsigned)T, shm, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(target),
      static_cast<const int32_t*>(qlens), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(bands), static_cast<int32_t*>(score),
      static_cast<uint8_t*>(dirs), (int)N, (int)Lmax, (int)Lt, (int)T, (int)Tn,
      (int)H, (int)Nrows, (int)C, sc);
  return (int)cudaGetLastError();
}
