// Batched banded dual affine-gap extension (ksw_extd2, approx-max H0) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel gdiet_tpu/ops/dp_pallas.py::_dp_kernel
// (_dp_kernel_body, driven by extd2_batch_pallas). It computes exactly what
// gdiet_tpu/ops/dp.py::extd2_batch computes -- the Suzuki-Kasahara
// difference recurrence of GDiet-ShortReads/ksw2_extd2_sse.c:34-402 over
// anti-diagonals, with the reference's 16-lane stale-block behaviour:
//   - substitution scores refresh over [st0, st0 + span16) while the state
//     updates over the 16-aligned [st, en]; lanes outside keep stale values;
//   - the x1/x21/v1 boundary values fall back to constants unless the
//     previous live wavefront covered lane st-1 (prev_ok);
//   - the edge lane t == r is re-initialised before the update;
//   - the greedy approximate H0 walk reads v[lt] and u[lt+1] of the
//     wavefront just computed; the score is H0 at the terminal corner
//     (hit_end), NEG_INF for rows that never reach it.
// One direction byte per (wavefront, lane) is written in the layout of
// ops/dp.py, dirs[N][R][T], which the backtrack reads at lane i.
//
// Design: one thread block per candidate row, one thread per lane (T
// rounded up to 32). The lane state u/v/x/y/x2/y2/s lives in registers.
// The per-row scalars (band window, H0 walk, last live range) are computed
// redundantly by every thread, so they need no broadcast. Each wavefront
// publishes the old x, v, x2 to shared memory for the lane t-1 neighbour
// and boundary reads (barrier 1), then the two H0 taps (barrier 2). The
// query sits in shared memory; the target byte of a lane in a register.
//
// What bounds it on this card: R = qlen+tlen-1 serial wavefronts per row,
// each behind two block barriers, with ~60 integer operations per lane.
// The dirs stream is N*R*T bytes (about 320 MB for the 6,272-row short-read
// batch at Lmax 160), written once as one coalesced T-byte row per
// wavefront -- about a tenth of a millisecond of the card's HBM bandwidth.
// So the kernel is bound by barrier latency and integer issue, not memory;
// many resident blocks per SM (160 threads each) hide the barrier latency.
// A warp-per-row, int16-state or fused-backtrack design is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegInf = -0x40000000;

struct Scoring {
  int a, b, q, e, q2, e2, long_thres, long_diff;
};

__device__ __forceinline__ int floor16(int x) {
  // floor(x / 16) * 16 for any sign (the JAX code uses floor division)
  return (x >= 0 ? x / 16 : -((-x + 15) / 16)) * 16;
}

__global__ void extd2_kernel(const uint8_t* __restrict__ query,
                             const uint8_t* __restrict__ target,
                             const int32_t* __restrict__ qlens,
                             const int32_t* __restrict__ tlens,
                             const int32_t* __restrict__ bands,
                             int32_t* __restrict__ score_out,
                             uint8_t* __restrict__ dirs, int Lmax, int Lt,
                             int T, int R, Scoring sc) {
  extern __shared__ int smem[];
  int* sx = smem;        // [T] old x
  int* sv = sx + T;      // [T] old v
  int* sx2 = sv + T;     // [T] old x2
  int* taps = sx2 + T;   // [2] updated v[lt], u[lt+1]
  uint8_t* sq = reinterpret_cast<uint8_t*>(taps + 2);  // [Lmax] query

  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const bool lane = t < T;
  const int qlen = qlens[n];
  const int tlen = tlens != nullptr ? tlens[n] : qlen;
  const int w = bands[n];
  for (int i = t; i < Lmax; i += blockDim.x) sq[i] = query[(size_t)n * Lmax + i];

  const int qe = sc.q + sc.e;
  const int qe2 = sc.q2 + sc.e2;
  int u = -qe, v = -qe, x = -qe, y = -qe, x2 = -qe2, y2 = -qe2, s = 0;
  const int tq = (t < Lt) ? (int)target[(size_t)n * Lt + t] : 0;
  int H0 = 0, lt = 0, last_st = -1, last_en = -1, score = kNegInf;
  uint8_t* drow = dirs + (size_t)n * R * T;

  for (int r = 0; r < R; ++r) {
    const int st0 = max(max(0, r - qlen + 1), (r - w + 1) >> 1);
    const int en0 = min(min(tlen - 1, r), (r + w) >> 1);
    const bool live = (st0 <= en0) && (r < qlen + tlen - 1) && (qlen > 0);
    const int st = floor16(st0);
    const int en = min(floor16(en0 + 16) - 1, T - 1);
    const bool prev_ok = (st > 0) && (st - 1 >= last_st) && (st - 1 <= last_en);
    const int bu = r == 0 ? -qe
                 : r < sc.long_thres ? -sc.e
                 : r == sc.long_thres ? sc.long_diff : -sc.e2;

    if (lane) {
      sx[t] = x;
      sv[t] = v;
      sx2[t] = x2;
    }
    __syncthreads();  // barrier 1: old x/v/x2 visible (also the query)

    if (lane) {
      uint8_t dout = 0;
      if (live && t == r && en >= r) {  // edge-lane init
        y = -qe;
        y2 = -qe2;
        u = bu;
      }
      const int span16 = floor16(en0 - st0) + 16;
      if (live && t >= st0 && t < st0 + span16) {
        const int qi = r - t;
        const int qv = (qi >= 0 && qi < qlen && qi < Lmax) ? (int)sq[qi] : 0;
        int sval = tq == qv ? sc.a : -sc.b;
        if (tq == 4 || qv == 4) sval = -sc.e2;
        s = sval;
      }
      if (live && t >= st && t <= en) {
        int xp, vp, x2p;
        if (t == st) {
          xp = prev_ok ? sx[st - 1] : -qe;
          x2p = prev_ok ? sx2[st - 1] : -qe2;
          vp = st > 0 ? (prev_ok ? sv[st - 1] : -qe) : bu;
        } else {
          xp = sx[t - 1];
          vp = sv[t - 1];
          x2p = sx2[t - 1];
        }
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
      drow[(size_t)r * T + t] = dout;
      // H0 taps of the wavefront just computed
      if (t == min(max(lt, 0), T - 1)) taps[0] = v;
      if (t == min(max(lt + 1, 0), T - 1)) taps[1] = u;
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

}  // namespace

// C entry point (bound with ctypes). Pointers are device pointers; scoring
// is the derived (a, b, q, e, q2, e2, long_thres, long_diff) of
// gdiet_tpu_torch/ops/dp.py::derive_scoring. tlens may be null (= qlens).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int gdiet_extd2(const void* query, const void* target,
                           const void* qlens, const void* tlens,
                           const void* bands, void* score, void* dirs,
                           int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                           int64_t R, int a, int b, int q, int e, int q2,
                           int e2, int long_thres, int long_diff,
                           void* stream) {
  if (N <= 0) return 0;
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  const int threads = (int)((T + 31) / 32 * 32);
  const size_t shm = (3 * (size_t)T + 2) * sizeof(int) + (size_t)Lmax;
  extd2_kernel<<<(unsigned)N, threads, shm, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(target),
      static_cast<const int32_t*>(qlens), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(bands), static_cast<int32_t*>(score),
      static_cast<uint8_t*>(dirs), (int)Lmax, (int)Lt, (int)T, (int)R, sc);
  return (int)cudaGetLastError();
}
