// Banded lane window of the DP with an int16 lane state, two lanes in each
// 32-bit register, for NVIDIA Hopper (sm_90a).
//
// Replaces the windowed mode of the TPU kernel
// gdiet_tpu/ops/dp_pallas.py::_dp_kernel (_dp_kernel_body with band_budget
// set) run with state_dtype = "int16" (extd2_batch_pallas, sdt = int16: the
// seven lane-state arrays 16-bit, H0 and the score int32). It computes
// exactly what gdiet_tpu_torch/ops/dp_band.py::extd2_band computes with
// state_dtype="int16", which under ops/dp.py::safe_state_dtype's bound is
// what it computes with int32 and what csrc/extd2_band.cu computes: the
// same window semantics, dirs[N][R][WB] with column j of wavefront r at
// lane lo_al(r) + j.
//
// Design: csrc/extd2_band.cu's (one block per candidate, one barrier per
// wavefront, the H0 walk in thread 0 one wavefront behind, the window
// shift through shared memory, the candidate ended at its last live
// wavefront) on lane pairs (csrc/dp_pair.cuh): pair j holds lanes 2j and
// 2j + 1 of the window in one word per state array, offset binary, and
// PPT pairs per thread (pair j = k * blockDim + t), one up to 2,048 lanes
// and two above, so a block has the int32 kernel's threads at half its
// instructions per lane. The window base is 128-aligned and the band
// limits st (a multiple of 16) and en (one below one) are even and odd, so
// a pair is in band or out as a whole, the window moves by whole pairs, and
// the two direction bytes of a pair are one 16-bit store. Per pair and
// wavefront:
//   - the lane t-1 neighbours of its halves are the high half of the pair
//     below (published in the exchange buffer) and its own low half: one
//     __byte_perm per state (x, v, x2);
//   - the per-half conditions act on one half: the edge lane r, the band's
//     first lane st (always a low half) and the substitution span
//     [st0, st0 + span16) as a mask over the halves;
//   - the chain is dp_pair.cuh's pair_step: four packed adds, four
//     __vibmax_u16x2 with the direction code per half, four
//     __viaddmax_s16x2_relu, six packed adds of the updates.
// The H0 walk reads one 16-bit lane of the published v and u and takes off
// the offset; H0 and the score stay int32.
//
// What bounds it on this card: as csrc/extd2_band.cu, the serial chain of a
// wavefront (the barrier, then the instructions a thread of the band issues
// in turn); packing halves the chain's instructions per lane. The dirs
// stream, N*R*WB bytes written once, is a small share of HBM bandwidth.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_pair.cuh"

namespace {

using namespace pair16;

constexpr int kNegInf = -0x40000000;
constexpr int kMaxThreads = 1024;
constexpr int kArrays = 8;  // shared word arrays of WB/2: 2 x (x, v, x2, u)

struct Scoring {
  int a, b, q, e, q2, e2, long_thres, long_diff;
};

__device__ __forceinline__ int window_base(int r0, int w_max, int T, int WB) {
  int lo = ((r0 - w_max + 1) >> 1) - 16;
  lo = min(max(lo, 0), T - WB);
  return lo & ~127;  // lo >= 0 here
}

// the substitution score of target code tq against query[qi] (0 outside
// the read): a, -b, or -e2 where either base is N (code 4)
__device__ __forceinline__ int subst(int tq, const uint8_t* sq, int qi,
                                     int qlen, const Scoring& sc) {
  const int qv = (qi >= 0 && qi < qlen) ? (int)sq[qi] : 0;
  return (tq == 4 || qv == 4) ? -sc.e2 : (tq == qv ? sc.a : -sc.b);
}

// the target codes of lanes (lane, lane + 1), 0 past Lt, in bytes 0 and 1
__device__ __forceinline__ int target_pair(const uint8_t* trow, int lane, int Lt) {
  return (lane < Lt ? (int)trow[lane] : 0) | ((lane + 1 < Lt ? (int)trow[lane + 1] : 0) << 8);
}

// the substitution scores of a pair of lanes (lane0 = first lane) at
// wavefront r, as one offset-binary word
__device__ __forceinline__ uint32_t subst_pair(int tq2, const uint8_t* sq, int r,
                                               int lane0, int qlen, const Scoring& sc) {
  return pack2(subst(tq2 & 0xff, sq, r - lane0, qlen, sc),
               subst(tq2 >> 8, sq, r - lane0 - 1, qlen, sc));
}

template <int PPT>
__global__ void __launch_bounds__(kMaxThreads)
extd2_band_i16_kernel(const uint8_t* __restrict__ query,
                      const uint8_t* __restrict__ target,
                      const int32_t* __restrict__ qlens,
                      const int32_t* __restrict__ tlens,
                      const int32_t* __restrict__ bands,
                      int32_t* __restrict__ score_out, uint8_t* __restrict__ dirs,
                      int Lmax, int Lt, int T, int R, int WB, int w_max, int unroll,
                      Scoring sc) {
  extern __shared__ uint32_t smem[];
  const int NP = WB / 2;  // pairs in the window
  // exchange buffer p (p = r & 1), [4][NP] words at ex + 4*p*NP: the old x,
  // v, x2 that the lane t-1 neighbours read, and u; the walker reads the H0
  // taps from v and u. The eight arrays are also the window shift's scratch.
  uint32_t* ex = smem;
  uint8_t* sq = reinterpret_cast<uint8_t*>(ex + 8 * NP);  // [Lmax] query

  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int qlen = qlens[n];
  const int tlen = tlens[n];
  const int w = bands[n];
  for (int i = t; i < Lmax; i += nt) sq[i] = query[(size_t)n * Lmax + i];
  const uint8_t* trow = target + (size_t)n * Lt;
  uint8_t* drow = dirs + (size_t)n * R * WB;
  // no wavefront from qlen + tlen - 1 on is live
  const int r_end = (qlen > 0 && tlen > 0) ? min(R, qlen + tlen - 1) : 0;

  const int qe = sc.q + sc.e;
  const int qe2 = sc.q2 + sc.e2;
  const PairScoring ps = pair_scoring(sc.a, sc.q, sc.e, sc.q2, sc.e2);
  const uint32_t init = splat(-qe), init2 = splat(-qe2);
  // sv: each pair's substitution scores at the next wavefront, loaded one
  // wavefront ahead so that their shared-memory loads are off the chain
  uint32_t u[PPT], v[PPT], x[PPT], y[PPT], x2[PPT], y2[PPT], s[PPT], sv[PPT];
  int tq[PPT];
  __syncthreads();  // the query
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    u[k] = v[k] = x[k] = y[k] = init;
    x2[k] = y2[k] = init2;
    s[k] = kBias;  // 0
    const int lane0 = 2 * (k * nt + t);
    tq[k] = target_pair(trow, lane0, Lt);
    sv[k] = subst_pair(tq[k], sq, 0, lane0, qlen, sc);
  }
  int lo = 0;  // lo_al(0) == 0
  int last_st = -1, last_en = -1;
  // the H0 walk (thread 0): wavefront pr's st0, en0, window base, liveness
  int H0 = 0, lt = 0, score = kNegInf;
  int pr = -1, p_st0 = 0, p_en0 = 0, p_lo = 0;
  bool p_live = false;
  int ustep = 0;  // r % unroll
  uint16_t* dst = reinterpret_cast<uint16_t*>(drow);  // dirs row r, a pair a store

  for (int r = 0; r <= r_end; ++r) {
    const int p = r & 1;
    uint32_t* const xo = ex + 4 * p * NP;
    uint32_t* const vo = xo + NP;
    uint32_t* const x2o = vo + NP;
    uint32_t* const uo = x2o + NP;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = k * nt + t;
      xo[j] = x[k];
      vo[j] = v[k];
      x2o[j] = x2[k];
      uo[j] = u[k];
    }
    __syncthreads();  // the one barrier of a wavefront

    if (t == 0 && p_live) {  // wavefront r-1's H0 walk, its taps clipped
      const uint16_t* v16 = reinterpret_cast<const uint16_t*>(vo);
      const uint16_t* u16 = reinterpret_cast<const uint16_t*>(uo);
      const int v_lt = (int)v16[min(max(lt - p_lo, 0), WB - 1)] - 0x8000;
      const int u_lt1 = (int)u16[min(max(lt + 1 - p_lo, 0), WB - 1)] - 0x8000;
      if (pr == 0) {  // lo == 0 and lt == 0, so the tap is v[0]
        H0 = v_lt - qe;
        lt = 0;
      } else {
        const bool lt_in = lt >= p_st0 && lt <= p_en0;
        const bool lt1_in = lt + 1 >= p_st0 && lt + 1 <= p_en0;
        if (lt_in && lt1_in ? v_lt > u_lt1 : lt_in) {
          H0 += v_lt;
        } else {
          H0 += u_lt1;
          lt += 1;
        }
      }
      if (pr == qlen + tlen - 2 && p_en0 == tlen - 1) score = H0;
    }
    if (r == r_end) break;  // the last wavefront's walk is done

    if (ustep == 0) {
      const int nlo = window_base(r, w_max, T, WB);
      if (nlo != lo) {  // the window moved right: shift the lane state
        const int dp = (nlo - lo) >> 1;  // whole pairs: both bases are even
        __syncthreads();  // the walker's reads are done
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const int j = k * nt + t;
          ex[j] = u[k];
          ex[NP + j] = v[k];
          ex[2 * NP + j] = x[k];
          ex[3 * NP + j] = y[k];
          ex[4 * NP + j] = x2[k];
          ex[5 * NP + j] = y2[k];
          ex[6 * NP + j] = s[k];
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const int src = k * nt + t + dp;
          const bool in = src < NP;
          u[k] = in ? ex[src] : init;
          v[k] = in ? ex[NP + src] : init;
          x[k] = in ? ex[2 * NP + src] : init;
          y[k] = in ? ex[3 * NP + src] : init;
          x2[k] = in ? ex[4 * NP + src] : init2;
          y2[k] = in ? ex[5 * NP + src] : init2;
          s[k] = in ? ex[6 * NP + src] : kBias;
          const int lane0 = nlo + 2 * (k * nt + t);
          tq[k] = target_pair(trow, lane0, Lt);
          sv[k] = subst_pair(tq[k], sq, r, lane0, qlen, sc);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PPT; ++k) {  // publish the shifted state again
          const int j = k * nt + t;
          xo[j] = x[k];
          vo[j] = v[k];
          x2o[j] = x2[k];
          uo[j] = u[k];
        }
        __syncthreads();
        lo = nlo;
      }
    }
    ustep = ustep + 1 == unroll ? 0 : ustep + 1;

    const int st0 = __vimax3_s32(0, r - qlen + 1, (r - w + 1) >> 1);
    const int en0 = __vimin3_s32(tlen - 1, r, (r + w) >> 1);
    const bool live = st0 <= en0;  // r < qlen + tlen - 1 and qlen > 0 here
    const int st = st0 & ~15;
    const int en = min(((en0 + 16) & ~15) - 1, T - 1);
    const int s_end = st0 + ((en0 - st0) & ~15) + 16;  // st0 + span16
    const bool prev_ok = (st > 0) && (st - 1 >= last_st) && (st - 1 <= last_en);
    const int bu = r == 0 ? -qe
                 : r < sc.long_thres ? -sc.e
                 : r == sc.long_thres ? sc.long_diff : -sc.e2;
    // lane st (a low half): x, x2 take the init values unless prev_ok, v
    // takes v_st unless st > 0 and prev_ok
    const uint32_t v_st = splat(st > 0 ? -qe : bu);

#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int j = k * nt + t;
      const int lane0 = lo + 2 * j;
      if (live) s[k] = blend(span_mask(lane0, st0, s_end), sv[k], s[k]);
      uint32_t dout = 0;
      if (live && lane0 >= st && lane0 <= en) {  // the pair is in band
        uint32_t uk = u[k], yk = y[k], y2k = y2[k];
        if ((lane0 >> 1) == (r >> 1)) {  // edge-lane init at lane r
          const int h = r & 1;
          yk = set_half(yk, h, init);
          y2k = set_half(y2k, h, init2);
          uk = set_half(uk, h, splat(bu));
        }
        const int jp = j == 0 ? NP - 1 : j - 1;  // rotate over the window
        uint32_t xp = prev_lanes(xo[jp], x[k]);
        uint32_t vp = prev_lanes(vo[jp], v[k]);
        uint32_t x2p = prev_lanes(x2o[jp], x2[k]);
        if (lane0 == st) {
          if (!prev_ok) {
            xp = set_half(xp, 0, init);
            x2p = set_half(x2p, 0, init2);
          }
          if (!(st > 0 && prev_ok)) vp = set_half(vp, 0, v_st);
        }
        const PairOut o = pair_step(s[k], xp, vp, x2p, uk, yk, y2k, ps);
        u[k] = o.u;
        v[k] = o.v;
        x[k] = o.x;
        y[k] = o.y;
        x2[k] = o.x2;
        y2[k] = o.y2;
        dout = o.d;
      }
      dst[j] = (uint16_t)dout;
    }
    dst += NP;
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      sv[k] = subst_pair(tq[k], sq, r + 1, lo + 2 * (k * nt + t), qlen, sc);

    pr = r;
    p_live = live;
    p_st0 = st0;
    p_en0 = en0;
    p_lo = lo;
    if (live) {
      last_st = st;
      last_en = en;
    }
  }
  if (t == 0) score_out[n] = score;
  // rows r_end .. R-1 are zero: WB is a multiple of 128, so they are one
  // 16-byte aligned run
  uint4* z = reinterpret_cast<uint4*>(drow + (size_t)r_end * WB);
  const int nz = (R - r_end) * (WB / 16);
  for (int i = t; i < nz; i += nt) z[i] = make_uint4(0, 0, 0, 0);
}

template <int PPT>
int launch(const void* query, const void* target, const void* qlens,
           const void* tlens, const void* bands, void* score, void* dirs,
           int64_t N, int64_t Lmax, int64_t Lt, int64_t T, int64_t R,
           int64_t WB, int w_max, int unroll, const Scoring& sc,
           cudaStream_t stream) {
  const int threads = (int)(WB / (2 * PPT));
  const size_t shm = kArrays * (size_t)(WB / 2) * sizeof(uint32_t) + (size_t)Lmax;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_band_i16_kernel<PPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_band_i16_kernel<PPT><<<(unsigned)N, threads, shm, stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(target),
      static_cast<const int32_t*>(qlens), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(bands), static_cast<int32_t*>(score),
      static_cast<uint8_t*>(dirs), (int)Lmax, (int)Lt, (int)T, (int)R, (int)WB,
      w_max, unroll, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes), the arguments of
// csrc/extd2_band.cu's gdiet_extd2_band. Pointers are device pointers;
// scoring is the derived (a, b, q, e, q2, e2, long_thres, long_diff) of
// gdiet_tpu_torch/ops/dp.py::derive_scoring, inside safe_state_dtype's
// bound (the wrapper checks it); WB is the window width of
// ops/dp_band.py::window_geometry (a multiple of 128, at most 4,096) and
// w_max the band budget it was computed from. Launches on `stream` and
// returns a CUDA error code (0 on success).
extern "C" int gdiet_extd2_band_i16(const void* query, const void* target,
                                    const void* qlens, const void* tlens,
                                    const void* bands, void* score, void* dirs,
                                    int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                                    int64_t R, int64_t WB, int w_max, int unroll,
                                    int a, int b, int q, int e, int q2, int e2,
                                    int long_thres, int long_diff, void* stream) {
  if (N <= 0) return 0;
  if (WB <= 0 || WB % 128 != 0 || WB > 4 * kMaxThreads || WB >= T ||
      unroll <= 0)
    return (int)cudaErrorInvalidValue;
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  cudaStream_t s = (cudaStream_t)stream;
  if (WB <= 2 * kMaxThreads)
    return launch<1>(query, target, qlens, tlens, bands, score, dirs, N, Lmax,
                     Lt, T, R, WB, w_max, unroll, sc, s);
  return launch<2>(query, target, qlens, tlens, bands, score, dirs, N, Lmax,
                   Lt, T, R, WB, w_max, unroll, sc, s);
}
