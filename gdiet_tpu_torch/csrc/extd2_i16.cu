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
// layout of ops/dp.py.
//
// Design, the warp route (T <= 512): csrc/extd2.cu's (one warp per row, the
// lane state in registers, no barrier, slots outside the wavefront's live
// lanes skipped, the H0 walk one wavefront behind, the substitution score
// loaded one wavefront ahead, the row ended at its last live wavefront) on
// lane pairs (csrc/dp_pair.cuh): slot k of thread t holds pair j = k*32 + t,
// lanes 2j and 2j + 1, one offset-binary word per state array, so a slot
// covers 64 lanes and a row needs NP = ceil(T / 64) slots, half the int32
// kernel's. Per pair and wavefront:
//   - the lane t-1 neighbours: the high half of pair j-1 (one __shfl_sync
//     per state x, v, x2 per slot, lane 0 of slot k taking lane 31 of slot
//     k-1 carried from its iteration) under the pair's own low half, one
//     __byte_perm each;
//   - a pair is in band or out as a whole (st is a multiple of 16 and en
//     one below one, or T - 1, with T even); the edge lane r, the band's
//     first lane st (a low half) and the substitution span act per half;
//   - the chain is dp_pair.cuh's pair_step (its direction code per half
//     from the __vibmax_u16x2 predicates: csrc/extd2.cu's key trick needs
//     three more bits than a 16-bit half has to spare under the bound);
//   - the two direction bytes of a pair are one 16-bit store;
//   - the H0 taps v[lt] and u[lt+1]: the pair's word by a select over the
//     slots (PTX selp) and one warp-uniform __shfl_sync, then the half.
//
// The block route (T > 512: the long-read (512, 1024) bucket): one block
// per row, one thread per pair, the lane t-1 neighbours and the H0 taps
// exchanged through shared memory behind two barriers per wavefront, as
// csrc/extd2.cu's block route.
//
// What bounds it on this card: as csrc/extd2.cu, the instructions a row's
// wavefronts issue and what each waits on between them (qlen + tlen - 1
// serial wavefronts per row); packing halves the chain's instructions and
// shuffles per lane. The dirs stream, N*R*T bytes written once in coalesced
// rows, takes about a tenth of a millisecond of HBM bandwidth at the
// short-read batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_pair.cuh"

namespace {

using namespace pair16;

constexpr int kNegInf = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 8;  // the warp route's widest row: T <= 512

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

// value of lane l (warp-uniform) of a register array of NP pair slots
template <int NP>
__device__ __forceinline__ int lane_value(const uint32_t (&a)[NP], int l) {
  const int j = l >> 1;  // its pair
  uint32_t sel = a[0];
#pragma unroll
  for (int k = 1; k < NP; ++k) sel = select_if((j >> 5) == k, a[k], sel);
  return half(__shfl_sync(kFull, sel, j & 31), l & 1);
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

template <int NP>
__global__ void __launch_bounds__(32)
extd2_i16_warp_kernel(const uint8_t* __restrict__ query,
                      const uint8_t* __restrict__ target,
                      const int32_t* __restrict__ qlens,
                      const int32_t* __restrict__ tlens,
                      const int32_t* __restrict__ bands,
                      int32_t* __restrict__ score_out, uint8_t* __restrict__ dirs,
                      int Lmax, int Lt, int T, int R, Scoring sc) {
  extern __shared__ uint8_t sq[];  // [Lmax] the row's query
  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int qlen = qlens[n];
  const int tlen = tlens != nullptr ? tlens[n] : qlen;
  const int w = bands[n];
  for (int i = t; i < Lmax; i += 32) sq[i] = query[(size_t)n * Lmax + i];
  __syncwarp();
  const int qlim = min(qlen, Lmax);
  const int qe = sc.q + sc.e;
  const PairScoring ps = pair_scoring(sc.a, sc.q, sc.e, sc.q2, sc.e2);
  const uint32_t init = splat(-qe), init2 = splat(-(sc.q2 + sc.e2));
  const uint8_t* trow = target + (size_t)n * Lt;
  // sv: each pair's substitution scores at the next wavefront
  uint32_t u[NP], v[NP], x[NP], y[NP], x2[NP], y2[NP], s[NP], sv[NP];
  int tq[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int lane0 = 2 * (k * 32 + t);
    u[k] = v[k] = x[k] = y[k] = init;
    x2[k] = y2[k] = init2;
    s[k] = kBias;  // 0
    tq[k] = target_pair(trow, lane0, Lt);
    sv[k] = subst_pair(tq[k], sq, 0, lane0, qlim, sc);
  }
  int H0 = 0, lt = 0, last_st = -1, last_en = -1, score = kNegInf;
  // no wavefront from qlen + tlen - 1 on is live
  const int r_end = (qlen > 0 && tlen > 0) ? min(R, qlen + tlen - 1) : 0;
  uint8_t* drow = dirs + (size_t)n * R * T;
  // the H0 walk runs one wavefront behind (csrc/extd2.cu): wavefront r
  // reads the taps of r-1 before its slots update the lanes and walks r-1
  // after them
  bool p_live = false;
  int p_st0 = 0, p_en0 = 0, v_lt = 0, u_lt1 = 0;
  auto taps = [&]() {
    if (p_live) {
      v_lt = lane_value<NP>(v, min(max(lt, 0), T - 1));
      u_lt1 = lane_value<NP>(u, min(max(lt + 1, 0), T - 1));
    }
  };
  auto walk = [&](int rw) {  // walk wavefront rw = r-1 on the taps
    if (!p_live) return;
    if (rw == 0) {  // lt == 0 here, so the tap is v[0]
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
    if (rw == qlen + tlen - 2 && p_en0 == tlen - 1) score = H0;
  };

  for (int r = 0; r < r_end; ++r, drow += T) {
    taps();
    const int st0 = __vimax3_s32(0, r - qlen + 1, (r - w + 1) >> 1);
    const int en0 = __vimin3_s32(tlen - 1, r, (r + w) >> 1);
    const bool live = st0 <= en0;  // r < qlen + tlen - 1 and qlen > 0 here
    const int st = st0 & ~15;
    const int en = min(((en0 + 16) & ~15) - 1, T - 1);
    const int s_end = st0 + ((en0 - st0) & ~15) + 16;  // st0 + span16
    const int hi = max(en, s_end - 1);  // the last lane with work
    const bool prev_ok = (st > 0) && (st - 1 >= last_st) && (st - 1 <= last_en);
    const int bu = boundary_u(r, sc);
    // the pair of the edge lane r and its half's mask; the pair of lane st
    // (a low half) and the masks of what it takes: x, x2 the init values
    // unless prev_ok, v v_st unless st > 0 and prev_ok
    const int e_pair = live && en >= r ? r >> 1 : -1;
    const uint32_t e_m = half_mask(r & 1);
    const uint32_t ubu = splat(bu);
    const int st_pair = st >> 1;
    const uint32_t st_xm = prev_ok ? 0u : 0xffffu;
    const uint32_t st_vm = st > 0 && prev_ok ? 0u : 0xffffu;
    const uint32_t v_st = splat(st > 0 ? -qe : bu);

    // pair 31 of the previous slot's old x, v, x2 (slot 0's pair 0 is in
    // band only as st = 0, whose low half takes the boundary values)
    uint32_t cx = 0, cv = 0, cx2 = 0;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int j = k * 32 + t;
      const int lane0 = 2 * j;
      const uint32_t rx = __shfl_sync(kFull, x[k], (t + 31) & 31);
      const uint32_t rv = __shfl_sync(kFull, v[k], (t + 31) & 31);
      const uint32_t rx2 = __shfl_sync(kFull, x2[k], (t + 31) & 31);
      uint32_t dout = 0;
      if (live && k * 64 + 63 >= st && k * 64 <= hi) {  // warp-uniform
        const bool in_band = lane0 >= st && lane0 <= en;
        const uint32_t em = j == e_pair ? e_m : 0u;  // edge-lane init (en >= r here)
        const uint32_t yk = blend(em, init, y[k]);
        const uint32_t y2k = blend(em, init2, y2[k]);
        const uint32_t uk = blend(em, ubu, u[k]);
        const uint32_t sk = blend(span_mask(lane0, st0, s_end), sv[k], s[k]);
        uint32_t xp = prev_lanes(t == 0 ? cx : rx, x[k]);
        uint32_t vp = prev_lanes(t == 0 ? cv : rv, v[k]);
        uint32_t x2p = prev_lanes(t == 0 ? cx2 : rx2, x2[k]);
        const bool at_st = j == st_pair;
        xp = blend(at_st ? st_xm : 0u, init, xp);
        x2p = blend(at_st ? st_xm : 0u, init2, x2p);
        vp = blend(at_st ? st_vm : 0u, v_st, vp);
        const PairOut o = pair_step(sk, xp, vp, x2p, uk, yk, y2k, ps);
        s[k] = sk;
        u[k] = in_band ? o.u : uk;
        v[k] = in_band ? o.v : v[k];
        x[k] = in_band ? o.x : x[k];
        y[k] = in_band ? o.y : yk;
        x2[k] = in_band ? o.x2 : x2[k];
        y2[k] = in_band ? o.y2 : y2k;
        dout = in_band ? o.d : 0u;
      }
      if (lane0 < T) reinterpret_cast<uint16_t*>(drow)[j] = (uint16_t)dout;
      sv[k] = subst_pair(tq[k], sq, r + 1, lane0, qlim, sc);
      cx = rx;
      cv = rv;
      cx2 = rx2;
    }

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
  walk(r_end - 1);
  if (t == 0) score_out[n] = score;
  // rows r_end .. R-1 are zero: T is a multiple of 16, so they are one
  // 16-byte aligned run
  uint4* z = reinterpret_cast<uint4*>(dirs + ((size_t)n * R + r_end) * T);
  const int nz = (R - r_end) * (T / 16);
  for (int i = t; i < nz; i += 32) z[i] = make_uint4(0, 0, 0, 0);
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

struct Args {
  const uint8_t *query, *target;
  const int32_t *qlens, *tlens, *bands;
  int32_t* score;
  uint8_t* dirs;
  int Lmax, Lt, T, R;
};

template <int NP>
int launch_warp(const Args& g, unsigned N, const Scoring& sc, cudaStream_t s) {
  const size_t shm = (size_t)g.Lmax;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_i16_warp_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_i16_warp_kernel<NP><<<N, 32, shm, s>>>(g.query, g.target, g.qlens, g.tlens,
                                                g.bands, g.score, g.dirs, g.Lmax,
                                                g.Lt, g.T, g.R, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes), the arguments of csrc/extd2.cu's
// gdiet_extd2. Pointers are device pointers; scoring is the derived (a, b,
// q, e, q2, e2, long_thres, long_diff) of
// gdiet_tpu_torch/ops/dp.py::derive_scoring, inside safe_state_dtype's
// bound (the wrapper checks it). tlens may be null (= qlens). T =
// round16(Lt), R = Lmax + Lt - 1. The row width picks the route: one warp
// per row up to T = 512 (the fewest slots of 64 lanes that cover T), one
// block per row above (T <= 2,048). Launches on `stream` and returns a CUDA
// error code (0 on success).
extern "C" int gdiet_extd2_i16(const void* query, const void* target,
                               const void* qlens, const void* tlens,
                               const void* bands, void* score, void* dirs,
                               int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                               int64_t R, int a, int b, int q, int e, int q2,
                               int e2, int long_thres, int long_diff,
                               void* stream) {
  if (N <= 0) return 0;
  if (T <= 0 || T % 16 != 0 || T < Lt || R <= 0 || T > 2048)
    return (int)cudaErrorInvalidValue;
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  cudaStream_t s = (cudaStream_t)stream;
  const Args g{static_cast<const uint8_t*>(query),
               static_cast<const uint8_t*>(target),
               static_cast<const int32_t*>(qlens),
               static_cast<const int32_t*>(tlens),
               static_cast<const int32_t*>(bands),
               static_cast<int32_t*>(score),
               static_cast<uint8_t*>(dirs),
               (int)Lmax, (int)Lt, (int)T, (int)R};
  const unsigned nb = (unsigned)N;
  switch ((T + 63) / 64) {
    case 1: return launch_warp<1>(g, nb, sc, s);
    case 2: return launch_warp<2>(g, nb, sc, s);
    case 3: return launch_warp<3>(g, nb, sc, s);
    case 4: return launch_warp<4>(g, nb, sc, s);
    case 5: return launch_warp<5>(g, nb, sc, s);
    case 6: return launch_warp<6>(g, nb, sc, s);
    case 7:
    case kMaxSlots: return launch_warp<kMaxSlots>(g, nb, sc, s);
    default: break;
  }
  const int threads = (int)((T / 2 + 31) / 32 * 32);
  const size_t shm = (3 * (size_t)(T / 2) + 2) * sizeof(uint32_t) + (size_t)Lmax;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_i16_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_i16_block_kernel<<<nb, threads, shm, s>>>(g.query, g.target, g.qlens, g.tlens,
                                                  g.bands, g.score, g.dirs, g.Lmax,
                                                  g.Lt, g.T, g.R, sc);
  return (int)cudaGetLastError();
}
