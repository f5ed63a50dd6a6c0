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
// ops/dp.py, dirs[N][R][T] (T = round16(Lt)), which the backtrack reads at
// lane i.
//
// What bounds it on this card: qlen + tlen - 1 serial wavefronts per row,
// with ~57 integer operations per live band lane (chip_smoke.py's bound
// counts them over this run's bands). The dirs stream, N*R*T bytes (about
// 320 MB for the 6,272-row short-read batch at Lmax 160) written once in
// coalesced rows, takes about a tenth of a millisecond of the card's HBM
// bandwidth. So the time is the instructions a row's wavefronts issue, and
// what each waits on between them.
//
// Design, the warp route (T <= 512, every short-read shape): one warp per
// row, NS = T/32 lanes per thread, lane j = k*32 + t of slot k. The lane
// state u/v/x/y/x2/y2/s of all NS slots lives in registers, so a
// wavefront needs no barrier and no shared-memory exchange:
//   - the lane j-1 neighbour (old x, v, x2) is a rotate of the slot by one
//     lane (__shfl_sync); lane 0 of slot k takes lane 31 of slot k-1, the
//     rotate of the slot before, carried from its iteration;
//   - the row scalars (band limits, prev_ok, boundary value, H0 walk) are
//     warp-uniform: computed once per wavefront, with no division (floor to
//     16 is a mask for both signs);
//   - a slot whose 32 lanes all lie outside the wavefront's live range
//     [st, max(en, st0 + span16 - 1)] skips its body (a warp-uniform
//     branch) and only stores its zero dirs bytes; within a slot the body
//     has no branch (selects on the lane's band membership and on lanes
//     set up once per wavefront: the edge lane, the boundary lane);
//   - the max-plus chain and its direction code in two __vimax3_s32 (DPX):
//     each candidate's key is value * 8 + (7 - its rank), so the maximum
//     key holds the maximum value and, among equal values, the first in
//     rank order (the strict tie rule); __viaddmax_s32_relu gives the
//     max(a - (z - q), 0) of the four gap states, __vimax3_s32 /
//     __vimin3_s32 the band limits;
//   - the H0 taps v[lt] and u[lt+1] are one select over the slots (PTX
//     selp, so the slots stay in registers) and one warp-uniform
//     __shfl_sync each, and the walk runs one wavefront behind, so that the
//     taps' latency hides behind the next wavefront's slot bodies;
//   - each lane's substitution score is loaded from the query (shared
//     memory) one wavefront ahead, off the chain;
//   - each row ends at its last live wavefront, qlen + tlen - 2 (a qlen-0
//     or tlen-0 row at once); the rows after it are zero in the plain
//     version and the Pallas kernel (tests/test_torch_band.py holds the
//     Pallas kernel to it at full width), and the warp writes them as one
//     run of 16-byte stores.
// The 6,272 rows of the short-read batch are 6,272 one-warp blocks, about
// three waves of the warps the registers let an SM hold.
//
// The block route (T > 512: the long-read (512, 1024) bucket): one block
// per row, one thread per lane, the lane t-1 neighbours and the H0 taps
// exchanged through shared memory behind two barriers per wavefront. A
// warp would need more than 16 slots of lane state in registers there.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegInf = -0x40000000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 16;  // the warp route's widest row: T <= 512

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
__device__ __forceinline__ int select_if(bool p, int a, int b) {
  int r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\tselp.b32 %0, %1, %2, q;\n\t}"
      : "=r"(r) : "r"(a), "r"(b), "r"((int)p));
  return r;
}

// value of lane l (warp-uniform) of a register array of NS slots
template <int NS>
__device__ __forceinline__ int lane_value(const int (&a)[NS], int l) {
  int sel = a[0];
#pragma unroll
  for (int k = 1; k < NS; ++k) sel = select_if((l >> 5) == k, a[k], sel);
  return __shfl_sync(kFull, sel, l & 31);
}

// the substitution score of target code tq against query[qi] (0 outside
// the read): a, -b, or -e2 where either base is N (code 4)
__device__ __forceinline__ int subst(int tq, const uint8_t* sq, int qi,
                                     int qlim, const Scoring& sc) {
  const int qv = (qi >= 0 && qi < qlim) ? (int)sq[qi] : 0;
  return (tq == 4 || qv == 4) ? -sc.e2 : (tq == qv ? sc.a : -sc.b);
}

template <int NS>
__global__ void __launch_bounds__(32)
extd2_warp_kernel(const uint8_t* __restrict__ query,
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
  const int qe2 = sc.q2 + sc.e2;
  // sv: each lane's substitution score at the next wavefront
  int u[NS], v[NS], x[NS], y[NS], x2[NS], y2[NS], s[NS], tq[NS], sv[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int j = k * 32 + t;
    u[k] = v[k] = x[k] = y[k] = -qe;
    x2[k] = y2[k] = -qe2;
    s[k] = 0;
    tq[k] = j < Lt ? (int)target[(size_t)n * Lt + j] : 0;
    sv[k] = subst(tq[k], sq, -j, qlim, sc);
  }
  int H0 = 0, lt = 0, last_st = -1, last_en = -1, score = kNegInf;
  // no wavefront from qlen + tlen - 1 on is live
  const int r_end = (qlen > 0 && tlen > 0) ? min(R, qlen + tlen - 1) : 0;
  uint8_t* drow = dirs + (size_t)n * R * T;
  // the H0 walk runs one wavefront behind: wavefront r reads the taps of
  // r-1 before its slots update the lanes, and walks r-1 after them, so the
  // tap shuffles' latency hides behind the slot bodies. p_live: wavefront
  // r-1 was live; its st0, en0 beside it
  bool p_live = false;
  int p_st0 = 0, p_en0 = 0, v_lt = 0, u_lt1 = 0;
  auto taps = [&]() {
    if (p_live) {
      v_lt = lane_value<NS>(v, min(max(lt, 0), T - 1));
      u_lt1 = lane_value<NS>(u, min(max(lt + 1, 0), T - 1));
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
    const int e_lane = live && en >= r ? r : -1;
    const int bad_lane = prev_ok ? -1 : st;  // x, x2 take the init values
    const int v_lane = (st > 0 && prev_ok) ? -1 : st;  // v takes v_val
    const int v_val = st > 0 ? -qe : bu;

    // lane 31 of the previous slot's old x, v, x2 (slot 0's lane 0 is in
    // band only as st = 0, which takes the boundary values)
    int cx = 0, cv = 0, cx2 = 0;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const int j = k * 32 + t;
      const int rx = __shfl_sync(kFull, x[k], (t + 31) & 31);
      const int rv = __shfl_sync(kFull, v[k], (t + 31) & 31);
      const int rx2 = __shfl_sync(kFull, x2[k], (t + 31) & 31);
      uint8_t dout = 0;
      if (live && k * 32 + 31 >= st && k * 32 <= hi) {  // warp-uniform
        const bool in_band = j >= st && j <= en;
        const bool edge = j == e_lane;  // edge-lane init (en >= r here)
        const int yk = edge ? -qe : y[k], y2k = edge ? -qe2 : y2[k];
        const int uk = edge ? bu : u[k];
        const int sk = (j >= st0 && j < s_end) ? sv[k] : s[k];
        int xp = t == 0 ? cx : rx, vp = t == 0 ? cv : rv, x2p = t == 0 ? cx2 : rx2;
        xp = j == bad_lane ? -qe : xp;
        x2p = j == bad_lane ? -qe2 : x2p;
        vp = j == v_lane ? v_val : vp;
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
        s[k] = sk;
        u[k] = in_band ? zv - vp : uk;
        v[k] = in_band ? zv - uk : v[k];
        x[k] = in_band ? xr - qe : x[k];
        y[k] = in_band ? yr - qe : yk;
        x2[k] = in_band ? x2r - qe2 : x2[k];
        y2[k] = in_band ? y2r - qe2 : y2k;
        dout = in_band ? (uint8_t)(ext * 8 + (7 - (key & 7))) : (uint8_t)0;
      }
      if (j < T) drow[j] = dout;
      sv[k] = subst(tq[k], sq, r + 1 - j, qlim, sc);
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

// The block route: one block per row, one thread per lane (T rounded up to
// 32). The per-row scalars are computed redundantly by every thread. Each
// wavefront publishes the old x, v, x2 to shared memory for the lane t-1
// neighbour and boundary reads (barrier 1), then the two H0 taps (barrier
// 2). The query sits in shared memory; the target byte of a lane in a
// register.
__global__ void extd2_block_kernel(const uint8_t* __restrict__ query,
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

  const int qlim = min(qlen, Lmax);
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
    const int st = st0 & ~15;
    const int en = min(((en0 + 16) & ~15) - 1, T - 1);
    const bool prev_ok = (st > 0) && (st - 1 >= last_st) && (st - 1 <= last_en);
    const int bu = boundary_u(r, sc);

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
      const int span16 = ((en0 - st0) & ~15) + 16;
      if (live && t >= st0 && t < st0 + span16) s = subst(tq, sq, r - t, qlim, sc);
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

struct Args {
  const uint8_t *query, *target;
  const int32_t *qlens, *tlens, *bands;
  int32_t* score;
  uint8_t* dirs;
  int Lmax, Lt, T, R;
};

template <int NS>
int launch_warp(const Args& g, unsigned N, const Scoring& sc, cudaStream_t s) {
  const size_t shm = (size_t)g.Lmax;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_warp_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_warp_kernel<NS><<<N, 32, shm, s>>>(g.query, g.target, g.qlens, g.tlens,
                                            g.bands, g.score, g.dirs, g.Lmax,
                                            g.Lt, g.T, g.R, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). Pointers are device pointers; scoring
// is the derived (a, b, q, e, q2, e2, long_thres, long_diff) of
// gdiet_tpu_torch/ops/dp.py::derive_scoring. tlens may be null (= qlens).
// T = round16(Lt), R = Lmax + Lt - 1. The row width picks the route: one
// warp per row up to T = 512 (the fewest slots of 32 lanes that cover T),
// one block per row above. Launches on `stream` and returns a CUDA error
// code (0 on success).
extern "C" int gdiet_extd2(const void* query, const void* target,
                           const void* qlens, const void* tlens,
                           const void* bands, void* score, void* dirs,
                           int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                           int64_t R, int a, int b, int q, int e, int q2,
                           int e2, int long_thres, int long_diff,
                           void* stream) {
  if (N <= 0) return 0;
  if (T <= 0 || T % 16 != 0 || T < Lt || R <= 0) return (int)cudaErrorInvalidValue;
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
  switch ((T + 31) / 32) {
    case 1:
    case 2: return launch_warp<2>(g, nb, sc, s);
    case 3: return launch_warp<3>(g, nb, sc, s);
    case 4: return launch_warp<4>(g, nb, sc, s);
    case 5: return launch_warp<5>(g, nb, sc, s);
    case 6: return launch_warp<6>(g, nb, sc, s);
    case 7:
    case 8: return launch_warp<8>(g, nb, sc, s);
    case 9:
    case 10: return launch_warp<10>(g, nb, sc, s);
    case 11:
    case 12: return launch_warp<12>(g, nb, sc, s);
    case 13:
    case 14:
    case 15:
    case kMaxSlots: return launch_warp<kMaxSlots>(g, nb, sc, s);
    default: break;
  }
  const int threads = (int)((T + 31) / 32 * 32);
  const size_t shm = (3 * (size_t)T + 2) * sizeof(int) + (size_t)Lmax;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_block_kernel<<<nb, threads, shm, s>>>(g.query, g.target, g.qlens, g.tlens,
                                              g.bands, g.score, g.dirs, g.Lmax,
                                              g.Lt, g.T, g.R, sc);
  return (int)cudaGetLastError();
}
