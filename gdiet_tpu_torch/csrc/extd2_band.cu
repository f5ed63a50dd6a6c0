// Banded lane window of the batched dual affine-gap extension (ksw_extd2,
// approx-max H0) for NVIDIA Hopper (sm_90a).
//
// Replaces the windowed mode of the TPU kernel
// gdiet_tpu/ops/dp_pallas.py::_dp_kernel (_dp_kernel_body with
// band_budget set, driven by extd2_batch_pallas), the mode of every
// long-read DP bucket. It computes exactly what
// gdiet_tpu_torch/ops/dp_band.py::extd2_band computes: only a 128-aligned
// window of WB lanes of the T = round128(Lt) lane range is computed and
// stored, and the window base lo_al = clip(((r0 - w_max + 1) >> 1) - 16,
// 0, T - WB) / 128 * 128 moves right once per grid step of `unroll`
// wavefronts (r0 = r / unroll * unroll). The TPU kernel's semantics kept:
//   - lanes entering the window on the right hold the r == 0 init values;
//   - the lane t-1 neighbour is a rotate over the window: window lane 0
//     reads window lane WB-1;
//   - the H0 taps v[lt] and u[lt+1] clip their lane into the window;
//   - the recurrence, the 16-lane stale blocks, prev_ok, the edge-lane
//     init and hit_end are those of csrc/extd2.cu.
// dirs[N][R][WB]: column j of wavefront r is lane lo_al(r) + j.
//
// Design: one thread block per candidate; the window's WB lanes across the
// block, LPT = WB / blockDim lanes per thread (lane j = k * blockDim + t),
// so that WB > 1,024 (bw 1000 gives 1,280, bw 1300 gives 1,536) still
// launches. The lane state u/v/x/y/x2/y2/s lives in registers. When lo_al
// advances by delta lanes, the state shifts down by delta through shared
// memory (one array at a time, behind barriers) and the entering lanes take
// the init values; this happens once per ~256 wavefronts. Each wavefront
// publishes the old x, v, x2 for the lane t-1 neighbours (barrier 1), then
// the two H0 taps (barrier 2), as extd2.cu does. The per-row scalars are
// computed redundantly by every thread. The query sits in shared memory as
// bytes (Lmax reaches 32,768 in the largest bucket); above 48 KB of shared
// memory the launch raises the kernel's dynamic shared-memory limit first.
//
// What bounds it on this card: R = round64(Lmax+Lt-1) serial wavefronts per
// candidate, each behind two block barriers, with ~60 integer operations
// per lane (e.g. 9,216 wavefronts x 768 lanes at the (4096, 5120) HiFi
// bucket with bw 500). The dirs stream, N*R*WB bytes written once in
// coalesced rows, is a small share of the card's HBM bandwidth. So it is
// bound by the serial chain and integer issue. A chunk of 64 candidates
// fills 64 of the 132 SMs: only ceil(chunk / 132) waves of blocks run, and
// more candidates per launch (or two blocks per SM) are a later lever.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegInf = -0x40000000;
constexpr int kMaxThreads = 1024;

struct Scoring {
  int a, b, q, e, q2, e2, long_thres, long_diff;
};

__device__ __forceinline__ int floor16(int x) {
  // floor(x / 16) * 16 for any sign (the JAX code uses floor division)
  return (x >= 0 ? x / 16 : -((-x + 15) / 16)) * 16;
}

__device__ __forceinline__ int window_base(int r0, int w_max, int T, int WB) {
  int lo = ((r0 - w_max + 1) >> 1) - 16;
  lo = min(max(lo, 0), T - WB);
  return lo / 128 * 128;
}

// shift one lane-state array down by delta lanes through `buf`, filling
// the lanes that enter on the right with `init`
template <int LPT>
__device__ __forceinline__ void shift_lanes(int (&a)[LPT], int* buf, int delta,
                                            int WB, int init) {
  const int t = threadIdx.x, nt = blockDim.x;
#pragma unroll
  for (int k = 0; k < LPT; ++k) buf[k * nt + t] = a[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int src = k * nt + t + delta;
    a[k] = src < WB ? buf[src] : init;
  }
  __syncthreads();
}

template <int LPT>
__global__ void __launch_bounds__(kMaxThreads)
extd2_band_kernel(const uint8_t* __restrict__ query,
                  const uint8_t* __restrict__ target,
                  const int32_t* __restrict__ qlens,
                  const int32_t* __restrict__ tlens,
                  const int32_t* __restrict__ bands,
                  int32_t* __restrict__ score_out, uint8_t* __restrict__ dirs,
                  int Lmax, int Lt, int T, int R, int WB, int w_max, int unroll,
                  Scoring sc) {
  extern __shared__ int smem[];
  int* sx = smem;        // [WB] old x (also the shift buffer)
  int* sv = sx + WB;     // [WB] old v
  int* sx2 = sv + WB;    // [WB] old x2
  int* taps = sx2 + WB;  // [2] updated v[lt], u[lt+1]
  uint8_t* sq = reinterpret_cast<uint8_t*>(taps + 2);  // [Lmax] query

  const int n = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int qlen = qlens[n];
  const int tlen = tlens[n];
  const int w = bands[n];
  for (int i = t; i < Lmax; i += nt) sq[i] = query[(size_t)n * Lmax + i];
  const uint8_t* trow = target + (size_t)n * Lt;

  const int qe = sc.q + sc.e;
  const int qe2 = sc.q2 + sc.e2;
  int u[LPT], v[LPT], x[LPT], y[LPT], x2[LPT], y2[LPT], s[LPT], tq[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    u[k] = v[k] = x[k] = y[k] = -qe;
    x2[k] = y2[k] = -qe2;
    s[k] = 0;
    const int lane = k * nt + t;
    tq[k] = lane < Lt ? (int)trow[lane] : 0;
  }
  int lo = 0;  // lo_al(0) == 0
  int H0 = 0, lt = 0, last_st = -1, last_en = -1, score = kNegInf;
  uint8_t* drow = dirs + (size_t)n * R * WB;

  for (int r = 0; r < R; ++r) {
    if (r % unroll == 0) {
      const int nlo = window_base(r, w_max, T, WB);
      if (nlo != lo) {  // the window moved right: shift the lane state
        const int delta = nlo - lo;
        shift_lanes<LPT>(u, sx, delta, WB, -qe);
        shift_lanes<LPT>(v, sx, delta, WB, -qe);
        shift_lanes<LPT>(x, sx, delta, WB, -qe);
        shift_lanes<LPT>(y, sx, delta, WB, -qe);
        shift_lanes<LPT>(x2, sx, delta, WB, -qe2);
        shift_lanes<LPT>(y2, sx, delta, WB, -qe2);
        shift_lanes<LPT>(s, sx, delta, WB, 0);
        lo = nlo;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const int lane = lo + k * nt + t;
          tq[k] = lane < Lt ? (int)trow[lane] : 0;
        }
      }
    }
    const int st0 = max(max(0, r - qlen + 1), (r - w + 1) >> 1);
    const int en0 = min(min(tlen - 1, r), (r + w) >> 1);
    const bool live = (st0 <= en0) && (r < qlen + tlen - 1) && (qlen > 0);
    const int st = floor16(st0);
    const int en = min(floor16(en0 + 16) - 1, T - 1);
    const bool prev_ok = (st > 0) && (st - 1 >= last_st) && (st - 1 <= last_en);
    const int bu = r == 0 ? -qe
                 : r < sc.long_thres ? -sc.e
                 : r == sc.long_thres ? sc.long_diff : -sc.e2;
    const int span16 = floor16(en0 - st0) + 16;
    const int jt0 = min(max(lt - lo, 0), WB - 1);
    const int jt1 = min(max(lt + 1 - lo, 0), WB - 1);

#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = k * nt + t;
      sx[j] = x[k];
      sv[j] = v[k];
      sx2[j] = x2[k];
    }
    __syncthreads();  // barrier 1: old x/v/x2 visible (also the query)

#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = k * nt + t;
      const int lane = lo + j;
      uint8_t dout = 0;
      if (live && lane == r && en >= r) {  // edge-lane init
        y[k] = -qe;
        y2[k] = -qe2;
        u[k] = bu;
      }
      if (live && lane >= st0 && lane < st0 + span16) {
        const int qi = r - lane;
        const int qv = (qi >= 0 && qi < qlen) ? (int)sq[qi] : 0;
        int sval = tq[k] == qv ? sc.a : -sc.b;
        if (tq[k] == 4 || qv == 4) sval = -sc.e2;
        s[k] = sval;
      }
      if (live && lane >= st && lane <= en) {
        const int jp = j == 0 ? WB - 1 : j - 1;  // rotate over the window
        int xp = sx[jp], vp = sv[jp], x2p = sx2[jp];
        if (lane == st) {
          if (!prev_ok) {
            xp = -qe;
            x2p = -qe2;
          }
          vp = st > 0 ? (prev_ok ? vp : -qe) : bu;
        }
        const int a_ = xp + vp, b_ = y[k] + u[k], a2_ = x2p + vp,
                  b2_ = y2[k] + u[k];
        int zv = s[k];
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
        const int v_new = zv - u[k];
        const int a_p = a_ - (zv - sc.q), b_p = b_ - (zv - sc.q);
        const int a2_p = a2_ - (zv - sc.q2), b2_p = b2_ - (zv - sc.q2);
        u[k] = u_new;
        v[k] = v_new;
        x[k] = max(a_p, 0) - qe;
        y[k] = max(b_p, 0) - qe;
        x2[k] = max(a2_p, 0) - qe2;
        y2[k] = max(b2_p, 0) - qe2;
        d |= (a_p > 0 ? 0x08 : 0) | (b_p > 0 ? 0x10 : 0) |
             (a2_p > 0 ? 0x20 : 0) | (b2_p > 0 ? 0x40 : 0);
        dout = (uint8_t)d;
      }
      drow[(size_t)r * WB + j] = dout;
      // H0 taps of the wavefront just computed, clipped into the window
      if (j == jt0) taps[0] = v[k];
      if (j == jt1) taps[1] = u[k];
    }
    __syncthreads();  // barrier 2: taps visible

    if (live) {
      const int v_lt = taps[0];
      const int u_lt1 = taps[1];
      if (r == 0) {  // lo == 0 and lt == 0 here, so taps[0] is v[0]
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

template <int LPT>
int launch(const void* query, const void* target, const void* qlens,
           const void* tlens, const void* bands, void* score, void* dirs,
           int64_t N, int64_t Lmax, int64_t Lt, int64_t T, int64_t R,
           int64_t WB, int w_max, int unroll, const Scoring& sc,
           cudaStream_t stream) {
  const int threads = (int)(WB / LPT);
  const size_t shm = (3 * (size_t)WB + 2) * sizeof(int) + (size_t)Lmax;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        extd2_band_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  extd2_band_kernel<LPT><<<(unsigned)N, threads, shm, stream>>>(
      static_cast<const uint8_t*>(query), static_cast<const uint8_t*>(target),
      static_cast<const int32_t*>(qlens), static_cast<const int32_t*>(tlens),
      static_cast<const int32_t*>(bands), static_cast<int32_t*>(score),
      static_cast<uint8_t*>(dirs), (int)Lmax, (int)Lt, (int)T, (int)R, (int)WB,
      w_max, unroll, sc);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes). Pointers are device pointers; scoring
// is the derived (a, b, q, e, q2, e2, long_thres, long_diff) of
// gdiet_tpu_torch/ops/dp.py::derive_scoring; WB is the window width of
// gdiet_tpu_torch/ops/dp_band.py::window_geometry (a multiple of 128, at
// most 4,096) and w_max the band budget it was computed from. Launches on
// `stream` and returns a CUDA error code (0 on success).
extern "C" int gdiet_extd2_band(const void* query, const void* target,
                                const void* qlens, const void* tlens,
                                const void* bands, void* score, void* dirs,
                                int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                                int64_t R, int64_t WB, int w_max, int unroll,
                                int a, int b, int q, int e, int q2, int e2,
                                int long_thres, int long_diff, void* stream) {
  if (N <= 0) return 0;
  if (WB <= 0 || WB % 128 != 0 || WB > 4 * kMaxThreads || WB >= T)
    return (int)cudaErrorInvalidValue;
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  cudaStream_t s = (cudaStream_t)stream;
  if (WB <= kMaxThreads)
    return launch<1>(query, target, qlens, tlens, bands, score, dirs, N, Lmax,
                     Lt, T, R, WB, w_max, unroll, sc, s);
  if (WB <= 2 * kMaxThreads)
    return launch<2>(query, target, qlens, tlens, bands, score, dirs, N, Lmax,
                     Lt, T, R, WB, w_max, unroll, sc, s);
  return launch<4>(query, target, qlens, tlens, bands, score, dirs, N, Lmax,
                   Lt, T, R, WB, w_max, unroll, sc, s);
}
