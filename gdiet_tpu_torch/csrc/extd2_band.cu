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
// block, LPT = WB / blockDim lanes per thread, two up to 2,048 lanes and
// four above (lane j = k * blockDim + t, so each warp's dirs bytes of a
// wavefront are one coalesced store; one lane per thread and a memset of
// the dirs in place of the tail stores were slower on the card). The
// lane state u/v/x/y/x2/y2/s lives in registers. Per wavefront:
//   - ONE block barrier. Each thread publishes the old x, v, x2 that the
//     lane t-1 neighbours read, and u, into an exchange buffer
//     double-buffered by the parity of r (a buffer is written again two
//     barriers after it was last read), and passes the barrier.
//   - The H0 walk runs in thread 0 alone, one wavefront behind: after
//     wavefront r's barrier it reads wavefront r-1's taps v[lt] and u[lt+1]
//     (clipped into r-1's window) from the published v and u. No other
//     thread does any H0 work, and no lane waits for the walk.
//   - The max-plus chain on Hopper's DPX instructions: __vibmax_s32 gives
//     the running maximum and the comparison that sets the direction code
//     (the tie rule is strict: d moves only when the new term is greater),
//     __viaddmax_s32_relu the max(a - (z - q), 0) of the four gap states,
//     __vimax3_s32 / __vimin3_s32 the band limits.
//   - The per-row scalars without division: floor to 16 is a mask (x & ~15
//     for both signs), r % unroll a counter, the window base only at
//     grid-step starts.
//   - Each lane's substitution score is loaded from the query one
//     wavefront ahead, so its shared-memory load is off the chain.
// Each candidate ends at its last live wavefront, qlen + tlen - 2 (a
// qlen-0 or tlen-0 candidate at once); the rows after it are zero in the
// plain version and the Pallas kernel, and the block writes them as one
// run of 16-byte stores (dp_band.py::extd2_band states the invariant;
// tests/test_torch_band.py holds the Pallas kernel to it). When lo_al
// advances by delta lanes (after the walker has read its taps), the seven
// state arrays shift down by delta through shared memory together, the
// entering lanes take the init values, and x, v, x2, u are published again
// (four barriers): once per ~256 wavefronts. The query sits in shared
// memory as bytes (Lmax reaches 32,768 in the largest bucket); above 48 KB
// of shared memory the launch raises the kernel's dynamic shared-memory
// limit first.
//
// What bounds it on this card: qlen + tlen - 1 serial wavefronts per
// candidate (up to R = round64(Lmax+Lt-1)), each behind one block barrier,
// with ~57 integer operations per live band lane (e.g. ~4,200 of the 9,216
// wavefronts x ~300 live lanes of the 768-lane window at the (4096, 5120)
// HiFi bucket with bw 500). The dirs stream, N*R*WB bytes written once in
// coalesced rows, is a small share of the card's HBM bandwidth. So it is
// bound by the serial chain of a wavefront: the barrier, then the
// instructions the threads of the band execute in turn (measured on the
// card, a step followed the per-thread instruction count more than the
// barriers; chip_smoke.py reports us per wavefront step). A chunk of
// <= 128 candidates fills at most one block per SM; threads over the band
// only, or a candidate across a cluster of blocks, are later levers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegInf = -0x40000000;
constexpr int kMaxThreads = 1024;
constexpr int kArrays = 8;  // shared int arrays of WB: 2 x (x, v, x2, u)

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
  // exchange buffer p (p = r & 1), [4][WB] at ex + 4*p*WB: the old x, v,
  // x2 that the lane t-1 neighbours read, and u; the walker reads the H0
  // taps from v and u. The eight arrays are also the window shift's scratch.
  int* ex = smem;
  uint8_t* sq = reinterpret_cast<uint8_t*>(ex + 8 * WB);  // [Lmax] query

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
  // sv: each lane's substitution score at the next wavefront, loaded one
  // wavefront ahead so that its shared-memory load is off the chain
  int u[LPT], v[LPT], x[LPT], y[LPT], x2[LPT], y2[LPT], s[LPT], tq[LPT],
      sv[LPT];
  __syncthreads();  // the query
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    u[k] = v[k] = x[k] = y[k] = -qe;
    x2[k] = y2[k] = -qe2;
    s[k] = 0;
    const int lane = k * nt + t;
    tq[k] = lane < Lt ? (int)trow[lane] : 0;
    sv[k] = subst(tq[k], sq, -lane, qlen, sc);
  }
  int lo = 0;  // lo_al(0) == 0
  int last_st = -1, last_en = -1;
  // the H0 walk (thread 0): wavefront pr's st0, en0, window base, liveness
  int H0 = 0, lt = 0, score = kNegInf;
  int pr = -1, p_st0 = 0, p_en0 = 0, p_lo = 0;
  bool p_live = false;
  int ustep = 0;  // r % unroll
  uint8_t* dst = drow;  // dirs row r

  for (int r = 0; r <= r_end; ++r) {
    const int p = r & 1;
    int* const xo = ex + 4 * p * WB;
    int* const vo = xo + WB;
    int* const x2o = vo + WB;
    int* const uo = x2o + WB;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = k * nt + t;
      xo[j] = x[k];
      vo[j] = v[k];
      x2o[j] = x2[k];
      uo[j] = u[k];
    }
    __syncthreads();  // the one barrier of a wavefront

    if (t == 0 && p_live) {  // wavefront r-1's H0 walk, its taps clipped
      const int v_lt = vo[min(max(lt - p_lo, 0), WB - 1)];
      const int u_lt1 = uo[min(max(lt + 1 - p_lo, 0), WB - 1)];
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
        const int delta = nlo - lo;
        __syncthreads();  // the walker's reads are done
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const int j = k * nt + t;
          ex[j] = u[k];
          ex[WB + j] = v[k];
          ex[2 * WB + j] = x[k];
          ex[3 * WB + j] = y[k];
          ex[4 * WB + j] = x2[k];
          ex[5 * WB + j] = y2[k];
          ex[6 * WB + j] = s[k];
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          const int src = k * nt + t + delta;
          const bool in = src < WB;
          u[k] = in ? ex[src] : -qe;
          v[k] = in ? ex[WB + src] : -qe;
          x[k] = in ? ex[2 * WB + src] : -qe;
          y[k] = in ? ex[3 * WB + src] : -qe;
          x2[k] = in ? ex[4 * WB + src] : -qe2;
          y2[k] = in ? ex[5 * WB + src] : -qe2;
          s[k] = in ? ex[6 * WB + src] : 0;
          const int lane = nlo + k * nt + t;
          tq[k] = lane < Lt ? (int)trow[lane] : 0;
          sv[k] = subst(tq[k], sq, r - lane, qlen, sc);
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < LPT; ++k) {  // publish the shifted state again
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

#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int j = k * nt + t;
      const int lane = lo + j;
      const bool in_band = live && lane >= st && lane <= en;
      uint8_t dout = 0;
      if (in_band) {
        if (lane == r) {  // edge-lane init (en >= r here)
          y[k] = -qe;
          y2[k] = -qe2;
          u[k] = bu;
        }
        if (lane >= st0 && lane < s_end) s[k] = sv[k];
        const int jp = j == 0 ? WB - 1 : j - 1;  // rotate over the window
        int xp = xo[jp], vp = vo[jp], x2p = x2o[jp];
        if (lane == st) {
          if (!prev_ok) {
            xp = -qe;
            x2p = -qe2;
          }
          vp = st > 0 ? (prev_ok ? vp : -qe) : bu;
        }
        const int a_ = xp + vp, b_ = y[k] + u[k], a2_ = x2p + vp,
                  b2_ = y2[k] + u[k];
        // running max with the strict tie rule: keep is (zv >= term)
        bool keep;
        int zv = __vibmax_s32(s[k], a_, &keep);
        int d = keep ? 0 : 1;
        zv = __vibmax_s32(zv, b_, &keep);
        d = keep ? d : 2;
        zv = __vibmax_s32(zv, a2_, &keep);
        d = keep ? d : 3;
        zv = __vibmax_s32(zv, b2_, &keep);
        d = keep ? d : 4;
        zv = min(zv, sc.a);
        const int mq = sc.q - zv, mq2 = sc.q2 - zv;
        // max(term - (zv - q), 0): positive exactly when the gap extends
        const int xr = __viaddmax_s32_relu(a_, mq, 0);
        const int yr = __viaddmax_s32_relu(b_, mq, 0);
        const int x2r = __viaddmax_s32_relu(a2_, mq2, 0);
        const int y2r = __viaddmax_s32_relu(b2_, mq2, 0);
        v[k] = zv - u[k];
        u[k] = zv - vp;
        x[k] = xr - qe;
        y[k] = yr - qe;
        x2[k] = x2r - qe2;
        y2[k] = y2r - qe2;
        d |= (xr > 0 ? 0x08 : 0) | (yr > 0 ? 0x10 : 0) | (x2r > 0 ? 0x20 : 0) |
             (y2r > 0 ? 0x40 : 0);
        dout = (uint8_t)d;
      } else if (live && lane >= st0 && lane < s_end) {
        s[k] = sv[k];  // the 16-aligned score span reaches past en
      }
      dst[j] = dout;
    }
    dst += WB;
#pragma unroll
    for (int k = 0; k < LPT; ++k)
      sv[k] = subst(tq[k], sq, r + 1 - (lo + k * nt + t), qlen, sc);

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

template <int LPT>
int launch(const void* query, const void* target, const void* qlens,
           const void* tlens, const void* bands, void* score, void* dirs,
           int64_t N, int64_t Lmax, int64_t Lt, int64_t T, int64_t R,
           int64_t WB, int w_max, int unroll, const Scoring& sc,
           cudaStream_t stream) {
  const int threads = (int)(WB / LPT);
  const size_t shm = kArrays * (size_t)WB * sizeof(int) + (size_t)Lmax;
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
  if (WB <= 0 || WB % 128 != 0 || WB > 4 * kMaxThreads || WB >= T ||
      unroll <= 0)
    return (int)cudaErrorInvalidValue;
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  cudaStream_t s = (cudaStream_t)stream;
  if (WB <= 2 * kMaxThreads)
    return launch<2>(query, target, qlens, tlens, bands, score, dirs, N, Lmax,
                     Lt, T, R, WB, w_max, unroll, sc, s);
  return launch<4>(query, target, qlens, tlens, bands, score, dirs, N, Lmax,
                   Lt, T, R, WB, w_max, unroll, sc, s);
}
