// Antidiagonal backtrack (ksw_backtrack, ksw2.h:131-163) of the DP
// direction bytes, for NVIDIA Hopper (sm_90a).
//
// Replaces gdiet_tpu/pipeline/device_step.py::_backtrack_antidiag on the
// long-read DP buckets (an XLA scan there, not a Pallas kernel). It writes
// exactly what gdiet_tpu_torch/pipeline/device_step.py::backtrack_antidiag
// writes for the same dirs: ops[N][Rpad] back to front, the op taken on
// antidiagonal r at column Rpad-1-r, 255 on every other column, and the
// walk's end point (fin_i, fin_j). Two dirs layouts are read:
//   - the banded window of csrc/extd2_band.cu, dirs[N][R][WB]: lane i of
//     wavefront r sits at column clip(i - lo_al(r), 0, WB-1), with
//     lo_al(r) the window base of the grid step r0 = r / unroll * unroll;
//   - the full width of csrc/extd2.cu, dirs[N][R][Wd]: column clip(i).
//
// Design: one thread per candidate, walking from (tlen-1, qlen-1) serially.
// The plain version steps all candidates in lock-step over r = R-1 .. 0 and
// a candidate acts only where i + j == r; every act lowers i + j, so a
// serial walk visits the same antidiagonals and writes the same columns.
// The op row is filled with 255 by one cudaMemsetAsync before the launch.
//
// What bounds it on this card: a chain of dependent byte loads from the
// dirs (~qlen + tlen steps per candidate), each an L2 or HBM latency; the
// bytes moved (one dirs byte and one op byte per step) are negligible.
// N threads run as N / 32 one-warp blocks: it is latency-bound, and its
// time is the longest walk's. Reading the dirs of the next steps ahead
// (they lie on a known diagonal band) is a later lever.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int floor16(int x) {
  return (x >= 0 ? x / 16 : -((-x + 15) / 16)) * 16;
}

__global__ void backtrack_band_kernel(const uint8_t* __restrict__ dirs,
                                      const int32_t* __restrict__ qlens,
                                      const int32_t* __restrict__ tlens,
                                      const int32_t* __restrict__ bands,
                                      uint8_t* __restrict__ ops,
                                      int32_t* __restrict__ fin_i,
                                      int32_t* __restrict__ fin_j, int N, int R,
                                      int Wd, int T, int Rpad, int WB,
                                      int w_max, int unroll) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int qlen = qlens[n];
  const int tlen = tlens[n];
  const int w = bands[n];
  const uint8_t* drow = dirs + (size_t)n * R * Wd;
  uint8_t* orow = ops + (size_t)n * Rpad;
  int i = tlen - 1, j = qlen - 1, state = 0;
  bool active = qlen > 0 && tlen > 0;
  while (active) {
    const int r = i + j;
    const int st0 = max(max(0, r - qlen + 1), (r - w + 1) >> 1);
    const int en0 = min(min(tlen - 1, r), (r + w) >> 1);
    const bool live = (st0 <= en0) && (r < qlen + tlen - 1) && (qlen > 0);
    const int off_r = live ? floor16(st0) : T;
    const int off_end = live ? min(floor16(en0 + 16) - 1, T - 1) : -1;
    const int force = i > off_end ? 1 : (i < off_r ? 2 : -1);
    int col = i;
    if (WB > 0) {
      const int r0 = r / unroll * unroll;
      int lo = ((r0 - w_max + 1) >> 1) - 16;
      lo = min(max(lo, 0), T - WB) / 128 * 128;
      col = i - lo;
    }
    col = min(max(col, 0), Wd - 1);
    const int tmp = force >= 0 ? 0 : (int)drow[(size_t)r * Wd + col];
    int ns = state == 0 ? (tmp & 7) : (((tmp >> (state + 2)) & 1) ? state : 0);
    if (ns == 0) ns = tmp & 7;
    if (force >= 0) ns = force;
    // CIGAR_MATCH 0, CIGAR_INS 1, CIGAR_DEL 2 (ops/dp.py)
    orow[Rpad - 1 - r] = ns == 0 ? 0 : ((ns == 1 || ns == 3) ? 2 : 1);
    i -= (ns == 0 || ns == 1 || ns == 3) ? 1 : 0;
    j -= (ns == 0 || ns == 2 || ns == 4) ? 1 : 0;
    state = ns;
    active = i >= 0 && j >= 0;
  }
  fin_i[n] = i;
  fin_j[n] = j;
}

}  // namespace

// C entry point (bound with ctypes). Device pointers; WB = 0 reads the
// full-width layout, WB > 0 the banded window of width WB (= Wd) built
// with band budget w_max and `unroll` wavefronts per grid step. Fills ops
// with 255, launches on `stream` and returns a CUDA error code.
extern "C" int gdiet_backtrack_band(const void* dirs, const void* qlens,
                                    const void* tlens, const void* bands,
                                    void* ops, void* fin_i, void* fin_j,
                                    int64_t N, int64_t R, int64_t Wd, int64_t T,
                                    int64_t Rpad, int64_t WB, int w_max,
                                    int unroll, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(ops, 0xFF, (size_t)N * Rpad, s);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32;  // one warp per block: spread over SMs
  backtrack_band_kernel<<<(unsigned)((N + threads - 1) / threads), threads, 0,
                          s>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const int32_t*>(qlens),
      static_cast<const int32_t*>(tlens), static_cast<const int32_t*>(bands),
      static_cast<uint8_t*>(ops), static_cast<int32_t*>(fin_i),
      static_cast<int32_t*>(fin_j), (int)N, (int)R, (int)Wd, (int)T, (int)Rpad,
      (int)WB, w_max, unroll);
  return (int)cudaGetLastError();
}
