// Antidiagonal backtrack (ksw_backtrack, ksw2.h:131-163) of the DP
// direction bytes, for NVIDIA Hopper (sm_90a).
//
// Replaces gdiet_tpu/pipeline/device_step.py::_backtrack_antidiag (an XLA
// scan there, not a Pallas kernel) on every path: the short-read step
// (single-end and paired-end, folded or not) and the long-read DP buckets.
// It writes exactly what
// gdiet_tpu_torch/pipeline/device_step.py::backtrack_antidiag writes for
// the same dirs: ops[N][Rpad] back to front, the op taken on antidiagonal r
// at column Rpad-1-r, 255 on every other column, and the walk's end point
// (fin_i, fin_j). Lane i of antidiagonal r sits at column
// clip(i - lo(r), 0, Wd-1) of row r, in one of three layouts
// (ops/dp_band.py::lane_offset gives lo):
//   - the banded window of csrc/extd2_band.cu, dirs[N][R][WB]: lo(r) is
//     the window base lo_al of the grid step r0 = r / unroll * unroll;
//   - the full width of csrc/extd2.cu, dirs[N][R][Wd]: lo(r) = 0;
//   - the raw folded layout of csrc/extd2_fold.cu,
//     dirs[(C+1)*H][Nrows][Wd]: candidate n = c*Nrows + k reads row r from
//     slice c*H + r, so its rows start at ((n / Nrows)*H*Nrows + n % Nrows)
//     * Wd and lie Nrows*Wd apart; lo(r) = -32 (the fold's lane gap) for
//     r >= H, else 0. With H = R and Nrows = 1 this is the full width.
//
// The plain version steps all candidates in lock-step over r = R-1 .. 0 and
// a candidate acts only where i + j == r; every act lowers i + j, so a
// serial walk from (tlen-1, qlen-1) visits the same antidiagonals and
// writes the same columns.
//
// Design: one block of one warp per candidate, spread over the SMs. The
// 32 lanes walk the same path in lock-step (each step reads one byte that
// all lanes load as a broadcast), so the walk has no divergence and every
// lane knows where the walk stands when the warp stages the next tile:
//   - Within K steps the walk lowers r by K to 2K and i by at most K, so
//     every byte it can read lies in rows [r - 2K + 1, r] and, in row rr,
//     in columns clip([i - K + 1, i] - lo(rr), 0, Wd - 1):
//     ops/dp_band.py::backtrack_tile, which tests/test_torch_band.py
//     holds against the plain walk. With K = kLook = 32: 64 rows of at
//     most 48 bytes (the columns widened to 16-byte chunks).
//   - The walk goes in blocks of kBlk = 16 steps. At the start of block k
//     the warp stages the tile of its position (K = 32 steps ahead) into
//     one of two shared buffers with cp.async 16-byte copies, and walks
//     block k on the tile staged at block k-1 (which covers the 32 steps
//     from there), so the copies of tile k are in flight while block k is
//     walked. Block 0 waits for its own tile.
//   - With a tile the warp also writes each row's band limits and column
//     offsets (off_r, off_end, lo_al, first staged column) to shared
//     memory. Each step loads the limits of both rows the next step can be
//     on (r-1, r-2) before it knows which, so a step's dependent chain is:
//     the column, the dirs byte (one load), the state update by selects
//     and bit tables, no branch.
//   - The op row is built in shared memory, filled with 255 first, and
//     written out once in 16-byte (or 8-byte) coalesced stores.
//
// What bounds it on this card: the longest walk's chain of dependent steps
// (~qlen + tlen of them), each a shared-memory load and the state update;
// the bytes moved (one dirs byte and one op byte per step, the op rows)
// are negligible. Its serial floor is the longest walk's steps times one
// shared-memory load's latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 16;           // walk steps per block of the walk
constexpr int kLook = 2 * kBlk;    // steps a staged tile covers (K)
constexpr int kRows = 2 * kLook;   // rows [r - 2K + 1, r]
constexpr int kSlot = 48;          // bytes per row: K columns in 16-byte chunks
constexpr int kTile = kRows * kSlot;
// a step reads the limits of the next two rows ahead; rows past the tile
// (and before antidiagonal 0) are never staged, and the walk never
// steps onto them within a block
constexpr int kRowsPad = kRows + 2;
constexpr int kFoldGap = 32;  // the folded layout's lane gap (ops/dp_fold.py)
// per ns (the ksw state 0-4): CIGAR op (2 bits each; CIGAR_MATCH 0,
// CIGAR_INS 1, CIGAR_DEL 2 of ops/dp.py), whether i and j step down
constexpr unsigned kOpOf = 0u | (2u << 2) | (1u << 4) | (2u << 6) | (1u << 8);
constexpr unsigned kStepI = 0b01011u;  // ns 0, 1, 3
constexpr unsigned kStepJ = 0b10101u;  // ns 0, 2, 4

// lo(r) of the layout (see the top of the file)
struct Layout {
  int Wd, T, WB, w_max, umask, H;
};

__device__ __forceinline__ int row_lo(int r, const Layout& L) {
  if (L.WB == 0) return r >= L.H ? -kFoldGap : 0;
  const int WB = L.WB, T = L.T;
  const int r0 = r & ~L.umask;  // unroll is a power of two
  const int lo = ((r0 - L.w_max + 1) >> 1) - 16;
  return min(max(lo, 0), T - WB) & ~127;
}

__device__ __forceinline__ int clip(int c, int Wd) {
  return min(max(c, 0), Wd - 1);
}

// the first staged column of row rr for a tile based at lane ib
__device__ __forceinline__ int tile_col0(int ib, int lo, int Wd) {
  return clip(ib - kLook + 1 - lo, Wd) & ~15;
}

struct Cand {
  int qlen, tlen, w;
};

// backtrack_tile(rb, ib, kLook) of ops/dp_band.py, copied into buf: row rr
// at slot rb - rr, from column tile_col0 on; rows[slot] = the row's
// (off_r, off_end, lo, first staged column), the band limits that force
// the op as ops/dp.py::band_geometry gives them. The candidate's row rr
// starts at drow + rr * rstride.
__device__ __forceinline__ void stage_tile(uint8_t* buf, int4* rows,
                                           const uint8_t* __restrict__ drow,
                                           size_t rstride, int rb, int ib,
                                           const Layout& L, Cand c) {
  const int lane = threadIdx.x;
  const int Wd = L.Wd, T = L.T;
  for (int sl = lane; sl < kRows; sl += 32) {
    const int rr = rb - sl;
    if (rr < 0) break;
    const int lo = row_lo(rr, L);
    const int c0 = tile_col0(ib, lo, Wd);
    const int st0 = __vimax3_s32(0, rr - c.qlen + 1, (rr - c.w + 1) >> 1);
    const int en0 = __vimin3_s32(c.tlen - 1, rr, (rr + c.w) >> 1);
    const bool live = (st0 <= en0) && (rr < c.qlen + c.tlen - 1);
    rows[sl] = make_int4(live ? (st0 & ~15) : T,
                         live ? min(((en0 + 16) & ~15) - 1, T - 1) : -1, lo, c0);
    const int c_hi = clip(ib - lo, Wd);
    const uint8_t* src = drow + (size_t)rr * rstride;
    const unsigned dst =
        (unsigned)__cvta_generic_to_shared(buf + sl * kSlot);
#pragma unroll
    for (int c = 0; c < kSlot / 16; ++c) {
      if (c0 + 16 * c <= c_hi) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         dst + 16 * c),
                     "l"(src + c0 + 16 * c));
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_tiles() {
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncwarp();
}

__global__ void __launch_bounds__(32)
backtrack_band_kernel(const uint8_t* __restrict__ dirs,
                      const int32_t* __restrict__ qlens,
                      const int32_t* __restrict__ tlens,
                      const int32_t* __restrict__ bands,
                      uint8_t* __restrict__ ops, int32_t* __restrict__ fin_i,
                      int32_t* __restrict__ fin_j, int Rpad, int Nrows,
                      Layout L) {
  extern __shared__ __align__(16) uint8_t sm[];
  int4* rows = reinterpret_cast<int4*>(sm);          // [2][kRowsPad]
  uint8_t* tiles = sm + 2 * kRowsPad * sizeof(int4);  // [2][kTile]
  uint8_t* sops = tiles + 2 * kTile;                 // [Rpad] the op row
  const int n = blockIdx.x;
  const int lane = threadIdx.x;
  const Cand cand{qlens[n], tlens[n], bands[n]};
  const int Wd = L.Wd;
  // the candidate's row 0 and the distance between its rows: n = c*Nrows +
  // k reads slice c*H + r at row k (Nrows = 1, H = R: dirs[n][r])
  const size_t rstride = (size_t)Nrows * Wd;
  const uint8_t* drow =
      dirs + ((size_t)(n / Nrows) * L.H * Nrows + n % Nrows) * Wd;
  for (int k = lane; k < Rpad / 8; k += 32)
    reinterpret_cast<uint2*>(sops)[k] = make_uint2(~0u, ~0u);

  int i = cand.tlen - 1, j = cand.qlen - 1, state = 0;
  bool active = cand.qlen > 0 && cand.tlen > 0;
  for (int blk = 0, sr = 0; active; ++blk) {
    // sr: the walk's antidiagonal where the last tile was staged (the
    // columns of the tile's rows, from the walk's lane then, are in rows)
    const int rb = blk == 0 ? i + j : sr;
    const int wb = blk == 0 ? 0 : (blk - 1) & 1;  // the buffer walked
    const uint8_t* tile = tiles + wb * kTile;
    const int4* trows = rows + wb * kRowsPad;
    if (blk > 0) wait_tiles();  // tile blk-1 has landed; tile blk-2 is walked
    stage_tile(tiles + (blk & 1) * kTile, rows + (blk & 1) * kRowsPad, drow,
               rstride, i + j, i, L, cand);
    sr = i + j;
    if (blk == 0) wait_tiles();  // block 0 walks its own tile
    // the current row's (off_r, off_end, lo, first column); each step
    // loads the two rows the next step can be on before it knows which
    int4 rw = trows[rb - (i + j)];
    for (int step = 0; step < kBlk && active; ++step) {
      const int r = i + j;
      const int sl = rb - r;  // the row's slot
      const int4 rw1 = trows[sl + 1], rw2 = trows[sl + 2];
      // i stays within the tile's lanes, so the byte is in the tile even
      // where the band forces the op and it is not used
      const int tmp = tile[sl * kSlot + clip(i - rw.z, Wd) - rw.w];
      const int force = i > rw.y ? 1 : (i < rw.x ? 2 : -1);
      const bool keep = state != 0 && ((tmp >> (state + 2)) & 1);
      const int ns = force >= 0 ? force : (keep ? state : (tmp & 7));
      sops[Rpad - 1 - r] = (uint8_t)((kOpOf >> (2 * ns)) & 3);
      const int di = (kStepI >> ns) & 1, dj = (kStepJ >> ns) & 1;
      i -= di;
      j -= dj;
      rw = di & dj ? rw2 : rw1;
      state = ns;
      active = i >= 0 && j >= 0;
    }
  }
  wait_tiles();  // no copy may land after the block ends
  if (lane == 0) {
    fin_i[n] = i;
    fin_j[n] = j;
  }
  uint8_t* orow = ops + (size_t)n * Rpad;
  if (Rpad % 16 == 0) {
    for (int k = lane; k < Rpad / 16; k += 32)
      reinterpret_cast<uint4*>(orow)[k] = reinterpret_cast<const uint4*>(sops)[k];
  } else {
    for (int k = lane; k < Rpad / 8; k += 32)
      reinterpret_cast<uint2*>(orow)[k] = reinterpret_cast<const uint2*>(sops)[k];
  }
}

}  // namespace

// C entry point (bound with ctypes). Device pointers; R antidiagonals per
// walk, T = round128(Lt) for the band limits. WB > 0 reads the banded
// window of width WB (= Wd) built with band budget w_max and `unroll` (a
// power of two) wavefronts per grid step; WB = 0 the folded layout of H
// wavefronts per pass and Nrows kernel rows (R = 2H), which with H = R and
// Nrows = 1 is the full width. Wd must be a multiple of 16 (round16(Lt),
// WB or the fold's lane width) and Rpad of 8. Launches on `stream` and
// returns a CUDA error code.
extern "C" int gdiet_backtrack_band(const void* dirs, const void* qlens,
                                    const void* tlens, const void* bands,
                                    void* ops, void* fin_i, void* fin_j,
                                    int64_t N, int64_t R, int64_t Wd, int64_t T,
                                    int64_t Rpad, int64_t WB, int64_t H,
                                    int64_t Nrows, int w_max, int unroll,
                                    void* stream) {
  if (N <= 0) return 0;
  if (Wd <= 0 || Wd % 16 != 0 || Rpad % 8 != 0 || Rpad < R || unroll <= 0 ||
      (unroll & (unroll - 1)) != 0 || Nrows <= 0 || H <= 0 ||
      (WB == 0 && R > 2 * H) || (WB > 0 && (Nrows != 1 || H != R)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t shm = 2 * (kRowsPad * sizeof(int4) + (size_t)kTile) + (size_t)Rpad;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        backtrack_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  backtrack_band_kernel<<<(unsigned)N, 32, shm, s>>>(
      static_cast<const uint8_t*>(dirs), static_cast<const int32_t*>(qlens),
      static_cast<const int32_t*>(tlens), static_cast<const int32_t*>(bands),
      static_cast<uint8_t*>(ops), static_cast<int32_t*>(fin_i),
      static_cast<int32_t*>(fin_j), (int)Rpad, (int)Nrows,
      Layout{(int)Wd, (int)T, (int)WB, w_max, unroll - 1, (int)H});
  return (int)cudaGetLastError();
}
