// Column tiles of a hit stream's two strand halves, staged through shared
// memory for the vote kernels (vote_scan.cu, vote_lr.cu). Included by both;
// ops/extd2.py hashes every csrc/*.cuh into each library's build tag.
//
// The stream of read b is read in place from the six [B][ld] tensors the
// hit collection returns: the forward half (fk, fq, fok) and the reverse
// half (rk, rq, rok), A columns each (A <= ld: the long-read front's
// vote_budget slice is a view). The plain versions walk the concatenation
// fwd | barrier | rev | barrier, where a barrier column is invalid. A run
// never spans an invalid column, so the strand of a valid head is the half
// it lies in, and each barrier is a call of gap(h) at the end of half h.
//
// Each warp follows R rows (R = 32: one row per lane; R = 16: two lanes per
// row). A tile is kCols columns of those R rows: R*kCols/32 load
// instructions, each lane loading one valid flag and, only where it is set,
// that column's 8-byte key and 4-byte query position. Four rows per
// instruction, eight consecutive columns per row: 64 contiguous key bytes
// per row (two 32-byte sectors), where one thread per row would touch 32
// rows' lines per instruction. A ballot per instruction gives
// each thread its row's 8-bit validity mask; the keys and positions go to
// shared memory ([R][kCols+1], padded against bank conflicts), from which
// each thread walks its row's columns in order. The next tile's keys and
// the flags of the one after are in flight while the warp walks the current
// tile.
//
// Skipped loads are exact on any stream: after an invalid column the head
// is not valid, so that column's key and position are never read back (the
// next valid column starts a new run, and the final emit requires a valid
// head); the walker calls gap(h) instead of valid(...) for it.
//
// Precondition: in each half of each row the valid columns come first
// (true of the hit collection's streams: each strand is sorted by key,
// invalid keys are U64_MAX and a valid key (chrom << 32 | position) is
// smaller, chrom being a reference index). So a row whose tile mask is not
// full has no valid column after that tile, and a warp stops reading a half
// after the first tile in which none of its rows is full.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vote_tile {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCols = 8;           // columns per tile
constexpr int kPitch = kCols + 1;  // a tile row in shared memory, padded

struct Halves {
  const int64_t* k[2];  // keys (uint64 bit patterns), [B][ld] each
  const int32_t* q[2];  // query positions
  const uint8_t* v[2];  // valid flags (one byte)
  int64_t ld;           // row stride of all six, in elements
  int64_t A;            // columns per half
};

template <int R>
struct Tile {
  uint64_t k[R * kPitch];
  int32_t q[R * kPitch];
};

// Walk rows row0 .. row0+R-1 (those < B) of both halves; every lane of the
// warp calls it together. Lane l follows row l / (32/R): valid(h, c, t, q)
// for each valid column c of half h in order, gap(h) for each invalid
// column and once at the end of each half (the barrier). Columns past A in
// a half's last tile count as invalid, as the barrier after them does.
template <int R, class Valid, class Gap>
__device__ __forceinline__ void walk(const Halves& H, int64_t row0, int64_t B, Tile<R>& sm,
                                     Valid valid, Gap gap) {
  constexpr int NI = R * kCols / 32;  // load instructions per tile
  const int lane = threadIdx.x & 31;
  const int my_r = lane / (32 / R);
  const int ld_r = lane >> 3, ld_c = lane & 7;  // row in a group of four, column
  const int64_t ntiles = (H.A + kCols - 1) / kCols;
  // instruction i reads row row0 + 4i + ld_r, at element off0 + i*step,
  // for i < n_ok (the rows below B)
  const int64_t rows_left = B - row0 - ld_r;
  const int n_ok = rows_left <= 0 ? 0 : (int)((rows_left + 3) / 4);
  const int64_t off0 = (row0 + ld_r) * H.ld, step = 4 * H.ld;
  for (int h = 0; h < 2; ++h) {
    const int64_t* __restrict__ K = h ? H.k[1] : H.k[0];
    const int32_t* __restrict__ Q = h ? H.q[1] : H.q[0];
    const uint8_t* __restrict__ V = h ? H.v[1] : H.v[0];
    auto flags = [&](int64_t t, uint8_t(&f)[NI]) {
      const int64_t col = t * kCols + ld_c;
#pragma unroll
      for (int i = 0; i < NI; ++i) f[i] = (i < n_ok && col < H.A) ? V[off0 + i * step + col] : 0;
    };
    uint8_t f_nxt[NI];  // tile t+2's flags, raw: they are read a tile later
    uint32_t f_cur = 0;  // tile t+1's flags, bit i for instruction i
    uint64_t kr[NI];
    int32_t qr[NI];
    auto take = [&]() {  // f_nxt becomes f_cur
      f_cur = 0;
#pragma unroll
      for (int i = 0; i < NI; ++i) f_cur |= (uint32_t)(f_nxt[i] != 0) << i;
    };
    auto keys = [&](int64_t t) {
      const int64_t col = t * kCols + ld_c;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        if ((f_cur >> i) & 1u) {
          kr[i] = (uint64_t)K[off0 + i * step + col];
          qr[i] = Q[off0 + i * step + col];
        }
      }
    };
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      kr[i] = 0;
      qr[i] = 0;
    }
    flags(0, f_nxt);
    take();
    keys(0);
    flags(1, f_nxt);
    for (int64_t t = 0; t < ntiles; ++t) {
      // stage tile t and take this row's mask from the ballots
      uint32_t m = 0;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const int s = (i * 4 + ld_r) * kPitch + ld_c;
        sm.k[s] = kr[i];
        sm.q[s] = qr[i];
        const uint32_t b = __ballot_sync(kFull, (f_cur >> i) & 1u);
        if ((my_r >> 2) == i) m = (b >> ((my_r & 3) * 8)) & 0xffu;
      }
      // tile t+1's keys and tile t+2's flags load during the walk
      take();
      keys(t + 1);
      flags(t + 2, f_nxt);
      __syncwarp();
      const int base = my_r * kPitch;
      const int c0 = (int)(t * kCols);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        if ((m >> c) & 1u)
          valid(h, c0 + c, sm.k[base + c], sm.q[base + c]);
        else
          gap(h);
      }
      __syncwarp();
      if (!__any_sync(kFull, m == 0xffu)) break;  // every row's half has ended
    }
    gap(h);
  }
}

}  // namespace vote_tile
