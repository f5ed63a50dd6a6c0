// Location voting (vote, GDiet-ShortReads map.c:447-584) over the
// short-read step's hit stream, for NVIDIA Hopper (sm_90a).
//
// Replaces gdiet_tpu/pipeline/device_step.py::_vote_scan (a lax.scan there,
// not a Pallas kernel). It returns exactly what
// gdiet_tpu_torch/pipeline/device_step.py::vote_scan returns for the
// concatenated stream fwd | barrier | rev | barrier: per read, the top-K
// runs kept by the reference's insertion (score, target, first and last
// query position, strand; out_len of them) and the recovery candidate
// (r_*). A run is a maximal stretch of valid columns of one half whose keys
// (chrom << 32 | projected position, compared as unsigned 64-bit values)
// stay within vt_distance of the run's head; the head moves to the column
// with the smallest query position. When a run ends, the reference inserts
// it into the sorted slot list if its count beats vt_threshold (the last
// slot is overwritten once the list is full, if the run beats it), and
// otherwise, while the list is empty, keeps it as the recovery candidate if
// it beats vt_rec_threshold and the candidate so far. The insertion is one
// backward bubble pass from the written slot. Filled slots hold counts >= 1
// in non-increasing order (slots past out_len are never compared), so the
// pass stops at the first pair it does not swap: the plain version's full
// pass over every slot pair swaps nothing more.
//
// Design: one warp per block follows 32 reads, one thread per read. The
// halves are read in place, in column tiles staged through shared memory
// (vote_tile.cuh: coalesced loads, no key or position load for an invalid
// column, and a stop after each half's last valid tile).
// The run state and the recovery candidate live in registers. A slot holds
// 12 bytes: the count with the strand in bit 31, and the columns of the
// run's head and of its last query position. The target and both query
// positions are those columns' key and positions (the head and fq move
// together; lq is a column's position), gathered from the stream once at
// the end. K slots are [K][32] per field in shared memory up to
// kMaxSmemSlots (a block's tile and slots within 48 KB: at K = 20, 11,136
// bytes, so shared memory would let 19 blocks share an SM and the 128
// registers of ptxas 16, and the 2,048 blocks of a 65,536-read batch run in
// one wave on 132 SMs); the slot rows are written out through the tile,
// field by field, with contiguous stores. Beyond kMaxSmemSlots the slots
// live in the output rows (k_score, k_fq, k_lq) and are converted in place.
//
// What bounds it on this card: the bytes any implementation must read,
// the valid flags (up to each half's end) and 12 bytes
// per valid column, over 3.35 TB/s, or the serial chain of one row's
// columns (a compare, the unsigned distance test and the run update per
// column, plus the bubble pass on a run's end), whichever is larger.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_tile.cuh"

namespace {

using vote_tile::Halves;
using vote_tile::Tile;

constexpr int kThreads = 32;
constexpr int kSlotBytes = 12;  // count | strand << 31, head column, lq column
constexpr int kSmemBudget = 48 * 1024;
constexpr int kMaxSmemSlots =
    (kSmemBudget - (int)sizeof(Tile<kThreads>)) / (kThreads * kSlotBytes);
constexpr uint32_t kScore = 0x7fffffffu;

struct Slots {
  uint32_t* s;  // count | strand << 31
  int32_t* h;   // column of the run's head (target, fq)
  int32_t* l;   // column of the run's lq
  int stride;
};

struct Out {
  int32_t* k_score;
  int64_t* k_target;
  int32_t* k_fq;
  int32_t* k_lq;
  int32_t* k_str;
  int32_t* out_len;
  int32_t* r_score;
  int64_t* r_target;
  int32_t* r_fq;
  int32_t* r_lq;
  int32_t* r_str;
};

__device__ __forceinline__ void swap_slots(const Slots& S, int a, int b) {
  const int ia = a * S.stride, ib = b * S.stride;
  const uint32_t s = S.s[ia];
  S.s[ia] = S.s[ib];
  S.s[ib] = s;
  int32_t x = S.h[ia];
  S.h[ia] = S.h[ib];
  S.h[ib] = x;
  x = S.l[ia];
  S.l[ia] = S.l[ib];
  S.l[ib] = x;
}

__global__ void __launch_bounds__(kThreads)
vote_scan_kernel(Halves H, const int64_t* __restrict__ vt_distance,
                 const int32_t* __restrict__ vt_threshold,
                 const int32_t* __restrict__ vt_rec_threshold, Out out, int64_t B, int K,
                 int smem_slots) {
  extern __shared__ __align__(16) unsigned char vote_smem[];
  Tile<kThreads>& sm = *reinterpret_cast<Tile<kThreads>*>(vote_smem);
  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int64_t b = row0 + threadIdx.x;
  const bool live = b < B;  // a thread past the end still loads its share

  Slots S;
  if (smem_slots) {
    const int n = K * kThreads;
    uint32_t* s = reinterpret_cast<uint32_t*>(vote_smem + sizeof(Tile<kThreads>));
    int32_t* c = reinterpret_cast<int32_t*>(s + n);
    S = Slots{s + threadIdx.x, c + threadIdx.x, c + n + threadIdx.x, kThreads};
  } else {
    const int64_t o = live ? b * K : 0;  // rows past B never emit
    S = Slots{reinterpret_cast<uint32_t*>(out.k_score) + o, out.k_fq + o, out.k_lq + o, 1};
  }

  const uint64_t dist = live ? (uint64_t)vt_distance[b] : 0;
  const int32_t thr = live ? vt_threshold[b] : 0;
  const int32_t rec_thr = live ? vt_rec_threshold[b] : 0;

  uint64_t head_t = 0;
  bool head_valid = false;
  int32_t fq = 0, lq = 0, cnt = 0, mh = 0, ml = 0, out_len = 0;
  int32_t r_score = 0, r_fq = 0, r_lq = 0, r_str = 0;
  uint64_t r_target = 0;

  // a finished run of half h: insert it or keep it for recovery
  auto emit = [&](int h) {
    if (cnt > thr) {
      const bool full = out_len == K;
      if (full && (int32_t)(S.s[(K - 1) * S.stride] & kScore) >= cnt) return;
      int kk = full ? K - 1 : out_len;
      const int i = kk * S.stride;
      S.s[i] = (uint32_t)cnt | ((uint32_t)h << 31);
      S.h[i] = mh;
      S.l[i] = ml;
      for (; kk > 0 && (S.s[kk * S.stride] & kScore) > (S.s[(kk - 1) * S.stride] & kScore);
           --kk)
        swap_slots(S, kk, kk - 1);
      if (!full) ++out_len;
    } else if (out_len == 0 && cnt > rec_thr && cnt > r_score) {
      r_score = cnt;
      r_target = head_t;
      r_fq = fq;
      r_lq = lq;
      r_str = h;
    }
  };

  vote_tile::walk<kThreads>(
      H, row0, B, sm,
      [&](int h, int c, uint64_t t, int32_t q) {
        if (head_valid && t - head_t <= dist) {
          if (q < fq) {
            fq = q;
            head_t = t;
            mh = c;
          }
          if (q > lq) {
            lq = q;
            ml = c;
          }
          ++cnt;
        } else {
          if (head_valid) emit(h);
          head_t = t;
          fq = lq = q;
          mh = ml = c;
          cnt = 1;
          head_valid = true;
        }
      },
      [&](int h) {
        if (head_valid) emit(h);
        head_valid = false;
      });

  if (live) {
    out.out_len[b] = out_len;
    out.r_score[b] = r_score;
    out.r_target[b] = (int64_t)r_target;
    out.r_fq[b] = r_fq;
    out.r_lq[b] = r_lq;
    out.r_str[b] = r_str;
  }
  const int64_t row = b * H.ld;
  const int64_t* K0 = H.k[0];
  const int64_t* K1 = H.k[1];
  const int32_t* Q0 = H.q[0];
  const int32_t* Q1 = H.q[1];
  // field f of slot k: score, target, fq, lq, strand (empty: -1, 0, 0, 0, 0)
  auto field = [&](int f, int k) -> int64_t {
    if (k >= out_len) return f == 0 ? -1 : 0;
    const int i = k * S.stride;
    const uint32_t sw = S.s[i];
    const bool rev = sw >> 31;
    switch (f) {
      case 0: return (int32_t)(sw & kScore);
      case 1: return (rev ? K1 : K0)[row + S.h[i]];
      case 2: return (rev ? Q1 : Q0)[row + S.h[i]];
      case 3: return (rev ? Q1 : Q0)[row + S.l[i]];
      default: return rev;
    }
  };
  if (!smem_slots) {  // the slots are the output rows: convert in place
    if (!live) return;
    for (int k = 0; k < K; ++k) {
      int64_t v[5];
      for (int f = 0; f < 5; ++f) v[f] = field(f, k);  // read before any write
      const int64_t o = b * K + k;
      out.k_score[o] = (int32_t)v[0];
      out.k_target[o] = v[1];
      out.k_fq[o] = (int32_t)v[2];
      out.k_lq[o] = (int32_t)v[3];
      out.k_str[o] = (int32_t)v[4];
    }
    return;
  }
  // The block's output rows are contiguous: they go through the (now free)
  // tile in chunks of whole rows and are written out by the warp with
  // contiguous stores (a thread's own K elements are K apart otherwise).
  // Pass 0 stages score and strand (8 bytes a slot), pass 1 the target,
  // fq and lq gathered from the stream (16 bytes a slot, loads overlapped).
  __syncwarp();
  const int nrows = (int)(B - row0 < kThreads ? B - row0 : kThreads);
  for (int pass = 0; pass < 2; ++pass) {
    const int fit = (int)sizeof(Tile<kThreads>) / ((pass ? 16 : 8) * K);
    const int chunk = fit < kThreads ? fit : kThreads;
    int64_t* t64 = reinterpret_cast<int64_t*>(vote_smem);            // target
    int32_t* a32 = reinterpret_cast<int32_t*>(vote_smem) + (pass ? 2 * chunk * K : 0);
    int32_t* b32 = a32 + chunk * K;  // pass 0: score, strand; pass 1: fq, lq
    for (int r0 = 0; r0 < nrows; r0 += chunk) {
      const int r = threadIdx.x - r0;
      if (live && r >= 0 && r < chunk) {
        for (int k = 0; k < K; ++k) {
          const int e = r * K + k;
          if (pass == 0) {
            a32[e] = (int32_t)field(0, k);
            b32[e] = (int32_t)field(4, k);
          } else {
            t64[e] = field(1, k);
            a32[e] = (int32_t)field(2, k);
            b32[e] = (int32_t)field(3, k);
          }
        }
      }
      __syncwarp();
      const int n = (nrows - r0 < chunk ? nrows - r0 : chunk) * K;
      const int64_t o = (row0 + r0) * K;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        if (pass == 0) {
          out.k_score[o + i] = a32[i];
          out.k_str[o + i] = b32[i];
        } else {
          out.k_target[o + i] = t64[i];
          out.k_fq[o + i] = a32[i];
          out.k_lq[o + i] = b32[i];
        }
      }
      __syncwarp();
    }
  }
}

}  // namespace

// C entry point (bound with ctypes). Device pointers: the halves fk, fq,
// fok, rk, rq, rok ([B][ld] int64 / int32 / bool, A columns of each row
// used), vt_distance [B] int64, vt_threshold and vt_rec_threshold [B]
// int32; outputs k_score, k_fq, k_lq, k_str [B][K] int32, k_target [B][K]
// int64, out_len, r_score, r_fq, r_lq, r_str [B] int32, r_target [B] int64.
// K >= 1, 0 <= A <= ld, 2A + 2 < 2^31, and the valid columns of each half
// of each row come first (vote_tile.cuh). Launches on `stream` and returns
// a CUDA error code.
extern "C" int gdiet_vote_scan(const void* fk, const void* fq, const void* fok,
                               const void* rk, const void* rq, const void* rok, int64_t ld,
                               const void* vt_distance, const void* vt_threshold,
                               const void* vt_rec_threshold, void* k_score, void* k_target,
                               void* k_fq, void* k_lq, void* k_str, void* out_len,
                               void* r_score, void* r_target, void* r_fq, void* r_lq,
                               void* r_str, int64_t B, int64_t A, int K,
                               void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || A < 0 || A > ld || 2 * A + 2 >= (int64_t)1 << 31)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int smem_slots = K <= kMaxSmemSlots;
  const size_t shm = sizeof(Tile<kThreads>) + (smem_slots ? (size_t)K * kThreads * kSlotBytes : 0);
  // the most shared memory per SM (at K = 20 the slots would let 19
  // blocks share an SM), set at the first launch: it costs host time
  static bool carveout_set = false;
  if (!carveout_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        vote_scan_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return (int)err;
    carveout_set = true;
  }
  const Halves H{{static_cast<const int64_t*>(fk), static_cast<const int64_t*>(rk)},
                 {static_cast<const int32_t*>(fq), static_cast<const int32_t*>(rq)},
                 {static_cast<const uint8_t*>(fok), static_cast<const uint8_t*>(rok)},
                 ld,
                 A};
  const Out out{static_cast<int32_t*>(k_score), static_cast<int64_t*>(k_target),
                static_cast<int32_t*>(k_fq),    static_cast<int32_t*>(k_lq),
                static_cast<int32_t*>(k_str),   static_cast<int32_t*>(out_len),
                static_cast<int32_t*>(r_score), static_cast<int64_t*>(r_target),
                static_cast<int32_t*>(r_fq),    static_cast<int32_t*>(r_lq),
                static_cast<int32_t*>(r_str)};
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  vote_scan_kernel<<<blocks, kThreads, shm, s>>>(
      H, static_cast<const int64_t*>(vt_distance), static_cast<const int32_t*>(vt_threshold),
      static_cast<const int32_t*>(vt_rec_threshold), out, B, K, smem_slots);
  return (int)cudaGetLastError();
}
