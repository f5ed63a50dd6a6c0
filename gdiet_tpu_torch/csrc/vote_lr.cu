// The long-read votes (GDiet-LongReads map.c:1052-1271) over the long-read
// front's hit stream, for NVIDIA Hopper (sm_90a). Two entry points:
//
// gdiet_vote_lr, the round-1 vote, replaces
// gdiet_tpu/pipeline/lr_step.py::_vote_scan_lr (a lax.scan there, not a
// Pallas kernel) and returns exactly what
// gdiet_tpu_torch/pipeline/lr_step.py::_vote_scan_lr returns for the
// concatenated stream fwd | barrier | rev | barrier: the top-K runs by
// count (k_score, k_first_t, k_last_t, k_fq, k_lq, k_str; out_len of them).
// A run is a maximal stretch of valid columns of one half whose keys stay
// within vt_distance (unsigned 64-bit) of ref_loc, the key of the column
// with the smallest query position so far. It tracks the unsigned min and
// max of its columns' raw targets, raw = t - q on the reverse strand and
// t - (extracted - q) on the forward one (uint64 wraparound, lr_step.py:34).
// A run that ends is inserted if lq - fq > cov_thr; once the list is full
// it overwrites the last slot only if its count beats it. The insertion is
// one backward bubble pass from the written slot; filled slots hold counts
// >= 1 in non-increasing order (slots past out_len are never compared), so
// the pass stops at the first pair it does not swap: the plain version's
// full pass swaps nothing more.
//
// gdiet_vote2_pair, the round-2 vote of both query windows, replaces
// _vote2_scan (lr_step.py:146) run once per window, and writes the packed
// [B][16] int32 block of vote2_packed_pair (two blocks of score, fq, lq,
// str, first_t >> 32, first_t & U32, last_t >> 32, last_t & U32). A run
// restarts at any column that breaks it, whatever its window, but counts,
// and moves fq, ref_loc, lq and the raw span, only on in-window columns
// (lo < q < hi); the best run is the first with the largest count among
// those with lq < hi and fq > lo.
//
// Design: both read the strand halves in place through vote_tile.cuh's
// column tiles (coalesced loads, no key or position load for an invalid
// column, a stop after each half's last valid tile). Round 1: one thread
// per read, the run state in registers, the K slots in
// shared memory ([K][32] per field, 28 bytes a slot) up to kMaxSmemSlots,
// beyond that in the output rows. Round 2: one thread per (read, window),
// 16 reads per warp, two lanes per read's tile row; the run and the best
// run in registers.
//
// What bounds them on this card: the serial chain of one row's columns
// (the unsigned distance test, the raw target and its min/max, the run
// update; the bubble pass on a run's end) at the long-read front's batch
// (256 or 16 reads fill at most 8 of 132 SMs), and beside it the bytes any
// implementation must read, the valid flags (up to each half's end) and
// 12 bytes per valid column.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_tile.cuh"

namespace {

using vote_tile::Halves;
using vote_tile::Tile;

constexpr int kThreads = 32;
constexpr int kSlotBytes = 28;  // first_t, last_t; count | strand << 31, fq, lq
constexpr int kSmemBudget = 48 * 1024;
constexpr int kMaxSmemSlots =
    (kSmemBudget - (int)sizeof(Tile<kThreads>)) / (kThreads * kSlotBytes);
constexpr uint32_t kScore = 0x7fffffffu;
constexpr int kVote2Rows = 16;  // reads per warp in round 2, two windows each

struct Slots {
  uint64_t* ft;
  uint64_t* lt;
  uint32_t* s;  // count | strand << 31
  int32_t* f;
  int32_t* l;
  int stride;
};

struct Out1 {
  int32_t* k_score;
  int64_t* k_first_t;
  int64_t* k_last_t;
  int32_t* k_fq;
  int32_t* k_lq;
  int32_t* k_str;
  int32_t* out_len;
};

template <class T>
__device__ __forceinline__ void swap_at(T* p, int a, int b) {
  const T x = p[a];
  p[a] = p[b];
  p[b] = x;
}

// the hit's raw genomic anchor: the inverse of the diagonal projection
__device__ __forceinline__ uint64_t raw_target(int h, uint64_t t, int32_t q, uint64_t ex) {
  const uint64_t qq = (uint64_t)(int64_t)q;
  return h ? t - qq : t - (ex - qq);
}

__global__ void __launch_bounds__(kThreads)
vote_lr_kernel(Halves H, const int64_t* __restrict__ extracted,
               const int64_t* __restrict__ vt_distance, const int32_t* __restrict__ cov_thr,
               Out1 out, int64_t B, int K, int smem_slots) {
  extern __shared__ __align__(16) unsigned char vote_smem[];
  Tile<kThreads>& sm = *reinterpret_cast<Tile<kThreads>*>(vote_smem);
  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int64_t b = row0 + threadIdx.x;
  const bool live = b < B;  // a thread past the end still loads its share

  Slots S;
  if (smem_slots) {
    const int n = K * kThreads;
    uint64_t* w = reinterpret_cast<uint64_t*>(vote_smem + sizeof(Tile<kThreads>));
    uint32_t* s = reinterpret_cast<uint32_t*>(w + 2 * n);
    int32_t* c = reinterpret_cast<int32_t*>(s + n);
    const int x = threadIdx.x;
    S = Slots{w + x, w + n + x, s + x, c + x, c + n + x, kThreads};
  } else {
    const int64_t o = live ? b * K : 0;  // rows past B never emit
    S = Slots{reinterpret_cast<uint64_t*>(out.k_first_t) + o,
              reinterpret_cast<uint64_t*>(out.k_last_t) + o,
              reinterpret_cast<uint32_t*>(out.k_score) + o, out.k_fq + o, out.k_lq + o, 1};
  }

  const uint64_t ex = live ? (uint64_t)extracted[b] : 0;
  const uint64_t dist = live ? (uint64_t)vt_distance[b] : 0;
  const int32_t cov = live ? cov_thr[b] : 0;

  bool head_valid = false;
  uint64_t ref = 0, ft = 0, lt = 0;
  int32_t fq = 0, lq = 0, cnt = 0, out_len = 0;

  auto emit = [&](int h) {
    if (lq - fq <= cov) return;  // lq >= fq: the i32 difference is the u32 gate
    const bool full = out_len == K;
    if (full && (int32_t)(S.s[(K - 1) * S.stride] & kScore) >= cnt) return;
    int kk = full ? K - 1 : out_len;
    const int i = kk * S.stride;
    S.ft[i] = ft;
    S.lt[i] = lt;
    S.s[i] = (uint32_t)cnt | ((uint32_t)h << 31);
    S.f[i] = fq;
    S.l[i] = lq;
    for (; kk > 0 && (S.s[kk * S.stride] & kScore) > (S.s[(kk - 1) * S.stride] & kScore);
         --kk) {
      const int a = kk * S.stride, c = (kk - 1) * S.stride;
      swap_at(S.ft, a, c);
      swap_at(S.lt, a, c);
      swap_at(S.s, a, c);
      swap_at(S.f, a, c);
      swap_at(S.l, a, c);
    }
    if (!full) ++out_len;
  };

  vote_tile::walk<kThreads>(
      H, row0, B, sm,
      [&](int h, int, uint64_t t, int32_t q) {
        const uint64_t raw = raw_target(h, t, q, ex);
        if (head_valid && t - ref <= dist) {
          if (q < fq) {
            fq = q;
            ref = t;
          }
          if (q > lq) lq = q;
          ft = raw < ft ? raw : ft;
          lt = raw > lt ? raw : lt;
          ++cnt;
        } else {
          if (head_valid) emit(h);
          ref = t;
          ft = lt = raw;
          fq = lq = q;
          cnt = 1;
          head_valid = true;
        }
      },
      [&](int h) {
        if (head_valid) emit(h);
        head_valid = false;
      });

  if (!live) return;
  out.out_len[b] = out_len;
  for (int k = 0; k < K; ++k) {
    int32_t score = -1, kfq = 0, klq = 0, str = 0;
    uint64_t kft = 0, klt = 0;
    if (k < out_len) {
      const int i = k * S.stride;
      const uint32_t sw = S.s[i];
      str = (int32_t)(sw >> 31);
      score = (int32_t)(sw & kScore);
      kft = S.ft[i];
      klt = S.lt[i];
      kfq = S.f[i];
      klq = S.l[i];
    }
    const int64_t o = b * K + k;  // the slot read above is this same element
    out.k_score[o] = score;
    out.k_first_t[o] = (int64_t)kft;
    out.k_last_t[o] = (int64_t)klt;
    out.k_fq[o] = kfq;
    out.k_lq[o] = klq;
    out.k_str[o] = str;
  }
}

__global__ void __launch_bounds__(kThreads)
vote2_pair_kernel(Halves H, const int64_t* __restrict__ extracted,
                  const int64_t* __restrict__ vt_distance, const int32_t* __restrict__ lo1,
                  const int32_t* __restrict__ hi1, const int32_t* __restrict__ lo2,
                  const int32_t* __restrict__ hi2, int32_t* __restrict__ out, int64_t B) {
  extern __shared__ __align__(16) unsigned char vote_smem[];
  Tile<kVote2Rows>& sm = *reinterpret_cast<Tile<kVote2Rows>*>(vote_smem);
  const int64_t row0 = (int64_t)blockIdx.x * kVote2Rows;
  const int64_t b = row0 + (threadIdx.x >> 1);
  const int w = threadIdx.x & 1;  // the window: 0 head gap, 1 tail gap
  const bool live = b < B;

  const uint64_t ex = live ? (uint64_t)extracted[b] : 0;
  const uint64_t dist = live ? (uint64_t)vt_distance[b] : 0;
  const int32_t lo = live ? (w ? lo2[b] : lo1[b]) : 0;
  const int32_t hi = live ? (w ? hi2[b] : hi1[b]) : 0;

  bool head_valid = false;
  uint64_t ref = 0, ft = 0, lt = 0;
  int32_t fq = 0, lq = 0, cnt = 0;
  uint64_t b_ft = 0, b_lt = 0;
  int32_t b_score = 0, b_fq = 0, b_lq = 0, b_str = 0;

  auto consider = [&](int h) {
    if (cnt > b_score && lq < hi && fq > lo) {
      b_score = cnt;
      b_ft = ft;
      b_lt = lt;
      b_fq = fq;
      b_lq = lq;
      b_str = h;
    }
  };

  vote_tile::walk<kVote2Rows>(
      H, row0, B, sm,
      [&](int h, int, uint64_t t, int32_t q) {
        const uint64_t raw = raw_target(h, t, q, ex);
        if (head_valid && t - ref <= dist) {
          if (q < hi && q > lo) {
            if (q < fq) {
              fq = q;
              ref = t;
            }
            if (q > lq) lq = q;
            ft = raw < ft ? raw : ft;
            lt = raw > lt ? raw : lt;
            ++cnt;
          }
        } else {
          if (head_valid) consider(h);
          ref = t;
          ft = lt = raw;
          fq = lq = q;
          cnt = 1;
          head_valid = true;
        }
      },
      [&](int h) {
        if (head_valid) consider(h);
        head_valid = false;
      });

  if (!live) return;
  int32_t* o = out + b * 16 + w * 8;
  o[0] = b_score;
  o[1] = b_fq;
  o[2] = b_lq;
  o[3] = b_str;
  o[4] = (int32_t)(uint32_t)(b_ft >> 32);
  o[5] = (int32_t)(uint32_t)b_ft;
  o[6] = (int32_t)(uint32_t)(b_lt >> 32);
  o[7] = (int32_t)(uint32_t)b_lt;
}

Halves halves(const void* fk, const void* fq, const void* fok, const void* rk,
              const void* rq, const void* rok, int64_t ld, int64_t A) {
  return Halves{{static_cast<const int64_t*>(fk), static_cast<const int64_t*>(rk)},
                {static_cast<const int32_t*>(fq), static_cast<const int32_t*>(rq)},
                {static_cast<const uint8_t*>(fok), static_cast<const uint8_t*>(rok)},
                ld,
                A};
}

bool bad_shape(int64_t ld, int64_t A) { return A < 0 || A > ld || 2 * A + 2 >= (int64_t)1 << 31; }

}  // namespace

// C entry points (bound with ctypes). Device pointers: the halves fk, fq,
// fok, rk, rq, rok ([B][ld] int64 / int32 / bool, A columns of each row
// used, 0 <= A <= ld, 2A + 2 < 2^31), extracted and vt_distance [B] int64.
// The valid columns of each half of each row come first (vote_tile.cuh).
// Each launches on `stream` and returns a CUDA error code.
//
// Round 1: cov_thr [B] int32; outputs k_score, k_fq, k_lq, k_str [B][K]
// int32, k_first_t, k_last_t [B][K] int64, out_len [B] int32. K >= 1.
extern "C" int gdiet_vote_lr(const void* fk, const void* fq, const void* fok, const void* rk,
                             const void* rq, const void* rok, int64_t ld,
                             const void* extracted, const void* vt_distance,
                             const void* cov_thr, void* k_score, void* k_first_t,
                             void* k_last_t, void* k_fq, void* k_lq, void* k_str,
                             void* out_len, int64_t B, int64_t A, int K,
                             void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || bad_shape(ld, A)) return (int)cudaErrorInvalidValue;
  const int smem_slots = K <= kMaxSmemSlots;
  const size_t shm = sizeof(Tile<kThreads>) + (smem_slots ? (size_t)K * kThreads * kSlotBytes : 0);
  const Out1 out{static_cast<int32_t*>(k_score), static_cast<int64_t*>(k_first_t),
                 static_cast<int64_t*>(k_last_t), static_cast<int32_t*>(k_fq),
                 static_cast<int32_t*>(k_lq),    static_cast<int32_t*>(k_str),
                 static_cast<int32_t*>(out_len)};
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  vote_lr_kernel<<<blocks, kThreads, shm, (cudaStream_t)stream>>>(
      halves(fk, fq, fok, rk, rq, rok, ld, A), static_cast<const int64_t*>(extracted),
      static_cast<const int64_t*>(vt_distance), static_cast<const int32_t*>(cov_thr), out, B,
      K, smem_slots);
  return (int)cudaGetLastError();
}

// Round 2, both windows: lo1, hi1, lo2, hi2 [B] int32 (exclusive bounds);
// out [B][16] int32.
extern "C" int gdiet_vote2_pair(const void* fk, const void* fq, const void* fok,
                                const void* rk, const void* rq, const void* rok, int64_t ld,
                                const void* extracted, const void* vt_distance,
                                const void* lo1, const void* hi1, const void* lo2,
                                const void* hi2, void* out, int64_t B, int64_t A,
                                void* stream) {
  if (B <= 0) return 0;
  if (bad_shape(ld, A)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((B + kVote2Rows - 1) / kVote2Rows);
  vote2_pair_kernel<<<blocks, kThreads, sizeof(Tile<kVote2Rows>), (cudaStream_t)stream>>>(
      halves(fk, fq, fok, rk, rq, rok, ld, A), static_cast<const int64_t*>(extracted),
      static_cast<const int64_t*>(vt_distance), static_cast<const int32_t*>(lo1),
      static_cast<const int32_t*>(hi1), static_cast<const int32_t*>(lo2),
      static_cast<const int32_t*>(hi2), static_cast<int32_t*>(out), B);
  return (int)cudaGetLastError();
}
