// Location voting (vote, GDiet-ShortReads map.c:447-584) over the
// short-read step's hit stream, for NVIDIA Hopper (sm_90a).
//
// Replaces gdiet_tpu/pipeline/device_step.py::_vote_scan (a lax.scan there,
// not a Pallas kernel). It returns exactly what
// gdiet_tpu_torch/pipeline/device_step.py::vote_scan returns for the same
// stream: per read, the top-K runs kept by the reference's insertion (score,
// target, first and last query position, strand; out_len of them) and the
// recovery candidate (r_*).
//
// The stream of read b is row b of keys/qpos/valid [B][M]: the sorted
// forward hits, a barrier column, the sorted reverse hits, a barrier
// column; strand[m] is the strand of column m. A run is a maximal stretch
// of valid columns of one strand whose keys (chrom << 32 | projected
// position, compared as unsigned 64-bit values) stay within vt_distance of
// the run's head; the head moves to the column with the smallest query
// position. When a run ends, the reference inserts it into the sorted slot
// list if its count beats vt_threshold (the last slot is overwritten once
// the list is full, if the run beats it), and otherwise, while the list is
// empty, keeps it as the recovery candidate if it beats vt_rec_threshold
// and the candidate so far. The insertion is one backward bubble pass from
// the written slot. Filled slots hold counts >= 1 in non-increasing order
// and empty slots -1, so the pass stops at the first pair it does not swap:
// the plain version's full pass over every slot pair swaps nothing more.
//
// Design: one thread per read walks its row's M columns in order. The run
// head, the run's counters, out_len and the recovery candidate live in
// registers; the K slots live in shared memory, [K][32] per field for a
// block of 32 threads (no bank conflict), 24 bytes per slot, so K is set
// at launch (any K up to kMaxSmemSlots; beyond that the slots live in the
// output rows themselves, in device memory). Each thread loads the next
// column while it processes the current one. One warp per block spreads
// a small batch over every SM.
//
// What bounds it on this card: the bytes it must read, B*M*13 (an 8-byte
// key, a 4-byte query position and a valid byte per column), over
// 3.35 TB/s, or the serial chain of one row's M columns (a compare, the
// unsigned distance test and the run update per column, plus the bubble
// pass on a run's end), whichever is larger. A warp's 32 threads read 32
// different rows, so the loads do not coalesce: each 128-byte line a row
// touches is reused from L1 by the thread's next columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kSlotBytes = 24;  // target 8 + score, fq, lq, strand 4 each
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxSmemSlots = kMaxSmem / (kThreads * kSlotBytes);

struct Slots {
  int64_t* t;
  int32_t* s;
  int32_t* f;
  int32_t* l;
  int32_t* r;
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
  const int64_t t = S.t[ia];
  S.t[ia] = S.t[ib];
  S.t[ib] = t;
  int32_t x = S.s[ia];
  S.s[ia] = S.s[ib];
  S.s[ib] = x;
  x = S.f[ia];
  S.f[ia] = S.f[ib];
  S.f[ib] = x;
  x = S.l[ia];
  S.l[ia] = S.l[ib];
  S.l[ib] = x;
  x = S.r[ia];
  S.r[ia] = S.r[ib];
  S.r[ib] = x;
}

__global__ void __launch_bounds__(kThreads)
vote_scan_kernel(const int64_t* __restrict__ keys, const int32_t* __restrict__ qpos,
                 const uint8_t* __restrict__ valid, const int32_t* __restrict__ strand,
                 const int64_t* __restrict__ vt_distance,
                 const int32_t* __restrict__ vt_threshold,
                 const int32_t* __restrict__ vt_rec_threshold, Out out, int64_t B,
                 int64_t M, int K, int smem_slots) {
  extern __shared__ __align__(8) unsigned char smem[];
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;  // no barrier below: a thread past the end just leaves

  Slots S;
  if (smem_slots) {
    const int n = K * kThreads;
    int64_t* t = reinterpret_cast<int64_t*>(smem);
    int32_t* s = reinterpret_cast<int32_t*>(t + n);
    S = Slots{t + threadIdx.x, s + threadIdx.x, s + n + threadIdx.x,
              s + 2 * n + threadIdx.x, s + 3 * n + threadIdx.x, kThreads};
  } else {
    S = Slots{out.k_target + b * K, out.k_score + b * K, out.k_fq + b * K,
              out.k_lq + b * K, out.k_str + b * K, 1};
  }
  for (int k = 0; k < K; ++k) {
    const int i = k * S.stride;
    S.t[i] = 0;
    S.s[i] = -1;
    S.f[i] = 0;
    S.l[i] = 0;
    S.r[i] = 0;
  }

  const uint64_t dist = (uint64_t)vt_distance[b];
  const int32_t thr = vt_threshold[b], rec_thr = vt_rec_threshold[b];
  const int64_t* __restrict__ krow = keys + b * M;
  const int32_t* __restrict__ qrow = qpos + b * M;
  const uint8_t* __restrict__ vrow = valid + b * M;

  uint64_t head_t = 0;
  bool head_valid = false;
  int32_t head_str = 0, fq = 0, lq = 0, cnt = 0, out_len = 0;
  int32_t r_score = 0, r_fq = 0, r_lq = 0, r_str = 0;
  uint64_t r_target = 0;

  // a finished run (the head fields): insert it or keep it for recovery
  auto emit = [&]() {
    if (cnt > thr) {
      const bool full = out_len == K;
      if (full && S.s[(K - 1) * S.stride] >= cnt) return;
      int kk = full ? K - 1 : out_len;
      const int i = kk * S.stride;
      S.t[i] = (int64_t)head_t;
      S.s[i] = cnt;
      S.f[i] = fq;
      S.l[i] = lq;
      S.r[i] = head_str;
      for (; kk > 0 && S.s[kk * S.stride] > S.s[(kk - 1) * S.stride]; --kk)
        swap_slots(S, kk, kk - 1);
      if (!full) ++out_len;
    } else if (out_len == 0 && cnt > rec_thr && cnt > r_score) {
      r_score = cnt;
      r_target = head_t;
      r_fq = fq;
      r_lq = lq;
      r_str = head_str;
    }
  };

  uint64_t t_next = 0;
  int32_t q_next = 0;
  uint8_t v_next = 0;
  if (M > 0) {
    t_next = (uint64_t)krow[0];
    q_next = qrow[0];
    v_next = vrow[0];
  }
  for (int64_t m = 0; m < M; ++m) {
    const uint64_t t = t_next;
    const int32_t q = q_next;
    const bool ok = v_next != 0;
    const int32_t sgn = strand[m];
    if (m + 1 < M) {
      t_next = (uint64_t)krow[m + 1];
      q_next = qrow[m + 1];
      v_next = vrow[m + 1];
    }
    const bool in_run = head_valid && ok && head_str == sgn && t - head_t <= dist;
    if (in_run) {
      if (q < fq) {
        fq = q;
        head_t = t;
      }
      if (q > lq) lq = q;
      ++cnt;
    } else {
      if (head_valid) emit();
      head_t = t;
      fq = q;
      lq = q;
      cnt = 1;
      head_valid = ok;
      head_str = sgn;
    }
  }
  if (head_valid) emit();

  out.out_len[b] = out_len;
  out.r_score[b] = r_score;
  out.r_target[b] = (int64_t)r_target;
  out.r_fq[b] = r_fq;
  out.r_lq[b] = r_lq;
  out.r_str[b] = r_str;
  if (smem_slots) {
    for (int k = 0; k < K; ++k) {
      const int i = k * S.stride;
      out.k_target[b * K + k] = S.t[i];
      out.k_score[b * K + k] = S.s[i];
      out.k_fq[b * K + k] = S.f[i];
      out.k_lq[b * K + k] = S.l[i];
      out.k_str[b * K + k] = S.r[i];
    }
  }
}

}  // namespace

// C entry point (bound with ctypes). Device pointers: keys [B][M] int64
// (uint64 bit patterns), qpos [B][M] int32, valid [B][M] bool (one byte),
// strand [M] int32, vt_distance [B] int64, vt_threshold and
// vt_rec_threshold [B] int32; outputs k_score, k_fq, k_lq, k_str [B][K]
// int32, k_target [B][K] int64, out_len, r_score, r_fq, r_lq, r_str [B]
// int32, r_target [B] int64. K >= 1. Launches on `stream` and returns a
// CUDA error code.
extern "C" int gdiet_vote_scan(const void* keys, const void* qpos, const void* valid,
                               const void* strand, const void* vt_distance,
                               const void* vt_threshold, const void* vt_rec_threshold,
                               void* k_score, void* k_target, void* k_fq, void* k_lq,
                               void* k_str, void* out_len, void* r_score,
                               void* r_target, void* r_fq, void* r_lq, void* r_str,
                               int64_t B, int64_t M, int K, void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int smem_slots = K <= kMaxSmemSlots;
  const size_t shm = smem_slots ? (size_t)K * kThreads * kSlotBytes : 0;
  if (shm > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        vote_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shm);
    if (err != cudaSuccess) return (int)err;
  }
  const Out out{static_cast<int32_t*>(k_score), static_cast<int64_t*>(k_target),
                static_cast<int32_t*>(k_fq),    static_cast<int32_t*>(k_lq),
                static_cast<int32_t*>(k_str),   static_cast<int32_t*>(out_len),
                static_cast<int32_t*>(r_score), static_cast<int64_t*>(r_target),
                static_cast<int32_t*>(r_fq),    static_cast<int32_t*>(r_lq),
                static_cast<int32_t*>(r_str)};
  const unsigned blocks = (unsigned)((B + kThreads - 1) / kThreads);
  vote_scan_kernel<<<blocks, kThreads, shm, s>>>(
      static_cast<const int64_t*>(keys), static_cast<const int32_t*>(qpos),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(strand),
      static_cast<const int64_t*>(vt_distance), static_cast<const int32_t*>(vt_threshold),
      static_cast<const int32_t*>(vt_rec_threshold), out, B, M, K, smem_slots);
  return (int)cudaGetLastError();
}
