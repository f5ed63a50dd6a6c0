// The long-read votes (GDiet-LongReads map.c:1052-1271) over the long-read
// front's hit stream, for NVIDIA Hopper (sm_90a). Two entry points:
//
// gdiet_vote_lr, the round-1 vote, replaces
// gdiet_tpu/pipeline/lr_step.py::_vote_scan_lr (a lax.scan there, not a
// Pallas kernel) and returns exactly what
// gdiet_tpu_torch/ops/vote.py::_vote_scan_lr returns for the
// concatenated stream fwd | barrier | rev | barrier: the top-K runs by
// count (k_score, k_first_t, k_last_t, k_fq, k_lq, k_str; out_len of them).
// A run is a maximal stretch of valid columns of one half whose keys stay
// within vt_distance (unsigned 64-bit) of ref_loc, the key of the column
// with the smallest query position so far (the first such column: q < fq
// is strict). It tracks the unsigned min and max of its columns' raw
// targets, raw = t - q on the reverse strand and t - (extracted - q) on the
// forward one (uint64 wraparound, lr_step.py:41). A run that ends is
// inserted if lq - fq > cov_thr (int32); once the list is full it replaces
// the last slot only if its count is strictly greater. The insertion is one
// backward bubble pass that moves only on a strictly greater count.
//
// gdiet_vote2_pair, the round-2 vote of both query windows, replaces
// _vote2_scan (lr_step.py:146) run once per window, and writes the packed
// [B][16] int32 block of vote2_packed_pair (two blocks of score, fq, lq,
// str, first_t >> 32, first_t & U32, last_t >> 32, last_t & U32). A run
// restarts at any column that breaks it, whatever its window, and its
// start column counts (cnt 1, fq = lq = q, ref_loc = t, the raw span at
// raw) even outside the window; after that only in-window columns (lo < q
// < hi) count and move fq, ref_loc, lq and the raw span. The best run is
// the first with the largest count among those with lq < hi and fq > lo.
//
// What bounds them on this card: not the arithmetic, nor the bytes (the
// valid flags and 12 bytes a valid column: ~0.1 us at the long-read
// batches), but the serial chain of one read's columns: today's streams
// hold ~50 (HiFi) to ~600 (ONT) valid columns a half in runs of ~100-200
// columns, at batches of 256 or 16 reads.
//
// Design: one warp per (read, strand half), 32 columns a step.
//   - Two facts make the halves independent. Round 1: the list after the
//     whole stream is the stable top-K by count of all gated runs in
//     emission order (a tie never replaces, the bubble moves only on a
//     greater count), so it is the stable merge of the forward half's list
//     and the reverse half's, forward first, cut at K. Round 2: the best
//     run of the stream is the reverse half's only where its count is
//     strictly greater than the forward half's.
//   - Loads. A warp keeps kSteps steps of 32 columns in flight in
//     registers (lane l: column 32 s + l; 8-byte key, 4-byte position,
//     valid flag; coalesced), and asks for the next kSteps steps as soon as
//     the current ones' flags say they are all valid. The halves are
//     valid-first, so a half ends at its first invalid column; columns past
//     it are never used.
//   - The scan. The run state (fq, ref_loc) is element -1 of an exclusive
//     first-argmin scan of q over the step's columns (__shfl_up_sync on
//     (q, lane), ties kept by the left element; a column that may not move
//     fq holds INT32_MAX, which never beats the carried run), so each column
//     learns the key it is tested against. A ballot of the columns with t -
//     ref > vt_distance gives the first break j: columns s .. j-1 join the
//     run at once (the count; lq and the raw span in per-lane accumulators,
//     reduced across the warp only when the run ends), the inclusive scan
//     at j - 1 gives the new (fq, ref_loc), column j starts a new run, and
//     the scan restarts at j + 1. A step costs one scan a break, plus one.
//   - Round 1: a run's end is gated and inserted by lane 0 into the half's
//     K-list in shared memory; after both warps of the block (one read)
//     end, each list element's output position is its index plus the
//     elements of the other list that precede it (strictly greater counts
//     for a forward element, greater or equal for a reverse one), one lane
//     an element. For K > kMaxSmemSlots one warp walks both halves in turn
//     with the list in the output rows, as the plain version does.
//   - Round 2: both windows' scans and run states over the same loaded
//     columns (their runs break at different columns: ref_loc moves only on
//     in-window columns); each warp keeps its half's best run per window,
//     and warp 0 merges.
//
// Exactness traps, held by tests/test_torch_vote_lr.py and
// tests/test_torch_vote_lr_warp.py (the decomposition as a model): the
// strict q < fq (the first argmin, never the last); the unsigned wrap of t
// - ref_loc (a key below ref_loc breaks the run); the raw target's uint64
// wrap, which differs per half; the int32 gate lq - fq > cov_thr (cov_thr
// may be negative); empty halves; runs crossing a step; a full K-list with
// ties; row strides ld > A (a column slice of the halves is a view).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// steps of 32 columns a warp keeps in flight: on an H100 four ran as fast
// as eight on HiFi-like halves and 7% faster in round 2 on ONT-like ones
// (fewer registers); one ran 12-26% slower in round 1
constexpr int kSteps = 4;
constexpr int kChunk = 32 * kSteps;
constexpr int kMaxSmemSlots = 32;  // a half's list in shared memory, one lane a slot
constexpr uint32_t kScore = 0x7fffffffu;
constexpr int32_t kQMax = 0x7fffffff;
constexpr uint64_t kU64Max = ~(uint64_t)0;

struct Halves {
  const int64_t* k[2];  // keys (uint64 bit patterns), [B][ld] each
  const int32_t* q[2];  // query positions
  const uint8_t* v[2];  // valid flags (one byte)
  int64_t ld;           // row stride of all six, in elements
  int64_t A;            // columns per half
};

// kSteps steps of one half row: lane l holds column base + 32 s + l
struct Chunk {
  uint64_t t[kSteps];
  int32_t q[kSteps];
  uint8_t f[kSteps];
};

__device__ __forceinline__ void load_chunk(const int64_t* __restrict__ K,
                                           const int32_t* __restrict__ Q,
                                           const uint8_t* __restrict__ V, int64_t A,
                                           int64_t base, int lane, Chunk& c) {
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int64_t col = base + 32 * s + lane;
    const bool in = col < A;
    c.f[s] = in ? V[col] : 0;
    c.t[s] = in ? (uint64_t)K[col] : 0;
    c.q[s] = in ? Q[col] : 0;
  }
}

// the lanes below j (0 <= j <= 32)
__device__ __forceinline__ unsigned below(int j) { return j >= 32 ? kFull : (1u << j) - 1; }

__device__ __forceinline__ uint64_t shfl64(uint64_t v, int src) {
  return (uint64_t)__shfl_sync(kFull, (unsigned long long)v, src);
}

__device__ __forceinline__ uint64_t warp_umin(uint64_t v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const uint64_t x = (uint64_t)__shfl_xor_sync(kFull, (unsigned long long)v, o);
    v = x < v ? x : v;
  }
  return v;
}

__device__ __forceinline__ uint64_t warp_umax(uint64_t v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const uint64_t x = (uint64_t)__shfl_xor_sync(kFull, (unsigned long long)v, o);
    v = x > v ? x : v;
  }
  return v;
}

// A run: (fq, ref, cnt) the same in every lane; lq and the raw span in
// per-lane accumulators over the lane's joined columns
struct Run {
  uint64_t ref;
  int32_t fq, cnt;
  int32_t acc_lq;
  uint64_t acc_ft, acc_lt;
  // a new run at lane j's column
  __device__ __forceinline__ void start(int j, int lane, uint64_t t, int32_t q, uint64_t raw) {
    ref = shfl64(t, j);
    fq = __shfl_sync(kFull, q, j);
    cnt = 1;
    acc_lq = lane == j ? q : INT32_MIN;
    acc_ft = lane == j ? raw : kU64Max;
    acc_lt = lane == j ? raw : 0;
  }
  __device__ __forceinline__ int32_t lq() const { return __reduce_max_sync(kFull, acc_lq); }
};

// Walk half h of a row (K, Q, V at the row's first column) as the module
// comment says; NW runs (1 for round 1, every column counting; 2 for round
// 2's windows, lo[w] < q < hi[w] counting). end_run(w, run) at each run's
// end, every lane together.
template <int NW, bool kWin, class End>
__device__ __forceinline__ void walk_half(const int64_t* __restrict__ K,
                                          const int32_t* __restrict__ Q,
                                          const uint8_t* __restrict__ V, int64_t A, int h,
                                          uint64_t ex, uint64_t dist, const int32_t (&lo)[NW],
                                          const int32_t (&hi)[NW], End& end_run) {
  const int lane = threadIdx.x & 31;
  Run run[NW];
  bool active = false;
  Chunk cur, nxt;
  load_chunk(K, Q, V, A, 0, lane, cur);
  for (int64_t base = 0;; base += kChunk) {
    unsigned m[kSteps];
    bool full = true;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      m[s] = __ballot_sync(kFull, cur.f[s] != 0);
      full = full && m[s] == kFull;
    }
    const bool more = full && base + kChunk < A;
    if (more) load_chunk(K, Q, V, A, base + kChunk, lane, nxt);  // in flight meanwhile
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int end = m[s] == kFull ? 32 : __ffs(~m[s]) - 1;  // the valid lanes [0, end)
      if (end == 0) break;
      const uint64_t t = cur.t[s];
      const int32_t q = cur.q[s];
      const uint64_t qq = (uint64_t)(int64_t)q;
      const uint64_t raw = h ? t - qq : t - (ex - qq);
      int s0 = 0;
      if (!active) {  // the half's first column
#pragma unroll
        for (int w = 0; w < NW; ++w) run[w].start(0, lane, t, q, raw);
        active = true;
        s0 = 1;
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        Run& r = run[w];
        const bool inw = !kWin || (q > lo[w] && q < hi[w]);
        for (int st = s0; st < end;) {
          const bool inside = lane >= st && lane < end;
          // inclusive first-argmin scan of q over the columns that move fq
          int32_t qv = inside && inw ? q : kQMax;
          int iv = lane;
#pragma unroll
          for (int d = 1; d < 32; d <<= 1) {
            const int32_t qo = __shfl_up_sync(kFull, qv, d);
            const int io = __shfl_up_sync(kFull, iv, d);
            if (lane >= d && qo <= qv) {  // the left element wins ties
              qv = qo;
              iv = io;
            }
          }
          // exclusive, with the carried run as element -1
          int32_t eq = __shfl_up_sync(kFull, qv, 1);
          int ei = __shfl_up_sync(kFull, iv, 1);
          if (lane == 0) {
            eq = kQMax;
            ei = 0;
          }
          const uint64_t te = shfl64(t, ei);
          const uint64_t ref = r.fq <= eq ? r.ref : te;
          const unsigned bm = __ballot_sync(kFull, inside && t - ref > dist);
          const int j = bm ? __ffs(bm) - 1 : end;  // the first break
          if (lane >= st && lane < j && inw) {  // st .. j-1 join
            r.acc_lq = max(r.acc_lq, q);
            r.acc_ft = raw < r.acc_ft ? raw : r.acc_ft;
            r.acc_lt = raw > r.acc_lt ? raw : r.acc_lt;
          }
          if (j > st) {
            r.cnt += kWin ? __popc(__ballot_sync(kFull, inw) & below(j) & ~below(st)) : j - st;
            const int32_t qi = __shfl_sync(kFull, qv, j - 1);
            const uint64_t ti = shfl64(t, __shfl_sync(kFull, iv, j - 1));
            if (qi < r.fq) {
              r.fq = qi;
              r.ref = ti;
            }
          }
          if (j == end) break;
          end_run(w, r);
          r.start(j, lane, t, q, raw);
          st = j + 1;
        }
      }
      if (end < 32) break;  // the half has ended
    }
    if (!more) break;
    cur = nxt;
  }
  if (active) {
#pragma unroll
    for (int w = 0; w < NW; ++w) end_run(w, run[w]);
  }
}

// a K-list: K slots of (first_t, last_t, count | strand << 31, fq, lq)
struct Slots {
  uint64_t* ft;
  uint64_t* lt;
  uint32_t* s;
  int32_t* f;
  int32_t* l;
};

// round 1's end of a run: the gate, then lane 0 inserts (len: lane 0's)
struct Emit1 {
  Slots S;
  int K;
  int32_t cov;
  int h;
  int len;
  __device__ __forceinline__ void operator()(int, const Run& r) {
    const int lane = threadIdx.x & 31;
    const int32_t lq = r.lq();
    if ((int32_t)((uint32_t)lq - (uint32_t)r.fq) <= cov) return;
    // full and not strictly greater than the last: no insert (lane 0 reads)
    int ok = 1;
    if (lane == 0) ok = !(len == K && (int32_t)(S.s[K - 1] & kScore) >= r.cnt);
    if (!__shfl_sync(kFull, ok, 0)) return;
    const uint64_t ft = warp_umin(r.acc_ft), lt = warp_umax(r.acc_lt);
    if (lane == 0) {
      const bool full = len == K;
      int k = full ? K - 1 : len;
      S.ft[k] = ft;
      S.lt[k] = lt;
      S.s[k] = (uint32_t)r.cnt | ((uint32_t)h << 31);
      S.f[k] = r.fq;
      S.l[k] = lq;
      for (; k > 0 && (S.s[k] & kScore) > (S.s[k - 1] & kScore); --k) {
        const uint64_t a = S.ft[k], b = S.lt[k];
        const uint32_t c = S.s[k];
        const int32_t d = S.f[k], e = S.l[k];
        S.ft[k] = S.ft[k - 1];
        S.lt[k] = S.lt[k - 1];
        S.s[k] = S.s[k - 1];
        S.f[k] = S.f[k - 1];
        S.l[k] = S.l[k - 1];
        S.ft[k - 1] = a;
        S.lt[k - 1] = b;
        S.s[k - 1] = c;
        S.f[k - 1] = d;
        S.l[k - 1] = e;
      }
      if (!full) ++len;
    }
    __syncwarp();
  }
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

__device__ __forceinline__ void put_slot(const Out1& out, int64_t o, uint32_t sw, uint64_t ft,
                                         uint64_t lt, int32_t f, int32_t l) {
  out.k_score[o] = (int32_t)(sw & kScore);
  out.k_str[o] = (int32_t)(sw >> 31);
  out.k_first_t[o] = (int64_t)ft;
  out.k_last_t[o] = (int64_t)lt;
  out.k_fq[o] = f;
  out.k_lq[o] = l;
}

__device__ __forceinline__ void put_empty(const Out1& out, int64_t o) {
  out.k_score[o] = -1;
  out.k_str[o] = 0;
  out.k_first_t[o] = 0;
  out.k_last_t[o] = 0;
  out.k_fq[o] = 0;
  out.k_lq[o] = 0;
}

// Round 1, K <= kMaxSmemSlots: block b is read b, warp h its half h
__global__ void __launch_bounds__(64)
vote_lr_kernel(Halves H, const int64_t* __restrict__ extracted,
               const int64_t* __restrict__ vt_distance, const int32_t* __restrict__ cov_thr,
               Out1 out, int K) {
  __shared__ uint64_t s_ft[2][kMaxSmemSlots], s_lt[2][kMaxSmemSlots];
  __shared__ uint32_t s_s[2][kMaxSmemSlots];
  __shared__ int32_t s_f[2][kMaxSmemSlots], s_l[2][kMaxSmemSlots];
  __shared__ int s_len[2];
  const int64_t b = blockIdx.x;
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = b * H.ld;
  const int32_t none[1] = {0};
  Emit1 emit{Slots{s_ft[h], s_lt[h], s_s[h], s_f[h], s_l[h]}, K, cov_thr[b], h, 0};
  walk_half<1, false>(H.k[h] + row, H.q[h] + row, H.v[h] + row, H.A, h,
                      (uint64_t)extracted[b], (uint64_t)vt_distance[b], none, none, emit);
  if (lane == 0) s_len[h] = emit.len;
  __syncthreads();
  // the stable merge, forward first: one lane an element of list h
  const int n0 = s_len[0], n1 = s_len[1];
  const int mine = h ? n1 : n0, other = h ? n0 : n1;
  if (lane < mine) {
    const uint32_t c = s_s[h][lane] & kScore;
    int p = lane;
    for (int i = 0; i < other; ++i) {
      const uint32_t o = s_s[h ^ 1][i] & kScore;
      p += h ? o >= c : o > c;
    }
    if (p < K)
      put_slot(out, b * K + p, s_s[h][lane], s_ft[h][lane], s_lt[h][lane], s_f[h][lane],
               s_l[h][lane]);
  }
  const int n = min(K, n0 + n1);
  if (h == 0 && lane >= n && lane < K) put_empty(out, b * K + lane);
  if (threadIdx.x == 0) out.out_len[b] = n;
}

// Round 1, K > kMaxSmemSlots: one warp a read walks both halves in turn,
// the list in the read's output rows (k_score holds count | strand << 31
// until the end)
__global__ void __launch_bounds__(32)
vote_lr_rows_kernel(Halves H, const int64_t* __restrict__ extracted,
                    const int64_t* __restrict__ vt_distance, const int32_t* __restrict__ cov_thr,
                    Out1 out, int K) {
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int64_t row = b * H.ld, o = b * K;
  const int32_t none[1] = {0};
  Emit1 emit{Slots{reinterpret_cast<uint64_t*>(out.k_first_t) + o,
                   reinterpret_cast<uint64_t*>(out.k_last_t) + o,
                   reinterpret_cast<uint32_t*>(out.k_score) + o, out.k_fq + o, out.k_lq + o},
             K, cov_thr[b], 0, 0};
  for (int h = 0; h < 2; ++h) {
    emit.h = h;
    walk_half<1, false>(H.k[h] + row, H.q[h] + row, H.v[h] + row, H.A, h,
                        (uint64_t)extracted[b], (uint64_t)vt_distance[b], none, none, emit);
  }
  const int n = __shfl_sync(kFull, emit.len, 0);
  for (int k = lane; k < K; k += 32) {
    if (k < n) {
      const uint32_t sw = (uint32_t)out.k_score[o + k];
      out.k_score[o + k] = (int32_t)(sw & kScore);
      out.k_str[o + k] = (int32_t)(sw >> 31);
    } else {
      put_empty(out, o + k);
    }
  }
  if (lane == 0) out.out_len[b] = n;
}

// round 2's best run of one window
struct Best {
  int32_t score, fq, lq, str;
  uint64_t ft, lt;
};

struct Consider {
  Best best[2];
  int32_t lo[2], hi[2];
  int h;
  __device__ __forceinline__ void operator()(int w, const Run& r) {
    const int32_t lq = r.lq();
    if (r.cnt > best[w].score && lq < hi[w] && r.fq > lo[w]) {
      const uint64_t ft = warp_umin(r.acc_ft), lt = warp_umax(r.acc_lt);
      best[w] = Best{r.cnt, r.fq, lq, h, ft, lt};
    }
  }
};

// Round 2, both windows: block b is read b, warp h its half h
__global__ void __launch_bounds__(64)
vote2_pair_kernel(Halves H, const int64_t* __restrict__ extracted,
                  const int64_t* __restrict__ vt_distance, const int32_t* __restrict__ lo1,
                  const int32_t* __restrict__ hi1, const int32_t* __restrict__ lo2,
                  const int32_t* __restrict__ hi2, int32_t* __restrict__ out) {
  __shared__ Best s_best[2][2];  // [half][window]
  const int64_t b = blockIdx.x;
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = b * H.ld;
  Consider con{{Best{0, 0, 0, 0, 0, 0}, Best{0, 0, 0, 0, 0, 0}}, {lo1[b], lo2[b]},
               {hi1[b], hi2[b]}, h};
  walk_half<2, true>(H.k[h] + row, H.q[h] + row, H.v[h] + row, H.A, h, (uint64_t)extracted[b],
                     (uint64_t)vt_distance[b], con.lo, con.hi, con);
  if (lane < 2) s_best[h][lane] = con.best[lane];
  __syncthreads();
  if (h == 0 && lane < 2) {  // the reverse half's best only where strictly greater
    const Best& f = s_best[0][lane];
    const Best& r = s_best[1][lane];
    const Best& p = r.score > f.score ? r : f;
    int32_t* o = out + b * 16 + lane * 8;
    o[0] = p.score;
    o[1] = p.fq;
    o[2] = p.lq;
    o[3] = p.str;
    o[4] = (int32_t)(uint32_t)(p.ft >> 32);
    o[5] = (int32_t)(uint32_t)p.ft;
    o[6] = (int32_t)(uint32_t)(p.lt >> 32);
    o[7] = (int32_t)(uint32_t)p.lt;
  }
}

__global__ void vote_lr_empty_kernel() {}

Halves halves(const void* fk, const void* fq, const void* fok, const void* rk,
              const void* rq, const void* rok, int64_t ld, int64_t A) {
  return Halves{{static_cast<const int64_t*>(fk), static_cast<const int64_t*>(rk)},
                {static_cast<const int32_t*>(fq), static_cast<const int32_t*>(rq)},
                {static_cast<const uint8_t*>(fok), static_cast<const uint8_t*>(rok)},
                ld,
                A};
}

bool bad_shape(int64_t B, int64_t ld, int64_t A) {
  return A < 0 || A > ld || 2 * A + 2 >= (int64_t)1 << 31 || B >= (int64_t)1 << 31;
}

}  // namespace

// C entry points (bound with ctypes). Device pointers: the halves fk, fq,
// fok, rk, rq, rok ([B][ld] int64 / int32 / bool, A columns of each row
// used, 0 <= A <= ld, 2A + 2 < 2^31), extracted and vt_distance [B] int64.
// The valid columns of each half of each row come first. Each launches on
// `stream` (one block a read: two warps, or one warp for round 1 at K >
// 32) and returns a CUDA error code.
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
  if (K <= 0 || bad_shape(B, ld, A)) return (int)cudaErrorInvalidValue;
  const Out1 out{static_cast<int32_t*>(k_score), static_cast<int64_t*>(k_first_t),
                 static_cast<int64_t*>(k_last_t), static_cast<int32_t*>(k_fq),
                 static_cast<int32_t*>(k_lq),    static_cast<int32_t*>(k_str),
                 static_cast<int32_t*>(out_len)};
  const Halves H = halves(fk, fq, fok, rk, rq, rok, ld, A);
  if (K <= kMaxSmemSlots)
    vote_lr_kernel<<<(unsigned)B, 64, 0, (cudaStream_t)stream>>>(
        H, static_cast<const int64_t*>(extracted), static_cast<const int64_t*>(vt_distance),
        static_cast<const int32_t*>(cov_thr), out, K);
  else
    vote_lr_rows_kernel<<<(unsigned)B, 32, 0, (cudaStream_t)stream>>>(
        H, static_cast<const int64_t*>(extracted), static_cast<const int64_t*>(vt_distance),
        static_cast<const int32_t*>(cov_thr), out, K);
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
  if (bad_shape(B, ld, A)) return (int)cudaErrorInvalidValue;
  vote2_pair_kernel<<<(unsigned)B, 64, 0, (cudaStream_t)stream>>>(
      halves(fk, fq, fok, rk, rq, rok, ld, A), static_cast<const int64_t*>(extracted),
      static_cast<const int64_t*>(vt_distance), static_cast<const int32_t*>(lo1),
      static_cast<const int32_t*>(hi1), static_cast<const int32_t*>(lo2),
      static_cast<const int32_t*>(hi2), static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// An empty kernel at the votes' launch shape (B blocks of 64 threads): the
// launch floor beside their times (chip_smoke.py).
extern "C" int gdiet_vote_lr_empty(int64_t B, void* stream) {
  if (B <= 0) return 0;
  vote_lr_empty_kernel<<<(unsigned)B, 64, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
