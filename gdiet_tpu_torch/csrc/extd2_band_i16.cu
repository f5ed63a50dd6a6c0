// Banded lane window of the DP with an int16 lane state, two lanes in each
// 32-bit register, for NVIDIA Hopper (sm_90a): one candidate over a
// thread-block cluster.
//
// Replaces the windowed mode of the TPU kernel
// gdiet_tpu/ops/dp_pallas.py::_dp_kernel (_dp_kernel_body with band_budget
// set, window :228-243, walk :370-382) run with state_dtype = "int16"
// (extd2_batch_pallas, sdt = int16: the seven lane-state arrays 16-bit, H0
// and the score int32). It computes exactly what
// gdiet_tpu_torch/ops/dp_band.py::extd2_band computes with
// state_dtype="int16", which under ops/dp.py::safe_state_dtype's bound is
// what csrc/extd2_band.cu computes: dirs[N][R][WB] with column j of
// wavefront r at lane lo_al(r) + j, the score, and the same offs/off_ends.
//
// What bounds it on this card: the wavefronts of one candidate are a
// serial chain (wavefront r reads wavefront r-1's lane t-1 neighbours), so
// a candidate's time is its live wavefronts times the time of one. The
// work of a wavefront (WB lanes, 57 lane operations each, two lanes an
// instruction) is small, and a long-read call holds few candidates (the
// ONT (32768, 34048) chunk: 32 rows, some of them padding, on 132 SMs).
// With one block a candidate (csrc/extd2_band.cu's design, this kernel's
// before) a wavefront is what one SM dispatches for it: at 24 warps (WB
// 1,536) bound by instruction dispatch, so every instruction a warp repeats
// each wavefront counts, while most SMs idle.
//
// Design:
//   - The cluster. Candidate n runs on a cluster of C blocks (C in {1, 2,
//     4, 8}, cudaLaunchKernelEx with a cluster dimension;
//     ops/extd2.py::band_cluster_size picks C so that all N clusters are
//     resident, one block an SM). Block c owns the P = NP / C lane pairs
//     [c P, (c+1) P) of the window's NP = WB / 2 pairs, so each SM
//     dispatches 1/C of a wavefront.
//   - Point-to-point between blocks. The one cross-block dependency of a
//     wavefront is the lane t-1 neighbour of a block's first pair: the
//     high halves of (x, v, x2) of block c-1's last pair. That thread
//     sends the words with st.async into a ring slot of block c's shared
//     memory, completing on the slot's mbarrier, and block c's first
//     thread waits on it; inside a block the compute warps meet at a named
//     barrier (bar.sync 1, compute threads) once a wavefront. So block c
//     runs behind block c-1 as in a pipeline, and no wavefront pays a
//     cluster barrier: barrier.cluster's release and acquire are, on this
//     card, a MEMBAR.ALL.GPU (the block's outstanding dirs stores reach L2)
//     and an L1 invalidate, and a first design with one a wavefront ran
//     slower than the one-block kernel at every cluster size. A barrier of the
//     cluster (of the block when C = 1) comes only every kEpoch wavefronts
//     and at the window shifts: it bounds how far block c-1 runs ahead (the
//     ring has more slots than an epoch has wavefronts) and carries the
//     walk's data. Pair 0's rotated neighbour (pair NP-1, in block C-1) is
//     not fetched: window lane 0 is in band only where lo = st = 0, and
//     there the band-start fixups replace all three of its neighbour halves
//     (tests/test_torch_band_cluster.py proves the geometry for band <=
//     band_budget).
//   - The window shift (the 128-aligned base moving right, at most once
//     per `unroll` wavefronts) moves the lane state by whole pairs through
//     a scratch array read from any block of the cluster, in two rounds
//     (u, v, x, y; then x2, y2, s) between barriers.
//   - The filler and walker warps (the block's last two). The row scalars
//     of a wavefront (band limits, the band-start fixups, the edge value,
//     the barriers and shifts that follow) are the same for every pair,
//     and nvcc keeps them in vector registers, not the uniform datapath:
//     every warp recomputed them each wavefront. The filler's lane 0
//     computes them one epoch ahead into a ring in shared memory, which the
//     compute warps read with three broadcast 16-byte loads. The
//     approximate-max H0 walk is a serial chain of its own (step r reads v
//     at lane lt and u at lane lt + 1 of wavefront r's output and moves lt
//     by 0 or 1); in block 0 the walker's lane 0 walks epoch e - 1 during
//     epoch e, off the compute warps' path and beside the filler (one warp
//     doing both fell behind the epoch barrier). For that the compute
//     threads whose pairs hold the lanes the walk can reach store their
//     (v, u) into a tap row in block 0, one 8-byte store a pair: the walk's
//     lt at the start of epoch e - 2, sent to every block before epoch e's
//     rows are filled, bounds epoch e's taps to 3 kEpoch + 1 lanes from it,
//     so a tap row holds kTaps pairs from that of its clipped lane. The
//     walk keeps the Pallas kernel's rules: the taps clipped into the
//     window of their wavefront, the first live wavefront's start, the
//     lt/lt+1 band tests, and the score at wavefront qlen + tlen - 2 when
//     its band reaches tlen - 1.
//   - The reversed query. Shared memory holds the query as 16-bit entries
//     e[i + kQPad] = (q(i), q(i - 1)), q(i) the code XOR 4 and code 0
//     outside [0, qlen) (the Pallas kernel's qrev_ext), so a pair's two
//     query codes at wavefront r are one 16-bit load at r - lane0 (one
//     DPX clamp keeps lanes outside the substitution span, whose scores
//     are not used, inside the array). A pair's target codes, XOR 4 in the
//     halves, and its N mask change only at shifts. The scores are then
//     an XOR, two subtractions whose bit 15 says "differs" and "query code
//     is not N" per half, two sign-replicating byte permutes into masks
//     and two blends: no compare, select or bounds test. They are computed
//     for the next wavefront right after the pair step, which is branch-free
//     (a pair outside the band keeps its state by selects), so that they
//     fill the chain's stalls.
//   - The lane pairs (csrc/dp_pair.cuh), as before: pair j holds lanes 2j
//     and 2j + 1 in one word per state array, offset binary; the window
//     base is 128-aligned, band starts 16-aligned and band ends odd, so a
//     pair is in band or out as a whole and its two direction bytes are
//     one 16-bit store. Per pair and wavefront: one __byte_perm per
//     neighbour state, the per-half fixups (edge lane, band start, the
//     substitution span), then pair_step's four packed adds, four
//     __vibmax_u16x2, four __viaddmax_s16x2_relu and six packed adds.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dp_pair.cuh"

namespace {

using namespace pair16;

constexpr int kNegInf = -0x40000000;
constexpr int kMaxThreads = 1024;
constexpr int kWalker = 64;  // the filler and walker warps' threads
constexpr int kMaxCompute = kMaxThreads - kWalker;
constexpr int kMaxCluster = 8;
constexpr int kEpoch = 32;              // wavefronts between cluster barriers, at most
constexpr int kHalo = 2 * kEpoch;       // halo ring slots: > kEpoch + 1 in flight
constexpr int kTaps = 3 * kEpoch / 2 + 2;  // tap pairs a wavefront (3 kEpoch + 1 lanes)
constexpr int kQPad = 17;  // query entries below index 0 (the span starts >= lane r - 15)
constexpr size_t kMaxShared = 232448;  // a block's dynamic shared memory on sm_90

struct Scoring {
  int a, b, q, e, q2, e2, long_thres, long_diff;
};

__device__ __forceinline__ int window_base(int r0, int w_max, int T, int WB) {
  int lo = ((r0 - w_max + 1) >> 1) - 16;
  lo = min(max(lo, 0), T - WB);
  return lo & ~127;  // lo >= 0 here
}

// Synchronisation primitives (PTX, sm_90).
// barrier.cluster.arrive / wait: release / acquire at cluster scope; every
// thread of the cluster takes part.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;\n" ::: "memory");
}
// the barrier of epochs and shifts: the cluster's, or the block's when the
// cluster is one block (no MEMBAR.GPU, no L1 invalidate)
__device__ __forceinline__ void epoch_sync(int C) {
  if (C == 1)
    __syncthreads();
  else
    cluster_sync();
}
// the compute warps' barrier (named barrier 1; n a multiple of 32)
__device__ __forceinline__ void compute_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}
// the generic address of `p` (in this block's shared memory) in block
// `rank` of the cluster
template <typename T>
__device__ __forceinline__ T* cluster_map(T* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// arrive on `bar` expecting `bytes` more of transactions in this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// wait for the phase of `bar` with the given parity to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// 16 bytes into block `rank`'s `dst`, completing on block `rank`'s `bar`
__device__ __forceinline__ void st_async16(void* dst, uint64_t* bar, int rank, uint4 v) {
  uint32_t rd, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rd) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(rd),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rb)
      : "memory");
}
// prmt.b32 in its default mode: a selector nibble with bit 3 set
// replicates the sign bit of the byte it selects
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t out;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(out) : "r"(a), "r"(b), "r"(sel));
  return out;
}

// a pair's target codes: lanes (lane, lane + 1), 0 past Lt, XOR 4 in the
// halves; nmask the halves whose code is 4 (N)
__device__ __forceinline__ void target_pair(const uint8_t* trow, int lane, int Lt,
                                            uint32_t& code, uint32_t& nmask) {
  const int t0 = lane < Lt ? (int)trow[lane] : 0;
  const int t1 = lane + 1 < Lt ? (int)trow[lane + 1] : 0;
  code = (uint32_t)(t0 ^ 4) | ((uint32_t)(t1 ^ 4) << 16);
  nmask = (t0 == 4 ? 0x0000ffffu : 0u) | (t1 == 4 ? 0xffff0000u : 0u);
}

// the substitution scores of a pair, one offset-binary word: a where the
// codes agree, -b where they differ, -e2 where either is N; q16 the query
// entry (q(i), q(i - 1)), i = r - lane0
__device__ __forceinline__ uint32_t subst_pair(uint32_t q16, uint32_t tcode, uint32_t tn,
                                               uint32_t sa, uint32_t sb, uint32_t se2) {
  const uint32_t qh = prmt(q16, 0u, 0x4140u);  // one code a half
  // bit 15 of a half of (h | 0x8000) - 1 is h != 0 (h <= 255: no borrow)
  const uint32_t differ = ((qh ^ tcode) | 0x80008000u) - 0x00010001u;
  const uint32_t q_not_n = (qh | 0x80008000u) - 0x00010001u;
  const uint32_t s = blend(prmt(differ, 0u, 0xbb99u), sb, sa);
  return blend(prmt(q_not_n, 0u, 0xbb99u) & ~tn, s, se2);
}

// The cluster barriers' schedule: before wavefront r (0 < r < r_end) when
// a window shift falls there (r a multiple of `unroll` and the base moves)
// or kEpoch wavefronts have run since the last one, and once after the
// last wavefront (r = r_end).
struct Schedule {
  int w_max, T, WB, unroll, r_end;
  int lo = 0, ustep = 0, since = 0;
  // advance to wavefront r (called for r = 1, 2, ...): whether a barrier
  // comes before it, and the new base where the window shifts there
  __device__ __forceinline__ bool barrier_before(int r, bool& shift, int& nlo) {
    ustep = ustep + 1 == unroll ? 0 : ustep + 1;
    ++since;
    shift = false;
    if (r < r_end && ustep == 0) {
      nlo = window_base(r, w_max, T, WB);
      shift = nlo != lo;
    }
    if (shift || since == kEpoch || r == r_end) {
      since = 0;
      if (shift) lo = nlo;
      return true;
    }
    return false;
  }
};

// A wavefront's row: the band limits and fixup values every pair reads,
// what follows it, and where its taps go. Three uint4 in the block's row
// ring, filled one epoch ahead by the filler warp.
enum RowFlags : uint32_t { kLive = 1, kBarrier = 2, kShift = 4 };
struct Rows {
  int qlen, tlen, w, qe, T, WB;
  Scoring sc;
  Schedule sched;
  int r = 0, last_st = -1, last_en = -1;
  int e = 0, b = 0;  // the epoch of row r, its first wavefront
  // the rows of epoch e, up to its barrier, into ring slots r mod 4
  // kEpoch; lt_e: the walk's lt the epoch's taps start from
  __device__ __forceinline__ void fill_epoch(uint4* ring, int lt_e) {
    for (bool bar = false; !bar; ++r) {
      const int st0 = __vimax3_s32(0, r - qlen + 1, (r - w + 1) >> 1);
      const int en0 = __vimin3_s32(tlen - 1, r, (r + w) >> 1);
      const bool live = st0 <= en0;  // r < qlen + tlen - 1 and qlen > 0 here
      const int st = st0 & ~15;
      const int en = live ? min(((en0 + 16) & ~15) - 1, T - 1) : -1;  // none in band if dead
      const int s_end = live ? st0 + ((en0 - st0) & ~15) + 16 : st0;   // st0 + span16
      const bool prev_ok = (st > 0) && (st - 1 >= last_st) && (st - 1 <= last_en);
      const int bu = r == 0 ? -qe
                   : r < sc.long_thres ? -sc.e
                   : r == sc.long_thres ? sc.long_diff : -sc.e2;
      if (live) {
        last_st = st;
        last_en = en;
      }
      // the taps: the pairs from that of lt_e's window lane, clipped, on
      // (none for a dead wavefront), in tap row (e parity, r - b)
      const int pw0 = live ? min(max(lt_e - sched.lo, 0), WB - 1) >> 1 : -(1 << 30);
      const int tbase = ((e & 1) * kEpoch + r - b) * 2 * kTaps;
      bool shift;
      int nlo = 0;
      bar = sched.barrier_before(r + 1, shift, nlo);
      uint4* slot = ring + (r & (4 * kEpoch - 1)) * 3;
      slot[0] = make_uint4((uint32_t)st0, (uint32_t)s_end, (uint32_t)st, (uint32_t)en);
      // lane st (a low half): x, x2 take the init values unless prev_ok,
      // v takes v_st unless st > 0 and prev_ok; the edge lane's u takes bu
      slot[1] = make_uint4(splat(st > 0 ? -qe : bu), prev_ok ? 0u : 0x0000ffffu,
                           (st > 0 && prev_ok) ? 0u : 0x0000ffffu, splat(bu));
      slot[2] = make_uint4((live ? kLive : 0u) | (bar ? kBarrier : 0u) | (shift ? kShift : 0u),
                           (uint32_t)nlo, (uint32_t)pw0, (uint32_t)tbase);
    }
    ++e;
    b = r;
  }
};

// PPT lane pairs a compute thread, at most MAXT threads a block (the
// register budget: 128 a thread at 512, 64 at 1,024)
template <int PPT, int MAXT>
__global__ void __launch_bounds__(MAXT, 1)
extd2_band_i16_kernel(const uint8_t* __restrict__ query,
                      const uint8_t* __restrict__ target,
                      const int32_t* __restrict__ qlens,
                      const int32_t* __restrict__ tlens,
                      const int32_t* __restrict__ bands,
                      int32_t* __restrict__ score_out, uint8_t* __restrict__ dirs,
                      int Lmax, int Lt, int T, int R, int WB, int w_max, int unroll,
                      int C, Scoring sc) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int NP = WB / 2;  // pairs in the window
  const int P = NP / C;   // pairs of this block
  const int nc = P / PPT;  // compute threads (a multiple of 32); filler and walker follow
  // shared memory: the neighbours' exchange xs/vs/x2s [2][P] words
  // (wavefront parity), the shift scratch [4][P], the halo ring [kHalo]
  // (16 bytes a slot) and its mbarriers, the row ring [4 kEpoch][3] uint4,
  // the walker's tap rows [2][kEpoch][kTaps] (v, u) word pairs (epoch
  // parity; used in block 0), the walk's lt sent to the block [2] (epoch
  // parity), then the query entries, u16 [Lmax + 2 kQPad]
  uint32_t* const xs = smem;
  uint32_t* const vs = xs + 2 * P;
  uint32_t* const x2s = vs + 2 * P;
  uint32_t* const scr = x2s + 2 * P;
  uint4* const halo = reinterpret_cast<uint4*>(scr + 4 * P);  // P is a multiple of 32
  uint64_t* const hbar = reinterpret_cast<uint64_t*>(halo + kHalo);
  uint4* const rows = reinterpret_cast<uint4*>(hbar + kHalo);
  uint32_t* const taps = reinterpret_cast<uint32_t*>(rows + 4 * kEpoch * 3);
  int* const ltk = reinterpret_cast<int*>(taps + 2 * kEpoch * 2 * kTaps);
  uint16_t* const qe16 = reinterpret_cast<uint16_t*>(ltk + 4);

  const int c = (int)blockIdx.x % C;  // the block's rank in its cluster
  const int n = (int)blockIdx.x / C;
  const int t = threadIdx.x;
  const int qlen = qlens[n];
  const int tlen = tlens[n];
  const int w = bands[n];
  const int qe = sc.q + sc.e;
  // entries 0 .. qhi: e[k] = (q(k - kQPad), q(k - kQPad - 1)); the last
  // two and the first kQPad + 1 are code 0
  const int qhi = qlen + kQPad + 1;
  {
    const uint8_t* qrow = query + (size_t)n * Lmax;
    for (int k = t; k <= qhi; k += blockDim.x) {
      const int i = k - kQPad;
      const int a = (i >= 0 && i < qlen) ? (int)qrow[i] : 0;
      const int b = (i >= 1 && i <= qlen) ? (int)qrow[i - 1] : 0;
      qe16[k] = (uint16_t)((a ^ 4) | ((b ^ 4) << 8));
    }
  }
  // no wavefront from qlen + tlen - 1 on is live
  const int r_end = (qlen > 0 && tlen > 0) ? min(R, qlen + tlen - 1) : 0;
  Rows rw{qlen, tlen, w, qe, T, WB, sc, Schedule{w_max, T, WB, unroll, r_end}};
  if (t == 0) {
    for (int i = 0; i < kHalo; ++i) mbar_init(&hbar[i], 1);
    mbar_init_fence();
    if (c > 0)  // the first pair's thread takes every slot's first round
      for (int i = 0; i < kHalo; ++i) mbar_expect(&hbar[i], sizeof(uint4));
    ltk[0] = ltk[1] = 0;
  }
  if (t == nc && r_end > 0) rw.fill_epoch(rows, 0);  // epoch 0's rows: lt is 0
  // block index of a window pair: src / P as a multiply (src < 2^12)
  const uint32_t pmagic = 0xffffffffu / (uint32_t)P + 1u;
  // every block of the cluster has started, its query, rows and mbarriers
  // in place, before any distributed shared memory access
  cluster_sync();

  if (t >= nc) {
    // the filler and walker warps: the same barriers as the compute warps,
    // found in the row ring. The filler's lane 0 fills epoch e + 1's rows
    // during epoch e with the lt sent before epoch e (the walk's lt at the
    // start of epoch e - 1: the taps of epoch e + 1 then lie within 3
    // kEpoch + 1 lanes of it); in block 0 the walker's lane 0 walks epoch
    // e - 1 meanwhile and sends its lt to every block. Two warps, so that
    // neither waits for the other's share of the SM's dispatch slots.
    const bool lead = t == nc;
    const bool walks = c == 0 && t == nc + 32;
    int H0 = 0, lt = 0, score = kNegInf;
    int wlo = 0, wstep = 0;  // the walked wavefront's window base, its r % unroll
    int e = 0, b = 0, b_prev = 0;  // the epoch, its first wavefront, the last one's
    auto walk = [&](int from, int to) {
      for (int pr = from; pr < to; ++pr) {
        if (wstep == 0) wlo = window_base(pr, w_max, T, WB);
        wstep = wstep + 1 == unroll ? 0 : wstep + 1;
        const uint4 tap = rows[(pr & (4 * kEpoch - 1)) * 3 + 2];
        if (!(tap.x & kLive)) continue;
        const int st0 = __vimax3_s32(0, pr - qlen + 1, (pr - w + 1) >> 1);
        const int en0 = __vimin3_s32(tlen - 1, pr, (pr + w) >> 1);
        // the taps' window lanes, clipped; the row holds the pairs from
        // pw0 (tap.z) on
        const uint2* row = reinterpret_cast<const uint2*>(taps + tap.w) - (int)tap.z;
        const int i0 = min(max(lt - wlo, 0), WB - 1);
        const int i1 = min(max(lt + 1 - wlo, 0), WB - 1);
        const int v_lt = half(row[i0 >> 1].x, i0 & 1);
        const int u_lt1 = half(row[i1 >> 1].y, i1 & 1);
        if (pr == 0) {  // lo == 0 and lt == 0, so the tap is v[0]
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
        if (pr == qlen + tlen - 2 && en0 == tlen - 1) score = H0;
      }
    };
    while (b < r_end) {
      // epoch e = [b, b_next): its end and shift from the row ring
      int r = b;
      uint32_t f;
      while (!((f = rows[(r & (4 * kEpoch - 1)) * 3 + 2].x) & kBarrier)) ++r;
      const int b_next = r + 1;
      if (walks && e > 0) {  // epoch e - 1, then lt for epoch e + 2's rows
        walk(b_prev, b);
        for (int k = 0; k < C; ++k) cluster_map(ltk, k)[e & 1] = lt;
      }
      // epoch e + 1's rows, from the lt sent during epoch e - 1
      if (lead && b_next < r_end) rw.fill_epoch(rows, e >= 1 ? ltk[(e + 1) & 1] : 0);
      epoch_sync(C);  // epoch e + 1 begins at b_next
      if (f & kShift) {
        epoch_sync(C);
        epoch_sync(C);
        epoch_sync(C);
      }
      b_prev = b;
      b = b_next;
      ++e;
    }
    if (walks) {
      if (r_end > 0) walk(b_prev, b);  // the last epoch
      score_out[n] = score;
    }
    return;
  }

  // the compute warps: pair J = c P + k nc + t, local index jl = k nc + t
  const uint8_t* trow = target + (size_t)n * Lt;
  uint8_t* drow = dirs + (size_t)n * R * WB;
  const int qe2 = sc.q2 + sc.e2;
  const PairScoring ps = pair_scoring(sc.a, sc.q, sc.e, sc.q2, sc.e2);
  const uint32_t init = splat(-qe), init2 = splat(-qe2);
  const uint32_t sa = splat(sc.a), sb = splat(-sc.b), se2 = splat(-sc.e2);
  // sv: each pair's substitution scores at the next wavefront, computed
  // after the chain of this one so that they fill its stalls
  uint32_t u[PPT], v[PPT], x[PPT], y[PPT], x2[PPT], y2[PPT], s[PPT], sv[PPT];
  uint32_t tcode[PPT], tn[PPT];
  int lo = 0;  // lo_al(0) == 0
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int jl = k * nc + t;
    u[k] = v[k] = x[k] = y[k] = init;
    x2[k] = y2[k] = init2;
    s[k] = kBias;  // 0
    target_pair(trow, 2 * (c * P + jl), Lt, tcode[k], tn[k]);
    sv[k] = subst_pair(qe16[__vimin_s32_relu(kQPad - 2 * (c * P + jl), qhi)], tcode[k], tn[k],
                       sa, sb, se2);
    xs[jl] = x[k];
    vs[jl] = v[k];
    x2s[jl] = x2[k];
  }
  const bool sends_halo = c + 1 < C && t == nc - 1;  // the block's last pair
  if (sends_halo && r_end > 0)
    st_async16(&halo[0], &hbar[0], c + 1, make_uint4(x[PPT - 1], v[PPT - 1], x2[PPT - 1], 0u));
  uint32_t* const taps0 = cluster_map(taps, 0);  // the walker's, in block 0
  uint16_t* dst = reinterpret_cast<uint16_t*>(drow);  // dirs row r, a pair a store

  for (int r = 0; r < r_end; ++r) {
    const uint4* row = rows + (r & (4 * kEpoch - 1)) * 3;
    const uint4 lim = row[0], fix = row[1];
    const uint32_t flags = row[2].x;
    const int st0 = (int)lim.x, s_end = (int)lim.y, st = (int)lim.z, en = (int)lim.w;
    const int h_edge = r & 1;
    compute_sync(nc);  // wavefront r-1's neighbour words are published
    const int p = (r & 1) * P;
    // block c-1's last pair, for the first pair (window pair 0 reads none:
    // it is in band only at lo = st = 0, where the fixups below replace all
    // three low halves)
    uint4 hw = make_uint4(x[0], v[0], x2[0], 0u);
    if (c > 0 && t == 0) {
      const int slot = r & (kHalo - 1);
      mbar_wait(&hbar[slot], (uint32_t)(r / kHalo) & 1u);
      hw = halo[slot];
      mbar_expect(&hbar[slot], sizeof(uint4));  // the slot's next round
    }
    // the pair step, branch-free: a pair outside the band keeps its state
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int jl = k * nc + t;
      const int lane0 = lo + 2 * (c * P + jl);
      s[k] = blend(span_mask(lane0, st0, s_end), sv[k], s[k]);
      const bool inb = lane0 >= st && lane0 <= en;
      const bool edge = (lane0 >> 1) == (r >> 1);  // edge-lane init at lane r
      const uint32_t uk = edge ? set_half(u[k], h_edge, fix.w) : u[k];
      const uint32_t yk = edge ? set_half(y[k], h_edge, init) : y[k];
      const uint32_t y2k = edge ? set_half(y2[k], h_edge, init2) : y2[k];
      const int jp = max(jl - 1, 0);
      const uint32_t xn = jl > 0 ? xs[p + jp] : hw.x;
      const uint32_t vn = jl > 0 ? vs[p + jp] : hw.y;
      const uint32_t x2n = jl > 0 ? x2s[p + jp] : hw.z;
      uint32_t xp = prev_lanes(xn, x[k]);
      uint32_t vp = prev_lanes(vn, v[k]);
      uint32_t x2p = prev_lanes(x2n, x2[k]);
      const bool at_st = lane0 == st;
      xp = blend(at_st ? fix.y : 0u, init, xp);
      x2p = blend(at_st ? fix.y : 0u, init2, x2p);
      vp = blend(at_st ? fix.z : 0u, fix.x, vp);
      const PairOut o = pair_step(s[k], xp, vp, x2p, uk, yk, y2k, ps);
      u[k] = inb ? o.u : u[k];
      v[k] = inb ? o.v : v[k];
      x[k] = inb ? o.x : x[k];
      y[k] = inb ? o.y : y[k];
      x2[k] = inb ? o.x2 : x2[k];
      y2[k] = inb ? o.y2 : y2[k];
      dst[c * P + jl] = (uint16_t)(inb ? o.d : 0u);
      // the next wavefront's substitution scores (a shift recomputes them)
      sv[k] = subst_pair(qe16[__vimin_s32_relu(r + 1 - lane0 + kQPad, qhi)], tcode[k], tn[k],
                         sa, sb, se2);
    }
    dst += NP;
    {  // the taps of this wavefront that lie in this block (none if dead)
      const uint4 tap = row[2];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const unsigned d = (unsigned)(c * P + k * nc + t - (int)tap.z);
        if (d < (unsigned)kTaps) {  // (v, u) of the pair, one 8-byte store
          const uint2 vu = make_uint2(v[k], u[k]);
          if (c == 0)
            reinterpret_cast<uint2*>(taps + tap.w)[d] = vu;
          else
            reinterpret_cast<uint2*>(taps0 + tap.w)[d] = vu;
        }
      }
    }

    const int rn = r + 1;
    if (flags & kBarrier) {
      const bool shift = flags & kShift;
      if (shift) {  // the window moves right: shift the lane state
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const int jl = k * nc + t;
          scr[jl] = u[k];
          scr[P + jl] = v[k];
          scr[2 * P + jl] = x[k];
          scr[3 * P + jl] = y[k];
        }
      }
      epoch_sync(C);  // the next epoch begins at rn
      if (shift) {
        const int nlo = (int)row[2].y;
        const int dp = (nlo - lo) >> 1;  // whole pairs: both bases are even
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const int src = c * P + k * nc + t + dp;
          if (src < NP) {
            const uint32_t b = __umulhi((uint32_t)src, pmagic);
            const uint32_t* sp = cluster_map(scr + src - (int)b * P, (int)b);
            u[k] = sp[0];
            v[k] = sp[P];
            x[k] = sp[2 * P];
            y[k] = sp[3 * P];
          } else {
            u[k] = v[k] = x[k] = y[k] = init;
          }
        }
        epoch_sync(C);  // every block has read the first round
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const int jl = k * nc + t;
          scr[jl] = x2[k];
          scr[P + jl] = y2[k];
          scr[2 * P + jl] = s[k];
        }
        epoch_sync(C);
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const int J = c * P + k * nc + t;
          const int src = J + dp;
          if (src < NP) {
            const uint32_t b = __umulhi((uint32_t)src, pmagic);
            const uint32_t* sp = cluster_map(scr + src - (int)b * P, (int)b);
            x2[k] = sp[0];
            y2[k] = sp[P];
            s[k] = sp[2 * P];
          } else {
            x2[k] = y2[k] = init2;
            s[k] = kBias;
          }
          target_pair(trow, nlo + 2 * J, Lt, tcode[k], tn[k]);
          sv[k] = subst_pair(qe16[__vimin_s32_relu(rn - nlo - 2 * J + kQPad, qhi)], tcode[k],
                             tn[k], sa, sb, se2);
        }
        epoch_sync(C);  // every block has read the scratch
        lo = nlo;
      }
    }
    if (rn < r_end) {  // publish wavefront r's neighbour words for rn
      const int pn = (rn & 1) * P;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int jl = k * nc + t;
        xs[pn + jl] = x[k];
        vs[pn + jl] = v[k];
        x2s[pn + jl] = x2[k];
      }
      if (sends_halo) {
        const int slot = rn & (kHalo - 1);
        st_async16(&halo[slot], &hbar[slot], c + 1,
                   make_uint4(x[PPT - 1], v[PPT - 1], x2[PPT - 1], 0u));
      }
    }
  }
  // rows r_end .. R-1 are zero: WB is a multiple of 128, so they are one
  // 16-byte aligned run, split over the cluster's compute threads
  uint4* z = reinterpret_cast<uint4*>(drow + (size_t)r_end * WB);
  const int nz = (R - r_end) * (WB / 16);
  for (int i = c * nc + t; i < nz; i += C * nc) z[i] = make_uint4(0, 0, 0, 0);
}

// The launch.

// pairs a compute thread holds for P pairs a block
int pairs_per_thread(int P) { return P <= kMaxCompute ? 1 : P <= 2 * kMaxCompute ? 2 : 4; }

size_t shared_bytes(int P, int64_t Lmax) {
  return (size_t)10 * P * sizeof(uint32_t) + kHalo * (sizeof(uint4) + sizeof(uint64_t)) +
         4 * kEpoch * 3 * sizeof(uint4) + (size_t)2 * kEpoch * 2 * kTaps * sizeof(uint32_t) +
         4 * sizeof(int) +
         (size_t)(Lmax + 2 * kQPad) * sizeof(uint16_t);
}

// the launch configuration of a window width and cluster size, or an
// error for one the kernel does not take
struct Plan {
  int P, ppt, threads;
  size_t shm;
};

cudaError_t plan_launch(int64_t Lmax, int64_t WB, int C, Plan& pl) {
  if (WB <= 0 || WB % 128 != 0 || WB > 4 * kMaxThreads) return cudaErrorInvalidValue;
  if (C < 1 || C > kMaxCluster || (WB / 2) % C != 0) return cudaErrorInvalidValue;
  pl.P = (int)(WB / 2) / C;
  if (C > 1 && pl.P < 64) return cudaErrorInvalidValue;  // a shift moves 64 pairs
  pl.ppt = pairs_per_thread(pl.P);
  if ((pl.P / pl.ppt) % 32 != 0) return cudaErrorInvalidValue;  // whole compute warps
  pl.threads = pl.P / pl.ppt + kWalker;
  pl.shm = shared_bytes(pl.P, Lmax);
  if (pl.shm > kMaxShared) return cudaErrorInvalidValue;
  return cudaSuccess;
}

using Kernel = void (*)(const uint8_t*, const uint8_t*, const int32_t*, const int32_t*,
                       const int32_t*, int32_t*, uint8_t*, int, int, int, int, int, int, int,
                       int, Scoring);

// the instantiation of a plan: pairs a thread and the block's thread budget
Kernel kernel_for(const Plan& pl) {
  if (pl.ppt == 1)
    return pl.threads <= 512 ? extd2_band_i16_kernel<1, 512> : extd2_band_i16_kernel<1, 1024>;
  if (pl.ppt == 2) return extd2_band_i16_kernel<2, 1024>;
  return extd2_band_i16_kernel<4, 2048 / 4 + kWalker>;
}

cudaError_t launch_config(const Plan& pl, int64_t N, int C, cudaStream_t stream,
                          cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_for(pl), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.shm);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(N * C));
  cfg.blockDim = dim3((unsigned)pl.threads);
  cfg.dynamicSmemBytes = pl.shm;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// C entry point (bound with ctypes), the arguments of
// csrc/extd2_band.cu's gdiet_extd2_band and the cluster size C. Pointers
// are device pointers; scoring is the derived (a, b, q, e, q2, e2,
// long_thres, long_diff) of gdiet_tpu_torch/ops/dp.py::derive_scoring,
// inside safe_state_dtype's bound (the wrapper checks it); WB is the window
// width of ops/dp_band.py::window_geometry (a multiple of 128, at most
// 4,096) and w_max the band budget it was computed from (every band <=
// w_max); C in {1, 2, 4, 8} divides WB / 2 into blocks of >= 64 pairs and
// whole compute warps (C = 1: any). Launches N clusters of C blocks on
// `stream` with cudaLaunchKernelEx and returns a CUDA error code (0 on
// success): the launch's own, else cudaGetLastError()'s. Nothing runs at
// another C.
extern "C" int gdiet_extd2_band_i16(const void* query, const void* target,
                                    const void* qlens, const void* tlens,
                                    const void* bands, void* score, void* dirs,
                                    int64_t N, int64_t Lmax, int64_t Lt, int64_t T,
                                    int64_t R, int64_t WB, int w_max, int unroll,
                                    int a, int b, int q, int e, int q2, int e2,
                                    int long_thres, int long_diff, int C, void* stream) {
  if (N <= 0) return 0;
  Plan pl;
  cudaError_t err = plan_launch(Lmax, WB, C, pl);
  if (err != cudaSuccess) return (int)err;
  if (WB >= T || unroll <= 0) return (int)cudaErrorInvalidValue;
  const Scoring sc{a, b, q, e, q2, e2, long_thres, long_diff};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = launch_config(pl, N, C, (cudaStream_t)stream, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kernel_for(pl), static_cast<const uint8_t*>(query),
                           static_cast<const uint8_t*>(target),
                           static_cast<const int32_t*>(qlens),
                           static_cast<const int32_t*>(tlens),
                           static_cast<const int32_t*>(bands), static_cast<int32_t*>(score),
                           static_cast<uint8_t*>(dirs), (int)Lmax, (int)Lt, (int)T, (int)R,
                           (int)WB, w_max, unroll, C, sc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The clusters of C blocks that can be resident on the current device at
// once for a launch of this window width and query budget
// (cudaOccupancyMaxActiveClusters), in *out; returns a CUDA error code.
extern "C" int gdiet_extd2_band_i16_max_clusters(int64_t Lmax, int64_t WB, int C, int* out) {
  Plan pl;
  cudaError_t err = plan_launch(Lmax, WB, C, pl);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  err = launch_config(pl, C, C, 0, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, kernel_for(pl), &cfg);
}
