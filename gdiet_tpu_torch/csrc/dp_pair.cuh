// Packed 16x2 lane pairs of the DP's int16 lane state, shared by
// extd2_i16.cu, extd2_band_i16.cu and extd2_fold_i16.cu (the int16 lane
// state of gdiet_tpu/ops/dp_pallas.py::extd2_batch_pallas, state_dtype =
// "int16", in each of its three layouts).
//
// Two neighbouring lanes (2j, 2j+1) of the seven lane-state arrays share
// one 32-bit word: lane 2j in the low half, lane 2j+1 in the high half, each
// half in offset binary (value + 0x8000, i.e. int16 with the sign bit
// flipped). Offset binary makes a 32-bit add the packed add: when every
// half's true result lies in int16's range, X + Y + k * 0x10001 (mod 2^32)
// holds exactly both halves of x + y + k, because a word is the linear form
// lo + 2^16 hi and no half carries into the other. So every add and
// subtract of the recurrence is one IADD3 with a constant, and the maxima
// compare offset-binary halves as unsigned 16-bit values, which is int16's
// order. The halves stay in range exactly when an int16 lane state does not
// wrap: under ops/dp.py::safe_state_dtype's bound (4 * (a + b + q + e + q2 +
// e2) < 32767) the kernels are bit-equal to the int32 ones.
//
// The chain of a pair is the int32 chain on both halves at once with
// Hopper's DPX instructions in their 16x2 forms: __vibmax_u16x2 gives the
// running maximum and, per half, the comparison that sets the direction code
// (the strict tie rule: the code moves only when the new term is greater);
// __viaddmax_s16x2_relu the max(term - (z - q), 0) of the four gap states,
// its per-half add taken modulo 2^16, where the two offsets cancel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pair16 {

constexpr uint32_t kBias = 0x80008000u;    // + kBias: plus 0x8000 per half
constexpr uint32_t kUnbias = 0x7fff8000u;  // + kUnbias: minus 0x8000 per half

// v (an int16 value) in both halves, offset binary
__host__ __device__ constexpr uint32_t splat(int v) {
  return (uint32_t)(v + 0x8000) * 0x10001u;
}

// the per-half constant k of the linear form: W + konst(k) adds k to both halves
__host__ __device__ constexpr uint32_t konst(int k) { return (uint32_t)k * 0x10001u; }

// the value of half h (0: low lane, 1: high lane) of word w
__device__ __forceinline__ int half(uint32_t w, int h) {
  return (int)((w >> (16 * h)) & 0xffffu) - 0x8000;
}

// the mask of half h
__device__ __forceinline__ uint32_t half_mask(int h) {
  return h ? 0xffff0000u : 0x0000ffffu;
}

// the halves of a where mask m is set, of b elsewhere
__device__ __forceinline__ uint32_t blend(uint32_t m, uint32_t a, uint32_t b) {
  return (a & m) | (b & ~m);
}

// word w with half h replaced by the offset-binary half of the splat word c
__device__ __forceinline__ uint32_t set_half(uint32_t w, int h, uint32_t c) {
  return blend(half_mask(h), c, w);
}

// the mask of the halves whose lane (lane0, lane0 + 1) lies in [lo, hi)
__device__ __forceinline__ uint32_t span_mask(int lane0, int lo, int hi) {
  return (lane0 >= lo && lane0 < hi ? 0x0000ffffu : 0u) |
         (lane0 + 1 >= lo && lane0 + 1 < hi ? 0xffff0000u : 0u);
}

// the lane t-1 neighbours of a pair: the high half of the previous pair
// below the low half of this one
__device__ __forceinline__ uint32_t prev_lanes(uint32_t prev, uint32_t cur) {
  return __byte_perm(prev, cur, 0x5432);
}

// two substitution scores (ints) as one offset-binary word
__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
  return (uint32_t)(lo + 0x8000) | ((uint32_t)(hi + 0x8000) << 16);
}

// the constants of a pair step, from the derived scoring
struct PairScoring {
  uint32_t a;         // splat(a): the running maximum's ceiling
  uint32_t mq, mq2;   // mq - Z is S(q - zv) per half (S: offset binary)
  uint32_t xq, xq2;   // relu + xq is S(relu - (q + e)) per half
};

__host__ __device__ inline PairScoring pair_scoring(int a, int q, int e, int q2, int e2) {
  return PairScoring{splat(a), konst(q) + 0x10000u, konst(q2) + 0x10000u,
                     konst(0x8000 - (q + e)), konst(0x8000 - (q2 + e2))};
}

struct PairOut {
  uint32_t u, v, x, y, x2, y2;
  uint32_t d;  // the two direction bytes: the low lane's in bits 0-7, the high's in 8-15
};

// One step of the recurrence on a pair (the body of csrc/extd2_band.cu's
// lane loop on both halves): s the substitution scores, xp/vp/x2p the lane
// t-1 neighbours (old x, v, x2), u/y/y2 the pair's own (edge-adjusted)
// state. All offset binary. floor: a word whose halves are <= 0 as int16
// (0, or kBias held in a register, which saves the four moves that build a
// constant 0 for the relu maxima each step).
__device__ __forceinline__ PairOut pair_step(uint32_t s, uint32_t xp, uint32_t vp,
                                             uint32_t x2p, uint32_t u, uint32_t y,
                                             uint32_t y2, const PairScoring& ps,
                                             uint32_t floor = 0u) {
  const uint32_t a_ = xp + vp + kUnbias;  // x + v, both halves
  const uint32_t b_ = y + u + kUnbias;
  const uint32_t a2_ = x2p + vp + kUnbias;
  const uint32_t b2_ = y2 + u + kUnbias;
  // running max with the strict tie rule: keep is (z >= term), per half
  bool kh, kl;
  uint32_t z = __vibmax_u16x2(s, a_, &kh, &kl);
  uint32_t dl = kl ? 0u : 1u, dh = kh ? 0u : 1u;
  z = __vibmax_u16x2(z, b_, &kh, &kl);
  dl = kl ? dl : 2u;
  dh = kh ? dh : 2u;
  z = __vibmax_u16x2(z, a2_, &kh, &kl);
  dl = kl ? dl : 3u;
  dh = kh ? dh : 3u;
  z = __vibmax_u16x2(z, b2_, &kh, &kl);
  dl = kl ? dl : 4u;
  dh = kh ? dh : 4u;
  z = __vimin3_u16x2(z, ps.a, ps.a);
  const uint32_t mq = ps.mq - z, mq2 = ps.mq2 - z;  // S(q - zv), S(q2 - zv)
  // max(term - (zv - q), 0) as plain int16: positive exactly when the gap
  // extends
  const uint32_t xr = __viaddmax_s16x2_relu(a_, mq, floor);
  const uint32_t yr = __viaddmax_s16x2_relu(b_, mq, floor);
  const uint32_t x2r = __viaddmax_s16x2_relu(a2_, mq2, floor);
  const uint32_t y2r = __viaddmax_s16x2_relu(b2_, mq2, floor);
  // bit 15 of each half of relu + 0x7fff is (relu > 0); moved to bits 3-6
  const uint32_t ext = (((xr + 0x7fff7fffu) >> 12) & 0x00080008u) |
                       (((yr + 0x7fff7fffu) >> 11) & 0x00100010u) |
                       (((x2r + 0x7fff7fffu) >> 10) & 0x00200020u) |
                       (((y2r + 0x7fff7fffu) >> 9) & 0x00400040u);
  PairOut o;
  o.u = z - vp + kBias;  // zv - vp
  o.v = z - u + kBias;   // zv - u
  o.x = xr + ps.xq;
  o.y = yr + ps.xq;
  o.x2 = x2r + ps.xq2;
  o.y2 = y2r + ps.xq2;
  o.d = __byte_perm(ext | dl | (dh << 16), 0u, 0x4420);
  return o;
}

}  // namespace pair16
