// The tensor-core attention pieces shared by K3 (flash_attention.cu) and K2
// (paged_attention.cu): one consumer warpgroup's fp32 online softmax over a
// 64-key tile of S held in wgmma accumulator registers, P split into two
// bf16 terms, and P V of the tile summed from zero on the tensor cores and
// added to O in fp32 registers.  Header only; every function is inline.
//
// Register layout (hopper.cuh ``acc_row`` / ``acc_col``): a thread holds the
// 32 values of S of two rows (row_a for i & 2 == 0, row_a + 8 otherwise)
// of the warpgroup's 64 x 64 tile; o[c] holds columns 64 c .. 64 c + 63 of
// O in the same layout.  m and l are the two rows' running max (log2
// units, equal over the four lanes of a row) and this thread's part of
// their sums.
//
// Numerics (kept here once for both kernels): P_hi =
// bf16(P) and P_lo = bf16(P - P_hi) carry P to about 2^-17, so P V keeps
// fp32-like accuracy on bf16 tensor cores; the tensor cores truncate their
// fp32 sums, so each tile's P V is summed from zero and added to O in fp32
// registers (rounding to nearest), which keeps the truncation from growing
// into a bias over a long row of keys.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace attn_tc {

constexpr float kNegInf = -1.0e38f;  // the Pallas kernels' NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBKV = 64;  // keys per tile

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// hi = bf16(x, y) and lo = bf16 of what hi leaves, as packed pairs.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 hi2 = __floats2bfloat162_rn(x, y);
  const float2 back = __bfloat1622float2(hi2);
  hi = bf16x2_bits(hi2);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - back.x, y - back.y));
}

// A raw score in log2 units: scale, or the accurate tanhf softcap.
__device__ __forceinline__ float log2_score(float s, float scale, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s * scale / softcap) * kLog2e : s * (scale * kLog2e);
}

// Online softmax of one tile of scaled, masked scores: sc becomes
// P = exp2(sc - m_new), m and l move on, alpha is the rescale of the rows'
// earlier sums.
__device__ __forceinline__ void online_softmax(float (&sc)[kBKV / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kBKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int e = 0; e < 2; ++e) {  // a row's values lie on 4 neighbouring lanes
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
    mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
    alpha[e] = exp2f(m[e] - mx[e]);
    m[e] = mx[e];
    l[e] *= alpha[e];
  }
#pragma unroll
  for (int i = 0; i < kBKV / 2; ++i) {
    sc[i] = exp2f(sc[i] - mx[(i >> 1) & 1]);
    l[(i >> 1) & 1] += sc[i];
  }
}

// O's rescale, then P into its two bf16 terms (the A fragments of P V).
template <int NC>
__device__ __forceinline__ void rescale_split(float (&o)[NC][32], const float (&sc)[kBKV / 2], const float (&alpha)[2],
                                              uint32_t (&p_hi)[kBKV / 4], uint32_t (&p_lo)[kBKV / 4]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int f = 0; f < kBKV / 4; ++f) split_bf16x2(sc[2 * f], sc[2 * f + 1], p_hi[f], p_lo[f]);
}

// pv = P_hi V + P_lo V, from zero, for PVC 64-column chunks of the V tile
// whose first chunk starts at shared address ``v_chunk`` (chunks
// kBKV * 128 bytes apart, MN-major): 128 columns per product where two
// chunks go together.  Issued as one commit group; the caller waits.
template <int PVC>
__device__ __forceinline__ void issue_pv(float (&pv)[PVC][32], uint32_t (&p_hi)[kBKV / 4], uint32_t (&p_lo)[kBKV / 4],
                                         uint32_t v_chunk) {
  using namespace hopper;
#pragma unroll
  for (int c = 0; c < PVC; ++c) fence_regs(pv[c]);
  fence_regs(p_hi);
  fence_regs(p_lo);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBKV / 16; ++j) {
    const uint64_t dv = smem_desc_mn(v_chunk + j * (16 * 128), kBKV * 128);
    if constexpr (PVC == 2) {
      wgmma_m64n128k16_bf16_rs_mn(pv[0], pv[1], p_hi[4 * j], p_hi[4 * j + 1], p_hi[4 * j + 2], p_hi[4 * j + 3], dv,
                                  j > 0);
      wgmma_m64n128k16_bf16_rs_mn(pv[0], pv[1], p_lo[4 * j], p_lo[4 * j + 1], p_lo[4 * j + 2], p_lo[4 * j + 3], dv, 1);
    } else {
      wgmma_m64n64k16_bf16_rs_mn(pv[0], p_hi[4 * j], p_hi[4 * j + 1], p_hi[4 * j + 2], p_hi[4 * j + 3], dv, j > 0);
      wgmma_m64n64k16_bf16_rs_mn(pv[0], p_lo[4 * j], p_lo[4 * j + 1], p_lo[4 * j + 2], p_lo[4 * j + 3], dv, 1);
    }
  }
  wgmma_commit();
}

// Once the issued P V is done: O (chunks c0 ..) += pv, rounded to nearest.
template <int PVC, int NC>
__device__ __forceinline__ void add_pv(float (&o)[NC][32], float (&pv)[PVC][32], uint32_t (&p_hi)[kBKV / 4],
                                       uint32_t (&p_lo)[kBKV / 4], int c0) {
  using namespace hopper;
#pragma unroll
  for (int c = 0; c < PVC; ++c) {
    fence_regs(pv[c]);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c0 + c][i] += pv[c][i];
  }
  fence_regs(p_hi);
  fence_regs(p_lo);
}

// The rows' full sums (the four lanes of a row), floored as the Pallas
// kernels floor them: the divisors of O.
__device__ __forceinline__ void row_denominators(float (&l)[2], float (&denom)[2]) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    denom[e] = fmaxf(l[e], 1e-30f);
  }
}

}  // namespace attn_tc
