// FP8 GEMM for Hopper (sm_90a): K4, the dequantizing product of two fp8
// matrices, out = (a / sa) @ (b / sb) in fp32, on the tensor cores.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   K4  src/repro/fp8/gemm.py  fp8_gemm / _fp8_gemm_kernel
//
// What it computes, as the TPU kernel does: a (M, K) and b (K, N) are fp8,
// e4m3 or e5m2 on either side (the backward of fp8_dot mixes them); every
// product is exact and every sum is kept at fp32 precision; the sum is
// multiplied once, at the end, by 1 / (sa * sb), with sa and sb read from
// device memory (no host sync).  Only the order of the fp32 sums differs
// from the plain version.
//
// What bounds it on the card: the operations.  2 M N K of them, at the fp8
// dense rate of 1,979 TFLOP/s, against M K + K N bytes of operands and the
// 4 M N bytes of the fp32 output at 3.35 TB/s; at the training path's
// shapes (8192 tokens; K and N in {2048, 8192}) the operations take 1.3-3.1x
// the bytes' time (ffn_up: 0.139 ms against 0.090 ms).
//
// Numerics, and the route taken.  Hopper's fp8 tensor cores (wgmma ...
// e4m3/e5m2) sum their products with fewer bits than fp32 (about 14, per the
// DeepSeek-V3 report, arXiv:2412.19437 section 3.3.2).  Promoting a partial
// sum to fp32 registers every P k32-steps bounds how much is lost across
// steps but not inside one.  The port holds K4 to fp32 sums (1e-5 of the
// output's largest magnitude against the plain version), and on the H100 no
// P of 4, 2 or 1 stayed within that (PERF.md has the readings).  So the
// kernel takes the exact route: every e4m3 and e5m2 value is an fp16 value
// (subnormals included), so the landed fp8 tiles are converted to fp16 and
// multiplied by wgmma m64n128k16 f32.f16.f16, whose products are exact, at
// up to 989 TFLOP/s.  Its tensor cores sum in fp32 but truncate, and over
// K = 8192 the bias grows: each 128-k stage therefore sums from zero
// (scale-d = 0) and the CUDA cores add the partial into fp32 registers,
// rounding to nearest (promotion every 128 k).
//
// What bounds the exact route: shared memory.  Per 128-k stage of a block
// the tensor cores need about 1,000 cycles at the fp16 rate; shared memory
// moves 128 bytes a cycle.  Converting both tiles into shared memory and
// reading both from it (this kernel's first form) moved 224 KB a stage; with
// A converted into registers (the wgmma A-from-registers form) a stage moves
// 160 KB: 32 KB of TMA writes, 32 KB of fp8 reads, 32 KB of b's fp16
// writes and 64 KB of b's fp16 reads by the two warpgroups.
//
// Design:
//  * operands reach the kernel K-major: a as (M, K) and b as (N, K), each
//    with a leading stride that is a multiple of 16 bytes; the wrapper
//    makes a K-major copy of an operand that is not (one 128-byte TMA box
//    row is then 128 values of k, and a tensor map's strides must be
//    multiples of 16 bytes);
//  * a block of 384 threads owns a 128 x 128 output tile.  Warpgroup 0 is
//    the producer: one thread keeps 2-D TMA loads of 128 rows x 128 k-bytes
//    (128B swizzle, zero fill past the edges, so ragged M, N and K need no
//    padding) in flight through a ring of stages with full and empty
//    mbarriers.  Warpgroups 1 and 2 each own 64 x 128 of the tile;
//  * each consumer thread loads its A values of a landed
//    stage into registers and converts them to its wgmma A fragments; the
//    two warpgroups convert b's tile into one of two fp16 buffers (in the
//    swizzled layout wgmma reads) while the tensor cores still multiply the
//    previous stage, then meet at a named barrier and issue 8 wgmma k16
//    steps.  The k order within a stage is permuted (see load_a) so that a
//    thread's A values are whole 16-byte chunks; b's buffer follows it;
//  * epilogue: the accumulator times 1 / (sa sb), stored as fp32 with edge
//    masks.  Not persistent: one tile per block.
//
// Build: libcuda's cuTensorMapEncodeTiled is looked up at run time through
// the CUDA runtime (hopper.cuh), so no -lcuda.  Entry point:
// a plain C interface (loaded with ctypes) that returns 0 or an error code.

#include <cuda_fp8.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 128;                        // output rows and columns per block, k per stage
constexpr int kTileBytes = kTile * kTile;         // one fp8 operand tile
constexpr int kStageBytes = 2 * kTileBytes;       // a's and b's tiles of one stage
constexpr int kHalfBytes = kTile * 64 * 2;        // 128 rows x 64 fp16 (one swizzle-row of k)
constexpr int kF16Bytes = 2 * kHalfBytes;         // b's tile in fp16: two k-halves
constexpr int kThreads = 384;
constexpr int kStages = 4;                        // fp8 stages in the ring

// 1024 bytes of alignment slack, the fp8 ring, b's two fp16 buffers, the
// full and empty mbarriers
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kF16Bytes + 2 * 8 * kStages;

// Four fp8 values (one 32-bit word) to four fp16 values, exactly: ``lo``
// holds the first two, ``hi`` the last two.
template <bool E5M2>
__device__ __forceinline__ void fp8x4_to_f16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if (E5M2) {  // an e5m2 value is the upper byte of the fp16 value
    lo = __byte_perm(w, 0u, 0x1404);
    hi = __byte_perm(w, 0u, 0x3424);
  } else {
    const __half2_raw l = __nv_cvt_fp8x2_to_halfraw2(__nv_fp8x2_storage_t(w & 0xFFFFu), __NV_E4M3);
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(__nv_fp8x2_storage_t(w >> 16), __NV_E4M3);
    lo = uint32_t(l.x) | (uint32_t(l.y) << 16);
    hi = uint32_t(h.x) | (uint32_t(h.y) << 16);
  }
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The order of k.  A thread's A fragment of k16 step j (0..7
// in a 128-k stage) covers fragment columns s = 2q + e + 8 hi (q = t & 3,
// e, hi in {0, 1}).  Column s of step j is taken to be stage column
//   32 q + 4 j + 2 hi + e,   i.e. byte 4 (j & 3) + 2 hi + e of the 16-byte
//   chunk 2 q + (j >> 2) of a row,
// so that a thread reads its A values as whole chunks.  The sum over k does
// not depend on the order, and b's fp16 tile is written in the same order.

// A's fp8 chunks of this thread for the stage: chunks 2q and 2q + 1 of its
// two fragment rows (64 w + a_frag_row), from the swizzled tile.
__device__ __forceinline__ void load_a(const uint8_t* tile, int w, int tw, uint4 (&raw)[4]) {
  const int q = tw & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // i = 2 * (row is the lower one) + chunk parity
    const int row = w * 64 + a_frag_row(tw, i >> 1);
    raw[i] = *reinterpret_cast<const uint4*>(tile + row * 128 + (((2 * q + (i & 1)) ^ (row & 7)) << 4));
  }
}

// The fragments of the stage's 8 k16 steps in fp16: step j in a[4j .. 4j+3].
template <bool E5M2>
__device__ __forceinline__ void convert_a(const uint4 (&raw)[4], uint32_t (&a)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    fp8x4_to_f16<E5M2>(word(raw[j >> 2], j & 3), a[4 * j + 0], a[4 * j + 2]);
    fp8x4_to_f16<E5M2>(word(raw[2 + (j >> 2)], j & 3), a[4 * j + 1], a[4 * j + 3]);
  }
}

// b's landed fp8 tile (128 rows x 128 bytes, 128B swizzle) into fp16 in the
// order above (two k-halves of 128 rows x 64 values, 128B swizzle): thread t
// of the 256 consumers converts half t >> 7 of row t & 127.  It reads chunks
// 2q + half (q = 0..3) and writes fp16 chunk 2 (j & 3) + hi of the half from
// byte pair hi of word j & 3 of each.  Neighbouring threads take
// neighbouring rows, so 8 of them reach 8 distinct banks.
template <bool E5M2>
__device__ __forceinline__ void convert_b(const uint8_t* tile, uint8_t* f16, int t) {
  const int r = t & 127;
  const int half = t >> 7;
  const int sw = r & 7;
  uint4 c[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    c[q] = *reinterpret_cast<const uint4*>(tile + r * 128 + (((2 * q + half) ^ sw) << 4));
  uint8_t* row = f16 + half * kHalfBytes + r * 128;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    uint4 lo, hi;
    fp8x4_to_f16<E5M2>(word(c[0], jj), lo.x, hi.x);
    fp8x4_to_f16<E5M2>(word(c[1], jj), lo.y, hi.y);
    fp8x4_to_f16<E5M2>(word(c[2], jj), lo.z, hi.z);
    fp8x4_to_f16<E5M2>(word(c[3], jj), lo.w, hi.w);
    *reinterpret_cast<uint4*>(row + (((2 * jj) ^ sw) << 4)) = lo;
    *reinterpret_cast<uint4*>(row + (((2 * jj + 1) ^ sw) << 4)) = hi;
  }
}

// AE5, BE5: a and b are e5m2 (true) or e4m3 (false).
template <bool AE5, bool BE5>
__global__ void __launch_bounds__(kThreads, 1)
    fp8_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                    const float* __restrict__ sa, const float* __restrict__ sb,
                    float* __restrict__ out, int M, int N, int K) {
  constexpr int S = kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024-byte alignment
  uint8_t* const base_ptr = smem_raw + (base - raw);
  const uint32_t f16_base = base + S * kStageBytes;
  const uint32_t bars = f16_base + 2 * kF16Bytes;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (S + s); };

  const int nk = (K + kTile - 1) / kTile;
  const int m0 = blockIdx.y * kTile;
  const int n0 = blockIdx.x * kTile;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(empty(s), ((kt / S) - 1) & 1);
        mbar_arrive_expect_tx(full(s), kStageBytes);
        tma_load_2d(base + s * kStageBytes, &map_a, full(s), kt * kTile, m0);
        tma_load_2d(base + s * kStageBytes + kTileBytes, &map_b, full(s), kt * kTile, n0);
      }
    }
  } else {  // consumers: warpgroup w = 0, 1 owns rows 64 w .. 64 w + 63 of the tile
    setmaxnreg_inc<232>();
    const int t = threadIdx.x - 128;
    const int w = t >> 7;
    const int lane = t & 31;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    float part[64];  // a partial sum of the tensor cores, before its promotion
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;

    uint8_t* const f16_ptr = base_ptr + (f16_base - base);
    const int tw = t & 127;
    uint4 raw[4];     // the next stage's A fp8 chunks
    uint32_t a[32];   // this stage's A fragments in fp16
    // stage kt: A's chunks into registers, b's tile into fp16 buffer kt & 1
    // (its readers, step kt-2, are done when the call runs), then the
    // fp8 stage goes back to the producer
    auto stage_in = [&](int kt) {
      const int s = kt % S;
      mbar_wait(full(s), (kt / S) & 1);
      const uint8_t* st = base_ptr + s * kStageBytes;
      load_a(st, w, tw, raw);
      convert_b<BE5>(st + kTileBytes, f16_ptr + (kt & 1) * kF16Bytes, t);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
      fence_proxy_async();  // b's fp16 tile, written by threads, is read by wgmma
    };
    stage_in(0);
    convert_a<AE5>(raw, a);
    fence_regs(a);
    for (int kt = 0; kt < nk; ++kt) {
      // both warpgroups: b of stage kt converted, step kt-1 done (so
      // buffer (kt+1) & 1 is free)
      named_barrier(1, 256);
      const uint32_t fb = f16_base + (kt & 1) * kF16Bytes;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // the stage's partial starts from zero
        const uint32_t koff = (j >> 2) * kHalfBytes + (j & 3) * 32;
        wgmma_m64n128k16_f16_rs(part, a[4 * j], a[4 * j + 1], a[4 * j + 2], a[4 * j + 3], smem_desc(fb + koff), j > 0);
      }
      wgmma_commit();
      if (kt + 1 < nk) stage_in(kt + 1);  // while the tensor cores run step kt
      // the step ends inside the iteration, so no register copy of the loop
      // lands between a product and its wait
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];  // fp32, rounded to nearest
      fence_regs(a);
      if (kt + 1 < nk) {
        convert_a<AE5>(raw, a);
        fence_regs(a);
      }
    }

    const float inv = 1.0f / (sa[0] * sb[0]);
    const bool vec = (N & 1) == 0;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = m0 + w * 64 + acc_row(tw, i);
      const int col = n0 + acc_col(tw, i);
      if (row >= M) continue;
      float* o = out + size_t(row) * N + col;
      if (vec && col + 1 < N) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[i] * inv, acc[i + 1] * inv);
      } else {
        if (col < N) o[0] = acc[i] * inv;
        if (col + 1 < N) o[1] = acc[i + 1] * inv;
      }
    }
  }
}

template <bool AE5, bool BE5>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, const float* sa, const float* sb, float* out,
           int M, int N, int K, cudaStream_t stream) {
  auto kernel = fp8_gemm_kernel<AE5, BE5>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return int(e);
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(ma, mb, sa, sb, out, M, N, K);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (M, N) fp32 contiguous = (a / *sa) @ (b / *sb).  a is stored K-major
// as (M, K) with lda bytes between rows, b K-major as (N, K) with ldb bytes
// between rows; both bases 16-byte aligned, lda and ldb multiples of 16.
// *_e5m2 picks e5m2 (1) or e4m3 (0).  Returns 0, a CUDA error code, or -1
// if cuTensorMapEncodeTiled refused a tensor map.
int fp8_gemm(const void* a, const void* b, const void* sa, const void* sb, void* out, int M, int N,
             int K, long long lda, long long ldb, int a_e5m2, int b_e5m2, void* stream) {
  CUtensorMap ma, mb;
  if (!encode_kmajor_sw128(&ma, a, M, K, lda, kTile, 1, CU_TENSOR_MAP_DATA_TYPE_UINT8) ||
      !encode_kmajor_sw128(&mb, b, N, K, ldb, kTile, 1, CU_TENSOR_MAP_DATA_TYPE_UINT8))
    return -1;
  const float* fa = static_cast<const float*>(sa);
  const float* fb = static_cast<const float*>(sb);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_e5m2 && b_e5m2) return launch<true, true>(ma, mb, fa, fb, o, M, N, K, st);
  if (a_e5m2) return launch<true, false>(ma, mb, fa, fb, o, M, N, K, st);
  if (b_e5m2) return launch<false, true>(ma, mb, fa, fb, o, M, N, K, st);
  return launch<false, false>(ma, mb, fa, fb, o, M, N, K, st);
}

}  // extern "C"
