// FP8 GEMM for Hopper (sm_90a): K4, the dequantizing product of two fp8
// matrices, out = (a / sa) @ (b / sb) in fp32.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   K4  src/repro/fp8/gemm.py  fp8_gemm / _fp8_gemm_kernel
//
// What it computes, as the TPU kernel does: a (M, K) and b (K, N) are fp8,
// e4m3 or e5m2 on either side (the backward of fp8_dot mixes them); every
// product and every sum is fp32; the accumulator is multiplied once, at the
// end, by 1 / (sa * sb), with sa and sb read from device memory (no host
// sync).  fp8 values convert to fp32 exactly, and the product of two of them
// is exact in fp32, so only the order of the fp32 sums differs from the
// plain version.
//
// What bounds it on the card: the operations.  2 M N K of them against
// M N fp32 outputs and (M + N) K input bytes; at the training path's shapes
// (M = 8192 tokens, K, N in {2048, 8192}) that is hundreds of operations per
// byte.  A tensor-core kernel could run these products at the fp8 dense
// rate (1,979 TFLOP/s), so that is the bound stated for it; this first
// version runs them on the CUDA cores in fp32 (67 TFLOP/s peak) and so
// stays far above the bound.  Hopper's fp8 tensor cores accumulate with
// fewer bits than fp32; a tensor-core version must promote its partial sums
// to fp32 registers every few k-steps to keep these numerics (later work).
//
// Design (not carried over from the Pallas grid, whose k axis revisits an
// output block in VMEM):
//  * one thread block of 256 threads owns a 128 x 128 output tile and loops
//    over K in steps of 32 itself; each thread keeps an 8 x 8 block of the
//    tile in registers (rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
//    likewise from tx), so each k-step costs 4 float4 shared-memory reads
//    per 64 fused multiply-adds;
//  * each operand is read with its two strides, so the transposed operands
//    of the backward (qw.T, qx.T) are views and cost no copy; one of the two
//    strides must be 1.  A 128 x 32 fp8 tile is 256 chunks of 16 bytes, one
//    per thread, loaded with one 16-byte load where the chunk lies inside
//    the matrix and is aligned, and byte by byte with zero fill at ragged
//    edges, so no padded copy of an operand is ever made;
//  * the next tile's chunks are loaded into registers while the current
//    tile is multiplied, then converted to fp32 into shared memory, stored
//    k-major ([k][row]) so the inner loop reads rows as float4.
//
// Entry point: a plain C interface (loaded with ctypes) that returns
// cudaGetLastError() after the launch.  The caller guarantees the strides
// and alignment flags it passes, fp32 scales, and a contiguous (M, N) fp32
// output.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output rows per thread block
constexpr int kBN = 128;  // output columns per thread block
constexpr int kBK = 32;   // k per step
constexpr int kThreads = 256;
constexpr int kLd = 128 + 4;  // shared row stride in floats: [k][outer], 16-byte aligned rows

// One fp8 operand as a matrix (outer, K): outer is M for a, N for b.
struct Operand {
  const uint8_t* p;
  long long s_outer;  // elements between neighbouring outer indices
  long long s_k;      // elements between neighbouring k
  int outer;
  int e5m2;      // 1: e5m2, 0: e4m3
  int k_contig;  // 1: s_k == 1, 0: s_outer == 1
  int vec;       // 16-byte loads allowed where a chunk lies inside the matrix
};

__device__ __forceinline__ float fp8_to_float(uint8_t v, int e5m2) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(v, e5m2 ? __NV_E5M2 : __NV_E4M3);
  return __half2float(__half(h));
}

// This thread's 16-byte chunk of the operand's tile at (o0, k0).  A k-major
// operand's tile is 128 rows x 2 chunks of k; an outer-major one's is 32 k x
// 8 chunks of rows.  Bytes outside the matrix read as 0 (fp8 zero).
__device__ __forceinline__ uint4 load_chunk(const Operand& op, int o0, int k0, int K) {
  const int tid = threadIdx.x;
  const uint8_t* src;  // the chunk's first byte; its 16 bytes are consecutive
  int n_in;            // how many of them lie inside the matrix
  if (op.k_contig) {
    const int o = o0 + (tid >> 1);
    const int k = k0 + (tid & 1) * 16;
    src = op.p + o * op.s_outer + k;
    n_in = o < op.outer ? K - k : 0;
  } else {
    const int k = k0 + (tid >> 3);
    const int o = o0 + (tid & 7) * 16;
    src = op.p + k * op.s_k + o;
    n_in = k < K ? op.outer - o : 0;
  }
  if (op.vec && n_in >= 16) return *reinterpret_cast<const uint4*>(src);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  uint8_t* b = reinterpret_cast<uint8_t*>(&r);
#pragma unroll
  for (int e = 0; e < 16; ++e) b[e] = e < n_in ? src[e] : uint8_t(0);
  return r;
}

// Convert this thread's chunk to fp32 and store it in the [k][outer] tile.
__device__ __forceinline__ void store_chunk(const Operand& op, uint4 r, float* tile) {
  const int tid = threadIdx.x;
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&r);
  if (op.k_contig) {
    const int o = tid >> 1;
    const int k = (tid & 1) * 16;
#pragma unroll
    for (int e = 0; e < 16; ++e) tile[(k + e) * kLd + o] = fp8_to_float(b[e], op.e5m2);
  } else {
    const int k = tid >> 3;
    const int o = (tid & 7) * 16;
    float4* dst = reinterpret_cast<float4*>(tile + k * kLd + o);
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      dst[e / 4] = make_float4(fp8_to_float(b[e], op.e5m2), fp8_to_float(b[e + 1], op.e5m2),
                               fp8_to_float(b[e + 2], op.e5m2), fp8_to_float(b[e + 3], op.e5m2));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    fp8_gemm_kernel(Operand a, Operand b, const float* __restrict__ sa,
                    const float* __restrict__ sb, float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float As[kBK * kLd];
  __shared__ __align__(16) float Bs[kBK * kLd];
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  uint4 ra = load_chunk(a, m0, 0, K);
  uint4 rb = load_chunk(b, n0, 0, K);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous step's reads of the tiles are done
    store_chunk(a, ra, As);
    store_chunk(b, rb, Bs);
    __syncthreads();
    if (k0 + kBK < K) {  // next step's loads, in flight during the products
      ra = load_chunk(a, m0, k0 + kBK, K);
      rb = load_chunk(b, n0, k0 + kBK, K);
    }
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * kLd + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * kLd + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * kLd + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * kLd + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  const float inv = 1.0f / (sa[0] * sb[0]);
  const bool vec_out = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
    float* orow = out + size_t(row) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (vec_out && col < N) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][4 * h] * inv, acc[i][4 * h + 1] * inv, acc[i][4 * h + 2] * inv,
                        acc[i][4 * h + 3] * inv);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) orow[col + j] = acc[i][4 * h + j] * inv;
      }
    }
  }
}

}  // namespace

extern "C" {

// out (M, N) fp32 contiguous = (a / *sa) @ (b / *sb).  a is (M, K) with
// strides (a_sm, a_sk), b is (K, N) with strides (b_sk, b_sn), in elements;
// one stride of each is 1.  *_e5m2 picks e5m2 (1) or e4m3 (0); *_vec allows
// 16-byte loads (the base is 16-byte aligned and the stride that is not 1 is
// a multiple of 16).
int fp8_gemm(const void* a, const void* b, const void* sa, const void* sb, void* out, int M, int N,
             int K, long long a_sm, long long a_sk, long long b_sk, long long b_sn, int a_e5m2,
             int b_e5m2, int a_vec, int b_vec, void* stream) {
  Operand A{static_cast<const uint8_t*>(a), a_sm, a_sk, M, a_e5m2, a_sk == 1 ? 1 : 0, a_vec};
  Operand B{static_cast<const uint8_t*>(b), b_sn, b_sk, N, b_e5m2, b_sk == 1 ? 1 : 0, b_vec};
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  fp8_gemm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, B, static_cast<const float*>(sa), static_cast<const float*>(sb), static_cast<float*>(out),
      M, N, K);
  return int(cudaGetLastError());
}

}  // extern "C"
