// BabelStream for Hopper (sm_90a): K6, the card's memory-bandwidth kernels.
//
// Replaces the Pallas TPU kernels of the JAX package:
//   K6  src/repro/kernels/babelstream.py  stream_copy / stream_mul / stream_add /
//       stream_triad / stream_dot  (_copy_kernel, _mul_kernel, _add_kernel,
//       _triad_kernel, _dot_kernel)
//
// What they compute, as the TPU kernels do, on 1-D arrays of n elements:
//   copy   c = a
//   mul    b = s * c
//   add    c = a + b
//   triad  a = b + s * c
//   dot    partial[i] = sum over tile i of fp32(a) * fp32(b)   (tiles of `block`)
// The scalar s arrives already rounded to the array's dtype (the wrapper
// rounds it as JAX rounds a weakly typed Python float).  bf16 arithmetic is
// done in fp32 and rounded to bf16 after every operation, as PyTorch's and
// JAX's elementwise bf16 ops do: triad rounds s * c, then the sum, and
// __fmul_rn / __fadd_rn keep the compiler from contracting the two.  An fp32
// triad is one fused multiply-add, rounded once (__fmaf_rn): XLA compiles
// the JAX kernel's b + s * c so, and the plain version emulates it exactly.
// So copy, mul, add and triad are bit-equal to their plain versions in
// both dtypes.  dot upcasts to fp32 as
// _dot_kernel does and writes one fp32 partial per tile; the wrapper sums
// the partials, as the JAX package sums them outside its kernel.
//
// What bounds them on the card: the bytes.  Each element is read once and
// written once (2 or 3 arrays of n elements, BabelStream's count) with at
// most two flops per element, so 3.35 TB/s of device memory is the limit.
//
// Design (not the Pallas grid of VMEM-sized tiles, which exists to
// double-buffer HBM->VMEM copies): enough bytes in flight to cover the
// memory latency, and nothing else in the way.
//  * every thread moves 16 bytes per load and store (4 fp32 or 8 bf16
//    elements), neighbouring threads on neighbouring 16-byte chunks;
//  * each thread issues kUnroll (U = 2) independent 16-byte loads per input
//    before any store or FMA, on a contiguous tile of 256 U chunks per
//    block; the grid holds every whole tile, so the block scheduler
//    balances the SMs; block 0 also takes the ragged end;
//  * index math is 32-bit where the array allows (fewer than 2^31 chunks),
//    64-bit otherwise.
// On the H100, U = 4 and 8, a grid of the SMs' occupancy walking the tiles
// (its last round is uneven) and the streaming cache hints (__ldcs /
// __stcs) were each slower (PERF.md).
// dot runs one thread block per tile of `block` elements; each thread keeps
// U independent fp32 sums, then the block reduces them by warp shuffles and
// shared memory and writes its partial.
//
// Entry points: a plain C interface (loaded with ctypes) that returns
// cudaGetLastError() after the launch.  The caller guarantees contiguous
// arrays on 16-byte boundaries, n a multiple of 16 bytes' worth of
// elements, and (dot) n a multiple of block, block a multiple of that width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;  // U: independent 16-byte loads per input per thread

// Every load of the kernels: a plain 16-byte load.  Indexing the
// __restrict__ arguments directly instead ran dot 4-6% slower on the H100
// (PERF.md), though the loads are the same bytes.
__device__ __forceinline__ uint4 load16(const uint4* p) { return *p; }

enum Op { kCopy = 0, kMul = 1, kAdd = 2, kTriad = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// One 16-byte chunk of the result from the chunks of x and y.
template <typename T, int OP>
__device__ __forceinline__ uint4 apply(const uint4& xv, const uint4& yv, float s) {
  if constexpr (OP == kCopy) {
    return xv;
  } else {
    constexpr int N = 16 / sizeof(T);
    uint4 ov;
    const T* x = reinterpret_cast<const T*>(&xv);
    const T* y = reinterpret_cast<const T*>(&yv);
    T* o = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if constexpr (OP == kMul) {
        o[j] = from_f<T>(__fmul_rn(s, to_f(x[j])));
      } else if constexpr (OP == kAdd) {
        o[j] = from_f<T>(__fadd_rn(to_f(x[j]), to_f(y[j])));
      } else if constexpr (sizeof(T) == 4) {  // kTriad, fp32: x = b, y = c, one rounding
        o[j] = __fmaf_rn(s, to_f(y[j]), to_f(x[j]));
      } else {  // kTriad, bf16: the product is rounded to bf16 before the sum
        const T p = from_f<T>(__fmul_rn(s, to_f(y[j])));
        o[j] = from_f<T>(__fadd_rn(to_f(x[j]), to_f(p)));
      }
    }
    return ov;
  }
}

// out = op(x, y) over nvec 16-byte chunks: block t takes the tile of
// kThreads * U chunks at t * kThreads * U, block 0 also the ragged end; I
// is the index type.
template <typename T, int OP, typename I>
__global__ void __launch_bounds__(kThreads) stream_kernel(const uint4* __restrict__ x,
                                                          const uint4* __restrict__ y,
                                                          uint4* __restrict__ out, I nvec, float s) {
  constexpr bool kTwo = OP == kAdd || OP == kTriad;  // a second input
  constexpr I kTile = I(kThreads) * kUnroll;
  const I whole = nvec / kTile;
  if (I(blockIdx.x) < whole) {
    const I i0 = I(blockIdx.x) * kTile + threadIdx.x;
    uint4 xv[kUnroll], yv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) xv[u] = load16(x + i0 + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) yv[u] = kTwo ? load16(y + i0 + u * kThreads) : xv[u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) out[i0 + u * kThreads] = apply<T, OP>(xv[u], yv[u], s);
  }
  if (blockIdx.x == 0) {
    for (I i = whole * kTile + threadIdx.x; i < nvec; i += kThreads) {
      const uint4 xv = load16(x + i);
      out[i] = apply<T, OP>(xv, kTwo ? load16(y + i) : xv, s);
    }
  }
}

template <typename T>
__device__ __forceinline__ void fma_chunk(const uint4& av, const uint4& bv, float& acc) {
  constexpr int N = 16 / sizeof(T);
  const T* x = reinterpret_cast<const T*>(&av);
  const T* y = reinterpret_cast<const T*>(&bv);
#pragma unroll
  for (int j = 0; j < N; ++j) acc = fmaf(to_f(x[j]), to_f(y[j]), acc);
}

// Sum of fp32(a) * fp32(b) over one tile of `block` elements per thread
// block; the tile's partial goes to partials[blockIdx.x].
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads) dot_kernel(const uint4* __restrict__ a,
                                                       const uint4* __restrict__ b,
                                                       float* __restrict__ partials, I vec_per_tile) {
  constexpr I kStep = I(kThreads) * kUnroll;
  const uint4* at = a + I(blockIdx.x) * vec_per_tile;
  const uint4* bt = b + I(blockIdx.x) * vec_per_tile;
  float sums[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) sums[u] = 0.f;
  const I whole = vec_per_tile / kStep * kStep;
  for (I i = threadIdx.x; i < whole; i += kStep) {
    uint4 av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) av[u] = load16(at + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) bv[u] = load16(bt + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fma_chunk<T>(av[u], bv[u], sums[u]);
  }
  for (I i = whole + threadIdx.x; i < vec_per_tile; i += kThreads) fma_chunk<T>(load16(at + i), load16(bt + i), sums[0]);
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) acc += sums[u];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) partials[blockIdx.x] = acc;
  }
}

template <typename T, int OP, typename I>
int launch_op(const void* x, const void* y, void* out, long long nvec, float s, cudaStream_t st) {
  const long long whole = nvec / ((long long)kThreads * kUnroll);
  if (whole > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  stream_kernel<T, OP, I><<<dim3(static_cast<unsigned>(whole > 0 ? whole : 1)), kThreads, 0, st>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(y), static_cast<uint4*>(out), I(nvec), s);
  return int(cudaGetLastError());
}

template <typename T, typename I>
int launch_stream(int op, const void* x, const void* y, void* out, long long nvec, float s, cudaStream_t st) {
  switch (op) {
    case kCopy: return launch_op<T, kCopy, I>(x, y, out, nvec, s, st);
    case kMul: return launch_op<T, kMul, I>(x, y, out, nvec, s, st);
    case kAdd: return launch_op<T, kAdd, I>(x, y, out, nvec, s, st);
    case kTriad: return launch_op<T, kTriad, I>(x, y, out, nvec, s, st);
    default: return int(cudaErrorInvalidValue);
  }
}

// 32-bit indices while every chunk index (and the last tile's end) fits
constexpr long long kMax32 = 0x7fffffffLL - (long long)kThreads * kUnroll;

}  // namespace

extern "C" {

// op: 0 copy (x), 1 mul (x = c), 2 add (x = a, y = b), 3 triad (x = b,
// y = c).  n elements of fp32 (bf16 = 0) or bf16 (bf16 = 1); s is the
// scalar, already rounded to the dtype.  y may be null for copy and mul.
int stream_run(int op, int bf16, const void* x, const void* y, void* out, long long n, float s,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nvec = n * (bf16 ? 2 : 4) / 16;
  if (nvec <= kMax32)
    return bf16 ? launch_stream<__nv_bfloat16, unsigned>(op, x, y, out, nvec, s, st)
                : launch_stream<float, unsigned>(op, x, y, out, nvec, s, st);
  return bf16 ? launch_stream<__nv_bfloat16, long long>(op, x, y, out, nvec, s, st)
              : launch_stream<float, long long>(op, x, y, out, nvec, s, st);
}

// partials: (n / block,) fp32, one per tile of `block` elements.
int stream_dot_partials(int bf16, const void* a, const void* b, void* partials, long long n,
                        long long block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = n / block;
  const long long vec_per_tile = block * (bf16 ? 2 : 4) / 16;
  if (tiles <= 0 || tiles > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  const uint4* av = static_cast<const uint4*>(a);
  const uint4* bv = static_cast<const uint4*>(b);
  float* p = static_cast<float*>(partials);
  const dim3 grid(static_cast<unsigned>(tiles));
  if (n * (bf16 ? 2 : 4) / 16 <= kMax32) {
    if (bf16)
      dot_kernel<__nv_bfloat16, unsigned><<<grid, kThreads, 0, st>>>(av, bv, p, unsigned(vec_per_tile));
    else
      dot_kernel<float, unsigned><<<grid, kThreads, 0, st>>>(av, bv, p, unsigned(vec_per_tile));
  } else if (bf16) {
    dot_kernel<__nv_bfloat16, long long><<<grid, kThreads, 0, st>>>(av, bv, p, vec_per_tile);
  } else {
    dot_kernel<float, long long><<<grid, kThreads, 0, st>>>(av, bv, p, vec_per_tile);
  }
  return int(cudaGetLastError());
}

}  // extern "C"
