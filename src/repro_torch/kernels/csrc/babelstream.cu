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
// double-buffer HBM->VMEM copies): every thread moves 16 bytes per load and
// store (4 fp32 or 8 bf16 elements), neighbouring threads on neighbouring
// 16-byte chunks, in a grid-stride loop over a grid of a few blocks per SM,
// so that enough loads are in flight to cover the memory latency.  dot runs
// one thread block per tile, which reduces its tile in registers, then by
// warp shuffles and shared memory, and writes its fp32 partial.
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
constexpr int kBlocksPerSM = 8;  // resident blocks of 256 threads that fill an SM

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

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads) stream_kernel(const uint4* __restrict__ x,
                                                          const uint4* __restrict__ y,
                                                          uint4* __restrict__ out, long long nvec,
                                                          float s) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += stride) {
    if constexpr (OP == kCopy) {
      out[i] = x[i];
    } else {
      const uint4 xv = x[i];
      const uint4 yv = (OP == kAdd || OP == kTriad) ? y[i] : xv;
      out[i] = apply<T, OP>(xv, yv, s);
    }
  }
}

// Sum of fp32(a) * fp32(b) over one tile of `block` elements per thread
// block; the tile's partial goes to partials[blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(kThreads) dot_kernel(const uint4* __restrict__ a,
                                                       const uint4* __restrict__ b,
                                                       float* __restrict__ partials,
                                                       long long vec_per_tile) {
  constexpr int N = 16 / sizeof(T);
  const long long base = (long long)blockIdx.x * vec_per_tile;
  float acc = 0.f;
  for (long long i = threadIdx.x; i < vec_per_tile; i += kThreads) {
    const uint4 av = a[base + i], bv = b[base + i];
    const T* x = reinterpret_cast<const T*>(&av);
    const T* y = reinterpret_cast<const T*>(&bv);
#pragma unroll
    for (int j = 0; j < N; ++j) acc = fmaf(to_f(x[j]), to_f(y[j]), acc);
  }
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

int grid_for(long long nvec) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const long long want = (nvec + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSM;
  return int(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename T>
int launch_stream(int op, const void* x, const void* y, void* out, long long n, float s,
                  cudaStream_t st) {
  const long long nvec = n * (long long)sizeof(T) / 16;
  const dim3 grid(grid_for(nvec));
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* yv = static_cast<const uint4*>(y);
  uint4* ov = static_cast<uint4*>(out);
  switch (op) {
    case kCopy: stream_kernel<T, kCopy><<<grid, kThreads, 0, st>>>(xv, yv, ov, nvec, s); break;
    case kMul: stream_kernel<T, kMul><<<grid, kThreads, 0, st>>>(xv, yv, ov, nvec, s); break;
    case kAdd: stream_kernel<T, kAdd><<<grid, kThreads, 0, st>>>(xv, yv, ov, nvec, s); break;
    case kTriad: stream_kernel<T, kTriad><<<grid, kThreads, 0, st>>>(xv, yv, ov, nvec, s); break;
    default: return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// op: 0 copy (x), 1 mul (x = c), 2 add (x = a, y = b), 3 triad (x = b,
// y = c).  n elements of fp32 (bf16 = 0) or bf16 (bf16 = 1); s is the
// scalar, already rounded to the dtype.  y may be null for copy and mul.
int stream_run(int op, int bf16, const void* x, const void* y, void* out, long long n, float s,
               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_stream<__nv_bfloat16>(op, x, y, out, n, s, st);
  return launch_stream<float>(op, x, y, out, n, s, st);
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
  if (bf16)
    dot_kernel<__nv_bfloat16><<<dim3(unsigned(tiles)), kThreads, 0, st>>>(av, bv, p, vec_per_tile);
  else
    dot_kernel<float><<<dim3(unsigned(tiles)), kThreads, 0, st>>>(av, bv, p, vec_per_tile);
  return int(cudaGetLastError());
}

}  // extern "C"
