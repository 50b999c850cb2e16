// Flash attention forward for Hopper (sm_90a): K3.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   K3  src/repro/kernels/flash_attention.py  flash_attention_bhsd / _flash_kernel
//
// What it computes, as the TPU kernel does: FlashAttention-2's forward
// (arXiv:2307.08691).  Query row r of head h attends over key/value rows c
// of kv head h / qpk (GQA) with scores s = (q . k) * scale, an optional
// tanh softcap (s = cap * tanh(s / cap)), and a mask: c < Skv, with causal
// c <= r, with a window r - c < window; masked scores are -1e38.  The
// softmax is online, in fp32: a running max m, denominator l and fp32
// accumulator per row.  P stays fp32 for P.V: the TPU kernel upcasts its v
// tile to fp32 before `p.astype(v.dtype)`, so that cast rounds nothing.
// The output is acc / max(l, 1e-30) in q's dtype.  bf16 and fp32 share one
// template.
//
// What bounds it on the card: the operations.  At the training path's
// shape, (B, H, S, hd) = (4, 16, 2048, 128) bf16 causal, about 4 hd
// operations per visible (query, key) pair against 4 B S H hd bytes of
// q, k, v and output: hundreds of operations per byte.  bf16 products are
// exact in fp32, so a tensor-core kernel could run them at the bf16 dense
// rate (989 TFLOP/s), the bound stated for bf16 inputs (67 TFLOP/s, the
// CUDA cores' fp32 rate, for fp32 inputs).  This first version runs them on
// the CUDA cores in fp32; wgmma, TMA and a producer/consumer pipeline are
// later work.
//
// Design (not carried over from the Pallas grid, whose kv axis revisits an
// output block in VMEM):
//  * one thread block of 256 threads per (64-row q tile, q head, batch)
//    walks the KV tiles of 64 rows in a loop; m and l live in registers,
//    each thread owning four rows (ty + 16 i) of the tile and the same rows
//    of the accumulator, so the rescale needs no exchange;
//  * the walk covers only KV tiles that hold a visible key for some row of
//    the q tile: from the first key inside the window of the tile's first
//    row to the tile's last row (causal) or the end.  A tile the mask hides
//    entirely leaves the Pallas kernel's result unchanged (before the first
//    visible key it is wiped by the exp(-1e38 - m) rescale, after the last
//    one it adds exp(-1e38 - m) = 0), so skipping it gives the same output.
//    The exception is a row that sees no key at all (possible only when
//    Sq > Skv with a window): the Pallas kernel averages V over it, this
//    kernel averages over the tiles it walks;
//  * q tiles are scheduled longest first (the last tile of a causal row
//    has the most KV tiles);
//  * Q, K and V tiles are read with coalesced 16-byte loads and kept in
//    shared memory in fp32, rows padded by 4 floats so that the float4
//    reads of eight neighbouring rows hit distinct banks.  Each thread
//    computes a 4 x 4 block of the scores (rows ty + 16 i, keys tx + 16 j)
//    with 8 float4 reads per 64 multiply-adds; row maxima and sums reduce
//    over the 16 lanes of a half warp by shuffles;
//  * every tensor is taken with its batch, head and sequence strides, so
//    the model's (B, S, H, hd) layout needs no transposed copy.
//
// Entry point: a plain C interface (loaded with ctypes) that returns
// cudaGetLastError() after the launch.  The caller guarantees hd a multiple
// of 16 in [16, 256], H a multiple of KV, unit stride along hd, and rows of
// q, k and v that start on 16-byte boundaries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // query rows per thread block
constexpr int kBKV = 64;  // key / value rows per step
constexpr int kThreads = 256;
constexpr int kPad = 4;             // floats of padding per shared row
constexpr int kLdP = kBKV + kPad;   // row stride of the P tile
constexpr float kNegInf = -1.0e38f;  // the Pallas kernel's NEG_INF

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// 16 bytes of T, unpacked to floats.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* src, float* out) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    out[0] = u.x;
    out[1] = u.y;
    out[2] = u.z;
    out[3] = u.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Rows [row0, row0 + 64) of a (S, hd) matrix with row stride s_row into the
// shared tile dst (64 x ld floats); rows at or past S are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src, long long s_row,
                                          int row0, int S, int hd) {
  constexpr int n = Vec16<T>::n;
  const int per_row = hd / n;
  for (int idx = threadIdx.x; idx < 64 * per_row; idx += kThreads) {
    const int r = idx / per_row;
    const int c = (idx - r * per_row) * n;
    float f[n];
    if (row0 + r < S) {
      Vec16<T>::load(src + (row0 + r) * s_row + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < n; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < n; e += 4)
      *reinterpret_cast<float4*>(dst + r * ld + c + e) = make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__host__ __device__ inline size_t smem_bytes(int hd) {
  return sizeof(float) * (size_t(kBQ + 2 * kBKV) * (hd + kPad) + size_t(kBQ) * kLdP);
}

struct Strides {
  long long b, h, s;
};

// JJ: column groups of 4 per thread in the output, hd <= 64 * JJ.
template <typename T, int JJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ o, int H, int KV, int Sq, int Skv, int hd, Strides sq,
                     Strides sk, Strides sv, Strides so, float scale, int causal, int window,
                     float softcap) {
  extern __shared__ __align__(16) float smem[];
  const int ld = hd + kPad;
  float* Qs = smem;
  float* Ks = Qs + kBQ * ld;
  float* Vs = Ks + kBKV * ld;
  float* Ps = Vs + kBKV * ld;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int ng = hd / 4;  // column groups of 4

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  load_tile<T>(Qs, ld, qb, sq.s, q0, Sq, hd);

  float m[4], l[4], acc[4][4 * JJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * JJ; ++c) acc[i][c] = 0.f;
  }

  const int hi = causal ? min(Skv, q0 + kBQ) : Skv;  // one past the last visible key
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int t0 = (lo / kBKV) * kBKV; t0 < hi; t0 += kBKV) {
    __syncthreads();  // the previous step is done with Ks, Vs and Ps
    load_tile<T>(Ks, ld, kb, sk.s, t0, Skv, hd);
    load_tile<T>(Vs, ld, vb, sv.s, t0, Skv, hd);
    __syncthreads();

    // ---- scores: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qa[i].x, ka[j].x, a);
          a = fmaf(qa[i].y, ka[j].y, a);
          a = fmaf(qa[i].z, ka[j].z, a);
          a = fmaf(qa[i].w, ka[j].w, a);
          s[i][j] = a;
        }
    }

    // ---- softcap, mask, online softmax; P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = t0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = c < Skv;
        if (causal) ok = ok && r >= c;
        if (window > 0) ok = ok && (r - c) < window;
        s[i][j] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * JJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // ---- acc += P V: rows ty + 16 i, column groups tx + 16 jj
    for (int kk = 0; kk < kBKV; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p4[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kLdP + kk);
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
        const int g = tx + 16 * jj;
        if (g < ng) {
          const float* vr = Vs + kk * ld + 4 * g;
          const float4 vv[4] = {*reinterpret_cast<const float4*>(vr),
                                *reinterpret_cast<const float4*>(vr + ld),
                                *reinterpret_cast<const float4*>(vr + 2 * ld),
                                *reinterpret_cast<const float4*>(vr + 3 * ld)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pp[4] = {p4[i].x, p4[i].y, p4[i].z, p4[i].w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              acc[i][4 * jj] = fmaf(pp[u], vv[u].x, acc[i][4 * jj]);
              acc[i][4 * jj + 1] = fmaf(pp[u], vv[u].y, acc[i][4 * jj + 1]);
              acc[i][4 * jj + 2] = fmaf(pp[u], vv[u].z, acc[i][4 * jj + 2]);
              acc[i][4 * jj + 3] = fmaf(pp[u], vv[u].w, acc[i][4 * jj + 3]);
            }
          }
        }
      }
    }
  }

  // ---- output rows ty + 16 i
  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < JJ; ++jj) {
      const int g = tx + 16 * jj;
      if (g < ng) {
#pragma unroll
        for (int e = 0; e < 4; ++e) ob[r * so.s + 4 * g + e] = from_f<T>(acc[i][4 * jj + e] / denom);
      }
    }
  }
}

template <typename T, int JJ>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int Sq,
           int Skv, int hd, Strides sq, Strides sk, Strides sv, Strides so, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(hd);
  auto kernel = flash_fwd_kernel<T, JJ>;
  if (smem > 48 * 1024) {
    if (int e = int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))))
      return e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq,
                                           Skv, hd, sq, sk, sv, so, scale, causal, window, softcap);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int Sq,
             int Skv, int hd, Strides sq, Strides sk, Strides sv, Strides so, float scale,
             int causal, int window, float softcap, cudaStream_t st) {
  if (hd <= 64)
    return launch<T, 1>(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal, window, softcap, st);
  if (hd <= 128)
    return launch<T, 2>(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal, window, softcap, st);
  return launch<T, 4>(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal, window, softcap, st);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one thread block needs at head_dim hd.
size_t flash_attention_smem_bytes(int hd) { return smem_bytes(hd); }

// q, o: (B, H, Sq, hd); k, v: (B, KV, Skv, hd); each with (batch, head,
// sequence) strides in elements and unit stride along hd.  bf16 selects
// bf16 (1) or fp32 (0) for all four.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                        int Sq, int Skv, int hd, int bf16, long long qb, long long qh, long long qs,
                        long long kb, long long kh, long long ks, long long vb, long long vh,
                        long long vs, long long ob, long long oh, long long os, float scale,
                        int causal, int window, float softcap, void* stream) {
  const Strides sq{qb, qh, qs}, sk{kb, kh, ks}, sv{vb, vh, vs}, so{ob, oh, os};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal,
                                   window, softcap, st);
  return dispatch<float>(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal, window,
                         softcap, st);
}

}  // extern "C"
