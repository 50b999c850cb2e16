// Paged attention for Hopper (sm_90a): decode (K1) and chunked prefill (K2).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1  src/repro/kernels/paged_attention.py  paged_attention_bhd / _paged_kernel
//   K2  src/repro/kernels/paged_attention.py  paged_prefill_attention_bhd / _paged_prefill_kernel
//
// Both compute exact softmax attention of query rows against K/V that lives
// in a global block pool (N, bs, KV, hd), addressed through a per-sequence
// block table, with an online (running max / denominator / fp32
// accumulator) softmax over the blocks, GQA (qpk query heads per KV head),
// a causal position mask, an optional sliding window and an optional tanh
// softcap.  Row r of a tile has one query position q_pos; K/V position p is
// visible when p <= q_pos and, with a window, q_pos - p < window.  For K1
// q_pos = seq_len - 1 for every row; for K2 row r of the chunk's C*qpk rows
// is chunk offset r / qpk at q_pos = start + r / qpk.
//
// What bounds it on the card: the bytes of K/V read.  At decode every K/V
// element is used by qpk query rows only, about one multiply-add per byte,
// far below the ~20 fp32 operations per byte where the H100's CUDA cores
// (67 TFLOP/s) would take over from its memory (3.35 TB/s).  K2 reuses each
// block for a tile of up to 16 query rows, which moves it toward the
// operations bound.
//
// What the design does about it:
//  * one thread block per (sequence, kv head[, row tile]) loads its own
//    table row and length (this replaces the TPU's scalar prefetch) and
//    walks the logical blocks in a loop (this replaces the sequential grid
//    axis and its VMEM carry); the running max, denominator and accumulator
//    stay in shared memory for the whole walk;
//  * the walk covers only blocks that hold a visible position: it starts
//    at the block of the first position inside the window and stops at the
//    block of the last query position.  The Pallas kernel walks every table
//    entry, but the blocks it masks fully leave its result unchanged (a
//    fully masked block before the first visible one is wiped by the
//    exp(NEG_INF - m) rescale, one after the last adds exp(NEG_INF - m) = 0);
//  * each K/V block is read once per thread block, with 16-byte coalesced
//    loads, converted to fp32 in shared memory and shared by all qpk (K1)
//    or row-tile (K2) query rows;
//  * shared memory is read as float4 (K rows padded to a stride of hd + 4
//    floats so neighbouring rows fall in different banks); each thread keeps
//    four independent sums, in the scores and in the P V product, so its
//    multiply-adds do not wait on each other.
// Math is fp32 on the CUDA cores.  Tensor cores (wgmma), TMA and a split of
// long sequences over several thread blocks are later work.
//
// Entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() after the launch.  The caller guarantees: hd a multiple
// of 16 and <= 256, bs in {16, 32}, H a multiple of KV, contiguous tensors,
// int32 tables and lengths.  Table entries outside [0, N) read the null
// block 0, so a kernel never indexes outside the pool.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1.0e38f;  // the Pallas kernels' NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory tile of one thread block: `rows` query rows against one
// K/V block at a time.  Every section starts on a 16-byte boundary (hd is a
// multiple of 16), so rows are read as float4.
struct Tile {
  float* q;      // rows x hd, the query rows in fp32
  float* acc;    // rows x hd, running numerator
  float* k;      // bs x (hd + kKPad), the current K block
  float* v;      // bs x hd, the current V block
  float* s;      // rows x bs, scores, then probabilities
  float* m;      // rows, running max
  float* l;      // rows, running denominator
  float* alpha;  // rows, this block's rescale of the carry
  int* qpos;     // rows, each row's absolute query position
};

// K rows are padded by 4 floats: float4 reads of neighbouring rows then
// start 4 banks apart, so the 8 lanes of a quarter warp hit distinct banks.
constexpr int kKPad = 4;

__host__ __device__ inline size_t tile_bytes(int rows, int bs, int hd) {
  return sizeof(float) * (size_t(2) * rows * hd + size_t(bs) * (hd + kKPad) + size_t(bs) * hd +
                          size_t(rows) * bs + 3 * size_t(rows)) +
         sizeof(int) * size_t(rows);
}

__device__ inline Tile carve(float* smem, int rows, int bs, int hd) {
  Tile t;
  t.q = smem;
  t.acc = t.q + rows * hd;
  t.k = t.acc + rows * hd;
  t.v = t.k + bs * (hd + kKPad);
  t.s = t.v + bs * hd;
  t.m = t.s + rows * bs;
  t.l = t.m + rows;
  t.alpha = t.l + rows;
  t.qpos = reinterpret_cast<int*>(t.alpha + rows);
  return t;
}

__device__ __forceinline__ void store_f4(float* dst, const float* f) {
  *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
}

// Walk logical blocks [blo, bhi] of one sequence for one kv head, folding
// each into the online softmax of the tile's rows.  t.q, t.qpos, t.acc, t.m
// and t.l are set up by the caller and synchronised.
template <typename TKV>
__device__ void attend_blocks(const Tile& t, int rows, const TKV* __restrict__ kpool,
                              const TKV* __restrict__ vpool, const int* __restrict__ table_row,
                              int blo, int bhi, int N, int bs, int KV, int kv, int hd, float scale,
                              float softcap, int window) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  constexpr int n = Vec16<TKV>::n;
  const int chunks = hd / n;  // 16-byte chunks per K/V row
  const int hd4 = hd / 4;     // float4s per row
  const int ks = hd + kKPad;  // K row stride
  const int pairs = rows * bs;
  // threads that share one (row, position) dot product: a power of two,
  // aligned inside a warp, as many as keep every thread busy
  int G = 1;
  while (G < 32 && G < hd4 && 2 * G * pairs <= int(blockDim.x)) G <<= 1;
  const int ngroups = blockDim.x / G;
  const int gl = tid % G;

  for (int i = blo; i <= bhi; ++i) {
    int phys = table_row[i];
    if (phys < 0 || phys >= N) phys = 0;  // never index outside the pool
    // ---- K/V block -> shared memory (fp32), coalesced 16-byte loads
    for (int idx = tid; idx < bs * chunks; idx += blockDim.x) {
      const int tok = idx / chunks;
      const int c = idx - tok * chunks;
      const size_t off = ((size_t(phys) * bs + tok) * KV + kv) * size_t(hd) + size_t(c) * n;
      float f[n];
      Vec16<TKV>::load(kpool + off, f);
#pragma unroll
      for (int e = 0; e < n; e += 4) store_f4(t.k + tok * ks + c * n + e, f + e);
      Vec16<TKV>::load(vpool + off, f);
#pragma unroll
      for (int e = 0; e < n; e += 4) store_f4(t.v + tok * hd + c * n + e, f + e);
    }
    __syncthreads();

    // ---- scores: softcap, then the position / window mask.  Four
    // independent partial sums keep the multiply-adds from waiting on
    // each other.
    for (int base = 0; base < pairs; base += ngroups) {
      const int pair = base + tid / G;
      const bool valid = pair < pairs;
      const int r = valid ? pair / bs : 0;
      const int j = valid ? pair - r * bs : 0;
      float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) {
        const float4* qr = reinterpret_cast<const float4*>(t.q + r * hd);
        const float4* kr = reinterpret_cast<const float4*>(t.k + j * ks);
        for (int d4 = gl; d4 < hd4; d4 += G) {
          const float4 a = qr[d4], b = kr[d4];
          part.x = fmaf(a.x, b.x, part.x);
          part.y = fmaf(a.y, b.y, part.y);
          part.z = fmaf(a.z, b.z, part.z);
          part.w = fmaf(a.w, b.w, part.w);
        }
      }
      float dot = (part.x + part.y) + (part.z + part.w);
      for (int o = G >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (valid && gl == 0) {
        float s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        const int kv_pos = i * bs + j;
        const int q_pos = t.qpos[r];
        bool ok = kv_pos <= q_pos;
        if (window > 0) ok = ok && (q_pos - kv_pos) < window;
        t.s[r * bs + j] = ok ? s : kNegInf;
      }
    }
    __syncthreads();

    // ---- online softmax: one warp per row (bs <= 32: one lane per position)
    for (int r = warp; r < rows; r += nwarps) {
      const float sv = lane < bs ? t.s[r * bs + lane] : -CUDART_INF_F;
      const float m_prev = t.m[r];
      const float m_cur = fmaxf(m_prev, warp_max(sv));
      const float p = lane < bs ? expf(sv - m_cur) : 0.f;
      if (lane < bs) t.s[r * bs + lane] = p;
      const float psum = warp_sum(p);
      if (lane == 0) {
        const float a = expf(m_prev - m_cur);
        t.l[r] = a * t.l[r] + psum;
        t.m[r] = m_cur;
        t.alpha[r] = a;
      }
    }
    __syncthreads();

    // ---- accumulator: acc = acc * alpha + P V, four columns per thread
    for (int item = tid; item < rows * hd4; item += blockDim.x) {
      const int r = item / hd4;
      const int c4 = item - r * hd4;
      const float* pr = t.s + r * bs;
      const float4* vc = reinterpret_cast<const float4*>(t.v) + c4;  // row j at vc[j * hd4]
      float4* ac = reinterpret_cast<float4*>(t.acc + r * hd) + c4;
      const float a = t.alpha[r];
      float4 o = *ac;
      o.x *= a;
      o.y *= a;
      o.z *= a;
      o.w *= a;
      for (int j = 0; j < bs; ++j) {
        const float p = pr[j];
        const float4 v = vc[j * hd4];
        o.x = fmaf(p, v.x, o.x);
        o.y = fmaf(p, v.y, o.y);
        o.z = fmaf(p, v.z, o.z);
        o.w = fmaf(p, v.w, o.w);
      }
      *ac = o;
    }
    __syncthreads();
  }
}

// K1: grid (B, KV); one thread block holds the qpk query rows of one kv head.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
                        const TKV* __restrict__ vpool, const int* __restrict__ tables,
                        const int* __restrict__ seq_lens, TQ* __restrict__ out, int N, int bs,
                        int nb, int H, int KV, int hd, float scale, float softcap, int window) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const int qpk = H / KV;
  const int rows = qpk;
  const Tile t = carve(smem, rows, bs, hd);

  int len = seq_lens[b];
  len = len < 1 ? 1 : (len > nb * bs ? nb * bs : len);
  const TQ* qb = q + (size_t(b) * H + size_t(kv) * qpk) * hd;
  for (int idx = threadIdx.x; idx < rows * hd; idx += blockDim.x) {
    t.q[idx] = to_f(qb[idx]);
    t.acc[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    t.m[r] = kNegInf;
    t.l[r] = 0.f;
    t.qpos[r] = len - 1;
  }
  __syncthreads();

  const int blo = window > 0 ? (len - window > 0 ? len - window : 0) / bs : 0;
  const int bhi = (len - 1) / bs;
  attend_blocks<TKV>(t, rows, kpool, vpool, tables + size_t(b) * nb, blo, bhi, N, bs, KV, kv, hd,
                     scale, softcap, window);

  TQ* ob = out + (size_t(b) * H + size_t(kv) * qpk) * hd;
  for (int idx = threadIdx.x; idx < rows * hd; idx += blockDim.x) {
    ob[idx] = from_f<TQ>(t.acc[idx] / fmaxf(t.l[idx / hd], 1e-30f));
  }
}

// K2: grid (B, KV, row tiles); one thread block holds up to `row_tile` of
// the C*qpk query rows of one kv head; row r is chunk offset r / qpk.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
                         const TKV* __restrict__ vpool, const int* __restrict__ tables,
                         const int* __restrict__ starts, TQ* __restrict__ out, int N, int bs,
                         int nb, int C, int H, int KV, int hd, int row_tile, float scale,
                         float softcap, int window) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const int qpk = H / KV;
  const int row0 = blockIdx.z * row_tile;
  const int total = C * qpk;
  const int rows = total - row0 < row_tile ? total - row0 : row_tile;
  const Tile t = carve(smem, rows, bs, hd);

  int start = starts[b];
  start = start < 0 ? 0 : start;
  for (int idx = threadIdx.x; idx < rows * hd; idx += blockDim.x) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const int gr = row0 + r;
    const int c = gr / qpk;
    const int h = kv * qpk + (gr - c * qpk);
    t.q[idx] = to_f(q[((size_t(b) * C + c) * H + h) * hd + d]);
    t.acc[idx] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    t.m[r] = kNegInf;
    t.l[r] = 0.f;
    t.qpos[r] = start + (row0 + r) / qpk;
  }
  __syncthreads();

  const int first = start + row0 / qpk;
  const int last = start + (row0 + rows - 1) / qpk;
  const int blo = window > 0 ? (first - window + 1 > 0 ? first - window + 1 : 0) / bs : 0;
  const int bhi = last / bs < nb - 1 ? last / bs : nb - 1;
  attend_blocks<TKV>(t, rows, kpool, vpool, tables + size_t(b) * nb, blo, bhi, N, bs, KV, kv, hd,
                     scale, softcap, window);

  for (int idx = threadIdx.x; idx < rows * hd; idx += blockDim.x) {
    const int r = idx / hd;
    const int d = idx - r * hd;
    const int gr = row0 + r;
    const int c = gr / qpk;
    const int h = kv * qpk + (gr - c * qpk);
    out[((size_t(b) * C + c) * H + h) * hd + d] = from_f<TQ>(t.acc[idx] / fmaxf(t.l[r], 1e-30f));
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <typename TQ, typename TKV>
int launch_decode(const void* q, const void* k, const void* v, const int* tables,
                  const int* seq_lens, void* out, int B, int H, int KV, int hd, int N, int bs,
                  int nb, float softcap, int window, cudaStream_t stream) {
  const size_t smem = tile_bytes(H / KV, bs, hd);
  auto kernel = paged_decode_kernel<TQ, TKV>;
  if (int e = set_smem(kernel, smem)) return e;
  kernel<<<dim3(B, KV), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), tables,
      seq_lens, static_cast<TQ*>(out), N, bs, nb, H, KV, hd, 1.0f / sqrtf(float(hd)), softcap,
      window);
  return int(cudaGetLastError());
}

template <typename TQ, typename TKV>
int launch_prefill(const void* q, const void* k, const void* v, const int* tables,
                   const int* starts, void* out, int B, int C, int H, int KV, int hd, int N, int bs,
                   int nb, int row_tile, float softcap, int window, cudaStream_t stream) {
  const size_t smem = tile_bytes(row_tile, bs, hd);
  auto kernel = paged_prefill_kernel<TQ, TKV>;
  if (int e = set_smem(kernel, smem)) return e;
  const int tiles = (C * (H / KV) + row_tile - 1) / row_tile;
  kernel<<<dim3(B, KV, tiles), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), tables,
      starts, static_cast<TQ*>(out), N, bs, nb, C, H, KV, hd, row_tile, 1.0f / sqrtf(float(hd)),
      softcap, window);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one thread block of either kernel needs.
size_t paged_attention_smem_bytes(int rows, int bs, int hd) { return tile_bytes(rows, bs, hd); }

// K1.  q, out: (B, H, hd); pools: (N, bs, KV, hd); tables: (B, nb) int32;
// seq_lens: (B,) int32.  *_bf16 selects bf16 (1) or fp32 (0) storage.
int paged_decode_attention(const void* q, const void* k_pool, const void* v_pool,
                           const void* tables, const void* seq_lens, void* out, int B, int H,
                           int KV, int hd, int N, int bs, int nb, float softcap, int window,
                           int q_bf16, int kv_bf16, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch_decode<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, tb, sl, out, B, H, KV,
                                                       hd, N, bs, nb, softcap, window, st);
  if (q_bf16)
    return launch_decode<__nv_bfloat16, float>(q, k_pool, v_pool, tb, sl, out, B, H, KV, hd, N,
                                               bs, nb, softcap, window, st);
  if (kv_bf16)
    return launch_decode<float, __nv_bfloat16>(q, k_pool, v_pool, tb, sl, out, B, H, KV, hd, N,
                                               bs, nb, softcap, window, st);
  return launch_decode<float, float>(q, k_pool, v_pool, tb, sl, out, B, H, KV, hd, N, bs, nb,
                                     softcap, window, st);
}

// K2.  q, out: (B, C, H, hd); pools: (N, bs, KV, hd); tables: (B, nb)
// int32; starts: (B,) int32 absolute position of each chunk's first token.
int paged_prefill_attention(const void* q, const void* k_pool, const void* v_pool,
                            const void* tables, const void* starts, void* out, int B, int C,
                            int H, int KV, int hd, int N, int bs, int nb, int row_tile,
                            float softcap, int window, int q_bf16, int kv_bf16, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* st0 = static_cast<const int*>(starts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return launch_prefill<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, tb, st0, out, B, C, H,
                                                        KV, hd, N, bs, nb, row_tile, softcap,
                                                        window, st);
  if (q_bf16)
    return launch_prefill<__nv_bfloat16, float>(q, k_pool, v_pool, tb, st0, out, B, C, H, KV, hd,
                                                N, bs, nb, row_tile, softcap, window, st);
  if (kv_bf16)
    return launch_prefill<float, __nv_bfloat16>(q, k_pool, v_pool, tb, st0, out, B, C, H, KV, hd,
                                                N, bs, nb, row_tile, softcap, window, st);
  return launch_prefill<float, float>(q, k_pool, v_pool, tb, st0, out, B, C, H, KV, hd, N, bs, nb,
                                      row_tile, softcap, window, st);
}

}  // extern "C"
