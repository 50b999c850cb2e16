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
// The walk covers only blocks that hold a visible position: it starts at
// the block of the first position inside the window and stops at the block
// of the last query position.  The Pallas kernel walks every table entry,
// but the blocks it masks fully leave its result unchanged (a fully masked
// block before the first visible one is wiped by the exp(NEG_INF - m)
// rescale, one after the last adds exp(NEG_INF - m) = 0).  Table entries
// outside [0, N) read the null block 0, so a kernel never indexes outside
// the pool.
//
// Three kernel families:
//  * v1 (``paged_decode_cuda_cores_kernel``, ``paged_prefill_kernel``): one
//    block per (sequence, kv head[, row tile]) walking its blocks in order,
//    the CUDA cores in fp32, any pool dtype.  K2 on fp32 pools; K1 and K2 on
//    bf16 pools only as the yardsticks of the kernels below;
//  * split (``split::paged_decode_kernel_split``): K1, every pool dtype, each
//    (sequence, kv head)'s walk split over a thread-block cluster of up to
//    8 blocks and 4 warps in each, with every load of a share in flight
//    together, combined through distributed shared memory;
//  * tc (``tc::paged_prefill_tc_kernel``): K2 on bf16 pools, the serving
//    path, on the tensor cores (TMA through the block table, wgmma).
//
// Entry points have a plain C interface (loaded with ctypes) and return
// cudaGetLastError() after the launch (or -1 if a TMA tensor map was
// refused).  The caller guarantees: hd a multiple of 16 and <= 256, bs in
// {16, 32}, H a multiple of KV, contiguous tensors on 16-byte boundaries,
// int32 tables and lengths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_tc.cuh"
#include "hopper.cuh"

namespace {

// ===========================================================================
// v1: the CUDA cores, fp32 arithmetic
// ===========================================================================
//
// What bounds it on the card: the bytes of K/V read.  At decode every K/V
// element is used by qpk query rows only, about one multiply-add per byte,
// far below the ~20 fp32 operations per byte where the H100's CUDA cores
// (67 TFLOP/s) would take over from its memory (3.35 TB/s).  K2 reuses each
// block for a tile of up to 16 query rows, which moves it toward the
// operations bound.  v1 runs K1 only as the yardstick of the split kernel:
// its grid of (sequence, kv head) blocks, 64 at olmo-1b's 4 slots, each
// loading one K/V block at a time and crossing four block barriers a
// block, is bound by latency, not bytes.
//
// Design:
//  * one thread block per (sequence, kv head[, row tile]) loads its own
//    table row and length (this replaces the TPU's scalar prefetch) and
//    walks the logical blocks in a loop (this replaces the sequential grid
//    axis and its VMEM carry); the running max, denominator and accumulator
//    stay in shared memory for the whole walk;
//  * each K/V block is read once per thread block, with 16-byte coalesced
//    loads, converted to fp32 in shared memory and shared by all qpk (K1)
//    or row-tile (K2) query rows;
//  * shared memory is read as float4 (K rows padded to a stride of hd + 4
//    floats so neighbouring rows fall in different banks); each thread keeps
//    four independent sums, in the scores and in the P V product, so its
//    multiply-adds do not wait on each other.

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

// K1's yardstick: grid (B, KV); one thread block holds the qpk query rows
// of one kv head.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
    paged_decode_cuda_cores_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kpool,
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
  auto kernel = paged_decode_cuda_cores_kernel<TQ, TKV>;
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

// ===========================================================================
// tc: K2 on bf16 pools, on the tensor cores
// ===========================================================================
//
// What bounds it on the card: the operations.  At olmo-1b's serving chunk
// (128 queries after 192 tokens, 16 heads of 128) every K/V position is
// used by up to 128 query rows, hundreds of operations per byte read, and
// the route does its products at the bf16 tensor-core rate (989 TFLOP/s)
// where v1 ran at the CUDA cores' 67.
//
// Numerics.  The pools are bf16, so K and V are exact wgmma operands.
// Serving queries are fp32 (fp32 weights), and the Pallas kernel computes
// q . k in fp32: q is split on the card into q_hi = bf16(q) and
// q_lo = bf16(q - q_hi), good to about 2^-17 together, and S is the sum of
// two SS wgmmas per k16 step against the same K tile (one for bf16
// queries, which are exact).  One bf16 term alone would miss the fp32
// result by about 1e-3 of the output.  The softmax, P_hi + P_lo and the
// per-tile fp32 sum of P V are K3's (attention_tc.cuh).
//
// Design:
//  * a block of 160 threads: warps 0-3 are one consumer warpgroup that owns
//    64 of the C * qpk query rows of one (sequence, kv head); warp 4 is the
//    producer.  Rows past C * qpk are zero queries: computed, never stored;
//  * the consumers load their Q rows once (16-byte loads), split them into
//    bf16 terms and store each term as a K-major tile with the 128-byte
//    swizzle, hd padded with zeros to HDP, a multiple of 64;
//  * the producer's one thread reads the block table and loads each 64-key
//    tile of K and V by TMA, one box of (64 columns, bs positions) of one
//    kv head per physical block (a rank-4 map over the pool's (hd, KV, bs,
//    N)), 64 / bs boxes per tile, into a ring of 2-4 stages with full and
//    empty mbarriers, so the next tiles load while this one is computed.
//    Tiles start at the walk's first block; positions past its last block
//    read block 0 and are masked;
//  * each tile: S by SS wgmma, the masks and the softmax in registers,
//    then P V; K3's overlap of one tile's P V with the next one's softmax
//    was slower here (a serving walk is a few tiles);
//  * the causal and window masks are applied in registers on every tile;
//  * where a tile's work is heavy (hd > 128 or a softcap), a row tile's
//    tiles are split over a thread-block cluster of ``split`` blocks (1 to
//    4; the host picks it, ``pick_split``):
//    each block walks a contiguous share, and block 0 of the cluster
//    combines the others' (m, l, O) from their shared memory (distributed
//    shared memory) before it writes the output.  One launch per call.

namespace tc {

constexpr int kThreads = 160;  // one consumer warpgroup and a producer warp
constexpr int kRows = 64;      // query rows per block
constexpr int kMaxSplit = 4;   // blocks of a cluster that share a row tile

template <typename TQ, int HDP>
struct Tiles {
  static constexpr int NC = HDP / 64;                 // 64-column chunks of a row
  static constexpr int BKV = attn_tc::kBKV;           // keys per tile
  static constexpr int kTerms = sizeof(TQ) == 4 ? 2 : 1;  // bf16 terms of q
  static constexpr int PVC = NC <= 2 ? NC : 1;        // O chunks per P V product
  static constexpr int kQBytes = NC * kRows * 128;    // one term of Q
  static constexpr int kKVBytes = NC * BKV * 128;     // K or V of one stage
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kFit = (232448 - 2048 - kTerms * kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  // what a block hands the cluster's first block: O, m and l of each thread
  static constexpr int kXBytes = (32 * NC + 4) * 128 * 4;
  // 1024 bytes of alignment slack, Q, the ring, 3 kStages mbarriers
  static constexpr int kSmem = 1024 + kTerms * kQBytes + kStages * kStageBytes + 8 * 3 * kStages;
  static_assert(kStages >= 2 && kSmem <= 232448, "a block's shared memory on the H100");
  static_assert(kXBytes <= kStages * kStageBytes, "the exchange reuses the ring");
};

// 8 values of q from global memory, as floats.
__device__ __forceinline__ void load8(const float* src, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  const float4 b = *reinterpret_cast<const float4*>(src + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float (&x)[8]) { Vec16<__nv_bfloat16>::load(src, x); }

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <typename TQ, int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    paged_prefill_tc_kernel(const TQ* __restrict__ q, const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v, const int* __restrict__ tables,
                            const int* __restrict__ starts, TQ* __restrict__ out, int N, int bs, int nb, int C,
                            int H, int KV, int hd, float scale, float softcap, int window) {
  using namespace hopper;
  using L = Tiles<TQ, HDP>;
  constexpr int NC = L::NC;
  constexpr int BKV = L::BKV;
  constexpr int kStages = L::kStages;
  constexpr int PVC = L::PVC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024-byte alignment
  const uint32_t ring = base + L::kTerms * L::kQBytes;
  auto q_s = [&](int term) { return base + term * L::kQBytes; };
  auto k_s = [&](int s) { return ring + s * L::kStageBytes; };
  auto v_s = [&](int s) { return ring + s * L::kStageBytes + L::kKVBytes; };
  const uint32_t bars = ring + kStages * L::kStageBytes;
  auto k_full = [&](int s) { return bars + 8u * s; };
  auto v_full = [&](int s) { return bars + 8u * (kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (2 * kStages + s); };

  // the cluster of gridDim.x blocks along x shares the row tile
  const int split = gridDim.x;
  const int rank = blockIdx.x;
  const int row0 = blockIdx.y * kRows;
  const int b = blockIdx.z / KV;
  const int kv = blockIdx.z - b * KV;
  const int qpk = H / KV;
  const int total = C * qpk;
  const int start = max(starts[b], 0);
  // the logical blocks [blo, bhi] that hold a position some real row sees,
  // in tiles of 64 / bs blocks; this block walks tiles [t_lo, t_lo + n_tiles)
  const int first = start + row0 / qpk;
  const int last = start + (min(row0 + kRows, total) - 1) / qpk;
  const int blo = window > 0 ? max(first - window + 1, 0) / bs : 0;
  const int bhi = min(last / bs, nb - 1);
  const int per_tile = BKV / bs;
  const int n_all = bhi >= blo ? (bhi - blo + per_tile) / per_tile : 0;
  const int t_lo = n_all * rank / split;
  const int n_tiles = n_all * (rank + 1) / split - t_lo;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer: one thread reads the table and issues the loads
    if (threadIdx.x == 128) {
      const int* trow = tables + size_t(b) * nb;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        mbar_arrive_expect_tx(k_full(s), L::kKVBytes);
        mbar_arrive_expect_tx(v_full(s), L::kKVBytes);
        const int lb0 = blo + (t_lo + it) * per_tile;
        for (int j = 0; j < per_tile; ++j) {
          int phys = lb0 + j <= bhi ? trow[lb0 + j] : 0;  // past the walk: block 0, masked
          if (phys < 0 || phys >= N) phys = 0;             // never index outside the pool
          for (int c = 0; c < NC; ++c) {
            tma_load_4d(k_s(s) + c * (BKV * 128) + j * (bs * 128), &map_k, k_full(s), 64 * c, kv, 0, phys);
            tma_load_4d(v_s(s) + c * (BKV * 128) + j * (bs * 128), &map_v, v_full(s), 64 * c, kv, 0, phys);
          }
        }
      }
    }
    __syncwarp();
    if (split > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- consumers
  const int tw = threadIdx.x;
  // Q rows row0 .. row0 + 63 as bf16 terms, K-major with the 128-byte
  // swizzle: the 16-byte unit u of row r of a 64-column chunk lies at unit
  // u ^ (r & 7) of the row's 128 bytes
  constexpr int kUnits = HDP / 8;
  constexpr int kPer = kRows * kUnits / 128;    // units per thread
  constexpr int kBatch = kPer % 8 == 0 ? 8 : 4;  // loads in flight before the stores (divides kPer)
  static_assert(kPer % kBatch == 0, "Q loads in whole batches");
#pragma unroll
  for (int u0 = 0; u0 < kPer; u0 += kBatch) {
    float x[kBatch][8];
#pragma unroll
    for (int v = 0; v < kBatch; ++v) {
      const int u = tw + 128 * (u0 + v);
      const int r = u / kUnits;
      const int col = 8 * (u - r * kUnits);
      const int gr = row0 + r;
#pragma unroll
      for (int e = 0; e < 8; ++e) x[v][e] = 0.f;
      if (gr < total && col < hd) {
        const int c = gr / qpk;
        const int h = kv * qpk + (gr - c * qpk);
        load8(q + ((size_t(b) * C + c) * H + h) * hd + col, x[v]);
      }
    }
#pragma unroll
    for (int v = 0; v < kBatch; ++v) {
      const int u = tw + 128 * (u0 + v);
      const int r = u / kUnits;
      const int cu = u - r * kUnits;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) attn_tc::split_bf16x2(x[v][2 * e], x[v][2 * e + 1], hi[e], lo[e]);
      const uint32_t off = (cu >> 3) * (kRows * 128) + r * 128 + (((cu & 7) ^ (r & 7)) << 4);
      st_shared_v4(q_s(0) + off, hi[0], hi[1], hi[2], hi[3]);
      if constexpr (L::kTerms == 2) st_shared_v4(q_s(1) + off, lo[0], lo[1], lo[2], lo[3]);
    }
  }
  fence_proxy_async();  // the tiles are wgmma operands
  named_barrier(1, 128);

  const int row_a = row0 + acc_row(tw, 0);  // this thread's two rows
  const int row_b = row_a + 8;
  const int qpos_a = start + row_a / qpk;
  const int qpos_b = start + row_b / qpk;
  // the last key each row may see: its own position, or the table's last
  // where the chunk runs past the table (bhi is then nb - 1, and the last
  // tile's positions beyond it read block 0)
  const int kp_last = (bhi + 1) * bs - 1;
  const int qlim_a = min(qpos_a, kp_last);
  const int qlim_b = min(qpos_b, kp_last);

  float o_acc[NC][32];  // O, summed in fp32 registers (round to nearest)
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[c][i] = 0.f;
  float pv[PVC][32];  // P V of one tile (PVC chunks), from the tensor cores
  float m[2] = {attn_tc::kNegInf, attn_tc::kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};                            // this thread's part of the row sums
  float sc[BKV / 2];                                  // S of one tile, then its P
#pragma unroll
  for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
  uint32_t p_hi[BKV / 4], p_lo[BKV / 4];  // P = P_hi + P_lo, the A fragments of P V
  float alpha[2];

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t parity = (it / kStages) & 1;
    // S = (Q_hi + Q_lo) K^T
    fence_regs(sc);
    mbar_wait(k_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < HDP / 16; ++j) {  // hd's zero padding adds nothing
      const uint32_t koff = (j >> 2) * (BKV * 128) + (j & 3) * 32;
      const uint32_t qoff = (j >> 2) * (kRows * 128) + (j & 3) * 32;
      wgmma_m64n64k16_bf16_ss(sc, smem_desc(q_s(0) + qoff), smem_desc(k_s(s) + koff), j > 0);
      if constexpr (L::kTerms == 2) wgmma_m64n64k16_bf16_ss(sc, smem_desc(q_s(1) + qoff), smem_desc(k_s(s) + koff), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    // softcap and the causal / window mask, then the online softmax
    const int kp0 = (blo + (t_lo + it) * per_tile) * bs;
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) {
      const int kp = kp0 + acc_col(tw, i);
      const int qp = (i & 2) ? qpos_b : qpos_a;
      const bool ok = kp <= ((i & 2) ? qlim_b : qlim_a) && (window == 0 || qp - kp < window);
      sc[i] = ok ? attn_tc::log2_score(sc[i], scale, softcap) : attn_tc::kNegInf;
    }
    attn_tc::online_softmax(sc, m, l, alpha);
    attn_tc::rescale_split<NC>(o_acc, sc, alpha, p_hi, p_lo);
    // P V of the tile, summed from zero and added to O in fp32
    mbar_wait(v_full(s), parity);
#pragma unroll
    for (int c0 = 0; c0 < NC; c0 += PVC) {
      attn_tc::issue_pv<PVC>(pv, p_hi, p_lo, v_s(s) + c0 * (BKV * 128));
      wgmma_wait<0>();
      attn_tc::add_pv<PVC, NC>(o_acc, pv, p_hi, p_lo, c0);
    }
    __syncwarp();  // the stage's K and V go back to the producer
    if ((tw & 31) == 0) mbar_arrive(empty(s));
  }

  if (split > 1) {
    // (m, l, O) of every block but the first go to its ring (every tile has
    // landed and been read), thread-major so the first block's thread tw
    // reads its own values: value v of thread tw at float v * 128 + tw
    float* xs = reinterpret_cast<float*>(smem_raw + (ring - raw));
    if (rank != 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) xs[(32 * c + i) * 128 + tw] = o_acc[c][i];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        xs[(32 * NC + e) * 128 + tw] = m[e];
        xs[(32 * NC + 2 + e) * 128 + tw] = l[e];
      }
    }
    __syncwarp();
    cluster_sync();
    if (rank == 0) {  // O = sum over blocks of exp2(m_j - M) O_j, and l alike
      float mx[2] = {m[0], m[1]};
      for (int j = 1; j < split; ++j) {
        const uint32_t peer = cluster_map(ring, j);
#pragma unroll
        for (int e = 0; e < 2; ++e) mx[e] = fmaxf(mx[e], ld_cluster_f32(peer + 4u * ((32 * NC + e) * 128 + tw)));
      }
      float w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        w[e] = exp2f(m[e] - mx[e]);
        l[e] *= w[e];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o_acc[c][i] *= w[(i >> 1) & 1];
      for (int j = 1; j < split; ++j) {
        const uint32_t peer = cluster_map(ring, j);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          w[e] = exp2f(ld_cluster_f32(peer + 4u * ((32 * NC + e) * 128 + tw)) - mx[e]);
          l[e] += w[e] * ld_cluster_f32(peer + 4u * ((32 * NC + 2 + e) * 128 + tw));
        }
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int i = 0; i < 32; ++i)
            o_acc[c][i] += w[(i >> 1) & 1] * ld_cluster_f32(peer + 4u * ((32 * c + i) * 128 + tw));
      }
    }
  }

  if (rank == 0) {  // ---- O / max(l, 1e-30) in q's dtype, real rows and columns < hd
    float denom[2];
    attn_tc::row_denominators(l, denom);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gr = e ? row_b : row_a;
      if (gr >= total) continue;
      const int c = gr / qpk;
      const int h = kv * qpk + (gr - c * qpk);
      TQ* orow = out + ((size_t(b) * C + c) * H + h) * hd;
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
#pragma unroll
        for (int i = 2 * e; i < 32; i += 4) {  // registers i, i + 1 of row e
          const int col = 64 * cc + acc_col(tw, i);
          if (col < hd) store2(orow + col, o_acc[cc][i] / denom[e], o_acc[cc][i + 1] / denom[e]);
        }
    }
  }
  __syncwarp();
  if (split > 1) cluster_sync();  // the others' shared memory stays until it has been read
}

// Tensor map of a bf16 pool (N, bs, KV, hd), dims (hd, KV, bs, N), read in
// boxes of (64 columns, 1 kv head, bs positions, 1 block): bs rows of 128
// bytes in shared memory.
inline bool encode_pool(CUtensorMap* map, const void* pool, int N, int bs, int KV, int hd) {
  const uint64_t row = uint64_t(hd) * 2;  // bytes of one (position, kv head)
  const uint64_t dims[4] = {uint64_t(hd), uint64_t(KV), uint64_t(bs), uint64_t(N)};
  const uint64_t strides[3] = {row, row * KV, row * KV * bs};
  const uint32_t box[3] = {1, uint32_t(bs), 1};
  return hopper::encode_rank4_sw128(map, pool, dims, strides, box, 2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// Blocks per row tile (the cluster size).  On the H100 a block's time is a
// fixed part (launch, Q, the first loads) plus about 0.9 us a 64-key tile
// at hd <= 128, 1.3 us at hd 256 and 4 us with a softcap (its tanhf), and a
// cluster adds about 3 us to combine (PERF.md): the split pays only where
// a tile is that heavy (hd > 128 or a softcap) and each block still walks
// two tiles or more of the longest walk the table and the window allow.
// The split is then the largest of 4, 3 and 2 that keeps that, whose grid
// fills at most 3/4 of the SMs, and whose clusters the occupancy API
// (asked once per kernel, which fixes its shared memory, and size) holds
// at once: 4-block clusters over 128 of 132 SMs ran slower though the API
// admitted them.  Else 1.
template <typename TQ, int HDP>
int pick_split(int B, int C, int H, int KV, int nb, int bs, int window, float softcap) {
  static int sms = 0;
  static int max_clusters[kMaxSplit + 1] = {};
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  if (!(HDP > 128 || softcap > 0.f)) return 1;
  const int qpk = H / KV;
  const int row_blocks = (C * qpk + kRows - 1) / kRows * B * KV;
  const int positions = min(C, (kRows + qpk - 1) / qpk);  // query positions of one block's rows
  constexpr int T = attn_tc::kBKV;
  int max_tiles = (nb * bs + T - 1) / T;
  if (window > 0) {  // the window, the block's positions, and a block of slack at each end
    const int span = window - 1 + positions + 2 * bs;
    max_tiles = min(max_tiles, (span + T - 1) / T);
  }
  auto kernel = paged_prefill_tc_kernel<TQ, HDP>;
  constexpr int smem = Tiles<TQ, HDP>::kSmem;
  for (int split = kMaxSplit; split >= 2; --split) {
    if (2 * split > max_tiles || 4 * row_blocks * split > 3 * sms) continue;
    if (max_clusters[split] == 0) {
      // the query reads the kernel's shared-memory limit: set it first
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(split);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = smem;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = split;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int n = 0;
      if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n <= 0) {
        cudaGetLastError();  // a refused query is not the launch's error
        n = -1;
      }
      max_clusters[split] = n;
    }
    if (row_blocks <= max_clusters[split]) return split;
  }
  return 1;
}

template <typename TQ, int HDP>
int launch(const void* q, const void* k, const void* v, const int* tables, const int* starts, void* out, int B,
           int C, int H, int KV, int hd, int N, int bs, int nb, float softcap, int window, int split,
           cudaStream_t stream) {
  using L = Tiles<TQ, HDP>;
  CUtensorMap mk, mv;
  if (!encode_pool(&mk, k, N, bs, KV, hd) || !encode_pool(&mv, v, N, bs, KV, hd)) return -1;
  auto kernel = paged_prefill_tc_kernel<TQ, HDP>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return int(e);
  if (split <= 0) split = pick_split<TQ, HDP>(B, C, H, KV, nb, bs, window, softcap);
  const int row_tiles = (C * (H / KV) + kRows - 1) / kRows;
  if (split > kMaxSplit) return int(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, row_tiles, B * KV);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TQ*>(q), mk, mv, tables, starts, static_cast<TQ*>(out), N,
                         bs, nb, C, H, KV, hd, 1.0f / sqrtf(float(hd)), softcap, window);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

template <typename TQ>
int split_for(int B, int C, int H, int KV, int hd, int nb, int bs, int window, float softcap) {
  if (hd <= 64) return pick_split<TQ, 64>(B, C, H, KV, nb, bs, window, softcap);
  if (hd <= 128) return pick_split<TQ, 128>(B, C, H, KV, nb, bs, window, softcap);
  if (hd <= 192) return pick_split<TQ, 192>(B, C, H, KV, nb, bs, window, softcap);
  return pick_split<TQ, 256>(B, C, H, KV, nb, bs, window, softcap);
}

template <typename TQ>
int dispatch(const void* q, const void* k, const void* v, const int* tables, const int* starts, void* out, int B,
             int C, int H, int KV, int hd, int N, int bs, int nb, float softcap, int window, int split,
             cudaStream_t st) {
  if (hd <= 64) return launch<TQ, 64>(q, k, v, tables, starts, out, B, C, H, KV, hd, N, bs, nb, softcap, window, split, st);
  if (hd <= 128) return launch<TQ, 128>(q, k, v, tables, starts, out, B, C, H, KV, hd, N, bs, nb, softcap, window, split, st);
  if (hd <= 192) return launch<TQ, 192>(q, k, v, tables, starts, out, B, C, H, KV, hd, N, bs, nb, softcap, window, split, st);
  return launch<TQ, 256>(q, k, v, tables, starts, out, B, C, H, KV, hd, N, bs, nb, softcap, window, split, st);
}

}  // namespace tc

// ===========================================================================
// split: K1 with each (sequence, kv head)'s walk split across a cluster
// ===========================================================================
//
// What bounds it on the card: the bytes of K/V read (olmo-1b's 4 slots at
// lengths 77 / 160 / 291 / 352 read about 7 MB: 0.0022 ms at 3.35 TB/s).
// Each K/V element feeds qpk <= 4 multiply-adds at the decode shapes the
// port serves (olmo-1b and gemma-7b 1, mistral-nemo-12b 4): far below the
// hundreds of operations a byte where the tensor cores would pay, so the
// arithmetic stays fp32 on the CUDA cores.  What v1 lost was parallelism
// and bytes in flight: 64 blocks on 132 SMs, each loading one K/V block
// at a time behind four block barriers.
//
// Design:
//  * a thread-block cluster of ``split`` blocks (1 to 8; the host picks it
//    from the table width and the window, ``pick_split``) per (sequence, kv head, group of
//    up to RT query rows).  The lengths stay on the card: each block takes
//    an even share of the live positions [max(0, len - window), len) on the
//    device, and each of its 4 warps an even share of the block's.  The
//    shares are exact, so no position is masked; a share may be empty;
//  * a warp issues every K/V load of its share at once (``cp.async``, 16
//    bytes a lane, through the block table) into its own stages of up to
//    16 positions, two stages ahead where the table holds more positions
//    than one; it needs only warp barriers while it walks;
//  * per stage: 8 lanes share a position's q . k (4 positions at a time,
//    q in shared memory as fp32), the warp's online softmax in log2 units
//    (one lane per position), then P V with each lane owning hd / 32
//    columns of the rows' accumulators in registers;
//  * the warps' (m, l, acc) are combined in shared memory (one block
//    barrier), and the blocks' by the cluster's first block through
//    distributed shared memory (two cluster barriers), which writes the
//    output.  A share with no position has m = -inf and l = 0 and weighs
//    0 in a combine (no exp(-inf - (-inf))).

namespace split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 8;  // the portable cluster size
constexpr int kG = 8;         // lanes that share one position's dot products

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int round4(int x) { return (x + 3) & ~3; }

// Layout of one instance: rows RT, head dim padded to HDP, pool type TKV.
template <typename TKV, int HDP, int RT>
struct Geo {
  static constexpr int kRowBytes = HDP * int(sizeof(TKV));  // one position's K (or V) row in a stage
  static constexpr int kWP = kRowBytes <= 256 ? 16 : (kRowBytes <= 512 ? 8 : 4);  // positions a stage
  static constexpr int kStageBytes = 2 * kWP * kRowBytes;   // K and V of one stage
  static constexpr int kCL = HDP / 32;                     // accumulator columns a lane
  static constexpr int kX = HDP + 4;  // a row's (acc, m, l) in a combine, rows on 16-byte boundaries
  // floats: q (then the block's combined rows), the stages' scores, the warps' rows
  static constexpr int kQ = round4(RT * kX);
  static constexpr int kP = round4(kWarps * RT * kWP);
  static constexpr int kXs = round4(kWarps * RT * kX);
  static constexpr int kFixed = 4 * (kQ + kP + kXs);
  static constexpr size_t bytes(int depth) { return size_t(kFixed) + size_t(kWarps) * depth * kStageBytes; }
};

// Stage ``st`` of a warp's positions [wlo, whi) into its ring slot st % depth:
// each lane copies 16-byte pieces of K and V rows, one commit group.
template <typename TKV, int HDP, int RT>
__device__ __forceinline__ void issue_stage(uint32_t ring_w, int depth, int st, int wlo, int whi, const TKV* kpool,
                                            const TKV* vpool, const int* trow, int N, int bs, int KV, int kv, int hd,
                                            int lane) {
  using G = Geo<TKV, HDP, RT>;
  const int p0 = wlo + st * G::kWP;
  const int np = min(G::kWP, whi - p0);
  const int chunks = hd * int(sizeof(TKV)) / 16;
  const uint32_t kdst = ring_w + (st % depth) * G::kStageBytes;
  const uint32_t vdst = kdst + G::kWP * G::kRowBytes;
  for (int i = lane; i < np * chunks; i += 32) {
    const int pp = i / chunks, c = i - pp * chunks;
    const int p = p0 + pp;
    int phys = trow[p / bs];
    if (phys < 0 || phys >= N) phys = 0;  // never index outside the pool
    const size_t off = (((size_t(phys) * bs + p % bs) * KV + kv) * size_t(hd)) * sizeof(TKV) + size_t(c) * 16;
    cp_async16(kdst + pp * G::kRowBytes + c * 16, reinterpret_cast<const uint8_t*>(kpool) + off);
    cp_async16(vdst + pp * G::kRowBytes + c * 16, reinterpret_cast<const uint8_t*>(vpool) + off);
  }
  cp_async_commit();
}

// CL values of T at ``src`` as floats.
template <typename T, int CL>
__device__ __forceinline__ void load_cols(const T* src, float (&x)[CL]) {
  if constexpr (sizeof(T) * CL == 16) {
    Vec16<T>::load(src, x);
  } else if constexpr (sizeof(T) == 4 && CL == 2) {
    const float2 a = *reinterpret_cast<const float2*>(src);
    x[0] = a.x, x[1] = a.y;
  } else if constexpr (sizeof(T) == 2 && CL == 4) {
    const uint2 a = *reinterpret_cast<const uint2*>(src);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
    x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
  } else if constexpr (sizeof(T) == 2 && CL == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
    x[0] = a.x, x[1] = a.y;
  } else {  // 8 fp32
#pragma unroll
    for (int e = 0; e < CL; e += 4) {
      const float4 a = *reinterpret_cast<const float4*>(src + e);
      x[e] = a.x, x[e + 1] = a.y, x[e + 2] = a.z, x[e + 3] = a.w;
    }
  }
}

// grid (split, B, KV * row groups), clusters of (split, 1, 1); 128 threads.
template <typename TQ, typename TKV, int HDP, int RT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel_split(const TQ* __restrict__ q, const TKV* __restrict__ kpool, const TKV* __restrict__ vpool,
                              const int* __restrict__ tables, const int* __restrict__ seq_lens, TQ* __restrict__ out,
                              int N, int bs, int nb, int H, int KV, int hd, float scale, float softcap, int window,
                              int depth) {
  using G = Geo<TKV, HDP, RT>;
  constexpr int WP = G::kWP, CL = G::kCL, X = G::kX;
  constexpr int EPC = 16 / int(sizeof(TKV));  // values in a 16-byte piece
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // RT x X: q in fp32, then the block's (acc, m, l)
  float* p_s = q_s + G::kQ;           // kWarps x RT x WP: each warp's stage scores, then P
  float* xs = p_s + G::kP;            // kWarps x RT x X: each warp's (acc, m, l)
  uint8_t* ring = reinterpret_cast<uint8_t*>(xs + G::kXs);  // kWarps x depth stages

  const int split = gridDim.x, rank = blockIdx.x;
  const int b = blockIdx.y;
  const int groups = gridDim.z / KV;
  const int kv = blockIdx.z / groups, r0 = (blockIdx.z - kv * groups) * RT;
  const int qpk = H / KV;
  const int nrows = min(RT, qpk - r0);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;

  int len = seq_lens[b];
  len = len < 1 ? 1 : (len > nb * bs ? nb * bs : len);
  const int lo = window > 0 ? max(len - window, 0) : 0;
  const int n_all = len - lo;
  const int blo = lo + n_all * rank / split, bhi = lo + n_all * (rank + 1) / split;
  const int wlo = blo + (bhi - blo) * w / kWarps, whi = blo + (bhi - blo) * (w + 1) / kWarps;
  const int nst = (whi - wlo + WP - 1) / WP;

  // the share's loads first, then q while they fly
  const int* trow = tables + size_t(b) * nb;
  const uint32_t ring_w = hopper::smem_addr(ring) + w * depth * G::kStageBytes;
  for (int st = 0; st < min(depth, nst); ++st)
    issue_stage<TKV, HDP, RT>(ring_w, depth, st, wlo, whi, kpool, vpool, trow, N, bs, KV, kv, hd, lane);
  const TQ* qb = q + (size_t(b) * H + size_t(kv) * qpk + r0) * hd;
  for (int i = tid; i < RT * HDP; i += kThreads) {
    const int r = i / HDP, d = i - r * HDP;
    q_s[r * X + d] = (r < nrows && d < hd) ? to_f(qb[size_t(r) * hd + d]) : 0.f;
  }
  __syncthreads();

  float m[RT], l[RT], acc[RT][CL];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m[r] = -CUDART_INF_F;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CL; ++c) acc[r][c] = 0.f;
  }
  float* pw = p_s + w * RT * WP;
  const int chunks = hd * int(sizeof(TKV)) / 16;
  const int gl = lane & (kG - 1);
  for (int st = 0; st < nst; ++st) {
    if (min(nst, st + depth) - st - 1 > 0)  // a later stage may stay in flight
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncwarp();
    const int p0 = wlo + st * WP;
    const int np = min(WP, whi - p0);
    const uint8_t* ks = ring + (w * depth + st % depth) * G::kStageBytes;
    const uint8_t* vs = ks + WP * G::kRowBytes;
    // scores: kG lanes share a position, 32 / kG positions at a time
#pragma unroll
    for (int it = 0; it < WP * kG / 32; ++it) {
      const int pp = it * (32 / kG) + lane / kG;
      float part[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) part[r] = 0.f;
      if (pp < np) {
        for (int c = gl; c < chunks; c += kG) {
          float kf[EPC];
          Vec16<TKV>::load(reinterpret_cast<const TKV*>(ks + pp * G::kRowBytes + c * 16), kf);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float* qr = q_s + r * X + c * EPC;
#pragma unroll
            for (int e = 0; e < EPC; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              part[r] = fmaf(qv.x, kf[e], part[r]);
              part[r] = fmaf(qv.y, kf[e + 1], part[r]);
              part[r] = fmaf(qv.z, kf[e + 2], part[r]);
              part[r] = fmaf(qv.w, kf[e + 3], part[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int o = kG / 2; o > 0; o >>= 1) part[r] += __shfl_xor_sync(0xffffffffu, part[r], o);
        if (gl == 0) pw[r * WP + pp] = pp < np ? attn_tc::log2_score(part[r], scale, softcap) : -CUDART_INF_F;
      }
    }
    __syncwarp();
    // online softmax, one lane per position (lanes past WP repeat them)
    float sv[RT], alpha[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) sv[r] = pw[r * WP + lane % WP];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mx = sv[r];
#pragma unroll
      for (int o = WP / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[r], mx);  // finite: the stage holds a position
      const float p = exp2f(sv[r] - mn);
      float ps = p;
#pragma unroll
      for (int o = WP / 2; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      alpha[r] = exp2f(m[r] - mn);  // 0 on the first stage (m = -inf)
      l[r] = l[r] * alpha[r] + ps;
      m[r] = mn;
      if (lane < WP) pw[r * WP + lane] = p;
    }
    __syncwarp();
    // P V: this lane's columns lane * CL ..
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < CL; ++c) acc[r][c] *= alpha[r];
    if (lane * CL < hd) {
      for (int pp = 0; pp < np; ++pp) {
        float vf[CL];
        load_cols<TKV, CL>(reinterpret_cast<const TKV*>(vs + pp * G::kRowBytes) + lane * CL, vf);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float pr = pw[r * WP + pp];
#pragma unroll
          for (int c = 0; c < CL; ++c) acc[r][c] = fmaf(pr, vf[c], acc[r][c]);
        }
      }
    }
    __syncwarp();  // the stage's slot is free again
    if (st + depth < nst)
      issue_stage<TKV, HDP, RT>(ring_w, depth, st + depth, wlo, whi, kpool, vpool, trow, N, bs, KV, kv, hd, lane);
  }

  // the warps' rows, then the block's (one barrier)
  float* xw = xs + w * RT * X;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int c = 0; c < CL; ++c) xw[r * X + lane * CL + c] = acc[r][c];
    if (lane == 0) {
      xw[r * X + HDP] = m[r];
      xw[r * X + HDP + 1] = l[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < RT * (HDP + 1); i += kThreads) {  // column HDP: the row's m and l
    const int r = i / (HDP + 1), d = i - r * (HDP + 1);
    float M = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) M = fmaxf(M, xs[(j * RT + r) * X + HDP]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const float* xj = xs + (j * RT + r) * X;
      if (xj[HDP] == -CUDART_INF_F) continue;  // an empty share weighs 0
      const float wt = exp2f(xj[HDP] - M);
      L += wt * xj[HDP + 1];
      if (d < HDP) A += wt * xj[d];
    }
    if (d < HDP) {
      q_s[r * X + d] = A;
    } else {
      q_s[r * X + HDP] = M;
      q_s[r * X + HDP + 1] = L;
    }
  }

  // the cluster's blocks, combined by its first block
  if (split > 1)
    hopper::cluster_sync();
  else
    __syncthreads();
  if (rank == 0) {
    const uint32_t xb = hopper::smem_addr(q_s);
    for (int i = tid; i < nrows * hd; i += kThreads) {
      const int r = i / hd, d = i - r * hd;
      float M = q_s[r * X + HDP], L = q_s[r * X + HDP + 1], A = q_s[r * X + d];
      for (int j = 1; j < split; ++j) {
        const uint32_t peer = hopper::cluster_map(xb, j);
        const float mj = hopper::ld_cluster_f32(peer + 4u * (r * X + HDP));
        if (mj == -CUDART_INF_F) continue;
        const float mn = fmaxf(M, mj);
        const float a = M == -CUDART_INF_F ? 0.f : exp2f(M - mn);
        const float wt = exp2f(mj - mn);
        L = a * L + wt * hopper::ld_cluster_f32(peer + 4u * (r * X + HDP + 1));
        A = a * A + wt * hopper::ld_cluster_f32(peer + 4u * (r * X + d));
        M = mn;
      }
      out[(size_t(b) * H + size_t(kv) * qpk + r0 + r) * hd + d] = from_f<TQ>(A / fmaxf(L, 1e-30f));
    }
  }
  if (split > 1) hopper::cluster_sync();  // the others' shared memory stays until it has been read
}

// The cluster size: every block of the longest walk the table and the
// window allow takes 64 positions or more, at most 8 blocks, and the grid
// stays within 8 blocks an SM.  (A cluster's combine costs more than a
// walk of a few dozen positions: on the H100, mistral-nemo-12b's heads
// under a window of 32 ran 0.0142 ms with 8 blocks against 0.0076 with one.)
inline int pick_split(int B, int KV, int groups, int nb, int bs, int window) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  const int longest = window > 0 ? min(nb * bs, window) : nb * bs;
  int split = min(kMaxSplit, max(1, (longest + 63) / 64));
  while (split > 1 && B * KV * groups * split > 8 * sms) --split;
  return split;
}

template <typename TQ, typename TKV, int HDP, int RT>
int launch(const void* q, const void* k, const void* v, const int* tables, const int* seq_lens, void* out, int B,
           int H, int KV, int hd, int N, int bs, int nb, float softcap, int window, int split, cudaStream_t stream) {
  using G = Geo<TKV, HDP, RT>;
  const int groups = (H / KV + RT - 1) / RT;
  if (split <= 0) split = pick_split(B, KV, groups, nb, bs, window);
  if (split > kMaxSplit) return int(cudaErrorInvalidValue);
  // stages a warp needs for its share of a full table; two in flight at most
  const int per_warp = ((nb * bs + split - 1) / split + kWarps - 1) / kWarps;
  const int depth = min(2, max(1, (per_warp + G::kWP - 1) / G::kWP));
  const size_t smem = G::bytes(depth);
  auto kernel = paged_decode_kernel_split<TQ, TKV, HDP, RT>;
  if (int e = set_smem(kernel, smem)) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, B, KV * groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TQ*>(q), static_cast<const TKV*>(k),
                                     static_cast<const TKV*>(v), tables, seq_lens, static_cast<TQ*>(out), N, bs, nb, H,
                                     KV, hd, 1.0f / sqrtf(float(hd)), softcap, window, depth);
  if (e != cudaSuccess) return int(e);
  return int(cudaGetLastError());
}

// The instance for these dtypes, head dim and rows: RT = 1, 4 or 8 query
// rows a block, hd padded to 64, 128 or 256.
template <typename TQ, typename TKV>
int dispatch(const void* q, const void* k, const void* v, const int* tables, const int* seq_lens, void* out, int B,
             int H, int KV, int hd, int N, int bs, int nb, float softcap, int window, int split, cudaStream_t st) {
  const int qpk = H / KV;
#define K1_SPLIT_LAUNCH(HDP, RT) \
  return launch<TQ, TKV, HDP, RT>(q, k, v, tables, seq_lens, out, B, H, KV, hd, N, bs, nb, softcap, window, split, st)
#define K1_SPLIT_ROWS(HDP)          \
  if (qpk == 1) K1_SPLIT_LAUNCH(HDP, 1); \
  if (qpk <= 4) K1_SPLIT_LAUNCH(HDP, 4); \
  K1_SPLIT_LAUNCH(HDP, 8)
  if (hd <= 64) {
    K1_SPLIT_ROWS(64);
  }
  if (hd <= 128) {
    K1_SPLIT_ROWS(128);
  }
  K1_SPLIT_ROWS(256);
#undef K1_SPLIT_ROWS
#undef K1_SPLIT_LAUNCH
}

inline int rows_for(int qpk) { return qpk == 1 ? 1 : (qpk <= 4 ? 4 : 8); }

}  // namespace split

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one thread block of either kernel needs.
size_t paged_attention_smem_bytes(int rows, int bs, int hd) { return tile_bytes(rows, bs, hd); }

// K1, split over a cluster.  q, out: (B, H, hd); pools: (N, bs, KV, hd);
// tables: (B, nb) int32; seq_lens: (B,) int32.  *_bf16 selects bf16 (1) or
// fp32 (0) storage.  split: the cluster size, 1 to 8; 0 lets the kernel pick.
int paged_decode_attention_split(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                                 const void* seq_lens, void* out, int B, int H, int KV, int hd, int N, int bs, int nb,
                                 float softcap, int window, int q_bf16, int kv_bf16, int split, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && kv_bf16)
    return split::dispatch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, tb, sl, out, B, H, KV, hd, N, bs, nb,
                                                         softcap, window, split, st);
  if (q_bf16)
    return split::dispatch<__nv_bfloat16, float>(q, k_pool, v_pool, tb, sl, out, B, H, KV, hd, N, bs, nb, softcap,
                                                 window, split, st);
  if (kv_bf16)
    return split::dispatch<float, __nv_bfloat16>(q, k_pool, v_pool, tb, sl, out, B, H, KV, hd, N, bs, nb, softcap,
                                                 window, split, st);
  return split::dispatch<float, float>(q, k_pool, v_pool, tb, sl, out, B, H, KV, hd, N, bs, nb, softcap, window,
                                       split, st);
}

// The cluster size K1's split kernel picks for these shapes.
int paged_decode_split(int B, int H, int KV, int nb, int bs, int window) {
  const int rt = split::rows_for(H / KV);
  return split::pick_split(B, KV, (H / KV + rt - 1) / rt, nb, bs, window);
}

// K1's yardstick, v1.  Arguments as paged_decode_attention_split without
// the split.
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

// The cluster split K2's tensor-core kernel picks for these shapes.
int paged_prefill_tc_split(int B, int C, int H, int KV, int hd, int nb, int bs, int window, float softcap,
                           int q_bf16) {
  return q_bf16 ? tc::split_for<__nv_bfloat16>(B, C, H, KV, hd, nb, bs, window, softcap)
                : tc::split_for<float>(B, C, H, KV, hd, nb, bs, window, softcap);
}

// K2 on bf16 pools, on the tensor cores.  Arguments as paged_prefill_attention;
// the pools must be bf16.  split: blocks (a cluster of 1, 2 or 4) that share
// each 64-row tile's keys; 0 lets the kernel pick.
int paged_prefill_attention_tc(const void* q, const void* k_pool, const void* v_pool, const void* tables,
                               const void* starts, void* out, int B, int C, int H, int KV, int hd, int N, int bs,
                               int nb, float softcap, int window, int q_bf16, int split, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  const int* st0 = static_cast<const int*>(starts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_bf16)
    return tc::dispatch<__nv_bfloat16>(q, k_pool, v_pool, tb, st0, out, B, C, H, KV, hd, N, bs, nb, softcap, window,
                                       split, st);
  return tc::dispatch<float>(q, k_pool, v_pool, tb, st0, out, B, C, H, KV, hd, N, bs, nb, softcap, window, split, st);
}

}  // extern "C"
