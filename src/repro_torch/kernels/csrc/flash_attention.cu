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
// accumulator per row.  P stays at fp32 accuracy for P.V: the TPU kernel
// upcasts its v tile to fp32 before `p.astype(v.dtype)`, so that cast
// rounds nothing.  The output is acc / max(l, 1e-30) in q's dtype.
//
// Two kernels, chosen by the inputs' dtype alone:
//  * bf16: ``tc::flash_tc_kernel``, on the tensor cores (wgmma, TMA);
//  * fp32: ``v1::flash_fwd_kernel``, on the CUDA cores in fp32.  wgmma takes
//    fp32 only as tf32 (10 bits), far from the fp32 result, so fp32 inputs
//    keep the first version.  Its bf16 instantiation is kept as the
//    yardstick of the tensor-core kernel (``cuda_cores`` of the entry point).
//
// What bounds it on the card: the operations.  At the training path's
// shape, (B, H, S, hd) = (4, 16, 2048, 128) bf16 causal, 4 hd operations
// per visible (query, key) pair against 4 B S H hd bytes of q, k, v and
// output: hundreds of operations per byte, at the bf16 dense rate (989
// TFLOP/s) for bf16 inputs, the CUDA cores' fp32 rate (67 TFLOP/s) for fp32.
//
// The walk over KV tiles (both kernels).  A q tile walks only the KV tiles
// that hold a visible key for some of its rows: from the first key inside
// the window of its first row to its last row (causal) or the end.  A tile
// the mask hides entirely leaves the Pallas kernel's result unchanged
// (before a row's first visible key it is wiped by the exp(-1e38 - m)
// rescale, after the last one it adds exp(-1e38 - m) = 0), so skipping it
// gives the same output.  A row that sees no key at all (possible only
// when Sq > Skv with a window) gets the mean of V over all Skv keys from
// the Pallas kernel (every score is -1e38, so every p is 1): a q tile that
// holds such a row walks every KV tile.  Keys past Skv in the last tile
// score -inf, so they count in no row's l.
//
// Entry points: a plain C interface (loaded with ctypes) that returns 0,
// a CUDA error code, or -1 if a TMA tensor map was refused.  The caller
// guarantees hd a multiple of 16 in [16, 256], H a multiple of KV,
// Sq, Skv >= 1, unit stride along hd, and rows and strides of q, k and v
// on 16-byte boundaries.

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1.0e38f;  // the Pallas kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

// The keys [lo, hi) that the q tile of rows [q0, q0 + rows) walks.
__device__ __forceinline__ void kv_range(int q0, int rows, int Sq, int Skv, int causal, int window, int& lo,
                                         int& hi) {
  hi = causal ? min(Skv, q0 + rows) : Skv;  // one past the last visible key
  lo = window > 0 ? max(0, q0 - window + 1) : 0;
  // a row that sees no key (r - window >= Skv - 1): every tile, as the
  // Pallas kernel averages V over all keys there
  if (window > 0 && min(Sq, q0 + rows) - 1 >= Skv + window - 1) {
    lo = 0;
    hi = Skv;
  }
}

// ===========================================================================
// v1: the CUDA cores, fp32 arithmetic (the fp32 route)
// ===========================================================================
//
//  * one thread block of 256 threads per (64-row q tile, q head, batch)
//    walks the KV tiles of 64 rows in a loop; m and l live in registers,
//    each thread owning four rows (ty + 16 i) of the tile and the same rows
//    of the accumulator, so the rescale needs no exchange;
//  * q tiles are scheduled longest first;
//  * Q, K and V tiles are read with coalesced 16-byte loads and kept in
//    shared memory in fp32, rows padded by 4 floats so that the float4
//    reads of eight neighbouring rows hit distinct banks.  Each thread
//    computes a 4 x 4 block of the scores (rows ty + 16 i, keys tx + 16 j)
//    with 8 float4 reads per 64 multiply-adds; row maxima and sums reduce
//    over the 16 lanes of a half warp by shuffles.

namespace v1 {

constexpr int kBQ = 64;   // query rows per thread block
constexpr int kBKV = 64;  // key / value rows per step
constexpr int kThreads = 256;
constexpr int kPad = 4;             // floats of padding per shared row
constexpr int kLdP = kBKV + kPad;   // row stride of the P tile

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

  int lo, hi;
  kv_range(q0, kBQ, Sq, Skv, causal, window, lo, hi);
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
        bool ok = true;
        if (causal) ok = ok && r >= c;
        if (window > 0) ok = ok && (r - c) < window;
        s[i][j] = c >= Skv ? -INFINITY : ok ? x : kNegInf;
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

}  // namespace v1

// ===========================================================================
// tc: the tensor cores, bf16 inputs (the bf16 route)
// ===========================================================================
//
// Numerics.  S = Q K^T by wgmma f32.bf16.bf16: the products are exact and
// the tensor cores sum them over hd in fp32 (with truncation).  The online
// softmax runs in fp32 registers: scores in log2 units (log2(e) folded into
// the scale, or applied after an accurate tanhf softcap) and exp2f.  P is
// kept at fp32-like accuracy on the tensor cores by a split: P_hi = bf16(P)
// and P_lo = bf16(P - P_hi), good to about 2^-17 together, each multiplied
// by the same exact bf16 V tile (two register-A wgmmas per k16 step).  A
// bf16 P alone would round the weights to 2^-9 and miss the fp32 result by
// about 1e-3 of the output.  The split costs 1.5x the products of a bf16-P
// kernel.  The tensor cores truncate each sum toward zero, so O summed in
// them over a whole row of keys shrinks by a bias that grows with the
// number of products (in olmo-1b's eval forward enough to move the loss
// past its limit): P V of each KV tile is therefore summed from zero on the
// tensor cores and added to O in fp32 registers, rounding to nearest.
//
// Design:
//  * a block of 384 threads per (128-row q tile, q head, batch), q tiles
//    longest first (the grid's slowest dimension, reversed).  Warpgroup 0
//    is the producer: one thread loads the Q tile once and K and V tiles
//    into a ring of stages by rank-4 TMA (hd, S, heads, batch), taken
//    with the caller's strides, so the model's (B, S, H, hd) layout needs no
//    copy; full and empty mbarriers, K and V on barriers of their own.
//    Warpgroups 1 and 2 each own 64 query rows;
//  * hd is padded to HDP, a multiple of 64, in shared memory: a tile is
//    HDP / 64 column chunks of rows x 128 bytes with the 128-byte swizzle,
//    and TMA fills columns past hd and rows past S with zeros (zero columns
//    add nothing to Q K^T; O's are not stored).  KV tiles hold 64 keys; the
//    ring holds as many stages as shared memory allows, at most 4 (gemma-7b's
//    hd 256: 64 KB of Q and 2 x 64 KB of K and V);
//  * S (64 x 64 per warpgroup) by SS wgmma, Q and K both K-major along hd;
//    its accumulator registers are P's A fragments for P V (hopper.cuh
//    ``acc_col``), so P_hi and P_lo reach wgmma with no trip through shared
//    memory; V, row-major along hd, is the MN-major B of P V (transpose
//    bit), m64n128 products over two 64-column chunks of O where they are
//    issued together, m64n64 otherwise;
//  * for hd <= 128 the tensor cores run P V of one KV tile while the CUDA
//    cores run the softmax of the next: S of tile it is issued, then P V of
//    tile it - 1, and the softmax waits only for S (the two commit groups
//    complete in order).  O, that P V, S and P_hi + P_lo are then live at
//    once (192 of the 240 registers a consumer thread gets at hd 128); at
//    hd 192 and 256 they would not fit, and P V follows the softmax, one
//    64-column chunk at a time;
//  * the causal, window and ragged-edge compares run only on the tiles
//    that need them (the diagonal, the window's edge, the last tile).

namespace tc {

constexpr int kBQ = 128;  // query rows per block: two consumer warpgroups
constexpr int kThreads = 384;

template <int HDP>
struct Tiles {
  static constexpr int NC = HDP / 64;  // 64-column chunks of a row
  static constexpr int BKV = 64;       // keys per KV tile
  // P V of one tile comes back from the tensor cores in PVC chunks at a
  // time; with the softmax of the next tile overlapping it (kOverlap), O,
  // that P V, S and P_hi + P_lo are live at once: 192 registers at most
  static constexpr bool kOverlap = 2 * 32 * NC + BKV <= 192;
  static constexpr int PVC = kOverlap ? NC : 1;
  static constexpr int kQBytes = NC * kBQ * 128;
  static constexpr int kKVBytes = NC * BKV * 128;  // K or V of one stage
  static constexpr int kStageBytes = 2 * kKVBytes;
  // K/V stages in the ring: as many as shared memory holds, at most 4
  static constexpr int kFit = (232448 - 2048 - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  // 1024 bytes of alignment slack, Q, the ring, 1 + 3 kStages mbarriers
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + 8 * (1 + 3 * kStages);
  static_assert(kStages >= 2 && kSmem <= 232448, "a block's shared memory on the H100");
};

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o, int H, int KV,
                    int Sq, int Skv, int hd, Strides so, float scale, int causal, int window, float softcap) {
  using namespace hopper;
  using L = Tiles<HDP>;
  constexpr int NC = L::NC;
  constexpr int BKV = L::BKV;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024-byte alignment
  const uint32_t q_s = base;
  auto k_s = [&](int s) { return base + L::kQBytes + s * L::kStageBytes; };
  auto v_s = [&](int s) { return base + L::kQBytes + s * L::kStageBytes + L::kKVBytes; };
  const uint32_t bars = base + L::kQBytes + kStages * L::kStageBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8u * (1 + s); };
  auto v_full = [&](int s) { return bars + 8u * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + 2 * kStages + s); };

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // longest tiles first
  int lo, hi;
  kv_range(q0, kBQ, Sq, Skv, causal, window, lo, hi);
  const int t_first = lo / BKV;
  const int n_tiles = (hi + BKV - 1) / BKV - t_first;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < NC; ++c) tma_load_4d(q_s + c * (kBQ * 128), &map_q, q_full, 64 * c, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int t0 = (t_first + it) * BKV;
        if (it >= kStages) mbar_wait(empty(s), ((it / kStages) - 1) & 1);
        mbar_arrive_expect_tx(k_full(s), L::kKVBytes);
        for (int c = 0; c < NC; ++c) tma_load_4d(k_s(s) + c * (BKV * 128), &map_k, k_full(s), 64 * c, t0, kvh, b);
        mbar_arrive_expect_tx(v_full(s), L::kKVBytes);
        for (int c = 0; c < NC; ++c) tma_load_4d(v_s(s) + c * (BKV * 128), &map_v, v_full(s), 64 * c, t0, kvh, b);
      }
    }
  } else {  // consumers: warpgroup w = 0, 1 owns rows 64 w .. 64 w + 63 of the tile
    setmaxnreg_inc<240>();
    const int t = threadIdx.x - 128;
    const int w = t >> 7;
    const int tw = t & 127;
    const int r0 = q0 + 64 * w;              // the warpgroup's first row
    const int row_a = r0 + acc_row(tw, 0);   // this thread's two rows
    const int row_b = row_a + 8;
    const float scale_log2 = scale * kLog2e;

    constexpr int PVC = L::PVC;
    float o_acc[NC][32];  // O, summed in fp32 registers (round to nearest)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[c][i] = 0.f;
    float pv[PVC][32];    // P V of one tile (PVC chunks), from the tensor cores
    float m[2] = {kNegInf, kNegInf};  // running max, log2 units
    float l[2] = {0.f, 0.f};          // this thread's part of the row sums
    float sc[BKV / 2];                // S of one tile, then its P
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.f;
    uint32_t p_hi[BKV / 4], p_lo[BKV / 4];  // P = P_hi + P_lo, the A fragments of P V

    // S = Q K^T of stage s, issued (one commit group)
    auto issue_qk = [&](int s, uint32_t parity) {
      fence_regs(sc);
      mbar_wait(k_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < HDP / 16; ++j) {  // hd's zero padding adds nothing
        const uint32_t qa = q_s + (j >> 2) * (kBQ * 128) + w * (64 * 128) + (j & 3) * 32;
        const uint32_t kb = k_s(s) + (j >> 2) * (BKV * 128) + (j & 3) * 32;
        wgmma_m64n64k16_bf16_ss(sc, smem_desc(qa), smem_desc(kb), j > 0);
      }
      wgmma_commit();
    };
    // pv = P_hi V + P_lo V for chunks c0 .. c0 + PVC - 1 of stage s, from
    // zero, issued (one commit group): 128 columns per product where two
    // chunks go together
    auto issue_pv = [&](int s, uint32_t parity, int c0) {
#pragma unroll
      for (int c = 0; c < PVC; ++c) fence_regs(pv[c]);
      fence_regs(p_hi);
      fence_regs(p_lo);
      mbar_wait(v_full(s), parity);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BKV / 16; ++j) {
        const uint64_t dv = smem_desc_mn(v_s(s) + c0 * (BKV * 128) + j * (16 * 128), BKV * 128);
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
    };
    // once the issued P V is done: O += pv, rounded to nearest
    auto add_pv = [&](int c0) {
#pragma unroll
      for (int c = 0; c < PVC; ++c) {
        fence_regs(pv[c]);
#pragma unroll
        for (int i = 0; i < 32; ++i) o_acc[c0 + c][i] += pv[c][i];
      }
      fence_regs(p_hi);
      fence_regs(p_lo);
    };
    // softcap, mask and online softmax of the landed S of the tile at key
    // t0 (log2 units): sc becomes P, m and l move on; returns the rescale
    // of the rows' earlier sums in alpha
    auto softmax = [&](int t0, float (&alpha)[2]) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i)
        sc[i] = softcap > 0.f ? softcap * tanhf(sc[i] * scale / softcap) * kLog2e : sc[i] * scale_log2;
      if (t0 + BKV > Skv || (causal && t0 + BKV - 1 > r0) || (window > 0 && r0 + 63 - t0 >= window)) {
#pragma unroll
        for (int i = 0; i < BKV / 2; ++i) {  // the diagonal, the window's edge or the last tile
          const int c = t0 + acc_col(tw, i);
          const int r = (i & 2) ? row_b : row_a;
          const bool ok = (!causal || c <= r) && (window == 0 || r - c < window);
          sc[i] = c >= Skv ? -INFINITY : ok ? sc[i] : kNegInf;
        }
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // a row's values lie on 4 neighbouring lanes
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        alpha[e] = exp2f(m[e] - mx[e]);
        m[e] = mx[e];
        l[e] *= alpha[e];
      }
#pragma unroll
      for (int i = 0; i < BKV / 2; ++i) {
        sc[i] = exp2f(sc[i] - mx[(i >> 1) & 1]);
        l[(i >> 1) & 1] += sc[i];
      }
    };
    // O's rescale, then P into its two bf16 terms
    auto rescale_split = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o_acc[c][i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int f = 0; f < BKV / 4; ++f) {
        const __nv_bfloat162 hi2 = __floats2bfloat162_rn(sc[2 * f], sc[2 * f + 1]);
        const float2 back = __bfloat1622float2(hi2);
        p_hi[f] = bf16x2_bits(hi2);
        p_lo[f] = bf16x2_bits(__floats2bfloat162_rn(sc[2 * f] - back.x, sc[2 * f + 1] - back.y));
      }
    };
    auto release = [&](int s) {  // the stage's K and V go back to the producer
      __syncwarp();
      if ((t & 31) == 0) mbar_arrive(empty(s));
    };

    mbar_wait(q_full, 0);
    float alpha[2];
    if constexpr (L::kOverlap) {
      // The tensor cores run P V of tile it - 1 while the CUDA cores run
      // the softmax of tile it: S of tile it is issued first, P V of it - 1
      // behind it, and the softmax waits only for S (commit groups complete
      // in order).
      issue_qk(0, 0);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(t_first * BKV, alpha);
      rescale_split(alpha);
      for (int it = 1; it < n_tiles; ++it) {
        const int s = it % kStages, sp = (it - 1) % kStages;
        issue_qk(s, (it / kStages) & 1);
        issue_pv(sp, ((it - 1) / kStages) & 1, 0);
        wgmma_wait<1>();  // S of tile it
        fence_regs(sc);
        softmax((t_first + it) * BKV, alpha);
        wgmma_wait<0>();  // P V of tile it - 1
        add_pv(0);
        release(sp);
        rescale_split(alpha);
      }
      const int sl = (n_tiles - 1) % kStages;
      issue_pv(sl, ((n_tiles - 1) / kStages) & 1, 0);
      wgmma_wait<0>();
      add_pv(0);
      release(sl);
    } else {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        issue_qk(s, parity);
        wgmma_wait<0>();
        fence_regs(sc);
        softmax((t_first + it) * BKV, alpha);
        rescale_split(alpha);
#pragma unroll
        for (int c0 = 0; c0 < NC; c0 += PVC) {
          issue_pv(s, parity, c0);
          wgmma_wait<0>();
          add_pv(c0);
        }
        release(s);
      }
    }

    // ---- O / max(l, 1e-30) in bf16, rows < Sq and columns < hd
    float denom[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
      denom[e] = fmaxf(l[e], 1e-30f);
    }
    __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i & 2) ? row_b : row_a;
        const int col = 64 * c + acc_col(tw, i);
        if (r < Sq && col < hd)
          *reinterpret_cast<__nv_bfloat162*>(ob + r * so.s + col) =
              __floats2bfloat162_rn(o_acc[c][i] / denom[(i >> 1) & 1], o_acc[c][i + 1] / denom[(i >> 1) & 1]);
      }
  }
}

__host__ __device__ constexpr int smem_bytes(int hd) {
  return hd <= 64 ? Tiles<64>::kSmem : hd <= 128 ? Tiles<128>::kSmem : hd <= 192 ? Tiles<192>::kSmem : Tiles<256>::kSmem;
}

// Tensor map of a (B, heads, S, hd) bf16 tensor with element strides st,
// in boxes of 64 x rows.
inline bool encode(CUtensorMap* map, const void* p, int B, int heads, int S, int hd, Strides st, int rows) {
  const uint64_t dims[4] = {uint64_t(hd), uint64_t(S), uint64_t(heads), uint64_t(B)};
  const uint64_t strides[3] = {uint64_t(st.s) * 2, uint64_t(st.h) * 2, uint64_t(st.b) * 2};
  return hopper::encode_rank4_sw128(map, p, dims, strides, rows, 2, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int Sq, int Skv, int hd,
           Strides sq, Strides sk, Strides sv, Strides so, float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  using L = Tiles<HDP>;
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, q, B, H, Sq, hd, sq, kBQ) || !encode(&mk, k, B, KV, Skv, hd, sk, L::BKV) ||
      !encode(&mv, v, B, KV, Skv, hd, sv, L::BKV))
    return -1;
  auto kernel = flash_tc_kernel<HDP>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (e != cudaSuccess) return int(e);
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), H, KV, Sq, Skv, hd, so,
                                               scale, causal, window, softcap);
  return int(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int Sq, int Skv, int hd,
             Strides sq, Strides sk, Strides sv, Strides so, float scale, int causal, int window, float softcap,
             cudaStream_t st) {
  if (hd <= 64) return launch<64>(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal, window, softcap, st);
  if (hd <= 128) return launch<128>(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal, window, softcap, st);
  if (hd <= 192) return launch<192>(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal, window, softcap, st);
  return launch<256>(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal, window, softcap, st);
}

}  // namespace tc

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one thread block needs at head_dim hd,
// on the bf16 route (1) or the fp32 one (0).
size_t flash_attention_smem_bytes(int hd, int bf16) { return bf16 ? tc::smem_bytes(hd) : v1::smem_bytes(hd); }

// q, o: (B, H, Sq, hd); k, v: (B, KV, Skv, hd); each with (batch, head,
// sequence) strides in elements and unit stride along hd.  bf16 (1) or
// fp32 (0) for all four; bf16 runs the tensor-core kernel unless
// cuda_cores (1) asks for the CUDA-core one, which fp32 always runs.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
                        int Sq, int Skv, int hd, int bf16, int cuda_cores, long long qb, long long qh,
                        long long qs, long long kb, long long kh, long long ks, long long vb, long long vh,
                        long long vs, long long ob, long long oh, long long os, float scale,
                        int causal, int window, float softcap, void* stream) {
  const Strides sq{qb, qh, qs}, sk{kb, kh, ks}, sv{vb, vh, vs}, so{ob, oh, os};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16 && !cuda_cores)
    return tc::dispatch(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal, window, softcap, st);
  if (bf16)
    return v1::dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal, window,
                                       softcap, st);
  return v1::dispatch<float>(q, k, v, o, B, H, KV, Sq, Skv, hd, sq, sk, sv, so, scale, causal, window, softcap, st);
}

}  // extern "C"
