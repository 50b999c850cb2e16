// RWKV6 WKV chunked scan for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel of the JAX package:
//   K5  src/repro/kernels/rwkv6_scan.py  wkv6_chunked / _wkv_kernel
//
// What it computes, as the TPU kernel does: Finch's recurrence with
// data-dependent decay (arXiv:2404.05892), per (batch, head), head size n,
// from a zero (n, n) fp32 state, returning the outputs only:
//   out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
// in the chunked-parallel form.  Per chunk of L steps, with lw = log w <= 0,
// la the inclusive cumulative sum of lw and la_prev = la - lw:
//   out   = (r * exp(la_prev)) @ S0                        (inter-chunk)
//         + sum_{s<t} [sum_c r_t k_s exp(la_prev_t - la_s)] v_s   (intra-chunk)
//         + (r_t . (u * k_t)) v_t                           (diagonal bonus)
//   S1    = diag(exp(la_L)) S0 + (k * exp(la_L - la))^T @ v
// Inputs and output are fp32, as the model hands them to the kernel.
//
// What bounds it on the card: the bytes.  At rwkv6-7b's eval shape
// (4 x 64 heads, S = 2048, n = L = 64) the scan must read r, k, v, logw
// and write the output once: 671 MB, 0.200 ms at 3.35 TB/s.  What the
// recurrence needs in operations (4 n^2 a token and head, 4.3 GFLOP, and
// n exponentials a token and head) takes less at the card's rates.
//
// Design (``wkv6_kernel_chunk``): the chunks are the unit of parallel
// work, one block of 2 L / 16 warps per chunk, B * H * S / L blocks (8192
// at the eval shape), two on every SM (107 KB of shared memory at
// n = L = 64).  Only the state crosses chunks, and its recurrence is
// elementwise: a block computes its chunk's state term U = (k * exp(la_L
// - la))^T v on the tensor cores, takes the state entering its chunk from
// the block of the chunk before, publishes S_{c+1} = diag(exp(la_L)) S_c
// + U through L2 (a ring of two states per (batch, head), a flag each),
// and computes its outputs from S_c.  Blocks take their chunks by a
// ticket in chunk-major order, so a block waits only for blocks that
// already run, 256 walks advance side by side, and a chunk's predecessor
// has published long before the chunk needs it.  No state term leaves
// the chip: the call moves the bound's bytes and 16 KB of L2 traffic a
// chunk.  The v1 kernel (``wkv6_cuda_cores_kernel``, the yardstick) ran
// one block per (batch, head) through its chunks in order: 256 blocks of
// 113 KB of shared memory, two waves of one block per SM.
//
// Far fewer exponentials.  Each chunk splits into sub-chunks of 16 steps.
// For t in sub-chunk i and s in an earlier sub-chunk, with b the last step
// before sub-chunk i, exp(la_prev_t - la_s) = exp(la_prev_t - la_b) *
// exp(la_b - la_s): both exponents are <= 0, so neither factor overflows
// (one that underflows stands for a product smaller still, which keeps the
// fast-decay case finite), and the off-diagonal 16 x 16 score blocks are
// the product (r * exp(la_prev - la_b)) (k * exp(la_b - la))^T.  Within a
// diagonal block the pairs of different 4-step groups are factored alike
// about the last step of s's group; only the pairs s < t of one group
// keep one exponential per (t, s, channel), and s = t takes the bonus.
// s > t takes nothing (exp of a positive exponent is inf, and inf * 0 is
// NaN).  At n = L = 64 that is about 33k exponentials a chunk, against
// v1's 129k.  The decays are taken as the JAX package's kernel takes them
// (la the cumulative sum of lw in order, la_prev = la - lw, in natural
// units): another rounding of la_prev moved the rwkv6-7b eval's bf16
// layers past their limits.
//
// The products on the tensor cores at fp32 accuracy.  k~^T v, the
// off-diagonal scores, scores v and r~ S0 are ``mma.sync`` m16n8k8
// products on TF32 operands with fp32 sums, "3xTF32": every fp32 operand
// is split into hi = tf32(x) and lo = x - hi, and each product is hi hi +
// hi lo + lo hi, good to about 2^-22, each k8 step's three summed from
// zero and added in fp32 registers (the tensor cores truncate their sums;
// carried over K = 64 that became a bias).  One TF32 term alone misses the
// limit, and two bf16 terms, good to 2^-16, moved the rwkv6-7b eval's bf16
// layers past theirs (``rwkv6_scan_ref.wkv6_chunked_split``).  Warps
// 2 i and 2 i + 1 own sub-chunk i's 16 rows, each half of the columns.
// The diagonal blocks are spread over all warps in 4 x 4 register tiles,
// so a value read from shared memory serves 4 pairs: read per pair, they
// made the kernel bound by shared memory.  Shared-memory rows are padded
// so the fragment reads are conflict-free.  The exponentials go to the
// special-function unit's ``ex2``.  Operands are staged by ``cp.async``,
// all of a chunk's bytes in flight at once.
//
// Every operand is taken with its batch, head and sequence strides, so the
// model's (B, S, H, n) layout needs no transposed copy; 16-byte copies
// where every address and stride allows, else 4-byte ones.
//
// Entry points: a plain C interface (loaded with ctypes) that returns
// cudaGetLastError() after the launch.  The caller guarantees n and L in
// {16, 32, 64}, S a multiple of L, unit stride along n, and zeroed flags.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

struct Strides {
  long long b, h, s;
};

// ===========================================================================
// v1: one block per (batch, head), the CUDA cores (the yardstick)
// ===========================================================================

constexpr int kThreads = 256;

template <int N, int L>
struct Smem {
  static constexpr int kP = N + 1;  // padded row of k and la
  static constexpr int r = 0;
  static constexpr int k = r + L * N;
  static constexpr int v = k + L * kP;
  static constexpr int la = v + L * N;
  static constexpr int lp = la + L * kP;
  static constexpr int sc = lp + L * N;
  static constexpr int st = sc + L * L;
  static constexpr int u = st + N * N;
  static constexpr int floats = u + N;
  static constexpr size_t bytes = size_t(floats) * sizeof(float);
};

// v1 walks its chunks in order, the state resident in shared memory.  Per
// chunk it stages r, k, v and lw, takes the cumulative sums (one thread per
// channel), computes the scores for s < t only, decays r and k in place,
// writes the outputs and updates the state in place.
template <int N, int L>
__global__ void __launch_bounds__(kThreads)
    wkv6_cuda_cores_kernel(const float* __restrict__ R, const float* __restrict__ K, const float* __restrict__ V,
                           const float* __restrict__ W, const float* __restrict__ U, float* __restrict__ O,
                           int H, int S, Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
                           long long ub, long long uh) {
  using M = Smem<N, L>;
  constexpr int P = M::kP;
  extern __shared__ float smem[];
  float* r = smem + M::r;    // (L, N): r, then r * exp(la_prev)
  float* k = smem + M::k;    // (L, P): k, then k * exp(la_last - la)
  float* v = smem + M::v;    // (L, N)
  float* la = smem + M::la;  // (L, P): inclusive cumulative log-decay
  float* lp = smem + M::lp;  // (L, N): lw, then la_prev = la - lw
  float* sc = smem + M::sc;  // (L, L): scores, the bonus on the diagonal
  float* st = smem + M::st;  // (N, N): the carried state
  float* u = smem + M::u;    // (N,)

  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;
  const float* Rb = R + b * sr.b + h * sr.h;
  const float* Kb = K + b * sk.b + h * sk.h;
  const float* Vb = V + b * sv.b + h * sv.h;
  const float* Wb = W + b * sw.b + h * sw.h;
  float* Ob = O + b * so.b + h * so.h;

  for (int i = tid; i < N * N; i += kThreads) st[i] = 0.f;
  for (int i = tid; i < N; i += kThreads) u[i] = U[b * ub + h * uh + i];

  for (int c0 = 0; c0 < S; c0 += L) {
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, c = i % N;
      const long long row = c0 + t;
      r[i] = Rb[row * sr.s + c];
      k[t * P + c] = Kb[row * sk.s + c];
      v[i] = Vb[row * sv.s + c];
      lp[i] = Wb[row * sw.s + c];
    }
    __syncthreads();
    for (int c = tid; c < N; c += kThreads) {
      float acc = 0.f;
      for (int t = 0; t < L; ++t) {
        const float w = lp[t * N + c];
        acc += w;
        la[t * P + c] = acc;
        lp[t * N + c] = acc - w;
      }
    }
    __syncthreads();
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, s = i % L;
      float acc = 0.f;
      if (s < t) {
#pragma unroll 8
        for (int c = 0; c < N; ++c)
          acc += r[t * N + c] * k[s * P + c] * expf(lp[t * N + c] - la[s * P + c]);
      } else if (s == t) {
#pragma unroll 8
        for (int c = 0; c < N; ++c) acc += r[t * N + c] * u[c] * k[t * P + c];
      }
      sc[i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, c = i % N;
      r[i] *= expf(lp[i]);
      k[t * P + c] *= expf(la[(L - 1) * P + c] - la[t * P + c]);
    }
    __syncthreads();
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, j = i % N;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < N; ++c) acc += r[t * N + c] * st[c * N + j];
      for (int s = 0; s <= t; ++s) acc += sc[t * L + s] * v[s * N + j];
      Ob[(long long)(c0 + t) * so.s + j] = acc;
    }
    __syncthreads();
    for (int i = tid; i < N * N; i += kThreads) {
      const int c = i / N, j = i % N;
      float acc = expf(la[(L - 1) * P + c]) * st[i];
#pragma unroll 8
      for (int s = 0; s < L; ++s) acc += k[s * P + c] * v[s * N + j];
      st[i] = acc;
    }
    __syncthreads();
  }
}

template <typename Kern>
int allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <int N, int L>
int launch_v1(const float* r, const float* k, const float* v, const float* w, const float* u, float* o, int B, int H,
              int S, Strides sr, Strides sk, Strides sv, Strides sw, Strides so, long long ub, long long uh,
              cudaStream_t stream) {
  auto kernel = wkv6_cuda_cores_kernel<N, L>;
  constexpr size_t smem = Smem<N, L>::bytes;
  if (int e = allow_smem(kernel, smem)) return e;
  kernel<<<dim3(B * H), kThreads, smem, stream>>>(r, k, v, w, u, o, H, S, sr, sk, sv, sw, so, ub, uh);
  return int(cudaGetLastError());
}

// ===========================================================================
// the chunk-parallel kernels
// ===========================================================================

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSub = 16;  // steps of a sub-chunk: the rows of one warp's m16 products

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x by the special-function unit (relative error about 2^-22); 0 for
// x = -inf and wherever the result would be subnormal.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A flag in global memory, read and written at the card's scope.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Rows 0..rows-1 of one (batch, head)'s operand, ``ss`` floats apart in
// global memory, into shared rows ``pitch`` floats apart.
template <int N>
__device__ __forceinline__ void stage_rows(float* dst, int pitch, const float* src, long long ss, int rows, bool vec,
                                           int tid, int nthreads) {
  if (vec) {
    constexpr int Q = N / 4;
    for (int i = tid; i < rows * Q; i += nthreads) {
      const int t = i / Q, q = i - t * Q;
      cp_async16(dst + t * pitch + 4 * q, src + t * ss + 4 * q);
    }
  } else {
    for (int i = tid; i < rows * N; i += nthreads) {
      const int t = i / N, c = i - t * N;
      cp_async4(dst + t * pitch + c, src + t * ss + c);
    }
  }
}

// e^x for x <= 0 by the special-function unit, 2^(x log2 e).
__device__ __forceinline__ float expn(float x) { return ex2(x * kLog2e); }

// VW (2 or 4) floats at ``src`` (16- or 8-byte aligned).
template <int VW>
__device__ __forceinline__ void load_vec(const float* src, float (&x)[VW]) {
  if constexpr (VW == 4) {
    const float4 p = *reinterpret_cast<const float4*>(src);
    x[0] = p.x, x[1] = p.y, x[2] = p.z, x[3] = p.w;
  } else {
    const float2 p = *reinterpret_cast<const float2*>(src);
    x[0] = p.x, x[1] = p.y;
  }
}

// hi = x rounded to TF32 (to nearest, ties away: half an ulp of TF32 added
// to the bits, the 13 bits below it cleared) and lo = what hi leaves,
// rounded so too: hi + lo carries x to about 2^-23, without the bias the
// tensor cores' truncation of an unrounded lo would give.  Integer
// operations: the conversion instruction runs at a quarter of their rate.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// d (16 x 8) += a (16 x 8, row) b (8 x 8, col), TF32 operands, fp32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += the three products of two-term operands ("3xTF32"), the small ones
// first.  The tensor cores truncate their fp32 sums, so the three are
// summed from zero and added to d in fp32 registers (rounding to nearest):
// carried in the tensor cores over a long sum, the truncation becomes a
// bias.
// ``first``: d holds zeros, and takes the three products itself.
template <bool first = false>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  if constexpr (first) {
    mma_tf32(d, al, bh[0], bh[1]);
    mma_tf32(d, ah, bl[0], bl[1]);
    mma_tf32(d, ah, bh[0], bh[1]);
  } else {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma_tf32(t, al, bh[0], bh[1]);
    mma_tf32(t, ah, bl[0], bl[1]);
    mma_tf32(t, ah, bh[0], bh[1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += t[e];
  }
}

// An A fragment (16 x 8) from four values and a B fragment (8 x 8) from two.
__device__ __forceinline__ void split_a(float x0, float x1, float x2, float x3, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(x0, hi[0], lo[0]);
  split_tf32(x1, hi[1], lo[1]);
  split_tf32(x2, hi[2], lo[2]);
  split_tf32(x3, hi[3], lo[3]);
}
__device__ __forceinline__ void split_b(float x0, float x1, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  split_tf32(x0, hi[0], lo[0]);
  split_tf32(x1, hi[1], lo[1]);
}

// Fragment coordinates of lane ``lane`` (m16n8k8, TF32): g = lane / 4 and
// q = lane % 4.  An A fragment (16 x 8) holds rows g, g + 8 at columns q
// and q + 4 (registers: (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)); a
// B fragment (8 x 8) rows q and q + 4 at column g; an accumulator
// (16 x 8) rows g, g + 8 at columns 2q, 2q + 1.  So a thread reads row g of
// an operand stored [m or n][k] at column q, and row q of one stored
// [k][n] at column g: the first kind of array has rows n + 4 floats apart
// and the second n + 8, which puts the 32 lanes on 32 banks.

template <int N, int L>
struct ChunkSmem {
  static constexpr int PA = N + 4;  // r, k, la, lp, S^T: read [m or n][k]
  static constexpr int PV = N + 8;  // v: read [k][n]
  static constexpr int PS = L + 4;  // the scores: read [m][k]
  static constexpr int PK = N + 8;  // k * exp(la_L - la): read [k][n]
  static constexpr int r = 0;                   // L x PA
  static constexpr int k = r + L * PA;          // L x PA, then the lo terms of S^T (N x PA)
  static constexpr int la = k + (L > N ? L : N) * PA;  // L x PA, la of each step
  static constexpr int lp = la + L * PA;        // L x PA, lw, then la_prev = la - lw
  static constexpr int v = lp + L * PA;         // L x PV
  static constexpr int scx = L * PS > L * PK ? L * PS : L * PK;
  static constexpr int sc = v + L * PV;         // k~, then the scores, then S^T
  static constexpr int u = sc + (scx > N * PA ? scx : N * PA);  // N
  static constexpr int floats = u + N;
  static constexpr size_t bytes = size_t(floats) * sizeof(float);
};

// The 4 x 4 tiles of a sub-chunk's diagonal block below its diagonal:
// (a, b), b < a, each 16 pairs s < t.
__device__ __forceinline__ void full_tile(int u, int& a, int& b) {  // u in 0..5
  a = u < 1 ? 1 : (u < 3 ? 2 : 3);
  b = u - (a * (a - 1)) / 2;
}

// One launch, one block of 2 L / 16 warps per chunk (8192 at the eval
// shape).  Warps 2 i and 2 i + 1 own sub-chunk i, steps t0 = 16 i ..
// t0 + 15, and each half of the n columns.  The decays are taken as the
// JAX package's kernel takes them: la the cumulative sum of lw in order,
// la_prev = la - lw, exponentials of their differences.
//  * The chunk's state term U^T = v^T k~ on the tensor cores, in registers.
//  * The walk: a block takes its chunk c of (batch, head) bh by a ticket
//    in chunk-major order (every (batch, head)'s chunk c before any chunk
//    c + 1), so it waits only for blocks that already run.  It reads the
//    state entering chunk c, which the block of chunk c - 1 publishes in
//    the ring ``Sring`` (B*H, 2, n, n), and publishes S_{c+1} =
//    exp(la_L) * S_c + U_c.  The walk costs a block one exchange of 16 KB
//    through L2, and no state term leaves the chip.  ``sync[0]`` is the
//    ticket counter, ``sync[1 + bh]`` the chunks of bh whose outgoing
//    state is published; zeros at the launch.
//  * The scores against the earlier sub-chunks (one n8 tile of a 16-step
//    block a warp, the blocks dealt evenly) on the tensor cores.
//  * The diagonal blocks on the CUDA cores, spread over all warps in 4 x 4
//    register tiles so each value read from shared memory serves 4 pairs:
//    the 6 tiles below each block's diagonal split 8 ways over the
//    channels, its 4 diagonal tiles (with the bonus) 4 ways; lanes combine
//    by shuffles.
//  * After a block barrier each warp takes scores v, then the inter-chunk
//    term (its operands split into TF32 terms once, in shared memory), for
//    its rows and columns.
template <int N, int L>
__global__ void __launch_bounds__(4 * L, 2)  // two blocks an SM: at most 128 registers a thread at L = 64
    wkv6_kernel_chunk(const float* __restrict__ R, const float* __restrict__ K, const float* __restrict__ V,
                      const float* __restrict__ W, const float* __restrict__ U, float* __restrict__ Sring,
                      int* __restrict__ sync, float* __restrict__ O, int BH, int H, int C, Strides sr, Strides sk,
                      Strides sv, Strides sw, Strides so, long long ub, long long uh, int vec) {
  using M = ChunkSmem<N, L>;
  constexpr int PA = M::PA, PV = M::PV, PS = M::PS, PK = M::PK;
  constexpr int NT = 4 * L;
  constexpr int NS = L / kSub;
  constexpr int NH = N / 16;  // n8 tiles of a half of the output columns
  extern __shared__ __align__(16) float smem[];
  __shared__ int ticket;
  float* r = smem + M::r;
  float* k = smem + M::k;
  float* la = smem + M::la;
  float* lp = smem + M::lp;
  float* v = smem + M::v;
  float* scr = smem + M::sc;
  float* u = smem + M::u;
  const int tid = threadIdx.x;
  if (tid == 0) ticket = atomicAdd(sync, 1);
  __syncthreads();
  if (ticket >= BH * C) return;  // a counter not zeroed at the launch: no chunk, and no wait
  const int ch = ticket / BH, bh = ticket - ch * BH;
  const int b = bh / H, h = bh - b * H;
  const long long row0 = (long long)ch * L;
  stage_rows<N>(lp, PA, W + b * sw.b + h * sw.h + row0 * sw.s, sw.s, L, vec, tid, NT);
  cp_async_commit();  // lw first: the cumulative sums start while the rest arrives
  stage_rows<N>(k, PA, K + b * sk.b + h * sk.h + row0 * sk.s, sk.s, L, vec, tid, NT);
  stage_rows<N>(v, PV, V + b * sv.b + h * sv.h + row0 * sv.s, sv.s, L, vec, tid, NT);
  stage_rows<N>(r, PA, R + b * sr.b + h * sr.h + row0 * sr.s, sr.s, L, vec, tid, NT);
  for (int c = tid; c < N; c += NT) cp_async4(u + c, U + b * ub + h * uh + c);
  cp_async_commit();
  cp_async_wait_group<1>();
  __syncthreads();
  // la: lw summed in order, one thread a channel; la_prev = la - lw
  if (tid < N) {
    float acc = 0.f;
#pragma unroll
    for (int t0 = 0; t0 < L; t0 += kSub) {
      float w[kSub];
#pragma unroll
      for (int t = 0; t < kSub; ++t) w[t] = lp[(t0 + t) * PA + tid];
#pragma unroll
      for (int t = 0; t < kSub; ++t) {
        acc += w[t];
        la[(t0 + t) * PA + tid] = acc;
        lp[(t0 + t) * PA + tid] = acc - w[t];
      }
    }
  }
  cp_async_wait_group<0>();
  __syncthreads();

  const int lane = tid & 31, wid = tid >> 5, g = lane >> 2, q = lane & 3;
  const int i = wid >> 1, half = wid & 1;
  const int t0 = kSub * i;
  const int ta = t0 + g, tb = ta + 8;  // this lane's two rows of the products
  const float* la_last = la + (L - 1) * PA;

  // ---- the chunk's state term U^T[j][c] = sum_s v[s][j] k~[s][c], with
  // k~ = k * exp(la_L - la) computed once into the scores' place, in items
  // of 16 rows j and half of the columns c, a warp's items in turn (one
  // each at n = L)
  constexpr int kItems = 2 * (N / 16);
  constexpr int IPW = (kItems + 2 * NS - 1) / (2 * NS);
  for (int e = tid; e < L * N; e += NT) {
    const int s = e / N, c = e - s * N;
    scr[s * PK + c] = k[s * PA + c] * expn(la_last[c] - la[s * PA + c]);
  }
  __syncthreads();
  float ut[IPW][NH][4];
#pragma unroll
  for (int it = 0; it < IPW; ++it)
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ut[it][nt][e] = 0.f;
#pragma unroll
  for (int it = 0; it < IPW; ++it) {
    const int item = wid + it * 2 * NS;
    if (item >= kItems) continue;
    const int ja = 16 * (item >> 1) + g, jb = ja + 8, hh = item & 1;
#pragma unroll
    for (int ks = 0; ks < L / 8; ++ks) {
      const float* v0 = v + (8 * ks + q) * PV;  // A[j][s] = v[s][j], rows s = 8 ks + q, + 4
      uint32_t ah[4], al[4];
      split_a(v0[ja], v0[jb], v0[4 * PV + ja], v0[4 * PV + jb], ah, al);
      const float* k0 = scr + (8 * ks + q) * PK;  // B[s][c] = k~[s][c]
#pragma unroll
      for (int nt = 0; nt < NH; ++nt) {
        const int c = 8 * (hh * NH + nt) + g;
        uint32_t bh2[2], bl2[2];
        split_b(k0[c], k0[4 * PK + c], bh2, bl2);
        if (ks == 0)
          mma3<true>(ut[it][nt], ah, al, bh2, bl2);
        else
          mma3(ut[it][nt], ah, al, bh2, bl2);
      }
    }
  }

  // ---- the walk's step, first half: wait for the state entering the
  // chunk, and load this thread's part of it from the ring, which the
  // scores leave time to arrive (k~ is read by now: the scores may
  // overwrite it)
  if (ch > 0 && tid == 0) {
    while (ld_acquire(sync + 1 + bh) < ch) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();
  float2 s_in[IPW][NH][2];
  {
    const float* ring_in = Sring + (size_t(bh) * 2 + ((ch - 1) & 1)) * N * N;
#pragma unroll
    for (int it = 0; it < IPW; ++it) {
      const int item = wid + it * 2 * NS;
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int j = 16 * (item >> 1) + g + 8 * e2, c = 8 * ((item & 1) * NH + nt) + 2 * q;
          s_in[it][nt][e2] = ch > 0 && item < kItems ? __ldcg(reinterpret_cast<const float2*>(ring_in + j * N + c))
                                                     : make_float2(0.f, 0.f);
        }
    }
  }

  // ---- scores of sub-chunk ri against earlier ones about the step
  // b = 16 ri - 1: (r * exp(la_prev - la_b)) (k * exp(la_b - la))^T, this
  // warp's n8 tile of the 16-step blocks jb in [jlo, jhi).  At L = 64 the
  // six blocks are dealt so that no pair of warps takes more than two:
  // pair 0 (3, 0), pair 1 (1, 0), pair 2 (2, 0) (2, 1), pair 3 (3, 1)
  // (3, 2); else pair i takes its own sub-chunk's.
  const int ri = NS == 4 ? (i == 1 ? 1 : (i == 2 ? 2 : 3)) : i;
  const int jlo = NS == 4 && i == 3 ? 1 : 0, jhi = NS == 4 ? (i == 0 ? 1 : ri) : i;
  if (jhi > jlo) {
    const int ra = kSub * ri + g, rb = ra + 8;  // this lane's two rows of the block
    const float* lb = la + (kSub * ri - 1) * PA;
    float sacc[NS][4];
#pragma unroll
    for (int jb = 0; jb < NS; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[jb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < N / 8; ++ks) {
      const int c0 = 8 * ks + q, c1 = c0 + 4;  // this lane's two channels
      const float l0 = lb[c0], l1 = lb[c1];
      uint32_t ah[4], al[4];
      split_a(r[ra * PA + c0] * expn(lp[ra * PA + c0] - l0), r[rb * PA + c0] * expn(lp[rb * PA + c0] - l0),
              r[ra * PA + c1] * expn(lp[ra * PA + c1] - l1), r[rb * PA + c1] * expn(lp[rb * PA + c1] - l1), ah, al);
#pragma unroll
      for (int jb = 0; jb < NS; ++jb) {
        if (jb < jlo || jb >= jhi) continue;
        const int s = kSub * jb + 8 * half + g;  // B[c][s] = k[s][c] exp(la_b - la_s)
        uint32_t bh2[2], bl2[2];
        split_b(k[s * PA + c0] * expn(l0 - la[s * PA + c0]), k[s * PA + c1] * expn(l1 - la[s * PA + c1]), bh2, bl2);
        if (ks == 0)
          mma3<true>(sacc[jb], ah, al, bh2, bl2);
        else
          mma3(sacc[jb], ah, al, bh2, bl2);
      }
    }
#pragma unroll
    for (int jb = 0; jb < NS; ++jb) {
      if (jb < jlo || jb >= jhi) continue;
      const int col = kSub * jb + 8 * half + 2 * q;
      *reinterpret_cast<float2*>(scr + ra * PS + col) = make_float2(sacc[jb][0], sacc[jb][1]);
      *reinterpret_cast<float2*>(scr + rb * PS + col) = make_float2(sacc[jb][2], sacc[jb][3]);
    }
  }

  // ---- the diagonal blocks on the CUDA cores, 4 x 4 register tiles over
  // a range of channels: threads 0 .. 16 NS - 1 the diagonal tiles (4 a
  // tile), one exponential per pair, the rest the tiles below the diagonal
  // (8 threads a tile), factored about the column tile's last step as the
  // blocks below the diagonal are; the scores against earlier sub-chunks
  // go to other entries
  constexpr int kDiag = 16 * NS;  // threads on the diagonal tiles: the first ones
  const bool split_warp = kDiag % 32 != 0 && wid == kDiag / 32;  // at L = 16 warp 0 holds both kinds
  if (tid >= kDiag) {
    const unsigned mask = split_warp ? 0xffff0000u : 0xffffffffu;
    constexpr int CW = N / 8;  // channels a thread
    constexpr int VW = CW >= 4 ? 4 : 2;
    const int unit = (tid - kDiag) >> 3, part = tid & 7;
    const int ti = unit / 6;
    int a, bb;
    full_tile(unit - 6 * ti, a, bb);
    const int tr = kSub * ti + 4 * a, tc = kSub * ti + 4 * bb;  // first row t and column s
    float acc[4][4] = {};
#pragma unroll
    for (int c0 = 0; c0 < CW; c0 += VW) {
      const int c = part * CW + c0;
      float rv[4][VW], lt[4][VW], kv[4][VW], ls[4][VW];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        load_vec<VW>(r + (tr + x) * PA + c, rv[x]);
        load_vec<VW>(lp + (tr + x) * PA + c, lt[x]);
        load_vec<VW>(k + (tc + x) * PA + c, kv[x]);
        load_vec<VW>(la + (tc + x) * PA + c, ls[x]);
      }
#pragma unroll
      for (int e = 0; e < VW; ++e) {  // about m = tc + 3: exp(la_prev_t - la_m) exp(la_m - la_s), both <= 1
        float at[4], bs[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) at[x] = rv[x][e] * expn(lt[x][e] - ls[3][e]);
#pragma unroll
        for (int y = 0; y < 3; ++y) bs[y] = kv[y][e] * expn(ls[3][e] - ls[y][e]);
        bs[3] = kv[3][e];
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(at[x], bs[y], acc[x][y]);
      }
    }
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y)
#pragma unroll
        for (int m = 4; m > 0; m >>= 1) acc[x][y] += __shfl_xor_sync(mask, acc[x][y], m);
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y)
        if (2 * x + (y >> 1) == part) scr[(tr + x) * PS + tc + y] = acc[x][y];  // two of the 16 a thread
  } else {
    const unsigned mask = split_warp ? 0x0000ffffu : 0xffffffffu;
    constexpr int CW = N / 4;  // channels a thread
    const int unit = tid >> 2, part = tid & 3;
    const int t4 = kSub * (unit >> 2) + 4 * (unit & 3);  // the tile's first step
    float acc[10] = {};  // pairs (1,0) (2,0) (2,1) (3,0) (3,1) (3,2), then the bonus of rows 0..3
#pragma unroll
    for (int c0 = 0; c0 < CW; c0 += 4) {
      const int c = part * CW + c0;
      float rv[4][4], kv[4][4], lt[4][4], ls[4][4], uv[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        load_vec<4>(r + (t4 + x) * PA + c, rv[x]);
        load_vec<4>(k + (t4 + x) * PA + c, kv[x]);
        load_vec<4>(lp + (t4 + x) * PA + c, lt[x]);
        load_vec<4>(la + (t4 + x) * PA + c, ls[x]);
      }
      load_vec<4>(u + c, uv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int p = 0;
#pragma unroll
        for (int x = 1; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < x; ++y, ++p) acc[p] = fmaf(rv[x][e] * kv[y][e], expn(lt[x][e] - ls[y][e]), acc[p]);
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[6 + x] = fmaf(rv[x][e] * uv[e], kv[x][e], acc[6 + x]);
      }
    }
#pragma unroll
    for (int p = 0; p < 10; ++p)
#pragma unroll
      for (int m = 2; m > 0; m >>= 1) acc[p] += __shfl_xor_sync(mask, acc[p], m);
    int p = 0;
#pragma unroll
    for (int x = 1; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < x; ++y, ++p)
        if ((p & 3) == part) scr[(t4 + x) * PS + t4 + y] = acc[p];
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (((6 + x) & 3) == part) scr[(t4 + x) * PS + t4 + x] = acc[6 + x];
  }

  // ---- the walk's step, second half: S_{c+1} = exp(la_L) * S_c + U_c to
  // the ring, published once the block's barrier has passed
  if (ch + 1 < C) {
    float* ring_out = Sring + (size_t(bh) * 2 + (ch & 1)) * N * N;
#pragma unroll
    for (int it = 0; it < IPW; ++it) {
      const int item = wid + it * 2 * NS;
      if (item >= kItems) continue;
#pragma unroll
      for (int nt = 0; nt < NH; ++nt)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int j = 16 * (item >> 1) + g + 8 * e2, c = 8 * ((item & 1) * NH + nt) + 2 * q;
          const float2 x = s_in[it][nt][e2];
          *reinterpret_cast<float2*>(ring_out + j * N + c) =
              make_float2(fmaf(expn(la_last[c]), x.x, ut[it][nt][2 * e2]),
                          fmaf(expn(la_last[c + 1]), x.y, ut[it][nt][2 * e2 + 1]));
        }
    }
    __threadfence();
  }
  __syncthreads();
  if (ch + 1 < C && tid == 0) st_release(sync + 1 + bh, ch + 1);  // the state entering chunk ch + 1

  // r * exp(la_prev), the A of the inter-chunk term, split once into its
  // TF32 terms: hi in r's place, lo in la's (la and k are read by now);
  // the sub-chunk's two warps take its rows
  uint32_t* a_hi = reinterpret_cast<uint32_t*>(r);
  uint32_t* a_lo = reinterpret_cast<uint32_t*>(la);
  for (int e = tid & 63; e < kSub * N; e += 64) {
    const int t = t0 + e / N, c = e % N;
    split_tf32(r[t * PA + c] * expn(lp[t * PA + c]), a_hi[t * PA + c], a_lo[t * PA + c]);
  }

  float o[NH][4];
#pragma unroll
  for (int nt = 0; nt < NH; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  // ---- o += scores v over the 16-step blocks up to the diagonal, A from
  // the shared scores (s > t on the diagonal block: zero)
#pragma unroll
  for (int ks = 0; ks < 2 * NS; ++ks) {
    if (ks > 2 * i + 1) continue;  // 8-column steps up to the diagonal block's
    const int s0 = 8 * ks + q, s1 = s0 + 4;  // this lane's two columns
    float x[4] = {scr[ta * PS + s0], scr[tb * PS + s0], scr[ta * PS + s1], scr[tb * PS + s1]};
    if (ks >= 2 * i) {  // the diagonal block: s > t holds no score
      x[0] = s0 <= ta ? x[0] : 0.f;
      x[1] = s0 <= tb ? x[1] : 0.f;
      x[2] = s1 <= ta ? x[2] : 0.f;
      x[3] = s1 <= tb ? x[3] : 0.f;
    }
    uint32_t ah[4], al[4];
    split_a(x[0], x[1], x[2], x[3], ah, al);
#pragma unroll
    for (int nt = 0; nt < NH; ++nt) {
      const int j = 8 * (half * NH + nt) + g;  // B[s][j] = v[s][j]
      uint32_t bh2[2], bl2[2];
      split_b(v[s0 * PV + j], v[s1 * PV + j], bh2, bl2);
      if (ks == 0)
        mma3<true>(o[nt], ah, al, bh2, bl2);
      else
        mma3(o[nt], ah, al, bh2, bl2);
    }
  }

  // ---- the state entering the chunk to shared memory, split once into
  // its TF32 terms: hi in the scores' place once every warp has read them,
  // lo in k's
  __syncthreads();
  uint32_t* b_hi = reinterpret_cast<uint32_t*>(scr);  // N x PA, S^T
  uint32_t* b_lo = reinterpret_cast<uint32_t*>(k);
#pragma unroll
  for (int it = 0; it < IPW; ++it) {
    const int item = wid + it * 2 * NS;
    if (item >= kItems) continue;
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int j = 16 * (item >> 1) + g + 8 * e2, c = 8 * ((item & 1) * NH + nt) + 2 * q;
        uint2 hi, lo;
        split_tf32(s_in[it][nt][e2].x, hi.x, lo.x);
        split_tf32(s_in[it][nt][e2].y, hi.y, lo.y);
        *reinterpret_cast<uint2*>(b_hi + j * PA + c) = hi;
        *reinterpret_cast<uint2*>(b_lo + j * PA + c) = lo;
      }
  }
  __syncthreads();

  // ---- inter-chunk: o += (r * exp(la_prev)) S, this warp's columns
#pragma unroll
  for (int ks = 0; ks < N / 8; ++ks) {
    const int c0 = 8 * ks + q, c1 = c0 + 4;
    const uint32_t ah[4] = {a_hi[ta * PA + c0], a_hi[tb * PA + c0], a_hi[ta * PA + c1], a_hi[tb * PA + c1]};
    const uint32_t al[4] = {a_lo[ta * PA + c0], a_lo[tb * PA + c0], a_lo[ta * PA + c1], a_lo[tb * PA + c1]};
#pragma unroll
    for (int nt = 0; nt < NH; ++nt) {
      const int j = 8 * (half * NH + nt) + g;  // B[c][j] = S^T[j][c]
      const uint32_t bh2[2] = {b_hi[j * PA + c0], b_hi[j * PA + c1]};
      const uint32_t bl2[2] = {b_lo[j * PA + c0], b_lo[j * PA + c1]};
      mma3(o[nt], ah, al, bh2, bl2);
    }
  }

  // ---- store rows ta, tb, this warp's columns
  float* oa = O + b * so.b + h * so.h + (row0 + ta) * so.s;
  float* ob = oa + 8 * so.s;
#pragma unroll
  for (int nt = 0; nt < NH; ++nt) {
    const int j = 8 * (half * NH + nt) + 2 * q;
    if (vec) {
      *reinterpret_cast<float2*>(oa + j) = make_float2(o[nt][0], o[nt][1]);
      *reinterpret_cast<float2*>(ob + j) = make_float2(o[nt][2], o[nt][3]);
    } else {
      oa[j] = o[nt][0];
      oa[j + 1] = o[nt][1];
      ob[j] = o[nt][2];
      ob[j + 1] = o[nt][3];
    }
  }
}

template <int N, int L>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u, float* o, float* ring,
           int* sync, int B, int H, int S, Strides sr, Strides sk, Strides sv, Strides sw, Strides so, long long ub,
           long long uh, int vec, cudaStream_t stream) {
  const int C = S / L;
  auto kernel = wkv6_kernel_chunk<N, L>;
  if (int e = allow_smem(kernel, ChunkSmem<N, L>::bytes)) return e;
  kernel<<<B * H * C, 4 * L, ChunkSmem<N, L>::bytes, stream>>>(r, k, v, w, u, ring, sync, o, B * H, H, C, sr, sk,
                                                                  sv, sw, so, ub, uh, vec);
  return int(cudaGetLastError());
}

// The kernel family <N, L> for runtime n and chunk.
template <template <int, int> class F, typename... A>
int dispatch(int n, int chunk, A... args) {
#define WKV6_CASE(NN, LL) \
  if (n == NN && chunk == LL) return F<NN, LL>::run(args...);
  WKV6_CASE(16, 16) WKV6_CASE(16, 32) WKV6_CASE(16, 64)
  WKV6_CASE(32, 16) WKV6_CASE(32, 32) WKV6_CASE(32, 64)
  WKV6_CASE(64, 16) WKV6_CASE(64, 32) WKV6_CASE(64, 64)
#undef WKV6_CASE
  return int(cudaErrorInvalidValue);
}

template <int N, int L>
struct RunChunked {
  template <typename... A>
  static int run(A... args) { return launch<N, L>(args...); }
};
template <int N, int L>
struct RunV1 {
  template <typename... A>
  static int run(A... args) { return launch_v1<N, L>(args...); }
};

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

// The chunk-parallel K5.  r, k, v, logw, out: (B, H, S, n) fp32 addressed by
// (batch, head, sequence) strides in elements, unit stride along n; u:
// (B, H, n) by (ub, uh); scratch, contiguous: ring (B*H, 2, n, n) fp32 and
// sync (1 + B*H,) int32 zeros.  One launch.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* logw, const void* u, void* out, void* ring,
             void* sync, int B, int H, int S, int n, int chunk, long long rb, long long rh, long long rs,
             long long kb, long long kh, long long ks, long long vb, long long vh, long long vs, long long wb,
             long long wh, long long ws, long long ob, long long oh, long long os, long long ub, long long uh,
             void* stream) {
  if (chunk <= 0 || S % chunk != 0) return int(cudaErrorInvalidValue);
  const Strides sr{rb, rh, rs}, sk{kb, kh, ks}, sv{vb, vh, vs}, sw{wb, wh, ws}, so{ob, oh, os};
  bool vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(logw) && aligned16(out);
  for (long long x : {rb, rh, rs, kb, kh, ks, vb, vh, vs, wb, wh, ws, ob, oh, os}) vec = vec && x % 4 == 0;
  return dispatch<RunChunked>(n, chunk, static_cast<const float*>(r), static_cast<const float*>(k),
                              static_cast<const float*>(v), static_cast<const float*>(logw),
                              static_cast<const float*>(u), static_cast<float*>(out), static_cast<float*>(ring),
                              static_cast<int*>(sync), B, H, S, sr, sk, sv, sw, so, ub, uh, int(vec),
                              static_cast<cudaStream_t>(stream));
}

// v1, the yardstick: arguments as wkv6_fwd without the scratch.  One launch.
int wkv6_fwd_cuda_cores(const void* r, const void* k, const void* v, const void* logw, const void* u, void* out,
                        int B, int H, int S, int n, int chunk, long long rb, long long rh, long long rs, long long kb,
                        long long kh, long long ks, long long vb, long long vh, long long vs, long long wb,
                        long long wh, long long ws, long long ob, long long oh, long long os, long long ub,
                        long long uh, void* stream) {
  if (chunk <= 0 || S % chunk != 0) return int(cudaErrorInvalidValue);
  const Strides sr{rb, rh, rs}, sk{kb, kh, ks}, sv{vb, vh, vs}, sw{wb, wh, ws}, so{ob, oh, os};
  return dispatch<RunV1>(n, chunk, static_cast<const float*>(r), static_cast<const float*>(k),
                         static_cast<const float*>(v), static_cast<const float*>(logw), static_cast<const float*>(u),
                         static_cast<float*>(out), B, H, S, sr, sk, sv, sw, so, ub, uh,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
