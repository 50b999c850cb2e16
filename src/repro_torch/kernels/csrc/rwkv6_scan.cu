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
// What bounds it on the card: the operations.  At rwkv6-7b's eval shape
// (4 x 64 heads, S = 2048, n = L = 64) it reads r, k, v, logw and writes
// the output once (671 MB, 0.20 ms at 3.35 TB/s) but does about 15 GFLOP
// of fp32 (0.22 ms at 67 TFLOP/s) and 1.1 G exponentials, most of them in
// the pairwise scores (L (L - 1) / 2 pairs by n channels per chunk).
//
// Design (not carried over from the Pallas grid, whose chunk axis revisits
// a VMEM scratch holding the state): one thread block of 256 threads per
// (batch, head) walks its chunks in order, the state resident in shared
// memory from the first chunk to the last.  Per chunk it stages r, k, v and
// lw in shared memory, takes the cumulative sums (one thread per channel),
// computes the scores for s < t only (the Pallas kernel computes exp for
// every pair and masks afterwards; on the card exp of a large positive
// exponent is inf and inf * 0 is NaN, so s >= t is skipped, and s = t takes
// the bonus u instead of a decay), decays r and k in place, writes the
// outputs and updates the state in place.  Rows of k and la are padded by
// one float so that the threads of a warp, which walk 32 consecutive s,
// read 32 banks.  At n = L = 64 that is about 113 KB of dynamic shared
// memory (one block per SM).  Every operand is taken with its batch, head
// and sequence strides, so the model's (B, S, H, n) layout needs no
// transposed copy.  Tensor cores are not used: a simple first version.
//
// Entry point: a plain C interface (loaded with ctypes) that returns
// cudaGetLastError() after the launch.  The caller guarantees n and L in
// {16, 32, 64}, S a multiple of L, unit stride along n.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Strides {
  long long b, h, s;
};

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

template <int N, int L>
__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const float* __restrict__ R, const float* __restrict__ K, const float* __restrict__ V,
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
    // stage the chunk
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, c = i % N;
      const long long row = c0 + t;
      r[i] = Rb[row * sr.s + c];
      k[t * P + c] = Kb[row * sk.s + c];
      v[i] = Vb[row * sv.s + c];
      lp[i] = Wb[row * sw.s + c];
    }
    __syncthreads();
    // cumulative log-decays, one thread per channel
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
    // scores: strictly lower pairs decayed, the bonus on the diagonal
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
    // decay r by exp(la_prev) and k by exp(la_last - la), in place
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, c = i % N;
      r[i] *= expf(lp[i]);
      k[t * P + c] *= expf(la[(L - 1) * P + c] - la[t * P + c]);
    }
    __syncthreads();
    // outputs: the inter-chunk term through the state, then the scores
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, j = i % N;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < N; ++c) acc += r[t * N + c] * st[c * N + j];
      for (int s = 0; s <= t; ++s) acc += sc[t * L + s] * v[s * N + j];
      Ob[(long long)(c0 + t) * so.s + j] = acc;
    }
    __syncthreads();
    // state update, each element by the thread that owns it
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

template <int N, int L>
int launch(const float* r, const float* k, const float* v, const float* w, const float* u, float* o,
           int B, int H, int S, Strides sr, Strides sk, Strides sv, Strides sw, Strides so,
           long long ub, long long uh, cudaStream_t stream) {
  auto kernel = wkv6_kernel<N, L>;
  constexpr size_t smem = Smem<N, L>::bytes;
  if (smem > 48 * 1024) {
    if (int e = int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))))
      return e;
  }
  kernel<<<dim3(B * H), kThreads, smem, stream>>>(r, k, v, w, u, o, H, S, sr, sk, sv, sw, so, ub, uh);
  return int(cudaGetLastError());
}

template <int N>
int dispatch_chunk(int chunk, const float* r, const float* k, const float* v, const float* w,
                   const float* u, float* o, int B, int H, int S, Strides sr, Strides sk,
                   Strides sv, Strides sw, Strides so, long long ub, long long uh, cudaStream_t st) {
  switch (chunk) {
    case 16: return launch<N, 16>(r, k, v, w, u, o, B, H, S, sr, sk, sv, sw, so, ub, uh, st);
    case 32: return launch<N, 32>(r, k, v, w, u, o, B, H, S, sr, sk, sv, sw, so, ub, uh, st);
    case 64: return launch<N, 64>(r, k, v, w, u, o, B, H, S, sr, sk, sv, sw, so, ub, uh, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// r, k, v, logw, out: (B, H, S, n) fp32 addressed by (batch, head, sequence)
// strides in elements, unit stride along n; u: (B, H, n) by (ub, uh).
int wkv6_fwd(const void* r, const void* k, const void* v, const void* logw, const void* u, void* out,
             int B, int H, int S, int n, int chunk, long long rb, long long rh, long long rs,
             long long kb, long long kh, long long ks, long long vb, long long vh, long long vs,
             long long wb, long long wh, long long ws, long long ob, long long oh, long long os,
             long long ub, long long uh, void* stream) {
  const Strides sr{rb, rh, rs}, sk{kb, kh, ks}, sv{vb, vh, vs}, sw{wb, wh, ws}, so{ob, oh, os};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *R = static_cast<const float*>(r), *K = static_cast<const float*>(k);
  const float *V = static_cast<const float*>(v), *W = static_cast<const float*>(logw);
  const float* U = static_cast<const float*>(u);
  float* O = static_cast<float*>(out);
  if (S % chunk != 0) return int(cudaErrorInvalidValue);
  switch (n) {
    case 16: return dispatch_chunk<16>(chunk, R, K, V, W, U, O, B, H, S, sr, sk, sv, sw, so, ub, uh, st);
    case 32: return dispatch_chunk<32>(chunk, R, K, V, W, U, O, B, H, S, sr, sk, sv, sw, so, ub, uh, st);
    case 64: return dispatch_chunk<64>(chunk, R, K, V, W, U, O, B, H, S, sr, sk, sv, sw, so, ub, uh, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // extern "C"
