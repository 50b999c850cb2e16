// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// mbarriers, cluster barriers and distributed shared memory, TMA tensor
// maps and loads (rank 2 and rank 4), wgmma
// shared-memory descriptors (K-major and MN-major), fences and the fp16 and
// bf16 products.  Header only; every function is inline.
//
// Conventions.  Shared-memory addresses are 32-bit addresses in the shared
// window (``smem_addr``).  Operand tiles carry the 128-byte swizzle: each
// row of a tile is 128 bytes (128 fp8 or 64 16-bit values), eight rows form
// a 1024-byte swizzle atom, and a tile starts on a 1024-byte boundary.  TMA
// writes that layout (CU_TENSOR_MAP_SWIZZLE_128B with a 128-byte inner box).
// A tile whose rows run along k is K-major (``smem_desc``); one whose rows
// run along m or n, with k from row to row, is MN-major (``smem_desc_mn``).
//
// libcuda's cuTensorMapEncodeTiled is looked up at run time through the
// CUDA runtime's entry-point query, so a library that includes this header
// links against the runtime only (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------------------
// shared memory and mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive and announce ``bytes`` of TMA traffic that will complete the phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Barrier ``id`` (1..15; 0 is __syncthreads) over ``threads`` threads.
__device__ __forceinline__ void named_barrier(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16 bytes to shared memory at ``addr``.
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// ---------------------------------------------------------------------------
// thread-block clusters
// ---------------------------------------------------------------------------

// Every thread of every block of the cluster arrives, then waits for all:
// shared-memory writes before it are visible to the cluster after it.
// Called by whole, converged warps.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The address of ``addr`` (this block's shared window) in the shared
// memory of the cluster's block ``rank``.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// 2-D tile load: the box at (c0 inner, c1 outer) of the tensor map into
// shared memory at ``dst``, completing ``bar``'s transaction bytes.  Parts of
// the box outside the tensor are filled with zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// 4-D tile load: the box at (c0 innermost, c1, c2, c3) of the tensor map,
// as ``tma_load_2d``.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// Tensor map of a row-major byte matrix (rows, cols) with ``ld`` bytes
// between rows (a multiple of 16), read in boxes of ``box_rows`` x 128 bytes
// with the 128-byte swizzle.  ``dtype`` names the element type to TMA (the
// swizzle only sees bytes).  Returns false if the encoding is refused.
inline bool encode_kmajor_sw128(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                                uint64_t ld, uint32_t box_rows, uint32_t elem_bytes,
                                CUtensorMapDataType dtype) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {ld};
  const cuuint32_t box[2] = {128u / elem_bytes, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map of a rank-4 tensor with extents ``dims`` (innermost first, the
// innermost of unit stride) and byte strides ``strides`` of dims 1..3 (each
// a multiple of 16), read in boxes of 128 bytes x ``box[0]`` x ``box[1]`` x
// ``box[2]`` with the 128-byte swizzle: in shared memory, rows of 128 bytes,
// dim 1 fastest.  Parts of a box past an extent, the innermost included,
// are filled with zeros.  Returns false if the encoding is refused.
inline bool encode_rank4_sw128(CUtensorMap* map, const void* base, const uint64_t (&dims)[4],
                               const uint64_t (&strides)[3], const uint32_t (&box)[3], uint32_t elem_bytes,
                               CUtensorMapDataType dtype) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t b[4] = {128u / elem_bytes, box[0], box[1], box[2]};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return fn(map, dtype, 4, const_cast<void*>(base), d, st, b, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Descriptor of a K-major operand tile with the 128-byte swizzle at shared
// address ``addr``: 8-row groups 1024 bytes apart (stride byte offset), the
// leading byte offset unused by this layout (1 by convention).  Moving along
// k inside a 128-byte row adds its byte offset to ``addr``.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// Descriptor of an MN-major operand tile with the 128-byte swizzle at
// ``addr``: each 128-byte row holds 64 values along m (or n) at one k, rows
// are consecutive k; 8-row groups (k) are 1024 bytes apart (stride byte
// offset) and the next 64 values along m or n start ``mn_stride`` bytes on
// (leading byte offset).  Moving 16 along k adds 2048 bytes to ``addr``.
// wgmma reads such a tile as B of a 16-bit product with the transpose bit.
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr, uint32_t mn_stride) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((mn_stride >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous products that own them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The 32 accumulator operands of an m64n64 product, as inline-asm lists.
#define HOPPER_D32_STR                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define HOPPER_D32_OPS(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// The 64 accumulator operands of an m64n128 product, as inline-asm lists.
#define HOPPER_D64_STR                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                     \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "            \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "            \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define HOPPER_D64_OPS(d)                                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),             \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),             \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),             \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),             \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),             \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),             \
      "+f"(d[62]), "+f"(d[63])

// d (64 x 128, fp32) = A (64 x 16) B^T (128 x 16) [+ d if accumulate], fp16
// operands: A from registers, a0..a3 this thread's fragment of the 64 x 16
// tile (``a_frag_row``), two values each; B K-major in shared memory.  The
// products are exact; the tensor cores sum them in fp32 with truncation.
__device__ __forceinline__ void wgmma_m64n128k16_f16_rs(float (&d)[64], uint32_t a0, uint32_t a1,
                                                        uint32_t a2, uint32_t a3, uint64_t db,
                                                        int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " HOPPER_D64_STR
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : HOPPER_D64_OPS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) = A (64 x 16) B^T (64 x 16) [+ d if accumulate], bf16
// operands, both K-major in shared memory (``smem_desc``).  The products
// are exact; the tensor cores sum them in fp32 with truncation.
__device__ __forceinline__ void wgmma_m64n64k16_bf16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                        int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_STR
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D32_OPS(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, fp32) = A (64 x 16) B (16 x 64) [+ d if accumulate], bf16
// operands: A from registers (``a_frag_row``), B MN-major in shared memory
// (``smem_desc_mn``: 16 rows of k, each 64 values of n), read with the
// transpose bit.
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs_mn(float (&d)[32], uint32_t a0, uint32_t a1,
                                                           uint32_t a2, uint32_t a3, uint64_t db,
                                                           int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32_STR
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D32_OPS(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// The same at n = 128, two MN-major 64-column tiles ``mn_stride`` bytes
// apart (the descriptor's leading byte offset): d0 takes columns 0..63 and
// d1 columns 64..127, each in the m64n64 layout.
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs_mn(float (&d0)[32], float (&d1)[32], uint32_t a0,
                                                            uint32_t a1, uint32_t a2, uint32_t a3, uint64_t db,
                                                            int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HOPPER_D64_STR
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_D32_OPS(d0), HOPPER_D32_OPS(d1)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// The A fragment from registers, for the thread with index ``t`` in its
// warpgroup: register r (0..3) holds the two values of row
// (t >> 5) * 16 + ((t & 31) >> 2) + 8 * (r & 1) at k = 2 * (t & 3) + 8 * (r >> 1)
// and the next k.
__device__ __forceinline__ int a_frag_row(int t, int r) { return (t >> 5) * 16 + ((t & 31) >> 2) + 8 * (r & 1); }

// Row and column, within the 64 x n tile, of accumulator register i of
// the thread with index ``t`` in its warpgroup (0..127).  Registers
// 8 j + 2 r and 8 j + 2 r + 1 hold the two values of A fragment register r
// (``a_frag_row``) of k16 step j of a product whose A is this tile, so an
// accumulator feeds the next product without leaving the registers.
__device__ __forceinline__ int acc_row(int t, int i) { return (t >> 5) * 16 + ((t & 31) >> 2) + 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int acc_col(int t, int i) { return (i >> 2) * 8 + (t & 3) * 2 + (i & 1); }

// ---------------------------------------------------------------------------
// warp specialisation
// ---------------------------------------------------------------------------

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

}  // namespace hopper
