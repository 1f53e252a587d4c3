// Hopper (sm_90a) building blocks shared by the wgmma kernels (ffn.cu,
// transp_conv.cu, conv3x3.cu): mbarriers, bulk and tensor (TMA) copies,
// wgmma descriptors and the wgmma forms they issue, written as inline PTX.
//
// Shared-memory operands are K-major bf16 tiles: with the 128-byte swizzle,
// rows of 64 elements (128 B), 8-row atoms of 1024 B, the 16-byte chunk c of
// row r stored at chunk c ^ (r % 8), a tile starting on a 1024-byte
// boundary; with the 32-byte swizzle (conv3x3.cu), rows of 16 elements
// (32 B), the two 16-byte chunks of a row swapped where address bit 7 is
// set; or without swizzle (conv3x3.cu), core matrices of 8 rows x 8
// elements, a row's 16 bytes right after the previous row's.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of element (row, k) of a swizzled K-major tile of 64-wide rows
__device__ __forceinline__ uint32_t swz(int row, int k) {
  return (uint32_t)(row * 128 + ((((k >> 3) ^ row) & 7) << 4) + (k & 7) * 2);
}

// ---- mbarriers ----
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed; a wait of 2^35
// cycles (~17 s) can only be a pipeline fault, and traps rather than hangs
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    if (clock64() - t0 > (1ll << 35)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// ---- bulk copies ----
// global -> shared, `bytes` a multiple of 16, completion counted on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// shared -> global, in a bulk group of this thread
__device__ __forceinline__ void bulk_s2g(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and have completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// start bringing `bytes` (a multiple of 16) at src into L2
__device__ __forceinline__ void bulk_prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}
// 2D tensor-map load of one box at (c0 innermost, c1)
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tmap, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(tmap), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
// 5D tensor-map load of one box at (c0 innermost, ..., c4); coordinates may
// lie outside the tensor, and the box's elements there are filled with zeros
__device__ __forceinline__ void tma_load_5d(void* dst, const void* tmap, int c0, int c1, int c2,
                                            int c3, int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_addr(dst)),
      "l"(tmap), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4), "r"(smem_addr(bar))
      : "memory");
}
// make this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma operands, bulk stores)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier over the `threads` threads of named barrier `id` (1..15)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ----
// descriptor of a K-major, 128-byte-swizzled tile: 8-row groups 1024 B apart
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
// descriptor of a K-major tile without swizzle: core matrices (8 rows of 16
// B, back to back) `lbo` bytes apart along K and `sbo` bytes apart along
// M or N
__device__ __forceinline__ uint64_t desc_plain(const void* tile, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}
// descriptor of a K-major tile with the 32-byte swizzle: rows of 32 B (k 0-15),
// 8-row groups `sbo` bytes apart. The swizzle acts on the address bits
// themselves, so the tile may start at any 32-byte row of a buffer that TMA
// filled with the same swizzle from a 1024-byte boundary
__device__ __forceinline__ uint64_t desc_sw32(const void* tile, uint32_t sbo) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(sbo >> 4) << 32) | (3ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of a register across an
// asynchronous wgmma's issue or wait
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// D[64x64] (+)= A[64x16] B[16x64]^T, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_64x64_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x48] (+)= A[64x16] B[16x48]^T, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_64x48_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(accumulate));
}

#define SM90_D64(i)                                                                         \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),           \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7]), "+f"(d[i + 8]), "+f"(d[i + 9]),       \
      "+f"(d[i + 10]), "+f"(d[i + 11]), "+f"(d[i + 12]), "+f"(d[i + 13]), "+f"(d[i + 14]),  \
      "+f"(d[i + 15])
#define SM90_REGS64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// D[64x128] (+)= A[64x16] B[16x128]^T, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_64x128_ss(float* d, uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_D64(0), SM90_D64(16), SM90_D64(32), SM90_D64(48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64x128] (+)= A[64x16] B[16x128]^T, A from registers (the accumulator
// layout of a 64-row wgmma, packed to bf16 pairs), B from shared memory
__device__ __forceinline__ void wgmma_64x128_rs(float* d, const uint32_t* a, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : SM90_D64(0), SM90_D64(16), SM90_D64(32), SM90_D64(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
#undef SM90_D64
#undef SM90_REGS64

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// SMs of the current device: a persistent grid's size
inline int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace sm90
