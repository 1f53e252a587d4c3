// Bias-free kernel == stride ConvTranspose3d as one GEMM with an
// interleaving store:
// out[b, x*k0+i, y*k1+j, z*k2+l, co] = sum_ci x[b, x, y, z, ci] W[ci, co, i, j, l]
//
// Replaces hybrid_ctunet_tpu/ops/shuffle_pallas.py:_impl as reached through
// fused_transp_conv (the factor-dot kernel with a dense per-factor weight).
// Numerics follow reference_transp_kxs: bf16 x bf16 products summed in fp32,
// rounded to bf16 once.
//
// Bound: at the four decoder sites of CUNet/CTUNet (Cin -> Cout 1024->512,
// 512->256, 256->128 at stride 2^3; 128->64 at (2,2,1)) the GEMM does
// 2*Cin FLOP per output element against 2 bytes written, so the deep sites
// are operation-bound and the full-resolution 128->64 site is bound by its
// 113 MB input and 453 MB output (4 windows).
// Design: M = input voxels, K = Cin, N = (k0 k1 k2) x Cout, the weight
// pre-arranged by the wrapper as N rows of K. A block computes a 64 x 64 tile
// whose columns lie inside one sub-position's Cout slice (Cout % 64 == 0), so
// every output row of the tile is 64 contiguous features at one interleaved
// NDHWC position, stored 16 bytes a thread from a per-row offset table. The
// grid is the flat (M tiles x N tiles) product with N fastest, so the small-M
// 6x6x12 site (M 1728, N 4096) still launches 1728 blocks. K streams in
// steps of 32 through a two-stage cp.async ring; four warps each own a
// 32 x 32 quadrant on the tensor cores (WMMA bf16, fp32 accumulate).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;  // voxels (GEMM rows) per block
constexpr int BN = 64;  // output features per block
constexpr int BK = 32;  // input channels per K step
constexpr int THREADS = 128;
constexpr int LDK = BK + 8;  // smem row length: 16 bytes of padding against bank conflicts
constexpr int LDC = BN + 4;  // fp32 staging row length
constexpr int STAGE = (BM + BN) * LDK;  // bf16 elements per ring stage
constexpr int SMEM = 2 * STAGE * 2 > BM * LDC * 4 ? 2 * STAGE * 2 : BM * LDC * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(THREADS)
    transp_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       bf16* __restrict__ out, long long M, int X, int Y, int Z, int k0,
                       int k1, int k2, int K, int Cout) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ long long sRow[BM];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int N = k0 * k1 * k2 * Cout, ntiles = N / BN;
  const long long m0 = (long long)(blockIdx.x / ntiles) * BM;
  const int n0 = (blockIdx.x % ntiles) * BN;

  // output element offset of each row's voxel at sub-position 0 (-1: past M)
  const long long Xo = (long long)X * k0, Yo = (long long)Y * k1, Zo = (long long)Z * k2;
  if (threadIdx.x < BM) {
    const long long m = m0 + threadIdx.x;
    long long o = -1;
    if (m < M) {
      const long long zz = m % Z, t = m / Z;
      const long long yy = t % Y, t2 = t / Y;
      const long long xx = t2 % X, b = t2 / X;
      o = (((b * Xo + xx * k0) * Yo + yy * k1) * Zo + zz * k2) * Cout;
    }
    sRow[threadIdx.x] = o;
  }
  // this block's sub-position (i, j, l) and first feature inside its slice
  const int s = n0 / Cout, co0 = n0 % Cout;
  const int si = s / (k1 * k2), sj = (s / k2) % k1, sl = s % k2;
  const long long sub = ((si * Yo + sj) * Zo + sl) * Cout + co0;

  // stage loads: A 64 x 32 and B 64 x 32, 16 bytes per copy, 2 + 2 per thread;
  // rows past M re-read row M-1 (their results are never stored)
  auto load = [&](int stage, int kk) {
    bf16* sA = ring + stage * STAGE;
    bf16* sB = sA + BM * LDK;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = threadIdx.x + u * THREADS, r = i / (BK / 8), part = i % (BK / 8);
      long long m = m0 + r;
      if (m >= M) m = M - 1;
      cp_async16(sA + r * LDK + part * 8, x + m * K + kk + part * 8);
      cp_async16(sB + r * LDK + part * 8, w + (long long)(n0 + r) * K + kk + part * 8);
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x / 32, wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  const int KT = K / BK;
  load(0, 0);
  for (int kt = 0; kt < KT; ++kt) {
    if (kt + 1 < KT) {
      load((kt + 1) & 1, (kt + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sA = ring + (kt & 1) * STAGE;
    const bf16* sB = sA + BM * LDK;
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wmma::load_matrix_sync(fa[a], sA + (wm * 32 + a * 16) * LDK + k16 * 16, LDK);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wmma::load_matrix_sync(fb[b], sB + (wn * 32 + b * 16) * LDK + k16 * 16, LDK);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
    __syncthreads();  // the next iteration's load overwrites this stage
  }

  float* sC = reinterpret_cast<float*>(smem);  // [BM][LDC], over the ring
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      wmma::store_matrix_sync(sC + (wm * 32 + a * 16) * LDC + wn * 32 + b * 16, acc[a][b], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), col = (i % (BN / 8)) * 8;
    const long long o = sRow[r];
    if (o < 0) continue;
    uint4 packed;
    bf16* vals = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(sC[r * LDC + col + e]);
    *reinterpret_cast<uint4*>(out + o + sub + col) = packed;
  }
}

// x: (B, X, Y, Z, K) bf16; w: (k0, k1, k2, Cout, K) bf16 (the torch
// ConvTranspose3d weight (K, Cout, k0, k1, k2) permuted so each GEMM column
// is one contiguous row of K); out: (B, X*k0, Y*k1, Z*k2, Cout) bf16.
extern "C" int transp_conv_kxs(const void* x, const void* w, void* out, int B, int X, int Y,
                               int Z, int k0, int k1, int k2, int K, int Cout, void* stream) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || k0 < 1 || k1 < 1 || k2 < 1 || K % BK || K < BK ||
      Cout % BN)
    return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)w | (size_t)out) % 16) return (int)cudaErrorMisalignedAddress;
  const long long M = (long long)B * X * Y * Z;
  const long long blocks = ((M + BM - 1) / BM) * ((long long)k0 * k1 * k2 * Cout / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  transp_conv_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (bf16*)out, M, X, Y, Z, k0, k1, k2, K, Cout);
  return (int)cudaGetLastError();
}
