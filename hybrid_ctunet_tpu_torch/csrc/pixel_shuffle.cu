// Anisotropic 3D pixel shuffle fused with the per-voxel Linear C' -> F:
// out[b, x*f0+i, y*f1+j, z*f2+k, :] = bias + sum_c' x[b, x, y, z, c] W[:, c']
// with c = ((c'*f0 + i)*f1 + j)*f2 + k (C' slowest, the reference reshape).
//
// Replaces hybrid_ctunet_tpu/ops/shuffle_pallas.py:_impl (_kernel), the
// Pallas kernel behind fused_pixel_shuffle. Numerics follow
// reference_shuffle: bf16 x bf16 products summed in fp32, rounded to bf16,
// then the bf16 bias added and rounded.
//
// Bound: memory. K = C' is 32-96 on TUNet's pyramid, so the GEMM is ~2*C'
// FLOP per output byte pair; the unfused path writes the 8-D transpose of
// the input to device memory and reads it back before the matmul.
// Design: a GEMM with M = input voxels x (f0 f1 f2) sub-positions, K = C',
// N = F. A block takes 64/(f0 f1 f2) input voxels — 64 GEMM rows — and a
// 64-wide slice of F. Its A-load reads each voxel's C channels once,
// coalesced, and gathers the strided channel slice of every sub-position
// into its own row in shared memory (no zero-padded K, unlike the TPU
// kernel's scattered weight). The product runs on the tensor cores (WMMA
// bf16, fp32 accumulate); the store writes each row's F-slice, contiguous,
// at its interleaved NDHWC position, 16 bytes a thread, from a per-row offset
// table computed once per block. No 8-D transpose reaches device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;  // GEMM rows per block
constexpr int BN = 64;  // output features per block
constexpr int THREADS = 128;
// shared-memory rows read by the tensor cores are padded by 16 bytes so the
// 16 rows of a fragment start in different banks
constexpr int PAD16 = 8;
constexpr int LDC = BN + 4;  // fp32 result rows

static size_t smem_bytes(int Cp) {
  return (size_t)(BM + BN) * (Cp + PAD16) * sizeof(bf16) + (size_t)BM * LDC * sizeof(float);
}

__global__ void __launch_bounds__(THREADS)
    pixel_shuffle_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                         const bf16* __restrict__ bias, bf16* __restrict__ out, long long V,
                         int X, int Y, int Z, int f0, int f1, int f2, int Cp, int F) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long sRow[BM];
  const int div = f0 * f1 * f2, VB = BM / div, C = Cp * div, LDA = Cp + PAD16;
  bf16* sA = reinterpret_cast<bf16*>(smem);    // [BM][LDA], row = s*VB + voxel
  bf16* sB = sA + BM * LDA;                    // [BN][LDA], W rows n0..n0+BN
  float* sC = reinterpret_cast<float*>(sB + BN * LDA);  // [BM][LDC]
  const long long v0 = (long long)blockIdx.x * VB;
  const int n0 = blockIdx.y * BN;

  // gather: 8 channels (16 B) per load; channel c = c'*div + s goes to row
  // s*VB + voxel, column c'
  for (int i = threadIdx.x; i < VB * C / 8; i += THREADS) {
    const int vl = i / (C / 8), c0 = (i % (C / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (v0 + vl < V) raw = *reinterpret_cast<const uint4*>(x + (v0 + vl) * C + c0);
    const bf16* vals = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + e;
      sA[((c % div) * VB + vl) * LDA + c / div] = vals[e];
    }
  }
  // output element offset of each GEMM row's first feature (-1: past the end)
  if (threadIdx.x < BM) {
    const int r = threadIdx.x, s = r / VB;
    const long long v = v0 + r % VB;
    long long o = -1;
    if (v < V) {
      const int zz = (int)(v % Z);
      long long t = v / Z;
      const int yy = (int)(t % Y);
      t /= Y;
      const int xx = (int)(t % X);
      const long long b = t / X;
      const int i0 = s / (f1 * f2), j0 = (s / f2) % f1, k0 = s % f2;
      o = ((((b * X + xx) * f0 + i0) * ((long long)Y * f1) + yy * f1 + j0) *
               ((long long)Z * f2) + zz * f2 + k0) * F;
    }
    sRow[r] = o;
  }
  for (int i = threadIdx.x; i < BN * Cp / 8; i += THREADS) {
    const int n = i / (Cp / 8), part = i % (Cp / 8);
    *reinterpret_cast<uint4*>(sB + n * LDA + part * 8) =
        *reinterpret_cast<const uint4*>(w + (long long)(n0 + n) * Cp + part * 8);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;  // row tile
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int kk = 0; kk < Cp / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, sA + warp * 16 * LDA + kk * 16, LDA);
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, sB + j * 16 * LDA + kk * 16, LDA);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 16; ++j)
    wmma::store_matrix_sync(sC + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
  __syncthreads();

  // store: 8 features (16 B) per thread, each row's slice contiguous
  for (int i = threadIdx.x; i < BM * BN / 8; i += THREADS) {
    const int r = i / (BN / 8), col = (i % (BN / 8)) * 8;
    const long long o = sRow[r];
    if (o < 0) continue;
    uint4 packed;
    bf16* vals = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float y = __bfloat162float(__float2bfloat16(sC[r * LDC + col + e]));
      vals[e] = __float2bfloat16(y + __bfloat162float(bias[n0 + col + e]));
    }
    *reinterpret_cast<uint4*>(out + o + n0 + col) = packed;
  }
}

// x: (B, X, Y, Z, C) bf16 with C = Cp*f0*f1*f2; w: (F, Cp) bf16 (torch Linear
// layout); bias: (F) bf16; out: (B, X*f0, Y*f1, Z*f2, F) bf16.
extern "C" int pixel_shuffle_linear(const void* x, const void* w, const void* bias, void* out,
                                    int B, int X, int Y, int Z, int f0, int f1, int f2,
                                    int Cp, int F, void* stream) {
  const int div = f0 * f1 * f2;
  if (div < 1 || BM % div || Cp % 16 || F % BN || B < 1) return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)w | (size_t)out) % 16) return (int)cudaErrorMisalignedAddress;
  const size_t smem = smem_bytes(Cp);
  cudaError_t err = cudaFuncSetAttribute(
      pixel_shuffle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long V = (long long)B * X * Y * Z;
  const int VB = BM / div;
  dim3 grid((unsigned)((V + VB - 1) / VB), F / BN);
  pixel_shuffle_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w, (const bf16*)bias, (bf16*)out, V, X, Y, Z, f0, f1, f2,
      Cp, F);
  return (int)cudaGetLastError();
}
