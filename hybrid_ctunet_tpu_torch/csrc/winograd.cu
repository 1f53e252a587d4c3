// Stride-1 SAME 3x3x3 convolution of an NDHWC bf16 tensor via Winograd
// F(2,3)^3, with an optional per-(b, c) affine + LeakyReLU on the input and
// optional per-(b, f) sums of y and y^2 of the output (the fused form).
//
// Replaces hybrid_ctunet_tpu/ops/winograd_pallas.py:_conv_impl (both entry
// points, conv3x3_winograd and conv3x3_winograd_fused). What it computes is
// the TPU kernel's; its z-pair lane fold and _folded_filter are TPU lane
// machinery and are not carried over. Numerics (the port's plain version,
// ops/winograd.py): U = G g G^T is computed in fp32 and rounded to bf16 by
// the wrapper; V = B^T d B is formed in fp32 from the bf16 input (after the
// affine, itself rounded to bf16) and rounded to bf16; the 64 position
// products run on the tensor cores with fp32 accumulation and fold at once
// into the eight fp32 output accumulators (A^T entries 0, +-1); the output
// is rounded once. The sums are taken over the fp32 accumulators.
//
// Bound: operations. The direct conv's 2*27*C*F FLOP per output voxel
// against 2*(C + F) bytes moved: at the path's (4,48,48,96,32) -> 32, 48.9
// GFLOP (0.049 ms at 989 TFLOP/s) against 113 MB (0.034 ms at 3.35 TB/s).
// Design: a block owns 4x4x4 tiles of 2x2x2 outputs (64 GEMM rows) and 32
// output features. It copies its halo'd 10^3 x 32 input slab into shared
// memory with cp.async (zeros at the SAME border; the affine in place after
// the copy), then per x-row a of B^T: every thread forms V for the 16
// positions (a, b, c) of a (tile, channel pair) separably in registers and
// stores them as bf16 (64 tiles x 32 channels per position); each of 8 warps
// then runs, per position, a 16-tile x 32-channel by 32 x 16-feature WMMA
// product (U read from L2) and adds it into its eight output accumulators
// with the A^T signs. The accumulators are staged through shared memory for
// 16-byte bf16 stores and for the sums, which each block writes per feature
// and a second launch combines over blocks in a fixed order (no float
// atomics: a rerun is bit-identical).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int C = 32;                  // input channels
constexpr int TB = 4;                  // tiles per block along each axis
constexpr int NT = TB * TB * TB;       // 64 tiles: GEMM rows
constexpr int FC = 32;                 // output features per block
constexpr int THREADS = 256;           // 8 warps: 4 row groups x 2 feature groups
constexpr int S = 2 * TB + 2;          // halo'd slab edge, 10 voxels
constexpr int LDS = C + 8;             // slab voxel stride (bf16): 80 bytes
constexpr int LDV = C + 8;             // V row stride (bf16)
constexpr int SLAB = S * S * S * LDS;  // bf16 elements
constexpr int VBUF = 16 * NT * LDV;    // bf16 elements: V of 16 positions
constexpr int LDU = FC + 8;            // U row stride (bf16)
constexpr int UBUF = 16 * C * LDU;     // bf16 elements: this block's U of 16 positions
constexpr int SMEM = (SLAB + VBUF + UBUF) * 2;
static_assert(NT * 8 * FC * 4 <= VBUF * 2, "output staging must fit the V buffer");
static_assert(2 * 8 * FC * 4 <= SLAB * 2, "sum staging must fit the slab");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]
__device__ __forceinline__ float at(int o, int a) {
  return o == 0 ? (a < 3 ? 1.f : 0.f) : (a == 0 ? 0.f : (a == 1 ? 1.f : -1.f));
}

// one row of B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] on four values
__device__ __forceinline__ float2 bt(int r, float2 d0, float2 d1, float2 d2, float2 d3) {
  switch (r) {
    case 0: return make_float2(d0.x - d2.x, d0.y - d2.y);
    case 1: return make_float2(d1.x + d2.x, d1.y + d2.y);
    case 2: return make_float2(d2.x - d1.x, d2.y - d1.y);
    default: return make_float2(d1.x - d3.x, d1.y - d3.y);
  }
}

__device__ __forceinline__ bool in_range(int ix, int iy, int iz, int X, int Y, int Z) {
  return ix >= 0 && ix < X && iy >= 0 && iy < Y && iz >= 0 && iz < Z;
}

__global__ void __launch_bounds__(THREADS, 1)
    wino_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u, bf16* __restrict__ y,
                const float* __restrict__ scale, const float* __restrict__ bias, int act,
                float* __restrict__ part, int X, int Y, int Z, int F, int nby, int nbz) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sSlab = reinterpret_cast<bf16*>(smem);
  bf16* sV = sSlab + SLAB;
  bf16* sU = sV + VBUF;
  const int b = blockIdx.z, f0 = blockIdx.y * FC;
  const int bz = blockIdx.x % nbz, by = (blockIdx.x / nbz) % nby, bx = blockIdx.x / (nbz * nby);
  const int tx0 = bx * TB, ty0 = by * TB, tz0 = bz * TB;
  const int ix0 = 2 * tx0 - 1, iy0 = 2 * ty0 - 1, iz0 = 2 * tz0 - 1;  // slab origin
  const long long vb = (long long)b * X * Y * Z;  // first voxel of this sample

  // 1. the halo'd slab, 16 bytes (8 channels) a copy; zeros outside the volume
  for (int i = threadIdx.x; i < S * S * S * 4; i += THREADS) {
    const int q = i & 3, v = i >> 2;
    const int ix = ix0 + v / (S * S), iy = iy0 + (v / S) % S, iz = iz0 + v % S;
    bf16* dst = sSlab + v * LDS + q * 8;
    if (in_range(ix, iy, iz, X, Y, Z))
      cp_async16(dst, x + (vb + ((long long)ix * Y + iy) * Z + iz) * C + q * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();
  cp_async_wait_all();
  if (scale != nullptr) {
    // the previous InstanceNorm's affine (+ LeakyReLU) on the copies this
    // thread made, rounded to bf16; the border stays zero
    for (int i = threadIdx.x; i < S * S * S * 4; i += THREADS) {
      const int q = i & 3, v = i >> 2;
      if (!in_range(ix0 + v / (S * S), iy0 + (v / S) % S, iz0 + v % S, X, Y, Z)) continue;
      uint4* p = reinterpret_cast<uint4*>(sSlab + v * LDS + q * 8);
      uint4 raw = *p;
      bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = q * 8 + k;
        float t = __bfloat162float(e[k]) * scale[b * C + c] + bias[b * C + c];
        if (act && !(t > 0.f)) t = 0.01f * t;
        e[k] = __float2bfloat16(t);
      }
      *p = raw;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, wr = warp >> 1, wc = warp & 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int o = 0; o < 8; ++o) wmma::fill_fragment(acc[o], 0.f);

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    // U of the 16 positions (a, b, c), this block's 32 features, copied
    // while V is formed
    for (int i = threadIdx.x; i < 16 * C * (FC / 8); i += THREADS) {
      const int q = i % (FC / 8), r = i / (FC / 8);  // r = position * C + channel
      cp_async16(sU + r * LDU + q * 8, u + ((long long)a * 16 * C + r) * F + f0 + q * 8);
    }
    cp_async_commit();
    // 2. V of the 16 positions (a, b, c): per (tile, channel pair) the x row
    //    a of B^T on two planes, then the y and z transforms, in fp32
    const int i1 = a == 2 ? 2 : (a == 0 ? 0 : 1);
    const int i2 = a == 0 ? 2 : (a == 1 ? 2 : (a == 2 ? 1 : 3));
    const float s2 = a == 1 ? 1.f : -1.f;
    for (int it = threadIdx.x; it < NT * (C / 2); it += THREADS) {
      const int cp = it % (C / 2), t = it / (C / 2);
      const int ti = t / (TB * TB), tj = (t / TB) % TB, tk = t % TB;
      const bf16* base = sSlab + ((2 * ti * S + 2 * tj) * S + 2 * tk) * LDS + 2 * cp;
      float2 t1[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 d1 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(base + ((i1 * S + j) * S + k) * LDS));
          const float2 d2 = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(base + ((i2 * S + j) * S + k) * LDS));
          t1[j][k] = make_float2(d1.x + s2 * d2.x, d1.y + s2 * d2.y);
        }
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        float2 t2[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) t2[k] = bt(bb, t1[0][k], t1[1][k], t1[2][k], t1[3][k]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float2 v = bt(cc, t2[0], t2[1], t2[2], t2[3]);
          *reinterpret_cast<__nv_bfloat162*>(sV + ((bb * 4 + cc) * NT + t) * LDV + 2 * cp) =
              __floats2bfloat162_rn(v.x, v.y);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // 3. per position: (16 tiles x 32 ch) @ (32 ch x 16 features) on the
    //    tensor cores, added into the eight outputs with the A^T signs
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa0, fa1;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb0, fb1;
      const bf16* va = sV + (q * NT + wr * 16) * LDV;
      wmma::load_matrix_sync(fa0, va, LDV);
      wmma::load_matrix_sync(fa1, va + 16, LDV);
      const bf16* up = sU + q * C * LDU + wc * 16;
      wmma::load_matrix_sync(fb0, up, LDU);
      wmma::load_matrix_sync(fb1, up + 16 * LDU, LDU);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> m;
      wmma::fill_fragment(m, 0.f);
      wmma::mma_sync(m, fa0, fb0, m);
      wmma::mma_sync(m, fa1, fb1, m);
      const int bb = q >> 2, cc = q & 3;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float coef = at(o >> 2, a) * at((o >> 1) & 1, bb) * at(o & 1, cc);
        if (coef > 0.f) {
#pragma unroll
          for (int e = 0; e < m.num_elements; ++e) acc[o].x[e] += m.x[e];
        } else if (coef < 0.f) {
#pragma unroll
          for (int e = 0; e < m.num_elements; ++e) acc[o].x[e] -= m.x[e];
        }
      }
    }
    __syncthreads();  // the next row a rewrites V
  }

  // 4. stage the fp32 outputs [tile][o][feature] over V, store bf16
  float* sOut = reinterpret_cast<float*>(sV);
#pragma unroll
  for (int o = 0; o < 8; ++o)
    wmma::store_matrix_sync(sOut + (wr * 16 * 8 + o) * FC + wc * 16, acc[o], 8 * FC,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < NT * 8 * (FC / 8); i += THREADS) {
    const int ch = i % (FC / 8), o = (i / (FC / 8)) % 8, t = i / (8 * (FC / 8));
    const int ox = 2 * (tx0 + t / (TB * TB)) + (o >> 2);
    const int oy = 2 * (ty0 + (t / TB) % TB) + ((o >> 1) & 1);
    const int oz = 2 * (tz0 + t % TB) + (o & 1);
    if (ox >= X || oy >= Y || oz >= Z) continue;  // a tile past the volume's edge
    const float* src = sOut + (t * 8 + o) * FC + ch * 8;
    uint4 packed;
    bf16* vals = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16(src[e]);
    *reinterpret_cast<uint4*>(y + (vb + ((long long)ox * Y + oy) * Z + oz) * F + f0 + ch * 8) =
        packed;
  }

  // 5. the block's sums of y and y^2 per feature, in a fixed order
  if (part != nullptr) {
    float* red = reinterpret_cast<float*>(sSlab);  // [2][8 groups][FC]
    const int f = threadIdx.x % FC, g = threadIdx.x / FC;
    float s1 = 0.f, s2 = 0.f;
    for (int t = g * (NT / 8); t < (g + 1) * (NT / 8); ++t) {
      if (2 * (tx0 + t / (TB * TB)) >= X || 2 * (ty0 + (t / TB) % TB) >= Y ||
          2 * (tz0 + t % TB) >= Z)
        continue;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float v = sOut[(t * 8 + o) * FC + f];
        s1 += v;
        s2 += v * v;
      }
    }
    red[g * FC + f] = s1;
    red[(8 + g) * FC + f] = s2;
    __syncthreads();
    if (threadIdx.x < FC) {
      float a1 = 0.f, a2 = 0.f;
      for (int gg = 0; gg < 8; ++gg) {
        a1 += red[gg * FC + threadIdx.x];
        a2 += red[(8 + gg) * FC + threadIdx.x];
      }
      float* out = part + ((long long)b * gridDim.x + blockIdx.x) * 2 * F + f0 + threadIdx.x;
      out[0] = a1;
      out[F] = a2;
    }
  }
}

// one block per (b, 32 features), 32 x 32 threads: row g sums the partials of
// blocks g, g + 32, ... in order, then row 0 adds the 32 row sums in order
__global__ void wino_stats_combine(const float* __restrict__ part, float* __restrict__ stats,
                                   int nblk, int F) {
  __shared__ float red[2][32][33];
  const int b = blockIdx.x, f = blockIdx.y * 32 + threadIdx.x, g = threadIdx.y;
  float a1 = 0.f, a2 = 0.f;
  for (int k = g; k < nblk; k += 32) {
    const float* p = part + ((long long)b * nblk + k) * 2 * F;
    a1 += p[f];
    a2 += p[F + f];
  }
  red[0][g][threadIdx.x] = a1;
  red[1][g][threadIdx.x] = a2;
  __syncthreads();
  if (g != 0) return;
  float s1 = 0.f, s2 = 0.f;
  for (int r = 0; r < 32; ++r) {
    s1 += red[0][r][threadIdx.x];
    s2 += red[1][r][threadIdx.x];
  }
  stats[(long long)b * 2 * F + f] = s1;
  stats[(long long)b * 2 * F + F + f] = s2;
}

// x: (B, X, Y, Z, 32) bf16, X, Y, Z even; u: (64, 32, F) bf16, U = G g G^T
// per position (a*16 + b*4 + c); y: (B, X, Y, Z, F) bf16, F a multiple of 32;
// scale, bias: (B, 32) fp32 or null (no affine); work: null (no sums) or
// fp32 of B*nblk*2*F (partials) + B*2*F (the sums: s1 then s2 per sample).
extern "C" int conv3x3_winograd(const void* x, const void* u, void* y, const void* scale,
                                const void* bias, int act, void* work, int B, int X, int Y,
                                int Z, int F, void* stream) {
  if (B < 1 || B > 65535 || X < 2 || Y < 2 || Z < 2 || X % 2 || Y % 2 || Z % 2 || F < FC ||
      F % FC || (scale == nullptr) != (bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)y) % 16 || (size_t)u % 32) return (int)cudaErrorMisalignedAddress;
  const int nbx = (X / 2 + TB - 1) / TB, nby = (Y / 2 + TB - 1) / TB, nbz = (Z / 2 + TB - 1) / TB;
  const long long nblk = (long long)nbx * nby * nbz;
  if (nblk > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(wino_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  float* part = (float*)work;
  wino_kernel<<<dim3((unsigned)nblk, F / FC, B), THREADS, SMEM, s>>>(
      (const bf16*)x, (const bf16*)u, (bf16*)y, (const float*)scale, (const float*)bias, act,
      part, X, Y, Z, F, nby, nbz);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  wino_stats_combine<<<dim3(B, F / 32), dim3(32, 32), 0, s>>>(
      part, part + (long long)B * nblk * 2 * F, (int)nblk, F);
  return (int)cudaGetLastError();
}
