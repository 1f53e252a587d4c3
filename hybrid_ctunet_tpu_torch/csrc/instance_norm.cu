// Affine-free InstanceNorm over space of an NDHWC tensor (B, S, C), with an
// optional LeakyReLU: y = (x - mean) * rsqrt(var + eps), var clamped at 0.
//
// Replaces hybrid_ctunet_tpu/ops/norm_pallas.py:fused_instance_norm_pallas
// (its moments and normalize kernels). Numerics follow the JAX default path
// (ops/norm.py instance_norm, the port's plain version), not the Pallas
// kernel: single-pass fp32 sums of x and x^2, variance E[x^2] - E[x]^2
// clamped at 0, y rounded to bf16 before the LeakyReLU, whose product is
// rounded again.
//
// Bound: memory. Two reads of x and one write of y, bf16, against ~5 FLOP per
// element; the 4 x 96^3 x 64 calls of the full-resolution ResBlocks move
// 1.36 GB.
// Design: three launches on one stream.
//  1. Statistics: grid (splits, B). A block owns a contiguous run of rows of
//     one sample; each thread reads 8 channels (16 bytes) of a row and steps
//     over the run, keeping fp32 partial sums in registers; the block sums its
//     threads' partials in shared memory in a fixed order and writes one
//     partial (sum x, sum x^2) per channel to the workspace. The wrapper picks
//     the split count from B, S and C (about four blocks per SM, at least four
//     row steps per block), so the 6x6x12 calls stay small and the 96^3 calls
//     fill the card.
//  2. Combine: one thread per (b, c) sums the splits in order (no float
//     atomics: a run is reproducible) and writes mean and rstd.
//  3. Normalize: a grid-stride pass per sample, 16-byte loads and stores,
//     each thread's channel group and its statistics fixed in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    in_stats_kernel(const bf16* __restrict__ x, float* __restrict__ part, long long S, int C,
                    int splits) {
  __shared__ float red[2][THREADS * 8];
  const int CV = C / 8, RPI = THREADS / CV;
  const int cv = threadIdx.x % CV, rr = threadIdx.x / CV;
  const int sp = blockIdx.x, b = blockIdx.y;
  const long long chunk = (S + splits - 1) / splits;
  const long long r0 = sp * chunk, r1 = r0 + chunk < S ? r0 + chunk : S;
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;
  if (rr < RPI) {
    const bf16* base = x + (long long)b * S * C + cv * 8;
    for (long long r = r0 + rr; r < r1; r += RPI) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + r * C);
      const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float f = __bfloat162float(v[e]);
        s1[e] += f;
        s2[e] += f * f;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[0][threadIdx.x * 8 + e] = s1[e];
    red[1][threadIdx.x * 8 + e] = s2[e];
  }
  __syncthreads();
  // thread (rr, cv) wrote channels cv*8.. at red[.][(rr*CV + cv)*8 + e], i.e.
  // red[.][rr*C + c]: sum over rr in order
  float* out = part + ((long long)b * splits + sp) * 2 * C;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float a1 = 0.f, a2 = 0.f;
    for (int q = 0; q < RPI; ++q) {
      a1 += red[0][q * C + c];
      a2 += red[1][q * C + c];
    }
    out[c] = a1;
    out[C + c] = a2;
  }
}

__global__ void in_combine_kernel(const float* __restrict__ part, float* __restrict__ stats,
                                  int B, long long S, int C, int splits, float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  float a1 = 0.f, a2 = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* p = part + ((long long)b * splits + sp) * 2 * C;
    a1 += p[c];
    a2 += p[C + c];
  }
  const float n = (float)S;
  const float mean = a1 / n;
  const float var = fmaxf(a2 / n - mean * mean, 0.f);
  stats[(long long)b * 2 * C + c] = mean;
  stats[(long long)b * 2 * C + C + c] = rsqrtf(var + eps);
}

// grid (blocks, B); the grid stride is a multiple of C/8, so each thread
// keeps one group of 8 channels and their mean and rstd in registers
__global__ void __launch_bounds__(THREADS)
    in_normalize_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                        const float* __restrict__ stats, long long S, int C, int act,
                        float slope) {
  const int CV = C / 8;
  const long long b = blockIdx.y;
  const long long Vb = S * CV;  // 16-byte vectors per sample
  const long long stride = (long long)gridDim.x * THREADS;
  long long j = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int c0 = (int)(j & (CV - 1)) * 8;  // CV is a power of two
  float mean[8], rstd[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mean[e] = stats[b * 2 * C + c0 + e];
    rstd[e] = stats[b * 2 * C + C + c0 + e];
  }
  const uint4* xv = reinterpret_cast<const uint4*>(x + b * S * C);
  uint4* yv = reinterpret_cast<uint4*>(y + b * S * C);
  for (; j < Vb; j += stride) {
    const uint4 raw = xv[j];
    const bf16* v = reinterpret_cast<const bf16*>(&raw);
    uint4 packed;
    bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      bf16 yb = __float2bfloat16((__bfloat162float(v[e]) - mean[e]) * rstd[e]);
      if (act) {
        const float f = __bfloat162float(yb);
        if (f < 0.f) yb = __float2bfloat16(f * slope);
      }
      o[e] = yb;
    }
    yv[j] = packed;
  }
}

// x, y: (B, S, C) bf16, C % 8 == 0 and (C / 8) dividing 256; work: fp32
// workspace of B*splits*2*C (partials) + B*2*C (mean, rstd) floats.
extern "C" int instance_norm(const void* x, void* y, void* work, int B, long long S, int C,
                             int splits, float eps, int act, float slope, void* stream) {
  if (B < 1 || S < 1 || C < 8 || C % 8 || THREADS % (C / 8) || splits < 1 || splits > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)y) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  float* part = (float*)work;
  float* stats = part + (long long)B * splits * 2 * C;
  in_stats_kernel<<<dim3(splits, B), THREADS, 0, s>>>((const bf16*)x, part, S, C, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  in_combine_kernel<<<(B * C + THREADS - 1) / THREADS, THREADS, 0, s>>>(part, stats, B, S, C,
                                                                        splits, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // about 16 blocks per SM over the whole call
  long long blocks = (S * (C / 8) + THREADS - 1) / THREADS;
  const long long cap = (132 * 16 + B - 1) / B;
  if (blocks > cap) blocks = cap;
  in_normalize_kernel<<<dim3((unsigned)blocks, B), THREADS, 0, s>>>(
      (const bf16*)x, (bf16*)y, stats, S, C, act, slope);
  return (int)cudaGetLastError();
}
