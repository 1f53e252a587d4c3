// Affine-free InstanceNorm over space of an NDHWC tensor (B, S, C), with an
// optional LeakyReLU: y = (x - mean) * rsqrt(var + eps), var clamped at 0.
//
// Replaces hybrid_ctunet_tpu/ops/norm_pallas.py:fused_instance_norm_pallas
// (its moments and normalize kernels). Numerics follow the JAX default path
// (ops/norm.py instance_norm, the port's plain version), not the Pallas
// kernel: single-pass fp32 sums of x and x^2, variance E[x^2] - E[x]^2
// clamped at 0, y rounded to bf16 before the LeakyReLU, whose product is
// rounded again. Every sum is taken in a fixed order with no float atomics,
// so a rerun is bit for bit the same.
//
// Bound: memory, one read of x and one write of y (bf16) against ~5 FLOP an
// element. The conv paths call it at 16 shapes, from 4 x 6x6x12 x 1024
// (3.5 MB) to 4 x 96^3 x 64 (453 MB), so the design splits by what one
// sample's channel slab needs (ops/norm.py plan() chooses):
//
// - On chip, one launch (`in_onchip_kernel`). A cluster of k <= 8 CTAs owns
//   one sample's slab of 64 channels (each row piece a whole 128-byte line)
//   over all of S, in k consecutive row ranges of at most 108 KB each (two
//   CTAs an SM). Each thread loads its
//   16-byte row pieces, eight in flight, sums them and keeps them in shared
//   memory; the CTA reduces its sums (lanes, then warps, in order), the
//   cluster sums its CTAs' partials in rank order through distributed shared
//   memory, and each CTA normalizes its rows from shared memory. x is read
//   once. Taken by every site of 12x12x24 and below, where a call lasts a
//   few microseconds and the two passes' extra launch and reread cost most.
// - Large, two launches. Statistics: grid (splits, B); a block owns a
//   contiguous run of rows of one sample, a thread 8 channels (16 bytes) of
//   a row, eight rows in flight, with fp32 sums in registers; the block sums
//   its threads in order and writes one partial per channel. Normalize:
//   block (sp, b) first reduces sample b's partials in split order (the
//   combine, folded in), then walks the rows of statistics block (sp, b)
//   from the last, so that it first finds in L2 what that block read last.
//   x is read twice: a floor of 1.5x the bound, less what L2 keeps.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_SLAB = 110592;  // bytes of x a CTA holds on chip (ops/norm.py SLAB_BYTES)
constexpr int MAX_C = 2048;
constexpr int BATCH = 8;  // 16-byte loads a thread keeps in flight

__device__ __forceinline__ void stats_of(float s1, float s2, long long S, float eps, float* mean,
                                         float* rstd) {
  const float n = (float)S;
  const float m = s1 / n;
  *mean = m;
  *rstd = rsqrtf(fmaxf(s2 / n - m * m, 0.f) + eps);
}

__device__ __forceinline__ void add8(uint4 raw, float* s1, float* s2) {
  const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float f = __bfloat162float(v[e]);
    s1[e] += f;
    s2[e] += f * f;
  }
}

// 8 channels: bf16((x - mean) * rstd), then bf16(y * slope) where y < 0
__device__ __forceinline__ uint4 normalize8(uint4 raw, const float* mean, const float* rstd,
                                            int act, float slope) {
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
  return packed;
}

// ---------------------------------------------------------------------------
// On chip: grid (k, C / CG, B), cluster (k, 1, 1); CTA q of the cluster holds
// rows [q * rows, (q + 1) * rows) of channels [CG * blockIdx.y, + CG) of
// sample blockIdx.z; dynamic shared memory rows * CG * 2 bytes.
constexpr int CG = 64;  // channels of an on-chip slab: 128 bytes a row
__global__ void __launch_bounds__(THREADS)
    in_onchip_kernel(const bf16* __restrict__ x, bf16* __restrict__ y, long long S, int C,
                     int rows, float eps, int act, float slope) {
  constexpr int CV = CG / 8;         // 16-byte pieces of a row
  constexpr int RPI = THREADS / CV;  // rows a pass of the block covers
  extern __shared__ uint4 slab[];    // [rows][CV]
  __shared__ float wred[2][WARPS][CG];
  __shared__ float part[2][CG];
  __shared__ float stat[2][CG];
  cg::cluster_group cluster = cg::this_cluster();

  const long long r0 = (long long)blockIdx.x * rows;
  const int n = (int)max(0LL, min((long long)rows, S - r0));
  const int cv = threadIdx.x % CV, rr = threadIdx.x / CV;
  const bf16* src = x + ((long long)blockIdx.z * S + r0) * C + blockIdx.y * CG + cv * 8;
  bf16* dst = y + ((long long)blockIdx.z * S + r0) * C + blockIdx.y * CG + cv * 8;

  // 1. the CTA's rows into shared memory, BATCH loads in flight a thread,
  //    each summed on its way
  float s1[8], s2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.f;
  for (int rb = rr; rb < n; rb += BATCH * RPI) {
    uint4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = rb + u * RPI;
      if (r < n) v[u] = __ldg(reinterpret_cast<const uint4*>(src + (long long)r * C));
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = rb + u * RPI;
      if (r < n) {
        slab[r * CV + cv] = v[u];
        add8(v[u], s1, s2);
      }
    }
  }

  // 2. the CTA's partial: lanes holding the same channels (a butterfly, so
  //    every lane ends with the same bits), then the warps in order
#pragma unroll
  for (int off = CV; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
      s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
    }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < CV)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      wred[0][warp][lane * 8 + e] = s1[e];
      wred[1][warp][lane * 8 + e] = s2[e];
    }
  __syncthreads();
  if (threadIdx.x < CG) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a1 += wred[0][w][threadIdx.x];
      a2 += wred[1][w][threadIdx.x];
    }
    part[0][threadIdx.x] = a1;
    part[1][threadIdx.x] = a2;
  }

  // 3. the sample's statistics: the cluster's partials in rank order, the
  //    same sums in every CTA
  cluster.sync();
  if (threadIdx.x < CG) {
    float a1 = 0.f, a2 = 0.f;
    for (unsigned q = 0; q < gridDim.x; ++q) {
      const float* p = cluster.map_shared_rank(&part[0][0], q);
      a1 += p[threadIdx.x];
      a2 += p[CG + threadIdx.x];
    }
    stats_of(a1, a2, S, eps, &stat[0][threadIdx.x], &stat[1][threadIdx.x]);
  }
  __syncthreads();
  // the other CTAs may leave once this one has read their partials
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");

  // 4. normalize from shared memory
  float mean[8], rstd[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mean[e] = stat[0][cv * 8 + e];
    rstd[e] = stat[1][cv * 8 + e];
  }
  for (int r = rr; r < n; r += RPI)
    *reinterpret_cast<uint4*>(dst + (long long)r * C) =
        normalize8(slab[r * CV + cv], mean, rstd, act, slope);
  // ... and this one leaves once the others have read its partial
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Large: statistics, grid (splits, B). Block (sp, b) owns rows
// [sp * chunk, (sp + 1) * chunk) of sample b, chunk = ceil(S / splits).
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
  const bf16* base = x + (long long)b * S * C + cv * 8;
  for (long long rb = r0 + rr; rb < r1; rb += BATCH * RPI) {
    uint4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const long long r = rb + u * RPI;
      if (r < r1) v[u] = __ldg(reinterpret_cast<const uint4*>(base + r * C));
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (rb + u * RPI < r1) add8(v[u], s1, s2);
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

// Large: normalize, grid (splits, B), the statistics pass's blocks. The
// sample's 2C sums come first: P = 256 / 2C threads (at least 1) per sum,
// thread p adding splits p, p + P, ... in order, then the P results in order.
__global__ void __launch_bounds__(THREADS)
    in_normalize_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                        const float* __restrict__ part, long long S, int C, int splits,
                        float eps, int act, float slope) {
  __shared__ float sums[2 * MAX_C];
  __shared__ float scratch[2 * MAX_C > THREADS ? 2 * MAX_C : THREADS];
  const int sp = blockIdx.x, b = blockIdx.y;
  const int V = 2 * C, P = V < THREADS ? THREADS / V : 1;
  const float* pb = part + (long long)b * splits * V;
  for (int i = threadIdx.x; i < V * P; i += THREADS) {
    const int v = i % V, p = i / V;
    float a = 0.f;
    for (int q = p; q < splits; q += P) a += pb[(long long)q * V + v];
    scratch[i] = a;
  }
  __syncthreads();
  for (int v = threadIdx.x; v < V; v += THREADS) {
    float a = 0.f;
    for (int p = 0; p < P; ++p) a += scratch[p * V + v];
    sums[v] = a;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float s1 = sums[c], s2 = sums[C + c];
    stats_of(s1, s2, S, eps, &sums[c], &sums[C + c]);
  }
  __syncthreads();

  const int CV = C / 8, RPI = THREADS / CV;
  const int cv = threadIdx.x % CV, rr = threadIdx.x / CV;
  float mean[8], rstd[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    mean[e] = sums[cv * 8 + e];
    rstd[e] = sums[C + cv * 8 + e];
  }
  const long long chunk = (S + splits - 1) / splits;
  const long long r0 = sp * chunk, r1 = r0 + chunk < S ? r0 + chunk : S;
  if (r1 <= r0) return;
  const long long off = (long long)b * S * C + cv * 8;
  for (long long rb = r0 + ((r1 - r0 - 1) / (BATCH * RPI)) * BATCH * RPI; rb >= r0;
       rb -= BATCH * RPI) {
    uint4 v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const long long r = rb + u * RPI + rr;
      if (r < r1) v[u] = __ldg(reinterpret_cast<const uint4*>(x + off + r * C));
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const long long r = rb + u * RPI + rr;
      if (r < r1)
        *reinterpret_cast<uint4*>(y + off + r * C) = normalize8(v[u], mean, rstd, act, slope);
    }
  }
}

static cudaError_t launch_onchip(const bf16* x, bf16* y, int B, long long S, int C, int k,
                                 int rows, float eps, int act, float slope, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        in_onchip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SLAB);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, C / CG, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)rows * CG * 2;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, in_onchip_kernel, x, y, S, C, rows, eps, act, slope);
}

// x, y: (B, S, C) bf16, 16-byte aligned, C % 8 == 0 and (C / 8) dividing 256.
// On chip when cluster > 0: `cluster` CTAs of `rows` rows each per 64-channel
// group and sample; `work` unused. Else the two passes with `splits` blocks a
// sample; work holds B * splits * 2 * C floats.
extern "C" int instance_norm(const void* x, void* y, void* work, int B, long long S, int C,
                             int cluster, int rows, int splits, float eps, int act, float slope,
                             void* stream) {
  if (B < 1 || B > 65535 || S < 1 || C < 8 || C > MAX_C || C % 8 || THREADS % (C / 8))
    return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)y) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16* xb = (const bf16*)x;
  bf16* yb = (bf16*)y;
  if (cluster > 0) {
    if (C % CG || cluster > MAX_CLUSTER || rows < 1 ||
        (long long)rows * cluster < S || (long long)rows * CG * 2 > MAX_SLAB)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = launch_onchip(xb, yb, B, S, C, cluster, rows, eps, act, slope, s);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  if (splits < 1 || splits > 65535 || work == nullptr) return (int)cudaErrorInvalidValue;
  float* part = (float*)work;
  in_stats_kernel<<<dim3(splits, B), THREADS, 0, s>>>(xb, part, S, C, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  in_normalize_kernel<<<dim3(splits, B), THREADS, 0, s>>>(xb, yb, part, S, C, splits, eps, act,
                                                          slope);
  return (int)cudaGetLastError();
}
