// Binary cross-weight ("pixelweight") fusion of two same-shape token
// streams, per token and head of 32 channels:
//   h_s = LN_s(x_s); (q_s, k_s, v_s) = h_s W_qkv_s        (s = 1, 2)
//   d1 = <q2, k1> / sqrt(32); d2 = <q1, k2> / sqrt(32)
//   (w1, w2) = softmax(d1, d2); out = (w1 v1 + w2 v2) W_out
//
// Replaces hybrid_ctunet_tpu/ops/pixelweight.py:pixelweight_pallas (_kernel).
// Rounding points follow pixelweight_reference (the JAX CPU path and the
// port's plain version), not the Pallas kernel, which kept LN, q/k/v and the
// blend in fp32: the LN output and q/k/v are rounded to bf16; each product
// q2*k1 is rounded to bf16 before the fp32 head sum; the softmax is fp32 and
// its weights are rounded to bf16; w1*v1, w2*v2 and their sum are bf16 ops;
// each projection sums in fp32 and is rounded once.
//
// Bound: operations. Per token 14 C^2 FLOP (two C -> 3C projections and the
// C -> C output) against 6 C bytes of input and output; at C = 128 that is
// 75 FLOP per byte, at 512 300.
// Design: a block owns BM tokens (64 at C <= 256, 32 at C = 512) and 12
// warps. It loads both streams' tiles into shared memory, LayerNorms them in
// place (a warp per row, fp32), then walks the heads: per head the 12 warps
// each compute one 16-column tile of one of q1 k1 v1 q2 k2 v2 for all BM rows
// on the tensor cores (WMMA bf16, fp32 accumulate; the weight fragments come
// straight from device memory, where the <= 3 MB of weights stay in L2), the
// per-row cross-dots, softmax and blend run four threads to a row, and the
// head's 32 blended channels land in a shared BM x C tile. Last, the warps
// multiply that tile by W_out and store bf16 rows. The (BM, 3C) q/k/v never
// exist anywhere: at most one head's (BM, 6 x 32) does, in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int DH = 32;  // channels per head
constexpr int NWARPS = 12;
constexpr int THREADS = NWARPS * 32;
constexpr int LDQ = DH + 8;  // one head's q/k/v tile rows (16 bytes of padding)
constexpr int LDS = 16 + 4;  // per-warp fp32 staging rows

template <int C, int BM>
struct Layout {
  static constexpr int LDH = C + 8;  // LN / blend tile rows
  static constexpr size_t tile = (size_t)BM * LDH * sizeof(bf16);
  static constexpr size_t qkv = (size_t)6 * BM * LDQ * sizeof(bf16);
  static constexpr size_t stage = (size_t)NWARPS * 16 * LDS * sizeof(float);
  static constexpr size_t bytes = 3 * tile + qkv + stage;
};

struct PwParams {
  const float* ln1w;
  const float* ln1b;
  const float* ln2w;
  const float* ln2b;
  const bf16* wqkv1;  // (3C, C), torch Linear layout
  const bf16* wqkv2;
  const bf16* wout;  // (C, C)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float bmul(bf16 a, bf16 b) {  // bf16 product, rounded
  return __bfloat162float(__float2bfloat16(__bfloat162float(a) * __bfloat162float(b)));
}

// acc (16 x 16 fp32 fragment) -> bf16 at dst (row stride ld), via the
// warp's staging tile
__device__ __forceinline__ void frag_to_bf16(
    const wmma::fragment<wmma::accumulator, 16, 16, 16, float>& acc, float* stage, bf16* dst,
    int ld) {
  wmma::store_matrix_sync(stage, acc, LDS, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x % 32, r = lane / 2, c0 = (lane % 2) * 8;
  uint4 packed;
  bf16* v = reinterpret_cast<bf16*>(&packed);
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(stage[r * LDS + c0 + e]);
  *reinterpret_cast<uint4*>(dst + (long long)r * ld + c0) = packed;
  __syncwarp();
}

template <int C, int BM>
__global__ void __launch_bounds__(THREADS)
    pixelweight_kernel(const bf16* __restrict__ x1, const bf16* __restrict__ x2,
                       bf16* __restrict__ out, long long M, const PwParams p) {
  using L = Layout<C, BM>;
  constexpr int LDH = L::LDH, H = C / DH, RT = BM / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sH1 = reinterpret_cast<bf16*>(smem);
  bf16* sH2 = sH1 + BM * LDH;
  bf16* sBl = sH2 + BM * LDH;
  bf16* sQ = sBl + BM * LDH;  // [6][BM][LDQ]: q1 k1 v1 q2 k2 v2 of one head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* stage = reinterpret_cast<float*>(sQ + 6 * BM * LDQ) + warp * 16 * LDS;
  const long long m0 = (long long)blockIdx.x * BM;

  // both tiles in, rows past M zero
  for (int i = threadIdx.x; i < 2 * BM * (C / 8); i += THREADS) {
    const int s = i / (BM * (C / 8)), j = i % (BM * (C / 8));
    const int r = j / (C / 8), part = j % (C / 8);
    const bf16* src = s ? x2 : x1;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M) v = *reinterpret_cast<const uint4*>(src + (m0 + r) * C + part * 8);
    *reinterpret_cast<uint4*>((s ? sH2 : sH1) + r * LDH + part * 8) = v;
  }
  __syncthreads();

  // LayerNorm in place, fp32, a warp per row (two-pass mean and variance)
  constexpr int PER = C / 32;
  for (int rr = warp; rr < 2 * BM; rr += NWARPS) {
    bf16* row = (rr < BM ? sH1 : sH2) + (rr % BM) * LDH;
    const float* lw = rr < BM ? p.ln1w : p.ln2w;
    const float* lb = rr < BM ? p.ln1b : p.ln2b;
    float xv[PER];
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      xv[u] = __bfloat162float(row[lane + 32 * u]);
      sum += xv[u];
    }
    const float mean = warp_sum(sum) / C;
    float ss = 0.f;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const float d = xv[u] - mean;
      ss += d * d;
    }
    const float rstd = rsqrtf(warp_sum(ss) / C + 1e-5f);
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int c = lane + 32 * u;
      row[c] = __float2bfloat16((xv[u] - mean) * rstd * lw[c] + lb[c]);
    }
  }
  __syncthreads();

  const float scale = 0.17677669529663687f;  // 32^-0.5, rounded to fp32 as the plain version's
  for (int h = 0; h < H; ++h) {
    // warp -> (matrix m of q1 k1 v1 q2 k2 v2, 16-column half ct) of this head
    {
      const int m = warp / 2, ct = warp % 2;
      const bf16* a = m < 3 ? sH1 : sH2;
      const bf16* w = (m < 3 ? p.wqkv1 : p.wqkv2) + (long long)((m % 3) * C + h * DH + ct * 16) * C;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
      for (int t = 0; t < RT; ++t) wmma::fill_fragment(acc[t], 0.f);
      for (int k = 0; k < C / 16; ++k) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, w + k * 16, C);
#pragma unroll
        for (int t = 0; t < RT; ++t) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, a + t * 16 * LDH + k * 16, LDH);
          wmma::mma_sync(acc[t], fa, fb, acc[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < RT; ++t)
        frag_to_bf16(acc[t], stage, sQ + (m * BM + t * 16) * LDQ + ct * 16, LDQ);
    }
    __syncthreads();

    // cross-dots, 2-way softmax, blend: four threads to a row, 8 channels each
    if (threadIdx.x < BM * 4) {
      const int r = threadIdx.x / 4, d0 = (threadIdx.x % 4) * 8;
      const bf16* q1 = sQ + (0 * BM + r) * LDQ + d0;
      const bf16* k1 = sQ + (1 * BM + r) * LDQ + d0;
      const bf16* v1 = sQ + (2 * BM + r) * LDQ + d0;
      const bf16* q2 = sQ + (3 * BM + r) * LDQ + d0;
      const bf16* k2 = sQ + (4 * BM + r) * LDQ + d0;
      const bf16* v2 = sQ + (5 * BM + r) * LDQ + d0;
      float p1 = 0.f, p2 = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        p1 += bmul(q2[e], k1[e]);
        p2 += bmul(q1[e], k2[e]);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the row's four threads are adjacent lanes
        p1 += __shfl_xor_sync(0xffffffffu, p1, off);
        p2 += __shfl_xor_sync(0xffffffffu, p2, off);
      }
      const float dd1 = p1 * scale, dd2 = p2 * scale;
      const float mx = fmaxf(dd1, dd2);
      const float e1 = expf(dd1 - mx), e2 = expf(dd2 - mx);
      const float den = e1 + e2;
      const bf16 w1 = __float2bfloat16(e1 / den), w2 = __float2bfloat16(e2 / den);
      uint4 packed;
      bf16* o = reinterpret_cast<bf16*>(&packed);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(bmul(w1, v1[e]) + bmul(w2, v2[e]));
      *reinterpret_cast<uint4*>(sBl + r * LDH + h * DH + d0) = packed;
    }
    __syncthreads();
  }

  // out = blend @ W_out^T, one 16-column tile per warp at a time
  for (int ct = warp; ct < C / 16; ct += NWARPS) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
    for (int t = 0; t < RT; ++t) wmma::fill_fragment(acc[t], 0.f);
    const bf16* w = p.wout + (long long)ct * 16 * C;
    for (int k = 0; k < C / 16; ++k) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, w + k * 16, C);
#pragma unroll
      for (int t = 0; t < RT; ++t) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sBl + t * 16 * LDH + k * 16, LDH);
        wmma::mma_sync(acc[t], fa, fb, acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < RT; ++t) {
      wmma::store_matrix_sync(stage, acc[t], LDS, wmma::mem_row_major);
      __syncwarp();
      const int r = lane / 2, c0 = (lane % 2) * 8;
      const long long row = m0 + t * 16 + r;
      if (row < M) {
        uint4 packed;
        bf16* v = reinterpret_cast<bf16*>(&packed);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16(stage[r * LDS + c0 + e]);
        *reinterpret_cast<uint4*>(out + row * C + ct * 16 + c0) = packed;
      }
      __syncwarp();
    }
  }
}

template <int C, int BM>
static int launch(const void* x1, const void* x2, void* out, long long M, const PwParams& p,
                  cudaStream_t stream) {
  const size_t smem = Layout<C, BM>::bytes;
  cudaError_t err = cudaFuncSetAttribute(pixelweight_kernel<C, BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (M + BM - 1) / BM;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pixelweight_kernel<C, BM><<<(unsigned)blocks, THREADS, smem, stream>>>(
      (const bf16*)x1, (const bf16*)x2, (bf16*)out, M, p);
  return (int)cudaGetLastError();
}

// x1, x2, out: (M, C) bf16; LN params fp32 (C); wqkv1, wqkv2 (3C, C) and
// wout (C, C) bf16 in torch Linear layout. C is 128, 256 or 512.
extern "C" int pixelweight(const void* x1, const void* x2, void* out, long long M, int C,
                           const void* ln1w, const void* ln1b, const void* ln2w,
                           const void* ln2b, const void* wqkv1, const void* wqkv2,
                           const void* wout, void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  if (((size_t)x1 | (size_t)x2 | (size_t)out | (size_t)wqkv1 | (size_t)wqkv2 | (size_t)wout) %
      32)
    return (int)cudaErrorMisalignedAddress;
  const PwParams p = {(const float*)ln1w, (const float*)ln1b, (const float*)ln2w,
                      (const float*)ln2b, (const bf16*)wqkv1, (const bf16*)wqkv2,
                      (const bf16*)wout};
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 128) return launch<128, 64>(x1, x2, out, M, p, s);
  if (C == 256) return launch<256, 64>(x1, x2, out, M, p, s);
  if (C == 512) return launch<512, 32>(x1, x2, out, M, p, s);
  return (int)cudaErrorInvalidValue;
}
