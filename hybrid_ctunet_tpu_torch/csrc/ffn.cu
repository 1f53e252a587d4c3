// Transformer FeedForward on a row tile: LN (fp32, eps 1e-5) -> fc1 ->
// erf-GELU -> fc2 (+ bias) [+ residual], and the pair form
// y = x + FFN1(x), z = y + FFN2(y) with y kept on chip.
//
// Replaces hybrid_ctunet_tpu/ops/ffn_pallas.py:_fused_ffn_impl (_kernel) and
// :_fused_ffn_pair_impl (_pair_kernel). Rounding points follow the JAX
// reference_ffn: LN output rounded to bf16; each matmul sums bf16 x bf16
// products in fp32 and is rounded to bf16 BEFORE its bf16 bias is added;
// GELU runs in fp32 (erff) on the rounded value and is rounded to bf16; the
// residual add is a bf16 add.
//
// Bound: the unfused chain moves the 4x-wide hidden activation through
// device memory twice (stage 3 of TUNet: 884,736 rows x 512 hidden x 2 B,
// twice per FFN). Here the hidden activation exists only as a 64 x 64 tile
// in shared memory, so device traffic is x in, out back, and the weights
// (L2-resident, <= 1 MB in bf16); what is left is tensor-core work
// (2 x rows x C x H x 2 FLOP).
// Design: one block of 8 warps per 64-row tile. x and the LN output live in
// shared memory; the hidden dim is streamed in chunks of 64: the fc1 and fc2
// weight slices of the chunk are staged in shared memory, the 64 x 64 fc1
// tile is computed on the tensor cores (WMMA bf16, fp32 accumulate), biased
// and GELU'd in shared memory, and multiplied into the 64 x C fp32 fc2
// accumulator, which stays in registers for the whole hidden loop. The pair
// form runs the tile twice, writing y back over x in shared memory.
// C is 128 or 256 (stages 3 and 2 of the decoder pyramid), H a multiple of 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BM = 64;   // rows per block
constexpr int HC = 64;   // hidden chunk
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
// Shared-memory tiles read by the tensor cores get their rows padded by 16
// bytes (8 bf16 / 4 fp32), so that the 16 rows of a fragment start in
// different banks.
constexpr int PAD16 = 8;
constexpr int PAD32 = 4;
constexpr int HCP = HC + PAD16;  // row length of the fc2 slice and GELU tile
constexpr int HCF = HC + PAD32;  // row length of the fp32 fc1 tile

struct FfnParams {
  const float* lnw;  // (C) fp32
  const float* lnb;  // (C) fp32
  const bf16* w1;    // (H, C): fc1 weight, torch Linear layout
  const bf16* b1;    // (H)
  const bf16* w2;    // (C, H): fc2 weight
  const bf16* b2;    // (C)
};

template <int C>
constexpr size_t smem_bytes() {
  // sX [BM][C], sY [BM][C+8], sW1 [HC][C+8], sW2 [C][HC+8], sH fp32 [BM][HC+4],
  // sHb [BM][HC+8]; the fp32 output staging [BM][C+4] reuses sW1 + sW2
  return (BM * C + BM * (C + PAD16) + HC * (C + PAD16) + C * HCP + BM * HCP) * sizeof(bf16) +
         BM * HCF * sizeof(float);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sY = bf16(LN(sX)), one warp per row
template <int C>
__device__ void layer_norm_tile(const bf16* sX, bf16* sY, const float* lnw, const float* lnb) {
  constexpr int PER = C / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += NWARPS) {
    float xv[PER];
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      xv[u] = __bfloat162float(sX[r * C + lane + 32 * u]);
      s += xv[u];
    }
    const float mean = warp_sum(s) / C;
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
      sY[r * (C + PAD16) + c] = __float2bfloat16((xv[u] - mean) * rstd * lnw[c] + lnb[c]);
    }
  }
}

// One FFN over the tile in sX. Result bf16(bf16(acc) + b2) [+ sX] goes to
// global rows [row0, row0 + BM) of gout (rows < nrows), or back into sX when
// gout is null.
template <int C>
__device__ void ffn_tile(bf16* sX, unsigned char* smem_rest, const FfnParams p, int H,
                         bool residual, bf16* gout, long long row0, long long nrows) {
  constexpr int NT = C / 32;  // fc2 output tiles per warp: C/16 tiles over 2 warp columns
  constexpr int CP = C + PAD16;
  static_assert(BM * (C + PAD32) * sizeof(float) <= (HC * CP + C * HCP) * sizeof(bf16),
                "fp32 output staging must fit over sW1 + sW2");
  bf16* sY = reinterpret_cast<bf16*>(smem_rest);
  bf16* sW1 = sY + BM * CP;
  bf16* sW2 = sW1 + HC * CP;
  float* sH = reinterpret_cast<float*>(sW2 + C * HCP);
  bf16* sHb = reinterpret_cast<bf16*>(sH + BM * HCF);
  const int warp = threadIdx.x / 32;
  const int mw = warp % 4, ng = warp / 4;

  layer_norm_tile<C>(sX, sY, p.lnw, p.lnb);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int hc = 0; hc < H; hc += HC) {
    // stage fc1 rows [hc, hc+HC) and fc2 columns [hc, hc+HC)
    for (int i = threadIdx.x; i < HC * C / 8; i += THREADS) {
      const int n = i / (C / 8), part = i % (C / 8);
      *reinterpret_cast<uint4*>(sW1 + n * CP + part * 8) =
          *reinterpret_cast<const uint4*>(p.w1 + (long long)(hc + n) * C + part * 8);
    }
    for (int i = threadIdx.x; i < C * HC / 8; i += THREADS) {
      const int n = i / (HC / 8), part = i % (HC / 8);
      *reinterpret_cast<uint4*>(sW2 + n * HCP + part * 8) =
          *reinterpret_cast<const uint4*>(p.w2 + (long long)n * H + hc + part * 8);
    }
    __syncthreads();  // also orders the LN writes of sY before the first use

    // hidden tile (BM x HC) = sY @ W1c^T; warp: row tile mw, column tiles 2ng, 2ng+1
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[2];
      wmma::fill_fragment(hacc[0], 0.f);
      wmma::fill_fragment(hacc[1], 0.f);
      for (int kk = 0; kk < C / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sY + mw * 16 * CP + kk * 16, CP);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
          wmma::load_matrix_sync(b, sW1 + (ng * 2 + j) * 16 * CP + kk * 16, CP);
          wmma::mma_sync(hacc[j], a, b, hacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(sH + mw * 16 * HCF + (ng * 2 + j) * 16, hacc[j], HCF,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // h = bf16(bf16(h) + b1); g = bf16(gelu(h))
    for (int i = threadIdx.x; i < BM * HC; i += THREADS) {
      const int r = i / HC, col = i % HC;
      const float hv = round_bf16(round_bf16(sH[r * HCF + col]) + __bfloat162float(p.b1[hc + col]));
      sHb[r * HCP + col] = __float2bfloat16(0.5f * hv * (1.f + erff(hv * 0.70710678118654752f)));
    }
    __syncthreads();

    // acc (BM x C) += g @ W2c^T; warp: row tile mw, column tiles ng*NT ..
    for (int kk = 0; kk < HC / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, sHb + mw * 16 * HCP + kk * 16, HCP);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, sW2 + (ng * NT + j) * 16 * HCP + kk * 16, HCP);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();  // before the next chunk overwrites sW1, sW2, sHb
  }

  // fp32 staging of the output tile [BM][C+4] over sW1 + sW2
  constexpr int CF = C + PAD32;
  float* sO = reinterpret_cast<float*>(sW1);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    wmma::store_matrix_sync(sO + mw * 16 * CF + (ng * NT + j) * 16, acc[j], CF,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < BM * C; i += THREADS) {
    const int r = i / C, c = i % C;
    float o = round_bf16(round_bf16(sO[r * CF + c]) + __bfloat162float(p.b2[c]));
    if (residual) o = o + __bfloat162float(sX[i]);
    const bf16 ob = __float2bfloat16(o);
    if (gout == nullptr)
      sX[i] = ob;
    else if (row0 + r < nrows)
      gout[(row0 + r) * C + c] = ob;
  }
  __syncthreads();
}

template <int C>
__device__ void load_tile(const bf16* x, bf16* sX, long long row0, long long nrows) {
  for (int i = threadIdx.x; i < BM * C / 8; i += THREADS) {
    const int r = i / (C / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < nrows) val = reinterpret_cast<const uint4*>(x + row0 * C)[i];
    reinterpret_cast<uint4*>(sX)[i] = val;
  }
  __syncthreads();
}

template <int C>
__global__ void __launch_bounds__(THREADS)
    ffn_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, long long nrows, int H,
               int residual, const FfnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  const long long row0 = (long long)blockIdx.x * BM;
  load_tile<C>(x, sX, row0, nrows);
  ffn_tile<C>(sX, smem + BM * C * sizeof(bf16), p, H, residual != 0, out, row0, nrows);
}

template <int C>
__global__ void __launch_bounds__(THREADS)
    ffn_pair_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, long long nrows,
                    int H, const FfnParams p1, const FfnParams p2) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  const long long row0 = (long long)blockIdx.x * BM;
  load_tile<C>(x, sX, row0, nrows);
  unsigned char* rest = smem + BM * C * sizeof(bf16);
  ffn_tile<C>(sX, rest, p1, H, true, nullptr, row0, nrows);  // y = x + FFN1(x), in sX
  ffn_tile<C>(sX, rest, p2, H, true, out, row0, nrows);      // z = y + FFN2(y)
}

template <int C>
static int launch(const void* x, void* out, long long nrows, int H, int residual, bool pair,
                  const FfnParams& p1, const FfnParams& p2, cudaStream_t stream) {
  const size_t smem = smem_bytes<C>();
  const unsigned blocks = (unsigned)((nrows + BM - 1) / BM);
  cudaError_t err;
  if (pair) {
    err = cudaFuncSetAttribute(ffn_pair_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ffn_pair_kernel<C><<<blocks, THREADS, smem, stream>>>((const bf16*)x, (bf16*)out, nrows, H,
                                                          p1, p2);
  } else {
    err = cudaFuncSetAttribute(ffn_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ffn_kernel<C><<<blocks, THREADS, smem, stream>>>((const bf16*)x, (bf16*)out, nrows, H,
                                                     residual, p1);
  }
  return (int)cudaGetLastError();
}

static int dispatch(const void* x, void* out, long long nrows, int C, int H, int residual,
                    bool pair, const FfnParams& p1, const FfnParams& p2, void* stream) {
  if (nrows < 1 || H < HC || H % HC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 128) return launch<128>(x, out, nrows, H, residual, pair, p1, p2, s);
  if (C == 256) return launch<256>(x, out, nrows, H, residual, pair, p1, p2, s);
  return (int)cudaErrorInvalidValue;
}

// x, out: (nrows, C) bf16. LN params fp32; weights and biases bf16 in torch
// Linear layout (fc1 (H, C), fc2 (C, H)).
extern "C" int ffn(const void* x, void* out, long long nrows, int C, int H, int residual,
                   const void* lnw, const void* lnb, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* stream) {
  const FfnParams p = {(const float*)lnw, (const float*)lnb, (const bf16*)w1,
                       (const bf16*)b1,   (const bf16*)w2,   (const bf16*)b2};
  return dispatch(x, out, nrows, C, H, residual, false, p, p, stream);
}

extern "C" int ffn_pair(const void* x, void* out, long long nrows, int C, int H,
                        const void* lnw1, const void* lnb1, const void* w11, const void* b11,
                        const void* w12, const void* b12, const void* lnw2, const void* lnb2,
                        const void* w21, const void* b21, const void* w22, const void* b22,
                        void* stream) {
  const FfnParams p1 = {(const float*)lnw1, (const float*)lnb1, (const bf16*)w11,
                        (const bf16*)b11,   (const bf16*)w12,   (const bf16*)b12};
  const FfnParams p2 = {(const float*)lnw2, (const float*)lnb2, (const bf16*)w21,
                        (const bf16*)b21,   (const bf16*)w22,   (const bf16*)b22};
  return dispatch(x, out, nrows, C, H, 0, true, p1, p2, stream);
}
