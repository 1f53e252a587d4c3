// Transformer FeedForward on a row tile: LN (fp32, eps 1e-5) -> fc1 ->
// erf-GELU -> fc2 (+ bias) [+ residual] (entry `ffn`, K3), and the pair form
// y = x + FFN1(x), z = y + FFN2(y) with y kept on chip (entry `ffn_pair`, K4).
//
// Replaces hybrid_ctunet_tpu/ops/ffn_pallas.py:_fused_ffn_impl (_kernel) and
// :_fused_ffn_pair_impl (_pair_kernel). Rounding points follow the JAX
// reference_ffn: LN output rounded to bf16; each matmul sums bf16 x bf16
// products in fp32 and is rounded to bf16 BEFORE its bf16 bias is added;
// GELU runs in fp32 (erff) on the rounded value and is rounded to bf16; the
// residual add is a bf16 add.
//
// Bound: the unfused chain moves the 4x-wide hidden activation through
// device memory twice per FFN. Fused, device traffic is x in and out back;
// what is left is tensor-core work (2 x rows x C x H x 2 FLOP per FFN) and,
// beside it on the fp32 units, the bias, rounding and erff GELU of every
// hidden element (stage 3 of TUNet: 2 x 884,736 x 512 of them per pair).
//
// `ffn` (K3, C 128 or 256): one block of 8 warps per 64-row tile. x and the
// LN output live in shared memory; the hidden dim is streamed in chunks of
// 64: the fc1 and fc2 weight slices of the chunk are staged in shared memory,
// the 64 x 64 fc1 tile is computed on the tensor cores (WMMA bf16, fp32
// accumulate), biased and GELU'd in shared memory, and multiplied into the
// 64 x C fp32 fc2 accumulator, which stays in registers for the whole hidden
// loop.
//
// `ffn_pair` (K4, C 128) on Hopper: a persistent grid, one CTA per SM, of two
// consumer warpgroups (64 rows each, a 128-row tile) and one producer
// warpgroup, which hands its registers to the consumers (setmaxnreg).
// - A first launch packs both FFNs' weights into bf16 chunk images in the
//   exact shared-memory layout wgmma reads (K-major, 128-byte swizzle): per
//   64-wide hidden chunk the 64 W1 rows and the 64 W2 columns, 32 KB. So the
//   caller's fp32 or bf16 parameters are read as they are, with no torch op.
// - The producer streams the chunk images through a 3-stage ring by bulk
//   copy with mbarriers, and the next tile's x (contiguous rows) into the
//   second of two x buffers while this tile computes.
// - fc1 is wgmma m64n64k16 with A the LN'd tile in shared memory. Its fp32
//   accumulator is rounded, biased and rounded in registers (bf16x2 adds),
//   GELU'd and rounded by a 6.5 KB table in shared memory (the erff
//   formula's bf16 result for every bf16 input that needs one: erff took
//   half the kernel's time on an NVIDIA H100 80GB HBM3 at 700 W), and
//   packed as the register A operand of fc2's wgmma m64n128k16: the hidden
//   activation never leaves registers. fc2's 64 x 128 accumulator stays in
//   registers for the whole hidden loop.
// - fc2 of chunk j and fc1 of chunk j+1 are issued as one group; the two
//   warpgroups drift apart, so one's GELU runs under the other's wgmma.
// - y = x + FFN1(x) overwrites x in shared memory; z overwrites y and leaves
//   by one bulk store per warpgroup.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "sm90.cuh"

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
// global rows [row0, row0 + BM) of gout (rows < nrows).
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
    if (row0 + r < nrows) gout[(row0 + r) * C + c] = __float2bfloat16(o);
  }
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


// x, out: (nrows, C) bf16. LN params fp32; weights and biases bf16 in torch
// Linear layout (fc1 (H, C), fc2 (C, H)).
extern "C" int ffn(const void* x, void* out, long long nrows, int C, int H, int residual,
                   const void* lnw, const void* lnb, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* stream) {
  if (nrows < 1 || H < HC || H % HC) return (int)cudaErrorInvalidValue;
  const FfnParams p = {(const float*)lnw, (const float*)lnb, (const bf16*)w1,
                       (const bf16*)b1,   (const bf16*)w2,   (const bf16*)b2};
  const unsigned blocks = (unsigned)((nrows + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  size_t smem;
  cudaError_t err;
  if (C == 128) {
    smem = smem_bytes<128>();
    err = cudaFuncSetAttribute(ffn_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ffn_kernel<128><<<blocks, THREADS, smem, s>>>((const bf16*)x, (bf16*)out, nrows, H,
                                                  residual, p);
  } else if (C == 256) {
    smem = smem_bytes<256>();
    err = cudaFuncSetAttribute(ffn_kernel<256>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    ffn_kernel<256><<<blocks, THREADS, smem, s>>>((const bf16*)x, (bf16*)out, nrows, H,
                                                  residual, p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K4: the pair on Hopper (see the note at the head of the file)
namespace pair {

constexpr int C = 128;                   // stage-3 width
constexpr int HC = 64;                   // hidden chunk
constexpr int BM = 128;                  // rows per tile, 64 per consumer warpgroup
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int STAGES = 3;
// registers a thread after setmaxnreg: the producer gives its share to the
// consumers (the block is compiled at 65536 / 384 = 168)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int W1_BYTES = HC * C * 2;     // W1 rows of a chunk: 2 K blocks x 64 rows x 128 B
constexpr int CHUNK_BYTES = 2 * W1_BYTES;  // + W2 columns: 128 rows x 128 B
constexpr int X_BYTES = BM * C * 2;
constexpr int A_BYTES = BM * C * 2;      // LN'd tile: 2 K blocks x 128 rows x 128 B
constexpr int KB_BYTES = BM * 128;       // one K block of the LN'd tile
constexpr int FIXED_SMEM = STAGES * CHUNK_BYTES + 2 * X_BYTES + A_BYTES + 128;

// fp32 parameters per FFN in the packed buffer and in shared memory:
// lnw [C], lnb [C], b2 [C], b1 [H] (the biases rounded to bf16)
__host__ __device__ constexpr int nparams(int H) { return 3 * C + H; }

// GELU table: the hidden value h is a bf16 number, so bf16(gelu(h)) is a
// function of its 16 bits. The table holds it, computed by the same fp32
// erff formula, for |h| in [2^-10, 8) (biased exponents 117..129, 1664
// values a sign). Outside, the formula reduces exactly: bf16(h / 2) below
// 2^-10, and h or -0 from 8 up (erff is +-1 there); checked against the
// formula for every bf16 value.
constexpr int LUT_E0 = 117;
constexpr int LUT_HALF = 13 * 128;
constexpr int LUT_BYTES = 2 * LUT_HALF * 2;

__host__ size_t smem_bytes(int H) {
  return FIXED_SMEM + 2 * nparams(H) * sizeof(float) + LUT_BYTES + 1024;  // + alignment slack
}
__host__ size_t packed_bytes(int H) {
  return (size_t)2 * (H / HC) * CHUNK_BYTES + 2 * nparams(H) * sizeof(float) + LUT_BYTES;
}

struct Src {
  const float* lnw;
  const float* lnb;
  const void* w1;  // (H, C)
  const void* b1;  // (H)
  const void* w2;  // (C, H)
  const void* b2;  // (C)
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// bits of bf16(gelu(h)) for the bf16 value h with bits u, from the table
__device__ __forceinline__ uint32_t gelu_bits(uint32_t u, const unsigned short* lut) {
  const uint32_t a = u & 0x7fffu, sgn = u >> 15, idx = a - (LUT_E0 << 7);
  const uint32_t t = lut[min(idx, LUT_HALF - 1u) + sgn * LUT_HALF];
  if (idx < LUT_HALF) return t;
  const float h = __uint_as_float(u << 16);
  const bf16 g = __float2bfloat16(a < (LUT_E0 << 7) ? 0.5f * h : 0.5f * h * (sgn ? 0.f : 2.f));
  return *reinterpret_cast<const unsigned short*>(&g);
}

// bf16(bf16(a) + b) for an fp32 pair a and a bf16 pair b: one bf16x2 add,
// which rounds the exact sum of two bf16 values once, as the fp32 add
// followed by a rounding does
__device__ __forceinline__ __nv_bfloat162 round_add(float a0, float a1, __nv_bfloat162 b) {
  return __hadd2(__floats2bfloat162_rn(a0, a1), b);
}

__device__ __forceinline__ float load(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
            : reinterpret_cast<const float*>(p)[i];
}

// One thread per 16-byte unit of the chunk images, then one per parameter,
// then one per GELU table entry.
// Image of chunk j: W1 rows [64j, 64j+64) as 2 K blocks of 64 rows x 128 B,
// then W2 columns [64j, 64j+64) as 128 rows x 128 B, each row swizzled.
__global__ void pack_kernel(Src s1, Src s2, int H, int bf, unsigned char* packed) {
  const int nch = H / HC;
  const long long units = 2LL * nch * (CHUNK_BYTES / 16);
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q < units) {
    const int per_ffn = nch * (CHUNK_BYTES / 16);
    const int f = (int)(q / per_ffn), u = (int)(q % per_ffn);
    const int j = u / (CHUNK_BYTES / 16), byte = (u % (CHUNK_BYTES / 16)) * 16;
    const Src& s = f ? s2 : s1;
    const void* src;
    long long off;
    if (byte < W1_BYTES) {  // W1[64j + n][kb*64 + k]
      const int kb = byte / (64 * 128), n = (byte % (64 * 128)) / 128;
      const int k = (((byte % 128) / 16) ^ (n & 7)) * 8;
      src = s.w1;
      off = (long long)(HC * j + n) * C + kb * 64 + k;
    } else {  // W2[n][64j + k]
      const int b2 = byte - W1_BYTES, n = b2 / 128;
      const int k = (((b2 % 128) / 16) ^ (n & 7)) * 8;
      src = s.w2;
      off = (long long)n * H + HC * j + k;
    }
    uint4 v;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = sm90::pack_bf16(load(src, off + 2 * e, bf), load(src, off + 2 * e + 1, bf));
    reinterpret_cast<uint4*>(packed)[q] = v;
    return;
  }
  const long long i = q - units;
  if (i >= 2LL * nparams(H)) {
    const long long e = i - 2LL * nparams(H);
    if (e >= 2 * LUT_HALF) return;
    const uint32_t bits = ((uint32_t)(e / LUT_HALF) << 15) | ((LUT_E0 << 7) + (uint32_t)(e % LUT_HALF));
    const bf16 g = __float2bfloat16(gelu(__uint_as_float(bits << 16)));
    reinterpret_cast<unsigned short*>(packed + units * 16 + 2LL * nparams(H) * 4)[e] =
        *reinterpret_cast<const unsigned short*>(&g);
    return;
  }
  const int f = (int)(i / nparams(H)), c = (int)(i % nparams(H));
  const Src& s = f ? s2 : s1;
  float v;
  if (c < C)
    v = s.lnw[c];
  else if (c < 2 * C)
    v = s.lnb[c - C];
  else if (c < 3 * C)
    v = sm90::round_bf16(load(s.b2, c - 2 * C, bf));
  else
    v = sm90::round_bf16(load(s.b1, c - 3 * C, bf));
  reinterpret_cast<float*>(packed + units * 16)[i] = v;
}

// The warpgroup's 64 rows of xs (row-major) -> bf16(LN) into the swizzled
// K-major tile `as` (K block kb at as + kb * KB_BYTES); warp w does rows
// 16w..16w+15, four at a time so that their reductions overlap; a lane holds
// 4 columns of each.
__device__ __forceinline__ void layer_norm_rows(const bf16* xs, unsigned char* as,
                                                const float* lnw, const float* lnb, int warp,
                                                int lane) {
  constexpr int R = 4;
  const int c0 = 4 * lane;
  const float4 w = *reinterpret_cast<const float4*>(lnw + c0);
  const float4 b = *reinterpret_cast<const float4*>(lnb + c0);
  for (int rr = 0; rr < 16; rr += R) {
    float v[R][4], sum[R], ss[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const uint2 raw = *reinterpret_cast<const uint2*>(xs + (warp * 16 + rr + q) * C + c0);
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      v[q][0] = lo.x, v[q][1] = lo.y, v[q][2] = hi.x, v[q][3] = hi.y;
      sum[q] = v[q][0] + v[q][1] + v[q][2] + v[q][3];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < R; ++q) sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], off);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float mean = sum[q] / C;
      ss[q] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[q][e] -= mean;
        ss[q] += v[q][e] * v[q][e];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < R; ++q) ss[q] += __shfl_xor_sync(0xffffffffu, ss[q], off);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const float rstd = rsqrtf(ss[q] / C + 1e-5f);
      uint2 y;
      y.x = sm90::pack_bf16(v[q][0] * rstd * w.x + b.x, v[q][1] * rstd * w.y + b.y);
      y.y = sm90::pack_bf16(v[q][2] * rstd * w.z + b.z, v[q][3] * rstd * w.w + b.w);
      const int r = warp * 16 + rr + q;
      *reinterpret_cast<uint2*>(as + (c0 / 64) * KB_BYTES + sm90::swz(r, c0 % 64)) = y;
    }
  }
}

// fc1 of one chunk: h[64x64] = A (the warpgroup's LN'd rows) x W1c^T
__device__ __forceinline__ void issue_fc1(float* h, const unsigned char* as,
                                          const unsigned char* w1) {
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const uint64_t da = sm90::desc_sw128(as + (kk / 4) * KB_BYTES) + 2 * (kk % 4);
    const uint64_t db = sm90::desc_sw128(w1 + (kk / 4) * (64 * 128)) + 2 * (kk % 4);
    sm90::wgmma_64x64_ss(h, da, db, kk > 0);
  }
}

// In registers: g = bf16(gelu(bf16(bf16(h) + b1))), packed as fc2's A
// operand. Accumulator element 4i + 2half + e sits at row r0 + 8half,
// column 8i + cq + e; a[t] holds elements 2t, 2t+1 (the A fragment of k
// step t/4).
__device__ __forceinline__ void gelu_pack(const float* h, uint32_t* a, const float* b1, int cq,
                                          const unsigned short* lut) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 bb = *reinterpret_cast<const float2*>(b1 + 8 * i + cq);
    const __nv_bfloat162 b = __floats2bfloat162_rn(bb.x, bb.y);  // exact: bf16 values
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const __nv_bfloat162 v = round_add(h[4 * i + 2 * half], h[4 * i + 2 * half + 1], b);
      const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
      a[2 * i + half] = gelu_bits(u & 0xffffu, lut) | (gelu_bits(u >> 16, lut) << 16);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    pair_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int nrows, int H,
                const unsigned char* __restrict__ packed) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base;
  bf16* sX = reinterpret_cast<bf16*>(base + STAGES * CHUNK_BYTES);
  unsigned char* sA = base + STAGES * CHUNK_BYTES + 2 * X_BYTES;
  uint64_t* full_w = reinterpret_cast<uint64_t*>(sA + A_BYTES);
  uint64_t* empty_w = full_w + STAGES;
  uint64_t* full_x = empty_w + STAGES;
  uint64_t* empty_x = full_x + 2;
  float* prm = reinterpret_cast<float*>(base + FIXED_SMEM);
  unsigned short* lut = reinterpret_cast<unsigned short*>(prm + 2 * nparams(H));

  const int nch = H / HC;
  const int ntiles = (nrows + BM - 1) / BM;
  const float* gprm = reinterpret_cast<const float*>(packed + (size_t)2 * nch * CHUNK_BYTES);
  for (int i = threadIdx.x; i < 2 * nparams(H) + LUT_BYTES / 4; i += THREADS) prm[i] = gprm[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::bar_init(&full_w[s], 1);
      sm90::bar_init(&empty_w[s], CONSUMERS);
    }
    for (int b = 0; b < 2; ++b) {
      sm90::bar_init(&full_x[b], 1);
      sm90::bar_init(&empty_x[b], CONSUMERS);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x % 128) return;
    int s = 0;
    uint32_t ph = 0;
    int it = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
      const int b = it & 1;
      sm90::bar_wait(&empty_x[b], ((it >> 1) & 1) ^ 1);
      const uint32_t bytes = (uint32_t)min(BM, nrows - tile * BM) * C * 2;
      sm90::bar_expect_tx(&full_x[b], bytes);
      sm90::bulk_g2s(sX + b * BM * C, x + (size_t)tile * BM * C, bytes, &full_x[b]);
      for (int q = 0; q < 2 * nch; ++q) {
        sm90::bar_wait(&empty_w[s], ph ^ 1);
        sm90::bar_expect_tx(&full_w[s], CHUNK_BYTES);
        sm90::bulk_g2s(ring + s * CHUNK_BYTES, packed + (size_t)q * CHUNK_BYTES, CHUNK_BYTES,
                       &full_w[s]);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  unsigned char* as = sA + wg * 64 * 128;
  float acc[64], h[32];
  uint32_t a[16];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) h[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++it) {
    const int b = it & 1;
    sm90::bar_wait(&full_x[b], (it >> 1) & 1);
    bf16* xs = sX + b * BM * C + wg * 64 * C;
    for (int f = 0; f < 2; ++f) {
      const float* lnw = prm + f * nparams(H);
      const float* b2 = lnw + 2 * C;
      const float* b1 = lnw + 3 * C;
      layer_norm_rows(xs, as, lnw, lnw + C, warp, lane);
      sm90::fence_async_smem();
      sm90::named_sync(1 + wg, 128);

      sm90::bar_wait(&full_w[s], ph);
      sm90::wg_fence();
      issue_fc1(h, as, ring + s * CHUNK_BYTES);
      sm90::wg_commit();
      sm90::wg_wait<0>();
#pragma unroll
      for (int i = 0; i < 32; ++i) sm90::reg_fence(h[i]);
      gelu_pack(h, a, b1, cq, lut);
      for (int j = 0; j < nch; ++j) {
        const int cur = s;
        const unsigned char* w2 = ring + cur * CHUNK_BYTES + W1_BYTES;
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
        sm90::wg_fence();
#pragma unroll
        for (int kk = 0; kk < HC / 16; ++kk)
          sm90::wgmma_64x128_rs(acc, a + 4 * kk, sm90::desc_sw128(w2) + 2 * kk, j > 0 || kk > 0);
        if (j + 1 < nch) {
          sm90::bar_wait(&full_w[s], ph);
          issue_fc1(h, as, ring + s * CHUNK_BYTES);
        }
        sm90::wg_commit();
        sm90::wg_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) sm90::reg_fence(acc[i]);
#pragma unroll
        for (int i = 0; i < 32; ++i) sm90::reg_fence(h[i]);
#pragma unroll
        for (int i = 0; i < 16; ++i) sm90::reg_fence(a[i]);
        if (t == 0) sm90::bar_arrive(&empty_w[cur]);
        if (j + 1 < nch) gelu_pack(h, a, b1 + HC * (j + 1), cq, lut);
      }

      // y (or z) = bf16(bf16(bf16(acc) + b2) + x), over x in shared memory
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 8 * i + cq;
        const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
        const __nv_bfloat162 b = __floats2bfloat162_rn(bb.x, bb.y);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          __nv_bfloat162* px = reinterpret_cast<__nv_bfloat162*>(xs + (r0 + 8 * half) * C + col);
          *px = __hadd2(round_add(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1], b), *px);
        }
      }
      if (f == 0) sm90::named_sync(1 + wg, 128);  // y complete before FFN2's LN
    }
    sm90::fence_async_smem();
    sm90::named_sync(1 + wg, 128);
    if (t == 0) {
      const int rows = min(64, nrows - tile * BM - wg * 64);
      if (rows > 0) {
        sm90::bulk_s2g(out + ((size_t)tile * BM + wg * 64) * C, xs, (uint32_t)rows * C * 2);
        sm90::bulk_commit();
        sm90::bulk_wait_read();
      }
      sm90::bar_arrive(&empty_x[b]);
    }
  }
  if (t == 0) sm90::bulk_wait();
}

}  // namespace pair

// bytes of the scratch `packed` that ffn_pair takes for hidden width H
extern "C" int ffn_pair_packed_bytes(int H) { return (int)pair::packed_bytes(H); }

// x, out: (nrows, 128) bf16, 16-byte aligned. Per FFN: LN params fp32,
// weights and biases (fp32 if wbf16 == 0, else bf16) in torch Linear layout
// (fc1 (H, 128), fc2 (128, H)); packed: ffn_pair_packed_bytes(H) bytes of
// scratch that the first launch fills.
extern "C" int ffn_pair(const void* x, void* out, long long nrows, int C, int H, int wbf16,
                        const void* lnw1, const void* lnb1, const void* w11, const void* b11,
                        const void* w12, const void* b12, const void* lnw2, const void* lnb2,
                        const void* w21, const void* b21, const void* w22, const void* b22,
                        void* packed, void* stream) {
  if (nrows < 1 || nrows > 0x7fffffffLL - pair::BM || C != pair::C || H < pair::HC ||
      H % pair::HC || H > 1024)
    return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)out | (size_t)packed) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const pair::Src s1 = {(const float*)lnw1, (const float*)lnb1, w11, b11, w12, b12};
  const pair::Src s2 = {(const float*)lnw2, (const float*)lnb2, w21, b21, w22, b22};
  const long long work =
      2LL * (H / pair::HC) * (pair::CHUNK_BYTES / 16) + 2 * pair::nparams(H) + 2 * pair::LUT_HALF;
  pair::pack_kernel<<<(unsigned)((work + 255) / 256), 256, 0, s>>>(s1, s2, H, wbf16,
                                                                   (unsigned char*)packed);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = pair::smem_bytes(H);
  err = cudaFuncSetAttribute(pair::pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (int)((nrows + pair::BM - 1) / pair::BM);
  const int grid = ntiles < sm90::num_sms() ? ntiles : sm90::num_sms();
  pair::pair_kernel<<<grid, pair::THREADS, smem, s>>>((const bf16*)x, (bf16*)out, (int)nrows, H,
                                                      (const unsigned char*)packed);
  return (int)cudaGetLastError();
}
