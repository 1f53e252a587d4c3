// Transformer FeedForward on Hopper: LN (fp32, eps 1e-5) -> fc1 -> erf-GELU
// -> fc2 (+ bias) [+ residual] (entry `ffn`, K3, C 128 or 256), and the pair
// form y = x + FFN1(x), z = y + FFN2(y) with y kept on chip (entry
// `ffn_pair`, K4, C 128).
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
// hidden element.
//
// Both entries share one design, a persistent grid (one CTA per SM) of two
// consumer warpgroups (64 rows each, a 128-row tile) and one producer
// warpgroup, which hands its registers to the consumers (setmaxnreg):
// - A first launch packs the layer's weights into bf16 chunk images in the
//   exact shared-memory layout wgmma reads (K-major, 128-byte swizzle): per
//   64-wide hidden chunk the 64 W1 rows, then the 64 W2 columns. So the
//   caller's fp32 or bf16 parameters are read as they are, with no torch op.
// - The producer streams the chunk images through a ring by bulk copy with
//   mbarriers.
// - fc1 is wgmma m64n64k16 with A the LN'd tile in shared memory. Its fp32
//   accumulator is rounded, biased and rounded in registers (bf16x2 adds),
//   GELU'd and rounded by a 6.5 KB table in shared memory (the erff
//   formula's bf16 result for every bf16 input that needs one: erff took
//   half of K4's time on an NVIDIA H100 80GB HBM3 at 700 W), and packed as
//   the register A operand of fc2's wgmma: the hidden activation never
//   leaves registers. fc2's 64 x C accumulator stays in registers for the
//   whole hidden loop.
// - fc2 of chunk j and fc1 of chunk j+1 are issued as one group; the two
//   warpgroups drift apart, so one's GELU runs under the other's wgmma.
//
// `ffn` (K3): fc2 issues C/128 wgmma m64n128k16 per k step, so at C 256 a
// consumer holds a 64 x 256 fp32 accumulator (128 registers) beside fc1's
// 32 and the 16 of the A operand, under the 232 that setmaxnreg gives it.
// Shared memory holds the ring (128 KB: entries of one chunk's W1 rows or
// its W2 columns, C x 128 bytes each), the LN'd tile and the parameters;
// x is not staged: the producer prefetches the CTA's next tile into L2,
// the consumers read their rows for the LN from there and again for the
// residual, and the output leaves through shared memory (over the LN'd
// rows) in whole 16-byte row pieces.
//
// `ffn_pair` (K4): the ring holds whole chunk images (32 KB, 3 stages); the
// producer also bulk-copies the next tile's x into the second of two x
// buffers while this tile computes; y = x + FFN1(x) overwrites x in shared
// memory, z overwrites y and leaves by one bulk store per warpgroup.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// What both entries share: the weight packing, the GELU table, the LN into a
// swizzled tile, fc1 and the GELU epilogue in registers.
namespace ffnk {

constexpr int HC = 64;          // hidden chunk
constexpr int BM = 128;         // rows per tile, 64 per consumer warpgroup
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int KB_BYTES = BM * 128;              // one 64-wide K block of the LN'd tile
// registers a thread after setmaxnreg: the producer gives its share to the
// consumers (the block is compiled at 65536 / 384 = 168)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

// chunk image of one FFN: W1 rows [64j, 64j+64) as C/64 K blocks of 64 rows x
// 128 B, then W2 columns [64j, 64j+64) as C rows x 128 B, each row swizzled
template <int C>
struct Chunk {
  static constexpr int W1_BYTES = HC * C * 2;
  static constexpr int BYTES = 2 * W1_BYTES;
};

// fp32 parameters per FFN in the packed buffer and in shared memory:
// lnw [C], lnb [C], b2 [C], b1 [H] (the biases rounded to bf16)
__host__ __device__ constexpr int nparams(int C, int H) { return 3 * C + H; }

// GELU table: the hidden value h is a bf16 number, so bf16(gelu(h)) is a
// function of its 16 bits. The table holds it, computed by the same fp32
// erff formula, for |h| in [2^-10, 8) (biased exponents 117..129, 1664
// values a sign). Outside, the formula reduces exactly: bf16(h / 2) below
// 2^-10, and h or -0 from 8 up (erff is +-1 there); checked against the
// formula for every bf16 value.
constexpr int LUT_E0 = 117;
constexpr int LUT_HALF = 13 * 128;
constexpr int LUT_BYTES = 2 * LUT_HALF * 2;

// packed: nffn x (H/64) chunk images, nffn x nparams floats, the table
__host__ size_t packed_bytes(int C, int nffn, int H) {
  return (size_t)nffn * (H / HC) * (2 * HC * C * 2) + (size_t)nffn * nparams(C, H) * 4 +
         LUT_BYTES;
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
// then one per GELU table entry; FFN f of the `nffn` (1 or 2) is s1 or s2.
template <int C>
__global__ void pack_kernel(Src s1, Src s2, int nffn, int H, int bf, unsigned char* packed) {
  constexpr int W1_BYTES = Chunk<C>::W1_BYTES, CHUNK_BYTES = Chunk<C>::BYTES;
  const int nch = H / HC, np = nparams(C, H);
  const long long units = (long long)nffn * nch * (CHUNK_BYTES / 16);
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
  if (i >= (long long)nffn * np) {
    const long long e = i - (long long)nffn * np;
    if (e >= 2 * LUT_HALF) return;
    const uint32_t bits = ((uint32_t)(e / LUT_HALF) << 15) | ((LUT_E0 << 7) + (uint32_t)(e % LUT_HALF));
    const bf16 g = __float2bfloat16(gelu(__uint_as_float(bits << 16)));
    reinterpret_cast<unsigned short*>(packed + units * 16 + (long long)nffn * np * 4)[e] =
        *reinterpret_cast<const unsigned short*>(&g);
    return;
  }
  const int f = (int)(i / np), c = (int)(i % np);
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

template <int C>
static cudaError_t pack(Src s1, Src s2, int nffn, int H, int bf, unsigned char* packed,
                        cudaStream_t s) {
  const long long work = (long long)nffn * (H / HC) * (Chunk<C>::BYTES / 16) +
                         (long long)nffn * nparams(C, H) + 2 * LUT_HALF;
  pack_kernel<C><<<(unsigned)((work + 255) / 256), 256, 0, s>>>(s1, s2, nffn, H, bf, packed);
  return cudaGetLastError();
}

// The warpgroup's 64 rows at src (row-major, the first `valid` of them read,
// the rest taken as 0) -> bf16(LN) into the swizzled K-major tile `as` (K
// block kb at as + kb * KB_BYTES); warp w does rows 16w..16w+15, four at a
// time so that their reductions overlap; a lane holds C/32 columns of each.
template <int C>
__device__ __forceinline__ void layer_norm_rows(const bf16* src, int valid, unsigned char* as,
                                                const float* lnw, const float* lnb, int warp,
                                                int lane) {
  constexpr int R = 4, PER = C / 32;
  static_assert(PER == 4 || PER == 8, "C 128 or 256");
  const int c0 = PER * lane;
  float w[PER], b[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    w[e] = lnw[c0 + e];
    b[e] = lnb[c0 + e];
  }
  for (int rr = 0; rr < 16; rr += R) {
    float v[R][PER], sum[R], ss[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = warp * 16 + rr + q;
      uint32_t raw[PER / 2];
#pragma unroll
      for (int e = 0; e < PER / 2; ++e) raw[e] = 0;
      if (r < valid) {
        if constexpr (PER == 4) {
          const uint2 u = *reinterpret_cast<const uint2*>(src + r * C + c0);
          raw[0] = u.x, raw[1] = u.y;
        } else {
          const uint4 u = *reinterpret_cast<const uint4*>(src + r * C + c0);
          raw[0] = u.x, raw[1] = u.y, raw[2] = u.z, raw[3] = u.w;
        }
      }
#pragma unroll
      for (int e = 0; e < PER / 2; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[e]));
        v[q][2 * e] = f.x, v[q][2 * e + 1] = f.y;
      }
      sum[q] = v[q][0];
#pragma unroll
      for (int e = 1; e < PER; ++e) sum[q] += v[q][e];
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
      for (int e = 0; e < PER; ++e) {
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
      uint32_t y[PER / 2];
#pragma unroll
      for (int e = 0; e < PER / 2; ++e)
        y[e] = sm90::pack_bf16(v[q][2 * e] * rstd * w[2 * e] + b[2 * e],
                               v[q][2 * e + 1] * rstd * w[2 * e + 1] + b[2 * e + 1]);
      unsigned char* dst = as + (c0 / 64) * KB_BYTES + sm90::swz(warp * 16 + rr + q, c0 % 64);
      if constexpr (PER == 4)
        *reinterpret_cast<uint2*>(dst) = make_uint2(y[0], y[1]);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(y[0], y[1], y[2], y[3]);
    }
  }
}

// fc1 of one chunk: h[64x64] = A (the warpgroup's LN'd rows) x W1c^T
template <int C>
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

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (sm90::smem_addr(p) & 1023)) & 1023);
}

}  // namespace ffnk

// ---------------------------------------------------------------------------
// K3: one FFN, C 128 or 256 (see the note at the head of the file)
namespace single {
using namespace ffnk;

constexpr int RING_BYTES = 128 * 1024;

template <int C>
struct Cfg {
  static constexpr int ENTRY = Chunk<C>::W1_BYTES;  // = C * 128: W1 rows or W2 columns of a chunk
  static constexpr int STAGES = RING_BYTES / ENTRY;
  static constexpr int A_BYTES = BM * C * 2;
  static constexpr int FIXED = RING_BYTES + A_BYTES + 128;  // + the mbarriers
};

template <int C>
__host__ size_t smem_bytes(int H) {
  return Cfg<C>::FIXED + nparams(C, H) * sizeof(float) + LUT_BYTES + 1024;  // + alignment slack
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    ffn_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int nrows, int H,
               int residual, const unsigned char* __restrict__ packed) {
  using K = Cfg<C>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* ring = base;
  unsigned char* sA = base + RING_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sA + K::A_BYTES);
  uint64_t* empty = full + K::STAGES;
  float* prm = reinterpret_cast<float*>(base + K::FIXED);
  unsigned short* lut = reinterpret_cast<unsigned short*>(prm + nparams(C, H));

  const int nch = H / HC;
  const int ntiles = (nrows + BM - 1) / BM;
  const float* gprm = reinterpret_cast<const float*>(packed + (size_t)nch * Chunk<C>::BYTES);
  for (int i = threadIdx.x; i < nparams(C, H) + LUT_BYTES / 4; i += THREADS) prm[i] = gprm[i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < K::STAGES; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], CONSUMERS);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x % 128) return;
    auto tile_bytes = [&](int tile) { return (uint32_t)min(BM, nrows - tile * BM) * C * 2; };
    const int first = blockIdx.x, step = gridDim.x;
    if (first < ntiles) sm90::bulk_prefetch_l2(x + (size_t)first * BM * C, tile_bytes(first));
    int s = 0;
    uint32_t ph = 0;
    for (int tile = first; tile < ntiles; tile += step) {
      const int next = tile + step;
      if (next < ntiles) sm90::bulk_prefetch_l2(x + (size_t)next * BM * C, tile_bytes(next));
      for (int q = 0; q < 2 * nch; ++q) {  // W1 rows, then W2 columns, of each chunk
        sm90::bar_wait(&empty[s], ph ^ 1);
        sm90::bar_expect_tx(&full[s], K::ENTRY);
        sm90::bulk_g2s(ring + s * K::ENTRY, packed + (size_t)q * K::ENTRY, K::ENTRY, &full[s]);
        if (++s == K::STAGES) {
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
  const float* b2 = prm + 2 * C;
  const float* b1 = prm + 3 * C;
  constexpr int NH = C / 128;  // fc2's 128-wide column halves
  float acc[64 * NH], h[32];
  uint32_t a[16];
#pragma unroll
  for (int i = 0; i < 64 * NH; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) h[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  auto take = [&]() {  // the next ring entry, once it has landed
    const int cur = s;
    sm90::bar_wait(&full[cur], ph);
    if (++s == K::STAGES) {
      s = 0;
      ph ^= 1;
    }
    return cur;
  };
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = (long long)tile * BM + wg * 64;
    const int valid = (int)max(0LL, min(64LL, (long long)nrows - row0));
    layer_norm_rows<C>(x + row0 * C, valid, as, prm, prm + C, warp, lane);
    sm90::fence_async_smem();
    sm90::named_sync(1 + wg, 128);

    int w1 = take();
    sm90::wg_fence();
    issue_fc1<C>(h, as, ring + w1 * K::ENTRY);
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) sm90::reg_fence(h[i]);
    if (t == 0) sm90::bar_arrive(&empty[w1]);
    gelu_pack(h, a, b1, cq, lut);
    for (int j = 0; j < nch; ++j) {
      const int w2 = take();
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < HC / 16; ++kk)
#pragma unroll
        for (int nh = 0; nh < NH; ++nh)
          sm90::wgmma_64x128_rs(acc + 64 * nh, a + 4 * kk,
                                sm90::desc_sw128(ring + w2 * K::ENTRY + nh * 128 * 128) + 2 * kk,
                                j > 0 || kk > 0);
      if (j + 1 < nch) {
        w1 = take();
        issue_fc1<C>(h, as, ring + w1 * K::ENTRY);
      }
      sm90::wg_commit();
      sm90::wg_wait<0>();
#pragma unroll
      for (int i = 0; i < 64 * NH; ++i) sm90::reg_fence(acc[i]);
#pragma unroll
      for (int i = 0; i < 32; ++i) sm90::reg_fence(h[i]);
#pragma unroll
      for (int i = 0; i < 16; ++i) sm90::reg_fence(a[i]);
      if (t == 0) {
        sm90::bar_arrive(&empty[w2]);
        if (j + 1 < nch) sm90::bar_arrive(&empty[w1]);
      }
      if (j + 1 < nch) gelu_pack(h, a, b1 + HC * (j + 1), cq, lut);
    }

    // bf16(bf16(acc) + b2), staged over the warpgroup's LN'd rows (the last
    // fc1 has read them), then [+ x] and out in 16-byte row pieces
#pragma unroll
    for (int nh = 0; nh < NH; ++nh)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int col = 128 * nh + 8 * i + cq;
        const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
        const __nv_bfloat162 b = __floats2bfloat162_rn(bb.x, bb.y);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int e = 64 * nh + 4 * i + 2 * half;
          *reinterpret_cast<__nv_bfloat162*>(as + (col / 64) * KB_BYTES +
                                             sm90::swz(r0 + 8 * half, col % 64)) =
              round_add(acc[e], acc[e + 1], b);
        }
      }
    sm90::named_sync(1 + wg, 128);
    for (int u = t; u < valid * (C / 8); u += 128) {
      const int row = u / (C / 8), col = (u % (C / 8)) * 8;
      uint4 o = *reinterpret_cast<const uint4*>(as + (col / 64) * KB_BYTES + sm90::swz(row, col % 64));
      const size_t g = (size_t)(row0 + row) * C + col;
      if (residual) {
        const uint4 xv = *reinterpret_cast<const uint4*>(x + g);
        __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
        const __nv_bfloat162* px = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
        for (int e = 0; e < 4; ++e) po[e] = __hadd2(po[e], px[e]);
      }
      *reinterpret_cast<uint4*>(out + g) = o;
    }
    sm90::named_sync(1 + wg, 128);  // read out before the next tile's LN
  }
}

template <int C>
static cudaError_t launch(const bf16* x, bf16* out, int nrows, int H, int residual,
                          const unsigned char* packed, cudaStream_t s) {
  const size_t smem = smem_bytes<C>(H);
  const cudaError_t err =
      cudaFuncSetAttribute(ffn_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (nrows + BM - 1) / BM;
  const int grid = ntiles < sm90::num_sms() ? ntiles : sm90::num_sms();
  ffn_kernel<C><<<grid, THREADS, smem, s>>>(x, out, nrows, H, residual, packed);
  return cudaGetLastError();
}

}  // namespace single

// bytes of the scratch `packed` that ffn takes for width C, hidden H
extern "C" int ffn_packed_bytes(int C, int H) { return (int)ffnk::packed_bytes(C, 1, H); }

// x, out: (nrows, C) bf16, C 128 or 256, 16-byte aligned. LN params fp32,
// weights and biases (fp32 if wbf16 == 0, else bf16) in torch Linear layout
// (fc1 (H, C), fc2 (C, H)); packed: ffn_packed_bytes(C, H) bytes of scratch
// that the first launch fills.
extern "C" int ffn(const void* x, void* out, long long nrows, int C, int H, int residual,
                   int wbf16, const void* lnw, const void* lnb, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* packed, void* stream) {
  if (nrows < 1 || nrows > 0x7fffffffLL - ffnk::BM || (C != 128 && C != 256) || H < ffnk::HC ||
      H % ffnk::HC || H > 1024)
    return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)out | (size_t)packed) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const ffnk::Src src = {(const float*)lnw, (const float*)lnb, w1, b1, w2, b2};
  unsigned char* pk = (unsigned char*)packed;
  cudaError_t err = C == 128 ? ffnk::pack<128>(src, src, 1, H, wbf16, pk, s)
                             : ffnk::pack<256>(src, src, 1, H, wbf16, pk, s);
  if (err != cudaSuccess) return (int)err;
  err = C == 128 ? single::launch<128>((const bf16*)x, (bf16*)out, (int)nrows, H, residual, pk, s)
                 : single::launch<256>((const bf16*)x, (bf16*)out, (int)nrows, H, residual, pk, s);
  return (int)err;
}

// ---------------------------------------------------------------------------
// K4: the pair on Hopper (see the note at the head of the file)
namespace pair {
using namespace ffnk;

constexpr int C = 128;                   // stage-3 width
constexpr int STAGES = 3;
constexpr int W1_BYTES = Chunk<C>::W1_BYTES;
constexpr int CHUNK_BYTES = Chunk<C>::BYTES;
constexpr int X_BYTES = BM * C * 2;
constexpr int A_BYTES = BM * C * 2;      // LN'd tile: 2 K blocks x 128 rows x 128 B
constexpr int FIXED_SMEM = STAGES * CHUNK_BYTES + 2 * X_BYTES + A_BYTES + 128;

__host__ size_t smem_bytes(int H) {
  return FIXED_SMEM + 2 * nparams(C, H) * sizeof(float) + LUT_BYTES + 1024;  // + alignment slack
}

__global__ void __launch_bounds__(THREADS, 1)
    pair_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int nrows, int H,
                const unsigned char* __restrict__ packed) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* ring = base;
  bf16* sX = reinterpret_cast<bf16*>(base + STAGES * CHUNK_BYTES);
  unsigned char* sA = base + STAGES * CHUNK_BYTES + 2 * X_BYTES;
  uint64_t* full_w = reinterpret_cast<uint64_t*>(sA + A_BYTES);
  uint64_t* empty_w = full_w + STAGES;
  uint64_t* full_x = empty_w + STAGES;
  uint64_t* empty_x = full_x + 2;
  float* prm = reinterpret_cast<float*>(base + FIXED_SMEM);
  unsigned short* lut = reinterpret_cast<unsigned short*>(prm + 2 * nparams(C, H));

  const int nch = H / HC;
  const int ntiles = (nrows + BM - 1) / BM;
  const float* gprm = reinterpret_cast<const float*>(packed + (size_t)2 * nch * CHUNK_BYTES);
  for (int i = threadIdx.x; i < 2 * nparams(C, H) + LUT_BYTES / 4; i += THREADS) prm[i] = gprm[i];
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
      const float* lnw = prm + f * nparams(C, H);
      const float* b2 = lnw + 2 * C;
      const float* b1 = lnw + 3 * C;
      layer_norm_rows<C>(xs, 64, as, lnw, lnw + C, warp, lane);
      sm90::fence_async_smem();
      sm90::named_sync(1 + wg, 128);

      sm90::bar_wait(&full_w[s], ph);
      sm90::wg_fence();
      issue_fc1<C>(h, as, ring + s * CHUNK_BYTES);
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
          issue_fc1<C>(h, as, ring + s * CHUNK_BYTES);
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
extern "C" int ffn_pair_packed_bytes(int H) { return (int)ffnk::packed_bytes(pair::C, 2, H); }

// x, out: (nrows, 128) bf16, 16-byte aligned. Per FFN: LN params fp32,
// weights and biases (fp32 if wbf16 == 0, else bf16) in torch Linear layout
// (fc1 (H, 128), fc2 (128, H)); packed: ffn_pair_packed_bytes(H) bytes of
// scratch that the first launch fills.
extern "C" int ffn_pair(const void* x, void* out, long long nrows, int C, int H, int wbf16,
                        const void* lnw1, const void* lnb1, const void* w11, const void* b11,
                        const void* w12, const void* b12, const void* lnw2, const void* lnb2,
                        const void* w21, const void* b21, const void* w22, const void* b22,
                        void* packed, void* stream) {
  if (nrows < 1 || nrows > 0x7fffffffLL - ffnk::BM || C != pair::C || H < ffnk::HC ||
      H % ffnk::HC || H > 1024)
    return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)out | (size_t)packed) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const ffnk::Src s1 = {(const float*)lnw1, (const float*)lnb1, w11, b11, w12, b12};
  const ffnk::Src s2 = {(const float*)lnw2, (const float*)lnb2, w21, b21, w22, b22};
  cudaError_t err = ffnk::pack<pair::C>(s1, s2, 2, H, wbf16, (unsigned char*)packed, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = pair::smem_bytes(H);
  err = cudaFuncSetAttribute(pair::pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (int)((nrows + ffnk::BM - 1) / ffnk::BM);
  const int grid = ntiles < sm90::num_sms() ? ntiles : sm90::num_sms();
  pair::pair_kernel<<<grid, ffnk::THREADS, smem, s>>>((const bf16*)x, (bf16*)out, (int)nrows, H,
                                                      (const unsigned char*)packed);
  return (int)cudaGetLastError();
}
