// Bias-free kernel == stride ConvTranspose3d as one GEMM with an
// interleaving store:
// out[b, x*k0+i, y*k1+j, z*k2+l, co] = sum_ci x[b, x, y, z, ci] W[ci, co, i, j, l]
//
// Replaces hybrid_ctunet_tpu/ops/shuffle_pallas.py:_impl as reached through
// fused_transp_conv (the factor-dot kernel with a dense per-factor weight).
// Numerics follow reference_transp_kxs: bf16 x bf16 products summed in fp32,
// rounded to bf16 once.
//
// Bound: the GEMM does 2*Cin FLOP per output element against 2 bytes
// written. At the four decoder sites of CUNet/CTUNet (4 windows; Cin -> Cout
// 1024->512 and 512->256 at stride 2^3 are bound by operations, 256->128 at
// 2^3 by its 57 MB input and 226 MB output, 128->64 at (2,2,1) by its 226 MB
// input and 453 MB output.
// Design (Hopper): M = input voxels, K = Cin, N = (k0 k1 k2) x Cout, column
// n = s * Cout + co for sub-position s.
// - A first launch packs the weight, fp32 or bf16 in torch's (Cin, Cout, k0,
//   k1, k2) layout as the caller holds it, into a bf16 (N, K) scratch: no
//   torch op touches the weight per call.
// - A persistent grid (one CTA per SM) walks 128 x 128 output tiles, N
//   fastest, so the N tiles of an M tile run side by side and the x rows they
//   share come from L2. A producer warp keeps a 4-stage ring of 128 x 64 A
//   and B tiles filled by TMA (128-byte swizzle, ragged rows zero-filled);
//   two consumer warpgroups each run wgmma m64n128k16 on 64 rows, so the
//   next tile's loads overlap this tile's products and stores.
// - The epilogue rounds the accumulator to bf16 into a padded shared tile
//   (no bank conflicts) and stores it 16 bytes a thread: each tile row is
//   one sub-position's run of 128 contiguous output channels (two runs of 64
//   at Cout 64), so every 32-byte sector is written whole. Row offsets are
//   32-bit index arithmetic once per tile row.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 128;  // voxels per tile, 64 per consumer warpgroup
constexpr int BN = 128;  // output columns per tile
constexpr int BK = 64;   // input channels per stage (one 128-byte swizzle row)
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * CONSUMERS + 32;  // + the producer warp
constexpr int TILE_BYTES = BM * BK * 2;        // A or B stage tile: 16 KB
constexpr int LDC = BN + 8;                    // staging row length (bf16): 272 B
constexpr int STAGE_C_BYTES = 64 * LDC * 2;    // one warpgroup's staged rows
constexpr int SMEM = STAGES * 2 * TILE_BYTES + CONSUMERS * STAGE_C_BYTES +
                     CONSUMERS * 64 * 8 + 2 * STAGES * 8 + 1024;

struct Geom {
  int M, K, N, X, Y, Z, k0, k1, k2, Cout;
};

__global__ void __launch_bounds__(THREADS, 1)
    transp_conv_kernel(const __grid_constant__ CUtensorMap tmA,
                       const __grid_constant__ CUtensorMap tmB, bf16* __restrict__ out,
                       const Geom g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* sA = base;                       // [STAGES][128 rows][128 B]
  unsigned char* sB = base + STAGES * TILE_BYTES;  // [STAGES][128 rows][128 B]
  bf16* sC = reinterpret_cast<bf16*>(base + 2 * STAGES * TILE_BYTES);
  long long* sRow = reinterpret_cast<long long*>(base + 2 * STAGES * TILE_BYTES +
                                                 CONSUMERS * STAGE_C_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(sRow + CONSUMERS * 64);
  uint64_t* empty = full + STAGES;

  const int ntn = g.N / BN, KT = g.K / BK;
  const int ntiles = ((g.M + BM - 1) / BM) * ntn;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], CONSUMERS);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // producer warp: one thread issues every load
    if (threadIdx.x % 32) return;
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const int m0 = (tile / ntn) * BM, n0 = (tile % ntn) * BN;
      for (int kt = 0; kt < KT; ++kt) {
        sm90::bar_wait(&empty[s], ph ^ 1);
        sm90::bar_expect_tx(&full[s], 2 * TILE_BYTES);
        sm90::tma_load_2d(sA + s * TILE_BYTES, &tmA, kt * BK, m0, &full[s]);
        sm90::tma_load_2d(sB + s * TILE_BYTES, &tmB, kt * BK, n0, &full[s]);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  bf16* cs = sC + wg * 64 * LDC;
  long long* rows = sRow + wg * 64;
  const long long Xo = (long long)g.X * g.k0, Yo = (long long)g.Y * g.k1,
                  Zo = (long long)g.Z * g.k2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int m0 = (tile / ntn) * BM + wg * 64, n0 = (tile % ntn) * BN;
    int prev = 0;
    for (int kt = 0; kt < KT; ++kt) {
      sm90::bar_wait(&full[s], ph);
      sm90::wg_fence();
      const uint64_t da = sm90::desc_sw128(sA + s * TILE_BYTES + wg * 64 * 128);
      const uint64_t db = sm90::desc_sw128(sB + s * TILE_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        sm90::wgmma_64x128_ss(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      sm90::wg_commit();
      if (kt > 0) {
        sm90::wg_wait<1>();  // the previous stage's products are done
        if (t == 0) sm90::bar_arrive(&empty[prev]);
      }
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ph ^= 1;
      }
    }
    sm90::wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 64; ++i) sm90::reg_fence(acc[i]);
    if (t == 0) sm90::bar_arrive(&empty[prev]);

    // each row's output offset at sub-position 0 (-1 past M)
    if (t < 64) {
      const int m = m0 + t;
      long long o = -1;
      if (m < g.M) {
        const int zz = m % g.Z, r1 = m / g.Z;
        const int yy = r1 % g.Y, r2 = r1 / g.Y;
        const int xx = r2 % g.X, b = r2 / g.X;
        o = (((b * Xo + xx * g.k0) * Yo + yy * g.k1) * Zo + zz * g.k2) * g.Cout;
      }
      rows[t] = o;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(cs + (r0 + 8 * half) * LDC + 8 * i + cq) =
            sm90::pack_bf16(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
    sm90::named_sync(1 + wg, 128);

    // a thread stores the 8-column group cg of rows t/16, t/16 + 8, ...
    const int cg = t % 16, n = n0 + 8 * cg;
    const int sp = n / g.Cout, co = n % g.Cout;
    const int si = sp / (g.k1 * g.k2), sj = (sp / g.k2) % g.k1, sl = sp % g.k2;
    const long long coff = ((si * Yo + sj) * Zo + sl) * g.Cout + co;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int r = t / 16 + 8 * u;
      const long long o = rows[r];
      if (o >= 0)
        *reinterpret_cast<uint4*>(out + o + coff) =
            *reinterpret_cast<const uint4*>(cs + r * LDC + 8 * cg);
    }
    sm90::named_sync(1 + wg, 128);  // before the next tile's staging
  }
}

// Bp[s * Cout + co][ci] = bf16(w[ci][co][s]): a 32 x 32 tiled transpose of w
// viewed as (K, Cout * S), columns permuted on the way out
__global__ void pack_kernel(const void* __restrict__ w, int bf, bf16* __restrict__ bp, int K,
                            int Cout, int S) {
  __shared__ float tile[32][33];
  const int nn = Cout * S, c0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int k = k0 + r, c = c0 + threadIdx.x;
    if (k < K && c < nn) {
      const long long i = (long long)k * nn + c;
      tile[r][threadIdx.x] = bf ? __bfloat162float(reinterpret_cast<const bf16*>(w)[i])
                                : reinterpret_cast<const float*>(w)[i];
    }
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += blockDim.y) {
    const int c = c0 + r, k = k0 + threadIdx.x;
    if (c < nn && k < K)
      bp[(long long)((c % S) * Cout + c / S) * K + k] = __float2bfloat16(tile[threadIdx.x][r]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// a (rows, K) row-major bf16 matrix read as 128-row x 64-column boxes
bool encode(CUtensorMap* map, const void* ptr, long long rows, int K) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {BK, BM};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x: (B, X, Y, Z, K) bf16; w: (K, Cout, k0, k1, k2), fp32 (wbf16 == 0) or
// bf16, torch's ConvTranspose3d layout; wp: (k0 k1 k2 Cout, K) bf16 scratch
// that the first launch fills; out: (B, X*k0, Y*k1, Z*k2, Cout) bf16.
extern "C" int transp_conv_kxs(const void* x, const void* w, int wbf16, void* wp, void* out,
                               int B, int X, int Y, int Z, int k0, int k1, int k2, int K,
                               int Cout, void* stream) {
  const long long M = (long long)B * X * Y * Z;
  const long long N = (long long)k0 * k1 * k2 * Cout;
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || k0 < 1 || k1 < 1 || k2 < 1 || K < BK || K % BK ||
      Cout % 8 || N % BN || M > 0x7fffffffLL - BM || N > 0x7fffffffLL ||
      ((M + BM - 1) / BM) * (N / BN) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)wp | (size_t)out) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  const int S = k0 * k1 * k2;
  pack_kernel<<<dim3((unsigned)((N + 31) / 32), (unsigned)((K + 31) / 32)), dim3(32, 8), 0, s>>>(
      w, wbf16, (bf16*)wp, K, Cout, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tmA, tmB;
  if (!encode(&tmA, x, M, K) || !encode(&tmB, wp, N, K)) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(transp_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long ntiles = ((M + BM - 1) / BM) * (N / BN);
  const int grid = ntiles < sm90::num_sms() ? (int)ntiles : sm90::num_sms();
  const Geom g = {(int)M, K, (int)N, X, Y, Z, k0, k1, k2, Cout};
  transp_conv_kernel<<<grid, THREADS, SMEM, s>>>(tmA, tmB, (bf16*)out, g);
  return (int)cudaGetLastError();
}
