// Stride-1 SAME 3^3 convolution to 48 output channels, channels-last bf16,
// as an implicit GEMM on Hopper's tensor cores:
// out[b, x, y, z, n] = sum_{c, dx, dy, dz} w[n, c, dx, dy, dz] in[b, x+dx-1, y+dy-1, z+dz-1, c]
// with zeros outside the input. M = output voxels, N = 48, K = 27 taps x C.
// bf16 x bf16 products summed in fp32, the output rounded to bf16 once: what
// the direct conv of ops/conv.py::conv3d_same computes.
//
// Replaces no TPU kernel: the JAX package runs these convs on XLA
// (hybrid_ctunet_tpu/ops/conv.py:75), as the port ran them on cuDNN, whose
// kernels at 48 output channels (an sm80 implicit GEMM, and a generic sgemm
// at C 1) ran at ~15% of the card's bf16 rate on Swin-UNETR's decoder.
//
// Bound: 2 x 27 x C x 48 FLOP per output voxel against 2 C bytes read and 96
// written, so at C 48 and 96 the tensor cores bound it (~1300 and ~2600 FLOP
// a byte); at C 1 the 96-byte output rows bound it.
//
// Design at C % 16 == 0 (`c3_kernel`, the gate's C 48 and 96):
// - Work items are 8 x 8 x 8 output bricks of one sample, z fastest; a
//   persistent grid (one CTA per SM) walks them. A producer warp keeps a
//   3-stage ring filled; each stage is 16 input channels of the brick's
//   10 x 10 x 10 halo and the weights of those channels for all 27 taps.
// - The halo comes by one 5D TMA box load into [x][y][z][16 channels], 32
//   bytes a voxel, with the 32-byte swizzle. TMA's zero fill of the box
//   outside the tensor is the SAME padding, and a ragged brick needs no
//   other mask on its reads.
// - A tap's A operand is then the halo read at a shifted address: a 64-row
//   tile (8 y rows x 8 z) of output plane p at tap (dx, dy, dz) is the
//   descriptor of the halo at voxel (p + dx, dy, dz), the 8 z-neighbours of
//   a row one 8-row group, y rows 10 voxels apart (SBO). The swizzle acts on
//   address bits, so any voxel may start a descriptor (on an H100, one with
//   a base offset set from its start read wrong sums).
//   No im2col, no register A and no data movement per tap: each tap is one
//   wgmma m64n48k16 per output plane straight from the staged halo. (TMA's
//   im2col mode would stage each tap's rows anew; ldmatrix into registers
//   spends instructions and registers on what the descriptor does.) One
//   32-byte row a voxel, rather than two unswizzled 16-byte planes of 8
//   channels, halves the TMA's rows and the L2 sectors it reads: 15-20%
//   of the kernel's time on that card.
// - The weights (packed by a first launch, from the caller's fp32 or bf16
//   (48, C, 3, 3, 3) tensor, into the exact shared-memory image: per 16
//   channels and tap, [8-channel half][n][8], no swizzle) come by one bulk
//   copy a stage; the whole set is at most 249 KB and stays in L2.
// - Two consumer warpgroups each hold 4 output planes (4 x 24 fp32
//   accumulators) and issue 27 x 4 wgmmas a stage as one group; a stage is
//   released when the next stage's group has been issued, so the tensor
//   cores always have a group queued. Three stages (two lost 12-19% to the
//   loads) leave no room to stage the output: each thread stores its
//   accumulator rows' bf16 pairs, a quad of threads 16 contiguous bytes,
//   rows outside the output masked (as fast as a staged 16-byte store).
// At C 1 (`c3_c1_kernel`, encoder1's first conv) K is the 27 taps padded to
// 32: each warpgroup gathers a 64-voxel run's taps (one row, 27 values) into
// a shared A tile, issues two wgmma m64n48k16 against the resident weights
// and stores the 6 KB of output rows the run makes; three CTAs an SM hide
// the gather's latency behind the stores that bound it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int F = 48;                                 // output channels
constexpr int TX = 8, TY = 8, TZ = 8;                 // output brick
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;  // its halo
constexpr int CONSUMERS = 2;
constexpr int PLANES = TX / CONSUMERS;  // 64-row output planes a consumer holds
constexpr int THREADS = 128 * CONSUMERS + 32;           // + the producer warp
constexpr int HALO_BYTES = HX * HY * HZ * 32;         // 16 channels of the halo
constexpr int TAP_BYTES = 2 * F * 16;                  // a tap's 16 x 48 B operand
constexpr int W_BYTES = 27 * TAP_BYTES;                // 16 channels, all taps
constexpr int STAGE_BYTES = HALO_BYTES + W_BYTES;     // 73,472: 256-byte multiple
constexpr int STAGES = 3;
constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
constexpr int LDC = F + 8;                    // C 1 staging row (bf16): 112 B, no bank conflicts
constexpr int STAGE_C_BYTES = 64 * LDC * 2;  // one warpgroup's staged rows

constexpr int C1_WGS = 2;                 // warpgroups of a C 1 CTA, each on its own runs
constexpr int C1_A_BYTES = 4 * 64 * 16;  // [k / 8][row][8]
constexpr int C1_W_BYTES = 4 * F * 16;   // [k / 8][n][8]
constexpr int C1_SMEM = C1_W_BYTES + C1_WGS * (C1_A_BYTES + STAGE_C_BYTES) + 128;

struct Geom {
  int X, Y, Z, C, nx, ny, nz, items;
};

template <int A>
__device__ __forceinline__ unsigned char* align_up(unsigned char* p) {
  return p + ((A - (sm90::smem_addr(p) & (A - 1))) & (A - 1));
}

// one warpgroup's 64 x 48 accumulator, rounded to bf16, into its staging tile
__device__ __forceinline__ void stage_acc(bf16* cs, const float* acc, int t) {
  const int r0 = (t / 32) * 16 + (t % 32) / 4, cq = 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < F / 8; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(cs + (r0 + 8 * half) * LDC + 8 * i + cq) =
          sm90::pack_bf16(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
}

__global__ void __launch_bounds__(THREADS, 1)
    c3_kernel(const __grid_constant__ CUtensorMap tmx, const unsigned char* __restrict__ wp,
              bf16* __restrict__ out, const Geom g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_up<1024>(smem_raw);  // the halo's swizzle from a 1024-byte boundary
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int KC = g.C / 16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], CONSUMERS);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // producer warp: one thread issues every copy
    if (threadIdx.x % 32) return;
    int s = 0;
    uint32_t ph = 0;
    for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
      const int bz = item % g.nz, r1 = item / g.nz;
      const int by = r1 % g.ny, r2 = r1 / g.ny;
      const int bx = r2 % g.nx, b = r2 / g.nx;
      for (int kc = 0; kc < KC; ++kc) {
        sm90::bar_wait(&empty[s], ph ^ 1);
        unsigned char* st = base + s * STAGE_BYTES;
        sm90::bar_expect_tx(&full[s], STAGE_BYTES);
        sm90::tma_load_5d(st, &tmx, kc * 16, bz * TZ - 1, by * TY - 1, bx * TX - 1, b, &full[s]);
        sm90::bulk_g2s(st + HALO_BYTES, wp + (size_t)kc * W_BYTES, W_BYTES, &full[s]);
        if (++s == STAGES) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  const int t = threadIdx.x % 128;
  float acc[PLANES][24];
#pragma unroll
  for (int j = 0; j < PLANES; ++j)
#pragma unroll
    for (int i = 0; i < 24; ++i) acc[j][i] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  for (int item = blockIdx.x; item < g.items; item += gridDim.x) {
    const int bz = item % g.nz, r1 = item / g.nz;
    const int by = r1 % g.ny, r2 = r1 / g.ny;
    const int bx = r2 % g.nx, b = r2 / g.nx;
    int prev = 0;
    for (int kc = 0; kc < KC; ++kc) {
      sm90::bar_wait(&full[s], ph);
      sm90::wg_fence();
      const unsigned char* st = base + s * STAGE_BYTES;
      // halo voxel (wg * PLANES, 0, 0); a voxel is two 16-byte units of the address
      const uint64_t da = sm90::desc_sw32(st + wg * PLANES * HY * HZ * 32, HZ * 32);
      const uint64_t db = sm90::desc_plain(st + HALO_BYTES, F * 16, 8 * 16);
#pragma unroll
      for (int tap = 0; tap < 27; ++tap) {
        const int dx = tap / 9, dy = tap / 3 % 3, dz = tap % 3;
#pragma unroll
        for (int j = 0; j < PLANES; ++j)
          sm90::wgmma_64x48_ss(acc[j], da + 2 * (((j + dx) * HY + dy) * HZ + dz),
                               db + tap * (TAP_BYTES >> 4), kc > 0 || tap > 0);
      }
      sm90::wg_commit();
      if (kc > 0) {
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
    for (int j = 0; j < PLANES; ++j)
#pragma unroll
      for (int i = 0; i < 24; ++i) sm90::reg_fence(acc[j][i]);
    if (t == 0) sm90::bar_arrive(&empty[prev]);

    // thread t holds rows r0 and r0 + 8 (y = r / 8, z = r % 8), columns
    // 8 i + 2 (t % 4) + {0, 1} of each plane's tile
    const int r0 = (t / 32) * 16 + (t % 32) / 4;
#pragma unroll
    for (int j = 0; j < PLANES; ++j) {
      const int x = bx * TX + wg * PLANES + j;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + 8 * half, y = by * TY + r / 8, z = bz * TZ + r % 8;
        if (x < g.X && y < g.Y && z < g.Z) {
          bf16* o = out + ((((long long)b * g.X + x) * g.Y + y) * g.Z + z) * F + 2 * (t % 4);
#pragma unroll
          for (int i = 0; i < F / 8; ++i)
            *reinterpret_cast<uint32_t*>(o + 8 * i) =
                sm90::pack_bf16(acc[j][4 * i + 2 * half], acc[j][4 * i + 2 * half + 1]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(128 * C1_WGS, 3)
    c3_c1_kernel(const unsigned short* __restrict__ x, const uint4* __restrict__ wp,
                 bf16* __restrict__ out, const int B, const int X, const int Y, const int Z) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_up<128>(smem_raw);
  unsigned char* sW = base;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  unsigned char* sA = base + C1_W_BYTES + wg * C1_A_BYTES;
  bf16* cs = reinterpret_cast<bf16*>(base + C1_W_BYTES + C1_WGS * C1_A_BYTES) + wg * 64 * LDC;
  for (int i = threadIdx.x; i < C1_W_BYTES / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(sW)[i] = wp[i];
  sm90::fence_async_smem();
  __syncthreads();

  const long long M = (long long)B * X * Y * Z, runs = (M + 63) / 64;
  const uint64_t db = sm90::desc_plain(sW, F * 16, 8 * 16);
  const uint64_t da = sm90::desc_plain(sA, 64 * 16, 8 * 16);
  float acc[24];
#pragma unroll
  for (int i = 0; i < 24; ++i) acc[i] = 0.f;
  // thread t gathers taps 16 h .. 16 h + 15 of row r of the run
  const int r = t / 2, h = t % 2;
  for (long long run = (long long)blockIdx.x * C1_WGS + wg; run < runs;
       run += (long long)gridDim.x * C1_WGS) {
    const long long m = run * 64 + r;
    uint32_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = 0;
    if (m < M) {
      const int z = (int)(m % Z);
      const long long q = m / Z;
      const int y = (int)(q % Y), xx = (int)((q / Y) % X);
      const unsigned short* xs = x + (q / Y / X) * X * Y * Z;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int tap = 16 * h + k;
        const int ix = xx + tap / 9 - 1, iy = y + tap / 3 % 3 - 1, iz = z + tap % 3 - 1;
        if (tap < 27 && ix >= 0 && ix < X && iy >= 0 && iy < Y && iz >= 0 && iz < Z)
          v[k / 2] |= (uint32_t)__ldg(xs + ((long long)ix * Y + iy) * Z + iz) << (16 * (k % 2));
      }
    }
    *reinterpret_cast<uint4*>(sA + ((2 * h) * 64 + r) * 16) = make_uint4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<uint4*>(sA + ((2 * h + 1) * 64 + r) * 16) = make_uint4(v[4], v[5], v[6], v[7]);
    sm90::fence_async_smem();
    sm90::named_sync(1 + wg, 128);
    sm90::wg_fence();
    sm90::wgmma_64x48_ss(acc, da, db, 0);
    sm90::wgmma_64x48_ss(acc, da + 2 * 64, db + 2 * F, 1);  // k 16..31: two core matrices on
    sm90::wg_commit();
    sm90::wg_wait<0>();
#pragma unroll
    for (int i = 0; i < 24; ++i) sm90::reg_fence(acc[i]);
    stage_acc(cs, acc, t);
    sm90::named_sync(1 + wg, 128);
#pragma unroll
    for (int u = 0; u < 3; ++u) {  // the run's 64 rows are contiguous in the output
      const int piece = t + 128 * u, rr = piece / 6, c = piece % 6;
      if (run * 64 + rr < M)
        *reinterpret_cast<uint4*>(out + (run * 64 + rr) * F + 8 * c) =
            *reinterpret_cast<const uint4*>(cs + rr * LDC + 8 * c);
    }
    sm90::named_sync(1 + wg, 128);  // before the next run's A tile and staging
  }
}

// the weights (48, C, 3, 3, 3) as the kernels' B image, bf16: at C % 16 == 0
// [C / 16][tap][8-channel half][n][8], at C 1 [k / 8][n][8] over k = tap < 27
// and zeros to 32
__global__ void c3_pack_kernel(const void* __restrict__ w, int bf, bf16* __restrict__ wp, int C) {
  const int total = F * (C == 1 ? 32 : 27 * C);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int e = i % 8, n = (i / 8) % F;
    long long src = -1;
    if (C == 1) {
      const int k = (i / (8 * F)) * 8 + e;
      if (k < 27) src = (long long)n * 27 + k;
    } else {
      const int h = (i / (8 * F)) % 2, tap = (i / (16 * F)) % 27, kc = i / (16 * F * 27);
      src = ((long long)n * C + kc * 16 + h * 8 + e) * 27 + tap;
    }
    float v = 0.f;
    if (src >= 0)
      v = bf ? __bfloat162float(reinterpret_cast<const bf16*>(w)[src])
             : reinterpret_cast<const float*>(w)[src];
    wp[i] = __float2bfloat16(v);
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

// x (B, X, Y, Z, C) read as boxes of 16 channels x the halo, zeros outside
bool encode(CUtensorMap* map, const void* x, int B, int X, int Y, int Z, int C) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)C, (cuuint64_t)Z, (cuuint64_t)Y, (cuuint64_t)X,
                              (cuuint64_t)B};
  const cuuint64_t row = (cuuint64_t)C * 2;
  const cuuint64_t strides[4] = {row, row * Z, row * Z * Y, row * Z * Y * X};
  const cuuint32_t box[5] = {16, HZ, HY, HX, 1};
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// x: (B, X, Y, Z, C) bf16, C 1 or a multiple of 16; w: (48, C, 3, 3, 3), fp32
// (wbf16 == 0) or bf16, torch's Conv3d layout; wp: bf16 scratch of
// 48 x 32 elements at C 1, 48 x 27 x C otherwise, that the first launch
// fills; out: (B, X, Y, Z, 48) bf16.
extern "C" int conv3x3_48(const void* x, const void* w, int wbf16, void* wp, void* out, int B,
                          int X, int Y, int Z, int C, void* stream) {
  const long long M = (long long)B * X * Y * Z;
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || (C != 1 && (C < 16 || C % 16 || C > 1024)) ||
      M * (C > F ? C : F) > (1ll << 40))
    return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)wp | (size_t)out) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  c3_pack_kernel<<<C == 1 ? 6 : 27 * C / 16, 256, 0, s>>>(w, wbf16, (bf16*)wp, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (C == 1) {
    err = cudaFuncSetAttribute(c3_c1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C1_SMEM);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, c3_c1_kernel, 128 * C1_WGS,
                                                        C1_SMEM);
    if (err != cudaSuccess) return (int)err;
    const long long need = ((M + 63) / 64 + C1_WGS - 1) / C1_WGS;
    const long long cap = (long long)sm90::num_sms() * (per_sm > 0 ? per_sm : 1);
    c3_c1_kernel<<<(unsigned)(need < cap ? need : cap), 128 * C1_WGS, C1_SMEM, s>>>(
        (const unsigned short*)x, (const uint4*)wp, (bf16*)out, B, X, Y, Z);
    return (int)cudaGetLastError();
  }
  CUtensorMap tmx;
  if (!encode(&tmx, x, B, X, Y, Z, C)) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(c3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nx = (X + TX - 1) / TX, ny = (Y + TY - 1) / TY, nz = (Z + TZ - 1) / TZ;
  const long long items = (long long)B * nx * ny * nz;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = items < sm90::num_sms() ? (int)items : sm90::num_sms();
  const Geom g = {X, Y, Z, C, nx, ny, nz, (int)items};
  c3_kernel<<<grid, THREADS, SMEM, s>>>(tmx, (const unsigned char*)wp, (bf16*)out, g);
  return (int)cudaGetLastError();
}
