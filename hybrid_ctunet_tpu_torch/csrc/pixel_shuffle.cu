// Anisotropic 3D pixel shuffle fused with the per-voxel Linear C' -> F:
// out[b, x*f0+i, y*f1+j, z*f2+k, :] = bias + sum_c' x[b, x, y, z, c] W[:, c']
// with c = ((c'*f0 + i)*f1 + j)*f2 + k (C' slowest, the reference reshape).
//
// Replaces hybrid_ctunet_tpu/ops/shuffle_pallas.py:_impl (_kernel), the
// Pallas kernel behind fused_pixel_shuffle. Numerics follow
// reference_shuffle: bf16 x bf16 products summed in fp32, rounded to bf16,
// then the bf16 bias added and rounded.
//
// Bound: memory. K = C' is 32-96 on TUNet's pyramid, so the product is a few
// FLOP a byte; what the card must do is read x once and write the output
// once (0.203 ms of the 0.314 a TUNet chunk is the (4,48,48,96,128) ->
// (2,2,1) -> 64 site). The unfused path writes the 8-D transpose of x to
// device memory and reads it back before the matmul.
// Design: a persistent grid of 4-warp CTAs (as many as fit an SM: 4 at
// C 128, 3 at 256, 2 wider), W and the bias resident in shared memory for
// the CTA's life (brought in by cp.async, all pieces in flight at once; W
// rows padded by 16 bytes, so the B fragments load without bank
// conflicts). A warp's work item is a group of 8 consecutive voxels (one
// contiguous 8 x C run of x) and one pass of 64 output features. A lane
// copies whole 16-byte pieces of its voxel's channels by cp.async into a
// ring of its own in shared memory, 2-3 items ahead of the one it computes
// (it waits only for its own copies; at C 512 and 768 it loads them
// directly), and forms the C'-major A
// fragments of mma.sync m16n8k16 with byte permutes: a piece holds, for
// one or two c', the values of every sub-position, so one load serves every
// sub-position's fragment and nothing goes through shared memory. A
// fragment's rows are the voxel's sub-positions 2σ and 2σ+1 (rows g and
// g+8), so each lane owns one voxel's output. The fp32 results are
// rounded, biased, transposed within each quad of lanes (four shuffles) so
// that a lane holds 16 contiguous output bytes, and stored: every warp
// store writes 64-byte runs of 8 output rows. The wide sites (C' 64 and 96,
// 1,728 and 13,824 voxels) are too small to stream at the memory's rate:
// there the passes over F spread the work over the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace ps {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int VG = 8;    // voxels a warp's group
constexpr int NT = 8;    // n tiles of 8 output features a pass

template <int DIV, int CP>
struct Shape {
  static constexpr int C = CP * DIV;
  static constexpr int NL = C / 32;  // 16-byte loads a lane a group
  static constexpr int KS = CP / 16;  // k steps
  static constexpr int LD = CP + 8;   // W rows in shared memory
  // stages of each lane's cp.async ring of its pieces (0: loaded directly,
  // C 512 and 768, where a 2-stage ring measured slower)
  static constexpr int STAGES = NL <= 4 ? 4 : NL <= 8 ? 3 : 0;
  static constexpr int RING_BYTES = WARPS * STAGES * NL * 32 * 16;
  // CTAs an SM (registers: 128, 170, 255 a thread)
  static constexpr int MIN_BLOCKS = C <= 128 ? 4 : C <= 256 ? 3 : 2;
};

__device__ __forceinline__ void mma16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t* w, int i) {
  return i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
}

// sub-position s of the channel pair (c', c' + 1) as a bf16 pair (c' low),
// from the piece(s) that hold the pair: DIV 8, one piece a c'; DIV 4, one
// piece for both (c' then c' + 1, four sub-positions each)
template <int DIV>
__device__ __forceinline__ uint32_t pair_at(const uint4* piece, int s) {
  const uint32_t sel = s % 2 ? 0x7632u : 0x5410u;
  if constexpr (DIV == 8)
    return prmt(word(piece[0], s / 2), word(piece[1], s / 2), sel);
  else
    return prmt(word(piece[0], s / 2), word(piece[0], s / 2 + 2), sel);
}

// index, in its voxel's row of C/8 pieces of 16 bytes, of the lane's piece
// j (j = (2 ks + hl) DIV/4 + u): per k step ks, the pieces of the channel
// pairs (16ks + 2t4, +1) (hl 0) and (16ks + 8 + 2t4, +1) (hl 1)
template <int DIV>
__device__ __forceinline__ int piece(int j, int t4) {
  const int ks = j / (DIV / 2), hl = (j / (DIV / 4)) % 2, u = j % (DIV / 4);
  return (16 * ks + 8 * hl + 2 * t4) * DIV / 8 + u;
}

template <int DIV, int CP>
__global__ void __launch_bounds__(THREADS, Shape<DIV, CP>::MIN_BLOCKS)
    shuffle_kernel(const bf16* __restrict__ x, const void* __restrict__ w,
                   const void* __restrict__ bias, int wbf16, bf16* __restrict__ out, int V, int X,
                   int Y,
                   int Z, int f0, int f1, int f2, int F) {
  using S = Shape<DIV, CP>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);  // [F][LD]
  __nv_bfloat162* sBias = reinterpret_cast<__nv_bfloat162*>(sW + F * S::LD);
  // W and the bias in, rounded to bf16 from the caller's fp32 or bf16, 8
  // values a piece, several pieces' loads in flight a thread
  const int npieces = F * (CP / 8) + F / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < npieces; i += THREADS) {
    const bool is_w = i < F * (CP / 8);
    const int n = i / (CP / 8), part = i % (CP / 8), j = i - F * (CP / 8);
    const size_t off = is_w ? (size_t)n * CP + part * 8 : (size_t)j * 8;
    const void* src = is_w ? w : bias;
    uint4 v;
    if (wbf16) {
      v = *reinterpret_cast<const uint4*>(reinterpret_cast<const bf16*>(src) + off);
    } else {
      const float4 lo = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(src) + off);
      const float4 hi =
          *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(src) + off + 4);
      v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w), pack_bf16(hi.x, hi.y),
                     pack_bf16(hi.z, hi.w));
    }
    *reinterpret_cast<uint4*>(is_w ? sW + n * S::LD + part * 8
                                   : reinterpret_cast<bf16*>(sBias) + j * 8) = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  // work items: a group of VG voxels and one pass of 8 NT output features
  const int nbt = F / (8 * NT), items = (V + VG - 1) / VG * nbt;
  const int step = gridDim.x * WARPS;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  // the lane's ring: [stage][piece][lane], each lane waiting only for its
  // own copies (cp.async groups), STAGES - 1 items ahead
  uint4* ring = reinterpret_cast<uint4*>(sBias + F / 2) + warp * (S::STAGES * S::NL * 32);
  auto issue = [&](int it, int stage) {
    const int v = it / nbt * VG + g;
    const bool ok = it < items && v < V;
    const uint4* src = xv + (ok ? (size_t)v * (S::C / 8) : 0);
#pragma unroll
    for (int j = 0; j < S::NL; ++j)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       (uint32_t)__cvta_generic_to_shared(ring + (stage * S::NL + j) * 32 + lane)),
                   "l"(src + piece<DIV>(j, t4)), "r"(ok ? 16 : 0)
                   : "memory");
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  int item = blockIdx.x * WARPS + warp;
#pragma unroll
  for (int st = 0; st + 1 < S::STAGES; ++st) issue(item + st * step, st);
  for (int k = 0; item < items; item += step, ++k) {
    uint4 cur[S::NL];
    if constexpr (S::STAGES > 0) {
      issue(item + (S::STAGES - 1) * step, (k + S::STAGES - 1) % S::STAGES);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(S::STAGES > 0 ? S::STAGES - 1 : 0)
                   : "memory");
#pragma unroll
      for (int j = 0; j < S::NL; ++j) cur[j] = ring[((k % S::STAGES) * S::NL + j) * 32 + lane];
    } else {
      const int v = item / nbt * VG + g;
#pragma unroll
      for (int j = 0; j < S::NL; ++j)
        cur[j] = v < V ? __ldg(xv + (size_t)v * (S::C / 8) + piece<DIV>(j, t4))
                       : make_uint4(0, 0, 0, 0);
    }
    const int v = item / nbt * VG + g, nb = item % nbt * (8 * NT);
    int t = v / Z;
    const int z = v - t * Z;
    const int y = t % Y;
    t /= Y;
    const int xx = t % X, b = t / X;
#pragma unroll
    for (int sg = 0; sg < DIV / 2; ++sg) {  // sub-positions 2 sg (row g), 2 sg + 1 (row g + 8)
      float acc[NT][4];
#pragma unroll
      for (int ks = 0; ks < S::KS; ++ks) {
        const uint4* lo = cur + (2 * ks) * (DIV / 4);
        const uint4* hi = cur + (2 * ks + 1) * (DIV / 4);
        const uint32_t a[4] = {pair_at<DIV>(lo, 2 * sg), pair_at<DIV>(lo, 2 * sg + 1),
                               pair_at<DIV>(hi, 2 * sg), pair_at<DIV>(hi, 2 * sg + 1)};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (ks == 0)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
          const bf16* wr = sW + (nb + 8 * n + g) * S::LD + 16 * ks + 2 * t4;
          mma16816(acc[n], a, *reinterpret_cast<const uint32_t*>(wr),
                   *reinterpret_cast<const uint32_t*>(wr + 8));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = 2 * sg + r, i = s / (f1 * f2), j = (s / f2) % f1, k = s % f2;
        bf16* dst = out +
                    ((((size_t)b * X + xx) * f0 + i) * ((size_t)Y * f1) + (size_t)y * f1 + j) *
                        ((size_t)Z * f2) * F +
                    ((size_t)z * f2 + k) * F + nb + 8 * t4;
#pragma unroll
        for (int m = 0; m < NT / 4; ++m) {
          uint32_t wv[4], rcv[4], o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int n = 4 * m + q;
            const __nv_bfloat162 y2 =
                __hadd2(__floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]),
                        sBias[(nb + 8 * n + 2 * t4) / 2]);
            wv[q] = *reinterpret_cast<const uint32_t*>(&y2);
          }
          // lane t4 gets n-tile 4m + t4 from the quad: 16 contiguous bytes
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            rcv[rr] = __shfl_sync(0xffffffffu, pick4(wv, (t4 - rr) & 3),
                                  (lane & ~3) | ((t4 + rr) & 3));
#pragma unroll
          for (int q = 0; q < 4; ++q) o[q] = pick4(rcv, (q - t4) & 3);
          if (v < V) *reinterpret_cast<uint4*>(dst + 32 * m) = make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    }
  }
}

template <int DIV, int CP>
static cudaError_t launch(const bf16* x, const void* w, const void* bias, int wbf16, bf16* out,
                          int V,
                          int X, int Y, int Z, int f0, int f1, int f2, int F, cudaStream_t s) {
  const size_t smem =
      (size_t)F * Shape<DIV, CP>::LD * 2 + (size_t)F * 2 + Shape<DIV, CP>::RING_BYTES;
  auto kernel = shuffle_kernel<DIV, CP>;
  // the shared-memory opt-in and the resident CTAs, once per F (the host
  // time of a small call is of the order of its kernel's)
  static int cached_f = -1, resident = 0;
  if (F != cached_f) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
    cached_f = F;
  }
  const long long want =
      ((long long)(V + VG - 1) / VG * (F / (8 * NT)) + WARPS - 1) / WARPS;
  kernel<<<(unsigned)(want < resident ? want : resident), THREADS, smem, s>>>(
      x, w, bias, wbf16, out, V, X, Y, Z, f0, f1, f2, F);
  return cudaGetLastError();
}

}  // namespace ps

// x: (B, X, Y, Z, C) bf16 with C = Cp*f0*f1*f2, f0*f1*f2 4 or 8, Cp 32, 64
// or 96; w: (F, Cp) (torch Linear layout), F a multiple of 64, and bias:
// (F), both fp32 if wbf16 == 0, else bf16; out: (B, X*f0, Y*f1, Z*f2, F)
// bf16. All 16-byte aligned.
extern "C" int pixel_shuffle_linear(const void* x, const void* w, const void* bias, int wbf16,
                                    void* out, int B, int X, int Y, int Z, int f0, int f1, int f2,
                                    int Cp, int F, void* stream) {
  const int div = f0 * f1 * f2;
  const long long V = (long long)B * X * Y * Z;
  if (B < 1 || V > 0x7fffffffLL - 64 || F < 8 * ps::NT || F % (8 * ps::NT) ||
      (div != 4 && div != 8))
    return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)w | (size_t)bias | (size_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
  const bf16* xp = (const bf16*)x;
  bf16* op = (bf16*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int v = (int)V;
#define PS_LAUNCH(D, P)                                                          \
  if (div == D && Cp == P)                                                       \
    return (int)ps::launch<D, P>(xp, w, bias, wbf16, op, v, X, Y, Z, f0, f1, f2, F, s);
  PS_LAUNCH(4, 32)
  PS_LAUNCH(4, 64)
  PS_LAUNCH(4, 96)
  PS_LAUNCH(8, 32)
  PS_LAUNCH(8, 64)
  PS_LAUNCH(8, 96)
#undef PS_LAUNCH
  return (int)cudaErrorInvalidValue;
}
