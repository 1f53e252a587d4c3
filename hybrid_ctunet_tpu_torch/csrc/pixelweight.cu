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
// Bound: per token 14 C^2 FLOP (two C -> 3C projections and the C -> C
// output) against 6 C bytes in and out, 7C/3 FLOP a byte: 299 at C 128
// (the H100's bf16 ridge, ~295: bytes and tensor cores bound it alike),
// 597 at 256 and 1195 at 512, where the tensor cores bound it. So the
// products have to run at the wgmma rate, and the weights (7 C^2 bf16,
// re-read from L2 for every row tile) must not become the stream that
// limits them: that stream is 14 C^2 bytes per tile of BM rows.
//
// Design: a persistent grid (one CTA per SM) of two consumer warpgroups and
// a producer warpgroup, which hands its registers to the consumers.
// - A first launch packs the weights (fp32 or bf16, torch layout, as the
//   caller holds them) into bf16 entries in the exact shared-memory layout
//   wgmma reads (K-major, 128-byte swizzle), in the order the consumers
//   take them: per head pair and head, one entry per 64-wide K block with
//   the head's q, k and v rows of stream 1 (N = 96), then stream 2's (at
//   C >= 256 its q|k and its v rows in entries of their own), then W_out's
//   64 columns of the pair in 128-row entries.
// - The producer streams the entries through a ring of 16 KB slots by
//   bulk copy with mbarriers, and prefetches the next tile's rows into L2.
// - Each consumer LayerNorms its rows of both streams into swizzled tiles
//   in shared memory (fp32 statistics, bf16 out; 8 lanes a row at C 128).
//   Per head, stream 1's q|k|v is one wgmma m64n96 chain over K = C,
//   rounded and packed to bf16 pairs; stream 2's follows. The cross-dots,
//   softmax and blend run on the accumulator fragments: a row's 32 head
//   channels sit in the 4 lanes of a quad, so two shuffles finish each head
//   sum. The blended head is packed straight into the register A operand
//   of the output projection (wgmma m64n128, A from registers), issued per
//   head pair (K = 64) into a 64 x N fp32 accumulator that lives for the
//   whole tile. The (rows, 3C) q/k/v never exist in memory.
// - Registers decide the rest. ptxas holds a 384-thread block to 168 a
//   thread, whatever setmaxnreg gives back later. C 128: a 128-row tile, 64
//   rows a consumer, both walking every head on the same entries; the
//   accumulators fit (64 + 48 + 24 + 16). C 256: the same tile, but the 64 x 256 accumulator
//   takes 128 registers, so stream 2's q|k (reduced to the cross-dots) and
//   v (blended) come in two chains; it still spills a little. C 512: a
//   64 x 512 accumulator would take 256, so the consumers share a 64-row
//   tile, each LayerNorms one stream, both compute every head (the
//   products of q/k/v twice: 1.86x the FLOP of the bound), and each owns
//   256 output columns.
// - The output leaves through shared memory (over the LN'd tile) in 16-byte
//   row pieces.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "sm90.cuh"

typedef __nv_bfloat16 bf16;

namespace pw {

constexpr int DH = 32;  // channels per head
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int QKV_BYTES = 96 * 128;  // one head's q, k, v rows of one stream, one K block
constexpr int O_BYTES = 128 * 128;   // 128 rows of W_out, one head pair's 64 columns
constexpr int SLOT = O_BYTES;
constexpr int SMEM_MAX = 232448;

template <int C>
struct Cfg {
  static constexpr bool SPLIT = C == 512;  // the consumers share 64 rows and split N
  static constexpr int BM = SPLIT ? 64 : 128;  // rows a tile
  static constexpr int KB = C / 64;            // K blocks
  static constexpr int NBT = C / 128;          // W_out entries a head pair
  static constexpr int NO = SPLIT ? C / 2 : C;  // output columns a consumer
  static constexpr int NB = NO / 128;
  static constexpr int KB_BYTES = BM * 128;  // one K block of an LN'd tile
  static constexpr int H_BYTES = BM * C * 2;
  static constexpr int FIT = (SMEM_MAX - 1024 - 256 - 2 * H_BYTES) / SLOT;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * SLOT + 2 * H_BYTES + 256;
  // C >= 256: stream 2's q|k (64 rows) and v (32 rows) come in entries of
  // their own, so that q2|k2 is reduced to the cross-dots before v2 exists
  // (the 64 x 256 output accumulator leaves no room for both)
  static constexpr bool TWO_PASS = NO >= 256;
  static constexpr int HEAD_ENTRIES = TWO_PASS ? 3 * KB : 2 * KB;
  static constexpr int ENTRIES = 2 * HEAD_ENTRIES + NBT;  // ring entries a head pair
  // bytes of entry e of a head pair
  __host__ __device__ static constexpr int entry_bytes(int e) {
    const int h = e % HEAD_ENTRIES;  // entry of its head
    if (e >= 2 * HEAD_ENTRIES) return O_BYTES;
    if (!TWO_PASS || h < KB) return QKV_BYTES;
    return h < 2 * KB ? 64 * 128 : 32 * 128;  // stream 2's q|k, then its v
  }
  static constexpr long long PAIR_BYTES = 4LL * KB * QKV_BYTES + (long long)NBT * O_BYTES;
  static_assert(STAGES > NBT, "the ring must hold a head pair's W_out entries and one more");
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (sm90::smem_addr(p) & 1023)) & 1023);
}

// The wgmma forms this kernel issues, each in two variants: accumulating
// into D ("+f"), and the first of a chain, which overwrites D ("=f"), so
// that the compiler holds no accumulator live across the code before it.
#define PW_R8(c, i)                                                                          \
  c(d[i + 0]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), \
      c(d[i + 7])
#define PW_R32(c, i) PW_R8(c, i), PW_R8(c, i + 8), PW_R8(c, i + 16), PW_R8(c, i + 24)
#define PW_REGS48                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
#define PW_REGS64                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define PW_REGS32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define PW_REGS16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define PW_ACC "+f"
#define PW_SET "=f"

// D[64x96] (+)= A[64x16] B[16x96]^T, A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_64x96_ss(float* d, uint64_t da, uint64_t db) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " PW_REGS48
               ", %48, %49, p, 1, 1, 0, 0;\n}\n"
               : PW_R32(PW_ACC, 0), PW_R8(PW_ACC, 32), PW_R8(PW_ACC, 40)
               : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_64x96_ss_first(float* d, uint64_t da, uint64_t db) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %50, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 " PW_REGS48
               ", %48, %49, p, 1, 1, 0, 0;\n}\n"
               : PW_R32(PW_SET, 0), PW_R8(PW_SET, 32), PW_R8(PW_SET, 40)
               : "l"(da), "l"(db), "r"(0));
}
// D[64xN] (+)= A[64x16] B[16xN]^T for N 64 and 32 (stream 2's q|k and v
// at C >= 256)
__device__ __forceinline__ void wgmma_64x64_ss(float* d, uint64_t da, uint64_t db, int first) {
  if (first)
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PW_REGS32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : PW_R32(PW_SET, 0)
                 : "l"(da), "l"(db), "r"(0));
  else
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PW_REGS32
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"
                 : PW_R32(PW_ACC, 0)
                 : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_64x32_ss(float* d, uint64_t da, uint64_t db, int first) {
  if (first)
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " PW_REGS16
                 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
                 : PW_R8(PW_SET, 0), PW_R8(PW_SET, 8)
                 : "l"(da), "l"(db), "r"(0));
  else
    asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " PW_REGS16
                 ", %16, %17, p, 1, 1, 0, 0;\n}\n"
                 : PW_R8(PW_ACC, 0), PW_R8(PW_ACC, 8)
                 : "l"(da), "l"(db), "r"(1));
}
// D[64x128] (+)= A[64x16] B[16x128]^T, A from registers, B from shared memory
__device__ __forceinline__ void wgmma_64x128_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PW_REGS64
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
               : PW_R32(PW_ACC, 0), PW_R32(PW_ACC, 32)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_64x128_rs_first(float* d, const uint32_t* a, uint64_t db) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PW_REGS64
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
               : PW_R32(PW_SET, 0), PW_R32(PW_SET, 32)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(0));
}
#undef PW_R8
#undef PW_R32
#undef PW_REGS48
#undef PW_REGS64
#undef PW_REGS32
#undef PW_REGS16
#undef PW_ACC
#undef PW_SET

__device__ __forceinline__ float load(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(reinterpret_cast<const bf16*>(p)[i])
            : reinterpret_cast<const float*>(p)[i];
}

// One thread per 16-byte unit of the packed weights (see the note at the
// head of the file); a QKV entry's row n is q (n < 32), k or v of the head.
template <int C>
__global__ void pack_kernel(const void* wqkv1, const void* wqkv2, const void* wout, int bf,
                            uint4* packed) {
  using K = Cfg<C>;
  constexpr long long PAIR_UNITS = K::PAIR_BYTES / 16;
  constexpr int QKV_UNITS = 4 * K::KB * (QKV_BYTES / 16);
  const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (C / 64) * PAIR_UNITS) return;
  const int p = (int)(q / PAIR_UNITS);
  int u = (int)(q % PAIR_UNITS);
  const void* src;
  long long off;
  if (u < QKV_UNITS) {
    constexpr int E = QKV_BYTES / 16, HEAD = 2 * K::KB * E;  // units of an entry, of a head
    const int h = 2 * p + u / HEAD, c = u % 8;
    int v = u % HEAD, stream = 0, kb, n;
    if (v >= K::KB * E) {
      v -= K::KB * E;
      stream = 1;
    }
    if (!stream || !K::TWO_PASS) {
      kb = v / E, n = (v % E) / 8;
    } else if (v < K::KB * (E * 2 / 3)) {  // q|k: 64-row entries
      kb = v / (E * 2 / 3), n = (v % (E * 2 / 3)) / 8;
    } else {  // v: 32-row entries
      v -= K::KB * (E * 2 / 3);
      kb = v / (E / 3), n = 64 + (v % (E / 3)) / 8;
    }
    src = stream ? wqkv2 : wqkv1;
    off = (long long)((n / DH) * C + h * DH + n % DH) * C + kb * 64 + ((c ^ (n & 7)) * 8);
  } else {
    u -= QKV_UNITS;
    const int nb = u / (O_BYTES / 16), n = (u % (O_BYTES / 16)) / 8, c = u % 8;
    src = wout;
    off = (long long)(nb * 128 + n) * C + 64 * p + ((c ^ (n & 7)) * 8);
  }
  uint4 v;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w[e] = sm90::pack_bf16(load(src, off + 2 * e, bf), load(src, off + 2 * e + 1, bf));
  packed[q] = v;
}

template <int C>
static cudaError_t pack(const void* wqkv1, const void* wqkv2, const void* wout, int bf,
                        void* packed, cudaStream_t s) {
  const long long units = (C / 64) * (Cfg<C>::PAIR_BYTES / 16);
  pack_kernel<C><<<(unsigned)((units + 255) / 256), 256, 0, s>>>(wqkv1, wqkv2, wout, bf,
                                                                (uint4*)packed);
  return cudaGetLastError();
}

// The warpgroup's 64 rows at src (row stride C; rows >= valid read as 0) ->
// bf16(LN) into the swizzled K-major tile at dst (K block kb at dst + kb *
// kb_bytes). Warp w does rows 16w..16w+15. A row is LPR lanes' (8 at C 128,
// so that a row's sums take 3 shuffles, not 5; 32 wider), each holding
// 16-byte pieces j of 8 channels (j LPR + lane) * 8; the loads of 64 / PER
// of the warp's row groups are in flight together.
template <int C>
__device__ __forceinline__ void ln_rows(const bf16* src, int valid, unsigned char* dst,
                                        int kb_bytes, const float* lnw, const float* lnb,
                                        int warp, int lane) {
  constexpr int LPR = C == 128 ? 8 : 32, PER = C / LPR, NP = PER / 8, RPI = 32 / LPR;
  constexpr int B = 64 / PER;  // row groups a round
  const int k = lane % LPR, rsub = lane / LPR;
  float w[PER], b[PER];
#pragma unroll
  for (int j = 0; j < NP; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      w[8 * j + e] = lnw[(j * LPR + k) * 8 + e];
      b[8 * j + e] = lnb[(j * LPR + k) * 8 + e];
    }
#pragma unroll
  for (int r0 = 0; r0 < 16; r0 += B * RPI) {
    float v[B][PER], st[B];
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const int r = warp * 16 + r0 + q * RPI + rsub;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        uint4 u = make_uint4(0, 0, 0, 0);
        if (r < valid) u = *reinterpret_cast<const uint4*>(src + (size_t)r * C + (j * LPR + k) * 8);
        const uint32_t raw[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[e]));
          v[q][8 * j + 2 * e] = f.x, v[q][8 * j + 2 * e + 1] = f.y;
        }
      }
      st[q] = v[q][0];
#pragma unroll
      for (int e = 1; e < PER; ++e) st[q] += v[q][e];
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < B; ++q) st[q] += __shfl_xor_sync(0xffffffffu, st[q], off);
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const float mean = st[q] / C;
      st[q] = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        v[q][e] -= mean;
        st[q] += v[q][e] * v[q][e];
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int q = 0; q < B; ++q) st[q] += __shfl_xor_sync(0xffffffffu, st[q], off);
#pragma unroll
    for (int q = 0; q < B; ++q) {
      const float rstd = rsqrtf(st[q] / C + 1e-5f);
      const int r = warp * 16 + r0 + q * RPI + rsub;
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        uint32_t y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * j + 2 * e;
          y[e] = sm90::pack_bf16(v[q][i] * rstd * w[i] + b[i],
                                 v[q][i + 1] * rstd * w[i + 1] + b[i + 1]);
        }
        const int c = (j * LPR + k) * 8;
        *reinterpret_cast<uint4*>(dst + (c / 64) * kb_bytes + sm90::swz(r, c % 64)) =
            make_uint4(y[0], y[1], y[2], y[3]);
      }
    }
  }
}

// a consumer's position in the ring: slot and phase parity
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages;
  int s;
  uint32_t ph;
  __device__ __forceinline__ int take() {  // the next entry, once it has landed
    const int cur = s;
    sm90::bar_wait(&full[cur], ph);
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
    return cur;
  }
  __device__ __forceinline__ void release(int slot, int t) {
    if (t == 0) sm90::bar_arrive(&empty[slot]);
  }
  __device__ __forceinline__ const unsigned char* slot(int i) const { return base + i * SLOT; }
};

// acc[64 x N] = A (the consumer's LN'd rows of one stream, K = C) x the
// head's next K::KB entries (N 96: q|k|v; 64: q|k; 32: v), each entry
// released once the wgmma group that read it has completed
template <int C, int N>
__device__ __forceinline__ void qkv_chain(float* acc, const unsigned char* as, Ring& ring, int t) {
  using K = Cfg<C>;
  sm90::wg_fence();
  int prev = 0;
#pragma unroll
  for (int kb = 0; kb < K::KB; ++kb) {
    const int cur = ring.take();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = sm90::desc_sw128(as + kb * K::KB_BYTES) + 2 * kk;
      const uint64_t db = sm90::desc_sw128(ring.slot(cur)) + 2 * kk;
      const int first = kb == 0 && kk == 0;
      if constexpr (N == 96) {
        if (first)
          wgmma_64x96_ss_first(acc, da, db);
        else
          wgmma_64x96_ss(acc, da, db);
      } else if constexpr (N == 64) {
        wgmma_64x64_ss(acc, da, db, first);
      } else {
        wgmma_64x32_ss(acc, da, db, first);
      }
    }
    sm90::wg_commit();
    if (kb > 0) {
      sm90::wg_wait<1>();
      ring.release(prev, t);
    }
    prev = cur;
  }
  sm90::wg_wait<0>();
#pragma unroll
  for (int i = 0; i < N / 2; ++i) sm90::reg_fence(acc[i]);
  ring.release(prev, t);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One head, in registers. Fragment element 4i + 2half + e of a 64 x N
// accumulator sits at row r0 + 8half, column 8i + cq + e (i 0-3 q, 4-7 k,
// 8-11 v); pk holds stream 1's q|k|v, rounded and packed (pk[2i + half]).
// head_weights: d1 = <q2, k1> and d2 = <q1, k2> from stream 2's q|k in
// qk2 (fp32) sum bf16 products in fp32 over the quad's lanes; the softmax
// weights, rounded, go to w1, w2 (rows r0, r0 + 8).
__device__ __forceinline__ void head_weights(const float* qk2, const uint32_t* pk,
                                             __nv_bfloat162* w1, __nv_bfloat162* w2) {
  float d1[2] = {0.f, 0.f}, d2[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int e = 4 * i + 2 * half;
      const __nv_bfloat162 q2 = __floats2bfloat162_rn(qk2[e], qk2[e + 1]);
      const __nv_bfloat162 k2 = __floats2bfloat162_rn(qk2[e + 16], qk2[e + 17]);
      const float2 p1 = __bfloat1622float2(__hmul2(q2, as_bf2(pk[2 * (i + 4) + half])));
      const float2 p2 = __bfloat1622float2(__hmul2(as_bf2(pk[2 * i + half]), k2));
      d1[half] += p1.x;
      d1[half] += p1.y;
      d2[half] += p2.x;
      d2[half] += p2.y;
    }
  const float scale = 0.17677669529663687f;  // 32^-0.5, rounded to fp32 as the plain version's
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // a row's four lanes are adjacent
      d1[half] += __shfl_xor_sync(0xffffffffu, d1[half], off);
      d2[half] += __shfl_xor_sync(0xffffffffu, d2[half], off);
    }
    const float dd1 = d1[half] * scale, dd2 = d2[half] * scale;
    const float mx = fmaxf(dd1, dd2);
    const float e1 = expf(dd1 - mx), e2 = expf(dd2 - mx);
    const float den = e1 + e2;
    w1[half] = __bfloat162bfloat162(__float2bfloat16(e1 / den));
    w2[half] = __bfloat162bfloat162(__float2bfloat16(e2 / den));
  }
}

// head_mix: the blend w1 v1 + w2 v2 in bf16 (v2 fp32 in v2f), packed into
// a[0..7], the A operand of two k steps of the output projection
__device__ __forceinline__ void head_mix(const float* v2f, const uint32_t* pk,
                                         const __nv_bfloat162* w1, const __nv_bfloat162* w2,
                                         uint32_t* a) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = 4 * i + 2 * half;
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(v2f[e], v2f[e + 1]);
      a[2 * i + half] = as_u32(
          __hadd2(__hmul2(w1[half], as_bf2(pk[2 * (i + 8) + half])), __hmul2(w2[half], v2)));
    }
}

// One head pair of the consumer's rows: per head q|k|v of both streams,
// the cross-dots, softmax and blend, then o (+)= the pair's blend x
// W_out[:, 64p : 64p + 64]^T over the consumer's 128-row entries of it.
// FIRST: the tile's first pair, whose products overwrite o.
template <int C, bool FIRST>
__device__ __forceinline__ void pair_step(float* o, float* acc, uint32_t* pk, uint32_t* a,
                                          const unsigned char* a1, const unsigned char* a2,
                                          Ring& ring, int nb0, int t) {
  using K = Cfg<C>;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qkv_chain<C, 96>(acc, a1, ring, t);
#pragma unroll
    for (int i = 0; i < 12; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        pk[2 * i + half] = sm90::pack_bf16(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
    __nv_bfloat162 w1[2], w2[2];
    if constexpr (K::TWO_PASS) {
      qkv_chain<C, 64>(acc, a2, ring, t);
      head_weights(acc, pk, w1, w2);
      qkv_chain<C, 32>(acc, a2, ring, t);
      head_mix(acc, pk, w1, w2, a + 8 * hh);
    } else {
      qkv_chain<C, 96>(acc, a2, ring, t);
      head_weights(acc, pk, w1, w2);
      head_mix(acc + 32, pk, w1, w2, a + 8 * hh);
    }
  }
  const int s0 = ring.s;
#pragma unroll
  for (int nb = 0; nb < K::NBT; ++nb) ring.take();
  sm90::wg_fence();
#pragma unroll
  for (int lb = 0; lb < K::NB; ++lb) {
    const unsigned char* w = ring.slot((s0 + nb0 + lb) % K::STAGES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = sm90::desc_sw128(w) + 2 * kk;
      if (FIRST && kk == 0)
        wgmma_64x128_rs_first(o + 64 * lb, a + 4 * kk, db);
      else
        wgmma_64x128_rs(o + 64 * lb, a + 4 * kk, db);
    }
  }
  sm90::wg_commit();
  sm90::wg_wait<0>();
#pragma unroll
  for (int i = 0; i < 64 * K::NB; ++i) sm90::reg_fence(o[i]);
#pragma unroll
  for (int i = 0; i < 16; ++i) sm90::reg_fence(a[i]);
#pragma unroll
  for (int nb = 0; nb < K::NBT; ++nb) ring.release((s0 + nb) % K::STAGES, t);
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
    pixelweight_kernel(const bf16* __restrict__ x1, const bf16* __restrict__ x2,
                       bf16* __restrict__ out, int M, const float* __restrict__ ln1w,
                       const float* __restrict__ ln1b, const float* __restrict__ ln2w,
                       const float* __restrict__ ln2b, const unsigned char* __restrict__ packed) {
  using K = Cfg<C>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  unsigned char* sH1 = base + K::STAGES * SLOT;
  unsigned char* sH2 = sH1 + K::H_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sH2 + K::H_BYTES);
  uint64_t* empty = full + K::STAGES;
  const int ntiles = (M + K::BM - 1) / K::BM;
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
    auto prefetch = [&](int tile) {
      const size_t r = (size_t)tile * K::BM * C;
      const uint32_t bytes = (uint32_t)min(K::BM, M - tile * K::BM) * C * 2;
      sm90::bulk_prefetch_l2(x1 + r, bytes);
      sm90::bulk_prefetch_l2(x2 + r, bytes);
    };
    if ((int)blockIdx.x < ntiles) prefetch(blockIdx.x);
    int s = 0;
    uint32_t ph = 0;
    for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      if (tile + (int)gridDim.x < ntiles) prefetch(tile + gridDim.x);
      const unsigned char* src = packed;
      for (int p = 0; p < C / 64; ++p)
        for (int e = 0; e < K::ENTRIES; ++e) {
          const uint32_t bytes = K::entry_bytes(e);
          sm90::bar_wait(&empty[s], ph ^ 1);
          sm90::bar_expect_tx(&full[s], bytes);
          sm90::bulk_g2s(base + s * SLOT, src, bytes, &full[s]);
          src += bytes;
          if (++s == K::STAGES) {
            s = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int r0 = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  const int rowoff = K::SPLIT ? 0 : 64 * wg;
  unsigned char* a1 = sH1 + rowoff * 128;  // this consumer's rows of the LN'd tiles
  unsigned char* a2 = sH2 + rowoff * 128;
  const int nb0 = K::SPLIT ? K::NB * wg : 0;  // this consumer's first W_out entry of a pair
  Ring ring{base, full, empty, K::STAGES, 0, 0};
  float o[64 * K::NB], acc[48];
  uint32_t pk[24], a[16];

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = tile * K::BM + rowoff;
    const int valid = max(0, min(64, M - row0));
    if constexpr (K::SPLIT) {  // consumer wg LayerNorms stream wg + 1 of the shared rows
      ln_rows<C>((wg ? x2 : x1) + (size_t)row0 * C, valid, wg ? a2 : a1, K::KB_BYTES,
                 wg ? ln2w : ln1w, wg ? ln2b : ln1b, warp, lane);
      sm90::fence_async_smem();
      sm90::named_sync(3, 256);
    } else {
      ln_rows<C>(x1 + (size_t)row0 * C, valid, a1, K::KB_BYTES, ln1w, ln1b, warp, lane);
      ln_rows<C>(x2 + (size_t)row0 * C, valid, a2, K::KB_BYTES, ln2w, ln2b, warp, lane);
      sm90::fence_async_smem();
      sm90::named_sync(1 + wg, 128);
    }

    pair_step<C, true>(o, acc, pk, a, a1, a2, ring, nb0, t);
    for (int p = 1; p < C / 64; ++p) pair_step<C, false>(o, acc, pk, a, a1, a2, ring, nb0, t);

    // bf16(o), staged over LN'd rows that no wgmma reads any more, then out
    // in 16-byte row pieces
    if constexpr (K::SPLIT) sm90::named_sync(3, 256);  // both consumers are past the tiles
    unsigned char* st = K::SPLIT ? (wg ? sH2 : sH1) : a1;
#pragma unroll
    for (int lb = 0; lb < K::NB; ++lb)
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = 128 * lb + 8 * i + cq, e = 64 * lb + 4 * i + 2 * half;
          *reinterpret_cast<uint32_t*>(st + (col / 64) * K::KB_BYTES +
                                       sm90::swz(r0 + 8 * half, col % 64)) =
              sm90::pack_bf16(o[e], o[e + 1]);
        }
    sm90::named_sync(1 + wg, 128);
    const int cbase = K::SPLIT ? K::NO * wg : 0;
    for (int u = t; u < valid * (K::NO / 8); u += 128) {
      const int row = u / (K::NO / 8), col = (u % (K::NO / 8)) * 8;
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + row) * C + cbase + col) =
          *reinterpret_cast<const uint4*>(st + (col / 64) * K::KB_BYTES + sm90::swz(row, col % 64));
    }
    sm90::named_sync(1 + wg, 128);  // read out before the next tile's LN
  }
}

template <int C>
static cudaError_t launch(const void* x1, const void* x2, void* out, int M, const float* ln1w,
                          const float* ln1b, const float* ln2w, const float* ln2b,
                          const void* wqkv1, const void* wqkv2, const void* wout, int bf,
                          void* packed, cudaStream_t s) {
  using K = Cfg<C>;
  cudaError_t err = pack<C>(wqkv1, wqkv2, wout, bf, packed, s);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(pixelweight_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)K::SMEM);
  if (err != cudaSuccess) return err;
  const int ntiles = (M + K::BM - 1) / K::BM;
  const int grid = ntiles < sm90::num_sms() ? ntiles : sm90::num_sms();
  pixelweight_kernel<C><<<grid, THREADS, K::SMEM, s>>>(
      (const bf16*)x1, (const bf16*)x2, (bf16*)out, M, ln1w, ln1b, ln2w, ln2b,
      (const unsigned char*)packed);
  return cudaGetLastError();
}

}  // namespace pw

// bytes of the scratch `packed` that pixelweight takes at width C: the 7 C^2
// weights in bf16
extern "C" int pixelweight_packed_bytes(int C) { return 14 * C * C; }

// The packing launch alone (a test compares its image with the plain
// layout of ops/pixelweight.py::pack_weights).
extern "C" int pixelweight_pack(int C, const void* wqkv1, const void* wqkv2, const void* wout,
                                int wbf16, void* packed, void* stream) {
  if (((size_t)packed) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 128) return (int)pw::pack<128>(wqkv1, wqkv2, wout, wbf16, packed, s);
  if (C == 256) return (int)pw::pack<256>(wqkv1, wqkv2, wout, wbf16, packed, s);
  if (C == 512) return (int)pw::pack<512>(wqkv1, wqkv2, wout, wbf16, packed, s);
  return (int)cudaErrorInvalidValue;
}

// x1, x2, out: (M, C) bf16, 16-byte aligned; C 128, 256 or 512. LN params
// fp32 (C); wqkv1, wqkv2 (3C, C) and wout (C, C) in torch Linear layout,
// fp32 if wbf16 == 0, else bf16; packed: pixelweight_packed_bytes(C) bytes
// of scratch that the first launch fills.
extern "C" int pixelweight(const void* x1, const void* x2, void* out, long long M, int C,
                           const void* ln1w, const void* ln1b, const void* ln2w,
                           const void* ln2b, const void* wqkv1, const void* wqkv2,
                           const void* wout, int wbf16, void* packed, void* stream) {
  if (M < 1 || M > 0x7fffffffLL - 128) return (int)cudaErrorInvalidValue;
  if (((size_t)x1 | (size_t)x2 | (size_t)out | (size_t)packed) % 16)
    return (int)cudaErrorMisalignedAddress;
  const float *w1 = (const float*)ln1w, *b1 = (const float*)ln1b, *w2 = (const float*)ln2w,
              *b2 = (const float*)ln2b;
  cudaStream_t s = (cudaStream_t)stream;
  const int m = (int)M;
  if (C == 128)
    return (int)pw::launch<128>(x1, x2, out, m, w1, b1, w2, b2, wqkv1, wqkv2, wout, wbf16,
                                 packed, s);
  if (C == 256)
    return (int)pw::launch<256>(x1, x2, out, m, w1, b1, w2, b2, wqkv1, wqkv2, wout, wbf16,
                                 packed, s);
  if (C == 512)
    return (int)pw::launch<512>(x1, x2, out, m, w1, b1, w2, b2, wqkv1, wqkv2, wout, wbf16,
                                 packed, s);
  return (int)cudaErrorInvalidValue;
}
