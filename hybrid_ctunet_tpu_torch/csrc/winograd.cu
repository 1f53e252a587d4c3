// Stride-1 SAME 3x3x3 convolution of an NDHWC bf16 tensor via Winograd
// F(2,3)^3, with an optional per-(b, c) affine + LeakyReLU on the input and
// optional per-(b, f) sums of y and y^2 of the output (the fused form).
//
// Replaces hybrid_ctunet_tpu/ops/winograd_pallas.py:_conv_impl (both entry
// points, conv3x3_winograd and conv3x3_winograd_fused). What it computes is
// the TPU kernel's; its z-pair lane fold and _folded_filter are TPU lane
// machinery and are not carried over. Numerics (the port's plain version,
// ops/winograd.py): U = G g G^T is computed in fp32 (the 27 taps summed in
// order) and rounded to bf16 by a first, small launch (wino_filter); V =
// B^T d B is formed in fp32 from the bf16 input (after the affine, itself
// rounded to bf16) and rounded to bf16; the 64 position products run on the
// tensor cores with fp32 accumulation and fold at once into the eight fp32
// output accumulators (A^T entries 0, +-1); the output is rounded once. The
// sums are taken over the fp32 accumulators.
//
// Bound: bytes. Per 2^3-output tile the products are 64 x C x F MACs on the
// tensor cores and the transforms ~200 fp32 adds per channel: at the path's
// (4,48,48,96,32) -> 32, 14.5 GFLOP in bf16 (0.015 ms at 989 TFLOP/s) and
// 1.1 GFLOP in fp32 (0.016 ms at 67 TFLOP/s) against 113 MB (0.034 ms at
// 3.35 TB/s). What holds the kernel back is none of these but latency inside
// the CTA: cut after each phase, the slab loads take an eighth of its time,
// V formation a quarter and the position products more than half. Each
// product is a 16 x 32 by 32 x 8 mma.sync pair behind three ldmatrix loads,
// folded into the outputs before the next barrier, with two warps an SM
// sub-partition to cover it; more warps a CTA, wider feature groups a warp
// and a double-buffered V with one barrier a round all measured slower.
// Design: a persistent grid, one 224 KB CTA per SM, each walking a
// contiguous range of work items (sample, 2x4x4 tiles of 2^3 outputs, 32
// features). U of the CTA's 32 features (64 positions x 32 x 32 bf16, 128
// KB) is staged once and stays resident, not fetched again by every block;
// the halo'd 6x10x10 x 32 input slab of the next item is copied by cp.async
// into the other half of a double-buffered ring while this item's V and
// products run. Per x-row a of B^T each thread keeps the x-transform of its
// two (tile, channel pair) items in registers and forms V for 8 positions at
// a time into a 16 KB buffer (bf16); then each of 8 warps (16 tiles x 8
// features) runs mma.sync m16n8k16 per position, A and B by ldmatrix from
// XOR-swizzled rows, and folds the product into its eight output
// accumulators with the A^T signs. Outputs go straight from the accumulators
// to memory; the fused sums are reduced per item in a fixed order (shuffle
// butterfly, then the two row groups) and combined over items by a third
// launch in a fixed order (no float atomics: a rerun is bit-identical).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

constexpr int C = 32;                     // input channels
constexpr int FC = 32;                    // output features per work item
constexpr int TBX = 2, TBY = 4, TBZ = 4;  // tiles per work item along x, y, z
constexpr int NT = TBX * TBY * TBZ;       // 32 tiles: GEMM rows
constexpr int SX = 2 * TBX + 2, SY = 2 * TBY + 2, SZ = 2 * TBZ + 2;  // halo'd slab
constexpr int SV = SX * SY * SZ;          // 600 slab voxels of 64 B
constexpr int THREADS = 256;              // 8 warps: 2 row groups x 4 feature groups
constexpr int NPOS = 8;                   // positions of V formed per round
constexpr int U_ELEMS = 64 * FC * C;      // bf16: U of 32 features, [position][feature][channel]
constexpr int SLAB_ELEMS = SV * C;        // bf16
constexpr int V_ELEMS = NPOS * NT * C;    // bf16: [position][tile][channel]
constexpr int SMEM = (U_ELEMS + 2 * SLAB_ELEMS + V_ELEMS) * 2 + 4 * 2 * FC * 4;
static_assert(SV % 2 == 0, "slab rows pair voxels");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// d = a (16 x 16, row) * b (16 x 8, col) + d, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Swizzles, in bf16 elements. A 64-byte row of 32 channels holds four
// 16-byte chunks; ldmatrix reads 8 rows of one chunk, which an XOR of the
// chunk with (row >> 1) & 3 spreads over all 32 banks (U and V rows). The
// slab pairs voxels into 128-byte rows and flips the halves of odd rows, so
// that two tiles one z-step apart (2 voxels) read different banks.
__device__ __forceinline__ int row_swz(int row, int chunk) {
  return row * C + ((chunk ^ ((row >> 1) & 3)) << 3);
}
__device__ __forceinline__ int slab_swz(int v, int chunk) {
  const int row = v >> 1;
  return row * 2 * C + (((((v & 1) << 2) | chunk) ^ ((row & 1) << 2)) << 3);
}

// A^T = [[1, 1, 1, 0], [0, 1, -1, -1]]
__device__ __forceinline__ float at(int o, int a) {
  return o == 0 ? (a < 3 ? 1.f : 0.f) : (a == 0 ? 0.f : (a == 1 ? 1.f : -1.f));
}

// one row of B^T = [[1,0,-1,0],[0,1,1,0],[0,-1,1,0],[0,1,0,-1]] on four values
__device__ __forceinline__ float2 bt(int r, float2 d0, float2 d1, float2 d2, float2 d3) {
  switch (r) {
    case 0: return make_float2(d0.x - d2.x, d0.y - d2.y);
    case 1: return make_float2(d1.x + d2.x, d1.y + d2.y);
    case 2: return make_float2(d2.x - d1.x, d2.y - d1.y);
    default: return make_float2(d1.x - d3.x, d1.y - d3.y);
  }
}

__device__ __forceinline__ bool in_range(int ix, int iy, int iz, int X, int Y, int Z) {
  return ix >= 0 && ix < X && iy >= 0 && iy < Y && iz >= 0 && iz < Z;
}

struct Item {
  int fs, b, blk, tx0, ty0, tz0;  // feature slice, sample, block in the sample, first tile
};

__device__ __forceinline__ Item decode(int it, int B, int nblk, int nby, int nbz) {
  Item r;
  r.fs = it / (B * nblk);
  r.b = (it / nblk) % B;
  r.blk = it % nblk;
  r.tz0 = (r.blk % nbz) * TBZ;
  r.ty0 = ((r.blk / nbz) % nby) * TBY;
  r.tx0 = (r.blk / (nbz * nby)) * TBX;
  return r;
}

// the item's halo'd slab, 16 bytes (8 channels) a copy; zeros outside the volume
__device__ __forceinline__ void load_slab(bf16* buf, const bf16* __restrict__ x, const Item& t,
                                           int X, int Y, int Z) {
  const long long vb = (long long)t.b * X * Y * Z;
  const int ix0 = 2 * t.tx0 - 1, iy0 = 2 * t.ty0 - 1, iz0 = 2 * t.tz0 - 1;
  for (int i = threadIdx.x; i < SV * 4; i += THREADS) {
    const int q = i & 3, v = i >> 2;
    const int ix = ix0 + v / (SY * SZ), iy = iy0 + (v / SZ) % SY, iz = iz0 + v % SZ;
    bf16* dst = buf + slab_swz(v, q);
    if (in_range(ix, iy, iz, X, Y, Z))
      cp_async16(dst, x + (vb + ((long long)ix * Y + iy) * Z + iz) * C + q * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    wino_kernel(const bf16* __restrict__ x, const bf16* __restrict__ u, bf16* __restrict__ y,
                const float* __restrict__ scale, const float* __restrict__ bias, int act,
                float* __restrict__ part, int B, int X, int Y, int Z, int F, int nby, int nbz,
                int nblk, int items) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sU = reinterpret_cast<bf16*>(smem);
  bf16* sSlab = sU + U_ELEMS;  // two buffers
  bf16* sV = sSlab + 2 * SLAB_ELEMS;
  float* sRed = reinterpret_cast<float*>(sV + V_ELEMS);  // [2 sums][2 row groups][FC]
  const int first = (int)((long long)blockIdx.x * items / gridDim.x);
  const int last = (int)((long long)(blockIdx.x + 1) * items / gridDim.x);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 1, fq = warp >> 1, g = lane >> 2, tq = lane & 3;
  int cur_fs = -1;
  if (first < last) {
    load_slab(sSlab, x, decode(first, B, nblk, nby, nbz), X, Y, Z);
    cp_async_commit();
  }

  for (int it = first; it < last; ++it) {
    const Item t = decode(it, B, nblk, nby, nbz);
    bf16* slab = sSlab + (it - first) % 2 * SLAB_ELEMS;
    if (t.fs != cur_fs) {
      // U of this feature slice, (64, F, C) rows f0..f0+31 of each position;
      // once per CTA for F = 32. The previous item ended with a barrier.
      for (int i = threadIdx.x; i < 64 * FC * 4; i += THREADS) {
        const int q = i & 3, r = i >> 2, p = r / FC, f = r % FC;
        cp_async16(sU + p * FC * C + row_swz(f, q),
                   u + ((long long)p * F + t.fs * FC + f) * C + q * 8);
      }
      cp_async_commit();
      cur_fs = t.fs;
    }
    if (it + 1 < last) {
      load_slab(sSlab + (it + 1 - first) % 2 * SLAB_ELEMS, x, decode(it + 1, B, nblk, nby, nbz),
                 X, Y, Z);
      cp_async_commit();
      cp_async_wait<1>();  // all but the next slab: this slab and U
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (scale != nullptr) {
      // the previous InstanceNorm's affine (+ LeakyReLU) on the slab, rounded
      // to bf16; the border stays zero
      const int ix0 = 2 * t.tx0 - 1, iy0 = 2 * t.ty0 - 1, iz0 = 2 * t.tz0 - 1;
      for (int i = threadIdx.x; i < SV * 4; i += THREADS) {
        const int q = i & 3, v = i >> 2;
        if (!in_range(ix0 + v / (SY * SZ), iy0 + (v / SZ) % SY, iz0 + v % SZ, X, Y, Z)) continue;
        uint4* p = reinterpret_cast<uint4*>(slab + slab_swz(v, q));
        uint4 raw = *p;
        bf16* e = reinterpret_cast<bf16*>(&raw);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int c = q * 8 + k;
          float s = __bfloat162float(e[k]) * scale[t.b * C + c] + bias[t.b * C + c];
          if (act && !(s > 0.f)) s = 0.01f * s;
          e[k] = __float2bfloat16(s);
        }
        *p = raw;
      }
      __syncthreads();
    }

    float acc[8][4];
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0.f;

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      // x-row a of B^T for this thread's two (tile, channel pair) items: tile
      // threadIdx.x / 16 (+ 16), channels 2 cp, 2 cp + 1
      const int i1 = a == 2 ? 2 : (a == 0 ? 0 : 1);
      const int i2 = a == 0 ? 2 : (a == 1 ? 2 : (a == 2 ? 1 : 3));
      const float s2 = a == 1 ? 1.f : -1.f;
      const int cp = threadIdx.x & 15;
      float2 t1[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int tt = (threadIdx.x >> 4) + 16 * m;
        const int v0 = ((2 * (tt / (TBY * TBZ))) * SY + 2 * ((tt / TBZ) % TBY)) * SZ + 2 * (tt % TBZ);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int va = v0 + (i1 * SY + j) * SZ + k, vc = v0 + (i2 * SY + j) * SZ + k;
            const float2 d1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                slab + slab_swz(va, cp >> 2) + 2 * (cp & 3)));
            const float2 d2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                slab + slab_swz(vc, cp >> 2) + 2 * (cp & 3)));
            t1[m][j][k] = make_float2(d1.x + s2 * d2.x, d1.y + s2 * d2.y);
          }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // V of the 8 positions (a, 2 half + bb, cc), rounded to bf16
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int tt = (threadIdx.x >> 4) + 16 * m;
#pragma unroll
          for (int bb = 0; bb < 2; ++bb) {
            float2 t2[4];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              t2[k] = bt(2 * half + bb, t1[m][0][k], t1[m][1][k], t1[m][2][k], t1[m][3][k]);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const float2 vv = bt(cc, t2[0], t2[1], t2[2], t2[3]);
              *reinterpret_cast<__nv_bfloat162*>(sV + (bb * 4 + cc) * NT * C +
                                                 row_swz(tt, cp >> 2) + 2 * (cp & 3)) =
                  __floats2bfloat162_rn(vv.x, vv.y);
            }
          }
        }
        __syncthreads();
        // per position: (16 tiles x 32 ch) @ (32 ch x 8 features) on the
        // tensor cores, added into the eight outputs with the A^T signs
#pragma unroll
        for (int q = 0; q < NPOS; ++q) {
          const int bq = 2 * half + q / 4, cq = q % 4, p = (a * 4 + bq) * 4 + cq;
          unsigned fa[2][4], fb[4];
          const int row = rg * 16 + (lane & 15);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            ldsm_x4(fa[ks], sV + q * NT * C + row_swz(row, 2 * ks + (lane >> 4)));
          ldsm_x4(fb, sU + p * FC * C + row_swz(fq * 8 + (lane & 7), lane >> 3));
          float mm[4] = {0.f, 0.f, 0.f, 0.f};
          mma16816(mm, fa[0], fb[0], fb[1]);
          mma16816(mm, fa[1], fb[2], fb[3]);
#pragma unroll
          for (int o = 0; o < 8; ++o) {
            const float coef = at(o >> 2, a) * at((o >> 1) & 1, bq) * at(o & 1, cq);
            if (coef > 0.f) {
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[o][e] += mm[e];
            } else if (coef < 0.f) {
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[o][e] -= mm[e];
            }
          }
        }
        __syncthreads();  // the next round rewrites V (and, after a = 3, the slab)
      }
    }

    // outputs straight from the accumulators: tile rg*16 + g (+ 8), features
    // f0 + 8 fq + 2 tq (+ 1)
    const long long vb = (long long)t.b * X * Y * Z;
    const int f = t.fs * FC + fq * 8 + 2 * tq;
    float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int tt = rg * 16 + g + 8 * hh;
      const int ox0 = 2 * (t.tx0 + tt / (TBY * TBZ)), oy0 = 2 * (t.ty0 + (tt / TBZ) % TBY),
                oz0 = 2 * (t.tz0 + tt % TBZ);
      if (ox0 >= X || oy0 >= Y || oz0 >= Z) continue;  // a tile past the volume's edge
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const float y0 = acc[o][2 * hh], y1 = acc[o][2 * hh + 1];
        const long long vox = vb + ((long long)(ox0 + (o >> 2)) * Y + oy0 + ((o >> 1) & 1)) * Z +
                              oz0 + (o & 1);
        *reinterpret_cast<__nv_bfloat162*>(y + vox * F + f) = __floats2bfloat162_rn(y0, y1);
        s1[0] += y0;
        s1[1] += y1;
        s2[0] += y0 * y0;
        s2[1] += y1 * y1;
      }
    }
    if (part != nullptr) {
      // the item's sums of y and y^2 per feature, in a fixed order: over the
      // 8 row lanes by a butterfly, then the two row groups
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
          s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
        }
      if (g == 0)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sRed[rg * FC + fq * 8 + 2 * tq + e] = s1[e];
          sRed[(2 + rg) * FC + fq * 8 + 2 * tq + e] = s2[e];
        }
      __syncthreads();
      if (threadIdx.x < FC) {
        float* out = part + ((long long)t.b * nblk + t.blk) * 2 * F + t.fs * FC + threadIdx.x;
        out[0] = sRed[threadIdx.x] + sRed[FC + threadIdx.x];
        out[F] = sRed[2 * FC + threadIdx.x] + sRed[3 * FC + threadIdx.x];
      }
      __syncthreads();
    }
  }
}

// one block per (b, 32 features), 32 x 32 threads: row g sums the partials of
// blocks g, g + 32, ... in order, then row 0 adds the 32 row sums in order
__global__ void wino_stats_combine(const float* __restrict__ part, float* __restrict__ stats,
                                   int nblk, int F) {
  __shared__ float red[2][32][33];
  const int b = blockIdx.x, f = blockIdx.y * 32 + threadIdx.x, g = threadIdx.y;
  float a1 = 0.f, a2 = 0.f;
  for (int k = g; k < nblk; k += 32) {
    const float* p = part + ((long long)b * nblk + k) * 2 * F;
    a1 += p[f];
    a2 += p[F + f];
  }
  red[0][g][threadIdx.x] = a1;
  red[1][g][threadIdx.x] = a2;
  __syncthreads();
  if (g != 0) return;
  float s1 = 0.f, s2 = 0.f;
  for (int r = 0; r < 32; ++r) {
    s1 += red[0][r][threadIdx.x];
    s2 += red[1][r][threadIdx.x];
  }
  stats[(long long)b * 2 * F + f] = s1;
  stats[(long long)b * 2 * F + F + f] = s2;
}

// U (64, F, C) bf16 of w (F, C, 3, 3, 3), fp32 or bf16: U[p][f][c] =
// sum_t GGG[p][t] w[f][c][t] in fp32 over the taps t = 9 kx + 3 ky + kz in
// order, rounded once; GGG = G (x) G (x) G, p = 16 a + 4 b + c. Its entries
// are products of 0, +-1/2 and 1, so each term is exact before the add.
__global__ void wino_filter(const void* __restrict__ w, int w_bf16, bf16* __restrict__ u, int F) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 64 * F * C) return;
  const int c = idx % C, f = (idx / C) % F, p = idx / (C * F);
  const int ax[3] = {p >> 4, (p >> 2) & 3, p & 3};
  float gr[3][3];  // row a of G = [[1, 0, 0], [.5, .5, .5], [.5, -.5, .5], [0, 0, 1]] per axis
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int a = ax[d];
    gr[d][0] = a == 0 ? 1.f : (a == 3 ? 0.f : 0.5f);
    gr[d][1] = a == 1 ? 0.5f : (a == 2 ? -0.5f : 0.f);
    gr[d][2] = a == 0 ? 0.f : (a == 3 ? 1.f : 0.5f);
  }
  const long long base = ((long long)f * C + c) * 27;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < 27; ++t) {
    const float wt = w_bf16 ? __bfloat162float(reinterpret_cast<const bf16*>(w)[base + t])
                            : reinterpret_cast<const float*>(w)[base + t];
    acc = fmaf(gr[0][t / 9] * gr[1][(t / 3) % 3] * gr[2][t % 3], wt, acc);
  }
  u[idx] = __float2bfloat16(acc);
}

// x: (B, X, Y, Z, 32) bf16, X, Y, Z even; w: (F, 32, 3, 3, 3) contiguous,
// bf16 if w_bf16 else fp32; u: room for 64*F*32 bf16, where U = G w G^T goes, per
// position (a*16 + b*4 + c) with features before channels; y: (B, X, Y, Z,
// F) bf16, F a multiple of 32; scale, bias: (B, 32) fp32 or null (no
// affine); work: null (no sums) or fp32 of B*nblk*2*F (per-item partials) +
// B*2*F (the sums: s1 then s2 per sample), nblk the 2x4x4-tile blocks of a
// sample.
extern "C" int conv3x3_winograd(const void* x, const void* w, int w_bf16, void* u, void* y,
                                const void* scale, const void* bias, int act, void* work, int B,
                                int X, int Y, int Z, int F, void* stream) {
  if (B < 1 || X < 2 || Y < 2 || Z < 2 || X % 2 || Y % 2 || Z % 2 || F < FC || F % FC ||
      (scale == nullptr) != (bias == nullptr))
    return (int)cudaErrorInvalidValue;
  if (((size_t)x | (size_t)y | (size_t)u) % 16) return (int)cudaErrorMisalignedAddress;
  const int nbx = (X / 2 + TBX - 1) / TBX, nby = (Y / 2 + TBY - 1) / TBY,
            nbz = (Z / 2 + TBZ - 1) / TBZ;
  const long long nblk = (long long)nbx * nby * nbz, items = nblk * B * (F / FC);
  if (items > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  static int sms = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaFuncSetAttribute(wino_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  wino_filter<<<(64 * F * C + 255) / 256, 256, 0, s>>>(w, w_bf16, (bf16*)u, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* part = (float*)work;
  const int grid = (int)(items < sms ? items : sms);
  wino_kernel<<<grid, THREADS, SMEM, s>>>((const bf16*)x, (const bf16*)u, (bf16*)y,
                                          (const float*)scale, (const float*)bias, act, part, B,
                                          X, Y, Z, F, nby, nbz, (int)nblk, (int)items);
  err = cudaGetLastError();
  if (err != cudaSuccess || part == nullptr) return (int)err;
  wino_stats_combine<<<dim3(B, F / 32), dim3(32, 32), 0, s>>>(
      part, part + (long long)B * nblk * 2 * F, (int)nblk, F);
  return (int)cudaGetLastError();
}
