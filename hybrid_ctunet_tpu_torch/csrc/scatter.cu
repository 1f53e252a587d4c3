// Sliding-window blend: add a chunk of importance-weighted window
// predictions and the count map into the fp32 canvas, in window order.
//
// Replaces hybrid_ctunet_tpu/ops/scatter_pallas.py:_scatter_tpu (the Pallas
// in-place scatter) together with the chunk body around it
// (infer/sliding_window.py:256-267: w = importance * valid,
// acc[..., :C] += w * float(p), acc[..., C] += w). The port has no dummy
// windows (the trailing chunk is run at its own size), so valid is 1 and
// w is the importance itself.
//
// Bound: memory. Per chunk the card must read and write the canvas the
// windows cover once (fp32, C+1 lanes) and read each prediction and the
// importance rows once; one multiply and one add per element and window.
//
// Design. The unit of work is one canvas (x, y) row: its z-run of
// (z1 - z0) * (C+1) fp32 is contiguous, and so is each covering window's
// prediction row (rz * C values) and importance row (rz fp32). A
// persistent grid of 128-thread CTAs walks the rows of the windows' (x, y)
// bounding box. For each row, thread 0 finds the covering windows and the
// z-run once (rows no window covers are skipped there), and brings the
// windows' prediction and importance rows into shared memory with bulk
// copies on an mbarrier (cp.async.bulk; element copies where a row is not
// 16-byte aligned). A two-stage ring keeps the next row's copies in flight
// while this row is summed. The threads walk the canvas run in float4 (the
// unaligned head and tail element by element), each thread issuing two
// 16-byte loads before it sums (one or four measured 3-6% slower on the
// 4-window chunks), and get (z, c) of an element by a 32-bit
// division by the constant C+1 (multiply-shift; C = 14, the main path, is a
// template instance, other C take a runtime 32-bit division). A row covered
// by more windows than a ring stage holds is done in groups, each group's
// sums written before the next reads them. Each element is read once and
// written once a group, and its windows are added in window order with
// __fmul_rn / __fadd_rn, so that nvcc cannot contract them into an FMA:
// the result is bit-exact with the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "sm90.cuh"

#define MAX_WINDOWS 32

namespace k1 {

constexpr int THREADS = 128;
constexpr int UNROLL = 2;  // float4 loads a thread issues before it sums
constexpr int SMEM_BUDGET = 96 * 1024;  // ring bytes a CTA aims at (2 CTAs an SM at worst)

struct Windows {
  int n;
  int x0[MAX_WINDOWS];
  int y0[MAX_WINDOWS];
  int z0[MAX_WINDOWS];
};

struct Geometry {
  int Y, Z, C, rx, ry, rz;
  int bx0, by0, by, rows;  // the windows' (x, y) bounding box, rows = bx * by
  int G;                   // windows a ring stage holds
  int pred_row, imp_row;   // bytes of a window's rows in shared memory (16-byte multiples)
  int bulk;                // rows are 16-byte aligned: bulk copies
};

// one ring stage's work: a canvas row and up to G of its covering windows
struct Item {
  int row;  // < 0: the CTA has no more work
  int x, y, nw, next, zlo, zhi;
  int w[MAX_WINDOWS];
  int z0[MAX_WINDOWS];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// the first item at or after (row, window index `from`) of this CTA's rows
__device__ void find_item(const Windows& win, const Geometry& g, int row, int from, Item* it) {
  for (; row < g.rows; row += gridDim.x, from = 0) {
    const int x = g.bx0 + row / g.by, y = g.by0 + row % g.by;
    int nw = 0, zlo = g.Z, zhi = 0, w = from;
    for (; w < win.n && nw < g.G; ++w) {
      if ((unsigned)(x - win.x0[w]) < (unsigned)g.rx &&
          (unsigned)(y - win.y0[w]) < (unsigned)g.ry) {
        it->w[nw] = w;
        it->z0[nw] = win.z0[w];
        zlo = min(zlo, win.z0[w]);
        zhi = max(zhi, win.z0[w] + g.rz);
        ++nw;
      }
    }
    if (nw) {
      it->row = row;
      it->x = x;
      it->y = y;
      it->nw = nw;
      it->next = w;
      it->zlo = zlo;
      it->zhi = zhi;
      return;
    }
  }
  it->row = -1;
}

// thread 0: bulk-copy an item's prediction and importance rows into a stage
template <typename T>
__device__ void stage_bulk(const Item& it, const Windows& win, const Geometry& g, const T* pred,
                           const float* imp, T* ps, float* is, uint64_t* bar) {
  const uint32_t pb = g.rz * g.C * sizeof(T), ib = g.rz * 4;
  sm90::bar_expect_tx(bar, it.nw * (pb + ib));
  for (int j = 0; j < it.nw; ++j) {
    const int w = it.w[j], wx = it.x - win.x0[w], wy = it.y - win.y0[w];
    const size_t r = ((size_t)wx * g.ry + wy);
    sm90::bulk_g2s(reinterpret_cast<char*>(ps) + (size_t)j * g.pred_row,
                   pred + (((size_t)w * g.rx * g.ry) + r) * g.rz * g.C, pb, bar);
    sm90::bulk_g2s(reinterpret_cast<char*>(is) + (size_t)j * g.imp_row, imp + r * g.rz, ib, bar);
  }
}

// every thread: element copies of an item's rows (rows not 16-byte aligned)
template <typename T>
__device__ void stage_elements(const Item& it, const Windows& win, const Geometry& g,
                               const T* pred, const float* imp, T* ps, float* is) {
  const int pn = g.rz * g.C, ps_stride = g.pred_row / (int)sizeof(T), is_stride = g.imp_row / 4;
  for (int j = 0; j < it.nw; ++j) {
    const int w = it.w[j], wx = it.x - win.x0[w], wy = it.y - win.y0[w];
    const size_t r = ((size_t)wx * g.ry + wy);
    const T* src = pred + (((size_t)w * g.rx * g.ry) + r) * pn;
    for (int e = threadIdx.x; e < pn; e += THREADS) ps[j * ps_stride + e] = src[e];
    for (int e = threadIdx.x; e < g.rz; e += THREADS) is[j * is_stride + e] = imp[r * g.rz + e];
  }
}

// the canvas value a at (z, c) plus the item's windows, in order
template <typename T>
__device__ __forceinline__ float blend(float a, int z, int c, int C, const Item& it, int nw,
                                       int rz, const T* ps, int ps_stride, const float* is,
                                       int is_stride) {
  for (int j = 0; j < nw; ++j) {
    const unsigned wz = (unsigned)(z - it.z0[j]);
    if (wz < (unsigned)rz) {
      const float wgt = is[j * is_stride + wz];
      a = __fadd_rn(a, c < C ? __fmul_rn(wgt, to_f32(ps[j * ps_stride + wz * C + c])) : wgt);
    }
  }
  return a;
}

template <typename T, int KC>
__global__ void __launch_bounds__(THREADS) scatter_rows(float* __restrict__ acc,
                                                        const T* __restrict__ pred,
                                                        const float* __restrict__ imp,
                                                        const Windows win, const Geometry g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Item items[2];
  __shared__ __align__(8) uint64_t bars[2];
  const int stage_bytes = g.G * (g.pred_row + g.imp_row);
  auto pred_s = [&](int s) { return reinterpret_cast<T*>(smem + s * stage_bytes); };
  auto imp_s = [&](int s) {
    return reinterpret_cast<float*>(smem + s * stage_bytes + g.G * g.pred_row);
  };
  const int K = KC ? KC : g.C + 1, C = K - 1;
  const int ps_stride = g.pred_row / (int)sizeof(T), is_stride = g.imp_row / 4;
  const int tid = threadIdx.x;

  if (tid == 0) {
    sm90::bar_init(&bars[0], 1);
    sm90::bar_init(&bars[1], 1);
    sm90::bar_fence_init();
    find_item(win, g, blockIdx.x, 0, &items[0]);
    if (items[0].row >= 0 && g.bulk)
      stage_bulk(items[0], win, g, pred, imp, pred_s(0), imp_s(0), &bars[0]);
  }
  __syncthreads();

  for (int i = 0;; ++i) {
    const int s = i & 1;
    const Item& it = items[s];
    if (it.row < 0) break;
    if (tid == 0) {  // the next item, and its copies into the other stage
      Item* nx = &items[s ^ 1];
      find_item(win, g, it.row, it.next, nx);
      if (nx->row >= 0 && g.bulk)
        stage_bulk(*nx, win, g, pred, imp, pred_s(s ^ 1), imp_s(s ^ 1), &bars[s ^ 1]);
    }
    const T* ps = pred_s(s);
    const float* is = imp_s(s);
    if (g.bulk) {
      sm90::bar_wait(&bars[s], (i >> 1) & 1);
    } else {
      stage_elements(it, win, g, pred, imp, pred_s(s), imp_s(s));
      __syncthreads();
    }

    // the row's canvas run: elements [zlo * K, zhi * K) of row (x, y)
    const int l0 = it.zlo * K, m = (it.zhi - it.zlo) * K, nw = it.nw;
    float* run = acc + ((size_t)it.x * g.Y + it.y) * g.Z * K + l0;
    const int head = min((int)((0u - (unsigned)((uintptr_t)run >> 2)) & 3u), m);
    const int nb = (m - head) >> 2, tail = m - head - 4 * nb;
    if (tid < head + tail) {  // unaligned head and tail, one element a thread
      const int e = tid < head ? tid : head + 4 * nb + (tid - head);
      const int l = l0 + e, z = (int)((unsigned)l / (unsigned)K);
      run[e] = blend(run[e], z, l - z * K, C, it, nw, g.rz, ps, ps_stride, is, is_stride);
    }
    float4* run4 = reinterpret_cast<float4*>(run + head);
    for (int i0 = tid; i0 < nb; i0 += UNROLL * THREADS) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (i0 + u * THREADS < nb) v[u] = run4[i0 + u * THREADS];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int q = i0 + u * THREADS;
        if (q >= nb) break;
        const int l = l0 + head + 4 * q;
        int z = (int)((unsigned)l / (unsigned)K), c = l - z * K;
        float* f = &v[u].x;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          f[k] = blend(f[k], z, c, C, it, nw, g.rz, ps, ps_stride, is, is_stride);
          if (++c == K) {
            c = 0;
            ++z;
          }
        }
        run4[q] = v[u];
      }
    }
    __syncthreads();  // this stage is free for the item after next
  }
}

constexpr int STATIC_SMEM = 2 * sizeof(Item) + 2 * sizeof(uint64_t);  // scatter_rows' items, bars

template <typename T, int KC>
int launch(float* acc, const T* pred, const float* imp, const Windows& win, const Geometry& g,
           cudaStream_t s) {
  const int smem = 2 * g.G * (g.pred_row + g.imp_row);
  auto kernel = scatter_rows<T, KC>;
  // the 48 KB a block may use without opting in counts the static items and
  // barriers too, and the dynamic ring's 128-byte alignment after them
  if (smem + STATIC_SMEM + 128 > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  const int blocks = std::min(g.rows, std::max(1, sms * per_sm));
  kernel<<<blocks, THREADS, smem, s>>>(acc, pred, imp, win, g);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(float* acc, const T* pred, const float* imp, const Windows& win, const Geometry& g,
             cudaStream_t s) {
  if (g.C + 1 == 15) return launch<T, 15>(acc, pred, imp, win, g, s);
  return launch<T, 0>(acc, pred, imp, win, g, s);
}

}  // namespace k1

// acc: (X, Y, Z, C+1) fp32; pred: (n, rx, ry, rz, C) fp32 or bf16;
// imp: (rx, ry, rz) fp32; starts_host: n*3 ints in host memory (x, y, z).
extern "C" int scatter_add_windows(void* acc, const void* pred, int pred_is_bf16,
                                   const void* imp, const int* starts_host, int n, int X,
                                   int Y, int Z, int C, int rx, int ry, int rz,
                                   void* stream) {
  if (n < 1 || n > MAX_WINDOWS || C < 1) return (int)cudaErrorInvalidValue;
  k1::Windows win;
  win.n = n;
  int bx0 = X, by0 = Y, bx1 = 0, by1 = 0;
  for (int w = 0; w < n; ++w) {
    win.x0[w] = starts_host[3 * w];
    win.y0[w] = starts_host[3 * w + 1];
    win.z0[w] = starts_host[3 * w + 2];
    if (win.x0[w] < 0 || win.y0[w] < 0 || win.z0[w] < 0 || win.x0[w] + rx > X ||
        win.y0[w] + ry > Y || win.z0[w] + rz > Z)
      return (int)cudaErrorInvalidValue;
    bx0 = std::min(bx0, win.x0[w]);
    by0 = std::min(by0, win.y0[w]);
    bx1 = std::max(bx1, win.x0[w] + rx);
    by1 = std::max(by1, win.y0[w] + ry);
  }
  const int esize = pred_is_bf16 ? 2 : 4;
  k1::Geometry g;
  g.Y = Y;
  g.Z = Z;
  g.C = C;
  g.rx = rx;
  g.ry = ry;
  g.rz = rz;
  g.bx0 = bx0;
  g.by0 = by0;
  g.by = by1 - by0;
  g.rows = (bx1 - bx0) * g.by;
  g.pred_row = (rz * C * esize + 15) & ~15;
  g.imp_row = (rz * 4 + 15) & ~15;
  const int per_window = 2 * (g.pred_row + g.imp_row);  // both stages
  if (per_window > 200 * 1024) return (int)cudaErrorInvalidValue;
  g.G = std::max(1, std::min(n, k1::SMEM_BUDGET / per_window));
  g.bulk = (rz * C * esize) % 16 == 0 && (rz * 4) % 16 == 0 &&
           (reinterpret_cast<uintptr_t>(pred) & 15) == 0 &&
           (reinterpret_cast<uintptr_t>(imp) & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (pred_is_bf16)
    return k1::dispatch((float*)acc, (const __nv_bfloat16*)pred, (const float*)imp, win, g, s);
  return k1::dispatch((float*)acc, (const float*)pred, (const float*)imp, win, g, s);
}
