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
// Bound: memory. Per chunk it reads and writes the canvas inside the
// bounding box of the chunk's windows once (fp32, C+1 lanes) and reads each
// prediction once; there is no arithmetic to speak of.
// Design: one thread per canvas element (voxel, lane) of the bounding box;
// neighbouring threads own neighbouring addresses of the canvas and of the
// prediction, so loads and stores coalesce. Each thread loops over the
// windows in order and keeps its sum in a register: no atomics, one read and
// one write of the canvas, and the sum order of the sequential loop. The
// multiply and the add are __fmul_rn / __fadd_rn so that nvcc cannot
// contract them into an FMA: the result is bit-exact with the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#define MAX_WINDOWS 32

struct Windows {
  int n;
  int x0[MAX_WINDOWS];
  int y0[MAX_WINDOWS];
  int z0[MAX_WINDOWS];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void scatter_kernel(float* __restrict__ acc, const T* __restrict__ pred,
                               const float* __restrict__ imp, const Windows win, int Y,
                               int Z, int C, int rx, int ry, int rz, int bx0, int by0,
                               int bz0, int by, int bz, long long total) {
  const int K = C + 1;
  const long long win_vox = (long long)rx * ry * rz;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x; t < total;
       t += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(t % K);
    long long v = t / K;
    const int z = bz0 + (int)(v % bz);
    v /= bz;
    const int y = by0 + (int)(v % by);
    const int x = bx0 + (int)(v / by);
    float* dst = acc + (((long long)x * Y + y) * Z + z) * K + c;
    float a = 0.f;
    bool touched = false;
    for (int w = 0; w < win.n; ++w) {
      const int wx = x - win.x0[w], wy = y - win.y0[w], wz = z - win.z0[w];
      if (wx < 0 || wx >= rx || wy < 0 || wy >= ry || wz < 0 || wz >= rz) continue;
      if (!touched) {
        a = *dst;
        touched = true;
      }
      const long long local = ((long long)wx * ry + wy) * rz + wz;
      const float weight = imp[local];
      const float val =
          c < C ? __fmul_rn(weight, to_f32(pred[(w * win_vox + local) * C + c])) : weight;
      a = __fadd_rn(a, val);
    }
    if (touched) *dst = a;
  }
}

// acc: (X, Y, Z, C+1) fp32; pred: (n, rx, ry, rz, C) fp32 or bf16;
// imp: (rx, ry, rz) fp32; starts_host: n*3 ints in host memory (x, y, z).
extern "C" int scatter_add_windows(void* acc, const void* pred, int pred_is_bf16,
                                   const void* imp, const int* starts_host, int n, int X,
                                   int Y, int Z, int C, int rx, int ry, int rz,
                                   void* stream) {
  if (n < 1 || n > MAX_WINDOWS) return (int)cudaErrorInvalidValue;
  Windows win;
  win.n = n;
  int bx0 = X, by0 = Y, bz0 = Z, bx1 = 0, by1 = 0, bz1 = 0;
  for (int w = 0; w < n; ++w) {
    win.x0[w] = starts_host[3 * w];
    win.y0[w] = starts_host[3 * w + 1];
    win.z0[w] = starts_host[3 * w + 2];
    if (win.x0[w] < 0 || win.y0[w] < 0 || win.z0[w] < 0 || win.x0[w] + rx > X ||
        win.y0[w] + ry > Y || win.z0[w] + rz > Z)
      return (int)cudaErrorInvalidValue;
    bx0 = std::min(bx0, win.x0[w]);
    by0 = std::min(by0, win.y0[w]);
    bz0 = std::min(bz0, win.z0[w]);
    bx1 = std::max(bx1, win.x0[w] + rx);
    by1 = std::max(by1, win.y0[w] + ry);
    bz1 = std::max(bz1, win.z0[w] + rz);
  }
  const int bx = bx1 - bx0, by = by1 - by0, bz = bz1 - bz0;
  const long long total = (long long)bx * by * bz * (C + 1);
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  cudaStream_t s = (cudaStream_t)stream;
  if (pred_is_bf16)
    scatter_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (float*)acc, (const __nv_bfloat16*)pred, (const float*)imp, win, Y, Z, C, rx, ry,
        rz, bx0, by0, bz0, by, bz, total);
  else
    scatter_kernel<float><<<blocks, threads, 0, s>>>((float*)acc, (const float*)pred,
                                                     (const float*)imp, win, Y, Z, C, rx,
                                                     ry, rz, bx0, by0, bz0, by, bz, total);
  return (int)cudaGetLastError();
}
