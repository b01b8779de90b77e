// Pull-based edit pass of one fused fix iteration.
//
// Replaces the Pallas kernel kernels/fixpass.py:_kernel (called through
// fix_pass_pallas). Vertex j is an edit target when self_edit[j], or a
// stencil source i = j - off_k (inside the tile and the global domain)
// has demote_src[i] and up_code_g[i] == k, or promote_src[i] and
// dn_code_f[i] == k. Note the promote pull reads the ORIGINAL field's
// descending codes. Targets become (g + lower) * 0.5, raised to lower
// where that falls below it; the arithmetic is rounded to nearest in the
// field's type, with no contraction.
//
// Layout: grid (slab, plane chunk) so every block lies in one slab; the
// per-slab fix-source count (viol) and edit-target count (tgt) are a
// warp + block reduction and one integer atomicAdd per block. Integer
// atomics commute, so the counts are deterministic.
//
// Bound: memory. Each vertex reads g, lower and five int32 masks/codes
// once (the neighbor loads hit L1/L2) and writes g': 32 B/vertex in f32.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace msz {

__device__ __forceinline__ float halve(float g, float lo) {
  const float nw = __fmul_rn(__fadd_rn(g, lo), 0.5f);
  return nw < lo ? lo : nw;
}
__device__ __forceinline__ double halve(double g, double lo) {
  const double nw = __dmul_rn(__dadd_rn(g, lo), 0.5);
  return nw < lo ? lo : nw;
}

constexpr int kThreads = 256;

template <typename T, int K>
__global__ void __launch_bounds__(kThreads) fixpass_kernel(
    const T* __restrict__ g, const T* __restrict__ low,
    const int* __restrict__ selfe, const int* __restrict__ dem,
    const int* __restrict__ pro, const int* __restrict__ upg,
    const int* __restrict__ dnf, T* __restrict__ g_out,
    int* __restrict__ viol, int* __restrict__ tgt, Geo s) {
  const int z = blockIdx.x;
  const long long plane = (long long)s.ny * s.nx;
  const long long p = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  int n_src = 0, n_tgt = 0;
  if (p < plane) {
    const int y = (int)(p / s.nx), x = (int)(p % s.nx);
    const long long j = (long long)z * plane + p;
    const int se = selfe[j];
    bool target = se != 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (target) break;
      const int dz = off<K>(k, 0), dy = off<K>(k, 1), dx = off<K>(k, 2);
      if (!inside(s, z, y, x, -dz, -dy, -dx)) continue;
      const long long i = j - (((long long)dz * s.ny + dy) * s.nx + dx);
      if ((dem[i] != 0 && upg[i] == k) || (pro[i] != 0 && dnf[i] == k))
        target = true;
    }
    const T gv = g[j];
    g_out[j] = target ? halve(gv, low[j]) : gv;
    n_src = se + dem[j] + pro[j];
    n_tgt = target ? 1 : 0;
  }
  n_src = __reduce_add_sync(0xffffffffu, n_src);
  n_tgt = __reduce_add_sync(0xffffffffu, n_tgt);
  __shared__ int s_src[kThreads / 32], s_tgt[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_src[warp] = n_src;
    s_tgt[warp] = n_tgt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0, b = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      a += s_src[w];
      b += s_tgt[w];
    }
    if (a) atomicAdd(&viol[z], a);
    if (b) atomicAdd(&tgt[z], b);
  }
}

template <typename T>
int launch(const void* g, const void* low, const void* se, const void* dem,
           const void* pro, const void* upg, const void* dnf, void* g_out,
           void* viol, void* tgt, int ndim, Geo s, void* stream) {
  const long long plane = (long long)s.ny * s.nx;
  if (plane == 0 || s.nz == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)s.nz, (unsigned)((plane + kThreads - 1) / kThreads));
  cudaStream_t st = (cudaStream_t)stream;
  if (ndim == 3) {
    fixpass_kernel<T, 14><<<grid, kThreads, 0, st>>>(
        (const T*)g, (const T*)low, (const int*)se, (const int*)dem,
        (const int*)pro, (const int*)upg, (const int*)dnf, (T*)g_out,
        (int*)viol, (int*)tgt, s);
  } else {
    fixpass_kernel<T, 6><<<grid, kThreads, 0, st>>>(
        (const T*)g, (const T*)low, (const int*)se, (const int*)dem,
        (const int*)pro, (const int*)upg, (const int*)dnf, (T*)g_out,
        (int*)viol, (int*)tgt, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace msz

#define MSZ_FIXPASS_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* g, const void* low, const void* se,       \
                      const void* dem, const void* pro, const void* upg,    \
                      const void* dnf, void* g_out, void* viol, void* tgt,  \
                      int ndim, int nz, int ny, int nx, int z0, int y0,     \
                      int x0, int N, int NY, int NX, void* stream) {        \
    return msz::launch<T>(g, low, se, dem, pro, upg, dnf, g_out, viol, tgt, \
                          ndim,                                             \
                          msz::make_geo(nz, ny, nx, z0, y0, x0, N, NY, NX),  \
                          stream);                                          \
  }

MSZ_FIXPASS_ENTRY(msz_fixpass_f32, float)
MSZ_FIXPASS_ENTRY(msz_fixpass_f64, double)
