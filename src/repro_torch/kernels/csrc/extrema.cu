// Steepest directions + fix-source masks of one fused fix iteration.
//
// Replaces the Pallas kernel kernels/extrema.py:_kernel (called through
// extrema_masks_pallas). One thread per vertex of g:
//
//   * ascending scan: best = (g[v], lin(v)), slot = self; each in-domain
//     neighbor k, in stencil order, wins when val > best or (val == best
//     and idx > best_idx). Descending mirrors it. Linear indices are
//     unique, so this is the reference's three-reduction _sos_argbest
//     (max value, then max/min index, then first winning slot) for every
//     finite field, without stacking candidates;
//   * M_f/m_f gathered at the two winners, then the five int32 outputs of
//     kernels/extrema.py:204-218.
//
// Off-domain neighbors are skipped. grid.steepest_dirs fills them with
// -inf/-1 (ascending) and +inf/INT32_MAX (descending); the Pallas kernel
// with -inf/+inf and index lin+offset. For finite fields none of the
// three fills can win, so all three agree.
//
// Bound: memory. Each vertex reads g, M_f, m_f and the two bool extremum
// masks of f once (the 14 neighbor loads of g hit L1/L2) and writes five
// int32: 34 B/vertex in f32. Threads of a warp touch consecutive x, so
// every load and store is coalesced.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace msz {

template <typename T, int K>
__global__ void __launch_bounds__(256) extrema_kernel(
    const T* __restrict__ g, const int* __restrict__ Mf,
    const int* __restrict__ mf, const unsigned char* __restrict__ maxf,
    const unsigned char* __restrict__ minf, int* __restrict__ up_out,
    int* __restrict__ dn_out, int* __restrict__ self_out,
    int* __restrict__ dem_out, int* __restrict__ pro_out, Geo s) {
  const long long n = (long long)s.nz * s.ny * s.nx;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int x = (int)(v % s.nx);
  const long long t = v / s.nx;
  const int y = (int)(t % s.ny);
  const int z = (int)(t / s.ny);
  const long long lin =
      ((long long)(s.z0 + z) * s.NY + (s.y0 + y)) * s.NX + (s.x0 + x);

  const T gv = g[v];
  T ub = gv, db = gv;
  long long ui = lin, di = lin;
  long long unb = v, dnb = v;
  int uc = K, dc = K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int dz = off<K>(k, 0), dy = off<K>(k, 1), dx = off<K>(k, 2);
    if (!inside(s, z, y, x, dz, dy, dx)) continue;
    const long long nb = v + ((long long)dz * s.ny + dy) * s.nx + dx;
    const long long ni = lin + ((long long)dz * s.NY + dy) * s.NX + dx;
    const T val = g[nb];
    if (val > ub || (val == ub && ni > ui)) {
      ub = val; ui = ni; unb = nb; uc = k;
    }
    if (val < db || (val == db && ni < di)) {
      db = val; di = ni; dnb = nb; dc = k;
    }
  }

  const int Mv = Mf[v], mv = mf[v];
  const bool is_max_g = uc == K, is_min_g = dc == K;
  const bool is_max_f = maxf[v] != 0, is_min_f = minf[v] != 0;
  const int M_next = Mf[unb];   // unb == v at a maximum: M_next == Mv
  const int m_next = mf[dnb];
  const bool fpmax = is_max_g && !is_max_f;
  const bool fpmin = is_min_g && !is_min_f;
  const bool fnmax = !is_max_g && is_max_f;
  const bool fnmin = !is_min_g && is_min_f;
  const bool trouble_max = !is_max_g && M_next != Mv;
  const bool trouble_min = !is_min_g && m_next != mv;
  up_out[v] = uc;
  dn_out[v] = dc;
  self_out[v] = (fpmax || fnmin) ? 1 : 0;
  dem_out[v] = (fnmax || trouble_max) ? 1 : 0;
  pro_out[v] = (fpmin || trouble_min) ? 1 : 0;
}

template <typename T>
int launch(const void* g, const void* Mf, const void* mf, const void* maxf,
           const void* minf, void* up, void* dn, void* se, void* dem,
           void* pro, int ndim, Geo s, void* stream) {
  const long long n = (long long)s.nz * s.ny * s.nx;
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  if (ndim == 3) {
    extrema_kernel<T, 14><<<blocks, threads, 0, st>>>(
        (const T*)g, (const int*)Mf, (const int*)mf,
        (const unsigned char*)maxf, (const unsigned char*)minf, (int*)up, (int*)dn, (int*)se, (int*)dem,
        (int*)pro, s);
  } else {
    extrema_kernel<T, 6><<<blocks, threads, 0, st>>>(
        (const T*)g, (const int*)Mf, (const int*)mf,
        (const unsigned char*)maxf, (const unsigned char*)minf, (int*)up, (int*)dn, (int*)se, (int*)dem,
        (int*)pro, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace msz

#define MSZ_EXTREMA_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* g, const void* Mf, const void* mf,       \
                      const void* maxf, const void* minf, void* up,        \
                      void* dn, void* se, void* dem, void* pro, int ndim,  \
                      int nz, int ny, int nx, int z0, int y0, int x0,      \
                      int N, int NY, int NX, void* stream) {               \
    return msz::launch<T>(g, Mf, mf, maxf, minf, up, dn, se, dem, pro,     \
                          ndim,                                            \
                          msz::make_geo(nz, ny, nx, z0, y0, x0, N, NY, NX), \
                          stream);                                         \
  }

MSZ_EXTREMA_ENTRY(msz_extrema_f32, float)
MSZ_EXTREMA_ENTRY(msz_extrema_f64, double)
