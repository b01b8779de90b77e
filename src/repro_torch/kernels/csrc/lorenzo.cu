// Quantize + integer Lorenzo residual: the szlike compressor's forward
// transform, as a shared-memory stencil tile.
//
// Replaces the Pallas kernel kernels/lorenzo.py:_kernel (called through
// lorenzo_quant_pallas). q = rint(f / step) per vertex (IEEE division
// rounded to nearest, rint rounding half to even as jnp.round does, both
// in the field's type), then the mixed backward difference
//
//   3D: q - q(z-1) - q(y-1) - q(x-1) + q(z-1,y-1) + q(z-1,x-1)
//         + q(y-1,x-1) - q(z-1,y-1,x-1)
//   2D: the same on (Y, 1, X), where every y-1 term is zero.
//
// A term is zero when its position lies before the tile or before the
// global domain (global z == 0 through z0, and y == 0 / x == 0). The step
// is a device scalar of the field's type, as the Pallas operand is. The
// sum is int32 arithmetic modulo 2^32, as the reference's; under
// szlike.check_int32_range (|q| < 2^27) it never wraps.
//
// Bound: memory. 4 B read and 4 B written per vertex in f32: 8 B a vertex,
// 0.321 ms at 512^3 over the H100's 3.35 TB/s. The first kernel (one
// thread a vertex) took 1.59 ms there (NVIDIA H100 80GB HBM3, 700 W): a
// 64-bit division and modulo a vertex, and up to 8 IEEE divisions a
// vertex, one for each quotient of its backward cube.
//
// Design. The tile of fixpass.cu and extrema.cu: a block of 256 threads
// owns a (TY x TX) tile of the (y, x) plane and marches over a run of
// planes in z; a thread owns V consecutive x of one row (V = 4 with
// 16-byte loads and stores when nx % 4 == 0 and both pointers are 16-byte
// aligned, else V = 1). Each quotient is computed once: a thread divides
// its own V values, and the block its tile's backward halo (the row above
// and the column to the left), into a two-plane shared ring. The
// difference splits as r(z) = d(z) - d(z - 1), with d the 2D mixed
// difference of one plane, q - q(y-1) - q(x-1) + q(y-1,x-1); a thread keeps
// d(z - 1) in registers, so the ring needs no plane z - 1. The run's first
// plane z - 1 is computed from f, without a store. The loads of plane z + 1
// are in flight while plane z is differenced; one __syncthreads a plane.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "stencil.cuh"

namespace msz {

__device__ __forceinline__ int quant(float f, float step) {
  return (int)rintf(__fdiv_rn(f, step));
}
__device__ __forceinline__ int quant(double f, double step) {
  return (int)rint(__ddiv_rn(f, step));
}

// cells at - 1 .. at + V - 1 of a shared row (`p` = the cell at, 16-byte
// aligned when V == 4)
template <int V>
__device__ __forceinline__ void load_back(const int* p, int (&r)[V + 1]) {
  if constexpr (V == 4) {
    const int4* q = reinterpret_cast<const int4*>(p);
    const int4 a = q[-1], b = q[0];
    r[0] = a.w; r[1] = b.x; r[2] = b.y; r[3] = b.z; r[4] = b.w;
  } else {
    r[0] = p[-1]; r[1] = p[0];
  }
}

template <typename T, int V, int TY>
__global__ void __launch_bounds__(kThreads) lorenzo_tile(
    const T* __restrict__ f, const T* __restrict__ step_p,
    int* __restrict__ r, Geo s, int zrun) {
  constexpr int TPR = kThreads / TY;        // threads a tile row
  constexpr int TX = TPR * V;               // tile columns
  constexpr int RH = TY == 1 ? 0 : 1;       // the halo row above
  constexpr int SP = TX + 4;                // left halo at 3, tile from 4
  constexpr int SLOT = (TY + RH) * SP;
  // halo cells: the row above, its corner first (TY > 1), then the column
  // to the left
  constexpr int NH = TY == 1 ? 1 : TX + 1 + TY;
  constexpr int NHT = (NH + kThreads - 1) / kThreads;
  __shared__ __align__(16) int ring[2][SLOT];

  const int tid = threadIdx.x;
  const int tiles_x = (s.nx + TX - 1) / TX;
  const int tx0 = (int)(blockIdx.x % tiles_x) * TX;
  const int ty0 = (int)(blockIdx.x / tiles_x) * TY;
  const int ty = tid / TPR, tc = (tid % TPR) * V;
  const int y = ty0 + ty, x = tx0 + tc;
  const int plane = s.ny * s.nx;            // launch() bounds it
  const bool own = y < s.ny && x < s.nx;
  const int io = y * s.nx + x;              // its first vertex in a plane
  const int at0 = (ty + RH) * SP + 4 + tc;  // its first cell in a plane
  // own vertices that count as terms: not before the global domain
  bool ok[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    ok[v] = own && s.y0 + y >= 0 && s.x0 + x + v >= 0;
  // the halo cells this thread divides: ring offset, and in-plane index
  // or -1 when the cell lies before the tile or the domain
  int h_at[NHT], h_i[NHT];
#pragma unroll
  for (int j = 0; j < NHT; ++j) {
    const int h = tid + j * kThreads;
    h_at[j] = -1;
    h_i[j] = -1;
    if (h < NH) {
      int rr, c;
      if (TY > 1 && h < TX + 1) {
        rr = 0;
        c = 3 + h;
      } else {
        rr = RH + (TY == 1 ? h : h - (TX + 1));
        c = 3;
      }
      h_at[j] = rr * SP + c;
      const int ly = ty0 + rr - RH, lx = tx0 + c - 4;
      if (ly >= 0 && ly < s.ny && lx >= 0 && lx < s.nx &&
          s.y0 + ly >= 0 && s.x0 + lx >= 0)
        h_i[j] = ly * s.nx + lx;
    }
  }

  const T step = *step_p;
  T fv[V] = {}, hf[NHT] = {};
  auto fetch = [&](int zl) {
    if (zl < 0 || zl >= s.nz) return;
    const long long base = (long long)zl * plane;
    if (own) load_v<V>(f + base + io, fv);
#pragma unroll
    for (int j = 0; j < NHT; ++j)
      if (h_i[j] >= 0) hf[j] = f[base + h_i[j]];
  };

  const int za = (int)blockIdx.y * zrun;
  const int zb = min(za + zrun, s.nz);
  unsigned dprev[V] = {};
  fetch(za - 1);
  for (int z = za - 1; z < zb; ++z) {
    // the quotients of plane z into slot z & 1 (zero before the domain);
    // the slot was last read two passes ago, before the barrier that ended
    // the last pass
    const bool zq = z >= 0 && z < s.nz && s.z0 + z >= 0;
    int* sl = ring[z & 1];
    int q[V];
#pragma unroll
    for (int v = 0; v < V; ++v) q[v] = (zq && ok[v]) ? quant(fv[v], step) : 0;
    store_v<V>(sl + at0, q);
#pragma unroll
    for (int j = 0; j < NHT; ++j)
      if (h_at[j] >= 0)
        sl[h_at[j]] = (zq && h_i[j] >= 0) ? quant(hf[j], step) : 0;
    if (z + 1 < zb) fetch(z + 1);
    __syncthreads();
    // d(z) = q - q(y-1) - q(x-1) + q(y-1,x-1), modulo 2^32
    unsigned d[V];
    int above[V + 1] = {};
    if constexpr (TY > 1) load_back<V>(sl + at0 - SP, above);
    const int left = sl[at0 - 1];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      d[v] = (unsigned)q[v] - (unsigned)(v == 0 ? left : q[v - 1]) -
             (unsigned)above[v + 1] + (unsigned)above[v];
    }
    if (own && z >= za) {
      int out[V];
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = (int)(d[v] - dprev[v]);
      store_v<V>(r + (long long)z * plane + io, out);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) dprev[v] = d[v];
  }
}

template <typename T, int V, int TY>
int launch_tile(const T* f, const T* step, int* r, Geo s, cudaStream_t st) {
  constexpr int TX = kThreads / TY * V;
  // at most one tile a vertex, so within grid.x as the plane is 32-bit
  const long long tiles =
      (long long)((s.nx + TX - 1) / TX) * ((s.ny + TY - 1) / TY);
  const int zrun = z_run(s.nz, tiles);
  const dim3 grid((unsigned)tiles, (unsigned)((s.nz + zrun - 1) / zrun));
  lorenzo_tile<T, V, TY><<<grid, kThreads, 0, st>>>(f, step, r, s, zrun);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* f, const void* step, void* r, Geo s, void* stream) {
  const long long plane = (long long)s.ny * s.nx;
  if (plane == 0 || s.nz == 0) return (int)cudaGetLastError();
  if (plane > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = s.nx % 4 == 0 && aligned16(f) && aligned16(r);
  const T* fp = (const T*)f;
  const T* sp = (const T*)step;
  int* rp = (int*)r;
  cudaStream_t st = (cudaStream_t)stream;
  if (s.ny == 1) {                          // 2D fields, one-row planes
    return vec ? launch_tile<T, 4, 1>(fp, sp, rp, s, st)
               : launch_tile<T, 1, 1>(fp, sp, rp, s, st);
  }
  return vec ? launch_tile<T, 4, 8>(fp, sp, rp, s, st)
             : launch_tile<T, 1, 8>(fp, sp, rp, s, st);
}

}  // namespace msz

#define MSZ_LORENZO_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* f, const void* step, void* r, int nz, \
                      int ny, int nx, int z0, int y0, int x0,           \
                      int device, void* stream) {                       \
    const cudaError_t e = cudaSetDevice(device);                        \
    if (e != cudaSuccess) return (int)e;                                \
    return msz::launch<T>(                                              \
        f, step, r, msz::make_geo(nz, ny, nx, z0, y0, x0, 0, 0, 0),     \
        stream);                                                        \
  }

MSZ_LORENZO_ENTRY(msz_lorenzo_f32, float)
MSZ_LORENZO_ENTRY(msz_lorenzo_f64, double)
