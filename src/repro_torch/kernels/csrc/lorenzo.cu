// Quantize + integer Lorenzo residual: the szlike compressor's forward
// transform.
//
// Replaces the Pallas kernel kernels/lorenzo.py:_kernel (called through
// lorenzo_quant_pallas). One thread per vertex recomputes the up to 8
// quantized values q = rint(f / step) of its backward unit cube (IEEE
// division rounded to nearest, rint rounding half to even as jnp.round
// does, both in the field's type) and writes the mixed backward
// difference
//
//   3D: q - q(z-1) - q(y-1) - q(x-1) + q(z-1,y-1) + q(z-1,x-1)
//         + q(y-1,x-1) - q(z-1,y-1,x-1)
//   2D: the same on (Y, 1, X), where every y-1 term is zero.
//
// A term is zero when its position lies before the tile or before the
// global domain (global z == 0 through z0, and y == 0 / x == 0). The
// step is a device scalar of the field's type, as the Pallas operand is.
//
// Bound: memory. 4 B read and 4 B written per vertex in f32; the 7
// backward neighbor loads hit L1/L2 and the 8 divisions per vertex stay
// far below the card's FP rate.
#include <cuda_runtime.h>

#include "stencil.cuh"

namespace msz {

__device__ __forceinline__ long long quant(float f, float step) {
  return (long long)(int)rintf(__fdiv_rn(f, step));
}
__device__ __forceinline__ long long quant(double f, double step) {
  return (long long)(int)rint(__ddiv_rn(f, step));
}

template <typename T>
__global__ void __launch_bounds__(256) lorenzo_kernel(
    const T* __restrict__ f, const T* __restrict__ step_p,
    int* __restrict__ r, Geo s) {
  const long long n = (long long)s.nz * s.ny * s.nx;
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n) return;
  const int x = (int)(v % s.nx);
  const long long t = v / s.nx;
  const int y = (int)(t % s.ny);
  const int z = (int)(t / s.ny);
  const T step = *step_p;
  long long acc = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dz = (c >> 2) & 1, dy = (c >> 1) & 1, dx = c & 1;
    const int lz = z - dz, ly = y - dy, lx = x - dx;
    if (lz < 0 || ly < 0 || lx < 0) continue;
    if (s.z0 + lz < 0 || s.y0 + ly < 0 || s.x0 + lx < 0) continue;
    const long long q =
        quant(f[v - ((long long)dz * s.ny + dy) * s.nx - dx], step);
    acc += ((dz + dy + dx) & 1) ? -q : q;
  }
  r[v] = (int)acc;
}

template <typename T>
int launch(const void* f, const void* step, void* r, Geo s, void* stream) {
  const long long n = (long long)s.nz * s.ny * s.nx;
  if (n == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  lorenzo_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)f, (const T*)step, (int*)r, s);
  return (int)cudaGetLastError();
}

}  // namespace msz

#define MSZ_LORENZO_ENTRY(NAME, T)                                       \
  extern "C" int NAME(const void* f, const void* step, void* r, int nz, \
                      int ny, int nx, int z0, int y0, int x0,           \
                      void* stream) {                                   \
    return msz::launch<T>(                                              \
        f, step, r, msz::make_geo(nz, ny, nx, z0, y0, x0, 0, 0, 0),     \
        stream);                                                        \
  }

MSZ_LORENZO_ENTRY(msz_lorenzo_f32, float)
MSZ_LORENZO_ENTRY(msz_lorenzo_f64, double)
