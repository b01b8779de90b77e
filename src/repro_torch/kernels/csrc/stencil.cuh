// Shared geometry of the hand-written MSz stencil kernels (sm_90a).
//
// A field is walked as (nz, ny, nx): a 3D field (Z, Y, X) as it is, a 2D
// field (Y, X) as (Y, 1, X), exactly as the reference's slab kernels see
// it (kernels/extrema.py:slab_offsets). The tensor a kernel gets may be a
// tile of a larger field: (z0, y0, x0) is the tile origin and (N, NY, NX)
// the global extents. SoS linear indices and domain edges use GLOBAL
// coordinates, so a vertex whose one-vertex neighborhood lies inside the
// tile gets the bits an untiled run gives it.
#pragma once

#include <cuda_runtime.h>

namespace msz {

struct Geo {
  int nz, ny, nx;   // local extents
  int z0, y0, x0;   // tile origin in the global field
  int N, NY, NX;    // global extents
};

// Freudenthal stencils as (dz, dy, dx); 2D offsets (dy, dx) become
// (dy, 0, dx). Order and signs are core/grid.py's OFFSETS_3D/OFFSETS_2D.
__constant__ int OFF3[14][3] = {
    {0, 0, 1},  {0, 0, -1},  {0, 1, 0},  {0, -1, 0},  {1, 0, 0},
    {-1, 0, 0}, {0, 1, 1},   {0, -1, -1}, {1, 0, 1},  {-1, 0, -1},
    {1, 1, 0},  {-1, -1, 0}, {1, 1, 1},  {-1, -1, -1}};
__constant__ int OFF2[6][3] = {
    {0, 0, 1}, {0, 0, -1}, {1, 0, 0}, {-1, 0, 0}, {1, 0, 1}, {-1, 0, -1}};

template <int K>
__device__ __forceinline__ int off(int k, int c) {
  return K == 14 ? OFF3[k][c] : OFF2[k][c];
}

// Whether local vertex (z, y, x) + (dz, dy, dx) lies inside the tile AND
// inside the global domain.
__device__ __forceinline__ bool inside(const Geo& s, int z, int y, int x,
                                       int dz, int dy, int dx) {
  const int lz = z + dz, ly = y + dy, lx = x + dx;
  if (lz < 0 || lz >= s.nz || ly < 0 || ly >= s.ny || lx < 0 || lx >= s.nx)
    return false;
  const int gz = s.z0 + lz, gy = s.y0 + ly, gx = s.x0 + lx;
  return gz >= 0 && gz < s.N && gy >= 0 && gy < s.NY && gx >= 0 && gx < s.NX;
}

inline Geo make_geo(int nz, int ny, int nx, int z0, int y0, int x0, int N,
                    int NY, int NX) {
  Geo s;
  s.nz = nz; s.ny = ny; s.nx = nx;
  s.z0 = z0; s.y0 = y0; s.x0 = x0;
  s.N = N; s.NY = NY; s.NX = NX;
  return s;
}

}  // namespace msz
