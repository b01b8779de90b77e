// Shared geometry and helpers of the hand-written MSz stencil kernels
// (sm_90a): extrema.cu, fixpass.cu and lorenzo.cu.
//
// A field is walked as (nz, ny, nx): a 3D field (Z, Y, X) as it is, a 2D
// field (Y, X) as (Y, 1, X), exactly as the reference's slab kernels see
// it (kernels/extrema.py:slab_offsets). The tensor a kernel gets may be a
// tile of a larger field: (z0, y0, x0) is the tile origin and (N, NY, NX)
// the global extents. Domain edges use GLOBAL coordinates, so a vertex
// whose one-vertex neighborhood lies inside the tile gets the bits an
// untiled run gives it.
//
// All three kernels are tiles of the same shape: a block of kThreads
// threads owns a (TY x TX) tile of the (y, x) plane and marches over a
// run of planes in z (z_run below); a thread owns V consecutive x of one
// row, V = 4 with 16-byte loads when the rows allow it, else V = 1.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace msz {

struct Geo {
  int nz, ny, nx;   // local extents
  int z0, y0, x0;   // tile origin in the global field
  int N, NY, NX;    // global extents
};

constexpr int kThreads = 256;
// blocks a launch aims at: about 4 waves of 8 blocks on 132 SMs
constexpr long long kTargetBlocks = 4LL * 8 * 132;

// (dz, dy, dx) of Freudenthal stencil direction k, in the order and with
// the signs of core/grid.py's OFFSETS_3D / OFFSETS_2D (2D offsets (dy, dx)
// become (dy, 0, dx)). Direction 2j + 1 is direction 2j negated.
template <int K>
__host__ __device__ constexpr int stencil_off(int k, int c) {
  constexpr int o3[14][3] = {
      {0, 0, 1},  {0, 0, -1},  {0, 1, 0},  {0, -1, 0},  {1, 0, 0},
      {-1, 0, 0}, {0, 1, 1},   {0, -1, -1}, {1, 0, 1},  {-1, 0, -1},
      {1, 1, 0},  {-1, -1, 0}, {1, 1, 1},  {-1, -1, -1}};
  constexpr int o2[6][3] = {{0, 0, 1}, {0, 0, -1}, {1, 0, 0},
                            {-1, 0, 0}, {1, 0, 1}, {-1, 0, -1}};
  return K == 14 ? o3[k][c] : o2[k][c];
}

// Lexicographic rank of slot k's offset (dz, dy, dx) among the 27 of
// {-1, 0, 1}^3; slot K is the vertex itself, rank 13. For two vertices of
// one neighborhood that both lie inside the global domain, the sign of
// their global linear-index difference is the sign of their rank
// difference: linear indices order vertices lexicographically by (z, y,
// x), and both share the centre.
template <int K>
__host__ __device__ constexpr int lex_rank(int k) {
  return k == K ? 13
                : (stencil_off<K>(k, 0) + 1) * 9 +
                      (stencil_off<K>(k, 1) + 1) * 3 + stencil_off<K>(k, 2) +
                      1;
}

// Slot i of the scan order of the SoS scans: first the K/2 directions
// that rank above the vertex, in ascending rank, then the K/2 below it,
// in descending rank. Every direction ranks above or below (the offsets
// come in +- pairs and none is 0), so this is a permutation.
template <int K>
__host__ __device__ constexpr int scan_slot(int i) {
  int j = i < K / 2 ? i : i - K / 2;
  for (int step = 0; step < 13; ++step) {
    const int r = i < K / 2 ? 14 + step : 12 - step;
    for (int k = 0; k < K; ++k) {
      if (lex_rank<K>(k) == r) {
        if (j == 0) return k;
        --j;
      }
    }
  }
  return -1;
}

// Whether (ly, lx) lies inside the tile's plane and the global domain.
__device__ __forceinline__ bool in_plane(const Geo& s, int ly, int lx) {
  return ly >= 0 && ly < s.ny && lx >= 0 && lx < s.nx && s.y0 + ly >= 0 &&
         s.y0 + ly < s.NY && s.x0 + lx >= 0 && s.x0 + lx < s.NX;
}

// Whether local plane zl lies inside the tile and the global domain.
__device__ __forceinline__ bool in_z(const Geo& s, int zl) {
  return zl >= 0 && zl < s.nz && s.z0 + zl >= 0 && s.z0 + zl < s.N;
}

// V consecutive values from p (16-byte aligned when V == 4)
template <int V>
__device__ __forceinline__ void load_v(const int* p, int (&r)[V]) {
  if constexpr (V == 4) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  } else {
    r[0] = __ldg(p);
  }
}
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
  } else {
    r[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load_v(const double* p, double (&r)[V]) {
  if constexpr (V == 4) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    r[0] = a.x; r[1] = a.y; r[2] = b.x; r[3] = b.y;
  } else {
    r[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void store_v(int* p, const int (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(r[0], r[1], r[2], r[3]);
  } else {
    *p = r[0];
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    *p = r[0];
  }
}
template <int V>
__device__ __forceinline__ void store_v(double* p, const double (&r)[V]) {
  if constexpr (V == 4) {
    reinterpret_cast<double2*>(p)[0] = make_double2(r[0], r[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(r[2], r[3]);
  } else {
    *p = r[0];
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Planes a block of a launch over `tiles` (y, x) tiles marches over:
// enough blocks to fill the card, at least 4 a run so its halo planes
// stay a small share, and at most 65535 runs (the grid's y limit).
inline int z_run(int nz, long long tiles) {
  long long zrun = ((long long)nz * tiles + kTargetBlocks - 1) /
                   kTargetBlocks;
  zrun = zrun < 4 ? 4 : zrun;
  zrun = zrun < (nz + 65534LL) / 65535 ? (nz + 65534LL) / 65535 : zrun;
  zrun = zrun > nz ? nz : zrun;
  return (int)zrun;
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
