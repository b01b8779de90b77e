// Pull-based edit pass of one fused fix iteration, as a shared-memory
// stencil tile.
//
// Replaces the Pallas kernel kernels/fixpass.py:_kernel (called through
// fix_pass_pallas). Vertex j is an edit target when self_edit[j], or a
// stencil source i = j - off_k (inside the tile and the global domain)
// has demote_src[i] and up_code_g[i] == k, or promote_src[i] and
// dn_code_f[i] == k. Note the promote pull reads the ORIGINAL field's
// descending codes. Targets become (g + lower) * 0.5, raised to lower
// where that falls below it; the arithmetic is rounded to nearest in the
// field's type, with no contraction. viol[z] sums the values of
// self_edit + demote_src + promote_src over slab z, tgt[z] counts its
// targets.
//
// Bound: memory. Each vertex reads g, lower and five int32 arrays once
// and writes g': 32 B a vertex in f32, 1.282 ms at 512^3 over the H100's
// 3.35 TB/s. The first kernel (one thread a vertex, blocks of 256
// vertices of one row) took 7.45 ms there (NVIDIA H100 80GB HBM3,
// 700 W): a 64-bit division and modulo a vertex, up to 14 neighbour
// tests each behind a 12-comparison domain check, their loads issued one
// after another behind an early exit, and the +-y and +-z neighbours read
// from other blocks' rows.
//
// Design. A block of 256 threads owns a (TY x TX) tile of the (y, x)
// plane and marches over a run of planes in z. A thread owns V
// consecutive x of one row: V = 4 with 16-byte loads when the rows allow
// it (nx % 4 == 0 and every pointer 16-byte aligned), else V = 1. The
// tile is 8 rows of 32 V, or one row of 256 V when the plane is one row
// (every 2D field walks as (Y, 1, X)). As the block loads plane z + 1 it
// packs each vertex's two pulls into one byte of shared memory, with a
// one-vertex halo: dcode = demote_src ? up_code_g : NONE in the low
// nibble, pcode = promote_src ? dn_code_f : NONE in the high one (codes
// 0..13, NONE = 15). A cell outside the tile or the global domain holds
// NONE, so it never pulls. A ring of four planes lets one __syncthreads
// a plane separate the load of z + 1 from the tests of z, and each plane
// of codes is read from device memory once a run (plus the two halo
// planes of the run and the tile's halo, which its neighbours read too
// and L2 mostly serves). Each test of plane z
// reads 14 (3D) or 6 (2D) bytes of shared memory, with no branch and no
// early exit. Indices within a plane are 32-bit, from blockIdx and
// threadIdx with one division a block; a plane's base is 64-bit, once a
// plane. The counts are a warp reduction per plane, then one integer
// atomicAdd per (block, plane): integer atomics commute, so they are
// deterministic. Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W):
// 1.63-1.68 ms at 512^3, 1.27-1.31x the bound; 0.13-0.15 ms on the
// 1800 x 3600 climate field, whose planes are single rows (bound
// 0.062 ms).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

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

constexpr int kWarps = kThreads / 32;
constexpr unsigned kNone = 15;          // a nibble that pulls nothing
constexpr uint8_t kNoneByte = 0xFF;     // a cell that pulls nothing

// One byte of pulls: dcode in the low nibble, pcode in the high one.
template <int K>
__device__ __forceinline__ uint8_t pack_pulls(int dem, int pro, int upg,
                                              int dnf) {
  const unsigned d = (dem != 0 && (unsigned)upg < (unsigned)K)
                         ? (unsigned)upg : kNone;
  const unsigned p = (pro != 0 && (unsigned)dnf < (unsigned)K)
                         ? (unsigned)dnf : kNone;
  return (uint8_t)(d | (p << 4));
}

// Whether a source pulls the vertex at offset `at` of its plane's code
// tile: the cell at -off_k, in plane z - dz, carries k in a nibble. zm,
// z0 and zp are the code tiles of planes z - 1, z and z + 1.
template <int K, int k, int SP>
__device__ __forceinline__ bool pulled(const uint8_t* zm, const uint8_t* z0,
                                       const uint8_t* zp, int at) {
  constexpr int dz = stencil_off<K>(k, 0), dy = stencil_off<K>(k, 1),
                dx = stencil_off<K>(k, 2);
  const uint8_t* src = dz == 1 ? zm : (dz == -1 ? zp : z0);
  const unsigned b = src[at - dy * SP - dx];
  const bool hit = ((b & 15u) == (unsigned)k) | ((b >> 4) == (unsigned)k);
  if constexpr (k + 1 < K) {
    return hit | pulled<K, k + 1, SP>(zm, z0, zp, at);
  } else {
    return hit;
  }
}

// the four arrays a pull reads, at a source vertex
struct Srcs {
  const int* dem;
  const int* pro;
  const int* upg;
  const int* dnf;
};

template <typename T, int K, int V, int TY>
__global__ void __launch_bounds__(kThreads) fixpass_tile(
    const T* __restrict__ g, const T* __restrict__ low,
    const int* __restrict__ selfe, Srcs src, T* __restrict__ g_out,
    int* __restrict__ viol, int* __restrict__ tgt, Geo s, int zrun) {
  constexpr int TPR = kThreads / TY;        // threads a tile row
  constexpr int TX = TPR * V;               // tile columns
  constexpr int SP = TX + 2;                // a code row and its halo
  constexpr int SLOT = (TY + 2) * SP;       // a code plane and its halo
  __shared__ uint8_t ring[4][SLOT];
  __shared__ int cnt[4][2][kWarps];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles_x = (s.nx + TX - 1) / TX;
  const int tx0 = (int)(blockIdx.x % tiles_x) * TX;
  const int ty0 = (int)(blockIdx.x / tiles_x) * TY;
  const int ty = tid / TPR, tc = (tid % TPR) * V;
  const int y = ty0 + ty, x = tx0 + tc;
  const int plane = s.ny * s.nx;            // launch() bounds it
  // this thread's vertices lie in the tile (all V of them when V == 4:
  // nx % 4 == 0 and x % 4 == 0)
  const bool own = y < s.ny && x < s.nx;
  const int at0 = (ty + 1) * SP + tc + 1;   // its first cell in a tile
  bool src_ok[V];
#pragma unroll
  for (int v = 0; v < V; ++v) src_ok[v] = in_plane(s, y, x + v);

  if constexpr (TY == 1) {
    // a one-row plane: the rows above and below lie outside it for good
    for (int i = tid; i < 4 * SLOT; i += kThreads)
      (&ring[0][0])[i] = kNoneByte;
    __syncthreads();
  }

  // Pack plane zl's pulls into `sl`; dp gets the plane's demote_src +
  // promote_src values at this thread's own vertices.
  auto load = [&](int zl, uint8_t* sl, int& dp) {
    const bool zloc = zl >= 0 && zl < s.nz;
    const bool zok = in_z(s, zl);
    const long long base = (long long)zl * plane;
    if (own && zloc) {
      const int i = y * s.nx + x;
      int dv[V], pv[V], uv[V], nv[V];
      load_v<V>(src.dem + base + i, dv);
      load_v<V>(src.pro + base + i, pv);
      load_v<V>(src.upg + base + i, uv);
      load_v<V>(src.dnf + base + i, nv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        dp += dv[v] + pv[v];
        sl[at0 + v] = (zok && src_ok[v])
                          ? pack_pulls<K>(dv[v], pv[v], uv[v], nv[v])
                          : kNoneByte;
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) sl[at0 + v] = kNoneByte;
    }
    // the halo: rows above and below (TY > 1), then columns left, right
    constexpr int NH = TY == 1 ? 2 : 2 * SP + 2 * TY;
    for (int h = tid; h < NH; h += kThreads) {
      int r, c;
      if (TY > 1 && h < 2 * SP) {
        r = h < SP ? 0 : TY + 1;
        c = h < SP ? h : h - SP;
      } else {
        const int e = TY == 1 ? h : h - 2 * SP;
        r = 1 + (e >> 1);
        c = (e & 1) ? SP - 1 : 0;
      }
      const int ly = ty0 + r - 1, lx = tx0 + c - 1;
      uint8_t code = kNoneByte;
      if (zok && in_plane(s, ly, lx)) {
        const long long i = base + ly * s.nx + lx;
        code = pack_pulls<K>(__ldg(src.dem + i), __ldg(src.pro + i),
                             __ldg(src.upg + i), __ldg(src.dnf + i));
      }
      sl[r * SP + c] = code;
    }
  };
  auto flush = [&](int z) {
    int a = 0, b = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += cnt[z & 3][0][w];
      b += cnt[z & 3][1][w];
    }
    if (a) atomicAdd(&viol[z], a);
    if (b) atomicAdd(&tgt[z], b);
  };

  const int za = (int)blockIdx.y * zrun;
  const int zb = min(za + zrun, s.nz);
  int dp_cur = 0, dp_halo = 0;
  load(za - 1, ring[(za + 3) & 3], dp_halo);
  load(za, ring[za & 3], dp_cur);
  for (int z = za; z < zb; ++z) {
    // slots z - 1, z, z + 1 are read below; the load of z + 2 in the
    // next pass writes the fourth, so one barrier a plane suffices
    int dp_next = 0;
    load(z + 1, ring[(z + 1) & 3], dp_next);
    __syncthreads();
    if (tid == 0 && z > za) flush(z - 1);
    int n_src = dp_cur, n_tgt = 0;
    if (own) {
      const long long j = (long long)z * plane + (y * s.nx + x);
      int se[V];
      T gv[V], lv[V], out[V];
      load_v<V>(selfe + j, se);
      load_v<V>(g + j, gv);
      load_v<V>(low + j, lv);
      const uint8_t* zm = ring[(z + 3) & 3];
      const uint8_t* zc = ring[z & 3];
      const uint8_t* zp = ring[(z + 1) & 3];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const bool t = (se[v] != 0) | pulled<K, 0, SP>(zm, zc, zp, at0 + v);
        out[v] = t ? halve(gv[v], lv[v]) : gv[v];
        n_src += se[v];
        n_tgt += t ? 1 : 0;
      }
      store_v<V>(g_out + j, out);
    }
    n_src = __reduce_add_sync(0xffffffffu, n_src);
    n_tgt = __reduce_add_sync(0xffffffffu, n_tgt);
    if (lane == 0) {
      cnt[z & 3][0][warp] = n_src;
      cnt[z & 3][1][warp] = n_tgt;
    }
    dp_cur = dp_next;
  }
  __syncthreads();
  if (tid == 0 && zb > za) flush(zb - 1);
}

template <typename T, int K, int V, int TY>
int launch_tile(const T* g, const T* low, const int* se, Srcs src, T* g_out,
                int* viol, int* tgt, Geo s, cudaStream_t st) {
  constexpr int TX = kThreads / TY * V;
  // at most one tile a vertex, so within grid.x as the plane is 32-bit
  const long long tiles =
      (long long)((s.nx + TX - 1) / TX) * ((s.ny + TY - 1) / TY);
  const int zrun = z_run(s.nz, tiles);
  const dim3 grid((unsigned)tiles, (unsigned)((s.nz + zrun - 1) / zrun));
  fixpass_tile<T, K, V, TY><<<grid, kThreads, 0, st>>>(
      g, low, se, src, g_out, viol, tgt, s, zrun);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* g, const void* low, const void* se, const void* dem,
           const void* pro, const void* upg, const void* dnf, void* g_out,
           void* viol, void* tgt, int ndim, Geo s, void* stream) {
  const long long plane = (long long)s.ny * s.nx;
  if (plane == 0 || s.nz == 0) return (int)cudaGetLastError();
  if (plane > INT_MAX || (ndim == 2 && s.ny != 1))
    return (int)cudaErrorInvalidValue;
  const Srcs src{(const int*)dem, (const int*)pro, (const int*)upg,
                 (const int*)dnf};
  const bool vec = s.nx % 4 == 0 && aligned16(g) && aligned16(low) &&
                   aligned16(se) && aligned16(dem) && aligned16(pro) &&
                   aligned16(upg) && aligned16(dnf) && aligned16(g_out);
  const T* gp = (const T*)g;
  const T* lp = (const T*)low;
  const int* sp = (const int*)se;
  T* op = (T*)g_out;
  int* vp = (int*)viol;
  int* tp = (int*)tgt;
  cudaStream_t st = (cudaStream_t)stream;
  if (ndim == 2) {
    return vec ? launch_tile<T, 6, 4, 1>(gp, lp, sp, src, op, vp, tp, s, st)
               : launch_tile<T, 6, 1, 1>(gp, lp, sp, src, op, vp, tp, s, st);
  }
  if (s.ny == 1) {
    return vec ? launch_tile<T, 14, 4, 1>(gp, lp, sp, src, op, vp, tp, s, st)
               : launch_tile<T, 14, 1, 1>(gp, lp, sp, src, op, vp, tp, s, st);
  }
  return vec ? launch_tile<T, 14, 4, 8>(gp, lp, sp, src, op, vp, tp, s, st)
             : launch_tile<T, 14, 1, 8>(gp, lp, sp, src, op, vp, tp, s, st);
}

}  // namespace msz

#define MSZ_FIXPASS_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* g, const void* low, const void* se,       \
                      const void* dem, const void* pro, const void* upg,    \
                      const void* dnf, void* g_out, void* viol, void* tgt,  \
                      int ndim, int nz, int ny, int nx, int z0, int y0,     \
                      int x0, int N, int NY, int NX, int device,            \
                      void* stream) {                                       \
    const cudaError_t e = cudaSetDevice(device);                            \
    if (e != cudaSuccess) return (int)e;                                    \
    return msz::launch<T>(g, low, se, dem, pro, upg, dnf, g_out, viol, tgt, \
                          ndim,                                             \
                          msz::make_geo(nz, ny, nx, z0, y0, x0, N, NY, NX),  \
                          stream);                                          \
  }

MSZ_FIXPASS_ENTRY(msz_fixpass_f32, float)
MSZ_FIXPASS_ENTRY(msz_fixpass_f64, double)
