// Steepest directions + fix-source masks of one fused fix iteration, as a
// shared-memory stencil tile.
//
// Replaces the Pallas kernel kernels/extrema.py:_kernel (called through
// extrema_masks_pallas). Per vertex v of g:
//
//   * the SoS-steepest ascending neighbor: the largest (g, global linear
//     index) over v and its stencil neighbors that lie inside the tile
//     and the global domain; the steepest descending one, the smallest.
//     up/dn code = the winner's direction k, or K (14 in 3D, 6 in 2D)
//     when v itself wins. This is the reference's three-reduction
//     _sos_argbest for every finite field;
//   * M_f/m_f at the two winners, then the five int32 outputs of
//     kernels/extrema.py:204-218.
//
// Bound: memory. Each vertex reads g, M_f, m_f and the two bool extremum
// masks of f once and writes five int32: 34 B a vertex in f32, 1.362 ms at
// 512^3 over the H100's 3.35 TB/s. The first kernel (one thread a vertex)
// took 6.94 ms there (NVIDIA H100 80GB HBM3, 700 W): a 64-bit division and
// modulo a vertex, 64-bit linear indices carried through the scans, 14
// neighbour tests each behind a 12-comparison domain check, the +-y and
// +-z neighbours read from other blocks' rows, and two dependent label
// gathers from device memory.
//
// Design. The tile of fixpass.cu: a block of 256 threads owns a (TY x TX)
// tile of the (y, x) plane and marches over a run of planes in z; a
// thread owns V consecutive x of one row, V = 4 with 16-byte loads when
// the rows allow it (nx % 4 == 0 and every pointer 16-byte aligned), else
// V = 1; the tile is 8 rows of 32 V, or one row of 256 V when the plane
// is one row (every 2D field walks as (Y, 1, X)). Shared memory holds a
// ring of four planes of g, M_f and m_f, each with a one-vertex halo; a
// cell outside the tile or the global domain holds NaN in g. The block
// loads plane z + 2 into registers, scans plane z from the ring (planes z
// - 1, z, z + 1), then stores plane z + 2 into the slot plane z - 2 left:
// one __syncthreads a plane, and the loads are in flight during the scan.
//
// The scans carry no linear index. Inside the domain, the order of two
// candidates' linear indices is the order of their offsets' lexicographic
// rank (stencil.cuh, lex_rank), a constant of the stencil slot. Each scan
// visits the directions in scan_slot order, those ranked above v in
// ascending rank, then those below it in descending rank: the ascending
// scan starts from v and keeps a later candidate when its value is >= the
// best in the first half (it outranks all before it) and > in the second
// (all before it outrank it); the descending scan visits the second half
// first with <=, then the first half with <. NaN compares false both ways,
// so one sentinel keeps an invalid cell out of both scans (as a NaN in g
// never won in the first kernel either). A winner is carried as its ring
// address and code packed into one int, and M_f/m_f at it are read from
// the ring, not from device memory. In-plane indices are 32-bit, from
// blockIdx and threadIdx with one division a block; a plane's base is
// 64-bit, once a plane.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "stencil.cuh"

namespace msz {

__device__ __forceinline__ float nan_of(float) {
  return __int_as_float(0x7fc00000);
}
__device__ __forceinline__ double nan_of(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// The shared layout of a tile: a ring of four planes of g, then four of
// M_f, then four of m_f. A plane is TY rows (plus a halo row above and
// below when TY > 1) of SP cells: 3 of padding, the left halo at 3, the
// tile's TX cells from 4 (16-byte aligned), the right halo at TX + 4.
template <typename T, int V, int TY>
struct Tile {
  static constexpr int TPR = kThreads / TY;   // threads a tile row
  static constexpr int TX = TPR * V;          // tile columns
  static constexpr int RH = TY == 1 ? 0 : 1;  // halo rows each side
  static constexpr int SP = TX + 8;
  static constexpr int SLOT = (TY + 2 * RH) * SP;
  static constexpr size_t kBytes = 4 * SLOT * (sizeof(T) + 2 * sizeof(int));
  // halo cells: the rows above and below (TY > 1), then the columns
  static constexpr int NH = TY == 1 ? 2 : 2 * (TX + 2) + 2 * TY;
  static constexpr int NHT = (NH + kThreads - 1) / kThreads;
};

// cells at - 1 .. at + V of a shared row (`p` = the cell at, 16-byte
// aligned when V == 4)
template <int V>
__device__ __forceinline__ void load_seg(const float* p, float (&r)[V + 2]) {
  if constexpr (V == 4) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float4 a = q[-1], b = q[0], c = q[1];
    r[0] = a.w; r[1] = b.x; r[2] = b.y; r[3] = b.z; r[4] = b.w; r[5] = c.x;
  } else {
    r[0] = p[-1]; r[1] = p[0]; r[2] = p[1];
  }
}
template <int V>
__device__ __forceinline__ void load_seg(const double* p,
                                         double (&r)[V + 2]) {
  if constexpr (V == 4) {
    const double2* q = reinterpret_cast<const double2*>(p);
    const double2 a = q[-1], b = q[0], c = q[1], d = q[2];
    r[0] = a.y; r[1] = b.x; r[2] = b.y; r[3] = c.x; r[4] = c.y; r[5] = d.x;
  } else {
    r[0] = p[-1]; r[1] = p[0]; r[2] = p[1];
  }
}

// V flags (0 or 1) from bytes at p (4-byte aligned when V == 4)
template <int V>
__device__ __forceinline__ void load_flags(const uint8_t* p, bool (&r)[V]) {
  if constexpr (V == 4) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = ((w >> (8 * v)) & 0xFFu) != 0;
  } else {
    r[0] = __ldg(p) != 0;
  }
}

// One SoS scan of vertex v from scan position I on. seg[(dz + 1) * 3 + dy
// + 1] holds cells x - 1 .. x + V of row y + dy of plane z + dz, pb[dz +
// 1] the ring address of the thread's first cell in plane z + dz, times
// 16. A win sets best and pick = ring address * 16 + code.
template <typename T, int K, int V, int TY, int SP, bool ASC, int I>
__device__ __forceinline__ void sos_scan(const T (&seg)[9][V + 2], int v,
                                         const int (&pb)[3], T& best,
                                         int& pick) {
  if constexpr (I < K) {
    constexpr int k = scan_slot<K>(ASC ? I : (I + K / 2) % K);
    static_assert(k >= 0, "scan_slot is a permutation of the stencil");
    constexpr int dz = stencil_off<K>(k, 0), dy = stencil_off<K>(k, 1),
                  dx = stencil_off<K>(k, 2);
    // a one-row tile (ny == 1) has no neighbour at dy != 0
    if constexpr (TY > 1 || dy == 0) {
      const T val = seg[(dz + 1) * 3 + dy + 1][1 + v + dx];
      constexpr bool ties_win = I < K / 2;
      bool win;
      if constexpr (ASC) {
        win = ties_win ? val >= best : val > best;
      } else {
        win = ties_win ? val <= best : val < best;
      }
      if (win) {
        best = val;
        pick = pb[dz + 1] + (v + dy * SP + dx) * 16 + k;
      }
    }
    sos_scan<T, K, V, TY, SP, ASC, I + 1>(seg, v, pb, best, pick);
  }
}

// the arrays of one launch
template <typename T>
struct Bufs {
  const T* g;
  const int* Mf;
  const int* mf;
  const uint8_t* maxf;
  const uint8_t* minf;
  int* up;
  int* dn;
  int* se;
  int* dem;
  int* pro;
};

// Two blocks a SM (the ring takes 65 KB in f32, 87 KB in f64 at TY = 8):
// the registers are not capped below what the scans need. Three blocks
// (f32) spilled 8 B and ran no faster.
template <typename T, int K, int V, int TY>
__global__ void __launch_bounds__(kThreads, 2)
    extrema_tile(Bufs<T> b, Geo s, int zrun) {
  using L = Tile<T, V, TY>;
  constexpr int TPR = L::TPR, TX = L::TX, RH = L::RH, SP = L::SP,
                SLOT = L::SLOT, NH = L::NH, NHT = L::NHT;
  extern __shared__ __align__(16) unsigned char smem[];
  T* gs = reinterpret_cast<T*>(smem);
  int* Ms = reinterpret_cast<int*>(gs + 4 * SLOT);
  int* ms = Ms + 4 * SLOT;

  const int tid = threadIdx.x;
  const int tiles_x = (s.nx + TX - 1) / TX;
  const int tx0 = (int)(blockIdx.x % tiles_x) * TX;
  const int ty0 = (int)(blockIdx.x / tiles_x) * TY;
  const int ty = tid / TPR, tc = (tid % TPR) * V;
  const int y = ty0 + ty, x = tx0 + tc;
  const int plane = s.ny * s.nx;            // launch() bounds it
  // this thread's vertices lie in the tile (all V of them when V == 4:
  // nx % 4 == 0 and x % 4 == 0)
  const bool own = y < s.ny && x < s.nx;
  const int io = y * s.nx + x;              // its first vertex in a plane
  const int at0 = (ty + RH) * SP + 4 + tc;  // its first cell in a plane
  bool src_ok[V];
#pragma unroll
  for (int v = 0; v < V; ++v) src_ok[v] = in_plane(s, y, x + v);
  // the halo cells this thread loads: ring offset, and in-plane index or
  // -1 when the cell lies off the tile or the domain
  int h_at[NHT], h_i[NHT];
#pragma unroll
  for (int j = 0; j < NHT; ++j) {
    const int h = tid + j * kThreads;
    h_at[j] = -1;
    h_i[j] = -1;
    if (h < NH) {
      int r, c;
      if (TY > 1 && h < 2 * (TX + 2)) {
        r = h < TX + 2 ? 0 : TY + 1;
        c = 3 + (h < TX + 2 ? h : h - (TX + 2));
      } else {
        const int e = TY == 1 ? h : h - 2 * (TX + 2);
        r = RH + (e >> 1);
        c = (e & 1) ? TX + 4 : 3;
      }
      h_at[j] = r * SP + c;
      const int ly = ty0 + r - RH, lx = tx0 + c - 4;
      if (in_plane(s, ly, lx)) h_i[j] = ly * s.nx + lx;
    }
  }

  // plane zl in registers, on its way to the ring
  T fg[V] = {}, hg[NHT] = {};
  int fM[V] = {}, fm[V] = {}, hM[NHT] = {}, hm[NHT] = {};
  auto fetch = [&](int zl) {
    const long long base = (long long)zl * plane;
    if (own && zl >= 0 && zl < s.nz) {
      load_v<V>(b.g + base + io, fg);
      load_v<V>(b.Mf + base + io, fM);
      load_v<V>(b.mf + base + io, fm);
    }
    if (in_z(s, zl)) {
#pragma unroll
      for (int j = 0; j < NHT; ++j) {
        if (h_i[j] >= 0) {
          hg[j] = b.g[base + h_i[j]];
          hM[j] = __ldg(b.Mf + base + h_i[j]);
          hm[j] = __ldg(b.mf + base + h_i[j]);
        }
      }
    }
  };
  auto commit = [&](int zl) {
    const bool zok = in_z(s, zl);
    const int o = (zl & 3) * SLOT;
    T cg[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      cg[v] = (own && zok && src_ok[v]) ? fg[v] : nan_of(T());
    store_v<V>(gs + o + at0, cg);
    store_v<V>(Ms + o + at0, fM);
    store_v<V>(ms + o + at0, fm);
#pragma unroll
    for (int j = 0; j < NHT; ++j) {
      if (h_at[j] >= 0) {
        gs[o + h_at[j]] = (zok && h_i[j] >= 0) ? hg[j] : nan_of(T());
        Ms[o + h_at[j]] = hM[j];
        ms[o + h_at[j]] = hm[j];
      }
    }
  };

  const int za = (int)blockIdx.y * zrun;
  const int zb = min(za + zrun, s.nz);
  for (int zl = za - 1; zl <= za + 1; ++zl) {
    fetch(zl);
    commit(zl);
  }
  __syncthreads();
  for (int z = za; z < zb; ++z) {
    const bool more = z + 2 <= zb;          // plane z + 2 is read
    if (more) fetch(z + 2);
    if (own) {
      // ring offsets of the thread's first cell in planes z - 1, z, z + 1
      const int ob[3] = {((z + 3) & 3) * SLOT + at0, (z & 3) * SLOT + at0,
                         ((z + 1) & 3) * SLOT + at0};
      const int pb[3] = {ob[0] * 16, ob[1] * 16, ob[2] * 16};
      const long long j = (long long)z * plane + io;
      bool is_max_f[V], is_min_f[V];
      load_flags<V>(b.maxf + j, is_max_f);
      load_flags<V>(b.minf + j, is_min_f);
      const bool zok = in_z(s, z);
      T seg[9][V + 2];
#pragma unroll
      for (int dz = -1; dz <= 1; ++dz) {
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
          // rows no direction reads are never loaded (the compiler drops
          // them); a one-row tile has only its own row
          if (TY > 1 || dy == 0)
            load_seg<V>(gs + ob[dz + 1] + dy * SP, seg[(dz + 1) * 3 + dy + 1]);
        }
      }
      int up[V], dn[V], se[V], de[V], pr[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        // the vertex's own value, also where it lies off the domain
        // (its ring cell then holds NaN)
        const T gv = (zok && src_ok[v]) ? seg[4][1 + v] : b.g[j + v];
        T ub = gv, db = gv;
        int pu = pb[1] + v * 16 + K, pd = pu;
        sos_scan<T, K, V, TY, SP, true, 0>(seg, v, pb, ub, pu);
        sos_scan<T, K, V, TY, SP, false, 0>(seg, v, pb, db, pd);
        const int uc = pu & 15, dc = pd & 15;
        const int Mv = Ms[ob[1] + v], mv = ms[ob[1] + v];
        const bool is_max_g = uc == K, is_min_g = dc == K;
        const bool fpmax = is_max_g && !is_max_f[v];
        const bool fpmin = is_min_g && !is_min_f[v];
        const bool fnmax = !is_max_g && is_max_f[v];
        const bool fnmin = !is_min_g && is_min_f[v];
        const bool trouble_max = !is_max_g && Ms[pu >> 4] != Mv;
        const bool trouble_min = !is_min_g && ms[pd >> 4] != mv;
        up[v] = uc;
        dn[v] = dc;
        se[v] = (fpmax || fnmin) ? 1 : 0;
        de[v] = (fnmax || trouble_max) ? 1 : 0;
        pr[v] = (fpmin || trouble_min) ? 1 : 0;
      }
      store_v<V>(b.up + j, up);
      store_v<V>(b.dn + j, dn);
      store_v<V>(b.se + j, se);
      store_v<V>(b.dem + j, de);
      store_v<V>(b.pro + j, pr);
    }
    // slot (z + 2) & 3 was last read in the previous pass, before the
    // barrier that ended it
    if (more) commit(z + 2);
    __syncthreads();
  }
}

template <typename T, int K, int V, int TY>
int launch_tile(const Bufs<T>& b, Geo s, cudaStream_t st) {
  using L = Tile<T, V, TY>;
  auto kern = extrema_tile<T, K, V, TY>;
  // above 48 KB only by opting in; set at every launch (a cheap call), so
  // no state outlives it
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kBytes);
  if (e != cudaSuccess) return (int)e;
  // at most one tile a vertex, so within grid.x as the plane is 32-bit
  const long long tiles =
      (long long)((s.nx + L::TX - 1) / L::TX) * ((s.ny + TY - 1) / TY);
  const int zrun = z_run(s.nz, tiles);
  const dim3 grid((unsigned)tiles, (unsigned)((s.nz + zrun - 1) / zrun));
  kern<<<grid, kThreads, L::kBytes, st>>>(b, s, zrun);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* g, const void* Mf, const void* mf, const void* maxf,
           const void* minf, void* up, void* dn, void* se, void* dem,
           void* pro, int ndim, Geo s, void* stream) {
  const long long plane = (long long)s.ny * s.nx;
  if (plane == 0 || s.nz == 0) return (int)cudaGetLastError();
  if (plane > INT_MAX || (ndim == 2 && s.ny != 1))
    return (int)cudaErrorInvalidValue;
  const Bufs<T> b{(const T*)g,        (const int*)Mf,     (const int*)mf,
                  (const uint8_t*)maxf, (const uint8_t*)minf, (int*)up,
                  (int*)dn,           (int*)se,           (int*)dem,
                  (int*)pro};
  const bool vec = s.nx % 4 == 0 && aligned16(g) && aligned16(Mf) &&
                   aligned16(mf) && aligned16(maxf) && aligned16(minf) &&
                   aligned16(up) && aligned16(dn) && aligned16(se) &&
                   aligned16(dem) && aligned16(pro);
  cudaStream_t st = (cudaStream_t)stream;
  if (ndim == 2) {
    return vec ? launch_tile<T, 6, 4, 1>(b, s, st)
               : launch_tile<T, 6, 1, 1>(b, s, st);
  }
  if (s.ny == 1) {
    return vec ? launch_tile<T, 14, 4, 1>(b, s, st)
               : launch_tile<T, 14, 1, 1>(b, s, st);
  }
  return vec ? launch_tile<T, 14, 4, 8>(b, s, st)
             : launch_tile<T, 14, 1, 8>(b, s, st);
}

}  // namespace msz

#define MSZ_EXTREMA_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* g, const void* Mf, const void* mf,       \
                      const void* maxf, const void* minf, void* up,        \
                      void* dn, void* se, void* dem, void* pro, int ndim,  \
                      int nz, int ny, int nx, int z0, int y0, int x0,      \
                      int N, int NY, int NX, int device,                   \
                      void* stream) {                                      \
    const cudaError_t e = cudaSetDevice(device);                           \
    if (e != cudaSuccess) return (int)e;                                   \
    return msz::launch<T>(g, Mf, mf, maxf, minf, up, dn, se, dem, pro,     \
                          ndim,                                            \
                          msz::make_geo(nz, ny, nx, z0, y0, x0, N, NY, NX), \
                          stream);                                         \
  }

MSZ_EXTREMA_ENTRY(msz_extrema_f32, float)
MSZ_EXTREMA_ENTRY(msz_extrema_f64, double)
