// Causal or full GQA flash-attention forward.
//
// Replaces the Pallas kernel kernels/flash.py:_kernel (the pallas_call in
// _call, flash.py:102, reached through flash_attention_pallas). It computes
// what that kernel computes, in the same order of operations per row:
//
//   q' = f32(q) * scale               (scale = f32(Dh ** -0.5), from the host)
//   s  = q' . k  in f32               (masked to -inf where q_pos < k_pos
//                                      when causal, and past the end of T)
//   m' = max(m, max_j s)              m_safe = finite(m') ? m' : 0
//   p  = finite(s) ? exp(s - m_safe) : 0      (kept in f32)
//   c  = finite(m) ? exp(m - m_safe) : 0
//   l  = l * c + sum_j p              acc = acc * c + p . v   (f32)
//   o  = acc / max(l, 1e-37)          rounded once to q's type
//
// q is (B, S, H, Dh), k and v are (B, T, Hk, Dh) with H = Hk * G; query
// head h reads KV head h / G straight from that layout, so the wrapper
// transposes nothing. Positions start at 0 on both sides (S != T allowed).
//
// Bound: operations. At the prefill shape (B, S, H, Dh) = (8, 2048, 9, 64)
// the causal product is 3.87e10 FLOPs against 50 MB moved, 770 FLOPs a
// byte, far above the card's ~295 bf16 FLOPs a byte; the bound is the
// tensor cores' 989 TFLOP/s, 0.039 ms.
//
// bf16 (msz_flash_bf16): on the tensor cores, FA2-style, mma.sync
// m16n8k16 bf16 with f32 accumulation. The first kernel computed every
// product as an f32 fmaf on the CUDA cores, 2.04 ms at the prefill shape
// (19 TFLOP/s, 52x the bound; SDPA 0.138 ms; NVIDIA H100 80GB HBM3,
// 700 W). The tolerance is one bf16 ulp of the f32 result, which SDPA,
// rounding p to bf16 before p . v, fails; so the products keep f32
// accuracy by splitting each f32 operand in two bf16s, whose products
// with a bf16 operand are exact in f32:
//   S = q_hi . k^T + q_lo . k^T    q_hi = bf16(q'), q_lo = bf16(q' - q_hi)
//                                  (Dh 16 and 64: scale is a power of two,
//                                  q' is a bf16 and q_lo is 0, skipped)
//   O += p_hi . v + p_lo . v       p_hi = bf16(p), p_lo = bf16(p - p_hi)
// which leaves p an error of about 2^-16 of itself, far inside one ulp of
// the output (2^-8 to 2^-7). A block of 4 warps (kTcWarps) owns 16 query
// rows a warp; q's fragments, scaled and split, stay in registers for the
// sweep. K and V tiles of 64 keys stay bf16 in shared memory, rows padded
// by 16 bytes so ldmatrix (.trans for V) is free of bank conflicts, and
// arrive by cp.async into a two-stage ring: the next tile's copy overlaps
// this tile's products. The m16n8 accumulator layout of S is the m16n8k16
// A-fragment layout of p pair for pair, so p goes from the score
// registers straight into the p . v product, never through shared
// memory; the online softmax runs on those registers, its row max and
// sum by shuffles within each quad. The causal mask is applied only on
// tiles that cross the diagonal; a warp skips tiles wholly above its
// rows (that leaves its m, l and acc bit for bit as they were); blocks
// of the last query rows, which do the most tiles, are launched first.
// Keys past T are zero-filled and score -inf; query rows past S store
// nothing. Each score's exp is computed unguarded and the guard selects
// after it: guarding the call itself compiled to a branch a score, which
// ran a thread's 32 exps of a tile in series and cost nearly a fifth of
// the kernel's time. Measured (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700 W): 0.30 ms at the prefill shape, 130 TFLOP/s of the function's
// FLOPs, 7.6x the bound and 2.0x SDPA (0.146 ms); 7.7 ms at 1 x 32768.
// At Dh = 128 (granite-8b's 32/8 heads over 2 x 4096) 1.69 ms, 3.3x SDPA:
// that variant holds q's hi and lo fragments and a 64-float accumulator
// a thread, uses 255 registers and spills 72 bytes.
// The split products cost 1.5x the function's tensor work at Dh = 64;
// the next step is warpgroup wgmma with TMA and a producer warp
// (FA3-style).
//
// f32 (msz_flash_f32): on the CUDA cores, as the reference computes; the
// LM path serves bf16, and f32 is reached only by the 2-layer parity run
// and the tests, whose 2e-5 tolerance two bf16 terms cannot meet. One
// block of 8 warps per (batch * head, tile of 64 query rows); the loop
// over 64-key K/V tiles inside the block replaces the Pallas grid's
// sequential kv axis, and stops at the diagonal when causal. The scaled Q
// tile, the K tile (transposed, rows padded to 65 floats so both its
// stores and the score loop's loads are free of bank conflicts), the V
// tile and each warp's probabilities live in shared memory as f32. Each
// warp owns 8 query rows: a lane computes the scores of keys lane and
// lane + 32 for all 8 rows (Q read as float4 broadcasts), the row max and
// sum reduce by shuffles, and for p . v a lane owns output columns
// lane + 32 c, so the running m, l and the f32 accumulator stay in
// registers for the whole sweep.
//
// No fast math in either: expf and IEEE division.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace msz_flash {

constexpr int kKeys = 64;                       // keys per K/V tile
// the f32 kernel
constexpr int kRows = 64;                       // query rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;    // 8
constexpr int kKtStride = kKeys + 1;            // padded K^T row

struct Shape {
  int B, S, T, H, Hk, causal;
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int smem_bytes() {
  return 4 * (kRows * D              // Q tile, scaled
              + D * kKtStride        // K tile, transposed
              + kKeys * D            // V tile
              + kRows * kKeys);      // p, 8 rows per warp
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, Shape s) {
  static_assert(D % 32 == 0 || D == 16, "Dh is 16, 32, 64 or 128");
  constexpr int DC = (D + 31) / 32;             // output columns a lane owns
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* kt = qs + kRows * D;
  float* vs = kt + D * kKtStride;
  float* ps = vs + kKeys * D;

  const int bh = blockIdx.x;
  const int b = bh / s.H, h = bh % s.H;
  const int hk = h / (s.H / s.Hk);
  const int q0 = blockIdx.y * kRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * kRowsPerWarp;

  const long long q_stride = (long long)s.H * D;     // between positions
  const long long kv_stride = (long long)s.Hk * D;
  const float* qb = q + ((long long)b * s.S * s.H + h) * D;
  float* ob = o + ((long long)b * s.S * s.H + h) * D;
  const float* kb = k + ((long long)b * s.T * s.Hk + hk) * D;
  const float* vb = v + ((long long)b * s.T * s.Hk + hk) * D;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, qi = q0 + r;
    const float x = qi < s.S ? qb[qi * q_stride + d] : 0.f;
    qs[i] = __fmul_rn(x, s.scale);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }
  float* pw = ps + r0 * kKeys;
  const int kv_end = s.causal ? min(s.T, q0 + kRows) : s.T;

  for (int j0 = 0; j0 < kv_end; j0 += kKeys) {
    __syncthreads();          // the last tile is consumed (Q is stored)
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D, d = i % D, kj = j0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < s.T) {
        kx = kb[kj * kv_stride + d];
        vx = vb[kj * kv_stride + d];
      }
      kt[d * kKtStride + j] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    // scores of keys lane and lane + 32 for the warp's 8 rows
    float sc[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) sc[r][0] = sc[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float k0[4], k1[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        k0[c] = kt[(d + c) * kKtStride + lane];
        k1[c] = kt[(d + c) * kKtStride + lane + 32];
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qs[(r0 + r) * D + d]);
        sc[r][0] = fmaf(qv.x, k0[0], sc[r][0]);
        sc[r][1] = fmaf(qv.x, k1[0], sc[r][1]);
        sc[r][0] = fmaf(qv.y, k0[1], sc[r][0]);
        sc[r][1] = fmaf(qv.y, k1[1], sc[r][1]);
        sc[r][0] = fmaf(qv.z, k0[2], sc[r][0]);
        sc[r][1] = fmaf(qv.z, k1[2], sc[r][1]);
        sc[r][0] = fmaf(qv.w, k0[3], sc[r][0]);
        sc[r][1] = fmaf(qv.w, k1[3], sc[r][1]);
      }
    }

    // online softmax, row by row; p goes to the warp's shared rows
    const int kj0 = j0 + lane, kj1 = j0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qi = q0 + r0 + r;
      const float s0 =
          (kj0 < s.T && (!s.causal || kj0 <= qi)) ? sc[r][0] : -INFINITY;
      const float s1 =
          (kj1 < s.T && (!s.causal || kj1 <= qi)) ? sc[r][1] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s0, s1)));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float p0 = isfinite(s0) ? expf(s0 - m_safe) : 0.f;
      const float p1 = isfinite(s1) ? expf(s1 - m_safe) : 0.f;
      const float corr = isfinite(m[r]) ? expf(m[r] - m_safe) : 0.f;
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= corr;
      pw[r * kKeys + lane] = p0;
      pw[r * kKeys + lane + 32] = p1;
    }
    __syncwarp();

    // acc += p . v; a lane owns columns lane + 32 c
#pragma unroll 2
    for (int j = 0; j < kKeys; j += 4) {
      float vv[4][DC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < D ? vs[(j + jj) * D + d] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&pw[r * kKeys + j]);
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          acc[r][c] = fmaf(pv.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(pv.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(pv.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(pv.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + r0 + r;
    if (qi >= s.S) continue;
    const float den = fmaxf(l[r], 1e-37f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) ob[qi * q_stride + d] = __fdiv_rn(acc[r][c], den);
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

// warps a block of the bf16 kernel, 16 query rows each (kernels/flash.py
// Q_ROWS is kTcRows)
constexpr int kTcWarps = 4;
constexpr int kTcRows = 16 * kTcWarps;
constexpr int kPad = 8;                 // bf16 padding of a shared row

template <int D>
constexpr int tc_smem_bytes() {
  return 2 * 2 * kKeys * (D + kPad) * 2;     // 2 stages of K and V tiles
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// c += a . b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (a, b) as bf16 pairs hi = bf16(x), lo = bf16(x - hi), a in the low half
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y)));
}

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32) flash_bf16_mma(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    Shape s) {
  static_assert(D % 16 == 0, "Dh is 16, 32, 64 or 128");
  constexpr int RS = D + kPad;          // shared row stride, elements
  constexpr int TILE = kKeys * RS;      // one K or V tile, elements
  constexpr int KC = D / 16;            // k-steps of q' . k^T
  constexpr int ND = D / 8;             // n-tiles of the output
  constexpr int CPR = D / 8;            // 16-byte chunks a row
  constexpr int NT = kTcWarps * 32;
  // Dh 16 and 64 scale by a power of two: q' is a bf16, q_lo is 0
  constexpr bool kSplitQ = !(D == 16 || D == 64);
  extern __shared__ __align__(16) __nv_bfloat16 tiles[];

  const int bh = blockIdx.x;
  const int b = bh / s.H, h = bh % s.H;
  const int hk = h / (s.H / s.Hk);
  // the last query rows do the most causal tiles: launch them first
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * kTcRows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wq0 = q0 + 16 * warp;       // the warp's first query row

  const long long q_stride = (long long)s.H * D;
  const long long kv_stride = (long long)s.Hk * D;
  const __nv_bfloat16* qb = q + ((long long)b * s.S * s.H + h) * D;
  __nv_bfloat16* ob = o + ((long long)b * s.S * s.H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * s.T * s.Hk + hk) * D;
  const __nv_bfloat16* vb = v + ((long long)b * s.T * s.Hk + hk) * D;

  const int kv_end = s.causal ? min(s.T, q0 + kTcRows) : s.T;
  const int n_tiles = (kv_end + kKeys - 1) / kKeys;

  auto load_tile = [&](int it) {
    __nv_bfloat16* ks = tiles + (it & 1) * 2 * TILE;
    __nv_bfloat16* vs = ks + TILE;
    const int j0 = it * kKeys;
    constexpr int CHUNKS = kKeys * CPR;
#pragma unroll
    for (int c0 = 0; c0 < CHUNKS; c0 += NT) {
      const int c = c0 + tid;
      if (CHUNKS % NT != 0 && c >= CHUNKS) break;
      const int r = c / CPR, part = c % CPR, kj = j0 + r;
      const bool ok = kj < s.T;
      const long long off = (long long)(ok ? kj : 0) * kv_stride + part * 8;
      cp_async16(smem_addr(ks + r * RS + part * 8), kb + off, ok);
      cp_async16(smem_addr(vs + r * RS + part * 8), vb + off, ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0);

  // q' = f32(q) * scale as A fragments, hi and lo: register e holds rows
  // g + 8 (e & 1), columns 16 kk + 8 (e >> 1) + 2t and + 1
  uint32_t qh[KC][4], ql[KC][4];
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wq0 + g + 8 * (e & 1);
      const int col = 16 * kk + 8 * (e >> 1) + 2 * t;
      float2 x = make_float2(0.f, 0.f);
      if (r < s.S)
        x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            qb + r * q_stride + col));
      split_bf16(__fmul_rn(x.x, s.scale), __fmul_rn(x.y, s.scale), qh[kk][e],
                 ql[kk][e]);
    }
  }

  // accumulators: n-tile n holds rows g (e 0, 1) and g + 8 (e 2, 3),
  // columns 8n + 2t and + 1
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = it * kKeys;
    // a warp past S, or wholly below this tile's keys, has nothing to add
    if (wq0 < s.S && (!s.causal || j0 <= wq0 + 15)) {
      const __nv_bfloat16* ks = tiles + (it & 1) * 2 * TILE;
      const __nv_bfloat16* vs = ks + TILE;

      float sc[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
      // S = q_hi . k^T (+ q_lo . k^T): matrices (keys, dims) lo/lo, lo/hi,
      // hi/lo, hi/hi of each 16 x 16 block
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          const int key = 16 * jp + ((lane >> 4) << 3) + (lane & 7);
          const int dim = 16 * kk + (((lane >> 3) & 1) << 3);
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_addr(ks + key * RS + dim), b0, b1, b2, b3);
          mma_bf16(sc[2 * jp], qh[kk], b0, b1);
          mma_bf16(sc[2 * jp + 1], qh[kk], b2, b3);
          if constexpr (kSplitQ) {
            mma_bf16(sc[2 * jp], ql[kk], b0, b1);
            mma_bf16(sc[2 * jp + 1], ql[kk], b2, b3);
          }
        }
      }

      if ((s.causal && j0 + kKeys - 1 > wq0) || j0 + kKeys > s.T) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = j0 + 8 * n + 2 * t + (e & 1);
            const int qi = wq0 + g + 8 * (e >> 1);
            if (kj >= s.T || (s.causal && kj > qi)) sc[n][e] = -INFINITY;
          }
      }

      // online softmax on the score registers; row i is g + 8 i
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(sc[n][2 * i], sc[n][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        const float c = expf(m[i] - m_safe);
        const float corr = isfinite(m[i]) ? c : 0.f;
        float rs = 0.f;
        // expf runs on every score and the guard selects after it: the
        // same values as guarding the call, but with no branch a score,
        // so the 16 exps of a row overlap instead of running in series
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 2 * i; e < 2 * i + 2; ++e) {
            const float x = sc[n][e];
            const float ex = expf(x - m_safe);
            const float p = isfinite(x) ? ex : 0.f;
            sc[n][e] = p;
            rs += p;
          }
        l[i] = l[i] * corr + rs;        // this thread's part of the row
        m[i] = m_new;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][2 * i] *= corr;
          acc[n][2 * i + 1] *= corr;
        }
      }

      // O += p_hi . v + p_lo . v: keys 16 kk .. 16 kk + 15 are n-tiles
      // 2 kk and 2 kk + 1 of S, which are p's A fragment as they stand
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        split_bf16(sc[2 * kk][0], sc[2 * kk][1], ah[0], al[0]);
        split_bf16(sc[2 * kk][2], sc[2 * kk][3], ah[1], al[1]);
        split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ah[2], al[2]);
        split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          const int key = 16 * kk + (((lane >> 3) & 1) << 3) + (lane & 7);
          const int dim = 16 * dp + ((lane >> 4) << 3);
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(smem_addr(vs + key * RS + dim), b0, b1, b2, b3);
          mma_bf16(acc[2 * dp], ah, b0, b1);
          mma_bf16(acc[2 * dp], al, b0, b1);
          mma_bf16(acc[2 * dp + 1], ah, b2, b3);
          mma_bf16(acc[2 * dp + 1], al, b2, b3);
        }
      }
    }
    __syncthreads();          // the tile is consumed before it is reloaded
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int qi = wq0 + g + 8 * i;
    if (qi >= s.S) continue;
    const float den = fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(ob + qi * q_stride + 8 * n + 2 * t) =
          __floats2bfloat162_rn(__fdiv_rn(acc[n][2 * i], den),
                                __fdiv_rn(acc[n][2 * i + 1], den));
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               Shape s, void* stream) {
  const int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(s.B * s.H), (unsigned)((s.S + kRows - 1) / kRows));
  flash_fwd<D><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, s);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                Shape s, void* stream) {
  // cp.async copies 16 bytes: every row must start 16-byte aligned
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int bytes = tc_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(s.B * s.H),
                  (unsigned)((s.S + kTcRows - 1) / kTcRows));
  flash_bf16_mma<D><<<grid, kTcWarps * 32, bytes, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, s);
  return (int)cudaGetLastError();
}

template <bool BF16>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T_, int H, int Hk, int D, int causal, float scale,
           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (Hk <= 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  const Shape s{B, S, T_, H, Hk, causal, scale};
  switch (D) {
    case 16: return BF16 ? launch_bf16<16>(q, k, v, o, s, stream)
                         : launch_f32<16>(q, k, v, o, s, stream);
    case 32: return BF16 ? launch_bf16<32>(q, k, v, o, s, stream)
                         : launch_f32<32>(q, k, v, o, s, stream);
    case 64: return BF16 ? launch_bf16<64>(q, k, v, o, s, stream)
                         : launch_f32<64>(q, k, v, o, s, stream);
    case 128: return BF16 ? launch_bf16<128>(q, k, v, o, s, stream)
                          : launch_f32<128>(q, k, v, o, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace msz_flash

// device: the CUDA device of every pointer and of the stream, made
// current first (the library links its own cudart, whose current device
// is not the caller's).
#define MSZ_FLASH_ENTRY(NAME, BF16)                                       \
  extern "C" int NAME(const void* q, const void* k, const void* v,       \
                      void* o, int B, int S, int T_, int H, int Hk,       \
                      int D, int causal, int device, float scale,         \
                      void* stream) {                                     \
    const cudaError_t e = cudaSetDevice(device);                          \
    if (e != cudaSuccess) return (int)e;                                  \
    return msz_flash::launch<BF16>(q, k, v, o, B, S, T_, H, Hk, D,       \
                                   causal, scale, stream);               \
  }

MSZ_FLASH_ENTRY(msz_flash_f32, false)
MSZ_FLASH_ENTRY(msz_flash_bf16, true)
