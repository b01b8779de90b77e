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
// tensor cores' 989 TFLOP/s. This first kernel does not reach them: it
// computes in f32 on the CUDA cores, as the reference does, and leaves
// wgmma, TMA and warp specialisation to the kernel's redesign.
//
// Design. One block of 8 warps per (batch * head, tile of 64 query rows);
// the loop over 64-key K/V tiles inside the block replaces the Pallas
// grid's sequential kv axis, and stops at the diagonal when causal (tiles
// wholly above it are never loaded). The scaled Q tile, the K tile
// (transposed, rows padded to 65 floats so both its stores and the score
// loop's loads are free of bank conflicts), the V tile and each warp's
// probabilities live in shared memory as f32. Each warp owns 8 query rows:
// a lane computes the scores of keys lane and lane + 32 for all 8 rows
// (Q read as float4 broadcasts), the row max and sum reduce by shuffles,
// and for p . v a lane owns output columns lane + 32 c, so the running
// m, l and the f32 accumulator stay in registers for the whole sweep.
// Ragged tails are masked: query rows past S load zeros and store
// nothing, keys past T score -inf. No fast math: expf and IEEE division.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace msz_flash {

constexpr int kRows = 64;                       // query rows per block
constexpr int kKeys = 64;                       // keys per K/V tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;    // 8
constexpr int kKtStride = kKeys + 1;            // padded K^T row

struct Shape {
  int B, S, T, H, Hk, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, Shape s) {
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
  const T* qb = q + ((long long)b * s.S * s.H + h) * D;
  T* ob = o + ((long long)b * s.S * s.H + h) * D;
  const T* kb = k + ((long long)b * s.T * s.Hk + hk) * D;
  const T* vb = v + ((long long)b * s.T * s.Hk + hk) * D;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D, qi = q0 + r;
    const float x = qi < s.S ? to_f32(qb[qi * q_stride + d]) : 0.f;
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
        kx = to_f32(kb[kj * kv_stride + d]);
        vx = to_f32(vb[kj * kv_stride + d]);
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
      if (d < D) store(&ob[qi * q_stride + d], __fdiv_rn(acc[r][c], den));
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, Shape s,
             void* stream) {
  const int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(s.B * s.H), (unsigned)((s.S + kRows - 1) / kRows));
  flash_fwd<T, D><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int T_, int H, int Hk, int D, int causal, float scale,
           void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaGetLastError();
  if (Hk <= 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
  const Shape s{B, S, T_, H, Hk, causal, scale};
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, s, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, s, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, s, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace msz_flash

#define MSZ_FLASH_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* q, const void* k, const void* v,       \
                      void* o, int B, int S, int T_, int H, int Hk,       \
                      int D, int causal, float scale, void* stream) {     \
    return msz_flash::launch<T>(q, k, v, o, B, S, T_, H, Hk, D, causal,  \
                                scale, stream);                          \
  }

MSZ_FLASH_ENTRY(msz_flash_f32, float)
MSZ_FLASH_ENTRY(msz_flash_bf16, __nv_bfloat16)
