// Chunked-bitplane packing of int32 residual codes (the SZP1 stream of
// entropy="device-pack") and its inverse.
//
// Replaces the Pallas calls kernels/pack.py:_pack_codes_pallas_jit (body
// _pack_kernel) and kernels/pack.py:_unpack_codes_pallas_jit (body
// _unpack_kernel), together with the offset scan, compaction and expand
// gather that run around them there.
//
// Layout: codes split into chunks of 1024 (the ragged last chunk padded
// with zigzag 0). A chunk of width b = 32 - clz(max zigzag) stores planes
// 0..b-1, each 32 words; bit t of word m of plane k is bit k of code
// m*32 + t. Chunk c's words start at offsets[c] (int64, exclusive scan
// of 32*b). Word buffers are int32 holding the uint32 stream's bits.
//
// pack:   msz_pack_widths  one warp per chunk: coalesced loads, zigzag,
//                          __reduce_or_sync; width = 32 - __clz(or).
//         msz_pack_planes  one block of 32 warps per chunk: warp m's
//                          __ballot_sync of bit k is word m of plane k;
//                          the chunk's b*32 words are staged in 4 KB of
//                          shared memory and written out coalesced.
// unpack: msz_unpack       one block per chunk: the chunk's words into
//                          shared memory, coalesced; thread m*32+t ORs
//                          bit t of word m of each present plane into
//                          bit k, un-zigzags and stores if < n.
//
// Bound: memory. pack reads 4 B per code (twice: once per launch, the
// second mostly from L2) and writes the stream; unpack reads the stream
// and writes 4 B per code. The integer work is a few instructions per
// code. A chunk of width 0 writes nothing and its block returns early.
#include <cuda_runtime.h>
#include <stdint.h>

namespace msz {

constexpr int kChunk = 1024;
constexpr int kWpp = kChunk / 32;  // words per plane
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t zigzag(int r) {
  // shift the unsigned value: r << 1 on a negative int is undefined
  return (uint32_t(r) << 1) ^ uint32_t(r >> 31);
}

__device__ __forceinline__ int unzigzag(uint32_t u) {
  return int((u >> 1) ^ (0u - (u & 1u)));
}

__global__ void __launch_bounds__(256) pack_widths_kernel(
    const int* __restrict__ r, int* __restrict__ bits, int n,
    int n_chunks) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_chunks) return;  // whole warps leave together
  const long long base = (long long)warp * kChunk;
  uint32_t acc = 0;
#pragma unroll 8
  for (int j = 0; j < kWpp; ++j) {
    const long long i = base + j * 32 + lane;
    acc |= (i < n) ? zigzag(r[i]) : 0u;
  }
  acc = __reduce_or_sync(kFull, acc);
  if (lane == 0) bits[warp] = 32 - __clz(acc);
}

__global__ void __launch_bounds__(kChunk) pack_planes_kernel(
    const int* __restrict__ r, const int* __restrict__ bits,
    const long long* __restrict__ offsets, int* __restrict__ words,
    int n) {
  __shared__ uint32_t planes[kChunk];
  const int c = blockIdx.x;
  const int width = bits[c];
  if (width == 0) return;  // uniform across the block
  const int m = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long i = (long long)c * kChunk + threadIdx.x;
  const uint32_t u = (i < n) ? zigzag(r[i]) : 0u;
  for (int k = 0; k < width; ++k) {
    const uint32_t w = __ballot_sync(kFull, (u >> k) & 1u);
    if (lane == 0) planes[k * kWpp + m] = w;
  }
  __syncthreads();
  if (threadIdx.x < width * kWpp)
    words[offsets[c] + threadIdx.x] = int(planes[threadIdx.x]);
}

__global__ void __launch_bounds__(kChunk) unpack_kernel(
    const int* __restrict__ words, const int* __restrict__ bits,
    const long long* __restrict__ offsets, int* __restrict__ out, int n) {
  __shared__ uint32_t planes[kChunk];
  const int c = blockIdx.x;
  const int width = bits[c];
  if (threadIdx.x < width * kWpp)
    planes[threadIdx.x] = uint32_t(words[offsets[c] + threadIdx.x]);
  __syncthreads();
  const int m = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint32_t u = 0;
  for (int k = 0; k < width; ++k)
    u |= ((planes[k * kWpp + m] >> lane) & 1u) << k;
  const long long i = (long long)c * kChunk + threadIdx.x;
  if (i < n) out[i] = unzigzag(u);
}

inline int n_chunks_of(int n) {
  return (int)(((long long)n + kChunk - 1) / kChunk);
}

}  // namespace msz

extern "C" int msz_pack_widths(const void* r, void* bits, int n,
                               void* stream) {
  const int n_chunks = msz::n_chunks_of(n);
  if (n_chunks == 0) return (int)cudaGetLastError();
  const int threads = 256;  // 8 chunks per block
  const int blocks = (n_chunks + threads / 32 - 1) / (threads / 32);
  msz::pack_widths_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)r, (int*)bits, n, n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int msz_pack_planes(const void* r, const void* bits,
                               const void* offsets, void* words, int n,
                               void* stream) {
  const int n_chunks = msz::n_chunks_of(n);
  if (n_chunks == 0) return (int)cudaGetLastError();
  msz::pack_planes_kernel<<<n_chunks, msz::kChunk, 0,
                            (cudaStream_t)stream>>>(
      (const int*)r, (const int*)bits, (const long long*)offsets,
      (int*)words, n);
  return (int)cudaGetLastError();
}

extern "C" int msz_unpack(const void* words, const void* bits,
                          const void* offsets, void* out, int n,
                          void* stream) {
  const int n_chunks = msz::n_chunks_of(n);
  if (n_chunks == 0) return (int)cudaGetLastError();
  msz::unpack_kernel<<<n_chunks, msz::kChunk, 0, (cudaStream_t)stream>>>(
      (const int*)words, (const int*)bits, (const long long*)offsets,
      (int*)out, n);
  return (int)cudaGetLastError();
}
