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
// m*32 + t. Chunk c's words start at the exclusive scan of 32*b over the
// chunks before it. Word buffers are int32 holding the uint32 stream's
// bits.
//
// Both kernels are one launch each. A block of 256 threads takes a tile
// of kTile = 8 consecutive chunks and finds the tile's word offset on the
// device with a single-pass chained scan with decoupled look-back over
// the tiles (Merrill & Garland, "Single-pass Parallel Prefix Scan with
// Decoupled Look-back", 2016):
//
//   * a block takes its tile from an atomic ticket, so tiles start in
//     ticket order and every tile a block waits on is already running;
//   * it publishes its tile's word count (flag A) in a 64-bit status
//     word, then, once it knows its exclusive offset, its inclusive
//     prefix (flag P); flag and value share the word, so one relaxed
//     64-bit store publishes both;
//   * warp 0 looks back 32 tiles at a time, lane i at tile t-1-i,
//     spinning on a tile whose status is still empty, and sums the
//     values up to the nearest P;
//   * the last tile's block writes the stream length to meta[0].
//
// Why tiles: the chain advances about 32 statuses per L2 round trip of
// the look-back, and a block has only its own loads in flight. With one
// chunk a block, both held the kernels far from the bound on an H100; 8
// chunks shorten the chain 8-fold and put 32 KB of loads in flight per
// block.
//
// Scratch (int64, zeroed by the entry with one cudaMemsetAsync on the
// stream): meta[0] stream length in words, meta[1] widths outside [0, 32]
// (unpack), meta[2] the ticket, then one status word per tile.
//
// pack:   the tile's codes go to shared memory with cp.async (16-byte
//         copies, zero-filled past n; 4-byte copies when the codes are
//         not 16-byte aligned), each code read once and no register
//         held per load. Thread (w, l) takes codes 128w + 32j + l,
//         j = 0..3, of each chunk: zigzag; OR-reduce (__reduce_or_sync,
//         then across the 8 warps) to the widths; publish A; build the
//         planes with __ballot_sync (word 4w + j of plane k) and write
//         them over the codes already taken, in stream order (16-byte
//         groups swizzled against bank conflicts); warp 0 looks back;
//         the block writes its tile's words at its offset with 16-byte
//         coalesced stores. The words buffer has room for the largest
//         stream (n_chunks * 1024 words); the wrapper reads the length
//         from meta[0] and returns that many.
// unpack: each block reads its chunks' widths (validating them: a width
//         outside [0, 32] is counted in meta[1] and clamped), publishes
//         A, looks back, loads its tile's words into shared memory with
//         16-byte loads (every read guarded against n_words, so a bad
//         stream never reads past its buffer), and thread t rebuilds
//         codes 4t..4t+3 of each chunk from nibble t%8 of word t/8 of
//         each plane, 8 planes at a time (a multiply spreads a nibble's
//         bits to one bit a byte), storing them with one 16-byte store.
//         meta[0] = sum(32*b) lets the wrapper check the stream length
//         after the launch.
//
// Bound: memory. pack reads 4 B per code once and writes the stream and
// the widths; unpack reads the stream and the widths and writes 4 B per
// code. The integer work is a few instructions per code and plane; the
// look-back reads 8 B per predecessor tile from L2. A chunk of width 0
// moves no words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace msz {

constexpr int kChunk = 1024;
constexpr int kWpp = kChunk / 32;     // words per plane
constexpr int kTile = 8;              // chunks a block takes
constexpr int kThreads = 256;         // 4 codes a thread a chunk
constexpr int kWarps = kThreads / 32;
constexpr int kMeta = 3;              // scratch words before the statuses
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;
constexpr u64 kFlagA = 1ull << 62;    // status: the tile's own count
constexpr u64 kFlagP = 2ull << 62;    // status: inclusive prefix
constexpr u64 kValue = kFlagA - 1;

__device__ __forceinline__ uint32_t zigzag(int r) {
  // shift the unsigned value: r << 1 on a negative int is undefined
  return (uint32_t(r) << 1) ^ uint32_t(r >> 31);
}

__device__ __forceinline__ int unzigzag(uint32_t u) {
  return int((u >> 1) ^ (0u - (u & 1u)));
}

__device__ __forceinline__ u64 load_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Thread 0 draws the block's tile from the ticket; every thread gets it.
__device__ __forceinline__ int take_ticket(u64* meta, int* slot) {
  if (threadIdx.x == 0)
    *slot = (int)atomicAdd(reinterpret_cast<unsigned*>(meta + 2), 1u);
  __syncthreads();
  return *slot;
}

// One thread: publish tile t's word count (tile 0's is its prefix).
__device__ __forceinline__ void publish_count(u64* meta, int t, u64 count) {
  store_status(meta + kMeta + t, (t == 0 ? kFlagP : kFlagA) | count);
}

// Warp 0, after publish_count: look back for tile t's exclusive offset,
// publish its inclusive prefix, and, for the last tile, the stream
// length. Returns the offset in every lane.
__device__ u64 look_back(u64* meta, int t, int n_tiles, u64 count) {
  u64* status = meta + kMeta;
  const int lane = threadIdx.x & 31;
  u64 excl = 0;
  for (int end = t; end > 0; end -= 32) {
    const int j = end - 1 - lane;
    u64 s = kFlagP;                   // before tile 0: a prefix of 0
    if (j >= 0) {
      do {
        s = load_status(status + j);
      } while (s < kFlagA);           // not published yet
    }
    const unsigned prefix = __ballot_sync(kFull, s >= kFlagP);
    // sum the lanes up to the nearest P (the lowest such lane), or all 32
    const int stop = prefix ? __ffs(prefix) - 1 : 31;
    u64 v = lane <= stop ? (s & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    excl += v;
    if (prefix) break;
  }
  if (lane == 0) {
    if (t > 0) store_status(status + t, kFlagP | (excl + count));
    if (t == n_tiles - 1) meta[0] = excl + count;
  }
  return excl;
}

// Global -> shared copies that bypass the registers (zero-filled past
// src_bytes), and the wait for all of a thread's copies.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src,
                                      int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src),
                  "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads) pack_kernel(
    const int* __restrict__ r, int* __restrict__ words,
    int* __restrict__ bits, u64* __restrict__ meta, int n, int n_chunks,
    int n_tiles) {
  // the tile's codes, then, chunk by chunk over them, its planes in
  // stream order: one row of 8 groups of 4 words a plane, group g of row
  // p in slot g ^ (p & 7). Chunk c's rows end by word (c + 1) * 1024, so
  // they overwrite only codes already taken into registers.
  __shared__ __align__(16) uint32_t buf[kTile * kChunk];
  __shared__ uint32_t warp_or[kTile][kWarps];
  __shared__ int tile;
  __shared__ u64 offset;
  uint4* planes = reinterpret_cast<uint4*>(buf);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = take_ticket(meta, &tile);

  // every code of the tile in flight at once, zero past n
  const long long base = (long long)t * kTile * kChunk;
  if ((reinterpret_cast<uintptr_t>(r) & 15) == 0) {
    for (int q = threadIdx.x; q < kTile * kChunk / 4; q += kThreads) {
      const long long i = base + 4 * q;
      const int bytes = i >= n ? 0 : (n - i >= 4 ? 16 : int(n - i) * 4);
      copy16(buf + 4 * q, r + (bytes ? i : 0), bytes);
    }
  } else {
    for (int q = threadIdx.x; q < kTile * kChunk; q += kThreads) {
      const long long i = base + q;
      copy4(buf + q, r + (i < n ? i : 0), i < n ? 4 : 0);
    }
  }
  copies_done();
  __syncthreads();

  // thread (w, l) takes codes 128w + 32j + l of each chunk
  const uint32_t* mine_codes = buf + warp * 128 + lane;
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc |= zigzag(int(mine_codes[c * kChunk + 32 * j]));
    acc = __reduce_or_sync(kFull, acc);
    if (lane == 0) warp_or[c][warp] = acc;
  }
  __syncthreads();
  int width[kTile], first[kTile], rows = 0;
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    uint32_t acc = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc |= warp_or[c][w];
    width[c] = 32 - __clz(acc);
    first[c] = rows;
    rows += width[c];
    if (threadIdx.x == c && t * kTile + c < n_chunks)
      bits[t * kTile + c] = width[c];
  }
  const u64 count = (u64)(kWpp * rows);
  // at once, so that later tiles can pass this one while it builds
  if (threadIdx.x == 0) publish_count(meta, t, count);

#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      u[j] = zigzag(int(mine_codes[c * kChunk + 32 * j]));
    __syncthreads();                  // chunk c's codes are all taken
    // lane k keeps word 4*warp + j of plane k
    uint32_t mine[4] = {0u, 0u, 0u, 0u};
    for (int k = 0; k < width[c]; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t b = __ballot_sync(kFull, (u[j] >> k) & 1u);
        if (lane == k) mine[j] = b;
      }
    }
    if (lane < width[c]) {
      const int p = first[c] + lane;
      planes[p * 8 + (warp ^ (p & 7))] =
          make_uint4(mine[0], mine[1], mine[2], mine[3]);
    }
  }

  if (warp == 0) {
    const u64 excl = look_back(meta, t, n_tiles, count);
    if (lane == 0) offset = excl;
  }
  __syncthreads();
  uint4* dst = reinterpret_cast<uint4*>(words + offset);
  for (int q = threadIdx.x; q < 8 * rows; q += kThreads) {
    const int p = q >> 3;
    dst[p * 8 + ((q & 7) ^ (p & 7))] = planes[q];
  }
}

__global__ void __launch_bounds__(kThreads) unpack_kernel(
    const int* __restrict__ words, const int* __restrict__ bits,
    int* __restrict__ out, u64* __restrict__ meta, int n, int n_chunks,
    int n_tiles, int n_words) {
  // the tile's planes in stream order, 32 words a plane
  __shared__ uint4 planes[kTile * kChunk / 4];
  __shared__ int tile;
  __shared__ u64 offset;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = take_ticket(meta, &tile);

  int width[kTile], first[kTile], rows = 0, bad = 0;
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    int w = t * kTile + c < n_chunks ? bits[t * kTile + c] : 0;
    if (w < 0 || w > 32) {            // counted, and clamped for the scan
      ++bad;
      w = w < 0 ? 0 : 32;
    }
    width[c] = w;
    first[c] = rows;
    rows += w;
  }
  if (warp == 0) {
    const u64 count = (u64)(kWpp * rows);
    if (lane == 0) {
      publish_count(meta, t, count);
      if (bad) atomicAdd(meta + 1, (u64)bad);
    }
    const u64 excl = look_back(meta, t, n_tiles, count);
    if (lane == 0) offset = excl;
  }
  __syncthreads();
  const u64 off = offset;
  const bool aligned = (reinterpret_cast<uintptr_t>(words) & 15) == 0;
  for (int q = threadIdx.x; q < 8 * rows; q += kThreads) {
    const u64 w0 = off + 4 * q;
    uint4 v;
    if (aligned && w0 + 4 <= (u64)n_words) {
      v = *reinterpret_cast<const uint4*>(words + w0);
    } else {                          // never past the stream
      uint32_t e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = w0 + i < (u64)n_words ? uint32_t(words[w0 + i]) : 0u;
      v = make_uint4(e[0], e[1], e[2], e[3]);
    }
    planes[q] = v;
  }
  __syncthreads();

  // thread t rebuilds codes 4t..4t+3 of each chunk: nibble t%8 of word
  // t/8 of each of its planes
  const uint32_t* p = reinterpret_cast<const uint32_t*>(planes);
  const int m = threadIdx.x >> 3;
  const int shift = 4 * (threadIdx.x & 7);
#pragma unroll
  for (int c = 0; c < kTile; ++c) {
    uint32_t u0 = 0, u1 = 0, u2 = 0, u3 = 0;
    for (int k0 = 0; k0 < width[c]; k0 += 8) {
      // 8 planes at a time: the nibble's bit j goes to bit 0 of byte j
      // (x 0x00204081: shifted copies at bits 0, 7, 14, 21, no carries),
      // then up by the plane's place in the 8; byte j of acc ends up as
      // bits k0..k0+7 of code j
      const int kn = min(8, width[c] - k0);
      const uint32_t* row = p + (first[c] + k0) * kWpp + m;
      uint32_t acc = 0;
      for (int k = 0; k < kn; ++k) {
        const uint32_t nib = (row[k * kWpp] >> shift) & 15u;
        acc |= ((nib * 0x00204081u) & 0x01010101u) << k;
      }
      u0 |= (acc & 0xffu) << k0;
      u1 |= ((acc >> 8) & 0xffu) << k0;
      u2 |= ((acc >> 16) & 0xffu) << k0;
      u3 |= (acc >> 24) << k0;
    }
    const long long i0 =
        ((long long)t * kTile + c) * kChunk + 4 * threadIdx.x;
    const int4 v = make_int4(unzigzag(u0), unzigzag(u1), unzigzag(u2),
                             unzigzag(u3));
    if (i0 + 4 <= n) {
      *reinterpret_cast<int4*>(out + i0) = v;
    } else if (i0 < n) {              // the ragged end of the last chunk
      out[i0] = v.x;
      if (i0 + 1 < n) out[i0 + 1] = v.y;
      if (i0 + 2 < n) out[i0 + 2] = v.z;
    }
  }
}

inline int n_chunks_of(int n) {
  return (int)(((long long)n + kChunk - 1) / kChunk);
}

// Zero the scratch of the tiles on the stream: (chunks, tiles), or an
// error. A stream of no chunks launches nothing.
inline cudaError_t clear_scratch(void* scratch, int n, cudaStream_t s,
                                 int* n_chunks, int* n_tiles) {
  *n_chunks = n_chunks_of(n);
  *n_tiles = (*n_chunks + kTile - 1) / kTile;
  if (*n_chunks == 0) return cudaSuccess;
  return cudaMemsetAsync(scratch, 0, sizeof(u64) * (kMeta + *n_tiles), s);
}

}  // namespace msz

// r: n int32 codes; words: room for n_chunks * 1024 int32; bits: n_chunks
// int32; scratch: at least 3 + n_chunks int64, zeroed here; device: the
// CUDA device of every pointer and of the stream, made current first.
extern "C" int msz_pack(const void* r, void* words, void* bits,
                        void* scratch, int n, int device, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int n_chunks, n_tiles;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = msz::clear_scratch(scratch, n, s, &n_chunks, &n_tiles);
  if (e != cudaSuccess) return (int)e;
  if (n_chunks > 0)
    msz::pack_kernel<<<n_tiles, msz::kThreads, 0, s>>>(
        (const int*)r, (int*)words, (int*)bits, (msz::u64*)scratch, n,
        n_chunks, n_tiles);
  return (int)cudaGetLastError();
}

// words: n_words int32; bits: n_chunks int32; out: n int32 (16-byte
// aligned); scratch and device as for msz_pack.
extern "C" int msz_unpack(const void* words, const void* bits, void* out,
                          void* scratch, int n, int n_words, int device,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int n_chunks, n_tiles;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = msz::clear_scratch(scratch, n, s, &n_chunks, &n_tiles);
  if (e != cudaSuccess) return (int)e;
  if (n_chunks > 0)
    msz::unpack_kernel<<<n_tiles, msz::kThreads, 0, s>>>(
        (const int*)words, (const int*)bits, (int*)out, (msz::u64*)scratch,
        n, n_chunks, n_tiles, n_words);
  return (int)cudaGetLastError();
}
