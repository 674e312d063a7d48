// Shared device code of the persistent, double-buffered kernels
// (cascade.cu, filter.cu, stages.cu, exact_count.cu): staging a tile of
// text in shared memory with 16-byte cp.async copies, so that the next
// tile's load overlaps this tile's work, and the host-side grid size; and
// the code of the kernels whose threads own runs of kRun consecutive starts
// (filter.cu, stages.cu, exact_count.cu): a run's bytes from 16-byte
// shared-memory loads at a block-uniform offset, its 32 results stored as
// two 16-byte mask writes, or ranked block-wide into a sub-block's slots.
//
// A block walks tiles blockIdx.x, blockIdx.x + gridDim.x, ... of one fixed
// number of bytes.  Each iteration issues the NEXT tile's copies into the
// other buffer, then waits for the current one (cp.async.wait_group 1):
//
//     stage(buf[0], first tile); commit
//     for each tile:  stage(buf[next], next tile); commit
//                     wait_group 1; __syncthreads
//                     work on buf[cur]; __syncthreads
//
// The copies go to L2 only (.cg): the text is read once.  A chunk past the
// text's end is zero-filled by the copy itself (src-size < 16).  A text
// whose address is not 16-byte aligned (a view at an odd offset) is staged
// byte by byte by cascade.cu: same bytes, no overlap; filter.cu, stages.cu
// and exact_count.cu instead stage from the aligned address below such a
// text and offset their tile.

#pragma once

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cuda_runtime.h>

namespace tsm {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits for every committed group but the most recent one.
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Block-wide, over kThreads threads: buf[i] = text[base + i] for i < len
// (len a multiple of 16, base a multiple of 16), 0 past the text's end.
// aligned: text is 16-byte aligned (then the copies are asynchronous).
template <int kThreads>
__device__ __forceinline__ void stage_tile(uint8_t* buf,
                                           const uint8_t* __restrict__ text,
                                           long long n, long long base,
                                           int len, bool aligned) {
  for (int c = threadIdx.x; c < len / 16; c += kThreads) {
    long long g = base + 16LL * c;
    if (aligned) {
      long long left = n - g;
      int bytes = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
      cp_async16(buf + 16 * c, bytes ? text + g : text, bytes);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        buf[16 * c + k] = g + k < n ? text[g + k] : 0;
    }
  }
}

// Host: a persistent grid, as many blocks as fit on the card at once (the
// occupancy of `kernel` at this block size and dynamic shared memory), but
// no more than there are tiles.  Above the default 48 KB, first raises the
// kernel's dynamic shared memory limit to smem: on every such launch, since
// a launch with less shared memory lowers the limit again.  The blocks per
// card are cached per (kernel, device, block size, shared memory): the
// occupancy query costs microseconds, and a kernel of 0.25 ms is launched
// once per scan.
template <typename Kernel>
inline cudaError_t persistent_grid(Kernel kernel, int threads, size_t smem,
                                   long long tiles, int device, int* grid) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  using Key = std::tuple<const void*, int, int, size_t>;
  static std::mutex mu;
  static std::map<Key, long long> cache;
  const Key key{reinterpret_cast<const void*>(kernel), device, threads, smem};
  long long blocks = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) blocks = it->second;
  }
  if (!blocks) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    blocks = (long long)sms * per_sm;
    std::lock_guard<std::mutex> lock(mu);
    cache[key] = blocks;
  }
  *grid = (int)(tiles < blocks ? tiles : blocks);
  return cudaSuccess;
}

// The i-th 32-bit word of a 4-, 8- or 12-word window w starting at word q
// (q a runtime value in [0, 4), uniform over the block): w[i + q], by
// selects so that w stays in registers.
template <int kWords>
__device__ __forceinline__ uint32_t word_at(const uint32_t (&w)[kWords],
                                            int i, int q) {
  return q == 0 ? w[i] : q == 1 ? w[i + 1] : q == 2 ? w[i + 2] : w[i + 3];
}

// out[k] = the 4 bytes of w starting at byte 4k + s (0 <= s < 16): the
// words of a byte window at a runtime offset, s uniform over the block.
template <int kOut, int kWords>
__device__ __forceinline__ void shifted_words(const uint32_t (&w)[kWords],
                                              int s, uint32_t (&out)[kOut]) {
  static_assert(kWords >= kOut + 4, "window too short for the shift");
  const int q = s >> 2, r = (s & 3) * 8;
#pragma unroll
  for (int k = 0; k < kOut; ++k)
    out[k] = __funnelshift_r(word_at(w, k, q), word_at(w, k + 1, q), r);
}

// Byte j (a compile-time index after unrolling) of a word array.
template <int kWords>
__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[kWords],
                                            int j) {
  return (w[j >> 2] >> (8 * (j & 3))) & 0xFFu;
}

// Bit `key` of a bitmap in shared memory.
__device__ __forceinline__ uint32_t smem_bit(const uint32_t* bm,
                                             uint32_t key) {
  return (bm[key >> 5] >> (key & 31)) & 1u;
}

// ---------------------------------------------------------------------------
// runs of kRun consecutive starts per thread (filter.cu, stages.cu,
// exact_count.cu)
// ---------------------------------------------------------------------------

constexpr int kRun = 32;          // consecutive starts per thread
constexpr int kSlots = 16;        // BLOCK_SLOTS: candidates kept per sub-block

// Bytes of one text buffer of a tile of `tile` starts whose text sits at an
// offset shift < 16: the starts and the (m-1)-byte halo, and the chunks
// after them that a run's shifted loads may touch (up to 48 bytes from the
// 16-byte chunk holding byte p + m).
__host__ __device__ inline int run_buf_bytes(int tile, int m) {
  return (tile + m + 30) / 16 * 16 + 16;
}

// The 4 * kOut bytes at b + p as words (b 16-byte aligned, p % 16 == s, s
// uniform over the block): kOut / 4 + 1 aligned loads, funnel-shifted by s.
template <int kOut>
__device__ __forceinline__ void words_at(const uint8_t* b, int p, int s,
                                         uint32_t (&out)[kOut]) {
  const uint4* c = reinterpret_cast<const uint4*>(b) + (p >> 4);
  uint32_t w[kOut + 4];
#pragma unroll
  for (int i = 0; i <= kOut / 4; ++i) {
    const uint4 h = c[i];
    w[4 * i] = h.x, w[4 * i + 1] = h.y, w[4 * i + 2] = h.z,
    w[4 * i + 3] = h.w;
  }
  shifted_words(w, s, out);
}

// Four bits of a hit mask as four bytes of 0 or 1 (the bits land on bits 0,
// 8, 16 and 24, with no carries between them).
__device__ __forceinline__ uint32_t spread4(uint32_t bits) {
  return ((bits & 0xFu) * 0x00204081u) & 0x01010101u;
}

// A run's kRun results (bit j: start j) as kRun int8 of 0 or 1 at out,
// 16-byte aligned: two 16-byte stores (a 128-start mask row is 4 threads).
__device__ __forceinline__ void store_run_mask(int8_t* out, uint32_t hits) {
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(spread4(hits), spread4(hits >> 4), spread4(hits >> 8),
                    spread4(hits >> 12));
  o[1] = make_uint4(spread4(hits >> 16), spread4(hits >> 20),
                    spread4(hits >> 24), spread4(hits >> 28));
}

// Block-wide, over kThreads threads whose runs tile one sub-block in thread
// order: the sub-block's first kSlots candidates in position order into
// out[0..kSlots) (-1 where fewer) and its candidate count into *count.  A
// run's rank is an exclusive prefix of the runs' __popc: a __shfl_up_sync
// scan in each warp, then the totals of the warps before it (wsum, kThreads
// / 32 ints of shared memory).  i0 is the run's first start.  Every thread
// must call it; the caller syncs before wsum is written again.
template <int kThreads>
__device__ __forceinline__ void rank_run_slots(uint32_t hits, long long i0,
                                               int* __restrict__ out,
                                               int* __restrict__ count,
                                               int* wsum) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cnt = __popc(hits);
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = wsum[w];
    total += x;
    before += w < warp ? x : 0;
  }
  int rank = before + incl - cnt;
  for (uint32_t h = hits; h && rank < kSlots; h &= h - 1, ++rank)
    out[rank] = (int)(i0 + __ffs(h) - 1);
  if ((int)threadIdx.x >= total && threadIdx.x < kSlots)
    out[threadIdx.x] = -1;
  if (threadIdx.x == 0) *count = total;
}

}  // namespace tsm
