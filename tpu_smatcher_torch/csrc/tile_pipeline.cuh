// Shared device code of the persistent, double-buffered kernels
// (cascade.cu, filter.cu, exact_count.cu's unguarded count): staging a tile
// of text in shared memory with 16-byte cp.async copies, so that the next
// tile's load overlaps this tile's work, and the host-side grid size.
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
// byte by byte instead: same bytes, no overlap (filter.cu instead stages
// from the aligned address below such a text and offsets its tile).

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

}  // namespace tsm
