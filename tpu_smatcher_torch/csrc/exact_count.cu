// Exact-tier kernels on Hopper: the window count, with or without the pad
// guard, and the per-start match mask.
//
// Replaces three TPU kernels of tpu_smatcher/ops/pallas_filter.py:
//   count, guard off  _exact_flat_kernel (:886, via _exact_count_flat :923)
//   count, guard on   _exact_kernel (:202, via exact_count_pallas guard=True)
//   mask              _exact_mask_kernel (:220, via exact_mask_pallas :231)
//
// For every start i < n - m + 1 the packed window id
//     key = OR_j t[i+j] << bits*(m-1-j)      (m*bits <= 16)
// indexes one bit of a terminal bitmap of nwords*32 = max(4096, 2^(m*bits))
// bits.  The guard drops a window that holds a byte >= sigma: distribution
// pads shards and halos with the out-of-alphabet byte sigma, and for a
// power-of-two sigma such a window's id can alias a real pattern's id.  The
// guard compares bytes as int, so sigma = 256 drops nothing.  The count
// returns the number of hits; the mask writes one int8 per start over
// rows*128 starts, 0 past n - m + 1, so the padding of its last row is
// written and no caller zero-fills.  The MXU banded matmul that built the
// keys on the TPU summed shifted bytes; here they are ORed (as the JAX
// package's xla backend does), which is the same on in-alphabet text and,
// with the guard, on any text.  The TPU kernels' sequential-grid scalar sum
// (out_ref[0,0] += s) becomes a warp-shuffle reduction and one atomicAdd per
// warp into a zeroed int32.
//
// What bounds them on an H100: the text is read once (256 MiB in ~0.08 ms
// at 3.35 TB/s) and the mask written once (as much again); per start there
// is a window id and one random read of the bitmap (at most 8 KB, staged in
// shared memory once per block).
//
// The unguarded count, the main path's exact tier, is built for that bound:
//   - rolling window id: a thread owns a run of kRunE = 32 consecutive
//     starts; the id of the next window is
//         key(i+1) = ((key(i) << bits) | t[i+m]) & (2^(m*bits) - 1),
//     kept as one multiply-add per start (the mask taken off the chain),
//     where the first design rebuilt each id from m shared-memory bytes.  The run's 32 + m - 1 bytes come
//     from three 16-byte shared-memory loads (neighbouring threads read
//     neighbouring chunks, no bank conflict); the entering bytes are
//     shifted by m - 1 with funnel shifts, so a start reads no byte from
//     shared memory.  The recurrence equals the ORed id only when every
//     byte is below 2^bits; a run holding a larger byte (never on encoded
//     text; kept for exactness on any bytes) or a bitmap smaller than
//     2^(m*bits) bits takes the per-start loop of the first design.
//   - vector loads, double-buffered: a persistent grid walks tiles of 8192
//     starts, the next tile's text copied in by 16-byte cp.async while this
//     one is counted (tile_pipeline.cuh), where the first design staged
//     each tile with one-byte loads between two barriers.
//   - the bitmap lookups stay random 32-bit shared-memory reads (for DNA
//     m=8, 2048 words; about 3.5 lanes of a warp meet in the busiest bank).
//
// The guarded count and the mask keep the first design (for_each_start):
// one start per thread, the tile staged byte by byte, the id and the
// guard's max rebuilt from the window's m bytes.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_pipeline.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;      // starts per tile (guarded count, mask)
constexpr int kMaxM = 16;        // m*bits <= 16 and bits >= 1
constexpr int kRunE = 32;        // consecutive starts per thread (unguarded)
constexpr int kTileE = kThreads * kRunE;
// a text buffer of the unguarded count: the tile's starts and the 16-byte
// chunk after them (the halo, m - 1 <= 15 bytes)
constexpr int kBufE = kTileE + 16;

// Stages one tile of text (plus the halo) in shared memory, then calls
// visit(k, hit) for each start t0 + k of the tile below limit, hit = the
// window's bit (0 with kGuard and a byte >= sigma).  The guarded count and
// the mask run on it; the unguarded count has its own kernel below.
template <bool kGuard, typename Visit>
__device__ __forceinline__ void for_each_start(
    const uint8_t* __restrict__ text, long long n, int m, int bits,
    int sigma, const uint32_t* sbits, uint32_t nbits,
    uint8_t* tile, long long t0, long long limit, Visit visit) {
  __syncthreads();                // bitmap staged / previous tile consumed
  for (int i = threadIdx.x; i < kTile + m - 1; i += kThreads) {
    long long g = t0 + i;
    tile[i] = g < n ? text[g] : 0;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    if (t0 + k >= limit) continue;
    uint32_t key = 0;
    int mx = 0;
    for (int j = 0; j < m; ++j) {
      int c = tile[k + j];
      key = (key << bits) | (uint32_t)c;
      if (kGuard) mx = c > mx ? c : mx;
    }
    int hit = key < nbits ? (int)((sbits[key >> 5] >> (key & 31)) & 1u) : 0;
    if (kGuard && mx >= sigma) hit = 0;
    visit(k, hit);
  }
}

__device__ __forceinline__ void stage_bitmap(const uint32_t* __restrict__ bitmap,
                                             int nwords, uint32_t* sbits) {
  for (int i = threadIdx.x; i < nwords; i += kThreads) sbits[i] = bitmap[i];
}

__device__ __forceinline__ void add_warp_sum(int cnt, int* out) {
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(out, cnt);
}

__global__ void __launch_bounds__(kThreads) exact_count_guard_kernel(
    const uint8_t* __restrict__ text, long long n, int m, int bits,
    int sigma, long long n_starts,
    const uint32_t* __restrict__ bitmap, int nwords, int* __restrict__ out) {
  extern __shared__ uint32_t sbits[];              // nwords
  __shared__ uint8_t tile[kTile + kMaxM];
  stage_bitmap(bitmap, nwords, sbits);
  const uint32_t nbits = (uint32_t)nwords * 32u;
  int cnt = 0;
  for (long long t0 = (long long)blockIdx.x * kTile; t0 < n_starts;
       t0 += (long long)gridDim.x * kTile)
    for_each_start<true>(text, n, m, bits, sigma, sbits, nbits, tile, t0,
                         n_starts, [&](int, int hit) { cnt += hit; });
  add_warp_sum(cnt, out);
}

// The unguarded count: runs of kRunE starts per thread, rolling window ids,
// a persistent grid over double-buffered tiles of kTileE starts.
__global__ void __launch_bounds__(kThreads) exact_count_kernel(
    const uint8_t* __restrict__ text, long long n, int m, int bits,
    long long n_starts, const uint32_t* __restrict__ bitmap, int nwords,
    int* __restrict__ out, long long tiles, bool aligned) {
  extern __shared__ uint4 smem[];
  uint32_t* sbits = reinterpret_cast<uint32_t*>(smem);     // nwords
  uint8_t* bufs = reinterpret_cast<uint8_t*>(smem) + (nwords + 3) / 4 * 16;
  stage_bitmap(bitmap, nwords, sbits);
  const uint32_t nbits = (uint32_t)nwords * 32u;
  const int kbits = m * bits;
  const uint32_t kmask = (1u << kbits) - 1u, radix = 1u << bits;
  // a byte >= 2^bits in any lane of a word
  const uint32_t dirty_bytes = 0x01010101u * (0xFFu & ~((1u << bits) - 1u));
  const bool rolling_ok = nbits >= (1u << kbits);
  const int off = threadIdx.x * kRunE;
  int cnt = 0;

  long long tile = blockIdx.x;
  tsm::stage_tile<kThreads>(bufs, text, n, tile * kTileE, kBufE, aligned);
  tsm::cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < tiles)
      tsm::stage_tile<kThreads>(bufs + ((it + 1) & 1) * kBufE, text, n,
                                next * kTileE, kBufE, aligned);
    tsm::cp_async_commit();
    tsm::cp_async_wait_prev();
    __syncthreads();

    const uint8_t* b = bufs + (it & 1) * kBufE;
    const long long i0 = tile * kTileE + off;
    const long long valid = n_starts - i0;
    if (valid > 0) {
      // bytes [off, off + 48) of the buffer: the run's 32 + m - 1 bytes
      const uint4* c = reinterpret_cast<const uint4*>(b + off);
      const uint4 c0 = c[0], c1 = c[1], c2 = c[2];
      const uint32_t w[12] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y,
                              c1.z, c1.w, c2.x, c2.y, c2.z, c2.w};
      uint32_t dirty = 0;
#pragma unroll
      for (int k = 0; k < 12; ++k) dirty |= w[k] & dirty_bytes;
      if (rolling_ok && !dirty && valid >= kRunE) {
        // the first window's first m - 1 bytes, then one byte per start;
        // on bytes below 2^bits, s * 2^bits + byte is (s << bits) | byte,
        // one multiply-add from start to start, and the id is its low
        // m*bits bits
        uint32_t s = 0;
#pragma unroll
        for (int j = 0; j < kMaxM - 1; ++j)
          if (j < m - 1) s = s * radix + tsm::byte_of(w, j);
        uint32_t in[8];                        // bytes [off+m-1, off+m+31)
        tsm::shifted_words(w, m - 1, in);
#pragma unroll
        for (int j = 0; j < kRunE; ++j) {
          s = s * radix + tsm::byte_of(in, j);
          const uint32_t key = s & kmask;
          const uint32_t word = sbits[key >> 5];
          cnt += __funnelshift_r(word, word, key) & 1u;
        }
      } else {
        const int len = valid < kRunE ? (int)valid : kRunE;
        for (int k = 0; k < len; ++k) {
          uint32_t key = 0;
          for (int j = 0; j < m; ++j)
            key = (key << bits) | (uint32_t)b[off + k + j];
          cnt += key < nbits ? (int)((sbits[key >> 5] >> (key & 31)) & 1u)
                             : 0;
        }
      }
    }
    __syncthreads();                             // buffer free for reuse
  }
  add_warp_sum(cnt, out);
}

// total = rows * 128 starts written; starts >= n_starts get 0
__global__ void __launch_bounds__(kThreads) exact_mask_kernel(
    const uint8_t* __restrict__ text, long long n, int m, int bits,
    int sigma, long long n_starts, const uint32_t* __restrict__ bitmap,
    int nwords, int8_t* __restrict__ mask, long long total) {
  extern __shared__ uint32_t sbits[];              // nwords
  __shared__ uint8_t tile[kTile + kMaxM];
  stage_bitmap(bitmap, nwords, sbits);
  const uint32_t nbits = (uint32_t)nwords * 32u;
  for (long long t0 = (long long)blockIdx.x * kTile; t0 < total;
       t0 += (long long)gridDim.x * kTile)
    for_each_start<true>(text, n, m, bits, sigma, sbits, nbits, tile, t0,
                         total, [&](int k, int hit) {
                           mask[t0 + k] =
                               (int8_t)(t0 + k < n_starts ? hit : 0);
                         });
}

int grid_for(long long starts, int device, int* grid) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  long long tiles = (starts + kTile - 1) / kTile;
  long long want = (long long)sms * 8;
  *grid = (int)(tiles < want ? tiles : want);
  return 0;
}

}  // namespace

// out: one zeroed int32 on the device; the count is added to it.  guard:
// 0 or 1 (drop windows holding a byte >= sigma).
extern "C" int tsm_exact_count(const void* text, long long n, int m, int bits,
                               int sigma, int guard, const void* bitmap,
                               int nwords, void* out, int device,
                               void* stream) {
  if (m < 1 || m > kMaxM || m * bits > 16) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  long long n_starts = n - m + 1;
  if (n_starts <= 0) return 0;
  if (guard) {
    int grid = 0;
    int rc = grid_for(n_starts, device, &grid);
    if (rc) return rc;
    exact_count_guard_kernel<<<grid, kThreads, (size_t)nwords * 4,
                               (cudaStream_t)stream>>>(
        (const uint8_t*)text, n, m, bits, sigma, n_starts,
        (const uint32_t*)bitmap, nwords, (int*)out);
    return (int)cudaGetLastError();
  }
  const long long tiles = (n_starts + kTileE - 1) / kTileE;
  const size_t smem = (size_t)(nwords + 3) / 4 * 16 + 2 * kBufE;
  int grid = 0;
  err = tsm::persistent_grid(exact_count_kernel, kThreads, smem, tiles, device,
                             &grid);
  if (err != cudaSuccess) return (int)err;
  exact_count_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)text, n, m, bits, n_starts, (const uint32_t*)bitmap,
      nwords, (int*)out, tiles, ((uintptr_t)text & 15) == 0);
  return (int)cudaGetLastError();
}

// mask: rows * 128 int8 on the device, all of them written.  Requires
// n >= m.
extern "C" int tsm_exact_mask(const void* text, long long n, int m, int bits,
                              int sigma, const void* bitmap, int nwords,
                              void* mask, long long rows, int device,
                              void* stream) {
  if (m < 1 || m > kMaxM || m * bits > 16 || n < m)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  long long total = rows * 128;
  if (total <= 0) return 0;
  int grid = 0;
  int rc = grid_for(total, device, &grid);
  if (rc) return rc;
  exact_mask_kernel<<<grid, kThreads, (size_t)nwords * 4,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)text, n, m, bits, sigma, n - m + 1,
      (const uint32_t*)bitmap, nwords, (int8_t*)mask, total);
  return (int)cudaGetLastError();
}
