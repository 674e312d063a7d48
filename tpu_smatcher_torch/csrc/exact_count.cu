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
// is a window id, one random read of the bitmap (at most 8 KB, staged in
// shared memory once per block) and, guarded, the test of the byte that
// enters the window.
//
// The three are one kernel template (exact_kernel), built for that bound:
//   - a thread owns a run of kRun = 32 consecutive starts; its window ids
//     roll, one multiply-add per start, and its hits come out as a 32-bit
//     mask (wid_run.cuh's wid_run, shared with stages.cu's wid stages; a
//     run holding a byte >= 2^bits, or a bitmap smaller than 2^(m*bits)
//     bits, takes a per-start loop of the ORed id, so any bytes stay exact);
//   - the guard is a mask too: the run's entering bytes >= sigma
//     (__vcmpgeu4), each smeared over the m starts whose window holds it,
//     and the starts up to the first window's last such byte (wid_run.cuh's
//     guard_run).  A byte in [sigma, 2^bits) is dropped by the guard and
//     rolls as any other; sigma >= 256 has no guard work;
//   - a persistent grid walks tiles of 8192 starts, the next tile's text
//     copied in by 16-byte cp.async while this one is tested
//     (tile_pipeline.cuh); a text at an address that is not 16-byte aligned
//     (a positions piece is a view at any offset) is copied from the aligned
//     address below it, which lies in the same allocation, and its tile
//     sits `shift` bytes into the buffer.  A positions piece (~231K starts)
//     fills 29 blocks; 4096-start tiles ran no faster there nor at 256 MiB
//     (one-process A/B, H100);
//   - the count adds the runs' __popc, then a warp shuffle and one atomicAdd
//     per warp; the mask stores each run as two 16-byte stores;
//   - the entering bytes come from 16-byte shared-memory loads,
//     funnel-shifted into place, so a start reads no byte from shared
//     memory; the bitmap lookups stay random 32-bit shared-memory reads.
// The first design (one start per thread over a tile staged byte by byte,
// each id and the guard's max rebuilt from the window's m bytes) ran the
// guarded count and the mask at 7-13% of their bounds on an H100.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_pipeline.cuh"
#include "wid_run.cuh"

namespace {

using tsm::kRun;

constexpr int kThreads = 256;
constexpr int kTile = kThreads * kRun;   // starts per tile
constexpr int kMaxM = 16;                // m*bits <= 16 and bits >= 1
constexpr int kMaxSmem = 232448;         // a block's shared memory on an H100

enum Mode { kCount = 0, kCountGuard = 1, kMask = 2 };

// text: the 16-byte aligned address at or below the view, whose start count
// is n_starts and whose first byte is text[shift]; n: the view's length plus
// shift.  thr: the guard's threshold, or -1 without the guard.  The bitmap
// is staged at the front of the dynamic shared memory, then the two text
// buffers.  Count modes add to count; mask mode writes mask (n_out = R*128
// entries, 0 past n_starts).
template <int kMode>
__global__ void __launch_bounds__(kThreads) exact_kernel(
    const uint8_t* __restrict__ text, long long n, int shift, int m,
    int bits, int thr, long long n_starts, long long n_out, long long tiles,
    const uint32_t* __restrict__ bitmap, int nwords, int* __restrict__ count,
    int8_t* __restrict__ mask) {
  extern __shared__ uint4 smem[];
  uint32_t* sbits = reinterpret_cast<uint32_t*>(smem);     // nwords
  uint8_t* bufs = reinterpret_cast<uint8_t*>(smem) + (nwords + 3) / 4 * 16;
  for (int i = threadIdx.x; i < nwords; i += kThreads)
    sbits[i] = __ldg(bitmap + i);
  const int blen = tsm::run_buf_bytes(kTile, m);
  const int off = threadIdx.x * kRun;            // the run's first start
  int cnt = 0;

  long long tile = blockIdx.x;
  tsm::stage_tile<kThreads>(bufs, text, n, tile * kTile, blen, true);
  tsm::cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < tiles)
      tsm::stage_tile<kThreads>(bufs + ((it + 1) & 1) * blen, text, n,
                                next * kTile, blen, true);
    tsm::cp_async_commit();
    tsm::cp_async_wait_prev();
    __syncthreads();

    const long long i0 = tile * kTile + off;
    uint32_t hits = 0;
    if (i0 < n_starts) {
      const uint8_t* b = bufs + (it & 1) * blen;
      const int p = shift + off;
      hits = tsm::wid_run(sbits, nwords, b, p, shift, 0, m, bits);
      if (kMode != kCount && thr >= 0)
        hits &= tsm::guard_run(b, p, shift, m, thr);
      const long long valid = n_starts - i0;
      if (valid < kRun) hits &= (1u << valid) - 1u;
    }
    if (kMode == kMask) {
      if (i0 < n_out)                  // n_out is a multiple of kRun
        tsm::store_run_mask(mask + i0, hits);
    } else {
      cnt += __popc(hits);
    }
    __syncthreads();                   // buffer free for reuse
  }
  if (kMode != kMask) {
    for (int d = 16; d > 0; d >>= 1)
      cnt += __shfl_down_sync(0xffffffffu, cnt, d);
    if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(count, cnt);
  }
}

// Both entry points: checks, the aligned address below the text, the
// guard's threshold and the persistent grid.
int launch(int mode, const void* text, long long n, int m, int bits,
           int sigma, const void* bitmap, int nwords, int* count,
           int8_t* mask, long long n_out, int device, void* stream) {
  const long long n_starts = n - m + 1;
  const long long tiles = (n_starts + kTile - 1) / kTile;
  const size_t smem =
      (size_t)(nwords + 3) / 4 * 16 + 2 * (size_t)tsm::run_buf_bytes(kTile, m);
  if (nwords < 1 || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // sigma >= 256: no byte reaches it; sigma <= 0: every byte does
  const int thr =
      mode != kCount && sigma < 256 ? (sigma > 0 ? sigma : 0) : -1;
  const int shift = (int)((uintptr_t)text & 15);
  auto kernel = mode == kCount        ? exact_kernel<kCount>
                : mode == kCountGuard ? exact_kernel<kCountGuard>
                                      : exact_kernel<kMask>;
  int grid = 0;
  err = tsm::persistent_grid(kernel, kThreads, smem, tiles, device, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)text - shift, n + shift, shift, m, bits, thr, n_starts,
      n_out, tiles, (const uint32_t*)bitmap, nwords, count, mask);
  return (int)cudaGetLastError();
}

}  // namespace

// out: one zeroed int32 on the device; the count is added to it.  guard:
// 0 or 1 (drop windows holding a byte >= sigma).
extern "C" int tsm_exact_count(const void* text, long long n, int m, int bits,
                               int sigma, int guard, const void* bitmap,
                               int nwords, void* out, int device,
                               void* stream) {
  if (m < 1 || m > kMaxM || bits < 1 || m * bits > 16)
    return (int)cudaErrorInvalidValue;
  if (n - m + 1 <= 0) return 0;
  return launch(guard ? kCountGuard : kCount, text, n, m, bits, sigma, bitmap,
                nwords, (int*)out, nullptr, 0, device, stream);
}

// mask: rows * 128 int8 on the device, 16-byte aligned, all of them
// written, with rows = ceil((n-m+1)/128).  Requires n >= m.
extern "C" int tsm_exact_mask(const void* text, long long n, int m, int bits,
                              int sigma, const void* bitmap, int nwords,
                              void* mask, long long rows, int device,
                              void* stream) {
  if (m < 1 || m > kMaxM || bits < 1 || m * bits > 16 || n < m ||
      rows != (n - m + 128) / 128 || ((uintptr_t)mask & 15))
    return (int)cudaErrorInvalidValue;
  return launch(kMask, text, n, m, bits, sigma, bitmap, nwords, nullptr,
                (int8_t*)mask, rows * 128, device, stream);
}
