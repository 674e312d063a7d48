// Exact-tier kernels on Hopper: the window count, with or without the pad
// guard, and the per-start match mask.
//
// Replaces three TPU kernels of tpu_smatcher/ops/pallas_filter.py:
//   count, guard off  _exact_flat_kernel (:886, via _exact_count_flat :923)
//   count, guard on   _exact_kernel (:202, via exact_count_pallas guard=True)
//   mask              _exact_mask_kernel (:220, via exact_mask_pallas :231)
//
// For every start i < n - m + 1 the packed window id
//     key = sum_j t[i+j] << bits*(m-1-j)      (m*bits <= 16)
// indexes one bit of a terminal bitmap of nwords*32 = max(4096, 2^(m*bits))
// bits.  The guard drops a window that holds a byte >= sigma: distribution
// pads shards and halos with the out-of-alphabet byte sigma, and for a
// power-of-two sigma such a window's id can alias a real pattern's id.  The
// guard compares bytes as int, so sigma = 256 drops nothing.  The count
// returns the number of hits; the mask writes one int8 per start over
// rows*128 starts, 0 past n - m + 1, so the padding of its last row is
// written and no caller zero-fills.
//
// What bounds them on an H100: the text is read once (256 MiB in ~0.08 ms
// at 3.35 TB/s) and the mask written once (as much again), so the work is
// m shared-memory byte reads plus one random bitmap read per start.  The
// design keeps both on chip: the bitmap (at most 8 KB) is staged in shared
// memory once per block, each block walks tiles of TILE starts
// (grid-stride, a few blocks per SM) with the tile's bytes plus the
// (m-1)-byte halo in shared memory, and neighbouring threads take
// neighbouring starts so a warp's byte reads and mask stores fall in
// consecutive bytes.  The guard is the max of the m bytes the key loop
// already reads.  The TPU kernels' sequential-grid scalar sum (out_ref[0,0]
// += s) becomes a warp-shuffle reduction and one atomicAdd per warp into a
// zeroed int32.  The MXU banded matmul that built the keys on the TPU
// summed shifted bytes; here they are ORed (as the JAX package's xla
// backend does), which is the same on in-alphabet text and, with the guard,
// on any text.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;      // starts per tile
constexpr int kMaxM = 16;        // m*bits <= 16 and bits >= 1

// Stages one tile of text (plus the halo) in shared memory, then calls
// visit(k, hit) for each start t0 + k of the tile below limit, hit = the
// window's bit (0 with kGuard and a byte >= sigma).  The guard is a
// template argument so the unguarded count keeps its key loop as it was.
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

template <bool kGuard>
__global__ void __launch_bounds__(kThreads) exact_count_kernel(
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
    for_each_start<kGuard>(text, n, m, bits, sigma, sbits, nbits, tile, t0,
                           n_starts, [&](int, int hit) { cnt += hit; });
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(out, cnt);
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
  int grid = 0;
  int rc = grid_for(n_starts, device, &grid);
  if (rc) return rc;
  const size_t smem = (size_t)nwords * 4;
  if (guard)
    exact_count_kernel<true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)text, n, m, bits, sigma, n_starts,
        (const uint32_t*)bitmap, nwords, (int*)out);
  else
    exact_count_kernel<false><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)text, n, m, bits, sigma, n_starts,
        (const uint32_t*)bitmap, nwords, (int*)out);
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
