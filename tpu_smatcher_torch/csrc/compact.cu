// Ordered compaction of the cascade's (R, 16) slot matrix, on Hopper.
//
// Replaces no Pallas kernel: on the TPU this step is XLA code,
// tpu_smatcher/ops/fast.py:compact_valrows.  It replaces the port's torch
// version of it (ops/compaction.compact_valrows over nonzero_scatter: some
// twenty torch ops, several of them int64 temporaries the size of the
// matrix).
//
// idxs[j] is the j-th slot value >= 0 in row-major order, as int64, for
// j < min(total, cap), then -1 up to cap; n_cand = total; overflow =
// (total > cap) | (ovf != 0), ovf the cascade's own row-overflow flag.
// Bit for bit what compact_valrows gives, the order kept.
//
// What bounds it on an H100: bytes.  It reads the R x 64-byte matrix (134 MB
// at 256 MiB, 2.7x the 50 MB L2) and writes at most cap int64.  Design: two
// passes over tiles of 1,024 rows, each a block of 512 threads making eight
// 16-byte loads (four slots each), neighbouring threads on neighbouring
// addresses, all eight in flight before any is used.
//   pass 1  counts each tile's live slots (warp and block sums);
//   pass 2  each block sums the counts of the tiles before its own (a few
//           thousand ints, from L2), writes its share of the -1 tail, and
//           re-reads its tile to write the survivors in order: per 16-byte
//           load, a thread's rank in its warp from four __ballot_sync /
//           __popc, the warps' totals ranked in shared memory.
// A single pass with decoupled look-back would save the second read of the
// matrix (~0.04 ms at 3.35 TB/s); two passes are the simpler design.  Pass 2
// walks the tiles last to first, so its first blocks find the end of the
// matrix still in L2 (on an H100 at 700 W, 2^21 rows, one call on a cold
// L2: 0.105 ms, against 0.117 ms first to last), and does not re-read a
// tile with no survivor or one wholly past cap.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                       // 16-byte loads a thread
constexpr long long kTileVecs = (long long)kThreads * kVec;
constexpr int kRowVecs = 4;                   // a row: 16 int32, 4 loads
constexpr long long kTileRows = kTileVecs / kRowVecs;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kVec * kWarps == 4 * 32, "pass 2 ranks 4 warp totals a lane");

// Thread t's vectors of tile `tile`: vector i is tile * kTileVecs +
// i * kThreads + t, four empty slots past the end.
__device__ __forceinline__ void load_tile(const int4* __restrict__ slots,
                                          long long nvec, long long tile,
                                          int4 (&v)[kVec]) {
  long long base = tile * kTileVecs + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    long long q = base + (long long)i * kThreads;
    v[i] = q < nvec ? __ldg(slots + q) : make_int4(-1, -1, -1, -1);
  }
}

__global__ void __launch_bounds__(kThreads)
compact_rows_count_kernel(const int4* __restrict__ slots, long long nvec,
                          int* __restrict__ counts) {
  __shared__ int warp_sum[kWarps];
  int4 v[kVec];
  load_tile(slots, nvec, blockIdx.x, v);
  int c = 0;
#pragma unroll
  for (int i = 0; i < kVec; ++i)
    c += (v[i].x >= 0) + (v[i].y >= 0) + (v[i].z >= 0) + (v[i].w >= 0);
  c = __reduce_add_sync(kAll, c);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    int s = threadIdx.x < kWarps ? warp_sum[threadIdx.x] : 0;
    s = __reduce_add_sync(kAll, s);
    if (threadIdx.x == 0) counts[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
compact_rows_kernel(const int4* __restrict__ slots, long long nvec,
                    const int* __restrict__ counts, int n_tiles,
                    const int* __restrict__ ovf, long long* __restrict__ idxs,
                    long long cap, long long* __restrict__ n_cand,
                    int* __restrict__ overflow) {
  __shared__ long long red[2][kWarps];
  __shared__ int base[kVec * kWarps];         // i-major, warp-minor
  const int tile = n_tiles - 1 - (int)blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the live slots before this tile, and in all
  long long before = 0, total = 0;
  for (int j = threadIdx.x; j < n_tiles; j += kThreads) {
    long long c = counts[j];
    total += c;
    before += j < tile ? c : 0;
  }
  for (int o = 16; o; o >>= 1) {
    before += __shfl_xor_sync(kAll, before, o);
    total += __shfl_xor_sync(kAll, total, o);
  }
  if (lane == 0) {
    red[0][warp] = before;
    red[1][warp] = total;
  }
  __syncthreads();
  before = total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += red[0][w];
    total += red[1][w];
  }

  const long long live_end = total < cap ? total : cap;
  for (long long p = live_end + (long long)blockIdx.x * kThreads
                     + threadIdx.x;
       p < cap; p += (long long)gridDim.x * kThreads)
    idxs[p] = -1;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *n_cand = total;
    *overflow = (total > cap) | (*ovf != 0);
  }
  if (counts[tile] == 0 || before >= cap) return;

  int4 v[kVec];
  load_tile(slots, nvec, tile, v);
  const unsigned below = (1u << lane) - 1;
  int rank[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    unsigned b0 = __ballot_sync(kAll, v[i].x >= 0);
    unsigned b1 = __ballot_sync(kAll, v[i].y >= 0);
    unsigned b2 = __ballot_sync(kAll, v[i].z >= 0);
    unsigned b3 = __ballot_sync(kAll, v[i].w >= 0);
    rank[i] = __popc(b0 & below) + __popc(b1 & below)
              + __popc(b2 & below) + __popc(b3 & below);
    if (lane == 0)
      base[i * kWarps + warp] = __popc(b0) + __popc(b1) + __popc(b2)
                                + __popc(b3);
  }
  __syncthreads();
  if (warp == 0) {                            // exclusive scan of base
    int a[4], s = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      a[k] = base[4 * lane + k];
      s += a[k];
    }
    int inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(kAll, inc, o);
      if (lane >= o) inc += y;
    }
    int ex = inc - s;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      base[4 * lane + k] = ex;
      ex += a[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    long long out = before + base[i * kWarps + warp] + rank[i];
    const int vals[4] = {v[i].x, v[i].y, v[i].z, v[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (vals[k] >= 0) {
        if (out < cap) idxs[out] = vals[k];
        ++out;
      }
    }
  }
}

}  // namespace

// slots: (rows, 16) int32 on the device, 16-byte aligned; ovf: 0-d int32;
// counts: n_tiles = max(1, ceil(rows / 1024)) int32 of scratch; idxs: (cap,)
// int64, n_cand: 0-d int64, overflow: 0-d int32, every entry written.
extern "C" int tsm_compact_rows(const void* slots, long long rows,
                                const void* ovf, void* counts,
                                long long n_tiles, void* idxs, long long cap,
                                void* n_cand, void* overflow, int device,
                                void* stream) {
  long long want = rows > 0 ? (rows + kTileRows - 1) / kTileRows : 1;
  if (rows < 0 || cap < 0 || n_tiles != want
      || n_tiles > INT_MAX || (uintptr_t)slots % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  long long nvec = rows * kRowVecs;
  compact_rows_count_kernel<<<(int)n_tiles, kThreads, 0, s>>>(
      (const int4*)slots, nvec, (int*)counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_rows_kernel<<<(int)n_tiles, kThreads, 0, s>>>(
      (const int4*)slots, nvec, (const int*)counts, (int)n_tiles,
      (const int*)ovf, (long long*)idxs, cap, (long long*)n_cand,
      (int*)overflow);
  return (int)cudaGetLastError();
}
