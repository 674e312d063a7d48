// k-stage fingerprint filter on Hopper, in two modes.
//
// Replaces two TPU kernels of tpu_smatcher/ops/pallas_filter.py:
//   - mask mode:  _filter_mask_flat_kernel (:1052, via filter_mask_pallas
//     :1066), the per-start candidate mask of the mask route, the sync ladder,
//     the dense pass and the fingerprint tier's positions pieces;
//   - slots mode: _filter_slots_flat_kernel (:559, via filter_slots_pallas
//     :618) with its in-kernel compaction slot_row (:348), the slot route.
// Both run _candidates_flat (:530): a start i < n - m + 1 is a candidate iff
// its derived keys hit all k stage bitmaps (key and stage code in
// fp_filter.cuh, shared with cascade.cu).
//
// Mask mode writes mask[i] = 1 for a candidate, else 0, over R*128 int8 with
// R = ceil((n-m+1)/128): starts >= n-m+1 (the last row's padding) are written
// 0.  Filter_rb and the VMEM-driven FILTER_RB of the TPU do not exist here.
//
// Slots mode works per 16,384-start sub-block (SLOT_RB * 128 starts, the
// granularity the slot budget and the scanner's adaptation thresholds are
// calibrated on).  Sub-block b covers starts [16384b, 16384b + 16384); its
// output is pos[b, 0..16) = its first 16 candidates in position order (-1
// where it has fewer) and counts[b] = its true candidate count, so
// counts[b] > 16 means candidates were dropped.  This is the order of
// slot_row's rank matmuls, and (n_sub, 16) + (n_sub,) replaces the TPU's
// (n_sub, 128) rows with the count in lane 16.
//
// What bounds it on an H100: integer issue, as for the cascade.  The text is
// read once and the outputs are small (mask: one byte per start; slots: 68
// bytes per 16,384 starts); the work per start is the three fingerprints and
// about 1/(1-fill) stage tests.  The first design (one start per thread,
// Horner's rule over the whole window, 3m multiply-adds and m shared-memory
// byte loads per start, the text staged byte by byte, bitmaps through __ldg)
// ran at 5-6% of its bound.  This design follows cascade.cu:
//   - rolling fingerprints: a thread owns a run of kRun = 32 consecutive
//     starts, runs Horner's rule once on the run's first window (16 bytes per
//     shared-memory load) and rolls the other 31 in O(1) (fp_filter.cuh,
//     tsm::roll_fps); the bytes leaving and entering the window come from
//     16-byte shared-memory loads, funnel-shifted into place;
//   - 512-thread blocks in a persistent grid walking tiles of 16,384 starts
//     (one sub-block), the text staged by cp.async into two buffers so the
//     next tile's copy overlaps this tile's work (tile_pipeline.cuh).  A text at an address that is not 16-byte aligned
//     (a view at any offset: the sync ladder's budget pieces, the positions
//     pieces) is copied from the aligned address below it, which lies in the
//     same allocation, and its tile sits `shift` bytes into the buffer; the
//     bytes before the view and past its end never reach a start's result;
//   - the stage bitmaps in shared memory: all k stages where they fit in
//     kSmemTarget beside the two buffers (two blocks per SM), else the first
//     ks, the rest through __ldg; the first kBranchFree always (past the
//     target, one block per SM, only with 2^18-bit stages);
//   - stages 0 to kBranchFree - 1, which nearly every warp runs for nearly
//     every start (a warp runs a stage while any of its 32 starts is alive),
//     are tested for every start without a branch; the rest stop at the
//     first miss;
//   - mask mode: a thread's 32 results are two 16-byte stores (a 128-start
//     row is 4 threads);
//   - slots mode: a tile is one sub-block.  Each thread keeps its run's
//     candidates as a 32-bit mask; a block-wide exclusive prefix of __popc
//     in position order (a __shfl_up_sync scan in each warp, the warps'
//     totals in shared memory) ranks them, and a thread whose rank is below
//     16 writes its first candidates' positions; the plain torch version
//     ranks with a cumsum and agrees bit for bit.
// The run (fp_run_hits in fp_filter.cuh) and its stores (store_run_mask,
// rank_run_slots in tile_pipeline.cuh) are shared with stages.cu, whose
// fingerprint stage is this filter.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_filter.cuh"
#include "tile_pipeline.cuh"

namespace {

using tsm::kRun;
using tsm::kSlots;
using tsm::Rolling;
using tsm::StageCD;

constexpr int kThreads = 512;
constexpr int kTile = kThreads * kRun;    // starts per tile
constexpr int kSub = 16384;               // starts per sub-block, slots mode
constexpr int kBranchFree = tsm::kFpBranchFree;
// Shared memory a block keeps to, so that two blocks (32 warps) fit on an SM.
constexpr int kSmemTarget = 112 * 1024;
static_assert(kTile == kSub, "a slots-mode tile is one sub-block");

__host__ __device__ inline int buf_bytes(int m) {
  return tsm::run_buf_bytes(kTile, m);
}

// text: the 16-byte aligned address at or below the view, whose start count
// is n_starts and whose first byte is text[shift]; n: the view's length plus
// shift.  Mask mode writes mask (n_out = R*128 entries), slots mode pos and
// counts (one entry per tile).
template <bool kSlotsMode>
__global__ void __launch_bounds__(kThreads)
filter_kernel(const uint8_t* __restrict__ text, long long n, int shift, int m,
              long long n_starts, const uint32_t* __restrict__ bitmaps, int k,
              int ks, int words, uint32_t smask, StageCD cd, Rolling roll,
              int8_t* __restrict__ mask, long long n_out,
              int* __restrict__ pos, int* __restrict__ counts,
              long long tiles, int bm_bytes) {
  extern __shared__ uint4 smem[];
  __shared__ int wsum[kThreads / 32];           // slots mode: warp totals
  uint32_t* sbm = reinterpret_cast<uint32_t*>(smem);   // ks * words
  uint8_t* bufs = reinterpret_cast<uint8_t*>(smem) + bm_bytes;
  const int blen = buf_bytes(m);
  for (int i = threadIdx.x; i < ks * words; i += kThreads)
    sbm[i] = __ldg(bitmaps + i);
  const int off = threadIdx.x * kRun;            // the run's first start

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
      hits = tsm::fp_run_hits(bufs + (it & 1) * blen, shift + off, shift, m,
                              sbm, bitmaps, k, ks, words, smask, cd, roll,
                              ~0u);
      const long long valid = n_starts - i0;
      if (valid < kRun) hits &= (1u << valid) - 1u;
    }
    if constexpr (!kSlotsMode) {
      if (i0 < n_out)                    // n_out is a multiple of kRun
        tsm::store_run_mask(mask + i0, hits);
    } else {
      tsm::rank_run_slots<kThreads>(hits, i0, pos + tile * kSlots,
                                    counts + tile, wsum);
    }
    __syncthreads();                  // buffer and wsum free for reuse
  }
}

// Both modes: the aligned address below the text, the stages that go to
// shared memory, and the launch.
template <bool kSlotsMode>
int run(const void* text, long long n, int m, const void* bitmaps, int k,
        int stage_bits, const void* cd, int8_t* mask, long long n_out,
        int* pos, int* counts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n_starts = n - m + 1;
  const long long tiles = (n_starts + kTile - 1) / kTile;
  const int words = stage_bits / 32;
  // as many stages in shared memory as keep the block within kSmemTarget,
  // and the ones tested without a branch in any case
  const long long bufs = 2LL * buf_bytes(m);
  long long ks = (kSmemTarget - bufs) / (words * 4LL);
  if (ks < kBranchFree) ks = kBranchFree;
  if (ks > k) ks = k;
  const int bm_bytes = (int)((ks * words * 4 + 15) / 16 * 16);
  const int shift = (int)((uintptr_t)text & 15);
  const size_t smem = (size_t)bm_bytes + (size_t)bufs;
  const auto kernel = filter_kernel<kSlotsMode>;
  int grid = 0;
  err = tsm::persistent_grid(kernel, kThreads, smem, tiles, device, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)text - shift, n + shift, shift, m, n_starts,
      (const uint32_t*)bitmaps, k, (int)ks, words, (uint32_t)(stage_bits - 1),
      tsm::load_cd(cd, k), Rolling::make(m), mask, n_out, pos, counts, tiles,
      bm_bytes);
  return (int)cudaGetLastError();
}

bool valid_args(int m, int k, int stage_bits, long long n) {
  return m >= 1 && m <= tsm::kMaxM && k >= 1 && k <= tsm::kMaxStages &&
         tsm::valid_stage_bits(stage_bits) && n - m + 1 > 0;
}

}  // namespace

// bitmaps: k stages of stage_bits bits each, contiguous int32 words.
// cd: host array of 2*k uint32, (C_0, D_0, C_1, D_1, ...).
// mask: (rows, 128) int8 with rows = ceil((n-m+1)/128), 16-byte aligned;
// every entry written.
extern "C" int tsm_filter_mask(const void* text, long long n, int m,
                               const void* bitmaps, int k, int stage_bits,
                               const void* cd, void* mask, long long rows,
                               int device, void* stream) {
  if (!valid_args(m, k, stage_bits, n) || ((uintptr_t)mask & 15))
    return (int)cudaErrorInvalidValue;
  if (rows != (n - m + 1 + 127) / 128) return (int)cudaErrorInvalidValue;
  return run<false>(text, n, m, bitmaps, k, stage_bits, cd, (int8_t*)mask,
                    rows * 128, nullptr, nullptr, device, stream);
}

// pos: (n_sub, 16) int32 and counts: (n_sub,) int32, n_sub =
// ceil((n-m+1)/16384); every entry written.
extern "C" int tsm_filter_slots(const void* text, long long n, int m,
                                const void* bitmaps, int k, int stage_bits,
                                const void* cd, void* pos, void* counts,
                                long long n_sub, int device, void* stream) {
  if (!valid_args(m, k, stage_bits, n)) return (int)cudaErrorInvalidValue;
  if (n_sub != (n - m + 1 + kSub - 1) / kSub)
    return (int)cudaErrorInvalidValue;
  return run<true>(text, n, m, bitmaps, k, stage_bits, cd, nullptr, 0,
                   (int*)pos, (int*)counts, device, stream);
}
