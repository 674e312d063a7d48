// k-stage fingerprint filter on Hopper, in two modes.
//
// Replaces two TPU kernels of tpu_smatcher/ops/pallas_filter.py:
//   - mask mode:  _filter_mask_flat_kernel (:1052, via filter_mask_pallas
//     :1066), the per-start candidate mask of the mask route, the sync ladder
//     and the dense pass;
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
// What bounds it on an H100: integer ALU, as for the cascade.  Each start
// costs 3*m multiply-adds (Horner) plus about 1/(1-fill) random bitmap reads;
// the text is read once and the outputs are small (mask: one byte per start;
// slots: 68 bytes per 16,384 starts).  The design: a block's starts plus the
// (m-1)-byte halo sit in shared memory, each thread takes one start per step
// and stops testing at its first stage miss, bitmaps come through __ldg.
// Slots mode ranks candidates with __ballot_sync + __popc within a warp and a
// shared-memory prefix over the block's warps, chunk by chunk in position
// order, so the first 16 are chosen deterministically (the plain torch
// version ranks with a cumsum and agrees bit for bit).

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_filter.cuh"

namespace {

using tsm::BaseFps;
using tsm::StageCD;

constexpr int kThreads = 256;
constexpr int kMaskTile = 2048;   // starts per block, mask mode
constexpr int kSub = 16384;       // starts per sub-block (= block), slots mode
constexpr int kSlots = 16;        // BLOCK_SLOTS

__device__ __forceinline__ bool is_candidate(const uint8_t* w, int m,
                                             const uint32_t* bitmaps,
                                             const StageCD& cd, int k,
                                             int words, uint32_t smask) {
  BaseFps f = tsm::base_fps(w, m);
  return tsm::stages_hit(f, bitmaps, cd, 0, k, words, smask);
}

__global__ void __launch_bounds__(kThreads)
filter_mask_kernel(const uint8_t* __restrict__ text, long long n, int m,
                   long long n_starts, long long n_out,
                   const uint32_t* __restrict__ bitmaps, int k, int words,
                   uint32_t smask, StageCD cd, int8_t* __restrict__ mask) {
  extern __shared__ uint8_t tile[];                 // kMaskTile + m - 1
  const long long base = (long long)blockIdx.x * kMaskTile;
  tsm::load_tile<kThreads>(tile, text, n, base, kMaskTile + m - 1);
  __syncthreads();
  for (int i = threadIdx.x; i < kMaskTile; i += kThreads) {
    long long s = base + i;
    if (s >= n_out) break;
    bool c = s < n_starts &&
             is_candidate(tile + i, m, bitmaps, cd, k, words, smask);
    mask[s] = c ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
filter_slots_kernel(const uint8_t* __restrict__ text, long long n, int m,
                    long long n_starts, const uint32_t* __restrict__ bitmaps,
                    int k, int words, uint32_t smask, StageCD cd,
                    int* __restrict__ pos, int* __restrict__ counts) {
  extern __shared__ uint8_t tile[];                 // kSub + m - 1
  __shared__ int wcnt[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * kSub;
  tsm::load_tile<kThreads>(tile, text, n, base, kSub + m - 1);
  __syncthreads();
  int* out = pos + (long long)blockIdx.x * kSlots;
  int running = 0;               // candidates in earlier chunks (block-uniform)
  for (int c0 = 0; c0 < kSub && base + c0 < n_starts; c0 += kThreads) {
    long long s = base + c0 + tid;
    bool c = s < n_starts &&
             is_candidate(tile + c0 + tid, m, bitmaps, cd, k, words, smask);
    unsigned bal = __ballot_sync(0xffffffffu, c);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      int x = wcnt[w];
      total += x;
      if (w < warp) before += x;
    }
    if (c) {
      int rank = running + before + __popc(bal & ((1u << lane) - 1u));
      if (rank < kSlots) out[rank] = (int)s;
    }
    running += total;
    __syncthreads();             // wcnt is rewritten by the next chunk
  }
  if (tid >= running && tid < kSlots) out[tid] = -1;
  if (tid == 0) counts[blockIdx.x] = running;
}

bool valid_args(int m, int k, int stage_bits, long long n) {
  return m >= 1 && m <= tsm::kMaxM && k >= 1 && k <= tsm::kMaxStages &&
         tsm::valid_stage_bits(stage_bits) && n - m + 1 > 0;
}

}  // namespace

// bitmaps: k stages of stage_bits bits each, contiguous int32 words.
// cd: host array of 2*k uint32, (C_0, D_0, C_1, D_1, ...).
// mask: (rows, 128) int8 with rows = ceil((n-m+1)/128); every entry written.
extern "C" int tsm_filter_mask(const void* text, long long n, int m,
                               const void* bitmaps, int k, int stage_bits,
                               const void* cd, void* mask, long long rows,
                               int device, void* stream) {
  if (!valid_args(m, k, stage_bits, n)) return (int)cudaErrorInvalidValue;
  long long n_starts = n - m + 1;
  if (rows != (n_starts + 127) / 128) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  long long n_out = rows * 128;
  long long grid = (n_out + kMaskTile - 1) / kMaskTile;
  filter_mask_kernel<<<(unsigned)grid, kThreads, (size_t)(kMaskTile + m - 1),
                       (cudaStream_t)stream>>>(
      (const uint8_t*)text, n, m, n_starts, n_out, (const uint32_t*)bitmaps,
      k, stage_bits / 32, (uint32_t)(stage_bits - 1), tsm::load_cd(cd, k),
      (int8_t*)mask);
  return (int)cudaGetLastError();
}

// pos: (n_sub, 16) int32 and counts: (n_sub,) int32, n_sub =
// ceil((n-m+1)/16384); every entry written.
extern "C" int tsm_filter_slots(const void* text, long long n, int m,
                                const void* bitmaps, int k, int stage_bits,
                                const void* cd, void* pos, void* counts,
                                long long n_sub, int device, void* stream) {
  if (!valid_args(m, k, stage_bits, n)) return (int)cudaErrorInvalidValue;
  long long n_starts = n - m + 1;
  if (n_sub != (n_starts + kSub - 1) / kSub) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  filter_slots_kernel<<<(unsigned)n_sub, kThreads, (size_t)(kSub + m - 1),
                        (cudaStream_t)stream>>>(
      (const uint8_t*)text, n, m, n_starts, (const uint32_t*)bitmaps, k,
      stage_bits / 32, (uint32_t)(stage_bits - 1), tsm::load_cd(cd, k),
      (int*)pos, (int*)counts);
  return (int)cudaGetLastError();
}
