// Two-phase fingerprint cascade on Hopper.
//
// Replaces the TPU kernel _cascade_kernel (tpu_smatcher/ops/pallas_filter.py:758,
// launched by cascade_pallas :810), with its helpers _bases_flat :519,
// derived_keys :316 and _rowpack :705.
//
// For every start i < n - m + 1 it computes three base fingerprints
//     fp_s = sum_j t[i+j] * FP_MULTS[s]^j  mod 2^16      (s = 0, 1, 2)
// and tests derived stage keys key_s = (fp0 + C_s*fp1 + D_s*fp2) mod stage_bits
// against stage bitmaps.  Phase 1 keeps a start iff stages [0, k1) all hit.
// A row is 128 consecutive starts (row r = starts [128r, 128r+128)); the first
// 16 phase-1 survivors of each row, in position order, go on to phase 2,
// stages [k1, kt).  Output: slots (rows, 16) int32, slot k of row r = the
// row's k-th survivor if it passed phase 2, else -1; and ovf = 1 if any row
// had more than 16 phase-1 survivors.  (R, 16) row-major is the same memory
// as the Pallas kernel's packed (R/8, 128) output.  The key and stage code is
// shared with filter.cu (fp_filter.cuh).
//
// What bounds it on an H100: integer ALU and the bitmap reads, not memory
// traffic — the text is read once, while each start costs 3*m multiply-adds
// and about 1/(1-fill) random bitmap reads.  The design:
//   - keys: a block owns 8 rows (1024 starts); their bytes plus the
//     (m-1)-byte halo sit in shared memory, and each thread runs Horner's rule
//     over its window in uint32 (exact mod 2^16 after the final mask; C, D
//     <= 0xFFFF keep the derived keys exact mod stage_bits too).  The TPU's
//     bf16 banded matmuls and their f32-accumulation limit do not exist here.
//   - bitmaps: read from global memory through the read-only cache (__ldg).
//     Up to 32 stages of up to 32 KB do not fit shared memory; the stages a
//     block touches stay in L1/L2.  Phase 1 stops testing a start at its
//     first miss.
//   - compaction: a row is the block's four warps; __ballot_sync + __popc give
//     each survivor its in-row rank, so the first 16 by position are chosen
//     deterministically (the plain torch version ranks with a cumsum and
//     agrees bit for bit).  This replaces _rowpack's triangular MXU matmul and
//     8:1 lane repack.
//   - the per-scan overflow flag, a sequential-grid max on the TPU, is an
//     atomicOr into a zeroed int32.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_filter.cuh"

namespace {

using tsm::BaseFps;
using tsm::StageCD;

constexpr int kRow = 128;        // starts per row, = threads per block
constexpr int kRows = 8;         // rows per block
constexpr int kSlots = 16;       // survivors kept per row

__global__ void __launch_bounds__(kRow)
cascade_kernel(const uint8_t* __restrict__ text, long long n, int m,
               long long n_starts, const uint32_t* __restrict__ bitmaps,
               int kt, int k1, int words, uint32_t smask, StageCD cd,
               int* __restrict__ slots, long long rows,
               int* __restrict__ ovf) {
  extern __shared__ uint8_t tile[];                // kRows*kRow + m - 1
  __shared__ int wcnt[kRows][kRow / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * kRows * kRow;
  tsm::load_tile<kRow>(tile, text, n, base, kRows * kRow + m - 1);
  __syncthreads();

  BaseFps f[kRows];
  uint32_t bal[kRows];
  bool cand[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    bool c = base + r * kRow + tid < n_starts;
    f[r] = {0u, 0u, 0u};
    if (c) {
      f[r] = tsm::base_fps(tile + r * kRow + tid, m);
      c = tsm::stages_hit(f[r], bitmaps, cd, 0, k1, words, smask);
    }
    cand[r] = c;
    bal[r] = __ballot_sync(0xffffffffu, c);
    if (lane == 0) wcnt[r][warp] = __popc(bal[r]);
  }
  __syncthreads();

  bool any_ovf = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kRow / 32; ++w) {
      int x = wcnt[r][w];
      total += x;
      if (w < warp) before += x;
    }
    any_ovf |= total > kSlots;
    long long row = (long long)blockIdx.x * kRows + r;
    if (row >= rows) continue;
    int* out = slots + row * kSlots;
    if (cand[r]) {
      int rank = before + __popc(bal[r] & ((1u << lane) - 1u));
      if (rank < kSlots) {
        bool c2 = tsm::stages_hit(f[r], bitmaps, cd, k1, kt, words, smask);
        out[rank] = c2 ? (int)(base + r * kRow + tid) : -1;
      }
    }
    if (tid >= total && tid < kSlots) out[tid] = -1;
  }
  if (tid == 0 && any_ovf) atomicOr(ovf, 1);
}

}  // namespace

// bitmaps: kt stages of stage_bits bits each, contiguous int32 words.
// cd: host array of 2*kt uint32, (C_0, D_0, C_1, D_1, ...).
// slots: (rows, 16) int32 with rows = ceil((n-m+1)/128); every entry written.
// ovf: one zeroed int32 on the device; set to 1 on a phase-1 row overflow.
extern "C" int tsm_cascade(const void* text, long long n, int m,
                           const void* bitmaps, int kt, int stage_bits, int k1,
                           const void* cd, void* slots, long long rows,
                           void* ovf, int device, void* stream) {
  if (m < 1 || m > tsm::kMaxM || kt < 2 || kt > tsm::kMaxStages || k1 < 1 ||
      k1 >= kt || !tsm::valid_stage_bits(stage_bits))
    return (int)cudaErrorInvalidValue;
  long long n_starts = n - m + 1;
  if (n_starts <= 0 || rows != (n_starts + kRow - 1) / kRow)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  StageCD scd = tsm::load_cd(cd, kt);
  long long grid = (rows + kRows - 1) / kRows;
  size_t smem = (size_t)(kRows * kRow + m - 1);
  cascade_kernel<<<(unsigned)grid, kRow, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)text, n, m, n_starts, (const uint32_t*)bitmaps, kt, k1,
      stage_bits / 32, (uint32_t)(stage_bits - 1), scd, (int*)slots, rows,
      (int*)ovf);
  return (int)cudaGetLastError();
}
