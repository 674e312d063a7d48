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
// What bounds it on an H100: integer issue and latency, not memory traffic
// — the text is read once (256 MiB in 0.08 ms at 3.35 TB/s) and the work per
// start is the fingerprints plus about 1/(1-fill) stage tests.  The first
// design (one start per thread, Horner's rule over the window, 3m
// multiply-adds and m shared-memory byte reads per start before the first
// stage test, bitmaps through __ldg, one tile per block) ran at 5% of its
// bound, and its time barely moved with m (3.5 ms at m=16, 4.1 at m=32).
// This design:
//   - rolling fingerprints: a thread owns a run of kRun = 16 consecutive
//     starts.  It runs Horner once, on the run's first window (16 bytes per
//     shared-memory load), and rolls the other 15 in O(1)
//     (fp_filter.cuh, tsm::roll_fps; M^-1 and M^(m-1) from the host).  The
//     16 bytes leaving and the 16 entering the window come from three
//     16-byte shared-memory loads (conflict free: neighbouring threads read
//     neighbouring 16-byte chunks), the entering ones shifted by m mod 16
//     with funnel shifts, so a start reads no byte from shared memory.
//   - phase-1 bitmaps in shared memory when they fit beside the text tiles
//     (12 KB at m=32 p=10k, 32 KB at p=30k, 96 KB at p=100k; above 48 KB as
//     opted-in dynamic shared memory), else through __ldg.
//   - stages 0 and 1, which nearly every warp runs for nearly every start
//     (a warp runs a stage while any of its 32 starts is alive), are tested
//     for every start without a branch; stages 2.. of phase 1 stop at the
//     first miss.  Phase 2 (through __ldg) runs after the row's ranking, on
//     the survivors that get a slot only: the run's first survivor keeps its
//     fingerprints in registers, a later one (rare) recomputes them.
//   - 512-thread blocks in a persistent grid (as many as fit on the card),
//     each staging the bitmaps once and then walking tiles of 8192 starts,
//     the next tile's text copied in by cp.async while this one is scanned
//     (tile_pipeline.cuh).  At p=100k the 96 KB of bitmaps leave room for
//     two blocks per SM: 512 threads keep 32 warps there (256 kept 16, and
//     ran 1.4x slower, tpu_smatcher_torch/ab_cascade.py).
//   - compaction: a row is 8 threads' runs.  Each thread keeps its run's
//     phase-1 survivors as bits; a prefix sum of __popc over the row's 8
//     lanes (__shfl_up_sync, width 8) gives each survivor its rank in
//     position order, which is what the TPU's triangular-matmul ranks and
//     _rowpack's 8:1 lane repack computed.
//   - the per-scan overflow flag, a sequential-grid max on the TPU, is one
//     atomicOr per block into a zeroed int32.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_filter.cuh"
#include "tile_pipeline.cuh"

namespace {

using tsm::Rolling;
using tsm::StageCD;

constexpr int kThreads = 512;
constexpr int kRun = 16;                  // consecutive starts per thread
constexpr int kTile = kThreads * kRun;    // starts per tile
constexpr int kRow = 128;                 // starts per row
constexpr int kRowLanes = kRow / kRun;    // threads per row
constexpr int kSlots = 16;                // survivors kept per row

// Bytes of one text buffer: the tile's starts, the (m-1)-byte halo, and the
// 16-byte chunk after it that a run's shifted window load may touch.
__host__ __device__ inline int buf_bytes(int m) {
  return (kTile + m - 1 + 15) / 16 * 16 + 16;
}

// Bit `key` of a bitmap in shared memory, or in global memory through the
// read-only cache.
template <bool kShared>
__device__ __forceinline__ uint32_t bit_of(const uint32_t* __restrict__ bm,
                                           uint32_t key) {
  return ((kShared ? bm[key >> 5] : __ldg(bm + (key >> 5))) >> (key & 31)) &
         1u;
}

template <bool kSharedBitmaps>
__global__ void __launch_bounds__(kThreads)
cascade_kernel(const uint8_t* __restrict__ text, long long n, int m,
               long long n_starts, const uint32_t* __restrict__ bitmaps,
               int kt, int k1, int words, uint32_t smask, StageCD cd,
               Rolling roll, int* __restrict__ slots, long long rows,
               int* __restrict__ ovf, long long tiles, int bm_bytes,
               bool aligned) {
  extern __shared__ uint4 smem[];
  uint32_t* sbm = reinterpret_cast<uint32_t*>(smem);  // k1 * words
  uint8_t* bufs = reinterpret_cast<uint8_t*>(smem) + bm_bytes;
  const int blen = buf_bytes(m);
  if (kSharedBitmaps)
    for (int i = threadIdx.x; i < k1 * words; i += kThreads)
      sbm[i] = __ldg(bitmaps + i);

  const uint32_t* p1 = kSharedBitmaps ? sbm : bitmaps;    // phase 1's
  const uint32_t c0 = cd.c[0], d0 = cd.d[0], c1 = cd.c[1], d1 = cd.d[1];
  const int lane8 = threadIdx.x % kRowLanes;
  const int off = threadIdx.x * kRun;            // the run's first start
  // the entering bytes t[i+m]: 16 bytes from chunk (off+m)/16, shifted
  const int in_chunk = (off + m) >> 4, in_shift = m & 15;
  bool any_ovf = false;

  long long tile = blockIdx.x;
  tsm::stage_tile<kThreads>(bufs, text, n, tile * kTile, blen, aligned);
  tsm::cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < tiles)
      tsm::stage_tile<kThreads>(bufs + ((it + 1) & 1) * blen, text, n,
                                next * kTile, blen, aligned);
    tsm::cp_async_commit();
    tsm::cp_async_wait_prev();
    __syncthreads();

    const uint8_t* b = bufs + (it & 1) * blen;
    const long long i0 = tile * kTile + off;
    uint32_t pass1 = 0;
    uint32_t g0 = 0, g1 = 0, g2 = 0;       // the run's first survivor's fps
    if (i0 < n_starts) {
      uint32_t f0, f1, f2;
      tsm::horner_fps(b + off, m, f0, f1, f2);
      const uint4 lo = *reinterpret_cast<const uint4*>(b + off);
      const uint4 h0 = reinterpret_cast<const uint4*>(b)[in_chunk];
      const uint4 h1 = reinterpret_cast<const uint4*>(b)[in_chunk + 1];
      const uint32_t outw[4] = {lo.x, lo.y, lo.z, lo.w};
      const uint32_t w[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      uint32_t inw[4];
      tsm::shifted_words(w, in_shift, inw);
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const uint32_t a0 = f0 & 0xFFFFu, a1 = f1 & 0xFFFFu, a2 = f2 & 0xFFFFu;
        // stages 0 and 1 for every start, without a branch; the rest of
        // phase 1 for the starts that pass both
        bool ok = bit_of<kSharedBitmaps>(
            p1, (a0 + c0 * a1 + d0 * a2) & smask);
        if (k1 > 1)
          ok &= bit_of<kSharedBitmaps>(
              p1 + words, (a0 + c1 * a1 + d1 * a2) & smask) != 0;
        if (ok && k1 > 2)
          ok = kSharedBitmaps
              ? tsm::stages_hit_shared(a0, a1, a2, sbm + 2 * words, cd, 2,
                                       k1, words, smask)
              : tsm::stages_hit({a0, a1, a2}, bitmaps, cd, 2, k1, words,
                                smask);
        if (ok) {
          if (!pass1) g0 = a0, g1 = a1, g2 = a2;
          pass1 |= 1u << j;
        }
        if (j + 1 < kRun)
          tsm::roll_fps(roll, tsm::byte_of(outw, j), tsm::byte_of(inw, j),
                        f0, f1, f2);
      }
      const long long valid = n_starts - i0;
      if (valid < kRun) pass1 &= (1u << valid) - 1u;
    }

    // rank the row's survivors: prefix sum of the counts of its 8 runs
    const int cnt = __popc(pass1);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < kRowLanes; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, incl, d, kRowLanes);
      if (lane8 >= d) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, kRowLanes - 1, kRowLanes);
    any_ovf |= total > kSlots;
    const long long row = (tile * kTile + off) / kRow;
    if (row < rows) {
      int* out = slots + row * kSlots;
      const int s0 = 2 * lane8;                  // this lane's two slots
      if (s0 >= total)
        *reinterpret_cast<int2*>(out + s0) = make_int2(-1, -1);
      else if (s0 + 1 >= total)
        out[s0 + 1] = -1;
      // phase 2 on the survivors that get a slot: the first one's
      // fingerprints were kept, a later one's are computed again
      int rank = incl - cnt;
      for (uint32_t p = pass1; p && rank < kSlots; p &= p - 1, ++rank) {
        const int j = __ffs(p) - 1;
        tsm::BaseFps f = {g0, g1, g2};
        if (p != pass1) f = tsm::base_fps(b + off + j, m);
        out[rank] = tsm::stages_hit(f, bitmaps, cd, k1, kt, words, smask)
                        ? (int)(i0 + j) : -1;
      }
    }
    __syncthreads();                             // buffer free for reuse
  }
  if (__syncthreads_or(any_ovf) && threadIdx.x == 0) atomicOr(ovf, 1);
}

template <bool kShared>
cudaError_t launch(const uint8_t* text, long long n, int m, long long n_starts,
                   const uint32_t* bitmaps, int kt, int k1, int words,
                   const StageCD& cd, int* slots, long long rows, int* ovf,
                   int bm_bytes, int device, cudaStream_t stream) {
  const long long tiles = (n_starts + kTile - 1) / kTile;
  const size_t smem = (size_t)bm_bytes + 2 * (size_t)buf_bytes(m);
  int grid = 0;
  cudaError_t err = tsm::persistent_grid(cascade_kernel<kShared>, kThreads,
                                         smem, tiles, device, &grid);
  if (err != cudaSuccess) return err;
  cascade_kernel<kShared><<<grid, kThreads, smem, stream>>>(
      text, n, m, n_starts, bitmaps, kt, k1, words,
      (uint32_t)(words * 32 - 1), cd, Rolling::make(m), slots, rows, ovf,
      tiles, bm_bytes, ((uintptr_t)text & 15) == 0);
  return cudaGetLastError();
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
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const int words = stage_bits / 32;
  // phase 1's bitmaps go to shared memory when they fit beside the buffers
  const long long bm_bytes = ((long long)k1 * words * 4 + 15) / 16 * 16;
  const bool shared = bm_bytes + 2LL * buf_bytes(m) <= optin;
  StageCD scd = tsm::load_cd(cd, kt);
  const auto* t = (const uint8_t*)text;
  const auto* bm = (const uint32_t*)bitmaps;
  auto s = (cudaStream_t)stream;
  err = shared ? launch<true>(t, n, m, n_starts, bm, kt, k1, words, scd,
                              (int*)slots, rows, (int*)ovf, (int)bm_bytes,
                              device, s)
               : launch<false>(t, n, m, n_starts, bm, kt, k1, words, scd,
                               (int*)slots, rows, (int*)ovf, 0, device, s);
  return (int)err;
}
