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
// What bounds it on an H100: integer issue, not memory traffic — the text is
// read once (256 MiB in 0.08 ms at 3.35 TB/s) and the work per start is
// rolling three fingerprints, two derived keys and two shared-memory bit
// tests, ~30 instructions split about evenly between the 16-lane integer
// and multiply-add pipes.  Since the stage width became the H100's own
// (ops/fast.h100_stage_bits), phase 1 at p=10k is two stages that every
// start must test, and the previous design (16-start runs, 8 threads a row)
// spent more around them than on them: Horner's rule once per 16 starts,
// the first survivor's fingerprints kept by selects at every start, a
// shuffle scan per row, and phase 2 of a row's survivors run one after
// another by their run's thread (~67 instructions a start at m=32 in its
// SASS).  This design:
//   - one thread owns one 128-start row: Horner's rule runs once a row, on
//     its first window (16 bytes per shared-memory load), and the
//     fingerprints roll 127 times in O(1) (fp_filter.cuh, tsm::roll_fps;
//     M^-1 and M^(m-1) from the host).  The 16 bytes leaving and the 16
//     entering the window per 16 starts are 16-byte loads, the entering
//     ones funnel-shifted by m mod 16 (no shift where m is a multiple of
//     16), so a start reads no byte from shared memory.
//   - 16 starts at a time: their masked fingerprints in registers, then
//     phase 1 stage by stage over all 16, without a branch (every stage of
//     phase 1: the router's k1 is small where the fill is low, and where it
//     is large nearly every warp runs every stage anyway), each start's
//     bit shifted into a 16-bit mask.  The row's survivors are a 128-bit
//     mask; its ranking is their order in it.
//   - phase 2 at the row's end, shared out over the warp: its lanes'
//     survivors that get a slot (a prefix sum over the lanes) are dealt one
//     to a lane, which finds its survivor's row and rank by a binary search
//     over the lanes' counts, computes its fingerprints again by Horner's
//     rule from the tile in shared memory, tests stages [k1, kt) through
//     __ldg and writes the slot.  A row's thread writes -1 past its count.
//     (Phase 2 inline at each phase-1 hit, by the hit's own thread, ran
//     slower than the previous design: a global load in a branch at every
//     ~6th start of a warp; tpu_smatcher_torch/ab_cascade.py.)
//   - the text tile in shared memory is padded: one 16-byte pad after each
//     thread's run, so the 8 threads of a quarter-warp, whose 16-byte loads
//     are a run apart, hit distinct banks.  A tile is the block's rows,
//     double-buffered by cp.async (tile_pipeline.cuh); a text at an
//     unaligned address is staged byte by byte.
//   - phase-1 bitmaps in shared memory when they fit beside the text tiles
//     (32 KB at m=32 p=10k, 64 KB at p=30k, 96 KB at p=100k; above 48 KB as
//     opted-in dynamic shared memory), else through __ldg.  The block size
//     adapts to what they leave: the fewest threads that keep the most
//     warps on an SM (pick_shape).  Where one thread a row keeps fewer than
//     16 warps on an SM (p=100k's 96 KB), two threads share a row, 64
//     starts each, the second's survivors ranked after the first's count.
//   - a persistent grid (tile_pipeline.cuh, persistent_grid); the per-scan
//     overflow flag, a sequential-grid max on the TPU, is one atomicOr per
//     block into a zeroed int32.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_filter.cuh"
#include "tile_pipeline.cuh"

namespace {

using tsm::Rolling;
using tsm::StageCD;

constexpr int kRow = 128;                 // starts per row
constexpr int kSlots = 16;                // survivors kept per row
constexpr int kMaxThreads = 512;
constexpr int kMinWarps = 16;             // per SM, for one thread a row

// The text of a tile as a thread's run sees it: kRowThreads threads share a
// row, each a run of kRun consecutive starts; logical 16-byte chunk c of
// the tile is stored at chunk phys(c), one 16-byte pad after each run.
template <int kRowThreads>
struct Layout {
  static constexpr int kRun = kRow / kRowThreads;
  static constexpr int kChunks = kRun / 16;          // chunks per run
  __host__ __device__ static int phys(int c) { return c + c / kChunks; }
  // Bytes of one text buffer for `threads` threads: every chunk a run
  // reads, up to the one holding byte tile + m of the tile.
  __host__ __device__ static int buf_bytes(int threads, int m) {
    return 16 * (phys((threads * kRun + m) / 16) + 1);
  }
};

// Block-wide: logical chunks [0, chunks) of the tile at text[base..] into
// buf at their padded places, 0 past the text's end; cp.async where the
// text is 16-byte aligned, else byte by byte.
template <int kRowThreads>
__device__ __forceinline__ void stage_padded(uint8_t* buf,
                                             const uint8_t* __restrict__ text,
                                             long long n, long long base,
                                             int chunks, bool aligned) {
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    uint8_t* dst = buf + 16 * Layout<kRowThreads>::phys(c);
    const long long g = base + 16LL * c;
    if (aligned) {
      const long long left = n - g;
      const int bytes = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
      tsm::cp_async16(dst, bytes ? text + g : text, bytes);
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k) dst[k] = g + k < n ? text[g + k] : 0;
    }
  }
}

// Chunk c and byte j of a run whose text starts at r (padded layout).
template <int kRowThreads>
__device__ __forceinline__ uint4 run_chunk(const uint8_t* r, int c) {
  return reinterpret_cast<const uint4*>(r)[Layout<kRowThreads>::phys(c)];
}
template <int kRowThreads>
__device__ __forceinline__ uint32_t run_byte(const uint8_t* r, int j) {
  return r[j + 16 * (j / Layout<kRowThreads>::kRun)];
}

// Byte j (a compile-time index after unrolling) of a word array, by one
// byte permute.
__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[4], int j) {
  return __byte_perm(w[j >> 2], 0, 0x4440 | (j & 3));
}

// The three fingerprints (in uint32, not masked) of the m bytes at byte i
// of a run: Horner's rule from the last byte, the bytes past the last whole
// 16 one by one, then 16 bytes a step, from two chunk loads funnel-shifted
// by i mod 16 (one load where i is a multiple of 16).
template <int kRowThreads>
__device__ __forceinline__ void horner_run(const uint8_t* r, int i, int m,
                                           uint32_t& a, uint32_t& b,
                                           uint32_t& e) {
  a = b = e = 0;
  const int whole = m & ~15;
  for (int j = m - 1; j >= whole; --j) {
    const uint32_t t = run_byte<kRowThreads>(r, i + j);
    a = a * tsm::kMult0 + t;
    b = b * tsm::kMult1 + t;
    e = e * tsm::kMult2 + t;
  }
  const int s = i & 15;
  for (int c = whole - 16; c >= 0; c -= 16) {
    const int q = (i + c) >> 4;
    const uint4 v = run_chunk<kRowThreads>(r, q);
    uint32_t x[4] = {v.x, v.y, v.z, v.w};
    if (s) {
      const uint4 u = run_chunk<kRowThreads>(r, q + 1);
      const uint32_t w[8] = {x[0], x[1], x[2], x[3], u.x, u.y, u.z, u.w};
      tsm::shifted_words(w, s, x);
    }
#pragma unroll
    for (int j = 15; j >= 0; --j) {
      const uint32_t t = byte_at(x, j);
      a = a * tsm::kMult0 + t;
      b = b * tsm::kMult1 + t;
      e = e * tsm::kMult2 + t;
    }
  }
}

// The derived key of a start, not yet reduced mod stage_bits: bit_of takes
// its word index and bit from the low bits.
__device__ __forceinline__ uint32_t key_of(uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t c,
                                           uint32_t d) {
  return d * a2 + (c * a1 + a0);
}

// Bit key mod stage_bits of a bitmap (in shared memory, or in global memory
// through the read-only cache) in bit 0 of the result; the other bits are
// garbage.  amask = (stage_bits / 32 - 1) * 4 keeps the word's byte offset.
template <bool kShared>
__device__ __forceinline__ uint32_t bit_of(const uint32_t* __restrict__ bm,
                                           uint32_t key, uint32_t amask) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const char*>(bm) + ((key >> 3) & amask));
  const uint32_t w = kShared ? *p : __ldg(p);
  return __funnelshift_r(w, w, key);       // shifts by key & 31
}

// out[from..kSlots) = -1, 16 bytes per store where a whole quad is -1.
__device__ __forceinline__ void fill_tail(int* out, int from) {
#pragma unroll
  for (int q = 0; q < kSlots; q += 4) {
    if (from <= q)
      *reinterpret_cast<int4*>(out + q) = make_int4(-1, -1, -1, -1);
    else
      for (int s = from; s < q + 4; ++s) out[s] = -1;
  }
}

template <bool kSharedBitmaps, int kRowThreads>
__global__ void __launch_bounds__(kMaxThreads)
cascade_kernel(const uint8_t* __restrict__ text, long long n, int m,
               long long n_starts, const uint32_t* __restrict__ bitmaps,
               int kt, int k1, int words, uint32_t smask, StageCD cd,
               Rolling roll, int* __restrict__ slots, long long rows,
               int* __restrict__ ovf, long long tiles, int bm_bytes,
               bool aligned) {
  using L = Layout<kRowThreads>;
  constexpr int kRun = L::kRun, kWords = kRun / 32;
  extern __shared__ uint4 smem[];
  uint32_t* sbm = reinterpret_cast<uint32_t*>(smem);  // k1 * words
  uint8_t* bufs = reinterpret_cast<uint8_t*>(smem) + bm_bytes;
  const int tile_starts = blockDim.x * kRun;
  const int chunks = (tile_starts + m) / 16 + 1;
  const int blen = L::buf_bytes(blockDim.x, m);
  if (kSharedBitmaps)
    for (int i = threadIdx.x; i < k1 * words; i += blockDim.x)
      sbm[i] = __ldg(bitmaps + i);

  // phase 1's bitmaps; its first two stages (stage 0 twice where k1 = 1)
  const uint32_t* p0 = kSharedBitmaps ? sbm : bitmaps;
  const uint32_t* p1 = k1 > 1 ? p0 + words : p0;
  const uint32_t c0 = cd.c[0], d0 = cd.d[0];
  const uint32_t c1 = k1 > 1 ? cd.c[1] : c0, d1 = k1 > 1 ? cd.d[1] : d0;
  const uint32_t amask = (uint32_t)(words - 1) * 4;
  const int half = threadIdx.x % kRowThreads;    // the run's part of its row
  const int off = threadIdx.x * kRun;            // the run's first start
  // the entering bytes t[i+m]: 16 bytes from run chunk m/16 on, shifted
  const int in_chunk = m >> 4, in_shift = m & 15;
  bool any_ovf = false;

  long long tile = blockIdx.x;
  stage_padded<kRowThreads>(bufs, text, n, tile * tile_starts, chunks,
                            aligned);
  tsm::cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < tiles)
      stage_padded<kRowThreads>(bufs + ((it + 1) & 1) * blen, text, n,
                                next * tile_starts, chunks, aligned);
    tsm::cp_async_commit();
    tsm::cp_async_wait_prev();
    __syncthreads();

    const uint8_t* r = bufs + (it & 1) * blen + 16 * L::phys(off / 16);
    const long long i0 = tile * tile_starts + off;
    const long long row = i0 / kRow;
    // the run's phase-1 survivors, start i at bit i % 32 of word i / 32
    uint32_t hits[kWords] = {};
    if (row < rows) {
      uint32_t f0, f1, f2;
      horner_run<kRowThreads>(r, 0, m, f0, f1, f2);
      uint4 hi = run_chunk<kRowThreads>(r, in_chunk);
#pragma unroll 1
      for (int k = 0; k < kRun / 16; ++k) {
        const uint4 lo = run_chunk<kRowThreads>(r, k);
        const uint32_t outw[4] = {lo.x, lo.y, lo.z, lo.w};
        uint32_t inw[4] = {hi.x, hi.y, hi.z, hi.w};
        hi = run_chunk<kRowThreads>(r, in_chunk + k + 1);
        if (in_shift) {
          const uint32_t w[8] = {inw[0], inw[1], inw[2], inw[3],
                                 hi.x,   hi.y,   hi.z,   hi.w};
          tsm::shifted_words(w, in_shift, inw);
        }
        // the 16 starts' fingerprints, then phase 1 stage by stage over
        // all of them, without a branch
        uint32_t a0[16], a1[16], a2[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          a0[j] = f0 & 0xFFFFu, a1[j] = f1 & 0xFFFFu, a2[j] = f2 & 0xFFFFu;
          tsm::roll_fps(roll, byte_at(outw, j), byte_at(inw, j),
                        f0, f1, f2);
        }
        // start j's bit enters h at the top and moves down to bit 16 + j
        uint32_t h = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          h = __funnelshift_r(
              h,
              bit_of<kSharedBitmaps>(p0, key_of(a0[j], a1[j], a2[j], c0, d0),
                                     amask) &
                  bit_of<kSharedBitmaps>(
                      p1, key_of(a0[j], a1[j], a2[j], c1, d1), amask),
              1);
        for (int s = 2; s < k1; ++s) {
          const uint32_t c = cd.c[s], d = cd.d[s];
          const uint32_t* bm = p0 + s * words;
          uint32_t hs = 0;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            hs = __funnelshift_r(
                hs,
                bit_of<kSharedBitmaps>(bm, key_of(a0[j], a1[j], a2[j], c, d),
                                       amask),
                1);
          h &= hs;
        }
        // 16 bits in at the top of the run's survivors
#pragma unroll
        for (int w = 0; w + 1 < kWords; ++w)
          hits[w] = __funnelshift_r(hits[w], hits[w + 1], 16);
        hits[kWords - 1] = (hits[kWords - 1] >> 16) | h;
      }
      const long long valid = n_starts - i0;         // < kRun: the last row
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        if (valid < 32 * (w + 1))
          hits[w] &= valid <= 32 * w ? 0u : (1u << (valid - 32 * w)) - 1u;
    }

    // the run's survivors ranked after those of the row's runs before it
    int cnt = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) cnt += __popc(hits[w]);
    int before = 0;
    if (kRowThreads == 2) {
      const int first = __shfl_up_sync(0xffffffffu, cnt, 1, 2);
      if (half == 1) before = first;
    }
    // phase 2 on the survivors that get a slot, their fingerprints
    // computed again, shared out over the warp's lanes: item g of the warp
    // is survivor g - excl of the first lane whose incl exceeds g
    const int lane = threadIdx.x & 31;
    const int room = kSlots - before;
    const int take = row >= rows || room <= 0 ? 0 : cnt < room ? cnt : room;
    int incl = take;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    const int items = __shfl_sync(0xffffffffu, incl, 31);
    for (int g = lane; g - lane < items; g += 32) {
      int owner = 0;
#pragma unroll
      for (int step = 16; step; step >>= 1)
        if (__shfl_sync(0xffffffffu, incl, owner + step - 1) <= g)
          owner += step;
      int k = g - (__shfl_sync(0xffffffffu, incl, owner) -
                   __shfl_sync(0xffffffffu, take, owner));
      const int rank = __shfl_sync(0xffffffffu, before, owner) + k;
      uint32_t mask[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w)
        mask[w] = __shfl_sync(0xffffffffu, hits[w], owner);
      if (g >= items) continue;
      // the k-th survivor of the owner's run
      int i = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const int c = __popc(mask[w]);
        if (k >= 0 && k < c) {
          uint32_t p = mask[w];
          for (; k; --k) p &= p - 1;
          i = 32 * w + __ffs(p) - 1;
        }
        k -= c;
      }
      const int dl = owner - lane;
      const long long at = i0 + (long long)dl * kRun + i;
      uint32_t f0, f1, f2;
      horner_run<kRowThreads>(r + dl * 16 * (L::kChunks + 1), i, m, f0, f1,
                              f2);
      slots[at / kRow * kSlots + rank] =
          tsm::stages_hit({f0 & 0xFFFFu, f1 & 0xFFFFu, f2 & 0xFFFFu},
                          bitmaps, cd, k1, kt, words, smask)
              ? (int)at : -1;
    }
    if (row < rows && half == kRowThreads - 1) {
      const int total = before + cnt;
      any_ovf |= total > kSlots;
      fill_tail(slots + row * kSlots, total < kSlots ? total : kSlots);
    }
    __syncthreads();                             // buffer free for reuse
  }
  if (__syncthreads_or(any_ovf) && threadIdx.x == 0) atomicOr(ovf, 1);
}

// The block's threads and each row's: of the block sizes that fit beside
// bm_bytes of phase-1 bitmaps (two text buffers each), the fewest threads
// that keep the most warps on an SM — one thread a row where that keeps
// at least kMinWarps warps, else two threads a row where they keep more.
// warps = 0 where no block size fits.
struct Shape {
  int row_threads = 0, threads = 0, warps = 0;
};

template <int kRowThreads>
Shape best_shape(long long bm_bytes, int m, int optin, int sm_smem,
                 int reserved, int sm_threads) {
  Shape best;
  for (int threads = 128; threads <= kMaxThreads; threads *= 2) {
    const long long smem =
        bm_bytes + 2LL * Layout<kRowThreads>::buf_bytes(threads, m);
    if (smem > optin) continue;
    long long blocks = sm_smem / (smem + reserved);
    if (blocks > sm_threads / threads) blocks = sm_threads / threads;
    const int warps = (int)blocks * threads / 32;
    if (warps > best.warps) best = {kRowThreads, threads, warps};
  }
  return best;
}

cudaError_t pick_shape(long long bm_bytes, int m, int device, Shape* shape) {
  int optin = 0, sm_smem = 0, reserved = 0, sm_threads = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &sm_threads, cudaDevAttrMaxThreadsPerMultiProcessor, device);
  if (err != cudaSuccess) return err;
  const Shape one =
      best_shape<1>(bm_bytes, m, optin, sm_smem, reserved, sm_threads);
  const Shape two =
      best_shape<2>(bm_bytes, m, optin, sm_smem, reserved, sm_threads);
  *shape = one.warps >= kMinWarps || one.warps >= two.warps ? one : two;
  return cudaSuccess;
}

template <bool kShared, int kRowThreads>
cudaError_t launch(const uint8_t* text, long long n, int m, long long n_starts,
                   const uint32_t* bitmaps, int kt, int k1, int words,
                   const StageCD& cd, int* slots, long long rows, int* ovf,
                   int bm_bytes, int threads, int device,
                   cudaStream_t stream) {
  const long long tile_starts = (long long)threads * Layout<kRowThreads>::kRun;
  const long long tiles = (n_starts + tile_starts - 1) / tile_starts;
  const size_t smem =
      (size_t)bm_bytes + 2 * (size_t)Layout<kRowThreads>::buf_bytes(threads, m);
  auto* kernel = cascade_kernel<kShared, kRowThreads>;
  int grid = 0;
  cudaError_t err =
      tsm::persistent_grid(kernel, threads, smem, tiles, device, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(
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
  const int words = stage_bits / 32;
  // phase 1's bitmaps go to shared memory when some block size fits beside
  // them, else they are read through __ldg
  long long bm_bytes = ((long long)k1 * words * 4 + 15) / 16 * 16;
  Shape shape;
  err = pick_shape(bm_bytes, m, device, &shape);
  if (err != cudaSuccess) return (int)err;
  const bool shared = shape.warps > 0;
  if (!shared) {
    bm_bytes = 0;
    err = pick_shape(0, m, device, &shape);
    if (err != cudaSuccess) return (int)err;
  }
  StageCD scd = tsm::load_cd(cd, kt);
  const auto* t = (const uint8_t*)text;
  const auto* bm = (const uint32_t*)bitmaps;
  auto s = (cudaStream_t)stream;
  const int bmb = (int)bm_bytes, th = shape.threads;
  if (shape.row_threads == 1)
    err = shared ? launch<true, 1>(t, n, m, n_starts, bm, kt, k1, words, scd,
                                   (int*)slots, rows, (int*)ovf, bmb, th,
                                   device, s)
                 : launch<false, 1>(t, n, m, n_starts, bm, kt, k1, words, scd,
                                    (int*)slots, rows, (int*)ovf, bmb, th,
                                    device, s);
  else
    err = shared ? launch<true, 2>(t, n, m, n_starts, bm, kt, k1, words, scd,
                                   (int*)slots, rows, (int*)ovf, bmb, th,
                                   device, s)
                 : launch<false, 2>(t, n, m, n_starts, bm, kt, k1, words, scd,
                                    (int*)slots, rows, (int*)ovf, bmb, th,
                                    device, s);
  return (int)err;
}
