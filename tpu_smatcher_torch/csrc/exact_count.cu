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
// enters the window.  Measured (H100, 256 MiB, m=8): the bitmap design ran
// ~643 instructions a 32-start run at ~2.5 a cycle of an SM's 4, so the
// instruction rate set its pace, not the bytes nor shared memory: reading
// the bitmap at a lane-private word (no bank conflict) gained nothing, and
// no read at all 17%.  Of the run, the 32 lookups were 359 instructions,
// the next tile's copy with its bounds tests ~97, picking the window's
// words at a run-time offset ~60-120 and the first window's m-1 byte loads
// ~55.  The pair path's run takes ~195 for its 32 lookups' loop, and the
// kernel ~0.19 ms at 256 MiB, m=8, where the bitmap design took ~0.28.
//
// The three are one kernel template (exact_kernel), built for that bound:
//   - a thread owns a run of kRun = 32 consecutive starts; its window ids
//     roll, one multiply-add per start, and its hits come out as a 32-bit
//     mask (wid_run.cuh's wid_run, shared with stages.cu's wid stages; a
//     run holding a byte >= 2^bits, or a bitmap smaller than 2^(m*bits)
//     bits, takes a per-start loop of the ORed id, so any bytes stay exact);
//   - the pair path, where the (m+1)-gram ids fit kPairBits = 18 bits and
//     the bitmap covers every window id (DNA m <= 8, sigma 8 m <= 5, sigma
//     16 m <= 3, sigma 64 m <= 2, any sigma m = 1): each block builds from
//     the staged bitmap a table of 2-bit entries, one per (m+1)-gram g:
//     bm[g >> bits] (the window at g's first byte) and bm[g & kmask] (the
//     window one byte on), 64 KB at 18 bits, a word from two bitmap words
//     (build_pairs), so one lookup answers two starts.  A run takes its 48
//     bytes as one window of four 16-byte loads whose word offset is a
//     template argument (it is fixed for a launch), pulls bytes with byte
//     permutes, rolls the (m+1)-gram id two bytes a lookup and rotates the
//     entry into place (pair_run, ~10 instructions a pair); its guard comes
//     from the same window.  A run holding a byte >= 2^bits takes wid_run.
//     Past 18 bits the kernel keeps the bitmap path;
//   - the guard is a mask too: the run's entering bytes >= sigma
//     (__vcmpgeu4), each smeared over the m starts whose window holds it,
//     and the starts up to the first window's last such byte (wid_run.cuh's
//     guard_run; on the pair path the same from the run's window).  A byte
//     in [sigma, 2^bits) is dropped by the guard and rolls as any other;
//     sigma >= 256 has no guard work;
//   - a persistent grid walks tiles of 8192 starts, the next tile's text
//     copied in by 16-byte cp.async while this one is tested
//     (tile_pipeline.cuh), without bounds tests but in the last tile; a
//     text at an address that is not 16-byte aligned (a positions piece is
//     a view at any offset) is copied from the aligned address below it,
//     which lies in the same allocation, and its tile sits `shift` bytes
//     into the buffer.  A positions piece (~231K starts) fills 29 blocks;
//     4096-start tiles ran no faster there nor at 256 MiB (one-process A/B,
//     H100);
//   - the count adds the runs' __popc, then a warp shuffle and one atomicAdd
//     per warp; the mask stores each run as two 16-byte stores.
// The first design (one start per thread over a tile staged byte by byte,
// each id and the guard's max rebuilt from the window's m bytes) ran the
// guarded count and the mask at 7-13% of their bounds on an H100.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_pipeline.cuh"
#include "wid_run.cuh"

namespace {

using tsm::kRun;

// threads a block on the bitmap path and on the pair path, whose 64 KB
// table leaves room for two blocks an SM: 512 threads keep 32 warps there
constexpr int kThreads = 256;
constexpr int kPairThreads = 512;
constexpr int kMaxM = 16;                // m*bits <= 16 and bits >= 1
constexpr int kMaxSmem = 232448;         // a block's shared memory on an H100
constexpr int kPairBits = 18;            // widest (m+1)-gram id of a table
constexpr int kLead = 16;                // window bytes before byte m-1

enum Mode { kCount = 0, kCountGuard = 1, kMask = 2 };

// The pair path's shape rule: the (m+1)-gram ids fit kPairBits bits and the
// bitmap covers every window id (ops/cuda_filter.exact_pairs mirrors it).
bool pairs_fit(int m, int bits, int nwords) {
  return bits * (m + 1) <= kPairBits &&
         (long long)nwords * 32 >= (1LL << (m * bits));
}

// Words of the pair table: 2^(bits*(m+1)) entries of 2 bits, at least one.
int pair_words(int m, int bits) {
  const int gb = bits * (m + 1);
  return gb > 4 ? 1 << (gb - 4) : 1;
}

// Block-wide: the pair table tab of `words` words from the bitmap bm.
// Entry g, an (m+1)-gram id (gb = bits*(m+1) bits), sits at bits 2(g%16)
// and 2(g%16)+1 of word g/16: bm[g >> bits], the window at the gram's first
// byte, and bm[g & kmask], the window one byte on.  A word is built from
// two bitmap words: its 16 low ids are 16 consecutive bits of bm, and its
// ids g >> bits are c = max(1, 16 >> bits) consecutive bits, each standing
// for 16/c entries.  Below 8 bits of gram (a table of at most 16 words)
// entry by entry, each g taken mod 2^gb, so that a lookup may leave bits
// above gb in its index.
template <int kBlock>
__device__ __forceinline__ void build_pairs(uint32_t* tab, int words,
                                            const uint32_t* bm, int m,
                                            int bits) {
  const int gb = bits * (m + 1), kb = bits * m;
  const uint32_t kmask = (1u << kb) - 1u;
  if (gb < 8) {
    const uint32_t gmask = (1u << gb) - 1u;
    for (int w = threadIdx.x; w < words; w += kBlock) {
      uint32_t v = 0;
      for (int e = 0; e < 16; ++e) {
        const uint32_t g = ((uint32_t)w * 16u + e) & gmask;
        v |= (tsm::smem_bit(bm, g >> bits) |
              tsm::smem_bit(bm, g & kmask) << 1) << (2 * e);
      }
      tab[w] = v;
    }
    return;
  }
  for (int w = threadIdx.x; w < words; w += kBlock) {
    // bit 1 of entry e: bit 16w + e of bm, mod 2^kb (kb >= 4 here)
    const uint32_t lo0 = ((uint32_t)w << 4) & kmask;
    uint32_t z = (bm[lo0 >> 5] >> (lo0 & 16u)) & 0xFFFFu;
    z = (z | z << 8) & 0x00FF00FFu;      // 16 bits to the odd positions
    z = (z | z << 4) & 0x0F0F0F0Fu;
    z = (z | z << 2) & 0x33333333u;
    z = (z | z << 1) & 0x55555555u;
    // bit 0: bits (16w + e) >> bits of bm, c of them from hi0
    const uint32_t hi0 = ((uint32_t)w << 4) >> bits;
    uint32_t h;
    if (bits >= 4) {
      h = 0u - tsm::smem_bit(bm, hi0);
    } else {
      const int c = 16 >> bits;
      const uint32_t x = (bm[hi0 >> 5] >> (hi0 & 31u)) & ((1u << c) - 1u);
      if (bits == 3)        // 2 ids, 8 entries each
        h = ((x & 1u) | (x & 2u) << 15) * 0xFFFFu;
      else if (bits == 2)   // 4 ids, 4 entries each
        h = ((x * 0x00204081u) & 0x01010101u) * 0xFFu;
      else {                // 8 ids, 2 entries each
        uint32_t y = (x | x << 12) & 0x000F000Fu;
        y = (y | y << 6) & 0x03030303u;
        h = ((y | y << 3) & 0x11111111u) * 0xFu;
      }
    }
    tab[w] = (h & 0x55555555u) | z << 1;
  }
}

// A tile's text into buf as tsm::stage_tile copies it, without its 64-bit
// bounds tests (~25 instructions a 16-byte copy) where the tile's buffer
// lies wholly inside the text: every tile but the last.
template <int kBlock>
__device__ __forceinline__ void stage(uint8_t* buf,
                                     const uint8_t* __restrict__ text,
                                     long long n, long long base, int len) {
  if (base + len <= n) {
    const uint8_t* src = text + base;
    for (int c = threadIdx.x; c < len / 16; c += kBlock)
      tsm::cp_async16(buf + 16 * c, src + 16 * c, 16);
  } else {
    tsm::stage_tile<kBlock>(buf, text, n, base, len, true);
  }
}

// The pair path's run, as the kernel's three modes share it.  The run's
// bytes come as one window of 48 from its byte m-1-kLead: four aligned
// 16-byte loads from the chunk holding that byte, funnel-shifted by rb bits
// into 12 words, kQ (its word in the chunk, uniform over the launch) a
// template argument so that no word is picked at run time; so the first
// m-1 bytes cost no byte load.  dirty: the run holds a byte >= 2^bits at or
// past its byte 0 (dm: the dirty-byte masks of the window's first four
// words, 0 over the bytes before the run); the caller then takes wid_run.
// guard (thr >= 0): the starts whose window holds no byte >= thr, from the
// same window.  Else the hit mask (bit j: start j): the id rolls over the
// window's first kLead bytes, of which those before the run's byte 0 (bytes
// of the tile before it, or of the shared memory before the buffer) leave
// the low bits*(m+1) bits of the id, the only ones read, untouched (a
// product and a sum carry upward only), then two bytes a pair; one lookup
// in tab (twm: its words - 1) answers starts j and j+1, the word rotated so
// that the entry's two bits land at bits j, j+1.  radix = 2^bits, passed
// in as a value so that the roll is one multiply-add.  m <= kLead + 1.
template <int kQ>
__device__ __forceinline__ uint32_t pair_run(
    const uint32_t* tab, uint32_t twm, const uint8_t* b, int x, int rb,
    int m, uint32_t radix, int thr, const uint32_t (&dm)[4],
    uint32_t& dirty, uint32_t& guard) {
  const uint4* c = reinterpret_cast<const uint4*>(b) + (x >> 4);
  uint32_t raw[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint4 h = c[i];
    raw[4 * i] = h.x, raw[4 * i + 1] = h.y, raw[4 * i + 2] = h.z,
    raw[4 * i + 3] = h.w;
  }
  uint32_t w[12];
#pragma unroll
  for (int k = 0; k < 12; ++k)
    w[k] = __funnelshift_r(raw[kQ + k], raw[kQ + k + 1], rb);
  const uint32_t dirty_bytes = 0x01010101u * (0xFFu & ~(radix - 1u));
  dirty = (w[0] & dm[0]) | (w[1] & dm[1]) | (w[2] & dm[2]) | (w[3] & dm[3]) |
          ((w[4] | w[5] | w[6] | w[7] | w[8] | w[9] | w[10] | w[11]) &
           dirty_bytes);
  guard = ~0u;
  if (thr >= 0) {
    const uint32_t t4 = 0x01010101u * (uint32_t)thr;
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      lo |= tsm::bits4(__vcmpgeu4(w[k], t4)) << (4 * k);
#pragma unroll
    for (int k = 8; k < 12; ++k)
      hi |= tsm::bits4(__vcmpgeu4(w[k], t4)) << (4 * (k - 8));
    // window byte kLead+1-m is the run's byte 0; start j's window holds
    // bytes j .. j+m-1: smear each such byte over the m starts below it
    uint64_t r = ((uint64_t)hi << 32 | lo) >> (kLead + 1 - m);
    for (int c = 1; c < m;) {
      const int step = c < m - c ? c : m - c;
      r |= r >> step;
      c += step;
    }
    guard = ~(uint32_t)r;
  }
  if (dirty) return 0;
  uint32_t key = 0;
  if (m > kLead / 2 + 1) {
#pragma unroll
    for (int j = 0; j < kLead / 2; ++j)
      key = key * radix + __byte_perm(w[j >> 2], 0, 0x4440 | (j & 3));
  }
#pragma unroll
  for (int j = kLead / 2; j < kLead; ++j)
    key = key * radix + __byte_perm(w[j >> 2], 0, 0x4440 | (j & 3));
  uint32_t hits = 0;
#pragma unroll
  for (int j = 0; j < kRun; j += 2) {
    const int i = kLead + j;             // bytes i, i+1: words i/4, even
    key = key * radix + __byte_perm(w[i >> 2], 0, 0x4440 | (i & 3));
    key = key * radix + __byte_perm(w[i >> 2], 0, 0x4441 | (i & 3));
    // entry g = key mod 2^gb at bits 2(g%16) of word g/16: rotated right
    // by 2g - j (mod 32) it sits at bits j, j+1
    const uint32_t e = tab[(key >> 4) & twm];
    hits |= __funnelshift_r(e, e, 2u * key + (32u - j)) & (3u << j);
  }
  return hits;
}

// text: the 16-byte aligned address at or below the view, whose start count
// is n_starts and whose first byte is text[shift]; n: the view's length plus
// shift.  thr: the guard's threshold, or -1 without the guard.  twords: the
// pair table's words, or 0 for the bitmap path; radix: 2^bits.  The dynamic
// shared memory holds the pair table, the bitmap, then the two text
// buffers.  Count modes add to count; mask mode writes mask (n_out = R*128
// entries, 0 past n_starts).
template <int kMode, bool kPairs>
__global__ void __launch_bounds__(kPairs ? kPairThreads : kThreads)
exact_kernel(
    const uint8_t* __restrict__ text, long long n, int shift, int m,
    int bits, int thr, long long n_starts, long long n_out, long long tiles,
    const uint32_t* __restrict__ bitmap, int nwords, int twords,
    uint32_t radix, int* __restrict__ count, int8_t* __restrict__ mask) {
  extern __shared__ uint4 smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);       // twords
  uint32_t* sbits = tab + (twords + 3) / 4 * 4;            // nwords
  uint8_t* bufs = reinterpret_cast<uint8_t*>(sbits) + (nwords + 3) / 4 * 16;
  constexpr int kBlock = kPairs ? kPairThreads : kThreads;
  constexpr int kTile = kBlock * kRun;           // starts per tile
  for (int i = threadIdx.x; i < nwords; i += kBlock)
    sbits[i] = __ldg(bitmap + i);
  const int blen = tsm::run_buf_bytes(kTile, m);
  const int off = threadIdx.x * kRun;            // the run's first start
  int cnt = 0;

  long long tile = blockIdx.x;
  stage<kBlock>(bufs, text, n, tile * kTile, blen);
  tsm::cp_async_commit();
  // the pair path: the table from the staged bitmap, while the first tile
  // is copied in; the dirty-byte masks of the window's first four words;
  // the window's place in its chunk (word q, bit rb), uniform over the
  // launch: a run's first start is shift + 32k
  uint32_t dm[4] = {0u, 0u, 0u, 0u};
  const int wq = ((shift + m - 1 - kLead) & 15) >> 2;
  const int rb = ((shift + m - 1 - kLead) & 3) * 8;
  const int pthr = kMode != kCount ? thr : -1;
  if (kPairs) {
    __syncthreads();
    build_pairs<kBlock>(tab, twords, sbits, m, bits);
    const uint32_t dirty_bytes = 0x01010101u * (0xFFu & ~((1u << bits) - 1u));
#pragma unroll
    for (int k = 0; k < 4; ++k) {        // window bytes >= kLead + 1 - m
      const int before = kLead + 1 - m - 4 * k;
      dm[k] = before <= 0 ? dirty_bytes
              : before >= 4 ? 0u : dirty_bytes & (~0u << (8 * before));
    }
  }
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < tiles)
      stage<kBlock>(bufs + ((it + 1) & 1) * blen, text, n, next * kTile,
                    blen);
    tsm::cp_async_commit();
    tsm::cp_async_wait_prev();
    __syncthreads();

    const long long i0 = tile * kTile + off;
    uint32_t hits = 0;
    if (i0 < n_starts) {
      const uint8_t* b = bufs + (it & 1) * blen;
      const int p = shift + off;
      if (kPairs) {
        const uint32_t twm = (uint32_t)twords - 1u;
        const int x = p + m - 1 - kLead;   // the window's first byte
        uint32_t dirty, guard;
        switch (wq) {
          case 0: hits = pair_run<0>(tab, twm, b, x, rb, m, radix, pthr, dm,
                                     dirty, guard); break;
          case 1: hits = pair_run<1>(tab, twm, b, x, rb, m, radix, pthr, dm,
                                     dirty, guard); break;
          case 2: hits = pair_run<2>(tab, twm, b, x, rb, m, radix, pthr, dm,
                                     dirty, guard); break;
          default: hits = pair_run<3>(tab, twm, b, x, rb, m, radix, pthr, dm,
                                      dirty, guard);
        }
        if (dirty) hits = tsm::wid_run(sbits, nwords, b, p, shift, 0, m, bits);
        hits &= guard;
      } else {
        hits = tsm::wid_run(sbits, nwords, b, p, shift, 0, m, bits);
        if (kMode != kCount && thr >= 0)
          hits &= tsm::guard_run(b, p, shift, m, thr);
      }
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
// guard's threshold, the path (the pair table where pairs_fit holds: its
// own instantiation and block size, so that the bitmap path keeps its
// registers and its 64 warps an SM) and the persistent grid.
int launch(int mode, const void* text, long long n, int m, int bits,
           int sigma, const void* bitmap, int nwords, int* count,
           int8_t* mask, long long n_out, int device, void* stream) {
  const bool pairs = pairs_fit(m, bits, nwords);
  const int threads = pairs ? kPairThreads : kThreads;
  const int tile = threads * kRun;
  const long long n_starts = n - m + 1;
  const long long tiles = (n_starts + tile - 1) / tile;
  const int twords = pairs ? pair_words(m, bits) : 0;
  const size_t smem = (size_t)(twords + 3) / 4 * 16 +
                      (size_t)(nwords + 3) / 4 * 16 +
                      2 * (size_t)tsm::run_buf_bytes(tile, m);
  if (nwords < 1 || smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // sigma >= 256: no byte reaches it; sigma <= 0: every byte does
  const int thr =
      mode != kCount && sigma < 256 ? (sigma > 0 ? sigma : 0) : -1;
  const int shift = (int)((uintptr_t)text & 15);
  auto kernel =
      pairs ? (mode == kCount        ? exact_kernel<kCount, true>
               : mode == kCountGuard ? exact_kernel<kCountGuard, true>
                                     : exact_kernel<kMask, true>)
            : (mode == kCount        ? exact_kernel<kCount, false>
               : mode == kCountGuard ? exact_kernel<kCountGuard, false>
                                     : exact_kernel<kMask, false>);
  int grid = 0;
  err = tsm::persistent_grid(kernel, threads, smem, tiles, device, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)text - shift, n + shift, shift, m, bits, thr, n_starts,
      n_out, tiles, (const uint32_t*)bitmap, nwords, twords, 1u << bits,
      count, mask);
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
