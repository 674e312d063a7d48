// Shared device code of the kernels that test packed window ids over runs
// of kRun consecutive starts per thread (exact_count.cu; the wid stages and
// the guard of stages.cu): the run's rolling window id, with its per-start
// path for dirty runs, and the pad guard as a mask of the entering bytes >=
// sigma smeared over the m starts whose window holds each.  Both give the
// run's 32 results as a hit mask (bit j: start j), which a kernel ANDs,
// then stores, counts or ranks (tile_pipeline.cuh).
//
// A run's bytes sit in a tile buffer b (16-byte aligned, shared memory) at
// offset p, with s = p % 16 uniform over the block: the entering bytes come
// from 16-byte loads funnel-shifted into place (words_at), so a start reads
// no byte from shared memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_pipeline.cuh"

namespace tsm {

// The 32 bytes at b + p + x as words (p % 16 == s).
__device__ __forceinline__ void entering(const uint8_t* b, int p, int s,
                                         int x, uint32_t (&in)[8]) {
  words_at(b, p + x, (s + x) & 15, in);
}

// The ids of the d-byte windows at offset off of the run's starts,
//     key = OR_j t[i+off+j] << bits*(d-1-j),
// each tested in the bitmap tab of `words` 32-bit words in shared memory (a
// key past it misses), as the run's hit mask.  On bytes below 2^bits the id
// rolls, id = id * 2^bits + t[i+off+d-1] and key = id & (2^(d*bits) - 1), one
// multiply-add per start; a run holding a byte >= 2^bits, or a bitmap
// smaller than 2^(d*bits) bits, takes a per-start loop of the OR key, so
// any bytes stay exact.  d * bits <= 16.
__device__ __forceinline__ uint32_t wid_run(const uint32_t* tab, int words,
                                            const uint8_t* b, int p, int s,
                                            int off, int d, int bits) {
  const uint32_t nbits = (uint32_t)words * 32u;
  const uint32_t radix = 1u << bits, kmask = (1u << (d * bits)) - 1u;
  // a byte >= 2^bits in any lane of a word
  const uint32_t dirty_bytes = 0x01010101u * (0xFFu & ~(radix - 1u));
  uint32_t in[8];                    // bytes [off+d-1, off+d+31) of the run
  entering(b, p, s, off + d - 1, in);
  uint32_t dirty = nbits <= kmask;   // a key may fall past the bitmap
#pragma unroll
  for (int k = 0; k < 8; ++k) dirty |= in[k] & dirty_bytes;
  uint32_t key = 0;
  for (int j = 0; j < d - 1; ++j) {  // the first window's first d-1 bytes
    const uint32_t c = b[p + off + j];
    dirty |= c >> bits;
    key = key * radix + c;
  }
  uint32_t hits = 0;
  if (!dirty) {
    // on bytes below 2^bits, key * 2^bits + byte is (key << bits) | byte
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      key = key * radix + byte_of(in, j);
      hits |= smem_bit(tab, key & kmask) << j;
    }
  } else {
    for (int j = 0; j < kRun; ++j) {
      uint32_t k = 0;
      for (int i = 0; i < d; ++i) k = (k << bits) | b[p + off + j + i];
      hits |= (k < nbits ? smem_bit(tab, k) : 0u) << j;
    }
  }
  return hits;
}

// Four bytes of 0 or 0xFF (a __vcmpgeu4 result) as four bits.
__device__ __forceinline__ uint32_t bits4(uint32_t x) {
  return ((x & 0x01010101u) * 0x10204080u) >> 28;
}

// The pad guard over the run: the starts whose m-byte window holds no byte
// >= thr (0 <= thr <= 255; bytes compared as int, so a caller passes no
// guard for sigma >= 256).
__device__ __forceinline__ uint32_t guard_run(const uint8_t* b, int p, int s,
                                              int m, int thr) {
  int last = -1;                     // the first window's last such byte
  for (int j = 0; j < m - 1; ++j)
    if ((int)b[p + j] >= thr) last = j;
  uint32_t in[8];                    // bytes [m-1, m+31): byte m-1+j enters
  entering(b, p, s, m - 1, in);      // start j's window
  const uint32_t t4 = 0x01010101u * (uint32_t)thr;
  uint32_t enter = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) enter |= bits4(__vcmpgeu4(in[k], t4)) << (4 * k);
  // byte m-1+j lies in the windows of starts j .. j+m-1: smear each bit of
  // enter over the m bits from it up (r = OR of enter << t, t < c)
  uint32_t r = enter;
  for (int c = 1; c < m && c < 32;) {
    const int step = c < m - c ? c : m - c;
    r |= r << step;
    c += step;
  }
  const uint32_t first = last < 0 ? 0u : last >= 31 ? ~0u : (2u << last) - 1u;
  return ~(r | first);
}

}  // namespace tsm
