// Shared device code of the fingerprint-tier kernels (cascade.cu, filter.cu,
// stages.cu).
//
// Ports the key and stage code of the TPU filters: _bases_flat / _fp_keys_views
// (tpu_smatcher/ops/pallas_filter.py:519/:499), derived_keys (:316) and the
// stage ANDs of _candidates_flat (:530).
//
// For a window t[i..i+m) the three base fingerprints are
//     fp_s = sum_j t[i+j] * FP_MULTS[s]^j  mod 2^16      (s = 0, 1, 2)
// computed in uint32 and masked at the end: uint32 wraparound is exact mod
// 2^32, so the low 16 bits are exact for any m (the TPU's bf16 MXU keys and
// their f32-accumulation limit do not exist here).  Stage s tests bit
// key_s = (fp0 + C_s*fp1 + D_s*fp2) mod stage_bits of its bitmap; C, D <=
// 0xFFFF keep the uint32 sum exact mod stage_bits <= 2^18.
//
// Two ways to get the fingerprints:
//   - base_fps: Horner's rule over one window, 3m multiply-adds per start
//     (cascade.cu's phase 2 for a run's later survivors);
//   - Rolling: the multipliers are odd, so invertible mod 2^32, and
//         fp(i+1) = (fp(i) - t[i]) * M^-1 + t[i+m] * M^(m-1)
//     holds exactly in uint32.  A thread runs Horner once for the first
//     start of its run of consecutive starts (horner_fps, over a 16-byte
//     aligned window in shared memory, 16 bytes per load) and rolls the rest
//     in O(1): a subtract, a multiply and a multiply-add per fingerprint
//     (cascade.cu; filter.cu and stages.cu through fp_run_hits, for runs of
//     kRun starts at any byte offset).  Rolling::make computes M^-1 and
//     M^(m-1) on the host.
// Bitmaps are read through the read-only cache (__ldg), or from shared
// memory where a kernel stages them (stages_hit_shared).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_pipeline.cuh"

namespace tsm {

constexpr int kMaxStages = 32;   // len(STAGE_CD)
constexpr int kMaxM = 4097;      // MAX_FAST_M of the JAX fast path
constexpr uint32_t kMult0 = 0x9E37, kMult1 = 0x6A09, kMult2 = 0xB2D1;

// (C, D) of each stage, passed by value as a kernel parameter.
struct StageCD {
  uint32_t c[kMaxStages];
  uint32_t d[kMaxStages];
};

// Host: StageCD from a host array of 2*k uint32, (C_0, D_0, C_1, D_1, ...).
inline StageCD load_cd(const void* cd, int k) {
  StageCD scd = {};
  const uint32_t* h = (const uint32_t*)cd;
  for (int s = 0; s < k; ++s) {
    scd.c[s] = h[2 * s];
    scd.d[s] = h[2 * s + 1];
  }
  return scd;
}

inline bool valid_stage_bits(int stage_bits) {
  return stage_bits >= 32 && !(stage_bits & (stage_bits - 1));
}

struct BaseFps {
  uint32_t f0, f1, f2;
};

// The three base fingerprints of the m bytes at w.
__device__ __forceinline__ BaseFps base_fps(const uint8_t* w, int m) {
  uint32_t a = 0, b = 0, e = 0;
  for (int j = m - 1; j >= 0; --j) {
    uint32_t t = w[j];
    a = a * kMult0 + t;
    b = b * kMult1 + t;
    e = e * kMult2 + t;
  }
  return {a & 0xFFFFu, b & 0xFFFFu, e & 0xFFFFu};
}

__device__ __forceinline__ bool stage_hit(const uint32_t* __restrict__ bm,
                                          uint32_t key) {
  return (__ldg(bm + (key >> 5)) >> (key & 31)) & 1u;
}

// AND of stages [s0, s1), stopping at the first miss.  bitmaps: stage s at
// bitmaps + s * words (words = stage_bits / 32); smask = stage_bits - 1.
// (`&& ok` in the loop condition: an early return instead ran the cascade 6%
// slower on an H100, tpu_smatcher_torch/ab_cascade.py.)
__device__ __forceinline__ bool stages_hit(const BaseFps& f,
                                           const uint32_t* __restrict__ bitmaps,
                                           const StageCD& cd, int s0, int s1,
                                           int words, uint32_t smask) {
  bool ok = true;
  for (int s = s0; s < s1 && ok; ++s)
    ok = stage_hit(bitmaps + (size_t)s * words,
                   (f.f0 + cd.c[s] * f.f1 + cd.d[s] * f.f2) & smask);
  return ok;
}

// As stages_hit, with stages [s0, s1) at sbm + (s - s0) * words in shared
// memory.
__device__ __forceinline__ bool stages_hit_shared(uint32_t f0, uint32_t f1,
                                                  uint32_t f2,
                                                  const uint32_t* sbm,
                                                  const StageCD& cd, int s0,
                                                  int s1, int words,
                                                  uint32_t smask) {
  bool ok = true;
  const uint32_t* bm = sbm;
  for (int s = s0; s < s1 && ok; ++s, bm += words) {
    uint32_t key = (f0 + cd.c[s] * f1 + cd.d[s] * f2) & smask;
    ok = (bm[key >> 5] >> (key & 31)) & 1u;
  }
  return ok;
}

// The constants of the rolling update, per fingerprint: M^-1 mod 2^32 and
// M^(m-1) mod 2^32.  Passed by value as a kernel parameter.
struct Rolling {
  uint32_t inv[3];
  uint32_t top[3];

  static uint32_t inverse(uint32_t a) {    // a odd; Newton: 3 bits -> 48
    uint32_t x = a;                        // a * a == 1 mod 8
    for (int i = 0; i < 4; ++i) x *= 2u - a * x;
    return x;
  }

  static Rolling make(int m) {
    const uint32_t mult[3] = {kMult0, kMult1, kMult2};
    Rolling r;
    for (int s = 0; s < 3; ++s) {
      r.inv[s] = inverse(mult[s]);
      uint32_t p = 1;
      for (int j = 1; j < m; ++j) p *= mult[s];
      r.top[s] = p;
    }
    return r;
  }
};

// The three fingerprints (in uint32, not masked) of the m bytes at w, which
// is 16-byte aligned in shared memory: Horner's rule from the last byte, the
// bytes past the last whole 16 first, then 16 bytes per load.
__device__ __forceinline__ void horner_fps(const uint8_t* w, int m,
                                           uint32_t& a, uint32_t& b,
                                           uint32_t& e) {
  a = b = e = 0;
  const int whole = m & ~15;
  for (int j = m - 1; j >= whole; --j) {
    uint32_t t = w[j];
    a = a * kMult0 + t;
    b = b * kMult1 + t;
    e = e * kMult2 + t;
  }
  for (int c = whole - 16; c >= 0; c -= 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(w + c);
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 15; j >= 0; --j) {
      uint32_t t = (x[j >> 2] >> (8 * (j & 3))) & 0xFFu;
      a = a * kMult0 + t;
      b = b * kMult1 + t;
      e = e * kMult2 + t;
    }
  }
}

// One rolling step: from the fingerprints of t[i..i+m) to those of
// t[i+1..i+m+1), given out = t[i] and in = t[i+m].  Written as
// fp * M^-1 + (in * M^(m-1) - out * M^-1) so that the chain from one start
// to the next is a single multiply-add; the bracket does not depend on fp.
__device__ __forceinline__ void roll_fps(const Rolling& r, uint32_t out,
                                         uint32_t in, uint32_t& a,
                                         uint32_t& b, uint32_t& e) {
  a = a * r.inv[0] + (in * r.top[0] - out * r.inv[0]);
  b = b * r.inv[1] + (in * r.top[1] - out * r.inv[1]);
  e = e * r.inv[2] + (in * r.top[2] - out * r.inv[2]);
}

// ---------------------------------------------------------------------------
// a run of kRun starts through k fingerprint stages (filter.cu, stages.cu)
// ---------------------------------------------------------------------------

constexpr int kFpBranchFree = 3;   // stages tested without a branch

// The three fingerprints (in uint32, not masked) of the m bytes at b + p, b
// 16-byte aligned in shared memory and s = p % 16 uniform over the block:
// horner_fps where p is aligned; else Horner's rule from the last byte, the
// bytes past the last whole 16 one by one, then 16 bytes per step.
__device__ __forceinline__ void horner_at(const uint8_t* b, int p, int s,
                                          int m, uint32_t& f0, uint32_t& f1,
                                          uint32_t& f2) {
  if (s == 0) {
    horner_fps(b + p, m, f0, f1, f2);
    return;
  }
  f0 = f1 = f2 = 0;
  const int whole = m & ~15;
  for (int j = m - 1; j >= whole; --j) {
    const uint32_t t = b[p + j];
    f0 = f0 * kMult0 + t;
    f1 = f1 * kMult1 + t;
    f2 = f2 * kMult2 + t;
  }
  for (int c = whole - 16; c >= 0; c -= 16) {
    uint32_t x[4];
    words_at(b, p + c, s, x);
#pragma unroll
    for (int j = 15; j >= 0; --j) {
      const uint32_t t = byte_of(x, j);
      f0 = f0 * kMult0 + t;
      f1 = f1 * kMult1 + t;
      f2 = f2 * kMult2 + t;
    }
  }
}

// The candidates among the kRun starts whose windows begin at b + p, as bits
// (bit j: start j of the run): Horner's rule on the first window, then the
// fingerprints roll, the bytes leaving and entering the window funnel-shifted
// out of 16-byte loads.  Stages [0, ks) are in shared memory at sbm (ks >=
// min(k, kFpBranchFree)), the rest at bitmaps.  The first kFpBranchFree
// stages, which nearly every warp runs for nearly every start, are tested
// for every start without a branch; the rest only for a start that passed
// them and whose bit in `live` is set (the other stages of a chain), until
// the first miss.  A start outside `live` may come out set: the caller ANDs.
__device__ __forceinline__ uint32_t fp_run_hits(
    const uint8_t* b, int p, int s, int m, const uint32_t* sbm,
    const uint32_t* __restrict__ bitmaps, int k, int ks, int words,
    uint32_t smask, const StageCD& cd, const Rolling& roll, uint32_t live) {
  uint32_t f0, f1, f2;
  horner_at(b, p, s, m, f0, f1, f2);
  uint32_t outw[kRun / 4], inw[kRun / 4];   // the bytes leaving, entering
  words_at(b, p, s, outw);
  words_at(b, p + m, (s + m) & 15, inw);
  uint32_t c[kFpBranchFree], d[kFpBranchFree];
#pragma unroll
  for (int i = 0; i < kFpBranchFree; ++i) c[i] = cd.c[i], d[i] = cd.d[i];
  uint32_t hits = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const uint32_t a0 = f0 & 0xFFFFu, a1 = f1 & 0xFFFFu, a2 = f2 & 0xFFFFu;
    uint32_t ok = smem_bit(sbm, (a0 + c[0] * a1 + d[0] * a2) & smask);
#pragma unroll
    for (int i = 1; i < kFpBranchFree; ++i)
      if (k > i)
        ok &= smem_bit(sbm + i * words,
                       (a0 + c[i] * a1 + d[i] * a2) & smask);
    if (ok && ((live >> j) & 1u) && k > kFpBranchFree) {
      ok = stages_hit_shared(a0, a1, a2, sbm + kFpBranchFree * words, cd,
                             kFpBranchFree, ks, words, smask);
      if (ok && ks < k)
        ok = stages_hit({a0, a1, a2}, bitmaps, cd, ks, k, words, smask);
    }
    hits |= ok << j;
    if (j + 1 < kRun)
      roll_fps(roll, byte_of(outw, j), byte_of(inw, j), f0, f1, f2);
  }
  return hits;
}

}  // namespace tsm
