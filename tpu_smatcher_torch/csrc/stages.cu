// The named engines' stage chain on Hopper, in three modes.
//
// Replaces two TPU kernels of tpu_smatcher/ops/pallas_engines.py:
//   _stages_kernel       (:115, via _run_stages :163): the chain over the
//                        overlap tile, any stage kind, optional pad guard;
//   _stages_kernel_flat  (:213, via _run_stages_flat :270): the same chain
//                        over the flat layout, 'wid' and 'fpset' stages only,
//                        no guard.
// The flat layout is an artefact of the TPU (banded-matmul keys straight from
// 128-lane context views); here both are one kernel, and the wrapper counts
// its launches under the name of the TPU kernel it stands for.
//
// A start s < n - m + 1 is a candidate iff every stage of the chain hits
// (_stage_hit, pallas_engines.py:74-112):
//   wid(off, d, bits)  the packed id of chars [s+off, s+off+d), key =
//                      OR of t << bits*(d-1-j), hits a bitmap of `len`
//                      words (a key past it misses).  The TPU sums shifted
//                      bytes on the MXU; the two agree on in-alphabet text.
//   fpset(k, bits)     the k derived fingerprint stages of fp_filter.cuh
//                      over the window [s, s+m).
//   wm                 SHIFT[(t[s+m-3]*4 + t[s+m-2])*4 + t[s+m-1]] == 0,
//                      multiply-add with base 4 for every sigma (the table's
//                      builder hashes the same way).
//   sog(sigma)         for every i in 0..m-3, bit i of T[g(s+i)] is 0, with
//                      g(j) = t[j] + t[j+1]*sigma + t[j+2]*sigma^2.
// A wm or sog lookup past the table gives 0, as the TPU's banked lookup does
// (_value_lookup, :51): a 0 is a hit, so out-of-alphabet bytes make
// candidates and never reject one.  T is read as uint32 (bit 31 at m = 34).
// With the guard, a window holding a byte >= sigma is dropped (bytes
// compared as int, as in exact_count.cu: sigma = 256 drops nothing).
//
// Outputs, by mode:
//   count  one zeroed int32, += the candidates: a warp shuffle and one
//          atomicAdd per warp (the TPU carries a scalar across its grid);
//   mask   (rows, 128) int8, rows = ceil((n-m+1)/128), 0 past n-m+1;
//   slots  per 16,384-start sub-block, its first 16 candidates by position
//          (-1 where fewer) and its true candidate count, the layout of
//          filter.cu's slots mode (its word view comes from words.cu).
//
// What bounds it on an H100: integer issue, as for filter.cu.  The text is
// read once and the outputs are small; every stage needs O(1) work per start.
// The first design (one start per thread, each stage rebuilt from the
// window's bytes: Horner's rule over m bytes for the fp stages, m-2 lookups
// for sog, the guard rescanning the window; the text staged byte by byte)
// ran at 2-7% of its bound.  This design is filter.cu's:
//   - a thread owns a run of kRun = 32 consecutive starts; 512-thread blocks
//     in a persistent grid walk 16,384-start tiles (one slot sub-block), the
//     text staged by cp.async into two buffers so the next tile's copy
//     overlaps this tile's work, a view at any address copied from the
//     16-byte aligned address below it (tile_pipeline.cuh);
//   - each stage gives the run's 32 results as a hit mask, and the chain is
//     the AND of the masks, so the order of the stages changes nothing.
//     The bitmap, guard and fp stages roll over the run, so each start
//     costs O(1) whatever its hit:
//       wid    s = s * 2^bits + t[i+off+d-1], key = s & (2^(d*bits) - 1),
//              one multiply-add per start (wid_run.cuh's wid_run); a
//              run holding a byte >= 2^bits, or a bitmap smaller than
//              2^(d*bits) bits, takes a per-start loop of the OR key, so any
//              bytes stay exact;
//       fpset  fp_filter.cuh's fp_run_hits (Horner's rule once per run, then
//              rolling fingerprints; stages in shared memory while a block
//              stays within 112 KB, the first three tested without a
//              branch), its later stages only for starts the other stages
//              left alive;
//       guard  the bytes >= sigma entering the run's windows as a 32-bit
//              mask (__vcmpgeu4), smeared over the m starts whose window
//              holds each, and the last such byte of the first window
//              (wid_run.cuh's guard_run);
//     the value stages pass nearly every start on the bench sets (wm and
//     sog 1.000 at m = 8 and 32, DNA), so they come last where the other
//     stages leave few starts (chain_run):
//       sog    in front of an exact tier, a shift-or register E = (E << 1)
//              | T[g(j)] over the run's grams, E = 0 at the run's first
//              gram: start s hits iff bit m-3 of E is 0 after gram s+m-3
//              (bit m-3 then holds the OR of bit i of T[g(s+i)], i =
//              0..m-3), so a run costs 32 + m - 2 lookups where the first
//              design took 32 * (m - 2); behind the fp stages, m-2 lookups
//              for each start still live;
//       wm     one lookup for each start still live;
//   - the entering bytes of the rolling stages come from 16-byte
//     shared-memory loads, funnel-shifted into place (words_at);
//   - the six chain kinds EngineFastPath builds (kernel_for) are
//     instantiations of their own; any other chain the wrapper takes (up to
//     4 stages, at most one fpset) runs in a generic one, the same stage
//     code;
//   - count mode: __popc of the run's mask, a warp shuffle and one atomicAdd
//     per warp; mask mode: two 16-byte stores per run; slots mode: the
//     block-wide __popc prefix of tile_pipeline.cuh's rank_run_slots.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_filter.cuh"
#include "tile_pipeline.cuh"
#include "wid_run.cuh"

namespace {

using tsm::byte_of;
using tsm::kRun;
using tsm::kSlots;
using tsm::Rolling;
using tsm::StageCD;

constexpr int kThreads = 512;
constexpr int kTile = kThreads * kRun;   // starts per tile = one sub-block
constexpr int kMaxChain = 4;
constexpr int kMaxSmem = 232448;         // a block's shared memory on an H100
// Shared memory a block keeps to, so that two blocks (32 warps) fit on an SM.
constexpr int kSmemTarget = 112 * 1024;

// stage kinds (the wrapper's numbering), and two for the instantiations
enum Kind { kWid = 0, kFpset = 1, kWm = 2, kSog = 3, kNone = 4, kAny = 5 };
enum Mode { kCount = 0, kMask = 1, kSlotsMode = 2 };

struct Stage {
  int kind;
  int a, b, c;     // wid: off, d, bits; fpset: k, stage_bits; sog: sigma
  int len;         // wid: bitmap words; wm, sog: table entries
  int soff;        // the staged table's offset in shared memory (words)
  const uint32_t* table;
};

struct Chain {
  int n;
  Stage s[kMaxChain];
  int fp;          // the fpset stage's index, or -1
  int ks;          // its stages in shared memory, at s[fp].soff
  StageCD cd;      // its (C, D) pairs
  Rolling roll;
};

__host__ __device__ inline int buf_bytes(int m) {
  return tsm::run_buf_bytes(kTile, m);
}

__device__ __forceinline__ uint32_t lookup0(const uint32_t* tab, uint32_t len,
                                            uint32_t i) {
  return i < len ? tab[i] : 0u;
}

// wid(off, d, bits) over the run at b + p; tab: the bitmap in shared memory.
__device__ __forceinline__ uint32_t wid_stage(const Stage& st,
                                              const uint32_t* tab,
                                              const uint8_t* b, int p,
                                              int s) {
  return tsm::wid_run(tab, st.len, b, p, s, st.a, st.b, st.c);
}

// sog(sigma) over the run: the shift-or register over grams 0 .. m+30 of
// the run, checked at bit m-3 from gram m-3 on.
__device__ __forceinline__ uint32_t sog_run(const Stage& st,
                                            const uint32_t* tab,
                                            const uint8_t* b, int p, int s,
                                            int m) {
  const uint32_t sg = (uint32_t)st.c, sg2 = sg * sg, len = st.len;
  uint32_t x = b[p], y = b[p + 1], e = 0;
  for (int j = 0; j < m - 3; ++j) {  // grams 0 .. m-4: no start checked
    const uint32_t z = b[p + j + 2];
    e = (e << 1) | lookup0(tab, len, x + y * sg + z * sg2);
    x = y;
    y = z;
  }
  uint32_t in[8];                    // bytes [m-1, m+31): gram j's third
  tsm::entering(b, p, s, m - 1, in);
  const int top = m - 3;
  uint32_t hits = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const uint32_t z = byte_of(in, j);
    e = (e << 1) | lookup0(tab, len, x + y * sg + z * sg2);
    hits |= ((~e >> top) & 1u) << j;
    x = y;
    y = z;
  }
  return hits;
}

// A value stage (wm, sog) per start, for the starts in live only (a subset
// of live): wm's one lookup, or sog's m-2, stopping at a set bit.
template <int K>
__device__ __forceinline__ uint32_t value_starts(const Stage& st,
                                                 const uint32_t* tab,
                                                 const uint8_t* b, int p,
                                                 int m, uint32_t live) {
  const uint32_t sg = (uint32_t)st.c, sg2 = sg * sg, len = st.len;
  uint32_t hits = 0;
  for (uint32_t h = live; h; h &= h - 1) {
    const int j = __ffs(h) - 1;
    const uint8_t* w = b + p + j;
    bool ok;
    if constexpr (K == kWm) {
      ok = lookup0(tab, len, (w[m - 3] * 4u + w[m - 2]) * 4u + w[m - 1]) == 0;
    } else {
      ok = true;
      for (int i = 0; i + 2 < m && ok; ++i)
        ok = !((lookup0(tab, len, w[i] + w[i + 1] * sg + w[i + 2] * sg2) >> i)
               & 1u);
    }
    hits |= (uint32_t)ok << j;
  }
  return hits;
}

// The chain's hit mask over the run at b + p, in three steps (the AND does
// not depend on the order):
//   1. the guard (thr >= 0), the wid stages, and a sog stage of a chain
//      without an fp stage, each rolling over all 32 starts;
//   2. the fp stages, their later ones only for the starts still live;
//   3. per live start, the wm stage, and a sog stage of a chain with an fp
//      stage: the fp stages leave about 1 start in 10^4, and a start that
//      reaches a value stage pays a few lookups where the rolling register
//      costs every start one.  A wm stage's one lookup is worth deferring
//      behind an exact tier too (14% of starts live); sog's m-2 are not
//      (one-process A/B, H100: 0.94x and 1.78x).
// K0: stage 0's kind, kNone, or kAny (the generic chain: every stage by its
// kind); K1: the tier's (wid or fpset; kAny).
template <int K0, int K1>
__device__ __forceinline__ uint32_t chain_run(const Chain& ch,
                                              const uint32_t* smem,
                                              const uint8_t* b, int p, int s,
                                              int m, int thr) {
  uint32_t live = thr >= 0 ? tsm::guard_run(b, p, s, m, thr) : ~0u;
  const bool fp = ch.fp >= 0;
  if constexpr (K0 == kAny) {
    for (int i = 0; i < ch.n; ++i) {
      const Stage& st = ch.s[i];
      if (st.kind == kWid)
        live &= wid_stage(st, smem + st.soff, b, p, s);
      else if (st.kind == kSog && !fp)
        live &= sog_run(st, smem + st.soff, b, p, s, m);
    }
  } else if constexpr (K0 == kWid) {
    live &= wid_stage(ch.s[0], smem + ch.s[0].soff, b, p, s);
  } else if constexpr (K0 == kSog && K1 == kWid) {
    live &= sog_run(ch.s[0], smem + ch.s[0].soff, b, p, s, m);
  }
  if constexpr (K1 == kWid) {
    const Stage& st = ch.s[ch.n - 1];
    live &= wid_stage(st, smem + st.soff, b, p, s);
  }
  if constexpr (K1 == kFpset || K1 == kAny) {
    if (fp && live) {
      const Stage& st = ch.s[ch.fp];
      live &= tsm::fp_run_hits(b, p, s, m, smem + st.soff, st.table, st.a,
                               ch.ks, st.b / 32, (uint32_t)(st.b - 1), ch.cd,
                               ch.roll, live);
    }
  }
  if constexpr (K0 == kAny) {
    for (int i = 0; i < ch.n && live; ++i) {
      const Stage& st = ch.s[i];
      if (st.kind == kWm)
        live = value_starts<kWm>(st, smem + st.soff, b, p, m, live);
      else if (st.kind == kSog && fp)
        live = value_starts<kSog>(st, smem + st.soff, b, p, m, live);
    }
  } else if constexpr (K0 == kWm || (K0 == kSog && K1 == kFpset)) {
    if (live)
      live = value_starts<K0>(ch.s[0], smem + ch.s[0].soff, b, p, m, live);
  }
  return live;
}

// text: the 16-byte aligned address at or below the view, whose start count
// is n_starts and whose first byte is text[shift]; n: the view's length plus
// shift.  thr: the guard's threshold, or -1 without the guard.  tab_bytes:
// the staged tables' shared memory (16-byte multiple), then the two text
// buffers.  Count mode adds to count, mask mode writes mask (n_out = R*128
// entries), slots mode pos and counts (one entry per tile).
// No minimum of blocks per SM: asking for two (64 registers a thread) ran
// the exact-tier chains 3-9% slower and the fp chains at most 1% faster
// (one-process A/B, H100).
template <int K0, int K1>
__global__ void __launch_bounds__(kThreads) stages_kernel(
    const uint8_t* __restrict__ text, long long n, int shift, int m, int thr,
    int mode, long long n_starts, long long n_out, long long tiles, Chain ch,
    int tab_bytes, int* __restrict__ count, int8_t* __restrict__ mask,
    int* __restrict__ pos, int* __restrict__ counts) {
  extern __shared__ uint4 smem4[];
  __shared__ int wsum[kThreads / 32];            // slots mode: warp totals
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  uint8_t* bufs = reinterpret_cast<uint8_t*>(smem4) + tab_bytes;
  for (int i = 0; i < ch.n; ++i) {
    const Stage& st = ch.s[i];
    const int words = st.kind == kFpset ? ch.ks * (st.b / 32) : st.len;
    for (int j = threadIdx.x; j < words; j += kThreads)
      smem[st.soff + j] = __ldg(st.table + j);
  }
  const int blen = buf_bytes(m);
  const int off = threadIdx.x * kRun;            // the run's first start
  int cnt = 0;

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
      hits = chain_run<K0, K1>(ch, smem, bufs + (it & 1) * blen, shift + off,
                               shift, m, thr);
      const long long valid = n_starts - i0;
      if (valid < kRun) hits &= (1u << valid) - 1u;
    }
    if (mode == kCount) {
      cnt += __popc(hits);
    } else if (mode == kMask) {
      if (i0 < n_out)                  // n_out is a multiple of kRun
        tsm::store_run_mask(mask + i0, hits);
    } else {
      tsm::rank_run_slots<kThreads>(hits, i0, pos + tile * kSlots,
                                    counts + tile, wsum);
    }
    __syncthreads();                   // buffer and wsum free for reuse
  }
  if (mode == kCount) {
    for (int d = 16; d > 0; d >>= 1)
      cnt += __shfl_down_sync(0xffffffffu, cnt, d);
    if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(count, cnt);
  }
}

using Kernel = decltype(&stages_kernel<kNone, kWid>);

// The instantiation for a chain: its own for each chain kind EngineFastPath
// builds ([wid]; [wid, fpset]; [wm or sog, wid or fpset]), else the generic
// one.  On the engines' own calls the generic one ran 10-13% slower at m = 8
// and 1-3% at m = 32, against a spread of 0.6% (one-process A/B, H100).
Kernel kernel_for(const Chain& ch) {
  const int t = ch.s[ch.n - 1].kind;
  if (ch.n == 1 && t == kWid) return stages_kernel<kNone, kWid>;
  if (ch.n == 2 && (t == kWid || t == kFpset)) {
    const bool fp = t == kFpset;
    switch (ch.s[0].kind) {
      case kWid:
        if (fp) return stages_kernel<kWid, kFpset>;
        break;
      case kWm: return fp ? stages_kernel<kWm, kFpset>
                          : stages_kernel<kWm, kWid>;
      case kSog: return fp ? stages_kernel<kSog, kFpset>
                           : stages_kernel<kSog, kWid>;
      default: break;
    }
  }
  return stages_kernel<kAny, kAny>;
}

// The chain from the host's descriptors, with each table's offset in shared
// memory; returns the shared memory of the staged tables (bytes, a 16-byte
// multiple), or -1 if a descriptor is invalid.
long long load_chain(const int* desc, const void* const* tables,
                     int n_stages, const void* cd, int m, Chain* ch) {
  if (n_stages < 1 || n_stages > kMaxChain) return -1;
  *ch = Chain{};
  ch->n = n_stages;
  ch->fp = -1;
  long long words = 0;
  for (int i = 0; i < n_stages; ++i) {
    Stage& st = ch->s[i];
    st.kind = desc[5 * i];
    st.a = desc[5 * i + 1];
    st.b = desc[5 * i + 2];
    st.c = desc[5 * i + 3];
    st.len = desc[5 * i + 4];
    st.table = (const uint32_t*)tables[i];
    st.soff = (int)words;
    switch (st.kind) {
      case kWid:
        if (st.a < 0 || st.b < 1 || st.a + st.b > m || st.c < 1 ||
            st.b * st.c > 16 || st.len < 1)
          return -1;
        words += st.len;
        break;
      case kFpset:
        if (st.a < 1 || st.a > tsm::kMaxStages ||
            !tsm::valid_stage_bits(st.b) || ch->fp >= 0 || !cd)
          return -1;
        ch->fp = i;
        ch->cd = tsm::load_cd(cd, st.a);
        break;
      case kWm:
        if (m < 3 || st.len < 1) return -1;
        words += st.len;
        break;
      case kSog:
        if (m < 3 || m > 34 || st.c < 1 || st.c > 256 || st.len < 1)
          return -1;
        words += st.len;
        break;
      default:
        return -1;
    }
  }
  if (ch->fp >= 0) {
    // the fp stages after the other tables: as many as keep the block within
    // kSmemTarget, and the ones tested without a branch in any case
    Stage& st = ch->s[ch->fp];
    const long long fw = st.b / 32;
    long long ks = (kSmemTarget - 2LL * buf_bytes(m) - words * 4) / (fw * 4);
    if (ks < tsm::kFpBranchFree) ks = tsm::kFpBranchFree;
    if (ks > st.a) ks = st.a;
    ch->ks = (int)ks;
    ch->roll = Rolling::make(m);
    st.soff = (int)words;
    words += ks * fw;
  }
  return (words * 4 + 15) / 16 * 16;
}

}  // namespace

// desc: host array of 5 int32 per stage, (kind, a, b, c, len) as in Stage;
// tables: host array of one device pointer per stage (fpset: k stages of
// stage_bits bits each, contiguous); cd: host array of 2*k uint32 (C_0, D_0,
// C_1, ...) for the fpset stage, or null.  mode 0 (count): out0 is one
// zeroed int32; mode 1 (mask): out0 is (rows, 128) int8, 16-byte aligned,
// with rows = n_out = ceil((n-m+1)/128); mode 2 (slots): out0 is (n_sub, 16)
// int32 positions and out1 (n_sub,) int32 counts, n_sub = n_out =
// ceil((n-m+1)/16384).  Every output entry is written.  Requires n >= m.
extern "C" int tsm_stages(const void* text, long long n, int m, int sigma,
                          int guard, int mode, const void* desc,
                          const void* tables, int n_stages, const void* cd,
                          void* out0, void* out1, long long n_out,
                          int device, void* stream) {
  if (m < 1 || m > tsm::kMaxM || n < m) return (int)cudaErrorInvalidValue;
  Chain ch;
  const long long tab_bytes = load_chain(
      (const int*)desc, (const void* const*)tables, n_stages, cd, m, &ch);
  if (tab_bytes < 0) return (int)cudaErrorInvalidValue;
  const long long n_starts = n - m + 1;
  const long long tiles = (n_starts + kTile - 1) / kTile;
  if (mode == kMask) {
    if (n_out != (n_starts + 127) / 128 || ((uintptr_t)out0 & 15))
      return (int)cudaErrorInvalidValue;
  } else if (mode == kSlotsMode) {
    if (n_out != tiles) return (int)cudaErrorInvalidValue;
  } else if (mode != kCount) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)tab_bytes + 2 * (size_t)buf_bytes(m);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // sigma >= 256: no byte reaches it; sigma <= 0: every byte does
  const int thr = guard && sigma < 256 ? (sigma > 0 ? sigma : 0) : -1;
  const int shift = (int)((uintptr_t)text & 15);
  const Kernel kernel = kernel_for(ch);
  int grid = 0;
  err = tsm::persistent_grid(kernel, kThreads, smem, tiles, device, &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)text - shift, n + shift, shift, m, thr, mode, n_starts,
      mode == kMask ? n_out * 128 : 0, tiles, ch, (int)tab_bytes, (int*)out0,
      (int8_t*)out0, (int*)out0, (int*)out1);
  return (int)cudaGetLastError();
}
