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
// candidates and never reject one.  T is read as uint32 (bit 31 of sog32).
// With the guard, a window holding a byte >= sigma is dropped (the running
// max compared as int, as in exact_count.cu: sigma = 256 drops nothing).
//
// Outputs, by mode:
//   count  one zeroed int32, += the candidates: a warp shuffle and one
//          atomicAdd per warp (the TPU carries a scalar across its grid);
//   mask   (rows, 128) int8, rows = ceil((n-m+1)/128), 0 past n-m+1;
//   slots  per 16,384-start sub-block, its first 16 candidates by position
//          (-1 where fewer) and its true candidate count, the layout of
//          filter.cu's slots mode (its word view comes from words.cu).
//
// What bounds it on an H100: integer ALU, as for filter.cu.  The design is
// the simple one: the small tables of the chain (wid bitmaps of at most 8 KB,
// the WM SHIFT and SOG T tables of at most 4,096 entries) are staged in
// shared memory once per block; each block walks 16,384-start tiles
// (grid-stride) with the tile's bytes plus the (m-1)-byte halo in shared
// memory; a thread takes one start per step and evaluates the chain stage
// by stage, stopping at the first miss.  The sog stage is m-2 lookups per
// start here, where a shift-or register needs O(1); the fp stages' tables
// do not fit shared memory at p = 100k and come through __ldg.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_filter.cuh"

namespace {

using tsm::BaseFps;
using tsm::StageCD;

constexpr int kThreads = 256;
constexpr int kTile = 16384;        // starts per tile = one slot sub-block
constexpr int kSlots = 16;          // BLOCK_SLOTS
constexpr int kMaxChain = 4;
constexpr int kMaxSmem = 232448;    // a block's shared memory on an H100

enum Kind { kWid = 0, kFpset = 1, kWm = 2, kSog = 3 };
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
  StageCD cd;      // the fpset stage's (C, D) pairs
};

__device__ __forceinline__ uint32_t lookup0(const uint32_t* tab, int len,
                                            uint32_t i) {
  return i < (uint32_t)len ? tab[i] : 0u;
}

__device__ __forceinline__ bool stage_hit(const Stage& st, const Chain& ch,
                                          const uint8_t* w, int m,
                                          const uint32_t* smem) {
  const uint32_t* tab = smem + st.soff;
  switch (st.kind) {
    case kWid: {
      uint32_t key = 0;
      for (int j = 0; j < st.b; ++j) key = (key << st.c) | w[st.a + j];
      return key < (uint32_t)st.len * 32u &&
             ((tab[key >> 5] >> (key & 31)) & 1u);
    }
    case kFpset: {
      BaseFps f = tsm::base_fps(w, m);
      return tsm::stages_hit(f, st.table, ch.cd, 0, st.a, st.b / 32,
                             (uint32_t)(st.b - 1));
    }
    case kWm: {
      uint32_t h = ((uint32_t)w[m - 3] * 4u + w[m - 2]) * 4u + w[m - 1];
      return lookup0(tab, st.len, h) == 0;
    }
    default: {  // kSog
      const uint32_t sg = (uint32_t)st.c;
      bool ok = true;
      for (int i = 0; i + 2 < m && ok; ++i) {
        uint32_t g = w[i] + w[i + 1] * sg + w[i + 2] * sg * sg;
        ok = !((lookup0(tab, st.len, g) >> i) & 1u);
      }
      return ok;
    }
  }
}

__device__ __forceinline__ bool chain_hit(const Chain& ch, const uint8_t* w,
                                          int m, int sigma, bool guard,
                                          const uint32_t* smem) {
  for (int i = 0; i < ch.n; ++i)
    if (!stage_hit(ch.s[i], ch, w, m, smem)) return false;
  if (guard) {
    int mx = 0;
    for (int j = 0; j < m; ++j) mx = w[j] > mx ? w[j] : mx;
    if (mx >= sigma) return false;
  }
  return true;
}

// tiles: count mode ceil(n_starts / kTile); mask mode ceil(n_out /
// kTile) with n_out = rows * 128 starts written; slots mode n_sub.
__global__ void __launch_bounds__(kThreads) stages_kernel(
    const uint8_t* __restrict__ text, long long n, int m, int sigma,
    int guard, int mode, long long n_starts, long long n_out,
    long long tiles, Chain ch, int tab_words, int* __restrict__ count,
    int8_t* __restrict__ mask, int* __restrict__ pos,
    int* __restrict__ counts) {
  extern __shared__ uint32_t smem[];     // tab_words, then the text tile
  __shared__ int wcnt[kThreads / 32];
  for (int i = 0; i < ch.n; ++i) {
    const Stage& st = ch.s[i];
    if (st.kind == kFpset) continue;
    for (int j = threadIdx.x; j < st.len; j += kThreads)
      smem[st.soff + j] = __ldg(st.table + j);
  }
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem + tab_words);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool g = guard != 0;
  int cnt = 0;
  for (long long b = blockIdx.x; b < tiles; b += gridDim.x) {
    const long long base = b * kTile;
    __syncthreads();             // tables staged / previous tile consumed
    tsm::load_tile<kThreads>(tile, text, n, base, kTile + m - 1);
    __syncthreads();
    if (mode == kCount) {
      for (int i = tid; i < kTile && base + i < n_starts; i += kThreads)
        cnt += chain_hit(ch, tile + i, m, sigma, g, smem);
    } else if (mode == kMask) {
      for (int i = tid; i < kTile && base + i < n_out; i += kThreads)
        mask[base + i] = (int8_t)(base + i < n_starts &&
                                  chain_hit(ch, tile + i, m, sigma, g, smem));
    } else {
      // the first kSlots candidates of the sub-block in position order:
      // ballot + popc in a warp, a prefix over the warps, chunk by chunk
      int* out = pos + b * kSlots;
      int running = 0;           // candidates in earlier chunks
      for (int c0 = 0; c0 < kTile && base + c0 < n_starts; c0 += kThreads) {
        long long s = base + c0 + tid;
        bool c = s < n_starts && chain_hit(ch, tile + c0 + tid, m, sigma, g,
                                           smem);
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
        __syncthreads();         // wcnt is rewritten by the next chunk
      }
      if (tid >= running && tid < kSlots) out[tid] = -1;
      if (tid == 0) counts[b] = running;
    }
  }
  if (mode == kCount) {
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_down_sync(0xffffffffu, cnt, off);
    if (lane == 0 && cnt) atomicAdd(count, cnt);
  }
}

// The chain from the host's descriptors; returns the shared-memory words of
// its staged tables, or -1 if a descriptor is invalid.
int load_chain(const int* desc, const void* const* tables, int n_stages,
               const void* cd, int m, Chain* ch) {
  if (n_stages < 1 || n_stages > kMaxChain) return -1;
  *ch = Chain{};
  ch->n = n_stages;
  int words = 0, fpsets = 0;
  for (int i = 0; i < n_stages; ++i) {
    Stage& st = ch->s[i];
    st.kind = desc[5 * i];
    st.a = desc[5 * i + 1];
    st.b = desc[5 * i + 2];
    st.c = desc[5 * i + 3];
    st.len = desc[5 * i + 4];
    st.table = (const uint32_t*)tables[i];
    st.soff = words;
    switch (st.kind) {
      case kWid:
        if (st.a < 0 || st.b < 1 || st.a + st.b > m || st.c < 1 ||
            st.b * st.c > 16 || st.len < 1)
          return -1;
        words += st.len;
        break;
      case kFpset:
        if (st.a < 1 || st.a > tsm::kMaxStages ||
            !tsm::valid_stage_bits(st.b) || ++fpsets > 1 || !cd)
          return -1;
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
  return words;
}

}  // namespace

// desc: host array of 5 int32 per stage, (kind, a, b, c, len) as in Stage;
// tables: host array of one device pointer per stage (fpset: k stages of
// stage_bits bits each, contiguous); cd: host array of 2*k uint32 (C_0, D_0,
// C_1, ...) for the fpset stage, or null.  mode 0 (count): out0 is one
// zeroed int32; mode 1 (mask): out0 is (rows, 128) int8 with rows = n_out =
// ceil((n-m+1)/128); mode 2 (slots): out0 is (n_sub, 16) int32 positions and
// out1 (n_sub,) int32 counts, n_sub = n_out = ceil((n-m+1)/16384).  Every
// output entry is written.  Requires n >= m.
extern "C" int tsm_stages(const void* text, long long n, int m, int sigma,
                          int guard, int mode, const void* desc,
                          const void* tables, int n_stages, const void* cd,
                          void* out0, void* out1, long long n_out,
                          int device, void* stream) {
  if (m < 1 || m > tsm::kMaxM || n < m) return (int)cudaErrorInvalidValue;
  Chain ch;
  int tab_words = load_chain((const int*)desc, (const void* const*)tables,
                             n_stages, cd, m, &ch);
  if (tab_words < 0) return (int)cudaErrorInvalidValue;
  const long long n_starts = n - m + 1;
  long long tiles;
  if (mode == kCount) {
    tiles = (n_starts + kTile - 1) / kTile;
  } else if (mode == kMask) {
    if (n_out != (n_starts + 127) / 128) return (int)cudaErrorInvalidValue;
    tiles = (n_out * 128 + kTile - 1) / kTile;
  } else if (mode == kSlotsMode) {
    if (n_out != (n_starts + kTile - 1) / kTile)
      return (int)cudaErrorInvalidValue;
    tiles = n_out;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)tab_words * 4 + kTile + m - 1;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stages_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long want = (long long)sms * 4;
  const int grid = (int)(tiles < want ? tiles : want);
  stages_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)text, n, m, sigma, guard, mode, n_starts,
      mode == kMask ? n_out * 128 : 0, tiles, ch, tab_words, (int*)out0,
      (int8_t*)out0, (int*)out0, (int*)out1);
  return (int)cudaGetLastError();
}
