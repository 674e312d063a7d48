// Exact verification of the cascade route's compacted candidates, on Hopper.
//
// Replaces no Pallas kernel: on the TPU this step is XLA code,
// tpu_smatcher/ops/fast.py:verify_chunked (over _verify_matched), on the
// word view the cascade kernel fuses, each chunk gated on the device-side
// candidate count by lax.cond.  It replaces the port's torch version of it
// (ops/verify.verify_count over cuda_filter.words_view: an int32 copy of the
// whole text and some 25 torch ops over the whole cap, the -1 slots masked,
// since torch cannot bound work by a count on the device without a sync).
//
// count = how many j < min(n_cand, cap) have a start s = idxs[j],
// 0 <= s < n - m + 1, whose window t[s..s+m) equals a pattern.  The window's
// fingerprints fp_k = sum_i t[s+i] * FP_MULTS[k]^i mod 2^16 give its bucket,
// key = fp0 | (fp1 & (2^eb - 1)) << 16, of lmax slots; with slot_ok the slot
// is the last one whose bucket_fp2 equals fp2 (there is at most one), else
// every slot is tried; the slot's pattern (bucket_ids, -1 where empty) must
// equal the window as little-endian words (packed, the last word masked to
// its m - 4 (words - 1) bytes).  That is verify_count over idxs, whose
// entries from n_cand on are -1 (compact_rows writes them so), as 0-d int32.
//
// What bounds it on an H100: latency.  At the flagship's shapes (~28k
// candidates, m = 32) it reads some 3 MB from scattered addresses, ~1 us at
// 3.35 TB/s; each candidate's reads depend on one another (its start, its
// text, its bucket, its pattern), a few DRAM round trips.  Design: one
// thread a candidate and no word view.  A thread reads the aligned 32-bit
// text words that hold its window's bytes (each holds at least one of them,
// so no read leaves the text's 4-byte granules) and funnel-shifts them into
// the window's words, runs Horner's rule over them for the three
// fingerprints, then compares the pattern word by word against the window
// read again (from L1).  The grid covers cap and threads from min(n_cand,
// cap) on exit at once: no work for the -1 tail, no count on the host.
// Warp sums, block sums, one atomicAdd a block into the count, which the
// launcher zeroes first in the same stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "fp_filter.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

// The aligned text words holding one window.
struct Window {
  const uint32_t* w;   // the word holding the window's first byte
  int shift;           // 8 x the window's byte offset in it
  int nw;              // words holding the window's bytes
};

__device__ __forceinline__ Window window_at(const uint8_t* p, int m) {
  uintptr_t a = reinterpret_cast<uintptr_t>(p);
  int r = (int)(a & 3);
  return {reinterpret_cast<const uint32_t*>(a - r), 8 * r, (r + m + 3) >> 2};
}

// Window word j (bytes 4j..4j+3 of the window, little endian), j < words;
// bytes past the window are not masked here.
__device__ __forceinline__ uint32_t window_word(const Window& win, int j) {
  uint32_t lo = __ldg(win.w + j);
  uint32_t hi = j + 1 < win.nw ? __ldg(win.w + j + 1) : 0u;
  return __funnelshift_r(lo, hi, win.shift);
}

__device__ __forceinline__ bool equals(const Window& win,
                                       const uint32_t* __restrict__ pat,
                                       int words, uint32_t last_mask) {
  for (int j = 0; j < words - 1; ++j)
    if (window_word(win, j) != __ldg(pat + j)) return false;
  return (window_word(win, words - 1) & last_mask) == __ldg(pat + words - 1);
}

__global__ void __launch_bounds__(kThreads)
live_verify_kernel(const uint8_t* __restrict__ text, long long n_starts,
                   int m, const long long* __restrict__ idxs, long long cap,
                   const long long* __restrict__ n_cand,
                   const int* __restrict__ bucket_ids,
                   const int* __restrict__ bucket_fp2, int lmax, int eb,
                   bool slot_ok, const uint32_t* __restrict__ packed,
                   int words, int* __restrict__ count) {
  __shared__ int warp_sum[kWarps];
  long long live = *n_cand;
  if (live > cap) live = cap;
  const int nb_last = m - 4 * (words - 1);
  const uint32_t last_mask = nb_last == 4 ? kAll
                                          : (1u << (8 * nb_last)) - 1u;
  const uint32_t eb_mask = (1u << eb) - 1u;
  int c = 0;
  for (long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
       j < live; j += (long long)gridDim.x * kThreads) {
    const long long s = idxs[j];
    if (s < 0 || s >= n_starts) continue;
    const Window win = window_at(text + s, m);
    // Horner's rule from the window's last byte to its first
    uint32_t f0 = 0, f1 = 0, f2 = 0;
    for (int w = words - 1; w >= 0; --w) {
      const uint32_t v = window_word(win, w);
      for (int b = (w == words - 1 ? nb_last : 4) - 1; b >= 0; --b) {
        const uint32_t t = (v >> (8 * b)) & 0xFFu;
        f0 = f0 * tsm::kMult0 + t;
        f1 = f1 * tsm::kMult1 + t;
        f2 = f2 * tsm::kMult2 + t;
      }
    }
    const uint32_t key = (f0 & 0xFFFFu) | ((f1 & eb_mask) << 16);
    const long long base = (long long)key * lmax;
    bool hit = false;
    if (slot_ok) {
      const int fp2 = (int)(f2 & 0xFFFFu);
      int slot = -1;
      for (int l = 0; l < lmax; ++l)
        if (__ldg(bucket_fp2 + base + l) == fp2) slot = l;
      const int pid = slot < 0 ? -1 : __ldg(bucket_ids + base + slot);
      hit = pid >= 0 && equals(win, packed + (long long)pid * words, words,
                               last_mask);
    } else {
      for (int l = 0; l < lmax && !hit; ++l) {
        const int pid = __ldg(bucket_ids + base + l);
        hit = pid >= 0 && equals(win, packed + (long long)pid * words, words,
                                 last_mask);
      }
    }
    c += hit;
  }
  c = __reduce_add_sync(kAll, c);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x < 32) {
    int t = threadIdx.x < kWarps ? warp_sum[threadIdx.x] : 0;
    t = __reduce_add_sync(kAll, t);
    if (threadIdx.x == 0 && t) atomicAdd(count, t);
  }
}

}  // namespace

// text: (n,) uint8; idxs: (cap,) int64; n_cand: 0-d int64; bucket_ids,
// bucket_fp2: (2^(16+eb) * lmax,) int32; packed: (p, words) int32, words =
// ceil(m / 4); count: 0-d int32, zeroed here, then the kernel adds to it.
extern "C" int tsm_verify_live(const void* text, long long n, int m,
                               const void* idxs, long long cap,
                               const void* n_cand, const void* bucket_ids,
                               const void* bucket_fp2, int lmax, int eb,
                               int slot_ok, const void* packed, int words,
                               void* count, int device, void* stream) {
  if (n < 0 || m < 1 || m > tsm::kMaxM || cap < 0 || lmax < 1 || eb < 0
      || eb > 16 || words != (m + 3) / 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (cap + kThreads - 1) / kThreads;
  long long most = (long long)sms * (2048 / kThreads);
  int grid = (int)(blocks < 1 ? 1 : blocks < most ? blocks : most);
  live_verify_kernel<<<grid, kThreads, 0, s>>>(
      (const uint8_t*)text, n - m + 1, m, (const long long*)idxs, cap,
      (const long long*)n_cand, (const int*)bucket_ids,
      (const int*)bucket_fp2, lmax, eb, slot_ok != 0,
      (const uint32_t*)packed, words, (int*)count);
  return (int)cudaGetLastError();
}
