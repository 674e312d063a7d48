// Little-endian int32 word view of a text, on Hopper.
//
// Replaces the TPU kernel _words_kernel (tpu_smatcher/ops/pallas_filter.py:1011,
// via words_view_pallas :1032), and the word views fused into
// _filter_slots_flat_kernel (emit_words_flat :589) and _cascade_kernel.
//
// out[w] = t[4w] | t[4w+1] << 8 | t[4w+2] << 16 | t[4w+3] << 24 for w < nw,
// with bytes past the text's end read as 0.  Verify gathers words+1
// consecutive words per candidate, so callers pass nw = words_len(n, words),
// which covers the text plus that margin.
//
// What bounds it on an H100: memory, n bytes read and 4*nw bytes written.
// On the TPU the stride-4 byte shuffle needed 16 lane-permutation gathers per
// 128-byte quarter; here a little-endian uint8 stream already is the int32
// view, so the kernel is a padded copy: each thread moves 16 bytes with one
// 16-byte load and one 16-byte store where both pointers are 16-byte aligned
// and the group lies inside the text, and byte by byte at the ragged tail.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
words_kernel(const uint8_t* __restrict__ text, long long n,
             uint32_t* __restrict__ out, long long nw, long long groups,
             bool vec) {
  for (long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
       q < groups; q += (long long)gridDim.x * kThreads) {
    long long w0 = q * 4, b0 = w0 * 4;
    if (vec && b0 + 16 <= n && w0 + 4 <= nw) {
      *reinterpret_cast<uint4*>(out + w0) =
          __ldg(reinterpret_cast<const uint4*>(text + b0));
      continue;
    }
    for (int j = 0; j < 4 && w0 + j < nw; ++j) {
      uint32_t v = 0;
      for (int b = 3; b >= 0; --b) {
        long long g = b0 + 4 * j + b;
        v = (v << 8) | (g < n ? text[g] : 0u);
      }
      out[w0 + j] = v;
    }
  }
}

}  // namespace

// out: (nw,) int32 on the device; every entry written.
extern "C" int tsm_words_view(const void* text, long long n, void* out,
                              long long nw, int device, void* stream) {
  if (n < 0 || nw < 0) return (int)cudaErrorInvalidValue;
  if (nw == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  long long groups = (nw + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  long long want = (long long)sms * 32;
  int grid = (int)(blocks < want ? blocks : want);
  bool vec = ((uintptr_t)text % 16 == 0) && ((uintptr_t)out % 16 == 0);
  words_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)text, n, (uint32_t*)out, nw, groups, vec);
  return (int)cudaGetLastError();
}
