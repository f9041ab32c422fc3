// The multi-device probe kernel, hand-written for Hopper (sm_90a), bound to
// PyTorch through a plain C function loaded with ctypes.
//
// Replaces the JAX package's `kern` (tests/test_tp_pallas.py:194-203):
//   out = x * 2.0
// on a float32 array, (8, 512) in the probe: the Pallas call that shows
// GSPMD cannot partition a Mosaic kernel whose operand is split over
// "model". Each element is one exact product, so the output is bit-equal to
// x * 2.0 however the array is split.
//
// Bound on this card: bytes, each element read once and written once (16
// KiB each way at (8, 512): about 1e-5 ms at 3.35 TB/s), far below the cost
// of one launch. So the launch path is what the probe measures: this
// replaced a Triton kernel whose Python launcher took about twice as long
// as torch.mul's launch (kernel table, row 9); a ctypes call into this
// function launches from C. Each thread takes 16 bytes (four floats) with
// one vector load and one vector store when both pointers are 16-byte
// aligned, and the tail past the last whole vector element by element.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block; each four floats

__global__ void __launch_bounds__(NT) scale_probe_kernel(
    const float* __restrict__ x, float* __restrict__ out, long long n,
    bool vec) {
  const long long i = ((long long)blockIdx.x * NT + threadIdx.x) * 4;
  if (vec && i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    *reinterpret_cast<float4*>(out + i) =
        make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
    return;
  }
  for (long long j = i; j < i + 4 && j < n; ++j) out[j] = x[j] * 2.0f;
}

}  // namespace

// x, out: n contiguous float32 values on the card. Returns the cudaError_t
// of the launch (0 = success).
extern "C" int sdvar_scale_probe(const void* x, void* out, long long n,
                                 void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long blocks = (n + 4LL * NT - 1) / (4LL * NT);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  scale_probe_kernel<<<(unsigned)blocks, NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n, vec);
  return (int)cudaGetLastError();
}
