// Host side of the tensor-memory-accelerator (TMA) loads shared by the
// port's Hopper kernels, matmul_int8.cu, conv_s8.cu and w8a8_fused.cu: libcuda's
// cuTensorMapEncodeTiled, reached through the runtime (nothing more to
// link), which encodes the tensor map a kernel's cp.async.bulk.tensor
// loads read.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

// cuTensorMapEncodeTiled from libcuda, looked up once; null where the
// installed libcuda does not have it
static PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}
