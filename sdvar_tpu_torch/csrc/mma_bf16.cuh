// Device helpers of the port's mma.sync kernels (matmul_int8.cu): the
// bf16 mma.sync tile product and the exact int8 -> bf16 widening of a
// 16-byte word.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
static __device__ __forceinline__ void mma_bf16(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 int8 -> 16 bf16 (exact: |x| <= 127 fits bf16's 8-bit significand), as
// two 16-byte words
static __device__ __forceinline__ void int8x16_to_bf16(const uint4& w,
                                                       uint4 (&o)[2]) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&w);
  uint32_t* u = reinterpret_cast<uint32_t*>(o);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn((float)b[2 * i], (float)b[2 * i + 1]);
    u[i] = *reinterpret_cast<uint32_t*>(&h);
  }
}
