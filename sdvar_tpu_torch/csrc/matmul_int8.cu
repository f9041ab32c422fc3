// INT8-weight matmul, hand-written for Hopper (sm_90a), bound to PyTorch
// through a plain C function loaded with ctypes.
//
// Replaces the TPU kernel sdvar_tpu/ops/pallas/matmul_int8.py:_kernel
// (reached through int8_matmul / int8_matmul_blc). Same function:
//   out[m, n] = (sum_k x[m, k] * q[k, n]) * s[n]
// with x bf16 or f32 (M, K), q int8 (K, N) converted to x's type in
// registers (int8 is exact in bf16), f32 accumulation, and the
// per-output-channel scale applied once, in the epilogue, to the f32 sum
// (not folded into the weights), then cast to x's type.
//
// The TPU kernel walks K as a sequential grid axis into a VMEM accumulator;
// here each block owns a 128 x 128 output tile and runs the K loop itself,
// with the next K tile's global loads in flight in registers while the
// current one is multiplied out of shared memory. Weights never exist as
// bf16 or f32 in device memory: each int8 tile is converted as it is
// staged into shared memory. Edges are masked (rows past M and columns
// past N are neither read nor written; K past its end reads zeros).
//
// Two kernels, one per activation type:
//   - bf16 (the weight-only "w8" decode's block GEMMs): tensor cores through
//     mma.sync m16n8k16 with f32 accumulation; 8 warps, each a 64 x 32 tile;
//     fragments come from shared memory through ldmatrix (.trans for the
//     weights, stored [k][n]). Bound at the d30 fc1 shape (M=8192, K=1920,
//     N=7680): 241 GFLOP, ~0.24 ms at the bf16 peak, against ~60 MB moved.
//   - f32 (the W8A8 decode's logits head): scalar FMAs on the CUDA cores, no
//     TF32 (the head is f32 by design); 256 threads, each an 8 x 8 tile.
//     Bound at the head shape (M=8192, K=1920, N=4096): 129 GFLOP, ~1.9 ms
//     at the 67 TFLOP/s f32 peak, so operations bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef long long ll;

constexpr int TM = 128;  // output rows per block
constexpr int TN = 128;  // output columns per block
constexpr int NT = 256;  // threads per block

__device__ __forceinline__ void store_pair(float* out, ll i, float a, float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(bf16* out, ll i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// bf16 activations: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int BK = 32;  // K per shared-memory tile
constexpr int PAD = 8;  // bf16 padding per shared row: conflict-free ldmatrix

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Fragment layout of m16n8k16 (lane = 4 * g + t): C pairs at rows g / g+8
// and columns 2t, 2t+1 of the warp's 16 x 8 tile.
__global__ void __launch_bounds__(NT) int8_matmul_bf16_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ s, bf16* __restrict__ out, int M, int N, int K,
    ll x_sm) {
  __shared__ __align__(16) bf16 as[TM][BK + PAD];  // x tile  [m][k]
  __shared__ __align__(16) bf16 bs[BK][TN + PAD];  // weights [k][n]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 64;  // this warp's 64 rows of the tile
  const int wn = (warp & 3) * 32;   // and its 32 columns
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;

  // staging jobs: x tile 128 rows x 4 chunks of 8 bf16 (two per thread);
  // weight tile 32 rows x 8 chunks of 16 int8 (one per thread)
  uint4 ra[2], rb;
  auto load = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * NT, r = i >> 2, c = (i & 3) * 8;
      ra[j] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && k0 + c < K)
        ra[j] = *reinterpret_cast<const uint4*>(x + (ll)(m0 + r) * x_sm + k0 + c);
    }
    const int r = tid >> 3, c = (tid & 7) * 16;
    rb = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < K && n0 + c < N)
      rb = *reinterpret_cast<const uint4*>(q + (ll)(k0 + r) * N + n0 + c);
  };
  auto stage = [&]() {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = tid + j * NT;
      *reinterpret_cast<uint4*>(&as[i >> 2][(i & 3) * 8]) = ra[j];
    }
    uint4 o[2];
    int8x16_to_bf16(rb, o);
    uint4* dst = reinterpret_cast<uint4*>(&bs[tid >> 3][(tid & 7) * 16]);
    dst[0] = o[0];
    dst[1] = o[1];
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix row addresses: lane l feeds row (l & 7) of 8x8 matrix l >> 3
  const int lr = (lane & 7) + ((lane >> 3) & 1) * 8;  // row within 16
  const int lc = (lane >> 4) * 8;                     // column offset 0 / 8

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    stage();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight during the products below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ldmatrix_x4(a[i], &as[wm + i * 16 + lr][kk + lc]);
      // .trans on [k][n]: matrices (k 0-7, n 0-7), (k 8-15, n 0-7),
      // (k 0-7, n 8-15), (k 8-15, n 8-15) give b0, b1 of two n8 tiles
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4_trans(b[j], &bs[kk + lr][wn + j * 16 + lc]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16(acc[i][j], a[i], b[j >> 1][(j & 1) * 2],
                   b[j >> 1][(j & 1) * 2 + 1]);
    }
    __syncthreads();
  }

  // epilogue: the f32 sum times the column scale, cast once
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + 2 * t;
    if (n >= N) continue;
    const float s0 = s[n], s1 = s[n + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + wm + i * 16 + g + 8 * hf;
        if (m < M)
          store_pair(out, (ll)m * N + n, acc[i][j][2 * hf] * s0,
                     acc[i][j][2 * hf + 1] * s1);
      }
  }
}

// ---------------------------------------------------------------------------
// f32 activations: scalar kernel on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int FK = 8;       // K per shared-memory tile
constexpr int SA = TM + 4;  // padded row stride of the transposed x tile

__global__ void __launch_bounds__(NT) int8_matmul_f32_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ s, float* __restrict__ out, int M, int N, int K,
    ll x_sm) {
  __shared__ __align__(16) float aT[FK][SA];  // x tile, transposed [k][m]
  __shared__ __align__(16) float bw[FK][TN];  // weights [k][n]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;

  // staging jobs: x tile 128 rows x 2 chunks of 4 floats (one per thread);
  // weight tile 8 rows x 8 chunks of 16 int8 (threads 0-63)
  float4 ra;
  uint4 rb;
  auto load = [&](int k0) {
    const int r = tid >> 1, c = (tid & 1) * 4;
    ra = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m0 + r < M && k0 + c < K)
      ra = *reinterpret_cast<const float4*>(x + (ll)(m0 + r) * x_sm + k0 + c);
    rb = make_uint4(0u, 0u, 0u, 0u);
    if (tid < 64) {
      const int kr = tid >> 3, nc = (tid & 7) * 16;
      if (k0 + kr < K && n0 + nc < N)
        rb = *reinterpret_cast<const uint4*>(q + (ll)(k0 + kr) * N + n0 + nc);
    }
  };
  auto stage = [&]() {
    const int r = tid >> 1, c = (tid & 1) * 4;
    aT[c][r] = ra.x;
    aT[c + 1][r] = ra.y;
    aT[c + 2][r] = ra.z;
    aT[c + 3][r] = ra.w;
    if (tid < 64) {
      const int8_t* b = reinterpret_cast<const int8_t*>(&rb);
      float4* dst = reinterpret_cast<float4*>(&bw[tid >> 3][(tid & 7) * 16]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dst[i] = make_float4((float)b[4 * i], (float)b[4 * i + 1],
                             (float)b[4 * i + 2], (float)b[4 * i + 3]);
    }
  };

  // this thread's rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns
  // likewise: the two float4 reads per operand are conflict-free
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  for (int k0 = 0; k0 < K; k0 += FK) {
    stage();
    __syncthreads();
    if (k0 + FK < K) load(k0 + FK);
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&aT[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&aT[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bw[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bw[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int jh = 0; jh < 2; ++jh)
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      const int n = n0 + jh * 64 + tx * 4 + 2 * jp;
      if (n >= N) continue;
      const float s0 = s[n], s1 = s[n + 1];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
        if (m < M)
          store_pair(out, (ll)m * N + n, acc[i][jh * 4 + 2 * jp] * s0,
                     acc[i][jh * 4 + 2 * jp + 1] * s1);
      }
    }
}

}  // namespace

// x: (M, K) rows with stride x_sm (elements), contiguous along K; q: (K, N)
// int8 contiguous; s: (N,) float32; out: contiguous (M, N) in x's type.
// Types: 0 = float32, 1 = bfloat16. The caller guarantees 16-byte alignment
// of x, q and their rows, K % 8 == 0 and N % 16 == 0. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int sdvar_int8_matmul(const void* x, const void* q, const void* s,
                                 void* out, int x_dtype, int M, int N, int K,
                                 long long x_sm, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 16 ||
      (M + TM - 1) / TM > 65535 || (x_dtype != 0 && x_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(s);
  if (x_dtype == 1)
    int8_matmul_bf16_kernel<<<grid, NT, 0, st>>>(
        static_cast<const bf16*>(x), qi, sf, static_cast<bf16*>(out), M, N, K,
        x_sm);
  else
    int8_matmul_f32_kernel<<<grid, NT, 0, st>>>(
        static_cast<const float*>(x), qi, sf, static_cast<float*>(out), M, N,
        K, x_sm);
  return (int)cudaGetLastError();
}
