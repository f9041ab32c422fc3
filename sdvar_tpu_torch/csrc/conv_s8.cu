// INT8 3x3 convolution (NHWC, stride 1, "same" zero padding) as an implicit
// GEMM on the tensor cores, hand-written for Hopper (sm_90a), bound to
// PyTorch through a plain C function loaded with ctypes.
//
// Replaces the TPU kernel sdvar_tpu/ops/pallas/conv_s8.py:_kernel (reached
// through conv3x3_s8). Same function:
//   acc[p, o] = sum_{dy, dx, c} x[b, h + dy - 1, w + dx - 1, c] * w[o, dy, dx, c]
//   out[p, o] = bf16/f32( (float(acc) * scale[o]) + bias[o] )
// with int8 x (B, H, W, C), int8 weights (O, 3, 3, C) ("OHWI": K contiguous
// per output channel), exact s32 sums, and the epilogue rounded as two
// separate IEEE operations (__fmul_rn, __fadd_rn: never contracted into an
// FMA), so the plain PyTorch version gives the same bits.
//
// The TPU kernel folds the vertical taps into K and builds the horizontal
// taps with lane rolls and byte shifts (Mosaic's lane tiling). Here the
// convolution is an implicit GEMM: M = B*H*W output pixels, N = O, K = 9*C
// walked in (dy, dx, 32-channel chunk) order. Each K step stages a
// BM x 32-byte tile of shifted input pixels and a BN x 32-byte weight tile
// in shared memory with cp.async; a tap that falls outside the image, a
// pixel past M, a channel past C and an output channel past O are staged as
// zeros (cp.async's src-size 0), which is the "same" padding and the ragged
// edges. Two stages: the next K step's copies are in flight while the
// current one is multiplied with mma.sync.m16n8k32 s8 x s8 -> s32.
// Shared rows are padded to 48 bytes, so the 32-bit fragment loads of a
// warp hit 32 distinct banks.
//
// Bound at the pixel decoder's top level (B=16, H=W=256, C=O=160, bf16
// out): 2*16*256^2*9*160^2 = 483 G int8 operations, 0.244 ms at the H100
// SXM's 1979 dense int8 TOP/s, against about 504 MB moved (0.150 ms at
// 3.35 TB/s): operations bound it. This first version uses mma.sync (not
// wgmma) and a two-stage pipeline.
//
// Two tile shapes: "wide" (128 pixels x 160 channels, 10 warps) for O >= 96,
// which covers O = 160, 320, 640 with no masked columns; "narrow"
// (128 pixels x 8 channels, 4 warps) for small O (conv_out's O = 3). Loads
// are 16 bytes when C % 16 == 0, else 4 bytes (C % 4 == 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long ll;

constexpr int BK = 32;    // int8 values of K per stage (one m16n8k32 step)
constexpr int ROW = 48;   // padded shared-memory row, bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies VEC bytes, or writes VEC zero bytes when !valid
template <int VEC>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const int n = valid ? VEC : 0;
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// d += a (16x32, row) * b (32x8, col), s8 in, s32 accumulate (exact)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float epilogue(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

__device__ __forceinline__ void store1(float* out, ll i, float v) { out[i] = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, ll i, float v) {
  out[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* out, ll i, float a, float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* out, ll i, float a,
                                       float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}

// Fragment layout of m16n8k32 (lane = 4 * g + t): A registers hold rows g
// and g + 8, bytes 4t..4t+3 and 16+4t..; B registers hold k = 4t.. and
// 16+4t.. of column g; C pairs at rows g / g + 8, columns 2t, 2t + 1.
template <int WM, int WN, int MT, int NT, int VEC, typename OutT>
__global__ void __launch_bounds__(WM * WN * 32) conv3x3_s8_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    OutT* __restrict__ out, int H, int W, int C, int O, ll M) {
  constexpr int NTH = WM * WN * 32;
  constexpr int BM = WM * MT * 16;
  constexpr int BN = WN * NT * 8;
  constexpr int CPR = BK / VEC;  // copies per staged row
  constexpr int A_COPIES = BM * CPR, B_COPIES = BN * CPR;
  constexpr int A_IT = (A_COPIES + NTH - 1) / NTH;
  constexpr int B_IT = (B_COPIES + NTH - 1) / NTH;

  __shared__ __align__(16) int8_t as[2][BM][ROW];
  __shared__ __align__(16) int8_t bs[2][BN][ROW];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WN) * MT * 16, wn = (warp % WN) * NT * 8;
  const ll m0 = (ll)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread's staged pixels: their (h, w) and offset; h = -4 marks a
  // pixel past M (every tap of it reads as zero)
  int ah[A_IT], aw[A_IT];
  ll aoff[A_IT];
#pragma unroll
  for (int it = 0; it < A_IT; ++it) {
    const int i = tid + it * NTH;
    const ll p = m0 + i / CPR;
    ah[it] = -4;
    aw[it] = 0;
    aoff[it] = 0;
    if (i < A_COPIES && p < M) {
      const ll bh = p / W;
      aw[it] = (int)(p - bh * W);
      ah[it] = (int)(bh % H);
      aoff[it] = p * C + (i % CPR) * VEC;
    }
  }

  const int chunks = (C + BK - 1) / BK;
  const int ksteps = 9 * chunks;
  auto stage = [&](int buf, int ks) {
    const int tap = ks / chunks, c0 = (ks - tap * chunks) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
    for (int it = 0; it < A_IT; ++it) {
      const int i = tid + it * NTH;
      if (i < A_COPIES) {
        const int r = i / CPR, cc = (i % CPR) * VEC;
        const int hh = ah[it] + dy, ww = aw[it] + dx;
        const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W && c0 + cc < C;
        const int8_t* src = ok ? x + aoff[it] + (ll)(dy * W + dx) * C + c0 : x;
        cp_async<VEC>(&as[buf][r][cc], src, ok);
      }
    }
#pragma unroll
    for (int it = 0; it < B_IT; ++it) {
      const int i = tid + it * NTH;
      if (i < B_COPIES) {
        const int r = i / CPR, cc = (i % CPR) * VEC;
        const bool ok = n0 + r < O && c0 + cc < C;
        const int8_t* src = ok ? w + (ll)(n0 + r) * 9 * C + tap * C + c0 + cc : w;
        cp_async<VEC>(&bs[buf][r][cc], src, ok);
      }
    }
  };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  stage(0, 0);
  cp_async_commit();
  for (int ks = 0; ks < ksteps; ++ks) {
    const int buf = ks & 1;
    if (ks + 1 < ksteps) stage(buf ^ 1, ks + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this step's copies have landed
    __syncthreads();
    uint32_t a[MT][4], b[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = wm + i * 16 + g;
      a[i][0] = lds32(&as[buf][r][4 * t]);
      a[i][1] = lds32(&as[buf][r + 8][4 * t]);
      a[i][2] = lds32(&as[buf][r][16 + 4 * t]);
      a[i][3] = lds32(&as[buf][r + 8][16 + 4 * t]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = wn + j * 8 + g;
      b[j][0] = lds32(&bs[buf][n][4 * t]);
      b[j][1] = lds32(&bs[buf][n][16 + 4 * t]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    __syncthreads();  // the buffer is staged again two steps on
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn + j * 8 + 2 * t;
    if (n >= O) continue;
    const bool pair = n + 1 < O && (O % 2 == 0);
    const float s0 = scale[n], b0 = bias[n];
    const float s1 = n + 1 < O ? scale[n + 1] : 0.f;
    const float b1 = n + 1 < O ? bias[n + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const ll m = m0 + wm + i * 16 + g + 8 * hf;
        if (m >= M) continue;
        const float v0 = epilogue(acc[i][j][2 * hf], s0, b0);
        const float v1 = epilogue(acc[i][j][2 * hf + 1], s1, b1);
        if (pair) {
          store2(out, m * O + n, v0, v1);
        } else {
          store1(out, m * O + n, v0);
          if (n + 1 < O) store1(out, m * O + n + 1, v1);
        }
      }
  }
}

template <int WM, int WN, int MT, int NT, int VEC, typename OutT>
int launch(const void* x, const void* w, const void* scale, const void* bias,
           void* out, int B, int H, int W, int C, int O, cudaStream_t st) {
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  const ll M = (ll)B * H * W;
  const ll gx = (M + BM - 1) / BM;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (O + BN - 1) / BN);
  conv3x3_s8_kernel<WM, WN, MT, NT, VEC, OutT><<<grid, WM * WN * 32, 0, st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<OutT*>(out), H, W, C, O, M);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch(const void* x, const void* w, const void* scale, const void* bias,
             void* out, int B, int H, int W, int C, int O, cudaStream_t st) {
  const bool wide = O >= 96;
  if (C % 16 == 0)
    return wide ? launch<2, 5, 4, 4, 16, OutT>(x, w, scale, bias, out, B, H, W, C, O, st)
                : launch<4, 1, 2, 1, 16, OutT>(x, w, scale, bias, out, B, H, W, C, O, st);
  return wide ? launch<2, 5, 4, 4, 4, OutT>(x, w, scale, bias, out, B, H, W, C, O, st)
              : launch<4, 1, 2, 1, 4, OutT>(x, w, scale, bias, out, B, H, W, C, O, st);
}

}  // namespace

// x: contiguous int8 (B, H, W, C); w: contiguous int8 (O, 3, 3, C); scale,
// bias: (O,) float32; out: contiguous (B, H, W, O), float32 (out_dtype 0)
// or bfloat16 (1). The caller guarantees C % 4 == 0 and 16-byte aligned
// x and w. Returns the cudaError_t of the launch (0 = success).
extern "C" int sdvar_conv3x3_s8(const void* x, const void* w, const void* scale,
                                const void* bias, void* out, int out_dtype,
                                int B, int H, int W, int C, int O, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % 4 ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, scale, bias, out, B, H, W, C, O, st);
  return dispatch<float>(x, w, scale, bias, out, B, H, W, C, O, st);
}
