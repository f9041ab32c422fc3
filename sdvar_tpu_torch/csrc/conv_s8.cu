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
// convolution is an implicit GEMM: M = B*H*W output pixels, N = O, K = 9*C.
//
// Bound at the pixel decoder's top level (B=16, H=W=256, C=O=160, bf16
// out): 2*16*256^2*9*160^2 = 483 G int8 operations, 0.244 ms at the H100
// SXM's 1979 dense int8 TOP/s, against about 504 MB moved (0.150 ms at
// 3.35 TB/s): operations bound it, and the operand bytes each product
// draws from L2 come next (a 3x3 window reads each pixel 9 times).
//
// Two kernels, chosen by ops/kernels/conv_s8.py:conv_plan:
//   - the wide path (C % 16 == 0 and O >= 96: every wide site of the pixel
//     decoder; its note is below, before conv3x3_s8_tma_kernel): TMA tiles
//     in a ring, s8 wgmma, a producer warpgroup and two consumer
//     warpgroups; 0.68 ms at the top level against 2.13 for the first
//     version (tools/ab_conv_s8.py, H100 SXM);
//   - the implicit GEMM on mma.sync (conv3x3_s8_kernel): the narrow path
//     (O < 96: conv_out's O = 3; 128 pixels x 8 channels, 4 warps) and C %
//     16 != 0 (128 x 160, 10 warps). K is walked in (dy, dx, 32-channel
//     chunk) order; each K step stages a BM x 32-byte tile of shifted input
//     pixels and a BN x 32-byte weight tile in shared memory with cp.async;
//     a tap that falls outside the image, a pixel past M, a channel past C
//     and an output channel past O are staged as zeros (cp.async's src-size
//     0), which is the "same" padding and the ragged edges. Two stages: the
//     next K step's copies are in flight while the current one is
//     multiplied with mma.sync.m16n8k32 s8 x s8 -> s32. Shared rows are
//     padded to 48 bytes, so the 32-bit fragment loads of a warp hit 32
//     distinct banks. Loads are 16 bytes when C % 16 == 0, else 4 bytes
//     (C % 4 == 0).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_map.cuh"
#include "wgmma.cuh"

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

// ---------------------------------------------------------------------------
// The wide path for C % 16 == 0: TMA tiles and s8 wgmma.
//
// A tile is 256 output pixels (a box of BW x BH pixels of one image) by
// 160 output channels. Its K loop takes the channels of each of the 9 taps
// in chunks of 128, then the rest (C % 128, rounded up to KT = 32, 64 or
// 128) of each tap, so no product runs on a chunk of zeros (the sums are
// exact, so their order is free). Each K step is one stage of a ring
// filled by TMA: the x box at (c0, w0 + dx - 1, h0 + dy - 1, b) from a 4-d
// map over (C, W, H, B), where taps that fall outside the image land as
// zeros (the "same" padding; channels past C too), and the weight box at
// (tap * C + c0, n0) from a 2-d map over (9C, O), rows past O zeros (a
// chunk's channels past C meet zeros of x). Both land K-major in the
// swizzle of their width (128 or KT bytes a pixel or a channel row), which
// is what 8-bit wgmma reads. A block of three warpgroups stays on its SM
// (the grid is at most one block an SM) and walks the tiles gridDim.x
// apart. One thread of the producer warpgroup keeps the ring full across
// tiles (a full barrier a stage, completed by the loads' bytes; an empty
// barrier a stage, completed by the eight consumer warps), so the next
// tile's operands land while this one's epilogue runs; it gives its
// registers up (setmaxnreg) to the two consumer warpgroups, which each
// multiply 128 of the pixels by all 160 channels: two wgmma.mma_async
// m64n160k32 s32.s8.s8 per 32 channels of a step (160 s32 registers a
// thread), one step's products in flight while the next stage is awaited.
// A weight tile serves 256 pixels, and a 128-byte row is one TMA
// transfer: the bytes each product draws from L2 were what bound the
// first, 128-pixel, 32-channel version of this loop. What holds it back
// now (tools/ab_conv_s8.py --ablate at the top level, H100 SXM): the
// epilogue, about 0.28 of 0.66 ms, runs while the tensor cores wait; a
// tile staged in shared memory and stored by TMA behind the next tile's
// products is the next step.
constexpr int TILE_M = 256;            // output pixels a tile
constexpr int TILE_N = 160;            // output channels a tile
constexpr int KC = 128;                // channels a main K step
constexpr int XB = TILE_M * KC;        // the x tile of a stage
constexpr int SB = (TILE_M + TILE_N) * KC;  // a stage: 53248 bytes, 52 x 1024
constexpr int S = 3;                   // ring stages (4, 214 KB, ran slower)
constexpr int TMA_THREADS = 384;       // the producer and two consumer warpgroups
constexpr int TMA_SMEM = 1024 + S * SB;  // 1024 bytes of alignment slack

// wgmma's layout type of a swizzle of `bytes`: 3 = 32, 2 = 64, 1 = 128
__host__ __device__ constexpr uint32_t swizzle_type(int bytes) {
  return bytes == 32 ? 3 : (bytes == 64 ? 2 : 1);
}

// this warpgroup's products of one stage: 128 pixels (two m64 tiles of
// rows of `kb` bytes) by the 160 channels, 32 channels at a time
template <int KB>
__device__ __forceinline__ void stage_products(int (&acc)[2][TILE_N / 8][4],
                                               uint32_t st, int wg, bool first) {
  constexpr uint32_t SWZ = swizzle_type(KB);
#pragma unroll
  for (int kk = 0; kk < KB / 32; ++kk)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wgmma_s8_n160(acc[i], gmma_desc(st + (wg * 2 + i) * 64 * KB + kk * 32, 16, 8 * KB, SWZ),
                    gmma_desc(st + XB + kk * 32, 16, 8 * KB, SWZ),
                    !first || kk > 0);
}

// KT: the width of a tap's last chunk (0: C % 128 == 0); tx, tw: maps with
// 128-byte boxes; txt, twt: with KT-byte boxes
template <typename OutT, int KT>
__global__ void __launch_bounds__(TMA_THREADS, 1) conv3x3_s8_tma_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap txt, const __grid_constant__ CUtensorMap twt,
    const float* __restrict__ scale, const float* __restrict__ bias,
    OutT* __restrict__ out, int H, int W, int C, int O, int BW, int BH,
    int tiles_w, int tiles_h, int tiles_n, int tiles) {
  extern __shared__ __align__(1024) uint8_t smem_base[];
  __shared__ uint64_t full[S], empty[S];
  uint8_t* ring = smem_base + ((1024 - (smem_u32(smem_base) & 1023)) & 1023);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunks = C / KC;  // full 128-channel chunks a tap
  const int nmain = 9 * chunks, ntail = KT ? 9 : 0;
  // tile -> (n0, w0, h0, b), channels fastest
  auto origin = [&](int tile, int& n0, int& w0, int& h0, int& b) {
    n0 = (tile % tiles_n) * TILE_N;
    tile /= tiles_n;
    w0 = (tile % tiles_w) * BW;
    tile /= tiles_w;
    h0 = (tile % tiles_h) * BH;
    b = tile / tiles_h;
  };

  if (tid == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {  // the producer warpgroup: one thread starts the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int step = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int n0, w0, h0, b;
        origin(tile, n0, w0, h0, b);
        // each step: the next stage, once the consumers have released it
        for (int ks = 0; ks < nmain; ++ks, ++step) {
          const int tap = ks / chunks, c0 = (ks - tap * chunks) * KC, s = step % S;
          if (step >= S) mbar_wait(&empty[s], ((step / S) + 1) & 1);
          mbar_expect_tx(&full[s], SB);
          tma_load_4d(ring + s * SB, &tx, c0, w0 + tap % 3 - 1, h0 + tap / 3 - 1, b, &full[s]);
          tma_load_2d(ring + s * SB + XB, &tw, tap * C + c0, n0, &full[s]);
        }
        for (int tap = 0; tap < ntail; ++tap, ++step) {
          const int s = step % S;
          if (step >= S) mbar_wait(&empty[s], ((step / S) + 1) & 1);
          mbar_expect_tx(&full[s], (TILE_M + TILE_N) * KT);
          tma_load_4d(ring + s * SB, &txt, chunks * KC, w0 + tap % 3 - 1, h0 + tap / 3 - 1, b, &full[s]);
          tma_load_2d(ring + s * SB + XB, &twt, tap * C + chunks * KC, n0, &full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
    const uint32_t ring_addr = smem_u32(ring);
    int step = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int n0, w0, h0, b;
      origin(tile, n0, w0, h0, b);
      int acc[2][TILE_N / 8][4];
      const int first = step;
      // wait for the next stage, run its products, release the stage
      // before it (its products are done once one group is in flight)
      auto arrived = [&]() {
        const int s = step % S;
        mbar_wait(&full[s], (step / S) & 1);
        wgmma_fence();
        return ring_addr + s * SB;
      };
      auto release = [&]() {
        wgmma_commit();
        wgmma_wait<1>();
        if (step > first && lane == 0) mbar_arrive(&empty[(step - 1) % S]);
      };
      for (int ks = 0; ks < nmain; ++ks, ++step) {
        stage_products<KC>(acc, arrived(), wg, step == first);
        release();
      }
      if constexpr (KT > 0) {
        for (int tap = 0; tap < ntail; ++tap, ++step) {
          stage_products<KT>(acc, arrived(), wg, step == first);
          release();
        }
      }
      wgmma_wait<0>();
      pin_s32(acc[0]);
      pin_s32(acc[1]);
      if (lane == 0) mbar_arrive(&empty[(step - 1) % S]);

      // the exact sums times the channel's scale, plus its bias, rounded
      // as two IEEE operations, cast once; pixels past the image and
      // channels past O are not stored
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = (wg * 2 + i) * 64 + (warp & 3) * 16 + g + 8 * hf;
          const int hh = h0 + r / BW, ww = w0 + r % BW;
          const bool ok = hh < H && ww < W;
          if (!ok) continue;
          const ll m = ((ll)b * H + hh) * W + ww;
#pragma unroll
          for (int j = 0; j < TILE_N / 8; ++j) {
            const int n = n0 + j * 8 + 2 * t;
            if (n >= O) continue;
            const float v0 = epilogue(acc[i][j][2 * hf], scale[n], bias[n]);
            if (n + 1 < O && (O % 2 == 0)) {
              store2(out, m * O + n, v0,
                     epilogue(acc[i][j][2 * hf + 1], scale[n + 1], bias[n + 1]));
            } else {
              store1(out, m * O + n, v0);
              if (n + 1 < O)
                store1(out, m * O + n + 1,
                       epilogue(acc[i][j][2 * hf + 1], scale[n + 1], bias[n + 1]));
            }
          }
        }
    }
  }
}

// a tensor map of `rank` dims (dims[0] innermost, strides of dims 1.. in
// bytes), int8 elements, the given box (box[0] = 32, 64 or 128 bytes) in
// the swizzle of that width; out-of-range elements read as zeros
bool s8_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const CUtensorMapSwizzle swizzle =
      box[0] == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                   : (box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                   : CU_TENSOR_MAP_SWIZZLE_128B);
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT, int KT>
int launch_tma(const void* x, const void* w, const void* scale,
               const void* bias, void* out, int B, int H, int W, int C, int O,
               int BW, int BH, int grid, cudaStream_t st) {
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)C, (cuuint64_t)W * C,
                            (cuuint64_t)H * W * C};
  const cuuint64_t wd[2] = {(cuuint64_t)9 * C, (cuuint64_t)O};
  const cuuint64_t ws[1] = {(cuuint64_t)9 * C};
  const cuuint32_t xb[4] = {KC, (cuuint32_t)BW, (cuuint32_t)BH, 1};
  const cuuint32_t wb[2] = {KC, TILE_N};
  const cuuint32_t xbt[4] = {KT ? KT : KC, (cuuint32_t)BW, (cuuint32_t)BH, 1};
  const cuuint32_t wbt[2] = {KT ? KT : KC, TILE_N};
  CUtensorMap tx, tw, txt, twt;
  if (!s8_map(&tx, x, 4, xd, xs, xb) || !s8_map(&tw, w, 2, wd, ws, wb) ||
      !s8_map(&txt, x, 4, xd, xs, xbt) || !s8_map(&twt, w, 2, wd, ws, wbt))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;  // the shared-memory limit, raised once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        conv3x3_s8_tma_kernel<OutT, KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, TMA_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int tiles_w = (W + BW - 1) / BW, tiles_h = (H + BH - 1) / BH;
  const int tiles_n = (O + TILE_N - 1) / TILE_N;
  const ll tiles = (ll)tiles_n * tiles_w * tiles_h * B;
  if (tiles > 0x7fffffffLL || grid < 1 || grid > tiles)
    return (int)cudaErrorInvalidValue;
  conv3x3_s8_tma_kernel<OutT, KT><<<grid, TMA_THREADS, TMA_SMEM, st>>>(
      tx, tw, txt, twt, static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<OutT*>(out), H, W, C, O,
      BW, BH, tiles_w, tiles_h, tiles_n, (int)tiles);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch_tma(int kt, const void* x, const void* w, const void* scale,
                 const void* bias, void* out, int B, int H, int W, int C,
                 int O, int BW, int BH, int grid, cudaStream_t st) {
  switch (kt) {
    case 0: return launch_tma<OutT, 0>(x, w, scale, bias, out, B, H, W, C, O, BW, BH, grid, st);
    case 32: return launch_tma<OutT, 32>(x, w, scale, bias, out, B, H, W, C, O, BW, BH, grid, st);
    case 64: return launch_tma<OutT, 64>(x, w, scale, bias, out, B, H, W, C, O, BW, BH, grid, st);
    case 128: return launch_tma<OutT, 128>(x, w, scale, bias, out, B, H, W, C, O, BW, BH, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
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

// The wide path (TMA tiles and s8 wgmma). x, w, scale, bias and out as
// above; the caller guarantees C % 16 == 0 and 16-byte aligned x and w.
// box_w x box_h (a tile's 256 pixels; box_w a power of two from 8 to 256)
// and grid (blocks, at most one an SM and at most the tiles) come from
// ops/kernels/conv_s8.py:conv_plan, which also
// holds the width of a tap's last chunk that this function derives from C.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sdvar_conv3x3_s8_tma(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    void* out, int out_dtype, int B, int H,
                                    int W, int C, int O, int box_w, int box_h,
                                    int grid, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || C % 16 ||
      (out_dtype != 0 && out_dtype != 1) || box_w < 8 || box_w > 256 ||
      (box_w & (box_w - 1)) || box_w * box_h != TILE_M)
    return (int)cudaErrorInvalidValue;
  const int rest = C % KC;  // the last chunk, widened to a swizzle's width
  const int kt = rest == 0 ? 0 : (rest <= 32 ? 32 : (rest <= 64 ? 64 : 128));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return dispatch_tma<__nv_bfloat16>(kt, x, w, scale, bias, out, B, H, W, C,
                                       O, box_w, box_h, grid, st);
  return dispatch_tma<float>(kt, x, w, scale, bias, out, B, H, W, C, O, box_w,
                             box_h, grid, st);
}

// Dynamic shared memory one block of the wide path takes, in bytes (the
// compiler's -Xptxas -v report shows none of it).
extern "C" int sdvar_conv3x3_s8_tma_smem_bytes() { return TMA_SMEM; }
