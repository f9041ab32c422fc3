// Fused W8A8 matmul: per-token activation quantization, the int8 product and
// the scale epilogue in one kernel, hand-written for Hopper (sm_90a), bound
// to PyTorch through a plain C function loaded with ctypes.
//
// Replaces the TPU kernel tools/microbench_int8_matmul.py:_pallas_w8a8 (the
// microbenchmark's pl_s8 / pl_bf16 modes). Same function, row by row:
//   xs[m]     = max(amax_k |x[m, k]| / 127, 1e-8)               (f32)
//   xq[m, k]  = round_half_even(x[m, k] / xs[m])                (|xq| <= 127)
//   acc[m, n] = sum_k xq[m, k] * wq[k, n]
//   out[m, n] = bf16( (float(acc) * xs[m]) * ws[n] )
// with x bf16 or f32 (M, K) (widened to f32 exactly), wq int8 (K, N) stored
// K-major (each column's K bytes contiguous: the layout W8A8Linear keeps
// for torch._int_mm, and the "col" B operand of mma.sync), ws f32 (N,).
// A compile-time S8 flag picks the product:
//   S8 = true:  mma.sync m16n8k32 s8 x s8 -> s32, an exact sum;
//   S8 = false: the same int values as bf16 (exact) on m16n8k16 with an f32
//               sum, which rounds once partial sums pass 2^24 (K * 127^2
//               can reach 1.2e8 at K = 7680): the TPU's pl_bf16 form.
// The division, the rounding (rintf) and the two epilogue products are
// separate IEEE operations (__fdiv_rn, __fmul_rn: never contracted into an
// FMA), in the plain PyTorch version's order, so the S8 form gives its bits.
//
// The TPU kernel holds a (bm, K) strip of x and a (K, bn) slab of wq in VMEM
// per program and quantizes the strip there. Here a block owns a 64 x 128
// output tile (4 warps, each 32 x 64): a prologue reads the block's 64 rows
// of x over all of K with 16-byte loads, reduces |x| per row with warp
// shuffles and keeps xs in shared memory; the K loop then stages, per 32-wide
// K step, the x tile quantized to int8 in shared memory (loaded through
// registers, quantized as it is stored) and the wq tile with cp.async, two
// stages deep, and issues the MMAs. The bf16 form converts the staged int8
// values to bf16 pairs as it loads its fragments. Rows past M and columns
// past N are zero-filled on the way in and never stored.
//
// Bound at the d30 fc1 shape of the decode's last scale (B=32 requests, CFG
// doubled: M = 8192, K = 1920, N = 7680): 2*M*K*N = 242 G int8 operations,
// 0.122 ms at the H100 SXM's 1979 dense int8 TOP/s (0.244 ms in the bf16
// form at 989 TFLOP/s), against 2*M*K + K*N + 2*M*N = 172 MB moved (0.051 ms
// at 3.35 TB/s): operations bound it. This first version is far from that:
// every block of a row strip re-reads the strip for its amax (N/128 times),
// the tiles go through mma.sync from 32-bit shared loads, and the pipeline
// is two stages deep; wgmma with TMA-staged tiles and one amax pass per
// strip are the later steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

typedef __nv_bfloat16 bf16;
typedef long long ll;

constexpr int WM = 2, WN = 2;        // warps along M and N
constexpr int MT = 2, NT = 8;        // 16-row and 8-column MMA tiles per warp
constexpr int NTH = WM * WN * 32;    // threads per block
constexpr int BM = WM * MT * 16;     // 64 rows per block
constexpr int BN = WN * NT * 8;      // 128 columns per block
constexpr int BK = 32;               // K per stage (one m16n8k32 step)
constexpr int ROW = 48;              // padded shared row, bytes: conflict-free
                                     // 32-bit fragment loads

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies 16 bytes, or writes 16 zero bytes when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
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

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two neighbouring int8 values in shared memory as a bf16 pair (exact), the
// lower index in the low half, as mma.sync's fragments hold them
__device__ __forceinline__ uint32_t lds_pair_bf16(const int8_t* p) {
  __nv_bfloat162 h = __floats2bfloat162_rn((float)p[0], (float)p[1]);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 16 bytes of x as f32: 8 bf16 or 4 f32 values
__device__ __forceinline__ void widen(const uint4& w, float* f, const bf16*) {
  const bf16* h = reinterpret_cast<const bf16*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void widen(const uint4& w, float* f, const float*) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}

// Fragment layouts (lane = 4 * g + t): m16n8k32 s8 A registers hold rows g
// and g + 8, bytes 4t..4t+3 and 16+4t..; B registers k = 4t.. and 16+4t..
// of column g. m16n8k16 bf16 A registers hold (row g, k 2t..2t+1),
// (g + 8, 2t..), (g, 2t+8..), (g + 8, 2t+8..); B (k 2t.., column g) and
// (k 2t+8.., column g). C pairs: rows g / g + 8, columns 2t, 2t + 1.
template <typename XT, bool S8>
__global__ void __launch_bounds__(NTH) w8a8_fused_kernel(
    const XT* __restrict__ x, const int8_t* __restrict__ wq,
    const float* __restrict__ ws, bf16* __restrict__ out, ll M, int N, int K,
    ll x_sm) {
  constexpr int VEC = 16 / sizeof(XT);  // x values per 16-byte load
  constexpr int A_LOADS = 16 / VEC;     // loads per thread per stage: 16 values
  using Acc = typename std::conditional<S8, int, float>::type;

  __shared__ __align__(16) int8_t as[2][BM][ROW];  // quantized x [m][k]
  __shared__ __align__(16) int8_t bs[2][BN][ROW];  // wq [n][k]
  __shared__ float xs[BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WN) * MT * 16, wn = (warp % WN) * NT * 8;
  const ll m0 = (ll)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // prologue: the per-row activation scale of the block's rows
  for (int r = warp; r < BM; r += NTH / 32) {
    const ll m = m0 + r;
    float amax = 0.f;
    if (m < M) {
      const XT* row = x + m * x_sm;
      for (int k = lane * VEC; k < K; k += 32 * VEC) {
        float f[VEC];
        widen(*reinterpret_cast<const uint4*>(row + k), f, row);
#pragma unroll
        for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(f[i]));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (lane == 0) xs[r] = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  }
  __syncthreads();

  // A staging: thread -> row tid / 2, 16 values from column (tid & 1) * 16
  const int ar = tid >> 1, ac = (tid & 1) * 16;
  const bool a_row = m0 + ar < M;
  const XT* a_src = x + (a_row ? (m0 + ar) * x_sm : 0) + ac;
  const float a_scale = xs[ar];
  uint4 ra[A_LOADS];
  auto load_a = [&](int k0) {
    const bool ok = a_row && k0 + ac < K;  // K % 16 == 0: all or none
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i)
      ra[i] = ok ? *reinterpret_cast<const uint4*>(a_src + k0 + i * VEC)
                 : make_uint4(0u, 0u, 0u, 0u);
  };
  auto store_a = [&](int buf) {
    uint32_t packed[4];
    int8_t* q = reinterpret_cast<int8_t*>(packed);
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      float f[VEC];
      widen(ra[i], f, a_src);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        q[i * VEC + j] = (int8_t)__float2int_rn(rintf(__fdiv_rn(f[j], a_scale)));
    }
    *reinterpret_cast<uint4*>(&as[buf][ar][ac]) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  };
  // B staging: 128 columns x 2 chunks of 16 bytes, two per thread
  auto stage_b = [&](int buf, int k0) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = tid + it * NTH, r = i >> 1, c = (i & 1) * 16;
      const bool ok = n0 + r < N && k0 + c < K;
      cp_async16(&bs[buf][r][c], ok ? wq + (ll)(n0 + r) * K + k0 + c : wq, ok);
    }
  };

  Acc acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ksteps = (K + BK - 1) / BK;
  stage_b(0, 0);
  cp_async_commit();
  load_a(0);
  store_a(0);
  for (int ks = 0; ks < ksteps; ++ks) {
    const int buf = ks & 1;
    const bool more = ks + 1 < ksteps;
    if (more) {
      stage_b(buf ^ 1, (ks + 1) * BK);
      load_a((ks + 1) * BK);  // in flight during the products below
    }
    cp_async_commit();
    cp_async_wait<1>();  // this step's wq tile has landed
    __syncthreads();     // and every thread's quantized x tile is stored
    if constexpr (S8) {
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
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[MT][4], b[NT][2];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int r = wm + i * 16 + g;
          a[i][0] = lds_pair_bf16(&as[buf][r][kk + 2 * t]);
          a[i][1] = lds_pair_bf16(&as[buf][r + 8][kk + 2 * t]);
          a[i][2] = lds_pair_bf16(&as[buf][r][kk + 8 + 2 * t]);
          a[i][3] = lds_pair_bf16(&as[buf][r + 8][kk + 8 + 2 * t]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int n = wn + j * 8 + g;
          b[j][0] = lds_pair_bf16(&bs[buf][n][kk + 2 * t]);
          b[j][1] = lds_pair_bf16(&bs[buf][n][kk + 8 + 2 * t]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    }
    // the other buffer's last readers finished before the barrier above
    if (more) store_a(buf ^ 1);
    __syncthreads();  // this buffer is staged again at the next step
  }

  // epilogue: (float(acc) * xs[m]) * ws[n], rounded once each, then to bf16
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn + j * 8 + 2 * t;
    if (n >= N) continue;  // N % 8 == 0: n + 1 < N too
    const float s0 = ws[n], s1 = ws[n + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = wm + i * 16 + g + 8 * hf;
        const ll m = m0 + r;
        if (m >= M) continue;
        const float v0 = __fmul_rn(__fmul_rn((float)acc[i][j][2 * hf], xs[r]), s0);
        const float v1 = __fmul_rn(__fmul_rn((float)acc[i][j][2 * hf + 1], xs[r]), s1);
        *reinterpret_cast<__nv_bfloat162*>(out + m * N + n) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

template <typename XT, bool S8>
int launch(const void* x, const void* wq, const void* ws, void* out, ll M,
           int N, int K, ll x_sm, cudaStream_t st) {
  const ll gx = (M + BM - 1) / BM;
  if (gx > 0x7fffffffLL || (N + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)gx, (N + BN - 1) / BN);
  w8a8_fused_kernel<XT, S8><<<grid, NTH, 0, st>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ws), static_cast<bf16*>(out), M, N, K, x_sm);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) rows with stride x_sm (elements), contiguous along K, float32
// (x_dtype 0) or bfloat16 (1); wq: int8 (K, N) stored K-major (element
// [k, n] at n * K + k); ws: (N,) float32; out: contiguous (M, N) bfloat16.
// s8: 1 = exact s8 x s8 -> s32 product, 0 = int-valued bf16 operands with
// an f32 sum. The caller guarantees 16-byte aligned x, x rows and wq,
// K % 16 == 0 (K % 32 == 0 for s8) and N % 8 == 0. Returns the cudaError_t
// of the launch (0 = success).
extern "C" int sdvar_w8a8_fused(const void* x, const void* wq, const void* ws,
                                void* out, int x_dtype, int s8, long long M,
                                int N, int K, long long x_sm, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || (s8 && K % 32) || N % 8 ||
      (x_dtype != 0 && x_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1)
    return s8 ? launch<bf16, true>(x, wq, ws, out, M, N, K, x_sm, st)
              : launch<bf16, false>(x, wq, ws, out, M, N, K, x_sm, st);
  return s8 ? launch<float, true>(x, wq, ws, out, M, N, K, x_sm, st)
            : launch<float, false>(x, wq, ws, out, M, N, K, x_sm, st);
}
