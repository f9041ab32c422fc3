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
// for torch._int_mm), ws f32 (N,). A compile-time S8 flag picks the product:
//   S8 = true:  s8 x s8 -> s32 wgmma, an exact sum;
//   S8 = false: the same int values as bf16 (exact) on bf16 wgmma with an
//               f32 sum, which rounds once partial sums pass 2^24 (K * 127^2
//               can reach 1.2e8 at K = 7680): the TPU's pl_bf16 form.
// The division, the rounding (rintf) and the two epilogue products are
// separate IEEE operations (__fdiv_rn, __fmul_rn: never contracted into an
// FMA), in the plain PyTorch version's order, so the S8 form gives its bits.
//
// The TPU kernel holds a (bm, K) strip of x and a (K, bn) slab of wq in VMEM
// per program and quantizes the strip there. The per-token scale needs all
// of K before the first quantized value, and a quantized 256-row strip does
// not fit shared memory at large K (1.9 MB at K = 7680), so here each strip
// is quantized once, into a scratch in device memory (the wrapper's; 15.7
// MB at fc1, which stays in the 50 MB L2), and the product reads it from
// there. One persistent block an SM (384 threads, at most one block an SM
// and at most the card's SMs, launched cooperatively so that all blocks are
// resident together) walks a work list in which every quantization comes
// before every product:
//   1. quantization units of 32 rows, gridDim.x apart: one warp a row, the
//      amax over K with 16-byte loads, then x / xs rounded and stored as
//      int8 (the bf16 form: as int-valued bf16, and its weights converted
//      once into a bf16 copy, 32 columns a unit). Each finished unit adds
//      one to its strip's (or weight tile's) flag with a release at GPU
//      scope, after a proxy fence that makes the generic stores visible to
//      the tensor-memory accelerator's reads;
//   2. output tiles of 256 x 160, gridDim.x apart: one thread of the
//      producer warpgroup waits (acquire) until its strip's flag counts all
//      of its units, then keeps a ring of four stages full with TMA loads of
//      the quantized x box (128 bytes of K x 256 rows) and the weight box
//      (128 bytes x 160 columns), both K-major in the 128-byte swizzle that
//      wgmma reads; it gives its registers up (setmaxnreg) to the two
//      consumer warpgroups, which each multiply 128 of the rows by all 160
//      columns: two m64n160 wgmma a 32-byte K step (k32 s8 or k16 bf16),
//      no wgmma under a branch, one stage's products in flight while the
//      next is awaited, the stage released to the producer once its
//      products are done. The epilogue applies xs (read after its own
//      acquire of the strip's flag) and ws and stores bf16 pairs, while the
//      producer already loads the next tile's stages.
// No block waits before it has done all of its own quantization units, and
// every block is resident (the cooperative launch guarantees it or fails),
// so the waits end. The wrapper's scratch holds the
// quantized x, xs, the bf16 weights (bf16 form) and the flags, which this
// function zeroes on the stream before the launch (cudaMemsetAsync), so a
// launch can be captured in a CUDA graph after one eager call.
//
// Bound at the d30 fc1 shape of the decode's last scale (B=32 requests, CFG
// doubled: M = 8192, K = 1920, N = 7680): 2*M*K*N = 242 G int8 operations,
// 0.122 ms at the H100 SXM's 1979 dense int8 TOP/s (0.244 ms in the bf16
// form at 989 TFLOP/s), against 2*M*K + K*N + 2*M*N = 172 MB moved (0.051 ms
// at 3.35 TB/s): operations bound it. A 256 x 160 tile draws 416 bytes of
// operands from L2 per 32 x 2 x 256 x 160 int8 operations, about 10 TB/s of
// L2 traffic at the int8 peak, which is what holds a tile of this size
// back.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_map.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef long long ll;

constexpr int TILE_M = 256;               // rows of an output tile
constexpr int TILE_N = 160;               // columns of an output tile
constexpr int KB = 128;                   // bytes of K a stage (a swizzle row)
constexpr int XB = TILE_M * KB;           // the x box of a stage
constexpr int SB = (TILE_M + TILE_N) * KB;  // a stage: 53248 bytes, 52 x 1024
constexpr int STAGES = 4;                 // ring depth
constexpr int THREADS = 384;              // producer and two consumer warpgroups
constexpr int UNIT = 32;                  // rows (columns of wq) a unit
constexpr int ALIGN = 1024;               // scratch parts start 1024-aligned

constexpr int SMEM_BYTES = 1024 + STAGES * SB;  // 1024 bytes of alignment slack
__host__ __device__ constexpr ll align_up(ll v) {
  return (v + ALIGN - 1) / ALIGN * ALIGN;
}

// units of a strip of TILE_M rows (of a weight tile of TILE_N columns)
__device__ __forceinline__ int units_in(ll total, ll start, int tile) {
  const ll n = total - start < tile ? total - start : tile;
  return (int)((n + UNIT - 1) / UNIT);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
// generic-proxy global writes made visible to the async proxy (TMA), and
// the async proxy's later reads ordered after an acquire
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void wait_flag(const int* f, int target) {
  while (ld_acquire(f) < target) __nanosleep(100);
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

// rows [r0, r1) of x quantized into xq (int8, or int-valued bf16 when !S8)
// and xs: one warp a row, two passes over the row (amax, then values)
template <typename XT, bool S8>
__device__ void quantize_rows(const XT* __restrict__ x, ll x_sm, void* xq,
                              float* __restrict__ xs, ll r0, ll r1, int K) {
  constexpr int VEC = 16 / sizeof(XT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (ll m = r0 + warp; m < r1; m += THREADS / 32) {
    const XT* row = x + m * x_sm;
    float amax = 0.f;
    for (int k = lane * VEC; k < K; k += 32 * VEC) {
      float f[VEC];
      widen(*reinterpret_cast<const uint4*>(row + k), f, row);
#pragma unroll
      for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(f[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
    if (lane == 0) xs[m] = s;
    for (int k = lane * VEC; k < K; k += 32 * VEC) {
      float f[VEC];
      widen(*reinterpret_cast<const uint4*>(row + k), f, row);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f[i] = rintf(__fdiv_rn(f[i], s));
      if constexpr (S8) {
        uint32_t w[VEC / 4];
#pragma unroll
        for (int i = 0; i < VEC / 4; ++i)
          w[i] = (uint32_t)(uint8_t)(int8_t)__float2int_rn(f[4 * i]) |
                 (uint32_t)(uint8_t)(int8_t)__float2int_rn(f[4 * i + 1]) << 8 |
                 (uint32_t)(uint8_t)(int8_t)__float2int_rn(f[4 * i + 2]) << 16 |
                 (uint32_t)(uint8_t)(int8_t)__float2int_rn(f[4 * i + 3]) << 24;
        int8_t* q = static_cast<int8_t*>(xq) + m * K + k;
        if constexpr (VEC == 8)
          *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
        else
          *reinterpret_cast<uint32_t*>(q) = w[0];
      } else {
        uint32_t w[VEC / 2];
#pragma unroll
        for (int i = 0; i < VEC / 2; ++i) w[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
        bf16* q = static_cast<bf16*>(xq) + m * K + k;
        if constexpr (VEC == 8)
          *reinterpret_cast<uint4*>(q) = make_uint4(w[0], w[1], w[2], w[3]);
        else
          *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
      }
    }
  }
}

// columns [n0, n1) of wq (K bytes each) as int-valued bf16 rows of wb
__device__ void convert_weights(const int8_t* __restrict__ wq, bf16* wb,
                                ll n0, ll n1, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (ll n = n0 + warp; n < n1; n += THREADS / 32)
    for (int k = lane * 16; k < K; k += 32 * 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(wq + n * K + k);
      const uint32_t in[4] = {v.x, v.y, v.z, v.w};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) int8x4_to_bf16(in[i], o[2 * i], o[2 * i + 1]);
      uint4* d = reinterpret_cast<uint4*>(wb + n * K + k);
      d[0] = make_uint4(o[0], o[1], o[2], o[3]);
      d[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
}

template <bool S8>
using Acc = typename std::conditional<S8, int, float>::type;

// this warpgroup's products of one stage: 128 rows (two m64 tiles) by the
// 160 columns, one 32-byte K step at a time
template <bool S8>
__device__ __forceinline__ void stage_products(Acc<S8> (&acc)[2][TILE_N / 8][4],
                                               uint32_t st, int wg, bool first) {
#pragma unroll
  for (int kk = 0; kk < KB / 32; ++kk)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint64_t ad = gmma_desc(st + (wg * 2 + i) * 64 * KB + kk * 32, 16, 8 * KB, 1);
      const uint64_t bd = gmma_desc(st + XB + kk * 32, 16, 8 * KB, 1);
      if constexpr (S8)
        wgmma_s8_n160(acc[i], ad, bd, !first || kk > 0);
      else
        wgmma_bf16_n160(acc[i], ad, bd, !first || kk > 0);
    }
}

__device__ __forceinline__ void store_row(bf16* out_row, int n, float v0,
                                          float v1, int N) {
  *reinterpret_cast<__nv_bfloat162*>(out_row + n) = __floats2bfloat162_rn(v0, v1);
}

template <typename XT, bool S8>
__global__ void __launch_bounds__(THREADS, 1) w8a8_fused_kernel(
    const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
    const XT* __restrict__ x, ll x_sm, const int8_t* __restrict__ wq,
    const float* __restrict__ ws, bf16* __restrict__ out, void* xq,
    float* xs, bf16* wb, int* flags, ll M, int N, int K, int tiles_m,
    int tiles_n) {
  extern __shared__ __align__(1024) uint8_t smem_base[];
  __shared__ uint64_t full[STAGES], empty[STAGES];
  uint8_t* ring = smem_base + ((1024 - (smem_u32(smem_base) & 1023)) & 1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // 1. this block's quantization units (and the bf16 form's weight units)
  const ll units_x = (M + UNIT - 1) / UNIT;
  const ll units_w = S8 ? 0 : (N + UNIT - 1) / UNIT;
  for (ll u = blockIdx.x; u < units_x + units_w; u += gridDim.x) {
    int* flag;
    if (u < units_x) {
      const ll r0 = u * UNIT, r1 = r0 + UNIT < M ? r0 + UNIT : M;
      quantize_rows<XT, S8>(x, x_sm, xq, xs, r0, r1, K);
      flag = flags + r0 / TILE_M;
    } else {
      const ll n0 = (u - units_x) * UNIT, n1 = n0 + UNIT < N ? n0 + UNIT : N;
      convert_weights(wq, wb, n0, n1, K);
      flag = flags + tiles_m + n0 / TILE_N;
    }
    fence_proxy_global();
    __syncthreads();
    if (tid == 0) {
      __threadfence();
      red_release_add(flag, 1);
    }
  }

  // 2. the output tiles
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int tiles = tiles_m * tiles_n;
  const int ksteps = (int)(((ll)K * (S8 ? 1 : 2) + KB - 1) / KB);

  if (warp < 4) {  // the producer warpgroup: one thread starts the loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int step = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int tm = tile / tiles_n, tn = tile - tm * tiles_n;
        wait_flag(flags + tm, units_in(M, (ll)tm * TILE_M, TILE_M));
        if (!S8) wait_flag(flags + tiles_m + tn, units_in(N, (ll)tn * TILE_N, TILE_N));
        fence_proxy_global();
        for (int ks = 0; ks < ksteps; ++ks, ++step) {
          const int s = step % STAGES;
          if (step >= STAGES) mbar_wait(&empty[s], ((step / STAGES) + 1) & 1);
          mbar_expect_tx(&full[s], SB);
          tma_load_2d(ring + s * SB, &ta, ks * KB, tm * TILE_M, &full[s]);
          tma_load_2d(ring + s * SB + XB, &tb, ks * KB, tn * TILE_N, &full[s]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
    const uint32_t ring_addr = smem_u32(ring);
    int step = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int tm = tile / tiles_n, tn = tile - tm * tiles_n;
      Acc<S8> acc[2][TILE_N / 8][4];
      const int first = step;
      // wait for the next stage, run its products, release the stage
      // before it (its products are done once one group is in flight)
      auto arrived = [&]() {
        const int s = step % STAGES;
        mbar_wait(&full[s], (step / STAGES) & 1);
        wgmma_fence();
        return ring_addr + s * SB;
      };
      auto release = [&]() {
        wgmma_commit();
        wgmma_wait<1>();
        if (step > first && lane == 0) mbar_arrive(&empty[(step - 1) % STAGES]);
      };
      for (int ks = 0; ks < ksteps; ++ks, ++step) {
        stage_products<S8>(acc, arrived(), wg, step == first);
        release();
      }
      wgmma_wait<0>();
      if constexpr (S8) {
        pin_s32(acc[0]);
        pin_s32(acc[1]);
      } else {
        pin(acc[0]);
        pin(acc[1]);
      }
      if (lane == 0) mbar_arrive(&empty[(step - 1) % STAGES]);

      // (float(acc) * xs[m]) * ws[n], rounded as two IEEE products, then
      // bf16; rows past M and columns past N are not stored
      wait_flag(flags + tm, units_in(M, (ll)tm * TILE_M, TILE_M));
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const ll m = (ll)tm * TILE_M + (wg * 2 + i) * 64 + (warp & 3) * 16 + g + 8 * hf;
          if (m >= M) continue;
          const float sx = xs[m];
#pragma unroll
          for (int j = 0; j < TILE_N / 8; ++j) {
            const int n = tn * TILE_N + j * 8 + 2 * t;
            if (n >= N) continue;  // N % 8 == 0: n + 1 < N too
            const float v0 = __fmul_rn(__fmul_rn((float)acc[i][j][2 * hf], sx), ws[n]);
            const float v1 = __fmul_rn(__fmul_rn((float)acc[i][j][2 * hf + 1], sx), ws[n + 1]);
            store_row(out + m * N, n, v0, v1, N);
          }
        }
    }
  }
}

// a 2-d tensor map of int8 elements: rows of `row_bytes`, `rows` of them,
// a box of 128 bytes x box_rows in the 128-byte swizzle; out-of-range
// elements read as zeros
bool map_2d(CUtensorMap* map, const void* base, ll row_bytes, ll rows,
            int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {KB, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Scratch {
  ll xq, xs, wb, flags, bytes;  // byte offsets of the parts, and the total
};

Scratch scratch_layout(ll M, ll N, ll K, bool s8) {
  Scratch s;
  s.xq = 0;
  s.xs = align_up(M * K * (s8 ? 1 : 2));
  s.wb = s.xs + align_up(M * 4);
  s.flags = s.wb + (s8 ? 0 : align_up(N * K * 2));
  const ll nflags = (M + TILE_M - 1) / TILE_M + (s8 ? 0 : (N + TILE_N - 1) / TILE_N);
  s.bytes = s.flags + nflags * 4;
  return s;
}

int sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 0;
  }
  return n;
}

template <typename XT, bool S8>
int launch(const void* x, const void* wq, const void* ws, void* out, ll M,
           int N, int K, ll x_sm, void* scratch, int grid, cudaStream_t st) {
  const Scratch sc = scratch_layout(M, N, K, S8);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  const int tiles_m = (int)((M + TILE_M - 1) / TILE_M);
  const int tiles_n = (N + TILE_N - 1) / TILE_N;
  const int nflags = tiles_m + (S8 ? 0 : tiles_n);
  CUtensorMap ta, tb;
  if (!map_2d(&ta, base + sc.xq, (ll)K * (S8 ? 1 : 2), M, TILE_M) ||
      !map_2d(&tb, S8 ? wq : (const void*)(base + sc.wb), (ll)K * (S8 ? 1 : 2), N,
              TILE_N))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;  // the shared-memory limit, raised once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(w8a8_fused_kernel<XT, S8>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaError_t err = cudaMemsetAsync(base + sc.flags, 0, nflags * 4, st);
  if (err != cudaSuccess) return (int)err;
  // a cooperative launch: the runtime starts every block at once or
  // refuses the launch, so the flag waits end
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, w8a8_fused_kernel<XT, S8>, ta, tb, static_cast<const XT*>(x), x_sm,
      static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<bf16*>(out), static_cast<void*>(base + sc.xq),
      reinterpret_cast<float*>(base + sc.xs), reinterpret_cast<bf16*>(base + sc.wb),
      reinterpret_cast<int*>(base + sc.flags), M, N, K, tiles_m, tiles_n);
}

}  // namespace

// x: (M, K) rows with stride x_sm (elements), contiguous along K, float32
// (x_dtype 0) or bfloat16 (1); wq: int8 (K, N) stored K-major (element
// [k, n] at n * K + k); ws: (N,) float32; out: contiguous (M, N) bfloat16;
// scratch: sdvar_w8a8_fused_scratch_bytes(M, N, K, s8) bytes, 1024-byte
// aligned. s8: 1 = exact s8 x s8 -> s32 product, 0 = int-valued bf16
// operands with an f32 sum. grid (blocks: at most the card's SMs) comes
// from ops/kernels/w8a8_fused.py:w8a8_plan. The
// caller guarantees 16-byte aligned x, x rows and wq, K % 16 == 0 (K % 32
// == 0 for s8) and N % 8 == 0. Returns the cudaError_t of the first
// failing call (0 = success).
extern "C" int sdvar_w8a8_fused(const void* x, const void* wq, const void* ws,
                                void* out, int x_dtype, int s8, long long M,
                                int N, int K, long long x_sm, void* scratch,
                                int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 || (s8 && K % 32) || N % 8 ||
      (x_dtype != 0 && x_dtype != 1) || grid < 1 || grid > sms() ||
      (M + TILE_M - 1) / TILE_M > 0x7fffffffLL / ((N + TILE_N - 1) / TILE_N) ||
      reinterpret_cast<uintptr_t>(scratch) % ALIGN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1)
    return s8 ? launch<bf16, true>(x, wq, ws, out, M, N, K, x_sm, scratch, grid, st)
              : launch<bf16, false>(x, wq, ws, out, M, N, K, x_sm, scratch, grid, st);
  return s8 ? launch<float, true>(x, wq, ws, out, M, N, K, x_sm, scratch, grid, st)
            : launch<float, false>(x, wq, ws, out, M, N, K, x_sm, scratch, grid, st);
}

// Bytes of the scratch a launch needs (the quantized x, xs, the bf16 form's
// weights and the flags), to hold ops/kernels/w8a8_fused.py:w8a8_plan to it.
extern "C" long long sdvar_w8a8_fused_scratch_bytes(long long M, int N, int K,
                                                    int s8) {
  return scratch_layout(M, N, K, s8 != 0).bytes;
}

// Dynamic shared memory of a launch, in bytes.
extern "C" int sdvar_w8a8_fused_smem_bytes() { return SMEM_BYTES; }
