// INT8-weight matmul, hand-written for Hopper (sm_90a), bound to PyTorch
// through a plain C function loaded with ctypes.
//
// Replaces the TPU kernel sdvar_tpu/ops/pallas/matmul_int8.py:_kernel
// (reached through int8_matmul / int8_matmul_blc). Same function:
//   out[m, n] = (sum_k x[m, k] * q[k, n]) * s[n]
// with x bf16 or f32 (M, K), q int8 (K, N) in the JAX layout, f32
// accumulation, and the per-output-channel scale applied once, in the
// epilogue, to the f32 sum (not folded into the weights), then cast to x's
// type.
//
// The TPU kernel walks K as a sequential grid axis into a VMEM accumulator.
// Here each block owns a (64 x warpgroups) x BN output tile (BN = 64 or
// 128) and runs the K loop itself, 64 of K a step, on the tensor cores
// through wgmma, for both activation types:
//   - thread 0 keeps the x tiles and int8 weight tiles of a ring of 3-4
//     stages in dynamic shared memory filled by TMA (cp.async.bulk.tensor
//     with 128- or 64-byte swizzle, zeros past M, N and K), completing on
//     one mbarrier a stage; the tensor maps are encoded on the host per
//     launch through the driver's entry point (nothing more to link);
//   - while the tensor cores multiply tile kt, every thread waits for tile
//     kt + 1 and converts its int8 weight tile into a bf16 tile in wgmma's
//     swizzled layout (exact: |q| <= 127; a byte permute and a subtraction
//     per element, no int -> float convert), into the other of two
//     buffers; one __syncthreads a tile. The weight tile keeps q's (K, N)
//     layout and is read MN-major through the transpose bit; weights never
//     exist as bf16 in device memory.
//   - bf16 x (the weight-only "w8" decode's block GEMMs): the x tile lands
//     in the 128-byte swizzle and is wgmma's K-major A operand straight from
//     shared memory.
//   - f32 x (the logits head, W8A8 and w8): every f32 is the exact sum of
//     three bf16 pieces, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi
//     - mid), and each piece times an int8 weight is exact in f32, so three
//     bf16 products summed in f32 compute the same function as an f32 one;
//     only the order of the additions differs. Each warp reads its x rows
//     from shared memory (f32, swizzled so the reads are conflict-free),
//     splits them in registers and issues the three products lo, mid, hi
//     with x as wgmma's register A operand, the converted weight tile used
//     three times. The tensor cores' f32 accumulation does not round like
//     IEEE additions, so each 64-deep K tile sums into a fresh accumulator
//     that is then added into the running sum with IEEE FADDs. No TF32.
//   - small M (the decode's first scales): a cluster of 2-8 blocks along z
//     splits K, and the blocks add their partial tiles through distributed
//     shared memory in a fixed order (the same bits every run).
//
// Bound on this card (H100 SXM data sheet): at the d30 fc1 shape (M=8192,
// K=1920, N=7680, bf16) 241 GFLOP, 0.244 ms at the bf16 tensor-core peak,
// against about 60 MB moved (0.018 ms): operations. At the head shape
// (M=8192, K=1920, N=4096, f32) the function needs 3 x 2MKN = 387 GFLOP
// of bf16 products through the exact split, 0.391 ms, against 1.92 ms for
// 2MKN at the 67 TFLOP/s f32 rate of the CUDA cores: that is a correction
// of the yardstick (the lesser of the two is the least time this card
// needs), not a gain. At small M (M = 32-800) the weight bytes bound the
// function (up to 14.7 MB of int8 a GEMM, 4.4 us), and a block is bound by
// its loop's latency, which the split of K shortens. What still holds the
// loop back (tools/ab_int8_matmul.py --ablate): the conversion pass and the
// tensor-core products, each about a quarter of fc1's time, run by the same
// threads behind one barrier a tile.
//
// The C function allocates nothing and does not synchronise; the dynamic
// shared memory limit of each instance is raised once, at first use, so a
// launch can be captured in a CUDA graph after one eager call.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_map.cuh"
#include "wgmma.cuh"

namespace {

namespace cg = cooperative_groups;
typedef __nv_bfloat16 bf16;
typedef long long ll;

constexpr int BK = 64;              // K per ring tile: one 128-byte bf16 row
constexpr int WG_ROWS = 64;         // output rows per warpgroup
constexpr int MAX_STAGES = 4;       // ring depth the launch accepts (3..4)
constexpr int MAX_SPLITS = 8;       // blocks of a cluster that split K
constexpr int RED_PAD = 4;          // f32 padding of a reduction row
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take

// One stage of the ring: the x tile (64 x warpgroups rows of BK elements of
// x's type), then the int8 weight tile (BK rows of BN); after the ring, two
// bf16 weight tiles for the conversion pass (each of BN / 64 atoms of BK
// 128-byte rows). Every part is a multiple of 1024 bytes, the period of the
// 128-byte swizzle, and 1024 bytes of slack align the base.
__host__ __device__ constexpr int x_tile_bytes(bool f32, int wg) {
  return wg * WG_ROWS * BK * (f32 ? 4 : 2);
}
__host__ __device__ constexpr int stage_bytes(bool f32, int wg, int bn) {
  return x_tile_bytes(f32, wg) + BK * bn;
}
__host__ __device__ constexpr int conv_bytes(int bn) { return BK * bn * 2; }
__host__ __device__ constexpr int smem_bytes(bool f32, int wg, int bn,
                                             int stages) {
  return 1024 + stages * stage_bytes(f32, wg, bn) + 2 * conv_bytes(bn);
}
// split K: the block's f32 partial tile, padded rows, over the ring
__host__ __device__ constexpr int red_bytes(int wg, int bn) {
  return wg * WG_ROWS * (bn + RED_PAD) * 4;
}

// Byte offset of 16-byte chunk c of row r of the x tile, as TMA's 128-byte
// swizzle lays it down: bf16 rows are 128 bytes (wgmma's K-major layout);
// an f32 tile comes as two boxes of 32 columns, [half][row][128 bytes], so
// a warp's fragment reads are conflict-free.
template <bool F32, int BM>
__device__ __forceinline__ int x_off(int r, int c) {
  if constexpr (F32)
    return (c >> 3) * (BM * 128) + swz128(r, c & 7);
  else
    return swz128(r, c);
}

// Byte offset of 16-byte chunk c of row r of the raw int8 weight tile, as
// TMA lays it down: rows of 128 bytes in the 128-byte swizzle, or for BN =
// 64 rows of 64 bytes in the 64-byte swizzle (chunk c ^ (r / 2 % 4)); the
// conversion pass's reads of eight rows at one chunk are conflict-free
template <int BN>
__device__ __forceinline__ int q_off(int r, int c) {
  if constexpr (BN == 64)
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  else
    return swz128(r, c);
}

__device__ __forceinline__ void store_pair(float* out, ll i, float a, float b) {
  *reinterpret_cast<float2*>(out + i) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(bf16* out, ll i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_quad(float* out, ll i, float4 v) {
  *reinterpret_cast<float4*>(out + i) = v;
}

__device__ __forceinline__ void store_quad(bf16* out, ll i, float4 v) {
  uint2 w = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  *reinterpret_cast<uint2*>(out + i) = w;
}

// XT: x's type (bf16 or float); WG: warpgroups (64 output rows each); BN:
// output columns per block (64 or 128). blockDim.x = 128 * WG; the ring
// has `stages` stages (3..4). tx / tq: TMA maps of x (boxes of 64 x BM
// bf16, or 32 x BM f32) and q (boxes of BN x 64 int8). With splits > 1 the
// launch is a cluster of `splits` blocks along z, each summing its share of
// K; the cluster adds the partials through distributed shared memory in a
// fixed order and each block stores a slice of the rows.
template <typename XT, int WG, int BN>
__global__ void __launch_bounds__(128 * WG,
                                  std::is_same<XT, float>::value ? 1 : 2)
    int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tq,
                             const float* __restrict__ s, XT* __restrict__ out,
                             int M, int N, int K, int stages, int splits) {
  constexpr bool F32 = std::is_same<XT, float>::value;
  constexpr int NT = 128 * WG;
  constexpr int BM = WG_ROWS * WG;
  constexpr int XB = x_tile_bytes(F32, WG);
  constexpr int SB = stage_bytes(F32, WG, BN);
  constexpr int CB = conv_bytes(BN);
  constexpr int QCH = BN / 16;  // 16-byte chunks per weight row
  constexpr int NF = BN / 8;    // accumulator n-tiles
  extern __shared__ __align__(1024) uint8_t smem_base[];
  __shared__ uint64_t full[MAX_STAGES];  // a stage's tiles have landed
  uint8_t* ring = smem_base + ((1024 - (smem_u32(smem_base) & 1023)) & 1023);
  uint8_t* conv = ring + stages * SB;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // this block's K tiles: an even share of them under a split
  const int nk_all = (K + BK - 1) / BK;
  const int share = (nk_all + splits - 1) / splits;
  const int kt0 = blockIdx.z * share;
  const int nk = max(0, min(nk_all, kt0 + share) - kt0);

  // thread 0 issues the TMA loads of K tile kt into its stage: the x tile
  // (f32: two boxes of 32 columns) and the weight tile
  auto issue = [&](int kt) {
    uint8_t* st = ring + (kt % stages) * SB;
    uint64_t* bar = &full[kt % stages];
    const int k0 = (kt0 + kt) * BK;
    mbar_expect_tx(bar, SB);
#pragma unroll
    for (int h = 0; h < (F32 ? 2 : 1); ++h)
      tma_load_2d(st + h * (BM * 128), &tx, k0 + 32 * h, m0, bar);
    tma_load_2d(st + XB, &tq, n0, k0, bar);
  };
  auto arrived = [&](int kt) { mbar_wait(&full[kt % stages], (kt / stages) & 1); };

  // the arrived int8 weight tile kt -> bf16 in conversion buffer kt % 2:
  // atom n / 64, row k, chunk (n % 64) / 8 under the 128-byte swizzle. Eight
  // consecutive threads take one chunk of eight consecutive rows.
  auto convert = [&](int kt) {
    const uint8_t* raw = ring + (kt % stages) * SB + XB;
    uint8_t* dst = conv + (kt & 1) * CB;
    for (int i = tid; i < BK * QCH; i += NT) {
      const int grp = i >> 3, c = grp % QCH;
      const int r = ((grp / QCH) << 3) | (i & 7);
      const uint4 w = *reinterpret_cast<const uint4*>(raw + q_off<BN>(r, c));
      uint4 a, b;
      int8x4_to_bf16(w.x, a.x, a.y);
      int8x4_to_bf16(w.y, a.z, a.w);
      int8x4_to_bf16(w.z, b.x, b.y);
      int8x4_to_bf16(w.w, b.z, b.w);
      uint8_t* row = dst + (c >> 2) * (BK * 128);
      const int ch = (c & 3) * 2;
      *reinterpret_cast<uint4*>(row + swz128(r, ch)) = a;
      *reinterpret_cast<uint4*>(row + swz128(r, ch + 1)) = b;
    }
  };

  // f32 x: part holds one K tile's products, a its hi, mid and lo
  // fragments of each k-step
  float acc[NF][4], part[NF][4];
  uint32_t a[BK / 16][3][4];
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[j][e] = 0.f;

  // the first stages - 1 tiles in flight, then tile 0 converted
  if (tid == 0) {
    for (int st = 0; st < stages; ++st) mbar_init(&full[st], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int kt = 0; kt < stages - 1 && kt < nk; ++kt) issue(kt);
  if (nk > 0) {
    arrived(0);
    convert(0);
  }

  const int wrow = wg * WG_ROWS + (warp & 3) * 16;  // this warp's 16 rows
  for (int it = 0; it < nk; ++it) {
    // every warpgroup's products of tile it - 1 are done, so its stage and
    // conversion buffer are free; tile it (waited for by every thread
    // before it converted it) and its conversion are visible to the tensor
    // cores, and every generic access to the stage refilled next is
    // ordered before the TMA write. Tile it + 1 is waited for only where
    // it is converted, while tile it's products run.
    fence_proxy_async();
    __syncthreads();
    const uint8_t* st = ring + (it % stages) * SB;
    const uint32_t wb = smem_u32(conv + (it & 1) * CB);
    // B = the bf16 weight tile, MN-major: k-step kk is 16 rows on, the
    // next 64 columns the next atom
    auto bdesc = [&](int kk) {
      return gmma_desc(wb + kk * 16 * 128, BK * 128, 1024, 1);
    };
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = wrow + g + 8 * hf, col = kk * 16 + 8 * c + 2 * t;
            const float2 v = *reinterpret_cast<const float2*>(
                st + x_off<true, BM>(r, col >> 2) + (col & 3) * 4);
            split_bf16x3(v.x, v.y, a[kk][0][hf + 2 * c], a[kk][1][hf + 2 * c],
                         a[kk][2][hf + 2 * c]);
          }
        wgmma_fence();
        // lo and mid before hi; the tile's first product overwrites
        wgmma_rs<BN>(part, a[kk][2], bdesc(kk), kk > 0);
        wgmma_rs<BN>(part, a[kk][1], bdesc(kk), 1);
        wgmma_rs<BN>(part, a[kk][0], bdesc(kk), 1);
      }
      wgmma_commit();
      if (tid == 0 && it + stages - 1 < nk) issue(it + stages - 1);
      if (it + 1 < nk) {
        arrived(it + 1);
        convert(it + 1);
      }
      wgmma_wait<0>();
      pin(part);
      pin_a(a[0]);
      pin_a(a[1]);
      pin_a(a[2]);
      pin_a(a[3]);
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    } else {
      const uint32_t xb = smem_u32(st) + wg * WG_ROWS * 128;
      pin(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss<BN>(acc, gmma_desc(xb + kk * 32, 16, 1024, 1), bdesc(kk), 1);
      wgmma_commit();
      if (tid == 0 && it + stages - 1 < nk) issue(it + stages - 1);
      if (it + 1 < nk) {
        arrived(it + 1);
        convert(it + 1);
      }
      wgmma_wait<0>();
      pin(acc);
    }
  }

  if (splits == 1) {
    // the f32 sum times the column scale, cast once (a warpgroup whose
    // rows all lie past M multiplied zeros and stores nothing)
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const int n = n0 + j * 8 + 2 * t;
      if (n >= N) continue;
      const float s0 = s[n], s1 = s[n + 1];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = m0 + wrow + g + 8 * hf;
        if (m < M)
          store_pair(out, (ll)m * N + n, acc[j][2 * hf] * s0,
                     acc[j][2 * hf + 1] * s1);
      }
    }
    return;
  }

  // split K: each block's partial tile into its own shared memory (the
  // ring is free: every load has landed and been used), then block z of
  // the cluster sums rows [z, z+1) * BM / splits of every block's partial,
  // in the order of the blocks, scales and stores them
  constexpr int RS = BN + RED_PAD;
  float* red = reinterpret_cast<float*>(ring);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(red + (wrow + g + 8 * hf) * RS + j * 8 + 2 * t) =
          make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = BM / splits, r0 = (int)cluster.block_rank() * rows;
  for (int i = tid; i < rows * (BN / 4); i += NT) {
    const int r = r0 + i / (BN / 4), c = (i % (BN / 4)) * 4;
    const int m = m0 + r, n = n0 + c;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z = 0; z < splits; ++z) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red, z) + r * RS + c);
      sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
    }
    if (m < M && n < N)
      store_quad(out, (ll)m * N + n,
                 make_float4(sum.x * s[n], sum.y * s[n + 1], sum.z * s[n + 2],
                             sum.w * s[n + 3]));
  }
  cluster.sync();  // no block leaves while another reads its partial
}

// A 2-d tensor map: dims (inner, outer), outer stride in bytes, a box of
// (box0, box1) elements in the given swizzle; zeros past the edges
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                ll inner, ll outer, ll stride_bytes, int box0, int box1,
                CUtensorMapSwizzle swizzle) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box0, (cuuint32_t)box1};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename XT, int WG, int BN>
cudaError_t launch_one(const void* x, const int8_t* q, const float* s,
                       void* out, int M, int N, int K, ll x_sm, int stages,
                       int splits, cudaStream_t st) {
  constexpr bool F32 = std::is_same<XT, float>::value;
  const int smem = smem_bytes(F32, WG, BN, stages);
  if (smem > SMEM_LIMIT || (splits > 1 && red_bytes(WG, BN) >
                                              stages * stage_bytes(F32, WG, BN)))
    return cudaErrorInvalidValue;
  CUtensorMap tx, tq;
  if (!tensor_map(&tx, F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  x, K, M, x_sm * (ll)sizeof(XT), F32 ? 32 : 64,
                  WG * WG_ROWS, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, N, BN, BK,
                  BN == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  static int configured = 0;  // the largest ring this instance was given
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_wgmma_kernel<XT, WG, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN, (M + WG * WG_ROWS - 1) / (WG * WG_ROWS),
                     splits);
  cfg.blockDim = dim3(128 * WG);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, int8_matmul_wgmma_kernel<XT, WG, BN>, tx,
                            tq, s, static_cast<XT*>(out), M, N, K, stages,
                            splits);
}

template <typename XT>
cudaError_t launch_tile(int wg, int bn, const void* x, const int8_t* q,
                        const float* s, void* out, int M, int N, int K,
                        ll x_sm, int stages, int splits, cudaStream_t st) {
#define SDVAR_TILE(W, C)                                                   \
  if (wg == W && bn == C)                                                  \
    return launch_one<XT, W, C>(x, q, s, out, M, N, K, x_sm, stages, splits, \
                                st);
  SDVAR_TILE(1, 64)
  SDVAR_TILE(1, 128)
  SDVAR_TILE(2, 64)
  SDVAR_TILE(2, 128)
#undef SDVAR_TILE
  return cudaErrorInvalidValue;
}

bool bad_tile(int x_dtype, int wg, int bn, int stages, int splits) {
  return (x_dtype != 0 && x_dtype != 1) || (wg != 1 && wg != 2) ||
         (bn != 64 && bn != 128) || stages < 3 || stages > MAX_STAGES ||
         splits < 1 || splits > MAX_SPLITS || (splits & (splits - 1));
}

}  // namespace

// x: (M, K) rows with stride x_sm (elements), contiguous along K; q: (K, N)
// int8 contiguous; s: (N,) float32; out: contiguous (M, N) in x's type.
// Types: 0 = float32, 1 = bfloat16. The caller guarantees 16-byte alignment
// of x, q and their rows, K % 8 == 0 and N % 16 == 0. warpgroups (1 or 2:
// 64 or 128 output rows a block), block_n (64 or 128 columns), stages (3
// or 4) and splits (1, 2, 4 or 8 blocks of a cluster sharing K) come from
// ops/kernels/matmul_int8.py:matmul_plan. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int sdvar_int8_matmul(const void* x, const void* q, const void* s,
                                 void* out, int x_dtype, int M, int N, int K,
                                 long long x_sm, void* stream, int warpgroups,
                                 int block_n, int stages, int splits) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 16 ||
      bad_tile(x_dtype, warpgroups, block_n, stages, splits) ||
      (M + warpgroups * WG_ROWS - 1) / (warpgroups * WG_ROWS) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sf = static_cast<const float*>(s);
  if (x_dtype == 1)
    return (int)launch_tile<bf16>(warpgroups, block_n, x, qi, sf, out, M, N,
                                  K, x_sm, stages, splits, st);
  return (int)launch_tile<float>(warpgroups, block_n, x, qi, sf, out, M, N, K,
                                 x_sm, stages, splits, st);
}

// Dynamic shared memory one block takes for these types and tiles, in bytes
// (0 for a tile the kernel does not take): the compiler's -Xptxas -v report
// shows none of it.
extern "C" int sdvar_int8_matmul_smem_bytes(int x_dtype, int warpgroups,
                                            int block_n, int stages) {
  if (bad_tile(x_dtype, warpgroups, block_n, stages, 1)) return 0;
  return smem_bytes(x_dtype == 0, warpgroups, block_n, stages);
}
