// Fused activation quantization, hand-written for Hopper (sm_90a), bound to
// PyTorch through a plain C function loaded with ctypes.
//
// Replaces the TPU kernel sdvar_tpu/ops/pallas/quantize.py:_kernel (reached
// through act_quantize). Same function, one pass over each row of x (M, K):
//   h = f32(x) + bias                                      (bias optional)
//   h = (0.5 h) (1 + tanh(0.7978845608028654 (h + ((0.044715 h) h) h)))  (gelu)
//   s = max(amax|h| / 127, 1e-8)                           per row, f32
//   q = rint(h / s) as int8                                (no clip needed)
// in three modes: quantize (s and q written), scale only (s written: the
// first pass of a row split over ranks) and given scale (s read, q
// written: the second pass, under the whole row's scale).
//
// Numerics against the plain PyTorch version (act_quantize_plain):
//   - every product and sum is an IEEE round-to-nearest operation in the
//     plain version's order (__fmul_rn, __fadd_rn: never contracted into
//     an FMA), the scale an IEEE division by 127, the rounding rint (half
//     to even; CUDA's roundf rounds half away from zero);
//   - q = rint(fl(h / s)) exactly, without an IEEE division per element:
//     p = fl(h * r) with r = fl(1 / s) lies within 3 x 2^-24 |h / s| of
//     the IEEE quotient (under 2.3e-5 for |h / s| <= 128), so rint(p) is
//     rint(fl(h / s)) unless p lies that close to a half-integer. Where p
//     lies within 2^-12 of one (about 5e-4 of the elements), the load it
//     belongs to is quantized again from IEEE quotients __fdiv_rn(h, s).
//     ops/kernels/quantize.py:exact_quotient_rint is the rule in PyTorch,
//     and tests/test_torch_act_quant_plan.py holds it against
//     torch.round(h / s) on exact ties and near-ties at every |q| <= 127;
//   - without GELU the kernel gives the plain version's bits; with GELU
//     CUDA's tanhf is within 2 ulp of the correctly rounded value and
//     PyTorch's tanh within 1, so an h may differ in its last bit and a q
//     sitting on a rounding boundary move by one step.
//
// Bound on this card: memory. At the fc2 input of the d30 decode's last
// scale (M = 8192, K = 7680, bf16, bias + GELU) it reads 126 MB and writes
// 63 MB of int8 plus the scales: 0.056 ms at 3.35 TB/s. With GELU the
// instructions come close to that too: about 38 an element (tanhf and the
// GELU polynomial 28 of them) take 0.08 ms to dispatch on 132 SMs, so the
// arithmetic is cut where bits allow it: one multiply in place of a
// division, rint by one add of 1.5 x 2^23 (its low byte is the int8), no
// int conversion. Without GELU (K = 1920) the bytes bound it.
//
// Design. A row is held by a group of G threads (a power of two from 32 to
// 1024, from the launch plan ops/kernels/quantize.py:quant_plan), each
// with NV = 1 to 3 16-byte loads of it in registers (8 bf16 or 4 f32
// elements; one element a load when K is not a multiple of that), strided
// by the group so that a warp's loads are contiguous: many threads with
// few loads each keep the chains of dependent arithmetic short, and a
// launch of few rows (the decode's first scales) takes one load a thread.
// The row's amax is a warp shuffle reduction, and through shared memory
// across the group's warps when G > 32 (one barrier a row); then every
// thread quantizes its own elements from registers and stores them as one
// 8- or 4-byte word a load. x is read once and q written once. The grid is
// at most what the card holds at once (2048 threads an SM), and each block
// walks its rows gridDim.x blocks apart, fetching its next row into
// registers before it works on the current one, so the loads of one row
// are in flight while the previous one is reduced and quantized; without
// GELU those loads are marked as x's last use. The host side launches
// through ctypes with no Python launcher in between: the W8A8 decode makes
// 1200 of these launches, most of them at the host's pace.
//
// Measured against the Triton kernel it replaced (tools/ab_act_quant.py,
// H100 SXM): the fc2 input at the last scale 0.1993 -> 0.127 ms, K = 1920
// 0.0237 -> 0.0216 ms, one W8A8 decode's 1200 launches 25.4 -> 18.6 ms. The
// GELU pass is bound by its arithmetic (tanhf is most of it: without the
// arithmetic 0.069 ms); a scale-only pass with GELU, which has no division
// to save, is about as fast as before.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long ll;
typedef __nv_bfloat16 bf16;

// One load of x or the bias: 16 bytes (8 bf16 or 4 f32), 8 bytes (4 bf16:
// the bias of an f32 x) or one element, kept as raw bits until used. LAST:
// the load is the data's last use (ld.global.lu, evict first)
template <typename T, int VW, bool LAST = false>
__device__ __forceinline__ uint4 fetch(const T* p) {
  if constexpr (VW * sizeof(T) == 16) {
    const uint4* u = reinterpret_cast<const uint4*>(p);
    return LAST ? __ldlu(u) : __ldg(u);
  } else if constexpr (VW * sizeof(T) == 8) {
    const uint2* a = reinterpret_cast<const uint2*>(p);
    const uint2 u = LAST ? __ldlu(a) : __ldg(a);
    return make_uint4(u.x, u.y, 0u, 0u);
  } else if constexpr (sizeof(T) == 2) {
    const unsigned short* a = reinterpret_cast<const unsigned short*>(p);
    return make_uint4((uint32_t)(LAST ? __ldlu(a) : __ldg(a)), 0u, 0u, 0u);
  } else {
    const float* a = reinterpret_cast<const float*>(p);
    return make_uint4(__float_as_uint(LAST ? __ldlu(a) : __ldg(a)), 0u, 0u, 0u);
  }
}

// the f32 values of a fetched load (a bf16 is the top half of its f32)
template <typename T, int VW>
__device__ __forceinline__ void unpack(uint4 u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < (VW + 1) / 2; ++j) {
      f[2 * j] = __uint_as_float(w[j] << 16);
      if (2 * j + 1 < VW) f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int j = 0; j < (VW < 4 ? VW : 4); ++j) f[j] = __uint_as_float(w[j]);
  }
}

// VW bias values at element k as f32 (an 8-wide f32 bias is two loads)
template <int VW>
__device__ __forceinline__ void load_bias(const void* bias, int bias_bf16,
                                          ll k, float (&b)[VW]) {
  if (bias_bf16) {
    unpack<bf16, VW>(fetch<bf16, VW>(static_cast<const bf16*>(bias) + k), b);
  } else if constexpr (VW == 8) {
    const float* p = static_cast<const float*>(bias) + k;
    unpack<float, 4>(fetch<float, 4>(p), b);
    unpack<float, 4>(fetch<float, 4>(p + 4), b + 4);
  } else {
    unpack<float, VW>(fetch<float, VW>(static_cast<const float*>(bias) + k), b);
  }
}

// this thread's loads of row xr (vector i = lane + v * G); past the row
// (or an invalid row: nvec = 0) they are zeros
template <typename XT, int VW, int NV, bool LAST>
__device__ __forceinline__ void fetch_row(const XT* xr, int lane, int G,
                                          int nvec, uint4 (&raw)[NV]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int i = lane + v * G;
    raw[v] = i < nvec ? fetch<XT, VW, LAST>(xr + (ll)i * VW)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the fetched row in f32, plus the bias
template <typename XT, int VW, int NV>
__device__ __forceinline__ void unpack_row(const uint4 (&raw)[NV],
                                           const void* bias, int bias_bf16,
                                           int lane, int G, int nvec,
                                           float (&h)[NV][VW]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    unpack<XT, VW>(raw[v], h[v]);
    const int i = lane + v * G;
    if (bias != nullptr && i < nvec) {
      float b[VW];
      load_bias<VW>(bias, bias_bf16, (ll)i * VW, b);
#pragma unroll
      for (int e = 0; e < VW; ++e) h[v][e] = __fadd_rn(h[v][e], b[e]);
    }
  }
}

// tanh-GELU in the plain version's order of IEEE operations
__device__ __forceinline__ float gelu(float h) {
  const float c = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, h), h), h);
  const float z = __fmul_rn(0.7978845608028654f, __fadd_rn(h, c));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.f, tanhf(z)));
}

// GELU (if asked) in place and this thread's amax of |h|
template <bool GELU, int NV, int VW>
__device__ __forceinline__ void to_h(float (&h)[NV][VW], float& amax) {
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < VW; ++e) {
      if constexpr (GELU) h[v][e] = gelu(h[v][e]);
      amax = fmaxf(amax, fabsf(h[v][e]));
    }
}

// the max over the G threads of a row group (G = 32 .. 1024: the group's
// warps are consecutive warps of the block); every thread of the block
// calls it (a __syncthreads when G > 32; red alternates between two
// buffers from one row to the next, so one barrier a row suffices)
__device__ __forceinline__ float group_max(float v, int lane, int G, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (G > 32) {
    const int warp = threadIdx.x >> 5, first = warp - (lane >> 5);
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    v = red[first];
    for (int w = 1; w < (G >> 5); ++w) v = fmaxf(v, red[first + w]);
  }
  return v;
}

// VW elements quantized from p = fl(h * r), r = fl(1 / s), packed into
// words (4 int8 a word, element 0 in the low byte): p + 1.5 * 2^23 holds
// rint(p) in its low mantissa bits (for |p| <= 2^22; the caller
// guarantees |p| <= 128), so one add rounds half to even and its low byte
// is the int8. Returns whether an element lies within 2^-12 of a
// half-integer: there rint(p) may differ from rint(fl(h / s)) (p is within
// 3 x 2^-24 x 128 < 2^-12 of the quotient), and the caller re-does the
// vector with IEEE quotients.
template <int VW>
__device__ __forceinline__ bool quantize_vec(const float (&h)[VW], float r,
                                             uint32_t (&w)[(VW + 3) / 4]) {
  constexpr float MAGIC = 12582912.f;  // 1.5 * 2^23
  uint32_t m[VW];
  bool near = false;
#pragma unroll
  for (int e = 0; e < VW; ++e) {
    const float p = __fmul_rn(h[e], r);
    const float mf = __fadd_rn(p, MAGIC);
    const float d = fabsf(__fsub_rn(p, __fsub_rn(mf, MAGIC)));  // exact
    near |= d >= 0.499755859375f;  // 0.5 - 2^-12
    m[e] = __float_as_uint(mf);
  }
  if constexpr (VW == 1) {
    w[0] = m[0];
  } else {
#pragma unroll
    for (int j = 0; j < VW / 4; ++j)
      w[j] = __byte_perm(__byte_perm(m[4 * j], m[4 * j + 1], 0x0040),
                         __byte_perm(m[4 * j + 2], m[4 * j + 3], 0x0040),
                         0x5410);
  }
  return near;
}

// the same vector from IEEE quotients: rint(fl(h / s)) exactly
template <int VW>
__device__ __forceinline__ void quantize_vec_exact(const float (&h)[VW],
                                                   float s,
                                                   uint32_t (&w)[(VW + 3) / 4]) {
  int q[VW];
#pragma unroll
  for (int e = 0; e < VW; ++e) q[e] = __float2int_rn(__fdiv_rn(h[e], s));
  if constexpr (VW == 1) {
    w[0] = (uint32_t)q[0];
  } else {
#pragma unroll
    for (int j = 0; j < VW / 4; ++j)
      w[j] = (uint32_t)(q[4 * j] & 255) | ((uint32_t)(q[4 * j + 1] & 255) << 8) |
             ((uint32_t)(q[4 * j + 2] & 255) << 16) | ((uint32_t)q[4 * j + 3] << 24);
  }
}

template <int VW>
__device__ __forceinline__ void store_q(int8_t* p, const uint32_t (&w)[(VW + 3) / 4]) {
  if constexpr (VW == 1)
    *p = (int8_t)(w[0] & 255);
  else if constexpr (VW == 4)
    *reinterpret_cast<uint32_t*>(p) = w[0];
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// XT: x's type; VW: elements a load (16 bytes' worth, or 1); NV: loads a
// thread; GELU. mode 0: quantize, 1: scale only, 2: given scale. A block
// of blockDim.x threads holds blockDim.x / G rows (G = 1 << gshift) at a
// time and walks the rows gridDim.x blocks apart, fetching its next rows
// into registers before it works on the current ones.
template <typename XT, int VW, int NV, bool GELU>
__global__ void __launch_bounds__(1024) act_quantize_kernel(
    const XT* __restrict__ x, const void* __restrict__ bias, int bias_bf16,
    int8_t* __restrict__ q, float* __restrict__ s, int M, int K, ll xs,
    int gshift, int mode) {
  __shared__ float red[2][1024 / 32];
  const int G = 1 << gshift;  // a power of two: shifts, no division
  const int lane = threadIdx.x & (G - 1);
  const int rows = blockDim.x >> gshift;
  const int nvec_row = (K + VW - 1) / VW;
  int row = blockIdx.x * rows + (threadIdx.x >> gshift);
  // x is read once: without GELU, where the bytes bound the kernel, its
  // loads are marked as its last use, so that it leaves L2 first
  // (tools/ab_act_quant.py: 8% at the decode's last scale; with GELU,
  // where the arithmetic bounds it, no gain)
  constexpr bool LAST = !GELU;
  uint4 raw[NV];
  fetch_row<XT, VW, NV, LAST>(x + (ll)min(row, M - 1) * xs, lane, G,
                              row < M ? nvec_row : 0, raw);
  for (int it = 0; (ll)(blockIdx.x + (ll)it * gridDim.x) * rows < M; ++it) {
    const bool valid = row < M;  // a row past M still joins the barrier
    const int nvec = valid ? nvec_row : 0;
    float h[NV][VW];
    unpack_row<XT, VW, NV>(raw, bias, bias_bf16, lane, G, nvec, h);
    const int next = row + gridDim.x * rows;
    fetch_row<XT, VW, NV, LAST>(x + (ll)min(next, M - 1) * xs, lane, G,
                                next < M ? nvec_row : 0, raw);
    float own = 0.f;  // this thread's amax
    to_h<GELU>(h, own);
    float sc;
    if (mode == 2) {
      sc = valid ? s[row] : 1.f;
    } else {
      const float amax = group_max(own, lane, G, red[it & 1]);
      sc = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
      if (valid && lane == 0) s[row] = sc;
    }
    if (mode != 1) {
      const float r = __frcp_rn(sc);
      // the fast rounding needs a normal r and |h * r| <= 128 (so under
      // the row's own scale; a given scale is at least that)
      const bool careful = !(r >= 0x1p-126f) || !(__fmul_rn(own, r) <= 128.f);
      int8_t* qr = q + (ll)(valid ? row : 0) * K;
      uint32_t redo = 0;  // loads to re-do with IEEE quotients
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int i = lane + v * G;
        if (i < nvec) {
          uint32_t w[(VW + 3) / 4];
          const bool near = quantize_vec<VW>(h[v], r, w);
          if (near || careful)
            redo |= 1u << v;
          else
            store_q<VW>(qr + (ll)i * VW, w);
        }
      }
      if (redo) {  // about 5e-4 of the elements, one load at a time
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if ((redo >> v) & 1) {
            uint32_t w[(VW + 3) / 4];
            quantize_vec_exact<VW>(h[v], sc, w);
            store_q<VW>(qr + (ll)(lane + v * G) * VW, w);
          }
      }
    }
    row = next;
  }
}

template <typename XT, int VW, int NV>
cudaError_t launch_nv(const void* x, const void* bias, int bias_bf16, void* q,
                      void* s, int M, int K, ll xs, int gelu, int mode,
                      int group, int threads, int grid, cudaStream_t st) {
  if (grid <= 0 || (ll)grid * threads > (ll)M * group + threads)
    return cudaErrorInvalidValue;
  auto args = [&](auto kernel) {
    kernel<<<grid, threads, 0, st>>>(
        static_cast<const XT*>(x), bias, bias_bf16, static_cast<int8_t*>(q),
        static_cast<float*>(s), M, K, xs, 31 - __builtin_clz(group), mode);
  };
  if (gelu)
    args(act_quantize_kernel<XT, VW, NV, true>);
  else
    args(act_quantize_kernel<XT, VW, NV, false>);
  return cudaGetLastError();
}

template <typename XT, int VW>
cudaError_t launch(int nv, const void* x, const void* bias, int bias_bf16,
                   void* q, void* s, int M, int K, ll xs, int gelu, int mode,
                   int group, int threads, int grid, cudaStream_t st) {
  switch (nv) {
    case 1: return launch_nv<XT, VW, 1>(x, bias, bias_bf16, q, s, M, K, xs, gelu, mode, group, threads, grid, st);
    case 2: return launch_nv<XT, VW, 2>(x, bias, bias_bf16, q, s, M, K, xs, gelu, mode, group, threads, grid, st);
    case 3: return launch_nv<XT, VW, 3>(x, bias, bias_bf16, q, s, M, K, xs, gelu, mode, group, threads, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, K) rows with stride x_stride (elements), contiguous along K,
// float32 (x_dtype 0) or bfloat16 (1); bias: (K,) float32 (bias_dtype 0)
// or bfloat16 (1), or null; q: contiguous int8 (M, K) (unused in mode 1);
// s: (M,) float32, written (modes 0, 1) or read (mode 2). group (32 ..
// 1024 threads a row, a power of two), nv (1 to 3 loads a thread), vector
// (1: 16-byte loads, the caller guarantees K a multiple of 16 / itemsize
// and 16-byte aligned x rows and bias; 0: one element a load), threads
// (128 .. 1024 a block, a multiple of group) and grid (blocks, at most one
// for each threads / group rows) come from ops/kernels/quantize.py:
// quant_plan. Returns the cudaError_t of the launch (0 = success).
extern "C" int sdvar_act_quantize(const void* x, const void* bias, void* q,
                                  void* s, int x_dtype, int bias_dtype, int M,
                                  int K, long long x_stride, int gelu, int mode,
                                  int group, int nv, int vector, int threads,
                                  int grid, void* stream) {
  const int vw = vector ? (x_dtype == 1 ? 8 : 4) : 1;
  if (M <= 0 || K <= 0 || (x_dtype != 0 && x_dtype != 1) ||
      (bias_dtype != 0 && bias_dtype != 1) || mode < 0 || mode > 2 ||
      group < 32 || group > 1024 || (group & (group - 1)) ||
      threads < 128 || threads > 1024 || threads % group ||
      nv < 1 || nv > 3 || (ll)group * nv * vw < K || (vector && K % vw))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bb = bias_dtype == 1;
  if (x_dtype == 1)
    return vector ? (int)launch<bf16, 8>(nv, x, bias, bb, q, s, M, K, x_stride, gelu, mode, group, threads, grid, st)
                  : (int)launch<bf16, 1>(nv, x, bias, bb, q, s, M, K, x_stride, gelu, mode, group, threads, grid, st);
  return vector ? (int)launch<float, 4>(nv, x, bias, bb, q, s, M, K, x_stride, gelu, mode, group, threads, grid, st)
                : (int)launch<float, 1>(nv, x, bias, bb, q, s, M, K, x_stride, gelu, mode, group, threads, grid, st);
}
