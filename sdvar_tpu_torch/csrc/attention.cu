// Fused attention for VAR's KV-cached decode, hand-written for Hopper
// (sm_90a), bound to PyTorch through plain C functions loaded with ctypes.
//
// Replaces three TPU kernels with one attention loop:
//   - sdvar_tpu/ops/pallas/attention.py:_kernel, both branches (reached
//     through _pallas_forward / pallas_attention): sdvar_attention and
//     sdvar_attention_int8;
//   - sdvar_tpu/ops/pallas/experimental.py:_cache_kernel (reached through
//     pallas_attention_cache): attention over layer li of the stacked KV
//     cache, keys [0, kv_len): sdvar_attention_cache with write = 0;
//   - experimental.py:_write_kernel (reached through
//     pallas_attention_cache_write): the same, after writing this scale's
//     new keys and values (and, int8, their scales) into the cache at
//     [cache_begin, kv_len): sdvar_attention_cache with write = 1.
// Same function:
//   out = softmax(q k^T * scale + bias) v
// with the softmax in f32, the running max clamped at -1e30 so that a row
// whose bias is all -inf gives zeros (not NaN), the probabilities cast to
// v's type before the PV product (as the TPU kernel does), and the output
// divided by max(l, 1e-30) AFTER the PV product.
//
// INT8-KV branch (k/v int8 with per-token f32 scales ks, vs of shape
// (B, Lk), read through strides out of the cache's (depth, B, L_max)
// planes): the int8 values are converted to q's type (exact in bf16) as
// the K/V tiles are staged in shared memory, so no dequantised copy ever
// reaches device memory. The order is the TPU kernel's:
//   s_ij = (q_i . kq_j) * scale * ks_j  (+ bias_ij)
//   p_ij = exp(s_ij - m_i);  l_i = sum_j p_ij   (l BEFORE the value scale)
//   o_i  = sum_j cast_q(p_ij * vs_j) vq_j / max(l_i, 1e-30)
// A float cache in f32 under a bf16 q (kv_mode "f32" with a bf16 model) is
// rounded to bf16 as it is staged, as the unfused path's cast does.
//
// The cache write (WRITE): the TPU kernel DMAs aligned windows of the cache
// into VMEM, merges the new rows in and DMAs them back (read-merge-write,
// because Mosaic slices HBM in 8-row windows), then attends over keys it
// composed from the old prefix and the new rows. Here the attention loop
// has a split key source: rows below cache_begin come from the cache, rows
// from cache_begin on from the new rows themselves (a tile that straddles
// cache_begin takes rows from both). Every block stages every key row, so
// the block whose query tile holds new row r stores it into
// cache[li, b, cache_begin + r, head] from the registers it passes through
// (widened to f32 for an f32 cache; the blocks of head 0 also store the
// per-token scales): each new element is written once, with no
// read-merge-write and no pass of its own. No block reads a row that
// another block writes, so the grid needs no synchronisation, and the keys
// and values the loop sees are bit for bit those of "copy into the cache,
// then attend": the fused kernel gives the same output bits as the unfused
// pair.
//
// Bound on this card: memory. At the decode shapes (2B=32, H=30, hd=64,
// bf16, Lq = pn^2 <= 256, Lk <= 680) one launch moves q, k, v and o once
// (about 230 MB at the last 256px scale, ~69 us at 3.35 TB/s) against
// 43 GFLOP (~43 us at the bf16 tensor-core peak). With int8 K/V the bytes
// fall to about 147 MB (~44 us), level with the operations. The cache
// write reads the new rows and writes them once more (about 293 MB at the
// last scale, ~87 us): fused, it saves the two copy launches per layer and
// the unfused pair's re-read of the rows it has just written.
//
// Two kernels, one per type of q; both keep the (Lq, Lk) score matrix out
// of device memory with an online softmax over 64-key tiles, and both read
// K/V through strides straight out of the KV cache of one layer
// (batch-major or token-major), so nothing is copied per layer; q may be a
// strided view of the fused qkv output.
//   - bf16 (the main path): tensor cores through mma.sync m16n8k16 with f32
//     accumulation. One block of 4 warps per (64-query tile, head, batch
//     row); each warp owns 16 query rows, keeps its q fragments, scores,
//     softmax statistics and output in registers, and reads the key tile
//     (row-major) and the value tile (transposed) from shared memory.
//   - f32: scalar FMAs on the CUDA cores (the tensor cores take no full-f32
//     operands). One block of 256 threads per (64-query tile, head, batch
//     row), each thread owning a 4 x 4 tile of scores and a 4 x (hd/16) tile
//     of the output, with q, k and p staged transposed in shared memory.
// The TPU version's whole-Lk-in-VMEM blocking and 128-lane head packing
// are VMEM tuning and are not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef long long ll;

// What one launch reads and writes. Keys and values [0, split) come from
// k/v (a cache layer or plain k/v operands: any batch/token strides, heads
// packed), int8 with per-token f32 scales ks/vs, element (b, j) at
// b * s_sb + j * s_sl. With WRITE, keys and values [split, Lk) are the new
// rows kn/vn (row r = j - split; int8 scales kns/vns at b * ns_sb +
// r * ns_sl), which the kernel also stores into k/v (and ks/vs) at rows
// split + r; then Lk = split + Lq. Without it, split = Lk. The kernels
// also take every pointer they read as a __restrict__ parameter of its own:
// known to be global and unaliased, a thread's K/V loads of a tile are
// issued together ahead of its shared-memory stores (pointers read out of
// this struct may alias the shared tiles, which serialises those loads:
// 15-35% slower at the decode shapes). They write k/v/ks/vs only through
// the struct, at rows no launch reads through the parameters.
struct Params {
  const void* q;
  void* out;
  const float* bias;
  void* k;
  void* v;
  float* ks;
  float* vs;
  const void* kn;
  const void* vn;
  const float* kns;
  const float* vns;
  int Lq, Lk, H, split;
  ll q_sb, q_sl, k_sb, k_sl, v_sb, v_sl, s_sb, s_sl;
  ll kn_sb, kn_sl, vn_sb, vn_sl, ns_sb, ns_sl;
  float scale;
};

// N values of T in one aligned word: 8, 16 or more bytes, loaded and
// stored as vectors
template <typename T, int N>
struct alignas(N * sizeof(T) < 16 ? N * sizeof(T) : 16) Pack {
  T x[N];
};

// The type of the new rows under a q of type QT and a cache of type KC:
// int8 for an int8 cache, else q's type
template <typename QT, typename KC>
using New = typename std::conditional<std::is_same<KC, int8_t>::value,
                                      int8_t, QT>::type;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

// exact except float -> bf16, which rounds to nearest even as torch's cast
template <typename OT, typename T>
__device__ __forceinline__ OT cvt(T x) {
  if constexpr (std::is_same<OT, T>::value) {
    return x;
  } else if constexpr (std::is_same<OT, bf16>::value) {
    return __float2bfloat16_rn(to_f32(x));
  } else {
    static_assert(std::is_same<OT, float>::value, "no such conversion");
    return to_f32(x);
  }
}

// N zeros of T
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> zeros() {
  Pack<T, N> r;
#pragma unroll
  for (int w = 0; w < int(N * sizeof(T) / 4); ++w)
    reinterpret_cast<uint32_t*>(r.x)[w] = 0u;
  return r;
}

// a Pack of T as OT: a copy when the types agree, bf16 pairs converted
// together (cvt.rn.bf16x2.f32)
template <typename OT, typename T, int N>
__device__ __forceinline__ Pack<OT, N> cvt_pack(const Pack<T, N>& x) {
  if constexpr (std::is_same<OT, T>::value) {
    return x;
  } else {
    Pack<OT, N> o;
    if constexpr (std::is_same<OT, bf16>::value) {
#pragma unroll
      for (int e = 0; e < N; e += 2)
        *reinterpret_cast<__nv_bfloat162*>(&o.x[e]) =
            __floats2bfloat162_rn(to_f32(x.x[e]), to_f32(x.x[e + 1]));
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) o.x[e] = cvt<OT>(x.x[e]);
    }
    return o;
  }
}

// The key and value rows one block reads, at its batch row and head: of
// k/v ([0, split)) and of the new rows ([split, Lk)); kw/vw, the same k/v
// rows to store the new ones into. Only the bases: the strides stay in the
// parameter block (constant memory, no registers).
template <typename KC, typename KN>
struct Rows {
  const KC* k;
  const KC* v;
  const KN* kn;
  const KN* vn;
  KC* kw;
  KC* vw;
};

template <typename KC, typename KN>
__device__ __forceinline__ Rows<KC, KN> block_rows(const Params& p,
                                                   const KC* k, const KC* v,
                                                   const KN* kn, const KN* vn,
                                                   ll b, ll hoff) {
  return {k + b * p.k_sb + hoff, v + b * p.v_sb + hoff,
          kn + b * p.kn_sb + hoff, vn + b * p.vn_sb + hoff,
          static_cast<KC*>(p.k) + b * p.k_sb + hoff,
          static_cast<KC*>(p.v) + b * p.v_sb + hoff};
}

// WRITE: whether this block owns new row j, the row of its own query tile
// (of ROWS queries): the one block of its head and batch row that stores it
// into the cache
template <int ROWS>
__device__ __forceinline__ bool owns(const Params& p, int j) {
  return j >= p.split && j < p.Lk && (j - p.split) / ROWS == (int)blockIdx.x;
}

// VE values of key (V = false) or value (V = true) row j, columns
// [d0, d0 + VE), as OT: rows [0, split) from k/v, rows [split, Lk) from the
// new rows, zeros past Lk (p is 0 there, and 0 * garbage may be NaN). The
// loads are predicated, not branched around, so a thread's loads of one
// tile can all be in flight together. WRITE: a new row the block owns is
// also stored into the cache (widened to f32 for an f32 cache) from the
// registers it was staged through, so it is read once and written once.
template <typename OT, int VE, int ROWS, bool WRITE, bool V, typename KC,
          typename KN>
__device__ __forceinline__ Pack<OT, VE> kv_row(const Params& p,
                                               const Rows<KC, KN>& r, int j,
                                               int d0) {
  const bool fresh = WRITE && j >= p.split;
  KC* dst = nullptr;
  if constexpr (WRITE)
    dst = (V ? r.vw : r.kw) + (ll)j * (V ? p.v_sl : p.k_sl) + d0;
  if constexpr (sizeof(KC) == sizeof(KN)) {  // one element type
    const KC* src = fresh ? reinterpret_cast<const KC*>(V ? r.vn : r.kn) +
                                (ll)(j - p.split) * (V ? p.vn_sl : p.kn_sl)
                          : (V ? r.v : r.k) + (ll)j * (V ? p.v_sl : p.k_sl);
    Pack<KC, VE> x = zeros<KC, VE>();
    if (j < p.Lk) x = *reinterpret_cast<const Pack<KC, VE>*>(src + d0);
    if constexpr (WRITE)
      if (owns<ROWS>(p, j)) *reinterpret_cast<Pack<KC, VE>*>(dst) = x;
    return cvt_pack<OT>(x);
  } else {  // an f32 cache under bf16 q and new rows
    Pack<KC, VE> x = zeros<KC, VE>();
    Pack<KN, VE> xn = zeros<KN, VE>();
    if (j < p.Lk && !fresh)
      x = *reinterpret_cast<const Pack<KC, VE>*>(
          (V ? r.v : r.k) + (ll)j * (V ? p.v_sl : p.k_sl) + d0);
    if (j < p.Lk && fresh)
      xn = *reinterpret_cast<const Pack<KN, VE>*>(
          (V ? r.vn : r.kn) + (ll)(j - p.split) * (V ? p.vn_sl : p.kn_sl) + d0);
    if constexpr (WRITE)
      if (owns<ROWS>(p, j)) *reinterpret_cast<Pack<KC, VE>*>(dst) = cvt_pack<KC>(xn);
    return fresh ? cvt_pack<OT>(xn) : cvt_pack<OT>(x);
  }
}

// The int8 key or value scale of row j (sc: of k/v, nsc: of the new rows):
// 0 past Lk. WRITE: the owner of a new row in the blocks of head 0 also
// stores its scale into the cache's plane wsc.
template <int ROWS, bool WRITE>
__device__ __forceinline__ float kv_scale(const Params& p, const float* sc,
                                          const float* nsc, float* wsc, ll b,
                                          int h, int j) {
  if (j >= p.Lk) return 0.f;
  if (WRITE && j >= p.split) {
    const float s = nsc[b * p.ns_sb + (ll)(j - p.split) * p.ns_sl];
    if (h == 0 && owns<ROWS>(p, j)) wsc[b * p.s_sb + (ll)j * p.s_sl] = s;
    return s;
  }
  return sc[b * p.s_sb + (ll)j * p.s_sl];
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int MQ = 64;   // query rows per block (4 warps x 16)
constexpr int MK = 64;   // keys per shared-memory tile
constexpr int MT = 128;  // threads per block
constexpr int PAD = 8;   // bf16 padding per shared row: conflict-free fragments

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of m16n8k16 (lane = 4 * g + t): A element pairs at rows
// g / g+8 and columns 2t / 2t+8; B pairs at rows (k) 2t / 2t+8 and column
// (n) g; C pairs at rows g / g+8 and columns 2t, 2t+1.
// KC, the type of k/v: bf16, f32 (rounded to bf16 as staged) or int8 with
// the scales ksc/vsc (Q8). New rows (WRITE) come in bf16, or int8 under Q8.
// Float caches: at most 128 registers, so that 4 blocks share an SM (the
// WRITE instantiations would take 138-144 and fit only 3); int8 caches are
// left their own count.
template <typename KC>
constexpr int min_blocks() {
  return std::is_same<KC, int8_t>::value ? 1 : 4;
}

template <int HD, typename KC, bool WRITE>
__global__ void __launch_bounds__(MT, min_blocks<KC>()) attention_mma_kernel(
    const Params p, const bf16* __restrict__ q, const KC* __restrict__ k,
    const KC* __restrict__ v, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const New<bf16, KC>* __restrict__ kn,
    const New<bf16, KC>* __restrict__ vn, const float* __restrict__ knsc,
    const float* __restrict__ vnsc, const float* __restrict__ bias,
    bf16* __restrict__ out) {
  constexpr bool Q8 = std::is_same<KC, int8_t>::value;
  typedef New<bf16, KC> KN;
  constexpr int KS = HD / 16;  // k-steps of q k^T over the head dim
  constexpr int SN = MK / 8;   // score n-tiles per key tile
  constexpr int ON = HD / 8;   // output n-tiles
  // K/V elements per load: 16 bytes of the wider of the two sources
  constexpr int VE = 16 / (sizeof(KC) > sizeof(KN) ? sizeof(KC) : sizeof(KN));
  constexpr int CH = HD / VE;  // loads per key row
  __shared__ __align__(16) bf16 ks[MK][HD + PAD];  // [key][d]
  __shared__ __align__(16) bf16 vt[HD][MK + PAD];  // [d][key]
  __shared__ float kst[Q8 ? MK : 1], vst[Q8 ? MK : 1];  // the tile's scales

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const ll b = blockIdx.z;
  const int r0 = blockIdx.x * MQ + warp * 16;
  const ll hoff = (ll)h * HD;

  const bf16* qb = q + b * p.q_sb + hoff;
  const Rows<KC, KN> rows = block_rows<KC, KN>(p, k, v, kn, vn, b, hoff);

  // this warp's q as A fragments, straight from device memory; rows past
  // Lq are zero
  uint32_t qa[KS][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        qa[kk][hf + 2 * c] =
            r < p.Lq ? ld32(qb + (ll)r * p.q_sl + kk * 16 + 8 * c + 2 * t) : 0u;
  }

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int kv0 = 0; kv0 < p.Lk; kv0 += MK) {
    __syncthreads();  // the previous tile's readers are done
    // keys row-major: neighbouring threads read neighbouring words
    for (int i = threadIdx.x; i < MK * CH; i += MT) {
      const int c = i / CH, d0 = (i % CH) * VE;
      *reinterpret_cast<Pack<bf16, VE>*>(&ks[c][d0]) =
          kv_row<bf16, VE, MQ, WRITE, false>(p, rows, kv0 + c, d0);
    }
    // values transposed: neighbouring threads take neighbouring keys, so
    // the 2-byte stores into a [d] row do not collide in a bank
    for (int i = threadIdx.x; i < MK * CH; i += MT) {
      const int c = i % MK, d0 = (i / MK) * VE;
      if constexpr (sizeof(KC) == sizeof(KN)) {  // convert as each is stored
        const Pack<KC, VE> x = kv_row<KC, VE, MQ, WRITE, true>(p, rows, kv0 + c, d0);
#pragma unroll
        for (int e = 0; e < VE; ++e) vt[d0 + e][c] = cvt<bf16>(x.x[e]);
      } else {
        const Pack<bf16, VE> x = kv_row<bf16, VE, MQ, WRITE, true>(p, rows, kv0 + c, d0);
#pragma unroll
        for (int e = 0; e < VE; ++e) vt[d0 + e][c] = x.x[e];
      }
    }
    if constexpr (Q8) {
      if (threadIdx.x < MK) {
        const int j = kv0 + threadIdx.x;
        kst[threadIdx.x] = kv_scale<MQ, WRITE>(p, ksc, knsc, p.ks, b, h, j);
        vst[threadIdx.x] = kv_scale<MQ, WRITE>(p, vsc, vnsc, p.vs, b, h, j);
      }
    }
    __syncthreads();

    // scores (16 rows x 64 keys) in C fragments
    float s[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int n = 0; n < SN; ++n) {
        const bf16* kr = &ks[n * 8 + g][kk * 16 + 2 * t];
        mma_bf16(s[n], qa[kk], ld32(kr), ld32(kr + 8));
      }

    // online softmax of rows g (hf = 0) and g + 8 (hf = 1); a row's 64
    // columns lie in the 4 lanes that share g
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + g + 8 * hf;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = kv0 + n * 8 + 2 * t + e;
          float x = -INFINITY;
          if (c < p.Lk) {
            x = s[n][2 * hf + e] * p.scale;
            if constexpr (Q8) x *= kst[n * 8 + 2 * t + e];
            if (bias != nullptr && r < p.Lq) x += bias[(ll)r * p.Lk + c];
          }
          s[n][2 * hf + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // guard fully-masked rows: exp(-inf - -inf) would be NaN
      const float m_new = fmaxf(fmaxf(m[hf], mx), -1e30f);
      const float alpha = expf(m[hf] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < SN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pe = expf(s[n][2 * hf + e] - m_new);
          rs += pe;  // l sums p before the value scale folds in
          s[n][2 * hf + e] = Q8 ? pe * vst[n * 8 + 2 * t + e] : pe;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[hf] = l[hf] * alpha + rs;
      m[hf] = m_new;
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        o[n][2 * hf] *= alpha;
        o[n][2 * hf + 1] *= alpha;
      }
    }

    // o += p v: the C fragments of score n-tiles 2j, 2j+1 are the A
    // fragment of key step j
#pragma unroll
    for (int j = 0; j < MK / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        const bf16* vr = &vt[n * 8 + g][j * 16 + 2 * t];
        mma_bf16(o[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  // normalise after the PV product; out is contiguous (B, Lq, H, HD)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    if (r >= p.Lq) continue;
    const float denom = fmaxf(l[hf], 1e-30f);
    bf16* ob = out + ((b * p.Lq + r) * p.H + h) * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < ON; ++n)
      *reinterpret_cast<__nv_bfloat162*>(ob + n * 8) = __floats2bfloat162_rn(
          o[n][2 * hf] / denom, o[n][2 * hf + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// f32: scalar kernel on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int NT = 256;       // threads per block (16 x 16)
constexpr int SQ = BQ + 4;    // padded row stride of the transposed q / p tiles
constexpr int SK = BK + 4;    // padded row stride of the transposed k tile

__device__ __forceinline__ void load4(const float* p, float* out) {
  float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}

template <int HD>
constexpr size_t smem_bytes() {
  // qT (HD x SQ), kT (HD x SK), v (BK x HD), pT (BK x SQ), and the tile's
  // two rows of int8 key/value scales, all f32
  return sizeof(float) * (size_t(HD) * SQ + size_t(HD) * SK +
                          size_t(BK) * HD + size_t(BK) * SQ + 2 * size_t(BK));
}

// KC, the type of k/v and of the new rows: f32, or int8 with the scales.
template <int HD, typename KC, bool WRITE>
__global__ void __launch_bounds__(NT) attention_f32_kernel(
    const Params p, const float* __restrict__ q, const KC* __restrict__ k,
    const KC* __restrict__ v, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const New<float, KC>* __restrict__ kn,
    const New<float, KC>* __restrict__ vn, const float* __restrict__ knsc,
    const float* __restrict__ vnsc, const float* __restrict__ bias,
    float* __restrict__ out) {
  constexpr bool Q8 = std::is_same<KC, int8_t>::value;
  constexpr int VN = 4;                // q elements per 16-byte load
  constexpr int VE = 16 / sizeof(KC);  // K/V elements per 16-byte load
  constexpr int DJ = HD / 16;          // output columns per thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [d][r]
  float* kT = qT + HD * SQ;                      // [d][c]
  float* vs = kT + HD * SK;                      // [c][d]
  float* pT = vs + BK * HD;                      // [c][r]
  float* kst = pT + BK * SQ;                     // [c] key scales
  float* vst = kst + BK;                         // [c] value scales

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const ll b = blockIdx.z;
  const ll hoff = (ll)h * HD;

  const float* qb = q + b * p.q_sb + hoff;
  const Rows<KC, KC> rows = block_rows<KC, KC>(p, k, v, kn, vn, b, hoff);

  // stage this block's queries, transposed; rows past Lq are zero
  for (int i = tid; i < BQ * (HD / VN); i += NT) {
    const int r = i / (HD / VN), d0 = (i % (HD / VN)) * VN;
    float buf[VN] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < p.Lq) load4(qb + (ll)(q0 + r) * p.q_sl + d0, buf);
#pragma unroll
    for (int e = 0; e < VN; ++e) qT[(d0 + e) * SQ + r] = buf[e];
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < p.Lk; kv0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * (HD / VE); i += NT) {
      const int c = i / (HD / VE), d0 = (i % (HD / VE)) * VE;
      const Pack<float, VE> kx = kv_row<float, VE, BQ, WRITE, false>(p, rows, kv0 + c, d0);
      const Pack<float, VE> vx = kv_row<float, VE, BQ, WRITE, true>(p, rows, kv0 + c, d0);
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        kT[(d0 + e) * SK + c] = kx.x[e];
        vs[c * HD + d0 + e] = vx.x[e];
      }
    }
    if constexpr (Q8) {
      if (tid < BK) {
        kst[tid] = kv_scale<BQ, WRITE>(p, ksc, knsc, p.ks, b, h, kv0 + tid);
        vst[tid] = kv_scale<BQ, WRITE>(p, vsc, vnsc, p.vs, b, h, kv0 + tid);
      }
    }
    __syncthreads();

    // scores for rows ty*4+i, columns tx*4+j of this tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&qT[d * SQ + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(&kT[d * SK + tx * 4]);
      const float qr[4] = {qv.x, qv.y, qv.z, qv.w};
      const float kc[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kc[j], s[i][j]);
    }

    // online softmax; the 16 threads sharing ty hold one row's 64 columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = kv0 + tx * 4 + j;
        float x = -INFINITY;
        if (c < p.Lk) {
          x = s[i][j] * p.scale;
          if constexpr (Q8) x *= kst[tx * 4 + j];
          if (bias != nullptr && r < p.Lq) x += bias[(ll)r * p.Lk + c];
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      // guard fully-masked rows: exp(-inf - -inf) would be NaN
      const float m_new = fmaxf(fmaxf(m[i], mx), -1e30f);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pe = expf(s[i][j] - m_new);
        rs += pe;  // l sums p before the value scale folds in
        s[i][j] = Q8 ? pe * vst[tx * 4 + j] : pe;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&pT[(tx * 4 + j) * SQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int cmax = min(BK, p.Lk - kv0);
    for (int c = 0; c < cmax; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&pT[c * SQ + ty * 4]);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      float vc[DJ];
      if constexpr (DJ % 4 == 0) {
#pragma unroll
        for (int j4 = 0; j4 < DJ / 4; ++j4)
          load4(&vs[c * HD + tx * DJ + 4 * j4], &vc[4 * j4]);
      } else {
        const float2 t = *reinterpret_cast<const float2*>(&vs[c * HD + tx * DJ]);
        vc[0] = t.x;
        vc[1] = t.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pr[i], vc[j], acc[i][j]);
    }
  }

  // normalise after the PV product; out is contiguous (B, Lq, H, HD)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= p.Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* ob = out + ((b * p.Lq + r) * p.H + h) * HD + tx * DJ;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[j] = acc[i][j] / denom;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int HD, typename QT, typename KC, bool WRITE>
cudaError_t launch_one(const Params& p, int B, cudaStream_t stream) {
  if constexpr (std::is_same<QT, bf16>::value) {
    dim3 grid((p.Lq + MQ - 1) / MQ, p.H, B);
    attention_mma_kernel<HD, KC, WRITE><<<grid, MT, 0, stream>>>(
        p, static_cast<const QT*>(p.q), static_cast<const KC*>(p.k),
        static_cast<const KC*>(p.v), p.ks, p.vs,
        static_cast<const New<QT, KC>*>(p.kn),
        static_cast<const New<QT, KC>*>(p.vn), p.kns, p.vns, p.bias,
        static_cast<QT*>(p.out));
  } else {
    constexpr size_t smem = smem_bytes<HD>();
    static bool configured = false;
    if (!configured) {
      cudaError_t err = cudaFuncSetAttribute(
          attention_f32_kernel<HD, KC, WRITE>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      configured = true;
    }
    dim3 grid((p.Lq + BQ - 1) / BQ, p.H, B);
    attention_f32_kernel<HD, KC, WRITE><<<grid, NT, smem, stream>>>(
        p, static_cast<const QT*>(p.q), static_cast<const KC*>(p.k),
        static_cast<const KC*>(p.v), p.ks, p.vs,
        static_cast<const New<QT, KC>*>(p.kn),
        static_cast<const New<QT, KC>*>(p.vn), p.kns, p.vns, p.bias,
        static_cast<QT*>(p.out));
  }
  return cudaGetLastError();
}

template <typename QT, typename KC, bool WRITE>
cudaError_t launch_hd(int hd, const Params& p, int B, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_one<32, QT, KC, WRITE>(p, B, stream);
    case 64: return launch_one<64, QT, KC, WRITE>(p, B, stream);
    case 128: return launch_one<128, QT, KC, WRITE>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename KC>
cudaError_t launch_w(bool write, int hd, const Params& p, int B,
                     cudaStream_t stream) {
  return write ? launch_hd<QT, KC, true>(hd, p, B, stream)
               : launch_hd<QT, KC, false>(hd, p, B, stream);
}

// Type codes: 0 = float32, 1 = bfloat16, 2 = int8. The pairs (q, k/v):
// (bf16, bf16), (bf16, f32), (bf16, int8), (f32, f32), (f32, int8).
cudaError_t launch(int q_dtype, int kv_dtype, bool write, int hd,
                   const Params& p, int B, cudaStream_t stream) {
  if (q_dtype == 1) {
    switch (kv_dtype) {
      case 1: return launch_w<bf16, bf16>(write, hd, p, B, stream);
      case 0: return launch_w<bf16, float>(write, hd, p, B, stream);
      case 2: return launch_w<bf16, int8_t>(write, hd, p, B, stream);
    }
  } else if (q_dtype == 0) {
    switch (kv_dtype) {
      case 0: return launch_w<float, float>(write, hd, p, B, stream);
      case 2: return launch_w<float, int8_t>(write, hd, p, B, stream);
    }
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(int dtype, int B, int Lq, int Lk, int H) {
  return B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || H > 65535 || B > 65535 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; within a row,
// heads are packed (head h at offset h*hd) and the head dim is contiguous.
// bias: (Lq, Lk) contiguous float32, or null. out: contiguous (B, Lq, H, hd).
// Returns the cudaError_t of the launch (0 = success).
extern "C" int sdvar_attention(const void* q, const void* k, const void* v,
                               const void* bias, void* out, int dtype, int B,
                               int Lq, int Lk, int H, int hd, long long q_sb,
                               long long q_sl, long long k_sb, long long k_sl,
                               long long v_sb, long long v_sl, float scale,
                               void* stream) {
  if (bad_shape(dtype, B, Lq, Lk, H)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.out = out;
  p.bias = static_cast<const float*>(bias);
  p.k = const_cast<void*>(k);
  p.v = const_cast<void*>(v);
  p.Lq = Lq, p.Lk = Lk, p.H = H, p.split = Lk;
  p.q_sb = q_sb, p.q_sl = q_sl, p.k_sb = k_sb, p.k_sl = k_sl;
  p.v_sb = v_sb, p.v_sl = v_sl;
  p.scale = scale;
  return (int)launch(dtype, dtype, false, hd, p, B,
                     static_cast<cudaStream_t>(stream));
}

// The INT8-KV branch: k/v int8 with the same layout rules (16 int8 per
// load, so strides a multiple of 16); ks/vs the per-token float32 key and
// value scales, element (b, j) at b * s_sb + j * s_sl.
extern "C" int sdvar_attention_int8(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* bias, void* out, int dtype, int B, int Lq,
    int Lk, int H, int hd, long long q_sb, long long q_sl, long long k_sb,
    long long k_sl, long long v_sb, long long v_sl, long long s_sb,
    long long s_sl, float scale, void* stream) {
  if (bad_shape(dtype, B, Lq, Lk, H) || ks == nullptr || vs == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.out = out;
  p.bias = static_cast<const float*>(bias);
  p.k = const_cast<void*>(k);
  p.v = const_cast<void*>(v);
  p.ks = static_cast<float*>(const_cast<void*>(ks));
  p.vs = static_cast<float*>(const_cast<void*>(vs));
  p.Lq = Lq, p.Lk = Lk, p.H = H, p.split = Lk;
  p.q_sb = q_sb, p.q_sl = q_sl, p.k_sb = k_sb, p.k_sl = k_sl;
  p.v_sb = v_sb, p.v_sl = v_sl, p.s_sb = s_sb, p.s_sl = s_sl;
  p.scale = scale;
  return (int)launch(dtype, 2, false, hd, p, B,
                     static_cast<cudaStream_t>(stream));
}

// Attention over one layer of the stacked KV cache, keys [0, Lk). k/v
// point at the layer's (B, L_max, C) plane of the cache, strides c_sb /
// c_sl; with kv_dtype 2 (int8), ks/vs at the layer's (B, L_max) scale
// planes, strides cs_sb / cs_sl. With write = 1 the kernel first stores
// the new rows kn/vn ((B, Lq, H, hd), strides kn_sb/kn_sl, vn_sb/vn_sl, in
// q's type or int8; int8 scales kns/vns (B, Lq), strides ns_sb/ns_sl) into
// the cache at rows [split, split + Lq), and attends over them as the
// cache's rows: Lk must be split + Lq. With write = 0 the kn/vn arguments
// are ignored. q_dtype: 0 = float32, 1 = bfloat16; kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8.
extern "C" int sdvar_attention_cache(
    const void* q, void* k, void* v, void* ks, void* vs, const void* kn,
    const void* vn, const void* kns, const void* vns, const void* bias,
    void* out, int q_dtype, int kv_dtype, int write, int B, int Lq, int Lk,
    int split, int H, int hd, long long q_sb, long long q_sl, long long c_sb,
    long long c_sl, long long cs_sb, long long cs_sl, long long kn_sb,
    long long kn_sl, long long vn_sb, long long vn_sl, long long ns_sb,
    long long ns_sl, float scale, void* stream) {
  const bool q8 = kv_dtype == 2;
  if (bad_shape(q_dtype, B, Lq, Lk, H) || kv_dtype < 0 || kv_dtype > 2 ||
      (q8 && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (write && (split < 0 || split + Lq != Lk || kn == nullptr ||
                vn == nullptr || (q8 && (kns == nullptr || vns == nullptr))))
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = q;
  p.out = out;
  p.bias = static_cast<const float*>(bias);
  p.k = k;
  p.v = v;
  p.ks = static_cast<float*>(ks);
  p.vs = static_cast<float*>(vs);
  p.kn = kn;
  p.vn = vn;
  p.kns = static_cast<const float*>(kns);
  p.vns = static_cast<const float*>(vns);
  p.Lq = Lq, p.Lk = Lk, p.H = H, p.split = write ? split : Lk;
  p.q_sb = q_sb, p.q_sl = q_sl;
  p.k_sb = p.v_sb = c_sb;
  p.k_sl = p.v_sl = c_sl;
  p.s_sb = cs_sb, p.s_sl = cs_sl;
  p.kn_sb = kn_sb, p.kn_sl = kn_sl, p.vn_sb = vn_sb, p.vn_sl = vn_sl;
  p.ns_sb = ns_sb, p.ns_sl = ns_sl;
  p.scale = scale;
  return (int)launch(q_dtype, kv_dtype, write != 0, hd, p, B,
                     static_cast<cudaStream_t>(stream));
}

// Shared memory one block takes for head dim hd and dtype (0 = float32,
// dynamic; 1 = bfloat16, static), in bytes (0 for an unsupported hd): the
// compiler's -Xptxas -v report shows only the static part.
extern "C" int sdvar_attention_smem_bytes(int hd, int dtype) {
  if (hd != 32 && hd != 64 && hd != 128) return 0;
  if (dtype == 1)
    return (int)(sizeof(bf16) * (size_t(MK) * (hd + PAD) +
                                 size_t(hd) * (MK + PAD)));
  switch (hd) {
    case 32: return (int)smem_bytes<32>();
    case 64: return (int)smem_bytes<64>();
    default: return (int)smem_bytes<128>();
  }
}
