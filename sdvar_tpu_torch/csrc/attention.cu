// Fused attention for VAR's KV-cached decode, hand-written for Hopper
// (sm_90a), bound to PyTorch through a plain C function loaded with ctypes.
//
// Replaces the TPU kernel sdvar_tpu/ops/pallas/attention.py:_kernel
// (float-KV branch, reached through _pallas_forward / pallas_attention).
// Same function:
//   out = softmax(q k^T * scale + bias) v
// with the softmax in f32, the running max clamped at -1e30 so that a row
// whose bias is all -inf gives zeros (not NaN), the probabilities cast to
// v's type before the PV product (as the TPU kernel does), and the output
// divided by max(l, 1e-30) AFTER the PV product.
//
// Bound on this card: memory. At the decode shapes (2B=32, H=30, hd=64,
// bf16, Lq = pn^2 <= 256, Lk <= 680) one launch moves q, k, v and o once
// (about 230 MB at the last 256px scale, ~69 us at 3.35 TB/s) against
// 43 GFLOP (~43 us at the bf16 tensor-core peak).
//
// Two kernels, one per input type; both keep the (Lq, Lk) score matrix out
// of device memory with an online softmax over 64-key tiles, and both read
// K/V through strides straight out of the KV cache slice [0, kv_len) of one
// layer (batch-major or token-major), so nothing is copied per layer; q may
// be a strided view of the fused qkv output.
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

namespace {

typedef __nv_bfloat16 bf16;
typedef long long ll;

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

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragment layout of m16n8k16 (lane = 4 * g + t): A element pairs at rows
// g / g+8 and columns 2t / 2t+8; B pairs at rows (k) 2t / 2t+8 and column
// (n) g; C pairs at rows g / g+8 and columns 2t, 2t+1.
template <int HD>
__global__ void __launch_bounds__(MT) attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ bias,
    bf16* __restrict__ out, int Lq, int Lk, int H, ll q_sb, ll q_sl, ll k_sb,
    ll k_sl, ll v_sb, ll v_sl, float scale) {
  constexpr int KS = HD / 16;  // k-steps of q k^T over the head dim
  constexpr int SN = MK / 8;   // score n-tiles per key tile
  constexpr int ON = HD / 8;   // output n-tiles
  constexpr int CH = HD / 8;   // 16-byte chunks per key row
  __shared__ __align__(16) bf16 ks[MK][HD + PAD];  // [key][d]
  __shared__ __align__(16) bf16 vt[HD][MK + PAD];  // [d][key]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const ll b = blockIdx.z;
  const int r0 = blockIdx.x * MQ + warp * 16;

  const bf16* qb = q + b * q_sb + (ll)h * HD;
  const bf16* kb = k + b * k_sb + (ll)h * HD;
  const bf16* vb = v + b * v_sb + (ll)h * HD;

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
            r < Lq ? ld32(qb + (ll)r * q_sl + kk * 16 + 8 * c + 2 * t) : 0u;
  }

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int kv0 = 0; kv0 < Lk; kv0 += MK) {
    __syncthreads();  // the previous tile's readers are done
    // keys row-major: neighbouring threads read neighbouring 16 bytes
    for (int i = threadIdx.x; i < MK * CH; i += MT) {
      const int c = i / CH, d0 = (i % CH) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (kv0 + c < Lk)
        x = *reinterpret_cast<const uint4*>(kb + (ll)(kv0 + c) * k_sl + d0);
      *reinterpret_cast<uint4*>(&ks[c][d0]) = x;
    }
    // values transposed: neighbouring threads take neighbouring keys, so
    // the 2-byte stores into a [d] row do not collide in a bank; zero past
    // Lk (p is 0 there, and 0 * garbage may be NaN)
    for (int i = threadIdx.x; i < MK * CH; i += MT) {
      const int c = i % MK, d0 = (i / MK) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (kv0 + c < Lk)
        x = *reinterpret_cast<const uint4*>(vb + (ll)(kv0 + c) * v_sl + d0);
      const bf16* xe = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[d0 + e][c] = xe[e];
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
          if (c < Lk) {
            x = s[n][2 * hf + e] * scale;
            if (bias != nullptr && r < Lq) x += bias[(ll)r * Lk + c];
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
          const float p = expf(s[n][2 * hf + e] - m_new);
          s[n][2 * hf + e] = p;
          rs += p;
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
    if (r >= Lq) continue;
    const float denom = fmaxf(l[hf], 1e-30f);
    bf16* ob = out + ((b * Lq + r) * H + h) * HD + 2 * t;
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
  // qT (HD x SQ), kT (HD x SK), v (BK x HD), pT (BK x SQ), all f32
  return sizeof(float) * (size_t(HD) * SQ + size_t(HD) * SK +
                          size_t(BK) * HD + size_t(BK) * SQ);
}

template <int HD>
__global__ void __launch_bounds__(NT) attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ bias,
    float* __restrict__ out, int Lq, int Lk, int H, ll q_sb, ll q_sl,
    ll k_sb, ll k_sl, ll v_sb, ll v_sl, float scale) {
  constexpr int VN = 4;        // elements per 16-byte load
  constexpr int DJ = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [d][r]
  float* kT = qT + HD * SQ;                      // [d][c]
  float* vs = kT + HD * SK;                      // [c][d]
  float* pT = vs + BK * HD;                      // [c][r]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const ll b = blockIdx.z;

  const float* qb = q + b * q_sb + (ll)h * HD;
  const float* kb = k + b * k_sb + (ll)h * HD;
  const float* vb = v + b * v_sb + (ll)h * HD;

  // stage this block's queries, transposed; rows past Lq are zero
  for (int i = tid; i < BQ * (HD / VN); i += NT) {
    const int r = i / (HD / VN), d0 = (i % (HD / VN)) * VN;
    float buf[VN] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Lq) load4(qb + (ll)(q0 + r) * q_sl + d0, buf);
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

  for (int kv0 = 0; kv0 < Lk; kv0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * (HD / VN); i += NT) {
      const int c = i / (HD / VN), d0 = (i % (HD / VN)) * VN;
      // zero V past Lk: p is 0 there, and 0 * garbage may be NaN
      float kbuf[VN] = {0.f, 0.f, 0.f, 0.f}, vbuf[VN] = {0.f, 0.f, 0.f, 0.f};
      if (kv0 + c < Lk) {
        load4(kb + (ll)(kv0 + c) * k_sl + d0, kbuf);
        load4(vb + (ll)(kv0 + c) * v_sl + d0, vbuf);
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        kT[(d0 + e) * SK + c] = kbuf[e];
        vs[c * HD + d0 + e] = vbuf[e];
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
        if (c < Lk) {
          x = s[i][j] * scale;
          if (bias != nullptr && r < Lq) x += bias[(ll)r * Lk + c];
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
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
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

    const int cmax = min(BK, Lk - kv0);
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
    if (r >= Lq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* ob = out + ((b * Lq + r) * H + h) * HD + tx * DJ;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[j] = acc[i][j] / denom;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *bias;
  void* out;
  int B, Lq, Lk, H;
  ll q_sb, q_sl, k_sb, k_sl, v_sb, v_sl;
  float scale;
  cudaStream_t stream;
};

template <int HD>
cudaError_t launch_bf16(const Args& a) {
  dim3 grid((a.Lq + MQ - 1) / MQ, a.H, a.B);
  attention_mma_kernel<HD><<<grid, MT, 0, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const float*>(a.bias),
      static_cast<bf16*>(a.out), a.Lq, a.Lk, a.H, a.q_sb, a.q_sl, a.k_sb,
      a.k_sl, a.v_sb, a.v_sl, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Args& a) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        attention_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  attention_f32_kernel<HD><<<grid, NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.bias),
      static_cast<float*>(a.out), a.Lq, a.Lk, a.H, a.q_sb, a.q_sl, a.k_sb,
      a.k_sl, a.v_sb, a.v_sl, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(int dtype, const Args& a) {
  return dtype == 1 ? launch_bf16<HD>(a) : launch_f32<HD>(a);
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
  if (B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || H > 65535 || B > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q,    k,    v,    bias, out,  B,     Lq,
               Lk,   H,    q_sb, q_sl, k_sb, k_sl,  v_sb,
               v_sl, scale, static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32: return (int)launch<32>(dtype, a);
    case 64: return (int)launch<64>(dtype, a);
    case 128: return (int)launch<128>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
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
