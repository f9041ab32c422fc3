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
// planes): the int8 values are converted to q's type (exact in bf16) in
// shared memory, so no dequantised copy ever reaches device memory. The
// order is the TPU kernel's:
//   s_ij = (q_i . kq_j) * scale * ks_j  (+ bias_ij)
//   p_ij = exp(s_ij - m_i);  l_i = sum_j p_ij   (l BEFORE the value scale)
//   o_i  = sum_j cast_q(p_ij * vs_j) vq_j / max(l_i, 1e-30)
// (bf16 q: exp as ex2.approx of x log2 e, relative error about 2^-22). A
// float cache in f32 under a bf16 q (kv_mode "f32" with a bf16 model) is
// rounded to bf16 in shared memory, as the unfused path's cast does.
//
// The cache write (WRITE): the TPU kernel DMAs aligned windows of the cache
// into VMEM, merges the new rows in and DMAs them back (read-merge-write,
// because Mosaic slices HBM in 8-row windows), then attends over keys it
// composed from the old prefix and the new rows. Here the attention loop
// has a split key source: rows below cache_begin come from the cache, rows
// from cache_begin on from the new rows themselves (a tile that straddles
// cache_begin takes rows from both, chosen per row). Every block stages
// every key row, so the block whose query rows hold new row r stores it
// into cache[li, b, cache_begin + r, head] from the shared tile once the
// tile has arrived (widened to f32 for an f32 cache; the blocks of head 0
// also store the per-token scales): each new element is written once, with
// no read-merge-write and no pass of its own. No block reads a row that
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
//   - bf16 (the main path, all four entry points): one block per (query
//     rows, head, batch row) with 1-4 warpgroups of 4 warps (the launch
//     geometry is planned in Python, ops/kernels/attention.py:
//     attention_plan; by default 2 warpgroups, 128 query rows, so two
//     blocks share an SM and K/V are staged once per (b, h) for Lq <= 128,
//     twice at the decode's last scales, the second time from L2). K/V
//     arrive in a ring of 2-4 stages (default 3) in dynamic shared memory,
//     filled by cp.async 16-byte copies (zero-filled past Lk) while earlier
//     tiles are computed: one __syncthreads per tile. A bf16 cache lands in
//     wgmma's swizzled [key][d] layout; an int8 cache (with its per-token
//     scales, 4-byte cp.async into the same stage) or an f32 cache lands as
//     it is in device memory, and one pass per tile converts it into the
//     swizzled bf16 tiles (fence.proxy.async before the tensor cores read
//     them). Tensor cores through wgmma (sm_90a), one warpgroup per 64
//     query rows: S = q k^T with q from registers and B = the key tile
//     (K-major), O += P V with P from registers (the score accumulator
//     repacked to bf16) and B = the value tile read MN-major through the
//     transpose bit: no transposing stores. Staging differs between the
//     instances; the compute (attend_tile) is one function for all, so the
//     fused and unfused paths give the same bits.
//     Copies: cp.async everywhere, not TMA: one staging routine serves the
//     per-row split source of WRITE, the int8 and f32 rings and the plain
//     bf16 one, and issuing is cheap here (4 copies a thread a tile at
//     hd = 64). Measured (tools/ab_attention.py): the ring's depth moves
//     the time by under 2%, so copies are not what bounds the loop; the
//     softmax's instructions are (about a third of the time at scale 9),
//     then the per-tile barrier and the wgmma waits of a warpgroup that
//     does one thing at a time.
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

// N zeros of T
template <typename T, int N>
__device__ __forceinline__ Pack<T, N> zeros() {
  Pack<T, N> r;
#pragma unroll
  for (int w = 0; w < int(N * sizeof(T) / 4); ++w)
    reinterpret_cast<uint32_t*>(r.x)[w] = 0u;
  return r;
}

// a Pack of T (f32 or int8, exact) as f32
template <typename T, int N>
__device__ __forceinline__ Pack<float, N> to_f32(const Pack<T, N>& x) {
  if constexpr (std::is_same<T, float>::value) {
    return x;
  } else {
    Pack<float, N> o;
#pragma unroll
    for (int e = 0; e < N; ++e) o.x[e] = (float)x.x[e];
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

// f32 kernel: VE values of key (V = false) or value (V = true) row j,
// columns [d0, d0 + VE), as f32: rows [0, split) from k/v, rows
// [split, Lk) from the new rows (of the same type), zeros past Lk (p is 0
// there, and 0 * garbage may be NaN). The loads are predicated, not
// branched around, so a thread's loads of one tile can all be in flight
// together. WRITE: a new row the block owns is also stored into the cache
// from the registers it was staged through, so it is read once and
// written once.
template <int VE, int ROWS, bool WRITE, bool V, typename KC>
__device__ __forceinline__ Pack<float, VE> kv_row(const Params& p,
                                                  const Rows<KC, KC>& r,
                                                  int j, int d0) {
  const bool fresh = WRITE && j >= p.split;
  const KC* src = fresh ? (V ? r.vn : r.kn) + (ll)(j - p.split) * (V ? p.vn_sl : p.kn_sl)
                        : (V ? r.v : r.k) + (ll)j * (V ? p.v_sl : p.k_sl);
  Pack<KC, VE> x = zeros<KC, VE>();
  if (j < p.Lk) x = *reinterpret_cast<const Pack<KC, VE>*>(src + d0);
  if constexpr (WRITE)
    if (owns<ROWS>(p, j))
      *reinterpret_cast<Pack<KC, VE>*>((V ? r.vw : r.kw) +
                                       (ll)j * (V ? p.v_sl : p.k_sl) + d0) = x;
  return to_f32(x);
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
// bf16 q: a ring of K/V tiles filled by cp.async, warpgroup MMA (wgmma)
// ---------------------------------------------------------------------------

constexpr int MK = 64;          // keys per tile
constexpr int WG_ROWS = 64;     // query rows per warpgroup (4 warps x 16)
constexpr int MAX_STAGES = 4;   // ring depth the launch accepts (2..4)
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may take

// Warpgroups a block may hold, and the register budget that follows from
// __launch_bounds__(128 * max_wg<HD>(), 1): 128 registers a thread for
// hd <= 64 (so two 2-warpgroup blocks or one of 4 share an SM, whatever the
// K/V type), 255 for hd = 128 (its 64 output columns need them).
template <int HD>
__host__ __device__ constexpr int max_wg() {
  return HD == 128 ? 2 : 4;
}

// Whether the ring holds K/V in another type than bf16 (an int8 cache, or
// an f32 cache under bf16 q), converted by one pass per tile
template <typename KC>
__host__ __device__ constexpr bool converts() {
  return !std::is_same<KC, bf16>::value;
}

// One stage of the ring: the K tile, the V tile (MK rows of HD elements of
// KC each) and, int8, the tile's key and value scales (MK floats each)
template <int HD, typename KC>
__host__ __device__ constexpr int raw_bytes() {
  return MK * HD * (int)sizeof(KC);
}
template <int HD, typename KC>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * raw_bytes<HD, KC>() +
         (std::is_same<KC, int8_t>::value ? 2 * MK * 4 : 0);
}
template <int HD>
__host__ __device__ constexpr int tile_bytes() {  // one bf16 K or V tile
  return MK * HD * 2;
}
// The ring, then (converting instances) the two bf16 tiles, each at a
// 1024-byte boundary (the period of the 128-byte swizzle wgmma reads), and
// 1024 bytes of slack to align the dynamic shared memory's base
template <int HD, typename KC>
__host__ __device__ constexpr int ring_smem(int stages) {
  return 1024 + (stages * stage_bytes<HD, KC>() + 1023) / 1024 * 1024 +
         (converts<KC>() ? 2 * tile_bytes<HD>() : 0);
}

// Byte offset of 16-byte chunk c of row r in a bf16 tile of HD columns,
// in wgmma's canonical swizzled layouts (the tile 1024-byte aligned):
// hd = 64, rows of 128 bytes, 128-byte swizzle (chunk c ^ (r % 8));
// hd = 32, rows of 64 bytes, 64-byte swizzle (chunk c ^ (r / 2 % 4));
// hd = 128, two such 64-column atoms, [c / 8][r][128 bytes]. The same
// layout is K-major for the key tile (B of q k^T) and MN-major for the
// value tile (B of p v).
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (HD == 32)
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  else
    return (c >> 3) * (MK * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when n = 0 (rows past Lk)
__device__ __forceinline__ void cp16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n of this thread's groups are in flight
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

// d (64 x 64, f32) += a (64 x 16 bf16, registers) * B (16 x 64 bf16, shared
// memory through the descriptor bd; TNSP = 1: B is MN-major)
template <int TNSP>
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4],
                                       const uint32_t (&a)[4], uint64_t bd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd), "r"(1),
        "n"(TNSP));
}

// d (64 x 32, f32) += a (64 x 16 bf16, registers) * B (16 x 32 bf16, shared
// memory through the descriptor bd; TNSP = 1: B is MN-major)
template <int TNSP>
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4],
                                       const uint32_t (&a)[4], uint64_t bd) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(bd), "r"(1),
        "n"(TNSP));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator registers across the
// asynchronous products
template <int N>
__device__ __forceinline__ void pin(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
// shared-memory writes of this thread (cp.async, the conversion pass)
// made visible to the tensor cores' reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle (1 = 128 B, 2 = 64 B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swizzle << 62);
}

// e^x for x <= 0 (0 at -inf): ex2.approx of x log2 e, relative error
// about 2^-22, results below 2^-126 flushed to 0
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Byte offset of 16-byte chunk c of row r in a ring tile: the swizzled
// layout wgmma reads when the ring holds bf16, else rows packed as in
// device memory (the conversion pass reads them)
template <int HD, typename KC>
__device__ __forceinline__ int ring_off(int r, int c) {
  if constexpr (converts<KC>())
    return r * HD * (int)sizeof(KC) + (c << 4);
  else
    return swz<HD>(r, c);
}

// Issue the copies of key tile kv0 into one stage: every thread takes
// 16-byte chunks of the K and V rows (rows below split from k/v, later
// ones from the new rows kn/vn: for an f32 cache, whose new rows are bf16,
// into the first half of the row's slot), and, int8, the tile's scales.
template <int HD, typename KC, typename KN, bool WRITE>
__device__ __forceinline__ void issue_tile(
    const Params& p, const Rows<KC, KN>& rw, uint8_t* stage, int kv0, ll b,
    const float* ksc, const float* vsc, const float* knsc,
    const float* vnsc) {
  constexpr int CPR = HD * (int)sizeof(KC) / 16;   // chunks per ring row
  constexpr int CPN = HD * (int)sizeof(KN) / 16;   // chunks per new row
  for (int i = threadIdx.x; i < 2 * MK * CPR; i += blockDim.x) {
    const bool V = i >= MK * CPR;
    const int rc = V ? i - MK * CPR : i, r = rc / CPR, c = rc % CPR;
    const int j = kv0 + r;
    const bool fresh = WRITE && j >= p.split;
    if (fresh && c >= CPN) continue;
    const int n = j < p.Lk ? 16 : 0;
    const void* src;
    if (n == 0)
      src = V ? (const void*)rw.v : (const void*)rw.k;
    else if (fresh)
      src = reinterpret_cast<const uint8_t*>(V ? rw.vn : rw.kn) +
            ((ll)(j - p.split) * (V ? p.vn_sl : p.kn_sl)) * (ll)sizeof(KN) +
            (c << 4);
    else
      src = reinterpret_cast<const uint8_t*>(V ? rw.v : rw.k) +
            ((ll)j * (V ? p.v_sl : p.k_sl)) * (ll)sizeof(KC) + (c << 4);
    cp16(stage + (V ? raw_bytes<HD, KC>() : 0) + ring_off<HD, KC>(r, c), src, n);
  }
  if constexpr (std::is_same<KC, int8_t>::value) {
    float* sc = reinterpret_cast<float*>(stage + 2 * raw_bytes<HD, KC>());
    for (int i = threadIdx.x; i < 2 * MK; i += blockDim.x) {
      const bool V = i >= MK;
      const int r = V ? i - MK : i, j = kv0 + r;
      const float* src = V ? vsc : ksc;
      if (j < p.Lk) {
        if (WRITE && j >= p.split)
          src = (V ? vnsc : knsc) + b * p.ns_sb + (ll)(j - p.split) * p.ns_sl;
        else
          src += b * p.s_sb + (ll)j * p.s_sl;
      }
      cp4(sc + i, src, j < p.Lk ? 4 : 0);
    }
  }
}

// One pass over an arrived stage that is not bf16: K and V to bf16 (int8
// exactly, f32 rounded to nearest even as the unfused path's cast), into
// the swizzled tiles wgmma reads. An f32 cache's new rows are bf16
// already and are copied.
template <int HD, typename KC, bool WRITE>
__device__ __forceinline__ void convert_tile(const Params& p,
                                             const uint8_t* stage,
                                             uint8_t* conv, int kv0) {
  constexpr int CPB = HD / 8;  // bf16 chunks per row
  for (int i = threadIdx.x; i < 2 * MK * CPB; i += blockDim.x) {
    const bool V = i >= MK * CPB;
    const int rc = V ? i - MK * CPB : i, r = rc / CPB, c = rc % CPB;
    const uint8_t* row = stage + (V ? raw_bytes<HD, KC>() : 0) +
                         r * HD * (int)sizeof(KC);
    uint4 w;
    if constexpr (std::is_same<KC, int8_t>::value) {
      const uint2 x = *reinterpret_cast<const uint2*>(row + c * 8);
      const int8_t* e = reinterpret_cast<const int8_t*>(&x);
      uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        u[k] = pack_bf16((float)e[2 * k], (float)e[2 * k + 1]);
    } else {
      if (WRITE && kv0 + r >= p.split) {
        w = *reinterpret_cast<const uint4*>(row + c * 16);
      } else {
        const float4 a = *reinterpret_cast<const float4*>(row + c * 32);
        const float4 d = *reinterpret_cast<const float4*>(row + c * 32 + 16);
        w = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                       pack_bf16(d.x, d.y), pack_bf16(d.z, d.w));
      }
    }
    *reinterpret_cast<uint4*>(conv + (V ? tile_bytes<HD>() : 0) +
                              swz<HD>(r, c)) = w;
  }
}

// WRITE: the new rows of tile kv0 that this block owns (those of its own
// query rows [R * blockIdx.x, R * (blockIdx.x + 1))) go from the arrived
// stage into the cache, once (an f32 cache widens its bf16 new rows); the
// blocks of head 0 also store their int8 scales.
template <int HD, typename KC, typename KN>
__device__ __forceinline__ void store_owned(const Params& p,
                                            const Rows<KC, KN>& rw,
                                            const uint8_t* stage, int kv0,
                                            ll b, int h, int R) {
  const int lo = max(kv0, p.split + R * (int)blockIdx.x);
  const int hi = min(min(kv0 + MK, p.Lk), p.split + R * ((int)blockIdx.x + 1));
  if (lo >= hi) return;
  constexpr int CPC = HD * (int)sizeof(KC) / 16;  // 16-byte chunks per cache row
  const int n = (hi - lo) * CPC;
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const bool V = i >= n;
    const int rc = V ? i - n : i, r = lo - kv0 + rc / CPC, c = rc % CPC;
    const uint8_t* tile = stage + (V ? raw_bytes<HD, KC>() : 0);
    uint4 w;
    if constexpr (sizeof(KC) == sizeof(KN)) {
      w = *reinterpret_cast<const uint4*>(tile + ring_off<HD, KC>(r, c));
    } else {  // 4 bf16 of the new row's slot, widened to 4 f32
      const uint2 x = *reinterpret_cast<const uint2*>(tile + r * HD * 4 + c * 8);
      const bf16* e = reinterpret_cast<const bf16*>(&x);
      w = make_uint4(__float_as_uint(__bfloat162float(e[0])),
                     __float_as_uint(__bfloat162float(e[1])),
                     __float_as_uint(__bfloat162float(e[2])),
                     __float_as_uint(__bfloat162float(e[3])));
    }
    KC* dst = (V ? rw.vw : rw.kw) + (ll)(kv0 + r) * (V ? p.v_sl : p.k_sl);
    *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(dst) + c * 16) = w;
  }
  if constexpr (std::is_same<KC, int8_t>::value) {
    if (h != 0) return;
    const float* sc = reinterpret_cast<const float*>(stage + 2 * raw_bytes<HD, KC>());
    for (int i = threadIdx.x; i < 2 * (hi - lo); i += blockDim.x) {
      const bool V = i >= hi - lo;
      const int j = lo + (V ? i - (hi - lo) : i);
      (V ? p.vs : p.ks)[b * p.s_sb + (ll)j * p.s_sl] = sc[(V ? MK : 0) + j - kv0];
    }
  }
}

// The one compute path of every entry point: a warpgroup's 64 query rows
// (this warp's 16 of them in its registers) against one bf16 key tile kt
// and value tile vt (swizzled, [key][d]): scores through wgmma with q from
// registers, the online softmax, and o += p v through wgmma with p from
// registers and the value tile read MN-major (no transpose anywhere).
// kst/vst: the tile's int8 scales (Q8).
template <int HD, bool Q8>
__device__ __forceinline__ void attend_tile(
    const Params& p, const uint32_t (&qa)[HD / 16][4], const uint8_t* kt,
    const uint8_t* vt, const float* kst, const float* vst,
    const float* __restrict__ bias, int kv0, int r0, float (&m)[2],
    float (&l)[2], float (&o)[HD / 8][4]) {
  constexpr int KS = HD / 16;  // k-steps of q k^T over the head dim
  constexpr int SN = MK / 8;   // score n-tiles per key tile
  constexpr int ON = HD / 8;   // output n-tiles
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t kb = smem_u32(kt), vb = smem_u32(vt);
  // swizzle mode and the byte stride of 8-row groups, as swz lays them out
  constexpr uint32_t SWZ = HD == 32 ? 2 : 1, SBO = HD == 32 ? 512 : 1024;

  // scores (64 rows x 64 keys) of this warpgroup: B = the key tile,
  // K-major; k-step kk is 32 bytes into a row (into atom kk / 4 at hd=128)
  float s[SN][4];
#pragma unroll
  for (int n = 0; n < SN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  pin(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_n64<0>(s, qa[kk],
                 gmma_desc(kb + (kk >> 2) * (MK * 128) + (kk & 3) * 32, 16,
                           SBO, SWZ));
  wgmma_commit_wait();
  pin(s);

  // online softmax of rows g (hf = 0) and g + 8 (hf = 1); a row's 64
  // columns lie in the 4 lanes that share g. Only the last tile has keys
  // past Lk; exp(x) is 2^(x log2 e), one multiply and one ex2.approx.
  const bool ragged = kv0 + MK > p.Lk;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    const bool biased = bias != nullptr && r < p.Lq;
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = kv0 + n * 8 + 2 * t + e;
        float x = s[n][2 * hf + e] * p.scale;
        if constexpr (Q8) x *= kst[n * 8 + 2 * t + e];
        if (ragged && c >= p.Lk)
          x = -INFINITY;
        else if (biased)
          x += bias[(ll)r * p.Lk + c];
        s[n][2 * hf + e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // guard fully-masked rows: exp(-inf - -inf) would be NaN
    const float m_new = fmaxf(fmaxf(m[hf], mx), -1e30f);
    const float alpha = exp_approx(m[hf] - m_new);
    float rs = 0.f;
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pe = exp_approx(s[n][2 * hf + e] - m_new);
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

  // o += p v: the C fragments of score n-tiles 2j, 2j+1 are the A fragment
  // of key step j; B = the value tile, MN-major (the transpose bit): key
  // step j is 16 rows on, and at hd = 128 the second 64 columns are the
  // second atom
  uint32_t pa[MK / 16][4];
#pragma unroll
  for (int j = 0; j < MK / 16; ++j) {
    pa[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    pa[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    pa[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    pa[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
  pin(o);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < MK / 16; ++j) {
    if constexpr (HD == 32) {
      wgmma_n32<1>(o, pa[j], gmma_desc(vb + j * 16 * 64, MK * 64, SBO, SWZ));
    } else {
#pragma unroll
      for (int a = 0; a < HD / 64; ++a)
        wgmma_n64<1>(*reinterpret_cast<float(*)[8][4]>(&o[8 * a][0]), pa[j],
                     gmma_desc(vb + a * (MK * 128) + j * 16 * 128, MK * 128,
                               SBO, SWZ));
    }
  }
  wgmma_commit_wait();
  pin(o);
}

// Fragments (lane = 4 * g + t): wgmma's A in registers and its f32
// accumulator hold, for each warp's 16 rows of the warpgroup's 64, the
// layout of mma.sync m16n8k16: A pairs at rows g / g+8 and columns
// 2t / 2t+8 of each 16-column step, accumulator pairs at rows g / g+8 and
// columns 2t, 2t+1 of each 8-column tile.
// KC, the type of k/v: bf16, f32 (rounded to bf16 by the conversion pass)
// or int8 with the scales ksc/vsc. New rows (WRITE) come in bf16, or int8
// under an int8 cache. blockDim.x = 128 x warpgroups; the ring has
// `stages` stages (2..4) in dynamic shared memory.
template <int HD, typename KC, bool WRITE>
__global__ void __launch_bounds__(128 * max_wg<HD>(), 1) attention_mma_kernel(
    const Params p, const bf16* __restrict__ q, const KC* __restrict__ k,
    const KC* __restrict__ v, const float* __restrict__ ksc,
    const float* __restrict__ vsc, const New<bf16, KC>* __restrict__ kn,
    const New<bf16, KC>* __restrict__ vn, const float* __restrict__ knsc,
    const float* __restrict__ vnsc, const float* __restrict__ bias,
    bf16* __restrict__ out, int stages) {
  constexpr bool Q8 = std::is_same<KC, int8_t>::value;
  typedef New<bf16, KC> KN;
  constexpr int KS = HD / 16;
  constexpr int ON = HD / 8;
  constexpr int SB = stage_bytes<HD, KC>();
  extern __shared__ __align__(1024) uint8_t smem_base[];
  // the ring from the first 1024-byte boundary, then the converted bf16 K
  // and V tiles at the next one after it
  uint8_t* ring = smem_base + ((1024 - (smem_u32(smem_base) & 1023)) & 1023);
  uint8_t* conv = ring + (stages * SB + 1023) / 1024 * 1024;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y;
  const ll b = blockIdx.z;
  const int R = (int)blockDim.x / 2;  // query rows of this block
  const int r0 = blockIdx.x * R + warp * 16;
  // warpgroups whose 64 rows all lie past Lq only stage
  const bool active = blockIdx.x * R + (warp >> 2) * WG_ROWS < p.Lq;
  const ll hoff = (ll)h * HD;
  const Rows<KC, KN> rw = block_rows<KC, KN>(p, k, v, kn, vn, b, hoff);
  const int ntiles = (p.Lk + MK - 1) / MK;

  // the first stages - 1 tiles in flight before anything else
  for (int s = 0; s < stages - 1; ++s) {
    if (s < ntiles)
      issue_tile<HD, KC, KN, WRITE>(p, rw, ring + s * SB, s * MK, b, ksc, vsc,
                                    knsc, vnsc);
    cp_commit();
  }

  // this warp's q as A fragments, straight from device memory; rows past
  // Lq are zero
  const bf16* qb = q + b * p.q_sb + hoff;
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

  for (int it = 0; it < ntiles; ++it) {
    const int kv0 = it * MK;
    // tile it has arrived (this thread's copies, then everyone's), and
    // every thread is done with tile it - 1, whose stage is refilled next
    cp_wait(stages - 2);
    fence_proxy_async();
    __syncthreads();
    const int nt = it + stages - 1;
    if (nt < ntiles)
      issue_tile<HD, KC, KN, WRITE>(p, rw, ring + (nt % stages) * SB, nt * MK,
                                    b, ksc, vsc, knsc, vnsc);
    cp_commit();
    const uint8_t* stage = ring + (it % stages) * SB;
    if constexpr (WRITE) store_owned<HD, KC, KN>(p, rw, stage, kv0, b, h, R);
    const uint8_t* kt = stage;
    if constexpr (converts<KC>()) {
      convert_tile<HD, KC, WRITE>(p, stage, conv, kv0);
      fence_proxy_async();
      __syncthreads();
      kt = conv;
    }
    const float* sc = reinterpret_cast<const float*>(stage + 2 * raw_bytes<HD, KC>());
    if (active)
      attend_tile<HD, Q8>(p, qa, kt, kt + (converts<KC>() ? tile_bytes<HD>()
                                                          : raw_bytes<HD, KC>()),
                          sc, sc + MK, bias, kv0, r0, m, l, o);
  }
  cp_wait(0);

  // normalise after the PV product; out is contiguous (B, Lq, H, HD)
  if (!active) return;
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
      const Pack<float, VE> kx = kv_row<VE, BQ, WRITE, false>(p, rows, kv0 + c, d0);
      const Pack<float, VE> vx = kv_row<VE, BQ, WRITE, true>(p, rows, kv0 + c, d0);
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

// The launch geometry is chosen in Python (ops/kernels/attention.py,
// attention_plan) and passed in: warpgroups per block (bf16 q) and ring
// stages; the grid and the shared memory follow from them here as there.
struct Geometry {
  int B, wg, stages;
};

template <int HD, typename QT, typename KC, bool WRITE>
cudaError_t launch_one(const Params& p, const Geometry& gm,
                       cudaStream_t stream) {
  if constexpr (std::is_same<QT, bf16>::value) {
    if (gm.wg < 1 || gm.wg > max_wg<HD>() || gm.stages < 2 ||
        gm.stages > MAX_STAGES)
      return cudaErrorInvalidValue;
    const int smem = ring_smem<HD, KC>(gm.stages);
    if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
    static int configured = 0;  // the largest ring this instance was given
    if (smem > configured) {
      cudaError_t err = cudaFuncSetAttribute(
          attention_mma_kernel<HD, KC, WRITE>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      configured = smem;
    }
    const int rows = WG_ROWS * gm.wg;
    dim3 grid((p.Lq + rows - 1) / rows, p.H, gm.B);
    attention_mma_kernel<HD, KC, WRITE><<<grid, 128 * gm.wg, smem, stream>>>(
        p, static_cast<const QT*>(p.q), static_cast<const KC*>(p.k),
        static_cast<const KC*>(p.v), p.ks, p.vs,
        static_cast<const New<QT, KC>*>(p.kn),
        static_cast<const New<QT, KC>*>(p.vn), p.kns, p.vns, p.bias,
        static_cast<QT*>(p.out), gm.stages);
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
    dim3 grid((p.Lq + BQ - 1) / BQ, p.H, gm.B);
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
cudaError_t launch_hd(int hd, const Params& p, const Geometry& gm,
                      cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_one<32, QT, KC, WRITE>(p, gm, stream);
    case 64: return launch_one<64, QT, KC, WRITE>(p, gm, stream);
    case 128: return launch_one<128, QT, KC, WRITE>(p, gm, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename QT, typename KC>
cudaError_t launch_w(bool write, int hd, const Params& p, const Geometry& gm,
                     cudaStream_t stream) {
  return write ? launch_hd<QT, KC, true>(hd, p, gm, stream)
               : launch_hd<QT, KC, false>(hd, p, gm, stream);
}

// Type codes: 0 = float32, 1 = bfloat16, 2 = int8. The pairs (q, k/v):
// (bf16, bf16), (bf16, f32), (bf16, int8), (f32, f32), (f32, int8).
cudaError_t launch(int q_dtype, int kv_dtype, bool write, int hd,
                   const Params& p, const Geometry& gm, cudaStream_t stream) {
  if (q_dtype == 1) {
    switch (kv_dtype) {
      case 1: return launch_w<bf16, bf16>(write, hd, p, gm, stream);
      case 0: return launch_w<bf16, float>(write, hd, p, gm, stream);
      case 2: return launch_w<bf16, int8_t>(write, hd, p, gm, stream);
    }
  } else if (q_dtype == 0) {
    switch (kv_dtype) {
      case 0: return launch_w<float, float>(write, hd, p, gm, stream);
      case 2: return launch_w<float, int8_t>(write, hd, p, gm, stream);
    }
  }
  return cudaErrorInvalidValue;
}

bool bad_shape(int dtype, int B, int Lq, int Lk, int H) {
  return B <= 0 || Lq <= 0 || Lk <= 0 || H <= 0 || H > 65535 || B > 65535 ||
         (dtype != 0 && dtype != 1);
}

template <int HD>
int smem_of(int q_dtype, int kv_dtype, int stages) {
  if (q_dtype == 0) return (int)smem_bytes<HD>();
  switch (kv_dtype) {
    case 1: return ring_smem<HD, bf16>(stages);
    case 0: return ring_smem<HD, float>(stages);
    default: return ring_smem<HD, int8_t>(stages);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; within a row,
// heads are packed (head h at offset h*hd) and the head dim is contiguous.
// bias: (Lq, Lk) contiguous float32, or null. out: contiguous (B, Lq, H, hd).
// wg, stages: warpgroups per block and ring stages (bf16 q; ignored for
// f32 q), from attention_plan. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int sdvar_attention(const void* q, const void* k, const void* v,
                               const void* bias, void* out, int dtype, int B,
                               int Lq, int Lk, int H, int hd, long long q_sb,
                               long long q_sl, long long k_sb, long long k_sl,
                               long long v_sb, long long v_sl, float scale,
                               void* stream, int wg, int stages) {
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
  return (int)launch(dtype, dtype, false, hd, p, Geometry{B, wg, stages},
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
    long long s_sl, float scale, void* stream, int wg, int stages) {
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
  return (int)launch(dtype, 2, false, hd, p, Geometry{B, wg, stages},
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
    long long ns_sl, float scale, void* stream, int wg, int stages) {
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
  return (int)launch(q_dtype, kv_dtype, write != 0, hd, p,
                     Geometry{B, wg, stages},
                     static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory one block takes for head dim hd, the (q, k/v)
// type codes and, bf16 q, the ring's stages, in bytes (0 for an
// unsupported hd): the compiler's -Xptxas -v report shows none of it.
extern "C" int sdvar_attention_smem_bytes(int hd, int q_dtype, int kv_dtype,
                                          int stages) {
  switch (hd) {
    case 32: return smem_of<32>(q_dtype, kv_dtype, stages);
    case 64: return smem_of<64>(q_dtype, kv_dtype, stages);
    case 128: return smem_of<128>(q_dtype, kv_dtype, stages);
    default: return 0;
  }
}
