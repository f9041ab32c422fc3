// Fused top-k / top-p / Gumbel-max sampler, hand-written for Hopper
// (sm_90a), bound to PyTorch through a plain C function loaded with ctypes.
//
// Replaces the TPU kernel sdvar_tpu/ops/pallas/sampling.py:_kernel (reached
// through fused_sample), with per-row-seed noise or explicit noise. Same
// function, row by row, on the ordered image key = (i >= 0 ? i : i ^
// 0x7FFFFFFF) ^ 0x80000000 of the f32 bits i (unsigned order = float order;
// +0.0 above -0.0):
//   - top-k (0 < top_k < V): keep key >= the k-th largest key, ties kept;
//   - nucleus (0 < top_p < 1): over the kept set, keep x_j iff the exp-mass
//     of the keys strictly above key_j is below top_p * Z (the argmax is
//     always kept);
//   - ids = argmax over the kept columns of x + g, the first index on a
//     tie, g = -log(-log(u01)) with u01 = b24 * 2^-24 + 2^-25 from the
//     murmur3 row hash of (row seed, column), or g = noise[row, col]; a
//     column that is not kept scores -1e30, as in the plain version.
//
// Both thresholds are exact selections, which the TPU kernel finds by 32
// steps of bisection each (a reduction over the row per step: about 180
// operations a logit). Here each is a two-level histogram and a small exact
// ranking over the row, which one block (32-256 threads) keeps in shared
// memory after reading it from device memory once (a row of at most
// SMEM_V = 8192 values; a wider row stays in device memory and each pass
// reads it there, through L2, so any width that is a multiple of 4 runs):
//   1. the participating values fall into 2048 bins linear in x between
//      their least and largest value (f32 subtract, multiply and
//      truncation: monotone in x, so a bin holds a contiguous run of the
//      order), 32 coarse bins of 64. For top-k every value of the row takes
//      part, and the coarse counts are kept in each thread's own byte
//      counters, summed a bin a warp: no shared-memory atomics, which
//      serialise when many lanes hit one bin. For the nucleus only the kept
//      columns (about a fifth of a decode's row) take part, and their
//      masses go into each warp's own 32 bins by 64-bit atomics. A warp scan
//      finds the coarse bin where the weight from the top reaches the
//      target;
//   2. the chosen coarse bin's elements alone go into its 64 fine bins
//      with shared-memory atomics, and a warp scan picks the fine bin;
//   3. the fine bin's elements (a few for a smooth row) are compacted and
//      ranked exactly against each other on their ordered keys: the answer
//      is the key whose tie group makes the weight from the top cross the
//      target. A bin of one value is the answer; a bin of more than 128
//      (ties, or a range that overflows f32) falls back to four
//      most-significant-digit-first radix passes of 8 bits over its keys.
//   - top-k: weight 1 a valid column, target k; integer counts, so the
//     threshold and the mask are bit-equal to the plain version's.
//   - nucleus: weight E_j = round(exp(x_j - max) * 2^b), an integer, for
//     each column top-k keeps, b = min(50, 63 - ceil(log2 V)) so that a
//     row's sum stays below 2^63; target T = ceil(top_p * sum E) (in f64).
//     The select finds the largest key whose inclusive mass from the top
//     reaches T; keeping the keys at or above it keeps exactly the columns
//     whose mass strictly above is below T. The masses are summed as
//     integers, exactly and in no order, so the kernel gives the same bits
//     every run (and in a CUDA graph); they differ from the plain
//     version's f32 sums only by the latter's rounding, on rows whose mass
//     lands within an f32 step of the threshold.
//   - the noise is drawn (row hash and two logs) and the argmax taken only
//     for the kept columns, dealt out densely to a warp's lanes.
// A thread handles 16-byte chunks of the row, threads apart (V % 4 == 0);
// the geometry comes from ops/kernels/sampling.py:sampler_plan. Dynamic
// shared memory: the row and the kept columns (4V bytes each; a wide row
// has neither: its nucleus passes skip the columns below the top-k
// threshold instead of setting the kept ones aside), the fallback's
// histogram, the ranked candidates and the per-warp coarse masses. A row
// has 32-256 threads with at most 48 registers each, so five blocks (40 KB
// of shared memory each at V = 4096) share an SM and hide each other's
// barriers.
//
// Bound on this card: one read of the (M, V) f32 logits, 67 MB at the
// 256px scale-9 shape M = V = 4096 (0.020 ms at 3.35 TB/s); the function
// needs about 4 integer operations a logit for the top-k select and 25 a
// kept logit for the rest (chip_smoke.py:sampler_bound). The kernel
// allocates nothing and does not synchronise the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef long long ll;
typedef unsigned long long u64;

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int COARSE = 32;        // coarse bins (five ballot bits)
constexpr int FINE = 64;          // fine bins of a coarse bin
constexpr int CAND = 128;         // a fine bin of at most this many is ranked directly
constexpr int RBITS = 8;          // the fallback's radix digit
constexpr int MASS_BITS = 50;     // fixed-point scale of the nucleus masses
constexpr int SMEM_V = 8192;      // the widest row held in shared memory
constexpr int SEG = 63;           // chunks a thread counts before its byte
                                  // counters (4 values a chunk) are summed
constexpr float NOT_KEPT = -1e30f;

struct Shared {
  u64 fine[FINE];                 // the chosen coarse bin's fine bins
  u64 part[MAX_WARPS];            // per-warp partial sums of a scan
  u64 above;                      // weight above the chosen bin or digit
  u64 total;                      // the participants' weight (the nucleus's Z)
  int digit;                      // the chosen bin or digit
  int count;                      // elements of the chosen fine bin
  int warp_kept[MAX_WARPS];       // columns top-k keeps, a warp's chunks
  uint32_t result;                // the selected key
  uint32_t lo[MAX_WARPS], hi[MAX_WARPS];
  float best_s[MAX_WARPS];
  int best_i[MAX_WARPS];
  int drop[MAX_WARPS];
};

// Dynamic shared memory, in this order: the row (V floats); the columns
// top-k keeps (V floats), where top-k's select first keeps its per-thread
// coarse counts (COARSE rows of threads + 4 bytes: the pad spreads a warp's
// counters over the banks); the fallback's radix histogram (2^RBITS bins
// and one pad slot a thread, 8 bytes each); the ranked candidates' weights
// and keys; the coarse bins' per-warp weights (32 a warp, 8 bytes each).
// A row wider than SMEM_V has no row and no kept columns there (`row`
// points at the logits, `kept` is unused): the counts come first.
struct Layout {
  float* row;
  float* kept;
  unsigned char* counts;  // [COARSE][threads + 4] bytes, over `kept`
  unsigned char* hist;
  uint32_t* cand_key;
  u64* cand_w;  // (int weights use the low half of the space)
  u64* coarse;  // [warps][COARSE]
};
__host__ __device__ constexpr int row_bytes(int V) {
  return V > SMEM_V ? 0 : V * 4;
}
__host__ __device__ constexpr int kept_bytes(int V, int threads) {
  return row_bytes(V) > COARSE * (threads + 4) ? row_bytes(V)
                                                : COARSE * (threads + 4);
}
__host__ __device__ constexpr int hist_offset(int V, int threads) {
  return row_bytes(V) + kept_bytes(V, threads);
}
__host__ __device__ constexpr int smem_total(int V, int threads) {
  return hist_offset(V, threads) + ((1 << RBITS) + threads) * 8 + CAND * (4 + 8) +
         threads / 32 * COARSE * 8;
}
template <bool WIDE>
__device__ __forceinline__ Layout layout(unsigned char* dyn, int V,
                                         const float* logits_row) {
  Layout l;
  l.row = WIDE ? const_cast<float*>(logits_row) : reinterpret_cast<float*>(dyn);
  l.kept = WIDE ? nullptr : l.row + V;
  l.counts = WIDE ? dyn : reinterpret_cast<unsigned char*>(l.kept);
  l.hist = dyn + hist_offset(V, blockDim.x);
  l.cand_w = reinterpret_cast<u64*>(l.hist + ((1 << RBITS) + blockDim.x) * 8);
  l.cand_key = reinterpret_cast<uint32_t*>(l.cand_w + CAND);
  l.coarse = reinterpret_cast<u64*>(l.cand_key + CAND);
  return l;
}

__device__ __forceinline__ uint32_t to_key(float x) {
  const int i = __float_as_int(x);
  return (uint32_t)(i >= 0 ? i : i ^ 0x7FFFFFFF) ^ 0x80000000u;
}
__device__ __forceinline__ float from_key(uint32_t k) {
  const int u = (int)(k ^ 0x80000000u);
  return __int_as_float(u >= 0 ? u : u ^ 0x7FFFFFFF);
}

// the least and largest of lo / hi over the block
__device__ __forceinline__ void block_min_max(uint32_t& lo, uint32_t& hi,
                                              Shared& sh) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    sh.lo[w] = lo;
    sh.hi[w] = hi;
  }
  __syncthreads();
  for (int i = 0; i < nw; ++i) {
    lo = min(lo, sh.lo[i]);
    hi = max(hi, sh.hi[i]);
  }
  __syncthreads();
}

// sum of v over this lane and the lanes after it
template <typename T>
__device__ __forceinline__ T suffix_warp(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const T o = __shfl_down_sync(0xffffffffu, v, off);
    if (lane + off < 32) v += o;
  }
  return v;
}

// warp 0: the largest of the 32 lanes' bins (lane order = bin order) whose
// weight from the top reaches target; leaves (bin, weight above) in sh
template <typename T>
__device__ __forceinline__ void pick_lane(T weight, T target, Shared& sh) {
  const int lane = threadIdx.x & 31;
  const T s = suffix_warp(weight);
  const int l = 31 - __clz(__ballot_sync(0xffffffffu, s >= target));
  if (lane == l) {
    sh.digit = l;
    sh.above = (u64)(s - weight);
  }
}

// f(x, ok) for the values of xs (16-byte aligned; n of them) in this
// thread's chunks of four, threads apart (its chunks c0 to c1 alone, where
// given); ok says whether x is one of the n. Every thread makes the same
// number of calls (f may use ballots).
__device__ __forceinline__ int chunks_of(int n) {
  return (n + 4 * (int)blockDim.x - 1) / (4 * (int)blockDim.x);
}
template <typename F>
__device__ __forceinline__ void walk(const float* xs, int n, F f, int c0 = 0,
                                     int c1 = 0x7fffffff) {
  const float4* x4 = reinterpret_cast<const float4*>(xs);
  const int tid = threadIdx.x, nt = blockDim.x, chunks = min(c1, chunks_of(n));
#pragma unroll 2
  for (int c = c0; c < chunks; ++c) {
    const int q = tid + c * nt;
    const float4 v = 4 * q < n ? x4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    f(v.x, 4 * q < n);
    f(v.y, 4 * q + 1 < n);
    f(v.z, 4 * q + 2 < n);
    f(v.w, 4 * q + 3 < n);
  }
}

// One radix pass of the fallback: the weights of the elements with
// digit(x) >= 0 in 2^RBITS bins padded one slot a thread; leaves in sh the
// largest digit whose weight from the top reaches the target and the
// weight above it.
template <typename T, typename D, typename W>
__device__ void radix_pass(const float* xs, int n, D digit, W weight, T target,
                           T* hist, Shared& sh) {
  const int tid = threadIdx.x, nt = blockDim.x, nb = 1 << RBITS;
  const int per = nb > nt ? nb / nt : 1, own = tid * per < nb ? per : 0;
  for (int i = tid; i < nb + nt; i += nt) hist[i] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    const int b = digit(xs[i]);
    if (b >= 0) atomicAdd(&hist[b + b / per], weight(xs[i]));
  }
  __syncthreads();
  T local = 0;
  for (int i = 0; i < own; ++i) local += hist[tid * per + tid + i];
  const int lane = tid & 31, w = tid >> 5, nw = nt >> 5;
  T s = suffix_warp(local);
  if (lane == 0) sh.part[w] = (u64)s;
  __syncthreads();
  for (int i = w + 1; i < nw; ++i) s += (T)sh.part[i];
  T acc = s - local;
  if (acc < target && acc + local >= target)
    for (int i = own - 1; i >= 0; --i) {
      const T h = hist[tid * per + tid + i];
      if (acc + h >= target) {
        sh.digit = tid * per + i;
        sh.above = (u64)acc;
        break;
      }
      acc += h;
    }
  __syncthreads();
}

// The largest key among the n values xs (shared memory; WIDE: device
// memory, and only those of them whose key is at least floor_key) whose
// weight from the top (the summed weights of the keys at or above it)
// reaches the target; the values lie in [from_key(lo_key),
// from_key(hi_key)]. RELATIVE (masses): the target is ceil(top_p * total
// weight); else weight(x) is 1 (counts), and a WIDE row's count pass is
// cut into SEG chunks at a time (a shared-memory row has at most 8).
template <typename T, bool RELATIVE, bool WIDE, typename W>
__device__ uint32_t select_key(const float* xs, int n, W weight, T target,
                               float top_p, uint32_t floor_key, uint32_t lo_key,
                               uint32_t hi_key, const Layout& L, Shared& sh) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, w = tid >> 5;
  const int nw = nt >> 5;
  T* fine = reinterpret_cast<T*>(sh.fine);
  T* cand_w = reinterpret_cast<T*>(L.cand_w);

  const float lo = from_key(lo_key), range = __fsub_rn(from_key(hi_key), lo);
  float scale = range > 0.f && range < 3.4e38f
                    ? __fdiv_rn((float)(COARSE * FINE), range) : 0.f;
  if (!(scale < 3.4e38f)) scale = 0.f;  // a range too small to divide by
  auto bin = [&](float x) -> int {      // fine bin, 0 .. 2047
    const int b = scale == 0.f ? 0 : (int)__fmul_rn(__fsub_rn(x, lo), scale);
    return min(b, COARSE * FINE - 1);
  };
  auto part = [&](float x, bool in) {  // x takes part in the select
    return in && (!WIDE || to_key(x) >= floor_key);
  };

  // 1. the coarse bins' weights. Counts (every value of the row): each
  // thread's own byte counters, then summed a bin a warp, no atomics.
  // Masses (the kept columns only): 64-bit integer atomics into the warp's
  // own 32 bins, exact in any order.
  if constexpr (RELATIVE) {
    u64* mine = L.coarse + w * COARSE;
    mine[lane] = 0;
    __syncwarp();
    walk(xs, n, [&](float x, bool in) {
      if (part(x, in))
        atomicAdd(reinterpret_cast<unsigned long long*>(mine + (bin(x) >> 6)),
                  (unsigned long long)weight(x));
    });
  } else {  // SEG chunks at a time, so that no byte counter passes 255
    const int stride = nt + 4, chunks = WIDE ? chunks_of(n) : 1;
    for (int c0 = 0; c0 < chunks; c0 += SEG) {
#pragma unroll
      for (int b = 0; b < COARSE; ++b) L.counts[b * stride + tid] = 0;
      walk(xs, n, [&](float x, bool in) {
        if (part(x, in)) ++L.counts[(bin(x) >> 6) * stride + tid];
      }, c0, WIDE ? c0 + SEG : 0x7fffffff);
      __syncthreads();
      const int per_warp = COARSE / nw, words = nt / 4;
      for (int k = 0; k < per_warp; ++k) {
        const int b = w * per_warp + k;
        const uint32_t* row = reinterpret_cast<const uint32_t*>(L.counts + b * stride);
        unsigned sum = 0;
        for (int q = lane; q < words; q += 32) sum = __dp4a(row[q], 0x01010101u, sum);
        sum = __reduce_add_sync(0xffffffffu, sum);
        if (lane == 0) L.coarse[b] = (c0 ? L.coarse[b] : 0) + sum;
      }
      if (WIDE) __syncthreads();
    }
  }
  for (int i = tid; i < FINE; i += nt) fine[i] = 0;
  __syncthreads();
  if (w == 0) {
    T tot = 0;
    for (int k = 0; k < (RELATIVE ? nw : 1); ++k) tot += (T)L.coarse[k * COARSE + lane];
    if constexpr (RELATIVE) {
      T all = tot;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) all += __shfl_xor_sync(0xffffffffu, all, off);
      target = (T)ceil((double)top_p * (double)all);
      if (lane == 0) sh.total = (u64)all;
    }
    pick_lane(tot, target, sh);
  }
  __syncthreads();
  const int cb = sh.digit;
  if constexpr (RELATIVE) target = (T)ceil((double)top_p * (double)sh.total);
  target -= (T)sh.above;

  // 2. the chosen coarse bin's 64 fine bins, with atomics on its elements
  // alone
  walk(xs, n, [&](float x, bool in) {
    const int b = bin(x);
    if (part(x, in) && (b >> 6) == cb) atomicAdd(&fine[b & (FINE - 1)], weight(x));
  });
  __syncthreads();
  if (w == 0) {
    const T h0 = fine[2 * lane], h1 = fine[2 * lane + 1];
    pick_lane(h0 + h1, target, sh);
    __syncwarp();
    if (lane == 0) {
      const int l = sh.digit;
      const T above = (T)sh.above, top = fine[2 * l + 1];
      const bool upper = above + top >= target;
      sh.digit = cb * FINE + 2 * l + (upper ? 1 : 0);
      sh.above = (u64)(upper ? above : above + top);
      sh.count = 0;
    }
  }
  __syncthreads();
  const int chosen = sh.digit;
  target -= (T)sh.above;

  // 3. the chosen fine bin's elements, ranked exactly
  uint32_t blo = 0xffffffffu, bhi = 0;
  auto consider = [&](float x) {
    const uint32_t k = to_key(x);
    blo = min(blo, k);
    bhi = max(bhi, k);
    const int slot = atomicAdd(&sh.count, 1);
    if (slot < CAND) {
      L.cand_key[slot] = k;
      cand_w[slot] = weight(x);
    }
  };
  walk(xs, n, [&](float x, bool in) {
    if (part(x, in) && bin(x) == chosen) consider(x);
  });
  block_min_max(blo, bhi, sh);  // also orders the stores above before the reads
  if (blo == bhi) return blo;   // one value in the bin: it is the answer
  const int c = sh.count;
  if (c <= CAND) {
    for (int i = tid; i < c; i += nt) {
      const uint32_t k = L.cand_key[i];
      T over = 0, same = 0;
      for (int q = 0; q < c; ++q) {
        const uint32_t kq = L.cand_key[q];
        if (kq > k) over += cand_w[q];
        if (kq == k) same += cand_w[q];
      }
      if (over < target && target <= over + same) sh.result = k;
    }
    __syncthreads();
    return sh.result;
  }

  // a crowded bin: four digit passes of 8 bits over its keys
  uint32_t prefix = 0, pmask = 0;
#pragma unroll 1
  for (int shift = 32 - RBITS; shift >= 0; shift -= RBITS) {
    auto digit = [&](float x) -> int {
      const uint32_t k = to_key(x);
      if (!part(x, true) || bin(x) != chosen || (k & pmask) != prefix) return -1;
      return (k >> shift) & ((1 << RBITS) - 1);
    };
    radix_pass<T>(xs, n, digit, weight, target, reinterpret_cast<T*>(L.hist), sh);
    target -= (T)sh.above;
    prefix |= (uint32_t)sh.digit << shift;
    pmask |= (uint32_t)((1 << RBITS) - 1) << shift;
  }
  return prefix;
}

__device__ __forceinline__ float noise_at(const float* noise, uint32_t seed,
                                          ll row, int col, int V) {
  if (noise != nullptr) return noise[row * V + col];
  uint32_t h = seed + (uint32_t)col * 0x9E3779B9u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  const float b24 = (float)((h >> 8) & 0xFFFFFFu);
  const float u01 = __fadd_rn(__fmul_rn(b24, 5.9604644775390625e-08f),
                              2.9802322387695312e-08f);
  return -logf(-logf(u01));
}

// the better of two (score, column) candidates: the larger score, then the
// smaller column
__device__ __forceinline__ void better(float& s, int& c, float s2, int c2) {
  if (s2 > s || (s2 == s && c2 < c)) {
    s = s2;
    c = c2;
  }
}

// WIDE: a row of more than SMEM_V values, read in device memory by every
// pass (no copy in shared memory, no kept columns set aside).
template <bool WIDE>
__global__ void __launch_bounds__(MAX_THREADS, 5) sample_kernel(
    const float* __restrict__ logits, const int* __restrict__ seeds,
    const float* __restrict__ noise, int* __restrict__ ids,
    int8_t* __restrict__ mask, int V, int top_k, float top_p, int mass_bits) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, w = tid >> 5;
  const ll row = blockIdx.x;
  const float4* xr = reinterpret_cast<const float4*>(logits + row * V);
  const Layout L = layout<WIDE>(dyn, V, logits + row * V);
  float4* row4 = reinterpret_cast<float4*>(L.row);

  // the row into shared memory (unless wide), and its least and largest keys
  uint32_t kmin = 0xffffffffu, kmax = 0;
#pragma unroll 4
  for (int q = tid; 4 * q < V; q += nt) {
    const float4 v = __ldg(xr + q);
    if (!WIDE) row4[q] = v;
    kmin = min(min(min(kmin, to_key(v.x)), to_key(v.y)), min(to_key(v.z), to_key(v.w)));
    kmax = max(max(max(kmax, to_key(v.x)), to_key(v.y)), max(to_key(v.z), to_key(v.w)));
  }
  block_min_max(kmin, kmax, sh);

  // top-k: keep key >= kth (kth = 0 keeps every column)
  uint32_t kth = 0;
  const bool topk = 0 < top_k && top_k < V;
  if (topk) {
    auto one = [](float) { return 1; };
    kth = select_key<int, false, WIDE>(L.row, V, one, top_k, 0.f, 0u, kmin, kmax,
                                       L, sh);
  }

  // nucleus over the kept columns (set aside when top-k drops some, or,
  // in a wide row, those at or above kth): keep key >= kappa among those
  uint32_t kappa = 0;
  if (0.f < top_p && top_p < 1.f) {
    auto masses = [kmax](int bits) {  // exp(x - max) with `bits` fraction bits
      const float x_max = from_key(kmax), unit = (float)(1ull << bits);
      return [x_max, unit](float x) -> u64 {
        return __float2ull_rn(__fmul_rn(expf(__fsub_rn(x, x_max)), unit));
      };
    };
    if constexpr (WIDE) {
      kappa = select_key<u64, true, true>(L.row, V, masses(mass_bits), 0ull, top_p,
                                          kth, max(kth, kmin), kmax, L, sh);
    } else {
      const float* kept = L.row;
      int n = V;
      if (topk) {  // set aside in column order: a warp's count, then places
        const int slots = (V + nt - 1) / nt;
        int mine = 0;
        for (int s = 0; s < slots; ++s) {
          const int i = tid + s * nt;
          mine += __popc(__ballot_sync(0xffffffffu, i < V && to_key(L.row[i]) >= kth));
        }
        if (lane == 0) sh.warp_kept[w] = mine;
        __syncthreads();
        int base = 0;
        n = 0;
        for (int k = 0; k < nt / 32; ++k) {
          base += k < w ? sh.warp_kept[k] : 0;
          n += sh.warp_kept[k];
        }
        for (int s = 0; s < slots; ++s) {
          const int i = tid + s * nt;
          const bool in = i < V && to_key(L.row[i]) >= kth;
          const unsigned m = __ballot_sync(0xffffffffu, in);
          if (in) L.kept[base + __popc(m & ((1u << lane) - 1))] = L.row[i];
          base += __popc(m);
        }
        __syncthreads();
        kept = L.kept;
      }
      kappa = select_key<u64, true, false>(kept, n, masses(MASS_BITS), 0ull, top_p,
                                           0u, max(kth, kmin), kmax, L, sh);
    }
  }
  const uint32_t thr = max(kth, kappa);

  // the keep mask, and the argmax of x + g over the kept columns. A
  // warp's kept columns of each chunk of four are dealt out to its lanes
  // in turn (__fns finds the lane holding the j-th), so the noise (a hash
  // and two logs) runs with every lane busy, not a fifth of them.
  const uint32_t seed = seeds != nullptr ? (uint32_t)seeds[row] : 0u;
  float best = -__int_as_float(0x7f800000);  // -inf
  int best_col = 0x7fffffff, drop = 0x7fffffff;
  const int chunks = (V + 4 * nt - 1) / (4 * nt);
  for (int c = 0; c < chunks; ++c) {
    const int q = tid + c * nt;
    const bool ok = 4 * q < V;
    const float4 v = ok ? row4[q] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float xv[4] = {v.x, v.y, v.z, v.w};
    unsigned kept[4];
    uint32_t packed = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool k = ok && to_key(xv[e]) >= thr;
      if (k) packed |= 1u << (8 * e);
      else if (ok) drop = min(drop, 4 * q + e);
      kept[e] = __ballot_sync(0xffffffffu, k);
    }
    if (ok && mask != nullptr)
      *reinterpret_cast<uint32_t*>(mask + row * V + 4 * q) = packed;
    const int c0 = __popc(kept[0]), c1 = c0 + __popc(kept[1]),
              c2 = c1 + __popc(kept[2]), total = c2 + __popc(kept[3]);
    for (int j = lane; j - lane < total; j += 32) {
      // the j-th kept value of the chunk: element e of lane src
      const int e = j < c0 ? 0 : (j < c1 ? 1 : (j < c2 ? 2 : 3));
      const int r = j - (e == 0 ? 0 : (e == 1 ? c0 : (e == 2 ? c1 : c2)));
      const unsigned m = e == 0 ? kept[0] : (e == 1 ? kept[1] : (e == 2 ? kept[2] : kept[3]));
      const int src = j < total ? __fns(m, 0, r + 1) : lane;
      const float x0 = __shfl_sync(0xffffffffu, xv[0], src);
      const float x1 = __shfl_sync(0xffffffffu, xv[1], src);
      const float x2 = __shfl_sync(0xffffffffu, xv[2], src);
      const float x3 = __shfl_sync(0xffffffffu, xv[3], src);
      if (j < total) {
        const float xe = e == 0 ? x0 : (e == 1 ? x1 : (e == 2 ? x2 : x3));
        const int col = 4 * (q - lane + src) + e;
        const float g = noise_at(noise, seed, row, col, V);
        better(best, best_col, __fadd_rn(xe, g), col);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    better(best, best_col, __shfl_xor_sync(0xffffffffu, best, off),
           __shfl_xor_sync(0xffffffffu, best_col, off));
    drop = min(drop, __shfl_xor_sync(0xffffffffu, drop, off));
  }
  if (lane == 0) {
    sh.best_s[w] = best;
    sh.best_i[w] = best_col;
    sh.drop[w] = drop;
  }
  __syncthreads();
  if (tid == 0) {
    for (int i = 1; i < nt / 32; ++i) {
      better(best, best_col, sh.best_s[i], sh.best_i[i]);
      drop = min(drop, sh.drop[i]);
    }
    if (drop < V) better(best, best_col, NOT_KEPT, drop);
    ids[row] = best_col;
  }
}

bool configured = false;  // the dynamic shared memory limit, raised once

// the nucleus masses' fraction bits: a row of V masses of at most 2^b
// sums below 2^63
int mass_bits_for(int V) {
  int log2v = 0;
  while ((1ll << log2v) < V) ++log2v;
  return 63 - log2v < MASS_BITS ? 63 - log2v : MASS_BITS;
}

}  // namespace

// logits: contiguous (M, V) float32, 16-byte aligned; seeds: (M,) int32 row
// seeds, or null when noise (contiguous (M, V) float32, 16-byte aligned)
// is given; ids: (M,) int32 out; mask: contiguous (M, V) int8 keep mask
// out, or null. threads (a power of two, 32-256) comes from
// ops/kernels/sampling.py:sampler_plan. V % 4 == 0 (a row of more than
// SMEM_V values stays in device memory). Returns the cudaError_t of the
// launch (0 = success).
extern "C" int sdvar_sample(const void* logits, const void* seeds,
                            const void* noise, void* ids, void* mask,
                            long long M, int V, int top_k, float top_p,
                            int threads, void* stream) {
  if (M <= 0 || M > 0x7fffffffLL || V <= 0 || V % 4 ||
      threads < 32 || threads > MAX_THREADS || (threads & (threads - 1)) ||
      (seeds == nullptr && noise == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(logits);
  const int* s = static_cast<const int*>(seeds);
  const float* n = static_cast<const float*>(noise);
  int* o = static_cast<int*>(ids);
  int8_t* k = static_cast<int8_t*>(mask);
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        sample_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_total(SMEM_V, MAX_THREADS));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int smem = smem_total(V, threads), bits = mass_bits_for(V);
  if (V > SMEM_V)
    sample_kernel<true><<<(unsigned)M, threads, smem, st>>>(x, s, n, o, k, V, top_k,
                                                           top_p, bits);
  else
    sample_kernel<false><<<(unsigned)M, threads, smem, st>>>(x, s, n, o, k, V, top_k,
                                                            top_p, bits);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a launch, in bytes (the compiler's -Xptxas -v
// report shows none of it).
extern "C" int sdvar_sample_smem_bytes(int V, int threads) {
  return smem_total(V, threads);
}
