// Exact top-k over the rows of a (B, P) float32 matrix, for sm_90a.
//
// Replaces orienmask_tpu/ops/pallas_topk.py::exact_topk (kernel _topk_kernel).
// Contract: values descending, ties to the lower index, bit-identical to a
// stable descending sort (lax.top_k's order).  Inputs hold no NaN.
//
// What bounds it: a row is 73 KB (P=18207) or 128 KB (P=32000), so its bytes
// take a few hundredths of a microsecond at the card's memory rate.  One CTA
// works on a row, so the work is a chain of block-wide passes over shared
// memory separated by barriers: instruction throughput on one SM, the barriers
// and the launch bound it, not bytes.  The design keeps each pass to one
// read of the row per thread and a handful of barriers.
//
// Design: one CTA of 1024 threads per row, the row's keys resident in
// dynamic shared memory.  Thread t owns the contiguous chunk
// [t*c, t*c + c) of the row, with c odd so that a warp's 32 chunk reads of
// one step fall into 32 different banks.
//   1. key(v): the float's bits mapped to an unsigned key whose order is the
//      float order (-0.0 folded onto +0.0, so they tie as a float compare
//      makes them tie); the counterpart of pallas_topk.py's _sign_biased_keys.
//   2. Radix select, 4 passes of 8 bits MSB first.  Each thread adds its
//      chunk's keys that still match the prefix into a shared 256-bin
//      histogram, one atomic per run of equal digits, the last run of each
//      warp's threads summed first (heavy ties cost one atomic per warp).  Warp 0 finds the next digit of T, the k-th
//      largest key, with a suffix scan over the bins, and how many keys
//      equal to T must be taken.
//   3. Selection: per thread, count key > T and key == T in its chunk; one
//      block-wide exclusive scan of the two counts in thread order, which is
//      index order, places each thread's winners.  The first `need` keys
//      == T in index order are taken.  Winners are 64-bit (key, ~index)
//      words.
//   4. Bitonic sort of the winners, padded to a power of two (<= 1024),
//      descending: key descending, then index ascending.
//   5. Gather the values from the input row (keeps the input's bits).
// No padding value is ever compared: rows of any length are read as they
// are, so inputs <= -3.0 and -inf are ordered like any other value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;   // the winners' bitonic sort runs in one block
constexpr int kMaxP = 65535;  // the selection scan packs two 16-bit counts
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;  // -0.0 ties with +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Winner word: key in the high half, ~index in the low half, so a larger
// word means a larger key or, at equal keys, a lower index.  Padding words
// are 0: every real key is > 0 (the key of -inf is 0x007fffff).
__device__ __forceinline__ unsigned long long winner(uint32_t key, int i) {
  return ((unsigned long long)key << 32) | (unsigned long long)(~(uint32_t)i);
}

// Exclusive scan of one value per thread in thread order; `sums` holds
// kWarps words of shared memory.  Ends with a barrier, so `sums` may be
// reused at once.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t v, uint32_t* sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = sums[lane];
    uint32_t s = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    sums[lane] = s - w;
  }
  __syncthreads();
  const uint32_t excl = sums[warp] + x - v;
  __syncthreads();
  return excl;
}

__global__ void __launch_bounds__(kThreads)
topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
            int64_t* __restrict__ idx, int P, int k, int kpad, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* win = reinterpret_cast<unsigned long long*>(smem_raw);
  uint32_t* keys = reinterpret_cast<uint32_t*>(win + kpad);
  __shared__ uint32_t hist[256];
  __shared__ uint32_t sums[kWarps];
  __shared__ uint32_t s_prefix, s_need;

  const float* row = x + (size_t)blockIdx.x * P;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = min(tid * chunk, P), hi = min(lo + chunk, P);

#pragma unroll 8
  for (int i = tid; i < P; i += kThreads) keys[i] = order_key(row[i]);
  for (int i = tid; i < kpad; i += kThreads) win[i] = 0ull;

  // ---- radix select of T, the k-th largest key --------------------------
  uint32_t prefix = 0u, mask = 0u;
  uint32_t need = (uint32_t)k;  // keys still to take among those matching prefix
  for (int shift = 24; shift >= 0; shift -= 8) {
    if (tid < 256) hist[tid] = 0u;
    __syncthreads();
    uint32_t run_d = 0u, run_n = 0u;
    for (int i = lo; i < hi; ++i) {
      const uint32_t u = keys[i];
      if ((u & mask) != prefix) continue;
      const uint32_t d = (u >> shift) & 0xffu;
      if (run_n && d != run_d) {
        atomicAdd(&hist[run_d], run_n);
        run_n = 0u;
      }
      run_d = d;
      ++run_n;
    }
    // the last run: the threads of a warp on one digit add it once (under
    // heavy ties every thread ends on the same digit)
    const unsigned peers = __match_any_sync(kFull, run_n ? run_d : 0x100u);
    const uint32_t total = __reduce_add_sync(peers, run_n);
    if (run_n && lane == __ffs(peers) - 1) atomicAdd(&hist[run_d], total);
    __syncthreads();
    if (warp == 0) {
      // lane l owns bins [8l, 8l + 8); s: keys in the bins of lanes >= l
      uint32_t own = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) own += hist[lane * 8 + j];
      uint32_t s = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_down_sync(kFull, s, o);
        if (lane + o < 32) s += y;
      }
      uint32_t above = s - own;  // keys in the bins of higher lanes
      if (above < need && need <= s) {  // exactly one lane: T's digit is here
        int d = lane * 8 + 7;
        for (; d > lane * 8; --d) {
          if (above + hist[d] >= need) break;
          above += hist[d];
        }
        s_prefix = prefix | ((uint32_t)d << shift);
        s_need = need - above;
      }
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
    mask |= 0xffu << shift;
  }
  const uint32_t T = prefix;
  const uint32_t n_gt = (uint32_t)k - need;

  // ---- selection: key > T, and the first `need` keys == T by index ------
  uint32_t c_gt = 0u, c_eq = 0u;
  for (int i = lo; i < hi; ++i) {
    const uint32_t u = keys[i];
    c_gt += u > T;
    c_eq += u == T;
  }
  // both totals are < 2^16 (P < 65536), so one scan carries the pair
  const uint32_t excl = block_exclusive_scan((c_gt << 16) | c_eq, sums);
  uint32_t pos_gt = excl >> 16, rank_eq = excl & 0xffffu;
  for (int i = lo; i < hi && (c_gt || rank_eq < need); ++i) {
    const uint32_t u = keys[i];
    if (u > T) {
      win[pos_gt++] = winner(u, i);
      --c_gt;
    } else if (u == T) {
      if (rank_eq < need) win[n_gt + rank_eq] = winner(u, i);
      ++rank_eq;
    }
  }
  __syncthreads();

  // ---- bitonic sort of the winners, descending --------------------------
  for (int size = 2; size <= kpad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < kpad; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = win[i], b = win[j];
          const bool desc = (i & size) == 0;
          if (desc ? a < b : a > b) {
            win[i] = b;
            win[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < k; i += kThreads) {
    const uint32_t id = ~(uint32_t)(win[i] & 0xffffffffull);
    vals[(size_t)blockIdx.x * k + i] = row[id];
    idx[(size_t)blockIdx.x * k + i] = (int64_t)id;
  }
}

}  // namespace

extern "C" int omt_exact_topk(const float* x, float* vals, int64_t* idx, int B,
                              int P, int k, void* stream) {
  if (k < 1 || k > kMaxK || k > P || P > kMaxP) return (int)cudaErrorInvalidValue;
  int kpad = 1;
  while (kpad < k) kpad <<= 1;
  int chunk = (P + kThreads - 1) / kThreads;
  chunk |= 1;  // odd: conflict-free chunk reads
  // fails with cudaErrorInvalidValue when the row does not fit (227 KB);
  // that error is then cleared, so the next launch does not report it
  const size_t smem = (size_t)kpad * 8 + (size_t)P * 4;
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  topk_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(x, vals, idx, P, k, kpad,
                                                           chunk);
  return (int)cudaGetLastError();
}

extern "C" const char* omt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
