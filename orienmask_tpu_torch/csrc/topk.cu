// Exact top-k over the rows of a (B, P) float32 matrix, for sm_90a.
//
// Replaces orienmask_tpu/ops/pallas_topk.py::exact_topk (:157; its
// pallas_call at :173, kernel _topk_kernel).  Contract: values descending,
// ties to the lower index, bit-identical to a stable descending sort
// (lax.top_k's order).  -0.0 ties with +0.0; -inf and values <= -3.0 are
// ordered like any others.  Inputs hold no NaN.
//
// What bounds it: a row is 73 KB (P=18207) or 128 KB (P=32000), a few
// hundredths of a microsecond at the card's memory rate, and a radix select
// needs a compare per key and pass.  So at the main path's batch of one row
// the bound is far below what any launch takes: what costs is latency, the
// chain of barriers between passes, and the one SM that a one-CTA-a-row
// design leaves working while 131 wait.  The detect stage maps every score
// under conf_thresh to -1.0, so rows are tie-heavy: T, the k-th largest key,
// is often shared by thousands of keys.
//
// Design: one row over a thread-block cluster of C CTAs (C from the shape,
// ops/topk.py::launch_plan), launched with cudaLaunchKernelEx.
//   * CTA r of the cluster owns the contiguous range [r*per, (r+1)*per) of
//     the row, per = ceil(P/C) <= kKeysPerCta; its 512 threads hold those
//     keys in registers, 16 a thread, slot j of thread t at j*512 + t (the
//     loads coalesced, and index order is (j, warp, lane) order).
//   * key(v): the float's bits mapped to an unsigned key whose order is the
//     float order, -0.0 folded onto +0.0.
//   * Radix select of T in three passes of 11, 11 and 10 bits, MSB first.
//     Each CTA adds its keys that still match the prefix into its own shared
//     histogram, one shared atomic a key (on an H100 that beats merging a
//     warp's equal digits with __match_any_sync first, ties included), and
//     counts them per group of 32 bins.  One cluster barrier;
//     then one warp of every CTA sums the C CTAs' group counts through
//     distributed shared memory (cluster.map_shared_rank), finds T's group
//     with a warp suffix scan, sums that group's 32 bins over the C CTAs and
//     finds T's digit: every CTA finds the same, reading 96 words a CTA (not
//     the 2048 bins), all C CTAs' at once, and with no trip to device memory.
//     Each pass has its own histogram, so none is cleared between passes.
//     Once T's bin holds exactly the keys still to take, every key in it is a
//     winner and the passes stop: the selection then compares the masked
//     prefix.
//   * Selection: the same warp also counts the lower-ranked CTAs' keys above
//     T's bin and in it.  Per warp and slot, ballots of key > T and key == T;
//     one warp scans the (slot, warp) counts within the CTA; with the lower
//     ranks' counts that places every winner, the keys > T first, then the
//     first `need` keys == T in index order.  Winners are 64-bit (key,
//     ~index) words, so a larger word is a larger key or, at equal keys, a
//     lower index; each goes to every CTA's shared winner array, then one
//     cluster barrier.
//   * Rank sort: the k words are distinct, so a winner's output slot is the
//     number of words greater than it.  Each CTA ranks its k/C winners
//     against all k (a warp per 4 winners, the lanes splitting the words);
//     then each thread writes one winner's value, read back from the input
//     row by its index (which keeps the input's bits), and int64 index to
//     its slot.
// No padding value is ever compared, and a CTA whose range is empty (P < C)
// only takes part in the barriers.  A launch the card refuses (cluster too
// large, too few SMs free) returns its error; there is no other path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kKeysPerThread = 16;
constexpr int kKeysPerCta = kThreads * kKeysPerThread;  // ops/topk.py KEYS_PER_CTA
constexpr int kMaxK = 1024;
constexpr int kInFlight = 8;  // remote loads a lane issues before it adds them
constexpr int kBins = 2048;  // 11-bit digits; the last pass uses 1024
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;  // -0.0 ties with +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long winner(uint32_t key, int i) {
  return ((unsigned long long)key << 32) | (unsigned long long)(~(uint32_t)i);
}

__global__ void __launch_bounds__(kThreads, 2)
topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
            int64_t* __restrict__ idx, int P, int k) {
  __shared__ uint32_t hist[3][kBins];
  __shared__ unsigned long long win[kMaxK];
  __shared__ uint32_t slot_of[kMaxK];  // output slot of this CTA's winners
  __shared__ uint32_t cnt[kKeysPerThread * kWarps];  // (slot, warp): gt << 16 | eq
  __shared__ __align__(8) uint32_t coarse[3][kBins / 32];  // per pass, per 32 bins
  __shared__ uint32_t s_off[2];
  __shared__ uint32_t s_prefix, s_need, s_exact, s_digit;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xr = x + (size_t)row * P;
  const int per = (P + C - 1) / C;
  const int lo = min(rank * per, P);
  const int n = min(per, P - lo);  // this CTA's keys
  const int slots = (n + kThreads - 1) / kThreads;

  uint32_t key[kKeysPerThread];
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int i = j * kThreads + tid;
    key[j] = order_key(i < n ? xr[lo + i] : 0.0f);
  }
  for (int i = tid; i < 3 * kBins; i += kThreads) (&hist[0][0])[i] = 0u;
  __syncthreads();

  // ---- radix select of T, the k-th largest key --------------------------
  uint32_t prefix = 0u, mask = 0u;
  uint32_t need = (uint32_t)k;  // keys still to take among those matching prefix
  bool exact = false;
  uint32_t gt_lo = 0u, eq_lo = 0u;  // warp 0's: see below
#pragma unroll 1
  for (int pass = 0; pass < 3 && !exact; ++pass) {
    const int shift = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
    const uint32_t dmask = pass == 2 ? 0x3ffu : 0x7ffu;
    uint32_t* h = hist[pass];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      if (j >= slots) break;
      const bool in = j * kThreads + tid < n && (key[j] & mask) == prefix;
      if (in) atomicAdd(&h[(key[j] >> shift) & dmask], 1u);
    }
    // per group of 32 bins, this CTA's count (64 groups; 32 in the last pass)
    __syncthreads();
    const int groups = (int)(dmask + 1) / 32;
    uint32_t* g_cnt = coarse[pass];
    for (int g = warp; g < groups; g += kWarps) {
      const uint32_t v = __reduce_add_sync(kFull, h[32 * g + lane]);
      if (lane == 0) g_cnt[g] = v;
    }
    cluster.sync();

    // warp 0 sums the cluster's group counts, finds T's group, then sums
    // that group's 32 bins and finds T's digit: every CTA finds the same.
    // Beside the sums, it counts the keys of the lower-ranked CTAs above
    // T's bin (gt_lo) and in it (eq_lo), which place this CTA's winners.
    if (warp == 0) {
      // groups 2*lane and 2*lane + 1: the cluster's counts, the lower ranks'
      uint32_t g0 = 0u, g1 = 0u, l0 = 0u, l1 = 0u;
      if (2 * lane < groups) {
        for (int q0 = 0; q0 < C; q0 += kInFlight) {
          uint2 v[kInFlight];
#pragma unroll
          for (int i = 0; i < kInFlight; ++i) {
            v[i] = q0 + i < C
                       ? reinterpret_cast<const uint2*>(cluster.map_shared_rank(g_cnt, q0 + i))[lane]
                       : make_uint2(0u, 0u);
          }
#pragma unroll
          for (int i = 0; i < kInFlight; ++i) {
            g0 += v[i].x;
            g1 += v[i].y;
            if (q0 + i < rank) {
              l0 += v[i].x;
              l1 += v[i].y;
            }
          }
        }
      }
      const uint32_t own = g0 + g1;
      uint32_t s = own;  // keys in the groups of lanes >= this one
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_down_sync(kFull, s, o);
        if (lane + o < 32) s += y;
      }
      uint32_t above = s - own;  // keys in higher groups than this lane's
      const bool here = above < need && need <= s;  // exactly one lane
      int grp = 2 * lane;
      if (above + g1 >= need) ++grp;
      else above += g1;
      const int src = __ffs(__ballot_sync(kFull, here)) - 1;
      grp = __shfl_sync(kFull, grp, src);
      above = __shfl_sync(kFull, above, src);  // keys in groups above T's
      gt_lo += __reduce_add_sync(kFull, (2 * lane > grp ? l0 : 0u) +
                                            (2 * lane + 1 > grp ? l1 : 0u));
      uint32_t b = 0u, bl = 0u;  // bin 32*grp + lane: the cluster's, the lower ranks'
      for (int q0 = 0; q0 < C; q0 += kInFlight) {
        uint32_t v[kInFlight];
#pragma unroll
        for (int i = 0; i < kInFlight; ++i)
          v[i] = q0 + i < C ? cluster.map_shared_rank(h, q0 + i)[32 * grp + lane] : 0u;
#pragma unroll
        for (int i = 0; i < kInFlight; ++i) {
          b += v[i];
          if (q0 + i < rank) bl += v[i];
        }
      }
      uint32_t t = b;  // keys in the group's bins >= this lane's
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_down_sync(kFull, t, o);
        if (lane + o < 32) t += y;
      }
      const uint32_t a = above + t - b;  // keys above this bin
      const bool hit = a < need && need <= a + b;  // exactly one lane: T's digit
      const int dl = __ffs(__ballot_sync(kFull, hit)) - 1;
      gt_lo += __reduce_add_sync(kFull, lane > dl ? bl : 0u);
      eq_lo = __shfl_sync(kFull, bl, dl);
      if (hit) {
        s_digit = (uint32_t)(32 * grp + lane);
        s_prefix = prefix | (s_digit << shift);
        s_need = need - a;
        s_exact = b == need - a;
      }
    }
    __syncthreads();
    prefix = s_prefix;
    need = s_need;
    exact = s_exact;
    mask |= dmask << shift;
  }
  const uint32_t n_gt = (uint32_t)k - need;  // keys above T's masked prefix

  // ---- selection: (slot, warp) counts, scanned within the CTA ------------
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    if (j >= slots) break;
    const bool v = j * kThreads + tid < n;
    const uint32_t m = key[j] & mask;
    const unsigned bg = __ballot_sync(kFull, v && m > prefix);
    const unsigned be = __ballot_sync(kFull, v && m == prefix);
    if (lane == 0) cnt[j * kWarps + warp] = ((uint32_t)__popc(bg) << 16) | (uint32_t)__popc(be);
  }
  __syncthreads();
  if (warp == 0) {
    // lane l scans entries [kPer*l, kPer*(l + 1)) in order; per CTA gt < 1024
    // and eq <= kKeysPerCta, so the packed halves do not carry into each other
    constexpr int kPer = kKeysPerThread * kWarps / 32;
    const int entries = slots * kWarps;
    uint32_t v[kPer], sum = 0u;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = lane * kPer + e;
      v[e] = i < entries ? cnt[i] : 0u;
      sum += v[e];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    uint32_t run = incl - sum;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int i = lane * kPer + e;
      if (i < entries) cnt[i] = run;
      run += v[e];
    }
    if (lane == 0) {  // the winners of the lower-ranked CTAs come first
      s_off[0] = gt_lo;
      s_off[1] = eq_lo;
    }
  }
  __syncthreads();

  // ---- winners to every CTA's shared array -------------------------------
  const uint32_t off_gt = s_off[0], off_eq = s_off[1];
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    if (j >= slots) break;
    const int i = j * kThreads + tid;
    const bool v = i < n;
    const uint32_t m = key[j] & mask;
    const bool gt = v && m > prefix, eq = v && m == prefix;
    const unsigned bg = __ballot_sync(kFull, gt), be = __ballot_sync(kFull, eq);
    const uint32_t base = cnt[j * kWarps + warp];
    int slot = -1;
    if (gt) {
      slot = (int)(off_gt + (base >> 16) + __popc(bg & lt));
    } else if (eq) {
      const uint32_t r = off_eq + (base & 0xffffu) + __popc(be & lt);
      if (r < need) slot = (int)(n_gt + r);
    }
    if (slot >= 0) {
      const unsigned long long w = winner(key[j], lo + i);
      for (int q = 0; q < C; ++q) cluster.map_shared_rank(win, q)[slot] = w;
    }
  }
  cluster.sync();  // the last access to another CTA's shared memory is above

  // ---- rank sort: slot = the number of winner words greater -------------
  // a warp ranks 4 of this CTA's winners at once, its lanes splitting the k
  // words; then every thread writes one winner's value and index
  const int w_lo = k * rank / C, w_hi = k * (rank + 1) / C;
  for (int w0 = w_lo + 4 * warp; w0 < w_hi; w0 += 4 * kWarps) {
    unsigned long long me[4];
    uint32_t above[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 4; ++e) me[e] = w0 + e < w_hi ? win[w0 + e] : ~0ull;
    for (int j = lane; j < k; j += 32) {
      const unsigned long long v = win[j];
#pragma unroll
      for (int e = 0; e < 4; ++e) above[e] += v > me[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t r = __reduce_add_sync(kFull, above[e]);
      if (lane == e && w0 + e < w_hi) slot_of[w0 + e - w_lo] = r;
    }
  }
  __syncthreads();
  for (int w = w_lo + tid; w < w_hi; w += kThreads) {
    const uint32_t id = ~(uint32_t)(win[w] & 0xffffffffull);
    const size_t out = (size_t)row * k + slot_of[w - w_lo];
    vals[out] = xr[id];
    idx[out] = (int64_t)id;
  }
}

}  // namespace

// C CTAs a row (a cluster), B rows; ops/topk.py::launch_plan picks C.
extern "C" int omt_exact_topk(const float* x, float* vals, int64_t* idx, int B,
                              int P, int k, int C, void* stream) {
  if (k < 1 || k > kMaxK || k > P || C < 1 || (P + C - 1) / C > kKeysPerCta)
    return (int)cudaErrorInvalidValue;
  // C > 8 is a non-portable cluster size (up to 16 on an H100); the launch
  // refuses a larger C
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, C > 8 ? 1 : 0);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * C));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a refused launch (cluster size, resources) reports here; its error is
  // cleared, so the next launch does not report it
  err = cudaLaunchKernelEx(&cfg, topk_kernel, x, vals, idx, P, k);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* omt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
