// Orientation-mask assembly for sm_90a: three kernels over one predicate.
//
// For detection k of image b on anchor a, pixel (y, x) is inside its mask when
//   |fx[a,y,x] * (aw * 0.5) + x * (1/W) - cx_k| < t * w_k   and
//   |fy[a,y,x] * (ah * 0.5) + (y + row0) * (1/coord_h) - cy_k| < t * h_k.
//
// * mask_kernel replaces orienmask_tpu/ops/pallas_masks.py::
//   assemble_masks_anchor_resident (kernel _mask_kernel_anchor): (aw, ah) is
//   the row a of a per-anchor table, and 8 columns pack into one byte, MSB
//   first: out (B, K, H, W/8) uint8.  It also takes the (B, K) validity row
//   (null: all valid); an invalid detection gets an empty mask.
// * per_detection_kernel<false> replaces pallas_masks.py::assemble_masks
//   (_mask_kernel): (aw, ah) is the detection's own anchor size, out
//   (B, K, H, W) uint8 in {0, 1}, row0 = 0.
// * per_detection_kernel<true> replaces pallas_masks.py::
//   assemble_masks_bitpacked (_mask_kernel_bitpack): the same inputs, packed
//   as mask_kernel packs: out (B, K, H, W/8) uint8.
//
// mask_kernel.  What bounds it: the function needs the field planes of the
// anchors that hold a valid detection read once (2.37 MB an anchor at 544²)
// and the masks written once (3.7 MB at K=100), and 4 operations per used
// anchor and pixel for the sample positions: 1.81 us at 3.35 TB/s on the main
// path (one anchor), 7.46 us with nine.  Evaluating the predicate at every
// detection and pixel, as the TPU kernel does, is 6 instructions per
// detection-pixel in SASS (177.6 M, 5.3 us at the card's 32-bit rate), and
// most of it decides pixels far from the box.
// Design: exact tile culling.  A thread owns a tile, kTilePix columns of one
// row (kTileBytes bytes of the packed output), and keeps its sample
// positions in registers.  Each block loads the image's detections, drops
// the invalid ones and those off the table (empty masks, no predicate), and
// groups the rest by anchor in shared memory, one warp placing each group
// with ballots (two barriers in all).  kSlices threads share a tile, each
// taking one contiguous run of the grouped detections, so that it loads
// the field of only the anchors its run spans.  Per such anchor a thread
// loads its tile's field (float4s), forms the sample positions once and
// takes their min and max (NaN ignored) and whether any is NaN.  Per
// detection it classes the tile with the detection's own rounded
// differences dlo = fl(gmin - c), dhi = fl(gmax - c): all out if, in either
// axis, dhi <= -tb or dlo >= tb; all in if, in both, -tb < dlo and dhi < tb
// and the tile holds no NaN; mixed otherwise.  Round-to-nearest subtraction
// is monotone in g, so every pixel's fl(g - c) lies in [dlo, dhi] and only
// definite outcomes are taken: a NaN, inf - inf, tb <= 0 or a NaN tb ends
// as mixed or all out, where the predicate is false too.  An all out or all
// in tile stores 0 or ones; a mixed one evaluates the predicate per pixel.
// Measured on the card against other layouts of the same rule (a band of
// rows a block with the tiles' positions in shared memory, a warp a
// detection; one or four bytes a thread): shared-memory bands pay a barrier
// and a load round trip per anchor, four-byte tiles read their field
// uncoalesced, one-byte tiles class four times as many (tile, detection)
// pairs.  One launch covers the batch.
//
// per_detection_kernel (kernels 3 and 4).  What bounds it: the function
// needs the field planes of the anchors its detections use read once
// (42.6 MB at B = 2, nine anchors, 544²) and the masks written once (59.2 MB
// unpacked at K = 100, 7.4 MB packed); at 3.35 TB/s 30.4 and 14.9 us.  The
// TPU kernels' grid (one program per detection, as this file had it before)
// reads each detection's anchor field again, 473 MB of L2 traffic a call
// at those shapes, and evaluates the predicate at every detection and pixel.
// Design: mask_kernel's tiles and grouping, so a thread loads each anchor's
// field of its tile once (float4s) and keeps it in registers while it
// evaluates its run of that anchor's detections.  The anchor size differs
// between detections, so no sample position is shared; the field's bounds
// are: per anchor and tile, fmin and fmax of fx and fy (NaN ignored, a NaN
// flag), and per detection with half size s the position bounds
// [fl(fl(fmin * s) + col0), fl(fl(fmax * s) + col1)] (fmin and fmax swapped
// for s < 0), col0 and col1 the tile's first and last column coordinates:
// multiply and add in round-to-nearest are monotone in each argument, so
// every pixel's position lies inside.  classify then takes only definite
// outcomes, as for mask_kernel; a NaN bound (s NaN, inf * 0) decides
// nothing.  That is 8 operations and 4 compares a (tile, detection) pair in
// place of 16 predicates.  All out stores zeros, all in ones, mixed the
// per-pixel predicate from the field in registers.  Kernel 3 stores one
// 16-byte uint4 a tile (a warp writes 512 contiguous bytes of one mask),
// kernel 4 the same two bytes as mask_kernel, so pack_bits(kernel 3) ==
// kernel 4 by construction.  A block groups at most kChunk detections in
// shared memory (30 B each): a larger K takes more blocks in the grid's z,
// each re-reading its tiles' field.  The anchor index has no table limit.
// A detection whose anchor index is off the table gets an empty mask.
//
// Exact arithmetic, as the TPU kernels evaluate it: every multiply and add
// is a separately rounded __fmul_rn/__fadd_rn/__fsub_rn (nvcc would
// otherwise contract them into FMAs and flip boundary pixels), the column
// and row coordinates are float(i) * (1/W) with 1/W rounded to f32 on the
// host (not x / W), and the compare is the one-sided |g - c| < t * b.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kTileBytes = 2;  // mask_kernel: output bytes a tile (one 16-bit store)
constexpr int kTilePix = 8 * kTileBytes;  // columns a tile
constexpr int kTiles = 32;     // tiles a block
constexpr int kSlices = 4;     // threads a tile, each taking a run of the detections
constexpr int kThreads = kTiles * kSlices;
constexpr int kMaxAnchors = 64;  // the used anchors are one 64-bit mask
constexpr int kMaxDets = 2048;   // detections an image: 21 B each in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 1024;     // kernels 3, 4: detections a block groups (30 B each)

// The sample position f * (anchor * 0.5) + coordinate of one pixel.
__device__ __forceinline__ float sample(float f, float half_anchor, float coord) {
  return __fadd_rn(__fmul_rn(f, half_anchor), coord);
}

// The predicate of detection d = (cx, cy, t*w, t*h) at sample (gx, gy).
__device__ __forceinline__ bool inside(float gx, float gy, float4 d) {
  return fabsf(__fsub_rn(gx, d.x)) < d.z && fabsf(__fsub_rn(gy, d.y)) < d.w;
}

// The detection's box as (cx, cy, t*w, t*h).
__device__ __forceinline__ float4 load_det(const float* bx, float thresh) {
  return make_float4(bx[0], bx[1], __fmul_rn(thresh, bx[2]), __fmul_rn(thresh, bx[3]));
}

// The tile's class for detection d = (cx, cy, t*w, t*h) from its bounds t =
// (gx min, gx max, gy min, gy max): 0 all out, 1 all in, 2 mixed.
__device__ __forceinline__ int classify(float4 t, float4 d) {
  const float dlx = __fsub_rn(t.x, d.x), dhx = __fsub_rn(t.y, d.x);
  const float dly = __fsub_rn(t.z, d.y), dhy = __fsub_rn(t.w, d.y);
  if (dhx <= -d.z || dlx >= d.z || dhy <= -d.w || dly >= d.w) return 0;
  if (-d.z < dlx && dhx < d.z && -d.w < dly && dhy < d.w) return 1;
  return 2;
}

__global__ void __launch_bounds__(kThreads)
mask_kernel(const float* __restrict__ field, const float* __restrict__ boxes,
            const int* __restrict__ anchor_idx, const float* __restrict__ table,
            const uint8_t* __restrict__ valid, uint8_t* __restrict__ out, int A, int H,
            int W, int K, float thresh, float inv_w, float inv_h, int row0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // (cx, cy, t*w, t*h) of detection order[j], grouped by anchor
  float4* sorted = reinterpret_cast<float4*>(smem_raw);
  int* order = reinterpret_cast<int*>(sorted + K);
  signed char* det_anchor = reinterpret_cast<signed char*>(order + K);  // -1: an empty mask
  __shared__ unsigned long long warp_used[kThreads / 32];
  // order[start[j]] .. order[start[j + 1] - 1]: the detections of the j-th
  // used anchor, in index order; after the last used anchor, the empty masks
  __shared__ int start[kMaxAnchors + 2];

  const int b = blockIdx.y;
  const int tid = threadIdx.y * kTiles + threadIdx.x, lane = tid & 31;
  unsigned long long used = 0;
  for (int k = tid; k < K; k += kThreads) {
    const size_t bk = (size_t)b * K + k;
    int a = anchor_idx[bk];
    if (a < 0 || a >= A || (valid != nullptr && !valid[bk])) {
      a = -1;
    } else {
      used |= 1ull << a;
    }
    det_anchor[k] = (signed char)a;
  }
  const unsigned lo = __reduce_or_sync(kFull, (unsigned)used);
  const unsigned hi = __reduce_or_sync(kFull, (unsigned)(used >> 32));
  if (lane == 0) warp_used[tid >> 5] = ((unsigned long long)hi << 32) | lo;
  __syncthreads();
  used = 0;
  for (int w = 0; w < kThreads / 32; ++w) used |= warp_used[w];
  const int n_used = __popcll(used);
  if (tid < 32) {  // warp 0 groups the detections by anchor, with ballots
    int n = 0;
    unsigned long long u = used;
    for (int j = 0; j <= n_used; ++j, u &= u - 1) {
      // the j-th used anchor, or -1 for the empty masks after the last
      const int a = j < n_used ? __ffsll((long long)u) - 1 : -1;
      if (lane == 0) start[j] = n;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const bool match = k0 + lane < K && det_anchor[k0 + lane] == a;
        const unsigned m = __ballot_sync(kFull, match);
        if (match) {
          const int pos = n + __popc(m & ((1u << lane) - 1u));
          order[pos] = k0 + lane;
          sorted[pos] = load_det(boxes + ((size_t)b * K + k0 + lane) * 4, thresh);
        }
        n += __popc(m);
      }
    }
    if (lane == 0) start[n_used + 1] = n;
  }
  __syncthreads();

  // this thread's tile: kTileBytes output bytes of row y, columns x ..
  // x + kTilePix - 1 (a row's last tile may hold fewer)
  const int W8 = W >> 3, nw = (W8 + kTileBytes - 1) / kTileBytes;
  const int t = blockIdx.x * kTiles + threadIdx.x;
  if (t >= H * nw) return;
  const int y = t / nw, c = t - y * nw, x = c * kTilePix;
  const int n_bytes = min(kTileBytes, W8 - c * kTileBytes);
  const int slice = threadIdx.y;
  uint8_t* o = out + (size_t)b * K * H * W8 + (size_t)y * W8 + c * kTileBytes;
  const size_t kstride = (size_t)H * W8;  // from one detection's mask to the next
  // the tile's bits (column i is bit i ^ 7: each byte MSB first), one
  // 16-bit store when every row holds whole tiles (then it is aligned)
  auto store = [&](int k, unsigned v) {
    uint8_t* p = o + k * kstride;
    if ((W8 & 1) == 0) {
      *reinterpret_cast<uint16_t*>(p) = (uint16_t)v;
    } else {
      for (int i = 0; i < n_bytes; ++i) p[i] = (uint8_t)(v >> (8 * i));
    }
  };
  // invalid detections and anchors off the table: empty masks, no predicate
  for (int j = start[n_used] + slice; j < start[n_used + 1]; j += kSlices) store(order[j], 0u);

  const size_t plane = (size_t)H * W;
  float cols[kTilePix];
#pragma unroll
  for (int i = 0; i < kTilePix; ++i) cols[i] = __fmul_rn((float)(x + i), inv_w);
  const float row = __fmul_rn((float)(y + row0), inv_h);
  // this slice's run of the grouped detections: it forms the sample
  // positions only of the anchors the run spans
  const int first = slice * start[n_used] / kSlices;
  const int last = (slice + 1) * start[n_used] / kSlices;
  int ja = 0;
  unsigned long long u = used;
  for (; ja < n_used && start[ja + 1] <= first; ++ja) u &= u - 1;
  for (int j = first; j < last; ++ja, u &= u - 1) {
    const int a = __ffsll((long long)u) - 1;
    // the tile's sample positions (NaN past W), its bounds (NaN ignored)
    // and whether it holds a NaN
    const float* fx = field + ((size_t)b * A + a) * 2 * plane + (size_t)y * W + x;
    const float aw = __fmul_rn(table[2 * a], 0.5f);
    const float ah = __fmul_rn(table[2 * a + 1], 0.5f);
    float gx[kTilePix], gy[kTilePix];
    float4 tb = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
    bool has_nan = false;
#pragma unroll
    for (int q = 0; q < kTilePix; q += 4) {
      const bool on = x + q < W;  // W % 8 == 0: four columns lie wholly in or out
      float4 f = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
      float4 h = f;
      if (on) {
        f = *reinterpret_cast<const float4*>(fx + q);
        h = *reinterpret_cast<const float4*>(fx + plane + q);
      }
      const float fs[4] = {f.x, f.y, f.z, f.w}, hs[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gx[q + i] = on ? sample(fs[i], aw, cols[q + i]) : CUDART_NAN_F;
        gy[q + i] = on ? sample(hs[i], ah, row) : CUDART_NAN_F;
        tb = make_float4(fminf(tb.x, gx[q + i]), fmaxf(tb.y, gx[q + i]),
                         fminf(tb.z, gy[q + i]), fmaxf(tb.w, gy[q + i]));
        has_nan |= on && (isnan(gx[q + i]) || isnan(gy[q + i]));
      }
    }
    if (has_nan) tb.y = CUDART_NAN_F;  // refuses all in
    for (const int end = min(last, start[ja + 1]); j < end; ++j) {
      const float4 d = sorted[j];
      const int cls = classify(tb, d);
      unsigned v = cls == 1 ? kFull : 0u;
      if (cls == 2) {  // mixed: every pixel's predicate
        v = 0u;
#pragma unroll
        for (int i = 0; i < kTilePix; ++i) v |= (unsigned)inside(gx[i], gy[i], d) << (i ^ 7);
      }
      store(order[j], v);
    }
  }
}

// The tile's field bounds for one anchor: (fx min, fx max, fy min, fy max)
// of its on-image columns, NaN ignored (NaN only when every value is).
struct FieldTile {
  float fx[kTilePix], fy[kTilePix];  // NaN past W
  float4 lim;
  bool has_nan;  // a NaN among the on-image values: refuses all in
};

// Load row y, columns x .. x + kTilePix - 1 of both planes of one anchor's
// field (fx at f, fy at f + plane) as float4s, with their bounds.
__device__ __forceinline__ void load_field_tile(const float* f, size_t plane, int x, int W,
                                                FieldTile* t) {
  t->lim = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
  t->has_nan = false;
#pragma unroll
  for (int q = 0; q < kTilePix; q += 4) {
    const bool on = x + q < W;  // W % 8 == 0: four columns lie wholly in or out
    float4 u = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
    float4 v = u;
    if (on) {
      u = *reinterpret_cast<const float4*>(f + q);
      v = *reinterpret_cast<const float4*>(f + plane + q);
    }
    const float us[4] = {u.x, u.y, u.z, u.w}, vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      t->fx[q + i] = us[i];
      t->fy[q + i] = vs[i];
      t->lim = make_float4(fminf(t->lim.x, us[i]), fmaxf(t->lim.y, us[i]),
                           fminf(t->lim.z, vs[i]), fmaxf(t->lim.w, vs[i]));
      t->has_nan |= on && (isnan(us[i]) || isnan(vs[i]));
    }
  }
}

// The bounds (gx min, gx max, gy min, gy max) of the tile's sample positions
// for half anchor size s: round-to-nearest multiply and add are monotone in
// each argument, so for s >= 0 every pixel's fl(fl(f * s) + col) lies in
// [fl(fl(fmin * s) + col0), fl(fl(fmax * s) + col1)], and for s < 0 with
// fmin and fmax swapped.  Where the products are NaN (s NaN, inf * 0) the
// bound is NaN and decides nothing.  A NaN field value makes gx max NaN.
__device__ __forceinline__ float4 position_bounds(const FieldTile& t, float2 s, float col0,
                                                  float col1, float row) {
  const bool nx = s.x < 0.f, ny = s.y < 0.f;
  return make_float4(sample(nx ? t.lim.y : t.lim.x, s.x, col0),
                     t.has_nan ? CUDART_NAN_F : sample(nx ? t.lim.x : t.lim.y, s.x, col1),
                     sample(ny ? t.lim.w : t.lim.z, s.y, row),
                     sample(ny ? t.lim.z : t.lim.w, s.y, row));
}

// Kernels 3 and 4: kernel 2's tiles, each detection with its own anchor size.
// grid (tile blocks, image, chunk of detections); each block groups its
// chunk's detections by anchor in shared memory.  kPacked: kernel 4 (two
// bytes a tile, MSB first), else kernel 3 (16 bytes a tile, one uint4).
template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
per_detection_kernel(const float* __restrict__ field, const float* __restrict__ boxes,
                     const float* __restrict__ anchor_wh, const int* __restrict__ anchor_idx,
                     uint8_t* __restrict__ out, int A, int H, int W, int K, int chunk,
                     float thresh, float inv_w, float inv_h) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // (cx, cy, t*w, t*h) and the half anchor size of detection order[j],
  // grouped by anchor
  float4* sorted = reinterpret_cast<float4*>(smem_raw);
  float2* half = reinterpret_cast<float2*>(sorted + chunk);
  int* det_anchor = reinterpret_cast<int*>(half + chunk);  // -1: off the table
  // group j: detections order[start[j]] .. order[start[j + 1] - 1] on anchor
  // group_anchor[j]; the group after the last holds those off the table
  const int n_slots = min(A, chunk) + 2;
  int* start = det_anchor + chunk;
  int* group_anchor = start + n_slots;
  unsigned* used_bits = reinterpret_cast<unsigned*>(group_anchor + n_slots);
  const int n_words = (A + 31) >> 5;
  uint16_t* order = reinterpret_cast<uint16_t*>(used_bits + n_words);
  __shared__ int n_groups;

  const int b = blockIdx.y, k0 = blockIdx.z * chunk, kn = min(chunk, K - k0);
  const int tid = threadIdx.y * kTiles + threadIdx.x, lane = tid & 31;
  for (int i = tid; i < n_words; i += kThreads) used_bits[i] = 0u;
  __syncthreads();
  for (int k = tid; k < kn; k += kThreads) {
    int a = anchor_idx[(size_t)b * K + k0 + k];
    if (a < 0 || a >= A) {
      a = -1;
    } else {
      atomicOr(&used_bits[a >> 5], 1u << (a & 31));
    }
    det_anchor[k] = a;
  }
  __syncthreads();
  if (tid < 32) {  // warp 0 groups the detections by anchor, with ballots
    int n = 0, g = 0;
    auto place = [&](int a) {
      if (lane == 0) {
        start[g] = n;
        group_anchor[g] = a;
      }
      for (int k1 = 0; k1 < kn; k1 += 32) {
        const int k = k1 + lane;
        const bool match = k < kn && det_anchor[k] == a;
        const unsigned m = __ballot_sync(kFull, match);
        if (match) {
          const int pos = n + __popc(m & ((1u << lane) - 1u));
          const size_t bk = (size_t)b * K + k0 + k;
          order[pos] = (uint16_t)k;
          sorted[pos] = load_det(boxes + bk * 4, thresh);
          half[pos] = make_float2(__fmul_rn(anchor_wh[bk * 2], 0.5f),
                                  __fmul_rn(anchor_wh[bk * 2 + 1], 0.5f));
        }
        n += __popc(m);
      }
    };
    for (int w = 0; w < n_words; ++w) {
      for (unsigned u = used_bits[w]; u; u &= u - 1, ++g) place(32 * w + __ffs(u) - 1);
    }
    place(-1);
    if (lane == 0) {
      start[g + 1] = n;
      n_groups = g;
    }
  }
  __syncthreads();

  // this thread's tile: row y, columns x .. x + kTilePix - 1 (a row's last
  // tile may hold 8)
  const int W8 = W >> 3, nw = (W8 + kTileBytes - 1) / kTileBytes;
  const int t = blockIdx.x * kTiles + threadIdx.x;
  if (t >= H * nw) return;
  const int y = t / nw, c = t - y * nw, x = c * kTilePix;
  const bool whole = x + kTilePix <= W;
  const int slice = threadIdx.y;
  const size_t kstride = kPacked ? (size_t)H * W8 : (size_t)H * W;  // one mask to the next
  uint8_t* o = out + ((size_t)b * K + k0) * kstride
               + (kPacked ? (size_t)y * W8 + c * kTileBytes : (size_t)y * W + x);
  // bit i of v: column x + i's predicate
  auto store = [&](int k, unsigned v) {
    uint8_t* p = o + k * kstride;
    if constexpr (kPacked) {  // byte i >> 3, bit 7 - (i & 7)
      const unsigned r = __brev(v);
      const unsigned bytes = (r >> 24) | ((r >> 8) & 0xff00u);
      if ((W8 & 1) == 0) {
        *reinterpret_cast<uint16_t*>(p) = (uint16_t)bytes;
      } else {
        p[0] = (uint8_t)bytes;
        if (whole) p[1] = (uint8_t)(bytes >> 8);
      }
    } else {  // one byte a column in {0, 1}: each nibble of v spread over a word
      uint4 q;
      q.x = (v & 0xfu) * 0x204081u & 0x01010101u;
      q.y = (v >> 4 & 0xfu) * 0x204081u & 0x01010101u;
      q.z = (v >> 8 & 0xfu) * 0x204081u & 0x01010101u;
      q.w = (v >> 12 & 0xfu) * 0x204081u & 0x01010101u;
      if ((W & 15) == 0) {
        *reinterpret_cast<uint4*>(p) = q;  // 16-byte aligned
      } else {
        *reinterpret_cast<uint2*>(p) = make_uint2(q.x, q.y);
        if (whole) *reinterpret_cast<uint2*>(p + 8) = make_uint2(q.z, q.w);
      }
    }
  };
  // anchors off the table: empty masks, no predicate
  for (int j = start[n_groups] + slice; j < start[n_groups + 1]; j += kSlices) {
    store(order[j], 0u);
  }

  const size_t plane = (size_t)H * W;
  float cols[kTilePix];
#pragma unroll
  for (int i = 0; i < kTilePix; ++i) cols[i] = __fmul_rn((float)(x + i), inv_w);
  const float col1 = whole ? cols[kTilePix - 1] : cols[kTilePix / 2 - 1];
  const float row = __fmul_rn((float)y, inv_h);
  // this slice's run of the grouped detections: it loads the field of only
  // the anchors the run spans
  const int n_on = start[n_groups];
  const int first = slice * n_on / kSlices, last = (slice + 1) * n_on / kSlices;
  int g = 0;
  while (g < n_groups && start[g + 1] <= first) ++g;
  for (int j = first; j < last; ++g) {
    FieldTile ft;
    load_field_tile(field + ((size_t)b * A + group_anchor[g]) * 2 * plane + (size_t)y * W + x,
                    plane, x, W, &ft);
    for (const int end = min(last, start[g + 1]); j < end; ++j) {
      const float4 d = sorted[j];
      const float2 s = half[j];
      const int cls = classify(position_bounds(ft, s, cols[0], col1, row), d);
      unsigned v = cls == 1 ? 0xffffu : 0u;
      if (cls == 2) {  // mixed: every pixel's predicate
#pragma unroll
        for (int i = 0; i < kTilePix; ++i) {
          v |= (unsigned)inside(sample(ft.fx[i], s.x, cols[i]), sample(ft.fy[i], s.y, row), d)
               << i;
        }
      }
      store(order[j], v);
    }
  }
}

}  // namespace

extern "C" int omt_assemble_masks_packed(const float* field, const float* boxes,
                                         const int* anchor_idx, const float* table,
                                         const uint8_t* valid, uint8_t* out, int B, int A,
                                         int H, int W, int K, float thresh, float inv_w,
                                         float inv_h, int row0, void* stream) {
  if (A > kMaxAnchors || K > kMaxDets || B > 65535 || W % 8) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)K * (sizeof(float4) + sizeof(int) + sizeof(signed char));
  const int tiles = H * ((W / 8 + kTileBytes - 1) / kTileBytes);
  const dim3 grid((tiles + kTiles - 1) / kTiles, B);
  mask_kernel<<<grid, dim3(kTiles, kSlices), smem, (cudaStream_t)stream>>>(
      field, boxes, anchor_idx, table, valid, out, A, H, W, K, thresh, inv_w, inv_h, row0);
  return (int)cudaGetLastError();
}

// Kernels 3 and 4: grid (tile blocks, B, chunks of at most kChunk
// detections, as even as their number allows).
template <bool kPacked>
static int per_detection(const float* field, const float* boxes, const float* anchor_wh,
                         const int* anchor_idx, uint8_t* out, int B, int A, int H, int W,
                         int K, float thresh, float inv_w, float inv_h, void* stream) {
  const int chunks = (K + kChunk - 1) / kChunk;
  if (W % 8 || B > 65535 || chunks > 65535) return (int)cudaErrorInvalidValue;
  const int chunk = (K + chunks - 1) / chunks;
  const size_t smem = (size_t)chunk * (sizeof(float4) + sizeof(float2) + sizeof(int)
                                       + sizeof(uint16_t))
                      + (size_t)(std::min(A, chunk) + 2) * 2 * sizeof(int)
                      + (size_t)((A + 31) / 32) * sizeof(unsigned);
  const int tiles = H * ((W / 8 + kTileBytes - 1) / kTileBytes);
  const dim3 grid((tiles + kTiles - 1) / kTiles, B, chunks);
  per_detection_kernel<kPacked><<<grid, dim3(kTiles, kSlices), smem, (cudaStream_t)stream>>>(
      field, boxes, anchor_wh, anchor_idx, out, A, H, W, K, chunk, thresh, inv_w, inv_h);
  return (int)cudaGetLastError();
}

extern "C" int omt_assemble_masks(const float* field, const float* boxes,
                                  const float* anchor_wh, const int* anchor_idx,
                                  uint8_t* out, int B, int A, int H, int W, int K,
                                  float thresh, float inv_w, float inv_h, void* stream) {
  return per_detection<false>(field, boxes, anchor_wh, anchor_idx, out, B, A, H, W, K, thresh,
                              inv_w, inv_h, stream);
}

extern "C" int omt_assemble_masks_bitpacked(const float* field, const float* boxes,
                                            const float* anchor_wh, const int* anchor_idx,
                                            uint8_t* out, int B, int A, int H, int W,
                                            int K, float thresh, float inv_w, float inv_h,
                                            void* stream) {
  return per_detection<true>(field, boxes, anchor_wh, anchor_idx, out, B, A, H, W, K, thresh,
                             inv_w, inv_h, stream);
}

extern "C" const char* omt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
