// An alternative layout of kernel 2, timed beside the shipped one by
// probe/designs.py: a byte a thread, warp-level pre-culling and parallel
// grouping.  The file's header comment below is older text and does not
// describe this layout.

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
// * unpacked_kernel replaces pallas_masks.py::assemble_masks (_mask_kernel):
//   (aw, ah) is the detection's own anchor size, out (B, K, H, W) uint8 in
//   {0, 1}, row0 = 0.
// * bitpacked_kernel replaces pallas_masks.py::assemble_masks_bitpacked
//   (_mask_kernel_bitpack): the same per-detection inputs as unpacked_kernel,
//   packed MSB first with shifts and ors: out (B, K, H, W/8) uint8.
//
// mask_kernel.  What the function needs: at 544², K=100 it reads the field
// planes of the anchors that hold a detection once (2.37 MB an anchor, 21.3
// MB with all A=9) and writes 3.7 MB of bytes, and forms the sample
// positions with 4 operations per used anchor and pixel: 1.81 us at 3.35
// TB/s on the main path (one anchor), 7.46 us with nine.  Evaluating the
// predicate at every detection and pixel, as the TPU kernel does, is 6
// instructions per detection-pixel in SASS (177.6 M, 5.3 us at the card's
// 32-bit instruction rate), most of it for pixels far from the box.
// Design: exact tile culling.  A block owns a band of kBandRows rows of one
// image; a tile is one row by 32 columns, the pixels of one 32-bit word of
// the packed output.  Per anchor that holds a valid detection, the block
// forms its band's sample positions once into shared memory (a lane a
// column, coalesced loads; NaN past column W) with each tile's min and max
// of gx and gy (NaN ignored) and a NaN flag (the max of gx made NaN).  Then
// a warp takes its share of that anchor's detections and classes each tile
// with the detection's own rounded differences dlo = fl(gmin - c), dhi =
// fl(gmax - c): all out if, in either axis, dhi <= -tb or dlo >= tb; all in
// if, in both, -tb < dlo and dhi < tb; mixed otherwise.  Round-to-nearest
// subtraction is monotone in g, so every pixel's fl(g - c) lies in [dlo,
// dhi], and only definite outcomes are taken: a NaN, inf - inf, tb <= 0 or a
// NaN tb ends as mixed or all out, where the predicate is false too.  An all
// out or all in tile is the word 0 or ~0; a mixed tile is evaluated by the
// whole warp, a lane a column, and __ballot_sync packs the word (lane L
// takes column L ^ 7, so the little-endian word holds each byte MSB first).
// A warp's store covers 32 consecutive words of the detection's band, which
// are contiguous in memory when W % 32 == 0.  A detection that is invalid
// or whose anchor index is off the table gets zero words with no predicate.
// Barriers: one after the block loads the detections, then two per used
// anchor less one (two on the main path).  One launch covers the batch.
//
// unpacked_kernel and bitpacked_kernel are the per-detection formulation:
// one block per (image, detection, run of pixels), so each detection reads
// its own anchor's field slice (from L2 after the first detection of that
// anchor) and uses its own anchor size, which need not be a table row.
// unpacked_kernel: one thread per 4 pixels of a row, two float4 loads and one
// uchar4 store; bitpacked_kernel: one thread per output byte, four float4
// loads and one byte store.  At 544², K=100 the first writes 29.6 MB, the
// second 3.7 MB; both read at least the used anchors' field once.
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

namespace {

constexpr int kBytes = 32;   // mask_kernel: tiles (output bytes) a block; a warp's worth
constexpr int kSlices = 4;   // threads a tile, each taking every kSlices-th detection
constexpr int kThreads = kBytes * kSlices;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAnchors = 64;  // the used anchors are one 64-bit mask
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff, kIntMin = -kIntMax - 1;
// dynamic shared memory a block may opt in to (227 KB) less the static part
constexpr size_t kMaxDynamicSmem = 232448 - 1024;
constexpr int kDetThreads = 256;  // per-detection kernels: threads per block

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

// Min and max over the warp's lanes, NaN ignored (NaN when every lane's is):
// a float's bits made an order-preserving int, then one __reduce_*_sync.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

__device__ __forceinline__ float warp_min(float v) {
  const int m = __reduce_min_sync(kFull, isnan(v) ? kIntMax : order_key(v));
  return m == kIntMax ? CUDART_NAN_F : key_float(m);
}

__device__ __forceinline__ float warp_max(float v) {
  const int m = __reduce_max_sync(kFull, isnan(v) ? kIntMin : order_key(v));
  return m == kIntMin ? CUDART_NAN_F : key_float(m);
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

// The n-th (from 0) set bit of a 64-bit mask.
__device__ __forceinline__ int nth_bit(unsigned long long m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1;
  return __ffsll((long long)m) - 1;
}

__global__ void __launch_bounds__(kThreads)
mask_kernel(const float* __restrict__ field, const float* __restrict__ boxes,
            const int* __restrict__ anchor_idx, const float* __restrict__ table,
            const uint8_t* __restrict__ valid, uint8_t* __restrict__ out, int A, int H,
            int W, int K, float thresh, float inv_w, float inv_h, int row0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* det = reinterpret_cast<float4*>(smem_raw);  // (cx, cy, t*w, t*h)
  float4* sorted = det + K;                            // det, grouped by anchor
  int* det_anchor = reinterpret_cast<int*>(sorted + K);  // -1: an empty mask
  int* order = det_anchor + K;                         // sorted[j] is det[order[j]]
  __shared__ unsigned long long warp_used[kWarps];
  // group j < n_used: the detections of the j-th used anchor; group n_used:
  // the empty masks.  order[start[j]] .. order[start[j + 1] - 1], index order
  __shared__ int count[kMaxAnchors + 1], start[kMaxAnchors + 2];

  const int b = blockIdx.y;
  const int tid = threadIdx.y * kBytes + threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long used = 0;
  for (int k = tid; k < K; k += kThreads) {
    const size_t bk = (size_t)b * K + k;
    det[k] = load_det(boxes + bk * 4, thresh);
    int a = anchor_idx[bk];
    if (a < 0 || a >= A || (valid != nullptr && !valid[bk])) {
      a = -1;
    } else {
      used |= 1ull << a;
    }
    det_anchor[k] = a;
  }
  const unsigned lo = __reduce_or_sync(kFull, (unsigned)used);
  const unsigned hi = __reduce_or_sync(kFull, (unsigned)(used >> 32));
  if (lane == 0) warp_used[warp] = ((unsigned long long)hi << 32) | lo;
  __syncthreads();
  used = 0;
  for (int w = 0; w < kWarps; ++w) used |= warp_used[w];
  const int n_used = __popcll(used);
  // group the detections by anchor, a warp a group: count, then place
  for (int j = warp; j <= n_used; j += kWarps) {
    const int a = j < n_used ? nth_bit(used, j) : -1;
    int n = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      n += __popc(__ballot_sync(kFull, k0 + lane < K && det_anchor[k0 + lane] == a));
    }
    if (lane == 0) count[j] = n;
  }
  __syncthreads();
  for (int j = warp; j <= n_used; j += kWarps) {
    const int a = j < n_used ? nth_bit(used, j) : -1;
    int n = 0;
    for (int i = lane; i < j; i += 32) n += count[i];
    n = __reduce_add_sync(kFull, n);
    if (lane == 0) start[j] = n;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const bool match = k0 + lane < K && det_anchor[k0 + lane] == a;
      const unsigned m = __ballot_sync(kFull, match);
      if (match) {
        const int pos = n + __popc(m & ((1u << lane) - 1u));
        order[pos] = k0 + lane;
        sorted[pos] = det[k0 + lane];
      }
      n += __popc(m);
    }
  }
  if (tid == 0) start[n_used + 1] = K;
  __syncthreads();

  // this thread's tile: one output byte, row y, columns x .. x + 7; a warp
  // holds 32 consecutive bytes and one slice
  const int W8 = W >> 3;
  const int t = blockIdx.x * kBytes + threadIdx.x;
  const bool live = t < H * W8;
  const int y = t / W8, x = (t - y * W8) * 8;
  const int slice = threadIdx.y;
  uint8_t* o = out + (size_t)b * K * H * W8 + t;  // + k * H * W8
  const size_t kstride = (size_t)H * W8;
  // invalid detections and anchors off the table: empty masks, no predicate
  if (live) {
    for (int j = start[n_used] + slice; j < start[n_used + 1]; j += kSlices) {
      o[order[j] * kstride] = 0;
    }
  }

  const size_t plane = (size_t)H * W;
  float cols[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cols[i] = __fmul_rn((float)(x + i), inv_w);
  const float row = __fmul_rn((float)(y + row0), inv_h);
  unsigned long long u = used;
  for (int ja = 0; ja < n_used; ++ja, u &= u - 1) {
    const int a = __ffsll((long long)u) - 1;
    // the tile's sample positions, its bounds (NaN ignored) and a NaN flag;
    // a tile past the image's end holds only NaN
    float4 fx0, fx1, fy0, fy1;
    fx0 = fx1 = fy0 = fy1 = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
    if (live) {
      const float* fx = field + ((size_t)b * A + a) * 2 * plane + (size_t)y * W + x;
      fx0 = *reinterpret_cast<const float4*>(fx);
      fx1 = *reinterpret_cast<const float4*>(fx + 4);
      fy0 = *reinterpret_cast<const float4*>(fx + plane);
      fy1 = *reinterpret_cast<const float4*>(fx + plane + 4);
    }
    const float fxs[8] = {fx0.x, fx0.y, fx0.z, fx0.w, fx1.x, fx1.y, fx1.z, fx1.w};
    const float fys[8] = {fy0.x, fy0.y, fy0.z, fy0.w, fy1.x, fy1.y, fy1.z, fy1.w};
    const float aw = __fmul_rn(table[2 * a], 0.5f);
    const float ah = __fmul_rn(table[2 * a + 1], 0.5f);
    float gx[8], gy[8];
    float4 tb = make_float4(CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F, CUDART_NAN_F);
    bool has_nan = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      gx[i] = sample(fxs[i], aw, cols[i]);
      gy[i] = sample(fys[i], ah, row);
      tb = make_float4(fminf(tb.x, gx[i]), fmaxf(tb.y, gx[i]), fminf(tb.z, gy[i]),
                       fmaxf(tb.w, gy[i]));
      has_nan |= live && (isnan(gx[i]) || isnan(gy[i]));
    }
    // the warp's 32 tiles as one tile (the same rule over their union)
    const bool warp_nan = __any_sync(kFull, has_nan);
    float4 wb = make_float4(warp_min(tb.x), warp_max(tb.y), warp_min(tb.z), warp_max(tb.w));
    if (warp_nan) wb.y = CUDART_NAN_F;
    if (has_nan) tb.y = CUDART_NAN_F;  // refuses all in
    // this slice's detections of the anchor, 32 at a time: a lane classes one
    // against the warp's tiles; a detection all out or all in there is a
    // store per tile, the others are classed tile by tile
    const int end = start[ja + 1];
    for (int j0 = start[ja] + slice; j0 < end; j0 += 32 * kSlices) {
      const int jl = j0 + lane * kSlices;
      const int wcls = jl < end ? classify(wb, sorted[jl]) : 3;
      unsigned todo = __ballot_sync(kFull, wcls != 3);
      const unsigned ones = __ballot_sync(kFull, wcls == 1);
      const unsigned mixed = __ballot_sync(kFull, wcls == 2);
      while (todo) {
        const int i = __ffs(todo) - 1;
        todo &= todo - 1u;
        const int j = j0 + i * kSlices;
        unsigned byte = (ones >> i) & 1u ? 0xffu : 0u;
        if ((mixed >> i) & 1u) {
          const float4 d = sorted[j];
          const int cls = classify(tb, d);
          byte = cls == 1 ? 0xffu : 0u;
          if (cls == 2) {  // mixed: every pixel's predicate, MSB first
#pragma unroll
            for (int p = 0; p < 8; ++p) byte |= (unsigned)inside(gx[p], gy[p], d) << (7 - p);
          }
        }
        if (live) o[order[j] * kstride] = (uint8_t)byte;
      }
    }
  }
}

// Per-detection kernels: blockIdx.y = detection, blockIdx.z = image.
// Returns the detection's field planes (fx; fy = fx + H*W) or nullptr when
// its anchor index is off the table, and its box and half anchor size.
__device__ __forceinline__ const float* det_setup(
    const float* field, const float* boxes, const float* anchor_wh,
    const int* anchor_idx, int A, int H, int W, int K, float thresh, float4* d,
    float* aw, float* ah) {
  const int b = blockIdx.z, k = blockIdx.y;
  const size_t bk = (size_t)b * K + k;
  const int a = anchor_idx[bk];
  *d = load_det(boxes + bk * 4, thresh);
  *aw = __fmul_rn(anchor_wh[bk * 2], 0.5f);
  *ah = __fmul_rn(anchor_wh[bk * 2 + 1], 0.5f);
  if (a < 0 || a >= A) return nullptr;
  return field + ((size_t)b * A + a) * 2 * (size_t)H * W;
}

__global__ void __launch_bounds__(kDetThreads)
unpacked_kernel(const float* __restrict__ field, const float* __restrict__ boxes,
                const float* __restrict__ anchor_wh, const int* __restrict__ anchor_idx,
                uint8_t* __restrict__ out, int A, int H, int W, int K, float thresh,
                float inv_w, float inv_h) {
  const int W4 = W >> 2;
  const int q = blockIdx.x * kDetThreads + threadIdx.x;  // 4-pixel group
  if (q >= H * W4) return;
  const int y = q / W4, x = (q - y * W4) * 4;
  float4 d;
  float aw, ah;
  const float* fx = det_setup(field, boxes, anchor_wh, anchor_idx, A, H, W, K, thresh,
                              &d, &aw, &ah);
  const size_t plane = (size_t)H * W;
  uchar4 m = make_uchar4(0, 0, 0, 0);
  if (fx != nullptr) {
    const float4 f0 = *reinterpret_cast<const float4*>(fx + (size_t)y * W + x);
    const float4 f1 = *reinterpret_cast<const float4*>(fx + plane + (size_t)y * W + x);
    const float row = __fmul_rn((float)y, inv_h);
    const float gy0 = sample(f1.x, ah, row), gy1 = sample(f1.y, ah, row);
    const float gy2 = sample(f1.z, ah, row), gy3 = sample(f1.w, ah, row);
    m.x = inside(sample(f0.x, aw, __fmul_rn((float)x, inv_w)), gy0, d);
    m.y = inside(sample(f0.y, aw, __fmul_rn((float)(x + 1), inv_w)), gy1, d);
    m.z = inside(sample(f0.z, aw, __fmul_rn((float)(x + 2), inv_w)), gy2, d);
    m.w = inside(sample(f0.w, aw, __fmul_rn((float)(x + 3), inv_w)), gy3, d);
  }
  const size_t bk = (size_t)blockIdx.z * K + blockIdx.y;
  reinterpret_cast<uchar4*>(out + bk * plane)[q] = m;
}

__global__ void __launch_bounds__(kDetThreads)
bitpacked_kernel(const float* __restrict__ field, const float* __restrict__ boxes,
                 const float* __restrict__ anchor_wh, const int* __restrict__ anchor_idx,
                 uint8_t* __restrict__ out, int A, int H, int W, int K, float thresh,
                 float inv_w, float inv_h) {
  const int W8 = W >> 3;
  const int t = blockIdx.x * kDetThreads + threadIdx.x;  // output byte
  if (t >= H * W8) return;
  const int y = t / W8, x8 = t - y * W8;
  float4 d;
  float aw, ah;
  const float* fx = det_setup(field, boxes, anchor_wh, anchor_idx, A, H, W, K, thresh,
                              &d, &aw, &ah);
  unsigned byte = 0u;
  if (fx != nullptr) {
    const float* px = fx + (size_t)y * W + x8 * 8;
    const float* py = px + (size_t)H * W;
    const float4 x0 = *reinterpret_cast<const float4*>(px);
    const float4 x1 = *reinterpret_cast<const float4*>(px + 4);
    const float4 y0 = *reinterpret_cast<const float4*>(py);
    const float4 y1 = *reinterpret_cast<const float4*>(py + 4);
    const float fxs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float fys[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
    const float row = __fmul_rn((float)y, inv_h);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float col = __fmul_rn((float)(x8 * 8 + i), inv_w);
      byte |= (unsigned)inside(sample(fxs[i], aw, col), sample(fys[i], ah, row), d)
              << (7 - i);
    }
  }
  const size_t bk = (size_t)blockIdx.z * K + blockIdx.y;
  out[bk * H * W8 + t] = (uint8_t)byte;
}

}  // namespace

extern "C" int omt_assemble_masks_packed(const float* field, const float* boxes,
                                         const int* anchor_idx, const float* table,
                                         const uint8_t* valid, uint8_t* out, int B, int A,
                                         int H, int W, int K, float thresh, float inv_w,
                                         float inv_h, int row0, void* stream) {
  const size_t smem = (size_t)K * 2 * (sizeof(float4) + sizeof(int));
  if (A > kMaxAnchors || B > 65535 || W % 8 || smem > kMaxDynamicSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int bytes = H * (W / 8);
  const dim3 grid((bytes + kBytes - 1) / kBytes, B);
  mask_kernel<<<grid, dim3(kBytes, kSlices), smem, (cudaStream_t)stream>>>(
      field, boxes, anchor_idx, table, valid, out, A, H, W, K, thresh, inv_w, inv_h, row0);
  return (int)cudaGetLastError();
}

// The per-detection kernels: grid (pixel runs, K, B).
static cudaError_t per_detection_grid(int units, int B, int K, dim3* grid) {
  if (K > 65535 || B > 65535) return cudaErrorInvalidValue;
  *grid = dim3((units + kDetThreads - 1) / kDetThreads, K, B);
  return cudaSuccess;
}

extern "C" int omt_assemble_masks(const float* field, const float* boxes,
                                  const float* anchor_wh, const int* anchor_idx,
                                  uint8_t* out, int B, int A, int H, int W, int K,
                                  float thresh, float inv_w, float inv_h, void* stream) {
  dim3 grid;
  if (W % 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = per_detection_grid(H * (W / 4), B, K, &grid);
  if (err != cudaSuccess) return (int)err;
  unpacked_kernel<<<grid, kDetThreads, 0, (cudaStream_t)stream>>>(
      field, boxes, anchor_wh, anchor_idx, out, A, H, W, K, thresh, inv_w, inv_h);
  return (int)cudaGetLastError();
}

extern "C" int omt_assemble_masks_bitpacked(const float* field, const float* boxes,
                                            const float* anchor_wh, const int* anchor_idx,
                                            uint8_t* out, int B, int A, int H, int W,
                                            int K, float thresh, float inv_w, float inv_h,
                                            void* stream) {
  dim3 grid;
  if (W % 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = per_detection_grid(H * (W / 8), B, K, &grid);
  if (err != cudaSuccess) return (int)err;
  bitpacked_kernel<<<grid, kDetThreads, 0, (cudaStream_t)stream>>>(
      field, boxes, anchor_wh, anchor_idx, out, A, H, W, K, thresh, inv_w, inv_h);
  return (int)cudaGetLastError();
}

extern "C" const char* omt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
