// Kernel 2 before tile culling, timed beside the shipped kernel by probe/designs.py.

// Orientation-mask assembly for sm_90a: three kernels over one predicate.
//
// For detection k of image b on anchor a, pixel (y, x) is inside its mask when
//   |fx[a,y,x] * (aw * 0.5) + x * (1/W) - cx_k| < t * w_k   and
//   |fy[a,y,x] * (ah * 0.5) + (y + row0) * (1/coord_h) - cy_k| < t * h_k.
//
// * mask_kernel replaces orienmask_tpu/ops/pallas_masks.py::
//   assemble_masks_anchor_resident (kernel _mask_kernel_anchor): (aw, ah) is
//   the row a of a per-anchor table, and 8 columns pack into one byte, MSB
//   first: out (B, K, H, W/8) uint8.
// * unpacked_kernel replaces pallas_masks.py::assemble_masks (_mask_kernel):
//   (aw, ah) is the detection's own anchor size, out (B, K, H, W) uint8 in
//   {0, 1}, row0 = 0.
// * bitpacked_kernel replaces pallas_masks.py::assemble_masks_bitpacked
//   (_mask_kernel_bitpack): the same per-detection inputs as unpacked_kernel,
//   packed MSB first with shifts and ors: out (B, K, H, W/8) uint8.
//
// mask_kernel.  What bounds it: at 544², K=100 it reads the field planes of
// the anchors that hold a detection (at most A=9: 21.3 MB) once and writes
// 3.7 MB of bytes, about 7.5 us at 3.35 TB/s when every anchor is used; with
// the detections on one or two anchors the per-detection work bounds it
// instead: 6 instructions per detection and pixel in its SASS (2 subtracts,
// 2 compares with the abs as an operand modifier and the second chained on
// the first, and the bit's select and or), about 178 M, 5.3 us at the
// card's 32-bit instruction rate.
// Design: kSlices threads per output byte (y, 8 columns), each taking every
// kSlices-th detection, so that enough warps are in flight at batch 1.
// Each block first groups the image's detections by anchor in shared
// memory.  A thread then loops over the anchors that hold a detection; for
// each it loads its byte's 2x8 field values (four float4 loads, shared by
// the slices through L1) and forms the 8 sample positions, then loops over
// its share of that anchor's detections and writes one byte per detection.
// The field of a used anchor is read from memory once, an unused anchor's
// not at all, and every output byte is written once; a warp reads 1 KB of
// contiguous field per plane and writes 32 contiguous bytes per detection.
// One launch covers the whole batch.
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
#include <stdint.h>

namespace {

constexpr int kBytes = 64;   // output bytes per block
constexpr int kSlices = 4;   // threads per output byte
constexpr int kThreads = kBytes * kSlices;
constexpr int kMaxAnchors = 64;
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

__global__ void __launch_bounds__(kThreads)
mask_kernel(const float* __restrict__ field, const float* __restrict__ boxes,
            const int* __restrict__ anchor_idx, const float* __restrict__ table,
            uint8_t* __restrict__ out, int A, int H, int W, int K, float thresh,
            float inv_w, float inv_h, int row0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* det = reinterpret_cast<float4*>(smem_raw);  // (cx, cy, t*w, t*h)
  int* order = reinterpret_cast<int*>(det + K);       // detections by anchor
  // start[a]..start[a+1]: the detections of anchor a in `order`; slot A
  // collects those on no anchor of the table
  __shared__ int start[kMaxAnchors + 2];
  __shared__ int cursor[kMaxAnchors + 1];

  const int b = blockIdx.y;
  const int tid = threadIdx.y * kBytes + threadIdx.x;
  const int* aidx = anchor_idx + (size_t)b * K;
  for (int a = tid; a <= A; a += kThreads) cursor[a] = 0;
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) {
    det[k] = load_det(boxes + ((size_t)b * K + k) * 4, thresh);
    const int a = aidx[k];
    atomicAdd(&cursor[(a >= 0 && a < A) ? a : A], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int a = 0; a <= A; ++a) {
      start[a] = s;
      s += cursor[a];
      cursor[a] = start[a];
    }
    start[A + 1] = s;
  }
  __syncthreads();
  for (int k = tid; k < K; k += kThreads) {
    const int a = aidx[k];
    order[atomicAdd(&cursor[(a >= 0 && a < A) ? a : A], 1)] = k;
  }
  __syncthreads();

  const int W8 = W >> 3;
  const int t = blockIdx.x * kBytes + threadIdx.x;
  const int slice = threadIdx.y;
  if (t >= H * W8) return;
  const int y = t / W8, x8 = t - y * W8;
  const size_t plane = (size_t)H * W;
  const size_t kstride = (size_t)H * W8;

  float cols[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cols[j] = __fmul_rn((float)(x8 * 8 + j), inv_w);
  const float row = __fmul_rn((float)(y + row0), inv_h);
  uint8_t* o = out + (size_t)b * K * kstride + (size_t)y * W8 + x8;

  for (int a = 0; a < A; ++a) {
    const int j0 = start[a], j1 = start[a + 1];
    if (j0 == j1) continue;
    const float* fx = field + ((size_t)b * A + a) * 2 * plane + (size_t)y * W + x8 * 8;
    const float* fy = fx + plane;
    const float4 fx0 = *reinterpret_cast<const float4*>(fx);
    const float4 fx1 = *reinterpret_cast<const float4*>(fx + 4);
    const float4 fy0 = *reinterpret_cast<const float4*>(fy);
    const float4 fy1 = *reinterpret_cast<const float4*>(fy + 4);
    const float fxs[8] = {fx0.x, fx0.y, fx0.z, fx0.w, fx1.x, fx1.y, fx1.z, fx1.w};
    const float fys[8] = {fy0.x, fy0.y, fy0.z, fy0.w, fy1.x, fy1.y, fy1.z, fy1.w};
    const float aw = __fmul_rn(table[2 * a], 0.5f);
    const float ah = __fmul_rn(table[2 * a + 1], 0.5f);
    float gx[8], gy[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      gx[j] = sample(fxs[j], aw, cols[j]);
      gy[j] = sample(fys[j], ah, row);
    }
    for (int j = j0 + slice; j < j1; j += kSlices) {
      const int k = order[j];
      const float4 d = det[k];
      unsigned byte = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        byte |= (unsigned)inside(gx[i], gy[i], d) << (7 - i);
      }
      o[(size_t)k * kstride] = (uint8_t)byte;
    }
  }
  // a detection on no anchor of the table gets an empty mask
  for (int j = start[A] + slice; j < start[A + 1]; j += kSlices) {
    o[(size_t)order[j] * kstride] = 0;
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
                                         uint8_t* out, int B, int A, int H, int W,
                                         int K, float thresh, float inv_w,
                                         float inv_h, int row0, void* stream) {
  if (A > kMaxAnchors) return (int)cudaErrorInvalidValue;
  const int bytes_per_image = H * (W / 8);
  const dim3 grid((bytes_per_image + kBytes - 1) / kBytes, B);
  const size_t smem = (size_t)K * (sizeof(float4) + sizeof(int));
  mask_kernel<<<grid, dim3(kBytes, kSlices), smem, (cudaStream_t)stream>>>(
      field, boxes, anchor_idx, table, out, A, H, W, K, thresh, inv_w, inv_h, row0);
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
