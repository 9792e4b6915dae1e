// Orientation-mask assembly with MSB-first bit packing, for sm_90a.
//
// Replaces orienmask_tpu/ops/pallas_masks.py::assemble_masks_anchor_resident
// (kernel _mask_kernel_anchor).  For detection k of image b on anchor a,
// bit (k, y, x) is set when
//   |fx[a,y,x] * (aw_a * 0.5) + x * (1/W) - cx_k| < t * w_k   and
//   |fy[a,y,x] * (ah_a * 0.5) + (y + row0) * (1/coord_h) - cy_k| < t * h_k,
// and 8 columns pack into one byte, MSB first: out (B, K, H, W/8) uint8.
//
// What bounds it: at 544², K=100 it reads the field planes of the anchors
// that hold a detection (at most A=9: 21.3 MB) once and writes 3.7 MB of
// bytes, about 7.5 us at 3.35 TB/s when every anchor is used; with the
// detections on one or two anchors the per-detection work bounds it
// instead: 9 instructions per detection and pixel (subtracts, abs, compares,
// and, and the bit's shift and or), about 266 M, 8 us at the card's 32-bit
// issue rate.
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
// Exact arithmetic, as the TPU kernel evaluates it: every multiply and add
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
    const float* bx = boxes + ((size_t)b * K + k) * 4;
    det[k] = make_float4(bx[0], bx[1], __fmul_rn(thresh, bx[2]),
                         __fmul_rn(thresh, bx[3]));
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
      gx[j] = __fadd_rn(__fmul_rn(fxs[j], aw), cols[j]);
      gy[j] = __fadd_rn(__fmul_rn(fys[j], ah), row);
    }
    for (int j = j0 + slice; j < j1; j += kSlices) {
      const int k = order[j];
      const float4 d = det[k];
      unsigned byte = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool in = fabsf(__fsub_rn(gx[i], d.x)) < d.z &&
                        fabsf(__fsub_rn(gy[i], d.y)) < d.w;
        byte |= (unsigned)in << (7 - i);
      }
      o[(size_t)k * kstride] = (uint8_t)byte;
    }
  }
  // a detection on no anchor of the table gets an empty mask
  for (int j = start[A] + slice; j < start[A + 1]; j += kSlices) {
    o[(size_t)order[j] * kstride] = 0;
  }
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

extern "C" const char* omt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
