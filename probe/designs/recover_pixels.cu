// Mask recovery for sm_90a (kernel 6).
//
// Replaces orienmask_tpu/eval/coco_eval.py::_recover_shape_segm (cv2 on the
// host; no Pallas kernel): each image's masks at network resolution, packed
// (B, K, H, W/8) uint8 MSB first as the postprocess leaves them on the card,
// go back to the original image: the crop of the collate padding, the flips
// and the crop of the letterbox padding (composed on the host into source
// row and column tables), OpenCV's INTER_LINEAR resize, np.round.  Output:
// per image (n, ow, ceil(oh / 32)) uint32 words of column-major bits, bit i
// of word w of column c = pixel (32 w + i, c), rows past oh 0; the images'
// words concatenated at the offsets of the geometry rows.
//
// Arithmetic, as cv2 on float32 masks (ops/resize.py holds the plain version
// to it): per output pixel four source bits a, b (row y0) and c, d (row y1);
// the columns' pass (b - a) * fx + a and the rows' (r1 - r0) * fy + r0, each
// a single-rounded fused multiply-add with the difference rounded first
// (__fsub_rn, __fmaf_rn: no contraction left to nvcc), then rintf (ties to
// even, as np.round).  fx and fy come from double on the host, rounded to
// float once, and the source indices come with them.
//
// What bounds it: bytes, or on masks whose pixels mostly differ from their
// neighbours the arithmetic.  It reads the valid detections' packed masks
// (n * H * W/8 bytes; the tables are a few kB) and writes n * ow *
// ceil(oh/32) * 4 bytes: 3.70 + 3.84 MB for 100 masks of 544² to 480x640,
// 2.25 us at 3.35 TB/s.  The function needs a pass's subtraction and FMA
// only where its fraction is non-zero and its two values differ, and a rint
// where any pass ran: an identity resize needs none.  Design (simple first): a warp owns one (detection, group of 32
// output columns, word of 32 output rows); each lane one column, whose
// source columns and fraction it loads once, walks the word's 32 rows and
// sets one bit a row, then stores its word.  A row's table entries are the
// same for the whole warp (one broadcast load each) and the lanes' source
// bytes lie side by side in one source row, so each load touches one or
// two cache lines; the source mask (37 kB at 544²) stays in L1 and L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block, one (detection, 32 columns, 32 rows) each
constexpr int kGeom = 8;   // n, oh, ow, words a column, column, row, word offsets, 0

__device__ __forceinline__ float bit_at(const uint8_t* row, int byte, int shift) {
  return (float)((row[byte] >> shift) & 1);
}

__global__ void __launch_bounds__(32 * kWarps)
recover_kernel(const uint8_t* __restrict__ packed, const int* __restrict__ geom,
               const int* __restrict__ xtab, const float* __restrict__ xfrac,
               const int* __restrict__ ytab, const float* __restrict__ yfrac,
               uint32_t* __restrict__ out, int K, int H, int Wb) {
  const int b = blockIdx.y;
  const int* g = geom + kGeom * b;
  const int n = g[0], oh = g[1], ow = g[2], wpc = g[3];
  const int groups = (ow + 31) / 32;
  const long long task = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= (long long)n * groups * wpc) return;
  const int w = (int)(task % wpc);
  const long long rest = task / wpc;
  const int det = (int)(rest / groups);
  const int c = (int)(rest % groups) * 32 + (threadIdx.x & 31);
  if (c >= ow) return;  // no warp-wide operation follows
  const uint8_t* src = packed + ((size_t)b * K + det) * H * Wb;
  const int xc = g[4] + c;
  const int x0 = xtab[2 * xc], x1 = xtab[2 * xc + 1];
  const int byte0 = x0 >> 3, shift0 = 7 - (x0 & 7), byte1 = x1 >> 3, shift1 = 7 - (x1 & 7);
  const float fx = xfrac[xc];
  const int rows = min(32, oh - 32 * w);
  const int y = g[5] + 32 * w;
  uint32_t word = 0;
  for (int i = 0; i < rows; ++i) {
    const uint8_t* top = src + (size_t)ytab[2 * (y + i)] * Wb;
    const uint8_t* bottom = src + (size_t)ytab[2 * (y + i) + 1] * Wb;
    const float a = bit_at(top, byte0, shift0), bb = bit_at(top, byte1, shift1);
    const float cc = bit_at(bottom, byte0, shift0), d = bit_at(bottom, byte1, shift1);
    const float r0 = __fmaf_rn(__fsub_rn(bb, a), fx, a);
    const float r1 = __fmaf_rn(__fsub_rn(d, cc), fx, cc);
    const float v = __fmaf_rn(__fsub_rn(r1, r0), yfrac[y + i], r0);
    word |= (uint32_t)(rintf(v) != 0.f) << i;
  }
  out[g[6] + ((size_t)det * ow + c) * wpc + w] = word;
}

}  // namespace

extern "C" int omt_recover_masks(const uint8_t* packed, const int* geom, const int* xtab,
                                 const float* xfrac, const int* ytab, const float* yfrac,
                                 uint32_t* out, int B, int K, int H, int Wb, int max_tasks,
                                 void* stream) {
  if (B < 1 || B > 65535 || max_tasks < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((max_tasks + kWarps - 1) / kWarps, B);
  recover_kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(packed, geom, xtab, xfrac,
                                                                 ytab, yfrac, out, K, H, Wb);
  return (int)cudaGetLastError();
}

extern "C" const char* omt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
