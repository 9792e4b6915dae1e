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
// the columns' pass r = (b - a) * fx + a and the rows' v = (r1 - r0) * fy +
// r0, each a single-rounded fused multiply-add with the difference rounded
// first (__fsub_rn, __fmaf_rn), then rint (ties to even, as np.round).  fx
// and fy come from double on the host, rounded to float once.  On 0/1 inputs
// r is one of 0, 1, fx and 1 - fx, so a column's r0 and r1 - r0 take at most
// 16 values, one per (a, b, c, d): a table per column, built once a block
// with that arithmetic.  A pixel then costs one fused multiply-add,
// v = (r1 - r0) * fy + r0, and rint(v) != 0 is v > 0.5 (v lies in [0, 1]:
// rint(0.5) is 0).
//
// What bounds it: bytes, or on masks whose pixels mostly differ from their
// neighbours the pixels' arithmetic.  It reads the valid detections' packed
// masks (n * H * W/8 bytes; the tables are a few kB) and writes n * ow *
// ceil(oh/32) * 4 bytes: 3.70 + 3.84 MB for 100 masks of 544² to 480x640,
// 2.25 us at 3.35 TB/s.  The function needs a pass's subtraction and FMA
// only where its fraction is non-zero and its two values differ, and a rint
// where any pass ran; an identity resize needs none.  The first kernel
// (probe/designs/recover_pixels.cu) spent about 25 instructions and seven
// loads from device memory on every pixel, the identity included, and ran
// at 400-450 G pixels/s whatever the input.
//
// Design.  Every source bit is read from shared memory, staged once a block:
// * identity images (every fraction 0, every first index i -> i; flagged per
//   image on the host; the eval loop's 544² scenes): a block per detection
//   copies the mask's rows with one cp.async.bulk (an mbarrier counts the
//   bytes), its warps turn each 32x32 tile with a __shfl_xor_sync transpose
//   (five rounds) into column words, and the detection's words leave as one
//   contiguous run.  Bytes-bound.
// * other images: a block owns one detection and a band of 32 * S output
//   columns (S sub-bands of 32, a lane a column); it stages the 4-byte words
//   that hold the band's source columns in rows ylo..yhi as 16-byte chunks
//   with cp.async, then turns them into 64-bit windows, LSB first: entry
//   (row, k) = words k and k + 1.  Its 8 warps take the 32-row tiles.  Each
//   tile first checks its source rectangle (its rows' source rows, its
//   lanes' source columns) with word masks: where every bit is 0 or every
//   bit is 1 each output bit equals it (every pass is (x - x) * f + x = x)
//   and the tile is written with no arithmetic.  Otherwise a lane walks the
//   tile's 32 rows: the row's record (its top and bottom rows' windows, fy),
//   a window of each row at its column's word, two funnel shifts that put
//   its four source bits at bits 8-11 of an address into its column's
//   table, one table load, one fused multiply-add with fy, one compare.
//   Rows and columns with a zero fraction need no other path: their table
//   entries and the fused multiply-add with fy = 0 give the copy exactly.
//   The band's words collect in shared memory (over the staged chunks) and
//   leave as one contiguous run.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps a block
// ints per image: n, oh, ow, words a column, column, row and word offsets,
// flags, first band, first staged row, staged rows, 0
constexpr int kGeom = 12;
constexpr int kIdentity = 1;  // every fraction 0 and every first index i -> i
constexpr int kTable = 4096;  // bytes of a sub-band's tables: 16 entries x 32 columns x 8

struct Layout {
  int columns, recs, windows, raw, raw_stride, out, bar, total;  // byte offsets; tables at 0
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Shared memory of a block.  Other images: the S tables (at 0, so that bits
// 8-11 of an entry's address are its index), each column's source bit, a
// record a row (32 * wpc), the windows (rows x kw entries of 8 bytes), then the staged chunks (a row's
// kw + 1 words at any 4-byte offset into its first chunk), whose room the
// band's output words take once the windows are built.  Identity images:
// the mask's rows, its output words and the mbarrier.  The launch takes the
// larger.
__host__ __device__ inline Layout layout(int sub, int kw_max, int rows_max, int wpc_max,
                                         int identity_H, int Wb, int W) {
  Layout l;
  l.columns = sub * kTable;
  l.recs = l.columns + 32 * sub * 4;
  l.windows = l.recs + 32 * wpc_max * 16;
  l.raw = align16(l.windows + rows_max * kw_max * 8);
  l.raw_stride = align16(12 + 4 * (kw_max + 1));
  const int raw_bytes = rows_max * l.raw_stride, out_bytes = 32 * sub * wpc_max * 4;
  l.out = l.raw;
  l.total = l.raw + (raw_bytes > out_bytes ? raw_bytes : out_bytes);
  // identity: the mask at 0, its words, the barrier
  const int id_out = align16(identity_H * Wb), id_bar = id_out + W * ((identity_H + 31) / 32) * 4;
  l.bar = (id_bar + 7) & ~7;
  if (identity_H && l.bar + 8 > l.total) l.total = l.bar + 8;
  return l;
}

__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Stage rows [y0, y0 + rows) of a mask (Wb bytes a row, 16-byte aligned):
// the 16-byte chunks that hold words [w0, w0 + words) of each row (clipped
// to the row) go to raw + r * rs with cp.async.
__device__ void stage(const uint8_t* mask, int Wb, int y0, int rows, int w0, int words,
                      uint8_t* raw, int rs) {
  const int lo = max(w0, 0), hi = min(w0 + words, Wb >> 2);
  if (hi <= lo) return;
  const int chunks = (12 + 4 * (hi - lo) + 15) >> 4;
  for (int q = threadIdx.x; q < rows * chunks; q += blockDim.x) {
    const int r = q / chunks, c = q - r * chunks, row = (y0 + r) * Wb;
    const int start = ((row + 4 * lo) & ~15) + 16 * c;
    if (start < row + 4 * hi) cp_async16(raw + r * rs + 16 * c, mask + start);
  }
}

// Word w0 + k of staged row r, LSB first (bit i = pixel 32 (w0 + k) + i);
// 0 outside the row.
__device__ __forceinline__ uint32_t staged_word(const uint8_t* raw, int rs, int Wb, int y0,
                                                int r, int w0, int k) {
  const int g = w0 + k, lo = max(w0, 0);
  if (g < 0 || g >= (Wb >> 2)) return 0u;
  const int first = (y0 + r) * Wb + 4 * lo;
  const uint32_t w = *(const uint32_t*)(raw + r * rs + (first & 15) + 4 * (g - lo));
  return __byte_perm(__brev(w), 0, 0x0123);  // MSB-first bytes -> LSB-first bits
}

// Lane i's word (bit j = element (i, j)) -> lane j's word (bit i = element (i, j)).
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int m = 16; m; m >>= 1) {
    const uint32_t low = m == 16 ? 0x0000FFFFu : m == 8 ? 0x00FF00FFu : m == 4 ? 0x0F0F0F0Fu
                       : m == 2 ? 0x33333333u : 0x55555555u;
    const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, m);
    x = (lane & m) ? (x & ~low) | ((y >> m) & low) : (x & low) | ((y & low) << m);
  }
  return x;
}

__device__ __forceinline__ float column_pass(int a, int b, float fx) {
  return __fmaf_rn(__fsub_rn((float)b, (float)a), fx, (float)a);
}

__device__ __forceinline__ void bulk_load(uint8_t* dst, const uint8_t* src, unsigned bytes,
                                          uint64_t* bar) {
  const unsigned b = (unsigned)__cvta_generic_to_shared(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(bytes), "r"(b)
        : "memory");
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b) : "memory");
}

// Identity images: a block a detection.
__device__ void transpose_mask(const uint8_t* mask, int oh, int ow, int wpc, int Wb,
                               uint32_t* out, const Layout& lay) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* words = (uint32_t*)(smem + align16(oh * Wb));
  bulk_load(smem, mask, align16(oh * Wb), (uint64_t*)(smem + lay.bar));
  const int groups = (ow + 31) >> 5;
  for (int q = warp; q < groups * wpc; q += kWarps) {
    const int k = q % groups, t = q / groups, row = 32 * t + lane;
    const uint32_t w = row < oh ? *(const uint32_t*)(smem + row * Wb + 4 * k) : 0u;
    const uint32_t col = transpose32(__byte_perm(__brev(w), 0, 0x0123), lane);
    if (32 * k + lane < ow) words[(32 * k + lane) * wpc + t] = col;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < ow * wpc; q += blockDim.x) out[q] = words[q];
}

template <int S>
__global__ void __launch_bounds__(32 * kWarps)
recover_kernel(const uint8_t* __restrict__ packed, const int* __restrict__ geom,
               const int* __restrict__ bands, const int* __restrict__ xtab,
               const float* __restrict__ xfrac, const int* __restrict__ ytab,
               const float* __restrict__ yfrac, uint32_t* __restrict__ out, int K, int H,
               int Wb, int kw_max, int rows_max, int wpc_max, int identity_H) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int* g = geom + kGeom * blockIdx.y;
  const int n = g[0], oh = g[1], ow = g[2], wpc = g[3], xoff = g[4], yoff = g[5];
  const int flags = g[7];
  const Layout lay = layout(S, kw_max, rows_max, wpc_max, identity_H, Wb, 8 * Wb);
  if (flags & kIdentity) {
    if ((int)blockIdx.x >= n) return;  // the whole block
    const int det = blockIdx.x;
    transpose_mask(packed + ((size_t)blockIdx.y * K + det) * H * Wb, oh, ow, wpc, Wb,
                   out + g[6] + (size_t)det * ow * wpc, lay);
    return;
  }
  const int nb = (ow + 32 * S - 1) / (32 * S);
  if ((int)blockIdx.x >= n * nb) return;  // the whole block
  const int det = blockIdx.x / nb, band = blockIdx.x - det * nb;
  const int c0 = 32 * S * band, ncols = min(32 * S, ow - c0);
  const uint8_t* mask = packed + ((size_t)blockIdx.y * K + det) * H * Wb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g0 = bands[2 * (g[8] + band)], kw = bands[2 * (g[8] + band) + 1];
  const int ylo = g[9], rows = g[10];
  uint8_t* raw = smem + lay.raw;
  stage(mask, Wb, ylo, rows, g0, kw + 1, raw, lay.raw_stride);

  // while the chunks arrive: a thread a column builds its table (entry idx:
  // bits p, p + 1 of the top row, then of the bottom row, p = min(x0, x1);
  // a is bit p unless x0 is the larger, under a horizontal flip) and keeps
  // u, the bit of pixel p in the staged rows
  float2* table = (float2*)smem;
  int* columns = (int*)(smem + lay.columns);
  if (threadIdx.x < 32 * S) {
    const int cs = threadIdx.x, c = c0 + cs;
    float2* column = table + (cs >> 5) * (kTable / 8) + (cs & 31);
    int u = 10;  // a column past ow reads the first windows; its bits are dropped
    if (c < ow) {
      const int2 x = *(const int2*)(xtab + 2 * (xoff + c));
      const float fx = xfrac[xoff + c];
      const int p = min(x.x, x.y);
      u = p - 32 * g0;
#pragma unroll
      for (int idx = 0; idx < 16; ++idx) {
        const int tl = idx & 1, th = (idx >> 1) & 1, bl = (idx >> 2) & 1, bh = idx >> 3;
        const float r0 = column_pass(x.x == p ? tl : th, x.y == p ? tl : th, fx);
        const float r1 = column_pass(x.x == p ? bl : bh, x.y == p ? bl : bh, fx);
        column[idx * 32] = make_float2(r0, __fsub_rn(r1, r0));
      }
    }
    columns[cs] = u;
  }
  // a row's record: its top and bottom rows' windows, fy, the two rows
  int4* recs = (int4*)(smem + lay.recs);
#pragma unroll 4
  for (int i = threadIdx.x; i < 32 * wpc; i += blockDim.x) {
    int4 rec = make_int4(lay.windows, lay.windows, 0, 0);
    if (i < oh) {
      const int y0 = ytab[2 * (yoff + i)] - ylo, y1 = ytab[2 * (yoff + i) + 1] - ylo;
      rec = make_int4(lay.windows + y0 * kw * 8, lay.windows + y1 * kw * 8,
                      __float_as_int(yfrac[yoff + i]), y0 | (y1 << 16));
    }
    recs[i] = rec;
  }
  cp_async_wait_all();
  __syncthreads();
  // windows: entry (r, k) = words k, k + 1 of staged row r
  uint2* windows = (uint2*)(smem + lay.windows);
  const unsigned magic = 0xFFFFFFFFu / kw + 1;  // q / kw = umulhi(q, magic): q * kw < 2^32
  for (int q = threadIdx.x; q < rows * kw; q += blockDim.x) {
    const int r = __umulhi(q, magic), k = q - r * kw;
    windows[q] = make_uint2(staged_word(raw, lay.raw_stride, Wb, ylo, r, g0, k),
                            staged_word(raw, lay.raw_stride, Wb, ylo, r, g0, k + 1));
  }
  __syncthreads();

  uint32_t* words = (uint32_t*)(smem + lay.out);  // over the staged chunks
  const int s = warp % S, cs = 32 * s + lane;
  const bool valid = cs < ncols;
  const int u = columns[cs];
  // pixel u at bit 8 of the top row's shifted window, at bit 10 of the bottom's
  const int top_off = ((u - 8) >> 5) * 8, top_shift = (u - 8) & 31;
  const int bottom_off = ((u - 10) >> 5) * 8, bottom_shift = (u - 10) & 31;
  const int tab = s * kTable + lane * 8;
  // the sub-band's source columns, as bit positions in the staged rows
  const int blo = __reduce_min_sync(0xFFFFFFFFu, valid ? u : INT_MAX);
  const int bhi = __reduce_max_sync(0xFFFFFFFFu, valid ? u + 1 : INT_MIN);
  for (int t = warp / S; blo != INT_MAX && t < wpc; t += kWarps / S) {
    const int4* rec = recs + 32 * t;
    // the tile's source rows
    int ya = INT_MAX, yb = INT_MIN;
    if (32 * t + lane < oh) {
      const int rr = rec[lane].w;
      ya = min(rr & 0xFFFF, rr >> 16);
      yb = max(rr & 0xFFFF, rr >> 16);
    }
    const int rlo = __reduce_min_sync(0xFFFFFFFFu, ya), rhi = __reduce_max_sync(0xFFFFFFFFu, yb);
    bool zero = true, one = true;
    for (int r = rlo + lane; r <= rhi; r += 32) {
      const uint2* row = windows + r * kw;
      for (int k = blo >> 5; k <= bhi >> 5; ++k) {
        const uint32_t w = row[k].x;
        const int lo = max(blo - 32 * k, 0), hi = min(bhi - 32 * k, 31);
        const uint32_t m = (0xFFFFFFFFu >> (31 - hi + lo)) << lo;
        zero = zero && !(w & m);
        one = one && (w & m) == m;
      }
    }
    zero = __all_sync(0xFFFFFFFFu, zero);
    one = __all_sync(0xFFFFFFFFu, one);
    const int nr = min(32, oh - 32 * t);
    const uint32_t rowmask = nr == 32 ? 0xFFFFFFFFu : (1u << nr) - 1u;
    uint32_t word = one ? rowmask : 0u;
    if (!zero && !one) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int4 rr = rec[i];
        const uint2 wt = *(const uint2*)(smem + rr.x + top_off);
        const uint2 wb = *(const uint2*)(smem + rr.y + bottom_off);
        const uint32_t top = __funnelshift_r(wt.x, wt.y, top_shift);
        const uint32_t bottom = __funnelshift_r(wb.x, wb.y, bottom_shift);
        const float2 e = *(const float2*)(smem + ((top & 0x300u) | (bottom & 0xC00u) | tab));
        word |= (uint32_t)(__fmaf_rn(e.y, __int_as_float(rr.z), e.x) > 0.5f) << i;
      }
      word &= rowmask;
    }
    if (valid) words[cs * wpc + t] = word;
  }
  __syncthreads();
  uint32_t* dst = out + g[6] + ((size_t)det * ow + c0) * wpc;
  for (int q = threadIdx.x; q < ncols * wpc; q += blockDim.x) dst[q] = words[q];
}

// Let recover_kernel<S> take `bytes` of dynamic shared memory, with the
// SM's unified memory split all for shared memory, so that as many blocks
// fit as their shared memory allows.
template <int S>
int allow(int bytes) {
  static int granted = -1;
  if (bytes <= granted) return 0;
  cudaError_t err = cudaFuncSetAttribute(recover_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(recover_kernel<S>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  granted = bytes;
  return 0;
}

template <int S>
int occupancy(int bytes, int* blocks) {
  const int err = allow<S>(bytes);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, recover_kernel<S>,
                                                            32 * kWarps, bytes);
}

template <int S>
int launch(const uint8_t* packed, const int* geom, const int* bands, const int* xtab,
           const float* xfrac, const int* ytab, const float* yfrac, uint32_t* out, int B,
           int K, int H, int Wb, int max_tasks, int kw_max, int rows_max, int wpc_max,
           int identity_H, cudaStream_t stream) {
  const int bytes = layout(S, kw_max, rows_max, wpc_max, identity_H, Wb, 8 * Wb).total;
  const int err = allow<S>(bytes);
  if (err) return err;
  recover_kernel<S><<<dim3(max_tasks, B), 32 * kWarps, bytes, stream>>>(
      packed, geom, bands, xtab, xfrac, ytab, yfrac, out, K, H, Wb, kw_max, rows_max, wpc_max,
      identity_H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int omt_recover_masks(const uint8_t* packed, const int* geom, const int* bands,
                                 const int* xtab, const float* xfrac, const int* ytab,
                                 const float* yfrac, uint32_t* out, int B, int K, int H, int Wb,
                                 int band, int max_tasks, int kw_max, int rows_max, int wpc_max,
                                 int identity_H, void* stream) {
  if (B < 1 || B > 65535 || max_tasks < 1 || (Wb & 3) || ((long long)H * Wb) % 16 ||
      ((uintptr_t)packed & 15) || rows_max >= 65536 || identity_H > H)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (band) {
    case 32:
      return launch<1>(packed, geom, bands, xtab, xfrac, ytab, yfrac, out, B, K, H, Wb,
                       max_tasks, kw_max, rows_max, wpc_max, identity_H, st);
    case 64:
      return launch<2>(packed, geom, bands, xtab, xfrac, ytab, yfrac, out, B, K, H, Wb,
                       max_tasks, kw_max, rows_max, wpc_max, identity_H, st);
    case 128:
      return launch<4>(packed, geom, bands, xtab, xfrac, ytab, yfrac, out, B, K, H, Wb,
                       max_tasks, kw_max, rows_max, wpc_max, identity_H, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The dynamic shared memory of a launch with these sizes and the blocks an
// SM holds at once (the diagnostics of chip_smoke.py's phase 16).
extern "C" int omt_recover_occupancy(int band, int kw_max, int rows_max, int wpc_max,
                                     int identity_H, int Wb, int* bytes, int* blocks) {
  const int sub = band / 32;
  if (sub != 1 && sub != 2 && sub != 4) return (int)cudaErrorInvalidValue;
  *bytes = layout(sub, kw_max, rows_max, wpc_max, identity_H, Wb, 8 * Wb).total;
  return sub == 1 ? occupancy<1>(*bytes, blocks)
                  : sub == 2 ? occupancy<2>(*bytes, blocks) : occupancy<4>(*bytes, blocks);
}

extern "C" const char* omt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
