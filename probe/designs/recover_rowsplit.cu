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
//   bytes), its warps turn 32x32 tiles into column words with a
//   __shfl_xor_sync transpose (five rounds), and the detection's words leave
//   as one contiguous run.  Bytes-bound.
// * other images: a block owns one detection and a band of 64 output
//   columns and 8 row tiles (256 output rows: two tasks a warp).  It stages
//   the 4-byte words that hold the band's source columns in the rows its
//   output rows read (the host's table of each image's parts) as 16-byte
//   chunks with cp.async and builds each column's table.  The band splits into sub-bands of cps
//   columns (32, or fewer where the image is shrunk: the host picks the
//   largest power of two whose sub-bands span at most 32 source columns);
//   a warp takes a (sub-band, 32-row tile).  A lane owns an output row: it
//   loads 64-bit windows of its top and bottom source rows over the
//   sub-band's source columns once (six word loads, turned LSB first),
//   checks with word masks
//   whether the bits its row reads are all 0 or all 1 (if every lane's are,
//   each output bit equals them: every pass is (x - x) * f + x = x, and the
//   tile is written with no arithmetic), and otherwise walks the sub-band's
//   columns, all 32 with no branch so that their loads overlap: two funnel
//   shifts by the column's offset (a byte of eight registers, the same in
//   every lane) put its four source bits at bits 3-6 of an address into the
//   column's table, one table load (the lanes read one column's 128 bytes:
//   one wavefront), one fused multiply-add with its fy, one compare.  The row words then go through the same transpose into
//   column words.  Rows and columns with a zero fraction need no other
//   path: their table entries and the fused multiply-add with fy = 0 give
//   the copy exactly.  The band's words collect in shared memory and leave
//   as one contiguous run.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;    // warps a block
constexpr int kBand = 64;    // output columns a block (images that are not identities)
constexpr int kPartTiles = 8;  // 32-row tiles a block (the same)
constexpr int kEntry = 128;  // bytes of a column's table: 16 entries of (r0, r1 - r0)
// ints per image: n, oh, ow, words a column, column, row and word offsets,
// flags, first band, first part, columns a sub-band, 0
constexpr int kGeom = 12;
constexpr int kIdentity = 1;  // every fraction 0 and every first index i -> i

struct Layout {
  int columns, recs, raw, raw_stride, out, bar, total;  // byte offsets; tables at 0
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Shared memory of a block.  Other images: the band's tables (at 0; room for
// 32 more, which the column slots past a narrow sub-band read and drop),
// each column's source bit, a record a row of the part, the staged chunks
// (a row's kw words at any 4-byte offset into its first chunk) and the
// block's output words.  Identity images: the mask's rows, its output words and the
// mbarrier.  The launch takes the larger.
__host__ __device__ inline Layout layout(int kw_max, int rows_max, int identity_H, int Wb,
                                         int W) {
  Layout l;
  l.columns = (kBand + 32) * kEntry;
  l.recs = l.columns + kBand * 4;
  l.raw = align16(l.recs + 32 * kPartTiles * 8);
  l.raw_stride = align16(12 + 4 * kw_max);
  l.out = l.raw + rows_max * l.raw_stride;
  l.total = l.out + kBand * kPartTiles * 4;
  // identity: the mask at 0, its words, the barrier
  const int id_bar = align16(identity_H * Wb) + W * ((identity_H + 31) / 32) * 4;
  l.bar = (id_bar + 7) & ~7;
  if (identity_H && l.bar + 8 > l.total) l.total = l.bar + 8;
  return l;
}

__device__ __forceinline__ void cp_async16(uint8_t* dst, const uint8_t* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
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

// MSB-first bytes -> LSB-first bits (bit i = pixel i of the word).
__device__ __forceinline__ uint32_t lsb_first(uint32_t w) {
  return __byte_perm(__brev(w), 0, 0x0123);
}

// One round of the 32x32 transpose: lanes lane and lane ^ m swap the bits
// whose position and lane differ in bit m.
__device__ __forceinline__ uint32_t transpose_round(uint32_t x, int lane, int m) {
  const uint32_t low = m == 16 ? 0x0000FFFFu : m == 8 ? 0x00FF00FFu : m == 4 ? 0x0F0F0F0Fu
                     : m == 2 ? 0x33333333u : 0x55555555u;
  const uint32_t y = __shfl_xor_sync(0xFFFFFFFFu, x, m);
  return (lane & m) ? (x & ~low) | ((y >> m) & low) : (x & low) | ((y & low) << m);
}

// Lane i's word (bit j = element (i, j)) -> lane j's word (bit i = element (i, j)).
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
#pragma unroll
  for (int m = 16; m; m >>= 1) x = transpose_round(x, lane, m);
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
  const int groups = (ow + 31) >> 5, tiles = groups * wpc;
  for (int q = warp; q < tiles; q += kWarps) {
    const int k = q % groups, t = q / groups, row = 32 * t + lane;
    const uint32_t w = row < oh ? lsb_first(*(const uint32_t*)(smem + row * Wb + 4 * k)) : 0u;
    const uint32_t col = transpose32(w, lane);
    if (32 * k + lane < ow) words[(32 * k + lane) * wpc + t] = col;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < ow * wpc; q += blockDim.x) out[q] = words[q];
}

// Tables of the band from output column c0 (four threads a column; entry
// idx: bits p, p + 1 of the top row, then of the bottom row, p = min(x0,
// x1); a is bit p unless x0 is the larger, under a horizontal flip) and each
// column's u, the bit of pixel p in the band's staged rows.
__device__ void build_tables(const int* __restrict__ xtab, const float* __restrict__ xfrac,
                             int xoff, int c0, int ow, int g0, int* columns) {
  extern __shared__ __align__(16) uint8_t smem[];
  for (int q = threadIdx.x; q < 4 * kBand; q += blockDim.x) {
    const int cs = q >> 2, c = c0 + cs, quarter = q & 3;
    int u = INT_MAX;  // past ow
    if (c < ow) {
      const int2 x = *(const int2*)(xtab + 2 * (xoff + c));
      const float fx = xfrac[xoff + c];
      const int p = min(x.x, x.y);
      float2* table = (float2*)(smem + cs * kEntry);
#pragma unroll
      for (int idx = 4 * quarter; idx < 4 * quarter + 4; ++idx) {
        const int tl = idx & 1, th = (idx >> 1) & 1, bl = (idx >> 2) & 1, bh = idx >> 3;
        const float r0 = column_pass(x.x == p ? tl : th, x.y == p ? tl : th, fx);
        const float r1 = column_pass(x.x == p ? bl : bh, x.y == p ? bl : bh, fx);
        table[idx] = make_float2(r0, __fsub_rn(r1, r0));
      }
      u = p - 32 * g0;
    }
    if (!quarter) columns[cs] = u;
  }
}

// Tiles first..last - 1 of one (detection, band) from its staged rows in
// raw: each warp takes (sub-band, 32-row tile) tasks; recs[i] is row
// 32 first + i's record; the words go to words[column * tiles + t - first].
__device__ void recover_band(const uint8_t* raw, int raw_stride, const int* columns,
                             const int2* recs, uint32_t* words, int oh, int first, int last,
                             int ncols, int cps, int ylo, int Wb, int g0, int kw) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lo = max(g0, 0), hi = min(g0 + kw, Wb >> 2);  // the staged words of a row
  const int subs = (ncols + cps - 1) / cps, tiles = last - first;
  for (int task = warp; task < subs * tiles; task += kWarps) {
    const int sub = task % subs, t = first + task / subs, cs = sub * cps + lane;
    // the sub-band: window bit 0 is staged bit umin - 3; column j's pixel p
    // lies at window bit amt_j + 3 (amt_j < 32: the host's cps)
    const bool column = lane < cps && cs < ncols;
    const int u = column ? columns[cs] : INT_MAX;
    const int umin = __reduce_min_sync(0xFFFFFFFFu, u), base = umin - 3;
    const unsigned amt = column ? u - umin : 0u;
    unsigned offsets[8];  // amt_j in byte j % 4 of offsets[j / 4], the same in every lane
#pragma unroll
    for (int r = 0; r < 8; ++r)
      offsets[r] = __reduce_or_sync(0xFFFFFFFFu, (lane >> 2) == r ? amt << (8 * (lane & 3)) : 0u);
    // the bits the sub-band reads: p, p + 1 of the top window, of the bottom at + 2
    const unsigned long long used = column ? 3ull << (amt + 3) : 0ull;
    const uint32_t top_lo = __reduce_or_sync(0xFFFFFFFFu, (uint32_t)used);
    const uint32_t top_hi = __reduce_or_sync(0xFFFFFFFFu, (uint32_t)(used >> 32));
    const uint32_t bottom_lo = top_lo << 2, bottom_hi = __funnelshift_l(top_lo, top_hi, 2);

    // this lane's row: 64-bit windows of its top and bottom source rows;
    // words outside the row (the same for every lane) read 0
    const int i = 32 * t + lane;
    const bool row = i < oh;
    const int2 rec = recs[i - 32 * first];
    const int w0 = g0 + (base >> 5), m = base & 31;
    const int r0 = rec.x & 0xFFFF, r1 = rec.x >> 16;
    const uint32_t* top = (const uint32_t*)(raw + r0 * raw_stride +
                                            (((ylo + r0) * Wb + 4 * lo) & 15)) + (w0 - lo);
    const uint32_t* bottom = (const uint32_t*)(raw + r1 * raw_stride +
                                               (((ylo + r1) * Wb + 4 * lo) & 15)) + (w0 - lo);
    uint32_t tw[3], bw[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bool staged = w0 + k >= lo && w0 + k < hi;
      tw[k] = staged ? lsb_first(top[k]) : 0u;
      bw[k] = staged ? lsb_first(bottom[k]) : 0u;
    }
    const uint32_t t0 = __funnelshift_r(tw[0], tw[1], m), t1 = __funnelshift_r(tw[1], tw[2], m);
    const uint32_t u0 = __funnelshift_r(bw[0], bw[1], m), u1 = __funnelshift_r(bw[1], bw[2], m);
    const uint32_t b0 = u0 << 2, b1 = __funnelshift_l(u0, u1, 2);
    const bool zero = !row || !((t0 & top_lo) | (t1 & top_hi) | (b0 & bottom_lo) | (b1 & bottom_hi));
    const bool one = !row || ((t0 & top_lo) == top_lo && (t1 & top_hi) == top_hi &&
                              (b0 & bottom_lo) == bottom_lo && (b1 & bottom_hi) == bottom_hi);
    const int nr = min(32, oh - 32 * t);
    const uint32_t rowmask = nr == 32 ? 0xFFFFFFFFu : (1u << nr) - 1u;
    uint32_t col;
    if (__all_sync(0xFFFFFFFFu, zero)) {
      col = 0u;
    } else if (__all_sync(0xFFFFFFFFu, one)) {
      col = rowmask;
    } else {
      const float fy = __int_as_float(rec.y);
      const int tab = sub * cps * kEntry;
      uint32_t bits = 0;
#pragma unroll
      for (int j = 0; j < 32; ++j) {  // slots past cps read another table; dropped below
        const unsigned s = __byte_perm(offsets[j >> 2], 0, 0x4440 | (j & 3));
        const uint32_t tb = __funnelshift_r(t0, t1, s), bb = __funnelshift_r(b0, b1, s);
        const float2 e = *(const float2*)(smem + (((tb & 0x18u) | tab) | (bb & 0x60u)) +
                                          j * kEntry);
        bits |= (uint32_t)(__fmaf_rn(e.y, fy, e.x) > 0.5f) << j;
      }
      col = transpose32(row ? bits : 0u, lane);
    }
    if (column) words[cs * tiles + t - first] = col;
  }
}

__global__ void __launch_bounds__(32 * kWarps)
recover_kernel(const uint8_t* __restrict__ packed, const int* __restrict__ geom,
               const int* __restrict__ bands, const int* __restrict__ parts,
               const int* __restrict__ xtab, const float* __restrict__ xfrac,
               const int* __restrict__ ytab, const float* __restrict__ yfrac,
               uint32_t* __restrict__ out, int K, int H, int Wb, int kw_max, int rows_max,
               int identity_H) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int* g = geom + kGeom * blockIdx.y;
  const int n = g[0], oh = g[1], ow = g[2], wpc = g[3], xoff = g[4], yoff = g[5];
  const Layout lay = layout(kw_max, rows_max, identity_H, Wb, 8 * Wb);
  const uint8_t* masks = packed + (size_t)blockIdx.y * K * H * Wb;
  if (g[7] & kIdentity) {
    if ((int)blockIdx.x >= n) return;  // the whole block
    const int det = blockIdx.x;
    transpose_mask(masks + (size_t)det * H * Wb, oh, ow, wpc, Wb,
                   out + g[6] + (size_t)det * ow * wpc, lay);
    return;
  }
  // a block: (detection, band, part), parts fastest
  const int nb = (ow + kBand - 1) / kBand, np = (wpc + kPartTiles - 1) / kPartTiles;
  if ((int)blockIdx.x >= n * nb * np) return;  // the whole block
  const int det = blockIdx.x / (nb * np), band = blockIdx.x / np % nb, part = blockIdx.x % np;
  const int c0 = kBand * band, ncols = min(kBand, ow - c0);
  const int t0 = kPartTiles * part, t1 = min(wpc, t0 + kPartTiles), tiles = t1 - t0;
  const int g0 = bands[2 * (g[8] + band)], kw = bands[2 * (g[8] + band) + 1];
  const int ylo = parts[2 * (g[9] + part)], rows = parts[2 * (g[9] + part) + 1];
  uint8_t* raw = smem + lay.raw;
  stage(masks + (size_t)det * H * Wb, Wb, ylo, rows, g0, kw, raw, lay.raw_stride);
  cp_async_commit();
  // while the chunks arrive: the tables and each row's record (its top and
  // bottom staged rows, fy)
  int* columns = (int*)(smem + lay.columns);
  build_tables(xtab, xfrac, xoff, c0, ow, g0, columns);
  int2* recs = (int2*)(smem + lay.recs);
  for (int r = threadIdx.x; r < 32 * tiles; r += blockDim.x) {
    const int i = 32 * t0 + r;
    int2 rec = make_int2(0, 0);
    if (i < oh)
      rec = make_int2((ytab[2 * (yoff + i)] - ylo) | ((ytab[2 * (yoff + i) + 1] - ylo) << 16),
                      __float_as_int(yfrac[yoff + i]));
    recs[r] = rec;
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t* words = (uint32_t*)(smem + lay.out);
  recover_band(raw, lay.raw_stride, columns, recs, words, oh, t0, t1, ncols, g[10], ylo, Wb, g0,
               kw);
  __syncthreads();
  uint32_t* dst = out + g[6] + ((size_t)det * ow + c0) * wpc + t0;
  for (int q = threadIdx.x; q < ncols * tiles; q += blockDim.x)
    dst[q / tiles * wpc + q % tiles] = words[q];
}

// Let recover_kernel take `bytes` of dynamic shared memory, with the SM's
// unified memory split all for shared memory.
int allow(int bytes) {
  static int granted = -1;
  if (bytes <= granted) return 0;
  cudaError_t err = cudaFuncSetAttribute(recover_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(recover_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  granted = bytes;
  return 0;
}

}  // namespace

extern "C" int omt_recover_masks(const uint8_t* packed, const int* geom, const int* bands,
                                 const int* parts, const int* xtab, const float* xfrac,
                                 const int* ytab, const float* yfrac, uint32_t* out, int B, int K,
                                 int H, int Wb, int max_tasks, int kw_max, int rows_max,
                                 int identity_H, void* stream) {
  if (B < 1 || B > 65535 || max_tasks < 1 || (Wb & 3) || ((long long)H * Wb) % 16 ||
      ((uintptr_t)packed & 15) || rows_max >= 65536 || identity_H > H)
    return (int)cudaErrorInvalidValue;
  const int bytes = layout(kw_max, rows_max, identity_H, Wb, 8 * Wb).total;
  const int err = allow(bytes);
  if (err) return err;
  recover_kernel<<<dim3(max_tasks, B), 32 * kWarps, bytes, (cudaStream_t)stream>>>(
      packed, geom, bands, parts, xtab, xfrac, ytab, yfrac, out, K, H, Wb, kw_max, rows_max,
      identity_H);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a launch with these sizes and the blocks an
// SM holds at once (the diagnostics of chip_smoke.py's phase 16).
extern "C" int omt_recover_occupancy(int kw_max, int rows_max, int identity_H, int Wb,
                                     int* bytes, int* blocks) {
  *bytes = layout(kw_max, rows_max, identity_H, Wb, 8 * Wb).total;
  const int err = allow(*bytes);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, recover_kernel,
                                                            32 * kWarps, *bytes);
}

extern "C" const char* omt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
