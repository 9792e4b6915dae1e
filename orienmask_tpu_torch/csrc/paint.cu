// Orientation-target painting for sm_90a.
//
// Replaces orienmask_tpu/ops/pallas_paint.py::paint_orientation (kernel
// _paint_kernel).  Per sample, instances n < n_last[b] with active > 0 are
// painted in order on the canvas of their anchor; instance n covers the ROI
// [x1, x2) x [y1, y2) of pixels (x, y):
//   mask bit set:   rank := n + 1, center := (cx, cy)        (the last wins)
//   mask bit clear: count += 1, sum += sneg * sign(off) * max(|off|, 1e-8)
//     with off = pixel - center and
//     sneg = min(max(cwx * (1/olx), 1), max(cwy * (1/oly), 1)) - 1;
// then pos = rank > 0, neg = count > 0 && !pos, den = -1 | count | 1000 and
// torien = raw * f32(1/(anchor/2)) * (1/den), raw = pixel - center | sum | 0.
// In: geom (B, N, 10) f32 [cx, cy, cwx, cwy, x1, x2, y1, y2, anchor,
// active], n_last (B,) int32, masks (B, N, H, W/8) uint8 packed MSB first.
// Out: pos, neg (B, A, H, W) f32 and torien (B, A, H, W, 2) f32, x and y
// interleaved.
//
// What bounds it: every output plane is written whatever the data, 16 B per
// anchor and pixel: at B=8, A=9, 544² that is 341 MB, 0.10 ms at 3.35 TB/s.
// The mask bytes read are at most B*N*H*W/8 (30 MB at N=100), and the
// arithmetic, about 30 instructions per instance and ROI pixel, is a few us.
// Design: one block per (sample, tile of 1024 pixels in row-major order);
// a thread owns kUnits units of 4 adjacent pixels of one row, so its stores
// are float4s and a warp writes 512 contiguous bytes per plane.  The block
// loads the sample's geometry into shared memory and lists, per anchor and
// in instance order, the instances whose rows meet the tile (warp 0, a
// stable counting sort with ballots).  Anchors are the outer loop: a thread
// keeps one canvas's six accumulators for its pixels in registers, runs the
// anchor's instances in order, finalizes and writes, then takes the next
// anchor.  Each pixel thus sees the same sequence of operations as in the
// sequential loop.  Pixels outside an ROI are skipped: there the TPU kernel
// adds 0 to the count and a +-0 offset to the sums, which changes no value.
//
// Exact arithmetic: every product, sum and difference is a separately
// rounded __fmul_rn/__fadd_rn/__fsub_rn (nvcc would contract them into
// FMAs), reciprocals are the correctly rounded __frcp_rn followed by a
// multiply (pl.reciprocal(approx=False)), the product keeps the TPU order
// ((sneg * sign) * ol), and 1/(anchor/2) comes from the host, taken in double
// and rounded to f32 once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnits = 2;  // units of 4 pixels per thread
constexpr int kTileUnits = kThreads * kUnits;
constexpr int kMaxAnchors = 16;
constexpr int kMaxInstances = 1024;
constexpr int kGeom = 10;
constexpr int kFields = 8;  // cx, cy, cwx, cwy, x1, x2, y1, y2

struct InvHalfAnchors {
  float v[2 * kMaxAnchors];
};

__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ float push_to_border(float off, float ol, float sneg) {
  return __fmul_rn(__fmul_rn(sneg, sign_of(off)), ol);
}

__global__ void __launch_bounds__(kThreads)
paint_kernel(const float* __restrict__ geom, const int* __restrict__ n_last,
             const uint8_t* __restrict__ masks, InvHalfAnchors inv,
             float* __restrict__ pos, float* __restrict__ neg,
             float* __restrict__ torien, int N, int A, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* g = reinterpret_cast<float*>(smem_raw);     // (kFields, N)
  int* key = reinterpret_cast<int*>(g + kFields * N);  // anchor, or -1: not here
  int* order = key + N;                               // instances by anchor
  __shared__ int start[kMaxAnchors + 1];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int W4 = W >> 2;
  const int units = H * W4;
  const int u0 = blockIdx.x * kTileUnits;
  const float tile_y0 = (float)(u0 / W4);
  const float tile_y1 = (float)((min(u0 + kTileUnits, units) - 1) / W4);
  const int nl = min(n_last[b], N);

  // the sample's geometry, and which instances this tile paints
  for (int n = tid; n < nl; n += kThreads) {
    const float* row = geom + ((size_t)b * N + n) * kGeom;
#pragma unroll
    for (int f = 0; f < kFields; ++f) g[f * N + n] = row[f];
    const int a = (int)row[8];
    const bool here = row[9] > 0.f && a >= 0 && a < A &&
                      row[6] <= tile_y1 && row[7] > tile_y0;
    key[n] = here ? a : -1;
  }
  __syncthreads();
  if (tid < 32) {  // stable counting sort of the instances by anchor
    const int lane = tid;
    const unsigned below = (1u << lane) - 1u;
    int count = 0;
    for (int base = 0; base < nl; base += 32) {
      const int k = base + lane < nl ? key[base + lane] : -1;
      for (int a = 0; a < A; ++a) {
        const unsigned m = __ballot_sync(0xffffffffu, k == a);
        if (lane == a) count += __popc(m);
      }
    }
    int incl = count;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    int cursor = incl - count;
    if (lane < A) start[lane] = cursor;
    if (lane == A - 1) start[A] = incl;
    for (int base = 0; base < nl; base += 32) {
      const int n = base + lane;
      const int k = n < nl ? key[n] : -1;
      for (int a = 0; a < A; ++a) {
        const unsigned m = __ballot_sync(0xffffffffu, k == a);
        const int c = __shfl_sync(0xffffffffu, cursor, a);
        if (k == a) order[c + __popc(m & below)] = n;
        if (lane == a) cursor += __popc(m);
      }
    }
  }
  __syncthreads();

  int uy[kUnits], ux[kUnits];
  bool live[kUnits];
#pragma unroll
  for (int u = 0; u < kUnits; ++u) {
    const int unit = u0 + u * kThreads + tid;
    live[u] = unit < units;
    uy[u] = live[u] ? unit / W4 : 0;
    ux[u] = live[u] ? (unit - uy[u] * W4) * 4 : 0;
  }
  const int W8 = W >> 3;
  const size_t plane = (size_t)H * W;
  const uint8_t* smask = masks + (size_t)b * N * H * W8;

  for (int a = 0; a < A; ++a) {
    float rank[kUnits][4], cenx[kUnits][4], ceny[kUnits][4];
    float cnt[kUnits][4], sumx[kUnits][4], sumy[kUnits][4];
#pragma unroll
    for (int u = 0; u < kUnits; ++u)
#pragma unroll
      for (int p = 0; p < 4; ++p)
        rank[u][p] = cenx[u][p] = ceny[u][p] = cnt[u][p] = sumx[u][p] = sumy[u][p] = 0.f;

    for (int j = start[a]; j < start[a + 1]; ++j) {
      const int n = order[j];
      const float cx = g[0 * N + n], cy = g[1 * N + n];
      const float cwx = g[2 * N + n], cwy = g[3 * N + n];
      const float x1 = g[4 * N + n], x2 = g[5 * N + n];
      const float y1 = g[6 * N + n], y2 = g[7 * N + n];
      const float rnk = (float)(n + 1);
#pragma unroll
      for (int u = 0; u < kUnits; ++u) {
        const float yf = (float)uy[u];
        if (!live[u] || !(yf >= y1 && yf < y2)) continue;
        const float xf0 = (float)ux[u];
        if (!(xf0 + 3.f >= x1 && xf0 < x2)) continue;
        const unsigned byte =
            smask[((size_t)n * H + uy[u]) * W8 + (ux[u] >> 3)];
        const int bit0 = 7 - (ux[u] & 7);
        // the row's share of the push-to-border offset
        const float offy = __fsub_rn(yf, cy);
        const float oly = fmaxf(fabsf(offy), 1e-8f);
        const float ry = fmaxf(__fmul_rn(cwy, __frcp_rn(oly)), 1.f);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float xf = xf0 + (float)p;
          if (!(xf >= x1 && xf < x2)) continue;
          if ((byte >> (bit0 - p)) & 1u) {
            rank[u][p] = rnk;
            cenx[u][p] = cx;
            ceny[u][p] = cy;
          } else {
            const float offx = __fsub_rn(xf, cx);
            const float olx = fmaxf(fabsf(offx), 1e-8f);
            const float rx = fmaxf(__fmul_rn(cwx, __frcp_rn(olx)), 1.f);
            const float sneg = __fsub_rn(fminf(rx, ry), 1.f);
            cnt[u][p] = __fadd_rn(cnt[u][p], 1.f);
            sumx[u][p] = __fadd_rn(sumx[u][p], push_to_border(offx, olx, sneg));
            sumy[u][p] = __fadd_rn(sumy[u][p], push_to_border(offy, oly, sneg));
          }
        }
      }
    }

    const float ihx = inv.v[2 * a], ihy = inv.v[2 * a + 1];
    const size_t canvas = ((size_t)b * A + a) * plane;
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      if (!live[u]) continue;
      const float yf = (float)uy[u];
      float ps[4], ng[4], t[8];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float xf = (float)(ux[u] + p);
        const bool is_pos = rank[u][p] > 0.f;
        const bool has_bg = cnt[u][p] > 0.f && !is_pos;
        const float den = is_pos ? -1.f : (has_bg ? cnt[u][p] : 1000.f);
        const float rden = __frcp_rn(den);
        const float rawx = is_pos ? __fsub_rn(xf, cenx[u][p]) : (has_bg ? sumx[u][p] : 0.f);
        const float rawy = is_pos ? __fsub_rn(yf, ceny[u][p]) : (has_bg ? sumy[u][p] : 0.f);
        ps[p] = is_pos ? 1.f : 0.f;
        ng[p] = has_bg ? 1.f : 0.f;
        t[2 * p] = __fmul_rn(__fmul_rn(rawx, ihx), rden);
        t[2 * p + 1] = __fmul_rn(__fmul_rn(rawy, ihy), rden);
      }
      const size_t at = canvas + (size_t)uy[u] * W + ux[u];
      *reinterpret_cast<float4*>(pos + at) = make_float4(ps[0], ps[1], ps[2], ps[3]);
      *reinterpret_cast<float4*>(neg + at) = make_float4(ng[0], ng[1], ng[2], ng[3]);
      float4* to = reinterpret_cast<float4*>(torien + 2 * at);
      to[0] = make_float4(t[0], t[1], t[2], t[3]);
      to[1] = make_float4(t[4], t[5], t[6], t[7]);
    }
  }
}

}  // namespace

extern "C" int omt_paint_orientation(const float* geom, const int* n_last,
                                     const uint8_t* masks, const float* inv_half_host,
                                     float* pos, float* neg, float* torien, int B,
                                     int N, int A, int H, int W, void* stream) {
  if (A < 1 || A > kMaxAnchors || N > kMaxInstances || (W & 7))
    return (int)cudaErrorInvalidValue;
  InvHalfAnchors inv;
  for (int i = 0; i < 2 * kMaxAnchors; ++i) inv.v[i] = i < 2 * A ? inv_half_host[i] : 0.f;
  const int units = H * (W / 4);
  const dim3 grid((units + kTileUnits - 1) / kTileUnits, B);
  const size_t smem = (size_t)N * (kFields * sizeof(float) + 2 * sizeof(int));
  paint_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      geom, n_last, masks, inv, pos, neg, torien, N, A, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* omt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
