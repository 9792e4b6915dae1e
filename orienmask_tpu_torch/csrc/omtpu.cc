// Native host library of the port (its own copy of the JAX package's
// orienmask_tpu/native/src/omtpu.cc, with one entry point more).
//
// The host-side hot loops of COCO conversion and evaluation:
//   - om_nms:              greedy CPU NMS (reference parity, tests)
//   - om_rle_encode(_batch): COCO compressed-RLE encoding of uint8 masks
//   - om_rle_encode_colpacked: the same strings from column-major bits, the
//                          layout the card's mask recovery (csrc/recover.cu)
//                          writes, so that only bits cross to the host
//   - om_rle_decode:       compressed string -> raw counts
//   - om_poly_merge, om_rle_iou, om_coco_match: pycocotools' frPoly + merge,
//                          rleIou and COCOeval's greedy matching
//   - om_resize_bilinear:  float HWC bilinear resize (half-pixel centres)
//
// A plain C interface bound with ctypes (orienmask_tpu_torch/native), built
// by g++ at first use (kernels.host_library).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

// Raw counts -> compressed string: base-32 varint chars with delta coding
// from index 3 on (pycocotools wire format). Returns the string length, or
// -1 if out_cap is too small.
static int64_t write_counts(const std::vector<int64_t>& counts, char* out,
                            int64_t out_cap) {
  int64_t p = 0;
  const int64_t m = (int64_t)counts.size();
  for (int64_t i = 0; i < m; ++i) {
    int64_t x = counts[i];
    if (i > 2) x -= counts[i - 2];
    bool more = true;
    while (more) {
      int c = (int)(x & 0x1f);
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      if (p >= out_cap) return -1;
      out[p++] = (char)(c + 48);
    }
  }
  return p;
}

extern "C" {

// Greedy NMS over score-sorted cxcywh+score boxes. Returns number kept; keep
// indices (input order, ascending) written to keep_out.
int om_nms(const float* dets, int n, float thresh, int64_t* keep_out) {
  if (n <= 0) return 0;
  std::vector<float> x1(n), y1(n), x2(n), y2(n), area(n);
  std::vector<int> order(n);
  for (int i = 0; i < n; ++i) {
    const float* d = dets + 5 * i;
    x1[i] = d[0] - d[2] / 2.f;
    y1[i] = d[1] - d[3] / 2.f;
    x2[i] = d[0] + d[2] / 2.f;
    y2[i] = d[1] + d[3] / 2.f;
    area[i] = (x2[i] - x1[i]) * (y2[i] - y1[i]);
    order[i] = i;
  }
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return dets[5 * a + 4] > dets[5 * b + 4]; });
  std::vector<uint8_t> suppressed(n, 0);
  for (int oi = 0; oi < n; ++oi) {
    int i = order[oi];
    if (suppressed[i]) continue;
    for (int oj = oi + 1; oj < n; ++oj) {
      int j = order[oj];
      if (suppressed[j]) continue;
      float xx1 = std::max(x1[i], x1[j]);
      float yy1 = std::max(y1[i], y1[j]);
      float xx2 = std::min(x2[i], x2[j]);
      float yy2 = std::min(y2[i], y2[j]);
      float w = std::max(0.f, xx2 - xx1);
      float h = std::max(0.f, yy2 - yy1);
      float inter = w * h;
      float ovr = inter / (area[i] + area[j] - inter);
      if (ovr >= thresh) suppressed[j] = 1;
    }
  }
  int m = 0;
  for (int i = 0; i < n; ++i)
    if (!suppressed[i]) keep_out[m++] = i;
  return m;
}

// COCO compressed RLE: column-major runs, counts[0] is the zero-run, base-32
// varint chars with delta coding from index 3 on (pycocotools wire format).
// mask is row-major HxW uint8. Returns string length, or -1 if out_cap too small.
//
// The naive per-byte column walk costs ~0.67 ms on a 480x640 mask (loop
// overhead, not cache misses) and this is THE eval-time hot op — every
// detection's mask is encoded during COCO conversion. Instead: a blocked
// transpose into a normalized 0/1 scratch buffer (~50 us), then a word-wise
// run scan that skips 8 equal bytes per compare.
int om_rle_encode(const uint8_t* mask, int h, int w, char* out, int out_cap) {
  const int64_t n = (int64_t)h * w;
  static thread_local std::vector<uint8_t> scratch;
  if ((int64_t)scratch.size() < n) scratch.resize(n);
  uint8_t* f = scratch.data();
  const int B = 64;
  for (int y0 = 0; y0 < h; y0 += B) {
    int y1 = std::min(y0 + B, h);
    for (int x0 = 0; x0 < w; x0 += B) {
      int x1 = std::min(x0 + B, w);
      for (int y = y0; y < y1; ++y)
        for (int x = x0; x < x1; ++x)
          f[(size_t)x * h + y] = mask[(size_t)y * w + x] != 0;
    }
  }

  std::vector<int64_t> counts;
  counts.reserve(256);
  int64_t i = 0;
  uint8_t expect = 0;  // RLE alternates 0-run, 1-run, ... starting at 0
  while (i < n) {
    const uint8_t v = f[i];
    int64_t j = i + 1;
    uint64_t pat;
    std::memset(&pat, v, 8);
    while (j + 8 <= n) {
      uint64_t wv;
      std::memcpy(&wv, f + j, 8);
      if (wv != pat) break;
      j += 8;
    }
    while (j < n && f[j] == v) ++j;
    if (v != expect) counts.push_back(0);  // only possible at i == 0
    counts.push_back(j - i);
    expect = !v;
    i = j;
  }
  if (counts.empty()) counts.push_back(0);  // h*w == 0

  return (int)write_counts(counts, out, out_cap);
}

// Inverse of the varint writer above: compressed-RLE string -> raw counts.
// Returns the number of counts, or -1 if out_cap is too small. Hot in
// LiteCOCOeval, which touches every detection's RLE string at least once.
int64_t om_rle_decode(const char* s, int64_t slen, int64_t* out,
                      int64_t out_cap) {
  int64_t m = 0;
  int64_t p = 0;
  while (p < slen) {
    int64_t x = 0;
    int k = 0;
    while (true) {
      if (p >= slen) return -1;  // truncated varint
      int64_t c = (int64_t)s[p] - 48;
      x |= (c & 0x1f) << (5 * k);
      ++p;
      ++k;
      if (!(c & 0x20)) {
        if (c & 0x10) x |= ~((int64_t)0) << (5 * k);
        break;
      }
    }
    if (m > 2) x += out[m - 2];
    if (m >= out_cap) return -1;
    out[m++] = x;
  }
  return m;
}

// RLE encode of n masks of (oh, ow) that arrive as column-major bits:
// words (n, ow, wpc) uint32, wpc = ceil(oh / 32), bit i of word w of column
// c is pixel (32 w + i, c); bits past oh are ignored. Writes the same
// strings as om_rle_encode of the unpacked masks, concatenated, and their
// lengths to lens. Returns the total length, or -1 if out_cap is too small.
//
// Each word's run boundaries are the set bits of w ^ (w << 1 | carry),
// carry being the pixel before the word (the last of the previous column
// at a column seam, 0 before the first: counts start with the zero-run);
// count-trailing-zeros walks them.
int64_t om_rle_encode_colpacked(const uint32_t* words, int n, int oh, int ow,
                                char* out, int64_t out_cap, int32_t* lens) {
  const int wpc = (oh + 31) / 32;
  const int64_t area = (int64_t)oh * ow;
  std::vector<int64_t> counts;
  counts.reserve(256);
  int64_t total = 0;
  for (int i = 0; i < n; ++i) {
    const uint32_t* mask = words + (size_t)i * ow * wpc;
    counts.clear();
    int64_t last = 0;  // flat (column-major) index of the last boundary
    uint32_t carry = 0;
    for (int c = 0; c < ow; ++c) {
      const uint32_t* col = mask + (size_t)c * wpc;
      for (int w = 0; w < wpc; ++w) {
        const int nb = std::min(32, oh - 32 * w);
        const uint32_t valid = nb == 32 ? ~0u : ((1u << nb) - 1u);
        const uint32_t x = col[w] & valid;
        uint32_t t = (x ^ ((x << 1) | carry)) & valid;
        const int64_t base = (int64_t)c * oh + 32 * w;
        while (t) {
          const int64_t pos = base + __builtin_ctz(t);
          counts.push_back(pos - last);
          last = pos;
          t &= t - 1;
        }
        carry = (x >> (nb - 1)) & 1u;
      }
    }
    counts.push_back(area - last);
    const int64_t len = write_counts(counts, out + total, out_cap - total);
    if (len < 0) return -1;
    lens[i] = (int32_t)len;
    total += len;
  }
  return total;
}

// Batch RLE encode: n masks (n, h, w) uint8; writes concatenated strings to out
// and per-mask lengths to lens. Returns total length or -1 on overflow.
int om_rle_encode_batch(const uint8_t* masks, int n, int h, int w, char* out,
                        int out_cap, int32_t* lens) {
  int total = 0;
  for (int i = 0; i < n; ++i) {
    int len = om_rle_encode(masks + (size_t)i * h * w, h, w, out + total,
                            out_cap - total);
    if (len < 0) return -1;
    lens[i] = len;
    total += len;
  }
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// pycocotools-exact polygon rasterization + RLE-space ops.
//
// The reference's GT masks and eval IoUs come from pycocotools' maskApi
// (crossing-based rleFrPoly, run-sweep rleMerge/rleIou); these reimplement the
// same documented algorithms so masks/IoUs are bit-identical to the official
// toolchain without decoding full bitmaps.

namespace {

// One polygon -> toggle positions (column-major flat index) via the 5x
// upsampled boundary walk; caller accumulates positions across polygons.
void poly_toggle_positions(const double* xy, int k, int h, int w,
                           std::vector<int64_t>& pos) {
  if (k == 0) return;
  const double scale = 5.0;
  std::vector<int64_t> x(k + 1), y(k + 1);
  for (int j = 0; j < k; ++j) x[j] = (int64_t)(scale * xy[2 * j + 0] + 0.5);
  for (int j = 0; j < k; ++j) y[j] = (int64_t)(scale * xy[2 * j + 1] + 0.5);
  x[k] = x[0];
  y[k] = y[0];
  // dense boundary samples, axis-major stepping with endpoint flip
  std::vector<int64_t> u, v;
  for (int j = 0; j < k; ++j) {
    int64_t xs = x[j], xe = x[j + 1], ys = y[j], ye = y[j + 1];
    int64_t dx = std::llabs(xe - xs), dy = std::llabs(ys - ye);
    bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
    if (flip) {
      std::swap(xs, xe);
      std::swap(ys, ye);
    }
    if (dx >= dy) {
      double s = dx ? (double)(ye - ys) / dx : 0.0;
      for (int64_t d = 0; d <= dx; ++d) {
        int64_t t = flip ? dx - d : d;
        u.push_back(t + xs);
        v.push_back((int64_t)(ys + s * t + 0.5));
      }
    } else {
      double s = dy ? (double)(xe - xs) / dy : 0.0;
      for (int64_t d = 0; d <= dy; ++d) {
        int64_t t = flip ? dy - d : d;
        v.push_back(t + ys);
        u.push_back((int64_t)(xs + s * t + 0.5));
      }
    }
  }
  // column crossings at original-resolution pixel boundaries
  for (size_t j = 1; j < u.size(); ++j) {
    if (u[j] == u[j - 1]) continue;
    double xd = (double)(u[j] < u[j - 1] ? u[j] : u[j] - 1);
    xd = (xd + 0.5) / scale - 0.5;
    if (std::floor(xd) != xd || xd < 0 || xd > w - 1) continue;
    double yd = (double)(v[j] < v[j - 1] ? v[j] : v[j - 1]);
    yd = (yd + 0.5) / scale - 0.5;
    if (yd < 0) yd = 0;
    else if (yd > h) yd = h;
    yd = std::ceil(yd);
    pos.push_back((int64_t)xd * h + (int64_t)yd);
  }
}

// sorted toggle positions -> alternating counts. Toggles with even
// multiplicity cancel; counts always extend to n (so a toggle landing exactly
// at n is a no-op) — matching rleFrPoly's sentinel + delta-merge loop.
void toggles_to_counts(std::vector<int64_t>& pos, int64_t n,
                       std::vector<int64_t>& counts) {
  std::sort(pos.begin(), pos.end());
  counts.clear();
  std::vector<int64_t> kept;
  for (size_t i = 0; i < pos.size();) {
    size_t j = i;
    while (j < pos.size() && pos[j] == pos[i]) ++j;
    if ((j - i) % 2 && pos[i] < n) kept.push_back(pos[i]);
    i = j;
  }
  int64_t prev = 0;
  for (int64_t t : kept) {
    counts.push_back(t - prev);
    prev = t;
  }
  counts.push_back(n - prev);
}

// run-sweep union/intersection of two alternating-counts RLEs (rleMerge)
std::vector<int64_t> merge_two(const std::vector<int64_t>& A,
                               const std::vector<int64_t>& B, int64_t n,
                               bool intersect) {
  std::vector<int64_t> out;
  size_t ia = 0, ib = 0;
  int64_t ra = A.empty() ? 0 : A[0];
  int64_t rb = B.empty() ? 0 : B[0];
  bool va = false, vb = false, v = false;
  int64_t cc = 0, remaining = n;
  while (remaining > 0) {
    if (ra == 0) {  // advance A run (exhausted list keeps its last value)
      if (ia + 1 < A.size()) {
        ra = A[++ia];
        va = !va;
      } else {
        ra = remaining;
      }
      continue;
    }
    if (rb == 0) {
      if (ib + 1 < B.size()) {
        rb = B[++ib];
        vb = !vb;
      } else {
        rb = remaining;
      }
      continue;
    }
    int64_t c = std::min(std::min(ra, rb), remaining);
    bool nv = intersect ? (va && vb) : (va || vb);
    if (cc == 0) {  // very first segment
      v = nv;
      if (v) out.push_back(0);  // counts start with the zero-run
    } else if (nv != v) {
      out.push_back(cc);
      cc = 0;
      v = nv;
    }
    cc += c;
    ra -= c;
    rb -= c;
    remaining -= c;
  }
  if (cc > 0) out.push_back(cc);
  if (out.empty()) out.push_back(n);
  return out;
}

}  // namespace

extern "C" {

// Rasterize + union-merge COCO polygons (pycocotools frPoly + merge).
// flat_xy: concatenated [x0 y0 x1 y1 ...] for all polygons; offsets (n+1) give
// each polygon's start in VERTEX PAIRS. Writes alternating counts; returns m
// or -1 if cap too small.
int om_poly_merge(const double* flat_xy, const int64_t* offsets, int n_polys,
                  int h, int w, int64_t* counts_out, int cap) {
  const int64_t n = (int64_t)h * w;
  std::vector<int64_t> acc;  // merged counts so far
  bool first = true;
  for (int p = 0; p < n_polys; ++p) {
    int k = (int)(offsets[p + 1] - offsets[p]);
    std::vector<int64_t> pos;
    poly_toggle_positions(flat_xy + 2 * offsets[p], k, h, w, pos);
    std::vector<int64_t> counts;
    toggles_to_counts(pos, n, counts);
    if (first) {
      acc = std::move(counts);
      first = false;
    } else {
      acc = merge_two(acc, counts, n, /*intersect=*/false);
    }
  }
  if (first) {
    acc.assign(1, n);
  }
  if ((int)acc.size() > cap) return -1;
  std::copy(acc.begin(), acc.end(), counts_out);
  return (int)acc.size();
}

// Pairwise RLE IoU without decoding (pycocotools rleIou): two-pointer run
// sweep per pair, with a bbox-overlap prefilter. Inputs are concatenated
// alternating counts + offsets (in COUNTS) for each list; all RLEs share one
// (h, w). iscrowd (len n_b) switches union to area(a). Output (n_a, n_b)
// row-major double.
void om_rle_iou(const int64_t* counts_a, const int64_t* off_a, int n_a,
                const int64_t* counts_b, const int64_t* off_b, int n_b,
                int h, const uint8_t* iscrowd, double* out) {
  // per-RLE area + bbox (x0, x1 columns; y0, y1 rows) from runs
  auto stats = [h](const int64_t* c, int m, double* area, int64_t* bb) {
    int64_t pos = 0, ar = 0;
    int64_t x0 = INT64_MAX, x1 = -1, y0 = INT64_MAX, y1 = -1;
    for (int i = 0; i < m; ++i) {
      if (i % 2) {
        int64_t s = pos, e = pos + c[i] - 1;
        ar += c[i];
        int64_t cs = s / h, ce = e / h;
        x0 = std::min(x0, cs);
        x1 = std::max(x1, ce);
        if (ce > cs) {
          y0 = 0;
          y1 = h - 1;
        } else {
          y0 = std::min(y0, s % h);
          y1 = std::max(y1, e % h);
        }
      }
      pos += c[i];
    }
    *area = (double)ar;
    bb[0] = x0;
    bb[1] = x1;
    bb[2] = y0;
    bb[3] = y1;
  };
  std::vector<double> area_a(n_a), area_b(n_b);
  std::vector<int64_t> bb_a(4 * n_a), bb_b(4 * n_b);
  for (int i = 0; i < n_a; ++i)
    stats(counts_a + off_a[i], (int)(off_a[i + 1] - off_a[i]), &area_a[i],
          &bb_a[4 * i]);
  for (int j = 0; j < n_b; ++j)
    stats(counts_b + off_b[j], (int)(off_b[j + 1] - off_b[j]), &area_b[j],
          &bb_b[4 * j]);

  for (int i = 0; i < n_a; ++i) {
    for (int j = 0; j < n_b; ++j) {
      double& o = out[(size_t)i * n_b + j];
      o = 0.0;
      if (bb_a[4 * i + 1] < bb_b[4 * j + 0] ||
          bb_b[4 * j + 1] < bb_a[4 * i + 0] ||
          bb_a[4 * i + 3] < bb_b[4 * j + 2] ||
          bb_b[4 * j + 3] < bb_a[4 * i + 2])
        continue;  // disjoint bboxes -> IoU 0
      const int64_t* ca = counts_a + off_a[i];
      const int64_t* cb = counts_b + off_b[j];
      int ma = (int)(off_a[i + 1] - off_a[i]);
      int mb = (int)(off_b[j + 1] - off_b[j]);
      // two-pointer sweep over runs
      int64_t inter = 0;
      int ia = 0, ib = 0;
      int64_t ra = ma ? ca[0] : 0, rb = mb ? cb[0] : 0;
      bool va = false, vb = false;
      while (ia < ma && ib < mb) {
        int64_t c = std::min(ra, rb);
        if (va && vb) inter += c;
        ra -= c;
        rb -= c;
        if (!ra) {
          ++ia;
          if (ia < ma) ra = ca[ia];
          va = !va;
        }
        if (!rb) {
          ++ib;
          if (ib < mb) rb = cb[ib];
          vb = !vb;
        }
      }
      double uni = (iscrowd && iscrowd[j])
                       ? area_a[i]
                       : area_a[i] + area_b[j] - (double)inter;
      o = uni > 0 ? (double)inter / uni : 0.0;
    }
  }
}

// COCOeval greedy matching for one (image, category, area-range) cell —
// the exact loop in eval/lite_cocoeval.py _evaluate_img_cat, which profiles
// as ~half the evaluation once IoU and RLE decode are native.
//   ious:    nd x ng row-major (original gt index order)
//   g_order: sorted-gt order (non-ignored first, stable), length ng
//   gi:      ignore flag per SORTED gt position, length ng
//   iscrowd: per ORIGINAL gt index, length ng
//   thrs:    IoU thresholds, length nt
//   dt_m:    nt x nd out, -1 = unmatched, else SORTED gt index
//   dt_ig:   nt x nd out, 1 = matched an ignored gt
void om_coco_match(const double* ious, int nd, int ng,
                   const int64_t* g_order, const uint8_t* gi,
                   const uint8_t* iscrowd, const double* thrs, int nt,
                   int64_t* dt_m, uint8_t* dt_ig) {
  std::vector<int64_t> gt_m(ng);
  for (int ti = 0; ti < nt; ++ti) {
    std::fill(gt_m.begin(), gt_m.end(), (int64_t)-1);
    const double cap = 1.0 - 1e-10;
    for (int di = 0; di < nd; ++di) {
      double best = thrs[ti] < cap ? thrs[ti] : cap;
      int64_t m = -1;
      const double* row = ious + (size_t)di * ng;
      for (int sj = 0; sj < ng; ++sj) {
        const int64_t gj = g_order[sj];
        if (gt_m[sj] >= 0 && !iscrowd[gj]) continue;
        if (m > -1 && !gi[m] && gi[sj]) break;
        if (row[gj] < best) continue;
        best = row[gj];
        m = sj;
      }
      dt_m[(size_t)ti * nd + di] = m;
      if (m == -1) continue;
      dt_ig[(size_t)ti * nd + di] = gi[m];
      gt_m[m] = di;
    }
  }
}

}  // extern "C"

extern "C" {

// Bilinear resize float32 HWC, half-pixel centers (align_corners=false matches
// torch/cv2 INTER_LINEAR).
void om_resize_bilinear(const float* src, int sh, int sw, int c, float* dst,
                        int dh, int dw, int align_corners) {
  for (int y = 0; y < dh; ++y) {
    float fy = align_corners && dh > 1
                   ? (float)y * (sh - 1) / (dh - 1)
                   : ((float)y + 0.5f) * sh / dh - 0.5f;
    fy = std::min(std::max(fy, 0.f), (float)(sh - 1));
    int y0 = (int)fy;
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = align_corners && dw > 1
                     ? (float)x * (sw - 1) / (dw - 1)
                     : ((float)x + 0.5f) * sw / dw - 0.5f;
      fx = std::min(std::max(fx, 0.f), (float)(sw - 1));
      int x0 = (int)fx;
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - x0;
      const float* p00 = src + ((size_t)y0 * sw + x0) * c;
      const float* p01 = src + ((size_t)y0 * sw + x1) * c;
      const float* p10 = src + ((size_t)y1 * sw + x0) * c;
      const float* p11 = src + ((size_t)y1 * sw + x1) * c;
      float* o = dst + ((size_t)y * dw + x) * c;
      for (int k = 0; k < c; ++k) {
        float top = p00[k] * (1 - wx) + p01[k] * wx;
        float bot = p10[k] * (1 - wx) + p11[k] * wx;
        o[k] = top * (1 - wy) + bot * wy;
      }
    }
  }
}

}  // extern "C"
