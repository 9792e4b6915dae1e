// MPEG-4 Part 2 loops of data/mpeg4.py (the reader: Simple and Advanced
// Simple Profile) and data/mpeg4_encode.py (the writer), and the colour
// conversions of data/yuv.py: each is the plain Python version written
// again in C++, and held to it by the tests.  Plain C interface, loaded
// with ctypes.
//
// The reader's tables come from Python (mpeg4.native_tables): one int32
// array whose first entries are the offsets of its parts, so the codes are
// written once, in data/mpeg4_tables.py.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// offsets into the packed tables (mpeg4.native_tables's order)
enum {
  T_INTRA_MCBPC, T_INTER_MCBPC, T_CBPY, T_MVD, T_DC_LUMA, T_DC_CHROMA, T_TCOEF_INTER,
  T_TCOEF_INTRA, T_RUN_INTER, T_RUN_INTRA, T_LEVEL_INTER, T_LEVEL_INTRA, T_LMAX_INTER,
  T_LMAX_INTRA, T_RMAX_INTER, T_RMAX_INTRA, T_SCANS, T_DC_SCALE, T_COUNT
};
// a lookup at offset o: [bits, sym[1 << bits], len[1 << bits]]

enum {
  ERR_VLC = -1, ERR_END = -2, ERR_COEFS = -3, ERR_PACKET = -4, ERR_REF = -5, ERR_MBTYPE = -6,
  ERR_MARKER = -7, ERR_DC_AMONG_AC = -8
};
enum { MB_INTRA, MB_INTER, MB_SKIPPED, MB_INTER4V };
enum { I_VOP, P_VOP, B_VOP };
// the parameter vector (mpeg4.params)
enum {
  P_MB_W, P_MB_H, P_TYPE, P_QUANT, P_FCODE, P_ROUNDING, P_DC_THR, P_RESYNC, P_TIME_BITS, P_EDGE_W,
  P_EDGE_H, P_WIDTH, P_HEIGHT, P_BCODE, P_QUANT_TYPE, P_QPEL, P_PARTITIONED, P_IDCT, P_BUGS,
  P_PP_TIME, P_PB_TIME
};
enum { BUG_DC_CLIP = 1, BUG_QPEL_CHROMA = 2, BUG_QPEL_CHROMA2 = 4 };
const int INTRA_DC_STUFF = 8, INTER_STUFF = 20, ESCAPE = 102;
const int LAST_FROM[2] = {58, 67};
const int DQUANT[4] = {-1, -2, 1, 2};
const uint32_t DC_MARKER = 0x6B001, MOTION_MARKER = 0x1F001;

struct Bits {
  const uint8_t* data;  // padded with 8 zero bytes
  int64_t size, pos;
  int err = 0;
  uint32_t peek(int n) const {
    int64_t byte = pos >> 3;
    uint64_t w = 0;
    for (int i = 0; i < 8; i++) w = (w << 8) | data[byte + i];
    return (uint32_t)((w >> (64 - (pos & 7) - n)) & ((n == 32) ? 0xFFFFFFFFull : ((1ull << n) - 1)));
  }
  uint32_t bits(int n) {
    if (n == 0) return 0;
    if (pos + n > size) { err = ERR_END; pos = size; return 0; }
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
  int signed_bits(int n) {
    uint32_t v = bits(n);
    return (v >> (n - 1)) ? (int)v - (1 << n) : (int)v;
  }
  int vlc(const int32_t* t) {
    int n = t[0];
    uint32_t code = peek(n);
    int len = t[1 + (1 << n) + code];
    if (len == 0) { err = ERR_VLC; return 0; }
    pos += len;
    if (pos > size) { err = ERR_END; pos = size; return 0; }
    return t[1 + code];
  }
  void align() { pos = (pos + 7) & ~7ll; }
};

inline int median(int a, int b, int c) {
  if (a > b) std::swap(a, b);
  if (b > c) b = c;
  return a > b ? a : b;
}
inline int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }
inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline int16_t wrap16(int64_t v) { return (int16_t)(uint16_t)(v & 0xFFFF); }
inline int32_t wrap32(int64_t v) { return (int32_t)(uint32_t)(uint64_t)v; }
inline int rounded_div(int a, int b) { return a > 0 ? (a + (b >> 1)) / b : (a - (b >> 1)) / b; }
inline int half(int v) { return v / 2; }  // C's truncating division, as FFmpeg's mv / 2

const int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873, W6 = 8867, W7 = 4520;

// FFmpeg's simple_idct (8-bit): rows with the DC-only shortcut into int16,
// then columns; out[64] before the put or add
void simple_idct(const int16_t* in, int32_t* out) {
  int16_t rows[64];
  for (int i = 0; i < 8; i++) {
    const int16_t* r = in + 8 * i;
    int16_t* o = rows + 8 * i;
    if (!(r[1] | r[2] | r[3] | r[4] | r[5] | r[6] | r[7])) {
      int16_t dc = wrap16((int64_t)r[0] * 8);
      for (int k = 0; k < 8; k++) o[k] = dc;
      continue;
    }
    uint32_t a0 = (uint32_t)(W4 * r[0]) + (1u << 10), a1 = a0, a2 = a0, a3 = a0;
    a0 += (uint32_t)(W2 * r[2] + W4 * r[4] + W6 * r[6]);
    a1 += (uint32_t)(W6 * r[2] - W4 * r[4] - W2 * r[6]);
    a2 += (uint32_t)(-W6 * r[2] - W4 * r[4] + W2 * r[6]);
    a3 += (uint32_t)(-W2 * r[2] + W4 * r[4] - W6 * r[6]);
    uint32_t b0 = (uint32_t)(W1 * r[1] + W3 * r[3] + W5 * r[5] + W7 * r[7]);
    uint32_t b1 = (uint32_t)(W3 * r[1] - W7 * r[3] - W1 * r[5] - W5 * r[7]);
    uint32_t b2 = (uint32_t)(W5 * r[1] - W1 * r[3] + W7 * r[5] + W3 * r[7]);
    uint32_t b3 = (uint32_t)(W7 * r[1] - W5 * r[3] + W3 * r[5] - W1 * r[7]);
    o[0] = wrap16((int32_t)(a0 + b0) >> 11);
    o[1] = wrap16((int32_t)(a1 + b1) >> 11);
    o[2] = wrap16((int32_t)(a2 + b2) >> 11);
    o[3] = wrap16((int32_t)(a3 + b3) >> 11);
    o[4] = wrap16((int32_t)(a3 - b3) >> 11);
    o[5] = wrap16((int32_t)(a2 - b2) >> 11);
    o[6] = wrap16((int32_t)(a1 - b1) >> 11);
    o[7] = wrap16((int32_t)(a0 - b0) >> 11);
  }
  for (int i = 0; i < 8; i++) {
    const int16_t* c = rows + i;
    uint32_t a0 = (uint32_t)(W4 * (c[0] + 32)), a1 = a0, a2 = a0, a3 = a0;
    a0 += (uint32_t)(W2 * c[16] + W4 * c[32] + W6 * c[48]);
    a1 += (uint32_t)(W6 * c[16] - W4 * c[32] - W2 * c[48]);
    a2 += (uint32_t)(-W6 * c[16] - W4 * c[32] + W2 * c[48]);
    a3 += (uint32_t)(-W2 * c[16] + W4 * c[32] - W6 * c[48]);
    uint32_t b0 = (uint32_t)(W1 * c[8] + W3 * c[24] + W5 * c[40] + W7 * c[56]);
    uint32_t b1 = (uint32_t)(W3 * c[8] - W7 * c[24] - W1 * c[40] - W5 * c[56]);
    uint32_t b2 = (uint32_t)(W5 * c[8] - W1 * c[24] + W7 * c[40] + W3 * c[56]);
    uint32_t b3 = (uint32_t)(W7 * c[8] - W5 * c[24] + W3 * c[40] - W1 * c[56]);
    out[0 * 8 + i] = (int32_t)(a0 + b0) >> 20;
    out[1 * 8 + i] = (int32_t)(a1 + b1) >> 20;
    out[2 * 8 + i] = (int32_t)(a2 + b2) >> 20;
    out[3 * 8 + i] = (int32_t)(a3 + b3) >> 20;
    out[4 * 8 + i] = (int32_t)(a3 - b3) >> 20;
    out[5 * 8 + i] = (int32_t)(a2 - b2) >> 20;
    out[6 * 8 + i] = (int32_t)(a1 - b1) >> 20;
    out[7 * 8 + i] = (int32_t)(a0 - b0) >> 20;
  }
}

// XviD's IDCT (mpeg4.xvid_idct): per-row cosines and rounders, then the
// column pass of 16-bit multiplies and butterflies, each pass into int16
void xvid_idct(const int16_t* in, int32_t* out) {
  static const int64_t tab[8][7] = {
      {22725, 21407, 19266, 16384, 12873, 8867, 4520},
      {31521, 29692, 26722, 22725, 17855, 12299, 6270},
      {29692, 27969, 25172, 21407, 16819, 11585, 5906},
      {26722, 25172, 22654, 19266, 15137, 10426, 5315},
      {22725, 21407, 19266, 16384, 12873, 8867, 4520},
      {26722, 25172, 22654, 19266, 15137, 10426, 5315},
      {29692, 27969, 25172, 21407, 16819, 11585, 5906},
      {31521, 29692, 26722, 22725, 17855, 12299, 6270}};
  static const int64_t rnd[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};
  int64_t x[64];
  for (int r = 0; r < 8; r++) {
    const int16_t* b = in + 8 * r;
    const int64_t* c = tab[r];
    int64_t k = c[3] * b[0] + rnd[r];
    int64_t a0 = k + c[1] * b[2] + c[3] * b[4] + c[5] * b[6];
    int64_t a1 = k + c[5] * b[2] - c[3] * b[4] - c[1] * b[6];
    int64_t a2 = k - c[5] * b[2] - c[3] * b[4] + c[1] * b[6];
    int64_t a3 = k - c[1] * b[2] + c[3] * b[4] - c[5] * b[6];
    int64_t b0 = c[0] * b[1] + c[2] * b[3] + c[4] * b[5] + c[6] * b[7];
    int64_t b1 = c[2] * b[1] - c[6] * b[3] - c[0] * b[5] - c[4] * b[7];
    int64_t b2 = c[4] * b[1] - c[0] * b[3] + c[6] * b[5] + c[2] * b[7];
    int64_t b3 = c[6] * b[1] - c[4] * b[3] + c[2] * b[5] - c[0] * b[7];
    int64_t o[8] = {a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0};
    for (int j = 0; j < 8; j++) x[8 * r + j] = wrap16(wrap32(o[j]) >> 11);
  }
  const int64_t TAN1 = 0x32EC, TAN2 = 0x6A0A, TAN3 = 0xAB0E, SQRT2 = 0x5A82;
  auto mult = [](int64_t c, int64_t v) { return (int64_t)(wrap32(c * v) >> 16); };
  for (int j = 0; j < 8; j++) {
    const int64_t* i = x + j;
    int64_t m0 = mult(TAN1, i[56]) + i[8];
    int64_t m1 = mult(TAN1, i[8]) - i[56];
    int64_t m2 = mult(TAN3, i[40]) + i[24];
    int64_t m3 = mult(TAN3, i[24]) - i[40];
    int64_t m7 = m0 + m2, m4 = m1 - m3;
    m0 = m0 - m2;
    m1 = m1 + m3;
    int64_t m6 = 2 * mult(SQRT2, m0 + m1), m5 = 2 * mult(SQRT2, m0 - m1);
    m3 = mult(TAN2, i[48]) + i[16];
    m2 = mult(TAN2, i[16]) - i[48];
    int64_t e0 = i[0] + i[32], e1 = i[0] - i[32];
    int64_t t = e0 + m3;
    m3 = e0 - m3;
    e0 = t;
    int64_t o[8];
    o[0] = e0 + m7; o[7] = e0 - m7;
    o[3] = m3 + m4; o[4] = m3 - m4;
    t = e1 + m2;
    m2 = e1 - m2;
    e1 = t;
    o[1] = e1 + m6; o[6] = e1 - m6;
    o[2] = m2 + m5; o[5] = m2 - m5;
    for (int r = 0; r < 8; r++) out[8 * r + j] = wrap16(wrap32(o[r]) >> 6);
  }
}

// half-pel prediction of a size x size block at full-pel (x0, y0) of a
// plane of stride `stride`, its coordinates clamped to [0, ew) x [0, eh);
// `narrow`: FFmpeg's 8-wide no-rounding x2 and y2 averages on x86, pavgb
// with the left pixel, or the one on an odd row, less one (mpeg4.half_pel)
void half_pel(const uint8_t* ref, int stride, int ew, int eh, int x0, int y0, int hx, int hy,
              int size, int rounding, int32_t* out, bool narrow = false) {
  int p[17 * 17];
  int n = size + 1;
  for (int j = 0; j < n; j++) {
    const uint8_t* row = ref + (int64_t)clampi(y0 + j, 0, eh - 1) * stride;
    for (int i = 0; i < n; i++) p[j * n + i] = row[clampi(x0 + i, 0, ew - 1)];
  }
  int rnd = 1 - rounding;
  for (int j = 0; j < size; j++)
    for (int i = 0; i < size; i++) {
      int a = p[j * n + i], b = p[j * n + i + 1], c = p[(j + 1) * n + i], d = p[(j + 1) * n + i + 1];
      int v;
      if (hx && hy) v = (a + b + c + d + 1 + rnd) >> 2;
      else if (hx) v = (rounding && narrow) ? (std::max(a - 1, 0) + b + 1) >> 1 : (a + b + rnd) >> 1;
      else if (hy) {
        if (rounding && narrow) {
          if (j & 1) a = std::max(a - 1, 0);
          else c = std::max(c - 1, 0);
          v = (a + c + 1) >> 1;
        } else {
          v = (a + c + rnd) >> 1;
        }
      } else v = a;
      out[j * size + i] = v;
    }
}

// MPEG-4's 8-tap filter over size + 1 samples at stride `step`, mirrored at
// the block's edges, into `size` outputs at stride `dstep` (mpeg4._lowpass)
void lowpass(const int* src, int step, int size, int rounding, int* dst, int dstep) {
  auto s = [&](int k) {
    int kk = k < 0 ? -k - 1 : k > size ? 2 * size + 1 - k : k;
    return src[kk * step];
  };
  for (int i = 0; i < size; i++) {
    int v = 20 * (s(i) + s(i + 1)) - 6 * (s(i - 1) + s(i + 2)) + 3 * (s(i - 2) + s(i + 3)) -
            (s(i - 3) + s(i + 4));
    dst[i * dstep] = clip8((v + 16 - rounding) >> 5);
  }
}

// quarter-pel prediction of a size x size block (mpeg4.qpel): the
// horizontal stage over size + 1 rows, then the vertical one
void qpel(const uint8_t* ref, int stride, int ew, int eh, int x0, int y0, int fx, int fy, int size,
          int rounding, int32_t* out) {
  int n = size + 1;
  int p[17 * 17], hl[17 * 16], h[17 * 16], vl[16 * 16];
  for (int j = 0; j < n; j++) {
    const uint8_t* row = ref + (int64_t)clampi(y0 + j, 0, eh - 1) * stride;
    for (int i = 0; i < n; i++) p[j * n + i] = row[clampi(x0 + i, 0, ew - 1)];
  }
  int rnd = 1 - rounding;
  for (int j = 0; j < n; j++) {
    lowpass(p + j * n, 1, size, rounding, hl + j * size, 1);
    for (int i = 0; i < size; i++) {
      int f = p[j * n + i], f1 = p[j * n + i + 1], l = hl[j * size + i];
      h[j * size + i] =
          fx == 0 ? f : fx == 1 ? (f + l + rnd) >> 1 : fx == 2 ? l : (f1 + l + rnd) >> 1;
    }
  }
  for (int i = 0; i < size; i++) lowpass(h + i, size, size, rounding, vl + i, size);
  for (int j = 0; j < size; j++)
    for (int i = 0; i < size; i++) {
      int t = h[j * size + i], b = h[(j + 1) * size + i], l = vl[j * size + i];
      out[j * size + i] =
          fy == 0 ? t : fy == 1 ? (t + l + rnd) >> 1 : fy == 2 ? l : (b + l + rnd) >> 1;
    }
}

inline int chroma_4mv(int v) {
  static const int tab[16] = {0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2};
  return tab[v & 15] + ((v >> 3) & ~1);
}

struct Decoder {
  const int32_t* part[T_COUNT];
  int mb_w, mb_h, ctype, fcode, rounding, dc_thr, resync, time_bits, edge_w, edge_h, width,
      height, bcode, quant_type, qpel_on, partitioned, idct, bugs, pp_time, pb_time;
  // padded predictor arrays, as data/mpeg4.py lays them out
  std::vector<int32_t> dc[3], ac[3], mv, qtab;
  int dcw[3], dch[3];
  int resync_x = 0, resync_y = 0;
  bool first_line = true;

  int32_t& DC(int p, int y, int x) { return dc[p][y * dcw[p] + x]; }
  int32_t* AC(int p, int y, int x) { return &ac[p][(y * dcw[p] + x) * 16]; }
  int* MV(int y, int x) { return &mv[(y * (2 * mb_w + 2) + x) * 2]; }

  void init(const int32_t* prm, const int32_t* tables) {
    for (int i = 0; i < T_COUNT; i++) part[i] = tables + tables[i];
    mb_w = prm[P_MB_W]; mb_h = prm[P_MB_H]; ctype = prm[P_TYPE]; fcode = prm[P_FCODE];
    rounding = prm[P_ROUNDING]; dc_thr = prm[P_DC_THR]; resync = prm[P_RESYNC];
    time_bits = prm[P_TIME_BITS]; edge_w = prm[P_EDGE_W]; edge_h = prm[P_EDGE_H];
    width = prm[P_WIDTH]; height = prm[P_HEIGHT]; bcode = prm[P_BCODE];
    quant_type = prm[P_QUANT_TYPE]; qpel_on = prm[P_QPEL]; partitioned = prm[P_PARTITIONED];
    idct = prm[P_IDCT]; bugs = prm[P_BUGS]; pp_time = prm[P_PP_TIME]; pb_time = prm[P_PB_TIME];
    dcw[0] = 2 * mb_w + 1; dch[0] = 2 * mb_h + 1;
    dcw[1] = dcw[2] = mb_w + 1; dch[1] = dch[2] = mb_h + 1;
    for (int p = 0; p < 3; p++) {
      dc[p].assign((size_t)dcw[p] * dch[p], 1024);
      ac[p].assign((size_t)dcw[p] * dch[p] * 16, 0);
    }
    mv.assign((size_t)(2 * mb_h + 1) * (2 * mb_w + 2) * 2, 0);
    qtab.assign((size_t)mb_w * mb_h, 0);
  }

  static void block_pos(int n, int mb_x, int mb_y, int* bx, int* by) {
    if (n < 4) { *bx = 2 * mb_x + (n & 1); *by = 2 * mb_y + (n >> 1); }
    else { *bx = mb_x; *by = mb_y; }
  }

  // ff_h263_pred_motion, with its write of the left macroblock's vector
  void pred_motion(int row, int col, int block, int mb_x, int* px, int* py) {
    int y = row + 1 + (block >> 1), x = col + 1 + (block & 1);
    int* a = MV(y, x - 1);
    int ax = a[0], ay = a[1];
    if (first_line && block < 3) {
      if (block == 0) {
        if (mb_x == resync_x) { *px = *py = 0; return; }
        if (mb_x + 1 == resync_x) {
          int* c = MV(y - 1, x + 2);
          if (mb_x == 0) { *px = c[0]; *py = c[1]; return; }
          *px = median(ax, 0, c[0]); *py = median(ay, 0, c[1]); return;
        }
        *px = ax; *py = ay; return;
      }
      if (block == 1) {
        if (mb_x + 1 == resync_x) {
          int* c = MV(y - 1, x + 1);
          *px = median(ax, 0, c[0]); *py = median(ay, 0, c[1]); return;
        }
        *px = ax; *py = ay; return;
      }
      int* b = MV(y - 1, x);
      int* c = MV(y - 1, x + 1);
      if (mb_x == resync_x) { a[0] = a[1] = 0; ax = ay = 0; }
      *px = median(ax, b[0], c[0]); *py = median(ay, b[1], c[1]);
      return;
    }
    static const int off[4] = {2, 1, 1, -1};
    int* b = MV(y - 1, x);
    int* c = MV(y - 1, x + off[block]);
    *px = median(ax, b[0], c[0]); *py = median(ay, b[1], c[1]);
  }

  int decode_motion(Bits& r, int pred, int code_bits) {
    int code = r.vlc(part[T_MVD]);
    if (code == 0) return pred;
    int sign = r.bits(1);
    int shift = code_bits - 1;
    int val = code;
    if (shift) val = (((val - 1) << shift) | (int)r.bits(shift)) + 1;
    if (sign) val = -val;
    val += pred;
    int bits = 5 + code_bits;
    val &= (1 << bits) - 1;
    return (val >> (bits - 1)) ? val - (1 << bits) : val;
  }

  // TCOEF from scan position i + 1; inter levels inverse-quantised as read
  int tcoef(Bits& r, int16_t* block, const int32_t* scan, int i, int intra, int qmul, int qadd) {
    const int32_t* table = part[intra ? T_TCOEF_INTRA : T_TCOEF_INTER];
    const int32_t* runs = part[intra ? T_RUN_INTRA : T_RUN_INTER];
    const int32_t* levels = part[intra ? T_LEVEL_INTRA : T_LEVEL_INTER];
    const int32_t* lmax = part[intra ? T_LMAX_INTRA : T_LMAX_INTER];
    const int32_t* rmax = part[intra ? T_RMAX_INTRA : T_RMAX_INTER];
    int last_from = LAST_FROM[intra];
    for (;;) {
      int code = r.vlc(table);
      if (r.err) return r.err;
      int last, run, level, sign;
      bool clip = false;
      if (code == ESCAPE) {
        if (!r.bits(1)) {
          code = r.vlc(table);
          last = code >= last_from;
          run = runs[code];
          level = levels[code] + lmax[last * 64 + run];
          sign = r.bits(1);
        } else if (!r.bits(1)) {
          code = r.vlc(table);
          last = code >= last_from;
          level = levels[code];
          run = runs[code] + rmax[last * 64 + level] + 1;
          sign = r.bits(1);
        } else {
          last = r.bits(1);
          run = r.bits(6);
          r.bits(1);
          level = r.signed_bits(12);
          r.bits(1);
          sign = level < 0;
          level = std::abs(level);
          clip = true;
        }
        if (r.err) return r.err;
      } else {
        last = code >= last_from;
        run = runs[code];
        level = levels[code];
        sign = r.bits(1);
      }
      if (qmul != 1 || qadd) level = level * qmul + qadd;
      if (sign) level = -level;
      if (clip) level = clampi(level, -2048, 2047);
      i += run + 1;
      if (i > 63) return ERR_COEFS;
      block[scan[i]] = wrap16(level);
      if (last) return 0;
    }
  }

  int pred_dc(int n, int bx, int by, int level, int mb_x, int mb_y, int scale, int* dir) {
    int p = n < 4 ? 0 : n - 3;
    int a = DC(p, by + 1, bx), b = DC(p, by, bx), c = DC(p, by, bx + 1);
    if (first_line && n != 3) {
      if (n != 2) b = c = 1024;
      if (n != 1 && mb_x == resync_x) b = a = 1024;
    }
    if (mb_x == resync_x && mb_y == resync_y + 1 && (n == 0 || n == 4 || n == 5)) b = 1024;
    int pred;
    if (std::abs(a - b) < std::abs(b - c)) { pred = c; *dir = 1; }
    else { pred = a; *dir = 0; }
    pred = (pred + (scale >> 1)) / scale;
    level += pred;
    int stored = level * scale;
    if (stored & ~2047) stored = stored < 0 ? 0 : (bugs & BUG_DC_CLIP) ? stored : 2047;
    DC(p, by + 1, bx + 1) = stored;
    return level;
  }

  void pred_ac(int16_t* block, int n, int bx, int by, int dir, int ac_pred, int mb_x, int mb_y,
               int qscale) {
    int p = n < 4 ? 0 : n - 3;
    if (ac_pred) {
      if (dir == 0) {
        int32_t* pred = AC(p, by + 1, bx);
        int q = mb_x > 0 ? qtab[mb_y * mb_w + mb_x - 1] : qscale;
        bool same = mb_x == 0 || q == qscale || n == 1 || n == 3;
        for (int i = 1; i < 8; i++)
          block[i << 3] = wrap16(block[i << 3] + (same ? pred[i] : rounded_div(pred[i] * q, qscale)));
      } else {
        int32_t* pred = AC(p, by, bx + 1) + 8;
        int q = mb_y > 0 ? qtab[(mb_y - 1) * mb_w + mb_x] : qscale;
        bool same = mb_y == 0 || q == qscale || n == 2 || n == 3;
        for (int i = 1; i < 8; i++)
          block[i] = wrap16(block[i] + (same ? pred[i] : rounded_div(pred[i] * q, qscale)));
      }
    }
    int32_t* own = AC(p, by + 1, bx + 1);
    for (int i = 1; i < 8; i++) {
      own[i] = block[i << 3];
      own[8 + i] = block[i];
    }
  }

  void clean_intra(int mb_x, int mb_y) {
    for (int n = 0; n < 6; n++) {
      int bx, by;
      block_pos(n, mb_x, mb_y, &bx, &by);
      int p = n < 4 ? 0 : n - 3;
      DC(p, by + 1, bx + 1) = 1024;
      std::memset(AC(p, by + 1, bx + 1), 0, 16 * sizeof(int32_t));
    }
  }

  // ff_mpeg4_clean_buffers in FFmpeg's flat layout, mapped to ours
  void clean_buffers(int mb_x, int mb_y) {
    int lw = 2 * mb_w + 1, cw = mb_w + 1;
    for (int p = 0; p < 3; p++) {
      int w = p == 0 ? lw : cw;
      int s = p == 0 ? (2 * mb_y - 1) * lw + 2 * mb_x - 1 : (mb_y - 1) * cw + mb_x - 1;
      int n = p == 0 ? 2 * lw + 1 : cw + 1;
      for (int k = (s > -w - 1 ? s : -w - 1); k < s + n; k++) {
        int row = k >= 0 ? k / w : -((-k + w - 1) / w);
        int col = k - row * w;
        int r_, c_;
        if (col == w - 1) { r_ = row + 2; c_ = 0; }
        else { r_ = row + 1; c_ = col + 1; }
        if (r_ >= 0 && r_ < dch[p] && c_ >= 0 && c_ < dcw[p])
          std::memset(AC(p, r_, c_), 0, 16 * sizeof(int32_t));
      }
    }
  }

  int prefix() const {
    if (ctype == I_VOP) return 16;
    if (ctype == B_VOP) return std::max(std::max(fcode, bcode), 2) + 15;
    return 15 + fcode;
  }

  bool is_resync(Bits& r, int prefix_len) {
    int64_t pos = r.pos;
    int stuffing = 8 - (int)(pos & 7);
    if (pos + stuffing + 17 > r.size) return false;
    if (r.peek(stuffing) != (1u << (stuffing - 1)) - 1) return false;
    r.pos = pos + stuffing;
    bool ok = r.peek(prefix_len + 1) == 1;
    r.pos = pos;
    return ok;
  }

  int packet_header(Bits& r, int n_mb, int* mb_num, int* quant) {
    r.bits(1);
    r.align();
    while (!r.bits(1))
      if (r.err) return r.err;
    int nbits = 0;
    while ((1 << nbits) < n_mb) nbits++;
    *mb_num = r.bits(nbits);
    if (*mb_num == 0 || *mb_num >= n_mb) return ERR_PACKET;
    *quant = r.bits(5);
    if (r.bits(1)) {
      while (r.bits(1))
        if (r.err) return r.err;
      r.bits(1);
      r.bits(time_bits);
      r.bits(1);
      r.bits(2);
      r.bits(3);
      if (ctype != I_VOP) r.bits(3);
      if (ctype == B_VOP) r.bits(3);
    }
    return r.err;
  }

  // the intra DC by its VLC, predicted; returns the level
  int intra_dc(Bits& r, int n, int mb_x, int mb_y, int qscale, int* dir) {
    int size = r.vlc(part[n < 4 ? T_DC_LUMA : T_DC_CHROMA]);
    int diff = 0;
    if (size) {
      int code = r.bits(size);
      diff = (code >> (size - 1)) ? code : code - (1 << size) + 1;
      if (size > 8) r.bits(1);
    }
    int bx, by;
    block_pos(n, mb_x, mb_y, &bx, &by);
    return pred_dc(n, bx, by, diff, mb_x, mb_y, part[T_DC_SCALE][(n < 4 ? 0 : 32) + qscale], dir);
  }

  // an intra macroblock's six blocks; `dcs`/`dirs`: a data partition's
  // stored DCs and directions, or null
  int intra_blocks(Bits& r, int16_t blocks[6][64], int mb_x, int mb_y, int qscale, int cbp,
                   int ac_pred, bool use_dc_vlc, const int* dcs, const int* dirs) {
    const int32_t* scans = part[T_SCANS];
    const int32_t* dc_scale = part[T_DC_SCALE];
    for (int n = 0; n < 6; n++) {
      int16_t* block = blocks[n];
      int scale = dc_scale[(n < 4 ? 0 : 32) + qscale];
      int bx, by, dir, start;
      block_pos(n, mb_x, mb_y, &bx, &by);
      if (dcs) {
        block[0] = wrap16((dcs[n] + (scale >> 1)) / scale);
        dir = dirs[n];
        start = 0;
      } else if (use_dc_vlc) {
        block[0] = wrap16(intra_dc(r, n, mb_x, mb_y, qscale, &dir));
        if (r.err) return r.err;
        start = 0;
      } else {
        pred_dc(n, bx, by, 0, mb_x, mb_y, scale, &dir);
        start = -1;
      }
      const int32_t* scan = scans + 64 * (!ac_pred ? 0 : dir == 0 ? 2 : 1);
      if (cbp & (32 >> n)) {
        int e = tcoef(r, block, scan, start, 1, 1, 0);
        if (e) return e;
      }
      if (!dcs && !use_dc_vlc)
        block[0] = wrap16(pred_dc(n, bx, by, block[0], mb_x, mb_y, scale, &dir));
      pred_ac(block, n, bx, by, dir, ac_pred, mb_x, mb_y, qscale);
    }
    return 0;
  }

  int inter_blocks(Bits& r, int16_t blocks[6][64], bool coded[6], int cbp, int qscale) {
    int qmul = quant_type ? 1 : 2 * qscale, qadd = quant_type ? 0 : (qscale - 1) | 1;
    for (int n = 0; n < 6; n++)
      if (cbp & (32 >> n)) {
        coded[n] = true;
        int e = tcoef(r, blocks[n], part[T_SCANS], -1, 0, qmul, qadd);
        if (e) return e;
      }
    return 0;
  }
};

// ff_mpeg4_set_direct_mv: a direct macroblock's forward and backward vectors
void direct_vectors(bool col_four, const int32_t* col_mv, int dx, int dy, int pp, int pb,
                    int vec[2][4][2]) {
  for (int i = 0; i < (col_four ? 4 : 1); i++) {
    int d[2] = {dx, dy};
    for (int c = 0; c < 2; c++) {
      int p = col_mv[i * 2 + c];
      vec[0][i][c] = p * pb / pp + d[c];
      vec[1][i][c] = d[c] ? vec[0][i][c] - p : p * (pb - pp) / pp;
    }
  }
  if (!col_four)
    for (int i = 1; i < 4; i++)
      for (int c = 0; c < 2; c++) { vec[0][i][c] = vec[0][0][c]; vec[1][i][c] = vec[1][0][c]; }
}

// one direction's prediction of a macroblock (mpeg4._predict): luma as
// four 8x8 blocks (pred[0..3]), chroma pred[4], pred[5]
void predict_dir(const Decoder& d, bool four, const int vec[4][2], int mb_x, int mb_y,
                 const uint8_t* const refs[3], int rounding, int32_t pred[6][64]) {
  int ys = 16 * d.mb_w, cs = 8 * d.mb_w;
  int shift = d.qpel_on ? 2 : 1, mask = d.qpel_on ? 3 : 1;
  if (d.qpel_on && !four) {
    int32_t big[256];
    int mx = vec[0][0], my = vec[0][1];
    qpel(refs[0], ys, d.edge_w, d.edge_h, mb_x * 16 + (mx >> 2), mb_y * 16 + (my >> 2), mx & 3,
         my & 3, 16, rounding, big);
    for (int k = 0; k < 4; k++)
      for (int j = 0; j < 8; j++)
        for (int i = 0; i < 8; i++)
          pred[k][j * 8 + i] = big[((k >> 1) * 8 + j) * 16 + (k & 1) * 8 + i];
  } else {
    for (int k = 0; k < 4; k++) {
      int mx = vec[k][0], my = vec[k][1];
      int x = mb_x * 16 + (k & 1) * 8 + (mx >> shift), y = mb_y * 16 + (k >> 1) * 8 + (my >> shift);
      int fx = mx & mask, fy = my & mask;
      if (four) {
        x = clampi(x, -16, d.width);
        y = clampi(y, -16, d.height);
        if (x == d.width) fx = 0;
        if (y == d.height) fy = 0;
      }
      if (d.qpel_on) qpel(refs[0], ys, d.edge_w, d.edge_h, x, y, fx, fy, 8, rounding, pred[k]);
      else half_pel(refs[0], ys, d.edge_w, d.edge_h, x, y, fx, fy, 8, rounding, pred[k], four);
    }
  }
  int ux, uy, hx, hy;
  if (four) {
    int sx = 0, sy = 0;
    for (int k = 0; k < 4; k++) {
      sx += d.qpel_on ? half(vec[k][0]) : vec[k][0];
      sy += d.qpel_on ? half(vec[k][1]) : vec[k][1];
    }
    int cx = chroma_4mv(sx), cy = chroma_4mv(sy);
    ux = clampi(mb_x * 8 + (cx >> 1), -8, d.width >> 1);
    uy = clampi(mb_y * 8 + (cy >> 1), -8, d.height >> 1);
    hx = (ux == (d.width >> 1)) ? 0 : cx & 1;
    hy = (uy == (d.height >> 1)) ? 0 : cy & 1;
  } else if (d.qpel_on) {
    static const int rtab[8] = {0, 0, 1, 1, 0, 0, 0, 1};
    int mx = vec[0][0], my = vec[0][1], cx, cy;
    if (d.bugs & BUG_QPEL_CHROMA2) { cx = (mx >> 1) + rtab[mx & 7]; cy = (my >> 1) + rtab[my & 7]; }
    else if (d.bugs & BUG_QPEL_CHROMA) { cx = (mx >> 1) | (mx & 1); cy = (my >> 1) | (my & 1); }
    else { cx = half(mx); cy = half(my); }
    cx = (cx >> 1) | (cx & 1);
    cy = (cy >> 1) | (cy & 1);
    ux = mb_x * 8 + (cx >> 1);
    uy = mb_y * 8 + (cy >> 1);
    hx = cx & 1;
    hy = cy & 1;
  } else {
    int cx = vec[0][0], cy = vec[0][1];
    ux = (mb_x * 16 + (cx >> 1)) >> 1;
    uy = (mb_y * 16 + (cy >> 1)) >> 1;
    hx = (cx & 1) | ((cx & 2) >> 1);
    hy = (cy & 1) | ((cy & 2) >> 1);
  }
  for (int p = 1; p < 3; p++)
    half_pel(refs[p], cs, d.edge_w >> 1, d.edge_h >> 1, ux, uy, hx, hy, 8, rounding, pred[3 + p],
             true);
}

// one macroblock's pixels: intra blocks inverse-quantised (H.263, or MPEG
// quantisation with `matrices`) and put, inter ones (MPEG quantisation's
// inverse-quantised here, with its mismatch control) added to the
// prediction of direction 1 (forward), 2 (backward) or both (averaged)
void reconstruct_mb(const Decoder& d, int kind, int dirs, int qscale, int16_t blocks[6][64],
                    const bool coded[6], const int vec[2][4][2], int mb_x, int mb_y,
                    const uint8_t* const past[3], const uint8_t* const fut[3],
                    const int32_t* matrices, uint8_t* const outs[3]) {
  const int32_t* dc_scale = d.part[T_DC_SCALE];
  int ys = 16 * d.mb_w, cs = 8 * d.mb_w;
  int32_t pred[6][64];
  if (kind != MB_INTRA) {
    bool four = kind == MB_INTER4V;
    if (dirs & 1) predict_dir(d, four, vec[0], mb_x, mb_y, past, d.rounding, pred);
    if (dirs & 2) {
      if (dirs & 1) {
        int32_t back[6][64];
        predict_dir(d, four, vec[1], mb_x, mb_y, fut, d.rounding, back);
        for (int n = 0; n < 6; n++)
          for (int i = 0; i < 64; i++) pred[n][i] = (pred[n][i] + back[n][i] + 1) >> 1;
      } else {
        predict_dir(d, four, vec[1], mb_x, mb_y, fut, d.rounding, pred);
      }
    }
    if (d.quant_type) {
      for (int n = 0; n < 6; n++) {
        if (!coded[n]) continue;
        int16_t* b = blocks[n];
        int odd = 0;
        for (int i = 0; i < 64; i++) {
          if (!b[i]) continue;
          int q = (2 * qscale * matrices[64 + i]) & 0xFFFF;
          int mag = (((2 * std::abs((int)b[i]) + 1) * q) & 0xFFFF) >> 5;
          b[i] = wrap16(b[i] < 0 ? -mag : mag);
          odd ^= b[i] & 1;
        }
        b[63] = (int16_t)(b[63] ^ (1 - odd));
      }
    }
  } else {
    for (int n = 0; n < 6; n++) {
      int16_t* b = blocks[n];
      if (d.quant_type) {
        for (int i = 1; i < 64; i++) {
          if (!b[i]) continue;
          int q = (2 * qscale * matrices[i]) & 0xFFFF;
          int mag = (int16_t)(uint16_t)((std::abs((int)b[i]) * q) & 0xFFFF) >> 4;
          b[i] = wrap16(b[i] < 0 ? -mag : mag);
        }
      } else {
        int qmul = 2 * qscale, qadd = (qscale - 1) | 1;
        for (int i = 1; i < 64; i++)
          if (b[i]) b[i] = wrap16(b[i] < 0 ? b[i] * qmul - qadd : b[i] * qmul + qadd);
      }
      b[0] = wrap16(b[0] * dc_scale[(n < 4 ? 0 : 32) + qscale]);
      std::memset(pred[n], 0, sizeof(pred[n]));
    }
  }
  for (int n = 0; n < 6; n++) {
    int32_t res[64];
    if (coded[n]) {
      if (d.idct) xvid_idct(blocks[n], res);
      else simple_idct(blocks[n], res);
    } else {
      std::memset(res, 0, sizeof(res));
    }
    uint8_t* dst;
    int stride;
    if (n < 4) {
      stride = ys;
      dst = outs[0] + (int64_t)(mb_y * 16 + (n >> 1) * 8) * ys + mb_x * 16 + (n & 1) * 8;
    } else {
      stride = cs;
      dst = outs[n - 3] + (int64_t)(mb_y * 8) * cs + mb_x * 8;
    }
    for (int j = 0; j < 8; j++)
      for (int i = 0; i < 8; i++) dst[j * stride + i] = clip8(pred[n][j * 8 + i] + res[j * 8 + i]);
  }
}

// the decoded macroblocks of one VOP, reconstructed as they are parsed
struct Vop {
  Decoder& d;
  const uint8_t* const* past;
  const uint8_t* const* fut;
  const int32_t* matrices;
  uint8_t* const* outs;
  int32_t* out_kinds;

  int put(int mb, int kind, int dirs, int qscale, int16_t blocks[6][64], const bool coded[6],
          const int vec[2][4][2]) {
    int mb_x = mb % d.mb_w, mb_y = mb / d.mb_w;
    if ((dirs & 1) && !past[0]) return ERR_REF;
    if ((dirs & 2) && !fut[0]) return ERR_REF;
    reconstruct_mb(d, kind, dirs, qscale, blocks, coded, vec, mb_x, mb_y, past, fut, matrices,
                   outs);
    out_kinds[mb] = kind;
    return 0;
  }
};

// an I- or P-VOP with data partitioning (mpeg4._parse_partitioned)
int64_t decode_partitioned(Decoder& d, Bits& r, Vop& v, int qscale) {
  int mb_w = d.mb_w, n_mb = d.mb_w * d.mb_h;
  std::vector<int> cbpc(n_mb), cbps(n_mb), ac_preds(n_mb), kinds(n_mb), quants(n_mb);
  std::vector<int> dcs(n_mb * 6), dirs(n_mb * 6);
  std::vector<int> vecs(n_mb * 8);
  int start = 0;
  for (;;) {
    int mb = start;
    d.first_line = true;
    while (mb < n_mb) {
      int mb_y = mb / mb_w, mb_x = mb % mb_w;
      if (mb_x == d.resync_x && mb_y == d.resync_y + 1) d.first_line = false;
      int row = 2 * mb_y, col = 2 * mb_x;
      if (d.ctype == I_VOP) {
        bool marker = false;
        int c = 0;
        for (;;) {
          if (r.peek(19) == DC_MARKER) { marker = true; break; }
          c = r.vlc(d.part[T_INTRA_MCBPC]);
          if (r.err) return r.err;
          if (c != INTRA_DC_STUFF) break;
        }
        if (marker) break;
        kinds[mb] = MB_INTRA;
        if (c & 4) qscale = clampi(qscale + DQUANT[r.bits(2)], 1, 31);
        d.qtab[mb] = quants[mb] = qscale;
        for (int n = 0; n < 6; n++) {
          int bx, by;
          d.intra_dc(r, n, mb_x, mb_y, qscale, &dirs[mb * 6 + n]);
          Decoder::block_pos(n, mb_x, mb_y, &bx, &by);
          dcs[mb * 6 + n] = d.DC(n < 4 ? 0 : n - 3, by + 1, bx + 1);
        }
        if (r.err) return r.err;
        cbpc[mb] = c;
      } else {
        bool marker = false, skipped = false;
        int c = 0;
        for (;;) {
          if (r.peek(17) == MOTION_MARKER) { marker = true; break; }
          if (r.bits(1)) { skipped = true; break; }
          c = r.vlc(d.part[T_INTER_MCBPC]);
          if (r.err) return r.err;
          if (c != INTER_STUFF) break;
        }
        if (marker) break;
        for (int k = 0; k < 8; k++) vecs[mb * 8 + k] = 0;
        if (skipped) {
          kinds[mb] = MB_SKIPPED;
          for (int j = 0; j < 2; j++)
            for (int i = 0; i < 2; i++) { int* m = d.MV(row + 1 + j, col + 1 + i); m[0] = m[1] = 0; }
          d.clean_intra(mb_x, mb_y);
        } else if (c & 4) {
          kinds[mb] = MB_INTRA;
          for (int j = 0; j < 2; j++)
            for (int i = 0; i < 2; i++) { int* m = d.MV(row + 1 + j, col + 1 + i); m[0] = m[1] = 0; }
        } else {
          bool four = c & 16;
          kinds[mb] = four ? MB_INTER4V : MB_INTER;
          d.clean_intra(mb_x, mb_y);
          for (int i = 0; i < (four ? 4 : 1); i++) {
            int px, py;
            d.pred_motion(row, col, i, mb_x, &px, &py);
            int mx = d.decode_motion(r, px, d.fcode);
            int my = d.decode_motion(r, py, d.fcode);
            if (r.err) return r.err;
            if (four) {
              int* m = d.MV(row + 1 + (i >> 1), col + 1 + (i & 1));
              m[0] = mx; m[1] = my;
            } else {
              for (int j = 0; j < 2; j++)
                for (int k = 0; k < 2; k++) { int* m = d.MV(row + 1 + j, col + 1 + k); m[0] = mx; m[1] = my; }
            }
          }
          for (int i = 0; i < 4; i++) {
            int* m = d.MV(row + 1 + (i >> 1), col + 1 + (i & 1));
            vecs[mb * 8 + 2 * i] = m[0];
            vecs[mb * 8 + 2 * i + 1] = m[1];
          }
        }
        cbpc[mb] = c;
      }
      mb++;
    }
    int count = mb - start;
    if (count == 0) return ERR_PACKET;
    if (d.ctype == I_VOP) {
      while (r.peek(9) == 1) r.bits(9);
      if (r.bits(19) != DC_MARKER) return ERR_MARKER;
    } else {
      while (r.peek(10) == 1) r.bits(10);
      if (r.bits(17) != MOTION_MARKER) return ERR_MARKER;
    }
    d.first_line = true;
    for (int k = 0; k < count; k++) {
      int m = start + k, mb_y = m / mb_w, mb_x = m % mb_w;
      if (mb_x == d.resync_x && mb_y == d.resync_y + 1) d.first_line = false;
      int c = cbpc[m];
      if (d.ctype == I_VOP) {
        ac_preds[m] = r.bits(1);
        cbps[m] = (c & 3) | (r.vlc(d.part[T_CBPY]) << 2);
      } else if (kinds[m] == MB_INTRA) {
        ac_preds[m] = r.bits(1);
        int cbpy = r.vlc(d.part[T_CBPY]);
        if (c & 8) qscale = clampi(qscale + DQUANT[r.bits(2)], 1, 31);
        d.qtab[m] = quants[m] = qscale;
        for (int n = 0; n < 6; n++) {
          int bx, by;
          d.intra_dc(r, n, mb_x, mb_y, qscale, &dirs[m * 6 + n]);
          Decoder::block_pos(n, mb_x, mb_y, &bx, &by);
          dcs[m * 6 + n] = d.DC(n < 4 ? 0 : n - 3, by + 1, bx + 1);
        }
        cbps[m] = (c & 3) | (cbpy << 2);
      } else if (kinds[m] == MB_SKIPPED) {
        d.qtab[m] = quants[m] = qscale;
        ac_preds[m] = 0;
        cbps[m] = 0;
      } else {
        int cbpy = r.vlc(d.part[T_CBPY]);
        if (c & 8) qscale = clampi(qscale + DQUANT[r.bits(2)], 1, 31);
        d.qtab[m] = quants[m] = qscale;
        ac_preds[m] = 0;
        cbps[m] = (c & 3) | ((cbpy ^ 15) << 2);
      }
      if (r.err) return r.err;
    }
    for (int k = 0; k < count; k++) {
      int m = start + k, mb_y = m / mb_w, mb_x = m % mb_w;
      int q = quants[m];
      int16_t blocks[6][64];
      std::memset(blocks, 0, sizeof(blocks));
      bool coded[6] = {false, false, false, false, false, false};
      int vec[2][4][2];
      std::memset(vec, 0, sizeof(vec));
      int dirs_mb = 0;
      if (kinds[m] == MB_INTRA) {
        if (!(q < d.dc_thr)) return ERR_DC_AMONG_AC;
        int e = d.intra_blocks(r, blocks, mb_x, mb_y, q, cbps[m], ac_preds[m], true, &dcs[m * 6],
                               &dirs[m * 6]);
        if (e) return e;
        for (int n = 0; n < 6; n++) coded[n] = true;
      } else {
        dirs_mb = 1;
        for (int i = 0; i < 4; i++) { vec[0][i][0] = vecs[m * 8 + 2 * i]; vec[0][i][1] = vecs[m * 8 + 2 * i + 1]; }
        if (kinds[m] != MB_SKIPPED) {
          int e = d.inter_blocks(r, blocks, coded, cbps[m], q);
          if (e) return e;
        }
      }
      int e = v.put(m, kinds[m], dirs_mb, q, blocks, coded, vec);
      if (e) return e;
    }
    start += count;
    if (start >= n_mb) return r.pos;
    if (!d.is_resync(r, d.prefix())) return ERR_PACKET;
    int mb_num, q;
    int e = d.packet_header(r, n_mb, &mb_num, &q);
    if (e) return e;
    if (mb_num != start) return ERR_PACKET;
    if (q) qscale = q;
    d.resync_y = mb_num / mb_w;
    d.resync_x = mb_num % mb_w;
    d.clean_buffers(d.resync_x, d.resync_y);
  }
}

}  // namespace

namespace {

// ------------------------------------------------------------ the writer

struct Writer {
  uint8_t* out;
  int64_t cap, len;
  uint64_t acc;
  int n;
  bool overflow = false;
  void put(int nbits, uint32_t value) {
    if (nbits == 0) return;
    acc = (acc << nbits) | (value & ((nbits == 32) ? 0xFFFFFFFFu : ((1u << nbits) - 1)));
    n += nbits;
    while (n >= 8) {
      n -= 8;
      if (len < cap) out[len] = (uint8_t)((acc >> n) & 0xFF);
      else overflow = true;
      len++;
    }
    acc &= (1ull << n) - 1;
  }
  void code(const int32_t* pair) { put(pair[1], (uint32_t)pair[0]); }
  void stuffing() {
    put(1, 0);
    if (n) put(8 - n, (1u << (8 - n)) - 1);
  }
};

// jpeg_fdct_islow of an 8x8 block (rows, then columns): eight times the DCT
void fdct_islow(const int64_t* in, int64_t* out) {
  static const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                       F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069,
                       F2053 = 16819, F2562 = 20995, F3072 = 25172;
  const int CB = 13, P1 = 2;
  int64_t tmp[64];
  for (int pass = 0; pass < 2; pass++) {
    const int64_t* src = pass == 0 ? in : tmp;
    int64_t* dst = pass == 0 ? tmp : out;
    int shift = pass == 0 ? CB - P1 : CB + P1;
    auto descale = [](int64_t x, int nb) { return (x + (1ll << (nb - 1))) >> nb; };
    for (int k = 0; k < 8; k++) {
      int64_t s[8];
      // pass 0 along rows (last axis), pass 1 along columns
      for (int i = 0; i < 8; i++) s[i] = pass == 0 ? src[k * 8 + i] : src[i * 8 + k];
      int64_t t0 = s[0] + s[7], t7 = s[0] - s[7], t1 = s[1] + s[6], t6 = s[1] - s[6];
      int64_t t2 = s[2] + s[5], t5 = s[2] - s[5], t3 = s[3] + s[4], t4 = s[3] - s[4];
      int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
      int64_t o[8];
      if (pass == 0) {
        o[0] = (t10 + t11) * (1 << P1);
        o[4] = (t10 - t11) * (1 << P1);
      } else {
        o[0] = descale(t10 + t11, P1);
        o[4] = descale(t10 - t11, P1);
      }
      int64_t z1 = (t12 + t13) * F0541;
      o[2] = descale(z1 + t13 * F0765, shift);
      o[6] = descale(z1 - t12 * F1847, shift);
      z1 = t4 + t7;
      int64_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
      int64_t z5 = (z3 + z4) * F1175;
      t4 *= F0298; t5 *= F2053; t6 *= F3072; t7 *= F1501;
      z1 *= -F0899; z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      o[7] = descale(t4 + z1 + z3, shift);
      o[5] = descale(t5 + z2 + z4, shift);
      o[3] = descale(t6 + z2 + z3, shift);
      o[1] = descale(t7 + z1 + z4, shift);
      for (int i = 0; i < 8; i++) {
        if (pass == 0) dst[k * 8 + i] = o[i];
        else dst[i * 8 + k] = o[i];
      }
    }
  }
}

// the sum of absolute differences of the 16x16 block at (x, y) and its
// prediction by half-pel vector (mx, my); stops once it reaches `bound`
// (a cost that cannot win), which changes no choice of motion_search
int sad16(const uint8_t* cur, int stride, const uint8_t* ref, const Decoder& d, int x, int y,
          int mx, int my, int bound) {
  int x0 = x + (mx >> 1), y0 = y + (my >> 1), hx = mx & 1, hy = my & 1;
  int sum = 0;
  if (x0 >= 0 && y0 >= 0 && x0 + 17 <= d.edge_w && y0 + 17 <= d.edge_h) {
    // inside the plane: no clamping (half_pel's arithmetic, 16 wide: exact)
    int rnd = 1 - d.rounding;
    for (int j = 0; j < 16; j++) {
      const uint8_t* r0 = ref + (int64_t)(y0 + j) * stride + x0;
      const uint8_t* r1 = r0 + stride;
      const uint8_t* c = cur + (int64_t)(y + j) * stride + x;
      for (int i = 0; i < 16; i++) {
        int v;
        if (hx && hy) v = (r0[i] + r0[i + 1] + r1[i] + r1[i + 1] + 1 + rnd) >> 2;
        else if (hx) v = (r0[i] + r0[i + 1] + rnd) >> 1;
        else if (hy) v = (r0[i] + r1[i] + rnd) >> 1;
        else v = r0[i];
        sum += std::abs((int)c[i] - v);
      }
      if (sum >= bound) return sum;
    }
    return sum;
  }
  int32_t pred[256];
  half_pel(ref, stride, d.edge_w, d.edge_h, x0, y0, hx, hy, 16, d.rounding, pred);
  for (int j = 0; j < 16; j++)
    for (int i = 0; i < 16; i++) sum += std::abs((int)cur[(y + j) * stride + x + i] - pred[j * 16 + i]);
  return sum;
}

const int MV_MIN = -32, MV_MAX = 31, SEARCH_STEPS = 16;

void motion_search(const uint8_t* cur, const uint8_t* ref, const Decoder& d, int mb_x, int mb_y,
                   const int cand[4][2], int* out_x, int* out_y) {
  int stride = 16 * d.mb_w, x = 16 * mb_x, y = 16 * mb_y;
  int bx = 0, by = 0, best = -1;
  for (int c = 0; c < 4; c++) {
    int cx = clampi(cand[c][0], MV_MIN, MV_MAX) & ~1, cy = clampi(cand[c][1], MV_MIN, MV_MAX) & ~1;
    int cost = sad16(cur, stride, ref, d, x, y, cx, cy, best < 0 ? 1 << 30 : best);
    if (best < 0 || cost < best) { bx = cx; by = cy; best = cost; }
  }
  static const int diamond[4][2] = {{-2, 0}, {2, 0}, {0, -2}, {0, 2}};
  for (int step = 0; step < SEARCH_STEPS; step++) {
    bool moved = false;
    int sx = bx, sy = by;
    for (int k = 0; k < 4; k++) {
      int cx = sx + diamond[k][0], cy = sy + diamond[k][1];
      if (cx < MV_MIN || cx > MV_MAX || cy < MV_MIN || cy > MV_MAX) continue;
      int cost = sad16(cur, stride, ref, d, x, y, cx, cy, best);
      if (cost < best) { bx = cx; by = cy; best = cost; moved = true; }
    }
    if (!moved) break;
  }
  static const int half[8][2] = {{-1, -1}, {0, -1}, {1, -1}, {-1, 0}, {1, 0}, {-1, 1}, {0, 1}, {1, 1}};
  int sx = bx, sy = by;
  for (int k = 0; k < 8; k++) {
    int cx = sx + half[k][0], cy = sy + half[k][1];
    if (cx < MV_MIN || cx > MV_MAX || cy < MV_MIN || cy > MV_MAX) continue;
    int cost = sad16(cur, stride, ref, d, x, y, cx, cy, best);
    if (cost < best) { bx = cx; by = cy; best = cost; }
  }
  *out_x = bx;
  *out_y = by;
}


// the encoder's code tables (after the reader's parts): (code, length) pairs
// of each VLC, then (last, run, level < 64) -> TCOEF index maps
enum {
  E_INTRA_MCBPC = T_COUNT, E_INTER_MCBPC, E_CBPY, E_MVD, E_DC_LUMA, E_DC_CHROMA, E_TCOEF_INTER,
  E_TCOEF_INTRA, E_INDEX_INTER, E_INDEX_INTRA, E_COUNT
};

void put_tcoef(Writer& w, const int32_t* const* part, int intra, int last, int run, int level) {
  const int32_t* table = part[intra ? E_TCOEF_INTRA : E_TCOEF_INTER];
  const int32_t* index = part[intra ? E_INDEX_INTRA : E_INDEX_INTER];
  const int32_t* lmax = part[intra ? T_LMAX_INTRA : T_LMAX_INTER];
  const int32_t* rmax = part[intra ? T_RMAX_INTRA : T_RMAX_INTER];
  auto lookup = [&](int l, int r, int m) {
    if (r < 0 || r >= 64 || m <= 0 || m >= 64) return -1;
    return index[(l * 64 + r) * 64 + m];
  };
  int sign = level < 0, mag = std::abs(level);
  int k = lookup(last, run, mag);
  if (k >= 0) { w.code(table + 2 * k); w.put(1, sign); return; }
  int lm = run < 64 ? lmax[last * 64 + run] : 0;
  k = (lm && mag > lm) ? lookup(last, run, mag - lm) : -1;
  if (k >= 0) {
    w.code(table + 2 * ESCAPE); w.put(1, 0); w.code(table + 2 * k); w.put(1, sign);
    return;
  }
  int rm = mag < 64 ? rmax[last * 64 + mag] : -1;
  k = (mag > 0 && mag < 64 && run > rm) ? lookup(last, run - rm - 1, mag) : -1;
  if (k >= 0) {
    w.code(table + 2 * ESCAPE); w.put(2, 2); w.code(table + 2 * k); w.put(1, sign);
    return;
  }
  w.code(table + 2 * ESCAPE);
  w.put(2, 3);
  w.put(1, last);
  w.put(6, run);
  w.put(1, 1);
  w.put(12, (uint32_t)level);
  w.put(1, 1);
}

void put_block(Writer& w, const int32_t* const* part, const int64_t* levels, const int32_t* scan,
               int start, int intra) {
  int runs[64], vals[64], n = 0, run = 0;
  for (int i = start; i < 64; i++) {
    int level = (int)levels[scan[i]];
    if (level) { runs[n] = run; vals[n] = level; n++; run = 0; }
    else run++;
  }
  for (int k = 0; k < n; k++) put_tcoef(w, part, intra, k == n - 1, runs[k], vals[k]);
}

void put_motion(Writer& w, const int32_t* mvd, int val) {
  if (val == 0) { w.put(1, 1); return; }
  const int bits = 6;  // f_code 1
  val &= (1 << bits) - 1;
  if (val >> (bits - 1)) val -= 1 << bits;
  int sign = val < 0;
  val = std::abs(val) - 1;
  int code = val + 1;
  w.put(mvd[2 * code + 1] + 1, (uint32_t)((mvd[2 * code] << 1) | sign));
}

void put_dc(Writer& w, const int32_t* sizes, int diff) {
  int mag = std::abs(diff), size = 0;
  while ((1 << size) <= mag) size++;
  w.code(sizes + 2 * size);
  if (size) {
    w.put(size, (uint32_t)(diff > 0 ? diff : diff + (1 << size) - 1));
    if (size > 8) w.put(1, 1);
  }
}

void mb_samples(const uint8_t* const planes[3], int mb_w, int mb_x, int mb_y, int64_t out[6][64]) {
  int ys = 16 * mb_w, cs = 8 * mb_w;
  for (int n = 0; n < 6; n++) {
    const uint8_t* src;
    int stride;
    if (n < 4) {
      stride = ys;
      src = planes[0] + (int64_t)(16 * mb_y + (n >> 1) * 8) * ys + 16 * mb_x + (n & 1) * 8;
    } else {
      stride = cs;
      src = planes[n - 3] + (int64_t)(8 * mb_y) * cs + 8 * mb_x;
    }
    for (int j = 0; j < 8; j++)
      for (int i = 0; i < 8; i++) out[n][j * 8 + i] = src[j * stride + i];
  }
}

}  // namespace

extern "C" {

// A VOP's macroblocks, from bit `bitpos` of `data` (`len` bytes, then 8
// zero bytes), into out planes of whole macroblocks (Y stride 16 mb_w, U and
// V 8 mb_w), predicting from `past` (a P-VOP's reference, a B-VOP's forward
// one) and `fut` (a B-VOP's backward one; null where unused); a B-VOP reads
// the future reference's macroblock kinds and stored vectors (col_kinds,
// col_mv).  Writes each macroblock's kind and the stored forward vectors
// (n, 4, 2) a later B-VOP reads.  Returns the bit after the last
// macroblock, or a negative error.
int64_t omv_decode_vop(const uint8_t* data, int64_t len, int64_t bitpos, const int32_t* prm,
                       const int32_t* tables, const int32_t* matrices, const uint8_t* past_y,
                       const uint8_t* past_u, const uint8_t* past_v, const uint8_t* fut_y,
                       const uint8_t* fut_u, const uint8_t* fut_v, const int32_t* col_kinds,
                       const int32_t* col_mv, uint8_t* out_y, uint8_t* out_u, uint8_t* out_v,
                       int32_t* out_kinds, int32_t* out_mv) {
  Decoder d;
  d.init(prm, tables);
  Bits r{data, len * 8, bitpos};
  int mb_w = d.mb_w, mb_h = d.mb_h, n_mb = mb_w * mb_h;
  int qscale = prm[P_QUANT];
  const uint8_t* const past[3] = {past_y, past_u, past_v};
  const uint8_t* const fut[3] = {fut_y, fut_u, fut_v};
  uint8_t* const outs[3] = {out_y, out_u, out_v};
  Vop v{d, past, fut, matrices, outs, out_kinds};
  if (d.ctype == B_VOP && (!col_kinds || !col_mv)) return ERR_REF;
  int64_t end;
  if (d.partitioned && d.ctype != B_VOP) {
    end = decode_partitioned(d, r, v, qscale);
    if (end < 0) return end;
  } else {
    int last_mv[2][2] = {{0, 0}, {0, 0}};
    for (int mb = 0; mb < n_mb;) {
      int mb_y = mb / mb_w, mb_x = mb % mb_w;
      if (mb_x == d.resync_x && mb_y == d.resync_y + 1) d.first_line = false;
      int row = 2 * mb_y, col = 2 * mb_x;
      int16_t blocks[6][64];
      std::memset(blocks, 0, sizeof(blocks));
      bool coded[6] = {false, false, false, false, false, false};
      int vec[2][4][2];
      std::memset(vec, 0, sizeof(vec));
      int kind = MB_INTRA, dirs = 0;
      if (d.ctype == B_VOP) {
        if (mb_x == 0) std::memset(last_mv, 0, sizeof(last_mv));
        int ck = col_kinds[mb];
        if (ck == MB_SKIPPED) {
          kind = MB_SKIPPED;
          dirs = 1;
        } else {
          int mb_type = 0, cbp = 0, dx = 0, dy = 0;
          if (!r.bits(1)) {
            int modb2 = r.bits(1);
            mb_type = -1;
            for (int k = 0; k < 4; k++)
              if (r.bits(1)) { mb_type = k; break; }
            if (r.err) return r.err;
            if (mb_type < 0) return ERR_MBTYPE;
            cbp = modb2 ? 0 : (int)r.bits(6);
            if (mb_type != 0 && cbp && r.bits(1)) qscale = clampi(qscale + (int)r.bits(1) * 4 - 2, 1, 31);
            if (mb_type != 0) {
              static const int dmap[4] = {0, 3, 2, 1};
              dirs = dmap[mb_type];
              kind = MB_INTER;
              for (int dd = 0; dd < 2; dd++) {
                if (!(dirs & (1 << dd))) continue;
                int code = dd ? d.bcode : d.fcode;
                int mx = d.decode_motion(r, last_mv[dd][0], code);
                int my = d.decode_motion(r, last_mv[dd][1], code);
                last_mv[dd][0] = mx;
                last_mv[dd][1] = my;
                for (int i = 0; i < 4; i++) { vec[dd][i][0] = mx; vec[dd][i][1] = my; }
              }
            } else {
              dx = d.decode_motion(r, 0, 1);
              dy = d.decode_motion(r, 0, 1);
            }
          }
          if (mb_type == 0) {
            bool col_four = ck == MB_INTER4V;
            direct_vectors(col_four, col_mv + mb * 8, dx, dy, d.pp_time, d.pb_time, vec);
            dirs = 3;
            bool four = col_four || d.qpel_on;  // (mpeg4._parse_b_mb)
            kind = four ? MB_INTER4V : MB_INTER;
          }
          if (r.err) return r.err;
          int e = d.inter_blocks(r, blocks, coded, cbp, qscale);
          if (e) return e;
        }
      } else {
        bool intra = true, dquant = false, four = false, skipped = false;
        int cbpc = 0;
        if (d.ctype == P_VOP) {
          for (;;) {
            if (r.bits(1)) { skipped = true; break; }
            cbpc = r.vlc(d.part[T_INTER_MCBPC]);
            if (r.err) return r.err;
            if (cbpc != INTER_STUFF) break;
          }
          if (!skipped) { intra = cbpc & 4; dquant = cbpc & 8; four = cbpc & 16; }
        } else {
          for (;;) {
            cbpc = r.vlc(d.part[T_INTRA_MCBPC]);
            if (r.err) return r.err;
            if (cbpc != INTRA_DC_STUFF) break;
          }
          dquant = cbpc & 4;
        }
        if (r.err) return r.err;
        if (skipped) {
          kind = MB_SKIPPED;
          dirs = 1;
          for (int j = 0; j < 2; j++)
            for (int i = 0; i < 2; i++) { int* m = d.MV(row + 1 + j, col + 1 + i); m[0] = m[1] = 0; }
          d.clean_intra(mb_x, mb_y);
        } else if (!intra) {
          kind = four ? MB_INTER4V : MB_INTER;
          dirs = 1;
          int cbpy = r.vlc(d.part[T_CBPY]) ^ 15;
          int cbp = (cbpc & 3) | (cbpy << 2);
          if (dquant) qscale = clampi(qscale + DQUANT[r.bits(2)], 1, 31);
          for (int i = 0; i < (four ? 4 : 1); i++) {
            int px, py;
            d.pred_motion(row, col, i, mb_x, &px, &py);
            int mx = d.decode_motion(r, px, d.fcode);
            int my = d.decode_motion(r, py, d.fcode);
            if (r.err) return r.err;
            if (four) {
              int* m = d.MV(row + 1 + (i >> 1), col + 1 + (i & 1));
              m[0] = mx; m[1] = my;
            } else {
              for (int j = 0; j < 2; j++)
                for (int k = 0; k < 2; k++) { int* m = d.MV(row + 1 + j, col + 1 + k); m[0] = mx; m[1] = my; }
            }
          }
          for (int i = 0; i < 4; i++) {
            int* m = d.MV(row + 1 + (i >> 1), col + 1 + (i & 1));
            vec[0][i][0] = m[0]; vec[0][i][1] = m[1];
          }
          int e = d.inter_blocks(r, blocks, coded, cbp, qscale);
          if (e) return e;
          d.clean_intra(mb_x, mb_y);
        } else {
          int ac_pred = r.bits(1);
          int cbp = (cbpc & 3) | (r.vlc(d.part[T_CBPY]) << 2);
          bool use_dc_vlc = qscale < d.dc_thr;
          if (dquant) qscale = clampi(qscale + DQUANT[r.bits(2)], 1, 31);
          if (r.err) return r.err;
          for (int j = 0; j < 2; j++)
            for (int i = 0; i < 2; i++) { int* m = d.MV(row + 1 + j, col + 1 + i); m[0] = m[1] = 0; }
          d.qtab[mb_y * mb_w + mb_x] = qscale;
          int e = d.intra_blocks(r, blocks, mb_x, mb_y, qscale, cbp, ac_pred, use_dc_vlc, nullptr,
                                 nullptr);
          if (e) return e;
          for (int n = 0; n < 6; n++) coded[n] = true;
        }
      }
      d.qtab[mb_y * mb_w + mb_x] = qscale;
      int e = v.put(mb, kind, dirs, qscale, blocks, coded, vec);
      if (e) return e;
      mb++;
      if (d.resync && mb < n_mb && d.is_resync(r, d.prefix())) {
        int64_t saved = r.pos;
        int mb_num, q;
        e = d.packet_header(r, n_mb, &mb_num, &q);
        if (e) return e;
        if (mb_num != mb) {
          if (d.ctype == B_VOP && mb_num > mb && col_kinds[mb] == MB_SKIPPED) {
            r.pos = saved;  // skipped B macroblocks come before the packet's first
            continue;
          }
          return ERR_PACKET;
        }
        if (q) qscale = q;
        d.resync_y = mb_num / mb_w;
        d.resync_x = mb_num % mb_w;
        d.first_line = true;
        std::memset(last_mv, 0, sizeof(last_mv));
        d.clean_buffers(d.resync_x, d.resync_y);
      }
    }
    end = r.pos;
  }
  for (int mb = 0; mb < n_mb; mb++)
    for (int i = 0; i < 4; i++) {
      int* m = d.MV(2 * (mb / mb_w) + 1 + (i >> 1), 2 * (mb % mb_w) + 1 + (i & 1));
      out_mv[mb * 8 + 2 * i] = m[0];
      out_mv[mb * 8 + 2 * i + 1] = m[1];
    }
  return end;
}

// One VOP's macroblocks (data/mpeg4_encode.py's encode_vop_py): cur planes
// of whole macroblocks, ref the previous reconstruction (null for an
// I-VOP), the VOP header's head_len bytes already in out with n pending bits
// in acc.  Writes the VOP into out (capacity cap) and its reconstruction
// into rec; returns its length in bytes, or -1 when cap is too small.
int64_t omv_encode_vop(const uint8_t* cur_y, const uint8_t* cur_u, const uint8_t* cur_v,
                       const uint8_t* ref_y, const uint8_t* ref_u, const uint8_t* ref_v,
                       const int32_t* prm, const int32_t* tables, int64_t head_len, int64_t acc,
                       int n, uint8_t* out, int64_t cap, uint8_t* rec_y, uint8_t* rec_u,
                       uint8_t* rec_v) {
  Decoder d;
  d.init(prm, tables);
  const int32_t* part[E_COUNT];
  for (int i = 0; i < E_COUNT; i++) part[i] = tables + tables[i];
  Writer w{out, cap, head_len, (uint64_t)acc, n};
  int mb_w = d.mb_w, mb_h = d.mb_h, q = prm[3];
  const uint8_t* const cur[3] = {cur_y, cur_u, cur_v};
  const uint8_t* const refs[3] = {ref_y, ref_u, ref_v};
  uint8_t* const recs[3] = {rec_y, rec_u, rec_v};
  const int32_t* zig = part[T_SCANS];
  const int32_t* dc_scale = part[T_DC_SCALE];
  int dc_luma = dc_scale[q], dc_chroma = dc_scale[32 + q];
  int qmul = 2 * q, qadd = (q - 1) | 1;
  for (int mb = 0; mb < mb_w * mb_h; mb++) {
    int mb_y = mb / mb_w, mb_x = mb % mb_w;
    if (mb_x == 0 && mb_y == 1) d.first_line = false;
    int row = 2 * mb_y, col = 2 * mb_x;
    int64_t samples[6][64], coefs[6][64], levels[6][64];
    int16_t blocks[6][64];
    bool coded[6] = {false, false, false, false, false, false};
    int vec[2][4][2];  // forward only
    std::memset(vec, 0, sizeof(vec));
    mb_samples(cur, mb_w, mb_x, mb_y, samples);
    if (d.ctype == 0) {
      int cbp = 0;
      for (int k = 0; k < 6; k++) {
        fdct_islow(samples[k], coefs[k]);
        int scale = k < 4 ? dc_luma : dc_chroma;
        levels[k][0] = (coefs[k][0] + 4 * scale) / (8 * scale);
        bool any = false;
        for (int i = 1; i < 64; i++) {
          int64_t c = coefs[k][i];
          int64_t m = std::abs(c) / (16 * q);
          if (m > 2047) m = 2047;
          levels[k][i] = c < 0 ? -m : m;
          any |= m != 0;
        }
        if (any) cbp |= 32 >> k;
      }
      w.code(part[E_INTRA_MCBPC] + 2 * (cbp & 3));
      w.put(1, 0);
      w.code(part[E_CBPY] + 2 * (cbp >> 2));
      for (int k = 0; k < 6; k++) {
        int scale = k < 4 ? dc_luma : dc_chroma;
        int bx, by, dir;
        Decoder::block_pos(k, mb_x, mb_y, &bx, &by);
        int level = (int)levels[k][0];
        int pred = d.pred_dc(k, bx, by, 0, mb_x, mb_y, scale, &dir);
        d.pred_dc(k, bx, by, level - pred, mb_x, mb_y, scale, &dir);
        put_dc(w, part[k < 4 ? E_DC_LUMA : E_DC_CHROMA], level - pred);
        if (cbp & (32 >> k)) put_block(w, part, levels[k], zig, 1, 1);
        for (int i = 0; i < 64; i++) blocks[k][i] = wrap16(levels[k][i]);
        coded[k] = true;
      }
      reconstruct_mb(d, MB_INTRA, 0, q, blocks, coded, vec, mb_x, mb_y, refs, refs, nullptr, recs);
      continue;
    }
    int px, py;
    d.pred_motion(row, col, 0, mb_x, &px, &py);
    int cand[4][2] = {{0, 0}, {px, py}, {0, 0}, {0, 0}};
    if (mb_x > 0) { int* m = d.MV(row + 1, col); cand[2][0] = m[0]; cand[2][1] = m[1]; }
    if (mb_y > 0) { int* m = d.MV(row, col + 1); cand[3][0] = m[0]; cand[3][1] = m[1]; }
    int mx, my;
    motion_search(cur_y, ref_y, d, mb_x, mb_y, cand, &mx, &my);
    for (int k = 0; k < 4; k++) { vec[0][k][0] = mx; vec[0][k][1] = my; }
    int32_t pred[6][64];
    predict_dir(d, false, vec[0], mb_x, mb_y, refs, d.rounding, pred);
    int cbp = 0;
    for (int k = 0; k < 6; k++) {
      int64_t residual[64];
      for (int i = 0; i < 64; i++) residual[i] = samples[k][i] - pred[k][i];
      fdct_islow(residual, coefs[k]);
      bool any = false;
      for (int i = 0; i < 64; i++) {
        int64_t c = coefs[k][i];
        int64_t m = std::abs(c) - 4 * q;
        m = m > 0 ? m / (16 * q) : 0;
        if (m > 2047) m = 2047;
        levels[k][i] = c < 0 ? -m : m;
        any |= m != 0;
      }
      if (any) cbp |= 32 >> k;
    }
    if (cbp == 0 && mx == 0 && my == 0) {
      w.put(1, 1);
      for (int j = 0; j < 2; j++)
        for (int i = 0; i < 2; i++) { int* m = d.MV(row + 1 + j, col + 1 + i); m[0] = m[1] = 0; }
      std::memset(vec, 0, sizeof(vec));
      std::memset(blocks, 0, sizeof(blocks));
      reconstruct_mb(d, MB_SKIPPED, 1, q, blocks, coded, vec, mb_x, mb_y, refs, refs, nullptr,
                     recs);
      continue;
    }
    w.put(1, 0);
    w.code(part[E_INTER_MCBPC] + 2 * (cbp & 3));
    w.code(part[E_CBPY] + 2 * ((cbp >> 2) ^ 15));
    put_motion(w, part[E_MVD], mx - px);
    put_motion(w, part[E_MVD], my - py);
    for (int j = 0; j < 2; j++)
      for (int i = 0; i < 2; i++) { int* m = d.MV(row + 1 + j, col + 1 + i); m[0] = mx; m[1] = my; }
    std::memset(blocks, 0, sizeof(blocks));
    for (int k = 0; k < 6; k++)
      if (cbp & (32 >> k)) {
        put_block(w, part, levels[k], zig, 0, 0);
        for (int i = 0; i < 64; i++) {
          int64_t l = levels[k][i];
          blocks[k][i] = wrap16(l == 0 ? 0 : l < 0 ? l * qmul - qadd : l * qmul + qadd);
        }
        coded[k] = true;
      }
    reconstruct_mb(d, MB_INTER, 1, q, blocks, coded, vec, mb_x, mb_y, refs, refs, nullptr, recs);
  }
  w.stuffing();
  if (w.overflow) return -1;
  return w.len;
}

// YUV 4:2:0 -> RGB as libswscale's x86 yuv2rgb converts (data/yuv.py)
void omv_yuv_to_rgb(const uint8_t* y, int64_t ystride, const uint8_t* u, const uint8_t* v,
                    int64_t cstride, int w, int h, uint8_t* out) {
  for (int j = 0; j < h; j++) {
    const uint8_t* yr = y + j * ystride;
    const uint8_t* ur = u + (j >> 1) * cstride;
    const uint8_t* vr = v + (j >> 1) * cstride;
    uint8_t* o = out + (int64_t)j * w * 3;
    for (int i = 0; i < w; i++) {
      int yv = ((yr[i] * 8 - 128) * 9539) >> 16;
      int u8 = ur[i >> 1] * 8 - 1024, v8 = vr[i >> 1] * 8 - 1024;
      o[3 * i] = clip8(yv + ((v8 * 13075) >> 16));
      o[3 * i + 1] = clip8(yv + ((u8 * -3209) >> 16) + ((v8 * -6660) >> 16));
      o[3 * i + 2] = clip8(yv + ((u8 * 16525) >> 16));
    }
  }
}

// full-range YUV -> RGB (data/yuv.py's yuvj_to_rgb_py): U and V of row
// stride `cstride`, each chroma row serving `rows` luma rows (2: 4:2:0,
// 1: 4:2:2)
void omv_yuvj_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, int64_t cstride,
                     int rows, int w, int h, uint8_t* out) {
  for (int j = 0; j < h; j++) {
    const uint8_t* yr = y + (int64_t)j * w;
    const uint8_t* ur = u + (j / rows) * cstride;
    const uint8_t* vr = v + (j / rows) * cstride;
    uint8_t* o = out + (int64_t)j * w * 3;
    for (int i = 0; i < w; i++) {
      int yv = (yr[i] * 8 * 8192) >> 16;
      int u8 = ur[i >> 1] * 8 - 1024, v8 = vr[i >> 1] * 8 - 1024;
      o[3 * i] = clip8(yv + ((v8 * 11485) >> 16));
      o[3 * i + 1] = clip8(yv + ((u8 * -2819) >> 16) + ((v8 * -5850) >> 16));
      o[3 * i + 2] = clip8(yv + ((u8 * 14516) >> 16));
    }
  }
}

// an MJPEG component's pixels (data/mjpeg.py's planes_py): (rows, cols, 64)
// quantised int16 blocks in raster order times the quantiser `q` into
// int16 (the DC from 1024, saturated), simple_idct, clipped, into a plane
// of stride 8 cols
void omv_mjpeg_planes(const int16_t* coefs, int rows, int cols, const int32_t* q, uint8_t* out) {
  for (int by = 0; by < rows; by++)
    for (int bx = 0; bx < cols; bx++) {
      const int16_t* c = coefs + ((int64_t)by * cols + bx) * 64;
      int16_t block[64];
      for (int i = 1; i < 64; i++) block[i] = wrap16((int64_t)c[i] * q[i]);
      int64_t dc = 1024 + (int64_t)c[0] * q[0];
      block[0] = (int16_t)(dc < -32768 ? -32768 : dc > 32767 ? 32767 : dc);
      int32_t res[64];
      simple_idct(block, res);
      for (int j = 0; j < 8; j++)
        for (int i = 0; i < 8; i++)
          out[((int64_t)by * 8 + j) * cols * 8 + bx * 8 + i] = clip8(res[j * 8 + i]);
    }
}

// RGB -> YUV 4:2:0 (data/yuv.py's rgb_to_yuv420_py), w and h even
void omv_rgb_to_yuv(const uint8_t* rgb, int w, int h, uint8_t* y, uint8_t* u, uint8_t* v) {
  for (int j = 0; j < h; j++)
    for (int i = 0; i < w; i++) {
      const uint8_t* p = rgb + ((int64_t)j * w + i) * 3;
      y[(int64_t)j * w + i] = clip8((8414 * p[0] + 16519 * p[1] + 3208 * p[2] + (16 << 15)) >> 15);
    }
  for (int j = 0; j < h / 2; j++)
    for (int i = 0; i < w / 2; i++) {
      int64_t r = 0, g = 0, b = 0;
      for (int dy = 0; dy < 2; dy++)
        for (int dx = 0; dx < 2; dx++) {
          const uint8_t* p = rgb + ((int64_t)(2 * j + dy) * w + 2 * i + dx) * 3;
          r += p[0]; g += p[1]; b += p[2];
        }
      u[(int64_t)j * (w / 2) + i] = clip8((int)((-4857 * r - 9535 * g + 14392 * b + (128ll << 17)) >> 17));
      v[(int64_t)j * (w / 2) + i] = clip8((int)((14392 * r - 12052 * g - 2341 * b + (128ll << 17)) >> 17));
    }
}

const char* omv_error_string(int code) {
  switch (code) {
    case ERR_VLC: return "an invalid variable-length code";
    case ERR_END: return "the bitstream ends inside a macroblock";
    case ERR_COEFS: return "a block with more than 64 coefficients";
    case ERR_PACKET: return "a malformed video packet header";
    case ERR_REF: return "a VOP without its reference";
    case ERR_MBTYPE: return "an invalid B macroblock type";
    case ERR_MARKER: return "no marker after a data partition";
    case ERR_DC_AMONG_AC: return "data partitioning with the intra DC among the AC coefficients";
  }
  return "an unknown error";
}

}  // extern "C"
