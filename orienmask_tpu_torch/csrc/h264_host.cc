// H.264 loops of data/h264.py: a slice's macroblocks (CAVLC and CABAC
// entropy decoding, intra, inter and direct prediction, bi-prediction and
// weighted prediction, the inverse transforms),
// the deblocking filter of a picture, and the colour conversion of
// data/yuv.py for any colour matrix.  Each is the plain Python version
// (decode_slice_py, deblock_py, yuv_to_rgb_py) written again in C++, and
// held to it by the tests.  Plain C interface, loaded with ctypes.
//
// The tables come from Python (h264_tables.native_tables), in the order of
// its TABLE_ORDER, so they are written once, in data/h264_tables.py.  The
// picture's state arrays (data/h264.py's STATE) come as one int32 vector.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum {
  ERR_EOF = -1, ERR_VLC = -2, ERR_RANGE = -3, ERR_PAST_END = -4, ERR_TWICE = -5,
  ERR_MB_TYPE = -6, ERR_REF = -7, ERR_INTRA_MODE = -8, ERR_CABAC = -9, ERR_MV = -10,
  ERR_NO_REF = -11, ERR_COEFFS = -12
};
struct Error {
  int code;
};
[[noreturn]] void fail(int code) { throw Error{code}; }

// data/h264.py's macroblock kinds and parameter vector
enum {
  I4, I8, I16, PCM, P16X16, P16X8, P8X16, P8X8, P8X8REF0, PSKIP, BDIRECT, B16X16, B16X8, B8X16,
  B8X8, BSKIP
};
enum { P_SLICE = 0, B_SLICE = 1, I_SLICE = 2 };
enum { WEIGHT_NONE, WEIGHT_EXPLICIT, WEIGHT_IMPLICIT };
enum {
  PR_MB_W, PR_MB_H, PR_FIRST_MB, PR_TYPE, PR_CABAC, PR_INIT_IDC, PR_QP, PR_NUM_REF, PR_T8_MODE,
  PR_CONSTRAINED, PR_CB_OFF, PR_CR_OFF, PR_SLICE_NUM, PR_DBK_IDC, PR_DBK_A, PR_DBK_B,
  PR_LUMA_DENOM, PR_CHROMA_DENOM, PR_NUM_REF1, PR_WEIGHT_MODE, PR_DIRECT_SPATIAL, PR_DIRECT_8X8,
  PR_COL_SHORT
};
inline bool is_skip(int kind) { return kind == PSKIP || kind == BSKIP; }
// B mb_type 1-21 (Table 7-14): the kind and each partition's lists (1 L0, 2 L1, 3 both)
const int B_KIND[22] = {BDIRECT, B16X16, B16X16, B16X16, B16X8, B8X16, B16X8, B8X16, B16X8, B8X16,
                        B16X8, B8X16, B16X8, B8X16, B16X8, B8X16, B16X8, B8X16, B16X8, B8X16,
                        B16X8, B8X16};
const int B_MODES[22][2] = {{0, 0}, {1, 0}, {2, 0}, {3, 0}, {1, 1}, {1, 1}, {2, 2}, {2, 2},
                            {1, 2}, {1, 2}, {2, 1}, {2, 1}, {1, 3}, {1, 3}, {2, 3}, {2, 3},
                            {3, 1}, {3, 1}, {3, 2}, {3, 2}, {3, 3}, {3, 3}};
// sub_mb_type: (width, height, lists); B's 0 is direct
const int P_SUB[4][3] = {{8, 8, 1}, {8, 4, 1}, {4, 8, 1}, {4, 4, 1}};
const int B_SUB[13][3] = {{8, 8, 0}, {8, 8, 1}, {8, 8, 2}, {8, 8, 3}, {8, 4, 1},
                          {4, 8, 1}, {8, 4, 2}, {4, 8, 2}, {8, 4, 3}, {4, 8, 3},
                          {4, 4, 1}, {4, 4, 2}, {4, 4, 3}};
const int BLK_RASTER[16] = {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};
int BLK_ORDER[16];  // raster index -> luma4x4BlkIdx

// the tables, in h264_tables.TABLE_ORDER
struct Tables {
  const int *ct_len, *ct_code, *cdc_ct_len, *cdc_ct_code, *tz_len, *tz_code, *cdc_tz_len,
      *cdc_tz_code, *run_len, *run_code, *cbp_intra, *cbp_inter, *zz4, *zz8, *chroma_qp,
      *alpha, *beta, *tc0, *range_lps, *trans_lps, *sig8, *last8, *cabac_init;
  explicit Tables(const int* t) {
    const int sizes[] = {272, 272, 20, 20, 240, 240, 48, 48, 112, 112, 48, 48, 16, 64,
                         52, 52, 52, 156, 256, 64, 63, 63, 4 * 436 * 2};
    const int** fields[] = {&ct_len, &ct_code, &cdc_ct_len, &cdc_ct_code, &tz_len, &tz_code,
                            &cdc_tz_len, &cdc_tz_code, &run_len, &run_code, &cbp_intra,
                            &cbp_inter, &zz4, &zz8, &chroma_qp, &alpha, &beta, &tc0,
                            &range_lps, &trans_lps, &sig8, &last8, &cabac_init};
    for (int i = 0; i < 23; i++) {
      *fields[i] = t;
      t += sizes[i];
    }
  }
};

// a variable-length code as a lookup on its longest code's bits
struct Vlc {
  int bits = 0;
  std::vector<int16_t> sym, len;
  void build(const int* lengths, const int* codes, int n, int stride_sym = 0) {
    bits = 0;
    for (int i = 0; i < n; i++) bits = std::max(bits, lengths[i]);
    sym.assign(1 << bits, -1);
    len.assign(1 << bits, 0);
    for (int i = 0; i < n; i++) {
      int l = lengths[i];
      if (!l) continue;
      int first = codes[i] << (bits - l), count = 1 << (bits - l);
      for (int k = 0; k < count; k++) {
        sym[first + k] = (int16_t)(stride_sym ? i : i);
        len[first + k] = (int16_t)l;
      }
    }
  }
};

struct Vlcs {
  Vlc token[4], cdc_token, tz[15], cdc_tz[3], run[7];
  const int* source = nullptr;
  void build(const Tables& T) {
    for (int t = 0; t < 4; t++) token[t].build(T.ct_len + 68 * t, T.ct_code + 68 * t, 68);
    cdc_token.build(T.cdc_ct_len, T.cdc_ct_code, 20);
    for (int i = 0; i < 15; i++) tz[i].build(T.tz_len + 16 * i, T.tz_code + 16 * i, 16);
    for (int i = 0; i < 3; i++) cdc_tz[i].build(T.cdc_tz_len + 16 * i, T.cdc_tz_code + 16 * i, 16);
    for (int i = 0; i < 7; i++) run[i].build(T.run_len + 16 * i, T.run_code + 16 * i, 16);
  }
};
Vlcs VLCS;

struct Bits {
  const uint8_t* data;  // padded with 16 zero bytes
  int64_t size, pos, stop;
  Bits(const uint8_t* d, int64_t len, int64_t p) : data(d), size(8 * len), pos(p) {
    int64_t last = len - 1;
    while (last >= 0 && data[last] == 0) last--;
    stop = last < 0 ? 0 : 8 * last + 7 - __builtin_ctz(data[last]);
  }
  uint32_t peek(int n) const {
    int64_t byte = pos >> 3;
    uint64_t w = 0;
    for (int i = 0; i < 8; i++) w = (w << 8) | data[byte + i];
    return (uint32_t)((w >> (64 - (pos & 7) - n)) & ((1ull << n) - 1));
  }
  uint32_t u(int n) {
    if (n == 0) return 0;
    if (pos + n > size) fail(ERR_EOF);
    uint32_t v = peek(n);
    pos += n;
    return v;
  }
  int bit() { return (int)u(1); }
  uint32_t ue() {
    int zeros = 0;
    while (!bit())
      if (++zeros > 31) fail(ERR_VLC);
    return (uint32_t)(((1ull << zeros) - 1) + u(zeros));
  }
  int se() {
    uint32_t k = ue();
    return (k & 1) ? (int)((k + 1) >> 1) : -(int)(k >> 1);
  }
  bool more_rbsp_data() const { return pos < size && pos < stop; }
  int vlc(const Vlc& t) {
    if (pos >= size) fail(ERR_EOF);
    int code = (int)peek(t.bits);
    int l = t.len[code];
    if (!l) fail(ERR_VLC);
    if (pos + l > size) fail(ERR_EOF);
    pos += l;
    return t.sym[code];
  }
};

struct Cabac {
  Bits* r;
  const Tables* T;
  uint8_t state[436][2];
  int range = 510, offset = 0;
  void init(int idc, int qp) {
    const int* table = T->cabac_init + (idc + 1) * 436 * 2;
    qp = std::min(std::max(qp, 0), 51);
    for (int i = 0; i < 436; i++) {
      int m = table[2 * i], n = table[2 * i + 1];
      int pre = std::min(std::max(((m * qp) >> 4) + n, 1), 126);
      if (pre > 63) {
        state[i][0] = (uint8_t)(pre - 64);
        state[i][1] = 1;
      } else {
        state[i][0] = (uint8_t)(63 - pre);
        state[i][1] = 0;
      }
    }
  }
  void start() {
    range = 510;
    offset = (int)r->u(9);
    if (offset >= 510) fail(ERR_CABAC);
  }
  int next_bit() {
    if (r->pos >= r->size) {
      r->pos++;
      if (r->pos > r->size + 64) fail(ERR_EOF);
      return 0;
    }
    return r->bit();
  }
  int decision(int ctx) {
    uint8_t* st = state[ctx];
    int s = st[0], mps = st[1];
    int lps = T->range_lps[4 * s + ((range >> 6) & 3)];
    range -= lps;
    int b;
    if (offset >= range) {
      b = 1 - mps;
      offset -= range;
      range = lps;
      if (s == 0) st[1] = (uint8_t)(1 - mps);
      st[0] = (uint8_t)T->trans_lps[s];
    } else {
      b = mps;
      st[0] = (uint8_t)(s < 62 ? s + 1 : 62);
    }
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | next_bit();
    }
    return b;
  }
  int bypass() {
    offset = (offset << 1) | next_bit();
    if (offset >= range) {
      offset -= range;
      return 1;
    }
    return 0;
  }
  int terminate() {
    range -= 2;
    if (offset >= range) return 1;
    while (range < 256) {
      range <<= 1;
      offset = (offset << 1) | next_bit();
    }
    return 0;
  }
  // the binarisations (CabacElements of data/h264.py)
  // at ctxIdxOffset 3 (I slices), 17 (P's suffix) or 32 (B's suffix)
  int mb_type_i(int inc, int offset) {
    bool i = offset == 3;
    if (!decision(i ? 3 + inc : offset)) return 0;
    if (terminate()) return 25;
    int luma = decision(i ? 6 : offset + 1);
    int chroma = decision(i ? 7 : offset + 2);
    if (chroma) chroma += decision(i ? 8 : offset + 2);
    int m1 = decision(i ? 9 : offset + 3);
    int m0 = decision(i ? 10 : offset + 3);
    return 1 + (m1 << 1 | m0) + 4 * chroma + 12 * luma;
  }
  int mb_type_p() {
    if (decision(14)) return 5 + mb_type_i(0, 17);
    if (decision(15)) return decision(17) ? 1 : 2;
    return decision(16) ? 3 : 0;
  }
  int mb_type_b(int inc) {
    if (!decision(27 + inc)) return 0;
    if (!decision(30)) return 1 + decision(32);
    int bits = decision(31) << 3;
    bits |= decision(32) << 2;
    bits |= decision(32) << 1;
    bits |= decision(32);
    if (bits < 8) return bits + 3;
    if (bits == 13) return 23 + mb_type_i(0, 32);
    if (bits == 14) return 11;
    if (bits == 15) return 22;
    return ((bits << 1) | decision(32)) - 4;
  }
  int sub_mb_type() {
    if (decision(21)) return 0;
    if (!decision(22)) return 1;
    return decision(23) ? 2 : 3;
  }
  int sub_mb_type_b() {
    if (!decision(36)) return 0;
    if (!decision(37)) return 1 + decision(39);
    int base = 3;
    if (decision(38)) {
      if (decision(39)) return 11 + decision(39);
      base = 7;
    }
    int b1 = decision(39);
    return base + 2 * b1 + decision(39);
  }
  int rem_intra_mode() {
    int out = 0;
    for (int k = 0; k < 3; k++) out |= decision(69) << k;
    return out;
  }
  int chroma_mode(int inc) {
    if (!decision(64 + inc)) return 0;
    if (!decision(67)) return 1;
    return 2 + decision(67);
  }
  int cbp_chroma(int inc0, int inc1) {
    if (!decision(77 + inc0)) return 0;
    return 1 + decision(77 + 4 + inc1);
  }
  int mb_qp_delta(int inc) {
    int n = 0, ctx = 60 + inc;
    while (decision(ctx)) {
      n++;
      ctx = n == 1 ? 62 : 63;
      if (n > 104) fail(ERR_RANGE);
    }
    return (n & 1) ? (n + 1) >> 1 : -(n >> 1);
  }
  int ref_idx(int inc) {
    int n = 0, ctx = 54 + inc;
    while (decision(ctx)) {
      n++;
      ctx = n == 1 ? 58 : 59;
      if (n > 32) fail(ERR_RANGE);
    }
    return n;
  }
  int exp_golomb(int k) {
    int out = 0;
    while (bypass()) {
      out += 1 << k;
      if (++k > 30) fail(ERR_RANGE);
    }
    while (k) {
      k--;
      out += bypass() << k;
    }
    return out;
  }
  int mvd(int comp, int inc) {
    static const int next_inc[9] = {3, 4, 5, 6, 6, 6, 6, 6, 6};
    int base = comp == 0 ? 40 : 47;
    int n = 0, ctx = base + inc;
    while (n < 9 && decision(ctx)) {
      n++;
      ctx = base + next_inc[n - 1];
    }
    if (n == 9) n += exp_golomb(3);
    if (n && bypass()) return -n;
    return n;
  }
  // coefficient levels of a block whose coded_block_flag is 1
  void residual_block(int cat, int max_num, int* levels) {
    int sig_base, last_base, abs_base;
    static const int off[5] = {0, 15, 29, 44, 47}, abs_off[5] = {0, 10, 20, 30, 39};
    if (cat == 5) {
      sig_base = 402;
      last_base = 417;
      abs_base = 426;
    } else {
      sig_base = 105 + off[cat];
      last_base = 166 + off[cat];
      abs_base = 227 + abs_off[cat];
    }
    for (int i = 0; i < max_num; i++) levels[i] = 0;
    int sig[64], n_sig = 0;
    int i = 0;
    bool last_found = false;
    while (i < max_num - 1) {
      int inc = cat == 5 ? T->sig8[i] : (cat == 3 ? std::min(i, 2) : i);
      if (decision(sig_base + inc)) {
        sig[n_sig++] = i;
        int linc = cat == 5 ? T->last8[i] : (cat == 3 ? std::min(i, 2) : i);
        if (decision(last_base + linc)) {
          last_found = true;
          break;
        }
      }
      i++;
    }
    if (!last_found) sig[n_sig++] = max_num - 1;
    int gt1 = 0, eq1 = 0, cap = cat == 3 ? 3 : 4;
    for (int k = n_sig - 1; k >= 0; k--) {
      int ctx = abs_base + (gt1 ? 0 : std::min(4, 1 + eq1));
      int v = 0;
      if (decision(ctx)) {
        v = 1;
        ctx = abs_base + 5 + std::min(cap, gt1);
        while (v < 14 && decision(ctx)) v++;
        if (v == 14) v += exp_golomb(0);
      }
      int level = v + 1;
      if (v)
        gt1++;
      else
        eq1++;
      if (bypass()) level = -level;
      levels[sig[k]] = level;
    }
  }
};

inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int clip3(int lo, int hi, int v) { return v < lo ? lo : v > hi ? hi : v; }
inline int median3(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// -- prediction and transforms (data/h264.py's plain functions) -----------------

// intra 4x4 (n 4) or 8x8 (n 8); top has 2n entries (or null), left n
void intra_nxn(int n, int mode, const int* top, const int* left, int corner, int* out) {
  auto t = [&](int x) { return x < 0 ? corner : top[x]; };
  auto lf = [&](int y) { return y < 0 ? corner : left[y]; };
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++) {
      int v = 0;
      switch (mode) {
        case 0: v = top[x]; break;
        case 1: v = left[y]; break;
        case 2: {
          int st = 0, sl = 0;
          if (top) for (int k = 0; k < n; k++) st += top[k];
          if (left) for (int k = 0; k < n; k++) sl += left[k];
          if (top && left)
            v = (st + sl + n) >> (n == 4 ? 3 : 4);
          else if (left)
            v = (sl + n / 2) >> (n == 4 ? 2 : 3);
          else if (top)
            v = (st + n / 2) >> (n == 4 ? 2 : 3);
          else
            v = 128;
          break;
        }
        case 3:
          if (x == n - 1 && y == n - 1)
            v = (top[2 * n - 2] + 3 * top[2 * n - 1] + 2) >> 2;
          else
            v = (top[x + y] + 2 * top[x + y + 1] + top[x + y + 2] + 2) >> 2;
          break;
        case 4:
          if (x > y)
            v = (t(x - y - 2) + 2 * t(x - y - 1) + t(x - y) + 2) >> 2;
          else if (x < y)
            v = (lf(y - x - 2) + 2 * lf(y - x - 1) + lf(y - x) + 2) >> 2;
          else
            v = (t(0) + 2 * corner + lf(0) + 2) >> 2;
          break;
        case 5: {
          int z = 2 * x - y;
          if (z >= 0 && z % 2 == 0)
            v = (t(x - (y >> 1) - 1) + t(x - (y >> 1)) + 1) >> 1;
          else if (z > 0)
            v = (t(x - (y >> 1) - 2) + 2 * t(x - (y >> 1) - 1) + t(x - (y >> 1)) + 2) >> 2;
          else if (z == -1)
            v = (lf(0) + 2 * corner + t(0) + 2) >> 2;
          else
            v = (lf(y - 2 * x - 1) + 2 * lf(y - 2 * x - 2) + lf(y - 2 * x - 3) + 2) >> 2;
          break;
        }
        case 6: {
          int z = 2 * y - x;
          if (z >= 0 && z % 2 == 0)
            v = (lf(y - (x >> 1) - 1) + lf(y - (x >> 1)) + 1) >> 1;
          else if (z > 0)
            v = (lf(y - (x >> 1) - 2) + 2 * lf(y - (x >> 1) - 1) + lf(y - (x >> 1)) + 2) >> 2;
          else if (z == -1)
            v = (lf(0) + 2 * corner + t(0) + 2) >> 2;
          else
            v = (t(x - 2 * y - 1) + 2 * t(x - 2 * y - 2) + t(x - 2 * y - 3) + 2) >> 2;
          break;
        }
        case 7:
          if (y % 2 == 0)
            v = (top[x + (y >> 1)] + top[x + (y >> 1) + 1] + 1) >> 1;
          else
            v = (top[x + (y >> 1)] + 2 * top[x + (y >> 1) + 1] + top[x + (y >> 1) + 2] + 2) >> 2;
          break;
        default: {
          int z = x + 2 * y;
          if (z < 2 * n - 3 && z % 2 == 0)
            v = (left[y + (x >> 1)] + left[y + (x >> 1) + 1] + 1) >> 1;
          else if (z < 2 * n - 3)
            v = (left[y + (x >> 1)] + 2 * left[y + (x >> 1) + 1] + left[y + (x >> 1) + 2] + 2) >> 2;
          else if (z == 2 * n - 3)
            v = (left[n - 2] + 3 * left[n - 1] + 2) >> 2;
          else
            v = left[n - 1];
        }
      }
      out[y * n + x] = v;
    }
}

// the reference sample filter of intra 8x8 (in place; flags as available)
void filter_8x8_refs(int* top, bool has_top, int* left, bool has_left, int* corner,
                     bool has_corner) {
  int ft[16], fl[8], fc = 0;
  if (has_top) {
    ft[0] = ((has_corner ? *corner : top[0]) + 2 * top[0] + top[1] + 2) >> 2;
    for (int x = 1; x < 15; x++) ft[x] = (top[x - 1] + 2 * top[x] + top[x + 1] + 2) >> 2;
    ft[15] = (top[14] + 3 * top[15] + 2) >> 2;
  }
  if (has_corner) {
    if (has_top && has_left)
      fc = (top[0] + 2 * *corner + left[0] + 2) >> 2;
    else if (has_top)
      fc = (3 * *corner + top[0] + 2) >> 2;
    else if (has_left)
      fc = (3 * *corner + left[0] + 2) >> 2;
    else
      fc = *corner;
  }
  if (has_left) {
    fl[0] = ((has_corner ? *corner : left[0]) + 2 * left[0] + left[1] + 2) >> 2;
    for (int y = 1; y < 7; y++) fl[y] = (left[y - 1] + 2 * left[y] + left[y + 1] + 2) >> 2;
    fl[7] = (left[6] + 3 * left[7] + 2) >> 2;
  }
  if (has_top) std::memcpy(top, ft, sizeof ft);
  if (has_left) std::memcpy(left, fl, sizeof fl);
  if (has_corner) *corner = fc;
}

void plane_pred(int n, const int* top, const int* left, int corner, int* out) {
  int half = n / 2, h = 0, v = 0;
  for (int x = 0; x < half; x++)
    h += (x + 1) * (top[half + x] - (half - 2 - x >= 0 ? top[half - 2 - x] : corner));
  for (int y = 0; y < half; y++)
    v += (y + 1) * (left[half + y] - (half - 2 - y >= 0 ? left[half - 2 - y] : corner));
  int a = 16 * (left[n - 1] + top[n - 1]);
  int b = n == 16 ? (5 * h + 32) >> 6 : (34 * h + 32) >> 6;
  int c = n == 16 ? (5 * v + 32) >> 6 : (34 * v + 32) >> 6;
  for (int y = 0; y < n; y++)
    for (int x = 0; x < n; x++)
      out[y * n + x] = clip255((a + b * (x - half + 1) + c * (y - half + 1) + 16) >> 5);
}

void intra_16x16(int mode, const int* top, const int* left, int corner, int* out) {
  if (mode == 3) return plane_pred(16, top, left, corner, out);
  for (int y = 0; y < 16; y++)
    for (int x = 0; x < 16; x++) {
      int v;
      if (mode == 0)
        v = top[x];
      else if (mode == 1)
        v = left[y];
      else {
        int st = 0, sl = 0;
        if (top) for (int k = 0; k < 16; k++) st += top[k];
        if (left) for (int k = 0; k < 16; k++) sl += left[k];
        v = top && left ? (st + sl + 16) >> 5 : left ? (sl + 8) >> 4 : top ? (st + 8) >> 4 : 128;
      }
      out[y * 16 + x] = v;
    }
}

void intra_chroma(int mode, const int* top, const int* left, int corner, int* out) {
  if (mode == 3) return plane_pred(8, top, left, corner, out);
  if (mode == 1 || mode == 2) {
    for (int y = 0; y < 8; y++)
      for (int x = 0; x < 8; x++) out[y * 8 + x] = mode == 1 ? left[y] : top[x];
    return;
  }
  for (int by = 0; by < 2; by++)
    for (int bx = 0; bx < 2; bx++) {
      int st = 0, sl = 0;
      if (top) for (int k = 0; k < 4; k++) st += top[4 * bx + k];
      if (left) for (int k = 0; k < 4; k++) sl += left[4 * by + k];
      int v;
      if (bx == by)
        v = top && left ? (st + sl + 4) >> 3 : left ? (sl + 2) >> 2 : top ? (st + 2) >> 2 : 128;
      else if (bx == 1)
        v = top ? (st + 2) >> 2 : left ? (sl + 2) >> 2 : 128;
      else
        v = left ? (sl + 2) >> 2 : top ? (st + 2) >> 2 : 128;
      for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) out[(4 * by + y) * 8 + 4 * bx + x] = v;
    }
}

void idct4(const int* d, int* out) {
  int tmp[16];
  for (int i = 0; i < 4; i++) {
    int d0 = d[4 * i], d1 = d[4 * i + 1], d2 = d[4 * i + 2], d3 = d[4 * i + 3];
    int e0 = d0 + d2, e1 = d0 - d2, e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
    tmp[4 * i] = e0 + e3;
    tmp[4 * i + 1] = e1 + e2;
    tmp[4 * i + 2] = e1 - e2;
    tmp[4 * i + 3] = e0 - e3;
  }
  for (int j = 0; j < 4; j++) {
    int f0 = tmp[j], f1 = tmp[4 + j], f2 = tmp[8 + j], f3 = tmp[12 + j];
    int g0 = f0 + f2, g1 = f0 - f2, g2 = (f1 >> 1) - f3, g3 = f1 + (f3 >> 1);
    out[j] = (g0 + g3 + 32) >> 6;
    out[4 + j] = (g1 + g2 + 32) >> 6;
    out[8 + j] = (g1 - g2 + 32) >> 6;
    out[12 + j] = (g0 - g3 + 32) >> 6;
  }
}

void idct8_1d(const int* d, int* g) {
  int d0 = d[0], d1 = d[1], d2 = d[2], d3 = d[3], d4 = d[4], d5 = d[5], d6 = d[6], d7 = d[7];
  int e0 = d0 + d4, e1 = -d3 + d5 - d7 - (d7 >> 1), e2 = d0 - d4, e3 = d1 + d7 - d3 - (d3 >> 1);
  int e4 = (d2 >> 1) - d6, e5 = -d1 + d7 + d5 + (d5 >> 1), e6 = d2 + (d6 >> 1);
  int e7 = d3 + d5 + d1 + (d1 >> 1);
  int f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4, f3 = e3 + (e5 >> 2);
  int f4 = e2 - e4, f5 = (e3 >> 2) - e5, f6 = e0 - e6, f7 = e7 - (e1 >> 2);
  g[0] = f0 + f7;
  g[1] = f2 + f5;
  g[2] = f4 + f3;
  g[3] = f6 + f1;
  g[4] = f6 - f1;
  g[5] = f4 - f3;
  g[6] = f2 - f5;
  g[7] = f0 - f7;
}

void idct8(const int* d, int* out) {
  int rows[64], col[8], g[8];
  for (int i = 0; i < 8; i++) idct8_1d(d + 8 * i, rows + 8 * i);
  for (int j = 0; j < 8; j++) {
    for (int i = 0; i < 8; i++) col[i] = rows[8 * i + j];
    idct8_1d(col, g);
    for (int i = 0; i < 8; i++) out[8 * i + j] = (g[i] + 32) >> 6;
  }
}

void scale4(const int* c, const int* ls, int qp, int* out) {
  int q6 = qp / 6;
  for (int i = 0; i < 16; i++) {
    int v = c[i];
    out[i] = !v ? 0 : q6 >= 4 ? (v * ls[i]) << (q6 - 4)
                               : (v * ls[i] + (1 << (3 - q6))) >> (4 - q6);
  }
}

void scale8(const int* c, const int* ls, int qp, int* out) {
  int q6 = qp / 6;
  for (int i = 0; i < 64; i++) {
    int v = c[i];
    out[i] = !v ? 0 : q6 >= 6 ? (v * ls[i]) << (q6 - 6)
                               : (v * ls[i] + (1 << (5 - q6))) >> (6 - q6);
  }
}

void luma_dc(const int* c, int ls0, int qp, int* out) {
  int tmp[16], f[16];
  for (int i = 0; i < 4; i++) {
    int a = c[4 * i], b = c[4 * i + 1], cc = c[4 * i + 2], d = c[4 * i + 3];
    tmp[4 * i] = a + b + cc + d;
    tmp[4 * i + 1] = a + b - cc - d;
    tmp[4 * i + 2] = a - b - cc + d;
    tmp[4 * i + 3] = a - b + cc - d;
  }
  for (int j = 0; j < 4; j++) {
    int a = tmp[j], b = tmp[4 + j], cc = tmp[8 + j], d = tmp[12 + j];
    f[j] = a + b + cc + d;
    f[4 + j] = a + b - cc - d;
    f[8 + j] = a - b - cc + d;
    f[12 + j] = a - b + cc - d;
  }
  int q6 = qp / 6;
  for (int i = 0; i < 16; i++)
    out[i] = q6 >= 6 ? (f[i] * ls0) << (q6 - 6) : (f[i] * ls0 + (1 << (5 - q6))) >> (6 - q6);
}

void chroma_dc(const int* c, int ls0, int qp, int* out) {
  int a = c[0], b = c[1], cc = c[2], d = c[3];
  int f[4] = {a + b + cc + d, a - b + cc - d, a + b - cc - d, a - b - cc + d};
  for (int i = 0; i < 4; i++) out[i] = ((f[i] * ls0) << (qp / 6)) >> 5;
}

// quarter-sample luma prediction of a w x h block (8.4.2.2.1)
void luma_mc(const uint8_t* ref, int W, int H, int x, int y, int w, int h, int mx, int my,
             int* out) {
  int xf = mx & 3, yf = my & 3, x0 = x + (mx >> 2), y0 = y + (my >> 2);
  int P[21][21];
  for (int r = 0; r < h + 5; r++) {
    int yy = clip3(0, H - 1, y0 - 2 + r);
    for (int c = 0; c < w + 5; c++) P[r][c] = ref[yy * W + clip3(0, W - 1, x0 - 2 + c)];
  }
  auto tap = [](int a, int b, int c, int d, int e, int f) {
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
  };
  int b1[21][16], hh[16][21];
  for (int r = 0; r < h + 5; r++)
    for (int c = 0; c < w; c++)
      b1[r][c] = tap(P[r][c], P[r][c + 1], P[r][c + 2], P[r][c + 3], P[r][c + 4], P[r][c + 5]);
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w + 5; c++)
      hh[r][c] = clip255((tap(P[r][c], P[r + 1][c], P[r + 2][c], P[r + 3][c], P[r + 4][c],
                              P[r + 5][c]) + 16) >> 5);
  for (int r = 0; r < h; r++)
    for (int c = 0; c < w; c++) {
      int G = P[r + 2][c + 2];
      int v;
      if (xf == 0 && yf == 0) {
        v = G;
      } else {
        int bb = clip255((b1[r + 2][c] + 16) >> 5), s = clip255((b1[r + 3][c] + 16) >> 5);
        int hv = hh[r][c + 2], m = hh[r][c + 3];
        if (yf == 0) {
          v = xf == 2 ? bb : xf == 1 ? (G + bb + 1) >> 1 : (P[r + 2][c + 3] + bb + 1) >> 1;
        } else if (xf == 0) {
          v = yf == 2 ? hv : yf == 1 ? (G + hv + 1) >> 1 : (P[r + 3][c + 2] + hv + 1) >> 1;
        } else if ((xf & 1) && (yf & 1)) {
          v = ((yf == 1 ? bb : s) + (xf == 1 ? hv : m) + 1) >> 1;
        } else {
          int j = clip255((tap(b1[r][c], b1[r + 1][c], b1[r + 2][c], b1[r + 3][c], b1[r + 4][c],
                               b1[r + 5][c]) + 512) >> 10);
          if (xf == 2 && yf == 2)
            v = j;
          else if (xf == 2)
            v = yf == 1 ? (bb + j + 1) >> 1 : (j + s + 1) >> 1;
          else
            v = xf == 1 ? (hv + j + 1) >> 1 : (j + m + 1) >> 1;
        }
      }
      out[r * w + c] = v;
    }
}

void chroma_mc(const uint8_t* ref, int W, int H, int x, int y, int w, int h, int mx, int my,
               int* out) {
  int xf = mx & 7, yf = my & 7, x0 = x + (mx >> 3), y0 = y + (my >> 3);
  for (int r = 0; r < h; r++) {
    int ya = clip3(0, H - 1, y0 + r), yb = clip3(0, H - 1, y0 + r + 1);
    for (int c = 0; c < w; c++) {
      int xa = clip3(0, W - 1, x0 + c), xb = clip3(0, W - 1, x0 + c + 1);
      out[r * w + c] = ((8 - xf) * (8 - yf) * ref[ya * W + xa] + xf * (8 - yf) * ref[ya * W + xb] +
                        (8 - xf) * yf * ref[yb * W + xa] + xf * yf * ref[yb * W + xb] + 32) >> 6;
    }
  }
}

int weight1(int p, int w, int o, int denom) {
  int v = denom >= 1 ? ((p * w + (1 << (denom - 1))) >> denom) + o : p * w + o;
  return clip255(v);
}

int weight2(int a, int b, int w0, int w1, int o0, int o1, int denom) {
  return clip255(((a * w0 + b * w1 + (1 << denom)) >> (denom + 1)) + ((o0 + o1 + 1) >> 1));
}

int chroma_qp(const Tables& T, int qp, int offset) {
  return T.chroma_qp[clip3(0, 51, qp + offset)];
}

// the picture's state arrays (data/h264.py's STATE, in its order); each
// list's (mv, ref, refpic, mvd) also as lmv[list] etc.
struct State {
  int *kind, *slice, *qp, *t8, *cbp, *cmode, *modes, *nz, *nzc, *cbfdc, *mv, *ref, *refpic,
      *mvd, *dbk, *mv1, *ref1, *refpic1, *mvd1, *direct, *lists;
  int *lmv[2], *lref[2], *lpic[2], *lmvd[2];
  State(int* s, int n) {
    int* p = s;
    kind = p; p += n;
    slice = p; p += n;
    qp = p; p += n;
    t8 = p; p += n;
    cbp = p; p += n;
    cmode = p; p += n;
    modes = p; p += 16 * n;
    nz = p; p += 16 * n;
    nzc = p; p += 8 * n;
    cbfdc = p; p += 3 * n;
    mv = p; p += 32 * n;
    ref = p; p += 16 * n;
    refpic = p; p += 16 * n;
    mvd = p; p += 32 * n;
    dbk = p; p += 3 * n;
    mv1 = p; p += 32 * n;
    ref1 = p; p += 16 * n;
    refpic1 = p; p += 16 * n;
    mvd1 = p; p += 32 * n;
    direct = p; p += 16 * n;
    lists = p;
    lmv[0] = mv; lmv[1] = mv1;
    lref[0] = ref; lref[1] = ref1;
    lpic[0] = refpic; lpic[1] = refpic1;
    lmvd[0] = mvd; lmvd[1] = mvd1;
  }
};

// the co-located picture's arrays (Lists.col of data/h264.py)
struct Col {
  const int *kind, *ref[2], *mv[2], *map[2];
  Col(const int* c, int n) {
    kind = c; c += n;
    ref[0] = c; c += 16 * n;
    ref[1] = c; c += 16 * n;
    mv[0] = c; c += 32 * n;
    mv[1] = c; c += 32 * n;
    map[0] = c; c += 16 * n;
    map[1] = c;
  }
};

struct Coeffs {
  int dc[16];
  bool has_dc = false;
  int luma[16][64];
  bool has_luma[16];
  int cdc[2][4];
  bool has_cdc[2];
  int cac[2][4][16];
  bool has_cac[2][4];
  void clear() {
    has_dc = false;
    for (int i = 0; i < 16; i++) has_luma[i] = false;
    for (int c = 0; c < 2; c++) {
      has_cdc[c] = false;
      for (int r = 0; r < 4; r++) has_cac[c][r] = false;
    }
  }
};

struct Slice {
  const Tables& T;
  const int* prm;
  int mb_w, mb_h, n_mb;
  State s;
  uint8_t *Y, *U, *V;
  int W, H, CW, CH;
  const uint8_t* const* refs[2];  // (Y, U, V) per reference of each list
  const int* ref_ids[2];
  int n_refs[2];
  const int* weights[2];  // each reference's 6 explicit weights and offsets
  const int* implicit;    // w0 by (L0, L1) index
  const int* dist_scale;  // DistScaleFactor by L0 index
  Col col;
  const int *ls4, *ls8;  // (6, 6, 16) and (2, 6, 64)
  bool cabac;
  int slice_type, num_ref[2], slice_num, constrained, t8_mode, weight_mode;
  Bits r;
  Cabac cab;
  int qp, last_dqp = 0, i16_mode = 0;
  bool done[2][16];  // each list's 4x4 blocks predicted

  Slice(const Tables& t, const uint8_t* data, int64_t len, int64_t bitpos, const int* p,
        int* state, const uint8_t* const* rf, const int* ids, const int* nr, const int* wt,
        const int* imp, const int* dsf, const int* colarr, const int* l4, const int* l8,
        uint8_t* y, uint8_t* u, uint8_t* v)
      : T(t), prm(p), mb_w(p[PR_MB_W]), mb_h(p[PR_MB_H]), n_mb(mb_w * mb_h),
        s(state, mb_w * mb_h), Y(y), U(u), V(v), W(16 * mb_w), H(16 * mb_h), CW(8 * mb_w),
        CH(8 * mb_h), implicit(imp), dist_scale(dsf), col(colarr, mb_w * mb_h), ls4(l4), ls8(l8),
        cabac(p[PR_CABAC]), slice_type(p[PR_TYPE]), slice_num(p[PR_SLICE_NUM]),
        constrained(p[PR_CONSTRAINED]), t8_mode(p[PR_T8_MODE]), weight_mode(p[PR_WEIGHT_MODE]),
        r(data, len, bitpos), qp(p[PR_QP]) {
    n_refs[0] = nr[0];
    n_refs[1] = nr[1];
    refs[0] = rf;
    refs[1] = rf + 3 * nr[0];
    ref_ids[0] = ids;
    ref_ids[1] = ids + nr[0];
    weights[0] = wt;
    weights[1] = wt + 6 * nr[0];
    num_ref[0] = p[PR_NUM_REF];
    num_ref[1] = p[PR_NUM_REF1];
    cab.r = &r;
    cab.T = &T;
    if (cabac) {
      r.pos = (r.pos + 7) & ~7LL;
      cab.init(slice_type != I_SLICE ? p[PR_INIT_IDC] : -1, p[PR_QP]);
      cab.start();
    }
    for (int l = 0; l < 2; l++)
      for (int k = 0; k < 16; k++) done[l][k] = false;
  }

  // neighbours
  bool available(int n) const { return n >= 0 && n < n_mb && s.slice[n] == slice_num; }
  int mb_a(int a) const { return a % mb_w && available(a - 1) ? a - 1 : -1; }
  int mb_b(int a) const { return available(a - mb_w) ? a - mb_w : -1; }
  int mb_c(int a) const { return (a + 1) % mb_w && available(a - mb_w + 1) ? a - mb_w + 1 : -1; }
  int mb_d(int a) const { return a % mb_w && available(a - mb_w - 1) ? a - mb_w - 1 : -1; }
  // (macroblock, raster 4x4 index) of luma location (x, y) relative to a
  int neighbour4(int a, int x, int y, int* idx) const {
    if (x >= 0 && x < 16 && y >= 0 && y < 16) {
      *idx = (y >> 2) * 4 + (x >> 2);
      return a;
    }
    *idx = -1;
    if (y >= 16 || (x >= 16 && y >= 0)) return -1;
    int n;
    if (y < 0)
      n = x < 0 ? mb_d(a) : x < 16 ? mb_b(a) : mb_c(a);
    else
      n = mb_a(a);
    if (n < 0) return -1;
    *idx = (((y + 16) & 15) >> 2) * 4 + (((x + 16) & 15) >> 2);
    return n;
  }
  bool intra_avail(int n) const { return n >= 0 && (!constrained || s.kind[n] <= PCM); }

  void check(int a) {
    if (a >= n_mb) fail(ERR_PAST_END);
    if (s.slice[a] != -1) fail(ERR_TWICE);
  }

  int decode() {
    int a = prm[PR_FIRST_MB];
    bool inter = slice_type != I_SLICE;
    int skip_base = slice_type == B_SLICE ? 24 : 11;
    while (true) {
      if (inter && !cabac) {
        uint32_t run = r.ue();
        for (uint32_t k = 0; k < run; k++) {
          check(a);
          skip(a);
          a++;
        }
        if (run && !r.more_rbsp_data()) return a;
      }
      check(a);
      if (inter && cabac && cab.decision(skip_base + skip_ctx(a)))
        skip(a);
      else
        macroblock(a);
      a++;
      if (cabac) {
        if (cab.terminate()) return a;
      } else if (!r.more_rbsp_data()) {
        return a;
      }
    }
  }

  int skip_ctx(int a) const {
    int inc = 0;
    int na = mb_a(a), nb = mb_b(a);
    if (na >= 0 && !is_skip(s.kind[na])) inc++;
    if (nb >= 0 && !is_skip(s.kind[nb])) inc++;
    return inc;
  }
  void skip(int a) {
    if (slice_type == B_SLICE)
      b_skip(a);
    else
      p_skip(a);
  }

  void start_mb(int a, int kind) {
    s.kind[a] = kind;
    s.slice[a] = slice_num;
    s.lists[a] = slice_type == B_SLICE ? 2 : 1;
    s.dbk[3 * a] = prm[PR_DBK_IDC];
    s.dbk[3 * a + 1] = prm[PR_DBK_A];
    s.dbk[3 * a + 2] = prm[PR_DBK_B];
    s.qp[a] = qp;
    s.t8[a] = s.cbp[a] = s.cmode[a] = 0;
    s.cbfdc[3 * a] = s.cbfdc[3 * a + 1] = s.cbfdc[3 * a + 2] = 0;
    for (int k = 16 * a; k < 16 * a + 16; k++) {
      s.modes[k] = -1;
      s.nz[k] = s.direct[k] = 0;
      for (int l = 0; l < 2; l++) {
        s.lref[l][k] = s.lpic[l][k] = -1;
        s.lmv[l][2 * k] = s.lmv[l][2 * k + 1] = s.lmvd[l][2 * k] = s.lmvd[l][2 * k + 1] = 0;
      }
    }
    for (int k = 8 * a; k < 8 * a + 8; k++) s.nzc[k] = 0;
    for (int l = 0; l < 2; l++)
      for (int k = 0; k < 16; k++) done[l][k] = false;
  }

  void macroblock(int a) {
    int raw;
    if (!cabac)
      raw = (int)r.ue();
    else if (slice_type == P_SLICE)
      raw = cab.mb_type_p();
    else if (slice_type == B_SLICE)
      raw = cab.mb_type_b(mb_type_b_inc(a));
    else
      raw = cab.mb_type_i(mb_type_inc(a), 3);
    int kind, itype = -1;
    const int* modes = nullptr;
    if (slice_type == P_SLICE && raw < 5) {
      static const int kinds[5] = {P16X16, P16X8, P8X16, P8X8, P8X8REF0};
      kind = kinds[raw];
    } else if (slice_type == B_SLICE && raw < 23) {
      kind = raw == 22 ? B8X8 : B_KIND[raw];
      if (raw > 0 && raw < 22) modes = B_MODES[raw];
    } else {
      itype = raw - (slice_type == I_SLICE ? 0 : slice_type == P_SLICE ? 5 : 23);
      if (itype > 25) fail(ERR_MB_TYPE);
      kind = itype == 0 ? I4 : itype == 25 ? PCM : I16;
    }
    start_mb(a, kind);
    if (kind == PCM) return pcm(a);
    int t8 = 0, cbp = 0;
    bool small = false;
    if (kind == P8X8 || kind == P8X8REF0 || kind == B8X8) {
      small = sub_mb_pred(a, kind);
    } else if (kind == BDIRECT) {
      direct(a, 15);
      small = !prm[PR_DIRECT_8X8];
    } else if (kind == I4) {
      if (t8_mode) {
        t8 = cabac ? cab.decision(399 + t8_inc(a)) : r.bit();
        if (t8) {
          kind = I8;
          s.kind[a] = I8;
        }
      }
      intra_nxn_modes(a, t8);
    } else if (kind == I16) {
      i16_mode = (itype - 1) % 4;
      cbp = (((itype - 1) / 4) % 3) << 4 | (itype >= 13 ? 15 : 0);
    } else {
      static const int one[2] = {1, 1};
      mb_pred_inter(a, kind, modes ? modes : one);
    }
    if (kind == I4 || kind == I8 || kind == I16) {
      int mode = cabac ? cab.chroma_mode(cmode_inc(a)) : (int)r.ue();
      if (mode > 3) fail(ERR_RANGE);
      s.cmode[a] = mode;
    }
    if (kind != I16) {
      cbp = coded_block_pattern(a, kind <= PCM);
      if ((cbp & 15) && t8_mode && kind != I4 && kind != I8 && kind != I16 && !small)
        t8 = cabac ? cab.decision(399 + t8_inc(a)) : r.bit();
    }
    s.t8[a] = t8;
    s.cbp[a] = cbp;
    if (cbp || kind == I16) {
      int dqp = cabac ? cab.mb_qp_delta(last_dqp != 0) : r.se();
      if (dqp < -26 || dqp > 25) fail(ERR_RANGE);
      qp = (qp + dqp + 52) % 52;
      last_dqp = dqp;
    } else {
      last_dqp = 0;
    }
    s.qp[a] = qp;
    Coeffs& c = coeffs;
    c.clear();
    residual(a, kind, cbp, t8, c);
    if (kind <= PCM) {
      intra_pred_residual(a, kind, t8, c);
    } else {
      inter_pred(a);
      add_luma_residual(a, kind, t8, c);
    }
    chroma(a, kind, c);
  }
  Coeffs coeffs;

  int mb_type_inc(int a) const {
    int inc = 0;
    int na = mb_a(a), nb = mb_b(a);
    if (na >= 0 && s.kind[na] != I4 && s.kind[na] != I8) inc++;
    if (nb >= 0 && s.kind[nb] != I4 && s.kind[nb] != I8) inc++;
    return inc;
  }
  int mb_type_b_inc(int a) const {
    int inc = 0;
    int na = mb_a(a), nb = mb_b(a);
    if (na >= 0 && s.kind[na] != BSKIP && s.kind[na] != BDIRECT) inc++;
    if (nb >= 0 && s.kind[nb] != BSKIP && s.kind[nb] != BDIRECT) inc++;
    return inc;
  }
  int t8_inc(int a) const {
    int inc = 0, na = mb_a(a), nb = mb_b(a);
    if (na >= 0) inc += s.t8[na];
    if (nb >= 0) inc += s.t8[nb];
    return inc;
  }
  int cmode_inc(int a) const {
    int inc = 0;
    for (int n : {mb_a(a), mb_b(a)})
      if (n >= 0 && (s.kind[n] == I4 || s.kind[n] == I8 || s.kind[n] == I16) && s.cmode[n] != 0)
        inc++;
    return inc;
  }

  void pcm(int a) {
    Bits& b = r;
    b.pos = (b.pos + 7) & ~7LL;
    if (b.pos + 384 * 8 > b.size) fail(ERR_EOF);
    const uint8_t* p = b.data + (b.pos >> 3);
    b.pos += 384 * 8;
    int x0 = 16 * (a % mb_w), y0 = 16 * (a / mb_w);
    for (int y = 0; y < 16; y++) std::memcpy(Y + (y0 + y) * W + x0, p + 16 * y, 16);
    for (int y = 0; y < 8; y++) {
      std::memcpy(U + (y0 / 2 + y) * CW + x0 / 2, p + 256 + 8 * y, 8);
      std::memcpy(V + (y0 / 2 + y) * CW + x0 / 2, p + 320 + 8 * y, 8);
    }
    if (cabac) cab.start();
    for (int k = 16 * a; k < 16 * a + 16; k++) s.nz[k] = 16;
    for (int k = 8 * a; k < 8 * a + 8; k++) s.nzc[k] = 16;
    s.qp[a] = 0;
    s.cbp[a] = 0x2F;
    s.cbfdc[3 * a] = s.cbfdc[3 * a + 1] = s.cbfdc[3 * a + 2] = 1;
    last_dqp = 0;
  }

  int pred_intra_mode(int a, int bx, int by) const {
    int ia, ib;
    int na = neighbour4(a, 4 * bx - 1, 4 * by, &ia);
    int nb = neighbour4(a, 4 * bx, 4 * by - 1, &ib);
    if (!intra_avail(na) || !intra_avail(nb)) return 2;
    int ma = s.modes[16 * na + ia], mb = s.modes[16 * nb + ib];
    return std::min(ma < 0 ? 2 : ma, mb < 0 ? 2 : mb);
  }

  int intra_mode(int pred) {
    int rem;
    if (cabac) {
      if (cab.decision(68)) return pred;
      rem = cab.rem_intra_mode();
    } else {
      if (r.bit()) return pred;
      rem = (int)r.u(3);
    }
    return rem < pred ? rem : rem + 1;
  }

  void intra_nxn_modes(int a, int t8) {
    int base = 16 * a;
    if (t8) {
      for (int b8 = 0; b8 < 4; b8++) {
        int bx = 2 * (b8 & 1), by = 2 * (b8 >> 1);
        int mode = intra_mode(pred_intra_mode(a, bx, by));
        for (int dy = 0; dy < 2; dy++)
          for (int dx = 0; dx < 2; dx++) s.modes[base + (by + dy) * 4 + bx + dx] = mode;
      }
    } else {
      for (int blk = 0; blk < 16; blk++) {
        int rr = BLK_RASTER[blk];
        s.modes[base + rr] = intra_mode(pred_intra_mode(a, rr & 3, rr >> 2));
      }
    }
  }

  // inter partitions
  int ref_inc(int a, int x, int y, int l) const {
    int inc = 0, i;
    const int* ref = s.lref[l];
    int n = neighbour4(a, x - 1, y, &i);
    if (n >= 0 && s.kind[n] > PCM && !is_skip(s.kind[n]) && !s.direct[16 * n + i] &&
        ref[16 * n + i] > 0)
      inc += 1;
    n = neighbour4(a, x, y - 1, &i);
    if (n >= 0 && s.kind[n] > PCM && !is_skip(s.kind[n]) && !s.direct[16 * n + i] &&
        ref[16 * n + i] > 0)
      inc += 2;
    return inc;
  }
  int ref_idx(int a, int x, int y, int l) {
    int ref;
    if (cabac)
      ref = cab.ref_idx(ref_inc(a, x, y, l));
    else
      ref = num_ref[l] - 1 == 1 ? 1 - r.bit() : (int)r.ue();
    if (ref >= num_ref[l]) fail(ERR_REF);
    return ref;
  }
  void set_ref(int a, int x, int y, int w, int h, int ref, int l) {
    int pid = ref >= 0 && ref < n_refs[l] ? ref_ids[l][ref] : -1;
    for (int by = y >> 2; by < (y + h) >> 2; by++)
      for (int bx = x >> 2; bx < (x + w) >> 2; bx++) {
        int k = 16 * a + 4 * by + bx;
        s.lref[l][k] = ref;
        s.lpic[l][k] = pid;
      }
  }
  struct Nb {
    bool avail;
    int ref, x, y;
  };
  Nb mv_neighbour(int a, int x, int y, int l) const {
    int i;
    int n = neighbour4(a, x, y, &i);
    if (n < 0 || (n == a && !done[l][i])) return {false, -1, 0, 0};
    if (s.kind[n] <= PCM) return {true, -1, 0, 0};
    int k = 16 * n + i;
    return {true, s.lref[l][k], s.lmv[l][2 * k], s.lmv[l][2 * k + 1]};
  }
  void mv_pred(int a, int x, int y, int w, int h, int ref, int kind, int part, int l,
               int* mvp) const {
    Nb na = mv_neighbour(a, x - 1, y, l), nb = mv_neighbour(a, x, y - 1, l);
    Nb nc = mv_neighbour(a, x + w, y - 1, l);
    if (!nc.avail) nc = mv_neighbour(a, x - 1, y - 1, l);
    (void)h;
    if (kind == P16X8 || kind == B16X8) {
      if (part == 0 && nb.ref == ref) return (void)(mvp[0] = nb.x, mvp[1] = nb.y);
      if (part == 1 && na.ref == ref) return (void)(mvp[0] = na.x, mvp[1] = na.y);
    } else if (kind == P8X16 || kind == B8X16) {
      if (part == 0 && na.ref == ref) return (void)(mvp[0] = na.x, mvp[1] = na.y);
      if (part == 1 && nc.ref == ref) return (void)(mvp[0] = nc.x, mvp[1] = nc.y);
    }
    if (!nb.avail && !nc.avail && na.avail) nb = nc = na;
    int matches = (na.ref == ref) + (nb.ref == ref) + (nc.ref == ref);
    if (matches == 1) {
      const Nb& m = na.ref == ref ? na : nb.ref == ref ? nb : nc;
      mvp[0] = m.x;
      mvp[1] = m.y;
      return;
    }
    mvp[0] = median3(na.x, nb.x, nc.x);
    mvp[1] = median3(na.y, nb.y, nc.y);
  }
  int mvd_inc(int a, int x, int y, int comp, int l) const {
    int total = 0, i;
    const int* mvd = s.lmvd[l];
    int n = neighbour4(a, x - 1, y, &i);
    if (n >= 0) total += mvd[2 * (16 * n + i) + comp];
    n = neighbour4(a, x, y - 1, &i);
    if (n >= 0) total += mvd[2 * (16 * n + i) + comp];
    return total < 3 ? 0 : total <= 32 ? 1 : 2;
  }
  void store_mv(int a, int x, int y, int w, int h, int mvx, int mvy, int dx, int dy, int l) {
    if (mvx < -8192 || mvx >= 8192 || mvy < -8192 || mvy >= 8192) fail(ERR_MV);
    for (int by = y >> 2; by < (y + h) >> 2; by++)
      for (int bx = x >> 2; bx < (x + w) >> 2; bx++) {
        int k = 16 * a + 4 * by + bx;
        s.lmv[l][2 * k] = mvx;
        s.lmv[l][2 * k + 1] = mvy;
        s.lmvd[l][2 * k] = std::abs(dx);
        s.lmvd[l][2 * k + 1] = std::abs(dy);
        done[l][4 * by + bx] = true;
      }
  }
  void motion_vector(int a, int x, int y, int w, int h, const int* mvp, int l) {
    int d[2];
    for (int comp = 0; comp < 2; comp++)
      d[comp] = cabac ? cab.mvd(comp, mvd_inc(a, x, y, comp, l)) : r.se();
    store_mv(a, x, y, w, h, mvp[0] + d[0], mvp[1] + d[1], d[0], d[1], l);
  }
  // partitions of a 16x16, 16x8 or 8x16 kind: (x, y, w, h)
  static int parts_of(int kind, int parts[2][4]) {
    static const int P16[1][4] = {{0, 0, 16, 16}}, P168[2][4] = {{0, 0, 16, 8}, {0, 8, 16, 8}},
                     P816[2][4] = {{0, 0, 8, 16}, {8, 0, 8, 16}};
    const int(*src)[4] = kind == P16X16 || kind == B16X16 ? P16
                         : kind == P16X8 || kind == B16X8 ? P168 : P816;
    int n = src == P16 ? 1 : 2;
    for (int p = 0; p < n; p++) std::memcpy(parts[p], src[p], sizeof parts[p]);
    return n;
  }
  // mb_pred of a 16x16, 16x8 or 8x16 kind whose partitions use the lists modes
  void mb_pred_inter(int a, int kind, const int* modes) {
    int parts[2][4];
    int n = parts_of(kind, parts);
    int refs[2][2] = {{-1, -1}, {-1, -1}};
    for (int l = 0; l < 2; l++)
      for (int p = 0; p < n; p++)
        if (modes[p] >> l & 1) {
          refs[l][p] = num_ref[l] > 1 ? ref_idx(a, parts[p][0], parts[p][1], l) : 0;
          set_ref(a, parts[p][0], parts[p][1], parts[p][2], parts[p][3], refs[l][p], l);
        }
    for (int l = 0; l < 2; l++)
      for (int p = 0; p < n; p++) {
        const int* q = parts[p];
        if (modes[p] >> l & 1) {
          int mvp[2];
          mv_pred(a, q[0], q[1], q[2], q[3], refs[l][p], kind, p, l, mvp);
          motion_vector(a, q[0], q[1], q[2], q[3], mvp, l);
        } else {
          store_mv(a, q[0], q[1], q[2], q[3], 0, 0, 0, 0, l);
        }
      }
  }
  bool sub_mb_pred(int a, int kind) {
    bool b = kind == B8X8;
    const int(*table)[3] = b ? B_SUB : P_SUB;
    int subs[4];
    for (int k = 0; k < 4; k++) {
      subs[k] = !cabac ? (int)r.ue() : b ? cab.sub_mb_type_b() : cab.sub_mb_type();
      if (subs[k] > (b ? 12 : 3)) fail(ERR_RANGE);
    }
    int direct_mask = 0;
    for (int k = 0; k < 4; k++)
      if (b && subs[k] == 0) direct_mask |= 1 << k;
    if (direct_mask) direct(a, direct_mask);
    int lists = b ? 2 : 1;
    int refs[2][4];
    for (int l = 0; l < lists; l++)
      for (int b8 = 0; b8 < 4; b8++) {
        if (direct_mask >> b8 & 1) continue;
        int x = 8 * (b8 & 1), y = 8 * (b8 >> 1);
        if (table[subs[b8]][2] >> l & 1)
          refs[l][b8] = num_ref[l] > 1 && kind != P8X8REF0 ? ref_idx(a, x, y, l) : 0;
        else
          refs[l][b8] = -1;
        set_ref(a, x, y, 8, 8, refs[l][b8], l);
      }
    for (int l = 0; l < lists; l++)
      for (int b8 = 0; b8 < 4; b8++) {
        int x8 = 8 * (b8 & 1), y8 = 8 * (b8 >> 1);
        if (direct_mask >> b8 & 1) {
          for (int k = 0; k < 4; k++) done[l][BLK_RASTER[4 * b8 + k]] = true;
          continue;
        }
        int w = table[subs[b8]][0], h = table[subs[b8]][1];
        if (!(table[subs[b8]][2] >> l & 1)) {
          store_mv(a, x8, y8, 8, 8, 0, 0, 0, 0, l);
          continue;
        }
        int count = w == 4 && h == 4 ? 4 : w == 8 && h == 8 ? 1 : 2;
        for (int sub = 0; sub < count; sub++) {
          int x, y;
          if (w == 4 && h == 4) {
            x = x8 + 4 * (sub & 1);
            y = y8 + 4 * (sub >> 1);
          } else {
            x = x8 + 4 * sub * (w == 4);
            y = y8 + 4 * sub * (h == 4);
          }
          int mvp[2];
          mv_pred(a, x, y, w, h, refs[l][b8], kind, -1, l, mvp);
          motion_vector(a, x, y, w, h, mvp, l);
        }
      }
    if (direct_mask && !prm[PR_DIRECT_8X8]) return true;
    for (int k = 0; k < 4; k++)
      if (!(direct_mask >> k & 1) && (table[subs[k]][0] != 8 || table[subs[k]][1] != 8))
        return true;
    return false;
  }
  void p_skip_mv(int a, int* mv) const {
    Nb na = mv_neighbour(a, -1, 0, 0), nb = mv_neighbour(a, 0, -1, 0);
    if (!na.avail || !nb.avail || (na.ref == 0 && na.x == 0 && na.y == 0) ||
        (nb.ref == 0 && nb.x == 0 && nb.y == 0)) {
      mv[0] = mv[1] = 0;
      return;
    }
    mv_pred(a, 0, 0, 16, 16, 0, P16X16, 0, 0, mv);
  }
  void p_skip(int a) {
    start_mb(a, PSKIP);
    int mv[2];
    p_skip_mv(a, mv);
    set_ref(a, 0, 0, 16, 16, 0, 0);
    store_mv(a, 0, 0, 16, 16, mv[0], mv[1], 0, 0, 0);
    last_dqp = 0;
    inter_pred(a);
  }
  void b_skip(int a) {
    start_mb(a, BSKIP);
    direct(a, 15);
    last_dqp = 0;
    inter_pred(a);
  }
  // direct prediction (8.4.1.2) of the 8x8 blocks in mask b8s
  void direct(int a, int b8s) {
    bool spatial = prm[PR_DIRECT_SPATIAL], infer = prm[PR_DIRECT_8X8];
    int refs[2] = {0, 0}, mvps[2][2] = {{0, 0}, {0, 0}};
    bool zero = false;
    if (spatial) {
      for (int l = 0; l < 2; l++) {
        Nb na = mv_neighbour(a, -1, 0, l), nb = mv_neighbour(a, 0, -1, l);
        Nb nc = mv_neighbour(a, 16, -1, l);
        if (!nc.avail) nc = mv_neighbour(a, -1, -1, l);
        int ref = -1;
        for (int cand : {na.ref, nb.ref, nc.ref})
          if (cand >= 0 && (ref < 0 || cand < ref)) ref = cand;
        refs[l] = ref;
        if (ref >= 0) mv_pred(a, 0, 0, 16, 16, ref, B16X16, 0, l, mvps[l]);
      }
      if (refs[0] < 0 && refs[1] < 0) {
        refs[0] = refs[1] = 0;
        zero = true;
      }
    }
    bool col_intra = col.kind[a] <= PCM;
    for (int b8 = 0; b8 < 4; b8++) {
      if (!(b8s >> b8 & 1)) continue;
      for (int j = 0; j < 4; j++) {
        int rr = BLK_RASTER[4 * b8 + j], bx = rr & 3, by = rr >> 2;
        int ck = 16 * a + (infer ? (by >> 1) * 12 + (bx >> 1) * 3 : rr);
        int col_ref = -1, col_list = 0, cmv[2] = {0, 0};
        if (!col_intra) {
          col_list = col.ref[0][ck] >= 0 ? 0 : 1;
          col_ref = col.ref[col_list][ck];
          cmv[0] = col.mv[col_list][2 * ck];
          cmv[1] = col.mv[col_list][2 * ck + 1];
        }
        int bref[2], bmv[2][2];
        if (spatial) {
          bool col_zero = prm[PR_COL_SHORT] && col_ref == 0 && std::abs(cmv[0]) <= 1 &&
                          std::abs(cmv[1]) <= 1;
          for (int l = 0; l < 2; l++) {
            bref[l] = refs[l];
            bool z = refs[l] < 0 || zero || (refs[l] == 0 && col_zero);
            bmv[l][0] = z ? 0 : mvps[l][0];
            bmv[l][1] = z ? 0 : mvps[l][1];
          }
        } else {
          int ref0 = col_intra ? 0 : col.map[col_list][ck];
          int scale = dist_scale[ref0];
          bref[0] = ref0;
          bref[1] = 0;
          bmv[0][0] = (scale * cmv[0] + 128) >> 8;
          bmv[0][1] = (scale * cmv[1] + 128) >> 8;
          bmv[1][0] = bmv[0][0] - cmv[0];
          bmv[1][1] = bmv[0][1] - cmv[1];
        }
        int k = 16 * a + rr;
        s.direct[k] = 1;
        for (int l = 0; l < 2; l++) {
          s.lref[l][k] = bref[l];
          s.lpic[l][k] = bref[l] >= 0 && bref[l] < n_refs[l] ? ref_ids[l][bref[l]] : -1;
          s.lmv[l][2 * k] = bmv[l][0];
          s.lmv[l][2 * k + 1] = bmv[l][1];
        }
      }
    }
  }

  int cbp_luma_inc(int a, int b8, int luma) const {
    int conds[2];
    for (int k = 0; k < 2; k++) {
      int n = k == 0 ? mb_a(a) : mb_b(a);
      bool inside = k == 0 ? (b8 & 1) : (b8 >> 1);
      int nb8 = k == 0 ? ((b8 & 1) ? b8 - 1 : b8 + 1) : ((b8 >> 1) ? b8 - 2 : b8 + 2);
      if (inside)
        conds[k] = (luma >> nb8) & 1 ? 0 : 1;
      else if (n < 0 || s.kind[n] == PCM)
        conds[k] = 0;
      else if (!is_skip(s.kind[n]) && ((s.cbp[n] >> nb8) & 1))
        conds[k] = 0;
      else
        conds[k] = 1;
    }
    return conds[0] + 2 * conds[1];
  }
  int coded_block_pattern(int a, bool intra) {
    if (!cabac) {
      uint32_t code = r.ue();
      if (code > 47) fail(ERR_RANGE);
      return (intra ? T.cbp_intra : T.cbp_inter)[code];
    }
    int luma = 0;
    for (int b8 = 0; b8 < 4; b8++) luma |= cab.decision(73 + cbp_luma_inc(a, b8, luma)) << b8;
    int inc0 = 0, inc1 = 0;
    int ns[2] = {mb_a(a), mb_b(a)};
    for (int k = 0; k < 2; k++) {
      int n = ns[k];
      if (n < 0) continue;
      int chroma = s.kind[n] == PCM ? 2 : is_skip(s.kind[n]) ? 0 : s.cbp[n] >> 4;
      inc0 += (1 + k) * (chroma != 0);
      inc1 += (1 + k) * (chroma == 2);
    }
    return luma | cab.cbp_chroma(inc0, inc1) << 4;
  }

  // residual
  static int nc_of(int na, bool ha, int nb, bool hb) {
    if (ha && hb) return (na + nb + 1) >> 1;
    return ha ? na : hb ? nb : 0;
  }
  int nc_luma(int a, int rr) const {
    int bx = rr & 3, by = rr >> 2, v[2];
    bool h[2];
    int xy[2][2] = {{4 * bx - 1, 4 * by}, {4 * bx, 4 * by - 1}};
    for (int k = 0; k < 2; k++) {
      int i;
      int n = neighbour4(a, xy[k][0], xy[k][1], &i);
      h[k] = n >= 0;
      v[k] = n < 0 ? 0 : is_skip(s.kind[n]) ? 0 : s.nz[16 * n + i];
    }
    return nc_of(v[0], h[0], v[1], h[1]);
  }
  int nc_chroma(int a, int comp, int rr) const {
    int bx = rr & 1, by = rr >> 1, v[2];
    bool h[2];
    for (int k = 0; k < 2; k++) {
      int x = bx + (k == 0 ? -1 : 0), y = by + (k == 0 ? 0 : -1);
      if (x >= 0 && x < 2 && y >= 0 && y < 2) {
        h[k] = true;
        v[k] = s.nzc[8 * a + 4 * comp + 2 * y + x];
        continue;
      }
      int n = x < 0 ? mb_a(a) : mb_b(a);
      h[k] = n >= 0;
      v[k] = n < 0 ? 0 : is_skip(s.kind[n]) ? 0 : s.nzc[8 * n + 4 * comp + 2 * (y & 1) + (x & 1)];
    }
    return nc_of(v[0], h[0], v[1], h[1]);
  }
  int cbf_ctx(int a, int cat, int comp, int rr) const {
    bool intra = s.kind[a] <= PCM;
    int inc = 0;
    for (int k = 0; k < 2; k++) {
      int dx = k == 0 ? -1 : 0, dy = k == 0 ? 0 : -1;
      int n, i = 0;
      if (cat == 1 || cat == 2) {
        n = neighbour4(a, 4 * (rr & 3) + 4 * dx, 4 * (rr >> 2) + 4 * dy, &i);
      } else if (cat == 4) {
        int x = (rr & 1) + dx, y = (rr >> 1) + dy;
        if (x >= 0 && x < 2 && y >= 0 && y < 2) {
          n = a;
          i = 2 * y + x;
        } else {
          n = x < 0 ? mb_a(a) : mb_b(a);
          i = 2 * (y & 1) + (x & 1);
        }
      } else {
        n = dx ? mb_a(a) : mb_b(a);
      }
      int cond;
      if (n < 0)
        cond = intra ? 1 : 0;
      else if (s.kind[n] == PCM)
        cond = 1;
      else if (is_skip(s.kind[n]))
        cond = 0;
      else if (cat == 0)
        cond = s.kind[n] == I16 ? s.cbfdc[3 * n] : 0;
      else if (cat == 3)
        cond = (s.cbp[n] >> 4) ? s.cbfdc[3 * n + 1 + comp] : 0;
      else if (cat == 4)
        cond = (s.cbp[n] >> 4) == 2 ? s.nzc[8 * n + 4 * comp + i] > 0 : 0;
      else
        cond = ((s.cbp[n] >> ((i >> 3) * 2 + ((i & 3) >> 1))) & 1) ? s.nz[16 * n + i] > 0 : 0;
      inc += cond << k;
    }
    return inc;
  }
  // CAVLC's residual_block_cavlc: levels in scan order, TotalCoeff returned
  int cavlc_block(int nc, int max_num, int* levels) {
    for (int i = 0; i < max_num; i++) levels[i] = 0;
    const Vlc& tok = nc < 0 ? VLCS.cdc_token : VLCS.token[nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3];
    int sym = r.vlc(tok);
    int total = sym >> 2, ones = sym & 3;
    if (total == 0) return 0;
    if (total > max_num) fail(ERR_COEFFS);
    int vals[16];
    int suffix_length = total > 10 && ones < 3 ? 1 : 0;
    for (int i = 0; i < total; i++) {
      if (i < ones) {
        vals[i] = 1 - 2 * r.bit();
        continue;
      }
      int prefix = 0;
      while (!r.bit())
        if (++prefix > 32) fail(ERR_VLC);
      int code = std::min(15, prefix) << suffix_length;
      if (suffix_length > 0 || prefix >= 14) {
        int size = suffix_length;
        if (prefix == 14 && suffix_length == 0) size = 4;
        if (prefix >= 15) size = prefix - 3;
        code += (int)r.u(size);
      }
      if (prefix >= 15 && suffix_length == 0) code += 15;
      if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
      if (i == ones && ones < 3) code += 2;
      int level = code % 2 == 0 ? (code + 2) >> 1 : (-code - 1) >> 1;
      vals[i] = level;
      if (suffix_length == 0) suffix_length = 1;
      if (std::abs(level) > (3 << (suffix_length - 1)) && suffix_length < 6) suffix_length++;
    }
    int zeros = 0;
    if (total < max_num) {
      zeros = r.vlc(nc < 0 ? VLCS.cdc_tz[total - 1] : VLCS.tz[total - 1]);
      if (zeros > max_num - total) fail(ERR_COEFFS);
    }
    int pos = total + zeros - 1;
    for (int i = 0; i < total; i++) {
      levels[pos] = vals[i];
      if (i < total - 1 && zeros > 0) {
        int run = r.vlc(VLCS.run[std::min(zeros, 7) - 1]);
        if (run > zeros) fail(ERR_COEFFS);
        zeros -= run;
        pos -= run;
      }
      pos--;
    }
    return total;
  }
  int block(int a, int cat, int max_num, int nc, int comp, int rr, int* levels) {
    if (!cabac) return cavlc_block(nc, max_num, levels);
    if (cat != 5 && !cab.decision(85 + 4 * cat + cbf_ctx(a, cat, comp, rr))) {
      for (int i = 0; i < max_num; i++) levels[i] = 0;
      return 0;
    }
    cab.residual_block(cat, max_num, levels);
    int n = 0;
    for (int i = 0; i < max_num; i++) n += levels[i] != 0;
    return n;
  }
  void residual(int a, int kind, int cbp, int t8, Coeffs& c) {
    int base = 16 * a;
    int lv[64];
    if (kind == I16) {
      int n = block(a, 0, 16, nc_luma(a, 0), 0, 0, c.dc);
      c.has_dc = true;
      s.cbfdc[3 * a] = n > 0;
    }
    for (int b8 = 0; b8 < 4; b8++) {
      int rs[4];
      for (int k = 0; k < 4; k++) rs[k] = BLK_RASTER[4 * b8 + k];
      if (!((cbp >> b8) & 1)) {
        for (int k = 0; k < 4; k++) s.nz[base + rs[k]] = 0;
        continue;
      }
      if (t8 && cabac) {
        int n = block(a, 5, 64, 0, 0, rs[0], c.luma[rs[0]]);
        c.has_luma[rs[0]] = true;
        for (int k = 0; k < 4; k++) s.nz[base + rs[k]] = n;
        continue;
      }
      if (t8) {
        int* full = c.luma[rs[0]];
        for (int i = 0; i < 64; i++) full[i] = 0;
        for (int k = 0; k < 4; k++) {
          int n = block(a, 2, 16, nc_luma(a, rs[k]), 0, rs[k], lv);
          s.nz[base + rs[k]] = n;
          for (int i = 0; i < 16; i++) full[4 * i + k] = lv[i];
        }
        c.has_luma[rs[0]] = true;
        continue;
      }
      for (int k = 0; k < 4; k++) {
        int rr = rs[k], n;
        if (kind == I16) {
          n = block(a, 1, 15, nc_luma(a, rr), 0, rr, lv);
          c.luma[rr][0] = 0;
          for (int i = 0; i < 15; i++) c.luma[rr][i + 1] = lv[i];
        } else {
          n = block(a, 2, 16, nc_luma(a, rr), 0, rr, c.luma[rr]);
        }
        s.nz[base + rr] = n;
        c.has_luma[rr] = true;
      }
    }
    int chroma = cbp >> 4;
    for (int comp = 0; comp < 2; comp++) {
      if (chroma) {
        int n = block(a, 3, 4, -1, comp, 0, c.cdc[comp]);
        c.has_cdc[comp] = true;
        s.cbfdc[3 * a + 1 + comp] = n > 0;
      } else {
        s.cbfdc[3 * a + 1 + comp] = 0;
      }
    }
    for (int comp = 0; comp < 2; comp++)
      for (int rr = 0; rr < 4; rr++) {
        int n = 0;
        if (chroma == 2) {
          n = block(a, 4, 15, nc_chroma(a, comp, rr), comp, rr, lv);
          c.cac[comp][rr][0] = 0;
          for (int i = 0; i < 15; i++) c.cac[comp][rr][i + 1] = lv[i];
          c.has_cac[comp][rr] = true;
        }
        s.nzc[8 * a + 4 * comp + rr] = n;
      }
  }

  // reconstruction
  const int* lscale4(int list, int q) const { return ls4 + (list * 6 + q % 6) * 16; }
  const int* lscale8(int list, int q) const { return ls8 + (list * 6 + q % 6) * 64; }
  void residual4(const int* levels, const int* ls, int q, int* out, bool has_dc = false,
                 int dc = 0) {
    int c[16] = {0}, d[16];
    for (int i = 0; i < 16; i++)
      if (levels[i]) c[T.zz4[i]] = levels[i];
    scale4(c, ls, q, d);
    if (has_dc) d[0] = dc;
    idct4(d, out);
  }
  void residual8(const int* levels, const int* ls, int q, int* out) {
    int c[64] = {0}, d[64];
    for (int i = 0; i < 64; i++)
      if (levels[i]) c[T.zz8[i]] = levels[i];
    scale8(c, ls, q, d);
    idct8(d, out);
  }
  void add_luma_residual(int a, int kind, int t8, const Coeffs& c) {
    int x0 = 16 * (a % mb_w), y0 = 16 * (a / mb_w);
    bool intra = kind <= PCM;
    int res[64];
    for (int rr = 0; rr < 16; rr++) {
      if (!c.has_luma[rr]) continue;
      int bx = 4 * (rr & 3), by = 4 * (rr >> 2), n;
      if (t8) {
        residual8(c.luma[rr], lscale8(intra ? 0 : 1, qp), qp, res);
        n = 8;
      } else {
        residual4(c.luma[rr], lscale4(intra ? 0 : 3, qp), qp, res);
        n = 4;
      }
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
          uint8_t& p = Y[(y0 + by + y) * W + x0 + bx + x];
          p = (uint8_t)clip255(p + res[y * n + x]);
        }
    }
  }
  // (top, left, corner) of a block; `right` top-right samples after the top ones
  void neighbour_samples(const uint8_t* plane, int stride, int x0, int y0, int size, bool top_ok,
                         bool left_ok, bool corner_ok, bool topright_ok, int right, int* top,
                         int* left, int* corner) const {
    if (top_ok) {
      for (int k = 0; k < size; k++) top[k] = plane[(y0 - 1) * stride + x0 + k];
      for (int k = 0; k < right; k++)
        top[size + k] = topright_ok ? plane[(y0 - 1) * stride + x0 + size + k] : top[size - 1];
    }
    if (left_ok)
      for (int k = 0; k < size; k++) left[k] = plane[(y0 + k) * stride + x0 - 1];
    if (corner_ok) *corner = plane[(y0 - 1) * stride + x0 - 1];
  }
  static bool decoded_before(int tx, int ty, int bx, int by, int n) {
    if (n == 8) return (ty >> 3) * 2 + (tx >> 3) < (by >> 3) * 2 + (bx >> 3);
    return BLK_ORDER[(ty >> 2) * 4 + (tx >> 2)] < BLK_ORDER[(by >> 2) * 4 + (bx >> 2)];
  }
  void intra_pred_residual(int a, int kind, int t8, const Coeffs& c) {
    int x0 = 16 * (a % mb_w), y0 = 16 * (a / mb_w);
    bool ok_a = intra_avail(mb_a(a)), ok_b = intra_avail(mb_b(a));
    bool ok_c = intra_avail(mb_c(a)), ok_d = intra_avail(mb_d(a));
    int top[32], left[16], corner = 0, pred[256], res[64];
    if (kind == I16) {
      neighbour_samples(Y, W, x0, y0, 16, ok_b, ok_a, ok_d, false, 0, top, left, &corner);
      int mode = i16_mode;
      if ((mode == 0 && !ok_b) || (mode == 1 && !ok_a) || (mode == 3 && !(ok_a && ok_b && ok_d)))
        fail(ERR_INTRA_MODE);
      intra_16x16(mode, ok_b ? top : nullptr, ok_a ? left : nullptr, corner, pred);
      int dc_raster[16] = {0}, dcs[16];
      for (int i = 0; i < 16; i++) dc_raster[T.zz4[i]] = c.dc[i];
      const int* ls = lscale4(0, qp);
      luma_dc(dc_raster, ls[0], qp, dcs);
      static const int zero[16] = {0};
      for (int rr = 0; rr < 16; rr++) {
        int bx = 4 * (rr & 3), by = 4 * (rr >> 2);
        residual4(c.has_luma[rr] ? c.luma[rr] : zero, ls, qp, res, true, dcs[rr]);
        for (int y = 0; y < 4; y++)
          for (int x = 0; x < 4; x++)
            Y[(y0 + by + y) * W + x0 + bx + x] =
                (uint8_t)clip255(pred[(by + y) * 16 + bx + x] + res[y * 4 + x]);
      }
      return;
    }
    int n = t8 ? 8 : 4;
    for (int blk = 0; blk < (t8 ? 4 : 16); blk++) {
      int bx, by;
      if (t8) {
        bx = 8 * (blk & 1);
        by = 8 * (blk >> 1);
      } else {
        int rr = BLK_RASTER[blk];
        bx = 4 * (rr & 3);
        by = 4 * (rr >> 2);
      }
      int mode = s.modes[16 * a + (by >> 2) * 4 + (bx >> 2)];
      bool top_ok = by == 0 ? ok_b : true;
      bool left_ok = bx == 0 ? ok_a : true;
      bool corner_ok = by == 0 ? (bx == 0 ? ok_d : ok_b) : (bx == 0 ? ok_a : true);
      int tx = bx + n, ty = by - 1;
      bool topright_ok;
      if (ty < 0)
        topright_ok = tx >= 16 ? ok_c : ok_b;
      else if (tx >= 16)
        topright_ok = false;
      else
        topright_ok = decoded_before(tx, ty, bx, by, n);
      neighbour_samples(Y, W, x0 + bx, y0 + by, n, top_ok, left_ok, corner_ok, topright_ok, n,
                        top, left, &corner);
      bool need_top = mode == 0 || mode == 3 || mode == 4 || mode == 5 || mode == 6 || mode == 7;
      bool need_left = mode == 1 || mode == 4 || mode == 5 || mode == 6 || mode == 8;
      if ((need_top && !top_ok) || (need_left && !left_ok) ||
          ((mode == 4 || mode == 5 || mode == 6) && !corner_ok))
        fail(ERR_INTRA_MODE);
      if (t8) filter_8x8_refs(top, top_ok, left, left_ok, &corner, corner_ok);
      intra_nxn(n, mode, top_ok ? top : nullptr, left_ok ? left : nullptr, corner, pred);
      int rr = (by >> 2) * 4 + (bx >> 2);
      if (c.has_luma[rr]) {
        if (t8)
          residual8(c.luma[rr], lscale8(0, qp), qp, res);
        else
          residual4(c.luma[rr], lscale4(0, qp), qp, res);
        for (int k = 0; k < n * n; k++) pred[k] += res[k];
      }
      for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++)
          Y[(y0 + by + y) * W + x0 + bx + x] = (uint8_t)clip255(pred[y * n + x]);
    }
  }
  // the prediction of one block from list l's reference ref
  void predict(int l, int ref, int x, int y, int w, int h, int mvx, int mvy, int* py, int* pu,
               int* pv) const {
    if (ref < 0 || ref >= n_refs[l]) fail(ERR_NO_REF);
    const uint8_t* const* rp = refs[l] + 3 * ref;
    luma_mc(rp[0], W, H, x, y, w, h, mvx, mvy, py);
    chroma_mc(rp[1], CW, CH, x >> 1, y >> 1, w >> 1, h >> 1, mvx, mvy, pu);
    chroma_mc(rp[2], CW, CH, x >> 1, y >> 1, w >> 1, h >> 1, mvx, mvy, pv);
  }
  // motion-compensated prediction of the macroblock: its 4x4 blocks of
  // equal references and vectors merged into 16x16 or 8x8 blocks, each
  // from one list or both, weighted as the slice says
  void inter_pred(int a) {
    int x0 = 16 * (a % mb_w), y0 = 16 * (a / mb_w);
    int keys[16][6];
    for (int rr = 0; rr < 16; rr++) {
      int k = 16 * a + rr;
      int key[6] = {s.ref[k], s.ref1[k], s.mv[2 * k], s.mv[2 * k + 1], s.mv1[2 * k],
                    s.mv1[2 * k + 1]};
      std::memcpy(keys[rr], key, sizeof key);
    }
    auto same = [&](int i, int j) { return std::memcmp(keys[i], keys[j], sizeof keys[i]) == 0; };
    int blocks[16][3], nb = 0;  // (raster index, x, size)
    bool whole = true;
    for (int rr = 1; rr < 16; rr++) whole = whole && same(0, rr);
    if (whole) {
      blocks[nb][0] = 0;
      blocks[nb++][2] = 16;
    } else {
      for (int b8 = 0; b8 < 4; b8++) {
        const int* rs = BLK_RASTER + 4 * b8;
        if (same(rs[0], rs[1]) && same(rs[0], rs[2]) && same(rs[0], rs[3])) {
          blocks[nb][0] = rs[0];
          blocks[nb++][2] = 8;
        } else {
          for (int j = 0; j < 4; j++) {
            blocks[nb][0] = rs[j];
            blocks[nb++][2] = 4;
          }
        }
      }
    }
    int py[2][256], pu[2][64], pv[2][64];
    for (int q = 0; q < nb; q++) {
      int rr = blocks[q][0], w = blocks[q][2], h = w;
      int bx = 4 * (rr & 3), by = 4 * (rr >> 2);
      const int* key = keys[rr];
      int used[2], n = 0;
      for (int l = 0; l < 2; l++)
        if (key[l] >= 0) {
          predict(l, key[l], x0 + bx, y0 + by, w, h, key[2 + 2 * l], key[3 + 2 * l], py[n], pu[n],
                  pv[n]);
          used[n++] = l;
        }
      if (!n) fail(ERR_NO_REF);
      int cn = (w >> 1) * (h >> 1);
      int ld = prm[PR_LUMA_DENOM], cd = prm[PR_CHROMA_DENOM];
      if (n == 1 && weight_mode == WEIGHT_EXPLICIT) {
        const int* wt = weights[used[0]] + 6 * key[used[0]];
        for (int i = 0; i < w * h; i++) py[0][i] = weight1(py[0][i], wt[0], wt[1], ld);
        for (int i = 0; i < cn; i++) {
          pu[0][i] = weight1(pu[0][i], wt[2], wt[3], cd);
          pv[0][i] = weight1(pv[0][i], wt[4], wt[5], cd);
        }
      } else if (n == 2) {
        int w0[3], w1[3], o0[3] = {0, 0, 0}, o1[3] = {0, 0, 0}, den[3] = {5, 5, 5};
        if (weight_mode == WEIGHT_EXPLICIT) {
          const int *t0 = weights[0] + 6 * key[0], *t1 = weights[1] + 6 * key[1];
          for (int c = 0; c < 3; c++) {
            w0[c] = t0[2 * c];
            w1[c] = t1[2 * c];
            o0[c] = t0[2 * c + 1];
            o1[c] = t1[2 * c + 1];
            den[c] = c ? cd : ld;
          }
        } else {
          int v = weight_mode == WEIGHT_IMPLICIT ? implicit[key[0] * n_refs[1] + key[1]] : 32;
          for (int c = 0; c < 3; c++) {
            w0[c] = v;
            w1[c] = 64 - v;
          }
        }
        if (weight_mode == WEIGHT_NONE) {
          for (int i = 0; i < w * h; i++) py[0][i] = (py[0][i] + py[1][i] + 1) >> 1;
          for (int i = 0; i < cn; i++) {
            pu[0][i] = (pu[0][i] + pu[1][i] + 1) >> 1;
            pv[0][i] = (pv[0][i] + pv[1][i] + 1) >> 1;
          }
        } else {
          for (int i = 0; i < w * h; i++)
            py[0][i] = weight2(py[0][i], py[1][i], w0[0], w1[0], o0[0], o1[0], den[0]);
          for (int i = 0; i < cn; i++) {
            pu[0][i] = weight2(pu[0][i], pu[1][i], w0[1], w1[1], o0[1], o1[1], den[1]);
            pv[0][i] = weight2(pv[0][i], pv[1][i], w0[2], w1[2], o0[2], o1[2], den[2]);
          }
        }
      }
      for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) Y[(y0 + by + y) * W + x0 + bx + x] = (uint8_t)py[0][y * w + x];
      int cy = (y0 + by) >> 1, cx = (x0 + bx) >> 1;
      for (int y = 0; y < (h >> 1); y++)
        for (int x = 0; x < (w >> 1); x++) {
          U[(cy + y) * CW + cx + x] = (uint8_t)pu[0][y * (w >> 1) + x];
          V[(cy + y) * CW + cx + x] = (uint8_t)pv[0][y * (w >> 1) + x];
        }
    }
  }
  void chroma(int a, int kind, const Coeffs& c) {
    int x0 = 8 * (a % mb_w), y0 = 8 * (a / mb_w);
    bool intra = kind <= PCM;
    uint8_t* planes[2] = {U, V};
    int pred[64], res[16], top[8], left[8], corner = 0, dcs[4];
    static const int zero[16] = {0};
    for (int comp = 0; comp < 2; comp++) {
      uint8_t* plane = planes[comp];
      if (intra) {
        bool ok_a = intra_avail(mb_a(a)), ok_b = intra_avail(mb_b(a)), ok_d = intra_avail(mb_d(a));
        int mode = s.cmode[a];
        neighbour_samples(plane, CW, x0, y0, 8, ok_b, ok_a, ok_d, false, 0, top, left, &corner);
        if ((mode == 1 && !ok_a) || (mode == 2 && !ok_b) || (mode == 3 && !(ok_a && ok_b && ok_d)))
          fail(ERR_INTRA_MODE);
        intra_chroma(mode, ok_b ? top : nullptr, ok_a ? left : nullptr, corner, pred);
      } else {
        for (int y = 0; y < 8; y++)
          for (int x = 0; x < 8; x++) pred[y * 8 + x] = plane[(y0 + y) * CW + x0 + x];
      }
      if (c.has_cdc[comp]) {
        int qpc = chroma_qp(T, qp, prm[PR_CB_OFF + comp]);
        const int* ls = lscale4((intra ? 1 : 4) + comp, qpc);
        chroma_dc(c.cdc[comp], ls[0], qpc, dcs);
        for (int rr = 0; rr < 4; rr++) {
          int bx = 4 * (rr & 1), by = 4 * (rr >> 1);
          residual4(c.has_cac[comp][rr] ? c.cac[comp][rr] : zero, ls, qpc, res, true, dcs[rr]);
          for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) pred[(by + y) * 8 + bx + x] += res[y * 4 + x];
        }
      }
      for (int y = 0; y < 8; y++)
        for (int x = 0; x < 8; x++)
          plane[(y0 + y) * CW + x0 + x] = (uint8_t)clip255(pred[y * 8 + x]);
    }
  }
};

// -- deblocking (8.7) ---------------------------------------------------------------

void filter_edge(uint8_t* plane, int stride, int x, int y, bool vertical, int lines,
                 const int* bs, int bs_div, int qp_av, int off_a, int off_b, bool chroma,
                 const Tables& T) {
  int index_a = clip3(0, 51, qp_av + off_a), index_b = clip3(0, 51, qp_av + off_b);
  int alpha = T.alpha[index_a], beta = T.beta[index_b];
  if (alpha == 0 || beta == 0) return;
  // step along the edge, and across it (from q0 toward q3; p is the other way)
  int along = vertical ? stride : 1, across = vertical ? 1 : stride;
  for (int k = 0; k < lines; k++) {
    int b = bs[k / bs_div];
    if (!b) continue;
    uint8_t* q = plane + y * stride + x + k * along;
    int p0 = q[-across], p1 = q[-2 * across], q0 = q[0], q1 = q[across];
    if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta))
      continue;
    if (chroma) {
      if (b < 4) {
        int tc = T.tc0[3 * index_a + b - 1] + 1;
        int d = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
        q[-across] = (uint8_t)clip255(p0 + d);
        q[0] = (uint8_t)clip255(q0 - d);
      } else {
        q[-across] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
        q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
      }
      continue;
    }
    int p2 = q[-3 * across], q2 = q[2 * across];
    int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
    if (b < 4) {
      int tc0 = T.tc0[3 * index_a + b - 1];
      int tc = tc0 + (ap < beta) + (aq < beta);
      int d = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
      q[-across] = (uint8_t)clip255(p0 + d);
      q[0] = (uint8_t)clip255(q0 - d);
      if (ap < beta)
        q[-2 * across] =
            (uint8_t)(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1));
      if (aq < beta)
        q[across] = (uint8_t)(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1));
    } else {
      int p3 = q[-4 * across], q3 = q[3 * across];
      bool small = std::abs(p0 - q0) < ((alpha >> 2) + 2);
      if (ap < beta && small) {
        q[-across] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
        q[-2 * across] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
        q[-3 * across] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
      } else {
        q[-across] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
      }
      if (aq < beta && small) {
        q[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
        q[across] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
        q[2 * across] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
      } else {
        q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
      }
    }
  }
}

bool coded(const State& s, int m, int i) {
  if (s.t8[m]) {
    int b8 = ((i >> 3) << 1) | ((i & 3) >> 1);
    for (int k = 0; k < 4; k++)
      if (s.nz[16 * m + BLK_RASTER[4 * b8 + k]]) return true;
    return false;
  }
  return s.nz[16 * m + i] > 0;
}

inline bool far_mv(const int* mv, int kq, const int* mv2, int kp) {
  return std::abs(mv[2 * kq] - mv2[2 * kp]) >= 4 || std::abs(mv[2 * kq + 1] - mv2[2 * kp + 1]) >= 4;
}

// bS of a luma edge's four segments; a q of a B slice compares both lists
// in both pairings (edge_bs of data/h264.py)
void edge_bs(const State& s, int a, int n, bool vertical, int edge, bool mb_edge, int* out) {
  for (int seg = 0; seg < 4; seg++) {
    int qi, pi;
    if (vertical) {
      qi = seg * 4 + edge;
      pi = seg * 4 + (edge ? edge - 1 : 3);
    } else {
      qi = edge * 4 + seg;
      pi = (edge ? edge - 1 : 3) * 4 + seg;
    }
    if (s.kind[a] <= PCM || s.kind[n] <= PCM) {
      out[seg] = mb_edge ? 4 : 3;
      continue;
    }
    if (coded(s, a, qi) || coded(s, n, pi)) {
      out[seg] = 2;
      continue;
    }
    int kq = 16 * a + qi, kp = 16 * n + pi;
    bool v = s.refpic[kq] != s.refpic[kp] || far_mv(s.mv, kq, s.mv, kp);
    if (s.lists[a] == 2) {
      v = v || s.refpic1[kq] != s.refpic1[kp] || far_mv(s.mv1, kq, s.mv1, kp);
      if (v && s.refpic[kq] == s.refpic1[kp] && s.refpic1[kq] == s.refpic[kp])
        v = far_mv(s.mv, kq, s.mv1, kp) || far_mv(s.mv1, kq, s.mv, kp);
    }
    out[seg] = v;
  }
}

}  // namespace

extern "C" {

// One slice's macroblocks from bit `bitpos` of the RBSP `data` (`len`
// bytes, then 16 zero bytes) into the picture's planes (Y of 16 mb_w x 16
// mb_h, U and V half of it) and state; the references of L0 then L1
// (n_refs[0], n_refs[1] of them) as (Y, U, V) pointers and picture ids;
// their explicit `weights` (6 each, L0's then L1's), the `implicit` w0 by
// (L0, L1) index, temporal direct's `dist_scale` by L0 index and the
// co-located picture's arrays `col` (data/h264.py's Lists).  The
// macroblock after the slice's last, or a negative error code.
int64_t omh_decode_slice(const uint8_t* data, int64_t len, int64_t bitpos, const int* prm,
                         const int* tables, const int* ls4, const int* ls8,
                         const uint64_t* ref_ptrs, const int* ref_ids, const int* n_refs,
                         const int* weights, const int* implicit, const int* dist_scale,
                         const int* col, uint8_t* y, uint8_t* u, uint8_t* v, int* state) {
  static Tables* T = nullptr;
  if (!T || VLCS.source != tables) {
    delete T;
    T = new Tables(tables);
    VLCS.build(*T);
    VLCS.source = tables;
    for (int k = 0; k < 16; k++) BLK_ORDER[BLK_RASTER[k]] = k;
  }
  int total = n_refs[0] + n_refs[1];
  std::vector<const uint8_t*> refs(3 * (size_t)std::max(total, 1));
  for (int i = 0; i < 3 * total; i++) refs[i] = (const uint8_t*)(uintptr_t)ref_ptrs[i];
  try {
    Slice sl(*T, data, len, bitpos, prm, state, refs.data(), ref_ids, n_refs, weights, implicit,
             dist_scale, col, ls4, ls8, y, u, v);
    return sl.decode();
  } catch (const Error& e) {
    return e.code;
  }
}

const char* omh_error_string(int code) {
  switch (code) {
    case ERR_EOF: return "the bitstream ends inside a field";
    case ERR_VLC: return "an invalid variable-length code";
    case ERR_RANGE: return "a syntax element out of its range";
    case ERR_PAST_END: return "the slice runs past the picture's last macroblock";
    case ERR_TWICE: return "a macroblock decoded twice";
    case ERR_MB_TYPE: return "an invalid mb_type";
    case ERR_REF: return "a ref_idx past the active references";
    case ERR_INTRA_MODE: return "an intra prediction mode without its neighbours";
    case ERR_CABAC: return "a CABAC offset of 510 or 511";
    case ERR_MV: return "a motion vector out of range";
    case ERR_NO_REF: return "a reference index past the list";
    case ERR_COEFFS: return "more coefficients than the block holds";
  }
  return "an unknown error";
}

// The deblocking filter of a whole picture (deblock_py).
void omh_deblock(uint8_t* y, uint8_t* u, uint8_t* v, int mb_w, int mb_h, int cb_off, int cr_off,
                 int* state, const int* tables) {
  Tables T(tables);
  State s(state, mb_w * mb_h);
  int W = 16 * mb_w, CW = 8 * mb_w;
  for (int k = 0; k < 16; k++) BLK_ORDER[BLK_RASTER[k]] = k;
  for (int a = 0; a < mb_w * mb_h; a++) {
    int idc = s.dbk[3 * a], off_a = s.dbk[3 * a + 1], off_b = s.dbk[3 * a + 2];
    if (idc == 1 || s.kind[a] < 0) continue;
    int mx = a % mb_w, my = a / mb_w;
    for (int dir = 0; dir < 2; dir++) {
      bool vertical = dir == 0;
      int n = vertical ? (mx > 0 ? a - 1 : -1) : (my > 0 ? a - mb_w : -1);
      if (n >= 0 && idc == 2 && s.slice[n] != s.slice[a]) n = -1;
      for (int edge = 0; edge < 4; edge++) {
        if (edge == 0 && n < 0) continue;
        if ((edge == 1 || edge == 3) && s.t8[a]) continue;
        int p = edge == 0 ? n : a;
        int bs[4];
        edge_bs(s, a, p, vertical, edge, edge == 0, bs);
        if (!(bs[0] || bs[1] || bs[2] || bs[3])) continue;
        int qp_av = (s.qp[p] + s.qp[a] + 1) >> 1;
        int x = 16 * mx + (vertical ? 4 * edge : 0), yy = 16 * my + (vertical ? 0 : 4 * edge);
        filter_edge(y, W, x, yy, vertical, 16, bs, 4, qp_av, off_a, off_b, false, T);
        if (edge == 1 || edge == 3) continue;
        uint8_t* planes[2] = {u, v};
        int offs[2] = {cb_off, cr_off};
        for (int comp = 0; comp < 2; comp++) {
          int qpc =
              (chroma_qp(T, s.qp[p], offs[comp]) + chroma_qp(T, s.qp[a], offs[comp]) + 1) >> 1;
          int cx = 8 * mx + (vertical ? 2 * edge : 0), cy = 8 * my + (vertical ? 0 : 2 * edge);
          filter_edge(planes[comp], CW, cx, cy, vertical, 8, bs, 2, qpc, off_a, off_b, true, T);
        }
      }
    }
  }
}

// yuv_to_rgb_py: (H, W) Y and (ceil(H/2), ceil(W/2)) U, V (chroma row
// stride `cstride`) -> (H, W, 3) RGB with coefficients (Y, offset, V->R,
// U->B, V->G, U->G)
void omh_yuv_to_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, int64_t cstride, int w,
                    int h, const int* c, uint8_t* out) {
  int cy = c[0], oy = c[1], vr = c[2], ub = c[3], vg = c[4], ug = c[5];
  for (int r = 0; r < h; r++) {
    const uint8_t* ur = u + (r >> 1) * cstride;
    const uint8_t* vr_ = v + (r >> 1) * cstride;
    for (int x = 0; x < w; x++) {
      int64_t yv = (((int64_t)y[(int64_t)r * w + x] * 8 - oy) * cy) >> 16;
      int64_t u8 = (int64_t)ur[x >> 1] * 8 - 1024, v8 = (int64_t)vr_[x >> 1] * 8 - 1024;
      int64_t R = yv + ((v8 * vr) >> 16);
      int64_t G = yv + ((u8 * ug) >> 16) + ((v8 * vg) >> 16);
      int64_t B = yv + ((u8 * ub) >> 16);
      uint8_t* o = out + ((int64_t)r * w + x) * 3;
      o[0] = (uint8_t)(R < 0 ? 0 : R > 255 ? 255 : R);
      o[1] = (uint8_t)(G < 0 ? 0 : G > 255 ? 255 : G);
      o[2] = (uint8_t)(B < 0 ? 0 : B > 255 ? 255 : B);
    }
  }
}

}  // extern "C"
