// WebP's hot loops on the host: the counterparts of data/vp8l.py's
// decode_image_py, predictor_py, predictor_forward_py, BitWriter.pack_py and
// backward_refs_py and of data/vp8.py's decode_macroblocks_py, which are
// their spec (the tests hold them equal).
// Plain C++ with a C interface, built with the host compiler by
// kernels/__init__.py::host_library and loaded with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------ VP8L

constexpr int kLiteral = 256, kLengthCodes = 24, kDistanceCodes = 40, kMaxCacheBits = 11;
constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7,  8,  9, 10, 11, 12, 13, 14, 15};
// distance code i + 1 -> (x, y), x to the left (data/vp8l.py DISTANCE_MAP)
constexpr int8_t kDistanceMap[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2}, {2, 1},  {-2, 1},
    {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3}, {3, 1},  {-3, 1}, {2, 3},  {-2, 3},
    {3, 2},  {-3, 2}, {0, 4},  {4, 0},  {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3},
    {2, 4},  {-2, 4}, {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2}, {4, 4},  {-4, 4},
    {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},  {1, 6},  {-1, 6}, {6, 1},  {-6, 1},
    {2, 6},  {-2, 6}, {6, 2},  {-6, 2}, {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6},
    {6, 3},  {-6, 3}, {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2}, {3, 7},  {-3, 7},
    {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5}, {8, 0},  {4, 7},  {-4, 7}, {7, 4},
    {-7, 4}, {8, 1},  {8, 2},  {6, 6},  {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5},
    {8, 4},  {6, 7},  {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

// error codes (data/vp8l.py ERRORS)
constexpr int64_t kTruncated = -1, kBadCache = -2, kBadCode = -3, kBadCopy = -4, kBadRepeat = -5;

struct Error {
  int64_t code;
};

struct BitReader {
  const uint8_t* data;
  int64_t len;  // bytes
  int64_t pos;  // bits

  uint32_t peek(int n) const {  // n <= 24; bytes past the end read as zeros
    uint64_t w = 0;
    int64_t byte = pos >> 3;
    for (int i = 0; i < 4; ++i)
      if (byte + i < len) w |= static_cast<uint64_t>(data[byte + i]) << (8 * i);
    return static_cast<uint32_t>((w >> (pos & 7)) & ((1u << n) - 1));
  }
  void skip(int n) {
    pos += n;
    if (pos > 8 * len) throw Error{kTruncated};
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

struct PrefixCode {
  int bits = 0;
  std::vector<uint16_t> symbols;
  std::vector<uint8_t> lengths;

  void build(const std::vector<int>& len) {
    std::vector<int> used;
    for (int s = 0; s < static_cast<int>(len.size()); ++s)
      if (len[s]) used.push_back(s);
    if (used.empty()) throw Error{kBadCode};
    if (used.size() == 1) {
      bits = 0;
      symbols.assign(1, static_cast<uint16_t>(used[0]));
      lengths.assign(1, 0);
      return;
    }
    bits = 0;
    for (int s : used) bits = std::max(bits, len[s]);
    int64_t kraft = 0;
    for (int s : used) kraft += int64_t{1} << (bits - len[s]);
    if (kraft != (int64_t{1} << bits)) throw Error{kBadCode};
    int size = 1 << bits;
    symbols.assign(size, 0);
    lengths.assign(size, 0);
    uint32_t code = 0;
    for (int l = 1; l <= bits; ++l) {
      for (int s : used) {
        if (len[s] != l) continue;
        uint32_t rev = 0;
        for (int i = 0; i < l; ++i) rev |= ((code >> i) & 1u) << (l - 1 - i);
        for (int i = static_cast<int>(rev); i < size; i += 1 << l) {
          symbols[i] = static_cast<uint16_t>(s);
          lengths[i] = static_cast<uint8_t>(l);
        }
        ++code;
      }
      code <<= 1;
    }
  }

  int read(BitReader& br) const {
    if (bits == 0) return symbols[0];
    uint32_t i = br.peek(bits);
    br.skip(lengths[i]);
    return symbols[i];
  }
};

void read_code(BitReader& br, int alphabet, PrefixCode& out) {
  std::vector<int> len(alphabet, 0);
  if (br.read(1)) {
    int n = static_cast<int>(br.read(1)) + 1;
    int first = static_cast<int>(br.read(br.read(1) ? 8 : 1));
    if (first < alphabet) len[first] = 1;
    if (n == 2) {
      int second = static_cast<int>(br.read(8));
      if (second < alphabet) len[second] = 1;
    }
    out.build(len);
    return;
  }
  int n_codes = static_cast<int>(br.read(4)) + 4;
  std::vector<int> cl(19, 0);
  for (int i = 0; i < n_codes; ++i) cl[kCodeLengthOrder[i]] = static_cast<int>(br.read(3));
  PrefixCode cl_code;
  cl_code.build(cl);
  int max_symbol = alphabet;
  if (br.read(1)) {
    int nbits = 2 + 2 * static_cast<int>(br.read(3));
    max_symbol = 2 + static_cast<int>(br.read(nbits));
    if (max_symbol > alphabet) throw Error{kBadCode};
  }
  int symbol = 0, prev = 8;
  while (symbol < alphabet) {
    if (max_symbol == 0) break;
    --max_symbol;
    int l = cl_code.read(br);
    if (l < 16) {
      len[symbol++] = l;
      if (l) prev = l;
      continue;
    }
    static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
    int repeat = static_cast<int>(br.read(kExtra[l - 16])) + kOffset[l - 16];
    if (symbol + repeat > alphabet) throw Error{kBadRepeat};
    int value = l == 16 ? prev : 0;
    for (int i = 0; i < repeat; ++i) len[symbol++] = value;
  }
  out.build(len);
}

int copy_length(BitReader& br, int symbol) {
  if (symbol < 4) return symbol + 1;
  int extra = (symbol - 2) >> 1;
  return ((2 + (symbol & 1)) << extra) + static_cast<int>(br.read(extra)) + 1;
}

int64_t plane_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  int64_t d = kDistanceMap[code - 1][0] + static_cast<int64_t>(kDistanceMap[code - 1][1]) * xsize;
  return d < 1 ? 1 : d;
}

inline uint32_t cache_key(uint32_t argb, int shift) {
  return static_cast<uint32_t>(argb * 0x1E35A7BDu) >> shift;
}

void decode_image(BitReader& br, int xsize, int ysize, bool level0, uint32_t* out) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = static_cast<int>(br.read(4));
    if (cache_bits < 1 || cache_bits > kMaxCacheBits) throw Error{kBadCache};
  }
  std::vector<uint32_t> groups_image;
  int group_bits = 0, gw = 0, n_groups = 1;
  if (level0 && br.read(1)) {
    group_bits = static_cast<int>(br.read(3)) + 2;
    gw = (xsize + (1 << group_bits) - 1) >> group_bits;
    int gh = (ysize + (1 << group_bits) - 1) >> group_bits;
    groups_image.resize(static_cast<size_t>(gw) * gh);
    decode_image(br, gw, gh, false, groups_image.data());
    for (auto& p : groups_image) {
      p = (p >> 8) & 0xFFFF;
      n_groups = std::max(n_groups, static_cast<int>(p) + 1);
    }
  }
  const bool meta = !groups_image.empty();
  int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int alphabets[5] = {kLiteral + kLengthCodes + cache_size, 256, 256, 256, kDistanceCodes};
  std::vector<PrefixCode> codes(static_cast<size_t>(n_groups) * 5);
  for (int g = 0; g < n_groups; ++g)
    for (int k = 0; k < 5; ++k) read_code(br, alphabets[k], codes[5 * g + k]);
  std::vector<uint32_t> cache(cache_size, 0);
  const int shift = 32 - cache_bits;
  const int64_t total = static_cast<int64_t>(xsize) * ysize;
  int64_t pos = 0;
  const PrefixCode* group = codes.data();
  while (pos < total) {
    if (meta) {  // the group of the next pixel's tile
      int64_t x = pos % xsize, y = pos / xsize;
      group = codes.data() +
              5 * static_cast<size_t>(groups_image[(y >> group_bits) * gw + (x >> group_bits)]);
    }
    const int64_t start = pos;
    int code = group[0].read(br);
    if (code < kLiteral) {
      uint32_t red = group[1].read(br);
      uint32_t blue = group[2].read(br);
      uint32_t alpha = group[3].read(br);
      out[pos++] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
    } else if (code < kLiteral + kLengthCodes) {
      int length = copy_length(br, code - kLiteral);
      int64_t dist = plane_distance(xsize, copy_length(br, group[4].read(br)));
      if (dist > pos || length > total - pos) throw Error{kBadCopy};
      for (int64_t i = pos; i < pos + length; ++i) out[i] = out[i - dist];
      pos += length;
    } else {
      out[pos++] = cache[code - kLiteral - kLengthCodes];
    }
    if (cache_size)  // every pixel enters the cache
      for (int64_t i = start; i < pos; ++i) cache[cache_key(out[i], shift)] = out[i];
  }
}

inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b); }

inline int clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline int ch(uint32_t p, int s) { return static_cast<int>((p >> s) & 0xFF); }

uint32_t predict(int mode, uint32_t left, uint32_t top, uint32_t top_right, uint32_t top_left) {
  switch (mode) {
    case 1: return left;
    case 2: return top;
    case 3: return top_right;
    case 4: return top_left;
    case 5: return average2(average2(left, top_right), top);
    case 6: return average2(left, top_left);
    case 7: return average2(left, top);
    case 8: return average2(top_left, top);
    case 9: return average2(top, top_right);
    case 10: return average2(average2(left, top_left), average2(top, top_right));
    case 11: {
      int p_left = 0, p_top = 0;
      for (int s = 0; s < 32; s += 8) {
        p_left += std::abs(ch(top, s) - ch(top_left, s));
        p_top += std::abs(ch(left, s) - ch(top_left, s));
      }
      return p_left < p_top ? left : top;
    }
    case 12: {
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8)
        out |= static_cast<uint32_t>(clamp255(ch(left, s) + ch(top, s) - ch(top_left, s))) << s;
      return out;
    }
    case 13: {
      uint32_t avg = average2(left, top), out = 0;
      for (int s = 0; s < 32; s += 8) {
        int a = ch(avg, s);
        out |= static_cast<uint32_t>(clamp255(a + (a - ch(top_left, s)) / 2)) << s;
      }
      return out;
    }
    default: return 0xFF000000u;  // 0, and 14 and 15
  }
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  return (((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u) |
         (((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu);
}

// ------------------------------------------------------------------- VP8

constexpr int kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
constexpr int kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
constexpr uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
                  kCat5[] = {180, 157, 141, 134, 130, 0},
                  kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
constexpr const uint8_t* kCats[4] = {kCat3, kCat4, kCat5, kCat6};
enum { DC_PRED, V_PRED, H_PRED, TM_PRED, B_PRED };
enum { B_DC, B_TM, B_VE, B_HE, B_LD, B_RD, B_VR, B_VL, B_HD, B_HU };
constexpr int kImplied[4] = {B_DC, B_VE, B_HE, B_TM};
constexpr int kYModeTree[8] = {-B_PRED, 2, 4, 6, -DC_PRED, -V_PRED, -H_PRED, -TM_PRED};
constexpr uint8_t kYModeProb[4] = {145, 156, 163, 128};
constexpr int kUVModeTree[6] = {-DC_PRED, 2, -V_PRED, 4, -H_PRED, -TM_PRED};
constexpr uint8_t kUVModeProb[3] = {142, 114, 183};
constexpr int kBModeTree[18] = {-B_DC, 2, -B_TM, 4, -B_VE, 6, 8, 12, -B_HE, 10,
                                -B_RD, -B_VR, -B_LD, 14, -B_VL, 16, -B_HD, -B_HU};
constexpr int kSegmentTree[6] = {2, 4, 0, -1, -2, -3};

struct BoolDecoder {
  const uint8_t* data;
  int64_t pos, end;
  uint64_t value;
  int bits, rng, eof;

  int bit(int prob) {
    if (bits < 0) {
      if (pos < end) {
        value = (value << 8) | data[pos++];
      } else {
        value <<= 8;
        eof = 1;
      }
      bits += 8;
    }
    int split = (rng * prob) >> 8, r, b;
    if (static_cast<int>(value >> bits) > split) {
      r = rng - split;
      value -= static_cast<uint64_t>(split + 1) << bits;
      b = 1;
    } else {
      r = split + 1;
      b = 0;
    }
    int shift = 0;
    while ((r << shift) < 128) ++shift;
    rng = (r << shift) - 1;
    bits -= shift;
    return b;
  }

  int tree(const int* t, const uint8_t* probs) {
    int i = 0;
    for (;;) {
      i = t[i + bit(probs[i >> 1])];
      if (i <= 0) return -i;
    }
  }
};

inline int16_t to_int16(int v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }

// libwebp's GetCoeffs: probs[band][ctx][node], dq: (DC, AC) factors
int read_coefs(BoolDecoder& br, const uint8_t* probs, int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = probs + (kBands[n] * 3 + ctx) * 11;
  while (n < 16) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      if (++n == 16) return 16;
      p = probs + (kBands[n] * 3) * 11;
    }
    int v, nxt;
    if (!br.bit(p[2])) {
      v = 1;
      nxt = 1;
    } else {
      if (!br.bit(p[3])) {
        v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
      } else if (!br.bit(p[6])) {
        if (!br.bit(p[7])) {
          v = 5 + br.bit(159);
        } else {
          v = 7 + 2 * br.bit(165);
          v += br.bit(145);
        }
      } else {
        int bit1 = br.bit(p[8]);
        int bit0 = br.bit(p[9 + bit1]);
        int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* t = kCats[cat]; *t; ++t) v = 2 * v + br.bit(*t);
        v += 3 + (8 << cat);
      }
      nxt = 2;
    }
    if (br.bit(128)) v = -v;
    out[kZigzag[n]] = to_int16(v * dq[n > 0]);
    ++n;
    p = probs + (kBands[n] * 3 + nxt) * 11;
  }
  return 16;
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

void idct_add(const int16_t* in, uint8_t* dst, int stride) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    int c = mul2(in[4 + i]) - mul1(in[12 + i]), d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[i] + 4;
    int a = dc + tmp[8 + i], b = dc - tmp[8 + i];
    int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]), d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * stride;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

void iwht(const int16_t* in, int* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[4 * i] + 3;
    int a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    out[4 * i] = (a0 + a1) >> 3;
    out[4 * i + 1] = (a3 + a2) >> 3;
    out[4 * i + 2] = (a0 - a1) >> 3;
    out[4 * i + 3] = (a3 - a2) >> 3;
  }
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// a 4x4 prediction into dst (stride ws): top[0] the top-left, top[1..8]
// the 8 pixels above; left[0..3] (stride ws) the pixels to the left
void predict4(int mode, const uint8_t* top, const uint8_t* left, int ls, uint8_t* dst, int ws) {
  const int X = top[0], A = top[1], B = top[2], C = top[3], D = top[4], E = top[5], F = top[6],
            G = top[7], H = top[8];
  const int I = left[0], J = left[ls], K = left[2 * ls], L = left[3 * ls];
  auto put = [&](int x, int y, int v) { dst[x + y * ws] = static_cast<uint8_t>(v); };
  switch (mode) {
    case B_DC: {
      int dc = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) put(x, y, dc);
      break;
    }
    case B_TM: {
      const int l[4] = {I, J, K, L}, t[4] = {A, B, C, D};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) put(x, y, clip8(l[y] + t[x] - X));
      break;
    }
    case B_VE: {
      const int row[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) put(x, y, row[x]);
      break;
    }
    case B_HE: {
      const int col[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) put(x, y, col[y]);
      break;
    }
    case B_LD:
      put(0, 0, avg3(A, B, C));
      put(1, 0, avg3(B, C, D)); put(0, 1, avg3(B, C, D));
      put(2, 0, avg3(C, D, E)); put(1, 1, avg3(C, D, E)); put(0, 2, avg3(C, D, E));
      put(3, 0, avg3(D, E, F)); put(2, 1, avg3(D, E, F)); put(1, 2, avg3(D, E, F));
      put(0, 3, avg3(D, E, F));
      put(3, 1, avg3(E, F, G)); put(2, 2, avg3(E, F, G)); put(1, 3, avg3(E, F, G));
      put(3, 2, avg3(F, G, H)); put(2, 3, avg3(F, G, H));
      put(3, 3, avg3(G, H, H));
      break;
    case B_RD:
      put(0, 3, avg3(J, K, L));
      put(1, 3, avg3(I, J, K)); put(0, 2, avg3(I, J, K));
      put(2, 3, avg3(X, I, J)); put(1, 2, avg3(X, I, J)); put(0, 1, avg3(X, I, J));
      put(3, 3, avg3(A, X, I)); put(2, 2, avg3(A, X, I)); put(1, 1, avg3(A, X, I));
      put(0, 0, avg3(A, X, I));
      put(3, 2, avg3(B, A, X)); put(2, 1, avg3(B, A, X)); put(1, 0, avg3(B, A, X));
      put(3, 1, avg3(C, B, A)); put(2, 0, avg3(C, B, A));
      put(3, 0, avg3(D, C, B));
      break;
    case B_VR:
      put(0, 0, avg2(X, A)); put(1, 2, avg2(X, A));
      put(1, 0, avg2(A, B)); put(2, 2, avg2(A, B));
      put(2, 0, avg2(B, C)); put(3, 2, avg2(B, C));
      put(3, 0, avg2(C, D));
      put(0, 3, avg3(K, J, I));
      put(0, 2, avg3(J, I, X));
      put(0, 1, avg3(I, X, A)); put(1, 3, avg3(I, X, A));
      put(1, 1, avg3(X, A, B)); put(2, 3, avg3(X, A, B));
      put(2, 1, avg3(A, B, C)); put(3, 3, avg3(A, B, C));
      put(3, 1, avg3(B, C, D));
      break;
    case B_VL:
      put(0, 0, avg2(A, B));
      put(1, 0, avg2(B, C)); put(0, 2, avg2(B, C));
      put(2, 0, avg2(C, D)); put(1, 2, avg2(C, D));
      put(3, 0, avg2(D, E)); put(2, 2, avg2(D, E));
      put(0, 1, avg3(A, B, C));
      put(1, 1, avg3(B, C, D)); put(0, 3, avg3(B, C, D));
      put(2, 1, avg3(C, D, E)); put(1, 3, avg3(C, D, E));
      put(3, 1, avg3(D, E, F)); put(2, 3, avg3(D, E, F));
      put(3, 2, avg3(E, F, G));
      put(3, 3, avg3(F, G, H));
      break;
    case B_HD:
      put(0, 0, avg2(I, X)); put(2, 1, avg2(I, X));
      put(0, 1, avg2(J, I)); put(2, 2, avg2(J, I));
      put(0, 2, avg2(K, J)); put(2, 3, avg2(K, J));
      put(0, 3, avg2(L, K));
      put(3, 0, avg3(A, B, C));
      put(2, 0, avg3(X, A, B));
      put(1, 0, avg3(I, X, A)); put(3, 1, avg3(I, X, A));
      put(1, 1, avg3(J, I, X)); put(3, 2, avg3(J, I, X));
      put(1, 2, avg3(K, J, I)); put(3, 3, avg3(K, J, I));
      put(1, 3, avg3(L, K, J));
      break;
    default:  // B_HU
      put(0, 0, avg2(I, J));
      put(2, 0, avg2(J, K)); put(0, 1, avg2(J, K));
      put(2, 1, avg2(K, L)); put(0, 2, avg2(K, L));
      put(1, 0, avg3(I, J, K));
      put(3, 0, avg3(J, K, L)); put(1, 1, avg3(J, K, L));
      put(3, 1, avg3(K, L, L)); put(1, 2, avg3(K, L, L));
      put(3, 2, L); put(2, 2, L); put(0, 3, L); put(1, 3, L); put(2, 3, L); put(3, 3, L);
      break;
  }
}

// a 16x16 or 8x8 prediction with libwebp's DC edge rules
void predict_block(int mode, int size, const uint8_t* top, const uint8_t* left, int top_left,
                   int mb_x, int mb_y, uint8_t* dst, int stride) {
  if (mode == DC_PRED) {
    int shift = size == 16 ? 4 : 3, st = 0, sl = 0, dc;
    for (int i = 0; i < size; ++i) {
      st += top[i];
      sl += left[i];
    }
    if (mb_x > 0 && mb_y > 0) dc = (st + sl + size) >> (shift + 1);
    else if (mb_y > 0) dc = (st + (size >> 1)) >> shift;
    else if (mb_x > 0) dc = (sl + (size >> 1)) >> shift;
    else dc = 128;
    for (int y = 0; y < size; ++y) std::memset(dst + y * stride, dc, size);
  } else if (mode == V_PRED) {
    for (int y = 0; y < size; ++y) std::memcpy(dst + y * stride, top, size);
  } else if (mode == H_PRED) {
    for (int y = 0; y < size; ++y) std::memset(dst + y * stride, left[y], size);
  } else {
    for (int y = 0; y < size; ++y)
      for (int x = 0; x < size; ++x) dst[y * stride + x] = clip8(left[y] + top[x] - top_left);
  }
}

// a macroblock's edges from the unfiltered plane (127 above the frame, 129
// left of it); top holds size + extra pixels
void edges(const uint8_t* plane, int stride, int x0, int y0, int size, int extra, uint8_t* top,
           uint8_t* left, int* top_left) {
  if (y0 == 0) {
    std::memset(top, 127, size + extra);
    *top_left = 127;
  } else {
    const uint8_t* row = plane + static_cast<int64_t>(y0 - 1) * stride;
    std::memcpy(top, row + x0, size);
    if (extra) {
      if (x0 + size < stride) std::memcpy(top + size, row + x0 + size, extra);
      else std::memset(top + size, row[x0 + size - 1], extra);
    }
    *top_left = x0 == 0 ? 129 : row[x0 - 1];
  }
  for (int j = 0; j < size; ++j)
    left[j] = x0 == 0 ? 129 : plane[static_cast<int64_t>(y0 + j) * stride + x0 - 1];
}

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

void filter2(uint8_t* p, int s) {
  int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-s] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

void filter4(uint8_t* p, int s) {
  int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  int a = 3 * (q0 - p0);
  int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * s] = clip8(p1 + a3);
  p[-s] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[s] = clip8(q1 - a3);
}

void filter6(uint8_t* p, int s) {
  int p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s], q2 = p[2 * s];
  int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * s] = clip8(p2 + a3);
  p[-2 * s] = clip8(p1 + a2);
  p[-s] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[s] = clip8(q1 - a2);
  p[2 * s] = clip8(q2 - a3);
}

void simple_edge(uint8_t* p, int s, int step, int n, int thresh) {
  int t = 2 * thresh + 1;
  for (int k = 0; k < n; ++k, p += step)
    if (4 * std::abs(p[-s] - p[0]) + std::abs(p[-2 * s] - p[s]) <= t) filter2(p, s);
}

void normal_edge(uint8_t* p, int s, int step, int n, int thresh, int it, int hev_t,
                 bool mb_edge) {
  int t = 2 * thresh + 1;
  for (int k = 0; k < n; ++k, p += step) {
    int p3 = p[-4 * s], p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s];
    int q0 = p[0], q1 = p[s], q2 = p[2 * s], q3 = p[3 * s];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) continue;
    if (std::abs(p3 - p2) > it || std::abs(p2 - p1) > it || std::abs(p1 - p0) > it ||
        std::abs(q3 - q2) > it || std::abs(q2 - q1) > it || std::abs(q1 - q0) > it)
      continue;
    if (std::abs(p1 - p0) > hev_t || std::abs(q1 - q0) > hev_t) filter2(p, s);
    else if (mb_edge) filter6(p, s);
    else filter4(p, s);
  }
}

struct MBInfo {
  int segment, skip, ymode, uvmode;
  int bmodes[16];
};

}  // namespace

extern "C" {

// One VP8L entropy-coded image at bit ``bitpos`` of data[0:len]: its colour
// cache info, its meta prefix codes (level0: the main image), its prefix
// codes and LZ77 data -> xsize*ysize ARGB words.  Returns the bit position
// after it, or an error code below 0 (data/vp8l.py ERRORS).
int64_t omw_vp8l_image(const uint8_t* data, int64_t len, int64_t bitpos, int xsize, int ysize,
                       int level0, uint32_t* out) {
  BitReader br{data, len, bitpos};
  try {
    decode_image(br, xsize, ysize, level0 != 0, out);
  } catch (const Error& e) {
    return e.code;
  } catch (...) {
    return -6;
  }
  return br.pos;
}

// The predictor transform's inverse in place (data/vp8l.py predictor_py).
void omw_vp8l_predictor(uint32_t* px, int width, int height, const uint32_t* modes, int bits) {
  const int tiles_w = (width + (1 << bits) - 1) >> bits;
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      const int64_t i = static_cast<int64_t>(y) * width + x;
      uint32_t pred;
      if (y == 0) pred = x == 0 ? 0xFF000000u : px[i - 1];
      else if (x == 0) pred = px[i - width];
      else {
        int mode = (modes[(y >> bits) * tiles_w + (x >> bits)] >> 8) & 0xF;
        pred = predict(mode, px[i - 1], px[i - width], px[i - width + 1], px[i - width - 1]);
      }
      px[i] = add_pixels(px[i], pred);
    }
  }
}

// The encoder's predictor transform (data/vp8l.py predictor_forward_py):
// each tile's mode (0-13) is the one of least sum of |residual| over its
// interior pixels (ties: the lower mode); residuals of every pixel under
// its tile's mode, the borders under their fixed predictors.
void omw_vp8l_predictor_forward(const uint32_t* px, int width, int height, int bits,
                                uint32_t* residuals, uint32_t* modes) {
  const int size = 1 << bits, tiles_w = (width + size - 1) >> bits;
  const int tiles_h = (height + size - 1) >> bits;
  auto sub = [](uint32_t a, uint32_t b) {
    return (((a | 0x00FF00FFu) - (b & 0xFF00FF00u)) & 0xFF00FF00u) |
           (((a | 0xFF00FF00u) - (b & 0x00FF00FFu)) & 0x00FF00FFu);
  };
  auto cost = [](uint32_t r) {
    int c = 0;
    for (int s = 0; s < 32; s += 8) {
      int v = (r >> s) & 0xFF;
      c += v < 256 - v ? v : 256 - v;
    }
    return c;
  };
  auto pred_at = [&](int mode, int64_t i) {
    return predict(mode, px[i - 1], px[i - width], px[i - width + 1], px[i - width - 1]);
  };
  for (int ty = 0; ty < tiles_h; ++ty) {
    for (int tx = 0; tx < tiles_w; ++tx) {
      int64_t best = -1;
      int best_mode = 0;
      for (int mode = 0; mode < 14; ++mode) {
        int64_t total = 0;
        for (int y = std::max(1, ty * size); y < std::min(height, (ty + 1) * size); ++y)
          for (int x = std::max(1, tx * size); x < std::min(width, (tx + 1) * size); ++x) {
            const int64_t i = static_cast<int64_t>(y) * width + x;
            total += cost(sub(px[i], pred_at(mode, i)));
          }
        if (best < 0 || total < best) {
          best = total;
          best_mode = mode;
        }
      }
      modes[ty * tiles_w + tx] = 0xFF000000u | (static_cast<uint32_t>(best_mode) << 8);
      for (int y = ty * size; y < std::min(height, (ty + 1) * size); ++y)
        for (int x = tx * size; x < std::min(width, (tx + 1) * size); ++x) {
          const int64_t i = static_cast<int64_t>(y) * width + x;
          uint32_t pred;
          if (y == 0) pred = x == 0 ? 0xFF000000u : px[i - 1];
          else if (x == 0) pred = px[i - width];
          else pred = pred_at(best_mode, i);
          residuals[i] = sub(px[i], pred);
        }
    }
  }
}

// Pack (value, width) pairs least significant bit first (data/vp8l.py
// BitWriter.getvalue); returns the bytes written, or -1 past cap.
int64_t omw_vp8l_pack_bits(const int64_t* values, const int64_t* widths, int64_t n, uint8_t* out,
                           int64_t cap) {
  uint64_t acc = 0;
  int nbits = 0;
  int64_t len = 0;
  for (int64_t k = 0; k < n; ++k) {
    const int w = static_cast<int>(widths[k]);
    if (w <= 0) continue;
    acc |= (static_cast<uint64_t>(values[k]) & ((uint64_t{1} << w) - 1)) << nbits;
    nbits += w;
    while (nbits >= 8) {
      if (len >= cap) return -1;
      out[len++] = static_cast<uint8_t>(acc);
      acc >>= 8;
      nbits -= 8;
    }
  }
  if (nbits) {
    if (len >= cap) return -1;
    out[len++] = static_cast<uint8_t>(acc);
  }
  return len;
}

// Greedy LZ77 with a hash chain of pixel pairs and the colour cache
// (data/vp8l.py backward_refs_py).  Returns the token count, or -1.
int64_t omw_vp8l_backward_refs(const uint32_t* px, int64_t n, int xsize, int cache_bits,
                               int chain, int32_t* kinds, uint32_t* aa, int32_t* bb) {
  try {
    const int kHashBits = 18;
    std::vector<int64_t> head(size_t{1} << kHashBits, -1), prev(n, -1);
    // a hash of the pair with chains per hash; candidates are checked for
    // the exact pair, so the chain is that of the pair as in the spec
    auto hash = [&](int64_t j) {
      uint64_t k = (static_cast<uint64_t>(px[j]) << 32) | px[j + 1];
      return static_cast<size_t>((k * 0x9E3779B97F4A7C15ull) >> (64 - kHashBits));
    };
    auto insert = [&](int64_t j) {
      if (j + 1 < n) {
        size_t h = hash(j);
        prev[j] = head[h];
        head[h] = j;
      }
    };
    std::vector<uint32_t> cache(cache_bits ? size_t{1} << cache_bits : 0, 0);
    const int shift = 32 - cache_bits;
    int64_t count = 0, i = 0;
    std::vector<int64_t> cands;
    while (i < n) {
      int64_t best_len = 0, best_dist = 0;
      if (i + 1 < n) {
        const int64_t limit = std::min<int64_t>(4096, n - i);
        cands.clear();
        if (i - 1 >= 0) cands.push_back(i - 1);
        if (i - xsize >= 0) cands.push_back(i - xsize);
        int64_t j = head[hash(i)];
        int k = 0;
        while (j >= 0 && k < chain) {
          if (px[j] == px[i] && px[j + 1] == px[i + 1]) {
            cands.push_back(j);
            ++k;
          }
          j = prev[j];
        }
        for (int64_t c : cands) {
          int64_t length = 0;
          while (length < limit && px[c + length] == px[i + length]) ++length;
          if (length > best_len || (length == best_len && i - c < best_dist)) {
            best_len = length;
            best_dist = i - c;
          }
        }
      }
      if (best_len >= 3) {
        kinds[count] = 1;
        aa[count] = static_cast<uint32_t>(best_len);
        bb[count++] = static_cast<int32_t>(best_dist);
        for (int64_t j = i; j < i + best_len; ++j) {
          insert(j);
          if (cache_bits) cache[cache_key(px[j], shift)] = px[j];
        }
        i += best_len;
        continue;
      }
      const uint32_t p = px[i];
      if (cache_bits) {
        uint32_t key = cache_key(p, shift);
        if (cache[key] == p) {
          kinds[count] = 2;
          aa[count] = key;
        } else {
          kinds[count] = 0;
          aa[count] = p;
        }
        cache[key] = p;
      } else {
        kinds[count] = 0;
        aa[count] = p;
      }
      bb[count++] = 0;
      insert(i);
      ++i;
    }
    return count;
  } catch (...) {
    return -1;
  }
}

// Every macroblock of a VP8 key frame (data/vp8.py decode_macroblocks_py).
// state: the first partition's decoder after the header (pos, end, value,
// bits, range - 1, eof); parts: (start, end) of each token partition;
// params: mb_w, mb_h, update_map, 3 segment probabilities, use_skip,
// skip_prob, filter_type, n_parts; coef_probs (4, 8, 3, 11); bmode_probs
// (10, 10, 9); dequant (4, 6); filters (4, 2, 4).  Writes the
// macroblock-aligned planes.  Returns 0, 1 for a truncated partition, 2
// when out of memory.
int omw_vp8_decode(const uint8_t* data, int64_t len, const int64_t* state, const int64_t* parts,
                   const int32_t* params, const uint8_t* coef_probs, const uint8_t* bmode_probs,
                   const int32_t* dequant, const int32_t* filters, uint8_t* Y, uint8_t* U,
                   uint8_t* V) {
  try {
    const int mb_w = params[0], mb_h = params[1], update_map = params[2];
    const uint8_t seg_probs[3] = {static_cast<uint8_t>(params[3]), static_cast<uint8_t>(params[4]),
                                  static_cast<uint8_t>(params[5])};
    const int use_skip = params[6], skip_prob = params[7], filter_type = params[8];
    const int n_parts = params[9];
    const int yw = 16 * mb_w, uw = 8 * mb_w;
    BoolDecoder br{data, state[0], state[1], static_cast<uint64_t>(state[2]),
                   static_cast<int>(state[3]), static_cast<int>(state[4]),
                   static_cast<int>(state[5])};
    std::vector<BoolDecoder> tokens;
    for (int p = 0; p < n_parts; ++p)
      tokens.push_back(BoolDecoder{data, parts[2 * p], std::min(parts[2 * p + 1], len), 0, -8,
                                   254, 0});
    std::vector<int> top_modes(4 * mb_w, B_DC);
    std::vector<uint8_t> nz_top(8 * mb_w, 0), nz_dc_top(mb_w, 0);
    std::vector<MBInfo> row(mb_w);
    std::vector<int> finfo(4 * static_cast<size_t>(mb_w) * mb_h);
    int16_t coefs[25][16];
    uint8_t work[17 * 21];
    uint8_t top[20], left[16];
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      int left_modes[4] = {B_DC, B_DC, B_DC, B_DC};
      uint8_t nz_left[8] = {0};
      int nz_dc_left = 0;
      BoolDecoder& tb = tokens[mb_y % n_parts];
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {  // the row's modes
        MBInfo& m = row[mb_x];
        m.segment = update_map ? br.tree(kSegmentTree, seg_probs) : 0;
        m.skip = use_skip ? br.bit(skip_prob) : 0;
        m.ymode = br.tree(kYModeTree, kYModeProb);
        int* t = &top_modes[4 * mb_x];
        if (m.ymode == B_PRED) {
          for (int y = 0; y < 4; ++y) {
            int l = left_modes[y];
            for (int x = 0; x < 4; ++x) {
              int md = br.tree(kBModeTree, bmode_probs + (t[x] * 10 + l) * 9);
              m.bmodes[4 * y + x] = md;
              t[x] = l = md;
            }
            left_modes[y] = l;
          }
        } else {
          for (int k = 0; k < 4; ++k) t[k] = left_modes[k] = kImplied[m.ymode];
        }
        m.uvmode = br.tree(kUVModeTree, kUVModeProb);
      }
      if (br.eof) return 1;
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBInfo& m = row[mb_x];
        const bool i4x4 = m.ymode == B_PRED;
        bool has_coefs = false;
        int skip = m.skip;
        uint8_t* nzt = &nz_top[8 * mb_x];
        if (!skip) {
          const int32_t* dq = dequant + 6 * m.segment;
          std::memset(coefs, 0, sizeof(coefs));
          bool nonzero = false;
          int first;
          const uint8_t* yprobs;
          if (!i4x4) {
            const int dq2[2] = {dq[2], dq[3]};
            int nz = read_coefs(tb, coef_probs + 1 * 8 * 33, nz_dc_top[mb_x] + nz_dc_left, dq2,
                                0, coefs[24]);
            nz_dc_top[mb_x] = nz_dc_left = nz > 0;
            int dcs[16];
            iwht(coefs[24], dcs);
            for (int i = 0; i < 16; ++i) coefs[i][0] = to_int16(dcs[i]);
            first = 1;
            yprobs = coef_probs;
          } else {
            first = 0;
            yprobs = coef_probs + 3 * 8 * 33;
          }
          const int dq1[2] = {dq[0], dq[1]};
          for (int y = 0; y < 4; ++y) {
            int l = nz_left[y];
            for (int x = 0; x < 4; ++x) {
              int b = 4 * y + x;
              int nz = read_coefs(tb, yprobs, l + nzt[x], dq1, first, coefs[b]);
              l = nzt[x] = nz > first;
              nonzero |= nz > 1 || coefs[b][0] != 0;
            }
            nz_left[y] = static_cast<uint8_t>(l);
          }
          const int dqc[2] = {dq[4], dq[5]};
          for (int c = 0; c < 2; ++c) {
            for (int y = 0; y < 2; ++y) {
              int l = nz_left[4 + 2 * c + y];
              for (int x = 0; x < 2; ++x) {
                int b = 16 + 4 * c + 2 * y + x;
                int nz = read_coefs(tb, coef_probs + 2 * 8 * 33, l + nzt[4 + 2 * c + x], dqc, 0,
                                    coefs[b]);
                l = nzt[4 + 2 * c + x] = nz > 0;
                nonzero |= nz > 1 || coefs[b][0] != 0;
              }
              nz_left[4 + 2 * c + y] = static_cast<uint8_t>(l);
            }
          }
          skip = !nonzero;
          has_coefs = true;
        } else {
          std::memset(nzt, 0, 8);
          std::memset(nz_left, 0, 8);
          if (!i4x4) nz_dc_top[mb_x] = nz_dc_left = 0;
        }
        if (tb.eof) return 1;
        const int32_t* fl = filters + (m.segment * 2 + (i4x4 ? 1 : 0)) * 4;
        int* fi = &finfo[4 * (static_cast<size_t>(mb_y) * mb_w + mb_x)];
        fi[0] = fl[0];
        fi[1] = fl[1];
        fi[2] = fl[2];
        fi[3] = fl[3] || !skip;
        // reconstruct into the unfiltered planes
        const int x0 = 16 * mb_x, y0 = 16 * mb_y;
        int top_left;
        edges(Y, yw, x0, y0, 16, 4, top, left, &top_left);
        uint8_t* ydst = Y + static_cast<int64_t>(y0) * yw + x0;
        if (i4x4) {
          constexpr int ws = 21;
          work[0] = static_cast<uint8_t>(top_left);
          std::memcpy(work + 1, top, 20);
          for (int j = 0; j < 16; ++j) work[(j + 1) * ws] = left[j];
          for (int r = 4; r <= 12; r += 4) std::memcpy(work + r * ws + 17, top + 16, 4);
          for (int n = 0; n < 16; ++n) {
            int by = 4 * (n >> 2), bx = 4 * (n & 3);
            uint8_t* dst = work + (by + 1) * ws + bx + 1;
            predict4(m.bmodes[n], work + by * ws + bx, work + (by + 1) * ws + bx, ws, dst, ws);
            if (has_coefs) idct_add(coefs[n], dst, ws);
          }
          for (int j = 0; j < 16; ++j) std::memcpy(ydst + j * yw, work + (j + 1) * ws + 1, 16);
        } else {
          predict_block(m.ymode, 16, top, left, top_left, mb_x, mb_y, ydst, yw);
          if (has_coefs)
            for (int n = 0; n < 16; ++n)
              idct_add(coefs[n], ydst + 4 * (n >> 2) * yw + 4 * (n & 3), yw);
        }
        for (int c = 0; c < 2; ++c) {
          uint8_t* plane = c ? V : U;
          const int cx0 = 8 * mb_x, cy0 = 8 * mb_y;
          edges(plane, uw, cx0, cy0, 8, 0, top, left, &top_left);
          uint8_t* cdst = plane + static_cast<int64_t>(cy0) * uw + cx0;
          predict_block(m.uvmode, 8, top, left, top_left, mb_x, mb_y, cdst, uw);
          if (has_coefs)
            for (int n = 0; n < 4; ++n)
              idct_add(coefs[16 + 4 * c + n], cdst + 4 * (n >> 1) * uw + 4 * (n & 1), uw);
        }
      }
    }
    if (filter_type) {
      for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
          const int* fi = &finfo[4 * (static_cast<size_t>(mb_y) * mb_w + mb_x)];
          const int limit = fi[0], ilevel = fi[1], hev_t = fi[2], inner = fi[3];
          if (limit == 0) continue;
          uint8_t* yp = Y + static_cast<int64_t>(16 * mb_y) * yw + 16 * mb_x;
          uint8_t* up = U + static_cast<int64_t>(8 * mb_y) * uw + 8 * mb_x;
          uint8_t* vp = V + static_cast<int64_t>(8 * mb_y) * uw + 8 * mb_x;
          if (filter_type == 1) {
            if (mb_x > 0) simple_edge(yp, 1, yw, 16, limit + 4);
            if (inner)
              for (int k = 4; k < 16; k += 4) simple_edge(yp + k, 1, yw, 16, limit);
            if (mb_y > 0) simple_edge(yp, yw, 1, 16, limit + 4);
            if (inner)
              for (int k = 4; k < 16; k += 4) simple_edge(yp + k * yw, yw, 1, 16, limit);
            continue;
          }
          if (mb_x > 0) {
            normal_edge(yp, 1, yw, 16, limit + 4, ilevel, hev_t, true);
            normal_edge(up, 1, uw, 8, limit + 4, ilevel, hev_t, true);
            normal_edge(vp, 1, uw, 8, limit + 4, ilevel, hev_t, true);
          }
          if (inner) {
            for (int k = 4; k < 16; k += 4) normal_edge(yp + k, 1, yw, 16, limit, ilevel, hev_t, false);
            normal_edge(up + 4, 1, uw, 8, limit, ilevel, hev_t, false);
            normal_edge(vp + 4, 1, uw, 8, limit, ilevel, hev_t, false);
          }
          if (mb_y > 0) {
            normal_edge(yp, yw, 1, 16, limit + 4, ilevel, hev_t, true);
            normal_edge(up, uw, 1, 8, limit + 4, ilevel, hev_t, true);
            normal_edge(vp, uw, 1, 8, limit + 4, ilevel, hev_t, true);
          }
          if (inner) {
            for (int k = 4; k < 16; k += 4)
              normal_edge(yp + k * yw, yw, 1, 16, limit, ilevel, hev_t, false);
            normal_edge(up + 4 * uw, uw, 1, 8, limit, ilevel, hev_t, false);
            normal_edge(vp + 4 * uw, uw, 1, 8, limit, ilevel, hev_t, false);
          }
        }
      }
    }
    return 0;
  } catch (...) {
    return 2;
  }
}

}  // extern "C"
