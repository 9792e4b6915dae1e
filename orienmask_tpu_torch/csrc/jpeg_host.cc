// Entropy decoder of one JPEG scan (Huffman, sequential or progressive):
// the host-side counterpart of data/jpeg.py::decode_scan_py, which is its
// spec; and the entropy coder of the writer's one sequential scan, the
// counterpart of data/jpeg_encode.py::encode_blocks_py.  It turns one scan's entropy-coded bytes (byte stuffing and RSTn
// markers included) into the quantized coefficient blocks of the scan's
// components, in place: the blocks are the progressive state that later
// scans refine.  Plain C++ with a C interface, built with the host compiler
// by kernels/__init__.py::host_library and loaded with ctypes.
//
// Coefficients are int16 in natural (row-major) order, 64 a block; each
// component's blocks are a (rows, stride, 64) array at its offset in one
// buffer.  Values wrap to 16 bits as libjpeg's JCOEF does.

#include <cstdint>
#include <cstring>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // past 63: a corrupt run lands here and is refused before use
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Error {
  kOk = 0,
  kTruncated = 1,
  kBadCode = 2,
  kBadRestart = 3,
  kPast63 = 4,
  kBadRefinement = 5,
  kBadTable = 6,
  kMissingTable = 7,
};

constexpr int kLookBits = 9;

struct Huffman {
  int32_t maxcode[17];  // largest code of each length, -1 where none
  int32_t valoff[17];   // symbol index = code + valoff[length]
  uint8_t vals[256];
  int16_t look[1 << kLookBits];  // (length << 8) | symbol, or -1

  int build(const uint8_t* counts, const uint8_t* symbols) {
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      int n = counts[l - 1];
      valoff[l] = k - code;
      code += n;
      k += n;
      if (k > 256 || code > (1 << l)) return kBadTable;
      maxcode[l] = n ? code - 1 : -1;
      code <<= 1;
    }
    std::memcpy(vals, symbols, k);
    for (int i = 0; i < (1 << kLookBits); ++i) look[i] = -1;
    code = 0;
    k = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int n = 0; n < counts[l - 1]; ++n, ++code, ++k) {
        int shift = kLookBits - l;
        for (int j = 0; j < (1 << shift); ++j)
          look[(code << shift) | j] = static_cast<int16_t>((l << 8) | vals[k]);
      }
      code <<= 1;
    }
    return kOk;
  }
};

// The bits of a scan.  It stops at a marker (RSTn or the end of the
// segment) and feeds zero bits past it; a decode that consumes one of those
// has run past the data, which the interval's end check refuses.
struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;
  bool at_marker = false;
  int64_t fed = 0, real = 0;  // bits put in the buffer, of which real

  void fill() {
    while (nbits <= 56) {
      uint64_t byte = 0;
      if (!at_marker && p < end) {
        if (*p != 0xFF) {
          byte = *p++;
          real += 8;
        } else if (p + 1 < end && p[1] == 0x00) {
          byte = 0xFF;
          p += 2;
          real += 8;
        } else {
          at_marker = true;
        }
      } else {
        at_marker = true;
      }
      buf |= byte << (56 - nbits);
      nbits += 8;
      fed += 8;
    }
  }

  int get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    nbits -= n;
    return v;
  }

  int huffman(const Huffman& h) {
    if (nbits < 16) fill();
    int e = h.look[buf >> (64 - kLookBits)];
    if (e >= 0) {
      buf <<= (e >> 8);
      nbits -= (e >> 8);
      return e & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int code = static_cast<int>(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        buf <<= l;
        nbits -= l;
        return h.vals[(code + h.valoff[l]) & 0xFF];
      }
    }
    return -1;
  }

  bool overran() const { return fed - nbits > real; }

  // the end of a restart interval: drop the padding bits, expect RSTn
  int restart(int expect) {
    if (overran()) return kTruncated;
    buf = 0;
    nbits = 0;
    fed = real = 0;
    at_marker = false;
    while (p < end && *p == 0xFF && p + 1 < end && p[1] == 0xFF) ++p;
    if (p + 1 >= end || p[0] != 0xFF || p[1] != 0xD0 + expect) return kBadRestart;
    p += 2;
    return kOk;
  }
};

inline int extend(int v, int s) { return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v; }

struct Component {
  int16_t* coefs;
  int h, v, stride, bw, bh, dc, ac;
};

struct Scan {
  int ss, se, ah, al, progressive;
  int eobrun = 0;
};

int decode_sequential(Reader& r, int16_t* block, const Huffman& dc, const Huffman& ac,
                      int& pred) {
  int s = r.huffman(dc);
  if (s < 0) return kBadCode;
  pred += extend(r.get(s), s);
  block[0] = static_cast<int16_t>(pred);
  for (int k = 1; k < 64; ++k) {
    int rs = r.huffman(ac);
    if (rs < 0) return kBadCode;
    int run = rs >> 4;
    s = rs & 15;
    if (s) {
      k += run;
      if (k > 63) return kPast63;
      block[kNatural[k]] = static_cast<int16_t>(extend(r.get(s), s));
    } else if (run != 15) {
      break;
    } else {
      k += 15;
    }
  }
  return kOk;
}

int decode_dc(Reader& r, int16_t* block, const Huffman& dc, int& pred, const Scan& sc) {
  if (sc.ah == 0) {
    int s = r.huffman(dc);
    if (s < 0) return kBadCode;
    pred += extend(r.get(s), s);
    block[0] = static_cast<int16_t>(static_cast<uint32_t>(pred) << sc.al);
  } else if (r.get(1)) {
    block[0] = static_cast<int16_t>(block[0] | (1 << sc.al));
  }
  return kOk;
}

int decode_ac_first(Reader& r, int16_t* block, const Huffman& ac, Scan& sc) {
  if (sc.eobrun) {
    --sc.eobrun;
    return kOk;
  }
  for (int k = sc.ss; k <= sc.se; ++k) {
    int rs = r.huffman(ac);
    if (rs < 0) return kBadCode;
    int run = rs >> 4, s = rs & 15;
    if (s) {
      k += run;
      if (k > 63) return kPast63;
      block[kNatural[k]] =
          static_cast<int16_t>(static_cast<uint32_t>(extend(r.get(s), s)) << sc.al);
    } else if (run == 15) {
      k += 15;
    } else {
      sc.eobrun = 1 << run;
      if (run) sc.eobrun += r.get(run);
      --sc.eobrun;
      break;
    }
  }
  return kOk;
}

int decode_ac_refine(Reader& r, int16_t* block, const Huffman& ac, Scan& sc) {
  const int p1 = 1 << sc.al, m1 = -(1 << sc.al);
  auto correct = [&](int pos) {
    if (r.get(1) && (block[pos] & p1) == 0)
      block[pos] = static_cast<int16_t>(block[pos] + (block[pos] >= 0 ? p1 : m1));
  };
  int k = sc.ss;
  if (sc.eobrun == 0) {
    for (; k <= sc.se; ++k) {
      int rs = r.huffman(ac);
      if (rs < 0) return kBadCode;
      int run = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1) return kBadRefinement;
        s = r.get(1) ? p1 : m1;
      } else if (run != 15) {
        sc.eobrun = 1 << run;
        if (run) sc.eobrun += r.get(run);
        break;
      }
      for (; k <= sc.se; ++k) {
        int pos = kNatural[k];
        if (block[pos] != 0) {
          correct(pos);
        } else {
          if (run == 0) break;
          --run;
        }
      }
      if (s) {
        if (k > 63) return kPast63;
        block[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
  }
  if (sc.eobrun > 0) {
    for (; k <= sc.se; ++k) {
      int pos = kNatural[k];
      if (block[pos] != 0) correct(pos);
    }
    --sc.eobrun;
  }
  return kOk;
}

int decode_block(Reader& r, const Component& c, int by, int bx, const Huffman* tables,
                 int& pred, Scan& sc) {
  int16_t* block = c.coefs + (static_cast<int64_t>(by) * c.stride + bx) * 64;
  const Huffman& dc = tables[c.dc];
  const Huffman& ac = tables[4 + c.ac];
  if (!sc.progressive) return decode_sequential(r, block, dc, ac, pred);
  if (sc.ss == 0) return decode_dc(r, block, dc, pred, sc);
  if (sc.ah == 0) return decode_ac_first(r, block, ac, sc);
  return decode_ac_refine(r, block, ac, sc);
}

// The writer's bit buffer: bits go in MSB first; each whole byte goes out,
// followed by a stuffed 0x00 where it is 0xFF (jchuff.c's emit_bits).
struct Writer {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t buf = 0;
  int nbits = 0;
  bool full = false;

  void put_byte(uint8_t b) {
    if (n + 2 > cap) {
      full = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0;
  }

  void put(uint32_t value, int size) {
    buf = (buf << size) | (value & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      nbits -= 8;
      put_byte(static_cast<uint8_t>(buf >> nbits));
    }
  }

  // the last byte padded with 1-bits
  void flush() { put(0x7F, 7 - ((nbits + 7) % 8)); }
};

inline int magnitude_bits(int v) {
  int n = 0;
  for (unsigned a = static_cast<unsigned>(v < 0 ? -v : v); a; a >>= 1) ++n;
  return n;
}

}  // namespace

extern "C" {

// seg, n: the scan's entropy-coded bytes.  coefs: every component's blocks;
// offsets[i]: where scan component i's blocks start (in coefficients).
// geom[i]: h, v, stride (blocks a row), bw, bh (blocks with data), DC table,
// AC table, rows.  huff: 8 tables (DC 0-3, AC 0-3) of 16 counts and 256
// symbols; present[t] says whether table t was defined.
int omj_decode_scan(const uint8_t* seg, int64_t n, int16_t* coefs, const int64_t* offsets,
                    const int32_t* geom, int ncomp, const uint8_t* huff, const uint8_t* present,
                    int mcux, int mcuy, int ss, int se, int ah, int al, int restart,
                    int progressive) {
  static thread_local Huffman tables[8];
  Component comps[4];
  Scan sc;
  sc.ss = ss;
  sc.se = se;
  sc.ah = ah;
  sc.al = al;
  sc.progressive = progressive;
  if (ncomp < 1 || ncomp > 4) return kBadTable;
  for (int i = 0; i < ncomp; ++i) {
    const int32_t* g = geom + 8 * i;
    comps[i] = Component{coefs + offsets[i], g[0], g[1], g[2], g[3], g[4], g[5], g[6]};
    bool needs_dc = !progressive || (ss == 0 && ah == 0);
    bool needs_ac = !progressive || ss > 0;
    if ((needs_dc && !present[g[5]]) || (needs_ac && !present[4 + g[6]])) return kMissingTable;
  }
  for (int t = 0; t < 8; ++t) {
    if (!present[t]) continue;
    int err = tables[t].build(huff + t * 272, huff + t * 272 + 16);
    if (err) return err;
  }
  Reader r{seg, seg + n};
  int pred[4] = {0, 0, 0, 0};
  int64_t n_mcus = ncomp == 1 ? static_cast<int64_t>(comps[0].bw) * comps[0].bh
                              : static_cast<int64_t>(mcux) * mcuy;
  int expect = 0;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (restart && m && m % restart == 0) {
      int err = r.restart(expect);
      if (err) return err;
      expect = (expect + 1) & 7;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      sc.eobrun = 0;
    }
    int err = kOk;
    if (ncomp == 1) {
      const Component& c = comps[0];
      err = decode_block(r, c, static_cast<int>(m / c.bw), static_cast<int>(m % c.bw), tables,
                         pred[0], sc);
    } else {
      int my = static_cast<int>(m / mcux), mx = static_cast<int>(m % mcux);
      for (int i = 0; i < ncomp && !err; ++i) {
        const Component& c = comps[i];
        for (int j = 0; j < c.v && !err; ++j)
          for (int k = 0; k < c.h && !err; ++k)
            err = decode_block(r, c, my * c.v + j, mx * c.h + k, tables, pred[i], sc);
      }
    }
    if (err) return err;
  }
  return r.overran() ? kTruncated : kOk;
}

// blocks: n quantized blocks of 64 coefficients (natural order) in MCU
// order; comp[b]: block b's component; tables[2 * c], tables[2 * c + 1]:
// component c's DC and AC table; codes, sizes: 8 tables (DC 0-3, AC 0-3)
// of 256 codes and their lengths.  Writes the scan's bytes to out (cap
// bytes) and returns their number, or -1 where cap is too small, -2 where
// a coefficient needs more than 11 bits (a DC difference more than 12).
int64_t omj_encode_blocks(const int16_t* blocks, int64_t n, const uint8_t* comp,
                          const int32_t* tables, int ncomp, const uint32_t* codes,
                          const uint8_t* sizes, uint8_t* out, int64_t cap) {
  Writer w{out, cap};
  int last_dc[4] = {0, 0, 0, 0};
  for (int64_t b = 0; b < n; ++b) {
    const int16_t* block = blocks + 64 * b;
    int c = comp[b];
    if (c >= ncomp) return -2;
    const uint32_t* dc_code = codes + 256 * tables[2 * c];
    const uint8_t* dc_size = sizes + 256 * tables[2 * c];
    const uint32_t* ac_code = codes + 256 * (4 + tables[2 * c + 1]);
    const uint8_t* ac_size = sizes + 256 * (4 + tables[2 * c + 1]);
    int diff = block[0] - last_dc[c];
    last_dc[c] = block[0];
    int nbits = magnitude_bits(diff);
    if (nbits > 11 + 1) return -2;
    w.put(dc_code[nbits], dc_size[nbits]);
    if (nbits) w.put(static_cast<uint32_t>(diff < 0 ? diff - 1 : diff), nbits);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = block[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      for (; run > 15; run -= 16) w.put(ac_code[0xF0], ac_size[0xF0]);
      nbits = magnitude_bits(v);
      if (nbits > 11) return -2;
      int symbol = (run << 4) + nbits;
      w.put(ac_code[symbol], ac_size[symbol]);
      w.put(static_cast<uint32_t>(v < 0 ? v - 1 : v), nbits);
      run = 0;
    }
    if (run) w.put(ac_code[0], ac_size[0]);
    if (w.full) return -1;
  }
  w.flush();
  return w.full ? -1 : w.n;
}

const char* omj_error_string(int err) {
  switch (err) {
    case kTruncated: return "a truncated or corrupt JPEG (entropy-coded data ends early)";
    case kBadCode: return "a corrupt JPEG (bad Huffman code)";
    case kBadRestart: return "a corrupt JPEG (restart marker out of sequence)";
    case kPast63: return "a corrupt JPEG (coefficient past 63)";
    case kBadRefinement: return "a corrupt JPEG (refinement of size other than 1)";
    case kBadTable: return "a corrupt JPEG (Huffman table)";
    case kMissingTable: return "a corrupt JPEG (missing Huffman table)";
    default: return "no error";
  }
}

}  // extern "C"
