// TIFF's LZW codec (MSB-first codes of 9 to 12 bits, ClearCode 256, EOI
// 257, libtiff's early change of code width): the host-side counterparts
// of data/tiff.py::lzw_decode and lzw_encode, which are their spec.  Plain
// C++ with a C interface, built with the host compiler by
// kernels/__init__.py::host_library and loaded with ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kMaxBits = 12;
constexpr int kTableFull = 4094;  // libtiff's CODE_MAX - 1: a ClearCode follows

struct BitWriter {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t buf = 0;
  int nbits = 0;
  bool full = false;

  void put(int code, int width) {
    buf = (buf << width) | static_cast<uint64_t>(code);
    nbits += width;
    while (nbits >= 8) {
      nbits -= 8;
      if (n >= cap) {
        full = true;
        return;
      }
      out[n++] = static_cast<uint8_t>(buf >> nbits);
    }
  }

  void flush() {
    if (nbits) put(0, 8 - nbits);
  }
};

}  // namespace

extern "C" {

// in, n: the compressed bytes; out, cap: room for the decoded bytes.
// Returns the bytes decoded (stopping at EOI, at the end of the input or
// when out is full), -1 for a code that is neither in the table nor the
// next one, -2 for the old (LSB-first) form.
int64_t omt_lzw_decode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) return -2;
  // each entry: its first byte, its length and the entry it extends
  std::vector<int32_t> prefix(4096), length(4096);
  std::vector<uint8_t> last(4096), first(4096);
  for (int i = 0; i < 256; ++i) {
    prefix[i] = -1;
    length[i] = 1;
    last[i] = first[i] = static_cast<uint8_t>(i);
  }
  int next = kFirst, width = 9, prev = -1;
  int64_t pos = 0, written = 0;
  uint64_t buf = 0;
  int nbits = 0;
  while (written < cap) {
    while (nbits < width && pos < n) {
      buf = (buf << 8) | in[pos++];
      nbits += 8;
    }
    if (nbits < width) break;
    int code = static_cast<int>((buf >> (nbits - width)) & ((1u << width) - 1));
    nbits -= width;
    if (code == kEoi) break;
    if (code == kClear) {
      next = kFirst;
      width = 9;
      prev = -1;
      continue;
    }
    int entry = code;
    if (code >= next) {
      if (prev < 0 || code != next) return -1;
      entry = -1;  // the previous string and its own first byte (KwKwK)
    }
    if (prev >= 0 && next < 4096) {
      prefix[next] = prev;
      length[next] = length[prev] + 1;
      first[next] = first[prev];
      last[next] = entry >= 0 ? first[entry] : first[prev];
      if (entry < 0) entry = next;
      ++next;
    }
    if (entry < 0) return -1;
    // write the entry's bytes back to front, cut at cap
    int64_t len = length[entry];
    int64_t end = written + len;
    for (int e = entry, i = static_cast<int>(len - 1); e >= 0; e = prefix[e], --i)
      if (written + i < cap) out[written + i] = last[e];
    written = end < cap ? end : cap;
    prev = code;
    if (next >= (1 << width) - 1 && width < kMaxBits) ++width;
  }
  return written;
}

// in, n: the bytes to compress; out, cap: room for the codes.  Returns
// the bytes written, or -1 where cap is too small.
int64_t omt_lzw_encode(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap) {
  // table[entry * 256 + byte]: the code of entry + byte, 0 where none
  std::vector<uint16_t> table(4096 * 256, 0);
  BitWriter w{out, cap};
  int next = kFirst, width = 9;
  w.put(kClear, width);
  if (n == 0) {
    w.put(kEoi, width);
    w.flush();
    return w.full ? -1 : w.n;
  }
  int current = in[0];
  for (int64_t i = 1; i < n; ++i) {
    uint8_t byte = in[i];
    uint16_t& slot = table[static_cast<size_t>(current) * 256 + byte];
    if (slot) {
      current = slot;
      continue;
    }
    w.put(current, width);
    slot = static_cast<uint16_t>(next++);
    if (next == kTableFull) {
      w.put(kClear, width);
      std::memset(table.data(), 0, table.size() * sizeof(uint16_t));
      next = kFirst;
      width = 9;
    } else if (next > (1 << width) - 1) {
      ++width;
    }
    current = byte;
  }
  w.put(current, width);
  ++next;
  if (next > (1 << width) - 1 && width < kMaxBits) ++width;
  w.put(kEoi, width);
  w.flush();
  return w.full ? -1 : w.n;
}

}  // extern "C"
