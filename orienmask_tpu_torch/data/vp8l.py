"""WebP's lossless bitstream (VP8L), decode and encode, written from the
WebP Lossless Bitstream Specification (RFC 9649), without libwebp.

Decode: the header, the four transforms (predictor with its 14 modes,
colour transform, subtract-green, colour indexing with pixel bundling at
1, 2 and 4 bits), inverted in reverse order, and the entropy-coded images
(prefix codes in the simple and the normal form, the code-length code,
meta prefix codes, LZ77 backward references with the 120-entry distance
map, the colour cache).  ``decode`` gives the (H, W) ARGB words.

The loops that are too slow in Python run in ``csrc/webp_host.cc``
(``kernels.host_library("webp_host")``): an entropy-coded image
(``decode_image_native``), the predictor inverse (``predictor_native``),
and the encoder's mode choice and residuals (``predictor_forward_native``),
LZ77 with the colour cache (``backward_refs_native``) and bit packing
(``BitWriter.pack_native``).  Their Python versions here (``..._py``) are
the spec the tests hold the C++ to; the codec runs the C++ and raises when
it cannot be built.

Encode (``encode``, what ``write_image(".webp")`` writes for cv2's
lossless default): subtract-green, a predictor transform with the mode of
each 16x16 tile chosen by the least absolute residual (an image of at
most 256 colours: colour indexing with the indices bundled instead), LZ77
references with a colour cache where it pays, and prefix codes built from
the histograms and limited to 15 bits.  Its bytes are deterministic; they are
not libwebp's (libwebp searches many encodings), but every decoder reads
them back to the pixels written.
"""

import heapq
import struct

import numpy as np


class UnsupportedWebP(ValueError):
    pass


SIGNATURE = 0x2F
# the writer's predictor tiles (16x16) and the candidates its LZ77 checks
PREDICTOR_BITS = 4
CHAIN = 32
NUM_LITERAL = 256
NUM_LENGTH_CODES = 24
NUM_DISTANCE_CODES = 40
MAX_CACHE_BITS = 11
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# the distance map: distance code i + 1 is the offset (x, y), x to the left
DISTANCE_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1), (-2, 1),
    (2, 2), (-2, 2), (0, 3), (3, 0), (1, 3), (-1, 3), (3, 1), (-3, 1), (2, 3), (-2, 3),
    (3, 2), (-3, 2), (0, 4), (4, 0), (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3),
    (2, 4), (-2, 4), (4, 2), (-4, 2), (0, 5), (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0),
    (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4), (-4, 4),
    (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0), (1, 6), (-1, 6), (6, 1), (-6, 1),
    (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6),
    (6, 3), (-6, 3), (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1),
    (4, 6), (-4, 6), (6, 4), (-6, 4), (2, 7), (-2, 7), (7, 2), (-7, 2), (3, 7), (-3, 7),
    (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0), (4, 7), (-4, 7), (7, 4),
    (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6), (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5),
    (8, 4), (6, 7), (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))
# the C++ decoder's return codes below 0
ERRORS = {-1: "a truncated VP8L bitstream", -2: "a VP8L colour cache of more than 11 bits",
          -3: "an invalid VP8L prefix code", -4: "a VP8L backward reference out of the image",
          -5: "a VP8L code-length repeat past its alphabet", -6: "out of memory"}


# ------------------------------------------------------------------ reader

class BitReader:
    """VP8L's bits, least significant first; ``pos`` counts bits."""

    def __init__(self, data, pos=0):
        self.data = bytes(data) + b"\x00" * 8
        self.end = 8 * len(data)
        self.pos = pos

    def read(self, n):
        if n == 0:
            return 0
        at = self.pos
        word = int.from_bytes(self.data[at >> 3:(at >> 3) + 8], "little")
        self.pos = at + n
        if self.pos > self.end:
            raise UnsupportedWebP(ERRORS[-1])
        return (word >> (at & 7)) & ((1 << n) - 1)

    def peek(self, n):
        at = self.pos
        return (int.from_bytes(self.data[at >> 3:(at >> 3) + 4], "little") >> (at & 7)) & (
            (1 << n) - 1)

    def skip(self, n):
        self.pos += n
        if self.pos > self.end:
            raise UnsupportedWebP(ERRORS[-1])


def read_header(data):
    """(width, height, alpha hint) of a VP8L chunk's payload."""
    if len(data) < 5 or data[0] != SIGNATURE:
        raise UnsupportedWebP("a VP8L chunk without its signature")
    (bits,) = struct.unpack_from("<I", data, 1)
    if bits >> 29:
        raise UnsupportedWebP(f"a VP8L bitstream of version {bits >> 29}")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1, (bits >> 28) & 1


class PrefixCode:
    """A canonical prefix code from its code lengths, as a lookup table of
    ``bits`` bits: the next bits (read least significant first) -> symbol
    and its length.  One symbol is a code of no bits; an incomplete or
    over-subscribed code raises."""

    def __init__(self, lengths):
        lengths = [int(n) for n in lengths]
        used = [s for s, n in enumerate(lengths) if n]
        if not used:
            raise UnsupportedWebP(ERRORS[-3])
        if len(used) == 1:
            self.bits, self.symbols, self.lengths = 0, [used[0]], [0]
            return
        self.bits = max(lengths)
        if sum(1 << (self.bits - lengths[s]) for s in used) != 1 << self.bits:
            raise UnsupportedWebP(ERRORS[-3])
        size = 1 << self.bits
        symbols, code_lengths = [0] * size, [0] * size
        code = 0
        for length in range(1, self.bits + 1):
            for s in used:
                if lengths[s] != length:
                    continue
                rev = int(format(code, f"0{length}b")[::-1], 2)
                for i in range(rev, size, 1 << length):
                    symbols[i], code_lengths[i] = s, length
                code += 1
            code <<= 1
        self.symbols, self.lengths = symbols, code_lengths

    def read(self, br):
        if self.bits == 0:
            return self.symbols[0]
        i = br.peek(self.bits)
        br.skip(self.lengths[i])
        return self.symbols[i]


def read_code(br, alphabet):
    """One prefix code of an ``alphabet``-symbol alphabet, simple or normal."""
    lengths = [0] * alphabet
    if br.read(1):  # simple: one or two symbols
        n = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        if first < alphabet:
            lengths[first] = 1
        if n == 2:
            second = br.read(8)
            if second < alphabet:
                lengths[second] = 1
        return PrefixCode(lengths)
    n_codes = br.read(4) + 4
    cl_lengths = [0] * 19
    for i in range(n_codes):
        cl_lengths[CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_code = PrefixCode(cl_lengths)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise UnsupportedWebP(ERRORS[-3])
    else:
        max_symbol = alphabet
    symbol, prev = 0, 8
    while symbol < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        length = cl_code.read(br)
        if length < 16:
            lengths[symbol] = length
            symbol += 1
            if length:
                prev = length
            continue
        extra, offset = ((2, 3), (3, 3), (7, 11))[length - 16]
        repeat = br.read(extra) + offset
        if symbol + repeat > alphabet:
            raise UnsupportedWebP(ERRORS[-5])
        value = prev if length == 16 else 0
        lengths[symbol:symbol + repeat] = [value] * repeat
        symbol += repeat
    return PrefixCode(lengths)


def copy_length(br, symbol):
    """A length or distance prefix symbol and its extra bits -> the value."""
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def plane_distance(xsize, code):
    if code > 120:
        return code - 120
    dx, dy = DISTANCE_MAP[code - 1]
    return max(1, dx + dy * xsize)


def decode_image_py(br, xsize, ysize, level0):
    """One entropy-coded image at ``br``: its colour cache info, its meta
    prefix codes (the main image alone), its prefix codes and its LZ77
    data -> ``xsize * ysize`` ARGB words (a flat uint32 array)."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= MAX_CACHE_BITS:
            raise UnsupportedWebP(ERRORS[-2])
    groups_image, group_bits = None, 0
    if level0 and br.read(1):
        group_bits = br.read(3) + 2
        gw = -(-xsize // (1 << group_bits))
        gh = -(-ysize // (1 << group_bits))
        groups_image = [(p >> 8) & 0xFFFF for p in decode_image_py(br, gw, gh, False)]
        n_groups = max(groups_image) + 1
    else:
        n_groups = 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    alphabets = (NUM_LITERAL + NUM_LENGTH_CODES + cache_size, 256, 256, 256,
                 NUM_DISTANCE_CODES)
    groups = [[read_code(br, a) for a in alphabets] for _ in range(n_groups)]
    total = xsize * ysize
    out = [0] * total
    cache = [0] * cache_size
    shift = 32 - cache_bits
    pos = 0
    group = groups[0]
    gw = -(-xsize // (1 << group_bits))
    while pos < total:
        if groups_image is not None:  # the group of the next pixel's tile
            x, y = pos % xsize, pos // xsize
            group = groups[groups_image[(y >> group_bits) * gw + (x >> group_bits)]]
        start = pos
        code = group[0].read(br)
        if code < NUM_LITERAL:
            red = group[1].read(br)
            blue = group[2].read(br)
            alpha = group[3].read(br)
            out[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
            pos += 1
        elif code < NUM_LITERAL + NUM_LENGTH_CODES:
            length = copy_length(br, code - NUM_LITERAL)
            dist = plane_distance(xsize, copy_length(br, group[4].read(br)))
            if dist > pos or length > total - pos:
                raise UnsupportedWebP(ERRORS[-4])
            for i in range(pos, pos + length):
                out[i] = out[i - dist]
            pos += length
        else:
            out[pos] = cache[code - NUM_LITERAL - NUM_LENGTH_CODES]
            pos += 1
        if cache_size:  # every pixel enters the cache
            for i in range(start, pos):
                cache[((out[i] * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = out[i]
    return np.array(out, np.uint32)


# -------------------------------------------------------------- transforms

def _average2(a, b):
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(p):
    return (p >> 24) & 0xFF, (p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF


def _pack(channels):
    a, r, g, b = channels
    return (a << 24) | (r << 16) | (g << 8) | b


def _clamp(v):
    return 0 if v < 0 else 255 if v > 255 else v


def predict_py(mode, left, top, top_right, top_left):
    """Predictor ``mode`` (0-15) of one pixel from its neighbours."""
    if mode == 0 or mode >= 14:
        return 0xFF000000
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return top_right
    if mode == 4:
        return top_left
    if mode == 5:
        return _average2(_average2(left, top_right), top)
    if mode == 6:
        return _average2(left, top_left)
    if mode == 7:
        return _average2(left, top)
    if mode == 8:
        return _average2(top_left, top)
    if mode == 9:
        return _average2(top, top_right)
    if mode == 10:
        return _average2(_average2(left, top_left), _average2(top, top_right))
    lc, tc, tlc = _channels(left), _channels(top), _channels(top_left)
    if mode == 11:  # select: left or top, the one nearer the gradient's estimate
        p_left = sum(abs(t - tl) for t, tl in zip(tc, tlc))
        p_top = sum(abs(le - tl) for le, tl in zip(lc, tlc))
        return left if p_left < p_top else top
    if mode == 12:
        return _pack([_clamp(le + t - tl) for le, t, tl in zip(lc, tc, tlc)])
    avg = _channels(_average2(left, top))  # mode 13: a + (a - b) / 2, C's division
    return _pack([_clamp(a + int((a - tl) / 2)) for a, tl in zip(avg, tlc)])


def _add_pixels(a, b):
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | (
        ((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def predictor_py(pixels, width, height, modes, bits):
    """Invert the predictor transform in place on flat ``pixels``: the top
    row predicts from the left (its first pixel from black), the left
    column from above, the rest by its tile's mode in ``modes`` (the
    sub-image's green); the top-right of the last column is the first
    pixel of the row."""
    px = pixels.tolist()
    tiles_w = -(-width // (1 << bits))
    modes = modes.tolist()
    for y in range(height):
        row = y * width
        for x in range(width):
            i = row + x
            if y == 0:
                pred = 0xFF000000 if x == 0 else px[i - 1]
            elif x == 0:
                pred = px[i - width]
            else:
                mode = (modes[(y >> bits) * tiles_w + (x >> bits)] >> 8) & 0xF
                pred = predict_py(mode, px[i - 1], px[i - width], px[i - width + 1],
                                  px[i - width - 1])
            px[i] = _add_pixels(px[i], pred)
    pixels[:] = px


def color_transform_inverse(pixels, width, height, elements, bits):
    """Invert the colour transform: red += g2r*g >> 5, blue += g2b*g >> 5 +
    r2b*red' >> 5, each factor and channel a signed byte."""
    tiles_w = -(-width // (1 << bits))
    y, x = np.divmod(np.arange(width * height), width)
    e = elements[(y >> bits) * tiles_w + (x >> bits)]
    g2r = (e & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    g2b = ((e >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    r2b = ((e >> 16) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    green = ((pixels >> 8) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int32)
    red = ((pixels >> 16) & 0xFF).astype(np.int32) + ((g2r * green) >> 5)
    red &= 0xFF
    red_s = red.astype(np.uint8).view(np.int8).astype(np.int32)
    blue = (pixels & 0xFF).astype(np.int32) + ((g2b * green) >> 5) + ((r2b * red_s) >> 5)
    blue &= 0xFF
    return (pixels & np.uint32(0xFF00FF00)) | (red.astype(np.uint32) << 16) | blue.astype(
        np.uint32)


def add_green(pixels):
    green = (pixels >> 8) & 0xFF
    red_blue = (pixels & 0x00FF00FF) + (green << 16) + green
    return (pixels & np.uint32(0xFF00FF00)) | (red_blue & np.uint32(0x00FF00FF))


def color_index_inverse(pixels, width, height, palette, xbits):
    """Expand bundled palette indices (the packed green channel) to the
    palette's colours; an index past the palette reads 0."""
    table = np.zeros(256, np.uint32)
    table[:len(palette)] = palette
    packed_w = -(-width // (1 << xbits))
    green = ((pixels.reshape(height, packed_w) >> 8) & 0xFF).astype(np.int64)
    if xbits == 0:
        return table[green].reshape(-1)
    per = 1 << xbits
    bpp = 8 >> xbits
    x = np.arange(width)
    index = (green[:, x >> xbits] >> ((x & (per - 1)) * bpp)) & ((1 << bpp) - 1)
    return table[index].reshape(-1)


# ------------------------------------------------------------------ decode

def decode(payload, image_decoder=None, predictor=None):
    """A VP8L chunk's payload -> (H, W) uint32 ARGB words.  The entropy
    decoder and the predictor inverse are the C++ ones unless given."""
    image_decoder = image_decoder or decode_image_native
    predictor = predictor or predictor_native
    width, height, _ = read_header(payload)
    br = BitReader(payload, 40)
    transforms, xsize, seen = [], width, set()
    while br.read(1):
        kind = br.read(2)
        if kind in seen:
            raise UnsupportedWebP("a VP8L transform used twice")
        seen.add(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            data = image_decoder(br, -(-xsize // (1 << bits)), -(-height // (1 << bits)), False)
            transforms.append((kind, xsize, bits, data))
        elif kind == 2:
            transforms.append((kind, xsize, 0, None))
        else:
            size = br.read(8) + 1
            palette = image_decoder(br, size, 1, False)
            palette = _palette_deltas(palette)
            xbits = 3 if size <= 2 else 2 if size <= 4 else 1 if size <= 16 else 0
            transforms.append((kind, xsize, xbits, palette))
            xsize = -(-xsize // (1 << xbits))
    pixels = image_decoder(br, xsize, height, True)
    for kind, tw, bits, data in reversed(transforms):
        if kind == 0:
            predictor(pixels, tw, height, data, bits)
        elif kind == 1:
            pixels = color_transform_inverse(pixels, tw, height, data, bits)
        elif kind == 2:
            pixels = add_green(pixels)
        else:
            pixels = color_index_inverse(pixels, tw, height, data, bits)
    return pixels.reshape(height, width)


def _palette_deltas(palette):
    """The colour table is coded as per-channel differences."""
    out = palette.copy()
    for i in range(1, len(out)):
        out[i] = _add_pixels(int(out[i]), int(out[i - 1]))
    return out


def argb_to_rgb(argb):
    return np.stack([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF, argb & 0xFF],
                    axis=-1).astype(np.uint8)


# ------------------------------------------------------------------ native

def _lib():
    from .. import kernels

    return kernels.host_library("webp_host")


def decode_image_native(br, xsize, ysize, level0):
    """``decode_image_py`` in C++ (``csrc/webp_host.cc``)."""
    out = np.empty(xsize * ysize, np.uint32)
    data = np.frombuffer(br.data, np.uint8)
    pos = _lib().omw_vp8l_image(data.ctypes.data, br.end // 8, br.pos, xsize, ysize,
                                int(level0), out.ctypes.data)
    if pos < 0:
        raise UnsupportedWebP(ERRORS.get(pos, f"VP8L error {pos}"))
    br.pos = pos
    return out


def predictor_native(pixels, width, height, modes, bits):
    """``predictor_py`` in C++."""
    modes = np.ascontiguousarray(modes, np.uint32)
    _lib().omw_vp8l_predictor(pixels.ctypes.data, width, height, modes.ctypes.data, bits)


# ------------------------------------------------------------------ encode

class BitWriter:
    """Bits least significant first, gathered as (value, width) pairs and
    packed once (``pack_native``; ``pack_py`` is its spec)."""

    def __init__(self):
        self.values, self.widths = [], []

    def write(self, value, n):
        self.values.append(value)
        self.widths.append(n)

    def extend(self, values, widths):
        self.values.append(np.asarray(values, np.int64))
        self.widths.append(np.asarray(widths, np.int64))

    def getvalue(self):
        vals, widths = [], []
        scalars_v, scalars_w = [], []
        for v, w in zip(self.values, self.widths):
            if isinstance(v, np.ndarray):
                if scalars_v:
                    vals.append(np.array(scalars_v, np.int64))
                    widths.append(np.array(scalars_w, np.int64))
                    scalars_v, scalars_w = [], []
                vals.append(v)
                widths.append(w)
            else:
                scalars_v.append(v)
                scalars_w.append(w)
        if scalars_v:
            vals.append(np.array(scalars_v, np.int64))
            widths.append(np.array(scalars_w, np.int64))
        v = np.concatenate(vals) if vals else np.zeros(0, np.int64)
        w = np.concatenate(widths) if widths else np.zeros(0, np.int64)
        return self.pack(v, w)

    @staticmethod
    def pack_py(v, w):
        """(values, widths) -> bytes, least significant bit first."""
        keep = w > 0
        v, w = v[keep], w[keep]
        starts = np.concatenate([[0], np.cumsum(w)[:-1]]) if len(w) else w
        total = int(w.sum())
        bits = np.zeros(-(-total // 8) * 8, np.uint8)
        for j in range(int(w.max()) if len(w) else 0):
            sel = w > j
            bits[starts[sel] + j] = (v[sel] >> j) & 1
        return np.packbits(bits, bitorder="little").tobytes()

    @staticmethod
    def pack_native(v, w):
        """``pack_py`` in C++."""
        v = np.ascontiguousarray(v, np.int64)
        w = np.ascontiguousarray(w, np.int64)
        out = np.empty(int(w.sum()) // 8 + 1, np.uint8)
        n = _lib().omw_vp8l_pack_bits(v.ctypes.data, w.ctypes.data, len(v), out.ctypes.data,
                                      len(out))
        if n < 0:
            raise MemoryError("omw_vp8l_pack_bits")
        return out[:n].tobytes()

    pack = pack_native


def huffman_lengths(counts, limit=15):
    """Code lengths of a Huffman code for ``counts``, at most ``limit``
    bits: small counts are raised (doubling their floor) until the tree
    fits.  Ties break by symbol, so the lengths are deterministic."""
    counts = np.asarray(counts, np.int64)
    used = np.flatnonzero(counts)
    lengths = np.zeros(len(counts), np.int64)
    if len(used) <= 1:
        lengths[used] = 1
        return lengths
    floor = 1
    while True:
        c = np.maximum(counts[used], floor)
        heap = [(int(n), i, None) for i, n in enumerate(c)]
        heapq.heapify(heap)
        parent = {}
        nxt = len(used)
        while len(heap) > 1:
            n1, i1, _ = heapq.heappop(heap)
            n2, i2, _ = heapq.heappop(heap)
            parent[i1] = parent[i2] = nxt
            heapq.heappush(heap, (n1 + n2, nxt, None))
            nxt += 1
        depth = {}
        root = heap[0][1]
        depth[root] = 0

        def d(node):
            if node not in depth:
                depth[node] = d(parent[node]) + 1
            return depth[node]

        got = np.array([d(i) for i in range(len(used))], np.int64)
        if got.max() <= limit:
            lengths[used] = got
            return lengths
        floor *= 2


def canonical_codes(lengths):
    """Each symbol's code, bit-reversed for the least-significant-first
    stream (0 for symbols of no code)."""
    lengths = np.asarray(lengths, np.int64)
    codes = np.zeros(len(lengths), np.int64)
    code = 0
    for length in range(1, int(lengths.max()) + 1 if len(lengths) else 1):
        for s in np.flatnonzero(lengths == length):
            codes[s] = int(format(code, f"0{length}b")[::-1], 2)
            code += 1
        code <<= 1
    return codes


def _write_code_lengths_code(bw, lengths):
    """The normal form of a prefix code: its lengths run-length coded with
    the code-length code (16: repeat the previous non-zero length 3-6
    times, 17: 3-10 zeros, 18: 11-138 zeros)."""
    tokens = []
    i, n = 0, len(lengths)
    prev = 8
    while i < n:
        v = int(lengths[i])
        run = 1
        while i + run < n and int(lengths[i + run]) == v:
            run += 1
        if v == 0:
            left = run
            while left >= 3:
                k = min(left, 138)
                if k >= 11:
                    tokens.append((18, k - 11, 7))
                else:
                    tokens.append((17, k - 3, 3))
                left -= k
            tokens.extend([(0, 0, 0)] * left)
        else:
            left = run
            if v != prev:
                tokens.append((v, 0, 0))
                prev = v
                left -= 1
            while left >= 3:
                k = min(left, 6)
                tokens.append((16, k - 3, 2))
                left -= k
            tokens.extend([(v, 0, 0)] * left)
        i += run
    counts = np.bincount([t[0] for t in tokens], minlength=19)
    cl_lengths = huffman_lengths(counts, 7)
    if (cl_lengths > 0).sum() == 1:  # one code-length symbol: give it a partner
        other = 0 if tokens[0][0] != 0 else 1
        cl_lengths[other] = 1
    cl_codes = canonical_codes(cl_lengths)
    order_lengths = [int(cl_lengths[s]) for s in CODE_LENGTH_ORDER]
    n_codes = max(4, max(i + 1 for i, v in enumerate(order_lengths) if v) if any(
        order_lengths) else 4)
    bw.write(0, 1)  # normal form
    bw.write(n_codes - 4, 4)
    for i in range(n_codes):
        bw.write(order_lengths[i], 3)
    bw.write(0, 1)  # max_symbol: the whole alphabet
    for sym, extra, nbits in tokens:
        bw.write(int(cl_codes[sym]), int(cl_lengths[sym]))
        if nbits:
            bw.write(extra, nbits)


def write_code(bw, counts):
    """Write the prefix code of histogram ``counts``; its (codes, lengths)."""
    counts = np.asarray(counts, np.int64)
    used = np.flatnonzero(counts)
    if len(used) <= 2 and (len(used) == 0 or used.max() < 256):
        symbols = list(used) or [0]
        bw.write(1, 1)  # simple form
        bw.write(len(symbols) - 1, 1)
        if symbols[0] < 2:
            bw.write(0, 1)
            bw.write(int(symbols[0]), 1)
        else:
            bw.write(1, 1)
            bw.write(int(symbols[0]), 8)
        if len(symbols) == 2:
            bw.write(int(symbols[1]), 8)
        lengths = np.zeros(len(counts), np.int64)
        codes = np.zeros(len(counts), np.int64)
        if len(symbols) == 2:
            lengths[symbols] = 1
            codes[symbols[1]] = 1
        return codes, lengths
    lengths = huffman_lengths(counts)
    _write_code_lengths_code(bw, lengths)
    if len(used) == 1:  # a code of one symbol takes no bits
        return np.zeros(len(counts), np.int64), np.zeros(len(counts), np.int64)
    return canonical_codes(lengths), lengths


def prefix_encode(values):
    """Values >= 1 -> (prefix symbol, extra bits value, extra bit count),
    the inverse of ``copy_length``."""
    v = np.asarray(values, np.int64) - 1
    small = v < 4
    hb = np.zeros_like(v)
    big = ~small
    hb[big] = np.floor(np.log2(v[big])).astype(np.int64)
    # guard against float rounding at powers of two
    hb[big] -= (1 << hb[big]) > v[big]
    hb[big] += (1 << (hb[big] + 1)) <= v[big]
    second = np.where(big, (v >> np.maximum(hb - 1, 0)) & 1, 0)
    extra_bits = np.where(big, hb - 1, 0)
    symbol = np.where(small, v, 2 * hb + second)
    extra = np.where(big, v & ((1 << extra_bits) - 1), 0)
    return symbol, extra, extra_bits


def _plane_codes(xsize, dist):
    """Distances in pixels -> distance codes (the 120 short offsets where
    one matches, else distance + 120)."""
    table = {}
    for i, (dx, dy) in enumerate(DISTANCE_MAP):
        table[(dx, dy)] = i + 1
    dist = np.asarray(dist, np.int64)
    codes = dist + 120
    yo, xo = np.divmod(dist, xsize)
    for i in range(len(dist)):
        d = int(dist[i])
        y, x = int(yo[i]), int(xo[i])
        if x <= 8 and (x, y) in table and x + y * xsize == d:
            codes[i] = table[(x, y)]
        elif x > xsize - 8 and (x - xsize, y + 1) in table:
            codes[i] = min(codes[i], table[(x - xsize, y + 1)])
    return codes


def backward_refs_py(argb, xsize, cache_bits):
    """Greedy LZ77 over flat ``argb`` with a hash chain of pixel pairs (the
    ``CHAIN`` most recent candidates, the left and upper pixel first),
    matches of 3-4096 pixels, then the colour cache on the literals.
    Returns tokens (kind, a, b): kind 0 a literal (a: the pixel), 1 a copy
    (a: length, b: distance in pixels), 2 a cache hit (a: its index)."""
    n = len(argb)
    px = [int(p) for p in argb]
    head, prev = {}, [-1] * n
    kinds, aa, bb = [], [], []
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    i = 0

    def insert(j):
        if j + 1 < n:
            key = (px[j], px[j + 1])
            prev[j] = head.get(key, -1)
            head[key] = j

    while i < n:
        best_len, best_dist = 0, 0
        if i + 1 < n:
            limit = min(4096, n - i)
            cands = []
            for d in (1, xsize):
                if i - d >= 0:
                    cands.append(i - d)
            j = head.get((px[i], px[i + 1]), -1)
            k = 0
            while j >= 0 and k < CHAIN:
                cands.append(j)
                j = prev[j]
                k += 1
            for j in cands:
                length = 0
                while length < limit and px[j + length] == px[i + length]:
                    length += 1
                if length > best_len or (length == best_len and i - j < best_dist):
                    best_len, best_dist = length, i - j
        if best_len >= 3:
            kinds.append(1)
            aa.append(best_len)
            bb.append(best_dist)
            for j in range(i, i + best_len):
                insert(j)
                if cache is not None:
                    cache[((px[j] * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px[j]
            i += best_len
            continue
        p = px[i]
        if cache is not None:
            key = ((p * 0x1E35A7BD) & 0xFFFFFFFF) >> shift
            if cache[key] == p:
                kinds.append(2)
                aa.append(key)
            else:
                kinds.append(0)
                aa.append(p)
            cache[key] = p
        else:
            kinds.append(0)
            aa.append(p)
        bb.append(0)
        insert(i)
        i += 1
    return (np.array(kinds, np.int32), np.array(aa, np.int64).astype(np.uint32),
            np.array(bb, np.int32))


def backward_refs_native(argb, xsize, cache_bits):
    """``backward_refs_py`` in C++."""
    argb = np.ascontiguousarray(argb, np.uint32)
    n = len(argb)
    kinds = np.empty(n, np.int32)
    aa = np.empty(n, np.uint32)
    bb = np.empty(n, np.int32)
    count = _lib().omw_vp8l_backward_refs(argb.ctypes.data, n, xsize, cache_bits, CHAIN,
                                          kinds.ctypes.data, aa.ctypes.data, bb.ctypes.data)
    if count < 0:
        raise MemoryError("omw_vp8l_backward_refs")
    return kinds[:count], aa[:count], bb[:count]


def _predictions(argb, width, height):
    """The 14 predictor modes' predictions of every pixel from its
    neighbours in the image: (14, H, W) uint32 (edges filled as the
    decoder's; only interior pixels use them)."""
    img = argb.reshape(height, width).astype(np.int64)
    left = np.zeros_like(img)
    left[:, 1:] = img[:, :-1]
    top = np.zeros_like(img)
    top[1:] = img[:-1]
    top_left = np.zeros_like(img)
    top_left[1:, 1:] = img[:-1, :-1]
    flat = img.reshape(-1)
    top_right = np.zeros_like(flat)
    idx = np.arange(width, len(flat))
    top_right[width:] = flat[idx - width + 1]  # the last column wraps to the row's start
    top_right = top_right.reshape(height, width)

    def avg(a, b):
        return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)

    def ch(p):
        return [(p >> s) & 0xFF for s in (24, 16, 8, 0)]

    def pack(cs):
        return (cs[0] << 24) | (cs[1] << 16) | (cs[2] << 8) | cs[3]

    lc, tc, tlc = ch(left), ch(top), ch(top_left)
    p_left = sum(np.abs(t - tl) for t, tl in zip(tc, tlc))
    p_top = sum(np.abs(le - tl) for le, tl in zip(lc, tlc))
    full = pack([np.clip(le + t - tl, 0, 255) for le, t, tl in zip(lc, tc, tlc)])
    a2 = ch(avg(left, top))
    half = pack([np.clip(a + np.trunc((a - tl) / 2).astype(np.int64), 0, 255)
                 for a, tl in zip(a2, tlc)])
    preds = [np.full_like(img, 0xFF000000), left, top, top_right, top_left,
             avg(avg(left, top_right), top), avg(left, top_left), avg(left, top),
             avg(top_left, top), avg(top, top_right),
             avg(avg(left, top_left), avg(top, top_right)),
             np.where(p_left < p_top, left, top), full, half]
    return np.stack(preds).astype(np.uint32)


def _sub_pixels(a, b):
    return (((a | 0x00FF00FF) - (b & 0xFF00FF00)) & 0xFF00FF00) | (
        ((a | 0xFF00FF00) - (b & 0x00FF00FF)) & 0x00FF00FF)


_BYTE_COST = np.minimum(np.arange(256), 256 - np.arange(256)).astype(np.uint16)


def _residual_cost(res):
    """Sum over channels of |residual| as a signed byte."""
    channels = np.ascontiguousarray(res, np.uint32).view(np.uint8)
    return _BYTE_COST[channels].reshape(res.shape + (4,)).sum(axis=-1, dtype=np.int64)


def predictor_forward_native(argb, width, height):
    """``predictor_forward_py`` in C++."""
    argb = np.ascontiguousarray(argb, np.uint32)
    residuals = np.empty(width * height, np.uint32)
    bits = PREDICTOR_BITS
    modes = np.empty((-(-height // (1 << bits))) * (-(-width // (1 << bits))), np.uint32)
    _lib().omw_vp8l_predictor_forward(argb.ctypes.data, width, height, bits,
                                      residuals.ctypes.data, modes.ctypes.data)
    return residuals, modes


def predictor_forward_py(argb, width, height):
    """Choose each tile's mode (least residual cost over its interior
    pixels, the lower mode on ties) and return the residual image and the
    mode sub-image (mode in green)."""
    bits = PREDICTOR_BITS
    preds = _predictions(argb, width, height)
    img = argb.reshape(height, width).astype(np.uint32)
    res = np.stack([_sub_pixels(img.astype(np.int64), p.astype(np.int64)) for p in preds])
    cost = _residual_cost(res)  # (14, H, W)
    tiles_h, tiles_w = -(-height // (1 << bits)), -(-width // (1 << bits))
    ty = np.arange(height) >> bits
    tx = np.arange(width) >> bits
    cost[:, 0, :] = 0  # the borders' predictors are fixed
    cost[:, :, 0] = 0
    size = 1 << bits
    padded = np.zeros((14, tiles_h * size, tiles_w * size), np.int64)
    padded[:, :height, :width] = cost
    tile_cost = padded.reshape(14, tiles_h, size, tiles_w, size).sum(axis=(2, 4))
    modes = np.argmin(tile_cost, axis=0)  # lowest mode on ties
    chosen = modes[ty[:, None], tx[None, :]]
    out = np.take_along_axis(res, chosen[None], 0)[0].astype(np.uint32)
    # the borders' fixed predictors: black, left along the top, top down the left
    out[0, 0] = _sub_pixels(int(img[0, 0]), 0xFF000000)
    out[0, 1:] = res[1, 0, 1:]
    out[1:, 0] = res[2, 1:, 0]
    mode_image = (0xFF000000 | (modes.astype(np.uint32) << 8)).reshape(-1).astype(np.uint32)
    return out.reshape(-1), mode_image


def _histograms(kinds, aa, bb, xsize, cache_bits):
    lit = kinds == 0
    copy = kinds == 1
    hit = kinds == 2
    green_n = NUM_LITERAL + NUM_LENGTH_CODES + ((1 << cache_bits) if cache_bits else 0)
    px = aa[lit].astype(np.int64)
    len_sym, len_extra, len_bits = prefix_encode(aa[copy])
    dist_codes = _plane_codes(xsize, bb[copy])
    dist_sym, dist_extra, dist_bits = prefix_encode(dist_codes)
    green_syms = np.concatenate([(px >> 8) & 0xFF, NUM_LITERAL + len_sym,
                                 NUM_LITERAL + NUM_LENGTH_CODES + aa[hit].astype(np.int64)])
    hists = [np.bincount(green_syms, minlength=green_n),
             np.bincount((px >> 16) & 0xFF, minlength=256),
             np.bincount(px & 0xFF, minlength=256),
             np.bincount((px >> 24) & 0xFF, minlength=256),
             np.bincount(dist_sym, minlength=NUM_DISTANCE_CODES)]
    parts = dict(px=px, len_sym=len_sym, len_extra=len_extra, len_bits=len_bits,
                 dist_sym=dist_sym, dist_extra=dist_extra, dist_bits=dist_bits)
    return hists, parts


def _entropy_bits(hists):
    total = 0.0
    for h in hists:
        h = h[h > 0].astype(np.float64)
        if len(h) > 1:
            total += float((h * np.log2(h.sum() / h)).sum())
    return total


def _write_image_data(bw, argb, xsize, level0, cache_choices=(0,)):
    """An entropy-coded image: colour cache info, (the main image: no meta
    codes), its five prefix codes and its tokens."""
    best = None
    for cache_bits in cache_choices:
        kinds, aa, bb = backward_refs_native(argb, xsize, cache_bits)
        hists, parts = _histograms(kinds, aa, bb, xsize, cache_bits)
        cost = _entropy_bits(hists) + float(parts["len_bits"].sum() + parts["dist_bits"].sum())
        if best is None or cost < best[0]:
            best = (cost, cache_bits, kinds, aa, hists, parts)
    _, cache_bits, kinds, aa, hists, parts = best
    if cache_bits:
        bw.write(1, 1)
        bw.write(cache_bits, 4)
    else:
        bw.write(0, 1)
    if level0:
        bw.write(0, 1)  # no meta prefix codes
    codes = [write_code(bw, h) for h in hists]
    (gc, gl), (rc, rl), (bc, bl), (ac, al), (dc, dl) = codes
    n = len(kinds)
    vals = np.zeros((n, 6), np.int64)
    widths = np.zeros((n, 6), np.int64)
    lit = np.flatnonzero(kinds == 0)
    px = parts["px"]
    for col, (c, l, sym) in enumerate(((gc, gl, (px >> 8) & 0xFF), (rc, rl, (px >> 16) & 0xFF),
                                       (bc, bl, px & 0xFF), (ac, al, (px >> 24) & 0xFF))):
        vals[lit, col] = c[sym]
        widths[lit, col] = l[sym]
    cp = np.flatnonzero(kinds == 1)
    gsym = NUM_LITERAL + parts["len_sym"]
    vals[cp, 0], widths[cp, 0] = gc[gsym], gl[gsym]
    vals[cp, 1], widths[cp, 1] = parts["len_extra"], parts["len_bits"]
    vals[cp, 2], widths[cp, 2] = dc[parts["dist_sym"]], dl[parts["dist_sym"]]
    vals[cp, 3], widths[cp, 3] = parts["dist_extra"], parts["dist_bits"]
    hit = np.flatnonzero(kinds == 2)
    hsym = NUM_LITERAL + NUM_LENGTH_CODES + aa[hit].astype(np.int64)
    vals[hit, 0], widths[hit, 0] = gc[hsym], gl[hsym]
    bw.extend(vals.reshape(-1), widths.reshape(-1))


def encode(image):
    """(H, W, 3) uint8 RGB -> a VP8L bitstream (the chunk's payload)."""
    image = np.asarray(image, np.uint8)
    height, width = image.shape[:2]
    if not (1 <= width <= 16384 and 1 <= height <= 16384):
        raise ValueError(f"VP8L holds 1 to 16384 pixels a side, not {width}x{height}")
    rgb = image.astype(np.uint32)
    argb = 0xFF000000 | (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    argb = argb.reshape(-1).astype(np.uint32)
    bw = BitWriter()
    bw.write(SIGNATURE, 8)
    bw.write(width - 1, 14)
    bw.write(height - 1, 14)
    bw.write(0, 1)  # no alpha
    bw.write(0, 3)  # version
    palette = np.unique(argb)
    if len(palette) <= 256:  # colour indexing, the indices bundled into green
        xbits = 3 if len(palette) <= 2 else 2 if len(palette) <= 4 else 1 if len(
            palette) <= 16 else 0
        index = np.searchsorted(palette, argb).reshape(height, width).astype(np.uint32)
        packed_w = -(-width // (1 << xbits))
        packed = np.zeros((height, packed_w), np.uint32)
        for k in range(1 << xbits):
            part = index[:, k::1 << xbits]
            packed[:, :part.shape[1]] |= part << (k * (8 >> xbits))
        deltas = palette.copy()
        deltas[1:] = _sub_pixels(palette[1:].astype(np.int64),
                                 palette[:-1].astype(np.int64)).astype(np.uint32)
        bw.write(1, 1)
        bw.write(3, 2)
        bw.write(len(palette) - 1, 8)
        _write_image_data(bw, deltas, len(palette), False)
        bw.write(0, 1)  # no more transforms
        _write_image_data(bw, (0xFF000000 | (packed << 8)).reshape(-1).astype(np.uint32),
                          packed_w, True, cache_choices=(0, 10))
        return bw.getvalue()
    # subtract-green
    g = (argb >> 8) & 0xFF
    rb = ((argb & 0x00FF00FF) | 0x01000100) - ((g << 16) | g)
    argb = (argb & np.uint32(0xFF00FF00)) | (rb & np.uint32(0x00FF00FF))
    bw.write(1, 1)
    bw.write(2, 2)  # subtract-green
    residuals, modes = predictor_forward_native(argb, width, height)
    bw.write(1, 1)
    bw.write(0, 2)  # predictor
    bw.write(PREDICTOR_BITS - 2, 3)
    _write_image_data(bw, modes, -(-width // (1 << PREDICTOR_BITS)), False)
    bw.write(0, 1)  # no more transforms
    _write_image_data(bw, residuals, width, True, cache_choices=(0, 10))
    return bw.getvalue()
