"""TIFF files without cv2 or PIL: what ``cv2.imread(IMREAD_COLOR)`` reads
through libtiff's RGBA interface (``TIFFReadRGBAStrip``/``Tile``), and the
LZW files ``cv2.imwrite(".tif")`` writes.

``decode`` gives, as (H, W, 3) uint8 RGB, the first page of:

* either byte order; strips or tiles; chunky or planar samples;
* compression none, PackBits, LZW (the current, MSB-first form) and Deflate
  (8 and 32946), with or without the horizontal predictor (2) at 8 and 16
  bits;
* MinIsBlack and MinIsWhite grey at 1, 8 and 16 bits, RGB at 8 and 16
  bits and palette images at 1 and 8 bits (cv2 reads no 2- or 4-bit TIFF),
  as libtiff maps them to 8 bits: grey ``x * 255 / (2**bits - 1)`` below
  16 bits and the high byte at 16 (MinIsWhite inverted), RGB samples
  ``(x + 128) / 257`` at 16 bits, a colour map's 16-bit entries by their
  high byte unless every entry is below 256;
* extra samples: an associated (or unspecified) alpha is dropped; an
  unassociated one first multiplies the colour, ``(v * a + 127) / 255``, as
  libtiff's RGBA interface premultiplies it.

Anything else raises ``UnsupportedTiff`` naming the form: JPEG-in-TIFF,
CMYK, YCbCr, floating-point or signed samples, other compressions and
photometric interpretations, an orientation other than top-left, a
BigTIFF.  ``encode`` writes an RGB image as ``cv2.imwrite`` does: LZW with
the horizontal predictor, chunky, strips of ``8192 // (3 * W)`` rows.
"""

import struct
import zlib

import numpy as np

NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 8, 32946, 32773
MIN_IS_WHITE, MIN_IS_BLACK, RGB, PALETTE = 0, 1, 2, 3
_REFUSED_COMPRESSION = {6: "a JPEG-compressed TIFF (old-style JPEG)",
                        7: "a JPEG-compressed TIFF", 2: "a CCITT-compressed TIFF",
                        3: "a CCITT-compressed TIFF", 4: "a CCITT-compressed TIFF",
                        34712: "a JPEG 2000-compressed TIFF", 34925: "an LZMA-compressed TIFF",
                        50000: "a ZSTD-compressed TIFF", 50001: "a WebP-compressed TIFF"}
_REFUSED_PHOTOMETRIC = {5: "a CMYK TIFF (separated)", 6: "a YCbCr TIFF",
                        8: "a CIELab TIFF", 4: "a transparency-mask TIFF"}
# TIFF field type -> struct code (RATIONAL and its kin read as pairs)
_TYPES = {1: "B", 2: "c", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h", 9: "i", 10: "ii",
          11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}


class UnsupportedTiff(ValueError):
    """A TIFF form this reader does not read; the message names it."""


def _ifd(data, order):
    """The first IFD's tags: {tag: tuple of values}."""
    (pos,) = struct.unpack_from(order + "I", data, 4)
    (count,) = struct.unpack_from(order + "H", data, pos)
    tags = {}
    for i in range(count):
        tag, kind, n, raw = struct.unpack_from(order + "HHI4s", data, pos + 2 + 12 * i)
        code = _TYPES.get(kind)
        if code is None:
            continue
        size = struct.calcsize(order + code) * n
        # values of 4 bytes or fewer sit in the entry itself
        body = raw if size <= 4 else data[struct.unpack(order + "I", raw)[0]:][:size]
        if len(body) < size:
            raise UnsupportedTiff("a truncated TIFF")
        tags[tag] = struct.unpack_from(order + code * n, body)
    return tags


def _one(tags, tag, default=None):
    return tags[tag][0] if tag in tags else default


def lzw_decode(data):
    """TIFF's LZW (MSB-first codes of 9-12 bits, ClearCode 256, EOI 257,
    one code of early change), written plainly: the spec of
    ``csrc/tiff_host.cc::omt_lzw_decode``, which the reader runs."""
    if data[:2] == b"\x00\x01" or (data[:1] == b"\x00" and data[1:2] and data[1] & 1):
        raise UnsupportedTiff("an old-style (LSB-first) LZW TIFF")
    bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    pos, width, prev = 0, 9, None
    while pos + width <= len(bits):
        code = 0
        for b in bits[pos:pos + width]:
            code = (code << 1) | b
        pos += width
        if code == 257:
            break
        if code == 256:
            del table[258:]
            width, prev = 9, None
            continue
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(table[prev] + entry[:1])
        elif prev is not None and code == len(table):
            entry = table[prev] + table[prev][:1]
            table.append(entry)
        else:
            raise UnsupportedTiff("a corrupt LZW TIFF")
        out += entry
        prev = code
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out)


def lzw_encode(data):
    """TIFF's LZW of ``data``: ClearCode first, a ClearCode again when the
    table is full, EOI last (libtiff's code widths), written plainly: the
    spec of ``csrc/tiff_host.cc::omt_lzw_encode``, which the writer runs."""
    codes, widths = [256], [9]
    table = {bytes([i]): i for i in range(256)}
    next_code, width = 258, 9
    current = b""
    for byte in data:
        candidate = current + bytes([byte])
        if candidate in table:
            current = candidate
            continue
        codes.append(table[current])
        widths.append(width)
        table[candidate] = next_code
        next_code += 1
        if next_code == 4094:
            codes.append(256)
            widths.append(width)
            table = {bytes([i]): i for i in range(256)}
            next_code, width = 258, 9
        elif next_code > (1 << width) - 1:
            width += 1
        current = bytes([byte])
    if current:
        codes.append(table[current])
        widths.append(width)
        next_code += 1
        if next_code > (1 << width) - 1 and width < 12:
            width += 1
    codes.append(257)
    widths.append(width)
    stream = "".join(format(c, f"0{w}b") for c, w in zip(codes, widths))
    stream += "0" * (-len(stream) % 8)
    return int(stream, 2).to_bytes(len(stream) // 8, "big")


def lzw_decode_native(data, size):
    """``lzw_decode`` in C++, its first ``size`` bytes at most.  Builds the
    library at first use; raises if it cannot."""
    from .. import kernels

    lib = kernels.host_library("tiff_host")
    src = np.frombuffer(data, np.uint8)
    out = np.empty(max(size, 1), np.uint8)
    n = lib.omt_lzw_decode(src.ctypes.data, len(src), out.ctypes.data, size)
    if n == -2:
        raise UnsupportedTiff("an old-style (LSB-first) LZW TIFF")
    if n < 0:
        raise UnsupportedTiff("a corrupt LZW TIFF")
    return out[:n].tobytes()


def lzw_encode_native(data):
    """``lzw_encode`` in C++.  Builds the library at first use; raises if it
    cannot."""
    from .. import kernels

    lib = kernels.host_library("tiff_host")
    src = np.frombuffer(data, np.uint8)
    out = np.empty(2 * len(src) + 16, np.uint8)  # 12 bits a byte at most, and the codes around
    n = lib.omt_lzw_encode(src.ctypes.data, len(src), out.ctypes.data, len(out))
    if n < 0:
        raise RuntimeError("omt_lzw_encode: output buffer too small")
    return out[:n].tobytes()


def packbits_decode(data):
    out = bytearray()
    pos = 0
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n < 128:
            out += data[pos:pos + n + 1]
            pos += n + 1
        elif n > 128:
            out += data[pos:pos + 1] * (257 - n)
            pos += 1
    return bytes(out)


def _decompress(chunk, compression, size):
    """A strip's or tile's bytes, decompressed (LZW: its first ``size``)."""
    if compression == NONE:
        return chunk
    if compression == PACKBITS:
        return packbits_decode(chunk)
    if compression == LZW:
        return lzw_decode_native(chunk, size)
    try:
        return zlib.decompress(chunk)
    except zlib.error:
        raise UnsupportedTiff("a truncated or corrupt TIFF (its Deflate stream)") from None


def _samples(raw, rows, cols, spp, bits, order, predictor):
    """One strip's or tile's bytes -> (rows, cols, spp) samples (uint8 below
    16 bits, native uint16 at 16), the predictor undone."""
    rowbytes = -(-cols * spp * bits // 8)
    need = rows * rowbytes
    if len(raw) < need:
        raise UnsupportedTiff("a truncated or corrupt TIFF (a strip or tile holds fewer bytes "
                              "than its rows)")
    buf = np.frombuffer(raw, np.uint8, need).reshape(rows, rowbytes)
    if bits == 16:
        s = buf.view(order + "u2").astype(np.uint16).reshape(rows, cols, spp)
    elif bits == 8:
        s = buf.reshape(rows, cols, spp)
    else:
        unpacked = np.unpackbits(buf, axis=1).reshape(rows, -1, bits)
        weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
        s = (unpacked * weights).sum(axis=2, dtype=np.uint8)[:, :cols * spp]
        s = s.reshape(rows, cols, spp)
    if predictor == 2:  # horizontal differencing, per sample, modulo 2**bits
        s = np.cumsum(s, axis=1, dtype=s.dtype)
    return s


def _chunks(data, tags, width, height, spp, bits, order, compression, predictor, planar):
    """Every sample of the image: (H, W, spp)."""
    out = np.zeros((height, width, spp), np.uint16 if bits == 16 else np.uint8)
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp  # samples a chunk holds per pixel
    if 322 in tags:  # tiles
        tw, th = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags[324], tags[325]
        across, down = -(-width // tw), -(-height // th)
        boxes = [(p, y * th, x * tw, th, tw) for p in range(planes) for y in range(down)
                 for x in range(across)]
    else:
        rps = min(_one(tags, 278, height), height) or height
        offsets, counts = tags[273], tags.get(279)
        n = -(-height // rps)
        boxes = [(p, i * rps, 0, min(rps, height - i * rps), width) for p in range(planes)
                 for i in range(n)]
        if counts is None:
            if len(boxes) != 1 or compression != NONE:
                raise UnsupportedTiff("a TIFF without strip byte counts")
            counts = (height * -(-width * spp * bits // 8),)
    if len(offsets) < len(boxes) or len(counts) < len(boxes):
        raise UnsupportedTiff("a truncated TIFF (fewer strips or tiles than the image needs)")
    for (p, y, x, rows, cols), off, count in zip(boxes, offsets, counts):
        raw = _decompress(data[off:off + count], compression,
                          rows * -(-cols * per * bits // 8))
        s = _samples(raw, rows, cols, per, bits, order, predictor)
        h, w = min(rows, height - y), min(cols, width - x)
        if planar == 2:
            out[y:y + h, x:x + w, p] = s[:h, :w, 0]
        else:
            out[y:y + h, x:x + w] = s[:h, :w]
    return out


def _to_rgb(samples, tags, photometric, bits, colour_samples):
    """libtiff's RGBA mapping of the samples to (H, W, 3) uint8."""
    extra = samples.shape[2] - colour_samples
    alpha_kind = tags.get(338, (0,) * extra)[0] if extra else None
    if photometric in (MIN_IS_BLACK, MIN_IS_WHITE):
        grey = samples[..., 0].astype(np.int64)
        if bits == 16:
            grey = grey >> 8
            top = 255
        else:
            top = (1 << bits) - 1
        if photometric == MIN_IS_WHITE:
            grey = top - grey
        return np.repeat((grey * 255 // top).astype(np.uint8)[..., None], 3, axis=2)
    if photometric == PALETTE:
        cmap = np.array(tags[320], np.int64).reshape(3, -1)
        if (cmap >= 256).any():
            cmap = cmap >> 8
        table = np.zeros((256, 3), np.uint8)
        n = min(cmap.shape[1], 256)
        table[:n] = cmap[:, :n].T
        return table[samples[..., 0]]
    rgb = samples[..., :3].astype(np.int64)
    if bits == 16:
        rgb = (rgb + 128) // 257
    if extra and alpha_kind == 2:  # unassociated alpha: premultiplied
        a = samples[..., 3].astype(np.int64)
        if bits == 16:
            a = (a + 128) // 257
        rgb = (rgb * a[..., None] + 127) // 255
    return rgb.astype(np.uint8)


def decode(data):
    """The first page of the TIFF file ``data`` as (H, W, 3) uint8 RGB, as
    cv2 reads it."""
    data = bytes(data)
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None:
        raise UnsupportedTiff("not a TIFF")
    (magic,) = struct.unpack_from(order + "H", data, 2)
    if magic == 43:
        raise UnsupportedTiff("a BigTIFF")
    if magic != 42:
        raise UnsupportedTiff("not a TIFF")
    try:
        tags = _ifd(data, order)
        width, height = _one(tags, 256), _one(tags, 257)
        if not width or not height:
            raise UnsupportedTiff("a TIFF without a size")
        compression = _one(tags, 259, NONE)
        photometric = _one(tags, 262)
        spp = _one(tags, 277, 1)
        bit_list = tags.get(258, (1,) * spp)
        bits = bit_list[0]
        predictor = _one(tags, 317, 1)
        planar = _one(tags, 284, 1)
        formats = set(tags.get(339, (1,)))
        if compression in _REFUSED_COMPRESSION:
            raise UnsupportedTiff(_REFUSED_COMPRESSION[compression])
        if compression not in (NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS):
            raise UnsupportedTiff(f"a TIFF of compression {compression}")
        if photometric in _REFUSED_PHOTOMETRIC:
            raise UnsupportedTiff(_REFUSED_PHOTOMETRIC[photometric])
        if formats & {3}:
            raise UnsupportedTiff("a TIFF of floating-point samples")
        if formats != {1}:
            raise UnsupportedTiff(f"a TIFF of sample format {sorted(formats)}")
        if _one(tags, 274, 1) != 1:
            raise UnsupportedTiff(f"a TIFF of orientation {_one(tags, 274)} (top-left is read)")
        if _one(tags, 266, 1) != 1:
            raise UnsupportedTiff("a TIFF of LSB-first fill order")
        colour_samples = {MIN_IS_WHITE: 1, MIN_IS_BLACK: 1, RGB: 3, PALETTE: 1}.get(photometric)
        allowed = {RGB: (8, 16), PALETTE: (1, 8)}.get(photometric, (1, 8, 16))
        if colour_samples is None:
            raise UnsupportedTiff(f"a TIFF of photometric interpretation {photometric}")
        if bits not in allowed or len(set(bit_list)) != 1:
            raise UnsupportedTiff(f"a TIFF of {photometric=} at {bit_list} bits")
        if spp < colour_samples:
            raise UnsupportedTiff(f"a TIFF of {photometric=} with {spp} samples a pixel")
        if predictor not in (1, 2) or (predictor == 2 and bits < 8):
            raise UnsupportedTiff(f"a TIFF of predictor {predictor} at {bits} bits")
        if photometric == PALETTE and 320 not in tags:
            raise UnsupportedTiff("a palette TIFF without a colour map")
        samples = _chunks(data, tags, width, height, spp, bits, order, compression, predictor,
                          planar)
    except UnsupportedTiff:
        raise
    except (struct.error, ValueError, IndexError, KeyError):
        raise UnsupportedTiff("a truncated or corrupt TIFF") from None
    return _to_rgb(samples, tags, photometric, bits, colour_samples)


def encode(image):
    """An LZW TIFF (little-endian, chunky, horizontal predictor) of (H, W, 3)
    uint8 RGB ``image``, as ``cv2.imwrite(".tif", bgr)`` lays it out: strips
    of ``max(1, min(H, 8192 // (3 * W)))`` rows."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"the TIFF writer takes (H, W, 3) uint8, got {image.dtype} {image.shape}")
    height, width = image.shape[:2]
    rps = max(1, min(height, 8192 // (3 * width)))
    diff = image.copy()
    diff[:, 1:] -= image[:, :-1]  # horizontal differencing, modulo 256
    strips = [lzw_encode_native(diff[y:y + rps].tobytes()) for y in range(0, height, rps)]
    body = bytearray(b"II*\x00\x00\x00\x00\x00")
    offsets = []
    for strip in strips:
        offsets.append(len(body))
        body += strip
        body += b"\x00" * (len(body) % 2)
    tags = [(256, 4, [width]), (257, 4, [height]), (258, 3, [8, 8, 8]), (259, 3, [LZW]),
            (262, 3, [RGB]), (273, 4, offsets), (277, 3, [3]), (278, 4, [rps]),
            (279, 4, [len(s) for s in strips]), (284, 3, [1]), (317, 3, [2]),
            (339, 3, [1, 1, 1])]
    ifd_at = len(body)
    extra_at = ifd_at + 2 + 12 * len(tags) + 4  # values longer than 4 bytes follow the IFD
    entries, extra = [], bytearray()
    for number, kind, values in tags:
        payload = struct.pack("<" + {3: "H", 4: "I"}[kind] * len(values), *values)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\x00")
        else:
            field = struct.pack("<I", extra_at + len(extra))
            extra += payload
        entries.append(struct.pack("<HHI", number, kind, len(values)) + field)
    body[4:8] = struct.pack("<I", ifd_at)
    body += struct.pack("<H", len(tags)) + b"".join(entries) + b"\x00\x00\x00\x00" + extra
    return bytes(body)
