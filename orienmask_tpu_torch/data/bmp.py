"""BMP files without cv2 or PIL, as OpenCV's ``grfmt_bmp.cpp`` reads and
writes them.

``decode`` gives, as (H, W, 3) uint8 RGB, what ``cv2.imread(IMREAD_COLOR)``
+ ``cvtColor(BGR2RGB)`` gives for:

* 1-, 4- and 8-bit palette images (an index past the palette reads black),
  uncompressed or, at 4 and 8 bits, RLE4 and RLE8 (encoded and absolute
  runs, end of line, end of bitmap and delta escapes; the pixels an escape
  skips take palette entry 0, as OpenCV fills them, and an RLE4 delta
  moves by its dx alone, as OpenCV's does);
* 16-bit images: 5-5-5 (BI_RGB, or BI_BITFIELDS with its masks) and 5-6-5
  (BI_BITFIELDS), each field shifted up to 8 bits with zeros below, as
  OpenCV's ``icvCvt_BGR5552BGR``/``BGR5652BGR`` do;
* 24-bit images, and 32-bit ones (BI_RGB or BI_BITFIELDS) whose fourth
  byte is dropped;
* bottom-up rows or top-down ones (a negative height); the Windows
  headers (40 bytes and longer) and the OS/2 core header (12 bytes, a
  palette of 3-byte entries).

Anything else raises ``UnsupportedBmp`` naming the form.  ``encode`` writes
what ``cv2.imencode(".bmp")`` writes for a colour image: a 54-byte header,
24-bit BGR rows bottom-up, each padded with zeros to 4 bytes.
"""

import struct

import numpy as np

BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


class UnsupportedBmp(ValueError):
    """A BMP form this reader does not read; the message names it."""


def _header(data):
    """(width, height, bits, compression, palette (256, 3) RGB, palette
    entries, offset of the pixels), as OpenCV's readHeader reads them."""
    if len(data) < 26:
        raise UnsupportedBmp("a truncated BMP")
    offset, size = struct.unpack_from("<II", data, 10)
    palette = np.zeros((256, 3), np.uint8)
    if size >= 36:
        width, height, planes_bits, compression = struct.unpack_from("<iiIi", data, 18)
        bits = planes_bits >> 16
        (used,) = struct.unpack_from("<i", data, 46)
        pos = 14 + size
        forms = ((bits in (1, 4, 8, 24, 32) and compression == BI_RGB)
                 or (bits in (16, 32) and compression == BI_BITFIELDS)
                 or (bits == 4 and compression == BI_RLE4)
                 or (bits == 8 and compression == BI_RLE8)
                 or (bits == 16 and compression == BI_RGB))
        if not forms:
            raise UnsupportedBmp(f"a {bits}-bit BMP of compression {compression}")
        if bits <= 8:
            if not 0 <= used <= 256:
                raise UnsupportedBmp(f"a BMP palette of {used} entries")
            n = used or 1 << bits
            entries = np.frombuffer(data, np.uint8, 4 * n, pos).reshape(n, 4)
            palette[:n] = entries[:, 2::-1]
        elif bits == 16 and compression == BI_BITFIELDS:
            masks = struct.unpack_from("<III", data, pos)  # red, green, blue
            if masks == (0x7C00, 0x3E0, 0x1F):
                bits = 15
            elif masks != (0xF800, 0x7E0, 0x1F):
                raise UnsupportedBmp("a 16-bit BMP with bit masks other than 5-5-5 and 5-6-5")
        elif bits == 16:
            bits = 15
    elif size == 12:
        width, height, planes_bits = struct.unpack_from("<HHI", data, 18)
        bits, compression = planes_bits >> 16, BI_RGB
        if bits not in (1, 4, 8, 24, 32):
            raise UnsupportedBmp(f"an OS/2 BMP of {bits} bits")
        if bits <= 8:
            n = 1 << bits
            palette[:n] = np.frombuffer(data, np.uint8, 3 * n, 26).reshape(n, 3)[:, ::-1]
    else:
        raise UnsupportedBmp(f"a BMP header of {size} bytes")
    if width <= 0 or height == 0:
        raise UnsupportedBmp(f"a BMP of size {width}x{height}")
    return width, height, bits, compression, palette, offset


def decode(data):
    """The BMP file ``data`` as (H, W, 3) uint8 RGB, as cv2 reads it."""
    data = bytes(data)
    if data[:2] != b"BM":
        raise UnsupportedBmp("not a BMP")
    try:
        width, height, bits, compression, palette, offset = _header(data)
        rows = abs(height)
        if compression in (BI_RLE4, BI_RLE8):
            out = _rle(data, offset, width, rows, palette, compression == BI_RLE4)
        else:
            out = _plain(data, offset, width, rows, bits, palette)
    except UnsupportedBmp:
        raise
    except (struct.error, ValueError, IndexError):
        raise UnsupportedBmp("a truncated or corrupt BMP") from None
    # rows were filled in file order; a positive height is bottom-up
    return np.ascontiguousarray(out[::-1] if height > 0 else out)


def _plain(data, offset, width, rows, bits, palette):
    pitch = ((width * (16 if bits == 15 else bits) + 7) // 8 + 3) & -4
    raw = np.frombuffer(data, np.uint8, pitch * rows, offset).reshape(rows, pitch)
    if bits <= 8:
        if bits == 8:
            idx = raw[:, :width]
        else:
            unpacked = np.unpackbits(raw, axis=1).reshape(rows, -1, bits)
            weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
            idx = (unpacked * weights).sum(axis=2, dtype=np.uint8)[:, :width]
        return palette[idx]
    if bits in (15, 16):
        t = raw[:, :2 * width].copy().view("<u2").astype(np.int64)
        blue = (t << 3) & 0xFF
        if bits == 15:
            green, red = (t >> 2) & 0xF8, (t >> 7) & 0xF8
        else:
            green, red = (t >> 3) & 0xFC, (t >> 8) & 0xF8
        return np.stack([red, green, blue], axis=-1).astype(np.uint8)
    n = bits // 8
    return raw[:, :n * width].reshape(rows, width, n)[:, :, 2::-1].copy()


def _rle(data, pos, width, rows, palette, four):
    """OpenCV's RLE4/RLE8 loops: a cursor (x, y) in file order; the
    escape that ends a line, the bitmap or skips ahead fills what it skips
    with palette entry 0."""
    out = np.zeros((rows, width, 3), np.uint8)
    x = y = 0
    line_end_flag = False  # RLE8: the last run wrapped onto a new line

    def fill(count, colour):
        """FillUniColor: ``count`` pixels of one colour, wrapping lines."""
        nonlocal x, y
        while True:
            n = min(count, width - x)
            out[y, x:x + n] = colour
            x += n
            count -= n
            if x >= width:
                x = 0
                y += 1
                if y >= rows:
                    return
            if count <= 0:
                return

    while True:
        length, code = data[pos], data[pos + 1]
        pos += 2
        if length:  # encoded run
            if x + length > width:
                return out  # OpenCV stops at a run past the line
            if four:
                pair = palette[[code >> 4, code & 15]]
                out[y, x:x + length] = pair[np.arange(length) & 1]
                x += length
            else:
                prev = y
                fill(length, palette[code])
                line_end_flag = y != prev
                if y >= rows:
                    return out
        elif code > 2:  # absolute run, padded to 16 bits
            if x + code > width:
                return out
            n = (((code + 1) >> 1) + 1) & ~1 if four else (code + 1) & ~1
            raw = np.frombuffer(data, np.uint8, n, pos)
            pos += n
            idx = np.stack([raw >> 4, raw & 15], 1).reshape(-1) if four else raw
            out[y, x:x + code] = palette[idx[:code]]
            x += code
            line_end_flag = False
        else:  # 0: end of line, 1: end of bitmap, 2: delta
            skip = width - x
            if code == 2:  # OpenCV's RLE4 delta moves by its dx alone
                skip = data[pos] + (0 if four else data[pos + 1] * width)
                pos += 2
            elif code == 1:
                skip += (rows - y) * width
            if four or code or not line_end_flag or skip < width:
                if y >= rows:
                    return out
                fill(skip, palette[0])
            line_end_flag = False
            if y >= rows:
                return out


def encode(image):
    """The bytes ``cv2.imencode(".bmp", bgr)`` gives for (H, W, 3) uint8 RGB
    ``image``: 24 bits, bottom-up, rows padded to 4 bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"the BMP writer takes (H, W, 3) uint8, got {image.dtype} {image.shape}")
    height, width = image.shape[:2]
    pitch = (width * 3 + 3) & -4
    rows = np.zeros((height, pitch), np.uint8)
    rows[:, :width * 3] = image[::-1, :, ::-1].reshape(height, -1)
    header = struct.pack("<2sIHHIIiiHHIIiiII", b"BM", 54 + rows.size, 0, 0, 54, 40, width,
                         height, 1, 24, 0, 0, 0, 0, 0, 0)
    return header + rows.tobytes()
