"""Image files without cv2 or PIL: the port's replacement for the JAX CLI's
and datasets' ``cv2.imread`` + ``cvtColor`` and ``cv2.imwrite``
(``infer.py``, ``data/dataset.py``), and the CLI's video source
(``video_source``).

Reads, as (H, W, 3) uint8 RGB, what ``cv2.imread(IMREAD_COLOR)`` gives:

* PNG of every colour type and bit depth: grey at 1, 2, 4, 8 and 16 bits
  (1-4 bits scaled to 8 as libpng expands them), palette at 1-8 bits, RGB,
  grey and alpha, and RGBA at 8 and 16 bits (16 bits reduced to their high
  byte, as libpng's ``png_set_strip_16`` reduces them), interlaced (Adam7)
  or not, every filter type; alpha and ``tRNS`` dropped, grey replicated;
  decoded with ``zlib``;
* JPEG, through ``data/jpeg.py`` (baseline, extended and progressive
  Huffman, 8-bit, 1 or 3 components, EXIF orientation applied);
* BMP, through ``data/bmp.py`` (1-, 4- and 8-bit palette images, RLE4 and
  RLE8, 16-bit 5-5-5 and 5-6-5, 24 and 32 bits, either row order, OS/2
  core headers);
* TIFF, through ``data/tiff.py`` (the first page: strips or tiles, chunky
  or planar, uncompressed, PackBits, LZW or Deflate, the horizontal
  predictor, grey, RGB and palette images at 1-16 bits, alpha dropped as
  libtiff drops it);
* WebP, through ``data/webp.py`` (lossy VP8 with libwebp's fancy
  upsampling, lossless VP8L, the extended form: alpha dropped, EXIF
  orientation applied, an animation's first frame);
* binary PPM (P6, maxval 255);
* ``.npy`` arrays of shape (H, W, 3) and dtype uint8.

Anything else (a video file, which ``cv2.imread`` does not read either, the
JPEG, BMP, TIFF and WebP forms those modules refuse) is refused with
``UnsupportedImage``, whose message names the form and what is read.
Nothing tries another decoder.

``write_image`` writes (H, W, 3) uint8 RGB arrays as ``cv2.imwrite``
writes them, the format chosen by the extension: JPEG (``data/
jpeg_encode.py``, cv2's bytes at quality 95), PNG (``write_png``), BMP
(cv2's bytes), TIFF (LZW, as cv2 writes it), WebP (lossless VP8L, as cv2
writes it with no quality given; ``data/vp8l.py``'s own encoding, which
cv2 reads back to the pixels written) or PPM (P6).  A video source
(``video_source``) is a directory of readable files, sorted
(``frame_paths``), or a video file (``data/video.py``: MPEG-4 Part 2 in
MP4 or AVI).  Directories are filtered by ``IMAGE_EXTENSIONS``.
"""

import itertools
import os
import struct
import zlib

import numpy as np

from . import bmp, jpeg_encode, tiff, webp
from .jpeg import UnsupportedJpeg
from .jpeg import decode as decode_jpeg
from .video import VideoReader

READABLE = ("PNG (every colour type and bit depth, interlaced or not), JPEG (baseline, "
            "extended or progressive Huffman, 8-bit, 1 or 3 components), BMP (palette, RLE4, "
            "RLE8, 16, 24 and 32 bits), TIFF (uncompressed, PackBits, LZW or Deflate; grey, "
            f"RGB or palette), {webp.FORMS}, binary PPM (P6) and .npy (H, W, 3) uint8")
# What a directory of images or frames is filtered to: the JAX CLI's image
# extensions and the port's own.
IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp", ".ppm", ".npy")
# write_image: extension -> encoder of (H, W, 3) uint8 RGB to bytes, as
# cv2.imwrite chooses it
WRITERS = {".jpg": jpeg_encode.encode, ".jpeg": jpeg_encode.encode, ".bmp": bmp.encode,
           ".tif": tiff.encode, ".tiff": tiff.encode, ".webp": webp.encode}
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
# files read_image refuses by name, by their first bytes (video files: -i
# takes images, as cv2.imread does)
_REFUSED_MAGIC = ((b"ftyp", 4, "a video file"), (b"AVI ", 8, "a video file"))


class UnsupportedImage(ValueError):
    def __init__(self, path, why):
        super().__init__(f"cannot read {path}: {why}; this build reads {READABLE} only "
                         "(ROADMAP Queue 1 item 1, 'What the infer CLI still refuses')")


def read_image(path):
    """The file at ``path`` as an (H, W, 3) uint8 RGB array."""
    path = str(path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return _read_npy(path)
    with open(path, "rb") as fh:
        data = fh.read()
    if data.startswith(_PNG_SIGNATURE):
        return _read_png(path, data)
    if data[:2] == b"P6":
        return _read_ppm(path, data)
    if data[:3] == b"\xff\xd8\xff":
        try:
            return decode_jpeg(data)
        except UnsupportedJpeg as e:
            raise UnsupportedImage(path, str(e)) from None
    if data[:2] == b"BM":
        try:
            return bmp.decode(data)
        except bmp.UnsupportedBmp as e:
            raise UnsupportedImage(path, str(e)) from None
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        try:
            return tiff.decode(data)
        except tiff.UnsupportedTiff as e:
            raise UnsupportedImage(path, str(e)) from None
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        try:
            return webp.decode(data)
        except webp.UnsupportedWebP as e:
            raise UnsupportedImage(path, str(e)) from None
    for magic, at, what in _REFUSED_MAGIC:
        if data[at:at + len(magic)] == magic:
            raise UnsupportedImage(path, what)
    raise UnsupportedImage(path, "not an image file this build reads")


def image_names(directory):
    """The names of ``directory``'s image files (by extension), sorted."""
    return sorted(n for n in os.listdir(directory)
                  if n.lower().endswith(IMAGE_EXTENSIONS)
                  and os.path.isfile(os.path.join(directory, n)))


def frame_paths(directory, limit=None):
    """The image files of ``directory``, sorted, the first ``limit`` of
    them: a frame directory's frames."""
    return [os.path.join(directory, n) for n in image_names(directory)[:limit]]


def video_source(source, limit=None):
    """(frames, rate): the CLI's --video source as (H, W, 3) uint8 RGB
    frames, the first ``limit`` of them, and the rate a video of its
    drawings is written at.  A directory gives its image files at 25.0; a
    file, its ``VideoReader``'s frames (the reader refuses a file it cannot
    read, naming the form) at the file's own rate, or 25.0 where it has
    none (the JAX CLI's ``CAP_PROP_FPS`` rule)."""
    if os.path.isdir(source):
        return (read_image(p) for p in frame_paths(source, limit)), 25.0
    reader = VideoReader(source)
    fps = reader.fps if reader.fps > 0 and np.isfinite(reader.fps) else 25.0
    return itertools.islice(iter(reader), limit), fps


def _read_npy(path):
    image = np.load(path, allow_pickle=False)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise UnsupportedImage(path, f"a {image.dtype} array of shape {image.shape}")
    return np.ascontiguousarray(image)


def _read_ppm(path, data):
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # a comment runs to the end of its line
            pos = data.index(b"\n", pos)
            continue
        end = pos
        while end < len(data) and data[end:end + 1].isdigit():
            end += 1
        if end == pos:
            raise UnsupportedImage(path, "a malformed PPM header")
        fields.append(int(data[pos:end]))
        pos = end
    width, height, maxval = fields
    if maxval != 255:
        raise UnsupportedImage(path, f"a PPM with maxval {maxval}")
    pixels = np.frombuffer(data, np.uint8, height * width * 3, pos + 1)
    return pixels.reshape(height, width, 3).copy()


def _png_chunks(path, data):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return
    raise UnsupportedImage(path, "a truncated PNG")


def _read_png(path, data):
    header, idat, palette = None, [], None
    for kind, body in _png_chunks(path, data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise UnsupportedImage(path, "a PNG without a header")
    width, height, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in _DEPTHS[colour]:
        raise UnsupportedImage(path, f"a PNG of colour type {colour} at {depth} bits")
    if interlace > 1:
        raise UnsupportedImage(path, f"a PNG of interlace method {interlace}")
    if colour == 3 and palette is None:
        raise UnsupportedImage(path, "a palette PNG without a palette")
    channels = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    samples = np.zeros((height, width, channels), np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no bytes, not even filter types
        rowbytes = -(-pw * channels * depth // 8)
        rows = raw[pos:pos + ph * (rowbytes + 1)]
        if rows.size != ph * (rowbytes + 1):
            raise UnsupportedImage(path, "a truncated PNG")
        rows = rows.reshape(ph, rowbytes + 1)
        pos += rows.size
        bpp = max(1, channels * depth // 8)
        samples[y0::dy, x0::dx] = _samples(_unfilter(rows[:, 1:], rows[:, 0], bpp),
                                           pw, channels, depth)
    if colour == 3:  # palette: indices past its end read black, as libpng's
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[samples[..., 0]]
    if depth < 8:  # png_set_expand_gray_1_2_4_to_8
        samples = samples * np.uint8(255 // (2 ** depth - 1))
    if channels <= 2:  # grey, with or without alpha
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _samples(raw, width, channels, depth):
    """Unfiltered rows -> (rows, width, channels) uint8 samples: 16-bit ones
    reduced to their high byte, 1-4-bit ones unpacked (MSB first) unscaled."""
    if depth == 16:
        return raw.reshape(len(raw), -1, 2)[:, :width * channels, 0].reshape(
            len(raw), width, channels)
    if depth == 8:
        return raw[:, :width * channels].reshape(len(raw), width, channels)
    bits = np.unpackbits(raw, axis=1).reshape(len(raw), -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :width, None]


def _unfilter(filtered, kinds, bpp):
    """Undo PNG's per-row filters: (H, W*bpp) filtered bytes -> raw bytes."""
    out = np.empty_like(filtered)
    prev = np.zeros(filtered.shape[1], np.uint8)
    for y, kind in enumerate(kinds):
        line = filtered[y]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum, per channel, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):  # Average, Paeth: sequential along the row
            cur = _unfilter_sequential(line, prev, bpp, kind)
        else:
            raise ValueError(f"PNG filter type {kind} is not one of 0-4")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_sequential(line, prev, bpp, kind):
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def png_bytes(image):
    """An 8-bit RGB PNG of (H, W, 3) uint8 ``image`` (filter type 0 on every
    row, fast zlib compression)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"the PNG writer takes (H, W, 3) uint8, got {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    body = np.concatenate([np.zeros((height, 1), np.uint8), image.reshape(height, -1)], axis=1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (_PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(body.tobytes(), 1)) + chunk(b"IEND", b""))


def write_png(path, image):
    """Write (H, W, 3) uint8 RGB ``image`` as ``png_bytes`` encodes it."""
    data = png_bytes(image)
    with open(path, "wb") as fh:
        fh.write(data)

def encode_image(ext, image):
    """The bytes ``cv2.imwrite`` writes for (H, W, 3) uint8 RGB ``image``
    under extension ``ext`` (one of ``WRITERS`` or ``.png``, ``.ppm``)."""
    ext = ext.lower()
    if ext in WRITERS:
        return WRITERS[ext](image)
    if ext == ".png":
        return png_bytes(image)
    if ext == ".ppm":
        height, width = image.shape[:2]
        return b"P6\n%d %d\n255\n" % (width, height) + np.ascontiguousarray(image).tobytes()
    raise ValueError(f"cannot write {ext!r} files: the writers are "
                     f"{sorted([*WRITERS, '.png', '.ppm'])}")


def write_image(path, image):
    """Write (H, W, 3) uint8 RGB ``image`` to ``path`` in the format its
    extension names, as ``cv2.imwrite`` chooses it; any other extension
    raises, naming it."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_image takes (H, W, 3) uint8, got {image.dtype} {image.shape}")
    data = encode_image(os.path.splitext(str(path))[1], image)
    with open(path, "wb") as fh:
        fh.write(data)
