"""WebP files as ``cv2.imread`` reads them (OpenCV 5 with libwebp), without
cv2, PIL or libwebp: the RIFF container, written from Google's "WebP
Container Specification" (RFC 9649).

``decode`` reads a simple file (one ``VP8 `` or ``VP8L`` chunk) or an
extended one (``VP8X``): its ``ALPH`` chunk is ignored for colour (cv2's
3-channel read drops alpha and does not premultiply), ``ICCP`` and
``XMP `` are skipped, the ``EXIF`` orientation is applied (``jpeg.orient``;
the payload is read as a TIFF header, as OpenCV reads it),
and an animation (``ANIM``/``ANMF``) reads as its first frame placed on a
canvas of zeros at its offset.  The bitstreams are ``vp8.py`` (lossy) and
``vp8l.py`` (lossless).  ``encode`` writes a simple lossless file, as
``cv2.imwrite`` writes a ``.webp`` name with no quality given.
"""

import struct

import numpy as np

from . import vp8, vp8l
from .jpeg import orient, read_orientation
from .vp8l import UnsupportedWebP

__all__ = ["UnsupportedWebP", "decode", "encode", "info"]

# the forms of the container read, for image_io.READABLE
FORMS = "WebP (lossy VP8, lossless VP8L, extended with alpha, EXIF or animation)"


def _chunks(data, start, end):
    """(fourcc, payload, offset) of each chunk in ``data[start:end]``."""
    pos = start
    while pos < end:
        if pos + 8 > end:
            raise UnsupportedWebP("a truncated WebP chunk header")
        fourcc, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        if pos + 8 + size > end:
            raise UnsupportedWebP(f"a truncated WebP file (its {fourcc.decode('latin-1')!r} "
                                  "chunk runs past the end)")
        yield fourcc, data[pos + 8:pos + 8 + size], pos
        pos += 8 + size + (size & 1)


def _riff(data):
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise UnsupportedWebP("not a RIFF WEBP file")
    size = struct.unpack_from("<I", data, 4)[0]
    if size < 4 or 8 + size > len(data):
        raise UnsupportedWebP("a truncated WebP file (its RIFF size runs past the end)")
    return 8 + size


def _bitstream(fourcc, payload):
    """A ``VP8 `` or ``VP8L`` chunk -> (H, W, 3) uint8 RGB."""
    if fourcc == b"VP8L":
        return vp8l.argb_to_rgb(vp8l.decode(payload))
    if fourcc == b"VP8 ":
        return vp8.decode_rgb(payload)
    raise UnsupportedWebP(f"a WebP image chunk {fourcc!r}")


def info(data):
    """The file's form: {'kind': 'VP8'|'VP8L'|'VP8X', 'animated', 'alpha',
    'exif', 'width', 'height'} (what the tests and fixtures check)."""
    end = _riff(data)
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise UnsupportedWebP("a WebP file without chunks")
    first = chunks[0][0]
    out = {"kind": first.decode("latin-1").strip(), "animated": False, "alpha": False,
           "exif": False}
    if first == b"VP8X":
        flags = chunks[0][1][0]
        out.update(animated=bool(flags & 2), alpha=bool(flags & 16), exif=bool(flags & 8))
    return out


def decode(data):
    """A WebP file's bytes -> (H, W, 3) uint8 RGB, as cv2.imread gives it."""
    end = _riff(data)
    chunks = list(_chunks(data, 12, end))
    if not chunks:
        raise UnsupportedWebP("a WebP file without chunks")
    fourcc, payload, _ = chunks[0]
    if fourcc in (b"VP8 ", b"VP8L"):
        return _bitstream(fourcc, payload)
    if fourcc != b"VP8X":
        raise UnsupportedWebP(f"a WebP file starting with a {fourcc!r} chunk")
    if len(payload) < 10:
        raise UnsupportedWebP("a truncated VP8X chunk")
    flags = payload[0]
    canvas_w = int.from_bytes(payload[4:7], "little") + 1
    canvas_h = int.from_bytes(payload[7:10], "little") + 1
    image, orientation = None, 1
    for fourcc, body, _ in chunks[1:]:
        if fourcc == b"EXIF":
            # the payload is the TIFF header itself; one that starts with
            # JPEG's "Exif\0\0" is not read, as OpenCV does not read it
            orientation = read_orientation(b"Exif\x00\x00" + body)
        elif image is not None:
            continue
        elif fourcc in (b"VP8 ", b"VP8L") and not flags & 2:
            image = _bitstream(fourcc, body)
            if image.shape[:2] != (canvas_h, canvas_w):
                raise UnsupportedWebP("a WebP image of another size than its canvas")
        elif fourcc == b"ANMF" and flags & 2:
            image = _first_frame(body, canvas_w, canvas_h)
    if image is None:
        raise UnsupportedWebP("an extended WebP file without an image")
    return orient(image, orientation)


def _first_frame(body, canvas_w, canvas_h):
    """An animation's first frame on a zero canvas at its offset."""
    if len(body) < 16:
        raise UnsupportedWebP("a truncated ANMF chunk")
    x = 2 * int.from_bytes(body[0:3], "little")
    y = 2 * int.from_bytes(body[3:6], "little")
    w = int.from_bytes(body[6:9], "little") + 1
    h = int.from_bytes(body[9:12], "little") + 1
    if x + w > canvas_w or y + h > canvas_h:
        raise UnsupportedWebP("an animation frame outside its canvas")
    for fourcc, payload, _ in _chunks(body, 16, len(body)):
        if fourcc in (b"VP8 ", b"VP8L"):
            frame = _bitstream(fourcc, payload)
            if frame.shape[:2] != (h, w):
                raise UnsupportedWebP("an animation frame of another size than its header")
            canvas = np.zeros((canvas_h, canvas_w, 3), np.uint8)
            canvas[y:y + h, x:x + w] = frame
            return canvas
    raise UnsupportedWebP("an animation frame without an image")


def encode(image):
    """(H, W, 3) uint8 RGB -> a simple lossless WebP file (``vp8l.encode``)."""
    payload = vp8l.encode(image)
    chunk = b"VP8L" + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk
