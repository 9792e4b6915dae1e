"""Motion JPEG frames (AVI ``MJPG``, ``AVI1``), decoded as FFmpeg's
``mjpeg`` decoder decodes them for ``cv2.VideoCapture``, without cv2 or
FFmpeg.

Each packet is one JPEG.  Its markers and entropy-coded scans are read by
``data/jpeg.py`` (``parse``, with ``decode_scan_native``), into each
component's quantised coefficient blocks; a frame without a DHT segment
(AVI MJPEG often omits it) uses the standard tables of JPEG Annex K, as
FFmpeg does.  From there FFmpeg's arithmetic, not libjpeg's (so not
``jpeg.idct_islow`` and its fancy upsampling): each coefficient times its
quantiser into int16 (the DC with the 1024 offset FFmpeg's DC predictor
starts from, saturated), ``simple_idct`` (``data/mpeg4.py``), clipped to
8 bits, giving the planes of ``yuvj420p`` (luma sampled 2x2) or
``yuvj422p`` (2x1, or 2x2 with the chroma 1x2, as libavcodec's encoder
writes it) at the chroma's own size.  ``yuv.yuvj_to_rgb``
converts them as cv2 asks libswscale to.

``planes_py`` is the plain form; ``planes_native`` runs the pixel stage in
C++ (``omv_mjpeg_planes``, ``csrc/mpeg4_host.cc``), the one the reader
runs.

Refused, each by its name: progressive and lossless frames, grey (one
component) frames, sampling other than 4:2:0 and 4:2:2, frames of odd
height (libswscale converts those by another path), and interlaced MJPEG
(two fields a frame, as an AVI1 file whose frames are half the stream's
height holds them).
"""

import numpy as np

from . import jpeg
from .jpeg_encode import STD_HUFFMAN
from .mpeg4 import simple_idct

REFUSAL = "ROADMAP Queue 1 item 1, 'What the infer CLI still refuses'"
FOURCCS = {b"MJPG", b"mjpg", b"AVI1", b"avi1"}


class UnsupportedMjpeg(ValueError):
    def __init__(self, form):
        super().__init__(f"{form} is not read ({REFUSAL})")
        self.form = form


def _frame_with_default_tables():
    frame = jpeg.Frame()
    for key, table in STD_HUFFMAN.items():
        (frame.ac_tables if key >> 4 else frame.dc_tables)[key & 15] = table
    return frame


def parse(data, container_height):
    """The JPEG of one packet, parsed: a ``jpeg.Frame`` with its quantised
    coefficients, checked for the forms FFmpeg decodes to planes the reader
    converts; ``container_height`` is the AVI's frame height."""
    try:
        frame = jpeg.parse(data, jpeg.decode_scan_native, frame=_frame_with_default_tables())
    except jpeg.UnsupportedJpeg as e:
        raise UnsupportedMjpeg(f"an MJPEG frame that is {e}") from None
    if frame.progressive:
        raise UnsupportedMjpeg("a progressive MJPEG frame")
    if len(frame.components) != 3:
        raise UnsupportedMjpeg(f"a {len(frame.components)}-component (grey) MJPEG frame")
    sampling = [(c["h"], c["v"]) for c in frame.components]
    if sampling not in ([(2, 2), (1, 1), (1, 1)], [(2, 1), (1, 1), (1, 1)],
                        [(2, 2), (1, 2), (1, 2)]):
        raise UnsupportedMjpeg("MJPEG sampled " + ", ".join(f"{h}x{v}" for h, v in sampling)
                               + " (4:2:0 and 4:2:2 are read)")
    if frame.height & 1:
        raise UnsupportedMjpeg(f"an MJPEG frame of odd height ({frame.height})")
    if frame.height < container_height * 3 // 4:
        raise UnsupportedMjpeg("interlaced MJPEG (two fields a frame)")
    return frame


def _sizes(frame):
    """(height, width) of each plane: luma, then the chroma's."""
    return [(c["h_px"], c["w"]) for c in frame.components]


def planes_py(frame):
    """The (Y, U, V) planes of a parsed frame, plainly written."""
    out = []
    for comp, (ph, pw) in zip(frame.components, _sizes(frame)):
        coefs = comp["coefs"].astype(np.int64)
        q = comp["qtable"].astype(np.int64)
        blocks = ((coefs * q + 32768) & 0xFFFF) - 32768
        blocks[..., 0] = np.clip(1024 + coefs[..., 0] * q[0], -32768, 32767)
        rows, cols = coefs.shape[:2]
        pix = np.clip(simple_idct(blocks.reshape(-1, 64)), 0, 255).astype(np.uint8)
        plane = pix.reshape(rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)
        out.append(np.ascontiguousarray(plane[:ph, :pw]))
    return tuple(out)


def planes_native(frame):
    """``planes_py`` in C++ (``omv_mjpeg_planes``)."""
    from .. import kernels

    lib = kernels.host_library("mpeg4_host")
    out = []
    for comp, (ph, pw) in zip(frame.components, _sizes(frame)):
        coefs = np.ascontiguousarray(comp["coefs"])
        q = np.ascontiguousarray(comp["qtable"], np.int32)
        rows, cols = coefs.shape[:2]
        plane = np.empty((rows * 8, cols * 8), np.uint8)
        lib.omv_mjpeg_planes(coefs.ctypes.data, rows, cols, q.ctypes.data, plane.ctypes.data)
        out.append(np.ascontiguousarray(plane[:ph, :pw]))
    return tuple(out)


def decode(data, container_height):
    """The (Y, U, V) planes of one MJPEG packet (by ``planes_native``)."""
    return planes_native(parse(data, container_height))
