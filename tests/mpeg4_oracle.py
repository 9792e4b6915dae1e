"""libavcodec and libswscale through ctypes, for the video tests and the
fixture maker (never the port): the libraries bundled with the
opencv-python wheel (``opencv_python.libs``), the very ones behind
``cv2.VideoCapture`` and ``cv2.VideoWriter`` here.

``decode`` gives each frame's Y, U and V planes before the colour
conversion, from the ``mpeg4`` or the ``mjpeg`` decoder, with a codec tag
as a demuxer sets it (``avcodec_send_packet`` / ``avcodec_receive_frame``;
AVFrame's ``data`` and ``linesize`` are its first fields, its width and
height follow ``extended_data``).  ``encode`` makes MPEG-4 Part 2 streams
with settings cv2 cannot choose, set with ``av_opt_set`` on the codec
context (``flags`` ``+mv4``, ``+qpel``, ``+ildct``; ``ps`` for resync
markers; ``qmin`` and ``qmax`` for a fixed quantiser; ``bf``;
``mpeg_quant``; ``data_partitioning``), and MJPEG at ``yuvj420p`` or
``yuvj422p``.  ``bgr_to_yuv420`` and ``yuv420_to_bgr`` are libswscale's
conversions as cv2's writer and reader ask for them (``SWS_BICUBIC``, the
same size; ``yuvj`` formats too)."""

import ctypes
import glob
import os

import cv2
import numpy as np

LIBS = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)), "opencv_python.libs")
_P = ctypes.c_void_p
_LIBS = {}
AV_PIX_FMT_YUV420P, AV_PIX_FMT_BGR24, SWS_BICUBIC = 0, 3, 4
# AVPacket: pts at 8, data at 24, size at 32; AVFrame: data[8] at 0,
# linesize[8] at 64, width and height at 104, format at 116, pts at 136
PACKET_PTS, PACKET_DATA, PACKET_SIZE = 8, 24, 32
FRAME_LINESIZE, FRAME_SIZE, FRAME_FORMAT, FRAME_PTS = 64, 104, 116, 136
CONTEXT_CODEC_TAG = 28  # AVCodecContext.codec_tag
CONTEXT_EXTRADATA = 72  # AVCodecContext.extradata, extradata_size after it
CONTEXT_HAS_B_FRAMES = 172  # AVCodecContext.has_b_frames (after refs)
AV_PIX_FMT_YUV422P, AV_PIX_FMT_YUVJ420P, AV_PIX_FMT_YUVJ422P = 4, 12, 13
PLANAR_422 = (AV_PIX_FMT_YUV422P, AV_PIX_FMT_YUVJ422P)
_PIX_NAMES = {AV_PIX_FMT_YUV420P: "yuv420p", AV_PIX_FMT_YUVJ420P: "yuvj420p",
              AV_PIX_FMT_YUVJ422P: "yuvj422p"}


def _lib(stem):
    if stem not in _LIBS:
        path = glob.glob(os.path.join(LIBS, stem + "-*.so*"))[0]
        _LIBS[stem] = ctypes.CDLL(path, mode=ctypes.RTLD_GLOBAL)
    return _LIBS[stem]


def _avutil():
    lib = _lib("libavutil")
    for name, res, args in (("av_frame_alloc", _P, []), ("av_frame_free", None, [_P]),
                            ("av_mallocz", _P, [ctypes.c_size_t]),
                            ("av_frame_get_buffer", ctypes.c_int, [_P, ctypes.c_int]),
                            ("av_opt_set", ctypes.c_int, [_P, ctypes.c_char_p, ctypes.c_char_p,
                                                          ctypes.c_int])):
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = args
    return lib


def _avcodec():
    _avutil()
    lib = _lib("libavcodec")
    for name, res, args in (
            ("avcodec_find_decoder_by_name", _P, [ctypes.c_char_p]),
            ("avcodec_find_encoder_by_name", _P, [ctypes.c_char_p]),
            ("avcodec_alloc_context3", _P, [_P]),
            ("avcodec_open2", ctypes.c_int, [_P, _P, _P]),
            ("avcodec_send_packet", ctypes.c_int, [_P, _P]),
            ("avcodec_receive_frame", ctypes.c_int, [_P, _P]),
            ("avcodec_send_frame", ctypes.c_int, [_P, _P]),
            ("avcodec_receive_packet", ctypes.c_int, [_P, _P]),
            ("avcodec_free_context", None, [_P]),
            ("av_packet_alloc", _P, []), ("av_packet_free", None, [_P]),
            ("av_packet_unref", None, [_P]),
            ("av_new_packet", ctypes.c_int, [_P, ctypes.c_int])):
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = args
    return lib


def _ints(address, n):
    return list((ctypes.c_int * n).from_address(address))


def decode(packets, extradata=b"", codec_tag=b"", codec=b"mpeg4", formats=None, delay=0,
           sources=None):
    """libavcodec's ``mpeg4`` (or ``codec``) decoder on ``packets``
    (``extradata``, a container's VOL, leads the first; for ``h264`` it is
    the codec context's extradata, an ``avcC`` record or Annex B parameter
    sets, as FFmpeg's demuxers set it; ``codec_tag`` the container's fourcc):
    each frame's (Y, U, V) planes, the chroma planes at the frame's chroma
    size.  ``formats``, a list, receives each frame's pixel format;
    ``delay`` is the context's ``has_b_frames`` at its opening (the
    ``video_delay`` a demuxer's probe hands the decoder); ``sources``, a
    list, receives the index of the packet each frame came from (its pts,
    set to the packet's index)."""
    avcodec, avutil = _avcodec(), _avutil()
    decoder = avcodec.avcodec_find_decoder_by_name(codec)
    ctx = avcodec.avcodec_alloc_context3(decoder)
    if codec_tag:
        ctypes.c_uint32.from_address(ctx + CONTEXT_CODEC_TAG).value = int.from_bytes(
            codec_tag, "little")
    if codec == b"h264" and extradata:
        buf = avutil.av_mallocz(len(extradata) + 64)
        ctypes.memmove(buf, bytes(extradata), len(extradata))
        _P.from_address(ctx + CONTEXT_EXTRADATA).value = buf
        ctypes.c_int.from_address(ctx + CONTEXT_EXTRADATA + 8).value = len(extradata)
        extradata = b""
    if delay:
        ctypes.c_int.from_address(ctx + CONTEXT_HAS_B_FRAMES).value = delay
    codec = decoder
    if avcodec.avcodec_open2(ctx, codec, None) != 0:
        raise RuntimeError("avcodec_open2 failed")
    pkt, frame = avcodec.av_packet_alloc(), avutil.av_frame_alloc()
    out = []

    def drain():
        while avcodec.avcodec_receive_frame(ctx, frame) == 0:
            data = (_P * 3).from_address(frame)
            linesize = _ints(frame + FRAME_LINESIZE, 3)
            w, h = _ints(frame + FRAME_SIZE, 2)
            fmt = _ints(frame + FRAME_FORMAT, 1)[0]
            if formats is not None:
                formats.append(fmt)
            if sources is not None:
                sources.append(ctypes.c_int64.from_address(frame + FRAME_PTS).value)
            cw, ch = (w + 1) // 2, (h + 1) // 2 if fmt not in PLANAR_422 else h
            planes = []
            for i, (pw, ph) in enumerate(((w, h), (cw, ch), (cw, ch))):
                buf = (ctypes.c_uint8 * (linesize[i] * ph)).from_address(data[i])
                planes.append(np.frombuffer(buf, np.uint8).reshape(ph, linesize[i])[:, :pw].copy())
            out.append(tuple(planes))

    for i, packet in enumerate(packets):
        packet = (extradata if i == 0 else b"") + bytes(packet)
        if avcodec.av_new_packet(pkt, len(packet)) != 0:
            raise MemoryError("av_new_packet")
        ctypes.memmove(_P.from_address(pkt + PACKET_DATA).value, packet, len(packet))
        ctypes.c_int64.from_address(pkt + PACKET_PTS).value = i
        avcodec.avcodec_send_packet(ctx, pkt)
        avcodec.av_packet_unref(pkt)
        drain()
    avcodec.avcodec_send_packet(ctx, None)
    drain()
    ctx_ref = _P(ctx)
    avcodec.avcodec_free_context(ctypes.byref(ctx_ref))
    return out


def encode(frames, width, height, rate=(25, 1), codec=b"mpeg4", pix_fmt=AV_PIX_FMT_YUV420P,
           **options):
    """libavcodec's ``mpeg4`` (or ``codec``) encoder on (Y, U, V)
    ``frames`` of ``pix_fmt`` at ``rate`` (frames a second, as a fraction):
    one packet a frame, the VOL in the first (no global header).
    ``options`` are ``av_opt_set`` names and values; for ``mpeg4`` an
    I-VOP every 12 frames and no B-VOPs unless they say so."""
    avcodec, avutil = _avcodec(), _avutil()
    codec = avcodec.avcodec_find_encoder_by_name(codec)
    ctx = avcodec.avcodec_alloc_context3(codec)
    settings = {"video_size": f"{width}x{height}", "pixel_format": _PIX_NAMES[pix_fmt],
                "time_base": f"{rate[1]}/{rate[0]}"}
    if pix_fmt == AV_PIX_FMT_YUV420P:
        settings.update(g="12", bf="0")
    settings.update({k: str(v) for k, v in options.items()})
    for key, value in settings.items():
        if avutil.av_opt_set(ctx, key.encode(), value.encode(), 1) != 0:
            raise ValueError(f"libavcodec refuses {key}={value}")
    if avcodec.avcodec_open2(ctx, codec, None) != 0:
        raise RuntimeError(f"avcodec_open2 refuses {settings}")
    pkt = avcodec.av_packet_alloc()
    packets = []

    def drain():
        while avcodec.avcodec_receive_packet(ctx, pkt) == 0:
            size = ctypes.c_int.from_address(pkt + PACKET_SIZE).value
            packets.append(ctypes.string_at(_P.from_address(pkt + PACKET_DATA).value, size))
            avcodec.av_packet_unref(pkt)

    for planes in frames:
        frame = avutil.av_frame_alloc()
        (ctypes.c_int * 2).from_address(frame + FRAME_SIZE)[:] = [width, height]
        ctypes.c_int.from_address(frame + FRAME_FORMAT).value = pix_fmt
        if avutil.av_frame_get_buffer(frame, 0) != 0:
            raise MemoryError("av_frame_get_buffer")
        data = (_P * 3).from_address(frame)
        linesize = _ints(frame + FRAME_LINESIZE, 3)
        for i, plane in enumerate(planes):
            plane = np.ascontiguousarray(plane, np.uint8)
            for row in range(plane.shape[0]):
                ctypes.memmove(data[i] + row * linesize[i], plane[row].ctypes.data,
                               plane.shape[1])
        if avcodec.avcodec_send_frame(ctx, frame) != 0:
            raise RuntimeError("avcodec_send_frame")
        drain()
        frame_ref = _P(frame)
        avutil.av_frame_free(ctypes.byref(frame_ref))
    avcodec.avcodec_send_frame(ctx, None)
    drain()
    ctx_ref = _P(ctx)
    avcodec.avcodec_free_context(ctypes.byref(ctx_ref))
    return packets


def bgr_to_yuv420(bgr, pix_fmt=AV_PIX_FMT_YUV420P):
    """libswscale's BGR24 -> YUV420P (or ``pix_fmt``) at the same size with
    ``SWS_BICUBIC``, as cv2's writer converts its frames: (Y, U, V)."""
    sws = _lib("libswscale")
    sws.sws_getContext.restype = _P
    sws.sws_getContext.argtypes = [ctypes.c_int] * 7 + [_P, _P, _P]
    sws.sws_scale.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P]
    sws.sws_freeContext.argtypes = [_P]
    bgr = np.ascontiguousarray(bgr, np.uint8)
    h, w = bgr.shape[:2]
    ctx = sws.sws_getContext(w, h, AV_PIX_FMT_BGR24, w, h, pix_fmt, SWS_BICUBIC,
                             None, None, None)
    ch = h if pix_fmt in PLANAR_422 else h // 2
    planes = [np.zeros((h, w + 64), np.uint8), np.zeros((ch, w // 2 + 64), np.uint8),
              np.zeros((ch, w // 2 + 64), np.uint8)]
    src = (_P * 4)(bgr.ctypes.data, None, None, None)
    src_stride = (ctypes.c_int * 4)(3 * w, 0, 0, 0)
    dst = (_P * 4)(*[p.ctypes.data for p in planes], None)
    dst_stride = (ctypes.c_int * 4)(*[p.shape[1] for p in planes], 0)
    sws.sws_scale(ctx, src, src_stride, 0, h, dst, dst_stride)
    sws.sws_freeContext(ctx)
    return planes[0][:, :w], planes[1][:, :w // 2], planes[2][:, :w // 2]


def cv2_packets(path):
    """The raw packets cv2 hands out with ``CAP_PROP_FORMAT`` -1."""
    cap = cv2.VideoCapture(str(path))
    cap.set(cv2.CAP_PROP_FORMAT, -1)
    out = []
    while True:
        ok, packet = cap.read()
        if not ok:
            break
        out.append(packet.tobytes())
    cap.release()
    return out


def cv2_frames(path):
    """cv2's frames of ``path`` as RGB, with its CAP_PROP_FPS and
    CAP_PROP_FRAME_COUNT."""
    cap = cv2.VideoCapture(str(path))
    fps, count = cap.get(cv2.CAP_PROP_FPS), cap.get(cv2.CAP_PROP_FRAME_COUNT)
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    return out, fps, count


def yuv420_to_bgr(y, u, v, pix_fmt=AV_PIX_FMT_YUV420P):
    """libswscale's YUV420P (or ``pix_fmt``: ``yuvj420p``, ``yuvj422p``)
    -> BGR24 at the same size with ``SWS_BICUBIC``, as cv2's reader
    converts its frames."""
    sws = _lib("libswscale")
    sws.sws_getContext.restype = _P
    sws.sws_getContext.argtypes = [ctypes.c_int] * 7 + [_P, _P, _P]
    sws.sws_scale.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P]
    sws.sws_freeContext.argtypes = [_P]
    h, w = y.shape
    planes = [np.ascontiguousarray(p, np.uint8) for p in (y, u, v)]
    ctx = sws.sws_getContext(w, h, pix_fmt, w, h, AV_PIX_FMT_BGR24, SWS_BICUBIC,
                             None, None, None)
    stride = (3 * w + 63) // 64 * 64
    out = np.zeros((h, stride), np.uint8)
    src = (_P * 4)(*[p.ctypes.data for p in planes], None)
    src_stride = (ctypes.c_int * 4)(*[p.shape[1] for p in planes], 0)
    dst = (_P * 4)(out.ctypes.data, None, None, None)
    dst_stride = (ctypes.c_int * 4)(stride, 0, 0, 0)
    sws.sws_scale(ctx, src, src_stride, 0, h, dst, dst_stride)
    sws.sws_freeContext(ctx)
    return out[:, :3 * w].reshape(h, w, 3)
