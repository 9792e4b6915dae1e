"""The system libwebp through ctypes, for the WebP tests and the fixture
maker (never the port): ``encode`` reaches the encoder settings cv2 and PIL
cannot choose (the simple loop filter, sharpness, segments, token
partitions) through ``WebPConfigInitInternal`` and ``WebPEncode``, with the
structure layouts of ``webp/encode.h`` (ABI 0x020f); ``decode_yuv`` gives a
lossy file's Y, U and V planes before the colour conversion
(``WebPDecodeYUV``).  ``lossless_features`` reads which VP8L tools a file
uses with the port's own reader."""

import ctypes
import ctypes.util

import numpy as np

ENCODER_ABI = 0x020F
_LIB = None


def lib():
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(ctypes.util.find_library("webp") or "libwebp.so.7")
        _LIB.WebPDecodeYUV.restype = ctypes.POINTER(ctypes.c_uint8)
        _LIB.WebPDecodeRGB.restype = ctypes.POINTER(ctypes.c_uint8)
    return _LIB


_CONFIG_FIELDS = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
                  "segments", "sns_strength", "filter_strength", "filter_sharpness",
                  "filter_type", "autofilter", "alpha_compression", "alpha_filtering",
                  "alpha_quality", "pass_", "show_compressed", "preprocessing", "partitions",
                  "partition_limit", "emulate_jpeg_size", "thread_level", "low_memory",
                  "near_lossless", "exact", "use_delta_palette", "use_sharp_yuv", "qmin",
                  "qmax"]


class WebPConfig(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float if n in ("quality", "target_PSNR") else ctypes.c_int)
                for n in _CONFIG_FIELDS]


_P = ctypes.c_void_p


class WebPPicture(ctypes.Structure):
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("y", _P), ("u", _P), ("v", _P), ("y_stride", ctypes.c_int),
                ("uv_stride", ctypes.c_int), ("a", _P), ("a_stride", ctypes.c_int),
                ("pad1", ctypes.c_uint32 * 2), ("argb", _P), ("argb_stride", ctypes.c_int),
                ("pad2", ctypes.c_uint32 * 3), ("writer", _P), ("custom_ptr", _P),
                ("extra_info_type", ctypes.c_int), ("extra_info", _P), ("stats", _P),
                ("error_code", ctypes.c_int), ("progress_hook", _P), ("user_data", _P),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", _P), ("pad5", _P),
                ("pad6", ctypes.c_uint32 * 8), ("memory_", _P), ("memory_argb_", _P),
                ("pad7", _P * 2)]


class WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


def encode(image, lossless=False, quality=75.0, method=4, **settings):
    """A WebP file of (H, W, 3) or (H, W, 4) uint8 RGB(A) ``image`` from the
    system libwebp; ``settings`` are WebPConfig fields (``segments``,
    ``filter_type``, ``filter_sharpness``, ``partitions``, ``exact``...)."""
    w = lib()
    image = np.ascontiguousarray(image, np.uint8)
    config = WebPConfig()
    if not w.WebPConfigInitInternal(ctypes.byref(config), 0, ctypes.c_float(quality),
                                    ENCODER_ABI):
        raise RuntimeError("WebPConfigInitInternal failed")
    config.lossless, config.method = int(lossless), method
    for name, value in settings.items():
        setattr(config, name, value)
    if not w.WebPValidateConfig(ctypes.byref(config)):
        raise ValueError(f"libwebp refuses the settings {settings}")
    pic = WebPPicture()
    if not w.WebPPictureInitInternal(ctypes.byref(pic), ENCODER_ABI):
        raise RuntimeError("WebPPictureInitInternal failed")
    pic.use_argb = int(lossless)
    pic.height, pic.width = image.shape[:2]
    importer = w.WebPPictureImportRGBA if image.shape[2] == 4 else w.WebPPictureImportRGB
    if not importer(ctypes.byref(pic), image.ctypes.data_as(_P),
                    image.shape[1] * image.shape[2]):
        raise RuntimeError("WebPPictureImportRGB failed")
    writer = WebPMemoryWriter()
    w.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(w.WebPMemoryWrite, _P)
    pic.custom_ptr = ctypes.cast(ctypes.byref(writer), _P)
    try:
        if not w.WebPEncode(ctypes.byref(config), ctypes.byref(pic)):
            raise RuntimeError(f"WebPEncode failed with error {pic.error_code}")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        w.WebPMemoryWriterClear(ctypes.byref(writer))
        w.WebPPictureFree(ctypes.byref(pic))


def decode_yuv(data):
    """The Y (H, W), U and V ((H+1)//2, (W+1)//2) planes of a lossy WebP."""
    w = lib()
    width, height, stride, uv_stride = (ctypes.c_int() for _ in range(4))
    u, v = ctypes.POINTER(ctypes.c_uint8)(), ctypes.POINTER(ctypes.c_uint8)()
    y = w.WebPDecodeYUV(data, len(data), ctypes.byref(width), ctypes.byref(height),
                        ctypes.byref(u), ctypes.byref(v), ctypes.byref(stride),
                        ctypes.byref(uv_stride))
    if not y:
        raise ValueError("WebPDecodeYUV failed")
    try:
        h, wd, ch, cw = height.value, width.value, (height.value + 1) // 2, (width.value + 1) // 2

        def plane(ptr, rows, cols, step):
            raw = np.ctypeslib.as_array(ptr, (rows * step,)).reshape(rows, step)
            return raw[:, :cols].copy()

        return (plane(y, h, wd, stride.value), plane(u, ch, cw, uv_stride.value),
                plane(v, ch, cw, uv_stride.value))
    finally:
        w.WebPFree(y)


def decode_rgb(data):
    """``WebPDecodeRGB`` of ``data``: (H, W, 3) uint8."""
    w = lib()
    width, height = ctypes.c_int(), ctypes.c_int()
    ptr = w.WebPDecodeRGB(data, len(data), ctypes.byref(width), ctypes.byref(height))
    if not ptr:
        raise ValueError("WebPDecodeRGB failed")
    try:
        return np.ctypeslib.as_array(ptr, (height.value * width.value * 3,)).reshape(
            height.value, width.value, 3).copy()
    finally:
        w.WebPFree(ptr)


def lossless_features(payload):
    """What a VP8L bitstream uses, read with the port's reader: its
    transforms in order (0 predictor, 1 colour, 2 subtract-green, 3 colour
    indexing with its palette size), and whether its main image has a
    colour cache and meta prefix codes."""
    from orienmask_tpu_torch.data import vp8l

    width, height, _ = vp8l.read_header(payload)
    br = vp8l.BitReader(payload, 40)
    transforms, palette = [], 0
    while br.read(1):
        kind = br.read(2)
        transforms.append(kind)
        if kind in (0, 1):
            bits = br.read(3) + 2
            vp8l.decode_image_native(br, -(-width // (1 << bits)), -(-height // (1 << bits)),
                                     False)
        elif kind == 3:
            palette = br.read(8) + 1
            vp8l.decode_image_native(br, palette, 1, False)
            width = -(-width // (1 << (3 if palette <= 2 else 2 if palette <= 4 else
                                       1 if palette <= 16 else 0)))
    cache = bool(br.read(1))
    if cache:
        br.read(4)
    return {"transforms": transforms, "palette": palette, "cache": cache,
            "meta": bool(br.read(1))}
