"""The port's image reader and writer (``data/image_io.py``) against OpenCV,
which the JAX CLI reads with (``cv2.imread`` + ``cvtColor``): every PNG
colour type and bit depth, interlaced or not, and every filter type,
exactly (16 bits reduced to the high byte, as cv2 reduces them); PPM and
``.npy`` round trips; cv2's BMP and TIFF; the formats it refuses, with the
message.  JPEG has its own file, ``test_torch_jpeg.py``; the BMP and TIFF
forms ``test_torch_bmp_tiff.py``, the writers ``test_torch_image_write.py``."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from orienmask_tpu_torch.data.image_io import (
    UnsupportedImage,
    frame_paths,
    image_names,
    read_image,
    write_png,
)


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def _smooth(h, w, c, seed):
    """Gradients and a little noise (PIL then mixes Sub and Paeth rows)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * (3 + k) + y * (5 - k)) for k in range(c)], axis=-1)
    return ((base + rng.integers(0, 6, (h, w, c))) % 256).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["grey", "rgb", "rgba"])
@pytest.mark.parametrize("content", ["noise", "smooth"])
def test_png_written_by_opencv_reads_as_opencv_reads_it(tmp_path, channels, content):
    """Colour types 0, 2 and 6 as OpenCV's libpng writes them; the alpha is
    dropped, grey is replicated, as ``cv2.imread`` does."""
    shape = (37, 53, channels)
    if content == "noise":
        image = np.random.default_rng(channels).integers(0, 256, shape, dtype=np.uint8)
    else:
        image = _smooth(*shape, seed=channels)
    path = tmp_path / "image.png"
    cv2.imwrite(str(path), image[..., 0] if channels == 1 else image)
    got = read_image(path)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    np.testing.assert_array_equal(got, _cv2_rgb(path))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_with_mixed_filters_written_by_pil(tmp_path, mode):
    """PIL's writer picks a filter a row (Sub and Paeth rows alternate on
    these images; OpenCV writes Sub only): read as OpenCV reads it."""
    image = _smooth(37, 53, len(mode), seed=len(mode))
    path = tmp_path / "image.png"
    Image.fromarray(image[..., 0] if mode == "L" else image, mode).save(path)
    np.testing.assert_array_equal(read_image(path), _cv2_rgb(path))


def test_grey_and_alpha_png(tmp_path):
    """Colour type 4 (written by PIL): grey replicated, alpha dropped."""
    la = np.random.default_rng(4).integers(0, 256, (21, 19, 2), dtype=np.uint8)
    path = tmp_path / "la.png"
    Image.fromarray(la, "LA").save(path)
    np.testing.assert_array_equal(read_image(path), np.repeat(la[..., :1], 3, axis=2))
    np.testing.assert_array_equal(read_image(path), _cv2_rgb(path))


def _png_chunk(kind, payload):
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def _png(raw, colour, filter_type, header=None):
    """PNG bytes of (H, W*bpp) raw samples, every row filtered with
    ``filter_type`` (each filter reads raw bytes only, so it is one array
    expression here)."""
    bpp = {0: 1, 2: 3}[colour]
    r = raw.astype(np.int16)
    a, b, c = np.zeros_like(r), np.zeros_like(r), np.zeros_like(r)
    a[:, bpp:], b[1:], c[1:, bpp:] = r[:, :-bpp], r[:-1], r[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = [np.zeros_like(r), a, b, (a + b) >> 1,
            np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))][filter_type]
    rows = ((r - pred) & 0xFF).astype(np.uint8)
    body = np.concatenate([np.full((len(raw), 1), filter_type, np.uint8), rows], axis=1)
    h, w = raw.shape[0], raw.shape[1] // bpp
    header = header or struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(body.tobytes())) + _png_chunk(b"IEND", b""))


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
def test_each_filter_type_round_trips(tmp_path, filter_type, grey):
    """Every row written with one filter type, at odd widths: OpenCV reads
    the file as the array written, and so does the port's reader."""
    for w in (1, 7, 33):
        image = _smooth(9, w, 1 if grey else 3, seed=w)
        path = tmp_path / f"f{filter_type}_{w}.png"
        path.write_bytes(_png(image.reshape(9, -1), 0 if grey else 2, filter_type))
        want = np.repeat(image, 3, axis=2) if grey else image
        np.testing.assert_array_equal(_cv2_rgb(path), want)
        np.testing.assert_array_equal(read_image(path), want)


def test_write_png_round_trips(tmp_path):
    image = _smooth(13, 21, 3, seed=3)
    write_png(tmp_path / "image.png", image)
    np.testing.assert_array_equal(_cv2_rgb(tmp_path / "image.png"), image)
    np.testing.assert_array_equal(read_image(tmp_path / "image.png"), image)


def test_ppm_and_npy_round_trip(tmp_path):
    image = np.random.default_rng(5).integers(0, 256, (11, 17, 3), dtype=np.uint8)
    ppm = tmp_path / "image.ppm"
    ppm.write_bytes(b"P6\n# a comment\n17 11\n255\n" + image.tobytes())
    np.testing.assert_array_equal(read_image(ppm), image)
    cv2.imwrite(str(tmp_path / "cv.ppm"), image[..., ::-1])
    np.testing.assert_array_equal(read_image(tmp_path / "cv.ppm"), image)
    np.save(tmp_path / "image.npy", image)
    np.testing.assert_array_equal(read_image(tmp_path / "image.npy"), image)


def test_refused_formats_name_what_is_read(tmp_path):
    image = np.random.default_rng(6).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "whole.webp"), image)  # a WebP cut short: its RIFF size lies
    (tmp_path / "a.webp").write_bytes((tmp_path / "whole.webp").read_bytes()[:40])
    Image.fromarray(image).convert("CMYK").save(tmp_path / "cmyk.jpg")
    # a bit depth the colour type does not allow
    (tmp_path / "rgb4.png").write_bytes(_png(
        image.reshape(8, -1), 2, 0, header=struct.pack(">IIBBBBB", 8, 8, 4, 2, 0, 0, 0)))
    np.save(tmp_path / "f32.npy", image.astype(np.float32))
    (tmp_path / "clip.mp4").write_bytes(b"\x00\x00\x00\x18ftypmp42")
    (tmp_path / "notes.txt").write_bytes(b"hello")
    for name, why in (("a.webp", "a truncated WebP file"), ("cmyk.jpg", "4-component JPEG"),
                      ("rgb4.png", "colour type 2 at 4 bits"), ("f32.npy", "float32"),
                      ("clip.mp4", "a video file"), ("notes.txt", "not an image file")):
        with pytest.raises(UnsupportedImage, match=why) as err:
            read_image(tmp_path / name)
        assert "this build reads PNG (every colour type" in str(err.value), name
        assert "ROADMAP Queue 1 item 1" in str(err.value), name
    with pytest.raises(UnsupportedImage, match="video file"):
        frame_paths(tmp_path / "clip.mp4")


@pytest.mark.parametrize("name", ["a.bmp", "a.tif"])
def test_bmp_and_tiff_written_by_opencv_read_as_opencv_reads_them(tmp_path, name):
    """The BMP and TIFF that were refusal cases above until the port read
    them (``data/bmp.py``, ``data/tiff.py``; their forms are in
    ``test_torch_bmp_tiff.py``): cv2's own files, read as cv2 reads them."""
    image = np.random.default_rng(6).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / name), image)
    np.testing.assert_array_equal(read_image(tmp_path / name), _cv2_rgb(tmp_path / name))
    np.testing.assert_array_equal(read_image(tmp_path / name), image[..., ::-1])


def _pack(samples, depth):
    """(rows, width, channels) samples -> (rows, bytes) packed as PNG packs
    them: MSB first below 8 bits, big-endian at 16."""
    rows = samples.reshape(len(samples), -1)
    if depth == 16:
        return rows.astype(">u2").view(np.uint8).reshape(len(rows), -1)
    if depth == 8:
        return rows.astype(np.uint8)
    bits = (rows[..., None] >> np.arange(depth - 1, -1, -1)) & 1
    return np.packbits(bits.reshape(len(rows), -1).astype(np.uint8), axis=1)


def _png_any(samples, colour, depth, interlace, palette=None, trns=None):
    """PNG bytes of (H, W, C) samples of any colour type and depth, Adam7
    interlaced or not, each row filtered with type ``y % 5``."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    body = []
    passes = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
              (1, 0, 2, 2), (0, 1, 1, 2)) if interlace else ((0, 0, 1, 1),)
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        raw = _pack(sub, depth).astype(np.int16)
        a, b, cc = np.zeros_like(raw), np.zeros_like(raw), np.zeros_like(raw)
        a[:, bpp:], b[1:], cc[1:, bpp:] = raw[:, :-bpp], raw[:-1], raw[:-1, :-bpp]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        preds = [np.zeros_like(raw), a, b, (a + b) >> 1,
                 np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))]
        for y in range(len(raw)):
            f = y % 5
            body.append(bytes([f]) + ((raw[y] - preds[f][y]) & 0xFF).astype(np.uint8).tobytes())
    chunks = _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0,
                                             int(interlace)))
    if palette is not None:
        chunks += _png_chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        chunks += _png_chunk(b"tRNS", trns)
    return (b"\x89PNG\r\n\x1a\n" + chunks + _png_chunk(b"IDAT", zlib.compress(b"".join(body)))
            + _png_chunk(b"IEND", b""))


_FORMS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
          (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("colour,depth", _FORMS, ids=[f"type{c}_{d}bit" for c, d in _FORMS])
def test_every_png_form_reads_as_opencv_reads_it(tmp_path, colour, depth, interlace):
    """Every colour type at every depth it allows, Adam7 or not, all five
    filter types, at odd sizes (13x11 leaves some Adam7 passes one pixel
    wide, 1x3 leaves some empty): bit for bit with ``cv2.imread``; a
    palette shorter than its indices reads black there, tRNS is ignored."""
    rng = np.random.default_rng(colour * 100 + depth)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    top = 2 ** depth
    for h, w in ((13, 11), (1, 3), (37, 53)):
        samples = rng.integers(0, top, (h, w, channels), dtype=np.uint32)
        palette = trns = None
        if colour == 3:
            palette = rng.integers(0, 256, (max(1, top - 1), 3))  # the last index has no entry
            trns = bytes(rng.integers(0, 256, 2, dtype=np.uint8))
        elif colour in (0, 2):
            trns = bytes(2 * channels)
        path = tmp_path / f"{h}x{w}.png"
        path.write_bytes(_png_any(samples, colour, depth, interlace, palette, trns))
        want = _cv2_rgb(path)
        np.testing.assert_array_equal(read_image(path), want, err_msg=f"{h}x{w}")
        if depth == 16:  # cv2 keeps the high byte (png_set_strip_16), it does not round
            first = samples[..., :3] if channels >= 3 else np.repeat(samples[..., :1], 3, 2)
            np.testing.assert_array_equal(want, (first >> 8).astype(np.uint8))


def test_frame_and_image_directories(tmp_path):
    for name in ("b.png", "a.png", "c.npy", "notes.json"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "sub.png").mkdir()
    assert image_names(tmp_path) == ["a.png", "b.png", "c.npy"]
    assert frame_paths(tmp_path, 2) == [str(tmp_path / "a.png"), str(tmp_path / "b.png")]
