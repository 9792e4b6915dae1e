"""The port's image reader and writer (``data/image_io.py``) against OpenCV,
which the JAX CLI reads with (``cv2.imread`` + ``cvtColor``): every PNG
colour type it reads and every filter type, exactly; PPM and ``.npy``
round trips; the formats it refuses, with the message."""

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
    cv2.imwrite(str(tmp_path / "a.jpg"), image)
    cv2.imwrite(str(tmp_path / "deep.png"), image.astype(np.uint16) * 257)
    Image.fromarray(image).convert("P").save(tmp_path / "palette.png")
    # an interlaced header (the IDAT content is never reached)
    (tmp_path / "interlaced.png").write_bytes(_png(
        image.reshape(8, -1), 2, 0, header=struct.pack(">IIBBBBB", 8, 8, 8, 2, 0, 0, 1)))
    np.save(tmp_path / "f32.npy", image.astype(np.float32))
    (tmp_path / "clip.mp4").write_bytes(b"\x00\x00\x00\x18ftypmp42")
    for name, why in (("a.jpg", "a JPEG"), ("deep.png", "16-bit"),
                      ("palette.png", "colour type 3"), ("interlaced.png", "interlaced"),
                      ("f32.npy", "float32"), ("clip.mp4", "not a PNG")):
        with pytest.raises(UnsupportedImage, match=why) as err:
            read_image(tmp_path / name)
        assert "reads 8-bit non-interlaced PNG" in str(err.value), name
    with pytest.raises(UnsupportedImage, match="video file"):
        frame_paths(tmp_path / "clip.mp4")


def test_frame_and_image_directories(tmp_path):
    for name in ("b.png", "a.png", "c.npy", "notes.json"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "sub.png").mkdir()
    assert image_names(tmp_path) == ["a.png", "b.png", "c.npy"]
    assert frame_paths(tmp_path, 2) == [str(tmp_path / "a.png"), str(tmp_path / "b.png")]
