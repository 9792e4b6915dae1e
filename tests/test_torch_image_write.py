"""The port's image writers (``data/jpeg_encode.py``, ``data/bmp.py``,
``data/tiff.py``, ``data/image_io.py::write_image``) against OpenCV, which
the JAX CLI writes with (``cv2.imwrite`` of the RGB2BGR drawing):

* JPEG: the bytes of ``cv2.imencode(".jpg")`` at sizes that are and are not
  whole MCUs, colour (4:2:0) and grey, qualities 1-100 (95 is cv2's
  default); the plain entropy coder gives the C++ coder's bytes; the port's
  decoder reads the file as ``cv2.imread`` does;
* BMP: the bytes of ``cv2.imencode(".bmp")``;
* TIFF: LZW strips with the horizontal predictor, as cv2 writes them, read
  back to the same pixels by ``cv2.imread`` and by the port; the plain LZW
  coder and decoder give the C++ ones' bytes;
* ``write_image`` picks the format by extension, as ``cv2.imwrite`` does,
  and names any extension it cannot write."""

import cv2
import numpy as np
import pytest
import torch

from orienmask_tpu_torch.data import bmp, jpeg_encode, tiff
from orienmask_tpu_torch.data.image_io import encode_image, read_image, write_image
from orienmask_tpu_torch.data.jpeg import decode as decode_jpeg


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _image(h, w, seed, grey=False):
    """Noise over gradients: every coefficient band and long zero runs."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 3 + y) % 256, (x + 5 * y) % 256, (x * y) % 256], axis=-1)
    image = np.clip(base + rng.integers(-24, 25, (h, w, 3)), 0, 255).astype(np.uint8)
    return image[..., 0] if grey else image


def _cv2_jpeg(image, quality):
    bgr = image if image.ndim == 2 else cv2.cvtColor(image, cv2.COLOR_RGB2BGR)
    return cv2.imencode(".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, quality])[1].tobytes()


SIZES = [(1, 1), (7, 9), (16, 16), (17, 33), (480, 640)]


@pytest.mark.parametrize("quality", [50, 75, 95, 98, 100])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_jpeg_bytes_equal_opencvs(size, quality):
    image = _image(*size, seed=size[0] * 7 + quality)
    assert jpeg_encode.encode(image, quality) == _cv2_jpeg(image, quality)


@pytest.mark.parametrize("quality", [10, 75, 95])
@pytest.mark.parametrize("size", [(1, 1), (9, 7), (24, 40), (33, 17)],
                         ids=["1x1", "9x7", "24x40", "33x17"])
def test_grey_jpeg_bytes_equal_opencvs(size, quality):
    image = _image(*size, seed=quality, grey=True)
    assert jpeg_encode.encode(image, quality) == _cv2_jpeg(image, quality)


def test_default_quality_is_opencvs():
    image = _image(23, 41, seed=3)
    assert jpeg_encode.encode(image) == cv2.imencode(".jpg", image[..., ::-1])[1].tobytes()


@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
@pytest.mark.parametrize("quality", [75, 95, 98])
def test_plain_coder_gives_the_native_coders_bytes(quality, grey):
    for h, w in ((1, 1), (9, 13), (17, 33), (40, 31), (23, 8), (8, 23)):
        image = _image(h, w, seed=h + w, grey=grey)
        coefs, comps, _ = jpeg_encode.component_blocks(image, quality)
        n = 1 if grey else 3
        assert jpeg_encode.encode_blocks_py(coefs, comps, n) == \
            jpeg_encode.encode_blocks_native(coefs, comps, n), (h, w)


@pytest.mark.parametrize("size", [(17, 33), (480, 640)], ids=["17x33", "480x640"])
def test_port_decodes_the_encoders_jpeg_as_opencv_does(tmp_path, size):
    image = _image(*size, seed=11)
    path = tmp_path / "a.jpg"
    write_image(path, image)
    want = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(read_image(path), want)
    np.testing.assert_array_equal(decode_jpeg(path.read_bytes()), want)


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (37, 53)], ids=["1x1", "5x7", "37x53"])
def test_bmp_bytes_equal_opencvs(size):
    image = _image(*size, seed=5)
    assert bmp.encode(image) == cv2.imencode(".bmp", image[..., ::-1])[1].tobytes()


@pytest.mark.parametrize("size", [(1, 1), (37, 53), (480, 640)], ids=["1x1", "37x53", "480x640"])
def test_tiff_reads_back_to_the_same_pixels(tmp_path, size):
    image = _image(*size, seed=9)
    path = tmp_path / "a.tif"
    write_image(path, image)
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB), image)
    np.testing.assert_array_equal(read_image(path), image)


def test_tiff_is_laid_out_as_opencv_writes_it():
    """LZW, horizontal predictor, chunky 8-bit RGB, strips of 8192 // (3 W)
    rows: the tags cv2's own file carries."""
    image = _image(37, 53, seed=2)
    ours = tiff._ifd(tiff.encode(image), "<")
    theirs = tiff._ifd(cv2.imencode(".tif", image[..., ::-1])[1].tobytes(), "<")
    for tag in (256, 257, 258, 259, 262, 277, 278, 284, 317, 339):
        assert ours[tag] == theirs[tag], tag


@pytest.mark.parametrize("kind", ["noise", "runs", "empty"])
def test_plain_lzw_gives_the_native_codecs_bytes(kind):
    rng = np.random.default_rng(4)
    data = {"noise": rng.integers(0, 256, 30000, dtype=np.uint8).tobytes(),
            "runs": rng.integers(0, 3, 60000, dtype=np.uint8).tobytes(), "empty": b""}[kind]
    coded = tiff.lzw_encode(data)
    assert tiff.lzw_encode_native(data) == coded
    assert tiff.lzw_decode(coded) == data
    assert tiff.lzw_decode_native(coded, len(data)) == data


@pytest.mark.parametrize("ext", [".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm", ".JPG"])
def test_write_image_chooses_the_format_by_extension(tmp_path, ext):
    """As cv2.imwrite: each extension's format, read back by cv2 and by the
    port to the pixels cv2 reads from cv2's own file of that name."""
    image = _image(19, 26, seed=1)
    ours, theirs = tmp_path / f"ours{ext}", tmp_path / f"cv2{ext}"
    write_image(ours, image)
    cv2.imwrite(str(theirs), image[..., ::-1])
    want = cv2.cvtColor(cv2.imread(str(theirs)), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(str(ours)), cv2.COLOR_BGR2RGB), want)
    np.testing.assert_array_equal(read_image(ours), want)
    if ext.lower() in (".jpg", ".jpeg", ".bmp", ".ppm"):
        assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("name", ["a.gif", "a.mp4", "a"])
def test_write_image_names_an_extension_it_cannot_write(tmp_path, name):
    with pytest.raises(ValueError, match="cannot write") as err:
        write_image(tmp_path / name, _image(4, 4, seed=0))
    assert ".jpg" in str(err.value) and not (tmp_path / name).exists()


def test_writers_refuse_what_is_not_rgb():
    with pytest.raises(ValueError, match="uint8"):
        encode_image(".jpg", np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        write_image("x.png", np.zeros((4, 4), np.uint8))
