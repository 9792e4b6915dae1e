"""The port's JPEG decoder (``orienmask_tpu_torch/data/jpeg.py`` and its
compiled scan decoder ``csrc/jpeg_host.cc``) against OpenCV, which the JAX
package reads images with (``cv2.imread`` + ``cvtColor``; written against
cv2 5.0.0, which bundles libjpeg-turbo 3.1.2): every case is bit-identical,
no tolerance.  JPEGs are written by cv2 from seeded
smooth scenes (``probe/make_jpeg_fixtures.py::scene``) at several sizes,
qualities and sampling factors, progressive, with restart intervals, grey,
and with EXIF orientations spliced in; a few forms cv2 does not write
(SOF1, 16-bit quantization tables, RGB-coded, a DRI before a restart-free
scan) are made by editing cv2's bytes.  The Python and C++ scan decoders
give equal coefficients; each refused form raises with its name; the
committed fixtures still equal cv2's decode."""

import hashlib
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

from orienmask_tpu_torch.data import jpeg
from orienmask_tpu_torch.data.image_io import UnsupportedImage, read_image
from test_golden_asset import ASSET

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "probe"))
from make_jpeg_fixtures import OUT as FIXTURES  # noqa: E402
from make_jpeg_fixtures import scene, with_exif  # noqa: E402

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
SIZES = [(16, 16), (37, 53), (120, 161), (480, 640)]


def _encode(h, w, quality=75, sampling="420", grey=False, progressive=False, restart=0,
            seed=0, optimize=False):
    rgb = scene(seed + h * 7 + w, h, w)
    pixels = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY) if grey else rgb[..., ::-1]
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
              SAMPLING[sampling], cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart, cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize)]
    ok, data = cv2.imencode(".jpg", pixels, params)
    assert ok
    return data.tobytes()


def _cv2_rgb(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def _assert_reads_as_cv2(data, tmp_path=None):
    want = _cv2_rgb(data)
    got = jpeg.decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if tmp_path is not None:  # and through the reader, from a file
        path = tmp_path / "image.jpg"
        path.write_bytes(data)
        np.testing.assert_array_equal(read_image(path), want)
        np.testing.assert_array_equal(read_image(path), cv2.cvtColor(cv2.imread(str(path)),
                                                                     cv2.COLOR_BGR2RGB))


@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("quality", [30, 75, 95, 100])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_sequential_reads_as_cv2_reads_it(tmp_path, size, quality, sampling):
    _assert_reads_as_cv2(_encode(*size, quality=quality, sampling=sampling), tmp_path)


@pytest.mark.parametrize("quality", [30, 75, 95, 100])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_grey_reads_replicated_as_cv2_reads_it(tmp_path, size, quality):
    _assert_reads_as_cv2(_encode(*size, quality=quality, grey=True), tmp_path)


@pytest.mark.parametrize("form", list(SAMPLING) + ["grey"])
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_progressive_reads_as_cv2_reads_it(size, form):
    """cv2 writes libjpeg's standard progressive script: successive
    approximation, DC and AC first and refinement scans, EOB runs."""
    grey = form == "grey"
    _assert_reads_as_cv2(_encode(*size, quality=85, sampling="420" if grey else form,
                                 grey=grey, progressive=True))


@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
@pytest.mark.parametrize("form", list(SAMPLING) + ["grey"])
@pytest.mark.parametrize("restart", [1, 4])
def test_restart_intervals_read_as_cv2_reads_them(restart, form, progressive):
    grey = form == "grey"
    _assert_reads_as_cv2(_encode(120, 161, quality=90, sampling="420" if grey else form,
                                 grey=grey, progressive=progressive, restart=restart))


@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("progressive", [False, True], ids=["sequential", "progressive"])
def test_optimized_huffman_tables(quality, progressive):
    """Tables built for the image (long codes, past the 9-bit lookahead)."""
    _assert_reads_as_cv2(_encode(120, 161, quality=quality, optimize=True,
                                 progressive=progressive))


@pytest.mark.parametrize("order", [b"II", b"MM"], ids=["little_endian", "big_endian"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_is_applied_as_cv2_applies_it(tmp_path, orientation, order):
    """cv2.imread turns the image by the EXIF orientation (OpenCV's
    ExifTransform: flips and a transpose) after decoding; on a 37x53 4:2:0
    image orientations 5-8 give 53x37."""
    data = with_exif(_encode(37, 53, quality=90), orientation, order)
    _assert_reads_as_cv2(data, tmp_path)
    assert jpeg.decode(data).shape == ((53, 37, 3) if orientation > 4 else (37, 53, 3))


def _segments(data):
    """(marker, start, end) of each marker segment before the first scan."""
    pos, out = 2, []
    while data[pos + 1] != 0xDA:
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((data[pos + 1], pos, pos + 2 + length))
        pos += 2 + length
    return out


def _edit(data, marker, fn):
    """``data`` with the first segment of ``marker`` replaced by fn(segment)."""
    for m, start, end in _segments(data):
        if m == marker:
            return data[:start] + fn(data[start:end]) + data[end:]
    raise AssertionError(f"no marker {marker:#x}")


def _dqt16(segment):
    """An 8-bit DQT segment rewritten with 16-bit entries (same values)."""
    body, out = segment[4:], b""
    while body:
        tq, values = body[0] & 15, body[1:65]
        out += bytes([0x10 | tq]) + np.frombuffer(values, np.uint8).astype(">u2").tobytes()
        body = body[65:]
    return b"\xff\xdb" + struct.pack(">H", len(out) + 2) + out


def _rgb_coded(data):
    """No JFIF marker and component ids 'R', 'G', 'B': libjpeg then takes
    the components as RGB (no colour conversion)."""
    data = _edit(data, 0xE0, lambda seg: b"")
    data = _edit(data, 0xC0, lambda seg: seg[:10] + b"R" + seg[11:13] + b"G" + seg[14:16]
                 + b"B" + seg[17:])
    sos = data.index(b"\xff\xda")  # the scan header names the components too
    return data[:sos + 5] + b"R" + data[sos + 6:sos + 7] + b"G" + data[sos + 8:sos + 9] \
        + b"B" + data[sos + 10:]


@pytest.mark.parametrize("form", ["sof1", "dqt16", "rgb_coded", "dri_zero"])
def test_forms_cv2_does_not_write(form):
    """Extended sequential (SOF1), 16-bit quantization tables, a 3-component
    file coded as RGB, and a DRI of 0 (no restarts) read as cv2 reads them."""
    data = _encode(37, 53, quality=60, sampling="444" if form == "rgb_coded" else "420")
    if form == "sof1":
        data = _edit(data, 0xC0, lambda seg: b"\xff\xc1" + seg[2:])
    elif form == "dqt16":
        data = _edit(data, 0xDB, _dqt16)
    elif form == "rgb_coded":
        data = _rgb_coded(data)
    else:
        data = data[:2] + b"\xff\xdd\x00\x04\x00\x00" + data[2:]
    _assert_reads_as_cv2(data)


@pytest.mark.parametrize("case", [
    dict(size=(16, 16), sampling="444"), dict(size=(37, 53), sampling="422"),
    dict(size=(37, 53), sampling="440"), dict(size=(37, 53), sampling="420"),
    dict(size=(37, 53), grey=True), dict(size=(37, 53), progressive=True),
    dict(size=(37, 53), progressive=True, grey=True),
    dict(size=(37, 53), progressive=True, restart=3, sampling="422"),
    dict(size=(37, 53), restart=1), dict(size=(37, 53), optimize=True, progressive=True),
], ids=lambda c: "_".join(f"{k}{v}" for k, v in c.items()))
def test_python_and_compiled_scan_decoders_agree(case):
    """The plain Python scan decoder (the spec) and the compiled one give
    equal coefficients, block for block, scan after scan."""
    case = dict(case)
    data = _encode(*case.pop("size"), quality=80, **case)
    spec = jpeg.parse(data, jpeg.decode_scan_py)
    native = jpeg.parse(data, jpeg.decode_scan_native)
    assert spec.scans == native.scans >= 1
    np.testing.assert_array_equal(spec.buffer, native.buffer)
    assert np.abs(native.buffer).max() > 0


def test_the_compiled_decoder_is_built_under_csrc_build():
    from orienmask_tpu_torch import kernels

    lib = kernels.host_library("jpeg_host")
    assert Path(lib._name) == kernels.BUILD_DIR / "libjpeg_host.so"
    assert lib.omj_error_string(1).decode().startswith("a truncated")


def _refused():
    base = _encode(37, 53, quality=75)
    cases = {
        "an arithmetic-coded JPEG": _edit(base, 0xC0, lambda s: b"\xff\xc9" + s[2:]),
        "a lossless JPEG": _edit(base, 0xC0, lambda s: b"\xff\xc3" + s[2:]),
        "a hierarchical JPEG": _edit(base, 0xC0, lambda s: b"\xff\xc5" + s[2:]),
        "a 12-bit JPEG": _edit(base, 0xC0, lambda s: s[:4] + b"\x0c" + s[5:]),
        "sampling factors 4x1": _edit(
            base, 0xC0, lambda s: s[:11] + b"\x41" + s[12:]),
        "a truncated JPEG \\(scan runs": base[:-40],
        "a truncated JPEG \\(no end-of-image": base[:-2] + b"\xff\xfe\x00\x04ok",
    }
    return cases


@pytest.mark.parametrize("why", list(_refused()), ids=lambda w: w.split(" (")[0].split("\\")[0])
def test_refused_forms_raise_with_their_name(tmp_path, why):
    data = _refused()[why]
    with pytest.raises(jpeg.UnsupportedJpeg, match=why):
        jpeg.decode(data)
    path = tmp_path / "refused.jpg"
    path.write_bytes(data)
    with pytest.raises(UnsupportedImage, match=why) as err:
        read_image(path)
    assert "this build reads PNG (every colour type" in str(err.value)


def test_cmyk_and_411_written_by_other_encoders_are_refused(tmp_path):
    """4-component files (PIL writes CMYK) and 4:1:1 (cv2 writes it)."""
    rgb = scene(3, 32, 48)
    Image.fromarray(rgb).convert("CMYK").save(tmp_path / "cmyk.jpg")
    with pytest.raises(jpeg.UnsupportedJpeg, match="4-component JPEG"):
        jpeg.decode((tmp_path / "cmyk.jpg").read_bytes())
    ok, data = cv2.imencode(".jpg", rgb, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    with pytest.raises(jpeg.UnsupportedJpeg, match="sampling factors 4x1"):
        jpeg.decode(data.tobytes())


def test_incomplete_progressive_scans_are_refused():
    """A progressive file whose last refinement scans are cut (coefficients
    left at a coarse bit) would be block-smoothed by libjpeg."""
    data = _encode(37, 53, progressive=True)
    scans = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    cut = data[:scans[-3]] + b"\xff\xd9"
    with pytest.raises(jpeg.UnsupportedJpeg, match="leave coefficients incomplete"):
        jpeg.decode(cut)


def test_committed_fixtures_equal_cv2_and_their_digests():
    """``probe/jpeg_fixtures``: each file's digest is cv2's decode here, and
    the port decodes it to the same bytes (what phase 15 of chip_smoke.py
    checks on the card's machine)."""
    digests = json.loads((FIXTURES / "digests.json").read_text())
    images = json.loads((FIXTURES / "images.json").read_text())["images"]
    assert len(digests) == len(images) >= 8
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) <= 1 << 20
    for entry in images:
        name = entry["file_name"]
        want = cv2.cvtColor(cv2.imread(str(FIXTURES / name)), cv2.COLOR_BGR2RGB)
        assert list(want.shape) == digests[name]["shape"] == [entry["height"],
                                                               entry["width"], 3]
        assert hashlib.sha256(want.tobytes()).hexdigest() == digests[name]["sha256"], name
        np.testing.assert_array_equal(read_image(FIXTURES / name), want)


def test_the_reference_coco_photograph():
    """The reference's COCO val2017 photograph, where it is present."""
    if not Path(ASSET).exists():
        pytest.skip("the reference's COCO asset is not present")
    _assert_reads_as_cv2(Path(ASSET).read_bytes())
