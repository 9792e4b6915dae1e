"""The port's Motion JPEG reader (``data/mjpeg.py``, the full-range colour
conversion of ``data/yuv.py`` and their C++ loops) against libavcodec's
``mjpeg`` decoder and libswscale (``mpeg4_oracle.py``, the libraries behind
cv2 here) and ``cv2.VideoCapture``.

The planes equal libavcodec's on every committed MJPEG fixture and on
frames made here: libavcodec's encoder at 4:2:0 and 4:2:2 (its 2x2 luma
with 1x2 chroma), with and without DHT segments, at several quantisers;
cv2's JPEG encoder (libjpeg: 2x2 and 2x1 sampling, restart intervals, a
width that is not a whole number of blocks).  The conversion to RGB
equals libswscale's ``yuvj420p`` and ``yuvj422p`` ones on every (Y, U, V)
triple.  The forms refused name themselves.  Frames are 96x128 or less."""

import json

import cv2
import numpy as np
import pytest
import torch

import mpeg4_oracle
from orienmask_tpu_torch.data import mjpeg, video, yuv
from test_torch_video_asp import FIXTURES, fixtures

DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
MJPEG = sorted(n for n, d in DIGESTS.items() if n.endswith(".avi") and "refused" not in d
               and video.VideoReader(FIXTURES / n).codec == "mjpeg")
J420, J422 = mpeg4_oracle.AV_PIX_FMT_YUVJ420P, mpeg4_oracle.AV_PIX_FMT_YUVJ422P


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _check_frames(packets, height):
    """Each packet's planes (of a ``height``-row AVI frame), by the plain
    and the C++ pixel loops, equal libavcodec's."""
    want = mpeg4_oracle.decode(packets, codec=b"mjpeg")
    assert len(want) == len(packets)
    for packet, planes in zip(packets, want):
        frame = mjpeg.parse(packet, height)
        for got in (mjpeg.planes_py(frame), mjpeg.planes_native(frame)):
            assert all(np.array_equal(a, b) for a, b in zip(got, planes))


def test_the_committed_mjpeg_fixtures_are_there():
    assert {"video_mjpg.avi", "mjpeg_422.avi", "mjpeg_422_nodht.avi", "mjpeg_420_nodht.avi",
            "mjpeg_422_webcam.avi", "mjpeg_422_480x640.avi"} <= set(MJPEG)


@pytest.mark.parametrize("name", MJPEG)
def test_committed_fixtures_decode_to_libavcodecs_planes(name):
    reader = video.VideoReader(FIXTURES / name)
    _check_frames(list(reader.packet_bytes()), reader.height)


def _scene(h, w, n=2, seed=0):
    return fixtures.pan(40 + seed, h, w, n, 3, 2)


@pytest.mark.parametrize("pix_fmt", [J420, J422])
@pytest.mark.parametrize("dht", [True, False])
@pytest.mark.parametrize("quality", [2, 9, 31])
def test_libavcodecs_frames_decode_to_its_planes(pix_fmt, dht, quality, tmp_path):
    """libavcodec's encoder (4:2:2 as 2x2 luma with 1x2 chroma); without
    DHT the decoder takes JPEG's standard tables, as FFmpeg does."""
    fixtures.mjpeg_avi(tmp_path / "a.avi", _scene(64, 96), pix_fmt=pix_fmt, dht=dht,
                       quality=quality)
    reader = video.VideoReader(tmp_path / "a.avi")
    packets = list(reader.packet_bytes())
    assert (b"\xff\xc4" in packets[0].split(b"\xff\xda")[0]) == dht
    _check_frames(packets, reader.height)


@pytest.mark.parametrize("sampling", ["420", "422"])
@pytest.mark.parametrize("quality, restart, size", [(50, 0, (64, 96)), (95, 0, (48, 70)),
                                                    (85, 2, (64, 96))])
def test_cv2s_frames_decode_to_libavcodecs_planes(sampling, quality, restart, size, tmp_path):
    """libjpeg's frames, as webcams write them (2x1 sampling for 4:2:2),
    with restart intervals and a width that is not a whole block."""
    factor = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
              "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422}[sampling]
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    packets = [cv2.imencode(".jpg", np.ascontiguousarray(f[..., ::-1]), params)[1].tobytes()
               for f in _scene(*size, seed=1)]
    _check_frames(packets, size[0])
    _check_frames([fixtures.strip_dht(p) for p in packets], size[0])


def test_an_avi1_tagged_file_reads_as_mjpg(tmp_path):
    data = (FIXTURES / "mjpeg_422_webcam.avi").read_bytes().replace(b"MJPG", b"AVI1")
    (tmp_path / "a.avi").write_bytes(data)
    got = list(video.VideoReader(tmp_path / "a.avi"))
    want, _, _ = mpeg4_oracle.cv2_frames(tmp_path / "a.avi")
    assert len(got) == len(want) == 3 and all(np.array_equal(a, b) for a, b in zip(got, want))


def _every_triple(rows):
    """Y, U, V planes holding every (Y, U, V) once: 2^16 (U, V) pairs, each
    serving 2 x ``rows`` luma pixels per occurrence, 256 / (2 ``rows``)
    occurrences of each."""
    n = (1 << 24) // (2 * rows)  # chroma samples
    c = np.arange(n)
    u = (c % 65536 >> 8).astype(np.uint8).reshape(-1, 2048)
    v = (c % 65536 & 255).astype(np.uint8).reshape(-1, 2048)
    group = (c // 65536 * 2 * rows).reshape(-1, 2048)
    y = np.zeros((u.shape[0] * rows, 4096), np.uint8)
    for k, (dy, dx) in enumerate((dy, dx) for dy in range(rows) for dx in range(2)):
        y[dy::rows, dx::2] = group + k
    return y, u, v


@pytest.mark.parametrize("pix_fmt", [J420, J422])
def test_yuvj_to_rgb_equals_libswscales_on_every_triple(pix_fmt):
    """libswscale's x86 yuv2rgb with its full-range table, as cv2 converts
    a ``yuvj420p`` or ``yuvj422p`` frame."""
    y, u, v = _every_triple(2 if pix_fmt == J420 else 1)
    want = mpeg4_oracle.yuv420_to_bgr(y, u, v, pix_fmt)[..., ::-1]
    assert np.array_equal(yuv.yuvj_to_rgb(y, u, v), want)


def test_the_colour_loop_equals_its_plain_version():
    rng = np.random.default_rng(5)
    for shape in ((18, 26), (36, 26)):  # 4:2:0, 4:2:2
        y = rng.integers(0, 256, (36, 51), np.uint8)
        u, v = (rng.integers(0, 256, shape, np.uint8) for _ in range(2))
        assert np.array_equal(yuv.yuvj_to_rgb_py(y, u, v), yuv.yuvj_to_rgb_native(y, u, v))


def _avi(path, packets, height=None):
    fixtures.write_avi(path, packets, 64, height or 48, fourcc=b"MJPG",
                       keys=[True] * len(packets))


@pytest.mark.parametrize("form", ["progressive", "grey", "444", "odd height", "interlaced"])
def test_the_refused_forms_name_themselves(form, tmp_path):
    frame = np.ascontiguousarray(_scene(48, 64)[0][..., ::-1])
    params = [cv2.IMWRITE_JPEG_QUALITY, 90]
    height = None
    if form == "progressive":
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    elif form == "grey":
        frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    elif form == "444":
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
    elif form == "odd height":
        frame = frame[:47]
    else:
        height = 96  # the stream twice the frame's height: a field a frame
    _avi(tmp_path / "a.avi", [cv2.imencode(".jpg", frame, params)[1].tobytes()] * 2, height)
    with pytest.raises(video.UnsupportedVideo) as err:
        list(video.VideoReader(tmp_path / "a.avi"))
    name = {"progressive": "progressive MJPEG", "grey": "(grey)", "444": "sampled 1x1",
            "odd height": "odd height", "interlaced": "interlaced MJPEG"}[form]
    assert name in str(err.value) and "ROADMAP Queue 1 item 1" in str(err.value)
