"""WebP in the port (``data/webp.py``, ``data/vp8.py``, ``data/vp8l.py``,
``csrc/webp_host.cc``) against ``cv2.imread`` and the system libwebp where
the tests run: the JAX CLI and datasets read WebP through cv2 (root ``infer.py:244``,
``orienmask_tpu/data/dataset.py:74``) and ``-v -o`` writes a ``.webp`` name
through ``cv2.imwrite``, which writes lossless VP8L.

Every read is exact (cv2's pixels).  VP8's Y, U and V planes equal
``WebPDecodeYUV``'s (``tests/webp_oracle.py``), so a fault in the decode and
one in the fancy upsampler or the colour conversion are told apart.  The
C++ loops equal their Python versions.  The writer's files read back to
the drawing exactly through cv2 and the port; its bytes are deterministic.
Images of 96x96 or less, plus 1x1 and odd sizes."""

import hashlib
import io
import json
import os
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import webp_oracle
from orienmask_tpu_torch.data import vp8, vp8l, webp
from orienmask_tpu_torch.data.image_io import UnsupportedImage, read_image, write_image

FIXTURES = Path(__file__).resolve().parent / "image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
WEBP_FIXTURES = sorted(n for n in DIGESTS if n.endswith(".webp"))
SIZES = ((1, 1), (15, 17), (33, 65), (96, 96))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(h, w, seed):
    """A smooth scene with edges and texture: every intra mode has work."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    image = rng.uniform(40, 200, 3) + (y / max(h, 1))[..., None] * rng.uniform(-60, 60, 3)
    for _ in range(4):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, max(4, h / 3))
        image = np.where((((y - cy) ** 2 + (x - cx) ** 2) < r * r)[..., None],
                         rng.uniform(0, 255, 3), image)
    image += 8 * np.sin(x / 3)[..., None] + rng.normal(0, 3, image.shape)
    return np.clip(np.round(image), 0, 255).astype(np.uint8)


def _images(h, w, seed):
    """Noise, a smooth scene and a few-colour image of one size."""
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (5, 3), dtype=np.uint8)
    return {"noise": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "smooth": _scene(h, w, seed),
            "few": palette[rng.integers(0, len(palette), (h, w))]}


def _cv2_read(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def _cv2_webp(image, *params):
    return cv2.imencode(".webp", image[..., ::-1], list(params))[1].tobytes()


def _pil_webp(image, **kw):
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _read(tmp_path, data, name="x.webp"):
    path = tmp_path / name
    path.write_bytes(data)
    return read_image(path)


def _riff(*chunks):
    body = b"".join(c + struct.pack("<I", len(p)) + p + b"\x00" * (len(p) & 1)
                    for c, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _payload(data, fourcc):
    i = data.index(fourcc)
    return data[i + 8:i + 8 + struct.unpack_from("<I", data, i + 4)[0]]


# ------------------------------------------------------------- fixtures

@pytest.mark.parametrize("name", WEBP_FIXTURES)
def test_committed_fixtures_read_as_opencv_reads_them(name):
    """The files phase 24 reads on the card: the port's read is cv2's
    (live here) and the committed digest; each is the form it says."""
    data = (FIXTURES / name).read_bytes()
    got = read_image(FIXTURES / name)
    np.testing.assert_array_equal(got, _cv2_read(data))
    assert list(got.shape) == DIGESTS[name]["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == DIGESTS[name]["sha256"]
    form = DIGESTS[name]["form"]
    assert {k: form[k] for k in ("kind", "animated", "alpha", "exif")} == webp.info(data)


def test_fixtures_cover_the_forms():
    forms = [DIGESTS[n]["form"] for n in WEBP_FIXTURES]
    assert {f["kind"] for f in forms} == {"VP8", "VP8L", "VP8X"}
    assert any(f["animated"] for f in forms) and any(f["alpha"] for f in forms)
    assert any(f["exif"] for f in forms)
    assert {f.get("filter_type") for f in forms} >= {1, 2}
    assert max(f.get("partitions", 1) for f in forms) == 8
    lossless = [f for f in forms if f["kind"] == "VP8L"]
    assert {t for f in lossless for t in f["transforms"]} == {0, 1, 2, 3}
    assert any(f["cache"] for f in lossless) and any(f["meta"] for f in lossless)
    assert any(3 <= f["palette"] <= 4 for f in lossless)  # 2-bit bundled indices
    assert DIGESTS["webp_exif_6.webp"]["shape"] == [24, 16, 3]


# ------------------------------------------------------------------ VP8

@pytest.mark.parametrize("quality", [1, 10, 25, 50, 75, 90, 100])
def test_vp8_from_opencv_at_every_quality(tmp_path, quality):
    for h, w in SIZES:
        for kind, image in _images(h, w, quality).items():
            data = _cv2_webp(image, cv2.IMWRITE_WEBP_QUALITY, quality)
            assert webp.info(data)["kind"] == "VP8"
            np.testing.assert_array_equal(_read(tmp_path, data), _cv2_read(data),
                                          err_msg=f"{kind} {h}x{w} q{quality}")


SETTINGS = [dict(filter_type=0), dict(filter_type=0, filter_sharpness=7),
            dict(method=2, partitions=1), dict(method=2, partitions=2),
            dict(method=2, partitions=3, segments=4), dict(segments=1),
            dict(segments=2, filter_sharpness=2), dict(segments=3, filter_sharpness=4),
            dict(segments=4, sns_strength=100, filter_sharpness=6),
            dict(filter_strength=0), dict(filter_strength=100, filter_sharpness=1),
            dict(filter_strength=100, filter_sharpness=3, filter_type=0),
            dict(quality=3, filter_sharpness=5), dict(quality=100, method=0)]


@pytest.mark.parametrize("settings", SETTINGS, ids=lambda s: "-".join(f"{k}{v}" for k, v in
                                                                          s.items()))
def test_vp8_settings_cv2_and_pil_cannot_choose(settings):
    """The simple filter, 2, 4 and 8 token partitions, 1-4 segments and
    sharpness 0-7 through the system libwebp: the planes equal
    WebPDecodeYUV's, the pixels cv2's."""
    kw = {"quality": 60, **settings}
    for h, w in SIZES[1:]:
        image = _scene(h, w, h + w)
        data = webp_oracle.encode(image, **kw)
        f = vp8.parse_header(_payload(data, b"VP8 "))
        if "partitions" in kw:
            assert f.n_parts == 1 << kw["partitions"]
        if kw.get("filter_type") == 0 and f.filter_type:
            assert f.filter_type == 1
        got = vp8.decode_yuv(_payload(data, b"VP8 "))
        for plane, want in zip(got, webp_oracle.decode_yuv(data)):
            np.testing.assert_array_equal(plane, want, err_msg=f"{h}x{w} {kw}")
        np.testing.assert_array_equal(webp.decode(data), _cv2_read(data))


def test_conversion_of_libwebps_planes_is_opencvs():
    """The fancy upsampler and the 14-bit conversion alone, on libwebp's
    own planes, at even and odd sizes."""
    for h, w in ((1, 1), (2, 2), (15, 17), (16, 9), (33, 65)):
        for image in _images(h, w, 3).values():
            data = _cv2_webp(image, cv2.IMWRITE_WEBP_QUALITY, 80)
            np.testing.assert_array_equal(vp8.yuv_to_rgb(*webp_oracle.decode_yuv(data)),
                                          _cv2_read(data))


@pytest.mark.parametrize("settings", [{}, dict(filter_type=0), dict(method=2, partitions=2),
                                      dict(segments=4, filter_sharpness=7, quality=20)])
def test_vp8_native_loops_equal_the_plain_ones(settings):
    for h, w in ((15, 17), (33, 65)):
        data = webp_oracle.encode(_scene(h, w, 5), **{"quality": 70, **settings})
        payload = _payload(data, b"VP8 ")
        got = vp8.decode_macroblocks_native(vp8.parse_header(payload))
        want = vp8.decode_macroblocks_py(vp8.parse_header(payload))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------- VP8L

@pytest.mark.parametrize("method", range(7))
def test_vp8l_from_pil_every_method_exact_and_alpha(tmp_path, method):
    rng = np.random.default_rng(method)
    for h, w in SIZES:
        for kind, image in _images(h, w, method).items():
            alpha = rng.integers(0, 256, (h, w), dtype=np.uint8)
            alpha[: h // 2] = 0  # transparent pixels: their colours are the encoder's
            for src in (image, np.dstack([image, alpha])):
                for exact in (False, True):
                    data = _pil_webp(src, lossless=True, method=method, exact=exact)
                    np.testing.assert_array_equal(
                        _read(tmp_path, data), _cv2_read(data),
                        err_msg=f"{kind} {h}x{w} m{method} exact={exact} {src.shape}")


FORMS = {"cache": lambda: np.where(np.random.default_rng(1).random((96, 96, 1)) < 0.1,
                                   _images(96, 96, 2)["noise"], 255).astype(np.uint8),
         "meta": lambda: _drawing(96, 96, 1),
         "palette_2bit": lambda: _images(40, 50, 3)["few"][..., :1].repeat(3, 2) // 64 * 64,
         "palette_8bit": lambda: np.kron(_images(12, 12, 4)["noise"], np.ones((8, 8, 1),
                                                                           np.uint8))}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_vp8l_forms_libwebp_chooses_by_content(tmp_path, name):
    """A colour cache (sparse dots), meta prefix codes (a drawing), palette
    indices bundled 4 to a byte (3-4 colours) and unbundled (144 colours):
    forms libwebp picks at methods 4 and 6 by what an image holds."""
    image = FORMS[name]()
    want = {"cache": "cache", "meta": "meta"}.get(name)
    for data in (_cv2_webp(image), _pil_webp(image, lossless=True, method=6)):
        features = webp_oracle.lossless_features(_payload(data, b"VP8L"))
        if want:
            assert features[want], features
        else:
            assert 3 in features["transforms"] and (features["palette"] <= 4) == (
                name == "palette_2bit"), features
        np.testing.assert_array_equal(_read(tmp_path, data), _cv2_read(data))


def test_vp8l_from_opencv(tmp_path):
    for h, w in SIZES:
        for image in _images(h, w, 9).values():
            data = _cv2_webp(image)
            assert webp.info(data)["kind"] == "VP8L"
            np.testing.assert_array_equal(_read(tmp_path, data), image)


@pytest.mark.parametrize("method", [0, 4, 6])
def test_vp8l_native_loops_equal_the_plain_ones(method):
    for h, w in ((15, 17), (33, 65)):
        for image in _images(h, w, method).values():
            payload = _payload(_pil_webp(image, lossless=True, method=method), b"VP8L")
            np.testing.assert_array_equal(
                vp8l.decode(payload),
                vp8l.decode(payload, vp8l.decode_image_py, vp8l.predictor_py))
            argb = vp8l.decode(payload).reshape(-1)
            for a, b in zip(vp8l.predictor_forward_native(argb, w, h),
                            vp8l.predictor_forward_py(argb, w, h)):
                np.testing.assert_array_equal(a, b)
            widths = (argb % 19).astype(np.int64)
            assert vp8l.BitWriter.pack_native(argb, widths) == vp8l.BitWriter.pack_py(
                argb.astype(np.int64), widths)
            for cache_bits in (0, 3, 10):
                for a, b in zip(vp8l.backward_refs_native(argb, w, cache_bits),
                                vp8l.backward_refs_py(argb, w, cache_bits)):
                    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- container

def test_vp8x_alpha_is_dropped_without_premultiplying(tmp_path):
    image = _scene(40, 56, 2)
    alpha = np.tile(np.linspace(0, 255, 56).astype(np.uint8), (40, 1))
    for kw in (dict(quality=80), dict(quality=30, alpha_quality=50), dict(lossless=True)):
        data = _pil_webp(np.dstack([image, alpha]), **kw)
        np.testing.assert_array_equal(_read(tmp_path, data), _cv2_read(data), err_msg=str(kw))
    data = _pil_webp(np.dstack([image, alpha]), quality=80)
    assert webp.info(data) == {"kind": "VP8X", "animated": False, "alpha": True,
                               "exif": False}


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("prefix", [b"", b"Exif\x00\x00"])
def test_exif_orientation_is_applied(tmp_path, orientation, prefix):
    """cv2 5 turns a WebP by its EXIF orientation; a WebP EXIF chunk holds
    the TIFF header itself, and one prefixed with JPEG's ``Exif\\0\\0`` is
    left alone by cv2, and so by the port."""
    image = _scene(16, 24, orientation)
    payload = _payload(_cv2_webp(image), b"VP8L")
    tiff = b"MM\x00*" + struct.pack(">IH", 8, 1) + struct.pack(">HHIHH", 0x0112, 3, 1,
                                                                orientation, 0) + b"\0" * 4
    vp8x = struct.pack("<B3x", 8) + (23).to_bytes(3, "little") + (15).to_bytes(3, "little")
    data = _riff((b"VP8X", vp8x), (b"VP8L", payload), (b"EXIF", prefix + tiff))
    np.testing.assert_array_equal(_read(tmp_path, data), _cv2_read(data))
    turned = orientation > 4 and not prefix
    assert _read(tmp_path, data).shape == ((24, 16, 3) if turned else (16, 24, 3))


def test_animation_reads_its_first_frame(tmp_path):
    frames = [_scene(30, 40, s) for s in range(3)]
    for lossless in (True, False):
        buf = io.BytesIO()
        Image.fromarray(frames[0]).save(buf, "WEBP", save_all=True, lossless=lossless,
                                        append_images=[Image.fromarray(f) for f in frames[1:]],
                                        duration=50)
        data = buf.getvalue()
        assert webp.info(data)["animated"]
        np.testing.assert_array_equal(_read(tmp_path, data), _cv2_read(data))
    # a first frame smaller than its canvas, at an offset: zeros around it
    payload = _payload(_cv2_webp(frames[1][:20, :24]), b"VP8L")
    anmf = (b"".join(v.to_bytes(3, "little") for v in (2, 3, 23, 19, 100)) + b"\x00"
            + b"VP8L" + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1))
    vp8x = struct.pack("<B3x", 2) + (39).to_bytes(3, "little") + (29).to_bytes(3, "little")
    data = _riff((b"VP8X", vp8x), (b"ANIM", b"\xff" * 4 + b"\x00\x00"), (b"ANMF", anmf))
    got = _read(tmp_path, data)
    np.testing.assert_array_equal(got, _cv2_read(data))
    assert got[6:26, 4:28].tolist() == frames[1][:20, :24].tolist() and not got[:6].any()


BROKEN = {
    "riff size past the end": lambda d: d[:len(d) // 2],
    "a chunk past the end": lambda d: d[:16] + struct.pack("<I", len(d)) + d[20:],
    "not a WebP bitstream chunk": lambda d: d[:12] + b"VP9 " + d[16:],
    "a VP8 interframe": lambda d: d[:20] + bytes([d[20] | 1]) + d[21:],
    "a VP8 frame without its start code": lambda d: d[:23] + b"\x00\x00\x00" + d[26:],
}
WHY = {"riff size past the end": "truncated WebP file", "a chunk past the end": "truncated",
       "not a WebP bitstream chunk": "starting with a b'VP9 ' chunk",
       "a VP8 interframe": "VP8 interframe", "a VP8 frame without its start code":
       "without its start code"}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_truncated_or_corrupt_files_are_refused_naming_the_form(tmp_path, case):
    data = BROKEN[case](_cv2_webp(_scene(33, 65, 1), cv2.IMWRITE_WEBP_QUALITY, 80))
    with pytest.raises(UnsupportedImage, match=WHY[case]) as err:
        _read(tmp_path, data)
    assert "ROADMAP Queue 1 item 1" in str(err.value) and "WebP (lossy VP8" in str(err.value)


def test_cut_partitions_and_bitstreams_are_refused(tmp_path):
    """A file whose sizes agree but whose VP8 partition or VP8L bitstream
    stops short: libwebp's end-of-data test, and the VP8L reader's."""
    lossy = _payload(_cv2_webp(_scene(96, 96, 4), cv2.IMWRITE_WEBP_QUALITY, 90), b"VP8 ")
    lossless = _payload(_cv2_webp(_scene(96, 96, 4)), b"VP8L")
    for fourcc, payload, why in ((b"VP8 ", lossy, "truncated VP8"),
                                 (b"VP8L", lossless, "truncated VP8L")):
        with pytest.raises(UnsupportedImage, match=why):
            _read(tmp_path, _riff((fourcc, payload[:len(payload) * 2 // 3])))
    with pytest.raises(UnsupportedImage, match="VP8L chunk without its signature"):
        _read(tmp_path, _riff((b"VP8L", b"\x00" + lossless[1:])))


# ---------------------------------------------------------------- writer

def _drawing(h, w, seed):
    """What -v -o writes: a scene with flat boxes, outlines and text-like
    strokes."""
    image = _scene(h, w, seed)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        y0, x0 = rng.integers(0, max(1, h - 4)), rng.integers(0, max(1, w - 4))
        colour = rng.integers(0, 256, 3)
        image[y0:y0 + h // 3, x0:x0 + w // 3] = (image[y0:y0 + h // 3, x0:x0 + w // 3] // 2
                                                 + colour // 2)
        image[y0, x0:x0 + w // 2] = colour
    return image


@pytest.mark.parametrize("h, w", SIZES + ((8, 200),))
def test_writer_round_trips_through_opencv_and_the_port(tmp_path, h, w, capsys):
    sizes = []
    for kind, image in {**_images(h, w, 11), "drawing": _drawing(h, w, 12)}.items():
        path = tmp_path / f"{kind}.webp"
        write_image(path, image)
        data = path.read_bytes()
        assert webp.info(data)["kind"] == "VP8L" and data == webp.encode(image)
        np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB),
                                      image, err_msg=f"{kind} {h}x{w}")
        np.testing.assert_array_equal(read_image(path), image)
        sizes.append(f"{kind} {len(data) / len(_cv2_webp(image)):.3f}")
    with capsys.disabled():
        print(f"\n  VP8L writer {h}x{w}, bytes against cv2.imwrite's: " + ", ".join(sizes))


def test_writer_uses_its_transforms_and_references():
    """Subtract-green and a predictor transform with modes chosen per tile,
    prefix codes of at most 15 bits, LZ77 references: not a literal dump;
    colour indexing for an image of few colours."""
    image = _drawing(96, 96, 13)
    payload = webp.encode(image)[20:]
    assert webp_oracle.lossless_features(payload)["transforms"] == [2, 0]
    br = vp8l.BitReader(payload, 40 + 3 + 6)  # past subtract-green's and the predictor's
    modes = vp8l.decode_image_native(br, 6, 6, False)  # 16x16 tiles
    assert len(np.unique((modes >> 8) & 0xF)) > 1
    kinds, _, _ = vp8l.backward_refs_native(vp8l.decode(payload).reshape(-1), 96, 0)
    assert (kinds == 1).sum() > 0
    assert len(payload) < 0.75 * image.size
    few = _images(33, 65, 14)["few"]  # 5 colours: a palette, 4 bits a pixel
    features = webp_oracle.lossless_features(webp.encode(few)[20:])
    assert features["transforms"] == [3] and features["palette"] == 5


# ------------------------------------------------------ the CLI, datasets

def _tiny_config(tmp_path):
    from orienmask_tpu_torch.config import coco_visualizer
    from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as cfg

    size = 64
    config = json.loads(json.dumps(cfg))
    config["model"].update(backbone_stage_blocks=[1, 1, 1, 1, 1], pretrained=None)
    config["transform"]["pipeline"][0]["size"] = [size, size]
    config["postprocess"].update(grid_size=[[size // 32] * 2, [size // 16] * 2,
                                            [size // 8] * 2], image_size=[size, size])
    config.update(compute_dtype="float32", visualizer=dict(coco_visualizer, conf_thresh=0.0))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(config))
    return path


def test_infer_cli_reads_and_writes_webp(tmp_path):
    """-i x.webp -v -o writes x.webp, which cv2 reads as the drawing; -d
    over lossy, lossless and animated WebP draws each under its name."""
    from orienmask_tpu_torch import infer

    images = tmp_path / "images"
    images.mkdir()
    (images / "a.webp").write_bytes(_cv2_webp(_scene(48, 64, 1), cv2.IMWRITE_WEBP_QUALITY, 90))
    (images / "b.webp").write_bytes(_cv2_webp(_scene(40, 56, 2)))
    (images / "c.webp").write_bytes((FIXTURES / "webp_animated.webp").read_bytes())
    written = []
    real = infer.write_image

    def keep(path, image):
        written.append((os.path.basename(path), image.copy()))
        real(path, image)

    config = str(_tiny_config(tmp_path))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(infer, "write_image", keep)
        assert infer.main(["--device", "cpu", "-c", config, "--random-weights", "-i",
                           str(images / "a.webp"), "-v", "-o", str(tmp_path / "one")]) == 0
        assert infer.main(["--device", "cpu", "-c", config, "--random-weights", "-d",
                           str(images), "-v", "-o", str(tmp_path / "all")]) == 0
    assert [n for n, _ in written] == ["a.webp", "a.webp", "b.webp", "c.webp"]
    outs = [tmp_path / "one" / "a.webp"] + [tmp_path / "all" / n for n in ("a.webp", "b.webp",
                                                                           "c.webp")]
    for out, (name, drawing) in zip(outs, written):
        assert webp.info(out.read_bytes())["kind"] == "VP8L"
        np.testing.assert_array_equal(cv2.cvtColor(cv2.imread(str(out)), cv2.COLOR_BGR2RGB),
                                      drawing, err_msg=name)
        np.testing.assert_array_equal(read_image(out), drawing)


def test_coco_dataset_reads_webp_as_jax_does(tmp_path):
    """The port's COCODataset over a dataset whose images are WebP (lossy
    and lossless) gives the JAX dataset's samples (which read through
    cv2.imread)."""
    from orienmask_tpu.data.dataset import COCODataset as JaxCOCODataset
    from orienmask_tpu_torch.data import COCODataset
    from orienmask_tpu_torch.utils.mini_dataset import write_mini_dataset

    paths = write_mini_dataset(tmp_path / "mini", 4, ((48, 64), (43, 61)), seed=0)
    image_dir = Path(paths["image_dir"])
    names = Path(paths["list_file"]).read_text().split()
    for i, name in enumerate(names):
        image = read_image(image_dir / name)
        params = [cv2.IMWRITE_WEBP_QUALITY, 85] if i % 2 else []
        (image_dir / name.replace(".png", ".webp")).write_bytes(_cv2_webp(image, *params))
        (image_dir / name).unlink()
    Path(paths["list_file"]).write_text("\n".join(n.replace(".png", ".webp") for n in names))
    anno = json.loads(Path(paths["anno_file"]).read_text())
    Path(paths["anno_file"]).write_text(json.dumps(
        {k.replace(".png", ".webp"): v for k, v in anno.items()}))
    args = (paths["list_file"], paths["image_dir"], paths["anno_file"])
    got, want = COCODataset(*args), JaxCOCODataset(*args)
    assert len(got) == len(want) == 4
    for i in range(4):
        for key in ("image", "bbox", "cls"):
            np.testing.assert_array_equal(got[i][key], want[i][key], err_msg=f"{i} {key}")
