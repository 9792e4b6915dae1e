"""Write the WebP fixtures of ``tests/image_fixtures/`` and their cv2 pixel
digests in ``digests.json`` (beside the BMP and TIFF ones).

Seeded smooth scenes (``make_jpeg_fixtures.py::scene``) in the forms a user
meets: cv2's lossless default (VP8L) and its lossy VP8 at qualities 50 and
95, an extended file with an ``ALPH`` chunk (PIL, lossy with alpha), a
3-frame animation (PIL), a 16x24 lossless file whose EXIF says orientation
6 (PIL), an odd 33x65 size; and the encoder settings neither cv2 nor PIL
can choose, through the system libwebp (``tests/webp_oracle.py``): the
simple loop filter, 8 token partitions with 4 segments and sharpness 7
(libwebp writes one partition at methods 3-6, so that file is method 2);
and two lossless files whose content makes libwebp choose a colour cache
and 2-bit palette bundling.
``webp_480x640_q95.webp`` is the 480x640 scene that ``chip_smoke.py``
phase 24 times the VP8 read on.  Each entry of ``digests.json`` holds the
shape, the SHA-256 of ``cv2.cvtColor(cv2.imread(f), COLOR_BGR2RGB)`` and
the file's form.

``chip_smoke.py`` (phase 24) reads them on the card's machine, which has
no cv2, PIL or libwebp; ``tests/test_torch_webp.py`` holds the port's
reads and the digests to cv2 on every run.

Run from the repository root on a machine with cv2, PIL and libwebp:
``python3 probe/make_webp_fixtures.py``.
"""

import hashlib
import io
import json
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "image_fixtures"
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "probe")]
from make_jpeg_fixtures import scene  # noqa: E402

import webp_oracle  # noqa: E402
from orienmask_tpu_torch.data import vp8, webp  # noqa: E402


def cv2_webp(image, *params):
    ok, buf = cv2.imencode(".webp", image[..., ::-1], list(params))
    assert ok
    return buf.tobytes()


def pil_webp(image, **kw):
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "WEBP", **kw)
    return buf.getvalue()


def animation(frames):
    buf = io.BytesIO()
    first, *rest = (Image.fromarray(f) for f in frames)
    first.save(buf, "WEBP", save_all=True, append_images=rest, duration=100, lossless=True)
    return buf.getvalue()


def with_orientation(image, orientation):
    exif = Image.Exif()
    exif[0x0112] = orientation
    return pil_webp(image, lossless=True, exif=exif.tobytes())


def fixtures():
    """name -> the file's bytes (the 7 files of phase 24 (a) first)."""
    rgba = np.dstack([scene(44, 72, 96), np.linspace(0, 255, 72 * 96).reshape(72, 96).astype(
        np.uint8)])
    return {
        "webp_vp8l.webp": cv2_webp(scene(41, 120, 160)),
        "webp_vp8_q50.webp": cv2_webp(scene(42, 120, 160), cv2.IMWRITE_WEBP_QUALITY, 50),
        "webp_vp8_q95.webp": cv2_webp(scene(43, 120, 160), cv2.IMWRITE_WEBP_QUALITY, 95),
        "webp_vp8x_alpha.webp": pil_webp(rgba, quality=80),
        "webp_animated.webp": animation([scene(45 + i, 64, 80) for i in range(3)]),
        "webp_exif_6.webp": with_orientation(scene(48, 16, 24), 6),
        "webp_odd_33x65.webp": cv2_webp(scene(49, 33, 65), cv2.IMWRITE_WEBP_QUALITY, 75),
        "webp_simple_filter.webp": webp_oracle.encode(scene(50, 48, 64), quality=60,
                                                      filter_type=0, filter_strength=60),
        "webp_parts8_seg4_sharp7.webp": webp_oracle.encode(
            scene(51, 80, 96), quality=40, method=2, partitions=3, segments=4,
            filter_sharpness=7, sns_strength=100),
        "webp_480x640_q95.webp": cv2_webp(scene(52, 480, 640), cv2.IMWRITE_WEBP_QUALITY, 95),
        # lossless forms libwebp picks by content: a colour cache for sparse
        # dots on white, 2-bit bundled palette indices for three colours
        "webp_vp8l_cache.webp": cv2_webp(dots(53, 96, 96)),
        "webp_vp8l_palette.webp": cv2_webp(three_colours(54, 40, 50)),
    }


def dots(seed, height, width):
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    return np.where(rng.random((height, width, 1)) < 0.1, colours, 255).astype(np.uint8)


def three_colours(seed, height, width):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (3, 3), dtype=np.uint8)[rng.integers(0, 3, (height, width))]


def form(data):
    """What a test reads off a fixture: the container's form and, for a
    lossy bitstream, its filter, partitions and segmentation; for a
    lossless one its transforms, colour cache and meta prefix codes."""
    out = webp.info(data)
    i = data.find(b"VP8 ")
    if i >= 0 and out["kind"] != "VP8L" and not out["animated"]:
        f = vp8.parse_header(data[i + 8:])
        out.update(filter_type=int(f.filter_type), partitions=int(f.n_parts),
                   segment_map=int(f.update_map))
    if out["kind"] == "VP8L":
        out.update(webp_oracle.lossless_features(data[20:]))
    return out


def rgb_digest(path):
    image = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
    return list(image.shape), hashlib.sha256(image.tobytes()).hexdigest()


def main():
    OUT.mkdir(exist_ok=True)
    path = OUT / "digests.json"
    digests = json.loads(path.read_text()) if path.exists() else {}
    files = fixtures()
    for name, data in files.items():
        (OUT / name).write_bytes(data)
        shape, digest = rgb_digest(OUT / name)
        digests[name] = {"shape": shape, "sha256": digest, "form": form(data)}
        print(name, len(data), digests[name]["form"])
    path.write_text(json.dumps(digests, indent=1) + "\n")
    assert digests["webp_exif_6.webp"]["shape"] == [24, 16, 3]
    assert digests["webp_parts8_seg4_sharp7.webp"]["form"]["partitions"] == 8
    assert digests["webp_simple_filter.webp"]["form"]["filter_type"] == 1
    total = sum(len(d) for d in files.values())
    print(f"{len(files)} WebP fixtures, {total} bytes in {OUT.relative_to(ROOT)}/")
    writer_sizes()


def writer_sizes():
    """The port's VP8L writer against cv2.imwrite's lossless bytes: phase
    24's seeded 480x640 scene and the fixtures' scenes."""
    from orienmask_tpu_torch.utils.mini_dataset import make_scene

    images = {"phase 24's 480x640 scene": make_scene(np.random.default_rng(24), 480, 640,
                                                     0, 80, 1)[0],
              "scene 41 at 120x160": scene(41, 120, 160),
              "dots at 96x96": dots(53, 96, 96),
              "three colours at 40x50": three_colours(54, 40, 50)}
    for name, image in images.items():
        ours, theirs = len(webp.encode(image)), len(cv2_webp(image))
        print(f"VP8L writer, {name}: {ours} bytes against cv2's {theirs} "
              f"({ours / theirs:.3f}x)")


if __name__ == "__main__":
    main()
