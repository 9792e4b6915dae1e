"""Write the JPEG fixtures of ``probe/jpeg_fixtures/``: seeded smooth scenes
(shapes with soft edges and gradients, a little noise, so that they compress
as photographs do) written by cv2, which the JAX package reads and writes
images with, in the forms COCO-style inputs take; ``digests.json`` holds each
file's decoded shape and the SHA-256 of ``cv2.cvtColor(cv2.imread(f),
COLOR_BGR2RGB)``, and ``images.json`` lists them in COCO's ``images`` form
(for the infer CLI's ``-j``).

``chip_smoke.py`` (phase 15) decodes them with the port's decoder on the
card's machine, which has no cv2, and holds each to its digest;
``tests/test_torch_jpeg.py`` holds the digests to cv2 on every run, so they
cannot go stale.

Run from the repository root on a machine with cv2:
``python3 probe/make_jpeg_fixtures.py``.
"""

import hashlib
import json
import struct
from pathlib import Path

import cv2
import numpy as np

OUT = Path(__file__).resolve().parent / "jpeg_fixtures"
F = cv2.IMWRITE_JPEG_SAMPLING_FACTOR
# name: (seed, (height, width), cv2 parameters, EXIF orientation or None)
FIXTURES = {
    "000000000001.jpg": (1, (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 95,
                                         F, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420], None),
    "000000000002.jpg": (2, (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 75,
                                         F, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422], None),
    "000000000003.jpg": (3, (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 50,
                                         F, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444], None),
    "000000000004.jpg": (4, (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 100,
                                         F, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440], None),
    "000000000005.jpg": (5, (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 85,
                                         cv2.IMWRITE_JPEG_PROGRESSIVE, 1], None),
    "000000000006.jpg": (6, (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 90,
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, 4], None),
    "000000000007.jpg": (7, (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 80], "grey"),
    "000000000008.jpg": (8, (427, 613), [cv2.IMWRITE_JPEG_QUALITY, 70], None),
    "000000000009.jpg": (9, (480, 640), [cv2.IMWRITE_JPEG_QUALITY, 90], 6),
}


def scene(seed, height, width):
    """A seeded smooth scene: a sky-to-ground gradient, soft ellipses and
    boxes of graded colour, a light texture, blurred, with sensor noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:height, 0:width].astype(np.float32)
    top, bottom = rng.uniform(40, 220, 3), rng.uniform(20, 200, 3)
    image = top + (bottom - top) * (y / height)[..., None]
    for _ in range(int(rng.integers(4, 9))):
        cy, cx = rng.uniform(0, height), rng.uniform(0, width)
        ry = rng.uniform(min(20, height / 4), height / 3)
        rx = rng.uniform(min(20, width / 4), width / 3)
        colour = rng.uniform(0, 255, 3)
        shade = 0.7 + 0.3 * np.cos((x - cx) / rx + (y - cy) / ry)[..., None]
        if rng.random() < 0.5:
            inside = ((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2 < 1
        else:
            inside = (np.abs(y - cy) < ry) & (np.abs(x - cx) < rx)
        image = np.where(inside[..., None], colour * shade, image)
    image += 6 * (np.sin(x / rng.uniform(3, 9)) * np.cos(y / rng.uniform(3, 9)))[..., None]
    image = cv2.GaussianBlur(image.astype(np.float32), (0, 0), 1.5)
    image += rng.normal(0, 2.5, image.shape)
    return np.clip(np.round(image), 0, 255).astype(np.uint8)


def with_exif(data, orientation, order=b"MM"):
    """``data`` (a JPEG from cv2, which writes no EXIF) with an APP1 Exif
    segment holding orientation tag 0x0112, in byte order ``order``
    (``b"II"`` or ``b"MM"``), after its first segment."""
    e = "<" if order == b"II" else ">"
    tiff = order + struct.pack(e + "HI", 42, 8)
    tiff += struct.pack(e + "H", 1) + struct.pack(e + "HHIH", 0x0112, 3, 1, orientation)
    tiff += b"\x00\x00" + struct.pack(e + "I", 0)
    payload = b"Exif\x00\x00" + tiff
    app1 = b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload
    first_end = 4 + struct.unpack(">H", data[4:6])[0]  # SOI, then APP0
    return data[:first_end] + app1 + data[first_end:]


def rgb_digest(path):
    image = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
    return list(image.shape), hashlib.sha256(image.tobytes()).hexdigest()


def main():
    OUT.mkdir(exist_ok=True)
    digests, images = {}, []
    for i, (name, (seed, (h, w), params, extra)) in enumerate(FIXTURES.items()):
        rgb = scene(seed, h, w)
        if extra == "grey":
            pixels = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)
        else:
            pixels = rgb[..., ::-1]
        ok, encoded = cv2.imencode(".jpg", pixels, params)
        assert ok
        data = encoded.tobytes()
        if isinstance(extra, int):
            data = with_exif(data, extra)
        (OUT / name).write_bytes(data)
        shape, digest = rgb_digest(OUT / name)
        digests[name] = {"shape": shape, "sha256": digest}
        images.append({"file_name": name, "height": shape[0], "width": shape[1], "id": i + 1})
    (OUT / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")
    (OUT / "images.json").write_text(json.dumps({"images": images}, indent=1) + "\n")
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(FIXTURES)} fixtures, {total} bytes in {OUT.name}/")


if __name__ == "__main__":
    main()
