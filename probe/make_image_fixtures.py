"""Write the BMP and TIFF fixtures of ``tests/image_fixtures/``: seeded
smooth scenes (``make_jpeg_fixtures.py::scene``) at 240x320 in forms that
neither the port's writers nor the card's machine make: an RLE8 BMP (the
scene quantized to 256 colours by PIL), a PackBits TIFF (PIL's writer) and a
tiled Deflate TIFF with the horizontal predictor (64x64 tiles, the edge
tiles padded; ``tests/test_torch_bmp_tiff.py::_tiff``).  ``digests.json``
holds each file's shape and the SHA-256 of ``cv2.cvtColor(cv2.imread(f),
COLOR_BGR2RGB)``.

``chip_smoke.py`` (phase 23) feeds them to the infer CLI on the card's
machine, which has no cv2 or PIL; ``tests/test_torch_bmp_tiff.py`` holds
the port's reads and the digests to cv2 on every run.

Run from the repository root on a machine with cv2 and PIL:
``python3 probe/make_image_fixtures.py``.
"""

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "image_fixtures"
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "probe")]
from make_jpeg_fixtures import scene  # noqa: E402
from test_torch_bmp_tiff import _bmp, _tiff  # noqa: E402

SIZE = (240, 320)


def rle8(indices):
    """RLE8 of (H, W) palette indices, bottom row first: runs of 2 or more
    as encoded runs, the rest as absolute runs (at least 3 long, padded to
    16 bits) or single encoded runs; an end of line after each row and an
    end of bitmap after the last."""
    out = bytearray()
    for row in indices[::-1].tolist():
        x, w = 0, len(row)
        while x < w:
            n = 1
            while x + n < w and n < 255 and row[x + n] == row[x]:
                n += 1
            if n >= 2:
                out += bytes([n, row[x]])
                x += n
                continue
            end = x + 1
            while end < w and end - x < 255 and (end + 1 >= w or row[end] != row[end + 1]):
                end += 1
            if end - x >= 3:
                out += bytes([0, end - x]) + bytes(row[x:end]) + bytes((end - x) % 2)
            else:
                out += b"".join(bytes([1, v]) for v in row[x:end])
            x = end
        out += b"\x00\x00"
    return bytes(out[:-2]) + b"\x00\x01"


def rgb_digest(path):
    image = cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)
    return list(image.shape), hashlib.sha256(image.tobytes()).hexdigest()


def main():
    OUT.mkdir(exist_ok=True)
    h, w = SIZE
    quantized = Image.fromarray(scene(21, h, w)).quantize(256, dither=Image.Dither.NONE)
    palette = np.array(quantized.getpalette()[:768], np.uint8).reshape(256, 3)
    files = {"rle8.bmp": _bmp(w, h, 8, rle8(np.asarray(quantized)), compression=1,
                              palette=palette)}
    buf = io.BytesIO()
    Image.fromarray(scene(22, h, w)).save(buf, "TIFF", compression="packbits")
    files["packbits.tif"] = buf.getvalue()
    files["tiled_deflate.tif"] = _tiff(scene(23, h, w), 2, compression=8, predictor=2,
                                       tile=(64, 64))
    path = OUT / "digests.json"  # make_webp_fixtures.py keeps its entries here too
    digests = json.loads(path.read_text()) if path.exists() else {}
    for name, data in files.items():
        (OUT / name).write_bytes(data)
        shape, digest = rgb_digest(OUT / name)
        digests[name] = {"shape": shape, "sha256": digest}
    path.write_text(json.dumps(digests, indent=1) + "\n")
    assert struct.unpack("<I", files["rle8.bmp"][30:34])[0] == 1  # BI_RLE8
    total = sum(p.stat().st_size for p in OUT.iterdir())
    print(f"{len(files)} fixtures, {total} bytes in {OUT.relative_to(ROOT)}/")


if __name__ == "__main__":
    main()
