"""The port's BMP and TIFF readers (``data/bmp.py``, ``data/tiff.py``,
through ``data/image_io.py::read_image``) against ``cv2.imread`` +
``cvtColor(BGR2RGB)``, which the JAX CLI and datasets read with, by bits.

Files come from cv2 and PIL where they write the form, and from the small
writers below where they do not (RLE, 16-bit BMPs, OS/2 headers; TIFF
tiles, planar samples, big-endian files, 1- and 16-bit grey, MinIsWhite,
palettes with 8- and 16-bit colour maps, alpha).  The forms refused are
refused with ``UnsupportedImage`` naming the form and a ROADMAP item.
cv2's RLE4 reader reads ahead of the data, so the RLE files carry 64
trailing zero bytes (the port reads them with or without)."""

import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from orienmask_tpu_torch.data import tiff
from orienmask_tpu_torch.data.image_io import UnsupportedImage, read_image


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _check(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    bgr = cv2.imread(str(path))
    assert bgr is not None, f"cv2 cannot read {name}"
    np.testing.assert_array_equal(read_image(path), cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))


def _noise(h, w, c=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, c), dtype=np.uint8)


# -------------------------------------------------------------------- BMP


def _bmp(width, height, bits, pixels, compression=0, palette=None, used=0, masks=None,
         header=40):
    """A BMP of ``pixels`` (the rows' bytes as stored) with a Windows header
    of ``header`` bytes, or the OS/2 core header (12)."""
    if header == 12:
        head = struct.pack("<IHHHH", 12, width, height, 1, bits)
        pal = b"" if palette is None else bytes(np.asarray(palette, np.uint8)[:, ::-1].tobytes())
    else:
        head = struct.pack("<IiiHHIIiiII", header, width, height, 1, bits, compression, 0, 0, 0,
                           used, 0) + bytes(header - 40)
        pal = b"" if palette is None else b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    extra = b"" if masks is None else struct.pack("<III", *masks)
    body = head + extra + pal
    return (struct.pack("<2sIHHI", b"BM", 14 + len(body) + len(pixels), 0, 0, 14 + len(body))
            + body + pixels)


def _rows(values, bits, width):
    """Palette indices (or 16-bit words) packed into 4-byte-padded rows."""
    pitch = ((width * bits + 7) // 8 + 3) & -4
    out = b""
    for row in values:
        if bits == 16:
            packed = row.astype("<u2").tobytes()
        else:
            shifts = np.arange(bits - 1, -1, -1)
            packed = np.packbits(((row[:, None] >> shifts) & 1).astype(np.uint8)).tobytes()
        out += packed + bytes(pitch - len(packed))
    return out


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_bmp_written_by_pil(tmp_path, mode):
    """1-bit, 8-bit grey and palette, 24- and 32-bit files as PIL writes them."""
    buf = io.BytesIO()
    Image.fromarray(_noise(13, 11)).convert(mode).save(buf, "BMP")
    _check(tmp_path, "a.bmp", buf.getvalue())


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_bmp_written_by_opencv(tmp_path, channels):
    image = _noise(13, 11, channels)
    _check(tmp_path, "a.bmp", cv2.imencode(".bmp", image[..., 0] if channels == 1 else image)[1]
           .tobytes())


@pytest.mark.parametrize("layout", ["bottom_up", "top_down", "os2"])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bmp_palette_images(tmp_path, bits, layout):
    """Every palette depth, in Windows files of either row order and OS/2
    files (whose unsigned height is always bottom-up); a short palette (an
    index past it reads black)."""
    rng = np.random.default_rng(bits)
    n = 1 << bits
    palette = rng.integers(0, 256, (n, 3))
    header = 12 if layout == "os2" else 40
    used = 0 if header == 12 or bits == 1 else n - 3
    idx = rng.integers(0, n, (7, 13))
    data = _bmp(13, -7 if layout == "top_down" else 7, bits, _rows(idx, bits, 13),
                palette=palette if used == 0 else palette[:used], used=used, header=header)
    _check(tmp_path, "a.bmp", data)


@pytest.mark.parametrize("form", ["555_rgb", "555_bitfields", "565_bitfields"])
def test_bmp_16_bit(tmp_path, form):
    words = np.random.default_rng(16).integers(0, 65536, (5, 9))
    masks = {"555_rgb": None, "555_bitfields": (0x7C00, 0x3E0, 0x1F),
             "565_bitfields": (0xF800, 0x7E0, 0x1F)}[form]
    data = _bmp(9, 5, 16, _rows(words, 16, 9), compression=0 if masks is None else 3,
                masks=masks)
    _check(tmp_path, "a.bmp", data)


@pytest.mark.parametrize("form", ["24_top_down", "24_os2", "32_bitfields", "32_v5_header"])
def test_bmp_24_and_32_bit(tmp_path, form):
    rng = np.random.default_rng(24)
    if form.startswith("24"):
        pixels = b"".join(r.tobytes() + bytes(3) for r in rng.integers(0, 256, (5, 9, 3),
                                                                        dtype=np.uint8))
        data = _bmp(9, -5 if form == "24_top_down" else 5, 24, pixels,
                    header=12 if form == "24_os2" else 40)
    else:
        pixels = rng.integers(0, 256, (5, 9, 4), dtype=np.uint8).tobytes()
        data = _bmp(9, 5, 32, pixels, compression=3 if form == "32_bitfields" else 0,
                    masks=(0xFF0000, 0xFF00, 0xFF) if form == "32_bitfields" else None,
                    header=124 if form == "32_v5_header" else 40)
    _check(tmp_path, "a.bmp", data)


# RLE streams of a 10x6 image: (length, code) pairs and escapes
_RLE8 = [
    3, 5, 0, 4, 1, 2, 3, 4, 3, 9, 0, 0,  # run, absolute (4), run ending the line, EOL
    2, 7, 0, 2, 2, 1, 0, 0,  # run, delta (2, 1), EOL
    10, 8, 0, 0,  # a run that fills its line, then an EOL that adds nothing
    0, 3, 1, 2, 3, 0, 4, 6, 0, 1,  # absolute (3, padded), run, end of bitmap
]
_RLE4 = [
    5, 0x12, 0, 5, 0x34, 0x56, 0x70, 0, 0, 0,  # run, absolute (5 nibbles, padded), EOL
    2, 0x11, 0, 2, 3, 1, 4, 0xAB, 0, 0,  # run, delta (3, 1: OpenCV moves by dx alone), run, EOL
    6, 0xCD, 0, 1,  # run, end of bitmap
]


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("kind", ["rle8", "rle4"])
def test_bmp_rle(tmp_path, kind, top_down):
    rng = np.random.default_rng(8)
    four = kind == "rle4"
    palette = rng.integers(0, 256, (16 if four else 256, 3))
    data = _bmp(10, -6 if top_down else 6, 4 if four else 8,
                bytes(_RLE4 if four else _RLE8) + bytes(64), compression=2 if four else 1,
                palette=palette)
    _check(tmp_path, "a.bmp", data)


def test_bmp_rle_reads_without_trailing_bytes(tmp_path):
    palette = np.random.default_rng(9).integers(0, 256, (16, 3))
    path = tmp_path / "a.bmp"
    path.write_bytes(_bmp(10, 6, 4, bytes(_RLE4), compression=2, palette=palette))
    padded = tmp_path / "b.bmp"
    padded.write_bytes(_bmp(10, 6, 4, bytes(_RLE4) + bytes(64), compression=2, palette=palette))
    np.testing.assert_array_equal(read_image(path), read_image(padded))


# ------------------------------------------------------------------- TIFF


def _packbits(data):
    """PackBits of ``data``: runs of 3 or more repeated, the rest literal."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        j = i
        while j < len(data) and j - i < 128 and not (
                j + 2 < len(data) and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff(samples, photometric, bits=8, order="<", compression=1, predictor=1, planar=1,
          tile=None, rps=None, extra=None, colormap=None, sample_format=None):
    """A one-page TIFF of (H, W, spp) ``samples`` (values below 2**bits)."""
    h, w, spp = samples.shape
    dtype = np.dtype(order + "u2") if bits == 16 else np.uint8

    def chunk(block):
        """(rows, cols, n) samples -> the chunk's compressed bytes."""
        block = block.astype(np.int64)
        if predictor == 2:
            block = block.copy()
            block[:, 1:] = (block[:, 1:] - block[:, :-1]) % (1 << bits)
        rows = []
        for row in block.reshape(len(block), -1):
            if bits >= 8:
                rows.append(row.astype(dtype).tobytes())
            else:
                shifts = np.arange(bits - 1, -1, -1)
                rows.append(np.packbits(((row[:, None] >> shifts) & 1).astype(np.uint8))
                            .tobytes())
        raw = b"".join(rows)
        return {1: raw, 5: tiff.lzw_encode(raw), 8: zlib.compress(raw), 32946: zlib.compress(raw),
                32773: _packbits(raw), 7: raw, 32771: raw}[compression]

    planes = [samples[..., p:p + 1] for p in range(spp)] if planar == 2 else [samples]
    chunks = []
    if tile:
        th, tw = tile
        for plane in planes:
            padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw, plane.shape[2]), np.int64)
            padded[:h, :w] = plane
            chunks += [chunk(padded[y:y + th, x:x + tw]) for y in range(0, h, th)
                       for x in range(0, w, tw)]
    else:
        rps = rps or h
        chunks = [chunk(plane[y:y + rps]) for plane in planes for y in range(0, h, rps)]
    body = bytearray((b"II*\x00" if order == "<" else b"MM\x00*") + bytes(4))
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c
    tags = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [compression]),
            (262, 3, [photometric]), (277, 3, [spp]), (284, 3, [planar])]
    if tile:
        tags += [(322, 3, [tile[1]]), (323, 3, [tile[0]]), (324, 4, offsets),
                 (325, 4, [len(c) for c in chunks])]
    else:
        tags += [(273, 4, offsets), (278, 4, [rps]), (279, 4, [len(c) for c in chunks])]
    if predictor != 1:
        tags.append((317, 3, [predictor]))
    if colormap is not None:
        tags.append((320, 3, list(np.asarray(colormap).T.reshape(-1))))
    if extra is not None:
        tags.append((338, 3, [extra]))
    if sample_format is not None:
        tags.append((339, 3, [sample_format] * spp))
    tags.sort()
    ifd_at = len(body) + len(body) % 2
    body += bytes(len(body) % 2)
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    entries, spill = b"", b""
    for number, kind, values in tags:
        payload = struct.pack(order + ("H" if kind == 3 else "I") * len(values),
                              *[int(v) for v in values])
        if len(payload) <= 4:
            field = payload.ljust(4, b"\x00")
        else:
            field = struct.pack(order + "I", extra_at + len(spill))
            spill += payload
        entries += struct.pack(order + "HHI", number, kind, len(values)) + field
    body[4:8] = struct.pack(order + "I", ifd_at)
    return bytes(body + struct.pack(order + "H", len(tags)) + entries + bytes(4) + spill)


def test_tiff_written_by_opencv(tmp_path):
    """LZW with the predictor, at 8 and 16 bits, colour, grey and alpha."""
    image = _noise(37, 53)
    for name, array in (("rgb", image), ("grey", image[..., 0]),
                        ("rgba", np.dstack([image, image[..., :1]])),
                        ("rgb16", image.astype(np.uint16) * 257 + 3),
                        ("grey16", image[..., 0].astype(np.uint16) * 251)):
        _check(tmp_path, f"{name}.tif", cv2.imencode(".tif", array)[1].tobytes())


@pytest.mark.parametrize("compression", ["raw", "packbits", "tiff_lzw", "tiff_deflate",
                                         "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "LA", "I;16", "I;16B"])
def test_tiff_written_by_pil(tmp_path, mode, compression):
    """Each of PIL's modes in each of its compressions (RGBA and LA carry an
    unassociated alpha: libtiff premultiplies RGB by it, and drops it from
    grey)."""
    image = _noise(37, 53, seed=len(mode))
    if mode == "I;16":
        im = Image.fromarray(image[..., 0].astype(np.uint16) * 257 + 1)
    elif mode == "I;16B":
        im = Image.frombytes("I;16B", (53, 37), (image[..., 0].astype(">u2") * 200).tobytes())
    else:
        im = Image.fromarray(image).convert(mode)
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression=compression)
    _check(tmp_path, "a.tif", buf.getvalue())


_LAYOUTS = {
    "strips_big_endian": dict(order=">", rps=5),
    "tiles": dict(tile=(16, 16)),
    "tiles_planar_big_endian": dict(tile=(16, 32), planar=2, order=">"),
    "strips_planar": dict(planar=2, rps=7),
}


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_tiff_layouts(tmp_path, layout, compression):
    """Strips and tiles, chunky and planar, both byte orders, each
    compression; the predictor with LZW and Deflate."""
    samples = _noise(37, 53, seed=compression)
    predictor = 2 if compression in (5, 8) else 1
    _check(tmp_path, "a.tif", _tiff(samples, 2, compression=compression, predictor=predictor,
                                    **_LAYOUTS[layout]))


@pytest.mark.parametrize("order", ["<", ">"], ids=["little", "big"])
@pytest.mark.parametrize("form", ["rgb16_predictor", "rgb16_tiles", "rgb16_unassociated_alpha",
                                  "rgb_associated_alpha", "rgb_unassociated_alpha_planar"])
def test_tiff_16_bit_and_alpha(tmp_path, form, order):
    rng = np.random.default_rng(17)
    if form.startswith("rgb16"):
        samples = rng.integers(0, 65536, (21, 19, 4 if "alpha" in form else 3))
        kw = dict(bits=16, compression=5 if "predictor" in form else 8,
                  predictor=2 if "predictor" in form else 1,
                  tile=(16, 16) if "tiles" in form else None,
                  extra=2 if "alpha" in form else None)
    else:
        samples = rng.integers(0, 256, (21, 19, 4))
        kw = dict(extra=1 if "associated" in form and "un" not in form else 2,
                  planar=2 if "planar" in form else 1)
    _check(tmp_path, "a.tif", _tiff(samples, 2, order=order, **kw))


@pytest.mark.parametrize("white", [False, True], ids=["min_is_black", "min_is_white"])
@pytest.mark.parametrize("bits", [1, 8, 16])
def test_tiff_grey(tmp_path, bits, white):
    samples = np.random.default_rng(bits).integers(0, 1 << bits, (13, 19, 1))
    _check(tmp_path, "a.tif", _tiff(samples, 0 if white else 1, bits=bits, compression=8,
                                    predictor=2 if bits >= 8 else 1, rps=4))


@pytest.mark.parametrize("wide", [False, True], ids=["8bit_map", "16bit_map"])
@pytest.mark.parametrize("bits", [1, 8])
def test_tiff_palette(tmp_path, bits, wide):
    """A colour map's 16-bit entries are read by their high byte; a map
    whose entries are all below 256 as 8-bit values, as libtiff does."""
    rng = np.random.default_rng(bits)
    colormap = rng.integers(0, 65536 if wide else 256, (1 << bits, 3))
    samples = rng.integers(0, 1 << bits, (13, 19, 1))
    _check(tmp_path, "a.tif", _tiff(samples, 3, bits=bits, colormap=colormap, compression=32773))


@pytest.mark.parametrize("form,why", [
    (dict(photometric=2, compression=7), "a JPEG-compressed TIFF"),
    (dict(photometric=5, spp=4), "a CMYK TIFF"),
    (dict(photometric=6), "a YCbCr TIFF"),
    (dict(photometric=2, sample_format=3), "floating-point samples"),
    (dict(photometric=2, compression=32771), "compression 32771"),
    (dict(photometric=1, spp=1, bits=4), "at \\(4,\\) bits"),
], ids=["jpeg", "cmyk", "ycbcr", "float", "other_compression", "4_bit_grey"])
def test_tiff_refused_forms_name_the_form(tmp_path, form, why):
    form = dict(form)
    samples = _noise(8, 8, form.pop("spp", 3)) >> (8 - form.get("bits", 8))
    path = tmp_path / "a.tif"
    path.write_bytes(_tiff(samples, form.pop("photometric"), **form))
    with pytest.raises(UnsupportedImage, match=why) as err:
        read_image(path)
    assert "ROADMAP Queue 1 item 1" in str(err.value)


FIXTURES = Path(__file__).resolve().parent / "image_fixtures"


@pytest.mark.parametrize("name", ["rle8.bmp", "packbits.tif", "tiled_deflate.tif"])
def test_committed_fixtures_read_as_opencv_reads_them(name):
    """``tests/image_fixtures`` (``probe/make_image_fixtures.py``), which the
    card's phase 23 reads without cv2: the port's read is cv2's here, and
    the digest recorded beside the file is of that read."""
    want = cv2.cvtColor(cv2.imread(str(FIXTURES / name)), cv2.COLOR_BGR2RGB)
    got = read_image(FIXTURES / name)
    np.testing.assert_array_equal(got, want)
    digest = json.loads((FIXTURES / "digests.json").read_text())[name]
    assert list(got.shape) == digest["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == digest["sha256"]


@pytest.mark.parametrize("name", ["rle8.bmp", "packbits.tif", "tiled_deflate.tif", "cv2.bmp",
                                  "cv2.tif"])
def test_truncated_files_are_refused(tmp_path, name):
    """A file cut short raises ``UnsupportedImage``, never another error."""
    if name.startswith("cv2"):
        data = cv2.imencode(name[3:], _noise(37, 53))[1].tobytes()
    else:
        data = (FIXTURES / name).read_bytes()
    path = tmp_path / name
    path.write_bytes(data[:len(data) // 3])
    with pytest.raises(UnsupportedImage, match="truncated|corrupt"):
        read_image(path)


@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_tiff_strip_shorter_than_its_rows_is_refused(tmp_path, compression):
    """A strip whose byte count holds fewer bytes than its rows need is
    refused (cv2 reads such a file with the strip black or half decoded)."""
    data = bytearray(_tiff(_noise(20, 16), 2, compression=compression, rps=5))
    ifd = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        tag, _, count, at = struct.unpack_from("<HHII", data, ifd + 2 + 12 * i)
        if tag == 279:  # halve the last strip's byte count
            last = at + 4 * (count - 1)
            struct.pack_into("<I", data, last, struct.unpack_from("<I", data, last)[0] // 2)
    path = tmp_path / "a.tif"
    path.write_bytes(bytes(data))
    with pytest.raises(UnsupportedImage, match="truncated or corrupt"):
        read_image(path)
