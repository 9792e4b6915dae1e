"""JPEG encoding without cv2 or PIL, byte for byte as ``cv2.imencode(".jpg")``
writes an RGB array after ``cvtColor(RGB2BGR)`` (libjpeg-turbo's defaults:
JFIF 1.01 APP0, 8-bit tables scaled to ``quality`` with force_baseline,
4:2:0 for colour, the standard Huffman tables of ``jstdhuff.c``, one
sequential scan, no restart markers).

The stages, libjpeg-turbo's, in numpy integer arithmetic:

* ``quant_table``: ``jcparam.c``'s quality scaling of the standard tables;
* ``rgb_to_ycc``: ``jccolor.c``'s fixed-point RGB->YCbCr (SCALEBITS 16, Cb
  and Cr rounded with ``ONE_HALF - 1``);
* ``component_blocks``: the edge replication of ``jcprepct.c`` and
  ``jcsample.c`` (the last column and row repeated out to whole blocks, the
  chroma planes' last row after their 2x2 downsampling with the
  alternating 1, 2 bias), ``jfdctint.c``'s ISLOW forward DCT and
  ``jcdctmgr.c``'s quantization by reciprocal, then ``jccoefct.c``'s dummy
  blocks where an MCU runs past the image (zero, with the DC of the block
  before them);
* the entropy coder (``jchuff.c``: DC differences, AC runs with ZRL and
  EOB, 0xFF stuffing, the last byte padded with 1-bits):
  ``encode_blocks_py`` is it written plainly, the spec; the one the writer
  runs is ``encode_blocks_native``, the same coder in C++
  (``csrc/jpeg_host.cc``), built with the host compiler at first use and
  loaded with ctypes (``kernels.host_library``).  It raises if it cannot
  be built; nothing falls back to the Python coder.

(H, W) uint8 arrays are written as one grey component, (H, W, 3) as colour.
"""

import struct

import numpy as np

from .jpeg import _FIX, CONST_BITS, PASS1_BITS, ZIGZAG

DEFAULT_QUALITY = 95  # cv2's IMWRITE_JPEG_QUALITY default
# the standard tables of the JPEG specification, Annex K (natural order)
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
CHROMA_QUANT = np.full(64, 99, np.int64)
CHROMA_QUANT[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = \
    [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# (class << 4 | id) -> (counts of codes of each length 1-16, symbols)
STD_HUFFMAN = {
    0x00: ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12))),
    0x10: ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125], bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272"
        "82090a161718191a25262728292a3435363738393a434445464748494a53545556575859"
        "5a636465666768696a737475767778797a838485868788898a92939495969798999aa2a3"
        "a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
        "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    0x01: ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], bytes(range(12))),
    0x11: ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119], bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d1"
        "0a162434e125f11718191a262728292a35363738393a434445464748494a535455565758"
        "595a636465666768696a737475767778797a82838485868788898a92939495969798999a"
        "a2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
        "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}


def quant_table(base, quality):
    """``jpeg_quality_scaling`` and ``jpeg_add_quant_table`` with
    force_baseline: the table (natural order) written at ``quality``."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _fix(x):
    return int(x * 65536 + 0.5)


def rgb_to_ycc(rgb):
    """``jccolor.c``'s rgb_ycc_convert: (H, W, 3) uint8 -> Y, Cb, Cr planes."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + offset + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + offset + half - 1) >> 16
    return y, cb, cr


def _replicate(plane, height, width):
    """``plane`` grown to (height, width) by repeating its last row and
    column (``expand_right_edge``, ``expand_bottom_edge``)."""
    h, w = plane.shape
    return np.pad(plane, ((0, height - h), (0, width - w)), mode="edge")


def downsample_h2v2(plane):
    """``jcsample.c``'s h2v2_downsample of an (even, even) plane: the 2x2
    sums plus the bias 1, 2, 1, 2, ... along each output row, >> 2."""
    h, w = plane.shape
    sums = plane.reshape(h // 2, 2, w // 2, 2).sum(axis=(1, 3))
    return (sums + 1 + (np.arange(w // 2) & 1)) >> 2


def fdct_islow(blocks):
    """``jpeg_fdct_islow`` of (N, 8, 8) level-shifted samples (int64): rows
    first, then columns; returns (N, 8, 8), eight times the DCT."""
    f = _FIX

    def one_pass(d, first):
        """The 1-D transform along the last axis of ``d``."""
        s = [d[..., i] for i in range(8)]
        tmp0, tmp7 = s[0] + s[7], s[0] - s[7]
        tmp1, tmp6 = s[1] + s[6], s[1] - s[6]
        tmp2, tmp5 = s[2] + s[5], s[2] - s[5]
        tmp3, tmp4 = s[3] + s[4], s[3] - s[4]
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        shift = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS

        def descale(x, n):
            return (x + (1 << (n - 1))) >> n

        out = [None] * 8
        if first:
            out[0], out[4] = (tmp10 + tmp11) << PASS1_BITS, (tmp10 - tmp11) << PASS1_BITS
        else:
            out[0], out[4] = descale(tmp10 + tmp11, PASS1_BITS), descale(tmp10 - tmp11, PASS1_BITS)
        z1 = (tmp12 + tmp13) * f["0_541196100"]
        out[2] = descale(z1 + tmp13 * f["0_765366865"], shift)
        out[6] = descale(z1 - tmp12 * f["1_847759065"], shift)
        z1, z2 = tmp4 + tmp7, tmp5 + tmp6
        z3, z4 = tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * f["1_175875602"]
        tmp4, tmp5 = tmp4 * f["0_298631336"], tmp5 * f["2_053119869"]
        tmp6, tmp7 = tmp6 * f["3_072711026"], tmp7 * f["1_501321110"]
        z1, z2 = z1 * -f["0_899976223"], z2 * -f["2_562915447"]
        z3, z4 = z3 * -f["1_961570560"] + z5, z4 * -f["0_390180644"] + z5
        out[7] = descale(tmp4 + z1 + z3, shift)
        out[5] = descale(tmp5 + z2 + z4, shift)
        out[3] = descale(tmp6 + z2 + z3, shift)
        out[1] = descale(tmp7 + z1 + z4, shift)
        return np.stack(out, axis=-1)

    rows = one_pass(blocks, True)
    return one_pass(rows.swapaxes(1, 2), False).swapaxes(1, 2)


def quantize(coefs, qtable):
    """``jcdctmgr.c``'s quantization of (N, 64) DCT outputs (natural order)
    by ``qtable`` * 8, with the reciprocal, correction and shift of
    ``compute_reciprocal`` (16-bit DCTELEM): sign(x) * ((|x| + c) * q >> r)."""
    divisor = qtable.astype(np.int64) * 8
    b = np.floor(np.log2(divisor)).astype(np.int64)
    r = 16 + b
    fq, fr = (1 << r) // divisor, (1 << r) % divisor
    c = divisor // 2
    power = fr == 0
    fq = np.where(power, fq >> 1, np.where(fr > divisor // 2, fq + 1, fq))
    r = np.where(power, r - 1, r)
    c = np.where(~power & (fr <= divisor // 2), c + 1, c)
    mag = ((np.abs(coefs) + c) * fq) >> r
    return np.where(coefs < 0, -mag, mag).astype(np.int16)


def _blocks(plane, bh, bw):
    """(bh * 8, bw * 8) plane -> (bh, bw, 64) blocks, natural order."""
    return plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(bh, bw, 64)


def component_blocks(image, quality):
    """The quantized blocks of ``image`` ((H, W) grey or (H, W, 3) RGB
    uint8) in the scan's MCU order: (N, 64) int16 (natural order), each
    block's component, and the quantization tables (natural order)."""
    height, width = image.shape[:2]
    tables = [quant_table(LUMA_QUANT, quality), quant_table(CHROMA_QUANT, quality)]
    if image.ndim == 2:
        bh, bw = -(-height // 8), -(-width // 8)
        plane = _replicate(image.astype(np.int64), bh * 8, bw * 8)
        coefs = quantize(fdct_islow(_blocks(plane, bh, bw).reshape(-1, 8, 8) - 128)
                         .reshape(-1, 64), tables[0])
        return coefs, np.zeros(len(coefs), np.uint8), tables[:1]
    mcuy, mcux = -(-height // 16), -(-width // 16)
    y, cb, cr = rgb_to_ycc(image)
    # luma: whole blocks by replication; blocks past them are dummies
    bh, bw = -(-height // 8), -(-width // 8)
    luma = quantize(fdct_islow(_blocks(_replicate(y, bh * 8, bw * 8), bh, bw)
                               .reshape(-1, 8, 8) - 128).reshape(-1, 64), tables[0])
    grid = np.zeros((2 * mcuy, 2 * mcux, 64), np.int16)
    grid[:bh, :bw] = luma.reshape(bh, bw, 64)
    if bw % 2:  # a right-edge dummy: the DC of the block to its left
        grid[:bh, bw, 0] = grid[:bh, bw - 1, 0]
    if bh % 2:  # a bottom row of dummies: the DC of the MCU's upper right block
        grid[bh, :, 0] = np.repeat(grid[bh - 1, 1::2, 0], 2)
    mcus = [grid.reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mcuy, mcux, 4, 64)]
    for plane in (cb, cr):
        full = _replicate(plane, height + height % 2, mcux * 16)
        small = _replicate(downsample_h2v2(full), mcuy * 8, mcux * 8)
        q = quantize(fdct_islow(_blocks(small, mcuy, mcux).reshape(-1, 8, 8) - 128)
                     .reshape(-1, 64), tables[1])
        mcus.append(q.reshape(mcuy, mcux, 1, 64))
    coefs = np.concatenate(mcus, axis=2).reshape(-1, 64)
    comps = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8), mcuy * mcux)
    return coefs, comps, tables


def derived_codes(counts, symbols):
    """``jpeg_make_c_derived_tbl``: (code, size) of every symbol (arrays of
    256; size 0 where a symbol has no code)."""
    codes, sizes = np.zeros(256, np.uint32), np.zeros(256, np.uint8)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]], sizes[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, sizes


# component -> (DC table, AC table): luma uses tables 0, chroma tables 1
_COMPONENT_TABLES = ((0, 0), (1, 1), (1, 1))


def _code_tables(n_components):
    """(8, 256) codes and sizes: DC tables 0-3 then AC tables 0-3."""
    codes, sizes = np.zeros((8, 256), np.uint32), np.zeros((8, 256), np.uint8)
    for t in range(min(n_components, 2)):
        for cls in (0, 1):
            codes[4 * cls + t], sizes[4 * cls + t] = derived_codes(*STD_HUFFMAN[cls << 4 | t])
    return codes, sizes


def encode_blocks_py(coefs, comps, n_components):
    """The entropy coder written plainly (the spec of ``csrc/jpeg_host.cc``):
    the scan's bytes, stuffed and padded, from (N, 64) quantized blocks in
    MCU order and each block's component."""
    codes, sizes = _code_tables(n_components)
    bits = []

    def emit(value, size):
        size = int(size)
        bits.append(format(int(value) & ((1 << size) - 1), f"0{size}b"))

    last_dc = [0] * n_components
    for block, comp in zip(coefs.astype(np.int64), comps):
        dc_t, ac_t = _COMPONENT_TABLES[comp]
        diff = int(block[0]) - last_dc[comp]
        last_dc[comp] = int(block[0])
        nbits = abs(diff).bit_length()
        emit(codes[dc_t, nbits], sizes[dc_t, nbits])
        if nbits:
            emit(diff - 1 if diff < 0 else diff, nbits)
        run = 0
        for k in range(1, 64):
            v = int(block[ZIGZAG[k]])
            if v == 0:
                run += 1
                continue
            while run > 15:
                emit(codes[4 + ac_t, 0xF0], sizes[4 + ac_t, 0xF0])
                run -= 16
            nbits = abs(v).bit_length()
            symbol = (run << 4) + nbits
            emit(codes[4 + ac_t, symbol], sizes[4 + ac_t, symbol])
            emit(v - 1 if v < 0 else v, nbits)
            run = 0
        if run:
            emit(codes[4 + ac_t, 0], sizes[4 + ac_t, 0])
    stream = "".join(bits)
    stream += "1" * (-len(stream) % 8)
    data = int(stream, 2).to_bytes(len(stream) // 8, "big") if stream else b""
    return data.replace(b"\xff", b"\xff\x00")


def encode_blocks_native(coefs, comps, n_components):
    """``encode_blocks_py`` in C++ (``csrc/jpeg_host.cc``): the coder the
    writer runs.  Builds the library at first use; raises if it cannot."""
    from .. import kernels

    lib = kernels.host_library("jpeg_host")
    codes, sizes = _code_tables(n_components)
    coefs = np.ascontiguousarray(coefs, np.int16)
    comps = np.ascontiguousarray(comps, np.uint8)
    tables = np.array(_COMPONENT_TABLES[:n_components], np.int32)
    out = np.empty(len(coefs) * 512 + 16, np.uint8)
    n = lib.omj_encode_blocks(coefs.ctypes.data, len(coefs), comps.ctypes.data,
                              tables.ctypes.data, n_components, codes.ctypes.data,
                              sizes.ctypes.data, out.ctypes.data, len(out))
    if n < 0:
        raise ValueError(f"omj_encode_blocks failed ({n}): a coefficient out of range")
    return out[:n].tobytes()


def _segment(marker, payload):
    return struct.pack(">BBH", 0xFF, marker, len(payload) + 2) + payload


def encode(image, quality=DEFAULT_QUALITY):
    """The bytes ``cv2.imencode(".jpg", bgr, [IMWRITE_JPEG_QUALITY, quality])``
    gives for ``image``: (H, W, 3) uint8 RGB or (H, W) uint8 grey."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (image.ndim == 2 or (image.ndim == 3
                                                           and image.shape[2] == 3)):
        raise ValueError(f"the JPEG writer takes (H, W) or (H, W, 3) uint8, got {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    if not (0 < height <= 65535 and 0 < width <= 65535):
        raise ValueError(f"a JPEG holds 1 to 65535 pixels a side, not {width}x{height}")
    coefs, comps, tables = component_blocks(image, quality)
    n = 1 if image.ndim == 2 else 3
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, table in enumerate(tables):
        out.append(_segment(0xDB, bytes([t]) + table[ZIGZAG].astype(np.uint8).tobytes()))
    sampling = (0x22, 0x11, 0x11) if n == 3 else (0x11,)
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([i + 1, sampling[i], min(i, 1)]) for i in range(n))))
    for t in range(len(tables)):
        for cls in (0, 1):
            counts, symbols = STD_HUFFMAN[cls << 4 | t]
            out.append(_segment(0xC4, bytes([cls << 4 | t, *counts]) + symbols))
    out.append(_segment(0xDA, bytes([n]) + b"".join(
        bytes([i + 1, 0x11 * min(i, 1)]) for i in range(n)) + b"\x00\x3f\x00"))
    out.append(encode_blocks_native(coefs, comps, n))
    out.append(b"\xff\xd9")
    return b"".join(out)
