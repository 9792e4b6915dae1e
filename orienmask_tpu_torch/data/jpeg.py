"""JPEG decoding without cv2 or PIL, bit for bit as ``cv2.imread`` decodes
(libjpeg-turbo: the ISLOW integer IDCT, "fancy" upsampling, the fixed-point
YCbCr->RGB tables) followed by ``cvtColor(BGR2RGB)``, EXIF orientation
applied as ``cv2.imread`` applies it.

What is read: baseline and extended sequential (SOF0, SOF1) and progressive
(SOF2) Huffman-coded files at 8-bit precision, 8- and 16-bit quantization
tables, 1 or 3 components, sampling factors of 1 or 2 on either axis (4:4:4,
4:2:2, 4:4:0, 4:2:0), restart intervals, sizes that are not a whole number of
MCUs.  Anything else (arithmetic coding, 12-bit, lossless, hierarchical,
4-component CMYK/YCCK, other sampling factors, a truncated or corrupt file,
a progressive file whose scans leave coefficients incomplete) raises
``UnsupportedJpeg`` naming the form.

The stages:

* ``parse`` reads the markers into a ``Frame`` and hands each scan's
  entropy-coded bytes to a scan decoder, which fills the frame's quantized
  coefficient blocks in place (the progressive state is those blocks);
* ``decode_scan_py`` is the scan decoder written plainly, the spec; the one
  the reader runs is ``decode_scan_native``, the same decoder in C++
  (``csrc/jpeg_host.cc``), built with the host compiler at first use and
  loaded with ctypes (``kernels.host_library``).  It raises if it cannot be
  built; nothing falls back to the Python decoder;
* ``pixels`` dequantizes, runs the IDCT (``jidctint.c``: CONST_BITS 13,
  PASS1_BITS 2 and the post-IDCT range-limit table), upsamples
  (``jdsample.c``'s h2v1, h1v2 and h2v2 fancy upsamplers) and converts the
  colour (``jdcolor.c``, SCALEBITS 16), vectorised with numpy's integer
  arithmetic; grey is replicated to three channels.
"""

import re
import struct

import numpy as np

# jpeg_natural_order: zigzag index -> natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# SOFn markers that are read, and those refused with the name of their form
_SOF_READ = (0xC0, 0xC1, 0xC2)  # baseline, extended sequential, progressive
_SOF_REFUSED = {
    0xC3: "a lossless JPEG", 0xC5: "a hierarchical JPEG", 0xC6: "a hierarchical JPEG",
    0xC7: "a hierarchical JPEG", 0xC9: "an arithmetic-coded JPEG",
    0xCA: "an arithmetic-coded JPEG", 0xCB: "an arithmetic-coded JPEG",
    0xCD: "an arithmetic-coded JPEG", 0xCE: "an arithmetic-coded JPEG",
    0xCF: "an arithmetic-coded JPEG",
}
# the end of a scan's entropy-coded bytes: a marker that is neither a
# stuffed zero nor RSTn (fill bytes 0xFF may precede it)
_MARKER = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")
# libjpeg-turbo block-smooths a progressive file whose scans leave any of
# coefficients 0..9 of a component incomplete; such a file is refused
_SMOOTHED_COEFS = 10


class UnsupportedJpeg(ValueError):
    """A JPEG form this decoder does not read; the message names it."""


class Frame:
    """What the markers say, and the coefficient blocks the scans fill.

    ``components``: dicts of id, h, v, tq and the derived geometry (``w``,
    ``h_px``: the component's size in samples; ``bw``, ``bh``: its blocks
    with data; ``coefs``: int16 (bh_padded, bw_padded, 64) blocks in
    natural order, padded to whole MCUs)."""

    def __init__(self):
        self.qtables = {}
        self.dc_tables, self.ac_tables = {}, {}
        self.restart = 0
        self.progressive = False
        self.components = []
        self.width = self.height = 0
        self.orientation = 1
        self.saw_jfif = False
        self.adobe_transform = None
        self.coef_bits = None
        self.scans = 0


def _u16(data, pos):
    return (data[pos] << 8) | data[pos + 1]


def read_orientation(app1):
    """EXIF tag 0x0112 of an APP1 payload, or 1 where there is none or its
    value is not 1-8 (as OpenCV's ExifReader leaves the image alone)."""
    if not app1.startswith(b"Exif\x00\x00") or len(app1) < 14:
        return 1
    tiff = app1[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    try:
        (ifd,) = struct.unpack_from(order + "I", tiff, 4)
        (count,) = struct.unpack_from(order + "H", tiff, ifd)
        for i in range(count):
            tag, kind, _, value = struct.unpack_from(order + "HHI4s", tiff, ifd + 2 + 12 * i)
            if tag == 0x0112 and kind == 3:
                (orientation,) = struct.unpack_from(order + "H", value, 0)
                return orientation if 1 <= orientation <= 8 else 1
    except struct.error:
        return 1
    return 1


def _read_sof(frame, marker, seg):
    if marker in _SOF_REFUSED:
        raise UnsupportedJpeg(_SOF_REFUSED[marker])
    if frame.components:
        raise UnsupportedJpeg("a JPEG with two frame headers")
    precision, height, width, n = struct.unpack_from(">BHHB", seg, 0)
    if precision != 8:
        raise UnsupportedJpeg(f"a {precision}-bit JPEG")
    if height == 0:
        raise UnsupportedJpeg("a JPEG whose height comes in a DNL marker")
    if width == 0:
        raise UnsupportedJpeg("a JPEG of width 0")
    if n == 4:
        raise UnsupportedJpeg("a 4-component JPEG (CMYK/YCCK)")
    if n not in (1, 3):
        raise UnsupportedJpeg(f"a {n}-component JPEG")
    comps = []
    for i in range(n):
        cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * i)
        comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    for c in comps:
        if c["h"] not in (1, 2) or c["v"] not in (1, 2) or hmax % c["h"] or vmax % c["v"]:
            raise UnsupportedJpeg("a JPEG with sampling factors " + ", ".join(
                f"{d['h']}x{d['v']}" for d in comps) + " (1 or 2 on either axis are read)")
    mcux = -(-width // (8 * hmax))
    mcuy = -(-height // (8 * vmax))
    shapes = [(mcuy * c["v"], mcux * c["h"], 64) for c in comps]
    # every component's blocks in one buffer, which the native decoder fills
    frame.offsets = np.cumsum([0] + [int(np.prod(s)) for s in shapes]).astype(np.int64)
    frame.buffer = np.zeros(frame.offsets[-1], np.int16)
    for c, shape, off in zip(comps, shapes, frame.offsets):
        c["w"] = -(-width * c["h"] // hmax)
        c["h_px"] = -(-height * c["v"] // vmax)
        c["bw"], c["bh"] = -(-c["w"] // 8), -(-c["h_px"] // 8)
        c["coefs"] = frame.buffer[off:off + int(np.prod(shape))].reshape(shape)
        c["qtable"] = None
    frame.width, frame.height = width, height
    frame.components = comps
    frame.hmax, frame.vmax, frame.mcux, frame.mcuy = hmax, vmax, mcux, mcuy
    frame.progressive = marker == 0xC2
    frame.coef_bits = np.full((n, 64), -1, np.int64)


def _read_dqt(frame, seg):
    pos = 0
    while pos < len(seg):
        pq, tq = seg[pos] >> 4, seg[pos] & 15
        if pq > 1:
            raise UnsupportedJpeg(f"a quantization table of precision {pq}")
        n = 64 * (pq + 1)
        values = np.frombuffer(seg[pos + 1:pos + 1 + n], ">u2" if pq else np.uint8)
        if len(values) != 64:
            raise UnsupportedJpeg("a truncated JPEG (quantization table)")
        table = np.zeros(64, np.int64)
        table[ZIGZAG] = values
        frame.qtables[tq] = table
        pos += 1 + n


def _read_dht(frame, seg):
    pos = 0
    while pos < len(seg):
        tc, th = seg[pos] >> 4, seg[pos] & 15
        counts = list(seg[pos + 1:pos + 17])
        symbols = bytes(seg[pos + 17:pos + 17 + sum(counts)])
        if len(counts) != 16 or len(symbols) != sum(counts) or tc > 1 or th > 3:
            raise UnsupportedJpeg("a corrupt JPEG (Huffman table)")
        (frame.ac_tables if tc else frame.dc_tables)[th] = (counts, symbols)
        pos += 17 + sum(counts)


def _read_sos(frame, seg):
    if not frame.components:
        raise UnsupportedJpeg("a corrupt JPEG (scan before the frame header)")
    n = seg[0]
    by_id = {c["id"]: i for i, c in enumerate(frame.components)}
    scan_comps = []
    for i in range(n):
        cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in by_id:
            raise UnsupportedJpeg("a corrupt JPEG (scan of an unknown component)")
        scan_comps.append((by_id[cid], tables >> 4, tables & 15))
    ss, se, a = seg[1 + 2 * n], seg[2 + 2 * n], seg[3 + 2 * n]
    ah, al = a >> 4, a & 15
    if frame.progressive:
        bad = (ss > se or se > 63 or al > 13 or (ss == 0) != (se == 0)
               or (ss > 0 and n != 1))
    else:
        bad = ss != 0 or se != 63 or ah != 0 or al != 0
    if bad or n < 1 or n > 4:
        raise UnsupportedJpeg("a corrupt JPEG (scan parameters)")
    for ci, td, ta in scan_comps:
        comp = frame.components[ci]
        if comp["qtable"] is None:  # latched at the component's first scan
            if comp["tq"] not in frame.qtables:
                raise UnsupportedJpeg("a corrupt JPEG (missing quantization table)")
            comp["qtable"] = frame.qtables[comp["tq"]].copy()
        if (ss == 0 and ah == 0 and td not in frame.dc_tables) or \
                (se > 0 and ta not in frame.ac_tables):
            raise UnsupportedJpeg("a corrupt JPEG (missing Huffman table)")
        bits = frame.coef_bits[ci, ss:se + 1].copy()
        frame.coef_bits[ci, ss:se + 1] = al
        if frame.progressive and ah and np.any(bits != ah):
            raise UnsupportedJpeg("a corrupt JPEG (progressive refinement out of order)")
    return {"comps": scan_comps, "ss": ss, "se": se, "ah": ah, "al": al}


def parse(data, scan_decoder, frame=None):
    """Read every marker of ``data`` (the bytes of a JPEG file); each scan's
    entropy-coded bytes go to ``scan_decoder(frame, scan, segment)``.
    ``frame``: a ``Frame`` to fill (one with tables set beforehand, as MJPEG
    frames without DHT need), or a new one."""
    data = bytes(data)
    if data[:2] != b"\xff\xd8":
        raise UnsupportedJpeg("not a JPEG")
    frame, pos, n = frame or Frame(), 2, len(data)
    while True:
        while pos < n and data[pos] == 0xFF and pos + 1 < n and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if pos + 1 >= n:
            raise UnsupportedJpeg("a truncated JPEG (no end-of-image marker)")
        if data[pos] != 0xFF:
            raise UnsupportedJpeg("a corrupt JPEG (bytes where a marker belongs)")
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker in (0xD8, 0x01):
            pos += 2
            continue
        if pos + 4 > n:
            raise UnsupportedJpeg("a truncated JPEG")
        length = _u16(data, pos + 2)
        seg = data[pos + 4:pos + 2 + length]
        if length < 2 or len(seg) != length - 2:
            raise UnsupportedJpeg("a truncated JPEG")
        pos += 2 + length
        if marker in _SOF_READ or marker in _SOF_REFUSED:
            _read_sof(frame, marker, seg)
        elif marker == 0xDB:
            _read_dqt(frame, seg)
        elif marker == 0xC4:
            _read_dht(frame, seg)
        elif marker == 0xCC:
            raise UnsupportedJpeg("an arithmetic-coded JPEG")
        elif marker == 0xDD:
            frame.restart = _u16(seg, 0)
        elif marker == 0xDC:
            raise UnsupportedJpeg("a JPEG whose height comes in a DNL marker")
        elif marker in (0xDE, 0xDF):
            raise UnsupportedJpeg("a hierarchical JPEG")
        elif marker == 0xE0 and seg.startswith(b"JFIF\x00"):
            frame.saw_jfif = True
        elif marker == 0xE1 and frame.orientation == 1 and seg.startswith(b"Exif\x00\x00"):
            frame.orientation = read_orientation(seg)
        elif marker == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            frame.adobe_transform = seg[11]
        elif marker == 0xDA:
            scan = _read_sos(frame, seg)
            end = _MARKER.search(data, pos)
            if end is None:
                raise UnsupportedJpeg("a truncated JPEG (scan runs to the end of the file)")
            scan_decoder(frame, scan, data[pos:end.start()])
            frame.scans += 1
            pos = end.start()
    if not frame.components or frame.scans == 0:
        raise UnsupportedJpeg("a JPEG without image data")
    if frame.progressive and np.any(frame.coef_bits[:, :_SMOOTHED_COEFS] != 0):
        raise UnsupportedJpeg("a progressive JPEG whose scans leave coefficients incomplete "
                              "(libjpeg would smooth its blocks)")
    return frame


# ------------------------------------------------------- entropy decoding

def _block_order(frame, scan):
    """(component index, block row, block column) of each block of each MCU
    of ``scan``, MCU by MCU: a list of MCUs, each a list of blocks."""
    comps = [frame.components[ci] for ci, _, _ in scan["comps"]]
    if len(comps) == 1:  # non-interleaved: an MCU is one block with data
        ci, c = scan["comps"][0][0], comps[0]
        return [[(ci, by, bx)] for by in range(c["bh"]) for bx in range(c["bw"])]
    return [[(ci, my * c["v"] + j, mx * c["h"] + i)
             for (ci, _, _), c in zip(scan["comps"], comps)
             for j in range(c["v"]) for i in range(c["h"])]
            for my in range(frame.mcuy) for mx in range(frame.mcux)]


class _Bits:
    """The bits of one restart interval's entropy-coded bytes."""

    def __init__(self, data):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8)).tolist()
        self.pos = 0

    def get(self, n):
        if self.pos + n > len(self.bits):
            raise UnsupportedJpeg("a truncated or corrupt JPEG (entropy-coded data ends early)")
        v = 0
        for b in self.bits[self.pos:self.pos + n]:
            v = (v << 1) | b
        self.pos += n
        return v

    def huffman(self, table):
        counts, symbols = table
        code = first = index = 0
        for length in range(16):
            code = (code << 1) | self.get(1)
            if code - first < counts[length]:
                return symbols[index + code - first]
            index += counts[length]
            first = (first + counts[length]) << 1
        raise UnsupportedJpeg("a corrupt JPEG (bad Huffman code)")


def _extend(v, s):
    return v - (1 << s) + 1 if s and v < (1 << (s - 1)) else v


def _i16(v):
    """``(JCOEF)v``: libjpeg keeps coefficients as 16-bit integers."""
    return ((v + 32768) & 0xFFFF) - 32768


def _intervals(segment, restart, n_mcus):
    """The unstuffed bytes of each restart interval, RSTn checked."""
    pieces, pos, expect = [], 0, 0
    out = bytearray()
    while True:
        i = segment.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(segment):
            out += segment[pos:]
            pieces.append(bytes(out))
            break
        out += segment[pos:i]
        nxt = segment[i + 1]
        if nxt == 0x00:
            out.append(0xFF)
            pos = i + 2
        elif 0xD0 <= nxt <= 0xD7:
            if not restart or nxt != 0xD0 + expect:
                raise UnsupportedJpeg("a corrupt JPEG (restart marker out of sequence)")
            expect = (expect + 1) % 8
            pieces.append(bytes(out))
            out = bytearray()
            pos = i + 2
        else:  # fill byte before a marker: the segment never holds one
            pos = i + 1
    n_intervals = -(-n_mcus // restart) if restart else 1
    if len(pieces) == n_intervals + 1 and not pieces[-1]:
        pieces.pop()  # a restart marker after the last interval
    if len(pieces) != n_intervals:
        raise UnsupportedJpeg("a corrupt JPEG (restart markers do not match the interval)")
    return pieces


def decode_scan_py(frame, scan, segment):
    """The scan decoder written plainly (the spec of ``csrc/jpeg_host.cc``):
    fills ``frame``'s coefficient blocks from one scan's bytes."""
    mcus = _block_order(frame, scan)
    restart = frame.restart
    pieces = _intervals(segment, restart, len(mcus))
    tables = {ci: (frame.dc_tables.get(td), frame.ac_tables.get(ta))
              for ci, td, ta in scan["comps"]}
    coefs = [c["coefs"] for c in frame.components]
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    for m, mcu in enumerate(mcus):
        if m % (restart or len(mcus) + 1) == 0:
            bits = _Bits(pieces[m // restart if restart else 0])
            pred = {ci: 0 for ci in tables}
            eobrun = 0
        for ci, by, bx in mcu:
            block = coefs[ci][by, bx]
            dc_table, ac_table = tables[ci]
            if not frame.progressive:
                s = bits.huffman(dc_table)
                pred[ci] += _extend(bits.get(s), s)
                block[0] = _i16(pred[ci])
                k = 1
                while k < 64:
                    rs = bits.huffman(ac_table)
                    r, s = rs >> 4, rs & 15
                    if s:
                        k += r
                        if k > 63:
                            raise UnsupportedJpeg("a corrupt JPEG (coefficient past 63)")
                        block[ZIGZAG[k]] = _extend(bits.get(s), s)
                    elif r != 15:
                        break
                    else:
                        k += 15
                    k += 1
            elif ss == 0:  # DC scan
                if ah == 0:
                    s = bits.huffman(dc_table)
                    pred[ci] += _extend(bits.get(s), s)
                    block[0] = _i16(pred[ci] << al)
                elif bits.get(1):
                    block[0] |= np.int16(1 << al)
            elif ah == 0:  # AC first
                eobrun = _ac_first(bits, block, ac_table, ss, se, al, eobrun)
            else:  # AC refinement
                eobrun = _ac_refine(bits, block, ac_table, ss, se, al, eobrun)


def _ac_first(bits, block, table, ss, se, al, eobrun):
    if eobrun:
        return eobrun - 1
    k = ss
    while k <= se:
        rs = bits.huffman(table)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                raise UnsupportedJpeg("a corrupt JPEG (coefficient past 63)")
            block[ZIGZAG[k]] = _i16(_extend(bits.get(s), s) << al)
        elif r == 15:
            k += 15
        else:
            eobrun = 1 << r
            if r:
                eobrun += bits.get(r)
            return eobrun - 1
        k += 1
    return 0


def _ac_refine(bits, block, table, ss, se, al, eobrun):
    p1, m1 = 1 << al, -1 << al
    k = ss

    def correct(pos):
        if bits.get(1) and (int(block[pos]) & p1) == 0:
            block[pos] += p1 if block[pos] >= 0 else m1

    if eobrun == 0:
        while k <= se:
            rs = bits.huffman(table)
            r, s = rs >> 4, rs & 15
            if s:
                if s != 1:
                    raise UnsupportedJpeg("a corrupt JPEG (refinement of size other than 1)")
                s = p1 if bits.get(1) else m1
            elif r != 15:
                eobrun = 1 << r
                if r:
                    eobrun += bits.get(r)
                break
            while k <= se:
                pos = ZIGZAG[k]
                if block[pos] != 0:
                    correct(pos)
                else:
                    if r == 0:
                        break
                    r -= 1
                k += 1
            if s:
                if k > 63:
                    raise UnsupportedJpeg("a corrupt JPEG (coefficient past 63)")
                block[ZIGZAG[k]] = s
            k += 1
    if eobrun > 0:
        while k <= se:
            pos = ZIGZAG[k]
            if block[pos] != 0:
                correct(pos)
            k += 1
        eobrun -= 1
    return eobrun


# ---------------------------------------------------------- sample stages

_FIX = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433,
        "0_765366865": 6270, "0_899976223": 7373, "1_175875602": 9633,
        "1_501321110": 12299, "1_847759065": 15137, "1_961570560": 16069,
        "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}
CONST_BITS, PASS1_BITS = 13, 2


def _idct_1d(c, shift):
    """One pass of jpeg_idct_islow over eight int64 arrays (inputs 0..7)."""
    f = _FIX
    z1 = (c[2] + c[6]) * f["0_541196100"]
    tmp2 = z1 - c[6] * f["1_847759065"]
    tmp3 = z1 + c[2] * f["0_765366865"]
    tmp0 = (c[0] + c[4]) << CONST_BITS
    tmp1 = (c[0] - c[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["1_175875602"]
    t0 = t0 * f["0_298631336"]
    t1 = t1 * f["2_053119869"]
    t2 = t2 * f["3_072711026"]
    t3 = t3 * f["1_501321110"]
    z1 = z1 * -f["0_899976223"]
    z2 = z2 * -f["2_562915447"]
    z3 = z3 * -f["1_961570560"] + z5
    z4 = z4 * -f["0_390180644"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                          tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _range_limit_table():
    """jdmaster.c's post-IDCT table, indexed by (x & 1023) for x = the
    descaled IDCT output before the +128 level shift."""
    j = np.arange(1024)
    return np.select([j < 128, j < 512, j < 896], [j + 128, 255, 0], j - 896).astype(np.uint8)


_RANGE_LIMIT = _range_limit_table()
_IDCT_RUN = 1024


def idct_islow(coefs, qtable):
    """(N, 64) quantized coefficients (natural order) and their table ->
    (N, 8, 8) uint8 samples, as ``jpeg_idct_islow`` gives them."""
    q = qtable.astype(np.int16).astype(np.int64)  # ISLOW_MULT_TYPE is short
    # (vertical frequency, column, block): each pass reads contiguous rows
    d = (coefs.astype(np.int64) * q).T.reshape(8, 8, -1)
    ws = np.stack(_idct_1d(d, CONST_BITS - PASS1_BITS))  # (row, horizontal freq, block)
    out = np.stack(_idct_1d(ws.transpose(1, 0, 2), CONST_BITS + PASS1_BITS + 3))  # (x, row, N)
    return _RANGE_LIMIT[out.transpose(2, 1, 0) & 1023]


def _plane(comp):
    """A component's samples, the blocks with data only: (h_px, w)."""
    coefs = comp["coefs"]
    flat = coefs.reshape(-1, 64)
    # in runs of blocks whose temporaries stay small (and in the cache)
    blocks = np.concatenate([idct_islow(flat[i:i + _IDCT_RUN], comp["qtable"])
                             for i in range(0, len(flat), _IDCT_RUN)])
    bh, bw = coefs.shape[:2]
    plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
    return plane[:comp["h_px"], :comp["w"]]


def _edge(a, axis):
    """(previous, next) neighbours of every sample along ``axis``, the edge
    samples replicated."""
    a = np.asarray(a)
    first = np.take(a, [0], axis=axis)
    last = np.take(a, [a.shape[axis] - 1], axis=axis)
    n = a.shape[axis]
    prev = np.concatenate([first, np.take(a, np.arange(n - 1), axis=axis)], axis=axis)
    nxt = np.concatenate([np.take(a, np.arange(1, n), axis=axis), last], axis=axis)
    return prev, nxt


def _interleave(a, b, axis):
    out = np.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane, fh, fv):
    """jdsample.c's upsampler for ratios ``fh``, ``fv`` in {1, 2}: h2v1 and
    h2v2 fancy where the component is wider than 2 samples (else pixel
    replication), h1v2 fancy always; edge samples replicated as the
    first/last column cases and the context rows give them."""
    p = plane.astype(np.int32)
    if fh == 1 and fv == 1:
        return plane
    if fh == 2 and p.shape[1] <= 2:  # h2v1_upsample / h2v2_upsample
        return np.repeat(np.repeat(plane, 2, axis=1), fv, axis=0)
    if fh == 1:  # h1v2_fancy_upsample: biases 1 (row above) and 2 (below)
        up, down = _edge(p, 0)
        return _interleave((3 * p + up + 1) >> 2, (3 * p + down + 2) >> 2, 0).astype(np.uint8)
    if fv == 1:  # h2v1_fancy_upsample
        left, right = _edge(p, 1)
        return _interleave((3 * p + left + 1) >> 2, (3 * p + right + 2) >> 2, 1).astype(np.uint8)
    up, down = _edge(p, 0)  # h2v2_fancy_upsample: column sums, biases 8 and 7
    rows = []
    for colsum in (3 * p + up, 3 * p + down):
        left, right = _edge(colsum, 1)
        rows.append(_interleave((3 * colsum + left + 8) >> 4, (3 * colsum + right + 7) >> 4, 1))
    return _interleave(rows[0], rows[1], 0).astype(np.uint8)


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table, with the green terms of every (Cb,
    Cr) pair summed and shifted once (int16, indexed by Cb * 256 + Cr)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15
    cr_r = (91881 * x + one_half) >> 16
    cb_b = (116130 * x + one_half) >> 16
    cr_g, cb_g = -46802 * x, -22554 * x + one_half
    green = (cb_g[:, None] + cr_g[None, :]) >> 16
    return cr_r.astype(np.int16), cb_b.astype(np.int16), green.reshape(-1).astype(np.int16)


_CR_R, _CB_B, _GREEN = _ycc_tables()
# sample_range_limit: x -> clamp(x, 0, 255) for x in [-256, 511], indexed by x + 256
_CLAMP = np.clip(np.arange(-256, 512), 0, 255).astype(np.uint8)


def ycc_to_rgb(y, cb, cr):
    """jdcolor.c's ycc_rgb_convert: uint8 planes -> (H, W, 3) uint8 RGB."""
    y = y.astype(np.int16) + 256
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = _CLAMP[y + _CR_R[cr]]
    out[..., 1] = _CLAMP[y + _GREEN[cb.astype(np.int32) * 256 + cr]]
    out[..., 2] = _CLAMP[y + _CB_B[cb]]
    return out


def orient(image, orientation):
    """cv2.imread's EXIF transform (OpenCV's ExifTransform)."""
    if orientation in (5, 6, 7, 8):
        image = image.transpose(1, 0, 2)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flip:
        image = np.flip(image, axis)
    return np.ascontiguousarray(image)


def pixels(frame):
    """The decoded frame as (H, W, 3) uint8 RGB, EXIF orientation applied."""
    if any(c["qtable"] is None for c in frame.components):
        raise UnsupportedJpeg("a JPEG with a component that no scan codes")
    planes = []
    for comp in frame.components:
        full = upsample(_plane(comp), frame.hmax // comp["h"], frame.vmax // comp["v"])
        planes.append(full[:frame.height, :frame.width])
    if len(planes) == 1:
        image = np.repeat(planes[0][..., None], 3, axis=2)
    elif _rgb_coded(frame):
        image = np.stack(planes, axis=-1)
    else:
        image = ycc_to_rgb(*planes)
    return orient(image, frame.orientation)


def _rgb_coded(frame):
    """jdapimin.c's guess of a 3-component colour space: JFIF means YCbCr,
    else an Adobe marker's transform, else component ids 'R', 'G', 'B'."""
    if frame.saw_jfif:
        return False
    if frame.adobe_transform is not None:
        return frame.adobe_transform == 0
    return [c["id"] for c in frame.components] == [82, 71, 66]


# ------------------------------------------------------ the native decoder

def decode_scan_native(frame, scan, segment):
    """``decode_scan_py`` in C++ (``csrc/jpeg_host.cc``): the scan decoder
    the reader runs.  Builds the library at first use; raises if it cannot."""
    from .. import kernels

    lib = kernels.host_library("jpeg_host")
    comps = frame.components
    geom = np.array([[comps[ci]["h"], comps[ci]["v"], comps[ci]["coefs"].shape[1],
                      comps[ci]["bw"], comps[ci]["bh"], td, ta,
                      comps[ci]["coefs"].shape[0]]
                     for ci, td, ta in scan["comps"]], np.int32)
    offsets = np.array([frame.offsets[ci] for ci, _, _ in scan["comps"]], np.int64)
    huff = np.zeros((8, 16 + 256), np.uint8)
    for i, tables in enumerate((frame.dc_tables, frame.ac_tables)):
        for t, (counts, symbols) in tables.items():
            huff[4 * i + t, :16] = counts
            huff[4 * i + t, 16:16 + len(symbols)] = np.frombuffer(symbols, np.uint8)
    present = np.array([t in frame.dc_tables for t in range(4)]
                       + [t in frame.ac_tables for t in range(4)], np.uint8)
    seg = np.frombuffer(segment, np.uint8)
    err = lib.omj_decode_scan(
        seg.ctypes.data, len(seg), frame.buffer.ctypes.data, offsets.ctypes.data,
        geom.ctypes.data, len(geom), huff.ctypes.data, present.ctypes.data,
        frame.mcux, frame.mcuy, scan["ss"], scan["se"], scan["ah"], scan["al"],
        frame.restart, int(frame.progressive))
    if err:
        raise UnsupportedJpeg(lib.omj_error_string(err).decode())


def decode(data, scan_decoder=decode_scan_native):
    """The JPEG file ``data`` as (H, W, 3) uint8 RGB, as cv2 reads it."""
    return pixels(parse(data, scan_decoder))
