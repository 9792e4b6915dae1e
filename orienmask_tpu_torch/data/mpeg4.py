"""MPEG-4 Part 2 (ISO/IEC 14496-2) Simple Profile video, decoded as FFmpeg's
``mpeg4`` decoder decodes it (the decoder behind ``cv2.VideoCapture`` for
the ``mp4v`` streams cv2 writes), without cv2 or FFmpeg.

The headers (visual object sequence, visual object, video object layer,
group of VOPs, VOP) are parsed here.  A VOP's macroblocks are decoded in two
parts:

* ``parse_macroblocks_py``: the sequential part, plainly written: MCBPC,
  CBPY, DQUANT, the intra DC (by its VLC or among the AC coefficients, after
  ``intra_dc_vlc_thr``), DC and AC prediction with ``ac_pred_flag``, TCOEF
  with its three escapes, the H.263 inverse quantisation of inter blocks,
  1MV and 4MV median prediction, ``not_coded`` macroblocks, and resync
  markers with their video packet headers (``header_extension_code``
  included); it yields each macroblock's kind, quantiser, coefficient
  blocks and vectors;
* ``reconstruct_py``: the intra blocks' inverse quantisation, FFmpeg's
  ``simple_idct`` (``simple_idct_template.c``, the integer IDCT libavcodec
  selects for these streams), half-pel motion compensation with
  ``vop_rounding_type`` over the edge-replicated reference (unrestricted
  vectors, ``f_code`` 1-7; the no-rounding averages of 8-wide blocks as
  FFmpeg's x86 code makes them, ``half_pel``) and the chroma vectors'
  rounding (7.6.4).

Together they are the spec of ``decode_vop_native``, the loop the reader
runs: the same per macroblock in C++ (``csrc/mpeg4_host.cc``), built with
the host compiler at first use (``kernels.host_library``).  It raises if it
cannot be built; nothing falls back to Python.

Refused, each by its name: B-VOPs, S(GMC)-VOPs, quarter-pel, interlaced
video, MPEG quantisation (``quant_type`` 1), data partitioning and
reversible VLC, shapes other than rectangular, the short video header
(H.263), DivX packed bitstreams, ``newpred``, reduced-resolution VOPs,
scalability and complexity estimation headers, and pixels of other than
8 bits.
"""

import numpy as np

from . import mpeg4_tables as T

REFUSAL = "ROADMAP Queue 1 item 1, 'What the infer CLI still refuses'"
I_VOP, P_VOP, B_VOP, S_VOP = 0, 1, 2, 3
# AVI tags FFmpeg takes for XviD's streams when no user data names the encoder
XVID_TAGS = (b"XVID", b"XVIX", b"RMP4", b"ZMP4", b"SIPP")
# macroblock kinds in the parse
MB_INTRA, MB_INTER, MB_SKIPPED, MB_INTER4V = 0, 1, 2, 3
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520


class UnsupportedMpeg4(ValueError):
    def __init__(self, form):
        super().__init__(f"{form} is not read ({REFUSAL})")
        self.form = form


class BitReader:
    """MSB-first bits of ``data`` from bit ``pos``."""

    __slots__ = ("data", "pos", "size")

    def __init__(self, data, pos=0):
        self.data = bytes(data)
        self.pos = pos
        self.size = 8 * len(self.data)

    def peek(self, n):
        byte = self.pos >> 3
        chunk = int.from_bytes(self.data[byte:byte + 8].ljust(8, b"\0"), "big")
        return (chunk >> (64 - (self.pos & 7) - n)) & ((1 << n) - 1)

    def bits(self, n):
        if n == 0:
            return 0
        if self.pos + n > self.size:
            raise EOFError("the bitstream ends inside a field")
        value = self.peek(n)
        self.pos += n
        return value

    def bit(self):
        return self.bits(1)

    def signed(self, n):
        value = self.bits(n)
        return value - (1 << n) if value >> (n - 1) else value

    def marker(self):
        self.bits(1)  # FFmpeg only warns on a missing marker bit

    def vlc(self, table):
        sym, length = table
        n = len(length).bit_length() - 1
        code = self.peek(n)
        if length[code] == 0:
            raise ValueError(f"an invalid variable-length code at bit {self.pos}")
        self.pos += int(length[code])
        if self.pos > self.size:
            raise EOFError("the bitstream ends inside a code")
        return int(sym[code])

    def align(self):
        self.pos = (self.pos + 7) & ~7


def start_codes(data):
    """(offset after ``00 00 01``, its code byte) of each start code."""
    out = []
    at = data.find(b"\0\0\1")
    while 0 <= at < len(data) - 3:
        out.append((at + 4, data[at + 3]))
        at = data.find(b"\0\0\1", at + 3)
    return out


class Vol:
    """The fields of a video object layer header the decoder uses."""

    def __init__(self, data):
        r = BitReader(data)
        r.bit()  # random_accessible_vol
        self.object_type = r.bits(8)
        if self.object_type == 0x12:
            raise UnsupportedMpeg4("a fine granularity scalable layer")
        verid = 1
        if r.bit():  # is_object_layer_identifier
            verid = r.bits(4)
            r.bits(3)
        self.verid = verid
        if r.bits(4) == 15:  # aspect_ratio_info: extended PAR
            r.bits(16)
        self.low_delay = 1
        if r.bit():  # vol_control_parameters
            chroma_format = r.bits(2)
            if chroma_format != 1:
                raise UnsupportedMpeg4(f"chroma format {chroma_format} (4:2:0 only)")
            self.low_delay = r.bit()
            if r.bit():  # vbv_parameters
                for n in (15, 1, 15, 1, 15, 1, 3, 11, 1, 15, 1):
                    r.bits(n)
        shape = r.bits(2)
        if shape != 0:
            kind = ("rectangular", "binary", "binary only", "grayscale")[shape]
            raise UnsupportedMpeg4(f"a non-rectangular shape ({kind})")
        r.marker()
        self.time_resolution = r.bits(16)
        if self.time_resolution == 0:
            raise ValueError("vop_time_increment_resolution is 0")
        r.marker()
        self.time_bits = max(1, (self.time_resolution - 1).bit_length())
        self.fixed_rate = r.bit()
        self.fixed_increment = r.bits(self.time_bits) if self.fixed_rate else 0
        r.marker()
        self.width = r.bits(13)
        r.marker()
        self.height = r.bits(13)
        r.marker()
        if self.width == 0 or self.height == 0:
            raise ValueError("a video object layer of size 0")
        if r.bit():
            raise UnsupportedMpeg4("interlaced video")
        r.bit()  # obmc_disable
        sprite = r.bits(1 if verid == 1 else 2)
        if sprite:
            raise UnsupportedMpeg4(f"sprite coding ({'static' if sprite == 1 else 'GMC'})")
        if r.bit():
            raise UnsupportedMpeg4("pixels of other than 8 bits (not_8_bit)")
        if r.bit():
            raise UnsupportedMpeg4("MPEG quantisation (quant_type 1)")
        if verid != 1 and r.bit():
            raise UnsupportedMpeg4("quarter-pel motion compensation")
        if not r.bit():
            raise UnsupportedMpeg4("complexity estimation headers")
        self.resync = not r.bit()
        if r.bit():
            raise UnsupportedMpeg4("data partitioning (and reversible VLC)")
        if verid != 1:
            if r.bit():
                raise UnsupportedMpeg4("newpred")
            if r.bit():
                raise UnsupportedMpeg4("reduced-resolution VOPs")
        if r.bit():
            raise UnsupportedMpeg4("scalability")
        self.mb_width = (self.width + 15) // 16
        self.mb_height = (self.height + 15) // 16


class Vop:
    """A VOP header: coding type, time, coded, rounding, DC threshold,
    quantiser, f_code, and the bit where its macroblocks start."""

    def __init__(self, data, vol):
        r = BitReader(data)
        self.coding_type = r.bits(2)
        if self.coding_type == B_VOP:
            raise UnsupportedMpeg4("B-VOPs")
        if self.coding_type == S_VOP:
            raise UnsupportedMpeg4("S(GMC)-VOPs")
        self.modulo_time = 0
        while r.bit():
            self.modulo_time += 1
        r.marker()
        self.time_increment = r.bits(vol.time_bits)
        r.marker()
        self.coded = r.bit()
        self.rounding = self.dc_threshold = self.quant = 0
        self.fcode = 1
        if self.coded:
            if self.coding_type == P_VOP:
                self.rounding = r.bit()
            self.dc_threshold = T.INTRA_DC_THRESHOLD[r.bits(3)]
            self.quant = r.bits(5)
            if self.quant == 0:
                raise ValueError("a VOP quantiser of 0")
            if self.coding_type == P_VOP:
                self.fcode = r.bits(3)
                if self.fcode == 0:
                    raise ValueError("a VOP f_code of 0")
        self.bitpos = r.pos


def params(vol, vop):
    """The int32 parameter vector of the macroblock loops.  Motion vectors
    reach past the edge of the whole macroblocks (FFmpeg's ``h_edge_pos``
    and ``v_edge_pos``), not of the VOL's size; the 8x8 blocks of 4MV
    macroblocks are first clipped to the VOL's size (``hpel_motion``)."""
    edge_w, edge_h = 16 * vol.mb_width, 16 * vol.mb_height
    return np.array([vol.mb_width, vol.mb_height, vop.coding_type, vop.quant, vop.fcode,
                     vop.rounding, vop.dc_threshold, int(vol.resync), vol.time_bits,
                     edge_w, edge_h, vol.width, vol.height], np.int32)


# ---------------------------------------------------------------- the parse


def _pred_motion(mv, block_row, block_col, block, first_line, mb_x, resync_x):
    """``ff_h263_pred_motion``: the median predictor of 8x8 block ``block``
    of the macroblock whose top-left block is (block_row, block_col) in the
    padded vector array ``mv`` (one row and column of zeros before, a column
    after)."""
    y, x = block_row + 1 + (block >> 1), block_col + 1 + (block & 1)
    a = mv[y, x - 1]
    if first_line and block < 3:
        if block == 0:
            if mb_x == resync_x:
                return 0, 0
            if mb_x + 1 == resync_x:
                c = mv[y - 1, x + 2]
                if mb_x == 0:
                    return int(c[0]), int(c[1])
                return _median(a[0], 0, c[0]), _median(a[1], 0, c[1])
            return int(a[0]), int(a[1])
        if block == 1:
            if mb_x + 1 == resync_x:
                c = mv[y - 1, x + 1]
                return _median(a[0], 0, c[0]), _median(a[1], 0, c[1])
            return int(a[0]), int(a[1])
        b, c = mv[y - 1, x], mv[y - 1, x + 1]
        if mb_x == resync_x:
            a = (0, 0)
        return _median(a[0], b[0], c[0]), _median(a[1], b[1], c[1])
    off = (2, 1, 1, -1)[block]
    b, c = mv[y - 1, x], mv[y - 1, x + off]
    return _median(a[0], b[0], c[0]), _median(a[1], b[1], c[1])


def _median(a, b, c):
    return int(sorted((int(a), int(b), int(c)))[1])


def _decode_motion(r, tables, pred, fcode):
    code = r.vlc(tables.mvd)
    if code == 0:
        return pred
    sign = r.bit()
    shift = fcode - 1
    val = code
    if shift:
        val = ((val - 1) << shift | r.bits(shift)) + 1
    if sign:
        val = -val
    val += pred
    bits = 5 + fcode  # modulo: sign_extend(val, 5 + f_code)
    val &= (1 << bits) - 1
    return val - (1 << bits) if val >> (bits - 1) else val


def _tcoef(r, tables, block, scan, i, intra, qmul, qadd):
    """The TCOEF loop of one block from scan position ``i`` + 1 on; inter
    levels inverse-quantised as they are read (FFmpeg's rl_vlc[qscale])."""
    table = tables.tcoef[intra]
    runs, levels, last_from = tables.runs[intra], tables.levels[intra], tables.last_from[intra]
    while True:
        code = r.vlc(table)
        clip = False
        if code == T.TCOEF_ESCAPE:
            if not r.bit():  # first escape: level + LMAX
                code = r.vlc(table)
                last = int(code >= last_from)
                run = int(runs[code])
                level = int(levels[code]) + int(tables.lmax[intra][last, run])
                sign = r.bit()
            elif not r.bit():  # second escape: run + RMAX + 1
                code = r.vlc(table)
                last = int(code >= last_from)
                level = int(levels[code])
                run = int(runs[code]) + int(tables.rmax[intra][last, level]) + 1
                sign = r.bit()
            else:  # third escape: fixed length
                last = r.bit()
                run = r.bits(6)
                r.marker()
                level = r.signed(12)
                r.marker()
                sign = int(level < 0)
                level = abs(level)
                clip = True
        else:
            last = int(code >= last_from)
            run, level = int(runs[code]), int(levels[code])
            sign = r.bit()
        if qmul != 1 or qadd:
            level = level * qmul + qadd
        if sign:
            level = -level
        if clip:
            level = min(max(level, -2048), 2047)
        i += run + 1
        if i > 63:
            raise ValueError("a block with more than 64 coefficients")
        block[scan[i]] = _w16(level)
        if last:
            return


def _pred_dc(state, n, bx, by, level, mb_x, mb_y, scale):
    """``ff_mpeg4_pred_dc``: (quantised DC, direction 0 left / 1 top); the
    DC times ``scale`` is stored for the blocks after."""
    dc = state["dc"][0 if n < 4 else n - 3]
    a, b, c = int(dc[by + 1, bx]), int(dc[by, bx]), int(dc[by, bx + 1])
    if state["first_line"] and n != 3:
        if n != 2:
            b = c = 1024
        if n != 1 and mb_x == state["resync_x"]:
            b = a = 1024
    if mb_x == state["resync_x"] and mb_y == state["resync_y"] + 1 and n in (0, 4, 5):
        b = 1024
    if abs(a - b) < abs(b - c):
        pred, direction = c, 1
    else:
        pred, direction = a, 0
    pred = (pred + (scale >> 1)) // scale
    level += pred
    stored = level * scale
    if stored & ~2047:
        stored = 0 if stored < 0 else 2047
    dc[by + 1, bx + 1] = stored
    return level, direction


def _pred_ac(state, block, n, bx, by, direction, ac_pred, mb_x, mb_y, qscale):
    """``ff_mpeg4_pred_ac``: add the predicted first row or column (rescaled
    to this quantiser where the neighbour's differs), then store this
    block's for the blocks after."""
    ac = state["ac"][0 if n < 4 else n - 3]
    qtab = state["qscale"]
    if ac_pred:
        if direction == 0:
            pred = ac[by + 1, bx, :8]
            q = int(qtab[mb_y, mb_x - 1]) if mb_x > 0 else qscale
            same = mb_x == 0 or q == qscale or n in (1, 3)
            for i in range(1, 8):
                block[i << 3] = _w16(int(block[i << 3]) + (
                    int(pred[i]) if same else _rounded_div(int(pred[i]) * q, qscale)))
        else:
            pred = ac[by, bx + 1, 8:]
            q = int(qtab[mb_y - 1, mb_x]) if mb_y > 0 else qscale
            same = mb_y == 0 or q == qscale or n in (2, 3)
            for i in range(1, 8):
                block[i] = _w16(int(block[i]) + (
                    int(pred[i]) if same else _rounded_div(int(pred[i]) * q, qscale)))
    for i in range(1, 8):
        ac[by + 1, bx + 1, i] = block[i << 3]
        ac[by + 1, bx + 1, 8 + i] = block[i]


def _w16(v):
    """``v`` as FFmpeg's int16 coefficient arrays hold it."""
    return ((int(v) + 32768) & 0xFFFF) - 32768


def _rounded_div(a, b):
    return int((a + (b >> 1)) / b) if a > 0 else int((a - (b >> 1)) / b)


def _block_position(n, mb_x, mb_y):
    """(column, row) of block ``n`` in its plane's block grid."""
    if n < 4:
        return 2 * mb_x + (n & 1), 2 * mb_y + (n >> 1)
    return mb_x, mb_y


def _clean_intra(state, mb_x, mb_y):
    """``ff_clean_intra_table_entries``: a non-intra macroblock's DC
    predictors back to 1024 and its AC ones to 0."""
    for n in range(6):
        bx, by = _block_position(n, mb_x, mb_y)
        plane = 0 if n < 4 else n - 3
        state["dc"][plane][by + 1, bx + 1] = 1024
        state["ac"][plane][by + 1, bx + 1] = 0


def _clean_buffers(state, mb_x, mb_y, mb_w):
    """``ff_mpeg4_clean_buffers`` at a video packet's first macroblock: the
    AC predictors from the one above-left on, in FFmpeg's flat layout."""
    lw = 2 * mb_w + 1
    start = (2 * mb_y - 1) * lw + 2 * mb_x - 1
    cw = mb_w + 1
    cstart = (mb_y - 1) * cw + mb_x - 1
    for plane, (w, s, n) in enumerate(((lw, start, 2 * lw + 1), (cw, cstart, cw + 1),
                                       (cw, cstart, cw + 1))):
        ac = state["ac"][plane]
        for k in range(max(s, -w - 1), s + n):
            row, col = divmod(k, w)
            # FFmpeg's index k is (row, col) with column w - 1 the padding column;
            # ours has it at column 0 of the next row
            if col == w - 1:
                r_, c_ = row + 2, 0
            else:
                r_, c_ = row + 1, col + 1
            if 0 <= r_ < ac.shape[0] and 0 <= c_ < ac.shape[1]:
                ac[r_, c_] = 0


def _is_resync(r, coding_type, fcode):
    """Whether stuffing to the next byte, then a resync marker, follows."""
    pos = r.pos
    stuffing = 8 - (pos & 7)
    if pos + stuffing + 17 > r.size:
        return False
    if r.peek(stuffing) != (1 << (stuffing - 1)) - 1:
        return False
    prefix = 16 if coding_type == I_VOP else 15 + fcode
    saved = r.pos
    r.pos = pos + stuffing
    ok = r.peek(prefix + 1) == 1
    r.pos = saved
    return ok


def _packet_header(r, state, vol_bits, mb_count):
    """A video packet header after the stuffing: the next macroblock, the
    quantiser, and the header extension's fields (read, not used)."""
    r.bits(1)
    r.align()
    zeros = 0
    while not r.bit():
        zeros += 1
    mb_num = r.bits((mb_count - 1).bit_length())
    if mb_num == 0 or mb_num >= mb_count:
        raise ValueError(f"a video packet at macroblock {mb_num} of {mb_count}")
    quant = r.bits(5)
    if r.bit():  # header_extension_code
        while r.bit():
            pass
        r.marker()
        r.bits(vol_bits)
        r.marker()
        coding_type = r.bits(2)
        r.bits(3)
        if coding_type != I_VOP:
            r.bits(3)
    return mb_num, quant


def parse_macroblocks_py(data, bitpos, prm, tables=None):
    """The sequential part of a VOP's decode, plainly written.  Returns
    (kinds (n,), quantisers (n,), coefficient blocks (n, 6, 64) int32, coded
    blocks (n, 6) bool, vectors (n, 4, 2) int32, the bit after the last
    macroblock); intra blocks hold quantised levels after prediction,
    inter blocks inverse-quantised ones."""
    tables = tables or T.tables()
    mb_w, mb_h, ctype, quant, fcode, _, dc_thr, resync, time_bits = (int(v) for v in prm[:9])
    n_mb = mb_w * mb_h
    r = BitReader(data, bitpos)
    kinds = np.zeros(n_mb, np.int32)
    quants = np.zeros(n_mb, np.int32)
    blocks = np.zeros((n_mb, 6, 64), np.int32)
    coded = np.zeros((n_mb, 6), bool)
    vectors = np.zeros((n_mb, 4, 2), np.int32)
    state = {
        "dc": [np.full((2 * mb_h + 1, 2 * mb_w + 1), 1024, np.int32),
               np.full((mb_h + 1, mb_w + 1), 1024, np.int32),
               np.full((mb_h + 1, mb_w + 1), 1024, np.int32)],
        "ac": [np.zeros((2 * mb_h + 1, 2 * mb_w + 1, 16), np.int32),
               np.zeros((mb_h + 1, mb_w + 1, 16), np.int32),
               np.zeros((mb_h + 1, mb_w + 1, 16), np.int32)],
        "qscale": np.zeros((mb_h, mb_w), np.int32),
        "resync_x": 0, "resync_y": 0, "first_line": True, "mb_h": mb_h,
    }
    mv = np.zeros((2 * mb_h + 1, 2 * mb_w + 2, 2), np.int32)
    qscale = quant
    mb = 0
    while mb < n_mb:
        mb_y, mb_x = divmod(mb, mb_w)
        if mb_x == state["resync_x"] and mb_y == state["resync_y"] + 1:
            state["first_line"] = False
        intra, dquant, cbpc, four = True, False, 0, False
        skipped = False
        if ctype == P_VOP:
            while True:
                if r.bit():
                    skipped = True
                    break
                cbpc = r.vlc(tables.inter_mcbpc)
                if cbpc != T.INTER_MCBPC_STUFFING:
                    break
            if not skipped:
                intra, dquant, four = bool(cbpc & 4), bool(cbpc & 8), bool(cbpc & 16)
        else:
            while True:
                cbpc = r.vlc(tables.intra_mcbpc)
                if cbpc != T.INTRA_MCBPC_STUFFING:
                    break
            dquant = bool(cbpc & 4)
        row, col = 2 * mb_y, 2 * mb_x
        if skipped:
            kinds[mb] = MB_SKIPPED
            mv[row + 1:row + 3, col + 1:col + 3] = 0
            _clean_intra(state, mb_x, mb_y)
        elif not intra:
            kinds[mb] = MB_INTER4V if four else MB_INTER
            cbp = (cbpc & 3) | ((r.vlc(tables.cbpy) ^ 15) << 2)
            if dquant:
                qscale = min(max(qscale + T.DQUANT[r.bits(2)], 1), 31)
            for i in range(4 if four else 1):
                px, py = _pred_motion(mv, row, col, i, state["first_line"], mb_x,
                                      state["resync_x"])
                mx = _decode_motion(r, tables, px, fcode)
                my = _decode_motion(r, tables, py, fcode)
                if four:
                    mv[row + 1 + (i >> 1), col + 1 + (i & 1)] = (mx, my)
                else:
                    mv[row + 1:row + 3, col + 1:col + 3] = (mx, my)
            vectors[mb] = mv[row + 1:row + 3, col + 1:col + 3].reshape(4, 2)
            qmul, qadd = 2 * qscale, (qscale - 1) | 1
            for n in range(6):
                if cbp & (32 >> n):
                    coded[mb, n] = True
                    _tcoef(r, tables, blocks[mb, n], T.ZIGZAG, -1, 0, qmul, qadd)
            _clean_intra(state, mb_x, mb_y)
        else:
            kinds[mb] = MB_INTRA
            ac_pred = r.bit()
            cbp = (cbpc & 3) | (r.vlc(tables.cbpy) << 2)
            use_dc_vlc = qscale < dc_thr
            if dquant:
                qscale = min(max(qscale + T.DQUANT[r.bits(2)], 1), 31)
            mv[row + 1:row + 3, col + 1:col + 3] = 0
            state["qscale"][mb_y, mb_x] = qscale
            for n in range(6):
                block = blocks[mb, n]
                scale = T.DC_SCALE[0 if n < 4 else 1][qscale]
                bx, by = _block_position(n, mb_x, mb_y)
                if use_dc_vlc:
                    size = r.vlc(tables.dc_luma if n < 4 else tables.dc_chroma)
                    diff = 0
                    if size:
                        code = r.bits(size)
                        diff = code if code >> (size - 1) else code - (1 << size) + 1
                        if size > 8:
                            r.marker()
                    level, direction = _pred_dc(state, n, bx, by, diff, mb_x, mb_y, scale)
                    block[0] = _w16(level)
                    start = 0
                else:
                    _, direction = _pred_dc(state, n, bx, by, 0, mb_x, mb_y, scale)
                    start = -1
                scan = T.ZIGZAG if not ac_pred else (
                    T.ALTERNATE_VERTICAL if direction == 0 else T.ALTERNATE_HORIZONTAL)
                if cbp & (32 >> n):
                    _tcoef(r, tables, block, scan, start, 1, 1, 0)
                if not use_dc_vlc:
                    level, direction = _pred_dc(state, n, bx, by, int(block[0]), mb_x, mb_y,
                                                scale)
                    block[0] = _w16(level)
                _pred_ac(state, block, n, bx, by, direction, ac_pred, mb_x, mb_y, qscale)
                coded[mb, n] = True
        quants[mb] = qscale
        state["qscale"][mb_y, mb_x] = qscale
        mb += 1
        if resync and mb < n_mb and _is_resync(r, ctype, fcode):
            mb_num, q = _packet_header(r, state, time_bits, n_mb)
            if mb_num != mb:
                raise ValueError(f"a video packet at macroblock {mb_num}, expected {mb}")
            if q:
                qscale = q
            state["resync_y"], state["resync_x"] = divmod(mb_num, mb_w)
            state["first_line"] = True
            _clean_buffers(state, state["resync_x"], state["resync_y"], mb_w)
    return kinds, quants, blocks, coded, vectors, r.pos


# ----------------------------------------------------------- reconstruction


def _wrap32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def simple_idct(blocks):
    """FFmpeg's ``simple_idct`` (8-bit, int16 coefficients) of (n, 64)
    blocks in raster order: the row pass with its DC-only shortcut and int16
    results, then the column pass; int64 results before the put or add."""
    b = blocks.reshape(-1, 8, 8).astype(np.int64)
    dc_only = ~np.any(b[:, :, 1:], axis=2)
    a0 = W4 * b[:, :, 0] + (1 << 10)
    a1, a2, a3 = a0.copy(), a0.copy(), a0.copy()
    a0 += W2 * b[:, :, 2] + W4 * b[:, :, 4] + W6 * b[:, :, 6]
    a1 += W6 * b[:, :, 2] - W4 * b[:, :, 4] - W2 * b[:, :, 6]
    a2 += -W6 * b[:, :, 2] - W4 * b[:, :, 4] + W2 * b[:, :, 6]
    a3 += -W2 * b[:, :, 2] + W4 * b[:, :, 4] - W6 * b[:, :, 6]
    b0 = W1 * b[:, :, 1] + W3 * b[:, :, 3] + W5 * b[:, :, 5] + W7 * b[:, :, 7]
    b1 = W3 * b[:, :, 1] - W7 * b[:, :, 3] - W1 * b[:, :, 5] - W5 * b[:, :, 7]
    b2 = W5 * b[:, :, 1] - W1 * b[:, :, 3] + W7 * b[:, :, 5] + W3 * b[:, :, 7]
    b3 = W7 * b[:, :, 1] - W5 * b[:, :, 3] + W3 * b[:, :, 5] - W1 * b[:, :, 7]
    rows = np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0],
                    axis=2)
    rows = _wrap32(rows) >> 11
    dc = np.repeat((b[:, :, :1] * 8), 8, axis=2)
    rows = np.where(dc_only[:, :, None], dc, rows)
    rows = ((rows + 32768) & 0xFFFF) - 32768  # stored as int16
    c = rows
    a0 = W4 * (c[:, 0] + 32)
    a1, a2, a3 = a0.copy(), a0.copy(), a0.copy()
    a0 += W2 * c[:, 2] + W4 * c[:, 4] + W6 * c[:, 6]
    a1 += W6 * c[:, 2] - W4 * c[:, 4] - W2 * c[:, 6]
    a2 += -W6 * c[:, 2] - W4 * c[:, 4] + W2 * c[:, 6]
    a3 += -W2 * c[:, 2] + W4 * c[:, 4] - W6 * c[:, 6]
    b0 = W1 * c[:, 1] + W3 * c[:, 3] + W5 * c[:, 5] + W7 * c[:, 7]
    b1 = W3 * c[:, 1] - W7 * c[:, 3] - W1 * c[:, 5] - W5 * c[:, 7]
    b2 = W5 * c[:, 1] - W1 * c[:, 3] + W7 * c[:, 5] + W3 * c[:, 7]
    b3 = W7 * c[:, 1] - W5 * c[:, 3] + W3 * c[:, 5] - W1 * c[:, 7]
    cols = np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0],
                    axis=1)
    return _wrap32(cols) >> 20


def dequantize_intra(blocks, quants):
    """``dct_unquantize_h263_intra`` of (n, 6, 64) quantised intra blocks:
    the DC times its scaler, the AC by the H.263 rule."""
    q = quants[:, None, None].astype(np.int64)
    out = blocks.astype(np.int64)
    ac = out[:, :, 1:]
    mag = np.abs(ac) * 2 * q + ((q - 1) | 1)
    out[:, :, 1:] = np.where(ac == 0, 0, np.sign(ac) * mag)
    scale = np.stack([T.DC_SCALE[0][quants]] * 4 + [T.DC_SCALE[1][quants]] * 2, axis=1)
    out[:, :, 0] *= scale
    return ((out + 32768) & 0xFFFF) - 32768


def _gather(ref, ys, xs, edge_h, edge_w):
    """ref[clip(y), clip(x)] for (n, h) rows and (n, w) columns."""
    ys = np.clip(ys, 0, edge_h - 1)
    xs = np.clip(xs, 0, edge_w - 1)
    return ref[ys[:, :, None], xs[:, None, :]].astype(np.int32)


def half_pel(ref, x0, y0, hx, hy, size, rounding, edge_w, edge_h, narrow=False):
    """Half-pel prediction of (n,) blocks of ``size`` at full-pel (x0, y0)
    with half flags (hx, hy), ``rounding`` 1 for the no-rounding averages.

    ``narrow`` (per block) marks FFmpeg's 8-wide copies (4MV luma, all
    chroma): on x86 its no-rounding horizontal and vertical averages of
    those (``put_no_rnd_pixels8_x2``/``_y2``, mmxext, builds that are not
    bit-exact) are ``pavgb`` with one pixel less one, saturated: the left
    one, and the one on an odd row of the block.  They differ from
    (a + b) >> 1 where that pixel is 0 and the other odd.  The 16-wide
    copies and the diagonal average are exact."""
    steps = np.arange(size + 1)
    p = _gather(ref, y0[:, None] + steps, x0[:, None] + steps, edge_h, edge_w)
    a, b = p[:, :-1, :-1], p[:, :-1, 1:]
    c, d = p[:, 1:, :-1], p[:, 1:, 1:]
    hx, hy = hx[:, None, None], hy[:, None, None]
    rnd = 1 - rounding
    x2, y2 = (a + b + rnd) >> 1, (a + c + rnd) >> 1
    if rounding:
        odd = (np.arange(size) % 2 == 1)[None, :, None]
        top = np.where(odd, np.maximum(a - 1, 0), a)
        bottom = np.where(odd, c, np.maximum(c - 1, 0))
        narrow = np.broadcast_to(np.asarray(narrow), hx.shape[:1])[:, None, None]
        x2 = np.where(narrow, (np.maximum(a - 1, 0) + b + 1) >> 1, x2)
        y2 = np.where(narrow, (top + bottom + 1) >> 1, y2)
    return np.where(hx & hy, (a + b + c + d + 1 + rnd) >> 2,
                    np.where(hx, x2, np.where(hy, y2, a)))


def chroma_vector_4mv(v):
    """The chroma vector of four luma vectors' sum (Table 7-9's rounding)."""
    tab = np.array([0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2])
    return tab[v & 15] + ((v >> 3) & ~1)


def reconstruct_py(kinds, quants, blocks, coded, vectors, prm, ref):
    """The pixels of a parsed VOP: (Y, U, V) planes of whole macroblocks;
    ``ref`` is the previous VOP's (or None for an I-VOP)."""
    mb_w, mb_h = int(prm[0]), int(prm[1])
    rounding, edge_w, edge_h = int(prm[5]), int(prm[9]), int(prm[10])
    width, height = int(prm[11]), int(prm[12])
    n = mb_w * mb_h
    mb_y, mb_x = np.divmod(np.arange(n), mb_w)
    pred = [np.zeros((n, 4, 8, 8), np.int32), np.zeros((n, 8, 8), np.int32),
            np.zeros((n, 8, 8), np.int32)]
    inter = kinds != MB_INTRA
    if inter.any():
        if ref is None:
            raise ValueError("a P-VOP without a reference")
        idx = np.nonzero(inter)[0]
        v = vectors[idx]
        four = kinds[idx] == MB_INTER4V
        for k in range(4):
            mx, my = v[:, k, 0], v[:, k, 1]
            x = mb_x[idx] * 16 + (k & 1) * 8 + (mx >> 1)
            y = mb_y[idx] * 16 + (k >> 1) * 8 + (my >> 1)
            hx, hy = mx & 1, my & 1
            # hpel_motion clips an 8x8 block's position to the VOL's size and
            # drops the half step there (16x16 prediction does not)
            x = np.where(four, np.clip(x, -16, width), x)
            y = np.where(four, np.clip(y, -16, height), y)
            hx = np.where(four & (x == width), 0, hx)
            hy = np.where(four & (y == height), 0, hy)
            pred[0][idx, k] = half_pel(ref[0], x, y, hx, hy, 8, rounding, edge_w, edge_h,
                                       narrow=four)
        sx, sy = v[:, :, 0].sum(axis=1), v[:, :, 1].sum(axis=1)
        cx = np.where(four, chroma_vector_4mv(sx), v[:, 0, 0])
        cy = np.where(four, chroma_vector_4mv(sy), v[:, 0, 1])
        # 1MV: (16 mb + mv >> 1) >> 1, half when mv & 3; 4MV: the rounded sum
        ux = np.where(four, mb_x[idx] * 8 + (cx >> 1), (mb_x[idx] * 16 + (cx >> 1)) >> 1)
        uy = np.where(four, mb_y[idx] * 8 + (cy >> 1), (mb_y[idx] * 16 + (cy >> 1)) >> 1)
        hx = np.where(four, cx & 1, ((cx & 1) | ((cx & 2) >> 1)))
        hy = np.where(four, cy & 1, ((cy & 1) | ((cy & 2) >> 1)))
        ux = np.where(four, np.clip(ux, -8, width >> 1), ux)  # chroma_4mv_motion's clip
        uy = np.where(four, np.clip(uy, -8, height >> 1), uy)
        hx = np.where(four & (ux == width >> 1), 0, hx)
        hy = np.where(four & (uy == height >> 1), 0, hy)
        for p in (1, 2):
            pred[p][idx] = half_pel(ref[p], ux, uy, hx, hy, 8, rounding, edge_w >> 1,
                                    edge_h >> 1, narrow=True)
    intra = kinds == MB_INTRA
    coefs = ((blocks.astype(np.int64) + 32768) & 0xFFFF) - 32768  # FFmpeg's int16 blocks
    if intra.any():
        coefs[intra] = dequantize_intra(coefs[intra], quants[intra])
    res = simple_idct(coefs.reshape(-1, 64)).reshape(n, 6, 8, 8)
    res = np.where(coded[:, :, None, None], res, 0)
    base = np.concatenate([pred[0], pred[1][:, None], pred[2][:, None]], axis=1)
    out = np.clip(np.where(intra[:, None, None, None], 0, base) + res, 0, 255).astype(np.uint8)
    y = out[:, :4].reshape(mb_h, mb_w, 2, 2, 8, 8).transpose(0, 2, 4, 1, 3, 5).reshape(
        mb_h * 16, mb_w * 16)
    u = out[:, 4].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3).reshape(mb_h * 8, mb_w * 8)
    v_ = out[:, 5].reshape(mb_h, mb_w, 8, 8).transpose(0, 2, 1, 3).reshape(mb_h * 8, mb_w * 8)
    return y, u, v_


_NATIVE_TABLES = None


def native_tables():
    """The lookups and tables of ``mpeg4_tables`` packed into one int32
    array for the C++ loops: the offsets of its parts, then the parts (a
    lookup is its bits, its symbols, its lengths)."""
    global _NATIVE_TABLES
    if _NATIVE_TABLES is None:
        t = T.tables()

        def vlc(table):
            sym, length = table
            return np.concatenate([[len(sym).bit_length() - 1], sym, length])

        parts = [vlc(t.intra_mcbpc), vlc(t.inter_mcbpc), vlc(t.cbpy), vlc(t.mvd),
                 vlc(t.dc_luma), vlc(t.dc_chroma), vlc(t.tcoef[0]), vlc(t.tcoef[1]),
                 t.runs[0], t.runs[1], t.levels[0], t.levels[1], t.lmax[0].ravel(),
                 t.lmax[1].ravel(), t.rmax[0].ravel(), t.rmax[1].ravel(), T.SCANS.ravel(),
                 np.concatenate([T.DC_SCALE[0], T.DC_SCALE[1]])]
        # the writer's: (code, length) pairs, then (last, run, level) -> index
        parts += [np.asarray(c, np.int32).ravel() for c in (
            T.INTRA_MCBPC, T.INTER_MCBPC, T.CBPY, T.MVD, T.DC_SIZE_LUMA, T.DC_SIZE_CHROMA,
            T.INTER_TCOEF, T.INTRA_TCOEF)]
        for runs, levels, last_from in ((T.INTER_RUN, T.INTER_LEVEL, T.INTER_LAST),
                                        (T.INTRA_RUN, T.INTRA_LEVEL, T.INTRA_LAST)):
            index = np.full((2, 64, 64), -1, np.int32)
            for i, (run, level) in enumerate(zip(runs, levels)):
                index[int(i >= last_from), run, level] = i
            parts.append(index.ravel())
        offsets, at = [], len(parts)
        for part in parts:
            offsets.append(at)
            at += len(part)
        _NATIVE_TABLES = np.ascontiguousarray(
            np.concatenate([offsets] + [np.asarray(p) for p in parts]).astype(np.int32))
    return _NATIVE_TABLES


def _ptr(array):
    return array.ctypes.data if array is not None else None


def decode_vop_native(data, bitpos, prm, ref):
    """``decode_vop_py`` in C++ (``omv_decode_vop``): the same planes and end
    bit."""
    from .. import kernels

    lib = kernels.host_library("mpeg4_host")
    mb_w, mb_h = int(prm[0]), int(prm[1])
    if ref is not None and ref[0].shape != (16 * mb_h, 16 * mb_w):
        raise ValueError(f"a reference of {ref[0].shape} for a VOP of {16 * mb_h}x{16 * mb_w}")
    buf = np.frombuffer(bytes(data) + bytes(8), np.uint8)
    out = (np.empty((16 * mb_h, 16 * mb_w), np.uint8), np.empty((8 * mb_h, 8 * mb_w), np.uint8),
           np.empty((8 * mb_h, 8 * mb_w), np.uint8))
    ref = [np.ascontiguousarray(p) for p in ref] if ref is not None else [None] * 3
    prm = np.ascontiguousarray(prm, np.int32)
    end = lib.omv_decode_vop(buf.ctypes.data, len(data), bitpos, prm.ctypes.data,
                             native_tables().ctypes.data, _ptr(ref[0]), _ptr(ref[1]),
                             _ptr(ref[2]), out[0].ctypes.data, out[1].ctypes.data,
                             out[2].ctypes.data)
    if end < 0:
        raise ValueError(f"a corrupt VOP: {lib.omv_error_string(end).decode()}")
    return out, end


def decode_vop_py(data, bitpos, prm, ref, tables=None):
    """A VOP's macroblocks decoded by the plain version: ((Y, U, V), the
    bit after the last macroblock)."""
    kinds, quants, blocks, coded, vectors, end = parse_macroblocks_py(data, bitpos, prm, tables)
    return reconstruct_py(kinds, quants, blocks, coded, vectors, prm, ref), end


class Decoder:
    """Decodes one stream's packets, in order, to (Y, U, V) planes of the
    VOL's size; ``extradata`` is a container's decoder configuration (MP4's
    VOL in ``esds``), read before the first packet.  ``native`` selects
    the C++ macroblock loop (the default) or the plain version."""

    def __init__(self, extradata=b"", native=True, codec_tag=b""):
        self.vol = self.ref = None
        self.held = None  # without low_delay: the last frame, shown at the next one
        self.codec_tag = bytes(codec_tag)
        self.lavc = False  # libavcodec's user data seen
        self.native = native
        if extradata:
            self._headers(bytes(extradata), allow_vop=False)

    def _headers(self, data, allow_vop=True):
        """Parse the start codes of ``data``; the VOP's (offset, header) or
        None."""
        vop = None
        for at, code in start_codes(data):
            if code <= 0x1F:  # video_object_start_code
                continue
            if 0x20 <= code <= 0x2F:
                vol = Vol(data[at:])
                if self.vol is None or (vol.width, vol.height) != (self.vol.width,
                                                                   self.vol.height):
                    self.ref = None  # a new size: P-VOPs wait for the next I-VOP
                self.vol = vol
            elif code == 0xB6:
                if not allow_vop:
                    raise ValueError("a VOP in the decoder configuration")
                if vop is not None:
                    raise UnsupportedMpeg4("a DivX packed bitstream (two VOPs in one packet)")
                vop = at
            elif code == 0xB5:
                r = BitReader(data[at:])
                if r.bit():
                    r.bits(7)
                kind = r.bits(4)
                if kind != 1:
                    raise UnsupportedMpeg4(f"a visual object of type {kind} (video only)")
            elif code == 0xB2:
                self._user_data(data[at:at + 16])
            elif code in (0xB0, 0xB1, 0xB3):
                continue  # sequence start and end, group of VOPs
            elif 0x40 <= code <= 0x5F:
                raise UnsupportedMpeg4("a fine granularity scalable layer")
        return vop

    def _user_data(self, text):
        """FFmpeg picks its IDCT by the encoder the user data names: XviD's
        and DivX's streams get other IDCTs and workarounds, not ported."""
        if text.startswith((b"XviD", b"DivX")):
            raise UnsupportedMpeg4(f"a {text[:4].decode()} stream (FFmpeg decodes it with that "
                                   "encoder's IDCT and workarounds)")
        if text.startswith((b"Lavc", b"FFmpe")):
            self.lavc = True

    def decode(self, packet):
        """The frames one packet holds: [(Y, U, V)], or [] for a packet of
        headers only or a VOP that is not coded (FFmpeg outputs none)."""
        data = bytes(packet)
        if data[:3] != b"\0\0\1":
            if data[:2] == b"\0\0" and len(data) > 2 and data[2] & 0xFC == 0x80:
                raise UnsupportedMpeg4("the short video header (H.263)")
        at = self._headers(data)
        if at is None:
            return []
        if self.vol is None:
            raise ValueError("a VOP before any video object layer header")
        if self.codec_tag in XVID_TAGS and not self.lavc:
            raise UnsupportedMpeg4(f"a {self.codec_tag.decode('latin-1')!r}-tagged stream "
                                   "without libavcodec's user data (FFmpeg decodes it as XviD's)")
        vop = Vop(data[at:], self.vol)
        if not vop.coded:
            return []
        if vop.coding_type == P_VOP and self.ref is None:
            return []  # FFmpeg skips P-VOPs until the first I-VOP
        prm = params(self.vol, vop)
        payload = data[at:]
        if self.native:
            planes, _ = decode_vop_native(payload, vop.bitpos, prm, self.ref)
        else:
            planes, _ = decode_vop_py(payload, vop.bitpos, prm, self.ref)
        self.ref = planes
        w, h = self.vol.width, self.vol.height
        frame = (planes[0][:h, :w], planes[1][:(h + 1) // 2, :(w + 1) // 2],
                 planes[2][:(h + 1) // 2, :(w + 1) // 2])
        if self.vol.low_delay:
            return [frame]
        # B-VOPs may follow, to be shown before this VOP: FFmpeg shows it
        # one VOP late, and the frames before a refused B-VOP stay in order
        shown, self.held = self.held, frame
        return [] if shown is None else [shown]

    def flush(self):
        """The frame still held back at the end of a stream without
        ``low_delay``: [(Y, U, V)] or []."""
        shown, self.held = self.held, None
        return [] if shown is None else [shown]
