"""MPEG-4 Part 2 (ISO/IEC 14496-2) Simple and Advanced Simple Profile
video, decoded as FFmpeg's ``mpeg4`` decoder decodes it (the decoder behind
``cv2.VideoCapture`` for ``mp4v``, XviD and DivX streams), without cv2 or
FFmpeg.

The headers (visual object sequence, visual object, video object layer,
group of VOPs, user data, VOP) are parsed here.  A VOP's macroblocks are
decoded in two parts:

* ``parse_macroblocks_py``: the sequential part, plainly written: MCBPC,
  CBPY, DQUANT, the intra DC (by its VLC or among the AC coefficients, after
  ``intra_dc_vlc_thr``), DC and AC prediction with ``ac_pred_flag``, TCOEF
  with its three escapes, the H.263 inverse quantisation of inter blocks,
  1MV and 4MV median prediction, ``not_coded`` macroblocks, resync markers
  with their video packet headers, data partitioning (the motion or DC
  partition, its marker, then the texture); and the B-VOP's macroblocks:
  MODB, MB_TYPE (direct, interpolated, backward, forward), DBQUANT, the
  forward and backward vectors (``f_code``, ``b_code``) predicted from the
  last of their direction, and direct mode from the co-located macroblock
  of the future reference (its 1 or 4 vectors scaled by ``TRB``/``TRD``); a
  B macroblock whose co-located one was skipped is skipped;
* ``reconstruct_py``: the inverse quantisation of intra blocks (H.263, or
  MPEG quantisation with its matrices and, for inter blocks, its mismatch
  control), FFmpeg's ``simple_idct`` or, for XviD's streams, XviD's IDCT
  (``xvid_idct``), and motion compensation over the edge-replicated
  references: half-pel with ``vop_rounding_type`` (``half_pel``) or
  quarter-pel with MPEG-4's 8-tap filter mirrored at the block's edges
  (``qpel``), the chroma vectors' rounding, and a B macroblock's two
  predictions averaged.

Together they are the spec of ``decode_vop_native``, the loop the reader
runs: the same per macroblock in C++ (``csrc/mpeg4_host.cc``), built with
the host compiler at first use (``kernels.host_library``).  It raises if it
cannot be built; nothing falls back to Python.

``Decoder`` keeps FFmpeg's state across packets: the two references and the
display order (a stream without ``low_delay`` is shown one reference late,
B-VOPs at once; a B-VOP clears the ``low_delay`` guessed for a VOL without
vol_control_parameters), the encoder that the user data names (``Lavc``, ``XviD``,
``DivX``; an ``XVID``-tagged stream without any is XviD's) with the IDCT and
the workarounds FFmpeg derives from it, and DivX's packed bitstreams (a
second VOP in a packet is held back for the next packet, which then only
carries a placeholder).

Refused, each by its name: interlaced video, static sprites and GMC,
reversible VLC, shapes other than rectangular, the short video header
(H.263), ``newpred``, reduced-resolution VOPs, scalability and complexity
estimation headers, and pixels of other than 8 bits.
"""

import re

import numpy as np

from . import mpeg4_tables as T

REFUSAL = "ROADMAP Queue 1 item 1, 'What the infer CLI still refuses'"
I_VOP, P_VOP, B_VOP, S_VOP = 0, 1, 2, 3
# AVI tags FFmpeg takes for XviD's streams when no user data names the encoder
XVID_TAGS = (b"XVID", b"XVIX", b"RMP4", b"ZMP4", b"SIPP")
# macroblock kinds in the parse
MB_INTRA, MB_INTER, MB_SKIPPED, MB_INTER4V = 0, 1, 2, 3
W1, W2, W3, W4, W5, W6, W7 = 22725, 21407, 19266, 16383, 12873, 8867, 4520
# FFmpeg's workarounds that change planes (FF_BUG_*), as a bit mask
BUG_DC_CLIP, BUG_QPEL_CHROMA, BUG_QPEL_CHROMA2, BUG_EDGE = 1, 2, 4, 8
IDCT_SIMPLE, IDCT_XVID = 0, 1
# the parameter vector of the macroblock loops, by index
(P_MB_W, P_MB_H, P_TYPE, P_QUANT, P_FCODE, P_ROUNDING, P_DC_THR, P_RESYNC, P_TIME_BITS,
 P_EDGE_W, P_EDGE_H, P_WIDTH, P_HEIGHT, P_BCODE, P_QUANT_TYPE, P_QPEL, P_PARTITIONED, P_IDCT,
 P_BUGS, P_PP_TIME, P_PB_TIME, PRM_LEN) = range(22)
DC_MARKER, MOTION_MARKER = 0x6B001, 0x1F001  # 19 and 17 bits
MAX_NVOP_SIZE = 19  # a packet this small may be a packed stream's placeholder


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


def _matrix(r):
    """A quantisation matrix loaded in a VOL: up to 64 values in zigzag
    order, a 0 ending it early (the last value repeats), in raster order."""
    out = np.zeros(64, np.int32)
    last = 0
    for i in range(64):
        v = r.bits(8)
        if v == 0:
            out[T.ZIGZAG[i:]] = last
            return out
        last = v
        out[T.ZIGZAG[i]] = v
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
        self.vol_control = bool(r.bit())
        self.low_delay = None  # FFmpeg's rule where the VOL has no vol_control_parameters
        if self.vol_control:
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
            raise UnsupportedMpeg4("static sprites" if sprite == 1 else
                                   "GMC (global motion compensation, sprite_enable 2)")
        if r.bit():
            raise UnsupportedMpeg4("pixels of other than 8 bits (not_8_bit)")
        self.quant_type = r.bit()
        self.intra_matrix = T.DEFAULT_INTRA_MATRIX.copy()
        self.inter_matrix = T.DEFAULT_INTER_MATRIX.copy()
        if self.quant_type:
            if r.bit():
                self.intra_matrix = _matrix(r)
            if r.bit():
                self.inter_matrix = _matrix(r)
        self.quarter_sample = r.bit() if verid != 1 else 0
        if not r.bit():
            raise UnsupportedMpeg4("complexity estimation headers")
        self.resync = not r.bit()
        self.partitioned = r.bit()
        if self.partitioned and r.bit():
            raise UnsupportedMpeg4("reversible VLC (reversible_vlc 1)")
        if verid != 1:
            if r.bit():
                raise UnsupportedMpeg4("newpred")
            if r.bit():
                raise UnsupportedMpeg4("reduced-resolution VOPs")
        if r.bit():
            raise UnsupportedMpeg4("scalability")
        self.mb_width = (self.width + 15) // 16
        self.mb_height = (self.height + 15) // 16

    def matrices(self):
        """The intra then the inter matrix, raster order, as one int32 array."""
        return np.ascontiguousarray(np.concatenate([self.intra_matrix, self.inter_matrix]),
                                    np.int32)


class Vop:
    """A VOP header: coding type, time, coded, rounding, DC threshold,
    quantiser, f_code and b_code, and the bit where its macroblocks start."""

    def __init__(self, data, vol):
        r = BitReader(data)
        self.coding_type = r.bits(2)
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
        self.fcode = self.bcode = 1
        if self.coded:
            if self.coding_type == P_VOP:
                self.rounding = r.bit()
            self.dc_threshold = T.INTRA_DC_THRESHOLD[r.bits(3)]
            self.quant = r.bits(5)
            if self.quant == 0:
                raise ValueError("a VOP quantiser of 0")
            if self.coding_type != I_VOP:
                self.fcode = r.bits(3)
                if self.fcode == 0:
                    raise ValueError("a VOP f_code of 0")
            if self.coding_type == B_VOP:
                self.bcode = r.bits(3)
                if self.bcode == 0:
                    raise ValueError("a VOP b_code of 0")
        self.bitpos = r.pos


def params(vol, vop, bugs=0, idct=IDCT_SIMPLE, pp_time=1, pb_time=0):
    """The int32 parameter vector of the macroblock loops.  Motion vectors
    reach past the edge of the whole macroblocks (FFmpeg's ``h_edge_pos``
    and ``v_edge_pos``), not of the VOL's size, unless FFmpeg's edge
    workaround is on; the 8x8 blocks of 4MV macroblocks are first clipped to
    the VOL's size (``hpel_motion``)."""
    edge_w, edge_h = 16 * vol.mb_width, 16 * vol.mb_height
    if bugs & BUG_EDGE:
        edge_w, edge_h = vol.width, vol.height
    prm = np.zeros(PRM_LEN, np.int32)
    prm[:P_BCODE] = [vol.mb_width, vol.mb_height, vop.coding_type, vop.quant, vop.fcode,
                     vop.rounding, vop.dc_threshold, int(vol.resync), vol.time_bits,
                     edge_w, edge_h, vol.width, vol.height]
    prm[P_BCODE:] = [vop.bcode, vol.quant_type, vol.quarter_sample, vol.partitioned, idct,
                     bugs, pp_time, pb_time]
    return prm


# ---------------------------------------------------------------- the parse


def _pred_motion(mv, block_row, block_col, block, first_line, mb_x, resync_x):
    """``ff_h263_pred_motion``: the median predictor of 8x8 block ``block``
    of the macroblock whose top-left block is (block_row, block_col) in the
    padded vector array ``mv`` (one row and column of zeros before, a column
    after), which it may change as FFmpeg's does."""
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
            # FFmpeg zeroes the left macroblock's stored vector here (after
            # that macroblock was predicted); a later B-VOP's direct mode and
            # the vectors predicted from it read the zero
            mv[y, x - 1] = 0
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
    levels inverse-quantised as they are read (FFmpeg's rl_vlc[qscale]),
    unless ``qmul`` is 1 and ``qadd`` 0 (intra blocks, MPEG quantisation)."""
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
    DC times ``scale`` is stored for the blocks after (clipped to 0..2047,
    not above with FFmpeg's DC clip workaround)."""
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
        stored = 0 if stored < 0 else stored if state["dc_clip"] else 2047
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


def _cdiv(a, b):
    """C's integer division (truncating toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


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


def _prefix(ctype, fcode, bcode):
    """The resync marker's zeros (``ff_mpeg4_get_video_packet_prefix_length``)."""
    if ctype == I_VOP:
        return 16
    if ctype == B_VOP:
        return max(fcode, bcode, 2) + 15
    return 15 + fcode


def _is_resync(r, prefix):
    """Whether stuffing to the next byte, then a resync marker, follows."""
    pos = r.pos
    stuffing = 8 - (pos & 7)
    if pos + stuffing + 17 > r.size:
        return False
    if r.peek(stuffing) != (1 << (stuffing - 1)) - 1:
        return False
    saved = r.pos
    r.pos = pos + stuffing
    ok = r.peek(prefix + 1) == 1
    r.pos = saved
    return ok


def _packet_header(r, ctype, vol_bits, mb_count):
    """A video packet header after the stuffing: the next macroblock, the
    quantiser, and the header extension's fields (read, not used)."""
    r.bits(1)
    r.align()
    while not r.bit():
        pass
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
        r.bits(2)  # its coding type; FFmpeg reads on by the VOP's
        r.bits(3)
        if ctype != I_VOP:
            r.bits(3)
        if ctype == B_VOP:
            r.bits(3)
    return mb_num, quant


def _b_mb_type(r):
    """MB_TYPE of a B macroblock: 0 direct ('1'), 1 interpolated ('01'),
    2 backward ('001'), 3 forward ('0001')."""
    for k in range(4):
        if r.bit():
            return k
    raise ValueError(f"an invalid B macroblock type at bit {r.pos}")


def direct_vectors(col_four, col_mv, dx, dy, pp, pb):
    """``ff_mpeg4_set_direct_mv``: the forward and backward vectors (4, 2)
    each of a direct macroblock from the co-located one's vectors
    ``col_mv`` (4, 2) (1 used unless ``col_four``) and the delta (dx, dy)."""
    fwd = np.zeros((4, 2), np.int32)
    bwd = np.zeros((4, 2), np.int32)
    for i in range(4 if col_four else 1):
        for c, d in ((0, dx), (1, dy)):
            p = int(col_mv[i][c])
            fwd[i, c] = _cdiv(p * pb, pp) + d
            bwd[i, c] = fwd[i, c] - p if d else _cdiv(p * (pb - pp), pp)
    if not col_four:
        fwd[1:] = fwd[0]
        bwd[1:] = bwd[0]
    return fwd, bwd


def _new_state(mb_w, mb_h, dc_clip):
    return {
        "dc": [np.full((2 * mb_h + 1, 2 * mb_w + 1), 1024, np.int32),
               np.full((mb_h + 1, mb_w + 1), 1024, np.int32),
               np.full((mb_h + 1, mb_w + 1), 1024, np.int32)],
        "ac": [np.zeros((2 * mb_h + 1, 2 * mb_w + 1, 16), np.int32),
               np.zeros((mb_h + 1, mb_w + 1, 16), np.int32),
               np.zeros((mb_h + 1, mb_w + 1, 16), np.int32)],
        "qscale": np.zeros((mb_h, mb_w), np.int32),
        "resync_x": 0, "resync_y": 0, "first_line": True, "dc_clip": dc_clip,
    }


def new_mbs(n_mb):
    """The parse's output: each macroblock's kind, quantiser, coefficient
    blocks (intra ones quantised levels after prediction, inter ones
    inverse-quantised by H.263 or quantised levels for MPEG quantisation),
    coded blocks, vectors (forward, backward) x (4 blocks) x (x, y) and
    directions (1 forward, 2 backward)."""
    return {"kinds": np.zeros(n_mb, np.int32), "quants": np.zeros(n_mb, np.int32),
            "blocks": np.zeros((n_mb, 6, 64), np.int32), "coded": np.zeros((n_mb, 6), bool),
            "mv": np.zeros((n_mb, 2, 4, 2), np.int32), "dirs": np.zeros(n_mb, np.int32)}


def _intra_dc(r, tables, state, n, mb_x, mb_y, qscale):
    """The intra DC by its VLC, predicted: (its level, the direction)."""
    size = r.vlc(tables.dc_luma if n < 4 else tables.dc_chroma)
    diff = 0
    if size:
        code = r.bits(size)
        diff = code if code >> (size - 1) else code - (1 << size) + 1
        if size > 8:
            r.marker()
    bx, by = _block_position(n, mb_x, mb_y)
    scale = int(T.DC_SCALE[0 if n < 4 else 1][qscale])
    return _pred_dc(state, n, bx, by, diff, mb_x, mb_y, scale)


def _intra_blocks(r, tables, state, blocks, mb_x, mb_y, qscale, cbp, ac_pred, use_dc_vlc,
                  dcs=None):
    """An intra macroblock's six blocks (``mpeg4_decode_block``); ``dcs``:
    the (stored DC, direction) of each block where a data partition held
    them."""
    for n in range(6):
        block = blocks[n]
        scale = int(T.DC_SCALE[0 if n < 4 else 1][qscale])
        bx, by = _block_position(n, mb_x, mb_y)
        if dcs is not None:
            stored, direction = dcs[n]
            block[0] = _w16((stored + (scale >> 1)) // scale)
            start = 0
        elif use_dc_vlc:
            level, direction = _intra_dc(r, tables, state, n, mb_x, mb_y, qscale)
            block[0] = _w16(level)
            start = 0
        else:
            _, direction = _pred_dc(state, n, bx, by, 0, mb_x, mb_y, scale)
            start = -1
        scan = T.ZIGZAG if not ac_pred else (
            T.ALTERNATE_VERTICAL if direction == 0 else T.ALTERNATE_HORIZONTAL)
        if cbp & (32 >> n):
            _tcoef(r, tables, block, scan, start, 1, 1, 0)
        if dcs is None and not use_dc_vlc:
            level, direction = _pred_dc(state, n, bx, by, int(block[0]), mb_x, mb_y, scale)
            block[0] = _w16(level)
        _pred_ac(state, block, n, bx, by, direction, ac_pred, mb_x, mb_y, qscale)


def _inter_blocks(r, tables, blocks, coded, cbp, qscale, quant_type):
    if quant_type:
        qmul, qadd = 1, 0
    else:
        qmul, qadd = 2 * qscale, (qscale - 1) | 1
    for n in range(6):
        if cbp & (32 >> n):
            coded[n] = True
            _tcoef(r, tables, blocks[n], T.ZIGZAG, -1, 0, qmul, qadd)


def parse_macroblocks_py(data, bitpos, prm, colocated=None, tables=None):
    """The sequential part of a VOP's decode, plainly written: the
    macroblocks (``new_mbs``) and the bit after the last one.
    ``colocated``: for a B-VOP, the future reference's (kinds, stored
    forward vectors)."""
    tables = tables or T.tables()
    mb_w, mb_h, ctype, quant, fcode = (int(v) for v in prm[:5])
    dc_thr, resync, time_bits = int(prm[P_DC_THR]), int(prm[P_RESYNC]), int(prm[P_TIME_BITS])
    bcode, quant_type = int(prm[P_BCODE]), int(prm[P_QUANT_TYPE])
    n_mb = mb_w * mb_h
    r = BitReader(data, bitpos)
    mbs = new_mbs(n_mb)
    state = _new_state(mb_w, mb_h, bool(prm[P_BUGS] & BUG_DC_CLIP))
    if prm[P_PARTITIONED] and ctype != B_VOP:
        _parse_partitioned(r, tables, prm, mbs, state)
        return mbs, r.pos
    kinds, quants, blocks, coded = mbs["kinds"], mbs["quants"], mbs["blocks"], mbs["coded"]
    mv = np.zeros((2 * mb_h + 1, 2 * mb_w + 2, 2), np.int32)
    last_mv = [[0, 0], [0, 0]]  # a B-VOP's forward and backward predictors
    prefix = _prefix(ctype, fcode, bcode)
    if ctype == B_VOP:
        if colocated is None:
            raise ValueError("a B-VOP without the future reference's macroblocks")
        col_kinds, col_mv = colocated
    qscale = quant
    mb = 0
    while mb < n_mb:
        mb_y, mb_x = divmod(mb, mb_w)
        if mb_x == state["resync_x"] and mb_y == state["resync_y"] + 1:
            state["first_line"] = False
        row, bcol = 2 * mb_y, 2 * mb_x
        if ctype == B_VOP:
            if mb_x == 0:
                last_mv = [[0, 0], [0, 0]]
            qscale = _parse_b_mb(r, tables, mbs, mb, qscale, fcode, bcode, quant_type, prm,
                                 int(col_kinds[mb]), col_mv[mb], last_mv)
        else:
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
            if skipped:
                kinds[mb] = MB_SKIPPED
                mbs["dirs"][mb] = 1
                mv[row + 1:row + 3, bcol + 1:bcol + 3] = 0
                _clean_intra(state, mb_x, mb_y)
            elif not intra:
                kinds[mb] = MB_INTER4V if four else MB_INTER
                mbs["dirs"][mb] = 1
                cbp = (cbpc & 3) | ((r.vlc(tables.cbpy) ^ 15) << 2)
                if dquant:
                    qscale = min(max(qscale + T.DQUANT[r.bits(2)], 1), 31)
                for i in range(4 if four else 1):
                    px, py = _pred_motion(mv, row, bcol, i, state["first_line"], mb_x,
                                          state["resync_x"])
                    mx = _decode_motion(r, tables, px, fcode)
                    my = _decode_motion(r, tables, py, fcode)
                    if four:
                        mv[row + 1 + (i >> 1), bcol + 1 + (i & 1)] = (mx, my)
                    else:
                        mv[row + 1:row + 3, bcol + 1:bcol + 3] = (mx, my)
                mbs["mv"][mb, 0] = mv[row + 1:row + 3, bcol + 1:bcol + 3].reshape(4, 2)
                _inter_blocks(r, tables, blocks[mb], coded[mb], cbp, qscale, quant_type)
                _clean_intra(state, mb_x, mb_y)
            else:
                kinds[mb] = MB_INTRA
                ac_pred = r.bit()
                cbp = (cbpc & 3) | (r.vlc(tables.cbpy) << 2)
                use_dc_vlc = qscale < dc_thr
                if dquant:
                    qscale = min(max(qscale + T.DQUANT[r.bits(2)], 1), 31)
                mv[row + 1:row + 3, bcol + 1:bcol + 3] = 0
                state["qscale"][mb_y, mb_x] = qscale
                _intra_blocks(r, tables, state, blocks[mb], mb_x, mb_y, qscale, cbp, ac_pred,
                              use_dc_vlc)
                coded[mb] = True
        quants[mb] = qscale
        state["qscale"][mb_y, mb_x] = qscale
        mb += 1
        if resync and mb < n_mb and _is_resync(r, prefix):
            saved = r.pos
            mb_num, q = _packet_header(r, ctype, time_bits, n_mb)
            if mb_num != mb:
                if ctype == B_VOP and mb_num > mb and col_kinds[mb] == MB_SKIPPED:
                    r.pos = saved  # skipped B macroblocks come before the packet's first
                    continue
                raise ValueError(f"a video packet at macroblock {mb_num}, expected {mb}")
            if q:
                qscale = q
            state["resync_y"], state["resync_x"] = divmod(mb_num, mb_w)
            state["first_line"] = True
            last_mv = [[0, 0], [0, 0]]
            _clean_buffers(state, state["resync_x"], state["resync_y"], mb_w)
    mbs["stored"] = _stored_vectors(mv, mb_w, mb_h)
    return mbs, r.pos


def _stored_vectors(mv, mb_w, mb_h):
    """Each macroblock's forward vectors (n, 4, 2) as the padded array
    holds them once the VOP is parsed: what a later B-VOP's direct mode
    reads (FFmpeg's ``motion_val``)."""
    blocks = mv[1:, 1:2 * mb_w + 1].reshape(mb_h, 2, mb_w, 2, 2).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(blocks.reshape(mb_h * mb_w, 4, 2))


def _parse_b_mb(r, tables, mbs, mb, qscale, fcode, bcode, quant_type, prm, col_kind, col_mv,
                last_mv):
    """One B macroblock (``mpeg4_decode_mb``'s B branch); returns the
    quantiser after it."""
    if col_kind == MB_SKIPPED:  # skipped in the future reference: skipped here
        mbs["kinds"][mb] = MB_SKIPPED
        mbs["dirs"][mb] = 1
        return qscale
    if r.bit():  # modb '1': direct, no vectors, no coefficients
        mb_type, cbp, dx, dy = 0, 0, 0, 0
    else:
        modb2 = r.bit()
        mb_type = _b_mb_type(r)
        cbp = 0 if modb2 else r.bits(6)
        if mb_type != 0 and cbp and r.bit():
            qscale = min(max(qscale + r.bit() * 4 - 2, 1), 31)
        if mb_type != 0:
            dirs = (0, 3, 2, 1)[mb_type]
            mbs["dirs"][mb] = dirs
            mbs["kinds"][mb] = MB_INTER
            for d, code in ((0, fcode), (1, bcode)):
                if dirs & (1 << d):
                    mx = _decode_motion(r, tables, last_mv[d][0], code)
                    my = _decode_motion(r, tables, last_mv[d][1], code)
                    last_mv[d] = [mx, my]
                    mbs["mv"][mb, d] = (mx, my)
        else:
            dx = _decode_motion(r, tables, 0, 1)
            dy = _decode_motion(r, tables, 0, 1)
    if mb_type == 0:
        col_four = col_kind == MB_INTER4V
        fwd, bwd = direct_vectors(col_four, col_mv, dx, dy, int(prm[P_PP_TIME]),
                                  int(prm[P_PB_TIME]))
        mbs["mv"][mb, 0], mbs["mv"][mb, 1] = fwd, bwd
        mbs["dirs"][mb] = 3
        # FFmpeg's direct-blocksize workaround (DivX, old libavcodec) is set on
        # its decoder's copy of the flags and read from the codec context's,
        # so it never applies: quarter-pel direct macroblocks are 8x8
        four = col_four or bool(prm[P_QPEL])
        mbs["kinds"][mb] = MB_INTER4V if four else MB_INTER
    _inter_blocks(r, tables, mbs["blocks"][mb], mbs["coded"][mb], cbp, qscale, quant_type)
    return qscale


def _parse_partitioned(r, tables, prm, mbs, state):
    """An I- or P-VOP with data partitioning: in each video packet, the
    first partition (MCBPC, DQUANT and the intra DCs of an I-VOP; the
    not_coded bits, MCBPC and vectors of a P-VOP), its marker, the second
    (ac_pred_flag and CBPY; a P-VOP's DQUANT and intra DCs too), then the
    texture (``ff_mpeg4_decode_partitions``)."""
    mb_w, mb_h, ctype, quant, fcode = (int(v) for v in prm[:5])
    dc_thr, time_bits = int(prm[P_DC_THR]), int(prm[P_TIME_BITS])
    quant_type = int(prm[P_QUANT_TYPE])
    n_mb = mb_w * mb_h
    kinds, quants, blocks, coded = mbs["kinds"], mbs["quants"], mbs["blocks"], mbs["coded"]
    mv = np.zeros((2 * mb_h + 1, 2 * mb_w + 2, 2), np.int32)
    qscale = quant
    start = 0
    while True:
        # partition A
        info = []  # each macroblock's (cbpc, dcs or None)
        mb = start
        state["first_line"] = True
        while mb < n_mb:
            mb_y, mb_x = divmod(mb, mb_w)
            if mb_x == state["resync_x"] and mb_y == state["resync_y"] + 1:
                state["first_line"] = False
            row, bcol = 2 * mb_y, 2 * mb_x
            if ctype == I_VOP:
                marker = False
                while True:
                    if r.peek(19) == DC_MARKER:
                        marker = True
                        break
                    cbpc = r.vlc(tables.intra_mcbpc)
                    if cbpc != T.INTRA_MCBPC_STUFFING:
                        break
                if marker:
                    break
                kinds[mb] = MB_INTRA
                if cbpc & 4:
                    qscale = min(max(qscale + T.DQUANT[r.bits(2)], 1), 31)
                state["qscale"][mb_y, mb_x] = qscale
                quants[mb] = qscale
                info.append([cbpc] + _partition_dcs(r, tables, state, mb_x, mb_y, qscale))
            else:
                marker = False
                while True:
                    if r.peek(17) == MOTION_MARKER:
                        marker = True
                        break
                    if r.bit():
                        cbpc = -1
                        break
                    cbpc = r.vlc(tables.inter_mcbpc)
                    if cbpc != T.INTER_MCBPC_STUFFING:
                        break
                if marker:
                    break
                if cbpc < 0:
                    kinds[mb] = MB_SKIPPED
                    mbs["dirs"][mb] = 1
                    mv[row + 1:row + 3, bcol + 1:bcol + 3] = 0
                    _clean_intra(state, mb_x, mb_y)
                elif cbpc & 4:
                    kinds[mb] = MB_INTRA
                    mv[row + 1:row + 3, bcol + 1:bcol + 3] = 0
                else:
                    four = bool(cbpc & 16)
                    kinds[mb] = MB_INTER4V if four else MB_INTER
                    mbs["dirs"][mb] = 1
                    _clean_intra(state, mb_x, mb_y)
                    for i in range(4 if four else 1):
                        px, py = _pred_motion(mv, row, bcol, i, state["first_line"], mb_x,
                                              state["resync_x"])
                        mx = _decode_motion(r, tables, px, fcode)
                        my = _decode_motion(r, tables, py, fcode)
                        if four:
                            mv[row + 1 + (i >> 1), bcol + 1 + (i & 1)] = (mx, my)
                        else:
                            mv[row + 1:row + 3, bcol + 1:bcol + 3] = (mx, my)
                    mbs["mv"][mb, 0] = mv[row + 1:row + 3, bcol + 1:bcol + 3].reshape(4, 2)
                info.append([cbpc, None, None])
            mb += 1
        count = len(info)
        if count == 0:
            raise ValueError(f"an empty data partition at macroblock {start}")
        if ctype == I_VOP:
            while r.peek(9) == 1:
                r.bits(9)
            if r.bits(19) != DC_MARKER:
                raise ValueError("no DC marker after the first partition")
        else:
            while r.peek(10) == 1:
                r.bits(10)
            if r.bits(17) != MOTION_MARKER:
                raise ValueError("no motion marker after the first partition")
        # partition B
        state["first_line"] = True
        cbps, ac_preds = [], []
        for k in range(count):
            mb = start + k
            mb_y, mb_x = divmod(mb, mb_w)
            if mb_x == state["resync_x"] and mb_y == state["resync_y"] + 1:
                state["first_line"] = False
            cbpc = info[k][0]
            if ctype == I_VOP:
                ac_preds.append(r.bit())
                cbps.append((cbpc & 3) | (r.vlc(tables.cbpy) << 2))
            elif kinds[mb] == MB_INTRA:
                ac_preds.append(r.bit())
                cbpy = r.vlc(tables.cbpy)
                if cbpc & 8:
                    qscale = min(max(qscale + T.DQUANT[r.bits(2)], 1), 31)
                state["qscale"][mb_y, mb_x] = qscale
                quants[mb] = qscale
                info[k][1:] = _partition_dcs(r, tables, state, mb_x, mb_y, qscale)
                cbps.append((cbpc & 3) | (cbpy << 2))
            elif kinds[mb] == MB_SKIPPED:
                state["qscale"][mb_y, mb_x] = qscale
                quants[mb] = qscale
                ac_preds.append(0)
                cbps.append(0)
            else:
                cbpy = r.vlc(tables.cbpy)
                if cbpc & 8:
                    qscale = min(max(qscale + T.DQUANT[r.bits(2)], 1), 31)
                state["qscale"][mb_y, mb_x] = qscale
                quants[mb] = qscale
                ac_preds.append(0)
                cbps.append((cbpc & 3) | ((cbpy ^ 15) << 2))
        # the texture
        for k in range(count):
            mb = start + k
            mb_y, mb_x = divmod(mb, mb_w)
            q = int(quants[mb])
            if kinds[mb] == MB_INTRA:
                if not q < dc_thr:
                    raise UnsupportedMpeg4("data partitioning with the intra DC among the AC "
                                           "coefficients (intra_dc_vlc_thr)")
                dcs = list(zip(info[k][1], info[k][2]))
                _intra_blocks(r, tables, state, blocks[mb], mb_x, mb_y, q, cbps[k],
                              ac_preds[k], True, dcs=dcs)
                coded[mb] = True
            elif kinds[mb] != MB_SKIPPED:
                _inter_blocks(r, tables, blocks[mb], coded[mb], cbps[k], q, quant_type)
        start += count
        if start >= n_mb:
            mbs["stored"] = _stored_vectors(mv, mb_w, mb_h)
            return
        if not _is_resync(r, _prefix(ctype, fcode, 1)):
            raise ValueError(f"no video packet after macroblock {start - 1}")
        mb_num, q = _packet_header(r, ctype, time_bits, n_mb)
        if mb_num != start:
            raise ValueError(f"a video packet at macroblock {mb_num}, expected {start}")
        if q:
            qscale = q
        state["resync_y"], state["resync_x"] = divmod(mb_num, mb_w)
        _clean_buffers(state, state["resync_x"], state["resync_y"], mb_w)


def _partition_dcs(r, tables, state, mb_x, mb_y, qscale):
    """A partitioned intra macroblock's six DCs, read and predicted: [the
    stored DCs, the directions]."""
    dcs, dirs = [], []
    for n in range(6):
        _, direction = _intra_dc(r, tables, state, n, mb_x, mb_y, qscale)
        bx, by = _block_position(n, mb_x, mb_y)
        dcs.append(int(state["dc"][0 if n < 4 else n - 3][by + 1, bx + 1]))
        dirs.append(direction)
    return [dcs, dirs]


# ----------------------------------------------------------- reconstruction


def _wrap32(x):
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _wrap16(x):
    return ((x + 32768) & 0xFFFF) - 32768


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
    rows = _wrap16(rows)  # stored as int16
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


# XviD's IDCT (FFmpeg's xvididct.c, the C form of its SSE2 code): a row's
# cosines by its index, the rows' rounders, and the column pass's tangents
XVID_ROWS = np.array([
    [22725, 21407, 19266, 16384, 12873, 8867, 4520],
    [31521, 29692, 26722, 22725, 17855, 12299, 6270],
    [29692, 27969, 25172, 21407, 16819, 11585, 5906],
    [26722, 25172, 22654, 19266, 15137, 10426, 5315],
    [22725, 21407, 19266, 16384, 12873, 8867, 4520],
    [26722, 25172, 22654, 19266, 15137, 10426, 5315],
    [29692, 27969, 25172, 21407, 16819, 11585, 5906],
    [31521, 29692, 26722, 22725, 17855, 12299, 6270]], np.int64)
XVID_ROUND = np.array([65536, 3597, 2260, 1203, 0, 120, 512, 512], np.int64)
XVID_TAN1, XVID_TAN2, XVID_TAN3, XVID_SQRT2 = 0x32EC, 0x6A0A, 0xAB0E, 0x5A82


def xvid_idct(blocks):
    """XviD's IDCT (``ff_xvid_idct``) of (n, 64) raster-order blocks: a
    row pass with per-row cosines and rounders into int16, then a column
    pass of 16-bit multiplies (``pmulhw``) and butterflies, ``>> 6`` into
    int16.  (The C form's shortcuts for sparse rows and columns compute the
    same.)"""
    b = blocks.reshape(-1, 8, 8).astype(np.int64)
    c = [XVID_ROWS[None, :, k] for k in range(7)]
    c1, c2, c3, c4, c5, c6, c7 = c
    k = c4 * b[:, :, 0] + XVID_ROUND[None, :]
    a0 = k + c2 * b[:, :, 2] + c4 * b[:, :, 4] + c6 * b[:, :, 6]
    a1 = k + c6 * b[:, :, 2] - c4 * b[:, :, 4] - c2 * b[:, :, 6]
    a2 = k - c6 * b[:, :, 2] - c4 * b[:, :, 4] + c2 * b[:, :, 6]
    a3 = k - c2 * b[:, :, 2] + c4 * b[:, :, 4] - c6 * b[:, :, 6]
    b0 = c1 * b[:, :, 1] + c3 * b[:, :, 3] + c5 * b[:, :, 5] + c7 * b[:, :, 7]
    b1 = c3 * b[:, :, 1] - c7 * b[:, :, 3] - c1 * b[:, :, 5] - c5 * b[:, :, 7]
    b2 = c5 * b[:, :, 1] - c1 * b[:, :, 3] + c7 * b[:, :, 5] + c3 * b[:, :, 7]
    b3 = c7 * b[:, :, 1] - c5 * b[:, :, 3] + c3 * b[:, :, 5] - c1 * b[:, :, 7]
    rows = np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2, a1 - b1, a0 - b0],
                    axis=2)
    x = _wrap16(_wrap32(rows) >> 11)

    def mult(cst, v):
        return _wrap32(cst * v) >> 16

    i = [x[:, j] for j in range(8)]  # the rows, (n, 8) each: a column per entry
    m0 = mult(XVID_TAN1, i[7]) + i[1]
    m1 = mult(XVID_TAN1, i[1]) - i[7]
    m2 = mult(XVID_TAN3, i[5]) + i[3]
    m3 = mult(XVID_TAN3, i[3]) - i[5]
    m7 = m0 + m2
    m4 = m1 - m3
    m0 = m0 - m2
    m1 = m1 + m3
    m6 = 2 * mult(XVID_SQRT2, m0 + m1)
    m5 = 2 * mult(XVID_SQRT2, m0 - m1)
    m3 = mult(XVID_TAN2, i[6]) + i[2]
    m2 = mult(XVID_TAN2, i[2]) - i[6]
    e0, e1 = i[0] + i[4], i[0] - i[4]
    e0, m3 = e0 + m3, e0 - m3
    o0, o7 = e0 + m7, e0 - m7
    o3, o4 = m3 + m4, m3 - m4
    e1, m2 = e1 + m2, e1 - m2
    o1, o6 = e1 + m6, e1 - m6
    o2, o5 = m2 + m5, m2 - m5
    cols = np.stack([o0, o1, o2, o3, o4, o5, o6, o7], axis=1)
    return _wrap16(_wrap32(cols) >> 6)


def dequantize_intra(blocks, quants):
    """``dct_unquantize_h263_intra`` of (n, 6, 64) quantised intra blocks:
    the DC times its scaler, the AC by the H.263 rule."""
    q = quants[:, None, None].astype(np.int64)
    out = blocks.astype(np.int64)
    ac = out[:, :, 1:]
    mag = np.abs(ac) * 2 * q + ((q - 1) | 1)
    out[:, :, 1:] = np.where(ac == 0, 0, np.sign(ac) * mag)
    out[:, :, 0] *= _dc_scales(quants)
    return _wrap16(out)


def _dc_scales(quants):
    return np.stack([T.DC_SCALE[0][quants]] * 4 + [T.DC_SCALE[1][quants]] * 2, axis=1)


def dequantize_mpeg_intra(blocks, quants, matrix):
    """``dct_unquantize_mpeg2_intra`` as FFmpeg's x86 code runs it (16-bit
    products, ``psraw`` 4, no mismatch control) of (n, 6, 64) quantised
    intra blocks; the DC times its scaler."""
    q = ((2 * quants[:, None, None].astype(np.int64) * matrix[None, None, :]) & 0xFFFF)
    out = blocks.astype(np.int64)
    mag = _wrap16(np.abs(out) * q) >> 4
    res = np.where(out == 0, 0, np.where(out < 0, -mag, mag))
    res[:, :, 0] = out[:, :, 0] * _dc_scales(quants)
    return _wrap16(res)


def dequantize_mpeg_inter(blocks, quants, matrix):
    """``dct_unquantize_mpeg2_inter`` as FFmpeg's x86 code runs it:
    ``((2 |level| + 1) q) >> 5`` in unsigned 16 bits, then the mismatch
    control (coefficient 63's low bit flipped where the sum is even)."""
    q = ((2 * quants[:, None, None].astype(np.int64) * matrix[None, None, :]) & 0xFFFF)
    lev = blocks.astype(np.int64)
    mag = (((2 * np.abs(lev) + 1) * q) & 0xFFFF) >> 5
    res = _wrap16(np.where(lev == 0, 0, np.where(lev < 0, -mag, mag)))
    odd = (res & 1).sum(axis=2) & 1
    res[:, :, 63] ^= 1 - odd
    return res


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


def _lowpass(x, axis, size, rounding):
    """MPEG-4's 8-tap half-sample filter (20, -6, 3, -1) along ``axis`` of
    ``size`` + 1 samples, mirrored at the block's edges, to ``size``."""
    k = np.arange(-3, size + 4)
    idx = np.where(k < 0, -k - 1, np.where(k > size, 2 * size + 1 - k, k))
    e = np.take(x, idx, axis=axis)

    def tap(o):
        return np.take(e, np.arange(size) + 3 + o, axis=axis)

    v = (20 * (tap(0) + tap(1)) - 6 * (tap(-1) + tap(2)) + 3 * (tap(-2) + tap(3))
         - (tap(-3) + tap(4)))
    return np.clip((v + 16 - rounding) >> 5, 0, 255)


def qpel(ref, x0, y0, fx, fy, size, rounding, edge_w, edge_h):
    """Quarter-pel prediction of (n,) blocks of ``size`` (16 or 8) at
    full-pel (x0, y0) with quarter steps (fx, fy) in 0..3, as FFmpeg's
    ``qpeldsp`` composes it: the horizontal stage (the filter, or its
    average with the nearer full pixel) over ``size`` + 1 rows, then the
    vertical one on its output; ``rounding`` 1 for the no-rounding forms."""
    steps = np.arange(size + 1)
    p = _gather(ref, y0[:, None] + steps, x0[:, None] + steps, edge_h, edge_w)
    rnd = 1 - rounding
    hl = _lowpass(p, 2, size, rounding)
    fx, fy = fx[:, None, None], fy[:, None, None]
    full, full1 = p[:, :, :size], p[:, :, 1:]
    h = np.where(fx == 0, full, np.where(fx == 1, (full + hl + rnd) >> 1,
                                         np.where(fx == 2, hl, (full1 + hl + rnd) >> 1)))
    vl = _lowpass(h, 1, size, rounding)
    top, bottom = h[:, :size], h[:, 1:]
    return np.where(fy == 0, top, np.where(fy == 1, (top + vl + rnd) >> 1,
                                           np.where(fy == 2, vl, (bottom + vl + rnd) >> 1)))


def chroma_vector_4mv(v):
    """The chroma vector of four luma vectors' sum (Table 7-9's rounding)."""
    tab = np.array([0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2])
    return tab[v & 15] + ((v >> 3) & ~1)


def _half(v):
    """C's ``v / 2``."""
    return np.where(v < 0, -((-v) >> 1), v >> 1)


QPEL_CHROMA2_ROUND = np.array([0, 0, 1, 1, 0, 0, 0, 1])


def _predict(ref, mb_x, mb_y, v, four, prm, rounding):
    """One direction's prediction of (n,) macroblocks from reference planes
    ``ref`` with vectors ``v`` (n, 4, 2): (Y (n, 16, 16), U, V (n, 8, 8))."""
    qpel_on, bugs = int(prm[P_QPEL]), int(prm[P_BUGS])
    edge_w, edge_h = int(prm[P_EDGE_W]), int(prm[P_EDGE_H])
    width, height = int(prm[P_WIDTH]), int(prm[P_HEIGHT])
    n = len(mb_x)
    luma = np.zeros((n, 16, 16), np.int32)
    shift, mask = (2, 3) if qpel_on else (1, 1)
    for k in range(4):
        mx, my = v[:, k, 0], v[:, k, 1]
        x = mb_x * 16 + (k & 1) * 8 + (mx >> shift)
        y = mb_y * 16 + (k >> 1) * 8 + (my >> shift)
        fx, fy = mx & mask, my & mask
        # an 8x8 block's position is clipped to the VOL's size, dropping its
        # fraction there (hpel_motion, and the quarter-pel 4MV loop)
        x = np.where(four, np.clip(x, -16, width), x)
        y = np.where(four, np.clip(y, -16, height), y)
        fx = np.where(four & (x == width), 0, fx)
        fy = np.where(four & (y == height), 0, fy)
        if qpel_on:
            blk = qpel(ref[0], x, y, fx, fy, 8, rounding, edge_w, edge_h)
        else:
            blk = half_pel(ref[0], x, y, fx, fy, 8, rounding, edge_w, edge_h, narrow=four)
        luma[:, (k >> 1) * 8:(k >> 1) * 8 + 8, (k & 1) * 8:(k & 1) * 8 + 8] = blk
    if qpel_on and (~four).any():
        one = ~four
        mx, my = v[one, 0, 0], v[one, 0, 1]
        luma[one] = qpel(ref[0], mb_x[one] * 16 + (mx >> 2), mb_y[one] * 16 + (my >> 2),
                         mx & 3, my & 3, 16, rounding, edge_w, edge_h)
    # chroma
    mv = _half(v) if qpel_on else v
    sx, sy = mv[:, :, 0].sum(axis=1), mv[:, :, 1].sum(axis=1)
    cx4, cy4 = chroma_vector_4mv(sx), chroma_vector_4mv(sy)
    ux4 = np.clip(mb_x * 8 + (cx4 >> 1), -8, width >> 1)
    uy4 = np.clip(mb_y * 8 + (cy4 >> 1), -8, height >> 1)
    hx4 = np.where(ux4 == width >> 1, 0, cx4 & 1)
    hy4 = np.where(uy4 == height >> 1, 0, cy4 & 1)
    if qpel_on:
        mx, my = v[:, 0, 0], v[:, 0, 1]
        if bugs & BUG_QPEL_CHROMA2:
            cx, cy = (mx >> 1) + QPEL_CHROMA2_ROUND[mx & 7], (my >> 1) + QPEL_CHROMA2_ROUND[my & 7]
        elif bugs & BUG_QPEL_CHROMA:
            cx, cy = (mx >> 1) | (mx & 1), (my >> 1) | (my & 1)
        else:
            cx, cy = _half(mx), _half(my)
        cx, cy = (cx >> 1) | (cx & 1), (cy >> 1) | (cy & 1)
        ux1, uy1, hx1, hy1 = mb_x * 8 + (cx >> 1), mb_y * 8 + (cy >> 1), cx & 1, cy & 1
    else:
        cx, cy = v[:, 0, 0], v[:, 0, 1]
        # 1MV: (16 mb + mv >> 1) >> 1, half when mv & 3
        ux1, uy1 = (mb_x * 16 + (cx >> 1)) >> 1, (mb_y * 16 + (cy >> 1)) >> 1
        hx1, hy1 = (cx & 1) | ((cx & 2) >> 1), (cy & 1) | ((cy & 2) >> 1)
    ux, uy = np.where(four, ux4, ux1), np.where(four, uy4, uy1)
    hx, hy = np.where(four, hx4, hx1), np.where(four, hy4, hy1)
    chroma = [half_pel(ref[p], ux, uy, hx, hy, 8, rounding, edge_w >> 1, edge_h >> 1,
                       narrow=True) for p in (1, 2)]
    return luma, chroma[0], chroma[1]


def reconstruct_py(mbs, prm, past, future=None, matrices=None):
    """The pixels of a parsed VOP: (Y, U, V) planes of whole macroblocks.
    ``past`` is the reference a P-VOP (or a B-VOP's forward vectors)
    predicts from, ``future`` a B-VOP's backward one; ``matrices`` the
    VOL's intra and inter matrices (``Vol.matrices``)."""
    mb_w, mb_h = int(prm[0]), int(prm[1])
    kinds, quants, coded = mbs["kinds"], mbs["quants"], mbs["coded"]
    n = mb_w * mb_h
    mb_y, mb_x = np.divmod(np.arange(n), mb_w)
    pred = [np.zeros((n, 16, 16), np.int32), np.zeros((n, 8, 8), np.int32),
            np.zeros((n, 8, 8), np.int32)]
    inter = kinds != MB_INTRA
    four = kinds == MB_INTER4V
    rounding = int(prm[P_ROUNDING])
    for d, ref in ((0, past), (1, future)):
        sel = inter & ((mbs["dirs"] & (1 << d)) != 0)
        if not sel.any():
            continue
        if ref is None:
            raise ValueError("a VOP without its reference")
        got = _predict(ref, mb_x[sel], mb_y[sel], mbs["mv"][sel, d], four[sel], prm, rounding)
        both = (mbs["dirs"][sel] & 1)[:, None, None] if d == 1 else 0
        for p in range(3):
            pred[p][sel] = np.where(both, (pred[p][sel] + got[p] + 1) >> 1, got[p])
    intra = kinds == MB_INTRA
    coefs = _wrap16(mbs["blocks"].astype(np.int64))  # FFmpeg's int16 blocks
    if prm[P_QUANT_TYPE]:
        if matrices is None:
            matrices = np.concatenate([T.DEFAULT_INTRA_MATRIX, T.DEFAULT_INTER_MATRIX])
        matrices = np.asarray(matrices, np.int64)
        if intra.any():
            coefs[intra] = dequantize_mpeg_intra(coefs[intra], quants[intra], matrices[:64])
        dq = inter & coded.any(axis=1)
        if dq.any():
            coefs[dq] = np.where(coded[dq][:, :, None],
                                 dequantize_mpeg_inter(coefs[dq], quants[dq], matrices[64:]),
                                 coefs[dq])
    elif intra.any():
        coefs[intra] = dequantize_intra(coefs[intra], quants[intra])
    idct = xvid_idct if prm[P_IDCT] == IDCT_XVID else simple_idct
    res = idct(coefs.reshape(-1, 64)).reshape(n, 6, 8, 8)
    res = np.where(coded[:, :, None, None], res, 0)
    base = np.concatenate([pred[0].reshape(n, 2, 8, 2, 8).transpose(0, 1, 3, 2, 4)
                           .reshape(n, 4, 8, 8), pred[1][:, None], pred[2][:, None]], axis=1)
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


def _planes_ok(ref, mb_w, mb_h):
    if ref is not None and ref[0].shape != (16 * mb_h, 16 * mb_w):
        raise ValueError(f"a reference of {ref[0].shape} for a VOP of {16 * mb_h}x{16 * mb_w}")
    return [np.ascontiguousarray(p) for p in ref] if ref is not None else [None] * 3


def decode_vop_native(data, bitpos, prm, ref, future=None, colocated=None, matrices=None):
    """``decode_vop_py`` in C++ (``omv_decode_vop``): the same planes, end
    bit, kinds and stored vectors."""
    from .. import kernels

    lib = kernels.host_library("mpeg4_host")
    prm = np.ascontiguousarray(prm, np.int32)
    mb_w, mb_h = int(prm[0]), int(prm[1])
    n = mb_w * mb_h
    past, fut = _planes_ok(ref, mb_w, mb_h), _planes_ok(future, mb_w, mb_h)
    buf = np.frombuffer(bytes(data) + bytes(8), np.uint8)
    out = (np.empty((16 * mb_h, 16 * mb_w), np.uint8), np.empty((8 * mb_h, 8 * mb_w), np.uint8),
           np.empty((8 * mb_h, 8 * mb_w), np.uint8))
    kinds = np.zeros(n, np.int32)
    mv = np.zeros((n, 4, 2), np.int32)
    col_kinds = col_mv = None
    if colocated is not None:
        col_kinds = np.ascontiguousarray(colocated[0], np.int32)
        col_mv = np.ascontiguousarray(colocated[1], np.int32)
    if matrices is None:
        matrices = np.concatenate([T.DEFAULT_INTRA_MATRIX, T.DEFAULT_INTER_MATRIX])
    matrices = np.ascontiguousarray(matrices, np.int32)
    end = lib.omv_decode_vop(buf.ctypes.data, len(data), bitpos, prm.ctypes.data,
                             native_tables().ctypes.data, matrices.ctypes.data,
                             _ptr(past[0]), _ptr(past[1]), _ptr(past[2]), _ptr(fut[0]),
                             _ptr(fut[1]), _ptr(fut[2]), _ptr(col_kinds), _ptr(col_mv),
                             out[0].ctypes.data, out[1].ctypes.data, out[2].ctypes.data,
                             kinds.ctypes.data, mv.ctypes.data)
    if end < 0:
        raise ValueError(f"a corrupt VOP: {lib.omv_error_string(end).decode()}")
    return out, end, (kinds, mv)


def decode_vop_py(data, bitpos, prm, ref, future=None, colocated=None, matrices=None,
                  tables=None):
    """A VOP's macroblocks decoded by the plain version: ((Y, U, V), the
    bit after the last macroblock, (kinds, the stored forward vectors
    (n, 4, 2) a later B-VOP's direct mode reads))."""
    mbs, end = parse_macroblocks_py(data, bitpos, prm, colocated, tables)
    planes = reconstruct_py(mbs, prm, ref, future, matrices)
    return planes, end, (mbs["kinds"], mbs["stored"])


# ------------------------------------------------------------- the decoder


def _c_int(text):
    """``sscanf``'s ``%d`` at the start of ``text``: (value, rest) or None."""
    m = re.match(rb"\s*([+-]?\d+)", text)
    return (int(m.group(1)), text[m.end():]) if m else None


def user_data_fields(text):
    """What FFmpeg's ``decode_user_data`` takes from a user data string:
    {"divx": (version, build, packed), "lavc": build, "xvid": build}, each
    where it matches."""
    out = {}
    for sep in (b"Build", b"b"):
        if text.startswith(b"DivX"):
            ver = _c_int(text[4:])
            if ver and ver[1].startswith(sep):
                build = _c_int(ver[1][len(sep):])
                if build:
                    out["divx"] = (ver[0], build[0], build[1][:1] == b"p")
                    break
    m = re.match(rb"FFmpe[^b]*b", text)
    build = _c_int(text[m.end():]) if m else None
    if build:
        out["lavc"] = build[0]
    else:
        m = re.match(rb"FFmpeg v\s*[+-]?\d+\.\s*[+-]?\d+\.\s*[+-]?\d+ / libavcodec build:", text)
        build = _c_int(text[m.end():]) if m else None
        if build:
            out["lavc"] = build[0]
        else:
            m = re.match(rb"Lavc\s*([+-]?\d+)\.\s*([+-]?\d+)\.\s*([+-]?\d+)", text)
            if m:
                v1, v2, v3 = (int(g) for g in m.groups())
                out["lavc"] = ((v1 & 0xFF) << 16) + ((v2 & 0xFF) << 8) + (v3 & 0xFF)
            elif text == b"ffmpeg":
                out["lavc"] = 4600
    if text.startswith(b"XviD"):
        build = _c_int(text[4:])
        if build:
            out["xvid"] = build[0]
    return out


def _u32(v):
    return v & 0xFFFFFFFF


class Decoder:
    """Decodes one stream's packets, in order, to (Y, U, V) planes of the
    VOL's size, in display order; ``extradata`` is a container's decoder
    configuration (MP4's VOL in ``esds``), read before the first packet;
    ``codec_tag`` the container's fourcc.  ``native`` selects the C++
    macroblock loop (the default) or the plain version."""

    def __init__(self, extradata=b"", native=True, codec_tag=b""):
        self.vol = None
        self.past = self.future = None  # the two references' planes
        self.future_mbs = None  # the future reference's (kinds, forward vectors)
        self.codec_tag = bytes(codec_tag).upper()  # FFmpeg's ff_toupper4
        self.native = native
        self.lavc_build = self.xvid_build = self.divx_version = self.divx_build = -1
        self.divx_packed = False
        self.bugs = 0
        self.idct = IDCT_SIMPLE
        self.low_delay = 1
        self.picture_number = 0
        self.time_base = self.last_time_base = self.last_non_b_time = 0
        self.pp_time = 0
        self.packed = None  # a packed stream's VOP held back for the next packet
        self.skipped_last = False
        if extradata:
            self._headers(bytes(extradata), allow_vop=False)

    def _headers(self, data, allow_vop=True):
        """Parse the start codes of ``data`` up to the first VOP (as
        ``ff_mpeg4_parse_picture_header``); that VOP's offset or None."""
        vol_seen = False
        codes = start_codes(data)
        for k, (at, code) in enumerate(codes):
            if code <= 0x1F:  # video_object_start_code
                continue
            if 0x20 <= code <= 0x2F:
                if vol_seen:
                    continue  # FFmpeg ignores a second VOL in one packet
                vol_seen = True
                vol = Vol(data[at:])
                if self.vol is None or (vol.width, vol.height) != (self.vol.width,
                                                                   self.vol.height):
                    # a new size: P-VOPs wait for the next I-VOP
                    self.past = self.future = self.future_mbs = None
                self.vol = vol
                if vol.vol_control:
                    self.low_delay = vol.low_delay
                elif self.picture_number == 0:
                    self.low_delay = int(vol.object_type in (1, 17))  # Simple, ASP
            elif code == 0xB6:
                if not allow_vop:
                    raise ValueError("a VOP in the decoder configuration")
                return at
            elif code == 0xB5:
                r = BitReader(data[at:])
                if r.bit():
                    r.bits(7)
                kind = r.bits(4)
                if kind != 1:
                    raise UnsupportedMpeg4(f"a visual object of type {kind} (video only)")
            elif code == 0xB2:
                self._user_data(data[at:])
            elif code in (0xB0, 0xB1, 0xB3):
                continue  # sequence start and end, group of VOPs
            elif 0x40 <= code <= 0x5F:
                raise UnsupportedMpeg4("a fine granularity scalable layer")
        return None

    def _user_data(self, data):
        """FFmpeg's ``decode_user_data``: the bytes up to the next start
        code (at most 255), and the encoder they name."""
        end = 0
        while end < min(len(data), 255):
            if data[end:end + 2] == b"\0\0" and (end + 2 >= len(data) or data[end + 2] < 2):
                break
            end += 1
        fields = user_data_fields(bytes(data[:end]))
        if "divx" in fields:
            self.divx_version, self.divx_build, self.divx_packed = fields["divx"]
        if "lavc" in fields:
            self.lavc_build = fields["lavc"]
        if "xvid" in fields:
            self.xvid_build = fields["xvid"]

    def _workarounds(self):
        """``ff_mpeg4_workaround_bugs``: the encoder by the codec tag where
        no user data named it, and the workarounds and IDCT its build and
        version call for."""
        if self.xvid_build == -1 and self.divx_version == -1 and self.lavc_build == -1:
            if self.codec_tag in XVID_TAGS:
                self.xvid_build = 0
            elif self.codec_tag == b"DIVX" and self.vol.object_type == 0 and \
                    not self.vol.vol_control:
                self.divx_version = 400
        if self.xvid_build >= 0 and self.divx_version >= 0:
            self.divx_version = self.divx_build = -1
        xvid, lavc, divx = _u32(self.xvid_build), _u32(self.lavc_build), self.divx_version
        bugs = 0
        if xvid <= 1:
            bugs |= BUG_QPEL_CHROMA
        if xvid <= 12:
            bugs |= BUG_EDGE
        if xvid <= 32:
            bugs |= BUG_DC_CLIP
        if lavc < 4670:
            bugs |= BUG_EDGE
        if lavc <= 4712:
            bugs |= BUG_DC_CLIP
        if _u32(divx) < 500:
            bugs |= BUG_EDGE
        if divx >= 500 and self.divx_build < 1814:
            bugs |= BUG_QPEL_CHROMA
        if divx > 502 and self.divx_build < 1814:
            bugs |= BUG_QPEL_CHROMA2
        self.bugs |= bugs
        if self.vol.quarter_sample:
            if lavc < 4653:
                raise UnsupportedMpeg4("quarter-pel of a libavcodec build before 4653 (FFmpeg's "
                                       "old quarter-pel filters)")
            if (self.lavc_build & 0xFF) >= 100 and 3621476 < self.lavc_build < 3752552 and \
                    (self.lavc_build < 3752037 or self.lavc_build > 3752191):
                raise UnsupportedMpeg4("quarter-pel of libavcodec 55.65-57.66 (FFmpeg's IEDGE "
                                       "workaround)")
        if self.xvid_build >= 0:
            self.idct = IDCT_XVID

    def decode_vop(self, data, bitpos, prm, ref, **kw):
        """One VOP's macroblocks by the C++ loop or the plain one
        (``decode_vop_native``, ``decode_vop_py``)."""
        return (decode_vop_native if self.native else decode_vop_py)(
            data, bitpos, prm, ref, **kw)

    def _source(self, data):
        """The bytes to decode for packet ``data``: a packed stream's VOP
        held back from the packet before, in place of this one's
        placeholder (``ff_mpeg4_decode_picture_header``)."""
        held, self.packed = self.packed, None
        if held is None:
            return data, False
        if self.divx_packed:
            codes = start_codes(data[:max(len(data) - 1, 0)])
            if codes and codes[0][1] == 0xB0:
                return data, False  # a new sequence: the held VOP is dropped
        if self.divx_packed or len(data) <= MAX_NVOP_SIZE:
            return held, True
        return data, False

    def _hold_packed(self, data, pos):
        """``ff_mpeg4_frame_end``: in a packed stream, a VOP that is not a
        P-VOP after byte ``pos`` of ``data`` is held for the next packet."""
        if not self.divx_packed or len(data) - pos <= 7:
            return
        i = data.find(b"\0\0\1\xb6", pos)
        if 0 <= i < len(data) - 4 and not data[i + 4] & 0x40:
            self.packed = data[pos:]

    def decode(self, packet):
        """The frames one packet makes shown: [(Y, U, V)], or [] for a packet
        of headers only, a VOP that is not coded or a VOP held back."""
        data = bytes(packet)
        source, from_held = self._source(data)
        if source[:3] != b"\0\0\1":
            if source[:2] == b"\0\0" and len(source) > 2 and source[2] & 0xFC == 0x80:
                raise UnsupportedMpeg4("the short video header (H.263)")
        self.skipped_last = False
        at = self._headers(source)
        if at is None:
            return []
        if self.vol is None:
            raise ValueError("a VOP before any video object layer header")
        vop = Vop(source[at:], self.vol)
        if vop.coding_type == B_VOP and not self.vol.vol_control:
            self.low_delay = 0  # FFmpeg: "low_delay flag set incorrectly, clearing it"
        edge_bug = self.bugs & BUG_EDGE  # h_edge_pos is set before the workarounds
        res = self.vol.time_resolution
        if vop.coding_type != B_VOP:
            self.last_time_base = self.time_base
            self.time_base += vop.modulo_time
            time = self.time_base * res + vop.time_increment
            self.pp_time = (time - self.last_non_b_time) & 0xFFFF
            self.last_non_b_time = time
            pb_time = 0
        else:
            time = (self.last_time_base + vop.modulo_time) * res + vop.time_increment
            pb_time = (self.pp_time - (self.last_non_b_time - time)) & 0xFFFF
            if self.pp_time <= pb_time or self.pp_time <= self.pp_time - pb_time or \
                    self.pp_time <= 0:
                return []  # out of order (after a seek): FFmpeg skips it
        if not vop.coded:
            self.skipped_last = True
            return []
        if self.vol.object_type == 0 and not self.vol.vol_control and \
                self.divx_version == -1 and self.picture_number == 0:
            self.low_delay = 1  # FFmpeg's guess for DivX 4, old XviD and OpenDivX
        self.picture_number += 1
        self._workarounds()
        if vop.coding_type == P_VOP and self.future is None:
            return []  # FFmpeg skips P-VOPs until the first I-VOP
        if vop.coding_type == B_VOP and self.past is None:
            return []  # and B-VOPs until two references
        prm = params(self.vol, vop, (self.bugs & ~BUG_EDGE) | edge_bug, self.idct,
                     self.pp_time, pb_time)
        payload = source[at:]
        kw = dict(matrices=self.vol.matrices())
        if vop.coding_type == B_VOP:
            planes, end, _ = self.decode_vop(payload, vop.bitpos, prm, self.past,
                                             future=self.future, colocated=self.future_mbs,
                                             **kw)
        else:
            planes, end, mbs = self.decode_vop(payload, vop.bitpos, prm, self.future, **kw)
        if self.divx_packed:
            self._hold_packed(data, 0 if from_held else at + (end >> 3))
        if vop.coding_type == B_VOP:
            return [self._crop(planes)]
        self.past, self.future, self.future_mbs = self.future, planes, mbs
        if self.low_delay:
            return [self._crop(planes)]
        return [] if self.past is None else [self._crop(self.past)]

    def _crop(self, planes):
        """Whole-macroblock planes cut to the VOL's size."""
        w, h = self.vol.width, self.vol.height
        return (planes[0][:h, :w], planes[1][:(h + 1) // 2, :(w + 1) // 2],
                planes[2][:(h + 1) // 2, :(w + 1) // 2])

    def flush(self):
        """The frame still held back at the end of the stream: [(Y, U, V)]
        or []; FFmpeg shows the last reference again where the stream ends
        in a VOP that is not coded."""
        if (not self.low_delay or self.skipped_last) and self.future is not None:
            planes, self.future = self.future, None
            return [self._crop(planes)]
        return []
