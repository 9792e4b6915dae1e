"""The ``mp4v`` writer: MPEG-4 Part 2 Simple Profile as cv2's
``VideoWriter`` lays it out through FFmpeg's ``mpeg4`` encoder (its bytes
are the port's own: the rate control and motion search here are not
FFmpeg's).

Headers as FFmpeg writes them: a visual object sequence (profile 1), a
visual object, a video object layer (rectangular, ``low_delay``,
``vop_time_increment_resolution`` the denominator of the rate as OpenCV
hands it to FFmpeg, ``fixed_vop_rate`` 0, resync markers off), a group of
VOPs before every I-VOP, and VOPs whose time increments count the rate's
numerator.  ``global_header`` (MP4) keeps the sequence headers for the
container's ``esds``; without it (AVI) they lead every I-VOP's packet.

An I-VOP every ``GOP`` frames, P-VOPs between them with
``vop_rounding_type`` alternating from 1, as FFmpeg writes them.  Every
macroblock has one quantiser, ``QUANT``: intra blocks with DC prediction
(``intra_dc_vlc_thr`` 0, no AC prediction), inter blocks with one 16x16
half-pel vector (``f_code`` 1) from a search over (0, 0), the median
predictor and the left and upper vectors, a diamond of full-pel steps
and the eight half-pel ones around the best, by the sum of absolute
differences; a macroblock whose vector is (0, 0) and whose blocks quantise
to nothing is ``not_coded``.  Coefficients come from ``jfdctint``'s
integer forward DCT (``data/jpeg_encode.py``), H.263 quantisation (no
bias intra, a quarter dead zone inter), TCOEF with the three escapes.

Each frame is reconstructed by the reader's own inverse quantisation,
IDCT and motion compensation (``data/mpeg4.py``), so FFmpeg and the port
read the file to the frames the writer predicted from.

``encode_vop_py`` is the macroblock loop plainly written, the spec;
``encode_vop_native`` is it in C++ (``csrc/mpeg4_host.cc``), the one the
writer runs.
"""

import math

import numpy as np

from . import mpeg4
from . import mpeg4_tables as T
from .jpeg_encode import fdct_islow

GOP = 12  # cv2's writer: an I-VOP every 12 frames (FFmpeg's gop_size)
QUANT = 4
SEARCH_STEPS = 16  # most full-pel diamond steps a macroblock
MV_MIN, MV_MAX = -32, 31  # half-pel range of f_code 1


def cv2_rate(fps):
    """(numerator, denominator) of the frame rate as OpenCV hands it to
    FFmpeg (``frame_rate_base`` a power of ten within 0.001), with the
    common factors removed as FFmpeg's encoder removes them."""
    fps = float(fps)
    if not (fps > 0 and math.isfinite(fps)):
        raise ValueError(f"a frame rate of {fps}")
    rate, base = int(fps + 0.5), 1
    while abs(rate / base - fps) > 0.001:
        base *= 10
        rate = int(fps * base + 0.5)
    g = math.gcd(rate, base)
    if rate // g > 65535:
        raise ValueError(f"a frame rate of {fps}: its time base {rate // g} is past MPEG-4's "
                         "16-bit vop_time_increment_resolution")
    return rate // g, base // g


class BitWriter:
    """MSB-first bits into a bytearray."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, nbits, value):
        if nbits == 0:
            return
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def code(self, pair):
        value, length = pair
        self.put(length, value)

    def stuffing(self):
        """``ff_mpeg4_stuffing``: a 0, then 1s to the byte boundary."""
        self.put(1, 0)
        if self.n:
            self.put(8 - self.n, (1 << (8 - self.n)) - 1)

    def start_code(self, code):
        self.put(32, 0x100 | code)

    def bytes(self):
        """The whole bytes written and the pending bits: (bytes, bits, n)."""
        return bytes(self.out), self.acc, self.n


def sequence_headers(width, height, rate):
    """VOS, visual object, video object and VOL headers, as FFmpeg's
    ``mpeg4_encode_visual_object_header`` and ``mpeg4_encode_vol_header``
    write them for the Simple Profile (no user data)."""
    num, den = rate
    w = BitWriter()
    w.start_code(0xB0)
    w.put(8, 1)  # profile_and_level_indication
    w.start_code(0xB5)
    w.put(1, 1)  # is_visual_object_identifier
    w.put(4, 1)  # visual_object_verid
    w.put(3, 1)  # visual_object_priority
    w.put(4, 1)  # visual_object_type: video
    w.put(1, 0)  # video_signal_type
    w.stuffing()
    w.start_code(0x00)  # video object 0
    w.start_code(0x20)  # video object layer 0
    w.put(1, 0)  # random_accessible_vol
    w.put(8, 1)  # video_object_type_indication: simple
    w.put(1, 1)  # is_object_layer_identifier
    w.put(4, 1)
    w.put(3, 1)
    w.put(4, 1)  # aspect_ratio_info: square
    w.put(1, 1)  # vol_control_parameters
    w.put(2, 1)  # chroma_format 4:2:0
    w.put(1, 1)  # low_delay
    w.put(1, 0)  # vbv_parameters
    w.put(2, 0)  # rectangular
    w.put(1, 1)
    w.put(16, num)  # vop_time_increment_resolution
    w.put(1, 1)
    w.put(1, 0)  # fixed_vop_rate
    w.put(1, 1)
    w.put(13, width)
    w.put(1, 1)
    w.put(13, height)
    w.put(1, 1)
    w.put(1, 0)  # interlaced
    w.put(1, 1)  # obmc_disable
    w.put(1, 0)  # sprite_enable
    w.put(1, 0)  # not_8_bit
    w.put(1, 0)  # quant_type: H.263
    w.put(1, 1)  # complexity_estimation_disable
    w.put(1, 1)  # resync_marker_disable
    w.put(1, 0)  # data_partitioned
    w.put(1, 0)  # scalability
    w.stuffing()
    return w.bytes()[0]


def _tcoef_codes():
    """(last, run, level) -> TCOEF index, for the inter [0] and intra [1]
    tables."""
    out = []
    for runs, levels, last_from in ((T.INTER_RUN, T.INTER_LEVEL, T.INTER_LAST),
                                    (T.INTRA_RUN, T.INTRA_LEVEL, T.INTRA_LAST)):
        out.append({(int(i >= last_from), r, l): i
                    for i, (r, l) in enumerate(zip(runs, levels))})
    return out


_CODES = None


def _codes():
    global _CODES
    if _CODES is None:
        _CODES = _tcoef_codes()
    return _CODES


def _put_tcoef(w, intra, last, run, level):
    """One (last, run, level) by its code, or the first escape that holds
    it."""
    table = T.INTRA_TCOEF if intra else T.INTER_TCOEF
    codes = _codes()[intra]
    tables = T.tables()
    sign, mag = int(level < 0), abs(level)
    index = codes.get((last, run, mag))
    if index is not None:
        w.code(table[index])
        w.put(1, sign)
        return
    lmax = int(tables.lmax[intra][last, run]) if run < 64 else 0
    index = codes.get((last, run, mag - lmax)) if lmax and mag > lmax else None
    if index is not None:
        w.code(table[T.TCOEF_ESCAPE])
        w.put(1, 0)
        w.code(table[index])
        w.put(1, sign)
        return
    rmax = int(tables.rmax[intra][last, mag]) if mag < 64 else -1
    index = codes.get((last, run - rmax - 1, mag)) if 0 < mag < 64 and run > rmax else None
    if index is not None:
        w.code(table[T.TCOEF_ESCAPE])
        w.put(2, 2)
        w.code(table[index])
        w.put(1, sign)
        return
    w.code(table[T.TCOEF_ESCAPE])
    w.put(2, 3)
    w.put(1, last)
    w.put(6, run)
    w.put(1, 1)
    w.put(12, level)
    w.put(1, 1)


def _put_block(w, block, scan, start, intra):
    """The TCOEF of ``block`` (raster levels) from scan position
    ``start``."""
    pairs, run = [], 0
    for i in range(start, 64):
        level = int(block[scan[i]])
        if level:
            pairs.append((run, level))
            run = 0
        else:
            run += 1
    for k, (run, level) in enumerate(pairs):
        _put_tcoef(w, intra, int(k == len(pairs) - 1), run, level)


def _put_motion(w, val, fcode=1):
    """``h263_encode_motion`` of a vector difference."""
    if val == 0:
        w.put(1, 1)
        return
    bit_size = fcode - 1
    bits = 6 + bit_size
    val &= (1 << bits) - 1
    if val >> (bits - 1):
        val -= 1 << bits
    sign = int(val < 0)
    val = abs(val) - 1
    code = (val >> bit_size) + 1
    value, length = T.MVD[code]
    w.put(length + 1, (value << 1) | sign)
    if bit_size:
        w.put(bit_size, val & ((1 << bit_size) - 1))


def _put_dc(w, diff, luma):
    size = abs(diff).bit_length()
    w.code((T.DC_SIZE_LUMA if luma else T.DC_SIZE_CHROMA)[size])
    if size:
        w.put(size, diff if diff > 0 else diff + (1 << size) - 1)
        if size > 8:
            w.put(1, 1)


def macroblock_planes(y, u, v, mb_w, mb_h):
    """Planes of whole macroblocks, the last row and column repeated."""
    return (np.pad(y, ((0, 16 * mb_h - y.shape[0]), (0, 16 * mb_w - y.shape[1])), mode="edge"),
            np.pad(u, ((0, 8 * mb_h - u.shape[0]), (0, 8 * mb_w - u.shape[1])), mode="edge"),
            np.pad(v, ((0, 8 * mb_h - v.shape[0]), (0, 8 * mb_w - v.shape[1])), mode="edge"))


def _mb_blocks(planes, mb_x, mb_y):
    y, u, v = planes
    yy = y[16 * mb_y:16 * mb_y + 16, 16 * mb_x:16 * mb_x + 16]
    return np.stack([yy[:8, :8], yy[:8, 8:], yy[8:, :8], yy[8:, 8:],
                     u[8 * mb_y:8 * mb_y + 8, 8 * mb_x:8 * mb_x + 8],
                     v[8 * mb_y:8 * mb_y + 8, 8 * mb_x:8 * mb_x + 8]]).astype(np.int64)


def _sad(cur, ref, x, y, mx, my, rounding, edge_w, edge_h):
    pred = mpeg4.half_pel(ref, np.array([x + (mx >> 1)]), np.array([y + (my >> 1)]),
                          np.array([mx & 1]), np.array([my & 1]), 16, rounding, edge_w,
                          edge_h)[0]
    return int(np.abs(cur - pred).sum())


def motion_search(cur, ref, mb_x, mb_y, candidates, rounding, edge_w, edge_h):
    """The 16x16 half-pel vector of macroblock (mb_x, mb_y): the best of
    ``candidates`` at full pel, a diamond of full-pel steps from it, then
    the eight half-pel neighbours; the first of equal costs is kept."""
    x, y = 16 * mb_x, 16 * mb_y
    block = cur[y:y + 16, x:x + 16].astype(np.int32)

    def clamp(v):
        return min(max(v, MV_MIN), MV_MAX)

    best, best_cost = None, None
    for cx, cy in candidates:
        cx, cy = clamp(cx) & ~1, clamp(cy) & ~1
        cost = _sad(block, ref, x, y, cx, cy, rounding, edge_w, edge_h)
        if best_cost is None or cost < best_cost:
            best, best_cost = (cx, cy), cost
    for _ in range(SEARCH_STEPS):
        moved = False
        bx, by = best
        for dx, dy in ((-2, 0), (2, 0), (0, -2), (0, 2)):
            cx, cy = bx + dx, by + dy
            if not (MV_MIN <= cx <= MV_MAX and MV_MIN <= cy <= MV_MAX):
                continue
            cost = _sad(block, ref, x, y, cx, cy, rounding, edge_w, edge_h)
            if cost < best_cost:
                best, best_cost, moved = (cx, cy), cost, True
        if not moved:
            break
    bx, by = best
    for dx, dy in ((-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1)):
        cx, cy = bx + dx, by + dy
        if not (MV_MIN <= cx <= MV_MAX and MV_MIN <= cy <= MV_MAX):
            continue
        cost = _sad(block, ref, x, y, cx, cy, rounding, edge_w, edge_h)
        if cost < best_cost:
            best, best_cost = (cx, cy), cost
    return best


def _fdct(blocks):
    """``jfdctint`` of (n, 8, 8) blocks: eight times the DCT."""
    return fdct_islow(blocks.reshape(-1, 8, 8)).reshape(-1, 64)


def encode_vop_py(planes, ref, prm, header):
    """One VOP's macroblocks, plainly written: ``planes`` are the frame's
    whole-macroblock planes, ``ref`` the previous reconstruction (None for
    an I-VOP), ``header`` the VOP header written so far (bytes, pending
    bits, their count).  Returns (the VOP's bytes, its reconstruction)."""
    mb_w, mb_h, ctype, q = (int(v) for v in prm[:4])
    rounding, edge_w, edge_h = int(prm[5]), int(prm[9]), int(prm[10])
    n_mb = mb_w * mb_h
    w = BitWriter()
    w.out, w.acc, w.n = bytearray(header[0]), header[1], header[2]
    mbs = mpeg4.new_mbs(n_mb)
    mbs["quants"][:] = q
    kinds, blocks, coded = mbs["kinds"], mbs["blocks"], mbs["coded"]
    zig = np.array(T.ZIGZAG)
    state = {"dc": [np.full((2 * mb_h + 1, 2 * mb_w + 1), 1024, np.int32),
                    np.full((mb_h + 1, mb_w + 1), 1024, np.int32),
                    np.full((mb_h + 1, mb_w + 1), 1024, np.int32)],
             "resync_x": 0, "resync_y": 0, "first_line": True, "dc_clip": False}
    mv = np.zeros((2 * mb_h + 1, 2 * mb_w + 2, 2), np.int32)
    dc_luma, dc_chroma = int(T.DC_SCALE[0][q]), int(T.DC_SCALE[1][q])
    qmul, qadd = 2 * q, (q - 1) | 1
    for mb in range(n_mb):
        mb_y, mb_x = divmod(mb, mb_w)
        if mb_x == 0 and mb_y == 1:
            state["first_line"] = False
        row, col = 2 * mb_y, 2 * mb_x
        if ctype == mpeg4.I_VOP:
            coefs = _fdct(_mb_blocks(planes, mb_x, mb_y))
            levels = np.zeros((6, 64), np.int64)
            for n in range(6):
                scale = dc_luma if n < 4 else dc_chroma
                levels[n, 0] = (coefs[n, 0] + 4 * scale) // (8 * scale)
                ac = coefs[n, 1:]
                levels[n, 1:] = np.minimum(np.abs(ac) // (16 * q), 2047) * np.sign(ac)
            cbp = 0
            for n in range(6):
                if levels[n, 1:].any():
                    cbp |= 32 >> n
            w.code(T.INTRA_MCBPC[cbp & 3])
            w.put(1, 0)  # ac_pred_flag
            w.code(T.CBPY[cbp >> 2])
            for n in range(6):
                scale = dc_luma if n < 4 else dc_chroma
                bx, by = mpeg4._block_position(n, mb_x, mb_y)
                level = int(levels[n, 0])
                pred, _ = mpeg4._pred_dc(state, n, bx, by, 0, mb_x, mb_y, scale)
                mpeg4._pred_dc(state, n, bx, by, level - pred, mb_x, mb_y, scale)
                _put_dc(w, level - pred, n < 4)
                if cbp & (32 >> n):
                    _put_block(w, levels[n], zig, 1, 1)
            kinds[mb] = mpeg4.MB_INTRA
            blocks[mb] = levels
            coded[mb] = True
            continue
        # P-VOP: one vector, inter blocks
        px, py = mpeg4._pred_motion(mv, row, col, 0, state["first_line"], mb_x, 0)
        left = tuple(mv[row + 1, col]) if mb_x > 0 else (0, 0)
        up = tuple(mv[row, col + 1]) if mb_y > 0 else (0, 0)
        mx, my = motion_search(planes[0], ref[0], mb_x, mb_y,
                               [(0, 0), (px, py), left, up], rounding, edge_w, edge_h)
        prm_mb = np.array(prm)
        pred = _predict(ref, mb_x, mb_y, mx, my, prm_mb)
        residual = _mb_blocks(planes, mb_x, mb_y).reshape(6, 64) - pred
        coefs = _fdct(residual)
        levels = np.maximum(np.abs(coefs) - 4 * q, 0) // (16 * q)
        levels = np.minimum(levels, 2047) * np.sign(coefs)
        cbp = 0
        for n in range(6):
            if levels[n].any():
                cbp |= 32 >> n
        if cbp == 0 and mx == 0 and my == 0:
            w.put(1, 1)  # not_coded
            kinds[mb] = mpeg4.MB_SKIPPED
            mbs["dirs"][mb] = 1
            mv[row + 1:row + 3, col + 1:col + 3] = 0
            continue
        w.put(1, 0)
        w.code(T.INTER_MCBPC[cbp & 3])
        w.code(T.CBPY[(cbp >> 2) ^ 15])
        _put_motion(w, mx - px)
        _put_motion(w, my - py)
        mv[row + 1:row + 3, col + 1:col + 3] = (mx, my)
        for n in range(6):
            if cbp & (32 >> n):
                _put_block(w, levels[n], zig, 0, 0)
                deq = np.abs(levels[n]) * qmul + qadd
                blocks[mb, n] = np.where(levels[n] == 0, 0, np.sign(levels[n]) * deq)
                coded[mb, n] = True
        kinds[mb] = mpeg4.MB_INTER
        mbs["dirs"][mb] = 1
        mbs["mv"][mb, 0] = (mx, my)
    w.stuffing()
    return bytes(w.out), mpeg4.reconstruct_py(mbs, prm, ref)


def _predict(ref, mb_x, mb_y, mx, my, prm):
    """The reader's 1MV prediction of one macroblock as (6, 64) blocks."""
    rounding, edge_w, edge_h = int(prm[5]), int(prm[9]), int(prm[10])
    out = np.zeros((6, 64), np.int64)
    for k in range(4):
        x = np.array([16 * mb_x + (k & 1) * 8 + (mx >> 1)])
        y = np.array([16 * mb_y + (k >> 1) * 8 + (my >> 1)])
        out[k] = mpeg4.half_pel(ref[0], x, y, np.array([mx & 1]), np.array([my & 1]), 8,
                                rounding, edge_w, edge_h)[0].ravel()
    ux, uy = (16 * mb_x + (mx >> 1)) >> 1, (16 * mb_y + (my >> 1)) >> 1
    hx, hy = (mx & 1) | ((mx & 2) >> 1), (my & 1) | ((my & 2) >> 1)
    for p in (1, 2):
        out[3 + p] = mpeg4.half_pel(ref[p], np.array([ux]), np.array([uy]), np.array([hx]),
                                    np.array([hy]), 8, rounding, edge_w >> 1, edge_h >> 1,
                                    narrow=True)[0].ravel()
    return out


def encode_vop_native(planes, ref, prm, header):
    """``encode_vop_py`` in C++ (``omv_encode_vop``): the same bytes and
    reconstruction."""
    from .. import kernels

    lib = kernels.host_library("mpeg4_host")
    mb_w, mb_h = int(prm[0]), int(prm[1])
    planes = [np.ascontiguousarray(p) for p in planes]
    ref = [np.ascontiguousarray(p) for p in ref] if ref is not None else [None] * 3
    recon = (np.empty((16 * mb_h, 16 * mb_w), np.uint8), np.empty((8 * mb_h, 8 * mb_w), np.uint8),
             np.empty((8 * mb_h, 8 * mb_w), np.uint8))
    head, acc, n = header
    cap = len(head) + 16 + mb_w * mb_h * 6 * 64 * 4
    out = np.empty(cap, np.uint8)
    out[:len(head)] = np.frombuffer(head, np.uint8)
    prm = np.ascontiguousarray(prm, np.int32)
    size = lib.omv_encode_vop(planes[0].ctypes.data, planes[1].ctypes.data,
                              planes[2].ctypes.data, mpeg4._ptr(ref[0]), mpeg4._ptr(ref[1]),
                              mpeg4._ptr(ref[2]), prm.ctypes.data,
                              mpeg4.native_tables().ctypes.data, len(head), acc, n,
                              out.ctypes.data, cap, recon[0].ctypes.data, recon[1].ctypes.data,
                              recon[2].ctypes.data)
    if size < 0:
        raise RuntimeError("omv_encode_vop: the output buffer is too small")
    return out[:size].tobytes(), recon


class Encoder:
    """Encodes frames of ``width`` x ``height`` (even) YUV 4:2:0 planes at
    ``fps`` to packets, one a frame.  ``global_header``: the sequence
    headers go to ``headers`` alone (MP4's ``esds``), not into I-VOP
    packets (AVI)."""

    def __init__(self, width, height, fps, global_header, native=True):
        if width % 2 or height % 2 or width <= 0 or height <= 0:
            raise ValueError(f"an encoded frame of {width}x{height} (even sizes only)")
        self.width, self.height = width, height
        self.rate = cv2_rate(fps)  # (rate, base): fps = rate / base
        self.global_header = global_header
        self.native = native
        self.headers = sequence_headers(width, height, self.rate)
        self.mb_w, self.mb_h = (width + 15) // 16, (height + 15) // 16
        self.time_bits = max(1, (self.rate[0] - 1).bit_length())
        self.frames = 0
        self.ref = None
        self.rounding = 0
        self.last_seconds = 0

    def encode(self, y, u, v):
        """(packet, is an I-VOP) of one frame's planes."""
        rate, base = self.rate
        key = self.frames % GOP == 0
        time = self.frames * base
        seconds, increment = divmod(time, rate)
        w = BitWriter()
        if key:
            if not self.global_header:
                w.out += self.headers
            # group of VOPs: its time code, closed (no B-VOPs), not broken
            w.start_code(0xB3)
            w.put(5, (seconds // 3600) % 24)
            w.put(6, (seconds // 60) % 60)
            w.put(1, 1)
            w.put(6, seconds % 60)
            w.put(1, 1)
            w.put(1, 0)
            w.stuffing()
            self.last_seconds = seconds
            self.rounding = 0
        else:
            self.rounding ^= 1
        w.start_code(0xB6)
        ctype = mpeg4.I_VOP if key else mpeg4.P_VOP
        w.put(2, ctype)
        for _ in range(seconds - self.last_seconds):
            w.put(1, 1)
        w.put(1, 0)
        self.last_seconds = seconds
        w.put(1, 1)
        w.put(self.time_bits, increment)
        w.put(1, 1)
        w.put(1, 1)  # vop_coded
        if not key:
            w.put(1, self.rounding)
        w.put(3, 0)  # intra_dc_vlc_thr
        w.put(5, QUANT)
        if not key:
            w.put(3, 1)  # f_code
        prm = np.zeros(mpeg4.PRM_LEN, np.int32)  # H.263 quantisation, half-pel, simple IDCT
        prm[:mpeg4.P_BCODE + 1] = [self.mb_w, self.mb_h, ctype, QUANT, 1, self.rounding, 32, 0,
                                   self.time_bits, 16 * self.mb_w, 16 * self.mb_h, self.width,
                                   self.height, 1]
        planes = macroblock_planes(y, u, v, self.mb_w, self.mb_h)
        run = encode_vop_native if self.native else encode_vop_py
        packet, self.ref = run(planes, None if key else self.ref, prm, w.bytes())
        self.frames += 1
        return packet, key
