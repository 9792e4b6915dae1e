"""H.264 (ITU-T H.264 | ISO/IEC 14496-10) video, decoded as FFmpeg's
``h264`` decoder decodes it (the decoder behind ``cv2.VideoCapture`` for
``avc1`` MP4 and ``H264`` AVI files), without cv2 or FFmpeg: I, P and B
pictures of progressive, 8-bit, 4:2:0 streams under both entropy coders.

The layers, from the packet down:

* NAL units: a packet's ``lengthSizeMinusOne + 1``-byte lengths (MP4's
  ``avcC``) or Annex B start codes (AVI), the emulation-prevention bytes
  removed.  AUD, SEI (but the recovery point), filler, end of sequence and
  stream, SPS extensions and the SVC/MVC NALs (14, 15, 20; FFmpeg decodes
  the base layer) are skipped.
* Parameter sets (``Sps``, ``Pps``): profiles 66, 77 and 100, POC types 0-2,
  frame cropping, the scaling matrices with fall-back rules A and B, the
  VUI (``video_full_range_flag`` picks the full-range conversion, as
  FFmpeg's ``yuvj420p``; ``bitstream_restriction``'s
  ``max_num_reorder_frames`` the output delay).
* The slice header (``SliceHeader``): both lists' modifications, explicit
  weighted prediction (L1's too), reference marking (the sliding window,
  MMCO 1-6), the deblocking controls, ``cabac_init_idc``, direct mode.
* The slice data (``decode_slice_py``): the macroblock layer under CAVLC
  (``Cavlc``) or CABAC (``Cabac``), every I, P and B macroblock type and
  sub type, B_Skip and direct prediction (spatial and temporal, from the
  co-located picture, ``direct_8x8_inference``), then its reconstruction:
  intra 4x4, 8x8 (with the reference sample filter), 16x16 and chroma
  prediction under ``constrained_intra_pred``, quarter-sample luma and
  eighth-sample chroma motion compensation over clamped reference
  coordinates, bi-prediction, explicit and implicit weighted prediction,
  the inverse 4x4 and 8x8 transforms with the DC transforms and the
  scaling lists.
* The deblocking filter of the whole picture (``deblock_py``), with B's
  boundary strength over both lists.
* The picture buffer (``Decoder``): ``frame_num``, reference marking, the
  initial P and B lists and their modifications, the co-located picture's
  reference map, and the output order FFmpeg's
  ``h264_select_output_frame`` gives (a delay from ``max_num_reorder_frames``,
  grown when POCs arrive out of order; pictures that come too late are
  dropped, as cv2 drops them).

``decode_slice_py`` and ``deblock_py`` are the plain versions, the spec
macroblock by macroblock; ``decode_slice_native`` and ``deblock_native`` are
the same in C++ (``csrc/h264_host.cc``, built at first use by
``kernels.host_library``), which ``Decoder`` runs by default.  Nothing falls
back to Python when the build fails.

The syntax elements of the macroblock layer go through methods of
``SliceDecoder`` (``mb_type``, ``intra_mode``, ``motion_vector``, ...)
that the fixture writer (``probe/h264_encode.py``) overrides to write the
same elements with the same contexts; CABAC's binarisations (``Cabac``)
take the value to code for the same reason.

Refused, each by its name (``UnsupportedH264``): SP and SI slices, field
pictures and MBAFF, chroma formats other than 4:2:0 and separate colour
planes, more than 8 bits, the lossless transform bypass, slice groups,
redundant pictures, data partitioning, gaps in ``frame_num``.
"""

import collections

import numpy as np

from . import h264_tables as T

REFUSAL = "ROADMAP Queue 1 item 1, 'What the infer CLI still refuses'"
P_SLICE, B_SLICE, I_SLICE, SP_SLICE, SI_SLICE = 0, 1, 2, 3, 4
# macroblock kinds kept per macroblock
(I4, I8, I16, PCM, P16X16, P16X8, P8X16, P8X8, P8X8REF0, PSKIP, BDIRECT, B16X16, B16X8, B8X16,
 B8X8, BSKIP) = range(16)
KIND_NAMES = ("I_NxN 4x4", "I_NxN 8x8", "I_16x16", "I_PCM", "P_L0_16x16", "P_L0_L0_16x8",
              "P_L0_L0_8x16", "P_8x8", "P_8x8ref0", "P_Skip", "B_Direct_16x16", "B_16x16",
              "B_16x8", "B_8x16", "B_8x8", "B_Skip")
SKIPS = (PSKIP, BSKIP)
# (x, y, w, h) of each partition of a kind
PARTS = {P16X16: ((0, 0, 16, 16),), P16X8: ((0, 0, 16, 8), (0, 8, 16, 8)),
         P8X16: ((0, 0, 8, 16), (8, 0, 8, 16))}
PARTS.update({B16X16: PARTS[P16X16], B16X8: PARTS[P16X8], B8X16: PARTS[P8X16]})
# B mb_type 1-21 (Table 7-14): the kind and each partition's lists (1 L0,
# 2 L1, 3 both)
_SHAPES = (B16X8, B8X16)
B_MB_TYPES = {1: (B16X16, (1,)), 2: (B16X16, (2,)), 3: (B16X16, (3,))}
for _k, _modes in enumerate(((1, 1), (2, 2), (1, 2), (2, 1), (1, 3), (2, 3), (3, 1), (3, 2),
                             (3, 3))):
    for _s, _kind in enumerate(_SHAPES):
        B_MB_TYPES[4 + 2 * _k + _s] = (_kind, _modes)
del _k, _s, _kind, _modes
_PRED = {1: "L0", 2: "L1", 3: "Bi"}
B_MB_NAMES = ["B_Direct_16x16"] + [
    "B_" + "_".join(_PRED[m] for m in B_MB_TYPES[t][1])
    + ("_16x16" if B_MB_TYPES[t][0] == B16X16 else "_16x8" if B_MB_TYPES[t][0] == B16X8
       else "_8x16") for t in range(1, 22)] + ["B_8x8"]
# sub_mb_type (Tables 7-17, 7-18): (width, height, lists); B's 0 is direct
P_SUB_TYPES = ((8, 8, 1), (8, 4, 1), (4, 8, 1), (4, 4, 1))
B_SUB_TYPES = ((8, 8, 0), (8, 8, 1), (8, 8, 2), (8, 8, 3), (8, 4, 1), (4, 8, 1), (8, 4, 2),
               (4, 8, 2), (8, 4, 3), (4, 8, 3), (4, 4, 1), (4, 4, 2), (4, 4, 3))
B_SUB_NAMES = ("B_Direct_8x8",) + tuple(f"B_{_PRED[m]}_{w}x{h}" for w, h, m in B_SUB_TYPES[1:])
HIGH_PROFILES = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)
# luma4x4BlkIdx -> raster index (4 * row + column) of its 4x4 block
BLK_RASTER = (0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15)
BLK_ORDER = tuple(BLK_RASTER.index(r) for r in range(16))  # raster index -> luma4x4BlkIdx
# the parameter vector of a slice, by index
(PR_MB_W, PR_MB_H, PR_FIRST_MB, PR_TYPE, PR_CABAC, PR_INIT_IDC, PR_QP, PR_NUM_REF, PR_T8_MODE,
 PR_CONSTRAINED, PR_CB_OFF, PR_CR_OFF, PR_SLICE_NUM, PR_DBK_IDC, PR_DBK_A, PR_DBK_B,
 PR_LUMA_DENOM, PR_CHROMA_DENOM, PR_NUM_REF1, PR_WEIGHT_MODE, PR_DIRECT_SPATIAL, PR_DIRECT_8X8,
 PR_COL_SHORT, PR_LEN) = range(24)
# PR_WEIGHT_MODE: no weighting, explicit weights, implicit weights (B only)
WEIGHT_NONE, WEIGHT_EXPLICIT, WEIGHT_IMPLICIT = range(3)
# state arrays of a picture, each (name, values a macroblock, initial value)
STATE = (("kind", 1, -1), ("slice", 1, -1), ("qp", 1, 0), ("t8", 1, 0), ("cbp", 1, 0),
         ("cmode", 1, 0), ("modes", 16, -1), ("nz", 16, 0), ("nzc", 8, 0), ("cbfdc", 3, 0),
         ("mv", 32, 0), ("ref", 16, -1), ("refpic", 16, -1), ("mvd", 32, 0), ("dbk", 3, 0),
         ("mv1", 32, 0), ("ref1", 16, -1), ("refpic1", 16, -1), ("mvd1", 32, 0),
         ("direct", 16, 0), ("lists", 1, 1))
# a list's state arrays: (vectors, reference indices, reference pictures,
# |mvd|); an unused list holds index -1, picture -1 and a zero vector
LIST_STATE = (("mv", "ref", "refpic", "mvd"), ("mv1", "ref1", "refpic1", "mvd1"))


class UnsupportedH264(ValueError):
    def __init__(self, form):
        super().__init__(f"{form} is not read ({REFUSAL})")
        self.form = form


# -- bits and NAL units -------------------------------------------------------

class Bits:
    """MSB-first bits of an RBSP from bit ``pos``, with Exp-Golomb codes."""

    __slots__ = ("data", "pos", "size")

    def __init__(self, data, pos=0):
        self.data = bytes(data)
        self.pos = pos
        self.size = 8 * len(self.data)

    def peek(self, n):
        byte = self.pos >> 3
        chunk = int.from_bytes(self.data[byte:byte + 8].ljust(8, b"\0"), "big")
        return (chunk >> (64 - (self.pos & 7) - n)) & ((1 << n) - 1)

    def u(self, n):
        """``n`` bits (at most 32)."""
        if n == 0:
            return 0
        if self.pos + n > self.size:
            raise EOFError("the bitstream ends inside a field")
        v = self.peek(n)
        self.pos += n
        return v

    def bit(self):
        if self.pos >= self.size:
            raise EOFError("the bitstream ends inside a field")
        v = (self.data[self.pos >> 3] >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return v

    def ue(self):
        zeros = 0
        while not self.bit():
            zeros += 1
            if zeros > 31:
                raise ValueError(f"an Exp-Golomb code of more than 31 leading zeros at bit "
                                 f"{self.pos}")
        return (1 << zeros) - 1 + self.u(zeros)

    def se(self):
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def more_rbsp_data(self):
        """True while bits other than the rbsp trailing bits are left."""
        if self.pos >= self.size:
            return False
        last = len(self.data) - 1
        while last >= 0 and self.data[last] == 0:
            last -= 1
        if last < 0:
            return False
        stop = 8 * last + 7 - ((self.data[last] & -self.data[last]).bit_length() - 1)
        return self.pos < stop


def unescape(nal):
    """The RBSP of a NAL unit's payload: each 0x000003 loses its 0x03."""
    if b"\0\0\3" not in nal:
        return bytes(nal)
    out = bytearray()
    i, n = 0, len(nal)
    while i < n:
        j = nal.find(b"\0\0\3", i)
        if j < 0:
            out += nal[i:]
            break
        out += nal[i:j + 2]
        i = j + 3
    return bytes(out)


def split_annexb(data):
    """The NAL units of Annex B byte stream ``data`` (start codes and the
    trailing zero bytes before the next one removed)."""
    data = bytes(data)
    out = []
    starts = []
    i = data.find(b"\0\0\1")
    while i >= 0:
        starts.append(i + 3)
        i = data.find(b"\0\0\1", i + 3)
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else len(data)
        nal = data[s:e].rstrip(b"\0")
        if nal:
            out.append(nal)
    return out


def split_lengths(data, size):
    """The NAL units of a packet of ``size``-byte big-endian lengths."""
    out = []
    pos, n = 0, len(data)
    while pos + size <= n:
        length = int.from_bytes(data[pos:pos + size], "big")
        pos += size
        if length == 0:
            continue
        if pos + length > n:
            raise ValueError(f"a NAL unit of {length} bytes past the packet's end")
        out.append(bytes(data[pos:pos + length]))
        pos += length
    return out


def parse_avcc(data):
    """(NAL length size, SPS and PPS NAL units) of an ``avcC`` record."""
    data = bytes(data)
    if len(data) < 7 or data[0] != 1:
        raise ValueError("an avcC record of another version than 1")
    size = (data[4] & 3) + 1
    nals = []
    pos = 5
    for count_mask in (0x1F, 0xFF):
        count = data[pos] & count_mask
        pos += 1
        for _ in range(count):
            length = int.from_bytes(data[pos:pos + 2], "big")
            nals.append(data[pos + 2:pos + 2 + length])
            pos += 2 + length
    return size, nals


class AnnexB:
    """FFmpeg's ``h264_mp4toannexb`` filter, which cv2 runs on an ``avcC``
    track's samples when it hands out raw packets (``CAP_PROP_FORMAT`` -1):
    each NAL unit behind a start code (four bytes for a packet's first and
    for parameter sets, three otherwise), the ``avcC`` parameter sets put
    before an IDR picture that comes without them."""

    def __init__(self, avcc):
        self.length_size, nals = parse_avcc(avcc)
        self.sps = b"".join(b"\0\0\0\1" + n for n in nals if n[0] & 0x1F == 7)
        self.pps = b"".join(b"\0\0\0\1" + n for n in nals if n[0] & 0x1F == 8)
        self.new_idr, self.sps_seen, self.pps_seen = True, False, False

    def __call__(self, sample):
        out = bytearray()
        new_idr, sps_seen, pps_seen = self.new_idr, self.sps_seen, self.pps_seen

        def copy(nal, ps):
            out.extend((b"\0\0\0\1" if not out or ps else b"\0\0\1") + nal)

        for nal in split_lengths(sample, self.length_size):
            kind = nal[0] & 0x1F
            if kind == 7:
                sps_seen = new_idr = True
            elif kind == 8:
                pps_seen = new_idr = True
                if not sps_seen and self.sps:
                    out.extend(self.sps)
                    sps_seen = True
            if not new_idr and kind == 5 and len(nal) > 1 and nal[1] & 0x80:
                new_idr = True  # first_mb_in_slice 0: a new IDR picture
            if kind == 6 and len(nal) > 1 and nal[1] == 0 and not sps_seen and not pps_seen:
                out.extend(self.sps + self.pps)  # a buffering period SEI
                sps_seen, pps_seen = bool(self.sps), bool(self.pps)
            if new_idr and kind == 5 and not sps_seen and not pps_seen:
                out.extend(self.sps + self.pps)
                new_idr = False
            elif new_idr and kind == 5 and sps_seen and not pps_seen:
                out.extend(self.pps)
            copy(nal, kind in (7, 8))
            if not new_idr and kind == 1:
                new_idr, sps_seen, pps_seen = True, False, False
        self.new_idr, self.sps_seen, self.pps_seen = new_idr, sps_seen, pps_seen
        return bytes(out)


# -- parameter sets -----------------------------------------------------------

def _scaling_list(r, size):
    """A scaling list in zig-zag order, or None for useDefaultScalingMatrix."""
    last = nxt = 8
    out = []
    for j in range(size):
        if nxt != 0:
            delta = r.se()
            if not -128 <= delta <= 127:
                raise ValueError(f"a delta_scale of {delta}")
            nxt = (last + delta + 256) % 256
            if j == 0 and nxt == 0:
                return None
        out.append(last if nxt == 0 else nxt)
        last = out[-1]
    return out


def _scaling_matrices(r, count, fallback):
    """Lists 0..count-1 (six 4x4 then 8x8, in zig-zag order) under fall-back
    ``fallback``: the lists a missing one falls back to (rule A: the
    defaults; rule B: the sequence's)."""
    defaults = [T.DEFAULT_4X4_INTRA, T.DEFAULT_4X4_INTER, T.DEFAULT_8X8_INTRA,
                T.DEFAULT_8X8_INTER]
    lists = []
    for i in range(count):
        present = r.bit()
        size = 16 if i < 6 else 64
        default = defaults[0 if i < 3 else 1] if i < 6 else defaults[2 + (i - 6) % 2]
        if present:
            lst = _scaling_list(r, size)
            lists.append(tuple(default) if lst is None else tuple(lst))
        elif i in (0, 3, 6, 7):
            lists.append(tuple(fallback[i]))
        else:
            lists.append(lists[i - 1])
    return lists


def _default_lists():
    return [T.DEFAULT_4X4_INTRA] * 3 + [T.DEFAULT_4X4_INTER] * 3 + [T.DEFAULT_8X8_INTRA,
                                                                     T.DEFAULT_8X8_INTER]


FLAT_LISTS = [(T.FLAT,) * 16] * 6 + [(T.FLAT,) * 64] * 2


class Sps:
    """A sequence parameter set."""

    def __init__(self, rbsp):
        r = Bits(rbsp)
        self.profile_idc = r.u(8)
        self.constraint_flags = r.u(8)
        self.level_idc = r.u(8)
        self.id = r.ue()
        if self.id > 31:
            raise ValueError(f"an SPS id of {self.id}")
        self.chroma_format_idc = 1
        self.bit_depth_luma = self.bit_depth_chroma = 8
        self.scaling_present = False
        self.scaling = FLAT_LISTS
        if self.profile_idc in HIGH_PROFILES:
            self.chroma_format_idc = r.ue()
            if self.chroma_format_idc == 3 and r.bit():
                raise UnsupportedH264("separate colour planes (separate_colour_plane_flag)")
            self.bit_depth_luma = r.ue() + 8
            self.bit_depth_chroma = r.ue() + 8
            if r.bit():
                raise UnsupportedH264("the lossless transform bypass "
                                      "(qpprime_y_zero_transform_bypass_flag)")
            self.scaling_present = bool(r.bit())
            if self.scaling_present:
                count = 8 if self.chroma_format_idc != 3 else 12
                self.scaling = _scaling_matrices(r, count, _default_lists())[:8]
        if self.chroma_format_idc != 1:
            raise UnsupportedH264(f"chroma_format_idc {self.chroma_format_idc} (4:2:0, 1, only)")
        if self.bit_depth_luma != 8 or self.bit_depth_chroma != 8:
            raise UnsupportedH264(f"{self.bit_depth_luma}-bit video (8 bits only)")
        self.log2_max_frame_num = r.ue() + 4
        self.poc_type = r.ue()
        self.log2_max_poc_lsb = 0
        self.delta_pic_order_always_zero = 0
        self.offset_for_non_ref_pic = self.offset_for_top_to_bottom = 0
        self.offset_for_ref_frame = []
        if self.poc_type == 0:
            self.log2_max_poc_lsb = r.ue() + 4
        elif self.poc_type == 1:
            self.delta_pic_order_always_zero = r.bit()
            self.offset_for_non_ref_pic = r.se()
            self.offset_for_top_to_bottom = r.se()
            n = r.ue()
            if n > 255:
                raise ValueError(f"a POC cycle of {n} frames")
            self.offset_for_ref_frame = [r.se() for _ in range(n)]
        elif self.poc_type != 2:
            raise ValueError(f"pic_order_cnt_type {self.poc_type}")
        self.max_num_ref_frames = r.ue()
        if self.max_num_ref_frames > 16:
            raise ValueError(f"max_num_ref_frames {self.max_num_ref_frames}")
        self.gaps_allowed = r.bit()
        self.mb_w = r.ue() + 1
        self.mb_h = r.ue() + 1
        if not r.bit():
            raise UnsupportedH264("field pictures and MBAFF (frame_mbs_only_flag 0)")
        self.direct_8x8_inference = r.bit()
        self.crop = (0, 0, 0, 0)
        if r.bit():
            self.crop = tuple(2 * r.ue() for _ in range(4))  # left, right, top, bottom
        self.full_range = 0
        self.bitstream_restriction = 0
        self.num_reorder_frames = 0
        self.timing = None
        self.colour = None
        if r.bit():
            self._vui(r)
        width, height = 16 * self.mb_w, 16 * self.mb_h
        left, right, top, bottom = self.crop
        if left + right >= width or top + bottom >= height:
            raise ValueError(f"a crop of {self.crop} from {width}x{height}")
        self.width, self.height = width - left - right, height - top - bottom

    def _vui(self, r):
        if r.bit():  # aspect_ratio_info
            if r.u(8) == 255:
                r.u(32)
        if r.bit():  # overscan_info
            r.bit()
        if r.bit():  # video_signal_type
            r.u(3)
            self.full_range = r.bit()
            if r.bit():
                self.colour = (r.u(8), r.u(8), r.u(8))
        if r.bit():  # chroma_loc_info
            r.ue()
            r.ue()
        if r.bit():  # timing_info
            self.timing = (r.u(32), r.u(32), r.bit())
        nal_hrd = r.bit()
        if nal_hrd:
            self._hrd(r)
        vcl_hrd = r.bit()
        if vcl_hrd:
            self._hrd(r)
        if nal_hrd or vcl_hrd:
            r.bit()  # low_delay_hrd_flag
        r.bit()  # pic_struct_present_flag
        self.bitstream_restriction = r.bit()
        if self.bitstream_restriction:
            r.bit()
            for _ in range(4):
                r.ue()
            self.num_reorder_frames = r.ue()
            r.ue()  # max_dec_frame_buffering
            if self.num_reorder_frames > 16:
                raise ValueError(f"max_num_reorder_frames {self.num_reorder_frames}")

    @staticmethod
    def _hrd(r):
        count = r.ue() + 1
        r.u(8)
        for _ in range(count):
            r.ue()
            r.ue()
            r.bit()
        r.u(20)


class Pps:
    """A picture parameter set (of the SPS it names, from ``sps_by_id``)."""

    def __init__(self, rbsp, sps_by_id):
        r = Bits(rbsp)
        self.id = r.ue()
        self.sps_id = r.ue()
        if self.id > 255 or self.sps_id not in sps_by_id:
            raise ValueError(f"a PPS {self.id} of an unknown SPS {self.sps_id}")
        sps = sps_by_id[self.sps_id]
        self.cabac = r.bit()
        self.bottom_field_pic_order = r.bit()
        if r.ue() > 0:
            raise UnsupportedH264("slice groups (FMO, num_slice_groups_minus1 > 0)")
        self.num_ref_idx_default = (r.ue() + 1, r.ue() + 1)
        if max(self.num_ref_idx_default) > 32:
            raise ValueError(f"num_ref_idx_default_active of {self.num_ref_idx_default}")
        self.weighted_pred = r.bit()
        self.weighted_bipred = r.u(2)
        self.init_qp = 26 + r.se()
        r.se()  # pic_init_qs
        self.cb_qp_offset = r.se()
        self.deblocking_control = r.bit()
        self.constrained_intra = r.bit()
        self.redundant_pic_cnt_present = r.bit()
        self.transform_8x8 = 0
        self.cr_qp_offset = self.cb_qp_offset
        self.scaling = sps.scaling
        if r.more_rbsp_data():
            self.transform_8x8 = r.bit()
            if r.bit():  # pic_scaling_matrix_present_flag
                count = 6 + 2 * self.transform_8x8
                fallback = sps.scaling if sps.scaling_present else _default_lists()
                lists = _scaling_matrices(r, count, fallback)
                self.scaling = lists + ([] if self.transform_8x8 else list(fallback[6:8]))
            self.cr_qp_offset = r.se()
        if not -12 <= self.cb_qp_offset <= 12 or not -12 <= self.cr_qp_offset <= 12:
            raise ValueError("a chroma QP offset outside -12..12")
        self.level_scale4, self.level_scale8 = level_scales(self.scaling)


def level_scales(lists):
    """LevelScale4x4 (6 lists x 6 values of qP % 6 x 16, raster) and
    LevelScale8x8 (2 x 6 x 64) of the scaling lists."""
    ls4 = np.zeros((6, 6, 16), np.int32)
    ls8 = np.zeros((2, 6, 64), np.int32)
    for i in range(6):
        w = T.scaling_raster(lists[i], T.ZIGZAG4)
        for m in range(6):
            for pos in range(16):
                y, x = divmod(pos, 4)
                k = 0 if (x % 2 == 0 and y % 2 == 0) else 1 if (x % 2 == 1 and y % 2 == 1) else 2
                ls4[i, m, pos] = w[pos] * T.NORM_ADJUST4[m][k]
    for i in range(2):
        w = T.scaling_raster(lists[6 + i], T.ZIGZAG8)
        for m in range(6):
            for pos in range(64):
                y, x = divmod(pos, 8)
                if x % 4 == 0 and y % 4 == 0:
                    k = 0
                elif x % 2 == 1 and y % 2 == 1:
                    k = 1
                elif x % 4 == 2 and y % 4 == 2:
                    k = 2
                elif (x % 4 == 0 and y % 2 == 1) or (x % 2 == 1 and y % 4 == 0):
                    k = 3
                elif (x % 4 == 0 and y % 4 == 2) or (x % 4 == 2 and y % 4 == 0):
                    k = 4
                else:
                    k = 5
                ls8[i, m, pos] = w[pos] * T.NORM_ADJUST8[m][k]
    return ls4, ls8


# -- slice header ---------------------------------------------------------------

class SliceHeader:
    """A slice header; ``bitpos`` is where the slice data starts."""

    def __init__(self, rbsp, nal_type, nal_ref_idc, sps_by_id, pps_by_id):
        r = Bits(rbsp)
        self.nal_type = nal_type
        self.nal_ref_idc = nal_ref_idc
        self.idr = nal_type == 5
        self.first_mb = r.ue()
        raw_type = r.ue()
        if raw_type > 9:
            raise ValueError(f"a slice_type of {raw_type}")
        self.type = raw_type % 5
        if self.type in (SP_SLICE, SI_SLICE):
            raise UnsupportedH264("SP and SI slices")
        self.pps_id = r.ue()
        if self.pps_id not in pps_by_id:
            raise ValueError(f"a slice of an unknown PPS {self.pps_id}")
        pps = self.pps = pps_by_id[self.pps_id]
        sps = self.sps = sps_by_id[pps.sps_id]
        self.frame_num = r.u(sps.log2_max_frame_num)
        self.idr_pic_id = r.ue() if self.idr else 0
        self.poc_lsb = self.delta_poc_bottom = 0
        self.delta_poc = [0, 0]
        if sps.poc_type == 0:
            self.poc_lsb = r.u(sps.log2_max_poc_lsb)
            if pps.bottom_field_pic_order:
                self.delta_poc_bottom = r.se()
        elif sps.poc_type == 1 and not sps.delta_pic_order_always_zero:
            self.delta_poc[0] = r.se()
            if pps.bottom_field_pic_order:
                self.delta_poc[1] = r.se()
        self.redundant_pic_cnt = r.ue() if pps.redundant_pic_cnt_present else 0
        if self.redundant_pic_cnt:
            raise UnsupportedH264("redundant pictures (redundant_pic_cnt > 0)")
        self.num_ref, self.num_ref1 = pps.num_ref_idx_default
        self.direct_spatial = 0
        self.modifications, self.modifications1 = [], []
        self.weights = None  # (luma denominator, chroma denominator, L0 table, L1 table)
        if self.type == B_SLICE:
            self.direct_spatial = r.bit()
        if self.type in (P_SLICE, B_SLICE):
            if r.bit():  # num_ref_idx_active_override_flag
                self.num_ref = r.ue() + 1
                if self.type == B_SLICE:
                    self.num_ref1 = r.ue() + 1
                if max(self.num_ref, self.num_ref1) > 32:
                    raise ValueError(f"num_ref_idx_active of {self.num_ref}, {self.num_ref1}")
            self.modifications = self._modifications(r)
            if self.type == B_SLICE:
                self.modifications1 = self._modifications(r)
            if (pps.weighted_pred and self.type == P_SLICE) or \
                    (pps.weighted_bipred == 1 and self.type == B_SLICE):
                self.weights = self._weights(r)
        self.long_term_reference = 0
        self.mmcos = None  # None: the sliding window
        if nal_ref_idc:
            if self.idr:
                r.bit()  # no_output_of_prior_pics_flag
                self.long_term_reference = r.bit()
            elif r.bit():  # adaptive_ref_pic_marking_mode_flag
                self.mmcos = []
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    if op > 6 or len(self.mmcos) > 66:
                        raise ValueError(f"a memory_management_control_operation of {op}")
                    a = r.ue() if op in (1, 3) else 0
                    b = r.ue() if op in (2, 3, 6) else 0
                    c = r.ue() if op == 4 else 0
                    self.mmcos.append((op, a, b, c))
        self.cabac_init_idc = 0
        if pps.cabac and self.type != I_SLICE:
            self.cabac_init_idc = r.ue()
            if self.cabac_init_idc > 2:
                raise ValueError(f"a cabac_init_idc of {self.cabac_init_idc}")
        self.qp = pps.init_qp + r.se()
        if not 0 <= self.qp <= 51:
            raise ValueError(f"a slice QP of {self.qp}")
        self.deblock_idc, self.alpha_off, self.beta_off = 0, 0, 0
        if pps.deblocking_control:
            self.deblock_idc = r.ue()
            if self.deblock_idc > 2:
                raise ValueError(f"a disable_deblocking_filter_idc of {self.deblock_idc}")
            if self.deblock_idc != 1:
                self.alpha_off = 2 * r.se()
                self.beta_off = 2 * r.se()
                if not -12 <= self.alpha_off <= 12 or not -12 <= self.beta_off <= 12:
                    raise ValueError("a deblocking offset outside -6..6")
        self.bitpos = r.pos
        if self.first_mb >= sps.mb_w * sps.mb_h:
            raise ValueError(f"a first_mb_in_slice of {self.first_mb}")

    @staticmethod
    def _modifications(r):
        """ref_pic_list_modification of one list: (idc, value) pairs."""
        out = []
        if r.bit():  # ref_pic_list_modification_flag_lX
            while True:
                idc = r.ue()
                if idc == 3:
                    break
                if idc > 3 or len(out) > 32:
                    raise ValueError(f"a modification_of_pic_nums_idc of {idc}")
                out.append((idc, r.ue()))
        return out

    def _weights(self, r):
        """pred_weight_table: each reference's (luma weight, offset, Cb
        weight, offset, Cr weight, offset), for L0 and (B) L1."""
        luma_denom = r.ue()
        chroma_denom = r.ue()
        if luma_denom > 7 or chroma_denom > 7:
            raise ValueError("a weight denominator above 7")
        tables = []
        for count in (self.num_ref, self.num_ref1) if self.type == B_SLICE else (self.num_ref,):
            table = []
            for _ in range(count):
                w = [1 << luma_denom, 0, 1 << chroma_denom, 0, 1 << chroma_denom, 0]
                for lo, hi in ((0, 2), (2, 6)):
                    if r.bit():
                        w[lo:hi] = [r.se() for _ in range(lo, hi)]
                        if not all(-128 <= v <= 127 for v in w[lo:hi]):
                            raise ValueError("a prediction weight or offset outside -128..127")
                table.append(w)
            tables.append(table)
        return luma_denom, chroma_denom, tables[0], tables[1] if len(tables) > 1 else None


# -- CAVLC (9.2) --------------------------------------------------------------

def _code_table(lengths, codes, values):
    """{(length, code): value} of a VLC."""
    return {(n, c): v for n, c, v in zip(lengths, codes, values) if n}


_COEFF_TOKEN = [_code_table(T.COEFF_TOKEN_LEN[t], T.COEFF_TOKEN_CODE[t],
                            [(i >> 2, i & 3) for i in range(68)]) for t in range(4)]
_CHROMA_DC_TOKEN = _code_table(T.CHROMA_DC_COEFF_TOKEN_LEN, T.CHROMA_DC_COEFF_TOKEN_CODE,
                               [(i >> 2, i & 3) for i in range(20)])
_TOTAL_ZEROS = [_code_table(ln, cd, range(16)) for ln, cd in zip(T.TOTAL_ZEROS_LEN,
                                                                 T.TOTAL_ZEROS_CODE)]
_CHROMA_DC_TOTAL_ZEROS = [_code_table(ln, cd, range(4)) for ln, cd in
                          zip(T.CHROMA_DC_TOTAL_ZEROS_LEN, T.CHROMA_DC_TOTAL_ZEROS_CODE)]
_RUN_BEFORE = [_code_table(ln, cd, range(16)) for ln, cd in zip(T.RUN_BEFORE_LEN,
                                                               T.RUN_BEFORE_CODE)]


def token_table(nc):
    """The coeff_token table of nC (-1: chroma DC)."""
    if nc < 0:
        return _CHROMA_DC_TOKEN
    return _COEFF_TOKEN[0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3]


class Cavlc(Bits):
    """The CAVLC slice data reader: Exp-Golomb and the residual block."""

    def vlc(self, table, longest=16):
        code = 0
        for n in range(1, longest + 1):
            code = (code << 1) | self.bit()
            v = table.get((n, code))
            if v is not None:
                return v
        raise ValueError(f"an invalid variable-length code at bit {self.pos}")

    def te(self, cmax):
        return 1 - self.bit() if cmax == 1 else self.ue()

    def residual_block(self, nc, max_num):
        """(coefficient levels in scan order, TotalCoeff) of one block."""
        total, ones = self.vlc(token_table(nc))
        levels = [0] * max_num
        if total == 0:
            return levels, 0
        if total > max_num:
            raise ValueError(f"a TotalCoeff of {total} in a block of {max_num}")
        vals = []
        suffix_length = 1 if total > 10 and ones < 3 else 0
        for i in range(total):
            if i < ones:
                vals.append(1 - 2 * self.bit())
                continue
            prefix = 0
            while not self.bit():
                prefix += 1
                if prefix > 32:
                    raise ValueError("a level_prefix above 32")
            code = min(15, prefix) << suffix_length
            if suffix_length > 0 or prefix >= 14:
                size = suffix_length
                if prefix == 14 and suffix_length == 0:
                    size = 4
                if prefix >= 15:
                    size = prefix - 3
                code += self.u(size)
            if prefix >= 15 and suffix_length == 0:
                code += 15
            if prefix >= 16:
                code += (1 << (prefix - 3)) - 4096
            if i == ones and ones < 3:
                code += 2
            level = (code + 2) >> 1 if code % 2 == 0 else (-code - 1) >> 1
            vals.append(level)
            if suffix_length == 0:
                suffix_length = 1
            if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
                suffix_length += 1
        zeros = 0
        if total < max_num:
            table = _CHROMA_DC_TOTAL_ZEROS[total - 1] if nc < 0 else _TOTAL_ZEROS[total - 1]
            zeros = self.vlc(table)
            if zeros > max_num - total:
                raise ValueError(f"total_zeros {zeros} with TotalCoeff {total} of {max_num}")
        pos = total + zeros - 1
        for i in range(total):
            levels[pos] = vals[i]
            if i < total - 1 and zeros > 0:
                run = self.vlc(_RUN_BEFORE[min(zeros, 7) - 1])
                if run > zeros:
                    raise ValueError("a run_before past the zeros left")
                zeros -= run
                pos -= run
            pos -= 1
        return levels, total


# -- CABAC (9.3) -----------------------------------------------------------------

def init_contexts(init_idc, qp):
    """(pStateIdx, valMPS) of each context (9.3.1.1); ``init_idc`` -1 for I."""
    table = T.CABAC_INIT[init_idc + 1]
    qp = min(max(qp, 0), 51)
    states = []
    for mn in table:
        m, n = mn
        pre = min(max(((m * qp) >> 4) + n, 1), 126)
        states.append([pre - 64, 1] if pre > 63 else [63 - pre, 0])
    return states


class CabacElements:
    """CABAC's binarisations of the macroblock layer's syntax elements over
    ``decision``, ``bypass`` and ``terminate``, each given the bin to code
    (``v``) by a writer and None by the reader, and returning the bin."""

    def mb_skip(self, inc, v=None, base=11):
        """mb_skip_flag at ctxIdxOffset 11 (P slices) or 24 (B slices)."""
        return self.decision(base + inc, v)

    def mb_type_i(self, inc, v=None, offset=3):
        """mb_type of an I macroblock (0 I_NxN, 1-24 I_16x16, 25 I_PCM), at
        ctxIdxOffset 3 (I slices, ``inc`` from the neighbours), 17 (the
        suffix in P slices) or 32 (in B slices) (Table 9-39)."""
        i = offset == 3
        t = None if v is None else v - 1
        if not self.decision(3 + inc if i else offset, None if v is None else int(v != 0)):
            return 0
        if self.terminate(None if v is None else int(v == 25)):
            return 25
        luma = self.decision(6 if i else offset + 1, None if v is None else int(t >= 12))
        chroma = self.decision(7 if i else offset + 2,
                               None if v is None else int(t // 4 % 3 != 0))
        if chroma:
            chroma += self.decision(8 if i else offset + 2,
                                    None if v is None else int(t // 4 % 3 == 2))
        m1 = self.decision(9 if i else offset + 3, None if v is None else (t % 4) >> 1)
        m0 = self.decision(10 if i else offset + 3, None if v is None else t & 1)
        return 1 + (m1 << 1 | m0) + 4 * chroma + 12 * luma

    def mb_type_b(self, inc, v=None):
        """mb_type of a B slice: 0-22 the B types, 23-48 intra (23 + the I
        type) (Tables 9-37, 9-39: ctxIdx 27-35)."""
        if not self.decision(27 + inc, None if v is None else int(v != 0)):
            return 0
        if not self.decision(30, None if v is None else int(v >= 3)):
            return 1 + self.decision(32, None if v is None else v - 1)
        code = None
        if v is not None:  # the four bins after "11" (a fifth for 12-21)
            code = 13 if v >= 23 else 14 if v == 11 else 15 if v == 22 else \
                v - 3 if v <= 10 else (v + 4) >> 1
        bits = 0
        for k, ctx in ((3, 31), (2, 32), (1, 32), (0, 32)):
            bits |= self.decision(ctx, None if code is None else (code >> k) & 1) << k
        if bits < 8:
            return bits + 3
        if bits == 13:
            return 23 + self.mb_type_i(0, None if v is None else v - 23, offset=32)
        if bits in (14, 15):
            return 11 if bits == 14 else 22
        return ((bits << 1) | self.decision(32, None if v is None else (v + 4) & 1)) - 4

    def sub_mb_type_b(self, v=None):
        """sub_mb_type of a B_8x8 macroblock, 0-12 (ctxIdx 36-39)."""
        if not self.decision(36, None if v is None else int(v != 0)):
            return 0
        if not self.decision(37, None if v is None else int(v >= 3)):
            return 1 + self.decision(39, None if v is None else v - 1)
        if self.decision(38, None if v is None else int(v >= 7)):
            if self.decision(39, None if v is None else int(v >= 11)):
                return 11 + self.decision(39, None if v is None else v - 11)
            base = 7
        else:
            base = 3
        b1 = self.decision(39, None if v is None else ((v - base) >> 1) & 1)
        return base + 2 * b1 + self.decision(39, None if v is None else (v - base) & 1)

    def mb_type_p(self, v=None):
        """mb_type of a P slice: 0-3 the P types, 5-30 intra (5 + the I
        type) (Table 9-37)."""
        if self.decision(14, None if v is None else int(v >= 5)):
            return 5 + self.mb_type_i(0, None if v is None else v - 5, offset=17)
        if self.decision(15, None if v is None else int(v in (1, 2))):
            return 1 if self.decision(17, None if v is None else int(v == 1)) else 2
        return 3 if self.decision(16, None if v is None else int(v == 3)) else 0

    def sub_mb_type(self, v=None):
        b = lambda k: None if v is None else k  # noqa: E731
        if self.decision(21, b(None if v is None else int(v == 0))):
            return 0
        if not self.decision(22, b(None if v is None else int(v >= 2))):
            return 1
        return 2 if self.decision(23, b(None if v is None else int(v == 2))) else 3

    def transform_8x8(self, inc, v=None):
        return self.decision(399 + inc, v)

    def prev_intra_flag(self, v=None):
        return self.decision(68, v)

    def rem_intra_mode(self, v=None):
        out = 0
        for k in range(3):
            out |= self.decision(69, None if v is None else (v >> k) & 1) << k
        return out

    def chroma_mode(self, inc, v=None):
        if not self.decision(64 + inc, None if v is None else int(v > 0)):
            return 0
        if not self.decision(67, None if v is None else int(v > 1)):
            return 1
        return 2 + self.decision(67, None if v is None else int(v > 2))

    def cbp_luma_bin(self, inc, v=None):
        return self.decision(73 + inc, v)

    def cbp_chroma(self, inc0, inc1, v=None):
        if not self.decision(77 + inc0, None if v is None else int(v > 0)):
            return 0
        return 1 + self.decision(77 + 4 + inc1, None if v is None else int(v > 1))

    def mb_qp_delta(self, inc, v=None):
        k = None if v is None else (2 * v - 1 if v > 0 else -2 * v)
        n = 0
        ctx = 60 + inc
        while self.decision(ctx, None if k is None else int(k > n)):
            n += 1
            ctx = 62 if n == 1 else 63
            if n > 104:
                raise ValueError("an mb_qp_delta past its range")
        return (n + 1) >> 1 if n & 1 else -(n >> 1)

    def ref_idx(self, inc, v=None):
        n = 0
        ctx = 54 + inc
        while self.decision(ctx, None if v is None else int(v > n)):
            n += 1
            ctx = 58 if n == 1 else 59
            if n > 32:
                raise ValueError("a ref_idx past 32")
        return n

    def mvd(self, comp, inc, v=None):
        """One motion vector difference component (UEG3, uCoff 9)."""
        base = 40 if comp == 0 else 47
        a = None if v is None else abs(v)
        n = 0
        ctx = base + inc
        while n < 9 and self.decision(ctx, None if a is None else int(a > n)):
            n += 1
            ctx = base + (3, 4, 5, 6, 6, 6, 6, 6, 6)[n - 1]
        if n == 9:
            n += self.exp_golomb(3, None if a is None else a - 9)
        if n and self.bypass(None if v is None else int(v < 0)):
            return -n
        return n

    def exp_golomb(self, k, v=None):
        out = 0
        while self.bypass(None if v is None else int(v >= (1 << k))):
            if v is not None:
                v -= 1 << k
            out += 1 << k
            k += 1
            if k > 30:
                raise ValueError("an Exp-Golomb suffix past 30 bits")
        while k:
            k -= 1
            out += self.bypass(None if v is None else (v >> k) & 1) << k
        return out

    def coded_block_flag(self, cat, inc, v=None):
        return self.decision(85 + (0, 4, 8, 12, 16)[cat] + inc, v)

    def residual_block(self, cat, max_num, coeffs=None):
        """Coefficient levels (scan order) of a block of ctxBlockCat ``cat``
        whose coded_block_flag is 1 (``coeffs`` to write them)."""
        if cat == 5:
            sig_base, last_base, abs_base = 402, 417, 426
        else:
            off = (0, 15, 29, 44, 47)[cat]
            sig_base, last_base = 105 + off, 166 + off
            abs_base = 227 + (0, 10, 20, 30, 39)[cat]
        levels = [0] * max_num
        if coeffs is not None:
            nzpos = [i for i, c in enumerate(coeffs) if c]
            last_pos = nzpos[-1]
        n = max_num
        sig = []
        i = 0
        while i < n - 1:
            inc = T.SIG_8X8_FRAME[i] if cat == 5 else (min(i, 2) if cat == 3 else i)
            s = self.decision(sig_base + inc, None if coeffs is None else int(coeffs[i] != 0))
            if s:
                sig.append(i)
                linc = T.LAST_8X8[i] if cat == 5 else (min(i, 2) if cat == 3 else i)
                if self.decision(last_base + linc, None if coeffs is None else
                                 int(i == last_pos)):
                    break
            i += 1
        else:
            sig.append(n - 1)
        gt1 = eq1 = 0
        cap = 3 if cat == 3 else 4
        for pos in reversed(sig):
            a = None if coeffs is None else abs(coeffs[pos]) - 1
            ctx = abs_base + (0 if gt1 else min(4, 1 + eq1))
            k = 0
            if self.decision(ctx, None if a is None else int(a > 0)):
                k = 1
                ctx = abs_base + 5 + min(cap, gt1)
                while k < 14 and self.decision(ctx, None if a is None else int(a > k)):
                    k += 1
                if k == 14:
                    k += self.exp_golomb(0, None if a is None else a - 14)
            level = k + 1
            if k:
                gt1 += 1
            else:
                eq1 += 1
            if self.bypass(None if coeffs is None else int(coeffs[pos] < 0)):
                level = -level
            levels[pos] = level
        return levels


class Cabac(CabacElements):
    """The CABAC decoding engine (9.3.1.2, 9.3.3.2) over an RBSP from bit
    ``pos`` (byte aligned), its contexts initialised for ``init_idc`` (-1
    for I slices) at ``qp``."""

    def __init__(self, rbsp, pos, init_idc, qp):
        self.r = Bits(rbsp, pos)
        self.ctx = init_contexts(init_idc, qp)
        self.start()

    def start(self):
        self.range = 510
        self.offset = self.r.u(9)
        if self.offset >= 510:
            raise ValueError("a CABAC offset of 510 or 511")

    def _bit(self):
        r = self.r
        if r.pos >= r.size:
            r.pos += 1
            if r.pos > r.size + 64:
                raise EOFError("the CABAC data runs past the slice")
            return 0
        return r.bit()

    def decision(self, ctx, v=None):
        st = self.ctx[ctx]
        state, mps = st
        lps = T.RANGE_LPS[state][(self.range >> 6) & 3]
        self.range -= lps
        if self.offset >= self.range:
            b = 1 - mps
            self.offset -= self.range
            self.range = lps
            if state == 0:
                st[1] = 1 - mps
            st[0] = T.TRANS_LPS[state]
        else:
            b = mps
            st[0] = state + 1 if state < 62 else 62
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return b

    def bypass(self, v=None):
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self, v=None):
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0


# -- prediction and transforms --------------------------------------------------

def _clip(v):
    return 0 if v < 0 else 255 if v > 255 else v


def intra_nxn(n, mode, top, left, corner):
    """Intra 4x4 (n 4) or 8x8 (n 8, the samples already filtered) prediction:
    ``top`` 2n samples p[x,-1] (or None), ``left`` n samples p[-1,y] (or
    None), ``corner`` p[-1,-1] (or None); an n x n list of rows."""
    def t(x):
        return corner if x < 0 else top[x]

    def lf(y):
        return corner if y < 0 else left[y]

    out = [[0] * n for _ in range(n)]
    for y in range(n):
        for x in range(n):
            if mode == 0:
                v = top[x]
            elif mode == 1:
                v = left[y]
            elif mode == 2:
                if top is not None and left is not None:
                    v = (sum(top[:n]) + sum(left) + n) >> (3 if n == 4 else 4)
                elif left is not None:
                    v = (sum(left) + n // 2) >> (2 if n == 4 else 3)
                elif top is not None:
                    v = (sum(top[:n]) + n // 2) >> (2 if n == 4 else 3)
                else:
                    v = 128
            elif mode == 3:
                if x == n - 1 and y == n - 1:
                    v = (top[2 * n - 2] + 3 * top[2 * n - 1] + 2) >> 2
                else:
                    v = (top[x + y] + 2 * top[x + y + 1] + top[x + y + 2] + 2) >> 2
            elif mode == 4:
                if x > y:
                    v = (t(x - y - 2) + 2 * t(x - y - 1) + t(x - y) + 2) >> 2
                elif x < y:
                    v = (lf(y - x - 2) + 2 * lf(y - x - 1) + lf(y - x) + 2) >> 2
                else:
                    v = (t(0) + 2 * corner + lf(0) + 2) >> 2
            elif mode == 5:
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    v = (t(x - (y >> 1) - 1) + t(x - (y >> 1)) + 1) >> 1
                elif z > 0:
                    v = (t(x - (y >> 1) - 2) + 2 * t(x - (y >> 1) - 1) + t(x - (y >> 1)) + 2) >> 2
                elif z == -1:
                    v = (lf(0) + 2 * corner + t(0) + 2) >> 2
                else:
                    v = (lf(y - 2 * x - 1) + 2 * lf(y - 2 * x - 2) + lf(y - 2 * x - 3) + 2) >> 2
            elif mode == 6:
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    v = (lf(y - (x >> 1) - 1) + lf(y - (x >> 1)) + 1) >> 1
                elif z > 0:
                    v = (lf(y - (x >> 1) - 2) + 2 * lf(y - (x >> 1) - 1) + lf(y - (x >> 1))
                         + 2) >> 2
                elif z == -1:
                    v = (lf(0) + 2 * corner + t(0) + 2) >> 2
                else:
                    v = (t(x - 2 * y - 1) + 2 * t(x - 2 * y - 2) + t(x - 2 * y - 3) + 2) >> 2
            elif mode == 7:
                if y % 2 == 0:
                    v = (top[x + (y >> 1)] + top[x + (y >> 1) + 1] + 1) >> 1
                else:
                    v = (top[x + (y >> 1)] + 2 * top[x + (y >> 1) + 1] + top[x + (y >> 1) + 2]
                         + 2) >> 2
            else:
                z = x + 2 * y
                if z < 2 * n - 3 and z % 2 == 0:
                    v = (left[y + (x >> 1)] + left[y + (x >> 1) + 1] + 1) >> 1
                elif z < 2 * n - 3:
                    v = (left[y + (x >> 1)] + 2 * left[y + (x >> 1) + 1] + left[y + (x >> 1) + 2]
                         + 2) >> 2
                elif z == 2 * n - 3:
                    v = (left[n - 2] + 3 * left[n - 1] + 2) >> 2
                else:
                    v = left[n - 1]
            out[y][x] = v
    return out


def filter_8x8_refs(top, left, corner):
    """The reference sample filter of intra 8x8 prediction (8.3.2.2.1):
    filtered (top 16, left 8, corner), each None where unavailable."""
    ft = fl = fc = None
    if top is not None:
        ft = [0] * 16
        ft[0] = ((corner if corner is not None else top[0]) + 2 * top[0] + top[1] + 2) >> 2
        for x in range(1, 15):
            ft[x] = (top[x - 1] + 2 * top[x] + top[x + 1] + 2) >> 2
        ft[15] = (top[14] + 3 * top[15] + 2) >> 2
    if corner is not None:
        if top is not None and left is not None:
            fc = (top[0] + 2 * corner + left[0] + 2) >> 2
        elif top is not None:
            fc = (3 * corner + top[0] + 2) >> 2
        elif left is not None:
            fc = (3 * corner + left[0] + 2) >> 2
        else:
            fc = corner
    if left is not None:
        fl = [0] * 8
        fl[0] = ((corner if corner is not None else left[0]) + 2 * left[0] + left[1] + 2) >> 2
        for y in range(1, 7):
            fl[y] = (left[y - 1] + 2 * left[y] + left[y + 1] + 2) >> 2
        fl[7] = (left[6] + 3 * left[7] + 2) >> 2
    return ft, fl, fc


def intra_16x16(mode, top, left, corner):
    """Intra 16x16 prediction, a 16 x 16 list of rows."""
    if mode == 0:
        return [list(top) for _ in range(16)]
    if mode == 1:
        return [[left[y]] * 16 for y in range(16)]
    if mode == 2:
        if top is not None and left is not None:
            v = (sum(top) + sum(left) + 16) >> 5
        elif left is not None:
            v = (sum(left) + 8) >> 4
        elif top is not None:
            v = (sum(top) + 8) >> 4
        else:
            v = 128
        return [[v] * 16 for _ in range(16)]
    return _plane(16, top, left, corner, 5)


def _plane(n, top, left, corner, scale):
    half = n // 2
    h = sum((x + 1) * (top[half + x] - (top[half - 2 - x] if half - 2 - x >= 0 else corner))
            for x in range(half))
    v = sum((y + 1) * (left[half + y] - (left[half - 2 - y] if half - 2 - y >= 0 else corner))
            for y in range(half))
    a = 16 * (left[n - 1] + top[n - 1])
    if n == 16:
        b, c = (5 * h + 32) >> 6, (5 * v + 32) >> 6
    else:
        b, c = (34 * h + 32) >> 6, (34 * v + 32) >> 6
    return [[_clip((a + b * (x - half + 1) + c * (y - half + 1) + 16) >> 5) for x in range(n)]
            for y in range(n)]


def intra_chroma(mode, top, left, corner):
    """Chroma prediction of one 8x8 (4:2:0) component (0 DC, 1 horizontal,
    2 vertical, 3 plane)."""
    if mode == 1:
        return [[left[y]] * 8 for y in range(8)]
    if mode == 2:
        return [list(top) for _ in range(8)]
    if mode == 3:
        return _plane(8, top, left, corner, 34)
    out = [[0] * 8 for _ in range(8)]
    for by in range(2):
        for bx in range(2):
            st = sum(top[4 * bx:4 * bx + 4]) if top is not None else None
            sl = sum(left[4 * by:4 * by + 4]) if left is not None else None
            if bx == by:  # (0, 0) and (1, 1): both when there are both
                if st is not None and sl is not None:
                    v = (st + sl + 4) >> 3
                elif sl is not None:
                    v = (sl + 2) >> 2
                elif st is not None:
                    v = (st + 2) >> 2
                else:
                    v = 128
            elif bx == 1:  # the top-right block prefers the top
                v = (st + 2) >> 2 if st is not None else (sl + 2) >> 2 if sl is not None else 128
            else:  # the bottom-left block prefers the left
                v = (sl + 2) >> 2 if sl is not None else (st + 2) >> 2 if st is not None else 128
            for y in range(4):
                for x in range(4):
                    out[4 * by + y][4 * bx + x] = v
    return out


def idct4(d):
    """The inverse 4x4 transform of 16 scaled coefficients (raster) to the
    residual (8.5.12.2), (x + 32) >> 6 included."""
    tmp = [0] * 16
    for i in range(4):
        d0, d1, d2, d3 = d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]
        e0, e1 = d0 + d2, d0 - d2
        e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
        tmp[4 * i], tmp[4 * i + 1], tmp[4 * i + 2], tmp[4 * i + 3] = \
            e0 + e3, e1 + e2, e1 - e2, e0 - e3
    out = [0] * 16
    for j in range(4):
        f0, f1, f2, f3 = tmp[j], tmp[4 + j], tmp[8 + j], tmp[12 + j]
        g0, g1 = f0 + f2, f0 - f2
        g2, g3 = (f1 >> 1) - f3, f1 + (f3 >> 1)
        out[j], out[4 + j], out[8 + j], out[12 + j] = \
            (g0 + g3 + 32) >> 6, (g1 + g2 + 32) >> 6, (g1 - g2 + 32) >> 6, (g0 - g3 + 32) >> 6
    return out


def _idct8_1d(d):
    d0, d1, d2, d3, d4, d5, d6, d7 = d
    e0 = d0 + d4
    e1 = -d3 + d5 - d7 - (d7 >> 1)
    e2 = d0 - d4
    e3 = d1 + d7 - d3 - (d3 >> 1)
    e4 = (d2 >> 1) - d6
    e5 = -d1 + d7 + d5 + (d5 >> 1)
    e6 = d2 + (d6 >> 1)
    e7 = d3 + d5 + d1 + (d1 >> 1)
    f0, f1, f2, f3 = e0 + e6, e1 + (e7 >> 2), e2 + e4, e3 + (e5 >> 2)
    f4, f5, f6, f7 = e2 - e4, (e3 >> 2) - e5, e0 - e6, e7 - (e1 >> 2)
    return [f0 + f7, f2 + f5, f4 + f3, f6 + f1, f6 - f1, f4 - f3, f2 - f5, f0 - f7]


def idct8(d):
    """The inverse 8x8 transform of 64 scaled coefficients (raster)
    (8.5.13.2)."""
    rows = [_idct8_1d(d[8 * i:8 * i + 8]) for i in range(8)]
    out = [0] * 64
    for j in range(8):
        col = _idct8_1d([rows[i][j] for i in range(8)])
        for i in range(8):
            out[8 * i + j] = (col[i] + 32) >> 6
    return out


def scale4(c, ls, qp, dc=None):
    """Scale 16 coefficients (raster) by LevelScale4x4 ``ls`` (of qP % 6);
    ``dc``, when given, is the already scaled DC."""
    out = [0] * 16
    q6 = qp // 6
    for i in range(16):
        v = c[i]
        if v:
            if q6 >= 4:
                out[i] = (v * ls[i]) << (q6 - 4)
            else:
                out[i] = (v * ls[i] + (1 << (3 - q6))) >> (4 - q6)
    if dc is not None:
        out[0] = dc
    return out


def scale8(c, ls, qp):
    out = [0] * 64
    q6 = qp // 6
    for i in range(64):
        v = c[i]
        if v:
            if q6 >= 6:
                out[i] = (v * ls[i]) << (q6 - 6)
            else:
                out[i] = (v * ls[i] + (1 << (5 - q6))) >> (6 - q6)
    return out


def luma_dc(c, ls0, qp):
    """The Intra16x16 DC transform and scaling (8.5.10) of 16 coefficients
    (raster of the 4x4 blocks): the 16 scaled DCs."""
    tmp = [0] * 16
    for i in range(4):
        a, b, cc, d = c[4 * i:4 * i + 4]
        tmp[4 * i:4 * i + 4] = [a + b + cc + d, a + b - cc - d, a - b - cc + d, a - b + cc - d]
    f = [0] * 16
    for j in range(4):
        a, b, cc, d = tmp[j], tmp[4 + j], tmp[8 + j], tmp[12 + j]
        f[j], f[4 + j], f[8 + j], f[12 + j] = a + b + cc + d, a + b - cc - d, a - b - cc + d, \
            a - b + cc - d
    q6 = qp // 6
    if q6 >= 6:
        return [(v * ls0) << (q6 - 6) for v in f]
    return [(v * ls0 + (1 << (5 - q6))) >> (6 - q6) for v in f]


def chroma_dc(c, ls0, qp):
    """The 2x2 chroma DC transform and scaling (8.5.11) of 4 coefficients."""
    a, b, cc, d = c
    f = [a + b + cc + d, a - b + cc - d, a + b - cc - d, a - b - cc + d]
    return [((v * ls0) << (qp // 6)) >> 5 for v in f]


def luma_mc(ref, x, y, w, h, mx, my):
    """Quarter-sample luma prediction (8.4.2.2.1) of the w x h block at
    (x, y) displaced by (mx, my) quarter samples, reference coordinates
    clamped to the plane; an int32 (h, w) array."""
    H, W = ref.shape
    xf, yf = mx & 3, my & 3
    x0, y0 = x + (mx >> 2), y + (my >> 2)
    rows = np.clip(np.arange(y0 - 2, y0 + h + 3), 0, H - 1)
    cols = np.clip(np.arange(x0 - 2, x0 + w + 3), 0, W - 1)
    P = ref[rows][:, cols].astype(np.int32)
    G = P[2:2 + h, 2:2 + w]
    if xf == 0 and yf == 0:
        return G.copy()

    def tap(a, axis, n):
        s = [np.take(a, range(k, k + n), axis=axis) for k in range(6)]
        return s[0] - 5 * s[1] + 20 * s[2] + 20 * s[3] - 5 * s[4] + s[5]

    b1 = tap(P, 1, w)  # (h + 5, w): half samples between columns
    b = np.clip((b1 + 16) >> 5, 0, 255)
    h1 = tap(P, 0, h)  # (h, w + 5)
    hh = np.clip((h1 + 16) >> 5, 0, 255)
    bb, s = b[2:2 + h], b[3:3 + h]
    hv, m = hh[:, 2:2 + w], hh[:, 3:3 + w]
    if xf == 2 and yf == 0:
        return bb
    if yf == 0:
        return (G + bb + 1) >> 1 if xf == 1 else (P[2:2 + h, 3:3 + w] + bb + 1) >> 1
    if xf == 0:
        if yf == 2:
            return hv
        return (G + hv + 1) >> 1 if yf == 1 else (P[3:3 + h, 2:2 + w] + hv + 1) >> 1
    if xf in (1, 3) and yf in (1, 3):
        first = bb if yf == 1 else s
        second = hv if xf == 1 else m
        return (first + second + 1) >> 1
    j1 = tap(b1, 0, h)
    j = np.clip((j1 + 512) >> 10, 0, 255)
    if xf == 2 and yf == 2:
        return j
    if xf == 2:
        return (bb + j + 1) >> 1 if yf == 1 else (j + s + 1) >> 1
    return (hv + j + 1) >> 1 if xf == 1 else (j + m + 1) >> 1


def chroma_mc(ref, x, y, w, h, mx, my):
    """Eighth-sample chroma prediction (8.4.2.2.2) of the w x h block at
    chroma (x, y) by the luma vector (mx, my) (4:2:0)."""
    H, W = ref.shape
    xf, yf = mx & 7, my & 7
    x0, y0 = x + (mx >> 3), y + (my >> 3)
    rows = np.clip(np.arange(y0, y0 + h + 1), 0, H - 1)
    cols = np.clip(np.arange(x0, x0 + w + 1), 0, W - 1)
    P = ref[rows][:, cols].astype(np.int32)
    return ((8 - xf) * (8 - yf) * P[:h, :w] + xf * (8 - yf) * P[:h, 1:] + (8 - xf) * yf * P[1:, :w]
            + xf * yf * P[1:, 1:] + 32) >> 6


def weight(pred, w, o, denom):
    """Explicit weighted prediction of one reference (8.4.2.3.2)."""
    if denom >= 1:
        out = ((pred * w + (1 << (denom - 1))) >> denom) + o
    else:
        out = pred * w + o
    return np.clip(out, 0, 255)


def bi_weight(a, b, w0, w1, o0, o1, denom):
    """Weighted bi-prediction of two references (8.4.2.3.2), explicit or
    implicit (``denom`` 5, no offsets)."""
    return np.clip(((a * w0 + b * w1 + (1 << denom)) >> (denom + 1)) + ((o0 + o1 + 1) >> 1), 0,
                   255)


# -- the slice data -----------------------------------------------------------------

class Picture:
    """A decoded picture: planes (coded size), its state arrays, and what
    the picture buffer keeps of it; ``pid`` tells it from the decoder's
    other pictures (the deblocking filter's "different reference
    pictures", direct prediction's co-located references)."""

    def __init__(self, mb_w, mb_h, pid):
        self.y = np.zeros((16 * mb_h, 16 * mb_w), np.uint8)
        self.u = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
        self.v = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
        n = mb_w * mb_h
        self.state = {name: np.full(n * per, init, np.int32) for name, per, init in STATE}
        self.id = pid
        self.frame_num = 0
        self.poc = 0
        self.ref = None  # None, "short" or "long"
        self.long_idx = -1
        self.key = False
        self.mmco_reset = False  # FFmpeg's output barrier
        self.mmco5 = False
        self.recovered = False
        self.crop = (0, 0, 0, 0)
        self.full_range = 0
        self.colourspace = 2  # AVColorSpace: unspecified
        self.packet = -1  # the index of the packet that held it
        self.b_first = False  # its first slice a B slice (FFmpeg's pict_type B)


class Lists:
    """What a slice predicts from: its reference lists (``refs[0]``,
    ``refs[1]``: pictures), each list's explicit weights (or None), the
    implicit bi-prediction weights w0 by (L0, L1) index (or None), temporal
    direct's DistScaleFactor by L0 index, and the co-located picture's
    arrays (``col``: its state's kind, ref, ref1, mv, mv1, and ``map``,
    ``map1``: the L0 index each block's reference maps to; None outside B
    slices)."""

    def __init__(self, refs0, refs1=(), weights=(None, None), implicit=None, dist_scale=None,
                 col=None):
        self.refs = (list(refs0), list(refs1))
        self.weights = weights
        self.implicit = implicit
        self.dist_scale = dist_scale
        self.col = col


class SliceDecoder:
    """Decodes one slice's macroblocks into a picture (the plain version).

    ``prm`` is the parameter vector (``PR_*``), ``lists`` the slice's
    ``Lists``, ``level_scale`` the PPS's (LevelScale4x4, LevelScale8x8);
    ``coverage`` a Counter of the paths taken (``Decoder.coverage``)."""

    def __init__(self, rbsp, bitpos, prm, pic, lists, level_scale, coverage=None):
        self.coverage = collections.Counter() if coverage is None else coverage
        self.setup(prm, pic, lists, level_scale)
        if self.cabac:
            pos = (bitpos + 7) & ~7  # cabac_alignment_one_bits
            self.ent = Cabac(rbsp, pos, prm[PR_INIT_IDC] if self.slice_type != I_SLICE else -1,
                             prm[PR_QP])
        else:
            self.ent = Cavlc(rbsp, bitpos)

    def setup(self, prm, pic, lists, level_scale):
        self.prm = prm
        self.mb_w, self.mb_h = prm[PR_MB_W], prm[PR_MB_H]
        self.pic = pic
        self.lists = lists
        self.ls4, self.ls8 = level_scale
        self.cabac = bool(prm[PR_CABAC])
        self.coder = "cabac" if self.cabac else "cavlc"
        self.slice_type = prm[PR_TYPE]
        self.num_ref = (prm[PR_NUM_REF], prm[PR_NUM_REF1])
        self.slice_num = prm[PR_SLICE_NUM]
        self.constrained = prm[PR_CONSTRAINED]
        self.t8_mode = prm[PR_T8_MODE]
        self.s = {k: v.tolist() for k, v in pic.state.items()}
        self.col = None if lists.col is None else {k: v.tolist() for k, v in lists.col.items()}
        self.qp = prm[PR_QP]
        self.last_dqp = 0
        self.done = ([False] * 16, [False] * 16)  # each list's 4x4 blocks predicted

    # -- the slice loop ----------------------------------------------------------
    def decode(self):
        """The slice data (7.3.4): the macroblock after the slice's last."""
        addr = self.prm[PR_FIRST_MB]
        inter = self.slice_type != I_SLICE
        while True:
            if inter and not self.cabac:
                run = self.ent.ue()
                for _ in range(run):
                    self.check(addr)
                    self.skip(addr)
                    addr += 1
                if run and not self.ent.more_rbsp_data():
                    return self.end(addr)
            self.check(addr)
            if inter and self.cabac and self.ent.mb_skip(self.skip_ctx(addr),
                                                         base=self.skip_base()):
                self.skip(addr)
            else:
                self.macroblock(addr)
            addr += 1
            if self.cabac:
                if self.ent.terminate():
                    return self.end(addr)
            elif not self.ent.more_rbsp_data():
                return self.end(addr)

    def check(self, addr):
        if addr >= self.mb_w * self.mb_h:
            raise ValueError("the slice runs past the picture's last macroblock")
        if self.s["slice"][addr] != -1:
            raise ValueError(f"macroblock {addr} decoded twice")

    def end(self, addr):
        for k, v in self.s.items():
            self.pic.state[k][:] = v
        return addr

    def skip_base(self):
        return 24 if self.slice_type == B_SLICE else 11

    def skip_ctx(self, addr):
        return sum(1 for n in (self.mb_a(addr), self.mb_b(addr))
                   if n >= 0 and self.s["kind"][n] not in SKIPS)

    def skip(self, addr):
        if self.slice_type == B_SLICE:
            self.b_skip(addr)
        else:
            self.p_skip(addr)

    def start_mb(self, addr, kind):
        """Reset macroblock ``addr``'s state for a macroblock of ``kind``."""
        s = self.s
        s["kind"][addr] = kind
        s["slice"][addr] = self.slice_num
        s["lists"][addr] = 2 if self.slice_type == B_SLICE else 1
        s["dbk"][3 * addr:3 * addr + 3] = [self.prm[PR_DBK_IDC], self.prm[PR_DBK_A],
                                           self.prm[PR_DBK_B]]
        s["qp"][addr] = self.qp
        s["t8"][addr] = s["cbp"][addr] = s["cmode"][addr] = 0
        s["cbfdc"][3 * addr:3 * addr + 3] = [0, 0, 0]
        base = 16 * addr
        for k in range(base, base + 16):
            s["modes"][k] = -1
            s["nz"][k] = s["direct"][k] = 0
            for mv, ref, refpic, mvd in LIST_STATE:
                s[ref][k] = s[refpic][k] = -1
                s[mv][2 * k] = s[mv][2 * k + 1] = s[mvd][2 * k] = s[mvd][2 * k + 1] = 0
        for k in range(8 * addr, 8 * addr + 8):
            s["nzc"][k] = 0
        for done in self.done:
            for k in range(16):
                done[k] = False

    # -- neighbours -------------------------------------------------------------------
    def available(self, n):
        return n >= 0 and self.s["slice"][n] == self.slice_num

    def mb_a(self, addr):
        return addr - 1 if addr % self.mb_w and self.available(addr - 1) else -1

    def mb_b(self, addr):
        return addr - self.mb_w if self.available(addr - self.mb_w) else -1

    def mb_c(self, addr):
        n = addr - self.mb_w + 1
        return n if (addr + 1) % self.mb_w and self.available(n) else -1

    def mb_d(self, addr):
        n = addr - self.mb_w - 1
        return n if addr % self.mb_w and self.available(n) else -1

    def neighbour4(self, addr, x, y):
        """(macroblock, raster 4x4 index) of luma location (x, y) relative
        to macroblock ``addr``'s top-left, or (-1, -1) where unavailable."""
        if 0 <= x < 16 and 0 <= y < 16:
            return addr, (y >> 2) * 4 + (x >> 2)
        if y >= 16 or (x >= 16 and y >= 0):
            return -1, -1
        if y < 0:
            n = self.mb_d(addr) if x < 0 else self.mb_b(addr) if x < 16 else self.mb_c(addr)
        else:
            n = self.mb_a(addr)
        if n < 0:
            return -1, -1
        return n, (((y + 16) & 15) >> 2) * 4 + (((x + 16) & 15) >> 2)

    def intra_avail(self, n):
        """Whether macroblock ``n`` (-1: none) gives samples to intra
        prediction (inter ones do not under constrained_intra_pred)."""
        return n >= 0 and (not self.constrained or self.s["kind"][n] <= PCM)

    # -- the macroblock layer -----------------------------------------------------
    def macroblock(self, addr):
        s = self.s
        raw = self.mb_type(addr)
        st = self.slice_type
        modes = None
        if st == P_SLICE and raw < 5:
            kind = (P16X16, P16X8, P8X16, P8X8, P8X8REF0)[raw]
        elif st == B_SLICE and raw < 23:
            self.coverage["mb", B_MB_NAMES[raw], self.coder] += 1
            kind = BDIRECT if raw == 0 else B8X8 if raw == 22 else B_MB_TYPES[raw][0]
            modes = B_MB_TYPES[raw][1] if kind in (B16X16, B16X8, B8X16) else None
        else:
            itype = raw - (0 if st == I_SLICE else 5 if st == P_SLICE else 23)
            if itype > 25:
                raise ValueError(f"an mb_type of {raw}")
            kind = I4 if itype == 0 else PCM if itype == 25 else I16
            if st == B_SLICE:
                self.coverage["mb", "B intra", self.coder] += 1
        self.start_mb(addr, kind)
        if kind == PCM:
            self.coverage["mb", KIND_NAMES[PCM], self.coder] += 1
            self.pcm(addr)
            return
        t8 = 0
        cbp = 0
        small = False
        if kind in (P8X8, P8X8REF0, B8X8):
            if kind != B8X8:
                self.coverage["mb", KIND_NAMES[kind]] += 1
            small = self.sub_mb_pred(addr, kind)
        elif kind == BDIRECT:
            self.direct(addr, range(4))
            small = not self.prm[PR_DIRECT_8X8]
        elif kind == I4:
            if self.t8_mode:
                t8 = self.transform_8x8(addr)
                if t8:
                    kind = I8
                    s["kind"][addr] = I8
            self.coverage["mb", KIND_NAMES[kind]] += 1
            self.intra_nxn_modes(addr, t8)
        elif kind == I16:
            mode = (itype - 1) % 4
            cbp = (((itype - 1) // 4) % 3) << 4 | (15 if itype >= 13 else 0)
            self.coverage["mb", "I_16x16", mode, cbp >> 4, cbp & 15] += 1
            self.i16_mode = mode
        else:
            if modes is None:
                self.coverage["mb", KIND_NAMES[kind]] += 1
            self.mb_pred_inter(addr, kind, modes or (1,) * len(PARTS[kind]))
        if kind in (I4, I8, I16):
            s["cmode"][addr] = self.chroma_pred_mode(addr)
            self.coverage["chroma", s["cmode"][addr]] += 1
        if kind != I16:
            cbp = self.coded_block_pattern(addr, kind <= PCM)
            if (cbp & 15) and self.t8_mode and kind not in (I4, I8, I16) and not small:
                t8 = self.transform_8x8(addr)
        s["t8"][addr] = t8
        s["cbp"][addr] = cbp
        if t8:
            self.coverage["transform 8x8", "intra" if kind == I8 else "inter"] += 1
        if cbp or kind == I16:
            dqp = self.mb_qp_delta()
            if not -26 <= dqp <= 25:
                raise ValueError(f"an mb_qp_delta of {dqp}")
            self.qp = (self.qp + dqp + 52) % 52
            self.last_dqp = dqp
        else:
            self.last_dqp = 0
        s["qp"][addr] = self.qp
        coeffs = self.residual(addr, kind, cbp, t8)
        self.reconstruct(addr, kind, cbp, t8, coeffs)

    def mb_type(self, addr):
        if not self.cabac:
            return self.ent.ue()
        if self.slice_type == P_SLICE:
            return self.ent.mb_type_p()
        if self.slice_type == B_SLICE:
            return self.ent.mb_type_b(self.mb_type_b_inc(addr))
        return self.ent.mb_type_i(self.mb_type_inc(addr))

    def mb_type_inc(self, addr):
        return sum(1 for n in (self.mb_a(addr), self.mb_b(addr)) if n >= 0 and
                   self.s["kind"][n] not in (I4, I8))

    def mb_type_b_inc(self, addr):
        return sum(1 for n in (self.mb_a(addr), self.mb_b(addr)) if n >= 0 and
                   self.s["kind"][n] not in (BSKIP, BDIRECT))

    def transform_8x8(self, addr):
        if not self.cabac:
            return self.ent.bit()
        return self.ent.transform_8x8(self.t8_inc(addr))

    def t8_inc(self, addr):
        return sum(self.s["t8"][n] for n in (self.mb_a(addr), self.mb_b(addr)) if n >= 0)

    def pcm(self, addr):
        s = self.s
        samples = self.pcm_samples()
        x0, y0 = 16 * (addr % self.mb_w), 16 * (addr // self.mb_w)
        pic = self.pic
        pic.y[y0:y0 + 16, x0:x0 + 16] = np.asarray(samples[:256], np.uint8).reshape(16, 16)
        pic.u[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = np.asarray(samples[256:320],
                                                                     np.uint8).reshape(8, 8)
        pic.v[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8] = np.asarray(samples[320:],
                                                                     np.uint8).reshape(8, 8)
        if self.cabac:
            self.ent.start()  # 9.3.1.2: the engine starts again after the samples
        for k in range(16 * addr, 16 * addr + 16):
            s["nz"][k] = 16
        for k in range(8 * addr, 8 * addr + 8):
            s["nzc"][k] = 16
        s["qp"][addr] = 0
        s["cbp"][addr] = 0x2F
        s["cbfdc"][3 * addr:3 * addr + 3] = [1, 1, 1]
        self.last_dqp = 0

    def pcm_samples(self):
        """pcm_alignment_zero_bits, then the 384 samples."""
        r = self.ent.r if self.cabac else self.ent
        r.pos = (r.pos + 7) & ~7
        if r.pos + 384 * 8 > r.size:
            raise EOFError("an I_PCM macroblock past the slice's end")
        start = r.pos >> 3
        r.pos += 384 * 8
        return list(r.data[start:start + 384])

    # intra modes
    def pred_intra_mode(self, addr, bx, by):
        """predIntra4x4PredMode / predIntra8x8PredMode of the block at 4x4
        coordinates (bx, by)."""
        s = self.s
        na, ia = self.neighbour4(addr, 4 * bx - 1, 4 * by)
        nb, ib = self.neighbour4(addr, 4 * bx, 4 * by - 1)
        if not self.intra_avail(na) or not self.intra_avail(nb):
            return 2
        ma = s["modes"][16 * na + ia]
        mb = s["modes"][16 * nb + ib]
        return min(2 if ma < 0 else ma, 2 if mb < 0 else mb)

    def intra_nxn_modes(self, addr, t8):
        s = self.s
        base = 16 * addr
        if t8:
            for b8 in range(4):
                bx, by = 2 * (b8 & 1), 2 * (b8 >> 1)
                mode = self.intra_mode(addr, self.pred_intra_mode(addr, bx, by), 8)
                for dy in range(2):
                    for dx in range(2):
                        s["modes"][base + (by + dy) * 4 + bx + dx] = mode
        else:
            for blk in range(16):
                r = BLK_RASTER[blk]
                bx, by = r & 3, r >> 2
                s["modes"][base + r] = self.intra_mode(addr, self.pred_intra_mode(addr, bx, by),
                                                       4)

    def intra_mode(self, addr, pred, size):
        if self.cabac:
            if self.ent.prev_intra_flag():
                return pred
            rem = self.ent.rem_intra_mode()
        else:
            if self.ent.bit():
                return pred
            rem = self.ent.u(3)
        return rem if rem < pred else rem + 1

    def chroma_pred_mode(self, addr):
        mode = self.ent.chroma_mode(self.cmode_inc(addr)) if self.cabac else self.ent.ue()
        if mode > 3:
            raise ValueError(f"an intra_chroma_pred_mode of {mode}")
        return mode

    def cmode_inc(self, addr):
        s = self.s
        return sum(1 for n in (self.mb_a(addr), self.mb_b(addr))
                   if n >= 0 and s["kind"][n] in (I4, I8, I16) and s["cmode"][n] != 0)

    # inter partitions
    def mb_pred_inter(self, addr, kind, modes):
        """mb_pred of a 16x16, 16x8 or 8x16 macroblock whose partitions use
        the lists ``modes`` (1 L0, 2 L1, 3 both): every ref_idx_l0, then
        ref_idx_l1, mvd_l0 and mvd_l1."""
        parts = PARTS[kind]
        refs = ([-1] * len(parts), [-1] * len(parts))
        for lst in range(2):
            for p, (x, y, w, h) in enumerate(parts):
                if modes[p] >> lst & 1:
                    refs[lst][p] = self.ref_idx(addr, x, y, lst) if self.num_ref[lst] > 1 else 0
                    self.set_ref(addr, x, y, w, h, refs[lst][p], lst)
        for lst in range(2):
            for p, (x, y, w, h) in enumerate(parts):
                if modes[p] >> lst & 1:
                    mvp = self.mv_pred(addr, x, y, w, h, refs[lst][p], kind, p, lst)
                    self.motion_vector(addr, x, y, w, h, mvp, lst)
                else:
                    self.store_mv(addr, x, y, w, h, 0, 0, (0, 0), lst)

    def sub_mb_pred(self, addr, kind):
        """sub_mb_pred of a P_8x8, P_8x8ref0 or B_8x8 macroblock; whether a
        partition is smaller than 8x8 (no 8x8 transform then)."""
        b = kind == B8X8
        table = B_SUB_TYPES if b else P_SUB_TYPES
        subs = [self.sub_mb_type() for _ in range(4)]
        for t in subs:
            if t >= len(table):
                raise ValueError(f"a sub_mb_type of {t}")
            if b:
                self.coverage["sub_mb_type", B_SUB_NAMES[t], self.coder] += 1
            else:
                self.coverage["sub_mb_type", ("8x8", "8x4", "4x8", "4x4")[t]] += 1
        direct = [b and t == 0 for t in subs]
        if any(direct):
            self.direct(addr, [b8 for b8 in range(4) if direct[b8]])
        lists = range(2 if b else 1)
        refs = ([0] * 4, [0] * 4)
        for lst in lists:
            for b8 in range(4):
                if direct[b8]:
                    continue
                x, y = 8 * (b8 & 1), 8 * (b8 >> 1)
                if table[subs[b8]][2] >> lst & 1:
                    refs[lst][b8] = self.ref_idx(addr, x, y, lst) if \
                        self.num_ref[lst] > 1 and kind != P8X8REF0 else 0
                else:
                    refs[lst][b8] = -1
                self.set_ref(addr, x, y, 8, 8, refs[lst][b8], lst)
        for lst in lists:
            for b8 in range(4):
                x8, y8 = 8 * (b8 & 1), 8 * (b8 >> 1)
                if direct[b8]:
                    for k in range(4):
                        self.done[lst][BLK_RASTER[4 * b8 + k]] = True
                    continue
                w, h, used = table[subs[b8]]
                if not used >> lst & 1:
                    self.store_mv(addr, x8, y8, 8, 8, 0, 0, (0, 0), lst)
                    continue
                for sub in range(4 if w == h == 4 else 1 if w == h == 8 else 2):
                    if w == 4 and h == 4:
                        x, y = x8 + 4 * (sub & 1), y8 + 4 * (sub >> 1)
                    else:
                        x, y = x8 + 4 * sub * (w == 4), y8 + 4 * sub * (h == 4)
                    mvp = self.mv_pred(addr, x, y, w, h, refs[lst][b8], kind, -1, lst)
                    self.motion_vector(addr, x, y, w, h, mvp, lst)
        if any(direct) and not self.prm[PR_DIRECT_8X8]:
            return True
        return any(not d and table[t][:2] != (8, 8) for d, t in zip(direct, subs))

    def sub_mb_type(self):
        if not self.cabac:
            return self.ent.ue()
        return self.ent.sub_mb_type_b() if self.slice_type == B_SLICE else \
            self.ent.sub_mb_type()

    def ref_idx(self, addr, x, y, lst=0):
        n = self.num_ref[lst]
        ref = self.ent.ref_idx(self.ref_inc(addr, x, y, lst)) if self.cabac else \
            self.ent.te(n - 1)
        if ref >= n:
            raise ValueError(f"a ref_idx of {ref} with {n} references")
        return ref

    def ref_inc(self, addr, x, y, lst=0):
        """ctxIdxInc of ref_idx: a neighbour counts where it is inter, not
        skipped nor direct, and its reference index in the list is above 0."""
        s = self.s
        refs = s[LIST_STATE[lst][1]]
        inc = 0
        for k, (nx, ny) in enumerate(((x - 1, y), (x, y - 1))):
            n, i = self.neighbour4(addr, nx, ny)
            if n >= 0 and s["kind"][n] > PCM and s["kind"][n] not in SKIPS and \
                    not s["direct"][16 * n + i] and refs[16 * n + i] > 0:
                inc += 1 + k
        return inc

    def set_ref(self, addr, x, y, w, h, ref, lst=0):
        s = self.s
        refs = self.lists.refs[lst]
        pid = refs[ref].id if 0 <= ref < len(refs) else -1
        _, ref_a, pic_a, _ = LIST_STATE[lst]
        for by in range(y >> 2, (y + h) >> 2):
            for bx in range(x >> 2, (x + w) >> 2):
                k = 16 * addr + 4 * by + bx
                s[ref_a][k] = ref
                s[pic_a][k] = pid

    def mv_neighbour(self, addr, x, y, lst=0):
        """(available, ref, mvx, mvy) in list ``lst`` of the partition
        covering (x, y); an intra one, or one not using the list, has ref
        -1 and a zero vector."""
        n, i = self.neighbour4(addr, x, y)
        if n < 0 or (n == addr and not self.done[lst][i]):
            return False, -1, 0, 0
        s = self.s
        k = 16 * n + i
        if s["kind"][n] <= PCM:
            return True, -1, 0, 0
        mv, ref, _, _ = LIST_STATE[lst]
        return True, s[ref][k], s[mv][2 * k], s[mv][2 * k + 1]

    def mv_pred(self, addr, x, y, w, h, ref, kind, part, lst=0):
        """The luma motion vector prediction (8.4.1.3) in list ``lst``."""
        a = self.mv_neighbour(addr, x - 1, y, lst)
        b = self.mv_neighbour(addr, x, y - 1, lst)
        c = self.mv_neighbour(addr, x + w, y - 1, lst)
        if not c[0]:
            c = self.mv_neighbour(addr, x - 1, y - 1, lst)
        if kind in (P16X8, B16X8):
            if part == 0 and b[1] == ref:
                return b[2], b[3]
            if part == 1 and a[1] == ref:
                return a[2], a[3]
        elif kind in (P8X16, B8X16):
            if part == 0 and a[1] == ref:
                return a[2], a[3]
            if part == 1 and c[1] == ref:
                return c[2], c[3]
        if not b[0] and not c[0] and a[0]:
            b = c = a
        match = [n for n in (a, b, c) if n[1] == ref]
        if len(match) == 1:
            return match[0][2], match[0][3]
        return (sorted((a[2], b[2], c[2]))[1], sorted((a[3], b[3], c[3]))[1])

    def motion_vector(self, addr, x, y, w, h, mvp, lst=0):
        """Read the partition's mvd in list ``lst``, store its vector (and
        |mvd|)."""
        mvd = [self.ent.mvd(comp, self.mvd_inc(addr, x, y, comp, lst)) if self.cabac else
               self.ent.se() for comp in range(2)]
        self.store_mv(addr, x, y, w, h, mvp[0] + mvd[0], mvp[1] + mvd[1], mvd, lst)

    def mvd_inc(self, addr, x, y, comp, lst=0):
        s = self.s
        mvds = s[LIST_STATE[lst][3]]
        total = 0
        for nx, ny in ((x - 1, y), (x, y - 1)):
            n, i = self.neighbour4(addr, nx, ny)
            if n >= 0:
                total += mvds[2 * (16 * n + i) + comp]
        return 0 if total < 3 else 1 if total <= 32 else 2

    def store_mv(self, addr, x, y, w, h, mvx, mvy, mvd, lst=0):
        s = self.s
        if not -2048 * 4 <= mvx < 2048 * 4 or not -2048 * 4 <= mvy < 2048 * 4:
            raise ValueError(f"a motion vector of ({mvx}, {mvy})")
        mv, _, _, mvd_a = LIST_STATE[lst]
        done = self.done[lst]
        for by in range(y >> 2, (y + h) >> 2):
            for bx in range(x >> 2, (x + w) >> 2):
                k = 16 * addr + 4 * by + bx
                s[mv][2 * k], s[mv][2 * k + 1] = mvx, mvy
                s[mvd_a][2 * k], s[mvd_a][2 * k + 1] = abs(mvd[0]), abs(mvd[1])
                done[4 * by + bx] = True

    def p_skip_mv(self, addr):
        """P_Skip's vector (8.4.1.1)."""
        a = self.mv_neighbour(addr, -1, 0)
        b = self.mv_neighbour(addr, 0, -1)
        if not a[0] or not b[0] or (a[1] == 0 and a[2] == 0 and a[3] == 0) or \
                (b[1] == 0 and b[2] == 0 and b[3] == 0):
            return 0, 0
        return self.mv_pred(addr, 0, 0, 16, 16, 0, P16X16, 0)

    def p_skip(self, addr):
        self.coverage["mb", "P_Skip", self.coder] += 1
        self.start_mb(addr, PSKIP)
        mvx, mvy = self.p_skip_mv(addr)
        self.set_ref(addr, 0, 0, 16, 16, 0)
        self.store_mv(addr, 0, 0, 16, 16, mvx, mvy, (0, 0))
        self.last_dqp = 0
        self.inter_pred(addr)

    def b_skip(self, addr):
        self.coverage["mb", "B_Skip", self.coder] += 1
        self.start_mb(addr, BSKIP)
        self.direct(addr, range(4))
        self.last_dqp = 0
        self.inter_pred(addr)

    def direct_spatial_refs(self, addr):
        """Spatial direct's (refIdxL0, refIdxL1) and each list's predicted
        vector (8.4.1.2.2): the least non-negative reference index of the
        neighbours A, B and C (D where C is missing), both 0 with zero
        vectors where neither list has one."""
        refs, mvps = [], []
        for lst in range(2):
            a = self.mv_neighbour(addr, -1, 0, lst)
            b = self.mv_neighbour(addr, 0, -1, lst)
            c = self.mv_neighbour(addr, 16, -1, lst)
            if not c[0]:
                c = self.mv_neighbour(addr, -1, -1, lst)
            found = [n[1] for n in (a, b, c) if n[1] >= 0]
            ref = min(found) if found else -1
            refs.append(ref)
            mvps.append(self.mv_pred(addr, 0, 0, 16, 16, ref, B16X16, 0, lst) if ref >= 0
                        else (0, 0))
        if refs[0] < 0 and refs[1] < 0:
            return [0, 0], [(0, 0), (0, 0)], True
        return refs, mvps, False

    def direct(self, addr, b8s):
        """Direct prediction (8.4.1.2) of the 8x8 blocks ``b8s``: each 4x4
        block's references and vectors in both lists, from the co-located
        block of RefPicList1[0] (its corner block under
        direct_8x8_inference)."""
        s, col, prm = self.s, self.col, self.prm
        spatial = prm[PR_DIRECT_SPATIAL]
        infer = prm[PR_DIRECT_8X8]
        self.coverage["direct", "spatial" if spatial else "temporal", infer, self.coder] += 1
        if spatial:
            refs, mvps, zero = self.direct_spatial_refs(addr)
        col_intra = col["kind"][addr] <= PCM
        for b8 in b8s:
            for r in BLK_RASTER[4 * b8:4 * b8 + 4]:
                bx, by = r & 3, r >> 2
                ck = 16 * addr + ((by >> 1) * 12 + (bx >> 1) * 3 if infer else r)
                if col_intra:
                    col_ref, cmv, col_list = -1, (0, 0), 0
                elif col["ref"][ck] >= 0:
                    col_ref, cmv, col_list = col["ref"][ck], col["mv"][2 * ck:2 * ck + 2], 0
                else:
                    col_ref, cmv, col_list = col["ref1"][ck], col["mv1"][2 * ck:2 * ck + 2], 1
                if spatial:
                    col_zero = prm[PR_COL_SHORT] and col_ref == 0 and abs(cmv[0]) <= 1 and \
                        abs(cmv[1]) <= 1
                    block = [(ref, (0, 0) if ref < 0 or zero or (ref == 0 and col_zero)
                              else mvps[lst]) for lst, ref in enumerate(refs)]
                else:
                    ref0 = 0 if col_intra else col["map1" if col_list else "map"][ck]
                    scale = self.lists.dist_scale[ref0]
                    mv0 = ((scale * cmv[0] + 128) >> 8, (scale * cmv[1] + 128) >> 8)
                    block = [(ref0, mv0), (0, (mv0[0] - cmv[0], mv0[1] - cmv[1]))]
                k = 16 * addr + r
                s["direct"][k] = 1
                for lst, (ref, mv) in enumerate(block):
                    mv_a, ref_a, pic_a, _ = LIST_STATE[lst]
                    s[ref_a][k] = ref
                    s[pic_a][k] = self.lists.refs[lst][ref].id if ref >= 0 else -1
                    s[mv_a][2 * k], s[mv_a][2 * k + 1] = mv

    def coded_block_pattern(self, addr, intra):
        if not self.cabac:
            code = self.ent.ue()
            if code > 47:
                raise ValueError(f"a coded_block_pattern code of {code}")
            return (T.CBP_INTRA if intra else T.CBP_INTER)[code]
        luma = 0
        for b8 in range(4):
            luma |= self.ent.cbp_luma_bin(self.cbp_luma_inc(addr, b8, luma)) << b8
        return luma | self.ent.cbp_chroma(*self.cbp_chroma_inc(addr)) << 4

    def cbp_luma_inc(self, addr, b8, luma):
        """ctxIdxInc of the coded_block_pattern bin of 8x8 block ``b8``,
        ``luma`` holding the bins before it."""
        s = self.s
        conds = []
        for n, nb8, inside in ((self.mb_a(addr), b8 - 1 if b8 & 1 else b8 + 1, b8 & 1),
                               (self.mb_b(addr), b8 - 2 if b8 >> 1 else b8 + 2, b8 >> 1)):
            if inside:
                conds.append(0 if (luma >> nb8) & 1 else 1)
            elif n < 0 or s["kind"][n] == PCM:
                conds.append(0)
            elif s["kind"][n] not in SKIPS and (s["cbp"][n] >> nb8) & 1:
                conds.append(0)
            else:
                conds.append(1)
        return conds[0] + 2 * conds[1]

    def cbp_chroma_inc(self, addr):
        s = self.s
        inc = [0, 0]
        for k, n in enumerate((self.mb_a(addr), self.mb_b(addr))):
            if n < 0:
                continue
            chroma = 2 if s["kind"][n] == PCM else 0 if s["kind"][n] in SKIPS else \
                s["cbp"][n] >> 4
            inc[0] += (1 + k) * (chroma != 0)
            inc[1] += (1 + k) * (chroma == 2)
        return inc

    def mb_qp_delta(self):
        if self.cabac:
            return self.ent.mb_qp_delta(int(self.last_dqp != 0))
        return self.ent.se()

    # residual
    def nc_luma(self, addr, r):
        """nC of the luma 4x4 block at raster index ``r`` (9.2.1)."""
        bx, by = r & 3, r >> 2
        s = self.s
        out = []
        for x, y in ((4 * bx - 1, 4 * by), (4 * bx, 4 * by - 1)):
            n, i = self.neighbour4(addr, x, y)
            if n < 0:
                out.append(None)
            elif s["kind"][n] in SKIPS:
                out.append(0)
            else:
                out.append(s["nz"][16 * n + i])
        return _nc(out)

    def nc_chroma(self, addr, comp, r):
        bx, by = r & 1, r >> 1
        s = self.s
        out = []
        for dx, dy in ((-1, 0), (0, -1)):
            x, y = bx + dx, by + dy
            if 0 <= x < 2 and 0 <= y < 2:
                out.append(s["nzc"][8 * addr + 4 * comp + 2 * y + x])
                continue
            n = self.mb_a(addr) if x < 0 else self.mb_b(addr)
            if n < 0:
                out.append(None)
            elif s["kind"][n] in SKIPS:
                out.append(0)
            else:
                out.append(s["nzc"][8 * n + 4 * comp + 2 * (y & 1) + (x & 1)])
        return _nc(out)

    def cbf_ctx(self, addr, cat, comp=0, r=0):
        """ctxIdxInc of coded_block_flag (9.3.3.1.1.9) for ctxBlockCat
        ``cat`` (0 luma DC, 1 and 2 luma 4x4 at raster ``r``, 3 chroma DC
        of ``comp``, 4 chroma AC at chroma raster ``r``)."""
        s = self.s
        intra = s["kind"][addr] <= PCM
        inc = 0
        for k, (dx, dy) in enumerate(((-1, 0), (0, -1))):
            if cat in (1, 2):
                n, i = self.neighbour4(addr, 4 * (r & 3) + 4 * dx, 4 * (r >> 2) + 4 * dy)
            elif cat == 4:
                x, y = (r & 1) + dx, (r >> 1) + dy
                if 0 <= x < 2 and 0 <= y < 2:
                    n, i = addr, 2 * y + x
                else:
                    n = self.mb_a(addr) if x < 0 else self.mb_b(addr)
                    i = 2 * (y & 1) + (x & 1)
            else:
                n = self.mb_a(addr) if dx else self.mb_b(addr)
                i = 0
            if n < 0:
                cond = 1 if intra else 0
            elif s["kind"][n] == PCM:
                cond = 1
            elif s["kind"][n] in SKIPS:
                cond = 0
            elif cat == 0:
                cond = s["cbfdc"][3 * n] if s["kind"][n] == I16 else 0
            elif cat == 3:
                cond = s["cbfdc"][3 * n + 1 + comp] if s["cbp"][n] >> 4 else 0
            elif cat == 4:
                cond = int(s["nzc"][8 * n + 4 * comp + i] > 0) if s["cbp"][n] >> 4 == 2 else 0
            else:
                cond = int(s["nz"][16 * n + i] > 0) if (s["cbp"][n] >> ((i >> 3) * 2 +
                                                                      ((i & 3) >> 1))) & 1 else 0
            inc += cond << k
        return inc

    def block(self, addr, cat, max_num, nc=0, comp=0, r=0):
        """One residual block: (levels in scan order, their count)."""
        self.coverage["ctxBlockCat", cat, "cabac" if self.cabac else "cavlc"] += 1
        if not self.cabac:
            return self.ent.residual_block(nc, max_num)
        if cat != 5 and not self.ent.coded_block_flag(cat, self.cbf_ctx(addr, cat, comp, r)):
            return [0] * max_num, 0
        levels = self.ent.residual_block(cat, max_num)
        return levels, sum(1 for v in levels if v)

    def residual(self, addr, kind, cbp, t8):
        """Every coefficient of the macroblock: {"dc": luma DC (I16),
        "luma": 16 raster-indexed lists (4x4, or the 8x8s at 0, 2, 8, 10),
        "cdc": two chroma DC lists, "cac": two x four chroma AC lists}."""
        s = self.s
        base = 16 * addr
        out = {"dc": None, "luma": [None] * 16, "cdc": [None, None], "cac": [[None] * 4,
                                                                               [None] * 4]}
        if kind == I16:
            levels, n = self.block(addr, 0, 16, self.nc_luma(addr, 0))
            out["dc"] = levels
            s["cbfdc"][3 * addr] = int(n > 0)
        for b8 in range(4):
            rs = [BLK_RASTER[4 * b8 + k] for k in range(4)]
            if not (cbp >> b8) & 1:
                for r in rs:
                    s["nz"][base + r] = 0
                continue
            if t8 and self.cabac:
                levels, n = self.block(addr, 5, 64, r=rs[0])
                out["luma"][rs[0]] = levels
                for r in rs:
                    s["nz"][base + r] = n
                continue
            if t8:  # CAVLC: four interleaved 4x4 blocks
                full = [0] * 64
                for k, r in enumerate(rs):
                    levels, n = self.block(addr, 2, 16, self.nc_luma(addr, r), r=r)
                    s["nz"][base + r] = n
                    for i in range(16):
                        full[4 * i + k] = levels[i]
                out["luma"][rs[0]] = full
                continue
            for r in rs:
                if kind == I16:
                    levels, n = self.block(addr, 1, 15, self.nc_luma(addr, r), r=r)
                    levels = [0] + levels
                else:
                    levels, n = self.block(addr, 2, 16, self.nc_luma(addr, r), r=r)
                s["nz"][base + r] = n
                out["luma"][r] = levels
        chroma = cbp >> 4
        for comp in range(2):
            if chroma:
                levels, n = self.block(addr, 3, 4, -1, comp=comp)
                out["cdc"][comp] = levels
                s["cbfdc"][3 * addr + 1 + comp] = int(n > 0)
            else:
                s["cbfdc"][3 * addr + 1 + comp] = 0
        for comp in range(2):
            for r in range(4):
                if chroma == 2:
                    levels, n = self.block(addr, 4, 15, self.nc_chroma(addr, comp, r), comp, r)
                    out["cac"][comp][r] = [0] + levels
                else:
                    n = 0
                s["nzc"][8 * addr + 4 * comp + r] = n
        return out

    # -- reconstruction ------------------------------------------------------------
    def reconstruct(self, addr, kind, cbp, t8, coeffs):
        if kind <= PCM:
            self.intra_pred_residual(addr, kind, t8, coeffs)
        else:
            self.inter_pred(addr)
            self.add_luma_residual(addr, kind, t8, coeffs)
        self.chroma(addr, kind, coeffs)

    def luma_scale(self, intra):
        qp = self.qp
        return self.ls4[0 if intra else 3][qp % 6], self.ls8[0 if intra else 1][qp % 6], qp

    def residual4(self, levels, ls, qp, dc=None):
        c = [0] * 16
        for i, v in enumerate(levels):
            if v:
                c[T.ZIGZAG4[i]] = v
        return idct4(scale4(c, ls, qp, dc))

    def residual8(self, levels, ls, qp):
        c = [0] * 64
        for i, v in enumerate(levels):
            if v:
                c[T.ZIGZAG8[i]] = v
        return idct8(scale8(c, ls, qp))

    def add_luma_residual(self, addr, kind, t8, coeffs):
        x0, y0 = 16 * (addr % self.mb_w), 16 * (addr // self.mb_w)
        ls4, ls8, qp = self.luma_scale(kind <= PCM)
        plane = self.pic.y
        for r, levels in enumerate(coeffs["luma"]):
            if levels is None:
                continue
            bx, by = 4 * (r & 3), 4 * (r >> 2)
            if t8:
                res, n = self.residual8(levels, ls8, qp), 8
            else:
                res, n = self.residual4(levels, ls4, qp), 4
            blk = plane[y0 + by:y0 + by + n, x0 + bx:x0 + bx + n].astype(np.int32)
            plane[y0 + by:y0 + by + n, x0 + bx:x0 + bx + n] = np.clip(
                blk + np.asarray(res, np.int32).reshape(n, n), 0, 255)

    def neighbour_samples(self, plane, x0, y0, size, top_ok, left_ok, corner_ok, topright_ok,
                          right_len):
        """(top, left, corner) samples of a block at (x0, y0) of ``size``;
        ``right_len`` top-right samples after the top ones (substituted by
        the last top sample where unavailable)."""
        top = left = corner = None
        if top_ok:
            top = plane[y0 - 1, x0:x0 + size].tolist()
            if right_len:
                if topright_ok:
                    top += plane[y0 - 1, x0 + size:x0 + size + right_len].tolist()
                else:
                    top += [top[-1]] * right_len
        if left_ok:
            left = plane[y0:y0 + size, x0 - 1].tolist()
        if corner_ok:
            corner = int(plane[y0 - 1, x0 - 1])
        return top, left, corner

    def intra_pred_residual(self, addr, kind, t8, coeffs):
        s = self.s
        mx, my = addr % self.mb_w, addr // self.mb_w
        x0, y0 = 16 * mx, 16 * my
        plane = self.pic.y
        ls4, ls8, qp = self.luma_scale(True)
        na, nb = self.mb_a(addr), self.mb_b(addr)
        nc, nd = self.mb_c(addr), self.mb_d(addr)
        ok_a, ok_b = self.intra_avail(na), self.intra_avail(nb)
        ok_c, ok_d = self.intra_avail(nc), self.intra_avail(nd)
        if kind == I16:
            top, left, corner = self.neighbour_samples(plane, x0, y0, 16, ok_b, ok_a, ok_d,
                                                       False, 0)
            mode = self.i16_mode
            if (mode == 0 and not ok_b) or (mode == 1 and not ok_a) or \
                    (mode == 3 and not (ok_a and ok_b and ok_d)):
                raise ValueError(f"Intra 16x16 mode {mode} without its neighbours")
            self.coverage["intra 16x16", mode] += 1
            pred = intra_16x16(mode, top, left, corner)
            dc_raster = [0] * 16
            for i, v in enumerate(coeffs["dc"]):
                dc_raster[T.ZIGZAG4[i]] = v
            dcs = luma_dc(dc_raster, ls4[0], qp)
            res = np.zeros((16, 16), np.int32)
            for r in range(16):
                bx, by = 4 * (r & 3), 4 * (r >> 2)
                levels = coeffs["luma"][r] or [0] * 16
                res[by:by + 4, bx:bx + 4] = np.asarray(self.residual4(levels, ls4, qp, dcs[r]),
                                                        np.int32).reshape(4, 4)
            plane[y0:y0 + 16, x0:x0 + 16] = np.clip(np.asarray(pred, np.int32) + res, 0, 255)
            return
        n = 8 if t8 else 4
        for blk in range(4 if t8 else 16):
            if t8:
                bx, by = 8 * (blk & 1), 8 * (blk >> 1)
            else:
                r = BLK_RASTER[blk]
                bx, by = 4 * (r & 3), 4 * (r >> 2)
            mode = s["modes"][16 * addr + (by >> 2) * 4 + (bx >> 2)]
            top_ok = ok_b if by == 0 else True
            left_ok = ok_a if bx == 0 else True
            corner_ok = (ok_d if bx == 0 else ok_b) if by == 0 else (ok_a if bx == 0 else True)
            # the top-right: above-right macroblock, the one above, or a block
            # of this macroblock decoded before
            tx, ty = bx + n, by - 1
            if ty < 0:
                topright_ok = ok_c if tx >= 16 else ok_b
            elif tx >= 16:
                topright_ok = False
            else:
                topright_ok = self._decoded_before(tx, ty, bx, by, n)
            top, left, corner = self.neighbour_samples(plane, x0 + bx, y0 + by, n, top_ok,
                                                       left_ok, corner_ok, topright_ok, n)
            need_top = mode in (0, 3, 4, 5, 6, 7)
            need_left = mode in (1, 4, 5, 6, 8)
            if (need_top and top is None) or (need_left and left is None) or \
                    (mode in (4, 5, 6) and corner is None):
                raise ValueError(f"Intra {n}x{n} mode {mode} without its neighbours")
            if t8:
                top, left, corner = filter_8x8_refs(top, left, corner)
            self.coverage[f"intra {n}x{n}", mode] += 1
            pred = np.asarray(intra_nxn(n, mode, top, left, corner), np.int32)
            levels = coeffs["luma"][(by >> 2) * 4 + (bx >> 2)]
            if levels is not None:
                res = self.residual8(levels, ls8, qp) if t8 else self.residual4(levels, ls4, qp)
                pred = pred + np.asarray(res, np.int32).reshape(n, n)
            plane[y0 + by:y0 + by + n, x0 + bx:x0 + bx + n] = np.clip(pred, 0, 255)

    @staticmethod
    def _decoded_before(tx, ty, bx, by, n):
        """Whether the n x n block holding (tx, ty) of this macroblock comes
        before the block at (bx, by) in decoding order."""
        if n == 8:
            return (ty >> 3) * 2 + (tx >> 3) < (by >> 3) * 2 + (bx >> 3)
        return BLK_ORDER[(ty >> 2) * 4 + (tx >> 2)] < BLK_ORDER[(by >> 2) * 4 + (bx >> 2)]

    def inter_pred(self, addr):
        """Motion-compensated prediction of the macroblock: its 4x4 blocks
        of equal references and vectors merged into 16x16 or 8x8 blocks
        (the samples do not depend on the block's size), each predicted
        from one list or both, weighted as the slice says."""
        s = self.s
        x0, y0 = 16 * (addr % self.mb_w), 16 * (addr // self.mb_w)
        base = 16 * addr
        keys = [(s["ref"][k], s["ref1"][k], s["mv"][2 * k], s["mv"][2 * k + 1], s["mv1"][2 * k],
                 s["mv1"][2 * k + 1]) for k in range(base, base + 16)]
        if keys.count(keys[0]) == 16:
            blocks = [(0, 0, 16, 16)]
        else:
            blocks = []
            for b8 in range(4):
                rs = BLK_RASTER[4 * b8:4 * b8 + 4]
                if all(keys[r] == keys[rs[0]] for r in rs):
                    blocks.append((8 * (b8 & 1), 8 * (b8 >> 1), 8, 8))
                else:
                    blocks += [(4 * (r & 3), 4 * (r >> 2), 4, 4) for r in rs]
        pic = self.pic
        for bx, by, w, h in blocks:
            key = keys[(by >> 2) * 4 + (bx >> 2)]
            preds = []
            for lst in range(2):
                ref, mvx, mvy = key[lst], key[2 + 2 * lst], key[3 + 2 * lst]
                if ref < 0:
                    continue
                refs = self.lists.refs[lst]
                if ref >= len(refs):
                    raise ValueError(f"a reference index {ref} past the list of {len(refs)}")
                rp = refs[ref]
                cx, cy = (x0 + bx) >> 1, (y0 + by) >> 1
                preds.append((lst, ref, luma_mc(rp.y, x0 + bx, y0 + by, w, h, mvx, mvy),
                              chroma_mc(rp.u, cx, cy, w >> 1, h >> 1, mvx, mvy),
                              chroma_mc(rp.v, cx, cy, w >> 1, h >> 1, mvx, mvy)))
            if not preds:
                raise ValueError("an inter block predicted from no list")
            py, pu, pv = self.weighted(preds)
            pic.y[y0 + by:y0 + by + h, x0 + bx:x0 + bx + w] = py
            cy, cx = (y0 + by) >> 1, (x0 + bx) >> 1
            pic.u[cy:cy + (h >> 1), cx:cx + (w >> 1)] = pu
            pic.v[cy:cy + (h >> 1), cx:cx + (w >> 1)] = pv

    def weighted(self, preds):
        """The (Y, U, V) prediction of one block from its ``preds`` (list,
        reference index, Y, U, V) of one list or both (8.4.2.3): the
        default average, explicit or implicit weights."""
        mode = self.prm[PR_WEIGHT_MODE]
        ld, cd = self.prm[PR_LUMA_DENOM], self.prm[PR_CHROMA_DENOM]
        if len(preds) == 1:
            lst, ref, py, pu, pv = preds[0]
            if mode != WEIGHT_EXPLICIT:
                return py, pu, pv
            wt = self.lists.weights[lst][ref]
            return weight(py, wt[0], wt[1], ld), weight(pu, wt[2], wt[3], cd), \
                weight(pv, wt[4], wt[5], cd)
        (_, r0, *p0), (_, r1, *p1) = preds
        if mode == WEIGHT_NONE:
            return [(a + b + 1) >> 1 for a, b in zip(p0, p1)]
        if mode == WEIGHT_IMPLICIT:
            w0 = self.lists.implicit[r0][r1]
            return [bi_weight(a, b, w0, 64 - w0, 0, 0, 5) for a, b in zip(p0, p1)]
        w0, w1 = self.lists.weights[0][r0], self.lists.weights[1][r1]
        return [bi_weight(a, b, w0[2 * c], w1[2 * c], w0[2 * c + 1], w1[2 * c + 1],
                          ld if c == 0 else cd) for c, (a, b) in enumerate(zip(p0, p1))]

    def chroma(self, addr, kind, coeffs):
        s = self.s
        x0, y0 = 8 * (addr % self.mb_w), 8 * (addr // self.mb_w)
        intra = kind <= PCM
        for comp, plane in enumerate((self.pic.u, self.pic.v)):
            if intra:
                na, nb, nd = self.mb_a(addr), self.mb_b(addr), self.mb_d(addr)
                ok_a, ok_b, ok_d = self.intra_avail(na), self.intra_avail(nb), \
                    self.intra_avail(nd)
                mode = s["cmode"][addr]
                top, left, corner = self.neighbour_samples(plane, x0, y0, 8, ok_b, ok_a, ok_d,
                                                           False, 0)
                if (mode == 1 and not ok_a) or (mode == 2 and not ok_b) or \
                        (mode == 3 and not (ok_a and ok_b and ok_d)):
                    raise ValueError(f"chroma mode {mode} without its neighbours")
                pred = np.asarray(intra_chroma(mode, top, left, corner), np.int32)
            else:
                pred = plane[y0:y0 + 8, x0:x0 + 8].astype(np.int32)
            if coeffs["cdc"][comp] is not None:
                qpc = chroma_qp(self.qp, self.prm[PR_CB_OFF + comp])
                ls = self.ls4[(1 if intra else 4) + comp][qpc % 6]
                dcs = chroma_dc(coeffs["cdc"][comp], ls[0], qpc)
                res = np.zeros((8, 8), np.int32)
                for r in range(4):
                    levels = coeffs["cac"][comp][r] or [0] * 16
                    bx, by = 4 * (r & 1), 4 * (r >> 1)
                    res[by:by + 4, bx:bx + 4] = np.asarray(
                        self.residual4(levels, ls, qpc, dcs[r]), np.int32).reshape(4, 4)
                pred = pred + res
            plane[y0:y0 + 8, x0:x0 + 8] = np.clip(pred, 0, 255)


def _nc(n):
    a, b = n
    if a is not None and b is not None:
        return (a + b + 1) >> 1
    return a if a is not None else b if b is not None else 0


def _clip8(v):
    return min(max(v, -128), 127)


def chroma_qp(qp, offset):
    return T.CHROMA_QP[min(max(qp + offset, 0), 51)]


def decode_slice_py(rbsp, bitpos, prm, pic, lists, level_scale, coverage=None):
    """Decode one slice's macroblocks into ``pic`` (planes and state) by
    the plain version; the number of the macroblock after its last."""
    return SliceDecoder(rbsp, bitpos, prm, pic, lists, level_scale, coverage).decode()


# -- deblocking (8.7) ----------------------------------------------------------------

def _filter_edge(plane, idx_p, idx_q, bs, qp_av, off_a, off_b, chroma):
    """Filter one edge's samples: ``idx_p[k]`` the (row, col) of p0..p3 and
    ``idx_q`` of q0..q3 for each sample line, ``bs`` per line."""
    index_a = min(max(qp_av + off_a, 0), 51)
    index_b = min(max(qp_av + off_b, 0), 51)
    alpha, beta = T.ALPHA[index_a], T.BETA[index_b]
    if alpha == 0 or beta == 0:
        return
    for line, b in enumerate(bs):
        if b == 0:
            continue
        P = [int(plane[r, c]) for r, c in idx_p[line]]
        Q = [int(plane[r, c]) for r, c in idx_q[line]]
        p0, p1, q0, q1 = P[0], P[1], Q[0], Q[1]
        if not (abs(p0 - q0) < alpha and abs(p1 - p0) < beta and abs(q1 - q0) < beta):
            continue
        if chroma:
            if b < 4:
                tc = T.TC0[index_a][b - 1] + 1
                d = min(max((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc), tc)
                newp, newq = [_clip(p0 + d)], [_clip(q0 - d)]
            else:
                newp = [(2 * p1 + p0 + q1 + 2) >> 2]
                newq = [(2 * q1 + q0 + p1 + 2) >> 2]
        else:
            p2, q2 = P[2], Q[2]
            ap, aq = abs(p2 - p0), abs(q2 - q0)
            if b < 4:
                tc0 = T.TC0[index_a][b - 1]
                tc = tc0 + (ap < beta) + (aq < beta)
                d = min(max((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc), tc)
                newp, newq = [_clip(p0 + d)], [_clip(q0 - d)]
                if ap < beta:
                    newp.append(p1 + min(max((p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1, -tc0),
                                         tc0))
                if aq < beta:
                    newq.append(q1 + min(max((q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1, -tc0),
                                         tc0))
            else:
                p3, q3 = P[3], Q[3]
                small = abs(p0 - q0) < ((alpha >> 2) + 2)
                if ap < beta and small:
                    newp = [(p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                            (p2 + p1 + p0 + q0 + 2) >> 2,
                            (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3]
                else:
                    newp = [(2 * p1 + p0 + q1 + 2) >> 2]
                if aq < beta and small:
                    newq = [(p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                            (p0 + q0 + q1 + q2 + 2) >> 2,
                            (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3]
                else:
                    newq = [(2 * q1 + q0 + p1 + 2) >> 2]
        for k, v in enumerate(newp):
            r, c = idx_p[line][k]
            plane[r, c] = v
        for k, v in enumerate(newq):
            r, c = idx_q[line][k]
            plane[r, c] = v


def _far(mv, kq, mv2, kp):
    """Whether two blocks' vectors differ by 4 quarter samples or more."""
    return abs(mv[2 * kq] - mv2[2 * kp]) >= 4 or abs(mv[2 * kq + 1] - mv2[2 * kp + 1]) >= 4


def edge_bs(st, mb_w, addr, n, vertical, edge, mb_edge):
    """bS of the four 4-sample segments of a luma edge (8.7.2.1): macroblock
    ``addr`` (q) and ``n`` (p, the same for inner edges).  The motion
    test of a q in a B slice compares both lists' pictures and vectors, in
    both pairings; of a q in a P slice, list 0's alone (FFmpeg's
    ``check_mv`` over the q slice's lists)."""
    kind, t8, nz, refpic, mv = st["kind"], st["t8"], st["nz"], st["refpic"], st["mv"]
    refpic1, mv1 = st["refpic1"], st["mv1"]
    out = []
    for seg in range(4):
        if vertical:
            qi = seg * 4 + edge
            pi = seg * 4 + (edge - 1 if edge else 3)
        else:
            qi = edge * 4 + seg
            pi = (edge - 1 if edge else 3) * 4 + seg
        if kind[addr] <= PCM or kind[n] <= PCM:
            out.append(4 if mb_edge else 3)
            continue

        def coded(m, i):
            if t8[m]:
                b8 = ((i >> 3) << 1) | ((i & 3) >> 1)
                return any(nz[16 * m + r] for r in (BLK_RASTER[4 * b8 + k] for k in range(4)))
            return nz[16 * m + i] > 0

        if coded(addr, qi) or coded(n, pi):
            out.append(2)
            continue
        kq, kp = 16 * addr + qi, 16 * n + pi
        v = refpic[kq] != refpic[kp] or _far(mv, kq, mv, kp)
        if st["lists"][addr] == 2:
            v = v or refpic1[kq] != refpic1[kp] or _far(mv1, kq, mv1, kp)
            if v and refpic[kq] == refpic1[kp] and refpic1[kq] == refpic[kp]:
                v = _far(mv, kq, mv1, kp) or _far(mv1, kq, mv, kp)
        out.append(int(v))
    return out


def deblock_py(pic, mb_w, mb_h, cb_off, cr_off, coverage=None):
    """The deblocking filter over the whole picture (plain version);
    ``coverage`` counts the bS values met."""
    st = {k: v.tolist() for k, v in pic.state.items()}
    for addr in range(mb_w * mb_h):
        idc, off_a, off_b = st["dbk"][3 * addr:3 * addr + 3]
        if idc == 1 or st["kind"][addr] < 0:
            continue
        mx, my = addr % mb_w, addr // mb_w
        qp = st["qp"]
        for vertical in (True, False):
            if vertical:
                n = addr - 1 if mx > 0 else -1
            else:
                n = addr - mb_w if my > 0 else -1
            if n >= 0 and idc == 2 and st["slice"][n] != st["slice"][addr]:
                n = -1
            for edge in range(4):
                if edge == 0 and n < 0:
                    continue
                if edge in (1, 3) and st["t8"][addr]:
                    continue
                p = n if edge == 0 else addr
                bs = edge_bs(st, mb_w, addr, p, vertical, edge, edge == 0)
                if coverage is not None:
                    for b in bs:
                        coverage["bS", b] += 1
                if not any(bs):
                    continue
                # luma
                qp_av = (qp[p] + qp[addr] + 1) >> 1
                lines_p, lines_q, lbs = [], [], []
                for k in range(16):
                    if vertical:
                        r, c = 16 * my + k, 16 * mx + 4 * edge
                        lines_p.append([(r, c - 1 - i) for i in range(4)])
                        lines_q.append([(r, c + i) for i in range(4)])
                    else:
                        r, c = 16 * my + 4 * edge, 16 * mx + k
                        lines_p.append([(r - 1 - i, c) for i in range(4)])
                        lines_q.append([(r + i, c) for i in range(4)])
                    lbs.append(bs[k >> 2])
                _filter_edge(pic.y, lines_p, lines_q, lbs, qp_av, off_a, off_b, False)
                if edge in (1, 3):
                    continue
                for comp, (plane, off) in enumerate(((pic.u, cb_off), (pic.v, cr_off))):
                    qpc = (chroma_qp(qp[p], off) + chroma_qp(qp[addr], off) + 1) >> 1
                    cp, cq, cbs = [], [], []
                    ce = 2 * edge
                    for k in range(8):
                        if vertical:
                            r, c = 8 * my + k, 8 * mx + ce
                            cp.append([(r, c - 1 - i) for i in range(2)])
                            cq.append([(r, c + i) for i in range(2)])
                        else:
                            r, c = 8 * my + ce, 8 * mx + k
                            cp.append([(r - 1 - i, c) for i in range(2)])
                            cq.append([(r + i, c) for i in range(2)])
                        cbs.append(bs[k >> 1])
                    _filter_edge(plane, cp, cq, cbs, qpc, off_a, off_b, True)


# -- the C++ loops ------------------------------------------------------------------

def _ptr(a):
    return a.ctypes.data


def _native_state(pic):
    return np.concatenate([pic.state[name] for name, _, _ in STATE])


def decode_slice_native(rbsp, bitpos, prm, pic, lists, level_scale):
    """``decode_slice_py`` in C++ (``omh_decode_slice``): the same planes,
    state and end."""
    from .. import kernels

    lib = kernels.host_library("h264_host")
    prm = np.ascontiguousarray(prm, np.int32)
    buf = np.frombuffer(bytes(rbsp) + bytes(16), np.uint8)
    refs = lists.refs[0] + lists.refs[1]
    counts = np.array([len(lists.refs[0]), len(lists.refs[1])], np.int32)
    ref_ptrs = np.array([_ptr(p) for r in refs for p in (r.y, r.u, r.v)] or [0], np.uint64)
    ref_ids = np.array([r.id for r in refs] or [0], np.int32)
    wt = np.zeros((max(len(refs), 1), 6), np.int32)
    for lst, table in enumerate(lists.weights):
        if table is not None:
            at = 0 if lst == 0 else len(lists.refs[0])
            wt[at:at + len(table)] = table
    implicit = np.ascontiguousarray(lists.implicit if lists.implicit is not None else [0],
                                    np.int32)
    dist = np.ascontiguousarray(lists.dist_scale if lists.dist_scale else [0], np.int32)
    col = np.concatenate([lists.col[k] for k in ("kind", "ref", "ref1", "mv", "mv1", "map",
                                                 "map1")]).astype(np.int32) \
        if lists.col is not None else np.zeros(1, np.int32)
    ls4 = np.ascontiguousarray(level_scale[0], np.int32)
    ls8 = np.ascontiguousarray(level_scale[1], np.int32)
    state = _native_state(pic)
    end = lib.omh_decode_slice(buf.ctypes.data, len(rbsp), bitpos, prm.ctypes.data,
                               _native_tables().ctypes.data, ls4.ctypes.data, ls8.ctypes.data,
                               ref_ptrs.ctypes.data, ref_ids.ctypes.data, counts.ctypes.data,
                               wt.ctypes.data, implicit.ctypes.data, dist.ctypes.data,
                               col.ctypes.data, _ptr(pic.y), _ptr(pic.u), _ptr(pic.v),
                               state.ctypes.data)
    _unpack_state(pic, state)
    if end < 0:
        raise ValueError(f"a corrupt slice: {lib.omh_error_string(end).decode()}")
    return end


def _unpack_state(pic, state):
    pos = 0
    for name, _, _ in STATE:
        arr = pic.state[name]
        arr[:] = state[pos:pos + arr.size]
        pos += arr.size


_TABLES = None


def _native_tables():
    global _TABLES
    if _TABLES is None:
        _TABLES = T.native_tables()
    return _TABLES


def deblock_native(pic, mb_w, mb_h, cb_off, cr_off):
    """``deblock_py`` in C++ (``omh_deblock``)."""
    from .. import kernels

    lib = kernels.host_library("h264_host")
    state = _native_state(pic)
    lib.omh_deblock(_ptr(pic.y), _ptr(pic.u), _ptr(pic.v), mb_w, mb_h, cb_off, cr_off,
                    state.ctypes.data, _native_tables().ctypes.data)


# -- the picture buffer and output ----------------------------------------------------

# (level_idc, MaxDpbMbs) as FFmpeg derives a reorder depth without VUI
LEVEL_MAX_DPB_MBS = ((10, 396), (11, 900), (12, 2376), (13, 2376), (20, 2376), (21, 4752),
                     (22, 8100), (30, 8100), (31, 18000), (32, 20480), (40, 32768),
                     (41, 32768), (42, 34816), (50, 110400), (51, 184320), (52, 184320))


def num_reorder_frames(sps):
    """The SPS's reorder depth as FFmpeg holds it: the VUI's, or without
    ``bitstream_restriction`` one derived from the level."""
    if sps.bitstream_restriction or not sps.max_num_ref_frames:
        return sps.num_reorder_frames
    for level, mbs in LEVEL_MAX_DPB_MBS:
        if level == sps.level_idc:
            return min(mbs // (sps.mb_w * sps.mb_h), MAX_DPB - 1)
    return MAX_DPB - 1


def probe_delay(packets, extradata=b"", codec_tag=b"", native=True, annexb=False, mp4=None):
    """The output delay libavformat's ``avformat_find_stream_info`` leaves
    in the stream's ``video_delay``, which cv2 hands its decoder: the delay
    of a decoder run over the first packets, as far as the probe reads.
    In AVI: until FFmpeg takes the delay for guessed
    (``has_decode_delay_been_guessed``: a delay equal to the SPS's reorder
    depth, or 7, 18 or 20 frames shown for a delay below 3, 3 or more), or
    to the end of ``packets``.  In MP4, ``mp4`` is (the delay the mov
    demuxer guesses from the composition offsets, ``mp4.Track.delay``;
    whether the first packets' offsets show a delay, FFmpeg's
    ``frame_delay_evidence``): the decoder starts at that delay, and the
    probe, the rate known from the container, stops once the codec's
    parameters are (the first packet), or, with that evidence and no delay
    yet, after three packets or the first that leaves one."""
    dec = Decoder(extradata, native=native, codec_tag=codec_tag, annexb=annexb,
                  delay=mp4[0] if mp4 else 0)
    shown = 0
    for k, packet in enumerate(packets):
        delay = dec.has_b_frames
        if mp4 and k and (not mp4[1] or delay or k >= 3):
            break
        sps = next(iter(dec.sps.values()), None) if dec.cur_header is None else \
            dec.cur_header.sps
        if delay and sps is not None and num_reorder_frames(sps) == delay:
            break
        if shown >= (7 if delay < 3 else 18 if delay < 4 else 20):
            break
        try:
            shown += len(dec.decode(packet))
        except (ValueError, EOFError):
            break
    return dec.has_b_frames


MAX_DPB = 16
INT_MIN = -(1 << 31)


class Decoder:
    """Decodes one stream's packets, in order, to (Y, U, V) planes of the
    cropped size in the order cv2 hands them out; ``extradata`` is the
    container's decoder configuration (``avcC``, or Annex B parameter
    sets), ``codec_tag`` the container's fourcc; ``annexb`` says the packets
    come behind start codes whatever the configuration (``AnnexB``'s
    output).  ``native`` selects the C++
    slice and deblocking loops (the default) or the plain versions.
    ``colour`` is the last frame's (colour matrix, full range), as cv2's
    conversion reads them (``yuv.coefficients``)."""

    def __init__(self, extradata=b"", native=True, codec_tag=b"", delay=0, annexb=False):
        self.native = native
        self.coverage = collections.Counter()  # the paths taken (the plain loops count more)
        self.codec_tag = bytes(codec_tag)
        self.length_size = 0  # 0: Annex B
        self.sps, self.pps = {}, {}
        self.cur = None  # the picture being decoded
        self.cur_header = None
        self.slice_num = 0
        self.dpb = []  # reference pictures
        self.delayed = []
        self.has_b_frames = delay
        self.last_pocs = [INT_MIN] * MAX_DPB
        self.next_outputed_poc = INT_MIN
        self.mmco_reset = False
        self.prev_frame_num = -1
        self.prev_frame_num_offset = 0
        self.prev_poc_msb, self.prev_poc_lsb = 1 << 16, -1
        self.prev_ref_frame_num = 0
        self.frame_nums = {}  # each reference picture's frame_num, by pid
        self.max_long_idx = -1  # "no long-term frame indices"
        self.recovery_frame = -1
        self.recovery_frame_cnt = None  # of the last recovery point SEI
        self.frame_recovered = False
        self.colour = (2, False)
        self.pictures = 0
        self.packets = 0  # packets decoded
        self.out = []  # the frames shown, and the index of each one's packet
        self.out_packets = []
        self.shown_packets = []  # of the frames the last decode or flush returned
        if extradata:
            extradata = bytes(extradata)
            if extradata[0] == 1:
                length_size, nals = parse_avcc(extradata)
                self.length_size = 0 if annexb else length_size
            else:
                nals = split_annexb(extradata)
            for nal in nals:
                self._nal(nal)

    # -- packets and NAL units ----------------------------------------------------
    def decode(self, packet):
        """The frames shown after ``packet`` (one access unit)."""
        packet = bytes(packet)
        if self.length_size:
            nals = split_lengths(packet, self.length_size)
        else:
            nals = split_annexb(packet)
        try:
            for nal in nals:
                self._nal(nal)
            if not self.sps:
                tag = self.codec_tag.decode("latin-1") or "H.264"
                raise UnsupportedH264(f"an {tag!r} stream without a sequence parameter set")
            self._finish_picture()
        except (ValueError, EOFError):
            self.cur = None  # a picture cut or damaged inside is not shown
            raise
        finally:
            self.packets += 1
        return self._take()

    def _take(self):
        out, self.shown_packets = self.out, self.out_packets
        self.out, self.out_packets = [], []
        return out

    def flush(self):
        """The frames still held for reordering, in FFmpeg's order."""
        self._finish_picture()
        while self.delayed:
            pick = 0
            for i in range(1, len(self.delayed)):
                p = self.delayed[i]
                if p.key or p.mmco_reset:
                    break
                if p.poc < self.delayed[pick].poc:
                    pick = i
            pic = self.delayed.pop(pick)
            self.frame_recovered |= pic.recovered
            if pic.recovered:
                self._show(pic)
        return self._take()

    def _nal(self, nal):
        if len(nal) < 1 or nal[0] & 0x80:
            return  # forbidden_zero_bit set: FFmpeg drops the unit
        ref_idc, kind = (nal[0] >> 5) & 3, nal[0] & 0x1F
        if kind == 7:
            sps = Sps(unescape(nal[1:]))
            self.coverage["profile", sps.profile_idc] += 1
            self.sps[sps.id] = sps
        elif kind == 8:
            pps = Pps(unescape(nal[1:]), self.sps)
            self.pps[pps.id] = pps
        elif kind in (1, 5):
            self._slice(unescape(nal[1:]), kind, ref_idc)
        elif kind in (2, 3, 4):
            raise UnsupportedH264("data partitioning (NAL units 2-4)")
        elif kind == 6:
            self._sei(unescape(nal[1:]))
        elif kind == 11:
            self._finish_picture()
        # 9 AUD, 10 end of sequence, 12 filler, 13 SPS extension, 14/20 SVC
        # and MVC (the base layer is decoded), 15 subset SPS, 19 auxiliary

    def _sei(self, rbsp):
        pos = 0
        while pos + 2 <= len(rbsp) and rbsp[pos] != 0x80:
            kind = 0
            while rbsp[pos] == 0xFF:
                kind += 255
                pos += 1
            kind += rbsp[pos]
            pos += 1
            size = 0
            while pos < len(rbsp) and rbsp[pos] == 0xFF:
                size += 255
                pos += 1
            if pos >= len(rbsp):
                return
            size += rbsp[pos]
            pos += 1
            if kind == 6:  # recovery point
                try:
                    self.recovery_frame_cnt = Bits(rbsp[pos:pos + size]).ue()
                except (EOFError, ValueError):
                    pass  # FFmpeg ignores a recovery point it cannot read
            pos += size

    # -- a picture's slices -------------------------------------------------------
    def _slice(self, rbsp, kind, ref_idc):
        h = SliceHeader(rbsp, kind, ref_idc, self.sps, self.pps)
        coder = "cabac" if h.pps.cabac else "cavlc"
        self.coverage["slice", "IPB"[(I_SLICE, P_SLICE, B_SLICE).index(h.type)], coder] += 1
        if h.first_mb == 0 or self.cur is None:
            self._finish_picture()
            self._start_picture(h)
        elif h.frame_num != self.cur_header.frame_num or h.pps_id != self.cur_header.pps_id:
            raise ValueError("a slice of another picture without first_mb_in_slice 0")
        sps, pps = h.sps, h.pps
        prm = np.zeros(PR_LEN, np.int32)
        prm[PR_MB_W], prm[PR_MB_H] = sps.mb_w, sps.mb_h
        prm[PR_FIRST_MB], prm[PR_TYPE] = h.first_mb, h.type
        prm[PR_CABAC], prm[PR_INIT_IDC], prm[PR_QP] = pps.cabac, h.cabac_init_idc, h.qp
        prm[PR_NUM_REF] = h.num_ref
        prm[PR_T8_MODE], prm[PR_CONSTRAINED] = pps.transform_8x8, pps.constrained_intra
        prm[PR_CB_OFF], prm[PR_CR_OFF] = pps.cb_qp_offset, pps.cr_qp_offset
        self.slice_num += 1
        prm[PR_SLICE_NUM] = self.slice_num
        prm[PR_DBK_IDC], prm[PR_DBK_A], prm[PR_DBK_B] = h.deblock_idc, h.alpha_off, h.beta_off
        if h.weights is not None:
            prm[PR_LUMA_DENOM], prm[PR_CHROMA_DENOM] = h.weights[0], h.weights[1]
            prm[PR_WEIGHT_MODE] = WEIGHT_EXPLICIT
        if h.type == P_SLICE:
            lists = Lists(self._ref_lists(h)[0], weights=(h.weights and h.weights[2], None))
            if h.weights is not None:
                self.coverage["weighted P"] += 1
        elif h.type == B_SLICE:
            lists = self._b_lists(h, prm)
            self.coverage["weighted_bipred_idc", pps.weighted_bipred, coder] += 1
        else:
            lists = Lists(())
        self.coverage["deblocking idc", h.deblock_idc] += 1
        if pps.cabac and h.type == P_SLICE:
            self.coverage["cabac_init_idc", h.cabac_init_idc] += 1
        if pps.cabac and h.type == B_SLICE:
            self.coverage["cabac_init_idc", "B", h.cabac_init_idc, pps.transform_8x8] += 1
        if self.slice_num > 1:
            self.coverage["several slices a picture"] += 1
        if self.slice_num > 1 and self.cur_header.type != h.type:
            self.coverage["slice types mixed in a picture"] += 1
        self.slice_data(rbsp, h, prm, lists)

    def _b_lists(self, h, prm):
        """A B slice's ``Lists``: both reference lists, its weights (the
        explicit table, or the implicit weights from the POC distances,
        8.4.2.3.1), DistScaleFactor (8.4.1.2.3), and the co-located
        picture (RefPicList1[0]) with its blocks' references mapped to the
        lowest L0 index of the same picture (FFmpeg's ``map_col_to_list0``,
        by frame_num; 0 where none is)."""
        refs0, refs1 = self._ref_lists(h)
        prm[PR_NUM_REF1] = h.num_ref1
        prm[PR_WEIGHT_MODE] = h.pps.weighted_bipred
        prm[PR_DIRECT_SPATIAL] = h.direct_spatial
        prm[PR_DIRECT_8X8] = h.sps.direct_8x8_inference
        col = refs1[0]
        prm[PR_COL_SHORT] = col.ref == "short"
        cur = self.cur.poc

        def tb_tx(p0, td):
            """tb * tx (C's division, toward zero)."""
            return _clip8(cur - p0.poc) * ((16384 + (abs(td) >> 1)) // abs(td)) * \
                (1 if td > 0 else -1)

        dist = []  # a long-term L0 picture or a td of 0: the vector unscaled
        for p0 in refs0:
            td = _clip8(col.poc - p0.poc)
            dist.append(256 if td == 0 or p0.ref == "long" else
                        min(max((tb_tx(p0, td) + 32) >> 6, -1024), 1023))
        implicit = None
        if h.pps.weighted_bipred == 2:
            implicit = [[32] * len(refs1) for _ in refs0]
            for i, p0 in enumerate(refs0):
                for j, p1 in enumerate(refs1):
                    td = _clip8(p1.poc - p0.poc)
                    if td and p0.ref != "long" and p1.ref != "long":
                        w1 = (tb_tx(p0, td) + 32) >> 8  # DistScaleFactor >> 2
                        if -64 <= w1 <= 128:
                            implicit[i][j] = 64 - w1
        st = col.state
        arrays = {k: st[k] for k in ("kind", "ref", "ref1", "mv", "mv1")}
        if h.direct_spatial:
            arrays["map"] = arrays["map1"] = np.zeros_like(st["ref"])
        else:
            pids = np.concatenate([st["refpic"], st["refpic1"]])
            table = np.zeros(max(int(pids.max()), 0) + 1, np.int32)
            nums = [p.frame_num for p in refs0]
            for pid in np.unique(pids[pids >= 0]).tolist():
                fn = self.frame_nums.get(pid)
                table[pid] = nums.index(fn) if fn in nums else 0
            arrays["map"] = table[np.maximum(st["refpic"], 0)]
            arrays["map1"] = table[np.maximum(st["refpic1"], 0)]
        weights = (None, None) if h.weights is None else (h.weights[2], h.weights[3])
        return Lists(refs0, refs1, weights, implicit, dist, arrays)

    def slice_data(self, rbsp, h, prm, lists):
        """Decode the slice's macroblocks into the current picture (the
        fixture writer codes them here instead)."""
        level_scale = (h.pps.level_scale4, h.pps.level_scale8)
        if self.native:
            decode_slice_native(rbsp, h.bitpos, prm, self.cur, lists, level_scale)
        else:
            decode_slice_py(rbsp, h.bitpos, prm, self.cur, lists, level_scale, self.coverage)

    def _start_picture(self, h):
        sps = h.sps
        self.cur_header = h
        self.slice_num = 0
        max_frame_num = 1 << sps.log2_max_frame_num
        if h.idr:
            self.dpb = []
            self.prev_frame_num = self.prev_frame_num_offset = 0
            self.prev_poc_msb, self.prev_poc_lsb = 1 << 16, -1
            self.last_pocs = [INT_MIN] * MAX_DPB
            self.max_long_idx = 0 if h.long_term_reference else -1
        elif self.prev_frame_num >= 0 and h.frame_num != self.prev_ref_frame_num and \
                h.frame_num != (self.prev_ref_frame_num + 1) % max_frame_num:
            raise UnsupportedH264(f"a gap in frame_num ({self.prev_ref_frame_num} to "
                                  f"{h.frame_num})")
        self.pictures += 1
        pic = Picture(sps.mb_w, sps.mb_h, self.pictures)
        pic.packet = self.packets
        pic.b_first = h.type == B_SLICE
        pic.frame_num = h.frame_num
        pic.crop = sps.crop
        pic.full_range = sps.full_range
        pic.colourspace = sps.colour[2] if sps.colour else 2
        pic.key = h.idr or self.recovery_frame_cnt is not None
        pic.poc = self._poc(h)
        self.coverage["poc type", sps.poc_type] += 1
        # the recovery point (FFmpeg's recovery_frame)
        if self.recovery_frame_cnt is not None:
            self.recovery_frame = (h.frame_num + self.recovery_frame_cnt) % max_frame_num
            self.recovery_frame_cnt = None
        if h.idr or (self.recovery_frame == h.frame_num and h.nal_ref_idc):
            self.recovery_frame = -1
            pic.recovered = True
        if h.idr or (h.type == I_SLICE and not self.frame_recovered):
            # libavcodec shows a stream that starts at a non-IDR I picture
            # from that picture, recovery point SEI or none
            self.frame_recovered = True
        pic.recovered |= self.frame_recovered
        self.cur = pic

    def _poc(self, h):
        sps = h.sps
        max_frame_num = 1 << sps.log2_max_frame_num
        offset = self.prev_frame_num_offset
        if h.frame_num < self.prev_frame_num:
            offset += max_frame_num
        self.frame_num_offset = offset
        if sps.poc_type == 0:
            max_lsb = 1 << sps.log2_max_poc_lsb
            prev_lsb = self.prev_poc_lsb if self.prev_poc_lsb >= 0 else h.poc_lsb
            if h.poc_lsb < prev_lsb and prev_lsb - h.poc_lsb >= max_lsb // 2:
                msb = self.prev_poc_msb + max_lsb
            elif h.poc_lsb > prev_lsb and prev_lsb - h.poc_lsb < -max_lsb // 2:
                msb = self.prev_poc_msb - max_lsb
            else:
                msb = self.prev_poc_msb
            self.poc_msb, self.poc_lsb = msb, h.poc_lsb
            top = msb + h.poc_lsb
            return min(top, top + h.delta_poc_bottom)
        if sps.poc_type == 1:
            cycle = len(sps.offset_for_ref_frame)
            absn = offset + h.frame_num if cycle else 0
            if h.nal_ref_idc == 0 and absn > 0:
                absn -= 1
            expected = 0
            if absn > 0:
                cycles, within = divmod(absn - 1, cycle)
                expected = cycles * sum(sps.offset_for_ref_frame)
                expected += sum(sps.offset_for_ref_frame[:within + 1])
            if h.nal_ref_idc == 0:
                expected += sps.offset_for_non_ref_pic
            top = expected + h.delta_poc[0]
            bottom = top + sps.offset_for_top_to_bottom + h.delta_poc[1]
            return min(top, bottom)
        poc = 2 * (offset + h.frame_num)
        if not h.nal_ref_idc:
            poc -= 1
        return poc

    # -- reference lists --------------------------------------------------------
    def _pic_num(self, p, h):
        max_frame_num = 1 << h.sps.log2_max_frame_num
        return p.frame_num - max_frame_num if p.frame_num > h.frame_num else p.frame_num

    def _ref_lists(self, h):
        """The slice's (RefPicList0, RefPicList1) (8.2.4; L1 empty outside B
        slices): P's L0 by descending PicNum, B's L0 by POC before the
        current picture (descending) then after it (ascending), L1 the
        other way round, swapping L1's first two entries where it equals L0
        and holds more than one; long-term pictures last; then each list's
        modifications, cut to its active count."""
        shorts = [p for p in self.dpb if p.ref == "short"]
        longs = sorted((p for p in self.dpb if p.ref == "long"), key=lambda p: p.long_idx)
        if h.type != B_SLICE:
            init = sorted(shorts, key=lambda p: -self._pic_num(p, h)) + longs
            return self._modified(h, init, h.modifications, h.num_ref), []
        cur = self.cur.poc
        before = sorted((p for p in shorts if p.poc <= cur), key=lambda p: -p.poc)
        after = sorted((p for p in shorts if p.poc > cur), key=lambda p: p.poc)
        init0, init1 = before + after + longs, after + before + longs
        if len(init1) > 1 and all(a is b for a, b in zip(init0, init1)):
            init1[0], init1[1] = init1[1], init1[0]
            self.coverage["L1 swapped"] += 1
        if h.num_ref1 > 1:
            self.coverage["more than one L1 reference"] += 1
        for lst, init in enumerate((init0, init1)):
            if longs and len(init) > len(shorts) and len(shorts) < (h.num_ref, h.num_ref1)[lst]:
                self.coverage["long-term reference in list", lst] += 1
        return (self._modified(h, init0, h.modifications, h.num_ref),
                self._modified(h, init1, h.modifications1, h.num_ref1, 1))

    def _modified(self, h, refs, modifications, num_ref, lst=0):
        """One list after ``modifications`` (8.2.4.3), cut to ``num_ref``;
        FFmpeg's "Missing reference picture" fill where it comes short."""
        if modifications:
            self.coverage["ref list modification"] += 1
            if lst:
                self.coverage["modification", "L1"] += 1
            max_pic_num = 1 << h.sps.log2_max_frame_num
            curr = h.frame_num
            pred = curr
            lst_ = refs[:num_ref] + [None] * max(0, num_ref - len(refs))
            for k, (idc, val) in enumerate(modifications):
                if k >= num_ref:
                    raise ValueError("more reference list modifications than references")
                if idc in (0, 1):
                    self.coverage["modification", "short"] += 1
                    diff = val + 1
                    if idc == 0:
                        nowrap = pred - diff + (max_pic_num if pred - diff < 0 else 0)
                    else:
                        nowrap = pred + diff - (max_pic_num if pred + diff >= max_pic_num else 0)
                    pred = nowrap
                    num = nowrap - max_pic_num if nowrap > curr else nowrap
                    found = [p for p in self.dpb if p.ref == "short" and
                             self._pic_num(p, h) == num]
                else:
                    self.coverage["modification", "long"] += 1
                    found = [p for p in self.dpb if p.ref == "long" and p.long_idx == val]
                if not found:
                    raise ValueError("a reference list modification names no reference")
                pic = found[0]
                lst_ = lst_[:k] + [pic] + [p for p in lst_[k:] if p is not pic]
                lst_ = lst_[:num_ref]
            refs = lst_
        refs = refs[:num_ref]
        if len(refs) < num_ref or any(p is None for p in refs):
            # FFmpeg: "Missing reference picture": the default fills the gap
            # and the POC history is forgotten
            self.last_pocs = [INT_MIN] * MAX_DPB
            default = next((p for p in refs if p is not None), None)
            if default is None:
                raise ValueError("an inter slice without reference pictures")
            refs = [p if p is not None else default for p in refs]
            refs += [default] * (num_ref - len(refs))
            self.coverage["missing reference", lst] += 1
        return refs

    # -- the end of a picture -------------------------------------------------------
    def _finish_picture(self):
        pic, h = self.cur, self.cur_header
        if pic is None:
            return
        self.cur = None
        sps, pps = h.sps, h.pps
        if (pic.state["slice"] == -1).any():
            raise ValueError("a picture with macroblocks no slice decoded")
        if self.native:
            deblock_native(pic, sps.mb_w, sps.mb_h, pps.cb_qp_offset, pps.cr_qp_offset)
        else:
            deblock_py(pic, sps.mb_w, sps.mb_h, pps.cb_qp_offset, pps.cr_qp_offset,
                       self.coverage)
        self._select_output(pic, sps)  # FFmpeg selects at the picture's start
        if h.nal_ref_idc:
            self._mark(pic, h)
            self.frame_nums[pic.id] = pic.frame_num
            if sps.poc_type == 0:
                self.prev_poc_msb, self.prev_poc_lsb = self.poc_msb, self.poc_lsb
            self.prev_ref_frame_num = pic.frame_num
        self.prev_frame_num_offset = self.frame_num_offset
        self.prev_frame_num = pic.frame_num
        if pic.mmco5:
            self.prev_frame_num_offset = 0
            self.prev_frame_num = self.prev_ref_frame_num = 0
            self.prev_poc_msb, self.prev_poc_lsb = 0, 0

    def _mark(self, pic, h):
        sps = h.sps
        max_frame_num = 1 << sps.log2_max_frame_num
        if h.idr:
            for p in self.dpb:
                p.ref = None
            self.dpb = []
            if h.long_term_reference:
                pic.ref, pic.long_idx = "long", 0
                self.max_long_idx = 0
            else:
                pic.ref = "short"
                self.max_long_idx = -1
            self.dpb.append(pic)
            return
        long_now = False
        if h.mmcos is None:
            shorts = [p for p in self.dpb if p.ref == "short"]
            if len(self.dpb) >= max(sps.max_num_ref_frames, 1) and shorts:
                oldest = min(shorts, key=lambda p: self._pic_num(p, h))
                self._unmark(oldest)
        else:
            for op, diff, long_num, max_plus1 in h.mmcos:
                self.coverage["mmco", op] += 1
                if op in (1, 3):
                    num = h.frame_num - (diff + 1)
                    target = [p for p in self.dpb if p.ref == "short" and
                              self._pic_num(p, h) == (num if num >= -max_frame_num else num)]
                    if not target:
                        continue  # FFmpeg logs "mmco: unref short failure" and goes on
                    if op == 1:
                        self._unmark(target[0])
                    else:
                        for p in self.dpb:
                            if p.ref == "long" and p.long_idx == long_num:
                                self._unmark(p)
                        target[0].ref, target[0].long_idx = "long", long_num
                elif op == 2:
                    for p in self.dpb:
                        if p.ref == "long" and p.long_idx == long_num:
                            self._unmark(p)
                            break
                elif op == 4:
                    self.max_long_idx = max_plus1 - 1
                    for p in list(self.dpb):
                        if p.ref == "long" and p.long_idx > self.max_long_idx:
                            self._unmark(p)
                elif op == 5:
                    for p in list(self.dpb):
                        self._unmark(p)
                    self.max_long_idx = -1
                    pic.frame_num = 0
                    pic.mmco5 = pic.mmco_reset = True
                    self.mmco_reset = True
                    self.last_pocs = [INT_MIN] * MAX_DPB
                elif op == 6:
                    for p in list(self.dpb):
                        if p.ref == "long" and p.long_idx == long_num:
                            self._unmark(p)
                    pic.ref, pic.long_idx = "long", long_num
                    long_now = True
        if not long_now:
            pic.ref = "short"
        self.dpb.append(pic)
        if len(self.dpb) > max(sps.max_num_ref_frames, 1):
            raise ValueError(f"{len(self.dpb)} reference frames of at most "
                             f"{sps.max_num_ref_frames}")

    def _unmark(self, p):
        p.ref = None
        if p in self.dpb:
            self.dpb.remove(p)

    # -- output order (FFmpeg's h264_select_output_frame) ---------------------------
    def _select_output(self, cur, sps):
        cur.mmco_reset, self.mmco_reset = self.mmco_reset or cur.mmco_reset, False
        if sps.bitstream_restriction:
            self.has_b_frames = max(self.has_b_frames, sps.num_reorder_frames)
        lp = self.last_pocs
        i = 0
        while True:
            if i == MAX_DPB or cur.poc < lp[i]:
                if i:
                    lp[i - 1] = cur.poc
                break
            elif i:
                lp[i - 1] = lp[i]
            i += 1
        out_of_order = MAX_DPB - i
        if cur.b_first or (lp[MAX_DPB - 2] > INT_MIN and lp[MAX_DPB - 1] - lp[MAX_DPB - 2] > 2):
            out_of_order = max(out_of_order, 1)
        if out_of_order == MAX_DPB:
            for k in range(1, MAX_DPB):
                lp[k] = INT_MIN
            lp[0] = cur.poc
            cur.mmco_reset = True
        elif self.has_b_frames < out_of_order and not sps.bitstream_restriction:
            self.has_b_frames = out_of_order
            self.coverage["output delay grown"] += 1
        self.delayed.append(cur)
        pics = len(self.delayed)
        out, out_idx = self.delayed[0], 0
        for k in range(1, pics):
            p = self.delayed[k]
            if p.key or p.mmco_reset:
                break
            if p.poc < out.poc:
                out, out_idx = p, k
        if self.has_b_frames == 0 and (self.delayed[0].key or self.delayed[0].mmco_reset):
            self.next_outputed_poc = INT_MIN
        late = out.poc < self.next_outputed_poc
        if late or pics > self.has_b_frames:
            self.delayed.pop(out_idx)
        if late:
            self.coverage["picture dropped (late)"] += 1
        if not late and pics > self.has_b_frames:
            if out_idx == 0 and self.delayed and (self.delayed[0].key or
                                                   self.delayed[0].mmco_reset):
                self.next_outputed_poc = INT_MIN
            else:
                self.next_outputed_poc = out.poc
            if out.recovered:
                self.frame_recovered = True
            out.recovered |= self.frame_recovered
            if out.recovered:
                self._show(out)

    def _show(self, pic):
        self.out.append(self._planes(pic))
        self.out_packets.append(pic.packet)

    def _planes(self, pic):
        left, right, top, bottom = pic.crop
        if left % 64:  # FFmpeg keeps the planes aligned: the left crop is rounded down
            left &= ~63
        h, w = pic.y.shape
        self.colour = (pic.colourspace, bool(pic.full_range))
        y = pic.y[top:h - bottom, left:w - right]
        u = pic.u[top // 2:(h - bottom + 1) // 2, left // 2:(w - right + 1) // 2]
        v = pic.v[top // 2:(h - bottom + 1) // 2, left // 2:(w - right + 1) // 2]
        return y, u, v
