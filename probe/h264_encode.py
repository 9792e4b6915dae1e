"""An H.264 writer for the fixtures of ``make_h264_fixtures.py``: it is not
a good encoder.  It writes conformant CAVLC and CABAC streams of I, P and
B slices whose syntax it chooses, macroblock by macroblock, either from a
seed (``RandomChooser``: every macroblock and sub-macroblock type, intra
mode, reference, vector, coefficient and QP change the fixture's tools
allow) or from pictures (``ContentChooser``: intra 16x16 or motion-searched
inter macroblocks, from one list or both in B slices, skipped or direct
ones where the prediction holds).

It codes the macroblock layer through the port's own decoder
(``orienmask_tpu_torch/data/h264.py``): ``SliceWriter`` overrides the
decoder's syntax hooks (``mb_type``, ``intra_mode``, ``motion_vector``,
``block``, ...) to write the chosen elements, with the decoder's contexts
and neighbour rules, and the decoder reconstructs, deblocks and keeps the
references as it would reading the stream.  A fixture therefore tests the
decoder against libavcodec (through cv2 and ``tests/mpeg4_oracle.py``),
not against this writer.

Run by ``make_h264_fixtures.py``; nothing of the port imports it.
"""

import fractions
import io
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from orienmask_tpu_torch.data import h264 as H  # noqa: E402
from orienmask_tpu_torch.data import h264_tables as T  # noqa: E402
from orienmask_tpu_torch.data import mp4  # noqa: E402


# -- bits ------------------------------------------------------------------------

class BitWriter:
    """MSB-first bits with Exp-Golomb codes and CAVLC's residual block."""

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    @property
    def pos(self):
        return 8 * len(self.buf) + self.n

    def bit(self, b):
        self.acc = (self.acc << 1) | (b & 1)
        self.n += 1
        if self.n == 8:
            self.buf.append(self.acc)
            self.acc = self.n = 0
        return b

    def u(self, n, v):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)
        return v

    def ue(self, v):
        assert v >= 0
        length = (v + 1).bit_length()
        self.u(length - 1, 0)
        self.u(length, v + 1)
        return v

    def se(self, v):
        self.ue(2 * v - 1 if v > 0 else -2 * v)
        return v

    def te(self, cmax, v):
        if cmax == 1:
            self.bit(1 - v)
        else:
            self.ue(v)
        return v

    def trailing(self):
        self.bit(1)
        while self.n:
            self.bit(0)

    def align(self, b):
        while self.n:
            self.bit(b)

    def partial(self):
        """The bytes so far, the last one padded with zeros."""
        return bytes(self.buf) + (bytes([self.acc << (8 - self.n)]) if self.n else b"")

    def rbsp(self):
        assert self.n == 0
        return bytes(self.buf)

    def vlc(self, lengths, codes, index):
        n = lengths[index]
        assert n, index
        self.u(n, codes[index])

    def residual_block(self, levels, nc, max_num):
        """CAVLC's residual_block_cavlc for ``levels`` (scan order)."""
        nz = [(i, v) for i, v in enumerate(levels) if v]
        total = len(nz)
        rev = [v for _, v in reversed(nz)]
        ones = 0
        for v in rev:
            if abs(v) == 1 and ones < 3:
                ones += 1
            else:
                break
        if nc < 0:
            self.vlc(T.CHROMA_DC_COEFF_TOKEN_LEN, T.CHROMA_DC_COEFF_TOKEN_CODE, 4 * total + ones)
        else:
            t = 0 if nc < 2 else 1 if nc < 4 else 2 if nc < 8 else 3
            self.vlc(T.COEFF_TOKEN_LEN[t], T.COEFF_TOKEN_CODE[t], 4 * total + ones)
        if total == 0:
            return 0
        suffix_length = 1 if total > 10 and ones < 3 else 0
        for i, v in enumerate(rev):
            if i < ones:
                self.bit(int(v < 0))
                continue
            code = 2 * v - 2 if v > 0 else -2 * v - 1
            if i == ones and ones < 3:
                code -= 2
            if suffix_length == 0:
                if code < 14:
                    prefix, size, suffix = code, 0, 0
                elif code < 30:
                    prefix, size, suffix = 14, 4, code - 14
                else:
                    prefix, size, suffix = 15, 12, code - 30
            elif code < (15 << suffix_length):
                prefix, size, suffix = code >> suffix_length, suffix_length, \
                    code & ((1 << suffix_length) - 1)
            else:
                prefix, size, suffix = 15, 12, code - (15 << suffix_length)
            if suffix >= (1 << size) and prefix == 15:
                raise ValueError(f"a level of {v} needs level_prefix 16 (High profiles only)")
            self.u(prefix, 0)
            self.bit(1)
            self.u(size, suffix)
            if suffix_length == 0:
                suffix_length = 1
            if abs(v) > (3 << (suffix_length - 1)) and suffix_length < 6:
                suffix_length += 1
        positions = [i for i, _ in reversed(nz)]
        zeros = positions[0] + 1 - total
        if total < max_num:
            if nc < 0:
                self.vlc(T.CHROMA_DC_TOTAL_ZEROS_LEN[total - 1],
                         T.CHROMA_DC_TOTAL_ZEROS_CODE[total - 1], zeros)
            else:
                self.vlc(T.TOTAL_ZEROS_LEN[total - 1], T.TOTAL_ZEROS_CODE[total - 1], zeros)
        for k in range(total - 1):
            if zeros <= 0:
                break
            run = positions[k] - positions[k + 1] - 1
            self.vlc(T.RUN_BEFORE_LEN[min(zeros, 7) - 1], T.RUN_BEFORE_CODE[min(zeros, 7) - 1],
                     run)
            zeros -= run
        return total


def nal(ref_idc, kind, rbsp):
    """A NAL unit (header and the RBSP with emulation prevention)."""
    out = bytearray([(ref_idc << 5) | kind])
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


class CabacWriter(H.CabacElements):
    """CABAC's encoding engine (9.3.4.2) over a ``BitWriter``."""

    def __init__(self, w, init_idc, qp):
        self.w = w
        self.ctx = H.init_contexts(init_idc, qp)
        self.start()

    def start(self):
        self.low, self.range, self.first, self.outstanding = 0, 510, True, 0

    def _put(self, b):
        if self.first:
            self.first = False
        else:
            self.w.bit(b)
        while self.outstanding:
            self.w.bit(1 - b)
            self.outstanding -= 1

    def _renorm(self):
        while self.range < 256:
            if self.low < 256:
                self._put(0)
            elif self.low >= 512:
                self.low -= 512
                self._put(1)
            else:
                self.low -= 256
                self.outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def decision(self, ctx, v):
        st = self.ctx[ctx]
        state, mps = st
        lps = T.RANGE_LPS[state][(self.range >> 6) & 3]
        self.range -= lps
        if v != mps:
            self.low += self.range
            self.range = lps
            if state == 0:
                st[1] = 1 - mps
            st[0] = T.TRANS_LPS[state]
        else:
            st[0] = min(state + 1, 62)
        self._renorm()
        return v

    def bypass(self, v):
        self.low <<= 1
        if v:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.low -= 512
            self.outstanding += 1
        return v

    def terminate(self, v):
        self.range -= 2
        if v:
            self.low += self.range
            self.range = 2
            self._renorm()
            self._put((self.low >> 9) & 1)
            self.w.u(2, ((self.low >> 7) & 3) | 1)
        else:
            self._renorm()
        return v


# -- parameter sets and slice headers ------------------------------------------------

class Cfg:
    """Attributes from keywords, with defaults."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def get(self, name, default=None):
        return self.__dict__.get(name, default)


def _write_scaling(w, lists, count):
    """Scaling lists 0..count-1, each None (not present), "default"
    (useDefaultScalingMatrixFlag) or values in zig-zag order."""
    for i in range(count):
        lst = lists[i] if i < len(lists) else None
        w.bit(lst is not None)
        if lst is None:
            continue
        if lst == "default":
            w.se(-8)
            continue
        last = 8
        for v in lst:
            delta = (v - last + 128) % 256 - 128
            w.se(delta)
            last = v


def sps_rbsp(c):
    w = BitWriter()
    w.u(8, c.profile_idc)
    w.u(8, c.get("constraint_flags", 0))
    w.u(8, c.get("level_idc", 40))
    w.ue(c.get("id", 0))
    if c.profile_idc in H.HIGH_PROFILES:
        w.ue(c.get("chroma_format_idc", 1))
        w.ue(c.get("bit_depth_luma", 8) - 8)
        w.ue(c.get("bit_depth_chroma", 8) - 8)
        w.bit(0)
        scaling = c.get("scaling")
        w.bit(scaling is not None)
        if scaling is not None:
            _write_scaling(w, scaling, 8)
    w.ue(c.get("log2_max_frame_num", 4) - 4)
    w.ue(c.poc_type)
    if c.poc_type == 0:
        w.ue(c.get("log2_max_poc_lsb", 6) - 4)
    elif c.poc_type == 1:
        w.bit(c.get("delta_always_zero", 0))
        w.se(c.get("offset_non_ref", -1))
        w.se(c.get("offset_top_bottom", 0))
        cycle = c.get("offset_for_ref_frame", [2])
        w.ue(len(cycle))
        for v in cycle:
            w.se(v)
    w.ue(c.get("max_num_ref_frames", 1))
    w.bit(0)  # gaps_in_frame_num_value_allowed_flag
    w.ue(c.mb_w - 1)
    w.ue(c.mb_h - 1)
    w.bit(c.get("frame_mbs_only", 1))
    if not c.get("frame_mbs_only", 1):
        w.bit(0)
    w.bit(c.get("direct_8x8_inference", 1))
    crop = c.get("crop")
    w.bit(crop is not None)
    if crop is not None:
        for v in crop:
            w.ue(v // 2)
    vui = c.get("vui")
    w.bit(vui is not None)
    if vui is not None:
        w.bit(0)  # aspect_ratio_info
        w.bit(0)  # overscan
        signal = vui.get("full_range") is not None or vui.get("colour") is not None
        w.bit(signal)
        if signal:
            w.u(3, 5)
            w.bit(vui.get("full_range") or 0)
            colour = vui.get("colour")
            w.bit(colour is not None)
            if colour is not None:
                for v in colour:
                    w.u(8, v)
        w.bit(0)  # chroma_loc_info
        timing = vui.get("timing")
        w.bit(timing is not None)
        if timing is not None:
            w.u(32, timing[0])
            w.u(32, timing[1])
            w.bit(timing[2])
        w.bit(0)  # nal_hrd
        w.bit(0)  # vcl_hrd
        w.bit(0)  # pic_struct_present_flag
        reorder = vui.get("num_reorder_frames")
        w.bit(reorder is not None)
        if reorder is not None:
            w.bit(1)
            w.ue(2)
            w.ue(1)
            w.ue(16)
            w.ue(16)
            w.ue(reorder)
            w.ue(vui.get("max_dec_frame_buffering", c.get("max_num_ref_frames", 1)))
    w.trailing()
    return w.rbsp()


def pps_rbsp(c):
    w = BitWriter()
    w.ue(c.get("id", 0))
    w.ue(c.get("sps_id", 0))
    w.bit(c.cabac)
    w.bit(0)  # bottom_field_pic_order_in_frame_present_flag
    w.ue(c.get("num_slice_groups", 1) - 1)
    if c.get("num_slice_groups", 1) > 1:
        w.ue(0)  # slice_group_map_type 0 (interleaved)
        for _ in range(c.num_slice_groups):
            w.ue(0)
    w.ue(c.get("num_ref_idx_default", 1) - 1)
    w.ue(c.get("num_ref_idx_default1", 1) - 1)
    w.bit(c.get("weighted_pred", 0))
    w.u(2, c.get("weighted_bipred", 0))
    w.se(c.get("init_qp", 26) - 26)
    w.se(0)
    w.se(c.get("cb_qp_offset", 0))
    w.bit(c.get("deblocking_control", 1))
    w.bit(c.get("constrained_intra", 0))
    w.bit(c.get("redundant_pic_cnt_present", 0))
    if c.get("transform_8x8") is not None:
        w.bit(c.transform_8x8)
        scaling = c.get("scaling")
        w.bit(scaling is not None)
        if scaling is not None:
            _write_scaling(w, scaling, 6 + 2 * c.transform_8x8)
        w.se(c.get("cr_qp_offset", c.get("cb_qp_offset", 0)))
    w.trailing()
    return w.rbsp()


def slice_header(w, c, sps, pps):
    """Write slice header ``c`` into ``w``."""
    w.ue(c.first_mb)
    w.ue(c.slice_type + (5 if c.get("all_same_type") else 0))
    w.ue(pps.get("id", 0))
    w.u(sps.get("log2_max_frame_num", 4), c.frame_num)
    if c.idr:
        w.ue(c.get("idr_pic_id", 0))
    if sps.poc_type == 0:
        w.u(sps.get("log2_max_poc_lsb", 6), c.poc_lsb)
    elif sps.poc_type == 1 and not sps.get("delta_always_zero", 0):
        w.se(c.get("delta_poc0", 0))
    if pps.get("redundant_pic_cnt_present", 0):
        w.ue(c.get("redundant_pic_cnt", 0))
    b_slice = c.slice_type == H.B_SLICE
    if b_slice:
        w.bit(c.get("direct_spatial", 1))
    if c.slice_type in (H.P_SLICE, H.B_SLICE):
        override = c.get("num_ref") is not None or c.get("num_ref1") is not None
        w.bit(override)
        if override:
            w.ue(c.get("num_ref", pps.get("num_ref_idx_default", 1)) - 1)
            if b_slice:
                w.ue(c.get("num_ref1", pps.get("num_ref_idx_default1", 1)) - 1)
        for key in ("modifications", "modifications1") if b_slice else ("modifications",):
            mods = c.get(key) or []
            w.bit(bool(mods))
            if mods:
                for idc, val in mods:
                    w.ue(idc)
                    w.ue(val)
                w.ue(3)
        if (pps.get("weighted_pred", 0) and not b_slice) or \
                (pps.get("weighted_bipred", 0) == 1 and b_slice):
            ld, cd, *tables = c.weights
            w.ue(ld)
            w.ue(cd)
            for table in tables:
                for luma, chroma in table:
                    w.bit(luma is not None)
                    if luma is not None:
                        w.se(luma[0])
                        w.se(luma[1])
                    w.bit(chroma is not None)
                    if chroma is not None:
                        for v in chroma:
                            w.se(v)
    if c.nal_ref_idc:
        if c.idr:
            w.bit(0)
            w.bit(c.get("long_term_reference", 0))
        else:
            mmcos = c.get("mmcos")
            w.bit(mmcos is not None)
            if mmcos is not None:
                for op in mmcos:
                    w.ue(op[0])
                    if op[0] in (1, 3):
                        w.ue(op[1])
                    if op[0] == 2:
                        w.ue(op[1])
                    if op[0] == 3:
                        w.ue(op[2])
                    if op[0] == 6:
                        w.ue(op[1])
                    if op[0] == 4:
                        w.ue(op[1])
                w.ue(0)
    if pps.cabac and c.slice_type != H.I_SLICE:
        w.ue(c.get("cabac_init_idc", 0))
    w.se(c.qp - pps.get("init_qp", 26))
    if pps.get("deblocking_control", 1):
        idc = c.get("deblock_idc", 0)
        w.ue(idc)
        if idc != 1:
            w.se(c.get("alpha_div2", 0))
            w.se(c.get("beta_div2", 0))


# -- the macroblock writer --------------------------------------------------------------

class Plan:
    """What the chooser picked for one macroblock."""

    def __init__(self, **kw):
        self.skip = False
        self.mb_type = 0
        self.t8 = 0
        self.modes = iter(())
        self.cmode = 0
        self.subs = iter(())
        self.refs = iter(())
        self.mvs = iter(())
        self.cbp = 0
        self.dqp = 0
        self.block = None  # (cat, comp, r, max_num) -> levels in scan order
        self.pcm = None
        self.__dict__.update(kw)


class SliceWriter(H.SliceDecoder):
    """Writes one slice's data into ``w`` (after its header), each
    macroblock as ``chooser(writer, addr)`` plans it, reconstructing it as
    the decoder would."""

    def __init__(self, w, prm, pic, lists, level_scale, chooser, last_mb, coverage):
        self.coverage = coverage
        self.setup(prm, pic, lists, level_scale)
        self.w = w
        if self.cabac:
            w.align(1)  # cabac_alignment_one_bit
            self.ent = CabacWriter(w, prm[H.PR_INIT_IDC] if self.slice_type != H.I_SLICE else -1,
                                   prm[H.PR_QP])
        else:
            self.ent = w
        self.chooser = chooser
        self.last_mb = last_mb

    def encode(self):
        addr = self.prm[H.PR_FIRST_MB]
        inter = self.slice_type != H.I_SLICE
        run = 0
        while addr <= self.last_mb:
            self.check(addr)
            self.plan = self.chooser(self, addr)
            if inter and self.plan.skip:
                if self.cabac:
                    self.ent.mb_skip(self.skip_ctx(addr), 1, base=self.skip_base())
                self.skip(addr)
                run += 1
            else:
                if inter and not self.cabac:
                    self.w.ue(run)
                    run = 0
                if inter and self.cabac:
                    self.ent.mb_skip(self.skip_ctx(addr), 0, base=self.skip_base())
                self.macroblock(addr)
            if self.cabac:
                self.ent.terminate(int(addr == self.last_mb))
            addr += 1
        if self.cabac:
            self.w.align(0)
        else:
            if run:
                self.w.ue(run)
            self.w.trailing()
        return self.end(addr)

    # the syntax hooks, writing the plan
    def mb_type(self, addr):
        v = self.plan.mb_type
        if not self.cabac:
            self.w.ue(v)
        elif self.slice_type == H.P_SLICE:
            self.ent.mb_type_p(v)
        elif self.slice_type == H.B_SLICE:
            self.ent.mb_type_b(self.mb_type_b_inc(addr), v)
        else:
            self.ent.mb_type_i(self.mb_type_inc(addr), v)
        return v

    def transform_8x8(self, addr):
        v = self.plan.t8
        if self.cabac:
            self.ent.transform_8x8(self.t8_inc(addr), v)
        else:
            self.w.bit(v)
        return v

    def intra_mode(self, addr, pred, size):
        mode = next(self.plan.modes)
        if self.cabac:
            self.ent.prev_intra_flag(int(mode == pred))
            if mode != pred:
                self.ent.rem_intra_mode(mode if mode < pred else mode - 1)
        else:
            self.w.bit(int(mode == pred))
            if mode != pred:
                self.w.u(3, mode if mode < pred else mode - 1)
        return mode

    def chroma_pred_mode(self, addr):
        v = self.plan.cmode
        if self.cabac:
            self.ent.chroma_mode(self.cmode_inc(addr), v)
        else:
            self.w.ue(v)
        return v

    def sub_mb_type(self):
        v = next(self.plan.subs)
        if not self.cabac:
            self.w.ue(v)
        elif self.slice_type == H.B_SLICE:
            self.ent.sub_mb_type_b(v)
        else:
            self.ent.sub_mb_type(v)
        return v

    def ref_idx(self, addr, x, y, lst=0):
        v = next(self.plan.refs)
        if self.cabac:
            self.ent.ref_idx(self.ref_inc(addr, x, y, lst), v)
        else:
            self.w.te(self.num_ref[lst] - 1, v)
        return v

    def motion_vector(self, addr, x, y, w, h, mvp, lst=0):
        mv = next(self.plan.mvs)
        if callable(mv):
            mv = mv(mvp)
        mvd = (mv[0] - mvp[0], mv[1] - mvp[1])
        for comp in range(2):
            if self.cabac:
                self.ent.mvd(comp, self.mvd_inc(addr, x, y, comp, lst), mvd[comp])
            else:
                self.w.se(mvd[comp])
        self.store_mv(addr, x, y, w, h, mv[0], mv[1], mvd, lst)

    def coded_block_pattern(self, addr, intra):
        v = self.plan.cbp
        if not self.cabac:
            self.w.ue((T.CBP_INTRA if intra else T.CBP_INTER).index(v))
            return v
        luma = 0
        for b8 in range(4):
            b = (v >> b8) & 1
            self.ent.cbp_luma_bin(self.cbp_luma_inc(addr, b8, luma), b)
            luma |= b << b8
        self.ent.cbp_chroma(*self.cbp_chroma_inc(addr), v >> 4)
        return v

    def mb_qp_delta(self):
        v = self.plan.dqp
        if self.cabac:
            self.ent.mb_qp_delta(int(self.last_dqp != 0), v)
        else:
            self.w.se(v)
        return v

    def block(self, addr, cat, max_num, nc=0, comp=0, r=0):
        self.coverage["ctxBlockCat", cat, "cabac" if self.cabac else "cavlc"] += 1
        levels = list(self.plan.block(cat, comp, r, max_num))
        n = sum(1 for v in levels if v)
        if not self.cabac:
            self.w.residual_block(levels, nc, max_num)
            return levels, n
        if cat != 5:
            self.ent.coded_block_flag(cat, self.cbf_ctx(addr, cat, comp, r), int(n > 0))
            if not n:
                return levels, 0
        elif not n:
            raise ValueError("an 8x8 block under CABAC with no coefficient")
        self.ent.residual_block(cat, max_num, levels)
        return levels, n

    def pcm_samples(self):
        self.w.align(0)
        for b in self.plan.pcm:
            self.w.u(8, b)
        return list(self.plan.pcm)


class WriterDecoder(H.Decoder):
    """The port's decoder, whose slices are written (``SliceWriter``)
    instead of read; the reconstruction, references and output are the
    decoder's own."""

    def __init__(self):
        super().__init__(native=False)
        self.job = None  # (writer, chooser, last macroblock)

    def slice_data(self, rbsp, h, prm, lists):
        w, chooser, last_mb = self.job
        SliceWriter(w, prm, self.cur, lists, (h.pps.level_scale4, h.pps.level_scale8),
                    chooser, last_mb, self.coverage).encode()


class Stream:
    """An H.264 stream written picture by picture: ``picture`` codes one,
    ``packets`` the access units so far (Annex B or lengths), ``frames``
    the decoder's output planes."""

    def __init__(self, sps, ppss, annexb=True, headers_in_band=True):
        self.sps = sps
        self.ppss = {p.get("id", 0): p for p in ppss}
        self.dec = WriterDecoder()
        self.annexb = annexb
        self.param_nals = [nal(3, 7, sps_rbsp(sps))] + [nal(3, 8, pps_rbsp(p)) for p in ppss]
        for n in self.param_nals:
            self.dec._nal(n)
        self.headers_in_band = headers_in_band
        self.packets = []
        self.keys = []
        self.frames = []
        self.pictures = 0

    def wrap(self, nals):
        if self.annexb:
            return b"".join(b"\0\0\0\1" + n for n in nals)
        return b"".join(struct.pack(">I", len(n)) + n for n in nals)

    def picture(self, slices, chooser, idr=False, nal_ref_idc=1, sei=None, pps_id=0,
                extra_nals=(), repeat_headers=False):
        """Code one picture of ``slices``: each a ``Cfg`` of slice header
        fields with ``last_mb``, the picture's ``frame_num`` etc. set."""
        pps = self.ppss[pps_id]
        nals = list(extra_nals)
        if (self.pictures == 0 and self.headers_in_band) or repeat_headers:
            nals = self.param_nals + nals
        if sei is not None:
            nals.append(nal(0, 6, sei))
            self.dec._nal(nals[-1])
        for c in slices:
            c.idr = idr
            c.nal_ref_idc = nal_ref_idc
            w = BitWriter()
            slice_header(w, c, self.sps, pps)
            self.dec.job = (w, chooser, c.last_mb)
            self.dec._slice(w.partial(), 5 if idr else 1, nal_ref_idc)
            nals.append(nal(nal_ref_idc, 5 if idr else 1, w.rbsp()))
        self.dec._finish_picture()
        self.frames += self.dec._take()
        self.packets.append(self.wrap(nals))
        self.keys.append(idr)
        self.pictures += 1

    def finish(self):
        self.frames += self.dec.flush()
        return self.packets

    def avcc(self):
        """The ``avcC`` record of the parameter sets (4-byte lengths)."""
        sps = self.param_nals[0]
        out = bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1]) + struct.pack(">H", len(sps)) + sps
        out += bytes([len(self.param_nals) - 1])
        for n in self.param_nals[1:]:
            out += struct.pack(">H", len(n)) + n
        return out


def recovery_point_sei(frames=0):
    """An SEI NAL's RBSP holding one recovery point."""
    w = BitWriter()
    w.ue(frames)
    w.bit(1)  # exact_match_flag
    w.bit(0)  # broken_link_flag
    w.u(2, 0)
    w.trailing()
    body = w.rbsp()
    return bytes([6, len(body)]) + body + b"\x80"


# -- choosers -------------------------------------------------------------------------

I_MODES_NEED = {0: "t", 1: "l", 2: "", 3: "t", 4: "tlc", 5: "tlc", 6: "tlc", 7: "t", 8: "l"}


def _avail(writer, addr, bx, by):
    """(top, left, corner) availability of the block at 4x4 (bx, by)."""
    ok_a = writer.intra_avail(writer.mb_a(addr))
    ok_b = writer.intra_avail(writer.mb_b(addr))
    ok_d = writer.intra_avail(writer.mb_d(addr))
    top = ok_b if by == 0 else True
    left = ok_a if bx == 0 else True
    corner = (ok_d if bx == 0 else ok_b) if by == 0 else (ok_a if bx == 0 else True)
    return top, left, corner


def _valid(need, top, left, corner):
    return ("t" not in need or top) and ("l" not in need or left) and ("c" not in need or corner)


class RandomChooser:
    """Random syntax: ``kinds`` weights of the macroblock kinds allowed
    (per slice type; B's "direct", "B16x16", "B16x8", "B8x16", "B8x8",
    "skip", "intra"), coefficient ``density``, ``dqp`` probability, vector
    ``mv_range`` (quarter samples), ``pcm`` weight, ``t8`` probability."""

    def __init__(self, seed, i_kinds=None, p_kinds=None, density=0.25, dqp=0.1, mv_range=40,
                 t8=0.5, big=0.02, max_level=12, b_kinds=None):
        self.rng = np.random.default_rng(seed)
        self.i_kinds = i_kinds or {"I4": 3, "I16": 3}
        self.p_kinds = p_kinds or {"P16x16": 3, "skip": 3}
        self.b_kinds = b_kinds or {"direct": 2, "B16x16": 3, "B16x8": 1.5, "B8x16": 1.5,
                                   "B8x8": 2, "skip": 2, "intra": 0.5}
        self.density, self.dqp, self.mv_range, self.t8p = density, dqp, mv_range, t8
        self.big, self.max_level = big, max_level

    def pick(self, weights):
        names = list(weights)
        p = np.array([weights[n] for n in names], float)
        return names[self.rng.choice(len(names), p=p / p.sum())]

    def levels(self, cat, max_num, must):
        rng = self.rng
        out = [0] * max_num
        dens = self.density if cat != 3 else min(1.0, 2 * self.density)
        for i in range(max_num):
            if rng.random() < dens * (1.5 if i < max_num // 3 else 0.6):
                v = int(rng.integers(1, 4))
                if rng.random() < 0.15:
                    v = int(rng.integers(4, self.max_level + 1))
                if rng.random() < self.big:
                    v = int(rng.integers(self.max_level, 4 * self.max_level))
                out[i] = v if rng.random() < 0.5 else -v
        if must and not any(out):
            out[int(rng.integers(0, min(4, max_num)))] = 1
        return out

    def __call__(self, w, addr):
        rng = self.rng
        p_slice = w.slice_type == H.P_SLICE
        b_slice = w.slice_type == H.B_SLICE
        kind = self.pick(self.b_kinds if b_slice else self.p_kinds if p_slice else self.i_kinds)
        if kind == "skip":
            return Plan(skip=True)
        if kind == "intra":
            kind = self.pick(self.i_kinds)
        plan = Plan()
        plan.block = self.block_levels(w, addr)
        base = 23 if b_slice else 5 if p_slice else 0
        if kind == "PCM":
            plan.mb_type = base + 25
            plan.pcm = bytes(int(v) for v in rng.integers(1, 256, 384))
            return plan
        if kind in ("I4", "I8", "I16"):
            if kind == "I16":
                top, left, corner = _avail(w, addr, 0, 0)
                modes = [m for m, need in ((0, "t"), (1, "l"), (2, ""), (3, "tlc"))
                         if _valid(need, top, left, corner)]
                mode = int(rng.choice(modes))
                chroma = int(rng.integers(0, 3))
                luma = int(rng.random() < 0.5)
                plan.mb_type = base + 1 + mode + 4 * chroma + 12 * luma
                plan.cbp = chroma << 4 | (15 if luma else 0)
            else:
                size = 8 if kind == "I8" else 4
                plan.mb_type = base
                plan.t8 = int(kind == "I8")
                modes = []
                order = range(4) if size == 8 else H.BLK_RASTER
                for k in order:
                    if size == 8:
                        bx, by = 2 * (k & 1), 2 * (k >> 1)
                    else:
                        bx, by = k & 3, k >> 2
                    top, left, corner = _avail(w, addr, bx, by)
                    valid = [m for m, need in I_MODES_NEED.items() if _valid(need, top, left,
                                                                            corner)]
                    modes.append(int(rng.choice(valid)))
                plan.modes = iter(modes)
                plan.cbp = int(rng.integers(0, 48))
            top, left, corner = _avail(w, addr, 0, 0)
            cmodes = [m for m, need in ((0, ""), (1, "l"), (2, "t"), (3, "tlc"))
                      if _valid(need, top, left, corner)]
            plan.cmode = int(rng.choice(cmodes))
        elif b_slice:
            self.b_plan(w, plan, kind)
        else:
            plan.mb_type = {"P16x16": 0, "P16x8": 1, "P8x16": 2, "P8x8": 3, "P8x8ref0": 4}[kind]
            n_parts = {0: 1, 1: 2, 2: 2, 3: 4, 4: 4}[plan.mb_type]
            refs = [int(rng.integers(0, w.num_ref[0])) for _ in range(n_parts)]
            if plan.mb_type == 4:
                refs = [0] * 4
            plan.refs = iter(refs)
            mvs = []
            if plan.mb_type >= 3:
                subs = [int(rng.integers(0, 4)) for _ in range(4)]
                plan.subs = iter(subs)
                n_mv = sum((1, 2, 2, 4)[t] for t in subs)
                small = any(subs)
            else:
                n_mv = n_parts
                small = False
            plan.mvs = iter([self.mv() for _ in range(n_mv)])
            plan.cbp = int(rng.integers(0, 48)) if rng.random() < 0.8 else 0
            plan.t8 = int(w.t8_mode and not small and rng.random() < self.t8p)
        if rng.random() < self.dqp:
            plan.dqp = int(rng.integers(-3, 4)) if rng.random() < 0.8 else \
                int(rng.integers(-26, 26))
        return plan

    def mv(self):
        """A vector, or a zero mvd (30 %)."""
        rng, r = self.rng, self.mv_range
        if rng.random() < 0.3:
            return lambda mvp: mvp
        return int(rng.integers(-r, r + 1)), int(rng.integers(-r, r + 1))

    def b_plan(self, w, plan, kind):
        """A B macroblock of ``kind``: its mb_type (and sub types), and its
        references and vectors in the order the syntax asks for them (every
        ref_idx_l0, ref_idx_l1, mvd_l0, mvd_l1; a list of one reference has
        no ref_idx)."""
        rng = self.rng
        if kind == "direct":
            plan.mb_type, parts = 0, []
        elif kind == "B8x8":
            plan.mb_type = 22
            subs = [int(rng.integers(0, 13)) for _ in range(4)]
            plan.subs = iter(subs)
            parts = [(H.B_SUB_TYPES[t][2], 4 // (H.B_SUB_TYPES[t][0] * H.B_SUB_TYPES[t][1] // 16))
                     for t in subs if t]
        else:
            plan.mb_type = int(rng.choice({"B16x16": (1, 2, 3), "B16x8": range(4, 22, 2),
                                           "B8x16": range(5, 22, 2)}[kind]))
            parts = [(m, 1) for m in H.B_MB_TYPES[plan.mb_type][1]]
        plan.refs = iter([int(rng.integers(0, w.num_ref[lst])) for lst in range(2)
                          if w.num_ref[lst] > 1 for used, _ in parts if used >> lst & 1])
        plan.mvs = iter([self.mv() for lst in range(2) for used, count in parts
                         if used >> lst & 1 for _ in range(count)])
        plan.cbp = int(rng.integers(0, 48)) if rng.random() < 0.8 else 0
        plan.t8 = int(w.t8_mode and rng.random() < self.t8p)

    def block_levels(self, w, addr):
        """The plan's ``block``: random levels, asked for in the order the
        residual is written, kept within the range the standard allows the
        scaled coefficients and the transforms' intermediate values
        (8.5.12.1): a block that would leave it is halved until it fits."""
        cache, dcs = {}, {}

        def fit(make, peak):
            levels = make()
            while peak(levels) > LIMIT:
                levels = [v // 2 if v > 0 else -((-v) // 2) for v in levels]
            return levels

        def block(cat, comp, r, max_num):
            key = (cat, comp, r)
            if key in cache:
                return cache[key]
            qp = w.qp
            intra = w.s["kind"][addr] <= H.PCM
            t8 = w.s["t8"][addr]
            if cat == 0:
                ls0 = w.ls4[0][qp % 6][0]

                def peak(lv):
                    raster = [0] * 16
                    for i, v in enumerate(lv):
                        raster[T.ZIGZAG4[i]] = v
                    dcs[0] = H.luma_dc(raster, ls0, qp)
                    return max(abs(v) for v in dcs[0])
                out = fit(lambda: self.levels(cat, max_num, False), peak)
                peak(out)
            elif cat == 3:
                qpc = H.chroma_qp(qp, w.prm[H.PR_CB_OFF + comp])
                ls0 = w.ls4[(1 if intra else 4) + comp][qpc % 6][0]

                def peak(lv):
                    dcs[3, comp] = H.chroma_dc(lv, ls0, qpc)
                    return max(abs(v) for v in dcs[3, comp])
                out = fit(lambda: self.levels(cat, max_num, False), peak)
                peak(out)
            elif cat == 5 or (cat == 2 and t8):
                b8 = (r >> 3) * 2 + ((r & 3) >> 1)
                ls = w.ls8[0 if intra else 1][qp % 6]
                full = fit(lambda: self.levels(5, 64, cat == 5),
                           lambda lv: _peak(lv, T.ZIGZAG8, lambda c: H.scale8(c, ls, qp),
                                            _idct8_stages))
                if cat == 5 and not any(full):
                    full[0] = 1
                if cat == 5:
                    out = full
                else:
                    for k in range(4):
                        cache[(2, 0, H.BLK_RASTER[4 * b8 + k])] = full[k::4]
                    return cache[key]
            else:
                if cat == 4:
                    qpc = H.chroma_qp(qp, w.prm[H.PR_CB_OFF + comp])
                    ls, q, dc = w.ls4[(1 if intra else 4) + comp][qpc % 6], qpc, \
                        dcs.get((3, comp), [0] * 4)[r]
                else:
                    ls, q = w.ls4[0 if intra else 3][qp % 6], qp
                    dc = dcs[0][r] if cat == 1 else None
                first = 1 if cat in (1, 4) else 0
                out = fit(lambda: self.levels(cat, max_num, False),
                          lambda lv: _peak([0] * first + list(lv), T.ZIGZAG4,
                                           lambda c: H.scale4(c, ls, q, dc), _idct4_stages))
            cache[key] = out
            return out

        return block


LIMIT = 1 << 14  # kept well inside the 16-bit range of 8.5.12.1


def _idct4_stages(d):
    """The inverse 4x4 transform's intermediate values, flattened."""
    rows = []
    for i in range(4):
        d0, d1, d2, d3 = d[4 * i:4 * i + 4]
        e = [d0 + d2, d0 - d2, (d1 >> 1) - d3, d1 + (d3 >> 1)]
        rows.append([e[0] + e[3], e[1] + e[2], e[1] - e[2], e[0] - e[3]])
    out = [v for row in rows for v in row]
    for j in range(4):
        f0, f1, f2, f3 = (rows[i][j] for i in range(4))
        g = [f0 + f2, f0 - f2, (f1 >> 1) - f3, f1 + (f3 >> 1)]
        out += g + [g[0] + g[3] + 32, g[1] + g[2] + 32, g[1] - g[2] + 32, g[0] - g[3] + 32]
    return out


def _idct8_stages(d):
    rows = [H._idct8_1d(d[8 * i:8 * i + 8]) for i in range(8)]
    out = [v for row in rows for v in row]
    for j in range(8):
        col = H._idct8_1d([rows[i][j] for i in range(8)])
        out += [v + 32 for v in col]
    return out


def _peak(levels, scan, scale, stages):
    c = [0] * len(scan)
    for i, v in enumerate(levels):
        c[scan[i]] = v
    d = scale(c)
    return max(max(abs(v) for v in d), max(abs(v) for v in stages(d)))


# the inverse transforms as matrices (float), for ContentChooser's levels
def _inverse_matrix(n):
    fn = H._idct8_1d if n == 8 else (lambda d: [d[0] + d[2] + d[1] + (d[3] >> 1),
                                                d[0] - d[2] + (d[1] >> 1) - d[3],
                                                d[0] - d[2] - (d[1] >> 1) + d[3],
                                                d[0] + d[2] - d[1] - (d[3] >> 1)])
    m = np.zeros((n, n))
    for k in range(n):
        e = [0] * n
        e[k] = 1024
        m[:, k] = np.array(fn(e)) / 1024
    return m


CI4, CI8 = _inverse_matrix(4), _inverse_matrix(8)


class Quantizer:
    """Levels whose reconstruction approximates a residual: the inverse of
    the (float) scaling and transform, then rounding with a dead zone."""

    def __init__(self):
        self.cache = {}

    def _block(self, n, ls, qp, first=0, dc=None):
        """(n*n residual, len) matrix of a block's levels from scan index
        ``first``."""
        scan = T.ZIGZAG8 if n == 8 else T.ZIGZAG4
        shift = 2.0 ** (qp // 6 - (6 if n == 8 else 4))
        ci = CI8 if n == 8 else CI4
        cols = []
        for i in range(first, n * n):
            d = np.zeros(n * n)
            d[scan[i]] = ls[scan[i]] * shift
            cols.append((ci @ d.reshape(n, n) @ ci.T).ravel() / 64)
        return np.array(cols).T

    def matrix(self, kind, ls, qp):
        key = (kind, qp, tuple(ls))
        if key in self.cache:
            return self.cache[key]
        if kind in ("4x4", "8x8"):
            n = 4 if kind == "4x4" else 8
            m = self._block(n, ls, qp)
        else:  # "i16" (16 DC then 16 x 15 AC, raster blocks) or "chroma" (4 + 4 x 15)
            nb = 16 if kind == "i16" else 4
            side = 4 if kind == "i16" else 2
            size = 4 * side
            ac = self._block(4, ls, qp, first=1)
            m = np.zeros((size * size, nb + 15 * nb))
            for r in range(nb):
                bx, by = 4 * (r % side), 4 * (r // side)
                rows = [(by + y) * size + bx + x for y in range(4) for x in range(4)]
                m[rows, nb + 15 * r:nb + 15 * r + 15] = ac
            for i in range(nb):
                c = np.zeros(nb)
                c[T.ZIGZAG4[i] if kind == "i16" else i] = 1
                cm = c.reshape(side, side)
                hm = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]]) \
                    if side == 4 else np.array([[1, 1], [1, -1]])
                f = (hm @ cm @ hm).ravel()
                scale = ls[0] * 2.0 ** (qp // 6 - 6) if kind == "i16" else \
                    ls[0] * 2.0 ** (qp // 6) / 32
                for r in range(nb):
                    bx, by = 4 * (r % side), 4 * (r // side)
                    d = np.zeros(16)
                    d[0] = f[r] * scale
                    res = (CI4 @ d.reshape(4, 4) @ CI4.T).ravel() / 64
                    rows = [(by + y) * size + bx + x for y in range(4) for x in range(4)]
                    m[rows, i] += res
        inv = np.linalg.inv(m)
        self.cache[key] = inv
        return inv

    def levels(self, kind, ls, qp, residual, deadzone):
        x = self.matrix(kind, ls, qp) @ residual.ravel().astype(float)
        return (np.sign(x) * np.floor(np.abs(x) + deadzone)).astype(int)


class ContentChooser:
    """Codes pictures: intra 16x16 in I slices (the best of the available
    modes), in P slices the best of each reference's motion search (full
    samples in a window around the prediction, then quarter samples)
    as P_L0_16x16, or P_Skip where it predicts as well and no coefficient
    survives."""

    def __init__(self, window=8, quant=None):
        self.window = window
        self.q = quant or Quantizer()
        self.frame = None  # (Y, U, V) of the picture being coded

    def __call__(self, w, addr):
        y0, x0 = 16 * (addr // w.mb_w), 16 * (addr % w.mb_w)
        Y, U, V = self.frame
        cur = Y[y0:y0 + 16, x0:x0 + 16].astype(np.int32)
        if w.slice_type == H.P_SLICE:
            plan = self.inter(w, addr, x0, y0, cur)
            if plan is not None:
                return plan
        if w.slice_type == H.B_SLICE:
            plan = self.inter_b(w, addr, x0, y0, cur)
            if plan is not None:
                return plan
        return self.intra(w, addr, x0, y0, cur, {H.I_SLICE: 0, H.P_SLICE: 5,
                                                 H.B_SLICE: 23}[w.slice_type])

    def intra(self, w, addr, x0, y0, cur, base):
        Y, U, V = self.frame
        pic = w.pic
        top, left, corner = _avail(w, addr, 0, 0)
        t, l, c = w.neighbour_samples(pic.y, x0, y0, 16, top, left, corner, False, 0)
        best = None
        for mode, need in ((0, "t"), (1, "l"), (2, ""), (3, "tlc")):
            if not _valid(need, top, left, corner):
                continue
            pred = np.asarray(H.intra_16x16(mode, t, l, c), np.int32)
            cost = np.abs(cur - pred).sum()
            if best is None or cost < best[0]:
                best = (cost, mode, pred)
        _, mode, pred = best
        qp = w.qp
        lv = self.q.levels("i16", w.ls4[0][qp % 6], qp, cur - pred, 0.4)
        dc, ac = lv[:16], lv[16:].reshape(16, 15)
        luma = int(np.any(ac))
        chroma_levels, chroma_cbp = self.chroma(w, x0 // 2, y0 // 2, True, top, left, corner)
        blocks = {(0, 0, 0): list(dc)}
        for r in range(16):
            blocks[(1, 0, r)] = list(ac[r]) if luma else [0] * 15
        blocks.update(chroma_levels)
        return Plan(mb_type=base + 1 + mode + 4 * chroma_cbp + 12 * luma,
                    cbp=chroma_cbp << 4 | (15 if luma else 0), cmode=self.cmode,
                    block=lambda cat, comp, r, n: blocks[(cat, comp, r)])

    def chroma(self, w, cx, cy, intra, top=False, left=False, corner=False):
        """Chroma levels keyed as ``block`` asks for them, and the chroma
        coded_block_pattern; intra macroblocks predict by DC (mode 0)."""
        Y, U, V = self.frame
        pic = w.pic
        out = {}
        any_dc = any_ac = False
        self.cmode = 0
        for comp, (src, plane) in enumerate(((U, pic.u), (V, pic.v))):
            cur = src[cy:cy + 8, cx:cx + 8].astype(np.int32)
            if intra:
                t, l, c = w.neighbour_samples(plane, cx, cy, 8, top, left, corner, False, 0)
                pred = np.asarray(H.intra_chroma(0, t, l, c), np.int32)
            else:
                pred = self.chroma_pred[comp]
            qpc = H.chroma_qp(w.qp, w.prm[H.PR_CB_OFF + comp])
            ls = w.ls4[(1 if intra else 4) + comp][qpc % 6]
            lv = self.q.levels("chroma", ls, qpc, cur - pred, 0.4 if intra else 0.2)
            out[(3, comp, 0)] = list(lv[:4])
            ac = lv[4:].reshape(4, 15)
            for r in range(4):
                out[(4, comp, r)] = list(ac[r])
            any_dc |= bool(np.any(lv[:4]))
            any_ac |= bool(np.any(ac))
        cbp = 2 if any_ac else 1 if any_dc else 0
        if cbp < 2:
            for k in list(out):
                if k[0] == 4:
                    out[k] = [0] * 15
        return out, cbp

    def search(self, w, ref, x0, y0, cur, centre):
        """The best quarter-sample vector of ``ref`` for the block, searched
        around ``centre`` (quarter samples): (cost, mv)."""
        H_, W_ = ref.y.shape
        cx, cy = centre[0] >> 2, centre[1] >> 2
        r = self.window
        rows = np.clip(np.arange(y0 + cy - r, y0 + cy + r + 16), 0, H_ - 1)
        cols = np.clip(np.arange(x0 + cx - r, x0 + cx + r + 16), 0, W_ - 1)
        area = ref.y[rows][:, cols].astype(np.int32)
        win = np.lib.stride_tricks.sliding_window_view(area, (16, 16))
        sad = np.abs(win - cur).sum(axis=(2, 3))
        dy, dx = (int(v) for v in np.unravel_index(np.argmin(sad), sad.shape))
        best_mv = (4 * (cx + dx - r), 4 * (cy + dy - r))
        best = int(sad[dy, dx])
        for step in (2, 1):
            base = best_mv
            for ddx in (-step, 0, step):
                for ddy in (-step, 0, step):
                    if ddx == ddy == 0:
                        continue
                    mv = (base[0] + ddx, base[1] + ddy)
                    pred = H.luma_mc(ref.y, x0, y0, 16, 16, mv[0], mv[1])
                    cost = int(np.abs(cur - pred).sum())
                    if cost < best:
                        best, best_mv = cost, mv
        return best, best_mv

    def inter(self, w, addr, x0, y0, cur):
        skip_mv = w.p_skip_mv(addr)
        best = None
        for ref_idx, ref in enumerate(w.lists.refs[0][:w.num_ref[0]]):
            mvp = w.mv_pred(addr, 0, 0, 16, 16, ref_idx, H.P16X16, 0)
            cost, mv = self.search(w, ref, x0, y0, cur, mvp)
            cost += abs(mv[0] - mvp[0]) + abs(mv[1] - mvp[1]) + 8 * ref_idx
            if best is None or cost < best[0]:
                best = (cost, ref_idx, mv)
        if best is None:
            return None
        _, ref_idx, mv = best
        ref = w.lists.refs[0][ref_idx]
        pred = H.luma_mc(ref.y, x0, y0, 16, 16, mv[0], mv[1])
        sad = int(np.abs(cur - pred).sum())
        if sad > 16 * 16 * 30:  # intra predicts it better
            return None
        self.chroma_pred = [H.chroma_mc(p, x0 // 2, y0 // 2, 8, 8, mv[0], mv[1])
                            for p in (ref.u, ref.v)]
        blocks, cbp, t8 = self.residual_levels(w, cur - pred)
        chroma_levels, chroma_cbp = self.chroma(w, x0 // 2, y0 // 2, False)
        blocks.update(chroma_levels)
        cbp |= chroma_cbp << 4
        if cbp == 0 and ref_idx == 0 and tuple(mv) == tuple(skip_mv):
            return Plan(skip=True)
        return Plan(mb_type=0, refs=iter([ref_idx]), mvs=iter([mv]), cbp=cbp, t8=t8,
                    block=lambda cat, comp, r, n: blocks[(cat, comp, r)])


    @staticmethod
    def predicted(w, addr, x0, y0, refs=None, mvs=None):
        """The decoder's (Y, U, V) prediction of macroblock ``addr``: direct
        where ``refs`` is None, else from one 16x16 partition of L0 and L1
        indices ``refs`` (-1: the list unused) and vectors ``mvs``.  The
        macroblock's state and samples are written again when it is
        coded."""
        s = w.s
        if refs is None:
            w.direct(addr, range(4))
        else:
            for k in range(16 * addr, 16 * addr + 16):
                for lst in range(2):
                    mv, ref, _, _ = H.LIST_STATE[lst]
                    s[ref][k] = refs[lst]
                    s[mv][2 * k], s[mv][2 * k + 1] = mvs[lst]
        w.inter_pred(addr)
        pic = w.pic
        return (pic.y[y0:y0 + 16, x0:x0 + 16].astype(np.int32),
                [p[y0 // 2:y0 // 2 + 8, x0 // 2:x0 // 2 + 8].astype(np.int32)
                 for p in (pic.u, pic.v)])

    def inter_b(self, w, addr, x0, y0, cur, searched=(2, 1)):
        """A B macroblock: direct (B_Skip where no coefficient survives),
        or the best of L0, L1 and both from each list's motion search over
        its first ``searched`` references, as one 16x16 partition."""
        cands = []
        pred, _ = self.predicted(w, addr, x0, y0)
        cands.append((int(np.abs(cur - pred).sum()) - 64, None, None))
        best = []
        for lst in range(2):
            found = None
            for ref_idx, ref in enumerate(w.lists.refs[lst][:min(w.num_ref[lst], searched[lst])]):
                mvp = w.mv_pred(addr, 0, 0, 16, 16, ref_idx, H.B16X16, 0, lst)
                cost, mv = self.search(w, ref, x0, y0, cur, mvp)
                cost += abs(mv[0] - mvp[0]) + abs(mv[1] - mvp[1]) + 8 * ref_idx
                if found is None or cost < found[0]:
                    found = (cost, ref_idx, mv)
            best.append(found)
        for mode in (1, 2, 3):
            refs = [best[lst][1] if mode >> lst & 1 else -1 for lst in range(2)]
            mvs = [best[lst][2] if mode >> lst & 1 else (0, 0) for lst in range(2)]
            pred, _ = self.predicted(w, addr, x0, y0, refs, mvs)
            cands.append((int(np.abs(cur - pred).sum()) + 16 * bin(mode).count("1"), refs, mvs))
        cost, refs, mvs = min(cands, key=lambda c: c[0])
        if cost > 16 * 16 * 30:
            return None
        pred, self.chroma_pred = self.predicted(w, addr, x0, y0, refs, mvs)
        blocks, cbp, t8 = self.residual_levels(w, cur - pred, w.prm[H.PR_DIRECT_8X8] or refs)
        chroma_levels, chroma_cbp = self.chroma(w, x0 // 2, y0 // 2, False)
        blocks.update(chroma_levels)
        cbp |= chroma_cbp << 4
        block = lambda cat, comp, r, n: blocks[(cat, comp, r)]  # noqa: E731
        if refs is None:
            return Plan(skip=True) if cbp == 0 else Plan(mb_type=0, cbp=cbp, t8=t8, block=block)
        mode = (refs[0] >= 0) | (refs[1] >= 0) << 1
        return Plan(mb_type=mode, refs=iter([refs[lst] for lst in range(2)
                                             if refs[lst] >= 0 and w.num_ref[lst] > 1]),
                    mvs=iter([mvs[lst] for lst in range(2) if refs[lst] >= 0]), cbp=cbp,
                    t8=t8, block=block)

    def residual_levels(self, w, res, t8_allowed=True):
        """The luma levels of an inter residual keyed as ``block`` asks for
        them, its luma coded_block_pattern, and transform_size_8x8_flag."""
        qp = w.qp
        blocks = {}
        t8 = int(bool(w.t8_mode and t8_allowed))
        cbp = 0
        if t8:
            ls = w.ls8[1][qp % 6]
            for b8 in range(4):
                bx, by = 8 * (b8 & 1), 8 * (b8 >> 1)
                lv = self.q.levels("8x8", ls, qp, res[by:by + 8, bx:bx + 8], 0.2)
                if np.any(lv):
                    cbp |= 1 << b8
                blocks[(5, 0, H.BLK_RASTER[4 * b8])] = list(lv)
                for k in range(4):  # CAVLC's four interleaved 4x4 blocks
                    blocks[(2, 0, H.BLK_RASTER[4 * b8 + k])] = list(lv[k::4])
        else:
            ls = w.ls4[3][qp % 6]
            for r in range(16):
                bx, by = 4 * (r & 3), 4 * (r >> 2)
                lv = self.q.levels("4x4", ls, qp, res[by:by + 4, bx:bx + 4], 0.2)
                if np.any(lv):
                    cbp |= 1 << ((r >> 3) * 2 + ((r & 3) >> 1))
                blocks[(2, 0, r)] = list(lv)
        return blocks, cbp, t8


# -- containers -------------------------------------------------------------------------

def write_mp4(path, packets, keys, width, height, rate, avcc, entry=b"avc1", offsets=None,
              media_time=None):
    """An MP4 of ``packets`` whose sample entry is ``entry`` with ``avcC``
    (the port's writer, its ``mp4v`` entry and ``esds`` replaced); with
    ``offsets`` (each sample's composition offset, in frames) a ``ctts``
    box after ``stts``, and the edit's media time ``media_time`` frames
    (FFmpeg's mov muxer writes the first sample's offset there)."""
    class AvcWriter(mp4.Writer):
        def _esds(self):
            return mp4._box(b"avcC", self.config) if self.config is not None else b""

    buf = io.BytesIO()
    writer = AvcWriter(buf, width, height, rate, avcc)
    for packet, key in zip(packets, keys):
        writer.write(packet, key)
    writer.close()
    data = buf.getvalue()
    at = data.index(b"mp4v", data.index(b"stsd"))
    data = data[:at] + entry + data[at + 4:]
    if offsets is not None:
        runs = []
        for off in offsets:
            if runs and runs[-1][1] == off * writer.delta:
                runs[-1][0] += 1
            else:
                runs.append([1, off * writer.delta])
        ctts = mp4._full_box(b"ctts", 0, 0, struct.pack(">I", len(runs)) + b"".join(
            struct.pack(">II", n, v) for n, v in runs))

        def edit(kind, payload):
            if kind == b"stbl":
                stts = next(a + n for k, a, n in mp4.boxes(payload, 0, len(payload))
                            if k == b"stts")
                return payload[:stts] + ctts + payload[stts:]
            if kind == b"elst":
                return payload[:12] + struct.pack(">i", (media_time or 0) * writer.delta) + \
                    payload[16:]
            return payload

        moov = data.rindex(b"moov") - 4
        data = data[:moov] + _rewrite(data[moov:], edit)
    Path(path).write_bytes(data)


_CONTAINERS = (b"moov", b"trak", b"edts", b"mdia", b"minf", b"stbl")


def _rewrite(buf, edit):
    """The boxes of ``buf``, each container's boxes rewritten first, each
    payload through ``edit(kind, payload)``, the sizes set anew."""
    out = b""
    for kind, at, size in mp4.boxes(buf, 0, len(buf)):
        payload = buf[at:at + size]
        if kind in _CONTAINERS:
            payload = _rewrite(payload, edit)
        payload = edit(kind, payload)
        out += struct.pack(">I4s", 8 + len(payload), kind) + payload
    return out


def write_avi(path, packets, keys, width, height, rate, fourcc=b"H264", extradata=b""):
    """An AVI of ``packets`` tagged ``fourcc`` with ``extradata`` after
    ``strf``'s BITMAPINFOHEADER."""
    num, den = rate
    frames = len(packets)

    def chunk(kind, payload):
        return kind + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) & 1
                                                                    else b"")

    def lst(kind, payload):
        return b"LIST" + struct.pack("<I", len(payload) + 4) + kind + payload

    big = max((len(p) for p in packets), default=0)
    avih = struct.pack("<14I", int(round(1e6 * den / num)), 0, 0, 0x910, frames, 0, 1, big,
                       width, height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0, den, num, 0, frames,
                       big, 0xFFFFFFFF, 0, 0, 0, width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40 + len(extradata), width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0) + extradata
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) +
                                                  chunk(b"strf", strf)))
    movi = b""
    index = b""
    for p, key in zip(packets, keys):
        index += b"00dc" + struct.pack("<III", 0x10 if key else 0, 4 + len(movi), len(p))
        movi += chunk(b"00dc", p)
    body = b"AVI " + hdrl + lst(b"movi", movi) + chunk(b"idx1", index)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


def rate_of(fps):
    f = fractions.Fraction(fps).limit_denominator(1001)
    return f.numerator, f.denominator
