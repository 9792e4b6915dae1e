"""Write the H.264 fixtures of ``tests/image_fixtures/`` and cv2's reading
of them in ``digests.json`` (beside the other video fixtures).

The streams are written by ``h264_encode.py`` (the bundled libavcodec has
no H.264 encoder).  Small files (at most 96x128, a few pictures each),
each aimed at a group of tools, together cover every one the port reads:

* ``h264_baseline_cavlc.avi``: Constrained Baseline CAVLC, 80x48 (an odd
  number of macroblocks a row), every I and P macroblock type and sub type
  (I_PCM, P_8x8ref0), three references, QP changes that wrap, POC type 2,
  AUD, filler and SVC prefix NAL units;
* ``h264_main_cabac.mp4``: Main CABAC in ``avc1`` with 2-byte NAL lengths,
  cabac_init_idc 0, 1 and 2, I_PCM, constrained intra prediction;
* ``h264_high_8x8_cabac.mp4`` and ``h264_high_8x8_cavlc.avi`` (``X264``):
  the 8x8 transform (intra 8x8 and inter) under custom scaling matrices
  (the SPS's with fall-back rule A, the PPS's with rule B; the PPS's alone
  with rule A);
* ``h264_slices.avi`` and ``h264_slices_cabac.mp4`` (``avc3``): three
  slices a picture, deblocking idc 0, 1 and 2 with offsets, POC type 1;
* ``h264_weighted.mp4``: explicit weighted P;
* ``h264_long_term.avi`` (16 references) and ``h264_mmco_cabac.mp4``:
  MMCO 1-6, long-term references, reference list modification (short and
  long), non-reference pictures;
* ``h264_hier_p.avi`` and ``h264_hier_p_restrict.avi``: P pictures whose
  POC order differs from their decoding order, without VUI (libavcodec
  grows its delay and drops what comes too late) and with
  ``bitstream_restriction``;
* ``h264_crop.mp4`` (cropped to 70x44), ``h264_full_range.avi`` (VUI
  ``video_full_range_flag`` and a colour description),
  ``h264_vui_timing.mp4`` (VUI timing of 50 fps in a 25 fps file),
  ``h264_recovery_sei.avi`` (a non-IDR I picture first, with a recovery
  point SEI), ``h264_params_strf.avi`` (two SPS and PPS ids, CAVLC and
  CABAC pictures, the parameter sets only in ``strf``'s extradata);
* ``h264_clip_96x128.mp4``: a pan coded from pictures, for both CLIs;
* ``h264_cabac_idc1_8x8.avi``: CABAC P and B slices of cabac_init_idc 1
  under the 8x8 transform.

B slices (``h264_b_*``): ``h264_b_{cavlc,cabac}_inf{0,1}``: every B
macroblock and sub type, B_Skip, spatial and temporal direct under
direct_8x8_inference 0 and 1, weighted_bipred_idc 0-2 (one PPS each), a
pyramid, under both coders; ``h264_b_lists.avi`` and
``h264_b_lists_cabac.mp4``: long-term pictures in both lists, L0 and L1
modifications, L1 equal to L0 (swapped), more than one L1 reference, an L1
longer than the references, MMCO 1 in a reference B picture;
``h264_b_mixed.avi``: P and B slices in one picture; ``h264_b_pyramid_*``:
the delay cv2 finds for a pyramid without VUI, with VUI and with
``bitstream_restriction``, in AVI and in MP4 with and without ``ctts``;
``h264_b_ctts.mp4`` and ``h264_b_ctts_late.mp4``: composition times and an
edit at the first offset, and a frame later (cv2 drops a picture).

Files as devices write them, for ``chip_smoke.py`` phases 27 and 28: the
24-frame 720x1280 pan of phase 25 as High-profile CABAC MP4 (motion search,
8x8 transform, three references, deblocking) and in x264's default GOP (3 B
frames under a pyramid, spatial direct, implicit weights, ``ctts``), and
480x640 AVIs: Constrained Baseline CAVLC, and Main CAVLC with two B frames
(temporal direct, explicit weights).  Refused, made by hand: SP and
data-partitioned slices, field coding, 4:2:2, 10 bits, slice groups,
redundant pictures, HEVC's ``hvc1`` and ``hev1``.

Each readable fixture is also decoded by the port's plain loop and by the
bundled libavcodec (``tests/mpeg4_oracle.py``); the script stops if they
differ.  Run from the repository root on a machine with cv2:
``python3 probe/make_h264_fixtures.py [name ...]`` (names: only those).
"""

import hashlib
import json
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "image_fixtures"
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "probe")]
import h264_encode as E  # noqa: E402
import mpeg4_oracle  # noqa: E402
from make_video_fixtures import pan  # noqa: E402

from orienmask_tpu_torch.data import h264 as H  # noqa: E402
from orienmask_tpu_torch.data import video, yuv  # noqa: E402

I, P, B = H.I_SLICE, H.P_SLICE, H.B_SLICE
ALL_I = {"I4": 2, "I16": 2, "PCM": 0.15}
ALL_P = {"P16x16": 2, "P16x8": 1, "P8x16": 1, "P8x8": 1.5, "skip": 2, "intra": 0.6}
CHIP_MP4 = "h264_high_cabac_720x1280.mp4"
CHIP_AVI = "h264_baseline_480x640.avi"
CHIP_AVI_FRAMES = 16


class Seq:
    """Pictures of one stream in decoding order, keeping frame_num and POC."""

    def __init__(self, stream, mb_w, mb_h):
        self.st = stream
        self.mb_w, self.mb_h = mb_w, mb_h
        self.frame_num = 0
        self.count = 0

    def pic(self, typ, chooser, idr=False, ref=1, slices=1, poc=None, per=None, pps_id=0,
            **kw):
        sps = self.st.sps
        sei = kw.pop("sei_rbsp", None)
        if idr:
            self.frame_num = 0
        n = self.mb_w * self.mb_h
        bounds = [round(k * n / slices) for k in range(slices + 1)]
        poc = 2 * self.count if poc is None else poc
        pps = self.st.ppss[pps_id]
        default = pps.get("num_ref_idx_default", 1)
        out = []
        for k in range(slices):
            c = dict(kw)
            if per is not None:
                c.update(per(self.count, k))
            have = len(self.st.dec.dpb)
            if typ in (P, B) and "num_ref" not in c and have < default:
                c["num_ref"] = have
            if typ == B and "num_ref1" not in c and have < pps.get("num_ref_idx_default1", 1):
                c["num_ref1"] = have
            out.append(E.Cfg(first_mb=bounds[k], last_mb=bounds[k + 1] - 1,
                             slice_type=c.pop("slice_type", typ),
                             frame_num=self.frame_num % (1 << sps.get("log2_max_frame_num", 4)),
                             poc_lsb=poc % (1 << sps.get("log2_max_poc_lsb", 6)),
                             qp=c.pop("qp", 26), **c))
        self.st.picture(out, chooser, idr=idr, nal_ref_idc=ref, pps_id=pps_id, sei=sei)
        self.frame_num += ref
        self.count += 1


def _cfg_stream(mb_w, mb_h, sps_kw, ppss, annexb=True, headers_in_band=True):
    sps = E.Cfg(mb_w=mb_w, mb_h=mb_h, **sps_kw)
    st = E.Stream(sps, [E.Cfg(**p) for p in ppss], annexb=annexb,
                  headers_in_band=headers_in_band)
    return st, Seq(st, mb_w, mb_h)


def avi(name, st, fps=25, fourcc=b"H264", extradata=b""):
    packets = st.finish()
    E.write_avi(OUT / name, packets, st.keys, 16 * st.sps.mb_w - _crop_w(st.sps),
                16 * st.sps.mb_h - _crop_h(st.sps), E.rate_of(fps), fourcc, extradata)
    return packets


def mp4_file(name, st, fps=25, entry=b"avc1", length_size=4, offsets=None, media_time=None):
    packets = st.finish()
    if length_size != 4:
        packets = [_relength(p, length_size) for p in packets]
    avcc = st.avcc()
    avcc = avcc[:4] + bytes([0xFC | (length_size - 1)]) + avcc[5:]
    E.write_mp4(OUT / name, packets, st.keys, 16 * st.sps.mb_w - _crop_w(st.sps),
                16 * st.sps.mb_h - _crop_h(st.sps), E.rate_of(fps), avcc, entry, offsets,
                media_time)
    return packets


def _crop_w(sps):
    crop = sps.get("crop") or (0, 0, 0, 0)
    return crop[0] + crop[1]


def _crop_h(sps):
    crop = sps.get("crop") or (0, 0, 0, 0)
    return crop[2] + crop[3]


def _relength(packet, size):
    out = b""
    pos = 0
    while pos < len(packet):
        n = struct.unpack_from(">I", packet, pos)[0]
        out += n.to_bytes(size, "big") + packet[pos + 4:pos + 4 + n]
        pos += 4 + n
    return out


# -- the small fixtures ------------------------------------------------------------

def baseline_cavlc():
    ch = E.RandomChooser(101, i_kinds=ALL_I, p_kinds={**ALL_P, "P8x8ref0": 0.8}, density=0.15,
                         dqp=0.25)
    st, s = _cfg_stream(5, 3, dict(profile_idc=66, constraint_flags=0xC0, poc_type=2,
                                   max_num_ref_frames=3),
                        [dict(cabac=0, num_ref_idx_default=3)])
    aud = E.nal(0, 9, bytes([0x30]))
    filler = E.nal(0, 12, b"\xff" * 6 + b"\x80")
    prefix = E.nal(3, 14, b"\x80\x00\x00\x80")  # an SVC prefix NAL unit: skipped
    s.pic(I, ch, idr=True)
    for k in range(5):
        s.pic(P, ch)
    # an AUD first, filler in every other access unit, an SVC prefix NAL
    # unit before a slice
    st.packets = [b"\0\0\0\1" + aud + p + (b"\0\0\0\1" + filler if i % 2 else b"")
                  for i, p in enumerate(st.finish())]
    st.packets[2] = st.packets[2].replace(b"\0\0\0\1\x41", b"\0\0\0\1" + prefix +
                                          b"\0\0\0\1\x41", 1)
    st.finish = lambda: st.packets
    avi("h264_baseline_cavlc.avi", st)


def main_cabac():
    ch = E.RandomChooser(102, i_kinds=ALL_I, p_kinds={**ALL_P, "intra": 1.5}, density=0.15,
                         dqp=0.25)
    st, s = _cfg_stream(5, 3, dict(profile_idc=77, poc_type=0, max_num_ref_frames=2),
                        [dict(cabac=1, num_ref_idx_default=2, constrained_intra=1)],
                        annexb=False)
    s.pic(I, ch, idr=True)
    for k in range(5):
        s.pic(P, ch, cabac_init_idc=k % 3)
    mp4_file("h264_main_cabac.mp4", st, length_size=2)


def _custom(seed, n):
    rng = np.random.default_rng(seed)
    return [int(v) for v in np.clip(np.sort(rng.integers(6, 40, n)), 4, 255)]


def high_8x8_cabac():
    ch = E.RandomChooser(103, i_kinds={**ALL_I, "I8": 3}, p_kinds=ALL_P, density=0.15,
                         dqp=0.15, t8=0.7)
    sps_lists = [_custom(1, 16), None, _custom(2, 16), "default", None, _custom(3, 16),
                 _custom(4, 64), None]  # rule A for the absent ones
    pps_lists = [None, _custom(5, 16), None, _custom(6, 16), None, None, None, _custom(7, 64)]
    st, s = _cfg_stream(5, 3, dict(profile_idc=100, poc_type=0, max_num_ref_frames=2,
                                   scaling=sps_lists),
                        [dict(cabac=1, num_ref_idx_default=2, transform_8x8=1,
                              scaling=pps_lists, cb_qp_offset=2, cr_qp_offset=-3)],
                        annexb=False)
    s.pic(I, ch, idr=True)
    for k in range(4):
        s.pic(P, ch, cabac_init_idc=(0, 2)[k % 2])
    mp4_file("h264_high_8x8_cabac.mp4", st)


def high_8x8_cavlc():
    ch = E.RandomChooser(104, i_kinds={**ALL_I, "I8": 3}, p_kinds={**ALL_P, "P8x8ref0": 0.5},
                         density=0.15, dqp=0.15, t8=0.7)
    pps_lists = [_custom(8, 16), None, None, "default", _custom(9, 16), None, _custom(10, 64),
                 "default"]  # rule A: no sequence lists
    st, s = _cfg_stream(5, 3, dict(profile_idc=100, poc_type=2, max_num_ref_frames=2),
                        [dict(cabac=0, num_ref_idx_default=2, transform_8x8=1,
                              scaling=pps_lists, cb_qp_offset=-4, cr_qp_offset=5)])
    s.pic(I, ch, idr=True)
    for k in range(4):
        s.pic(P, ch)
    avi("h264_high_8x8_cavlc.avi", st, fourcc=b"X264")


def _deblock(f, k):
    return dict(deblock_idc=(f + k) % 3, alpha_div2=(3 * k + f) % 13 - 6,
                beta_div2=(5 * f + 2 * k) % 13 - 6, qp=22 + 4 * k)


def slices_cavlc():
    ch = E.RandomChooser(105, i_kinds=ALL_I, p_kinds=ALL_P, density=0.15, dqp=0.2)
    st, s = _cfg_stream(6, 4, dict(profile_idc=77, poc_type=1, max_num_ref_frames=2,
                                   offset_for_ref_frame=[2, 2], offset_non_ref=-1),
                        [dict(cabac=0, num_ref_idx_default=2)])
    s.pic(I, ch, idr=True, slices=3, per=_deblock)
    for k in range(4):
        s.pic(P, ch, slices=3, per=_deblock, ref=int(k != 2), delta_poc0=k % 2)
    avi("h264_slices.avi", st)


def slices_cabac():
    ch = E.RandomChooser(106, i_kinds=ALL_I, p_kinds=ALL_P, density=0.15, dqp=0.2)
    st, s = _cfg_stream(6, 4, dict(profile_idc=77, poc_type=0, max_num_ref_frames=2),
                        [dict(cabac=1, num_ref_idx_default=2)], annexb=False)
    s.pic(I, ch, idr=True, slices=3, per=_deblock)
    for k in range(4):
        s.pic(P, ch, slices=3, per=lambda f, k: {**_deblock(f, k), "cabac_init_idc": k % 3})
    # avc3: the parameter sets travel in band as well
    mp4_file("h264_slices_cabac.mp4", st, entry=b"avc3")


def weighted():
    ch = E.RandomChooser(107, i_kinds=ALL_I, p_kinds=ALL_P, density=0.12)
    st, s = _cfg_stream(5, 3, dict(profile_idc=77, poc_type=0, max_num_ref_frames=2),
                        [dict(cabac=1, weighted_pred=1, num_ref_idx_default=2)],
                        annexb=False)
    s.pic(I, ch, idr=True)
    tables = [(5, 3, [((40, -5), None)]),
              (6, 2, [((70, 10), (3, -2, 5, 4)), (None, (4, 1, 3, -1))]),
              (0, 0, [((1, 3), (2, -4, 0, 9)), ((-1, 20), None)]),
              (7, 7, [((127, -10), (100, 6, 120, -8)), ((90, 0), (127, 0, -128, 0))])]
    for wt in tables:
        s.pic(P, ch, num_ref=len(wt[2]), weights=wt)
    mp4_file("h264_weighted.mp4", st)


def long_term():
    ch = E.RandomChooser(108, i_kinds=ALL_I, p_kinds=ALL_P, density=0.08)
    st, s = _cfg_stream(5, 3, dict(profile_idc=77, poc_type=0, max_num_ref_frames=16,
                                   log2_max_frame_num=5, log2_max_poc_lsb=7),
                        [dict(cabac=0, num_ref_idx_default=1)])
    s.pic(I, ch, idr=True, long_term_reference=1)
    s.pic(P, ch, mmcos=[(4, 4)])
    s.pic(P, ch, num_ref=2, mmcos=[(3, 0, 1)])
    s.pic(P, ch, num_ref=3, modifications=[(2, 0), (0, 0), (2, 1)])
    s.pic(P, ch, num_ref=3, mmcos=[(2, 1), (6, 2)])
    s.pic(P, ch, num_ref=3, mmcos=[(1, 1)], modifications=[(0, 2), (1, 0)])
    for k in range(12):  # the sliding window fills 16 references
        s.pic(P, ch, num_ref=min(16, len(st.dec.dpb)))
    oldest = min(p.frame_num for p in st.dec.dpb if p.ref == "short")
    s.pic(P, ch, num_ref=16, modifications=[(0, s.frame_num - oldest - 1), (2, 2)])
    s.pic(P, ch, num_ref=4, ref=0)
    s.pic(P, ch, num_ref=4, mmcos=[(5,)])
    s.frame_num = 1
    s.count = 0
    s.pic(P, ch, num_ref=1, poc=2)
    s.pic(P, ch, num_ref=2, poc=4)
    avi("h264_long_term.avi", st)


def mmco_cabac():
    ch = E.RandomChooser(109, i_kinds=ALL_I, p_kinds=ALL_P, density=0.1)
    st, s = _cfg_stream(5, 3, dict(profile_idc=77, poc_type=2, max_num_ref_frames=4),
                        [dict(cabac=1, num_ref_idx_default=1)], annexb=False)
    s.pic(I, ch, idr=True)
    s.pic(P, ch, mmcos=[(4, 2), (6, 0)])
    s.pic(P, ch, num_ref=2, modifications=[(2, 0)])
    s.pic(P, ch, num_ref=3, mmcos=[(3, 0, 1)])
    s.pic(P, ch, num_ref=3, ref=0)
    s.pic(P, ch, num_ref=3, mmcos=[(2, 0), (1, 0)])
    s.pic(P, ch, num_ref=2)
    mp4_file("h264_mmco_cabac.mp4", st)


def hierarchical(name, restrict):
    ch = E.RandomChooser(110 + bool(restrict), i_kinds=ALL_I, p_kinds=ALL_P, density=0.1)
    vui = dict(num_reorder_frames=restrict, max_dec_frame_buffering=3) if restrict else None
    st, s = _cfg_stream(5, 3, dict(profile_idc=77, poc_type=0, log2_max_poc_lsb=8,
                                   max_num_ref_frames=3, vui=vui),
                        [dict(cabac=1, num_ref_idx_default=1)])
    s.pic(I, ch, idr=True)
    for disp, ref in ((4, 1), (2, 1), (1, 0), (3, 0), (8, 1), (6, 1), (5, 0), (7, 0),
                      (12, 1), (10, 1), (9, 0), (11, 0)):
        s.pic(P, ch, ref=ref, poc=2 * disp, num_ref=min(3, len(st.dec.dpb)))
    avi(name, st)


def crop():
    ch = E.RandomChooser(112, i_kinds=ALL_I, p_kinds=ALL_P, density=0.12)
    st, s = _cfg_stream(5, 3, dict(profile_idc=77, poc_type=0, max_num_ref_frames=1,
                                   crop=(0, 10, 2, 2)), [dict(cabac=1)], annexb=False)
    s.pic(I, ch, idr=True)
    for k in range(3):
        s.pic(P, ch)
    mp4_file("h264_crop.mp4", st)


def full_range():
    ch = E.RandomChooser(113, i_kinds=ALL_I, p_kinds=ALL_P, density=0.12)
    st, s = _cfg_stream(5, 3, dict(profile_idc=66, poc_type=2, max_num_ref_frames=1,
                                   vui=dict(full_range=1, colour=(1, 1, 1))), [dict(cabac=0)])
    s.pic(I, ch, idr=True)
    for k in range(3):
        s.pic(P, ch)
    avi("h264_full_range.avi", st)


def vui_timing():
    ch = E.RandomChooser(114, i_kinds=ALL_I, p_kinds=ALL_P, density=0.12)
    st, s = _cfg_stream(5, 3, dict(profile_idc=77, poc_type=2, max_num_ref_frames=1,
                                   vui=dict(timing=(1, 100, 1), colour=(6, 6, 6))),
                        [dict(cabac=1)], annexb=False)
    s.pic(I, ch, idr=True)
    for k in range(3):
        s.pic(P, ch)
    mp4_file("h264_vui_timing.mp4", st, fps=25)


def recovery_sei():
    ch = E.RandomChooser(115, i_kinds=ALL_I, p_kinds=ALL_P, density=0.12)
    st, s = _cfg_stream(5, 3, dict(profile_idc=77, poc_type=2, max_num_ref_frames=2),
                        [dict(cabac=0, num_ref_idx_default=2)])
    s.frame_num = 5
    s.count = 3
    s.pic(I, ch, sei_rbsp=E.recovery_point_sei(0))
    for k in range(4):
        s.pic(P, ch)
    avi("h264_recovery_sei.avi", st)


def params_strf():
    """Two SPS and PPS ids; the parameter sets only in strf."""
    ch = E.RandomChooser(116, i_kinds=ALL_I, p_kinds=ALL_P, density=0.12)
    sps = E.Cfg(profile_idc=77, id=3, mb_w=5, mb_h=3, poc_type=2, max_num_ref_frames=2)
    ppss = [E.Cfg(id=0, sps_id=3, cabac=0, num_ref_idx_default=2),
            E.Cfg(id=7, sps_id=3, cabac=1, num_ref_idx_default=1, init_qp=30)]
    st = E.Stream(sps, ppss, headers_in_band=False)
    s = Seq(st, 5, 3)
    s.pic(I, ch, idr=True, pps_id=7)
    for k in range(4):
        s.pic(P, ch, pps_id=(0, 7)[k % 2])
    extradata = b"".join(b"\0\0\0\1" + n for n in st.param_nals)
    avi("h264_params_strf.avi", st, extradata=extradata)


# -- B slices ----------------------------------------------------------------------

ALL_B = {"direct": 2, "B16x16": 3, "B16x8": 2, "B8x16": 2, "B8x8": 3, "skip": 2, "intra": 0.5}


def random_weights(rng, n0, n1):
    """A B slice's pred_weight_table: denominators below 7 and weights of
    -20..63, so that each pair's sum stays within -128..128 (7.4.3.2);
    about a third of the entries left at their defaults."""
    def entry():
        luma = None if rng.random() < 0.3 else (int(rng.integers(-20, 64)),
                                                int(rng.integers(-20, 21)))
        chroma = None if rng.random() < 0.3 else tuple(
            int(v) for _ in range(2) for v in (rng.integers(-20, 64), rng.integers(-20, 21)))
        return luma, chroma
    return (int(rng.integers(0, 7)), int(rng.integers(0, 7)), [entry() for _ in range(n0)],
            [entry() for _ in range(n1)])


def b_pictures(st, s, ch, rng, gops, pps_ids=(0,), spatial=(1, 0), idcs=(0,), refs=2):
    """An IDR picture, then ``gops`` mini-GOPs of a P and three B pictures
    (a pyramid: the middle B a reference, coded first), each B picture
    taking the next of ``pps_ids``, direct modes (``spatial``) and
    cabac_init_idc values, with up to ``refs`` references in each list
    (random explicit weights under a PPS of weighted_bipred_idc 1)."""
    s.pic(I, ch, idr=True, poc=0)
    k = 0
    for g in range(gops):
        base = 4 * g
        s.pic(P, ch, poc=2 * (base + 4), cabac_init_idc=idcs[g % len(idcs)],
              pps_id=pps_ids[g % len(pps_ids)])
        for disp, ref in ((base + 2, 1), (base + 1, 0), (base + 3, 0)):
            pps_id = pps_ids[k % len(pps_ids)]
            have = len(st.dec.dpb)
            kw = dict(direct_spatial=spatial[k % len(spatial)], cabac_init_idc=idcs[k % len(idcs)],
                      num_ref=min(refs, have), num_ref1=min(refs, have))
            if st.ppss[pps_id].get("weighted_bipred") == 1:
                kw["weights"] = random_weights(rng, kw["num_ref"], kw["num_ref1"])
            s.pic(B, ch, ref=ref, poc=2 * disp, pps_id=pps_id, **kw)
            k += 1


def _b_ppss(cabac, t8=None, **kw):
    """Three PPSs, ids 0-2, of weighted_bipred_idc 0, 1 and 2."""
    return [dict(id=w, cabac=cabac, num_ref_idx_default=2, num_ref_idx_default1=2,
                 weighted_bipred=w, transform_8x8=t8, **kw) for w in range(3)]


def b_coverage(name, cabac, infer, t8, seed):
    """Every B macroblock and sub type, B_Skip, spatial and temporal direct
    (alternating by picture) under ``infer`` (direct_8x8_inference), the
    three weighted_bipred_idc (by PPS), cabac_init_idc 0-2, a pyramid."""
    ch = E.RandomChooser(seed, i_kinds=ALL_I, p_kinds=ALL_P, b_kinds=ALL_B, density=0.12,
                         dqp=0.15, t8=0.6)
    st, s = _cfg_stream(8, 6, dict(profile_idc=100 if t8 else 77, poc_type=0,
                                   max_num_ref_frames=4, direct_8x8_inference=infer,
                                   log2_max_poc_lsb=8),
                        _b_ppss(cabac, t8), annexb=not name.endswith(".mp4"))
    b_pictures(st, s, ch, np.random.default_rng(seed), 2, pps_ids=(0, 1, 2, 1, 2, 0),
               idcs=(0, 1, 2))
    if name.endswith(".mp4"):
        mp4_file(name, st)
    else:
        avi(name, st)


def b_lists(name, cabac, seed):
    """The reference lists of B slices: a long-term picture in both lists
    (with temporal direct's unscaled vector and implicit weights' 32/32),
    an L1 whose first entry is long-term, L0 and L1 modifications, L1
    equal to L0 (swapped), more than one L1 reference, an L1 longer than
    the references (FFmpeg's default fill), a reference B picture with
    MMCO 1, a co-located block whose reference is not in L0."""
    ch = E.RandomChooser(seed, i_kinds=ALL_I, p_kinds=ALL_P, b_kinds=ALL_B, density=0.1,
                         dqp=0.1)
    ppss = [dict(id=0, cabac=cabac, num_ref_idx_default=3, num_ref_idx_default1=3,
                 weighted_bipred=2),
            dict(id=1, cabac=cabac, num_ref_idx_default=2, num_ref_idx_default1=2)]
    st, s = _cfg_stream(5, 3, dict(profile_idc=77, poc_type=0, max_num_ref_frames=5,
                                   log2_max_poc_lsb=8), ppss, annexb=not name.endswith(".mp4"))
    s.pic(I, ch, idr=True, poc=0, long_term_reference=1)
    s.pic(P, ch, poc=8)
    s.pic(B, ch, ref=0, poc=4, num_ref=2, num_ref1=3, direct_spatial=1, pps_id=1)  # filled
    s.pic(P, ch, poc=16, num_ref=2)
    s.pic(B, ch, ref=1, poc=12, num_ref=3, num_ref1=3, direct_spatial=0)
    s.pic(B, ch, ref=0, poc=10, num_ref=3, num_ref1=2, modifications1=[(2, 0)],
          direct_spatial=1)
    s.pic(B, ch, ref=0, poc=14, num_ref=1, num_ref1=2, modifications=[(0, 0)],
          modifications1=[(0, 1), (0, 0)], direct_spatial=0, pps_id=1)
    target = min((p for p in st.dec.dpb if p.ref == "short"), key=lambda p: p.poc).frame_num
    s.pic(B, ch, ref=1, poc=20, num_ref=2, num_ref1=2, direct_spatial=0,
          mmcos=[(1, s.frame_num - target - 1)])
    s.pic(B, ch, ref=0, poc=24, num_ref=3, num_ref1=3, direct_spatial=1)  # L1 = L0: swapped
    s.pic(B, ch, ref=0, poc=26, num_ref=3, num_ref1=1, direct_spatial=0, pps_id=1)
    if name.endswith(".mp4"):
        mp4_file(name, st)
    else:
        avi(name, st)


def b_mixed():
    """P and B slices in one picture (three slices a picture, deblocking
    across them), reference and not, the B pictures after them spatial."""
    ch = E.RandomChooser(131, i_kinds=ALL_I, p_kinds=ALL_P, b_kinds=ALL_B, density=0.12)
    st, s = _cfg_stream(6, 4, dict(profile_idc=77, poc_type=0, max_num_ref_frames=3,
                                   log2_max_poc_lsb=8),
                        [dict(id=0, cabac=0, num_ref_idx_default=2, num_ref_idx_default1=2),
                         dict(id=1, cabac=1, num_ref_idx_default=2, num_ref_idx_default1=2,
                              weighted_bipred=2)])
    s.pic(I, ch, idr=True, poc=0)
    s.pic(P, ch, poc=12)

    def mixed(types):
        return lambda f, k: dict(slice_type=types[k], direct_spatial=1, num_ref=2,
                                 num_ref1=2, deblock_idc=0, qp=24 + 3 * k)

    for pps_id in (0, 1):
        base = 12 * pps_id
        s.pic(P, ch, poc=2 * base + 8, ref=1, slices=3, per=mixed((B, P, B)), pps_id=pps_id)
        s.pic(P, ch, poc=2 * base + 4, ref=0, slices=3, per=mixed((P, B, P)), pps_id=pps_id)
        s.pic(B, ch, poc=2 * base + 16, ref=0, num_ref=2, num_ref1=2, pps_id=pps_id)
        s.pic(P, ch, poc=2 * base + 24, num_ref=2, pps_id=pps_id)
    avi("h264_b_mixed.avi", st)


def b_pyramid(name, vui, offsets=False):
    """A B pyramid whose delay cv2 finds without VUI (guessed), with VUI but
    no bitstream_restriction, and with max_num_reorder_frames; in MP4 with
    or without composition offsets (cv2's probe reads further with)."""
    ch = E.RandomChooser(140 + len(name), i_kinds=ALL_I, p_kinds=ALL_P, b_kinds=ALL_B,
                         density=0.1)
    st, s = _cfg_stream(5, 3, dict(profile_idc=77, poc_type=0, max_num_ref_frames=3,
                                   log2_max_poc_lsb=8, vui=vui),
                        [dict(cabac=int(name.endswith(".mp4")), num_ref_idx_default=2,
                              num_ref_idx_default1=1)], annexb=not name.endswith(".mp4"))
    b_pictures(st, s, ch, None, 3)
    if name.endswith(".mp4"):
        cts = [d + 2 - i for i, (d, _, _) in enumerate(b_order(13, 3, True))] if offsets else None
        mp4_file(name, st, offsets=cts, media_time=cts and cts[0])
    else:
        avi(name, st)


def b_ctts(name, late):
    """A B-frame MP4 as FFmpeg's mov muxer writes one: ctts, and the edit at
    the first composition offset (``late`` frames after it: cv2 drops the
    pictures shown before the edit)."""
    content_stream_b(pan(26, 96, 128, 8, 2, 1),  # h264_clip_96x128.mp4's scene
                     dict(profile_idc=100, poc_type=0, max_num_ref_frames=4,
                          log2_max_poc_lsb=8, vui=dict(num_reorder_frames=2,
                                                       max_dec_frame_buffering=4)),
                     dict(cabac=1, transform_8x8=1, num_ref_idx_default=2, weighted_bipred=2),
                     name, 25, qp=28, window=4, b_kw=dict(direct_spatial=1), late=late)


def cabac_idc1_8x8():
    """CABAC P and B slices of cabac_init_idc 1 under the 8x8 transform
    (ctxIdx 417-435 of that column)."""
    ch = E.RandomChooser(150, i_kinds={**ALL_I, "I8": 2}, p_kinds=ALL_P, b_kinds=ALL_B,
                         density=0.15, t8=0.8)
    st, s = _cfg_stream(5, 3, dict(profile_idc=100, poc_type=0, max_num_ref_frames=3,
                                   log2_max_poc_lsb=8),
                        [dict(cabac=1, transform_8x8=1, num_ref_idx_default=2,
                              num_ref_idx_default1=2)])
    b_pictures(st, s, ch, None, 2, idcs=(1,))
    avi("h264_cabac_idc1_8x8.avi", st)


def content_stream(frames, sps_kw, pps_kw, name, fps, slices_qp=26, container="mp4",
                   window=8, fourcc=b"H264", gop=None):
    """A stream coded from RGB ``frames`` (ContentChooser)."""
    h, w = frames[0].shape[:2]
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    crop = (0, 16 * mb_w - w, 0, 16 * mb_h - h)
    sps_kw = dict(sps_kw)
    if any(crop):
        sps_kw["crop"] = crop
    st, s = _cfg_stream(mb_w, mb_h, sps_kw, [pps_kw], annexb=(container == "avi"))
    ch = E.ContentChooser(window=window)
    for k, frame in enumerate(frames):
        padded = np.pad(frame, ((0, 16 * mb_h - h), (0, 16 * mb_w - w), (0, 0)), mode="edge")
        ch.frame = yuv.rgb_to_yuv420_py(padded)
        if k == 0 or (gop and k % gop == 0):
            s.pic(I, ch, idr=True, qp=slices_qp - 2)
        else:
            s.pic(P, ch, qp=slices_qp)
        print(f"  {name}: picture {k} coded", flush=True)
    if container == "mp4":
        return mp4_file(name, st, fps=fps)
    return avi(name, st, fps=fps, fourcc=fourcc)


def b_order(n, bframes, pyramid):
    """(display index, slice type, nal_ref_idc) of ``n`` frames in decoding
    order: the I frame, then each P frame and the B frames shown before it
    (under a pyramid the middle one first, a reference, as x264's default
    b-pyramid codes three)."""
    out = [(0, I, 1)]
    d = 0
    while d < n - 1:
        p = min(d + bframes + 1, n - 1)
        out.append((p, P, 1))
        bs = list(range(d + 1, p))
        mid = bs[len(bs) // 2] if pyramid and len(bs) >= 3 else None
        if mid is not None:
            out.append((mid, B, 1))
        out += [(b, B, 0) for b in bs if b != mid]
        d = p
    return out


def content_stream_b(frames, sps_kw, pps_kw, name, fps, qp=26, container="mp4", window=8,
                     bframes=3, pyramid=True, b_kw=None, late=0):
    """A stream of I, P and B frames coded from RGB ``frames``
    (ContentChooser) in ``b_order``; in MP4 with each sample's composition
    offset (``ctts``) and the edit at the first one, ``late`` frames
    later."""
    h, w = frames[0].shape[:2]
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    sps_kw = dict(sps_kw)
    crop = (0, 16 * mb_w - w, 0, 16 * mb_h - h)
    if any(crop):
        sps_kw["crop"] = crop
    st, s = _cfg_stream(mb_w, mb_h, sps_kw, [pps_kw], annexb=(container == "avi"))
    ch = E.ContentChooser(window=window)
    order = b_order(len(frames), bframes, pyramid)
    for k, (display, typ, ref) in enumerate(order):
        padded = np.pad(frames[display], ((0, 16 * mb_h - h), (0, 16 * mb_w - w), (0, 0)),
                        mode="edge")
        ch.frame = yuv.rgb_to_yuv420_py(padded)
        s.pic(typ, ch, idr=display == 0, ref=ref, poc=2 * display,
              qp=qp - 2 if typ == I else qp + 2 * (typ == B), **(b_kw or {} if typ == B else {}))
        print(f"  {name}: picture {k} (frame {display}, {'IPB'[(I, P, B).index(typ)]}) coded",
              flush=True)
    delay = max(i - d for i, (d, _, _) in enumerate(order))
    offsets = [d + delay - i for i, (d, _, _) in enumerate(order)]
    if container == "avi":
        return avi(name, st, fps=fps)
    return mp4_file(name, st, fps=fps, offsets=offsets, media_time=offsets[0] + late)


def clip():
    content_stream(pan(26, 96, 128, 8, 2, 1), dict(profile_idc=100, poc_type=0,
                                                   max_num_ref_frames=2),
                   dict(cabac=1, transform_8x8=1, num_ref_idx_default=2),
                   "h264_clip_96x128.mp4", 25)


def chip_mp4():
    content_stream(pan(25, 720, 1280, 24, 6, 2), dict(profile_idc=100, level_idc=31,
                                                      poc_type=0, max_num_ref_frames=3,
                                                      log2_max_poc_lsb=8),
                   dict(cabac=1, transform_8x8=1, num_ref_idx_default=3),
                   CHIP_MP4, 25, slices_qp=30, window=6)


def chip_avi():
    content_stream(pan(37, 480, 640, CHIP_AVI_FRAMES, 4, 2),
                   dict(profile_idc=66, constraint_flags=0xC0, level_idc=30, poc_type=2,
                        max_num_ref_frames=1), dict(cabac=0), CHIP_AVI, 30, slices_qp=30,
                   container="avi", window=6)


CHIP_B_MP4 = "h264_b_cabac_720x1280.mp4"
CHIP_B_AVI = "h264_b_cavlc_480x640.avi"


def chip_b_mp4():
    """x264's default GOP shape: 3 B frames under a pyramid, spatial direct,
    implicit weighted bi-prediction, the 8x8 transform, High CABAC; in MP4
    with ctts and the edit at the first composition offset."""
    content_stream_b(pan(25, 720, 1280, 24, 6, 2),
                     dict(profile_idc=100, level_idc=31, poc_type=0, max_num_ref_frames=4,
                          log2_max_poc_lsb=8, vui=dict(num_reorder_frames=2,
                                                       max_dec_frame_buffering=4)),
                     dict(cabac=1, transform_8x8=1, num_ref_idx_default=2, weighted_bipred=2),
                     CHIP_B_MP4, 25, qp=30, window=6, b_kw=dict(direct_spatial=1))


def chip_b_avi():
    """Main CAVLC, two B frames between P frames, temporal direct, explicit
    weighted bi-prediction, in the scene of phase 26's MJPEG file."""
    content_stream_b(pan(37, 480, 640, CHIP_AVI_FRAMES, 4, 2),
                     dict(profile_idc=77, level_idc=30, poc_type=0, max_num_ref_frames=2,
                          vui=dict(num_reorder_frames=1, max_dec_frame_buffering=2)),
                     dict(cabac=0, weighted_bipred=1), CHIP_B_AVI, 30, qp=30, container="avi",
                     window=6, bframes=2, pyramid=False,
                     b_kw=dict(direct_spatial=0, weights=(5, 3, [((34, -3), (8, 1, 8, -1))],
                                                          [((30, 2), None)])))


# -- refused ---------------------------------------------------------------------------

def _slice_nal(kind, slice_type, first_mb=0, frame_num=1, extra=None, ref_idc=1, pps_id=0):
    w = E.BitWriter()
    w.ue(first_mb)
    w.ue(slice_type)
    w.ue(pps_id)
    w.u(4, frame_num)
    if extra:
        extra(w)
    w.trailing()
    return E.nal(ref_idc, kind, w.rbsp() + bytes(8))


def _sps_by_hand(profile, chroma=1, depth=8, frame_mbs_only=1):
    w = E.BitWriter()
    w.u(8, profile)
    w.u(8, 0)
    w.u(8, 40)
    w.ue(0)
    if profile in H.HIGH_PROFILES:
        w.ue(chroma)
        if chroma == 3:
            w.bit(0)
        w.ue(depth - 8)
        w.ue(depth - 8)
        w.bit(0)
        w.bit(0)
    w.ue(0)  # log2_max_frame_num - 4
    w.ue(2)  # POC type 2
    w.ue(1)
    w.bit(0)
    w.ue(1)
    w.ue(1)
    w.bit(frame_mbs_only)
    if not frame_mbs_only:
        w.bit(0)
    w.bit(1)
    w.bit(0)
    w.bit(0)
    w.trailing()
    return E.nal(3, 7, w.rbsp())


def refused():
    pps = E.nal(3, 8, E.pps_rbsp(E.Cfg(cabac=0)))
    base = E.Cfg(profile_idc=77, mb_w=2, mb_h=2, poc_type=2, max_num_ref_frames=1)

    def good_stream(pps_cfg=None, sps_cfg=None):
        ch = E.RandomChooser(121, i_kinds={"I16": 1}, p_kinds={"P16x16": 1}, density=0.1)
        st = E.Stream(sps_cfg or base, [pps_cfg or E.Cfg(cabac=0)])
        st.picture([E.Cfg(first_mb=0, last_mb=3, slice_type=I, frame_num=0, qp=26)], ch,
                   idr=True)
        return st

    def write(name, packets, container="avi", tag=b"H264", size=(32, 32)):
        keys = [True] + [False] * (len(packets) - 1)
        if container == "avi":
            E.write_avi(OUT / name, packets, keys, *size, (25, 1), tag)
        else:
            avcc = bytes([1, 77, 0, 40, 0xFF, 0xE0, 0])
            E.write_mp4(OUT / name, packets, keys, *size, (25, 1), avcc, tag)

    st = good_stream()
    write("h264_sp_slice.avi", st.finish() + [b"\0\0\0\1" + _slice_nal(1, 3)])
    st = good_stream()
    write("h264_partitioned.avi", st.finish() + [b"\0\0\0\1" + E.nal(1, 2, b"\x88\x80" +
                                                                    bytes(8))])
    write("h264_field.avi", [b"\0\0\0\1" + _sps_by_hand(77, frame_mbs_only=0) + b"\0\0\0\1" +
                             pps + b"\0\0\0\1" + _slice_nal(5, 7, frame_num=0)])
    write("h264_422.avi", [b"\0\0\0\1" + _sps_by_hand(122, chroma=2) + b"\0\0\0\1" + pps +
                           b"\0\0\0\1" + _slice_nal(5, 7, frame_num=0)])
    write("h264_10bit.avi", [b"\0\0\0\1" + _sps_by_hand(110, depth=10) + b"\0\0\0\1" + pps +
                             b"\0\0\0\1" + _slice_nal(5, 7, frame_num=0)])
    fmo = E.nal(3, 8, E.pps_rbsp(E.Cfg(cabac=0, num_slice_groups=2)))
    write("h264_fmo.avi", [b"\0\0\0\1" + _sps_by_hand(66) + b"\0\0\0\1" + fmo + b"\0\0\0\1" +
                           _slice_nal(5, 7, frame_num=0)])
    st = good_stream(E.Cfg(cabac=0, redundant_pic_cnt_present=1))
    redundant = _slice_nal(1, 2, extra=lambda w: w.ue(1))
    write("h264_redundant.avi", st.finish() + [b"\0\0\0\1" + redundant])
    for tag in (b"hvc1", b"hev1"):
        write(f"hevc_{tag.decode()}.mp4", [b"\0\0\0\x02\x26\x01"], container="mp4", tag=tag)


FIXTURES = {
    "baseline_cavlc": baseline_cavlc, "main_cabac": main_cabac,
    "high_8x8_cabac": high_8x8_cabac, "high_8x8_cavlc": high_8x8_cavlc,
    "slices_cavlc": slices_cavlc, "slices_cabac": slices_cabac, "weighted": weighted,
    "long_term": long_term, "mmco_cabac": mmco_cabac,
    "hier_p": lambda: hierarchical("h264_hier_p.avi", None),
    "hier_p_restrict": lambda: hierarchical("h264_hier_p_restrict.avi", 2),
    "crop": crop, "full_range": full_range, "vui_timing": vui_timing,
    "recovery_sei": recovery_sei, "params_strf": params_strf, "clip": clip,
    "chip_avi": chip_avi, "chip_mp4": chip_mp4, "refused": refused,
    "chip_b_mp4": chip_b_mp4, "chip_b_avi": chip_b_avi,
    "b_cavlc_inf1": lambda: b_coverage("h264_b_cavlc_inf1.avi", 0, 1, None, 161),
    "b_cavlc_inf0": lambda: b_coverage("h264_b_cavlc_inf0.avi", 0, 0, 1, 162),
    "b_cabac_inf1": lambda: b_coverage("h264_b_cabac_inf1.mp4", 1, 1, 1, 163),
    "b_cabac_inf0": lambda: b_coverage("h264_b_cabac_inf0.mp4", 1, 0, None, 164),
    "b_lists": lambda: b_lists("h264_b_lists.avi", 0, 171),
    "b_lists_cabac": lambda: b_lists("h264_b_lists_cabac.mp4", 1, 172),
    "b_mixed": b_mixed,
    "b_pyramid_novui": lambda: b_pyramid("h264_b_pyramid_novui.avi", None),
    "b_pyramid_vui": lambda: b_pyramid("h264_b_pyramid_vui.mp4", dict(timing=(1, 50, 1))),
    "b_pyramid_ctts": lambda: b_pyramid("h264_b_pyramid_ctts.mp4", None, offsets=True),
    "b_pyramid_restrict": lambda: b_pyramid("h264_b_pyramid_restrict.avi",
                                            dict(num_reorder_frames=2,
                                                 max_dec_frame_buffering=3)),
    "b_ctts": lambda: b_ctts("h264_b_ctts.mp4", 0),
    "b_ctts_late": lambda: b_ctts("h264_b_ctts_late.mp4", 1),
    "cabac_idc1_8x8": cabac_idc1_8x8,
}
# the refused fixtures and the form each is refused as
REFUSED = {
    "h264_sp_slice.avi": "SP and SI slices",
    "h264_partitioned.avi": "data partitioning", "h264_field.avi": "field pictures and MBAFF",
    "h264_422.avi": "chroma_format_idc 2", "h264_10bit.avi": "10-bit video",
    "h264_fmo.avi": "slice groups", "h264_redundant.avi": "redundant pictures",
    "hevc_hvc1.mp4": "'hvc1'", "hevc_hev1.mp4": "'hev1'",
    "video_h264_tag.avi": "an 'H264' stream without a sequence parameter set",
    "video_avc1.mp4": "an 'avc1' track without avcC",
}


def names():
    return sorted(p.name for p in OUT.iterdir()
                  if p.name.startswith(("h264_", "hevc_")) and p.suffix in (".mp4", ".avi"))


def check(name, cv2_frames):
    """The port's plain loop (the C++ one for the chip-phase files, which
    the tests hold to the plain one on their first pictures) gives
    libavcodec's planes and, the pictures of the packets an MP4 edit leaves
    out dropped, cv2's frames."""
    reader = video.VideoReader(OUT / name)
    packets = list(reader.packet_bytes())
    native = name in (CHIP_MP4, CHIP_AVI, CHIP_B_MP4, CHIP_B_AVI)
    delay = H.probe_delay(packets, reader.config, reader.codec_tag, native=native,
                          annexb=reader.annexb, mp4=reader.probe)
    dec = H.Decoder(reader.config, native=native, codec_tag=reader.codec_tag, delay=delay,
                    annexb=reader.annexb)
    mine, tags = [], []
    for packet in packets:
        mine += dec.decode(packet)
        tags += dec.shown_packets
    mine += dec.flush()
    tags += dec.shown_packets
    want = mpeg4_oracle.decode(packets, b"" if reader.annexb else reader.config, codec=b"h264",
                               delay=delay)
    if len(mine) != len(want) or not all(np.array_equal(a, b) for x, y in zip(mine, want)
                                         for a, b in zip(x, y)):
        raise AssertionError(f"{name}: the plain loop differs from libavcodec")
    if reader.shown is not None:
        mine = [m for m, t in zip(mine, tags) if t in reader.shown]
    rgb = [yuv.yuv_to_rgb(*p, yuv.coefficients(*dec.colour)) for p in mine]
    if len(rgb) != len(cv2_frames) or not all(np.array_equal(a, b)
                                              for a, b in zip(rgb, cv2_frames)):
        raise AssertionError(f"{name}: the plain loop's frames differ from cv2's")
    return len(mine)


def main():
    only = sys.argv[1:]
    for key, fn in FIXTURES.items():
        if not only or key in only:
            print("writing", key, flush=True)
            fn()
    path = OUT / "digests.json"
    digests = json.loads(path.read_text())
    for name in [n for n in digests if n.startswith(("h264_", "hevc_")) and n not in names()]:
        del digests[name]
    total = 0
    for name in names() + ["video_h264_tag.avi", "video_avc1.mp4"]:
        if name in REFUSED:
            frames, _, _ = mpeg4_oracle.cv2_frames(OUT / name)
            digests[name] = {"refused": REFUSED[name], "cv2_frames": len(frames)}
            continue
        total += (OUT / name).stat().st_size
        frames, fps, count = mpeg4_oracle.cv2_frames(OUT / name)
        check(name, frames)
        digests[name] = {"frames": len(frames), "shape": list(frames[0].shape), "fps": fps,
                         "frame_count": count,
                         "frame_sha256": [hashlib.sha256(f.tobytes()).hexdigest()
                                          for f in frames]}
        print(name, (OUT / name).stat().st_size, len(frames), frames[0].shape, fps, count)
    path.write_text(json.dumps(digests, indent=1) + "\n")
    print(f"readable H.264 fixtures: {total} bytes")


if __name__ == "__main__":
    main()
