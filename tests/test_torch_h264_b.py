"""The port's H.264 reader on B slices (``data/h264.py`` and its C++ loop,
``csrc/h264_host.cc``) and MP4's composition times (``data/mp4.py``),
against cv2 and the bundled libavcodec (``mpeg4_oracle.py``), on the
committed ``h264_b_*`` fixtures of ``probe/make_h264_fixtures.py``.

Each small B fixture reads, by the plain loop, to cv2's frames (their
SHA-256 in ``digests.json`` and their pixels), count and rates, and its
planes are libavcodec's; the C++ loop gives the plain loop's planes; the
two chip-phase files read by the C++ loop to cv2's frames, the plain loop
equal to it on their first three pictures (I, P and B).  The fixtures
together take every B macroblock and sub type, B_Skip, both direct modes
under both ``direct_8x8_inference`` values and the three
``weighted_bipred_idc`` under both coders; an MP4's edit drops the
pictures of the packets it leaves out, as cv2 does; explicit
bi-prediction equals FFmpeg's form of it; and both infer CLIs read a B
clip alike."""

import collections
import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import mpeg4_oracle
from orienmask_tpu_torch.data import h264, mp4, video, yuv
from test_torch_h264 import both_clis, check_both_clis
from test_torch_infer import inputs  # noqa: F401 (the fixture)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
CHIP = ("h264_b_cabac_720x1280.mp4", "h264_b_cavlc_480x640.avi")
SMALL = sorted(n for n in DIGESTS if n.startswith("h264_b_") and n not in CHIP)
CODERS = ("cavlc", "cabac")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _decode(name, native=False, limit=None):
    """(planes, each one's packet, decoder, reader, packets, delay) of
    fixture ``name`` (its first ``limit`` packets) at the delay cv2's probe
    finds."""
    reader = video.VideoReader(FIXTURES / name)
    packets = list(reader.packet_bytes())[:limit]
    delay = h264.probe_delay(packets, reader.config, reader.codec_tag, native=native,
                             annexb=reader.annexb, mp4=reader.probe)
    dec = h264.Decoder(reader.config, native=native, codec_tag=reader.codec_tag, delay=delay,
                       annexb=reader.annexb)
    planes, tags = [], []
    for packet in packets:
        planes += dec.decode(packet)
        tags += dec.shown_packets
    planes += dec.flush()
    tags += dec.shown_packets
    return planes, tags, dec, reader, packets, delay


def _lavc(reader, packets, delay, sources=None):
    return mpeg4_oracle.decode(packets, b"" if reader.annexb else reader.config, codec=b"h264",
                               delay=delay, sources=sources)


def _equal(xs, ys):
    return len(xs) == len(ys) and all(np.array_equal(a, b) for x, y in zip(xs, ys)
                                      for a, b in zip(x, y))


def _sha(frames):
    return [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]


@pytest.mark.parametrize("name", SMALL)
def test_the_plain_loop_reads_each_b_fixture_to_cv2s_frames_and_libavcodecs_planes(name):
    """Frames (SHA-256 and pixels), count and rates as cv2 gives them, the
    pictures of the packets an MP4 edit leaves out dropped; the planes
    before the colour conversion and the drop libavcodec's, each from the
    packet libavcodec's frame came from."""
    planes, tags, dec, reader, packets, delay = _decode(name)
    sources = []
    assert _equal(planes, _lavc(reader, packets, delay, sources))
    assert tags == sources
    shown = [p for p, t in zip(planes, tags) if reader.shown is None or t in reader.shown]
    frames = [yuv.yuv_to_rgb_py(*p, yuv.coefficients(*dec.colour)) for p in shown]
    want = DIGESTS[name]
    assert _sha(frames) == want["frame_sha256"]
    got_cv2, fps, count = mpeg4_oracle.cv2_frames(FIXTURES / name)
    assert len(got_cv2) == len(frames) and all(np.array_equal(a, b)
                                               for a, b in zip(frames, got_cv2))
    assert (reader.fps, reader.frame_count) == (want["fps"], want["frame_count"]) == (fps, count)


@pytest.mark.parametrize("name", SMALL)
def test_the_cpp_loop_gives_the_plain_loops_planes_on_b_slices(name):
    planes = _decode(name)[0]
    assert _equal(planes, _decode(name, native=True)[0])
    assert _sha(list(video.VideoReader(FIXTURES / name))) == DIGESTS[name]["frame_sha256"]


@pytest.mark.parametrize("name", CHIP)
def test_the_chip_phase_b_files_read_to_cv2s_frames(name):
    """The reader (C++ loop) to cv2's committed frames, rate and count and
    to libavcodec's planes; the plain loop equal to the C++ one on the
    first three pictures in decoding order (I, P and B)."""
    reader = video.VideoReader(FIXTURES / name)
    want = DIGESTS[name]
    assert _sha(list(reader)) == want["frame_sha256"]
    assert (reader.fps, reader.frame_count) == (want["fps"], want["frame_count"])
    planes, _, dec, _, packets, delay = _decode(name, native=True)
    assert _equal(planes, _lavc(reader, packets, delay))
    first, _, plain_dec, _, _, _ = _decode(name, limit=3)
    assert plain_dec.coverage["slice", "B", "cabac" if name.endswith(".mp4") else "cavlc"]
    assert _equal(first, _decode(name, native=True, limit=3)[0])


COVERAGE = (
    [("mb", t, c) for t in h264.B_MB_NAMES for c in CODERS]
    + [("sub_mb_type", t, c) for t in h264.B_SUB_NAMES for c in CODERS]
    + [("mb", "B_Skip", c) for c in CODERS] + [("mb", "B intra", c) for c in CODERS]
    + [("direct", mode, infer, c) for mode in ("spatial", "temporal") for infer in (0, 1)
       for c in CODERS]
    + [("weighted_bipred_idc", idc, c) for idc in range(3) for c in CODERS]
    + [("cabac_init_idc", "B", idc, 1) for idc in range(3)]
    + [("long-term reference in list", lst) for lst in range(2)]
    + [("missing reference", 1), ("modification", "L1"), ("mmco", 1), "L1 swapped",
       "more than one L1 reference", "slice types mixed in a picture", "output delay grown"])


def test_the_b_fixtures_together_take_every_path():
    """The plain loop over every small B fixture counts the paths it takes
    (``Decoder.coverage``): every B mb_type (0-22) and sub_mb_type (0-12),
    B_Skip, spatial and temporal direct under both direct_8x8_inference
    values, weighted_bipred_idc 0, 1 and 2, each under CAVLC and CABAC;
    cabac_init_idc 0-2 of B slices under the 8x8 transform, long-term
    pictures in both lists, L1's modifications, swap and default fill, and
    P and B slices in one picture."""
    taken = collections.Counter()
    for name in SMALL:
        taken.update(_decode(name)[2].coverage)
    missing = [key for key in COVERAGE if not taken[key]]
    assert not missing, missing
    assert taken["bS", 1] and taken["bS", 0]


def test_an_edit_drops_the_pictures_of_the_packets_it_leaves_out():
    """An edit a frame after the first composition offset: cv2 drops the
    picture of the first packet (the first shown), not the frame that
    comes out after that packet; the edit at the offset drops nothing."""
    whole, late = (video.VideoReader(FIXTURES / f"h264_b_ctts{s}.mp4") for s in ("", "_late"))
    assert whole.shown == set(range(len(whole.packets))) and late.shown == whole.shown - {0}
    assert whole.probe == late.probe == (2, True)
    frames, late_frames = list(whole), list(late)
    assert len(late_frames) == len(frames) - 1
    assert all(np.array_equal(a, b) for a, b in zip(frames[1:], late_frames))
    assert len(late_frames) == len(mpeg4_oracle.cv2_frames(late.path)[0])


def _ctts_v1(data):
    """``data`` with its ctts box rewritten as version 1, every offset less
    the first (the first sample's then 0, some negative), and its edit's
    media time 0."""
    at = data.index(b"ctts") - 4
    size, = struct.unpack_from(">I", data, at)
    count, = struct.unpack_from(">I", data, at + 12)
    runs = [list(struct.unpack_from(">Ii", data, at + 16 + 8 * i)) for i in range(count)]
    first = runs[0][1]
    body = struct.pack(">I", count) + b"".join(struct.pack(">Ii", n, v - first) for n, v in runs)
    out = bytearray(data[:at] + struct.pack(">I4sI", size, b"ctts", 1 << 24) + body
                    + data[at + size:])
    edit = out.index(b"elst") + 4
    out[edit + 12:edit + 16] = struct.pack(">i", 0)
    return bytes(out)


def test_ctts_version_1_reads_its_signed_offsets(tmp_path):
    """A version-1 ctts (signed offsets, some negative) reads, as cv2 reads
    it, to the same frames."""
    path = tmp_path / "v1.mp4"
    path.write_bytes(_ctts_v1((FIXTURES / "h264_b_ctts.mp4").read_bytes()))
    track = mp4.read(path.read_bytes())
    assert track.offsets[0] == 0 and min(track.offsets) < 0 and track.delay == 2
    frames = list(video.VideoReader(path))
    want, _, _ = mpeg4_oracle.cv2_frames(path)
    assert len(frames) == len(want) == DIGESTS["h264_b_ctts.mp4"]["frames"]
    assert all(np.array_equal(a, b) for a, b in zip(frames, want))


def test_the_reorder_delay_guessed_from_composition_times():
    """``mp4.guess_delay`` is FFmpeg's ``mov_guess_video_delay``: the most
    earlier presentation times one sample's passes."""
    assert mp4.guess_delay([0, 1, 2, 3]) == 0
    assert mp4.guess_delay([2, 5, 3, 4, 8, 6, 7]) == 1  # I P B B
    assert mp4.guess_delay([2, 6, 4, 3, 5, 10, 8, 7, 9]) == 2  # a pyramid
    assert mp4.guess_delay(list(range(20, 0, -1))) == 16  # within 17 samples


def _weight_tables():
    """Every explicit weight table of the B fixtures: (luma denominator,
    chroma denominator, L0 table, L1 table)."""
    tables = []
    for name in SMALL + list(CHIP):
        reader = video.VideoReader(FIXTURES / name)
        dec = h264.Decoder(reader.config, annexb=reader.annexb)
        for packet in reader.packet_bytes():
            nals = h264.split_annexb(packet) if not dec.length_size else \
                h264.split_lengths(packet, dec.length_size)
            for nal in nals:
                kind = nal[0] & 0x1F
                if kind in (7, 8):
                    dec._nal(nal)
                elif kind in (1, 5):
                    h = h264.SliceHeader(h264.unescape(nal[1:]), kind, nal[0] >> 5 & 3,
                                         dec.sps, dec.pps)
                    if h.type == h264.B_SLICE and h.weights is not None:
                        tables.append(h.weights)
    return tables


def test_explicit_bi_prediction_equals_ffmpegs_form():
    """((a w0 + b w1 + 2^logWD) >> (logWD + 1)) + ((o0 + o1 + 1) >> 1), the
    standard's, equals FFmpeg's (a w0 + b w1 + (((o0 + o1 + 1) | 1) <<
    logWD)) >> (logWD + 1), both clipped, for every sample pair and every
    pair of entries of every explicit table in the fixtures."""
    tables = _weight_tables()
    assert len(tables) > 10
    a, b = np.meshgrid(np.arange(256), np.arange(256))
    seen = set()
    for ld, cd, t0, t1 in tables:
        for e0 in t0:
            for e1 in t1:
                for c, denom in enumerate((ld, cd, cd)):
                    key = (e0[2 * c], e1[2 * c], e0[2 * c + 1], e1[2 * c + 1], denom)
                    if key in seen:
                        continue
                    seen.add(key)
                    w0, w1, o0, o1, _ = key
                    ours = h264.bi_weight(a, b, w0, w1, o0, o1, denom)
                    ffmpeg = np.clip((a * w0 + b * w1 + (((o0 + o1 + 1) | 1) << denom))
                                     >> (denom + 1), 0, 255)
                    assert np.array_equal(ours, ffmpeg), key
    assert len(seen) > 50


@pytest.fixture(scope="module")
def b_cli(inputs, tmp_path_factory):  # noqa: F811
    """Both CLIs over the committed 96x128 B-frame MP4 (ctts, an edit, a
    pyramid, implicit weights; the scene of the clip ``CLI_MEAN_ABS_DIFF``
    was measured on)."""
    return both_clis(inputs, tmp_path_factory.mktemp("h264_b_cli"), "h264_b_ctts.mp4")


def test_both_clis_read_a_b_clip_alike_and_write_close_videos(b_cli):
    """The two CLIs read the same frames of a B-frame clip (the port's
    reader equals cv2's) and write outputs within ``CLI_MEAN_ABS_DIFF``."""
    check_both_clis(b_cli, "h264_b_ctts.mp4", 8)
