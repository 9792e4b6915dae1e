"""The port's H.264 reader (``data/h264.py`` and its C++ loop,
``csrc/h264_host.cc``) against cv2 and the bundled libavcodec
(``mpeg4_oracle.py``), on the committed fixtures of
``probe/make_h264_fixtures.py``.

Each readable fixture reads, by the plain loop, to cv2's frames (their
SHA-256 in ``digests.json`` and their pixels), count and rates, and its
planes are libavcodec's; the C++ loop gives the plain loop's planes (on the
two chip-phase files, their first two pictures; the reader's frames there
are cv2's).  Each refused form is refused by its name.  The constant tables
are found in libavcodec's bytes, the fixtures together take every path the
coverage list names, and both infer CLIs read the same frames of an H.264
clip and write videos within ``CLI_MEAN_ABS_DIFF`` of each other."""

import collections
import glob
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mpeg4_oracle
from orienmask_tpu.utils.envs import cpu_subprocess_env
from orienmask_tpu_torch.data import h264, h264_tables, video, yuv
from test_torch_infer import _config, inputs  # noqa: F401 (the fixture)
from test_torch_video import CLI_MEAN_ABS_DIFF

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
# the B-slice fixtures (h264_b_*) are tests/test_torch_h264_b.py's
H264 = sorted(n for n in DIGESTS if n.startswith(("h264_", "hevc_")) and
              not n.startswith("h264_b_"))
READABLE = [n for n in H264 if "refused" not in DIGESTS[n]]
CHIP = ("h264_high_cabac_720x1280.mp4", "h264_baseline_480x640.avi")
SMALL = [n for n in READABLE if n not in CHIP]
REFUSED = [n for n in H264 if "refused" in DIGESTS[n]] + ["video_h264_tag.avi",
                                                          "video_avc1.mp4"]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plain(name, limit=None):
    """(planes, decoder) of the plain loop over fixture ``name`` (its first
    ``limit`` packets), with the delay cv2's probe finds."""
    reader = video.VideoReader(FIXTURES / name)
    packets = list(reader.packet_bytes())[:limit]
    delay = h264.probe_delay(packets, reader.config, reader.codec_tag, native=False,
                             annexb=reader.annexb, mp4=reader.probe)
    dec = h264.Decoder(reader.config, native=False, codec_tag=reader.codec_tag, delay=delay,
                       annexb=reader.annexb)
    planes = []
    for packet in packets:
        planes += dec.decode(packet)
    planes += dec.flush()
    return planes, dec, packets, delay


def _lavc(reader, packets, delay=0):
    """libavcodec's planes of ``packets`` (Annex B ones carry their
    parameter sets, so the avcC record is left out)."""
    return mpeg4_oracle.decode(packets, b"" if reader.annexb else reader.config, codec=b"h264",
                               delay=delay)


def _sha(frames):
    return [hashlib.sha256(f.tobytes()).hexdigest() for f in frames]


@pytest.mark.parametrize("name", SMALL)
def test_the_plain_loop_reads_each_fixture_to_cv2s_frames_and_libavcodecs_planes(name):
    """Frames (SHA-256 and pixels), count and rates as cv2 gives them; the
    planes before the colour conversion libavcodec's."""
    planes, dec, packets, delay = _plain(name)
    frames = [yuv.yuv_to_rgb_py(*p, yuv.coefficients(*dec.colour)) for p in planes]
    want = DIGESTS[name]
    assert _sha(frames) == want["frame_sha256"]
    got_cv2, fps, count = mpeg4_oracle.cv2_frames(FIXTURES / name)
    assert len(got_cv2) == len(frames) and all(np.array_equal(a, b)
                                               for a, b in zip(frames, got_cv2))
    reader = video.VideoReader(FIXTURES / name)
    assert (reader.fps, reader.frame_count) == (want["fps"], want["frame_count"]) == (fps, count)
    lavc = _lavc(reader, packets, delay)
    assert len(lavc) == len(planes)
    assert all(np.array_equal(a, b) for x, y in zip(planes, lavc) for a, b in zip(x, y))


@pytest.mark.parametrize("name", SMALL)
def test_the_cpp_loop_gives_the_plain_loops_planes(name):
    planes, _, _, _ = _plain(name)
    reader = video.VideoReader(FIXTURES / name)
    native = list(reader.planes())
    assert len(native) == len(planes)
    assert all(np.array_equal(a, b) for x, y in zip(planes, native) for a, b in zip(x, y))
    assert _sha(list(reader)) == DIGESTS[name]["frame_sha256"]


@pytest.mark.parametrize("name", CHIP)
def test_the_chip_phase_files_read_to_cv2s_frames(name):
    """The reader (C++ loop) to cv2's committed frames and libavcodec's
    planes; the plain loop equal to it on the first two pictures."""
    reader = video.VideoReader(FIXTURES / name)
    want = DIGESTS[name]
    assert _sha(list(reader)) == want["frame_sha256"]
    assert (reader.fps, reader.frame_count) == (want["fps"], want["frame_count"])
    planes = list(reader.planes())
    packets = list(reader.packet_bytes())
    lavc = _lavc(reader, packets, h264.probe_delay(packets, reader.config, reader.codec_tag,
                                                  annexb=reader.annexb, mp4=reader.probe))
    assert len(lavc) == len(planes)
    assert all(np.array_equal(a, b) for x, y in zip(planes, lavc) for a, b in zip(x, y))
    first, _, _, _ = _plain(name, limit=2)
    assert len(first) == 2
    assert all(np.array_equal(a, b) for x, y in zip(first, planes) for a, b in zip(x, y))


@pytest.mark.parametrize("name", REFUSED)
def test_each_refused_form_names_itself(name):
    with pytest.raises(video.UnsupportedVideo) as err:
        list(video.VideoReader(FIXTURES / name))
    assert DIGESTS[name]["refused"] in str(err.value)
    assert "ROADMAP Queue 1 item 1, 'What the infer CLI still refuses'" in str(err.value)


def test_a_packet_cut_inside_keeps_the_frames_before_it(tmp_path):
    """The last packet cut inside: the pictures before it are shown."""
    data = (FIXTURES / "h264_baseline_cavlc.avi").read_bytes()
    reader = video.VideoReader(FIXTURES / "h264_baseline_cavlc.avi")
    offset, size = reader.packets[-1]
    cut = bytearray(data)
    cut[offset + size // 2:offset + size] = bytes(size - size // 2)
    (tmp_path / "cut.avi").write_bytes(bytes(cut))
    frames = list(video.VideoReader(tmp_path / "cut.avi"))
    whole = list(reader)
    assert len(frames) == len(whole) - 1
    assert all(np.array_equal(a, b) for a, b in zip(frames, whole))


def _libavcodec():
    path = glob.glob(os.path.join(mpeg4_oracle.LIBS, "libavcodec-*.so*"))[0]
    return Path(path).read_bytes()


def _pad(rows, width):
    return [list(r) + [0] * (width - len(r)) for r in rows]


TABLES = {
    "coeff_token lengths": (h264_tables.COEFF_TOKEN_LEN, np.uint8),
    "coeff_token codes": (h264_tables.COEFF_TOKEN_CODE, np.uint8),
    "chroma DC coeff_token lengths": (h264_tables.CHROMA_DC_COEFF_TOKEN_LEN, np.uint8),
    "chroma DC coeff_token codes": (h264_tables.CHROMA_DC_COEFF_TOKEN_CODE, np.uint8),
    "total_zeros lengths": (_pad(h264_tables.TOTAL_ZEROS_LEN, 16), np.uint8),
    "total_zeros codes": (_pad(h264_tables.TOTAL_ZEROS_CODE, 16), np.uint8),
    "chroma DC total_zeros lengths": (_pad(h264_tables.CHROMA_DC_TOTAL_ZEROS_LEN, 4), np.uint8),
    "chroma DC total_zeros codes": (_pad(h264_tables.CHROMA_DC_TOTAL_ZEROS_CODE, 4), np.uint8),
    "run_before lengths": (_pad(h264_tables.RUN_BEFORE_LEN, 16), np.uint8),
    "run_before codes": (_pad(h264_tables.RUN_BEFORE_CODE, 16), np.uint8),
    "coded_block_pattern intra": (h264_tables.CBP_INTRA, np.uint8),
    "coded_block_pattern inter": (h264_tables.CBP_INTER, np.uint8),
    "4x4 zig-zag": (h264_tables.ZIGZAG4, np.uint8),
    "8x8 zig-zag": (h264_tables.ZIGZAG8, np.uint8),
    # LevelScale4x4's normAdjust, stored (v0, v2, v1)
    "normAdjust4x4": ([(a, c, b) for a, b, c in h264_tables.NORM_ADJUST4], np.uint8),
    "normAdjust8x8": (h264_tables.NORM_ADJUST8, np.uint8),
    # the default scaling lists, stored in raster order
    "Default_4x4_Intra": (h264_tables.scaling_raster(h264_tables.DEFAULT_4X4_INTRA,
                                                     h264_tables.ZIGZAG4), np.uint8),
    "Default_4x4_Inter": (h264_tables.scaling_raster(h264_tables.DEFAULT_4X4_INTER,
                                                     h264_tables.ZIGZAG4), np.uint8),
    "Default_8x8_Intra": (h264_tables.scaling_raster(h264_tables.DEFAULT_8X8_INTRA,
                                                     h264_tables.ZIGZAG8), np.uint8),
    "Default_8x8_Inter": (h264_tables.scaling_raster(h264_tables.DEFAULT_8X8_INTER,
                                                     h264_tables.ZIGZAG8), np.uint8),
    "chroma QP": (h264_tables.CHROMA_QP, np.uint8),
    "alpha": (h264_tables.ALPHA, np.uint8),
    "beta": (h264_tables.BETA, np.uint8),
    # tC0 stored with a -1 for bS 0 before each row
    "tC0": ([(-1,) + t for t in h264_tables.TC0], np.int8),
    # rangeTabLPS stored by qCodIRangeIdx, each state twice (for valMPS 0, 1)
    "rangeTabLPS": ([[h264_tables.RANGE_LPS[s >> 1][q] for s in range(128)] for q in range(4)],
                    np.uint8),
    "8x8 significant_coeff_flag ctxIdxInc": (h264_tables.SIG_8X8_FRAME, np.uint8),
    "8x8 last_significant_coeff_flag ctxIdxInc": (h264_tables.LAST_8X8, np.uint8),
    "CABAC (m, n), I slices": (h264_tables.CABAC_INIT[0], np.int8),
    "CABAC (m, n), cabac_init_idc 0": (h264_tables.CABAC_INIT[1], np.int8),
    "CABAC (m, n), cabac_init_idc 1": (h264_tables.CABAC_INIT[2], np.int8),
    "CABAC (m, n), cabac_init_idc 2": (h264_tables.CABAC_INIT[3], np.int8),
}


@pytest.fixture(scope="module")
def libavcodec():
    return _libavcodec()


@pytest.mark.parametrize("name", sorted(TABLES))
def test_each_table_is_a_run_of_libavcodecs_bytes(libavcodec, name):
    """Each table, written from ITU-T H.264, is found whole in the bundled
    libavcodec (in the layout noted beside it in ``TABLES``); transIdxLPS,
    stored there only folded into CABAC's state transitions, is checked by
    the CABAC fixtures."""
    values, dtype = TABLES[name]
    assert np.asarray(values, dtype).tobytes() in libavcodec


def test_the_tables_left_out_are_refused_not_guessed():
    """No table is left out any more: cabac_init_idc 1's ctxIdx 417-435,
    written from Table 9-24, are whole (their run of libavcodec's bytes is
    ``test_each_table_is_a_run_of_libavcodecs_bytes``), and the fixture of
    CABAC P and B slices of cabac_init_idc 1 under the 8x8 transform,
    refused before, reads by the plain loop to cv2's frames and
    libavcodec's planes."""
    assert all(mn is not None for mn in h264_tables.CABAC_INIT[2])
    name = "h264_cabac_idc1_8x8.avi"
    assert name in SMALL and name not in REFUSED
    planes, dec, packets, delay = _plain(name)
    frames = [yuv.yuv_to_rgb_py(*p, yuv.coefficients(*dec.colour)) for p in planes]
    assert _sha(frames) == DIGESTS[name]["frame_sha256"]
    assert dec.coverage["cabac_init_idc", 1] and dec.coverage["transform 8x8", "inter"]


COVERAGE = (
    [("mb", "I_16x16", mode, chroma, luma) for mode in range(4) for chroma in range(3)
     for luma in (0, 15)]
    + [("mb", h264.KIND_NAMES[k]) for k in (h264.I4, h264.I8, h264.P16X16, h264.P16X8,
                                            h264.P8X16, h264.P8X8, h264.P8X8REF0)]
    + [("mb", "I_PCM", coder) for coder in ("cavlc", "cabac")]
    + [("mb", "P_Skip", coder) for coder in ("cavlc", "cabac")]
    + [("sub_mb_type", t) for t in ("8x8", "8x4", "4x8", "4x4")]
    + [("intra 4x4", m) for m in range(9)] + [("intra 8x8", m) for m in range(9)]
    + [("intra 16x16", m) for m in range(4)] + [("chroma", m) for m in range(4)]
    + [("ctxBlockCat", c, "cabac") for c in range(6)]
    + [("ctxBlockCat", c, "cavlc") for c in range(5)]
    + [("bS", b) for b in range(5)] + [("mmco", op) for op in range(1, 7)]
    + [("poc type", t) for t in range(3)]
    + [("slice", t, coder) for t in ("I", "P") for coder in ("cavlc", "cabac")]
    + [("cabac_init_idc", idc) for idc in range(3)]
    + [("deblocking idc", idc) for idc in range(3)]
    + [("transform 8x8", k) for k in ("intra", "inter")]
    + [("modification", k) for k in ("short", "long")]
    + ["weighted P", "output delay grown", "picture dropped (late)", "several slices a picture",
       "ref list modification"]
    + [("profile", p) for p in (66, 77, 100)])


def test_the_fixtures_together_take_every_path():
    """The plain loop over every small fixture counts the paths it takes
    (``Decoder.coverage``): every macroblock and sub-macroblock type, intra
    mode, ctxBlockCat, bS, MMCO, POC type, coder and the rest of
    ``COVERAGE``; and the fixtures hold a crop, full range and colour
    matrices."""
    taken = collections.Counter()
    colour = {}
    for name in SMALL:
        reader = video.VideoReader(FIXTURES / name)
        dec = h264.Decoder(reader.config, native=False, codec_tag=reader.codec_tag,
                           annexb=reader.annexb)  # no delay: libavcodec's own, which drops
        for packet in reader.packet_bytes():
            dec.decode(packet)
        dec.flush()
        taken.update(dec.coverage)
        colour[name] = dec.colour
    missing = [key for key in COVERAGE if not taken[key]]
    assert not missing, missing
    assert colour["h264_full_range.avi"] == (1, True)
    assert colour["h264_vui_timing.mp4"] == (6, False)
    assert DIGESTS["h264_crop.mp4"]["shape"] == [44, 70, 3]


def test_the_colour_coefficients_are_libswscales():
    """BT.601 limited and full range as the MPEG-4 and MJPEG paths hold
    them; BT.709 full range as cv2 converts an H.264 frame of
    matrix_coefficients 1."""
    assert yuv.coefficients(2, False) == (yuv.Y_COEFF, yuv.Y_OFFSET, yuv.VR_COEFF, yuv.UB_COEFF,
                                          yuv.VG_COEFF, yuv.UG_COEFF)
    assert yuv.coefficients(5, True) == (yuv.FULL_Y_COEFF, 0, yuv.FULL_VR, yuv.FULL_UB,
                                         yuv.FULL_VG, yuv.FULL_UG)
    rng = np.random.default_rng(3)
    y = rng.integers(0, 256, (6, 10), dtype=np.uint8)
    u, v = (rng.integers(0, 256, (3, 5), dtype=np.uint8) for _ in range(2))
    c = yuv.coefficients(1, True)
    assert np.array_equal(yuv.yuv_to_rgb_py(y, u, v, c), yuv.yuv_to_rgb_native(y, u, v, c))


def both_clis(inputs, root, clip):  # noqa: F811
    """Both CLIs' --video over committed fixture ``clip`` (at 96x128, the
    size ``CLI_MEAN_ABS_DIFF`` was measured at), each -o out.avi, random
    colours seeded alike: {"jax" or "port": (stdout, output path)}."""
    config = dict(_config(), visualizer={"type": "InferenceVisualizer", "dataset": "COCO",
                                         "with_mask": True, "conf_thresh": 0.3, "alpha": 0.6,
                                         "line_thickness": 1})
    (root / "config.json").write_text(json.dumps(config))
    env = dict(cpu_subprocess_env(), OMP_NUM_THREADS="1")
    seeded = "import random, runpy, sys; random.seed(0); sys.argv = sys.argv[1:]; "
    args = ["-c", str(root / "config.json"), "-w", str(inputs / "weights.ckpt"), "--video",
            str(FIXTURES / clip)]
    out = {}
    for name, cmd in (
            ("jax", [sys.executable, "-c", seeded + "runpy.run_path(sys.argv[0], "
                     "run_name='__main__')", "infer.py"]),
            ("port", [sys.executable, "-c", seeded + "from orienmask_tpu_torch import infer; "
                      "raise SystemExit(infer.main(sys.argv[1:]))", "infer", "--device", "cpu"])):
        path = root / f"{name}.avi"
        proc = subprocess.run(cmd + args + ["-o", str(path)], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        out[name] = (proc.stdout, path)
    return out


def check_both_clis(out, clip, n):
    """The two CLIs of ``both_clis`` read the same ``n`` frames of ``clip``
    (the port's reader equals cv2's) and write outputs within
    ``CLI_MEAN_ABS_DIFF``."""
    shape = (96, 128, 3)
    port_frames = list(video.VideoReader(FIXTURES / clip))
    cv2_frames, _, _ = mpeg4_oracle.cv2_frames(FIXTURES / clip)
    assert len(port_frames) == len(cv2_frames) == n
    assert all(np.array_equal(a, b) for a, b in zip(port_frames, cv2_frames))
    (jax_out, jax_file), (port_out, port_file) = out["jax"], out["port"]
    assert f"Streamed {n} frames" in jax_out and f"Streamed {n} frames" in port_out
    want, want_fps, want_count = mpeg4_oracle.cv2_frames(jax_file)
    got, got_fps, got_count = mpeg4_oracle.cv2_frames(port_file)
    assert (len(got), got[0].shape, got_fps, got_count) == \
        (len(want), want[0].shape, want_fps, want_count) == (n, shape, 25.0, n)
    diff = np.mean([np.abs(a.astype(float) - b).mean() for a, b in zip(got, want)])
    print(f"mean absolute difference of the two CLIs' videos: {diff:.3f}")
    assert diff < CLI_MEAN_ABS_DIFF


@pytest.fixture(scope="module")
def h264_cli(inputs, tmp_path_factory):  # noqa: F811
    """Both CLIs over the committed 96x128 H.264 clip."""
    return both_clis(inputs, tmp_path_factory.mktemp("h264_cli"), "h264_clip_96x128.mp4")


def test_both_clis_read_an_h264_clip_alike_and_write_close_videos(h264_cli):
    """The two CLIs read the same frames (the port's reader equals cv2's)
    and write outputs within ``CLI_MEAN_ABS_DIFF``."""
    check_both_clis(h264_cli, "h264_clip_96x128.mp4", 8)
