"""The port's MPEG-4 Part 2 Advanced Simple Profile reader (``data/mpeg4.py``
and its C++ loop) against libavcodec (``mpeg4_oracle.py``, the library
behind cv2 here), tool by tool, and the infer CLI's ``--video`` over an
XviD ASP AVI against the JAX CLI.

Streams libavcodec makes here with each tool: B-VOPs (1 to 3 between
references, with 4MV and resync markers), quarter-pel (1MV and 4MV, in P-
and B-VOPs), MPEG quantisation (quantisers 2 to 31), data partitioning
(with resync markers, and all-intra); the user data of XviD (builds 0, 30
and 73: FFmpeg switches to XviD's IDCT, and to its DC clip, edge and
quarter-pel chroma workarounds for early builds), of DivX (5.01 and 5.03
with builds before 1814: the quarter-pel chroma workarounds), an
``XVID``-tagged stream without user data, a ``DIVX``-tagged one; DivX's
packed bitstreams, with and without the packed flag; a VOL rewritten to
load its own matrices, and one without vol_control_parameters.  Each
decodes to libavcodec's Y, U and V planes, by the plain loop and the C++
one.  The forms still refused name themselves.  Clips are 144x176 or
less."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mpeg4_oracle
from orienmask_tpu.utils.envs import cpu_subprocess_env
from orienmask_tpu_torch.data import mpeg4, video
from test_torch_infer import _config, inputs  # noqa: F401 (the fixture)
from test_torch_video import CLI_MEAN_ABS_DIFF, _equal_planes, _scene

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
sys.path.insert(0, str(REPO / "probe"))
import make_video_fixtures as fixtures  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _frames(h=96, w=112, n=10, seed=0):
    frames = _scene(h, w, n, 4, 3, seed=seed)
    frames[6:] = _scene(h, w, n - 6, 3, 2, seed=seed + 1)  # a scene cut: intra macroblocks
    return frames


def _decode_both(packets, want, **kw):
    for native in (True, False):
        decoder = mpeg4.Decoder(native=native, **kw)
        got = [f for p in packets for f in decoder.decode(p)] + decoder.flush()
        assert _equal_planes(got, want), native


TOOLS = {
    "bvop1": dict(bf=1),
    "bvop2_4mv": dict(bf=2, flags="+mv4"),
    "bvop3_4mv_resync": dict(bf=3, flags="+mv4", ps=150),
    "qpel": dict(flags="+qpel"),
    "qpel_4mv": dict(flags="+qpel+mv4"),
    "qpel_bvop2_4mv": dict(bf=2, flags="+qpel+mv4"),
    "qpel_bvop2_resync": dict(bf=2, flags="+qpel+mv4", ps=120),
    "mpeg_quant": dict(mpeg_quant=1),
    "mpeg_quant_q2_bvop": dict(mpeg_quant=1, qmin=2, qmax=2, bf=1),
    "mpeg_quant_q31_qpel": dict(mpeg_quant=1, qmin=31, qmax=31, flags="+qpel+mv4"),
    "partitioned": dict(data_partitioning=1),
    "partitioned_resync_4mv": dict(data_partitioning=1, ps=150, flags="+mv4"),
    "partitioned_intra": dict(data_partitioning=1, g=1, ps=100),
    "partitioned_bvop2_qpel_resync": dict(data_partitioning=1, bf=2, ps=150, flags="+mv4+qpel"),
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_each_tool_decodes_to_libavcodecs_planes(tool):
    """B-VOPs shown in display order, each macroblock mode, quarter-pel
    with its mirrored 8-tap filter, MPEG quantisation with its mismatch
    control, data partitioning; a scene cut makes intra macroblocks."""
    frames = _frames()
    packets = mpeg4_oracle.encode(frames, 112, 96, **TOOLS[tool])
    want = mpeg4_oracle.decode(packets)
    assert len(want) == len(frames)
    _decode_both(packets, want)


@pytest.mark.parametrize("seed", range(6))
def test_random_combinations_of_the_tools_decode_to_libavcodecs_planes(seed):
    """Seeded draws of every tool at once, at sizes that are not whole
    macroblocks and with motion that needs f_code 2 and above."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.choice([40, 72, 96])), int(rng.choice([56, 88, 120]))
    flags = "".join(f for f, on in (("+mv4", rng.random() < 0.7), ("+qpel", rng.random() < 0.6))
                    if on) or "+mv4"
    options = dict(bf=int(rng.integers(0, 4)), flags=flags, mpeg_quant=int(rng.random() < 0.5),
                   data_partitioning=int(rng.random() < 0.3))
    if rng.random() < 0.5:
        options["ps"] = int(rng.integers(60, 200))
    q = int(rng.integers(1, 28))
    options.update(qmin=q, qmax=q + int(rng.integers(0, 4)))
    frames = _scene(h, w, 9, int(rng.integers(2, 20)), int(rng.integers(1, 8)), seed=seed)
    packets = mpeg4_oracle.encode(frames, w, h, **options)
    _decode_both(packets, mpeg4_oracle.decode(packets))


def _patched(user_data, **options):
    packets = mpeg4_oracle.encode(_frames(72, 88), 88, 72, **options)
    return fixtures.user_data(user_data)(packets)


ENCODERS = {
    # (user data or None for none, codec tag, the IDCT and workarounds FFmpeg takes)
    "xvid73": (b"XviD0073", b"", mpeg4.IDCT_XVID, 0),
    "xvid30": (b"XviD0030", b"", mpeg4.IDCT_XVID, mpeg4.BUG_DC_CLIP),
    "xvid0": (b"XviD0000", b"", mpeg4.IDCT_XVID,
              mpeg4.BUG_DC_CLIP | mpeg4.BUG_EDGE | mpeg4.BUG_QPEL_CHROMA),
    "xvid_tag": (None, b"XVID", mpeg4.IDCT_XVID,
                 mpeg4.BUG_DC_CLIP | mpeg4.BUG_EDGE | mpeg4.BUG_QPEL_CHROMA),
    "divx501": (b"DivX501b2000", b"DX50", mpeg4.IDCT_SIMPLE, 0),
    "divx503": (b"DivX503b1393", b"DX50", mpeg4.IDCT_SIMPLE,
                mpeg4.BUG_QPEL_CHROMA | mpeg4.BUG_QPEL_CHROMA2),
    "divx_tag": (None, b"DIVX", mpeg4.IDCT_SIMPLE, 0),
    "lavc": (b"Lavc62.28.101", b"XVID", mpeg4.IDCT_SIMPLE, 0),
}


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_xvid_and_divx_streams_decode_to_libavcodecs_planes(encoder):
    """The encoder the user data (or the tag) names sets the IDCT and the
    workarounds, as FFmpeg's ``ff_mpeg4_workaround_bugs`` does; a 72x88
    size (not whole macroblocks) reaches the edge workaround."""
    text, tag, idct, bugs = ENCODERS[encoder]
    packets = _patched(text, bf=2, flags="+qpel+mv4", qmin=2, qmax=5)
    want = mpeg4_oracle.decode(packets, codec_tag=tag)
    _decode_both(packets, want, codec_tag=tag)
    decoder = mpeg4.Decoder(codec_tag=tag)
    for p in packets:
        decoder.decode(p)
    assert (decoder.idct, decoder.bugs) == (idct, bugs)


@pytest.mark.parametrize("fourcc", [b"XVIX", b"xvix", b"RMP4", b"SIPP", b"ZMP4", b"3IV2", b"DIV1"])
def test_other_mpeg4_fourccs_read_to_cv2s_frames(fourcc, tmp_path):
    """FFmpeg takes these AVI tags for MPEG-4 Part 2 too; the first five,
    in any case, for XviD's (here: a stream without user data, so XviD's
    early-build workarounds), the others not."""
    data = (FIXTURES / "mpeg4_xvid_no_user_data.avi").read_bytes().replace(b"XVID", fourcc)
    (tmp_path / "a.avi").write_bytes(data)
    got = list(video.VideoReader(tmp_path / "a.avi"))
    want, _, _ = mpeg4_oracle.cv2_frames(tmp_path / "a.avi")
    assert len(got) == len(want) == 8 and all(np.array_equal(a, b) for a, b in zip(got, want))


def test_xvids_idct_is_not_the_simple_one():
    """On the same coefficients the two IDCTs differ (by 1 here and there),
    which is why an XviD stream needs its own."""
    rng = np.random.default_rng(4)
    blocks = np.where(rng.random((200, 64)) < 0.2, rng.integers(-300, 300, (200, 64)), 0)
    simple, xvid = mpeg4.simple_idct(blocks), mpeg4.xvid_idct(blocks)
    diff = np.abs(simple - xvid)
    assert 0 < diff.max() <= 2 and (diff > 0).mean() < 0.5


@pytest.mark.parametrize("flag", [b"p", b""])
def test_divx_packed_bitstreams_decode_as_ffmpeg_decodes_them(flag):
    """Each P-VOP and the B-VOP after it in one packet, then a not-coded
    placeholder: with the packed flag the B-VOP is held for the
    placeholder's packet, as FFmpeg holds it; without it FFmpeg decodes the
    first VOP of a packet alone, and so does the reader."""
    packets = mpeg4_oracle.encode(_frames(), 112, 96, bf=1, flags="+mv4")
    packed = fixtures.pack_b_frames(fixtures.user_data(b"DivX503b2000" + flag)(packets))
    want = mpeg4_oracle.decode(packed)
    assert (len(want) == len(packets)) == bool(flag)
    _decode_both(packed, want)


def test_a_vol_with_its_own_matrices_decodes_to_libavcodecs_planes():
    """An intra matrix of 64 values and an inter one ended early by a 0
    (its last value repeats), loaded in zigzag order."""
    packets = mpeg4_oracle.encode(_frames(), 112, 96, mpeg_quant=1, bf=1, qmin=2, qmax=4)
    packets = fixtures.rewrite_vol(packets, fixtures.custom_matrices)
    vol = mpeg4.Vol(packets[0][packets[0].index(b"\0\0\1\x20") + 4:])
    assert vol.quant_type and vol.inter_matrix.max() == 55
    assert not np.array_equal(vol.intra_matrix, mpeg4.T.DEFAULT_INTRA_MATRIX)
    _decode_both(packets, mpeg4_oracle.decode(packets))


@pytest.mark.parametrize("user_data", [b"XviD0073", b"Lavc62.28.101"])
def test_a_b_vop_clears_the_low_delay_guessed_for_a_vol_without_vol_control(user_data):
    """FFmpeg guesses low_delay 1 for a Simple or ASP VOL without
    vol_control_parameters and clears it at the first B-VOP: the P-VOP
    already shown is shown again one reference late, so 10 VOPs make 11
    frames."""
    packets = fixtures.user_data(user_data)(
        mpeg4_oracle.encode(_frames(), 112, 96, bf=2, flags="+mv4"))
    packets = fixtures.rewrite_vol(packets, fixtures.no_vol_control)
    want = mpeg4_oracle.decode(packets)
    assert len(want) == len(packets) + 1
    _decode_both(packets, want)
    decoder, low_delay = mpeg4.Decoder(), []
    for packet in packets[:3]:  # I, P, B
        decoder.decode(packet)
        low_delay.append(decoder.low_delay)
    assert low_delay == [1, 1, 0]


def test_user_data_is_read_as_ffmpegs_sscanf_reads_it():
    f = mpeg4.user_data_fields
    assert f(b"DivX503b1393p") == {"divx": (503, 1393, True)}
    assert f(b"DivX501Build413") == {"divx": (501, 413, False)}
    assert f(b"XviD0073") == {"xvid": 73}
    assert f(b"Lavc62.28.101") == {"lavc": (62 << 16) + (28 << 8) + 101}
    assert f(b"FFmpeg0.4.9-pre1b4718") == {"lavc": 4718}
    assert f(b"ffmpeg") == {"lavc": 4600}
    assert f(b"Mine") == {}


@pytest.mark.parametrize("name, form", [
    ("mpeg4_interlaced.avi", "interlaced video"),
    ("mpeg4_gmc.avi", "GMC (global motion compensation"),
    ("mpeg4_rvlc.avi", "reversible VLC"),
    ("mpeg4_short_header.avi", "the short video header (H.263)"),
])
def test_the_forms_still_refused_name_themselves(name, form):
    with pytest.raises(video.UnsupportedVideo) as err:
        list(video.VideoReader(FIXTURES / name))
    assert form in str(err.value) and "ROADMAP Queue 1 item 1" in str(err.value)


def test_a_static_sprite_vol_is_refused_by_its_name():
    packets = mpeg4_oracle.encode(_frames(48, 64, 2), 64, 48, flags="+qpel")

    def static(bits, at):
        s, n = at["sprite"], at["sprite_bits"]
        return bits[:s] + "01" + bits[s + n:]

    packets = fixtures.rewrite_vol(packets, static)
    with pytest.raises(mpeg4.UnsupportedMpeg4, match="static sprites"):
        mpeg4.Decoder().decode(packets[0])


@pytest.fixture(scope="module")
def asp_cli(inputs, tmp_path_factory):  # noqa: F811
    """Both CLIs' --video over an XviD ASP AVI (B-VOPs, quarter-pel, 4MV,
    MPEG quantisation, XviD's user data) and a 4:2:2 MJPEG AVI (cv2's JPEG
    encoder, no DHT: a webcam's), each of the 96x128 clip's eight frames
    (the size ``CLI_MEAN_ABS_DIFF`` was measured at), each -o out.avi
    (random colours seeded alike)."""
    import cv2

    root = tmp_path_factory.mktemp("asp_cli")
    clip = fixtures.pan(26, 96, 128, 8, 2, 1)
    fixtures.oracle_avi(root / "xvid.avi", clip, fourcc=b"XVID", bf=2, flags="+qpel+mv4",
                        mpeg_quant=1, patch=fixtures.user_data(b"XviD0073"))
    fixtures.mjpeg_avi(root / "mjpeg.avi", clip, dht=False,
                       cv2_sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)
    config = dict(_config(), visualizer={"type": "InferenceVisualizer", "dataset": "COCO",
                                         "with_mask": True, "conf_thresh": 0.3, "alpha": 0.6,
                                         "line_thickness": 1})
    (root / "config.json").write_text(json.dumps(config))
    env = dict(cpu_subprocess_env(), OMP_NUM_THREADS="1")
    seeded = "import random, runpy, sys; random.seed(0); sys.argv = sys.argv[1:]; "
    out = {}
    for source in ("xvid.avi", "mjpeg.avi"):
        args = ["-c", str(root / "config.json"), "-w", str(inputs / "weights.ckpt"), "--video",
                str(root / source)]
        for name, cmd in (
                ("jax", [sys.executable, "-c", seeded + "runpy.run_path(sys.argv[0], "
                         "run_name='__main__')", "infer.py"]),
                ("port", [sys.executable, "-c", seeded + "from orienmask_tpu_torch import infer; "
                          "raise SystemExit(infer.main(sys.argv[1:]))", "infer",
                          "--device", "cpu"])):
            path = root / f"{name}_{source}"
            proc = subprocess.run(cmd + args + ["-o", str(path)], cwd=REPO, env=env,
                                  capture_output=True, text=True, timeout=600)
            assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
            out[name, source] = (proc.stdout, path)
    return root, out


@pytest.mark.parametrize("source, committed", [("xvid.avi", "mpeg4_xvid.avi"),
                                               ("mjpeg.avi", "mjpeg_422_webcam.avi")])
def test_cli_over_an_xvid_asp_and_an_mjpeg_avi_agrees_with_the_jax_cli(asp_cli, source,
                                                                       committed):
    """The two CLIs read the same frames (the port's reader equals cv2's,
    frame for frame, here and on the committed fixture of the same form)
    and write outputs within ``CLI_MEAN_ABS_DIFF``."""
    root, asp_cli = asp_cli
    n, shape = 8, (96, 128, 3)
    for path, count in ((root / source, n), (FIXTURES / committed, DIGESTS[committed]["frames"])):
        port_frames = list(video.VideoReader(path))
        cv2_frames, _, _ = mpeg4_oracle.cv2_frames(path)
        assert len(port_frames) == len(cv2_frames) == count
        assert all(np.array_equal(a, b) for a, b in zip(port_frames, cv2_frames))
    (jax_out, jax_file), (port_out, port_file) = asp_cli["jax", source], asp_cli["port", source]
    assert f"Streamed {n} frames" in jax_out and f"Streamed {n} frames" in port_out
    want, want_fps, want_count = mpeg4_oracle.cv2_frames(jax_file)
    got, got_fps, got_count = mpeg4_oracle.cv2_frames(port_file)
    assert (len(got), got[0].shape, got_fps, got_count) == \
        (len(want), want[0].shape, want_fps, want_count) == (n, shape, 25.0, n)
    diff = np.mean([np.abs(a.astype(float) - b).mean() for a, b in zip(got, want)])
    print(f"{source}: mean absolute difference of the two CLIs' videos: {diff:.3f}")
    assert diff < CLI_MEAN_ABS_DIFF
