"""The port's MPEG-4 Part 2 reader and ``mp4v`` writer (``data/mpeg4.py``,
``data/mpeg4_encode.py``, ``data/yuv.py``, ``data/video.py``) against
libavcodec and libswscale (``mpeg4_oracle.py``, the libraries behind cv2
here) and ``cv2.VideoCapture`` itself, and the infer CLI's ``--video
<file>`` and ``-o *.mp4|*.avi`` against the JAX CLI.

Decoding: the Y, U and V planes equal libavcodec's on every committed
fixture and on streams made here with 4MV, resync markers, f_code 2 and
above, quantisers 2 and 31, sizes that are not whole macroblocks, all-intra
and scene cuts; the RGB frames equal cv2's bit for bit (and the committed
digests the card checks); the C++ loops equal their Python versions.
Writing: cv2 reads the port's files to the writer's own reconstruction,
at a PSNR no more than 1 dB below cv2's own file of the same frames and
at most twice its bytes.  The colour conversion for writing takes
libswscale's luma exactly and its chroma to within 1 (on 12.45% of the V and
13.11% of the U samples of the test's image: a stated difference).  Refused streams name their form.
The committed fixtures include the Advanced Simple Profile's, XviD's and
DivX's and Motion JPEG's (``test_torch_video_asp.py`` and
``test_torch_mjpeg.py`` make more here).  Clips are 176x144 or less, but
for the committed 720x1280 files and the 480x640 MJPEG."""

import hashlib
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import mpeg4_oracle
from orienmask_tpu.utils.envs import cpu_subprocess_env
from orienmask_tpu_torch.data import h264, mjpeg, mpeg4, mpeg4_encode, video, yuv
from orienmask_tpu_torch.data.image_io import write_png
from chip_smoke import both_loops_decoder
from test_torch_infer import _config, inputs  # noqa: F401 (the fixture)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
READABLE = sorted(n for n, d in DIGESTS.items() if n.endswith((".mp4", ".avi"))
                  and "refused" not in d)
SMALL = [n for n in READABLE if "720x1280" not in n]
# the MPEG-4 streams still refused: cv2 reads them to frames (interlaced:
# near-black, after libswscale's "Cannot convert interlaced to progressive";
# GMC and reversible VLC: what libavcodec makes of the rewritten VOL)
REFUSED_STREAMS = ["mpeg4_interlaced.avi", "mpeg4_gmc.avi", "mpeg4_rvlc.avi"]
# the mean absolute difference of the two CLIs' videos as cv2 reads them,
# over every pixel of every frame: measured 2.97 on the 96x128 clip (2.28-3.25
# a frame, at most 40 at a pixel), both CLIs drawing the same detections in
# the same colours, each file through its own encoder; the drawings differ
# from the clip by 23.8
CLI_MEAN_ABS_DIFF = 4.0


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _equal_planes(got, want):
    return len(got) == len(want) and all(
        all(np.array_equal(a, b) for a, b in zip(g, w)) for g, w in zip(got, want))


def _scene(h, w, n, dx, dy, seed=0):
    """``n`` (Y, U, V) frames panning over blurred noise."""
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur(rng.integers(0, 256, (h + n * dy + 32, w + n * dx + 32), np.uint8)
                           .astype(np.float32), (0, 0), 2.5)
    big = np.clip((big - big.mean()) * 4 + 128, 0, 255).astype(np.uint8)
    out = []
    for i in range(n):
        y = np.ascontiguousarray(big[i * dy:i * dy + h, i * dx:i * dx + w])
        u = cv2.resize(y, (w // 2, h // 2), interpolation=cv2.INTER_AREA)
        out.append((y, u, 255 - u))
    return out


@pytest.mark.parametrize("name", READABLE)
def test_planes_equal_libavcodecs(name):
    """libavcodec's ``mpeg4`` (with the AVI's codec tag, as FFmpeg's
    demuxer sets it), ``mjpeg`` or ``h264`` decoder (opened at the delay
    cv2's probe finds; Annex B packets carry their parameter sets; the
    pictures of the packets an MP4 edit leaves out dropped)."""
    reader = video.VideoReader(FIXTURES / name)
    if reader.codec == "h264":
        packets = list(reader.packet_bytes())
        delay = h264.probe_delay(packets, reader.config, reader.codec_tag, annexb=reader.annexb,
                                 mp4=reader.probe)
        sources = []
        want = mpeg4_oracle.decode(packets, b"" if reader.annexb else reader.config,
                                   codec=b"h264", delay=delay, sources=sources)
        if reader.shown is not None:  # the pictures of the packets an MP4 edit leaves out
            want = [w for w, src in zip(want, sources) if src in reader.shown]
        assert _equal_planes(list(reader.planes()), want)
        return
    codec = b"mjpeg" if reader.codec == "mjpeg" else b"mpeg4"
    want = mpeg4_oracle.decode(list(reader.packet_bytes()), reader.config,
                               codec_tag=reader.codec_tag if reader.container == "avi" else b"",
                               codec=codec)
    assert _equal_planes(list(reader.planes()), want)


@pytest.mark.parametrize("name", READABLE)
def test_rgb_frames_equal_cv2s(name):
    """Bit for bit, and the committed digests the card's phase 25 checks."""
    got = list(video.VideoReader(FIXTURES / name))
    want, _, _ = mpeg4_oracle.cv2_frames(FIXTURES / name)
    assert len(got) == len(want) == DIGESTS[name]["frames"]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert [hashlib.sha256(f.tobytes()).hexdigest() for f in got] == \
        DIGESTS[name]["frame_sha256"]


SETTINGS = {
    "4mv": (dict(flags="+mv4"), 144, 176, 3, 2),
    "resync": (dict(ps=150), 144, 176, 3, 2),
    "fcode": (dict(), 96, 112, 40, 9),
    "q2": (dict(qmin=2, qmax=2), 64, 80, 3, 2),
    "q31": (dict(qmin=31, qmax=31), 144, 176, 3, 2),
    "72x40": (dict(flags="+mv4", ps=100), 72, 40, 5, 3),
    "4mv_resync_fcode": (dict(flags="+mv4", ps=150, qmin=9, qmax=9), 96, 120, 17, 5),
    "intra_only": (dict(g=1), 48, 64, 3, 1),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_streams_of_each_setting_decode_to_libavcodecs_planes(setting):
    """Streams libavcodec makes with settings cv2 cannot choose; a scene cut
    at frame 5 makes intra macroblocks in P-VOPs.  The C++ and the plain
    decoder both equal libavcodec.  The scenes clip to 0 in places, so the
    4mv and resync streams reach FFmpeg's x86 no-rounding averages of 8-wide
    blocks next to a 0 pixel (``mpeg4.half_pel``); both fail without them."""
    options, h, w, dx, dy = SETTINGS[setting]
    frames = _scene(h, w, 9, dx, dy)
    frames[5:] = _scene(h, w, 4, dx, dy, seed=1)
    packets = mpeg4_oracle.encode(frames, w, h, **options)
    want = mpeg4_oracle.decode(packets)
    for native in (True, False):
        decoder = mpeg4.Decoder(native=native)
        got = [f for p in packets for f in decoder.decode(p)]
        assert _equal_planes(got, want), native
    if setting.endswith("fcode"):
        vol = mpeg4.Vol(packets[0][packets[0].index(b"\0\0\1\x20") + 4:])
        fcodes = {mpeg4.Vop(p[p.index(b"\0\0\1\xb6") + 4:], vol).fcode for p in packets}
        assert max(fcodes) >= 2


@pytest.mark.parametrize("name", SMALL)
def test_the_cpp_macroblock_loop_equals_the_plain_one(name):
    """Each VOP, through ``chip_smoke.py``'s decoder of both loops: the
    same planes, end bit, kinds and stored vectors (B-VOPs, quarter-pel,
    MPEG quantisation, XviD's IDCT, data partitioning too); each MJPEG
    frame: the same planes; each H.264 stream: the same planes."""
    reader = video.VideoReader(FIXTURES / name)
    if reader.codec == "h264":
        got = []
        for native in (False, True):
            decoder = h264.Decoder(reader.config, native=native, codec_tag=reader.codec_tag,
                                   annexb=reader.annexb)
            got.append([f for p in reader.packet_bytes() for f in decoder.decode(p)] +
                       decoder.flush())
        assert got[0] and _equal_planes(*got)
        return
    if reader.codec == "mjpeg":
        for packet in reader.packet_bytes():
            frame = mjpeg.parse(packet, reader.height)
            assert all(np.array_equal(a, b) for a, b in zip(mjpeg.planes_native(frame),
                                                             mjpeg.planes_py(frame)))
        return
    both_loops = both_loops_decoder()
    decoder = both_loops(reader.config, codec_tag=reader.codec_tag)
    for packet in reader.packet_bytes():
        decoder.decode(packet)
    assert both_loops.vops >= 1


@pytest.mark.parametrize("size", [(72, 88), (40, 72)])
def test_the_cpp_encoder_loop_equals_the_plain_one(size):
    h, w = size
    frames = _scene(h, w, 4, 3, 2)
    plain = mpeg4_encode.Encoder(w, h, 25, global_header=True, native=False)
    cpp = mpeg4_encode.Encoder(w, h, 25, global_header=True, native=True)
    for frame in frames:
        assert plain.encode(*frame) == cpp.encode(*frame)
        assert all(np.array_equal(a, b) for a, b in zip(plain.ref, cpp.ref))


def test_the_colour_loops_equal_their_plain_versions():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (34, 50, 3), np.uint8)
    planes = yuv.rgb_to_yuv420_py(rgb)
    assert all(np.array_equal(a, b) for a, b in zip(planes, yuv.rgb_to_yuv420_native(rgb)))
    y, u, v = (rng.integers(0, 256, s, np.uint8) for s in ((35, 51), (18, 26), (18, 26)))
    assert np.array_equal(yuv.yuv420_to_rgb_py(y, u, v), yuv.yuv420_to_rgb_native(y, u, v))


def test_yuv_to_rgb_equals_libswscales_on_every_yuv_triple():
    """4096x4096 luma whose 2x2 blocks share one of the 65,536 (U, V)
    pairs: every (Y, U, V) once."""
    b = np.arange(2048 * 2048)
    u = (b % 65536 >> 8).astype(np.uint8).reshape(2048, 2048)
    v = (b % 256).astype(np.uint8).reshape(2048, 2048)
    group = (b // 65536 * 4).reshape(2048, 2048)
    y = np.zeros((4096, 4096), np.uint8)
    for k, (dy, dx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        y[dy::2, dx::2] = group + k
    want = mpeg4_oracle.yuv420_to_bgr(y, u, v)[..., ::-1]
    assert np.array_equal(yuv.yuv420_to_rgb(y, u, v), want)


def test_rgb_to_yuv_luma_equals_libswscales_and_chroma_is_within_one():
    """The stated difference: libswscale rounds its 2x2 chroma in two
    stages; the port rounds the mean once."""
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (128, 128, 3), np.uint8)
    y, u, v = yuv.rgb_to_yuv420(rgb)
    wy, wu, wv = mpeg4_oracle.bgr_to_yuv420(rgb[..., ::-1])
    assert np.array_equal(y, wy)
    for name, got, want in (("U", u, wu), ("V", v, wv)):
        diff = np.abs(got.astype(int) - want)
        print(f"{name}: {diff.mean():.4f} of the samples 1 from libswscale's")
        assert diff.max() <= 1 and diff.mean() < 0.15


def _frames(n, h=144, w=176):
    rng = np.random.default_rng(5)
    base = cv2.GaussianBlur(rng.integers(0, 256, (h + 64, w + 96, 3), np.uint8), (0, 0), 2)
    return [np.ascontiguousarray(base[i:i + h, 3 * i:3 * i + w]) for i in range(n)]


@pytest.mark.parametrize("ext", ["mp4", "avi"])
def test_cv2_reads_the_writers_file_to_its_reconstruction(tmp_path, ext):
    frames = _frames(14)
    recon = []
    with video.VideoWriter(tmp_path / f"a.{ext}", 29.97) as writer:
        for frame in frames:
            writer.write(frame)
            recon.append(yuv.yuv420_to_rgb(*writer.reconstruction()))
    got, fps, count = mpeg4_oracle.cv2_frames(tmp_path / f"a.{ext}")
    assert (len(got), fps, count) == (14, 29.97, 14)
    assert all(np.array_equal(a, b) for a, b in zip(got, recon))
    mine = list(video.VideoReader(tmp_path / f"a.{ext}"))
    assert all(np.array_equal(a, b) for a, b in zip(mine, recon))


def _psnr(frames, got):
    mse = [np.mean((a.astype(float) - b) ** 2) for a, b in zip(frames, got)]
    return float(np.mean([10 * np.log10(255 ** 2 / m) for m in mse]))


@pytest.mark.parametrize("ext", ["mp4", "avi"])
def test_the_writer_is_within_1_db_and_2x_the_bytes_of_cv2s_file(tmp_path, ext):
    """The same 24 frames through cv2's writer and the port's (measured
    33.57 against 34.41 dB, 0.78x the bytes in MP4 and 0.81x in AVI)."""
    frames = _frames(24)
    with video.VideoWriter(tmp_path / f"port.{ext}", 25) as writer:
        for frame in frames:
            writer.write(frame)
    cw = cv2.VideoWriter(str(tmp_path / f"cv2.{ext}"), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (176, 144))
    for frame in frames:
        cw.write(np.ascontiguousarray(frame[..., ::-1]))
    cw.release()
    port, _, _ = mpeg4_oracle.cv2_frames(tmp_path / f"port.{ext}")
    ref, _, _ = mpeg4_oracle.cv2_frames(tmp_path / f"cv2.{ext}")
    sizes = [os.path.getsize(tmp_path / f"{w}.{ext}") for w in ("port", "cv2")]
    print(f"{ext}: the port's writer {_psnr(frames, port):.2f} dB, {sizes[0]} bytes; cv2's "
          f"{_psnr(frames, ref):.2f} dB, {sizes[1]} bytes")
    assert _psnr(frames, port) >= _psnr(frames, ref) - 1.0
    assert sizes[0] <= 2 * sizes[1]


@pytest.mark.parametrize("name", REFUSED_STREAMS)
def test_refused_streams_name_their_form(name):
    """Each refused stream names its form; the frames read before the
    refusal are cv2's first frames, in cv2's order (none: each is refused
    at its VOL, where cv2 reads frames)."""
    got = []
    with pytest.raises(video.UnsupportedVideo) as err:
        for frame in video.VideoReader(FIXTURES / name):
            got.append(frame)
    assert DIGESTS[name]["refused"] in str(err.value)
    assert "ROADMAP Queue 1 item 1" in str(err.value)
    want, _, _ = mpeg4_oracle.cv2_frames(FIXTURES / name)
    assert len(got) < len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_xvid_and_divx_streams_and_packed_bitstreams_are_refused():
    """The XviD, DivX and packed forms this test once refused are read now,
    as FFmpeg reads them: the cv2-written XVID-tagged stream (libavcodec's
    user data) to cv2's frames; with XviD's or DivX's user data in its
    place, or none under the XVID tag, to libavcodec's planes (XviD's IDCT
    and workarounds); two VOPs in one packet without DivX's packed flag
    decode the first alone, as FFmpeg does.  The short video header (H.263)
    stays refused."""
    reader = video.VideoReader(FIXTURES / "video_xvid_tag.avi")
    assert reader.codec_tag == b"XVID" and len(list(reader)) == 6  # cv2's, with Lavc data
    packets = list(reader.packet_bytes())
    for patched in ([packets[0].replace(b"Lavc", b"XviD")] + packets[1:],
                    [packets[0].replace(b"Lavc", b"DivX")] + packets[1:],
                    [packets[0].replace(b"Lavc", b"Mine")] + packets[1:]):
        want = mpeg4_oracle.decode(patched, codec_tag=b"XVID")
        for native in (True, False):
            decoder = mpeg4.Decoder(codec_tag=b"XVID", native=native)
            got = [f for p in patched for f in decoder.decode(p)] + decoder.flush()
            assert _equal_planes(got, want)
    want = mpeg4_oracle.decode([packets[0], packets[1] + packets[2]])
    decoder = mpeg4.Decoder()
    got = [f for p in (packets[0], packets[1] + packets[2]) for f in decoder.decode(p)]
    assert _equal_planes(got, want)
    with pytest.raises(mpeg4.UnsupportedMpeg4, match="short video header"):
        mpeg4.Decoder().decode(b"\0\0\x80\x02\x0a" + bytes(20))


@pytest.fixture(scope="module")
def clip_cli(inputs, tmp_path_factory):  # noqa: F811
    """Both CLIs' --video clip.mp4 -o out.avi (random colours seeded alike)."""
    root = tmp_path_factory.mktemp("video_cli")
    config = dict(_config(), visualizer={"type": "InferenceVisualizer", "dataset": "COCO",
                                         "with_mask": True, "conf_thresh": 0.3, "alpha": 0.6,
                                         "line_thickness": 1})
    (root / "config.json").write_text(json.dumps(config))
    clip = FIXTURES / "video_clip_96x128.mp4"
    args = ["-c", str(root / "config.json"), "-w", str(inputs / "weights.ckpt"), "--video",
            str(clip)]
    env = dict(cpu_subprocess_env(), OMP_NUM_THREADS="1")
    seeded = "import random, runpy, sys; random.seed(0); sys.argv = sys.argv[1:]; "
    out = {}
    for name, cmd in (
            ("jax", [sys.executable, "-c", seeded + "runpy.run_path(sys.argv[0], "
                     "run_name='__main__')", "infer.py"]),
            ("port", [sys.executable, "-c", seeded + "from orienmask_tpu_torch import infer; "
                      "raise SystemExit(infer.main(sys.argv[1:]))", "infer",
                      "--device", "cpu"])):
        proc = subprocess.run(cmd + args + ["-o", str(root / f"{name}.avi")], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        out[name] = (proc.stdout, root / f"{name}.avi")
    return out


def test_cli_video_file_in_and_out_agrees_with_the_jax_cli(clip_cli):
    (jax_out, jax_file), (port_out, port_file) = clip_cli["jax"], clip_cli["port"]
    assert "Streamed 8 frames" in jax_out and "Streamed 8 frames" in port_out
    want, want_fps, want_count = mpeg4_oracle.cv2_frames(jax_file)
    got, got_fps, got_count = mpeg4_oracle.cv2_frames(port_file)
    assert (len(got), got[0].shape, got_fps, got_count) == \
        (len(want), want[0].shape, want_fps, want_count) == (8, (96, 128, 3), 25.0, 8)
    diff = np.mean([np.abs(a.astype(float) - b).mean() for a, b in zip(got, want)])
    print(f"mean absolute difference of the two CLIs' videos: {diff:.3f}")
    assert diff < CLI_MEAN_ABS_DIFF
    mine = list(video.VideoReader(port_file))
    assert all(np.array_equal(a, b) for a, b in zip(mine, got))


def test_cli_frame_directory_to_a_video_at_25_fps(inputs, tmp_path):  # noqa: F811
    """A directory source writes its drawings at 25.0, as the JAX CLI."""
    from orienmask_tpu_torch import infer

    config = dict(_config(), visualizer={"type": "InferenceVisualizer", "dataset": "COCO"})
    (tmp_path / "config.json").write_text(json.dumps(config))
    frames = tmp_path / "frames"
    frames.mkdir()
    for i, frame in enumerate(_frames(3, 96, 128)):
        write_png(frames / f"f{i}.png", frame)
    random.seed(0)
    assert infer.main(["--device", "cpu", "-c", str(tmp_path / "config.json"), "-w",
                       str(inputs / "weights.ckpt"), "--video", str(frames), "-o",
                       str(tmp_path / "out.mp4"), "-n", "2"]) == 0
    reader = video.VideoReader(tmp_path / "out.mp4")
    assert (reader.fps, reader.frame_count, len(list(reader))) == (25.0, 2, 2)


def test_a_new_size_waits_for_an_i_vop_and_a_wrong_reference_raises():
    """A VOL of another size mid-stream drops the reference, so the C++
    loop never predicts from planes of the old size; a reference of the
    wrong shape handed to it raises."""
    small = mpeg4_oracle.encode(_scene(48, 64, 3, 1, 1), 64, 48)
    large = mpeg4_oracle.encode(_scene(64, 80, 3, 1, 1), 80, 64)
    headers = large[0][:large[0].index(b"\0\0\1\xb6")]  # the larger VOL alone
    decoder = mpeg4.Decoder()
    shapes = [f[0].shape for p in small + [headers, large[1]] + large
              for f in decoder.decode(p)]
    assert shapes == [(48, 64)] * 3 + [(64, 80)] * 3  # large[1], a P-VOP, waits
    packet = large[0]
    at = decoder._headers(packet)
    vop = mpeg4.Vop(packet[at:], decoder.vol)
    wrong = [np.zeros((48, 64), np.uint8), np.zeros((24, 32), np.uint8),
             np.zeros((24, 32), np.uint8)]
    with pytest.raises(ValueError, match="reference"):
        mpeg4.decode_vop_native(packet[at:], vop.bitpos, mpeg4.params(decoder.vol, vop), wrong)


def test_spatial_2_reads_a_video_file_and_rank_0_alone_writes(inputs, tmp_path, capfd):  # noqa: F811
    """--video <file> -o out.mp4 under --spatial 2: both ranks read the
    file and run the stream's loop (gloo on the CPU); rank 0 alone reports
    and writes the video, at the clip's rate."""
    from orienmask_tpu_torch import infer

    config = dict(_config(), visualizer={"type": "InferenceVisualizer", "dataset": "COCO"})
    (tmp_path / "config.json").write_text(json.dumps(config))
    assert infer.main(["--device", "cpu", "-c", str(tmp_path / "config.json"), "-w",
                       str(inputs / "weights.ckpt"), "--video",
                       str(FIXTURES / "video_clip_96x128.mp4"), "-n", "3", "-o",
                       str(tmp_path / "out.mp4"), "--stream-depth", "1", "--spatial", "2"]) == 0
    assert capfd.readouterr().out.count("Streamed 3 frames (depth=1)") == 1
    reader = video.VideoReader(tmp_path / "out.mp4")
    assert (reader.fps, reader.frame_count) == (25.0, 3)
    assert [f.shape for f in reader] == [(96, 128, 3)] * 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["config.json", "out.mp4"]
