"""The port's MP4 and AVI containers (``data/mp4.py``, ``data/avi.py``,
through ``data/video.py``) against cv2's FFmpeg backend: the packets, rates
and frame counts cv2 reports for every committed video fixture; the files
the writer makes, read back by cv2 at the rates, counts and even sizes cv2
gives back from its own file; OpenDML segments past the 1 GiB boundary and
a 64-bit ``mdat`` with ``co64`` past 4 GiB (both at a boundary lowered for
the test); files cut short; a VOP that is not coded; and the refused
containers.  Clips are 176x144 or less."""

import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

import mpeg4_oracle
from orienmask_tpu_torch.data import avi, mp4, mpeg4_encode, video, yuv

FIXTURES = Path(__file__).resolve().parent / "image_fixtures"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
READABLE = sorted(n for n, d in DIGESTS.items() if n.endswith((".mp4", ".avi"))
                  and "refused" not in d)
RATES = (12.5, 23.976, 25, 29.97, 59.94)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _frames(n=14, height=72, width=88, seed=0):
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(rng.integers(0, 256, (height + 64, width + 64, 3), np.uint8),
                            (0, 0), 2)
    return [np.ascontiguousarray(base[i:i + height, 2 * i:2 * i + width]) for i in range(n)]


def _write(path, frames, fps):
    with video.VideoWriter(path, fps) as writer:
        for frame in frames:
            writer.write(frame)


def _cv2_write(path, frames, fps):
    height, width = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
    for frame in frames:
        writer.write(np.ascontiguousarray(frame[..., ::-1]))
    writer.release()


@pytest.mark.parametrize("name", READABLE)
def test_packets_rate_and_count_equal_cv2s(name):
    """The demuxed packets equal cv2's raw packets (``CAP_PROP_FORMAT`` -1)
    byte for byte; the rate and frame count equal cv2's, and the committed
    ones."""
    reader = video.VideoReader(FIXTURES / name)
    assert list(reader.packet_bytes()) == mpeg4_oracle.cv2_packets(FIXTURES / name)
    _, fps, count = mpeg4_oracle.cv2_frames(FIXTURES / name)
    assert (reader.fps, reader.frame_count) == (fps, count)
    assert (reader.fps, reader.frame_count) == (DIGESTS[name]["fps"],
                                                DIGESTS[name]["frame_count"])


@pytest.mark.parametrize("ext", ["mp4", "avi"])
@pytest.mark.parametrize("fps", RATES)
def test_written_rate_count_and_size_come_back_as_from_cv2s_own_file(tmp_path, ext, fps):
    frames = _frames(6)
    _write(tmp_path / f"port.{ext}", frames, fps)
    _cv2_write(tmp_path / f"cv2.{ext}", frames, fps)
    got, got_fps, got_count = mpeg4_oracle.cv2_frames(tmp_path / f"port.{ext}")
    want, want_fps, want_count = mpeg4_oracle.cv2_frames(tmp_path / f"cv2.{ext}")
    assert (len(got), got[0].shape, got_fps, got_count) == \
        (len(want), want[0].shape, want_fps, want_count)
    reader = video.VideoReader(tmp_path / f"port.{ext}")
    assert (reader.fps, reader.frame_count) == (want_fps, want_count)
    assert reader.container == ext


@pytest.mark.parametrize("ext", ["mp4", "avi"])
def test_odd_sizes_are_cut_to_even_as_cv2_cuts_them(tmp_path, ext):
    frames = [f[:33, :65] for f in _frames(3)]
    _write(tmp_path / f"odd.{ext}", frames, 25)
    got, _, _ = mpeg4_oracle.cv2_frames(tmp_path / f"odd.{ext}")
    assert got[0].shape == (32, 64, 3) == tuple(DIGESTS["video_odd_33x65.mp4"]["shape"])
    mine = list(video.VideoReader(tmp_path / f"odd.{ext}"))
    assert len(mine) == 3 and all(np.array_equal(a, b) for a, b in zip(mine, got))


def test_avi_goes_on_in_opendml_segments_past_the_riff_limit(tmp_path, monkeypatch):
    """Past ``avi.RIFF_LIMIT`` (1 GiB in use, 1.5 kB here) the writer ends the
    first RIFF with its ix00 and idx1 and goes on in RIFF AVIX segments;
    cv2 reads every frame, the port's reader the same ones."""
    monkeypatch.setattr(avi, "RIFF_LIMIT", 1500)
    frames = _frames(14)
    _write(tmp_path / "big.avi", frames, 25)
    data = (tmp_path / "big.avi").read_bytes()
    assert data.count(b"AVIX") >= 2 and b"indx" in data and b"ix00" in data and b"idx1" in data
    got, fps, count = mpeg4_oracle.cv2_frames(tmp_path / "big.avi")
    assert len(got) == 14 and count == 14 and fps == 25
    mine = list(video.VideoReader(tmp_path / "big.avi"))
    assert len(mine) == 14 and all(np.array_equal(a, b) for a, b in zip(mine, got))


def test_mp4_takes_a_64_bit_mdat_and_co64_past_the_large_boundary(tmp_path, monkeypatch):
    """Past ``mp4.LARGE`` (4 GiB in use, 1 kB here) the writer gives ``mdat``
    a 64-bit size and the chunk offsets ``co64``."""
    monkeypatch.setattr(mp4, "LARGE", 1000)
    frames = _frames(5)
    _write(tmp_path / "wide.mp4", frames, 25)
    data = (tmp_path / "wide.mp4").read_bytes()
    at = data.index(b"mdat") - 4
    assert struct.unpack_from(">I", data, at)[0] == 1 and b"co64" in data and b"stco" not in data
    got, _, count = mpeg4_oracle.cv2_frames(tmp_path / "wide.mp4")
    assert len(got) == 5 == count
    mine = list(video.VideoReader(tmp_path / "wide.mp4"))
    assert all(np.array_equal(a, b) for a, b in zip(mine, got))


@pytest.mark.parametrize("frac", [0.0, 0.5])
def test_an_avi_cut_short_yields_the_whole_frames_before_the_cut(tmp_path, frac):
    """Cut at or inside packet 5: the port yields frames 0-4, cv2's own.
    Cut inside the packet, cv2 also yields the damaged sixth frame its
    error concealment makes (a stated difference)."""
    frames = _frames(8)
    _write(tmp_path / "whole.avi", frames, 25)
    data = (tmp_path / "whole.avi").read_bytes()
    offset, size = video.VideoReader(tmp_path / "whole.avi").packets[5]
    (tmp_path / "cut.avi").write_bytes(data[:offset + int(size * frac)])
    got, _, _ = mpeg4_oracle.cv2_frames(tmp_path / "cut.avi")
    mine = list(video.VideoReader(tmp_path / "cut.avi"))
    assert len(mine) == 5 and all(np.array_equal(a, b) for a, b in zip(mine, got))
    assert len(got) == (5 if frac == 0 else 6)


def test_an_mp4_cut_before_its_movie_box_is_refused_and_cv2_reads_nothing(tmp_path):
    _write(tmp_path / "whole.mp4", _frames(4), 25)
    data = (tmp_path / "whole.mp4").read_bytes()
    (tmp_path / "cut.mp4").write_bytes(data[:data.index(b"moov") - 100])
    got, _, _ = mpeg4_oracle.cv2_frames(tmp_path / "cut.mp4")
    assert got == []
    with pytest.raises(video.UnsupportedVideo, match="movie box") as err:
        video.VideoReader(tmp_path / "cut.mp4")
    assert "ROADMAP Queue 1 item 1" in str(err.value)


def test_a_vop_not_coded_yields_no_frame_as_in_cv2(tmp_path):
    """FFmpeg outputs no frame for ``vop_coded`` 0; nor does the port."""
    frames = _frames(6)
    enc = mpeg4_encode.Encoder(88, 72, 25, global_header=False)
    packets = [enc.encode(*yuv.rgb_to_yuv420(f)) for f in frames]
    bits = mpeg4_encode.BitWriter()
    bits.start_code(0xB6)
    for n, v in ((2, 1), (1, 0), (1, 1), (enc.time_bits, 3), (1, 1), (1, 0)):
        bits.put(n, v)
    bits.stuffing()
    packets[3] = (bits.bytes()[0], False)
    with open(tmp_path / "nc.avi", "wb") as fh:
        writer = avi.Writer(fh, 88, 72, enc.rate)
        for packet, key in packets:
            writer.write(packet, key)
        writer.close()
    got, _, _ = mpeg4_oracle.cv2_frames(tmp_path / "nc.avi")
    mine = list(video.VideoReader(tmp_path / "nc.avi"))
    assert len(got) == len(mine) == 5
    assert all(np.array_equal(a, b) for a, b in zip(mine, got))


def test_an_mp4_edit_that_starts_later_hides_the_frames_before_it(tmp_path):
    """One edit whose media time is two frames in: FFmpeg decodes the
    first two samples but shows from the third; so does the port."""
    frames = _frames(6)
    _write(tmp_path / "full.mp4", frames, 25)
    data = bytearray((tmp_path / "full.mp4").read_bytes())
    reader = video.VideoReader(tmp_path / "full.mp4")
    track = mp4.read(bytes(data))
    at = data.index(b"elst") + 4
    delta = int(track.timescale / reader.fps)
    struct.pack_into(">i", data, at + 12, 2 * delta)  # media_time of the one edit
    (tmp_path / "edit.mp4").write_bytes(bytes(data))
    got, _, _ = mpeg4_oracle.cv2_frames(tmp_path / "edit.mp4")
    mine = list(video.VideoReader(tmp_path / "edit.mp4"))
    full = list(reader)
    assert len(mine) == len(got) == 4
    assert all(np.array_equal(a, b) for a, b in zip(mine, got))
    assert np.array_equal(mine[0], full[2])


@pytest.mark.parametrize("name", ["video_h264_tag.avi", "video_avc1.mp4",
                                  "video_fragmented.mp4", "mpeg4_short_header.avi"])
def test_refused_containers_name_their_form(name):
    """MPEG-4 Part 2 bytes under the ``H264`` fourcc (an H.264 stream
    without a sequence parameter set), an ``avc1`` sample entry without
    ``avcC``, a fragmented MP4 and the short video header (H.263) in an
    ``mp4v`` AVI (MJPEG in AVI, once refused here, is read:
    ``test_torch_mjpeg.py``; H.264 too: ``test_torch_h264.py``)."""
    with pytest.raises(video.UnsupportedVideo) as err:
        list(video.VideoReader(FIXTURES / name))
    assert DIGESTS[name]["refused"] in str(err.value)
    assert "ROADMAP Queue 1 item 1" in str(err.value)
    assert "this build reads MPEG-4 Part 2 Simple and Advanced Simple Profile" in str(err.value)


def test_the_refused_fixtures_are_what_their_names_say():
    """cv2 writes MJPG in AVI (read now); the H264-tagged AVI (MPEG-4 Part
    2 bytes), the avc1 file (an mp4v one renamed), the fragmented file and
    the short header are made by hand (probe/make_video_fixtures.py)."""
    assert avi.read((FIXTURES / "video_mjpg.avi").read_bytes()).fourcc == b"MJPG"
    assert avi.read((FIXTURES / "video_h264_tag.avi").read_bytes()).fourcc == b"H264"
    assert b"avc1" in (FIXTURES / "video_avc1.mp4").read_bytes()
    assert b"moof" in (FIXTURES / "video_fragmented.mp4").read_bytes()
    assert b"\0\0\x80" in (FIXTURES / "mpeg4_short_header.avi").read_bytes()


def test_the_writer_lays_files_out_as_ffmpeg_does(tmp_path):
    """AVI: hdrl, strh and strf carrying mp4v, movi, then idx1; MP4: ftyp
    isom, mdat, then moov with an mp4v esds, stts, stss, stco."""
    frames = _frames(3)
    _write(tmp_path / "a.avi", frames, 29.97)
    _write(tmp_path / "a.mp4", frames, 29.97)
    data = (tmp_path / "a.avi").read_bytes()
    strh = data[data.index(b"strh") + 8:]
    assert strh[:8] == b"vidsmp4v" and struct.unpack_from("<II", strh, 20) == (100, 2997)
    assert data.index(b"mp4v", data.index(b"strf")) and data.index(b"movi") < data.index(b"idx1")
    data = (tmp_path / "a.mp4").read_bytes()
    assert data[4:12] == b"ftypisom" and data.index(b"mdat") < data.index(b"moov")
    for box in (b"esds", b"stts", b"stss", b"stsc", b"stsz", b"stco", b"elst"):
        assert box in data
    track = mp4.read(data)
    assert (track.timescale, track.rate) == (11988, (2997, 100))
    assert track.config == mpeg4_encode.sequence_headers(88, 72, (2997, 100))


def test_avi_reads_through_rec_lists_and_skips_other_streams():
    """A movi of LIST rec groups holding an audio chunk and the video
    chunks: the video stream's packets in file order."""
    packets = [b"\0\0\1\xb6\x10", b"\0\0\1\xb6\x50\x01"]

    def chunk(kind, payload):
        return kind + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)

    def lst(kind, payload):
        return b"LIST" + struct.pack("<I", len(payload) + 4) + kind + payload

    strh_a = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"auds", b"\0" * 4, 0, 0, 0, 0, 1, 8000, 0,
                         0, 0, 0, 0, 0, 0, 0, 0)
    strh_v = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"mp4v", 0, 0, 0, 0, 1, 25, 0, 2, 0,
                         0, 0, 0, 0, 16, 16)
    strf_v = struct.pack("<IiiHH4sIiiII", 40, 16, 16, 1, 24, b"mp4v", 768, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", bytes(56)) + lst(b"strl", chunk(b"strh", strh_a))
               + lst(b"strl", chunk(b"strh", strh_v) + chunk(b"strf", strf_v)))
    movi = lst(b"movi", lst(b"rec ", chunk(b"00wb", b"abc") + chunk(b"01dc", packets[0]))
               + lst(b"rec ", chunk(b"01dc", packets[1])))
    body = b"AVI " + hdrl + movi
    data = b"RIFF" + struct.pack("<I", len(body)) + body
    stream = avi.read(data)
    assert [data[o:o + s] for o, s in stream.chunks] == packets
    assert (stream.rate, stream.length, stream.fourcc) == ((25, 1), 2, b"mp4v")


def test_writers_name_what_they_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="'.mkv'"):
        video.VideoWriter(tmp_path / "a.mkv", 25)
    with pytest.raises(ValueError, match="16-bit"):
        video.VideoWriter(tmp_path / "a.mp4", 1234.5678)
    writer = video.VideoWriter(tmp_path / "a.mp4", 25)
    writer.write(np.zeros((16, 16, 3), np.uint8))
    with pytest.raises(ValueError, match="32x16 frame for a 16x16 video"):
        writer.write(np.zeros((16, 32, 3), np.uint8))
    writer.close()
    assert mpeg4_encode.cv2_rate(29.97) == (2997, 100)
    assert mpeg4_encode.cv2_rate(12.5) == (25, 2)
    assert mpeg4_encode.cv2_rate(23.976) == (2997, 125)


@pytest.mark.parametrize("name", ["video_clip_96x128.mp4", "video_176x144_2997.avi"])
def test_damaged_files_read_or_are_refused_by_name(tmp_path, name):
    """Bytes of the headers and packets overwritten at seeded places: each
    file reads, or is refused with ``UnsupportedVideo``; nothing else
    escapes."""
    data = (FIXTURES / name).read_bytes()
    rng = np.random.default_rng(22)
    outcomes = set()
    for trial in range(60):
        damaged = bytearray(data)
        for _ in range(3):
            if name.endswith(".mp4") and trial % 2:  # the moov at the end
                at = len(damaged) - int(rng.integers(1, 900))
            else:
                at = int(rng.integers(0, len(damaged)))
            damaged[at] = int(rng.integers(0, 256))
        (tmp_path / name).write_bytes(bytes(damaged))
        try:
            list(video.VideoReader(tmp_path / name))
            outcomes.add("read")
        except video.UnsupportedVideo:
            outcomes.add("refused")
    assert outcomes == {"read", "refused"}
