"""Write the video fixtures of ``tests/image_fixtures/`` and cv2's reading
of them in ``digests.json`` (beside the image ones).

Each clip pans over a seeded smooth scene (``make_jpeg_fixtures.py::
scene``).  Written by cv2 (``mp4v``, its FFmpeg backend): the 24-frame
720x1280 scene in MP4 at 25 and in AVI at 29.97 (``chip_smoke.py`` phase
25 streams them through the 736² model), a 96x128 MP4 the CLI tests run
both CLIs on, a 176x144 AVI of two groups of VOPs, a 33x65 MP4 (stored as
32x64), an AVI tagged ``XVID``, and an MJPEG AVI (refused).  Encoded by
libavcodec with settings cv2 cannot choose (``tests/mpeg4_oracle.py``),
wrapped in AVI by the port's writer (``data/avi.py``): 4MV, resync markers,
f_code 2 and above, quantisers 2 and 31, a 72x40 size (not whole
macroblocks) with 4MV and resync markers; the Advanced Simple Profile:
B-VOPs (2 and 3 between references, with 4MV), quarter-pel (with and
without B-VOPs), MPEG quantisation (the default matrices, and a VOL
rewritten to load its own), data partitioning with resync markers, the
user data of XviD (build 73) and DivX (5.03 build 1393), an XviD
stream with B-VOPs whose VOL leaves out vol_control_parameters (FFmpeg
guesses low_delay, then clears it at the first B-VOP), an ``XVID``-tagged
stream without user data (FFmpeg takes it for an early XviD build, with
its edge, DC and chroma workarounds), a DivX packed stream (each P-VOP and
the B-VOP after it in one chunk, then a not-coded placeholder), and an ASP
stream in MP4; Motion JPEG in AVI: libavcodec's 4:2:0 and 4:2:2 with and
without DHT segments, and cv2's JPEG encoder at 4:2:2 (2x1 sampling, as
webcams write it) without DHT; the two chip-phase files (a 720x1280
24-frame ASP AVI with XviD's user data, B-VOPs, quarter-pel, 4MV and MPEG
quantisation; a 480x640 4:2:2 MJPEG AVI as a webcam writes it).  Refused:
interlaced video (libavcodec's ``+ildct``; cv2 here reads it to
near-constant frames), three Simple Profile frames followed by it (refused
mid-stream), and by hand: GMC and reversible VLC (a VOL's bits rewritten), the
short video header, an AVI of another fourcc, an MP4 whose sample entry is
``avc1`` and a fragmented MP4 (``moof``).

A readable fixture's entry holds cv2's frame count, size, ``CAP_PROP_FPS``
and ``CAP_PROP_FRAME_COUNT``, and the SHA-256 of each frame as
``cv2.cvtColor(frame, COLOR_BGR2RGB)``; a refused one holds the form it is
refused as.  ``chip_smoke.py`` (phase 25) checks the port's reads on the
card's machine, which has no cv2; ``tests/test_torch_video.py`` and
``tests/test_torch_mp4_avi.py`` hold them to cv2 and libavcodec on every
run.

Run from the repository root on a machine with cv2:
``python3 probe/make_video_fixtures.py``.
"""

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "image_fixtures"
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "probe")]
import mpeg4_oracle  # noqa: E402
from make_jpeg_fixtures import scene  # noqa: E402

from orienmask_tpu_torch.data import avi, mp4, mpeg4, mpeg4_encode  # noqa: E402


def pan(seed, height, width, n, dx, dy):
    """``n`` RGB frames of ``height`` x ``width`` panning (dx, dy) pixels a
    frame over a seeded scene."""
    big = scene(seed, height + abs(dy) * n + 1, width + abs(dx) * n + 1)
    out = []
    for i in range(n):
        y0 = i * dy if dy >= 0 else (n - 1 - i) * -dy
        x0 = i * dx if dx >= 0 else (n - 1 - i) * -dx
        out.append(np.ascontiguousarray(big[y0:y0 + height, x0:x0 + width]))
    return out


def cv2_write(path, frames, fps, fourcc="mp4v", size=None):
    height, width = frames[0].shape[:2]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), fps,
                             size or (width, height))
    for frame in frames:
        writer.write(np.ascontiguousarray(frame[..., ::-1]))
    writer.release()


def oracle_packets(frames, fps=25, **options):
    """libavcodec's ``mpeg4`` stream of RGB ``frames`` with ``options``."""
    height, width = frames[0].shape[:2]
    planes = [mpeg4_oracle.bgr_to_yuv420(f[..., ::-1]) for f in frames]
    return mpeg4_oracle.encode(planes, width, height, mpeg4_encode.cv2_rate(fps), **options)


def write_avi(path, packets, width, height, fps=25, fourcc=b"mp4v", keys=None):
    """``packets`` in an AVI of the port's writer, its tag (``strh`` and
    ``strf``, the first two ``mp4v`` of the file) made ``fourcc``."""
    rate = mpeg4_encode.cv2_rate(fps)
    buf = io.BytesIO()
    writer = avi.Writer(buf, width, height, rate)
    for i, packet in enumerate(packets):
        writer.write(packet, keys[i] if keys else i % 12 == 0)
    writer.close()
    path.write_bytes(buf.getvalue().replace(b"mp4v", fourcc, 2))


def oracle_avi(path, frames, fps=25, fourcc=b"mp4v", patch=None, **options):
    """libavcodec's stream of ``frames`` with ``options`` (``patch`` applied
    to its packets), in an AVI tagged ``fourcc``."""
    height, width = frames[0].shape[:2]
    packets = oracle_packets(frames, fps, **options)
    if patch:
        packets = patch(packets)
    write_avi(path, packets, width, height, fps, fourcc, keys=[is_key(p) for p in packets])
    return packets


def user_data(text):
    """A patch: each packet's user data (libavcodec's ``Lavc...``, with its
    headers before each I-VOP) replaced by ``text``, or dropped for None."""
    def one(p):
        if b"\0\0\1\xb2" not in p:
            return p
        i = p.index(b"\0\0\1\xb2")
        j = p.index(b"\0\0\1", i + 4)
        return p[:i] + (b"\0\0\1\xb2" + text if text is not None else b"") + p[j:]

    return lambda packets: [one(p) for p in packets]


def is_key(packet):
    return b"\0\0\1\xb6" in packet and packet[packet.index(b"\0\0\1\xb6") + 4] >> 6 == 0


def rewrite_vol(packets, edit):
    """The first packet with its VOL's bits rewritten by ``edit(bits, at)``,
    ``at`` the positions ``mpeg4.Vol`` reads its fields from."""
    p0 = packets[0]
    start = p0.index(b"\0\0\1\x20") + 4
    end = p0.index(b"\0\0\1", start)
    bits = "".join(f"{b:08b}" for b in p0[start:end])
    bits = bits[:bits.rindex("0")]  # next_start_code's stuffing: a 0, then ones
    bits = edit(bits, _vol_positions(p0[start:end]))
    bits += "0" + "1" * ((8 - (len(bits) + 1) % 8) % 8)
    vol = int(bits, 2).to_bytes(len(bits) // 8, "big")
    return [p0[:start] + vol + p0[end:]] + packets[1:]


def _vol_positions(vol):
    """Where ``mpeg4.Vol`` reads vol_control_parameters (and where they
    end), sprite_enable, quant_type and reversible_vlc (the bit after
    data_partitioned)."""
    r = mpeg4.BitReader(vol)
    r.bits(9)
    verid = 1
    if r.bit():
        verid = r.bits(4)
        r.bits(3)
    if r.bits(4) == 15:
        r.bits(16)
    at = {"vol_control": r.pos}
    if r.bit():
        r.bits(3)
        if r.bit():
            for n in (15, 1, 15, 1, 15, 1, 3, 11, 1, 15, 1):
                r.bits(n)
    at["vol_control_end"] = r.pos
    r.bits(3)
    resolution = r.bits(16)
    r.bits(1)
    if r.bit():
        r.bits(max(1, (resolution - 1).bit_length()))
    r.bits(1 + 13 + 1 + 13 + 1 + 1 + 1)
    at.update(sprite=r.pos, sprite_bits=1 if verid == 1 else 2)
    r.bits(at["sprite_bits"] + 1)
    at["quant_type"] = r.pos
    if r.bit():
        for _ in range(2):
            if r.bit():
                while r.bits(8):
                    pass
    if verid != 1:
        r.bits(1)
    r.bits(2)
    at["partitioned"] = r.pos
    return at


def custom_matrices(bits, at):
    """Load an intra matrix (its 64 values) and an inter one (ended early
    by a 0, its last value repeating) where the VOL loads none."""
    q = at["quant_type"]
    assert bits[q:q + 3] == "100", "an MPEG-quantisation VOL without its own matrices"
    intra = [8] + [min(16 + 2 * i, 120) for i in range(63)]
    inter = [16 + i for i in range(40)] + [0]
    load = "1" + "1" + "".join(f"{v:08b}" for v in intra) + "1" + "".join(
        f"{v:08b}" for v in inter)
    return bits[:q] + load + bits[q + 3:]


def no_vol_control(bits, at):
    """vol_control_parameters left out (chroma format, low_delay and the
    VBV fields with them), as DivX 5 and some XviD builds write a VOL."""
    c = at["vol_control"]
    assert bits[c] == "1", "a VOL without vol_control_parameters"
    return bits[:c] + "0" + bits[at["vol_control_end"]:]


def gmc(bits, at):
    """sprite_enable 2 (GMC) and its fields after it."""
    s, n = at["sprite"], at["sprite_bits"]
    assert n == 2
    return bits[:s] + "10" + "000010" + "00" + "0" + bits[s + n:]


def rvlc(bits, at):
    p = at["partitioned"]
    assert bits[p:p + 2] == "10", "a VOL without data partitioning"
    return bits[:p] + "11" + bits[p + 2:]


def nvop(time_bits):
    """A not-coded P-VOP: DivX's placeholder after a packed chunk."""
    bits = "01" + "0" + "1" + "0" * time_bits + "1" + "0"
    bits += "0" + "1" * ((8 - (len(bits) + 1) % 8) % 8)
    return b"\0\0\1\xb6" + int(bits, 2).to_bytes(len(bits) // 8, "big")


def pack_b_frames(packets):
    """DivX's packed bitstream: each P-VOP and the B-VOP after it in one
    chunk, a placeholder VOP in the next."""
    vol = mpeg4.Vol(packets[0][packets[0].index(b"\0\0\1\x20") + 4:])

    def kind(p):
        return p[p.index(b"\0\0\1\xb6") + 4] >> 6

    out, i = [packets[0]], 1
    while i < len(packets):
        if kind(packets[i]) == mpeg4.P_VOP and i + 1 < len(packets) and \
                kind(packets[i + 1]) == mpeg4.B_VOP:
            out += [packets[i] + packets[i + 1], nvop(vol.time_bits)]
            i += 2
        else:
            out.append(packets[i])
            i += 1
    return out


def asp_mp4(path, frames, fps=25, **options):
    """libavcodec's stream in an MP4, its VOL in ``esds``."""
    height, width = frames[0].shape[:2]
    packets = oracle_packets(frames, fps, **options)
    at = packets[0].index(b"\0\0\1\xb6")
    headers, packets[0] = packets[0][:at], packets[0][at:]
    with open(path, "wb") as fh:
        writer = mp4.Writer(fh, width, height, mpeg4_encode.cv2_rate(fps), headers)
        for packet in packets:
            writer.write(packet, is_key(packet))
        writer.close()


def strip_dht(jpeg_bytes):
    """A JPEG without its DHT segments (before the first scan)."""
    out, i = bytearray(), 0
    while i < len(jpeg_bytes):
        if jpeg_bytes[i] == 0xFF and jpeg_bytes[i + 1] == 0xDA:
            return bytes(out) + jpeg_bytes[i:]
        if jpeg_bytes[i] == 0xFF and jpeg_bytes[i + 1] not in (0xD8, 0x00, 0xFF):
            n = struct.unpack(">H", jpeg_bytes[i + 2:i + 4])[0]
            if jpeg_bytes[i + 1] != 0xC4:
                out += jpeg_bytes[i:i + 2 + n]
            i += 2 + n
            continue
        out.append(jpeg_bytes[i])
        i += 1
    return bytes(out)


def mjpeg_avi(path, frames, fps=25, pix_fmt=mpeg4_oracle.AV_PIX_FMT_YUVJ420P, dht=True,
              quality=4, cv2_sampling=None, cv2_quality=85):
    """An MJPEG AVI: libavcodec's ``mjpeg`` at ``pix_fmt`` (qscale
    ``quality``), or cv2's JPEG encoder with ``cv2_sampling``; without its
    DHT segments unless ``dht``."""
    height, width = frames[0].shape[:2]
    if cv2_sampling is None:
        yuv = [mpeg4_oracle.bgr_to_yuv420(f[..., ::-1], pix_fmt) for f in frames]
        packets = mpeg4_oracle.encode(yuv, width, height, mpeg4_encode.cv2_rate(fps),
                                      codec=b"mjpeg", pix_fmt=pix_fmt, flags="+qscale",
                                      global_quality=str(118 * quality),
                                      huffman="optimal" if dht else "default")
    else:
        params = [cv2.IMWRITE_JPEG_QUALITY, cv2_quality, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  cv2_sampling]
        packets = [cv2.imencode(".jpg", np.ascontiguousarray(f[..., ::-1]), params)[1].tobytes()
                   for f in frames]
    if not dht:
        packets = [strip_dht(p) for p in packets]
    write_avi(path, packets, width, height, fps, b"MJPG", keys=[True] * len(packets))


def avc1_mp4(path):
    """An MP4 of the port's writer whose sample entry says ``avc1``."""
    buf = io.BytesIO()
    writer = mp4.Writer(buf, 64, 48, (25, 1), b"\0\0\1\x20")
    writer.write(b"\0\0\1\xb6\0", True)
    writer.close()
    data = buf.getvalue()
    at = data.index(b"mp4v")
    path.write_bytes(data[:at] + b"avc1" + data[at + 4:])


def fragmented_mp4(path):
    """ftyp, a moov with mvex, then moof and mdat: a fragmented MP4."""
    def box(kind, payload):
        return struct.pack(">I4s", 8 + len(payload), kind) + payload

    mvhd = box(b"mvhd", bytes(4) + struct.pack(">IIII", 0, 0, 1000, 0) + bytes(80))
    trex = box(b"trex", bytes(4) + struct.pack(">IIIII", 1, 1, 0, 0, 0))
    moov = box(b"moov", mvhd + box(b"mvex", trex))
    moof = box(b"moof", box(b"mfhd", bytes(4) + struct.pack(">I", 1)))
    path.write_bytes(box(b"ftyp", b"isom" + struct.pack(">I", 512) + b"isomiso5")
                     + moov + moof + box(b"mdat", b"\0\0\1\xb6"))


def fixtures():
    """Write every fixture into ``OUT``."""
    OUT.mkdir(parents=True, exist_ok=True)
    big = pan(25, 720, 1280, 24, 6, 2)
    cv2_write(OUT / "video_720x1280_25.mp4", big, 25)
    cv2_write(OUT / "video_720x1280_2997.avi", big, 29.97)
    cv2_write(OUT / "video_clip_96x128.mp4", pan(26, 96, 128, 8, 2, 1), 25)
    cv2_write(OUT / "video_176x144_2997.avi", pan(27, 144, 176, 14, 3, 1), 29.97)
    cv2_write(OUT / "video_odd_33x65.mp4", pan(28, 33, 65, 6, 1, 1), 25, size=(65, 33))
    cv2_write(OUT / "video_xvid_tag.avi", pan(29, 48, 64, 6, 1, 0), 25, fourcc="XVID")
    cv2_write(OUT / "video_mjpg.avi", pan(30, 48, 64, 3, 1, 0), 25, fourcc="MJPG")
    small = pan(31, 144, 176, 8, 3, 2)
    oracle_avi(OUT / "mpeg4_4mv.avi", small, flags="+mv4")
    oracle_avi(OUT / "mpeg4_resync.avi", small, ps=200)
    oracle_avi(OUT / "mpeg4_fcode.avi", pan(32, 144, 176, 6, 24, 9))
    oracle_avi(OUT / "mpeg4_q2.avi", small[:4], qmin=2, qmax=2)
    oracle_avi(OUT / "mpeg4_q31.avi", small, qmin=31, qmax=31)
    oracle_avi(OUT / "mpeg4_72x40.avi", pan(33, 72, 40, 8, 2, 3), flags="+mv4", ps=100)
    # the Advanced Simple Profile's tools
    asp = pan(34, 64, 80, 10, 3, 2)
    oracle_avi(OUT / "mpeg4_bvop.avi", asp, bf=2, flags="+mv4")
    oracle_avi(OUT / "mpeg4_bvop3.avi", asp, bf=3, flags="+mv4", ps=100)
    oracle_avi(OUT / "mpeg4_qpel.avi", asp, flags="+qpel+mv4")
    oracle_avi(OUT / "mpeg4_qpel_bvop.avi", asp, bf=2, flags="+qpel+mv4")
    oracle_avi(OUT / "mpeg4_mpeg_quant.avi", asp, bf=1, mpeg_quant=1)
    oracle_avi(OUT / "mpeg4_mpeg_quant_custom.avi", asp, bf=1, mpeg_quant=1, qmin=2, qmax=6,
               patch=lambda p: rewrite_vol(p, custom_matrices))
    oracle_avi(OUT / "mpeg4_partitioned.avi", asp, data_partitioning=1, ps=120, flags="+mv4")
    oracle_avi(OUT / "mpeg4_xvid.avi", asp, fourcc=b"XVID", bf=2, flags="+qpel+mv4",
               mpeg_quant=1, patch=user_data(b"XviD0073"))
    oracle_avi(OUT / "mpeg4_bvop_no_vol_control.avi", asp, fourcc=b"XVID", bf=2, flags="+mv4",
               patch=lambda p: rewrite_vol(user_data(b"XviD0073")(p), no_vol_control))
    oracle_avi(OUT / "mpeg4_xvid_no_user_data.avi", pan(35, 40, 72, 8, 2, 1), fourcc=b"XVID",
               bf=1, flags="+qpel+mv4", qmin=2, qmax=4, patch=user_data(None))
    oracle_avi(OUT / "mpeg4_divx503.avi", asp, fourcc=b"DX50", bf=2, flags="+qpel+mv4",
               patch=user_data(b"DivX503b1393"))
    oracle_avi(OUT / "mpeg4_divx_packed.avi", asp, fourcc=b"DX50", bf=1, flags="+mv4",
               patch=lambda p: pack_b_frames(user_data(b"DivX503b2000p")(p)))
    asp_mp4(OUT / "mpeg4_asp.mp4", asp, bf=2, flags="+qpel+mv4")
    # Motion JPEG
    mj = pan(36, 48, 64, 3, 1, 1)
    J420, J422 = mpeg4_oracle.AV_PIX_FMT_YUVJ420P, mpeg4_oracle.AV_PIX_FMT_YUVJ422P
    mjpeg_avi(OUT / "mjpeg_420_nodht.avi", mj, pix_fmt=J420, dht=False)
    mjpeg_avi(OUT / "mjpeg_422.avi", mj, pix_fmt=J422)
    mjpeg_avi(OUT / "mjpeg_422_nodht.avi", mj, pix_fmt=J422, dht=False)
    mjpeg_avi(OUT / "mjpeg_422_webcam.avi", mj, dht=False,
              cv2_sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)
    # the two files chip_smoke.py's phase 26 streams through the 736 model
    oracle_avi(OUT / CHIP_ASP, big, fourcc=b"XVID", bf=2, flags="+qpel+mv4", mpeg_quant=1,
               b=3000000, patch=user_data(b"XviD0073"))
    mjpeg_avi(OUT / CHIP_MJPEG, pan(37, 480, 640, CHIP_MJPEG_FRAMES, 4, 2), dht=False,
              cv2_sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, cv2_quality=80)
    # refused
    refused = pan(38, 48, 64, 6, 1, 1)
    interlaced = oracle_avi(OUT / "mpeg4_interlaced.avi", refused, flags="+ildct")
    # three Simple Profile frames, then a VOL of interlaced video: refused mid-stream
    write_avi(OUT / "mpeg4_interlaced_mid_stream.avi",
              oracle_packets(refused[:3]) + interlaced, 64, 48,
              keys=[True, False, False, True] + [False] * (len(interlaced) - 1))
    oracle_avi(OUT / "mpeg4_gmc.avi", refused, flags="+qpel",
               patch=lambda p: rewrite_vol(p, gmc))
    oracle_avi(OUT / "mpeg4_rvlc.avi", refused, data_partitioning=1,
               patch=lambda p: rewrite_vol(p, rvlc))
    write_avi(OUT / "mpeg4_short_header.avi", [b"\0\0\x80\x02\x0a" + bytes(40)] * 2, 176, 144)
    h264 = (OUT / "mpeg4_bvop.avi").read_bytes().replace(b"mp4v", b"H264")
    (OUT / "video_h264_tag.avi").write_bytes(h264)
    avc1_mp4(OUT / "video_avc1.mp4")
    fragmented_mp4(OUT / "video_fragmented.mp4")


CHIP_ASP = "asp_xvid_720x1280.avi"
CHIP_MJPEG = "mjpeg_422_480x640.avi"
CHIP_MJPEG_FRAMES = 16
# the refused fixtures and the form each is refused as
REFUSED = {
    "mpeg4_interlaced.avi": "interlaced", "mpeg4_gmc.avi": "GMC",
    "mpeg4_interlaced_mid_stream.avi": "interlaced",
    "mpeg4_rvlc.avi": "reversible VLC", "mpeg4_short_header.avi": "short video header",
    "video_h264_tag.avi": "'H264'", "video_avc1.mp4": "'avc1'",
    "video_fragmented.mp4": "fragmented",
}


def main():
    fixtures()
    path = OUT / "digests.json"
    digests = json.loads(path.read_text()) if path.exists() else {}
    names = sorted(p.name for p in OUT.iterdir() if p.suffix in (".mp4", ".avi"))
    for name in [n for n in digests if n.endswith((".mp4", ".avi")) and n not in names]:
        del digests[name]
    for name in names:
        if name in REFUSED:
            digests[name] = {"refused": REFUSED[name]}
            continue
        frames, fps, count = mpeg4_oracle.cv2_frames(OUT / name)
        digests[name] = {"frames": len(frames), "shape": list(frames[0].shape), "fps": fps,
                         "frame_count": count,
                         "frame_sha256": [hashlib.sha256(f.tobytes()).hexdigest()
                                          for f in frames]}
        print(name, (OUT / name).stat().st_size, len(frames), frames[0].shape, fps, count)
    path.write_text(json.dumps(digests, indent=1) + "\n")
    total = sum((OUT / n).stat().st_size for n in names)
    print(f"{len(names)} video fixtures, {total} bytes")


if __name__ == "__main__":
    main()
