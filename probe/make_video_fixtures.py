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
macroblocks) with 4MV and resync markers; and the refused tools: B-VOPs,
quarter-pel, interlaced, MPEG quantisation, data partitioning.  By hand:
an MP4 whose sample entry is ``avc1`` and a fragmented MP4 (``moof``).

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

from orienmask_tpu_torch.data import avi, mp4, mpeg4_encode  # noqa: E402


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


def oracle_avi(path, frames, fps=25, **options):
    """libavcodec's stream of ``frames`` with ``options``, in an AVI."""
    height, width = frames[0].shape[:2]
    planes = [mpeg4_oracle.bgr_to_yuv420(f[..., ::-1]) for f in frames]
    rate = mpeg4_encode.cv2_rate(fps)
    packets = mpeg4_oracle.encode(planes, width, height, rate, **options)
    with open(path, "wb") as fh:
        writer = avi.Writer(fh, width, height, rate)
        for i, packet in enumerate(packets):
            writer.write(packet, i % 12 == 0)
        writer.close()
    return packets


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
    refused = pan(34, 48, 64, 6, 1, 1)
    oracle_avi(OUT / "mpeg4_bvop.avi", refused, bf=2)
    oracle_avi(OUT / "mpeg4_qpel.avi", refused, flags="+qpel")
    oracle_avi(OUT / "mpeg4_interlaced.avi", refused, flags="+ildct")
    oracle_avi(OUT / "mpeg4_mpeg_quant.avi", refused, mpeg_quant=1)
    oracle_avi(OUT / "mpeg4_partitioned.avi", refused, data_partitioning=1)
    avc1_mp4(OUT / "video_avc1.mp4")
    fragmented_mp4(OUT / "video_fragmented.mp4")


# the refused fixtures and the form each is refused as
REFUSED = {
    "video_mjpg.avi": "'MJPG'", "mpeg4_bvop.avi": "B-VOPs",
    "mpeg4_qpel.avi": "quarter-pel", "mpeg4_interlaced.avi": "interlaced",
    "mpeg4_mpeg_quant.avi": "MPEG quantisation", "mpeg4_partitioned.avi": "data partitioning",
    "video_avc1.mp4": "'avc1'", "video_fragmented.mp4": "fragmented",
}


def main():
    fixtures()
    path = OUT / "digests.json"
    digests = json.loads(path.read_text()) if path.exists() else {}
    names = sorted(p.name for p in OUT.iterdir() if p.suffix in (".mp4", ".avi"))
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
