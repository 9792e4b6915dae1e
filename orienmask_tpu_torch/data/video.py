"""Video files without cv2 or FFmpeg: the port's replacement for the JAX
CLI's ``cv2.VideoCapture`` and ``cv2.VideoWriter(..., "mp4v", ...)``.

``VideoReader(path)`` picks the container by the file's first bytes (RIFF
AVI or ISO BMFF), not by its name, and decodes its MPEG-4 Part 2 Simple or
Advanced Simple Profile video (``data/mpeg4.py``; XviD's and DivX's
streams too), its H.264 I, P and B pictures (``data/h264.py``) or, in AVI, its
Motion JPEG (``data/mjpeg.py``) to (H, W, 3) uint8 RGB frames, bit for bit
as ``cv2.VideoCapture`` reads them after ``cvtColor(BGR2RGB)``
(``data/yuv.py``; an H.264 frame by its colour matrix and range).  ``fps``
and ``frame_count`` are what cv2's ``CAP_PROP_FPS`` and
``CAP_PROP_FRAME_COUNT`` report.  A file cut short
yields the whole frames before the cut.

``VideoWriter(path, fps)`` picks the container by the extension, as cv2
does (``.mp4``, ``.avi``), and is sized by the first frame: odd sizes are
cut to even ones, as cv2 cuts them (33x65 -> 32x64).  It writes ``mp4v``
(``data/mpeg4_encode.py``) in MP4 (``data/mp4.py``) or AVI
(``data/avi.py``), at the rate cv2 would write and read back.

``UnsupportedVideo`` names the form refused and what is read.
"""

import mmap
import os
import struct

import numpy as np

from . import avi, h264, mjpeg, mp4, mpeg4, mpeg4_encode, yuv

READABLE = ("MPEG-4 Part 2 Simple and Advanced Simple Profile video (I-, P- and B-VOPs, 4MV, "
            "quarter-pel, MPEG quantisation, resync markers, data partitioning, f_code 1-7; "
            "XviD's and DivX's streams, DivX packed bitstreams) in MP4 ('mp4v') or AVI "
            "('mp4v', 'FMP4', 'XVID', 'XVIX', 'DIVX', 'DX50', 'DIV1', 'MP4S', 'M4S2', 'RMP4', "
            "'SIPP', 'ZMP4', '3IV2'), H.264 I, P and B slices of progressive 8-bit 4:2:0 video "
            "(CAVLC and CABAC, Baseline, Main and High profiles) in MP4 ('avc1', 'avc3') or "
            "AVI ('H264', 'h264', 'X264', 'x264', 'avc1', 'AVC1', 'DAVC'), and 4:2:0 or "
            "4:2:2 Motion JPEG in AVI ('MJPG', 'AVI1')")
WRITABLE = (".mp4", ".avi")
# AVI fourccs of MPEG-4 Part 2 video
AVI_FOURCCS = {t for tag in (b"MP4V", b"FMP4", b"XVID", b"XVIX", b"DIVX", b"DX50", b"DIV1",
                             b"MP4S", b"M4S2", b"RMP4", b"SIPP", b"ZMP4", b"3IV2")
               for t in (tag, tag.lower())}
# AVI fourccs of H.264 video
H264_FOURCCS = {b"H264", b"h264", b"X264", b"x264", b"avc1", b"AVC1", b"DAVC"}
_MP4_BOXES = (b"ftyp", b"moov", b"mdat", b"free", b"wide", b"skip", b"moof", b"styp")


class UnsupportedVideo(ValueError):
    def __init__(self, path, why):
        super().__init__(f"cannot read {path}: {why}; this build reads {READABLE} only "
                         "(ROADMAP Queue 1 item 1, 'What the infer CLI still refuses')")


class VideoReader:
    """Frames of the video file at ``path``, in order, as (H, W, 3) uint8
    RGB."""

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            self._data = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ) if size else b""
        data = self._data
        self.shown = None
        self.probe = None  # an MP4's (delay, evidence) for cv2's probe (h264.probe_delay)
        self.colour = (2, False)  # an H.264 frame's colour matrix and range
        try:
            self.codec = "mpeg4"
            if data[:4] == b"RIFF" and data[8:12] == b"AVI ":
                self.container = "avi"
                stream = avi.read(data)
                if stream.fourcc in mjpeg.FOURCCS:
                    self.codec = "mjpeg"
                    self.height = abs(stream.size[1])
                elif stream.fourcc in H264_FOURCCS:
                    self.codec = "h264"
                elif stream.fourcc not in AVI_FOURCCS:
                    raise UnsupportedVideo(self.path, "an AVI video stream in "
                                           f"{stream.fourcc.decode('latin-1')!r}")
                self.packets = stream.chunks
                self.config = stream.extradata
                self.fps = stream.fps
                self.frame_count = stream.length or len(stream.chunks)
                self.codec_tag = stream.fourcc
            elif data[4:8] in _MP4_BOXES:
                self.container = "mp4"
                track = mp4.read(data)
                self.packets = track.samples
                self.config = track.config
                self.fps = track.fps
                self.frame_count = track.count
                self.shown = None if track.shown is None else set(track.shown)
                self.probe = (track.delay, any(track.offsets[:3]))
                self.codec_tag = track.fourcc
                if track.fourcc != b"mp4v":
                    self.codec = "h264"
            else:
                raise UnsupportedVideo(self.path, "not a video file")
            # an avcC track's samples are handed out as cv2 filters them
            self.annexb = self.codec == "h264" and self.container == "mp4" and \
                self.config[:1] == b"\x01"
        except UnsupportedVideo:
            raise
        except (avi.UnsupportedAvi, mp4.UnsupportedMp4) as e:
            raise UnsupportedVideo(self.path, e.form) from None
        except (struct.error, IndexError, TypeError, ValueError) as e:
            raise UnsupportedVideo(self.path, f"a malformed {self._kind()} file ({e})") from None

    def _kind(self):
        return "AVI" if self._data[:4] == b"RIFF" else "MP4"

    def packet_bytes(self):
        """The stream's packets as cv2 hands them out with
        ``CAP_PROP_FORMAT`` -1, in order, up to the first one cut short (an
        ``avcC`` track's samples through ``h264.AnnexB``, as cv2 filters
        them)."""
        data = self._data
        annexb = h264.AnnexB(self.config) if self.annexb else None
        for offset, size in self.packets:
            if offset + size > len(data):
                return
            packet = bytes(data[offset:offset + size])
            yield annexb(packet) if annexb else packet

    def planes(self):
        """The decoded (Y, U, V) planes of each frame shown (``yuvj`` ones
        for Motion JPEG)."""
        if self.codec == "mjpeg":
            yield from self._mjpeg_planes()
            return
        refusal = h264.UnsupportedH264 if self.codec == "h264" else mpeg4.UnsupportedMpeg4
        try:
            if self.codec == "h264":  # cv2 starts its decoder at the delay the probe found
                delay = h264.probe_delay(self.packet_bytes(), self.config, self.codec_tag,
                                         annexb=self.annexb, mp4=self.probe)
                decoder = h264.Decoder(self.config, codec_tag=self.codec_tag, delay=delay,
                                       annexb=self.annexb)
            else:
                decoder = mpeg4.Decoder(self.config, codec_tag=self.codec_tag)
        except refusal as e:
            raise UnsupportedVideo(self.path, e.form) from None
        except (ValueError, EOFError) as e:
            raise UnsupportedVideo(self.path, f"a corrupt decoder configuration ({e})") from None
        for index, packet in enumerate(self.packet_bytes()):
            try:
                frames = decoder.decode(packet)
            except refusal as e:
                raise UnsupportedVideo(self.path, e.form) from None
            except (ValueError, EOFError) as e:
                if index == len(self.packets) - 1:
                    break  # a last packet cut inside: the frames before it stand
                # FFmpeg conceals the damage and goes on; the port stops, naming it
                raise UnsupportedVideo(self.path, f"a corrupt packet {index} ({e})") from None
            yield from self._shown(decoder, frames, index)
        yield from self._shown(decoder, decoder.flush(), None)

    def _shown(self, decoder, frames, index):
        """``frames`` less those an MP4 edit leaves out: an H.264 picture by
        the packet that held it (FFmpeg's discarded packet drops its
        picture wherever it lands in output order), an MPEG-4 one by the
        packet ``index`` it came out after (None: the flush)."""
        tags = decoder.shown_packets if self.codec == "h264" else [index] * len(frames)
        for frame, tag in zip(frames, tags):
            if self.shown is None or tag is None or tag in self.shown:
                yield self._frame(decoder, frame)

    def _frame(self, decoder, planes):
        if self.codec == "h264":
            self.colour = decoder.colour
        return planes

    def _mjpeg_planes(self):
        packets = list(self.packets)
        for index, packet in enumerate(self.packet_bytes()):
            try:
                yield mjpeg.decode(packet, self.height)
            except mjpeg.UnsupportedMjpeg as e:
                raise UnsupportedVideo(self.path, e.form) from None
            except (ValueError, EOFError) as e:
                if index == len(packets) - 1:
                    break  # a last packet cut inside: the frames before it stand
                raise UnsupportedVideo(self.path, f"a corrupt packet {index} ({e})") from None

    def __iter__(self):
        for y, u, v in self.planes():
            if self.codec == "h264":
                yield yuv.yuv_to_rgb(y, u, v, yuv.coefficients(*self.colour))
            else:
                yield (yuv.yuvj_to_rgb if self.codec == "mjpeg" else yuv.yuv420_to_rgb)(y, u, v)

    def close(self):
        if isinstance(self._data, mmap.mmap):
            self._data.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class VideoWriter:
    """Writes (H, W, 3) uint8 RGB frames to ``path`` as ``mp4v`` at ``fps``
    in the container of the extension; the first frame sets the size."""

    def __init__(self, path, fps):
        self.path = str(path)
        self.ext = os.path.splitext(self.path)[1].lower()
        if self.ext not in WRITABLE:
            raise ValueError(f"cannot write {self.ext!r} video: the writer makes "
                             f"{', '.join(WRITABLE)} files")
        self.fps = float(fps)
        mpeg4_encode.cv2_rate(self.fps)  # a rate MPEG-4 cannot carry raises here
        self.encoder = self.container = self.fh = None
        self.size = None

    def write(self, frame):
        frame = np.asarray(frame)
        if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
            raise ValueError(f"VideoWriter takes (H, W, 3) uint8, got {frame.dtype} "
                             f"{frame.shape}")
        height, width = frame.shape[0] & ~1, frame.shape[1] & ~1
        if self.encoder is None:
            if width == 0 or height == 0:
                raise ValueError(f"a video frame of {frame.shape[1]}x{frame.shape[0]}")
            self.size = (width, height)
            self.encoder = mpeg4_encode.Encoder(width, height, self.fps,
                                                global_header=self.ext == ".mp4")
            self.fh = open(self.path, "wb")
            if self.ext == ".mp4":
                self.container = mp4.Writer(self.fh, width, height, self.encoder.rate,
                                            self.encoder.headers)
            else:
                self.container = avi.Writer(self.fh, width, height, self.encoder.rate)
        elif (width, height) != self.size:
            raise ValueError(f"a {frame.shape[1]}x{frame.shape[0]} frame for a "
                             f"{self.size[0]}x{self.size[1]} video")
        rgb = np.ascontiguousarray(frame[:height, :width])
        packet, key = self.encoder.encode(*yuv.rgb_to_yuv420(rgb))
        self.container.write(packet, key)

    def reconstruction(self):
        """The last frame as the file holds it: (Y, U, V) planes."""
        w, h = self.size
        y, u, v = self.encoder.ref
        return y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2]

    def close(self):
        if self.container is not None:
            self.container.close()
            self.fh.close()
            self.container = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
