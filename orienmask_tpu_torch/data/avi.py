"""The RIFF AVI container, for the video reader and writer of
``data/video.py`` (the port's replacement for cv2's FFmpeg backend).

``read`` takes the headers (``hdrl``: ``avih``, each ``strl``'s ``strh``
and ``strf``) and the chunks of the first video stream from ``movi`` in file
order, through ``LIST rec `` groups and OpenDML's ``RIFF AVIX`` segments.
The rate is ``dwRate / dwScale``, reduced, as FFmpeg's demuxer sets the
stream's average frame rate that ``cv2.CAP_PROP_FPS`` reads; the frame count
is ``strh``'s ``dwLength``, as cv2's ``CAP_PROP_FRAME_COUNT`` reads it.  A
file cut short keeps the whole chunks before the cut.

``Writer`` lays a file out as FFmpeg's avienc does (its bytes are the
port's own): ``hdrl`` with ``avih``, one ``strl`` whose ``strh`` and
``strf`` carry ``mp4v``, a ``JUNK`` reserved for OpenDML's super index and
``LIST odml``; then ``LIST movi`` of ``00dc`` chunks and ``idx1``.  Past
``RIFF_LIMIT`` bytes (FFmpeg's 1 GiB) it ends the ``RIFF AVI `` with its
``ix00`` standard index and goes on in ``RIFF AVIX`` segments, each with its
own ``movi`` and ``ix00``; the super index ``indx`` then takes the
reserved space and ``dmlh`` the total frame count.
"""

import fractions
import struct

REFUSAL = "ROADMAP Queue 1 item 1, 'What the infer CLI still refuses'"
RIFF_LIMIT = 1 << 30  # FFmpeg's AVI_MAX_RIFF_SIZE
MASTER_INDEX_SIZE = 256  # super index entries reserved in strl (AVI_MASTER_INDEX_SIZE)
AVIF_HASINDEX, AVIF_ISINTERLEAVED, AVIF_TRUSTCKTYPE = 0x10, 0x100, 0x800
AVIIF_KEYFRAME = 0x10


class UnsupportedAvi(ValueError):
    def __init__(self, form):
        super().__init__(f"{form} is not read ({REFUSAL})")
        self.form = form


class Stream:
    """What ``read`` finds: the video stream's codec fourcc, rate
    (numerator, denominator), frame count, its chunks' (offset, size), and
    the ``strf`` extradata."""

    def __init__(self):
        self.fourcc = b""
        self.rate = (0, 1)
        self.length = 0
        self.chunks = []
        self.extradata = b""
        self.size = (0, 0)  # strf's width and height

    @property
    def fps(self):
        num, den = self.rate
        return num / den if den else 0.0


def _chunks(data, start, end):
    """(fourcc, payload offset, size, list type or None) of the chunks in
    [start, end), stopping at the first one cut short."""
    pos = start
    while pos + 8 <= end:
        kind = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = pos + 8
        if kind in (b"LIST", b"RIFF"):
            if body + 4 > end:
                return
            yield kind, body + 4, min(size, end - body) - 4, data[body:body + 4]
        else:
            if body + size > end:
                if kind[2:] in (b"dc", b"db"):
                    return  # a chunk cut short: the whole ones before it stand
                size = end - body
            yield kind, body, size, None
        pos = body + size + (size & 1)


def read(data):
    """The first video stream of AVI file ``data`` (bytes) as a ``Stream``."""
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError("not an AVI file")
    stream = Stream()
    video = None  # its index among the streams
    n_streams = 0
    movi = []
    end = len(data)
    riff_end = min(end, 8 + struct.unpack_from("<I", data, 4)[0])
    for kind, at, size, list_type in _chunks(data, 12, riff_end):
        if list_type == b"hdrl":
            for k2, a2, s2, t2 in _chunks(data, at, at + size):
                if t2 != b"strl":
                    continue
                strh = strf = None
                for k3, a3, s3, _ in _chunks(data, a2, a2 + s2):
                    if k3 == b"strh":
                        strh = data[a3:a3 + s3]
                    elif k3 == b"strf":
                        strf = data[a3:a3 + s3]
                if strh is not None and strh[:4] == b"vids" and video is None:
                    video = n_streams
                    scale, rate = struct.unpack_from("<II", strh, 20)
                    stream.length = struct.unpack_from("<I", strh, 32)[0]
                    if scale and rate:
                        f = fractions.Fraction(rate, scale)
                        stream.rate = (f.numerator, f.denominator)
                    if strf is not None and len(strf) >= 40:
                        stream.size = struct.unpack_from("<ii", strf, 4)
                        stream.fourcc = strf[16:20]
                        stream.extradata = strf[40:]
                    else:
                        stream.fourcc = strh[4:8]
                n_streams += 1
        elif list_type == b"movi":
            movi.append((at, size))
    # OpenDML: RIFF AVIX segments follow the first RIFF, each with its movi
    pos = 8 + struct.unpack_from("<I", data, 4)[0]
    pos += pos & 1
    while pos + 12 <= end and data[pos:pos + 4] == b"RIFF" and data[pos + 8:pos + 12] == b"AVIX":
        size = struct.unpack_from("<I", data, pos + 4)[0]
        for kind, at, s, list_type in _chunks(data, pos + 12, min(end, pos + 8 + size)):
            if list_type == b"movi":
                movi.append((at, s))
        pos += 8 + size + (size & 1)
    if video is None:
        raise UnsupportedAvi("an AVI file without a video stream")
    tags = (b"%02ddc" % video, b"%02ddb" % video)

    def walk(start, stop):
        for kind, at, size, list_type in _chunks(data, start, stop):
            if list_type == b"rec ":
                yield from _chunks(data, at, at + size)  # rec groups do not nest
            else:
                yield kind, at, size, list_type

    for at, size in movi:
        for kind, at, size, _ in walk(at, at + size):
            if kind in tags and size:  # an empty chunk is a dropped frame: no packet
                stream.chunks.append((at, size))
    return stream


def _chunk(kind, payload):
    return kind + struct.pack("<I", len(payload)) + payload + (b"\0" if len(payload) & 1 else b"")


def _list(kind, payload):
    return b"LIST" + struct.pack("<I", len(payload) + 4) + kind + payload


class Writer:
    """Writes one ``mp4v`` video stream to file object ``fh`` (seekable),
    chunk by chunk; ``close`` writes the indexes and fixes the sizes."""

    def __init__(self, fh, width, height, rate):
        self.fh = fh
        self.width, self.height = width, height
        self.rate = rate  # (numerator, denominator)
        self.frames = 0
        self.max_chunk = 0
        self.index = []  # this RIFF's (offset from movi, size, key) for idx1 / ix00
        self.segments = []  # finished segments' (ix00 offset, its size, frames)
        self.first_index = None
        self._write_header()

    def _headers(self, frames, total, super_index):
        num, den = self.rate
        usec = int(round(1e6 * den / num))
        avih = struct.pack("<14I", usec, 0, 0, AVIF_HASINDEX | AVIF_ISINTERLEAVED
                           | AVIF_TRUSTCKTYPE, frames, 0, 1, 1 << 20, self.width, self.height,
                           0, 0, 0, 0)
        strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", b"mp4v", 0, 0, 0, 0, den, num, 0,
                           total, self.max_chunk, 0xFFFFFFFF, 0, 0, 0, self.width, self.height)
        strf = struct.pack("<IiiHH4sIiiII", 40, self.width, self.height, 1, 24, b"mp4v",
                           self.width * self.height * 3, 0, 0, 0, 0)
        # OpenDML super index, or the JUNK that reserves its room
        indx_body = struct.pack("<HBBI4s12x", 4, 0, 0, len(super_index), b"00dc")
        for offset, size, frames_in in super_index:
            indx_body += struct.pack("<QII", offset, size, frames_in)
        indx_body += bytes(24 + 16 * MASTER_INDEX_SIZE - len(indx_body))
        indx = _chunk(b"indx" if super_index else b"JUNK", indx_body)
        strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf) + indx)
        odml = _list(b"odml", _chunk(b"dmlh", struct.pack("<I", total) + bytes(244)))
        return _list(b"hdrl", _chunk(b"avih", avih) + strl + odml)

    def _write_header(self):
        hdrl = self._headers(0, 0, [])
        head = b"RIFF" + bytes(4) + b"AVI " + hdrl
        pad = (-(len(head) + 8 + 12)) % 512  # movi's data at a 512-byte boundary, as avienc
        head += _chunk(b"JUNK", bytes(pad))
        self.hdrl_at = 12
        self.hdrl_size = len(hdrl)
        self.riff_at = 0
        self.fh.write(head)
        self._start_movi()

    def _start_movi(self):
        self.movi_at = self.fh.tell() + 8  # the 'movi' fourcc
        self.fh.write(b"LIST" + bytes(4) + b"movi")

    def write(self, packet, key):
        """Append one frame's packet."""
        if self.fh.tell() - self.riff_at > RIFF_LIMIT:
            self._end_riff()
            self.riff_at = self.fh.tell()
            self.fh.write(b"RIFF" + bytes(4) + b"AVIX")
            self._start_movi()
        at = self.fh.tell()
        self.fh.write(_chunk(b"00dc", packet))
        self.index.append((at - self.movi_at, len(packet), key))
        self.frames += 1
        self.max_chunk = max(self.max_chunk, len(packet))

    def _ix00(self):
        """This segment's OpenDML standard index (offsets from its movi)."""
        body = struct.pack("<HBBI4sQI", 2, 0, 1, len(self.index), b"00dc", self.movi_at, 0)
        for rel, size, key in self.index:
            body += struct.pack("<II", rel + 8, size | (0 if key else 0x80000000))
        return _chunk(b"ix00", body)

    def _end_riff(self, last=False):
        """Close the current RIFF: its ix00 inside movi where the file has
        more than one, then (for the first) idx1; fix the LIST and RIFF
        sizes."""
        if not (last and not self.segments):
            ix_at = self.fh.tell()
            ix = self._ix00()
            self.fh.write(ix)
            self.segments.append((ix_at, len(ix), len(self.index)))
        movi_end = self.fh.tell()
        if self.first_index is None:
            self.first_index = len(self.index)
            idx1 = b"".join(struct.pack("<4sIII", b"00dc", AVIIF_KEYFRAME if key else 0, rel, size)
                            for rel, size, key in self.index)
            self.fh.write(_chunk(b"idx1", idx1))
        end = self.fh.tell()
        self.fh.seek(self.movi_at - 4)
        self.fh.write(struct.pack("<I", movi_end - self.movi_at))
        self.fh.seek(self.riff_at + 4)
        self.fh.write(struct.pack("<I", end - self.riff_at - 8))
        self.fh.seek(end)
        self.index = []

    def close(self):
        """Write the indexes and the final headers."""
        self._end_riff(last=True)
        end = self.fh.tell()
        first = self.first_index
        super_index = self.segments if len(self.segments) > 1 else []
        hdrl = self._headers(first, self.frames, super_index)
        if len(hdrl) != self.hdrl_size:
            raise AssertionError("the AVI header changed size")
        self.fh.seek(self.hdrl_at)
        self.fh.write(hdrl)
        self.fh.seek(end)
