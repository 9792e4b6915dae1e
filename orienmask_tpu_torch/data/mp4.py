"""The ISO base media file format (MP4), for the video reader and writer
of ``data/video.py`` (the port's replacement for cv2's FFmpeg backend).

``read`` finds the first video track of ``moov`` (``hdlr`` ``vide``): its
sample entry must be ``mp4v`` (MPEG-4 Part 2), whose ``esds`` holds the
decoder configuration (the VOL headers), or ``avc1``/``avc3`` (H.264), whose
``avcC`` record does (``avc3`` may leave it out: its parameter sets travel
in the samples); its samples come from ``stsz``,
``stsc`` and ``stco`` or ``co64`` in decoding order (every sample is
decoded from the first, so ``stss`` is not read).  One edit of ``elst`` is
honoured as FFmpeg's mov demuxer honours it: samples whose presentation
time (the ``stts`` decoding time plus the ``ctts`` composition offset,
versions 0 and 1) falls before the edit's media time, or past its
duration, are decoded but their pictures not shown (``Track.shown``: the
indices of the samples whose pictures are shown).  The rate is the track's
time scale times its sample count over the ``stts`` durations, reduced,
as FFmpeg's demuxer sets the average frame rate that
``cv2.CAP_PROP_FPS`` reads; the frame count is the sample count, as
``CAP_PROP_FRAME_COUNT``.

Refused, naming the form: a fragmented file (``moof``), any other video
sample entry (``hvc1``, ``hev1``, ``av01``, ``vp09``, ...) by its fourcc, an
``avc1`` entry without ``avcC``, a file with no video track (by its tracks'
fourccs, such as ``mp4a``), and edit lists of more than one edit.

``Writer`` lays a file out as FFmpeg's mov muxer does (the bytes are the
port's own): ``ftyp`` ``isom``, a ``free`` box, ``mdat``, then ``moov``
(``mvhd``, one ``trak`` with ``tkhd``, ``edts``/``elst``, ``mdhd``,
``hdlr``, ``vmhd``, ``dinf``, and ``stbl``: ``stsd`` ``mp4v`` with
``esds``, ``stts``, ``stss``, ``stsc``, ``stsz``, ``stco``).  The track's
time scale is the rate's denominator doubled to at least 10000, as
FFmpeg's.  Past ``LARGE`` bytes of media (4 GiB) the ``free`` box becomes
a 64-bit ``mdat`` size and the chunk offsets ``co64``.
"""

import fractions
import struct

REFUSAL = "ROADMAP Queue 1 item 1, 'What the infer CLI still refuses'"
MOVIE_TIMESCALE = 1000
ENTRIES = (b"mp4v", b"avc1", b"avc3")  # the video sample entries read
LARGE = 1 << 32


class UnsupportedMp4(ValueError):
    def __init__(self, form):
        super().__init__(f"{form} is not read ({REFUSAL})")
        self.form = form


def boxes(data, start, end):
    """(type, payload offset, payload size) of the boxes in [start, end),
    stopping at one cut short."""
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            if pos + 16 > end:
                return
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head:
            return
        yield kind, pos + head, min(size, end - pos) - head
        pos += size


def _find(data, start, size, kind):
    for k, at, s in boxes(data, start, start + size):
        if k == kind:
            return at, s
    return None


def _full(data, at):
    """(version, payload after the full box header)."""
    return data[at], at + 4


def _descriptor(data, pos):
    """(tag, payload offset, payload size) of an MPEG-4 descriptor."""
    tag = data[pos]
    pos += 1
    size = 0
    for _ in range(4):
        b = data[pos]
        pos += 1
        size = (size << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, pos, size


def esds_config(data, at, size):
    """The DecoderSpecificInfo of an ``esds`` box (the VOL headers)."""
    pos = at + 4
    tag, pos, _ = _descriptor(data, pos)
    if tag != 3:
        raise ValueError("an esds without an ES descriptor")
    flags = data[pos + 2]
    pos += 3
    if flags & 0x80:
        pos += 2
    if flags & 0x40:
        pos += 1 + data[pos]
    if flags & 0x20:
        pos += 2
    tag, pos, _ = _descriptor(data, pos)
    if tag != 4:
        raise ValueError("an esds without a decoder configuration")
    object_type = data[pos]
    if object_type != 0x20:
        raise UnsupportedMp4(f"an mp4v track of object type 0x{object_type:02x} (MPEG-4 "
                             "Visual, 0x20, only)")
    end = pos + 13
    pos = end
    if pos < at + size:
        tag, pos, n = _descriptor(data, pos)
        if tag == 5:
            return bytes(data[pos:pos + n])
    return b""


class Track:
    """What ``read`` finds: the sample entry's fourcc, decoder
    configuration, time scale, samples' (offset, size), the shown samples'
    indices, and the rate and frame count cv2 reports."""

    def __init__(self):
        self.fourcc = b""
        self.config = b""
        self.timescale = 0
        self.samples = []
        self.shown = None
        self.offsets = []  # each sample's composition offset (ctts)
        self.delay = 0  # the reorder delay the offsets show (FFmpeg's mov_guess_video_delay)
        self.rate = (0, 1)
        self.count = 0

    @property
    def fps(self):
        num, den = self.rate
        return num / den if den else 0.0


def _table(data, at, fmt):
    version, pos = _full(data, at)
    n = struct.unpack_from(">I", data, pos)[0]
    return [struct.unpack_from(fmt, data, pos + 4 + i * struct.calcsize(fmt)) for i in range(n)]


def _track(data, at, size, movie_timescale):
    mdia = _find(data, at, size, b"mdia")
    if mdia is None:
        return None, b""
    hdlr = _find(data, *mdia, b"hdlr")
    handler = data[hdlr[0] + 8:hdlr[0] + 12] if hdlr else b""
    minf = _find(data, *mdia, b"minf")
    stbl = _find(data, *minf, b"stbl") if minf else None
    stsd = _find(data, *stbl, b"stsd") if stbl else None
    fourcc = data[stsd[0] + 12:stsd[0] + 16] if stsd and stsd[1] >= 16 else b""
    if handler != b"vide":
        return None, fourcc
    t = Track()
    t.fourcc = fourcc
    if fourcc not in ENTRIES:
        return t, fourcc
    entry = stsd[0] + 8  # the sample entry's box
    entry_size = struct.unpack_from(">I", data, entry)[0]
    if fourcc == b"mp4v":
        esds = _find(data, entry + 8 + 78, entry_size - 8 - 78, b"esds")
        if esds is not None:
            t.config = esds_config(data, *esds)
    else:
        avcc = _find(data, entry + 8 + 78, entry_size - 8 - 78, b"avcC")
        if avcc is not None:
            t.config = bytes(data[avcc[0]:avcc[0] + avcc[1]])
        elif fourcc == b"avc1":
            raise UnsupportedMp4("an 'avc1' track without avcC")
    mdhd = _find(data, *mdia, b"mdhd")
    version, pos = _full(data, mdhd[0])
    t.timescale = struct.unpack_from(">I", data, pos + (16 if version == 1 else 8))[0]
    stts = _table(data, _find(data, *stbl, b"stts")[0], ">II")
    stsz_at = _find(data, *stbl, b"stsz")[0]
    uniform, count = struct.unpack_from(">II", data, stsz_at + 4)
    if count > len(data):
        raise ValueError(f"an stsz of {count} samples in a file of {len(data)} bytes")
    sizes = [uniform] * count if uniform else list(
        struct.unpack_from(f">{count}I", data, stsz_at + 12))
    stsc = _table(data, _find(data, *stbl, b"stsc")[0], ">III")
    co = _find(data, *stbl, b"stco")
    offsets = [o for (o,) in _table(data, co[0], ">I")] if co else \
        [o for (o,) in _table(data, _find(data, *stbl, b"co64")[0], ">Q")]
    # samples of each chunk (stsc runs)
    sample = 0
    for i, (first, per_chunk, _) in enumerate(stsc):
        last = stsc[i + 1][0] - 1 if i + 1 < len(stsc) else len(offsets)
        for chunk in range(first - 1, last):
            pos = offsets[chunk]
            for _ in range(per_chunk):
                if sample >= count:
                    break
                t.samples.append((pos, sizes[sample]))
                pos += sizes[sample]
                sample += 1
    t.count = count
    times, durations = [], []
    clock = 0
    for n, delta in stts:
        for _ in range(n):
            times.append(clock)
            durations.append(delta)
            clock += delta
    ctts = _find(data, *stbl, b"ctts")
    if ctts is not None:  # composition offsets, signed as FFmpeg reads them
        t.offsets = [off for n, off in _table(data, ctts[0], ">Ii") for _ in range(n)][:count]
        times = [time + off for time, off in zip(times, t.offsets + [0] * len(times))]
        t.delay = guess_delay(times)
    total = sum(durations[:count])
    if total and t.timescale:
        f = fractions.Fraction(t.timescale * count, total)
        t.rate = (f.numerator, f.denominator)
    edts = _find(data, at, size, b"edts")
    elst = _find(data, *edts, b"elst") if edts else None
    if elst is not None:
        version, pos = _full(data, elst[0])
        n = struct.unpack_from(">I", data, pos)[0]
        fmt = ">qqhh" if version == 1 else ">iihh"
        edits = [struct.unpack_from(fmt, data, pos + 4 + i * struct.calcsize(fmt))
                 for i in range(n)]
        edits = [e for e in edits if e[1] != -1]  # empty edits only delay the track
        if len(edits) > 1:
            raise UnsupportedMp4(f"an edit list of {len(edits)} edits")
        if edits:
            duration, media_time = edits[0][0], edits[0][1]
            end = media_time + duration * t.timescale // max(movie_timescale, 1) \
                if duration else None
            t.shown = [i for i, time in enumerate(times[:count])
                       if time >= media_time and (end is None or time < end)]
    return t, fourcc


def guess_delay(times):
    """The most presentation times of earlier samples one sample's time
    passes, in decoding order, within a window of 17 (FFmpeg's
    ``mov_guess_video_delay`` for an H.264 track with ``ctts``)."""
    window, delay = [], 0
    for time in times:
        window = window[-16:] + [time]
        j = len(window) - 1
        swaps = 0
        while j > 0 and window[j] < window[j - 1]:
            window[j], window[j - 1] = window[j - 1], window[j]
            swaps += 1
            j -= 1
        delay = max(delay, swaps)
    return delay


def read(data):
    """The first video track of MP4 file ``data`` as a ``Track``."""
    moov = None
    for kind, at, size in boxes(data, 0, len(data)):
        if kind == b"moof":
            raise UnsupportedMp4("a fragmented MP4 (moof)")
        if kind == b"moov":
            moov = (at, size)
    if moov is None:
        raise UnsupportedMp4("an MP4 without a movie box (moov)")
    if _find(data, *moov, b"mvex") is not None:
        raise UnsupportedMp4("a fragmented MP4 (mvex)")
    mvhd = _find(data, *moov, b"mvhd")
    version, pos = _full(data, mvhd[0])
    movie_timescale = struct.unpack_from(">I", data, pos + (16 if version == 1 else 8))[0]
    fourccs = []
    for kind, at, size in boxes(data, moov[0], moov[0] + moov[1]):
        if kind != b"trak":
            continue
        track, fourcc = _track(data, at, size, movie_timescale)
        fourccs.append(fourcc.decode("latin-1"))
        if track is None:
            continue
        if track.fourcc not in ENTRIES:
            raise UnsupportedMp4(f"a video track in {track.fourcc.decode('latin-1')!r} "
                                 "(MPEG-4 Part 2 'mp4v' and H.264 'avc1', 'avc3' only)")
        return track
    raise UnsupportedMp4("an MP4 without a video track (tracks: "
                         + (", ".join(repr(f) for f in fourccs) or "none") + ")")


def _box(kind, payload):
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def _full_box(kind, version, flags, payload):
    return _box(kind, struct.pack(">I", (version << 24) | flags) + payload)


def _descr(tag, payload):
    """An MPEG-4 descriptor with FFmpeg's 4-byte size."""
    n = len(payload)
    return bytes([tag, 0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F]) + payload


_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


class Writer:
    """Writes one ``mp4v`` track to file object ``fh`` (seekable): samples
    into ``mdat`` as they come, ``moov`` at ``close``."""

    def __init__(self, fh, width, height, rate, config):
        self.fh = fh
        self.width, self.height = width, height
        num, den = rate  # fps = num / den
        self.timescale = num
        while self.timescale < 10000:
            self.timescale *= 2
        self.delta = den * (self.timescale // num)
        self.config = config
        self.samples = []  # (offset, size, key)
        ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200) + b"isomiso2mp41")
        fh.write(ftyp)
        self.free_at = fh.tell()
        fh.write(_box(b"free", b""))  # room for a 64-bit mdat size
        self.mdat_at = fh.tell()
        fh.write(struct.pack(">I4s", 0, b"mdat"))

    def write(self, packet, key):
        self.samples.append((self.fh.tell(), len(packet), key))
        self.fh.write(packet)

    def _esds(self):
        dsi = _descr(5, self.config)
        dcd = _descr(4, struct.pack(">BB3sII", 0x20, 0x11, b"\0\0\0", 0, 0) + dsi)
        es = _descr(3, struct.pack(">HB", 1, 0) + dcd + _descr(6, b"\x02"))
        return _full_box(b"esds", 0, 0, es)

    def close(self):
        end = self.fh.tell()
        size = end - self.mdat_at
        wide = size >= LARGE
        if wide:  # the free box's 8 bytes take the 64-bit size
            self.fh.seek(self.free_at)
            self.fh.write(struct.pack(">I4sQ", 1, b"mdat", end - self.free_at))
        else:
            self.fh.seek(self.mdat_at)
            self.fh.write(struct.pack(">I", size))
        self.fh.seek(end)
        n = len(self.samples)
        media = n * self.delta
        movie = -(-media * MOVIE_TIMESCALE // self.timescale)  # rounded up
        mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, MOVIE_TIMESCALE, movie)
                         + struct.pack(">IH10x", 0x10000, 0x100) + _MATRIX + bytes(24)
                         + struct.pack(">I", 2))
        tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, movie) + bytes(8)
                         + struct.pack(">hhh2x", 0, 0, 0) + _MATRIX
                         + struct.pack(">II", self.width << 16, self.height << 16))
        elst = _full_box(b"elst", 0, 0, struct.pack(">IIiHH", 1, movie, 0, 1, 0))
        mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, self.timescale, media)
                         + struct.pack(">HH", 0x55C4, 0))
        hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I4s12x", 0, b"vide") + b"VideoHandler\0")
        vmhd = _full_box(b"vmhd", 0, 1, bytes(8))
        dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1)
                                       + _full_box(b"url ", 0, 1, b"")))
        entry = _box(b"mp4v", bytes(6) + struct.pack(">H", 1) + bytes(16)
                     + struct.pack(">HHIII", self.width, self.height, 0x480000, 0x480000, 0)
                     + struct.pack(">H", 1) + bytes(32) + struct.pack(">Hh", 0x18, -1)
                     + self._esds())
        stsd = _full_box(b"stsd", 0, 0, struct.pack(">I", 1) + entry)
        stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, self.delta) if n else
                         struct.pack(">I", 0))
        keys = [i + 1 for i, (_, _, key) in enumerate(self.samples) if key]
        stss = _full_box(b"stss", 0, 0, struct.pack(f">I{len(keys)}I", len(keys), *keys))
        # one sample a chunk, as FFmpeg interleaves a lone video track
        stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1) if n else
                         struct.pack(">I", 0))
        stsz = _full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n,
                                                    *[s for _, s, _ in self.samples]))
        if wide or (self.samples and self.samples[-1][0] >= LARGE):
            co = _full_box(b"co64", 0, 0, struct.pack(f">I{n}Q", n,
                                                      *[o for o, _, _ in self.samples]))
        else:
            co = _full_box(b"stco", 0, 0, struct.pack(f">I{n}I", n,
                                                      *[o for o, _, _ in self.samples]))
        stbl = _box(b"stbl", stsd + stts + stss + stsc + stsz + co)
        minf = _box(b"minf", vmhd + dinf + stbl)
        mdia = _box(b"mdia", mdhd + hdlr + minf)
        trak = _box(b"trak", tkhd + _box(b"edts", elst) + mdia)
        self.fh.write(_box(b"moov", mvhd + trak))
