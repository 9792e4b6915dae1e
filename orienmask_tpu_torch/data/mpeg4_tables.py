"""The variable-length codes and scans of MPEG-4 Part 2 (ISO/IEC 14496-2
Annex B) that the Simple Profile reader (``data/mpeg4.py``) and writer
(``data/mpeg4_encode.py``) use, as (code, length) pairs, and the decoding
lookups built from them.

A lookup for a code whose longest word is ``n`` bits is a pair of arrays of
``2 ** n`` entries indexed by the next ``n`` bits of the stream: the symbol
and the code's length (0 where no code starts with those bits).  The C++
macroblock loops (``csrc/mpeg4_host.cc``) take these arrays from Python, so
the tables are written once.
"""

import numpy as np

# MCBPC of I-VOPs (Table B-6): index = cbpc | 4 * (dquant); 8 is stuffing
INTRA_MCBPC = [(1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6), (1, 9)]
INTRA_MCBPC_STUFFING = 8
# MCBPC of P-VOPs (Table B-7): index = cbpc | 4 * intra | 8 * dquant | 16 * 4MV;
# 20 is stuffing (the table's gaps have no code)
INTER_MCBPC = [(1, 1), (3, 4), (2, 4), (5, 6), (3, 5), (4, 8), (3, 8), (3, 7),
               (3, 3), (7, 7), (6, 7), (5, 9), (4, 6), (4, 9), (3, 9), (2, 9),
               (2, 3), (5, 7), (4, 7), (5, 8), (1, 9)]
INTER_MCBPC_STUFFING = 20
# CBPY (Table B-8), indexed by the intra pattern (an inter MB's is 15 minus it);
# bit 3 is block 0
CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
        (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)]
# motion vector data (Table B-12): |code| 0..32, a sign bit follows a nonzero one
MVD = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7),
       (11, 9), (10, 9), (9, 9), (17, 10), (16, 10), (15, 10), (14, 10), (13, 10),
       (12, 10), (11, 10), (10, 10), (9, 10), (8, 10), (7, 10), (6, 10), (5, 10),
       (4, 10), (7, 11), (6, 11), (5, 11), (4, 11), (3, 11), (2, 11), (3, 12),
       (2, 12)]
# dct_dc_size (Tables B-13, B-14)
DC_SIZE_LUMA = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7),
                (1, 8), (1, 9), (1, 10), (1, 11)]
DC_SIZE_CHROMA = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8),
                  (1, 9), (1, 10), (1, 11), (1, 12)]

# TCOEF of inter blocks (Table B-17): (code, length) of each (last, run, level),
# a sign bit after it; the last entry is the escape
INTER_TCOEF = [
    (0x2, 2), (0xf, 4), (0x15, 6), (0x17, 7), (0x1f, 8), (0x25, 9), (0x24, 9), (0x21, 10),
    (0x20, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x6, 3), (0x14, 6), (0x1e, 8), (0xf, 10),
    (0x21, 11), (0x50, 12), (0xe, 4), (0x1d, 8), (0xe, 10), (0x51, 12), (0xd, 5), (0x23, 9),
    (0xd, 10), (0xc, 5), (0x22, 9), (0x52, 12), (0xb, 5), (0xc, 10), (0x53, 12), (0x13, 6),
    (0xb, 10), (0x54, 12), (0x12, 6), (0xa, 10), (0x11, 6), (0x9, 10), (0x10, 6), (0x8, 10),
    (0x16, 7), (0x55, 12), (0x15, 7), (0x14, 7), (0x1c, 8), (0x1b, 8), (0x21, 9), (0x20, 9),
    (0x1f, 9), (0x1e, 9), (0x1d, 9), (0x1c, 9), (0x1b, 9), (0x1a, 9), (0x22, 11), (0x23, 11),
    (0x56, 12), (0x57, 12), (0x7, 4), (0x19, 9), (0x5, 11), (0xf, 6), (0x4, 11), (0xe, 6),
    (0xd, 6), (0xc, 6), (0x13, 7), (0x12, 7), (0x11, 7), (0x10, 7), (0x1a, 8), (0x19, 8),
    (0x18, 8), (0x17, 8), (0x16, 8), (0x15, 8), (0x14, 8), (0x13, 8), (0x18, 9), (0x17, 9),
    (0x16, 9), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9), (0x7, 10), (0x6, 10),
    (0x5, 10), (0x4, 10), (0x24, 11), (0x25, 11), (0x26, 11), (0x27, 11), (0x58, 12),
    (0x59, 12), (0x5a, 12), (0x5b, 12), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12),
    (0x3, 7)]
INTER_LEVEL = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3,
    1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]
INTER_RUN = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4,
    5, 5, 5, 6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 26, 0, 0, 0, 1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38,
    39, 40]
INTER_LAST = 58  # entries from here on end the block
# TCOEF of intra blocks (Table B-16)
INTRA_TCOEF = [
    (0x2, 2), (0x6, 3), (0xf, 4), (0xd, 5), (0xc, 5), (0x15, 6), (0x13, 6), (0x12, 6),
    (0x17, 7), (0x1f, 8), (0x1e, 8), (0x1d, 8), (0x25, 9), (0x24, 9), (0x23, 9), (0x21, 9),
    (0x21, 10), (0x20, 10), (0xf, 10), (0xe, 10), (0x7, 11), (0x6, 11), (0x20, 11), (0x21, 11),
    (0x50, 12), (0x51, 12), (0x52, 12), (0xe, 4), (0x14, 6), (0x16, 7), (0x1c, 8), (0x20, 9),
    (0x1f, 9), (0xd, 10), (0x22, 11), (0x53, 12), (0x55, 12), (0xb, 5), (0x15, 7), (0x1e, 9),
    (0xc, 10), (0x56, 12), (0x11, 6), (0x1b, 8), (0x1d, 9), (0xb, 10), (0x10, 6), (0x22, 9),
    (0xa, 10), (0xd, 6), (0x1c, 9), (0x8, 10), (0x12, 7), (0x1b, 9), (0x54, 12), (0x14, 7),
    (0x1a, 9), (0x57, 12), (0x19, 8), (0x9, 10), (0x18, 8), (0x23, 11), (0x17, 8), (0x19, 9),
    (0x18, 9), (0x7, 10), (0x58, 12), (0x7, 4), (0xc, 6), (0x16, 8), (0x17, 9), (0x6, 10),
    (0x5, 11), (0x4, 11), (0x59, 12), (0xf, 6), (0x16, 9), (0x5, 10), (0xe, 6), (0x4, 10),
    (0x11, 7), (0x24, 11), (0x10, 7), (0x25, 11), (0x13, 7), (0x5a, 12), (0x15, 8), (0x5b, 12),
    (0x14, 8), (0x13, 8), (0x1a, 8), (0x15, 9), (0x14, 9), (0x13, 9), (0x12, 9), (0x11, 9),
    (0x26, 11), (0x27, 11), (0x5c, 12), (0x5d, 12), (0x5e, 12), (0x5f, 12), (0x3, 7)]
INTRA_LEVEL = [
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
    25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1, 2, 3, 4, 1, 2, 3, 1, 2, 3,
    1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2, 1,
    2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]
INTRA_RUN = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7,
    7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4,
    5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20]
INTRA_LAST = 67
TCOEF_ESCAPE = 102

# the scans (Figure 7-2): zigzag, alternate horizontal, alternate vertical;
# position in scan order -> raster index
ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
ALTERNATE_HORIZONTAL = [
    0, 1, 2, 3, 8, 9, 16, 17, 10, 11, 4, 5, 6, 7, 15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63]
ALTERNATE_VERTICAL = [
    0, 8, 16, 24, 1, 9, 2, 10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3, 11, 4, 12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5, 13, 6, 14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7, 15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63]
SCANS = np.array([ZIGZAG, ALTERNATE_HORIZONTAL, ALTERNATE_VERTICAL], np.int32)

# DC scalers by quantiser (7.4.3.1), index 0 unused
LUMA_DC_SCALE = [0] + [8 if q <= 4 else 2 * q if q <= 8 else q + 8 if q <= 24 else 2 * q - 16
                       for q in range(1, 32)]
CHROMA_DC_SCALE = [0] + [8 if q <= 4 else (q + 13) // 2 if q <= 24 else q - 6
                         for q in range(1, 32)]
DC_SCALE = np.array([LUMA_DC_SCALE, CHROMA_DC_SCALE], np.int32)
# intra_dc_vlc_thr -> the running quantiser from which intra DC is coded
# with the AC coefficients (Table 6-21)
INTRA_DC_THRESHOLD = [32, 13, 15, 17, 19, 21, 23, 0]
DQUANT = [-1, -2, 1, 2]

# MPEG quantisation's default matrices (6.3.3), in raster order
DEFAULT_INTRA_MATRIX = np.array([
    8, 17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45], np.int32)
DEFAULT_INTER_MATRIX = np.array([
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33], np.int32)


assert len(INTER_LEVEL) == len(INTER_RUN) == len(INTRA_LEVEL) == len(INTRA_RUN) == 102


def lookup(codes, symbols=None):
    """(symbol, length) arrays of ``2 ** n`` entries for ``codes`` (a list
    of (code, length)); ``symbols[i]`` is code i's symbol (i by default)."""
    bits = max(n for _, n in codes)
    sym = np.full(1 << bits, -1, np.int32)
    length = np.zeros(1 << bits, np.int32)
    for i, (code, n) in enumerate(codes):
        if n == 0:
            continue
        lo = code << (bits - n)
        hi = lo + (1 << (bits - n))
        if (length[lo:hi] != 0).any():
            raise ValueError(f"code {i} overlaps another")
        sym[lo:hi] = i if symbols is None else symbols[i]
        length[lo:hi] = n
    return sym, length


def max_tables(runs, levels, last_from):
    """LMAX[last][run] and RMAX[last][level] (Tables B-19 to B-22) of a TCOEF
    table: the largest level coded for a run, the largest run for a level."""
    lmax = np.zeros((2, 64), np.int32)
    rmax = np.zeros((2, 64), np.int32)
    for i, (run, level) in enumerate(zip(runs, levels)):
        last = int(i >= last_from)
        lmax[last, run] = max(lmax[last, run], level)
        rmax[last, level] = max(rmax[last, level], run)
    return lmax, rmax


class Tables:
    """Every lookup of the reader, built once."""

    def __init__(self):
        self.intra_mcbpc = lookup(INTRA_MCBPC)
        self.inter_mcbpc = lookup(INTER_MCBPC)
        self.cbpy = lookup(CBPY)
        self.mvd = lookup(MVD)
        self.dc_luma = lookup(DC_SIZE_LUMA)
        self.dc_chroma = lookup(DC_SIZE_CHROMA)
        self.tcoef = [lookup(INTER_TCOEF), lookup(INTRA_TCOEF)]  # [intra]
        self.runs = [np.array(INTER_RUN, np.int32), np.array(INTRA_RUN, np.int32)]
        self.levels = [np.array(INTER_LEVEL, np.int32), np.array(INTRA_LEVEL, np.int32)]
        self.last_from = [INTER_LAST, INTRA_LAST]
        inter_max = max_tables(INTER_RUN, INTER_LEVEL, INTER_LAST)
        intra_max = max_tables(INTRA_RUN, INTRA_LEVEL, INTRA_LAST)
        self.lmax = [inter_max[0], intra_max[0]]
        self.rmax = [inter_max[1], intra_max[1]]


_TABLES = None


def tables():
    global _TABLES
    if _TABLES is None:
        _TABLES = Tables()
    return _TABLES
