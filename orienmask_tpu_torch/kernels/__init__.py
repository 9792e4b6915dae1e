"""Build and bind the hand-written CUDA kernels of ``orienmask_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``csrc/build/lib<name>.so`` (one ``nvcc`` per source,
all started together), then loaded with ``ctypes``.  Nothing is built at
import: the first call to ``library`` builds what is missing or older than
its sources, so running the program from a fresh checkout builds everything.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns ``cudaGetLastError()`` after its launch; ``launch``
raises when that is not 0.  ``launches`` holds one count per kernel, which
its wrapper raises by one where it launches the kernel.

Host code with a C interface, ``csrc/<name>.cc`` (the JPEG entropy
decoder and coder, TIFF's LZW codec, WebP's VP8 and VP8L loops, MPEG-4 Part 2's
macroblock loops and colour conversions, H.264's slice and deblocking loops, the native
host library ``omtpu``), is built the same way with the
host C++ compiler (``g++``, which nvcc itself needs) into
``csrc/build/lib<name>.so`` by ``host_library``; it runs on the CPU, so the
tests build and call it too.  It raises when the build fails: nothing falls
back to Python.
"""

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library -> {C entry point: argtypes}
SIGNATURES = {
    "topk": {
        # x, vals, idx, B, P, k, C (CTAs a row), stream
        "omt_exact_topk": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "masks": {
        # field, boxes, anchor_idx, anchor_table, valid (or null), out, B, A,
        # H, W, K, orien_thresh, inv_w, inv_h, row0, stream
        "omt_assemble_masks_packed": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _F, _F, _F, _I, _P],
        # field, boxes, anchor_wh, anchor_idx, out, B, A, H, W, K,
        # orien_thresh, inv_w, inv_h, stream
        "omt_assemble_masks": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P],
        "omt_assemble_masks_bitpacked": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _F, _F, _F, _P],
    },
    "paint": {
        # geom, n_last, masks, inv_half_anchors (host), pos, neg, torien,
        # B, N, A, H, W, stream
        "omt_paint_orientation": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "recover": {
        # packed masks, per-image geometry, bands' staged words, column
        # table, column fractions, row table, row fractions, out, B, K, H,
        # W/8, most blocks an image, most staged words a row, most staged
        # rows, most words a column, most rows of an identity image, stream
        "omt_recover_masks": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                              _I, _P],
        # most staged words a row, most staged rows, most words a column,
        # most rows of an identity image, W/8, out: shared memory bytes,
        # blocks an SM holds (no stream: not a launch)
        "omt_recover_occupancy": [_I, _I, _I, _I, _I, _P, _P],
    },
}

HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]
_L = ctypes.c_int64
# library -> {C entry point: (restype, argtypes)}
HOST_SIGNATURES = {
    "jpeg_host": {
        # segment, its length, coefficient buffer, offsets, geometry, scan
        # components, Huffman tables, tables present, mcux, mcuy, Ss, Se,
        # Ah, Al, restart interval, progressive
        "omj_decode_scan": (_I, [_P, _L, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I]),
        "omj_error_string": (ctypes.c_char_p, [_I]),
        # blocks, n, each block's component, tables of each component,
        # components, codes, code lengths, out, its capacity
        "omj_encode_blocks": (_L, [_P, _L, _P, _P, _I, _P, _P, _P, _L]),
    },
    "tiff_host": {
        # in, its length, out, its capacity
        "omt_lzw_decode": (_L, [_P, _L, _P, _L]),
        "omt_lzw_encode": (_L, [_P, _L, _P, _L]),
    },
    "webp_host": {
        # data, its length, bit position, xsize, ysize, level0, out
        "omw_vp8l_image": (_L, [_P, _L, _L, _I, _I, _I, _P]),
        # pixels, width, height, mode image, its tile bits
        "omw_vp8l_predictor": (None, [_P, _I, _I, _P, _I]),
        # pixels, width, height, tile bits, residuals, modes
        "omw_vp8l_predictor_forward": (None, [_P, _I, _I, _I, _P, _P]),
        # values, widths, n, out, its capacity
        "omw_vp8l_pack_bits": (_L, [_P, _P, _L, _P, _L]),
        # pixels, n, xsize, cache bits, chain, kinds, a, b
        "omw_vp8l_backward_refs": (_L, [_P, _L, _I, _I, _I, _P, _P, _P]),
        # data, its length, first partition's state, token partitions,
        # params, coefficient and 4x4-mode probabilities, dequantization,
        # filter strengths, Y, U, V
        "omw_vp8_decode": (_I, [_P, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P]),
    },
    "mpeg4_host": {
        # data, its length, bit position, parameters, tables, matrices, past
        # Y, U, V and future Y, U, V (or null), the future's kinds and stored
        # vectors (or null), out Y, U, V, out kinds, out stored vectors
        "omv_decode_vop": (_L, [_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _P, _P]),
        "omv_error_string": (ctypes.c_char_p, [_I]),
        # frame Y, U, V, reference Y, U, V (or null), parameters, tables,
        # header bytes already in out, pending bits, their count, out, its
        # capacity, reconstruction Y, U, V
        "omv_encode_vop": (_L, [_P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _I, _P, _L, _P, _P,
                                _P]),
        # Y, its row stride, U, V, their row stride, width, height, RGB out
        "omv_yuv_to_rgb": (None, [_P, _L, _P, _P, _L, _I, _I, _P]),
        # Y, U, V, the chroma's row stride, luma rows a chroma row, width,
        # height, RGB out
        "omv_yuvj_to_rgb": (None, [_P, _P, _P, _L, _I, _I, _I, _P]),
        # int16 blocks, block rows, block columns, quantiser table, plane out
        "omv_mjpeg_planes": (None, [_P, _I, _I, _P, _P]),
        # RGB, width, height, Y, U, V out
        "omv_rgb_to_yuv": (None, [_P, _I, _I, _P, _P, _P]),
    },
    "h264_host": {
        # RBSP, its length, bit position, parameters, tables, LevelScale4x4,
        # LevelScale8x8, the references' (Y, U, V) pointers (L0's, then
        # L1's), their picture ids, each list's count, explicit weights,
        # implicit weights, DistScaleFactor, the co-located arrays, Y, U, V,
        # state
        "omh_decode_slice": (_L, [_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P]),
        "omh_error_string": (ctypes.c_char_p, [_I]),
        # Y, U, V, mb_w, mb_h, Cb and Cr QP offsets, state, tables
        "omh_deblock": (None, [_P, _P, _P, _I, _I, _I, _I, _P, _P]),
        # Y, U, V, the chroma's row stride, width, height, coefficients, RGB out
        "omh_yuv_to_rgb": (None, [_P, _P, _P, _L, _I, _I, _P, _P]),
    },
    "omtpu": {
        # dets (n, 5), n, threshold, keep
        "om_nms": (_I, [_P, _I, _F, _P]),
        # mask, h, w, out, out_cap
        "om_rle_encode": (_I, [_P, _I, _I, _P, _I]),
        # string, its length, counts, cap
        "om_rle_decode": (_L, [_P, _L, _P, _L]),
        # masks, n, h, w, out, out_cap, lens
        "om_rle_encode_batch": (_I, [_P, _I, _I, _I, _P, _I, _P]),
        # words (n, ow, ceil(oh/32)), n, oh, ow, out, out_cap, lens
        "om_rle_encode_colpacked": (_L, [_P, _I, _I, _I, _P, _L, _P]),
        # flat xy, offsets, polygons, h, w, counts, cap
        "om_poly_merge": (_I, [_P, _P, _I, _I, _I, _P, _I]),
        # counts a, offsets a, n_a, counts b, offsets b, n_b, h, iscrowd, out
        "om_rle_iou": (None, [_P, _P, _I, _P, _P, _I, _I, _P, _P]),
        # ious, nd, ng, g_order, gi, iscrowd, thresholds, nt, dt_m, dt_ig
        "om_coco_match": (None, [_P, _I, _I, _P, _P, _P, _P, _I, _P, _P]),
        # src, sh, sw, c, dst, dh, dw, align_corners
        "om_resize_bilinear": (None, [_P, _I, _I, _I, _P, _I, _I, _I]),
    },
}

launches = {"exact_topk": 0, "assemble_masks_packed": 0, "assemble_masks": 0,
            "assemble_masks_bitpacked": 0, "paint_orientation": 0, "recover_masks": 0}

_libs = {}
build_seconds = None  # wall time of the last build that compiled anything
build_log = {}  # library -> nvcc's output (ptxas -v: registers, shared memory, spills)


def reset_launches():
    for name in launches:
        launches[name] = 0


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit")
    return nvcc


def _stale(suffix):
    """(source, library) of every ``csrc/*<suffix>`` whose library is
    missing or older than its source."""
    jobs = []
    for src in sorted(CSRC.glob("*" + suffix)):
        so = BUILD_DIR / f"lib{src.stem}.so"
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            jobs.append((src, so))
    return jobs


def _compile(jobs, command):
    """Build each (source, library) of ``jobs`` with ``command``, one
    process each, all started together; the seconds it took."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src, so in jobs:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [*command, "-o", str(tmp), str(src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, so, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[src.stem] = out
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError(f"{command[0]} failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_all():
    """Compile every ``csrc/*.cu`` whose library is missing or older than
    its source, one ``nvcc`` each, in parallel."""
    global build_seconds
    jobs = _stale(".cu")
    if jobs:
        build_seconds = _compile(jobs, [_nvcc(), *NVCC_FLAGS])


def library(name):
    """The loaded ``lib<name>.so`` with its argtypes declared; builds first."""
    if name not in _libs:
        build_all()
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.omt_error_string.argtypes = [ctypes.c_int]
        lib.omt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def host_library(name):
    """The loaded host library ``lib<name>.so`` (from ``csrc/<name>.cc``,
    built with ``g++`` when missing or older than its source)."""
    if name not in _libs:
        jobs = _stale(".cc")
        if jobs:
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: the host libraries of csrc/*.cc are built "
                                   "at first use with the host C++ compiler")
            _compile(jobs, [cxx, *HOST_FLAGS])
        lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        for fn, (restype, argtypes) in HOST_SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return _libs[name]


def launch(name, fn, *args):
    """Call C entry point ``fn`` of ``lib<name>.so`` on the current stream;
    raise on a launch error."""
    lib = library(name)
    err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.omt_error_string(err).decode()
        raise RuntimeError(f"{fn}: CUDA error {err} ({msg})")
