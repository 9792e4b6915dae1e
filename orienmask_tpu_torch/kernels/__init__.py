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
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# library -> {C entry point: argtypes}
SIGNATURES = {
    "topk": {
        # x, vals, idx, B, P, k, stream
        "omt_exact_topk": [_P, _P, _P, _I, _I, _I, _P],
    },
    "masks": {
        # field, boxes, anchor_idx, anchor_table, out, B, A, H, W, K,
        # orien_thresh, inv_w, inv_h, row0, stream
        "omt_assemble_masks_packed": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
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
}

launches = {"exact_topk": 0, "assemble_masks_packed": 0, "assemble_masks": 0,
            "assemble_masks_bitpacked": 0, "paint_orientation": 0}

_libs = {}
build_seconds = None  # wall time of the last build that compiled anything


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


def build_all():
    """Compile every ``csrc/*.cu`` whose library is missing or older than
    its source, one ``nvcc`` each, in parallel."""
    global build_seconds
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        so = BUILD_DIR / f"lib{src.stem}.so"
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            jobs.append((src, so))
    if not jobs:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src, so in jobs:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    build_seconds = time.perf_counter() - t0


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


def launch(name, fn, *args):
    """Call C entry point ``fn`` of ``lib<name>.so`` on the current stream;
    raise on a launch error."""
    lib = library(name)
    err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.omt_error_string(err).decode()
        raise RuntimeError(f"{fn}: CUDA error {err} ({msg})")
