"""Kernel 2 (``mask_kernel``) in each of its measured designs, side by side
on the card.

Builds the shipped ``orienmask_tpu_torch/csrc/masks.cu``, its tile-geometry
variants (constants replaced) and every source of ``probe/designs/`` with
nvcc in parallel, holds each design's output bit for bit against the plain
version, and times it on the cases below with ``chip_smoke.time_ms`` (CUDA
graph replays between events) and with the profiler (mean device time of
20 launches).  Prints ptxas's register and spill lines and each kernel's
SASS instruction count.

Cases: (a) the main path's recorded inputs (one anchor, random weights);
(b) the same shapes with detections on all nine anchors of a normal
field; (e) the field painted for 8 instances, what a model that fits its
training targets predicts (``chip_smoke.painted_inputs``); none valid;
K = 1.  ``unculled.cu`` takes no validity row: it runs only where every
detection is valid.

Run from the repository's root on a machine with the card:
    python3 probe/designs.py
"""
import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, ".")
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from orienmask_tpu_torch import kernels
from orienmask_tpu_torch.ops.masks import _f32, assemble_masks_packed_plain

DESIGNS = {  # probe/designs/<name>.cu
    "unculled": "the kernel before tile culling: 4 threads an output byte, every "
                "detection of the anchor at every pixel",
    "band": "a band of rows a block, tiles' positions and bounds in shared memory, "
            "a warp a detection",
    "word": "a 32-bit word a thread, the block's sample positions staged in shared "
            "memory from coalesced loads",
    "tile": "a 32-bit word a thread, positions in registers",
    "byte": "a byte a thread, 4 detections in flight (the phase probe's source)",
    "byte2": "a byte a thread, warp-level pre-culling and parallel grouping",
    "strided": "the shipped layout with each slice taking every 4th detection of "
               "every used anchor (so every slice forms every anchor's positions)",
}
SHIPPED = Path("orienmask_tpu_torch/csrc/masks.cu").read_text()


def knobs(tile_bytes, tiles, slices):
    return [("constexpr int kTileBytes = 2;", f"constexpr int kTileBytes = {tile_bytes};"),
            ("constexpr int kTiles = 32;", f"constexpr int kTiles = {tiles};"),
            ("constexpr int kSlices = 4;", f"constexpr int kSlices = {slices};")]


def sources():
    out = {"shipped": SHIPPED}
    for tb, t, sl in ((2, 64, 2), (2, 32, 2), (2, 16, 4)):  # 2-byte tiles: 16-bit stores
        src = SHIPPED
        for a, b in knobs(tb, t, sl):
            assert a in src, a
            src = src.replace(a, b)
        out[f"shipped_{tb}B_{t}x{sl}"] = src
    for name in DESIGNS:
        out[name] = Path(f"probe/designs/{name}.cu").read_text()
    return out


def build(srcs, outdir):
    procs = {}
    for name, src in srcs.items():
        (outdir / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(outdir / f"lib{name}.so"),
             str(outdir / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    cuobjdump = Path(kernels._nvcc()).with_name("cuobjdump")
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        assert p.returncode == 0, out
        lines = out.splitlines()
        i = [j for j, ln in enumerate(lines) if "Compiling entry" in ln and "mask_kernel" in ln][0]
        sass = subprocess.run([str(cuobjdump), "-sass", str(outdir / f"lib{name}.so")],
                              capture_output=True, text=True).stdout.split("Function : ")
        n_ins = [x.count("\n        /*") for x in sass if "mask_kernel" in x.split("\n")[0]]
        cs.log(f"  {name}: " + " | ".join(ln.strip() for ln in lines[i + 2:i + 4])
               + f" | SASS instructions {n_ins}")
        lib = ctypes.CDLL(str(outdir / f"lib{name}.so"))
        sig = list(kernels.SIGNATURES["masks"]["omt_assemble_masks_packed"])
        has_valid = "const uint8_t* valid" in srcs[name]
        if not has_valid:
            del sig[4]
        lib.omt_assemble_masks_packed.argtypes = sig
        lib.omt_assemble_masks_packed.restype = ctypes.c_int
        libs[name] = (lib, has_valid)
    return libs


def run(design, field, boxes, aidx, table, th, valid):
    lib, has_valid = design
    b, a, _, h, w = field.shape
    k = boxes.shape[1]
    out = torch.empty((b, k, h, w // 8), dtype=torch.uint8, device="cuda")
    ptrs = [field.data_ptr(), boxes.data_ptr(), aidx.data_ptr(), table.data_ptr()]
    if has_valid:
        ptrs.append(None if valid is None else valid.data_ptr())
    err = lib.omt_assemble_masks_packed(*ptrs, out.data_ptr(), b, a, h, w, k, th,
                                        _f32(1.0 / w), _f32(1.0 / h), 0,
                                        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def device_us(fn, n=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_time_total > 0) / n


def main():
    outdir = Path("probe/build")
    outdir.mkdir(parents=True, exist_ok=True)
    cs.log("card:", cs.card_line())
    libs = build(sources(), outdir)
    for name, text in DESIGNS.items():
        cs.log(f"  {name}: {text}")
    torch.backends.cudnn.allow_tf32 = False
    pipe, _ = cs.build_pipeline()
    image = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, 256, (1, 480, 640, 3), dtype=np.uint8)).cuda()
    field, boxes, aidx, valid = cs.main_path_inputs(pipe, image)["masks"][0]
    pp = pipe.postprocess
    main_args = (field, boxes, aidx, pp.norm_anchors)
    spread = cs.mask_inputs(np.random.default_rng(cs.SEED + 2), 1)
    spread[2] = torch.arange(100, device="cuda", dtype=torch.int32).remainder(9)[None]
    painted, th_e = cs.painted_inputs(np.random.default_rng(cs.SEED + 8), 1)
    cases = [("a", main_args, pp.orien_thresh, valid),
             ("b", tuple(spread), 0.3, None),
             ("e", tuple(painted), th_e, None),
             ("none", main_args, pp.orien_thresh, torch.zeros_like(valid)),
             ("K=1", (field, boxes[:, :1].contiguous(), aidx[:, :1].contiguous(),
                      pp.norm_anchors), pp.orien_thresh, None)]
    for case, args, th, v in cases:
        want = assemble_masks_packed_plain(*args, th, valid=v)
        row = []
        for name, design in libs.items():
            if not design[1] and v is not None and not bool(v.all()):
                continue
            ok = torch.equal(run(design, *args, th, v), want)
            t = cs.time_ms(lambda: run(design, *args, th, v)) * 1e3
            row.append(f"{name} {t:.2f} / {device_us(lambda: run(design, *args, th, v)):.2f}"
                       + ("" if ok else " WRONG"))
        cs.log(f"  ({case}) tiles {cs.tile_counts(args, th, v)}; us (graph / profiler): "
               + ", ".join(row))


if __name__ == "__main__":
    main()
