"""Kernels 3 and 4 (``per_detection_kernel`` of csrc/masks.cu) after a
change: ptxas's register and spill lines, chip_smoke.py's phase 9 checks
alone, then side by side on phase 9's two timed cases, each held bit for
bit against the plain version, in turns (each design's first timing in one
order, its second in the reverse): ``chip_smoke.time_ms`` (CUDA graph
replays between events) and the profiler's mean device time of 20
launches.  Designs:

* grid: one block per image, detection and run of pixels (the
  ``omt_assemble_masks*`` entry points of ``probe/designs/unculled.cu``);
* ballot: the shipped tiles and culling with kernel 2's grouping (warp 0
  places each anchor's detections with ballots, loading each box from
  device memory in its pass; ``probe/designs/perdet_ballot.cu``);
* shipped;
* both axes: the shipped source with each per-pixel axis evaluated on
  every tile not all out (no all-in shortcut per axis);
* tiles x slices: the shipped source with other block shapes (kTiles
  tiles of kSlices threads each; 32 x 4 shipped);
* unroll 2, unroll 4: the shipped source with the per-detection loop
  unrolled, so that independent detections' loads and compares overlap;
* diagnostics, wrong by design: no per-pixel compare (a mixed tile's axes
  taken as all in), and stores only (every mask written as zeros after
  the grouping, no field read): what the mixed tiles and the writes cost.

Run from the repository's root on a machine with the card:
    python3 probe/perdet.py
"""
import ctypes
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from orienmask_tpu_torch import kernels
from orienmask_tpu_torch.ops import masks

ENTRY = {"assemble_masks": "omt_assemble_masks",
         "assemble_masks_bitpacked": "omt_assemble_masks_bitpacked"}


SHIPPED = Path("orienmask_tpu_torch/csrc/masks.cu").read_text()
X_AXIS = "  if (!(-d.z < dlx && dhx < d.z)) {"
Y_AXIS = "  if (!(-d.w < dly && dhy < d.w)) {"
STORE = ("store(order[j], tile_bits(ft, cols, row, position_bounds(ft, s, cols[0], col1, row), "
         "d, s));")
LOOP = "    for (const int end = min(last, start[g + 1]); j < end; ++j) {"
DIAGNOSTIC = ("diag: no per-pixel compare", "diag: stores only")


def variant(*edits):
    src = SHIPPED
    for a, b in edits:
        assert a in src, a
        src = src.replace(a, b)
    return src


def sources():
    return {"grid": Path("probe/designs/unculled.cu").read_text(),
            "ballot": Path("probe/designs/perdet_ballot.cu").read_text(),
            "shipped": SHIPPED,
            "both axes": variant((X_AXIS, "  if (true) {"), (Y_AXIS, "  if (true) {")),
            **{f"{t} tiles x {n} slices": variant(
                ("constexpr int kTiles = 32;", f"constexpr int kTiles = {t};"),
                ("constexpr int kSlices = 4;", f"constexpr int kSlices = {n};"))
               for t, n in ((64, 2), (32, 8), (16, 8))},
            "unroll 2": variant((LOOP, "#pragma unroll 2\n" + LOOP)),
            "unroll 4": variant((LOOP, "#pragma unroll 4\n" + LOOP)),
            "diag: no per-pixel compare": variant((X_AXIS, "  if (false) {"),
                                                  (Y_AXIS, "  if (false) {")),
            "diag: stores only": variant((STORE, "store(order[j], 0u);"))}


def build(srcs, outdir):
    """Each source with nvcc, in parallel; ptxas's lines of its per-detection
    kernels; the loaded libraries."""
    outdir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        cu = outdir / f"perdet{i}.cu"
        cu.write_text(src)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out
        lines = out.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and ("per_detection" in ln or "unpacked" in ln
                                            or "bitpacked" in ln):
                cs.log(f"  {name}: {ln.split('entry function')[1].split()[0][:60]} "
                       + " | ".join(x.strip() for x in lines[i + 1:i + 4]
                                    if "spill" in x or "registers" in x))
        lib = ctypes.CDLL(str(so))
        for fn in ENTRY.values():
            getattr(lib, fn).argtypes = kernels.SIGNATURES["masks"][fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def run(lib, name, field, boxes, anchor_wh, anchor_idx, thresh):
    b, a, _, h, w = field.shape
    k = boxes.shape[1]
    out = torch.empty((b, k, h, w if name == "assemble_masks" else w // 8),
                      dtype=torch.uint8, device="cuda")
    err = getattr(lib, ENTRY[name])(
        field.data_ptr(), boxes.data_ptr(), anchor_wh.data_ptr(), anchor_idx.data_ptr(),
        out.data_ptr(), b, a, h, w, k, thresh, masks._f32(1.0 / w), masks._f32(1.0 / h),
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
    t0 = time.perf_counter()
    cs.log("card:", cs.card_line())
    libs = build(sources(), Path("probe/build"))
    cs.log("[9]")
    _, _, cases = cs.check_per_detection()
    cs.log(f"phase 9 passed at {time.perf_counter() - t0:.1f} s")
    for name in ENTRY:
        plain = getattr(masks, f"{name}_plain")
        for case, (args, thresh) in cases.items():
            want = plain(*args, thresh)
            fns = {d: (lambda lib=lib: run(lib, name, *args, thresh)) for d, lib in libs.items()}
            wrong = [d for d, fn in fns.items()
                     if d not in DIAGNOSTIC and not torch.equal(fn(), want)]
            times = {d: [] for d in fns}
            for order in (list(fns), list(fns)[::-1]):
                for d in order:
                    times[d].append(cs.time_ms(fns[d]) * 1e3)
            cs.log(f"  {name} ({case}) tiles {cs.per_detection_tiles(args, thresh)}; us "
                   "(graph, graph / profiler): " + "; ".join(
                       f"{d} {t[0]:.2f}, {t[1]:.2f} / {device_us(fns[d]):.2f}"
                       for d, t in times.items())
                   + (f"; WRONG: {wrong}" if wrong else "; all but the diagnostics identical"))
    cs.log(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
