"""A short first call of kernel 2 after a change: build csrc/masks.cu with
ptxas's register and spill lines, chip_smoke.py's phase 3 alone, then the
profiler's and chip_smoke.time_ms's times and the tile classes of cases (a),
(b), (c), (e), none valid and K = 1 (see probe/designs.py).

Run from the repository's root on a machine with the card:
    python3 probe/first.py
"""
import sys
import time

sys.path.insert(0, ".")
import numpy as np
import torch

import chip_smoke as cs
from orienmask_tpu_torch import kernels
from orienmask_tpu_torch.ops.masks import assemble_masks_packed

t0 = time.perf_counter()
kernels.library("masks")
cs.log("card:", cs.card_line())
for line in kernels.build_log.get("masks", "").splitlines():
    if "mask_kernel" in line or "registers" in line or "spill" in line or "error" in line:
        cs.log("  ptxas:", line.strip())
cs.log("[3]")
cs.check_masks()
cs.log(f"phase 3 passed at {time.perf_counter() - t0:.1f} s")
torch.backends.cudnn.allow_tf32 = False
pipe, pp_kw = cs.build_pipeline()
image = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
    0, 256, (1, 480, 640, 3), dtype=np.uint8)).cuda()
calls = cs.main_path_inputs(pipe, image)
field, boxes, aidx, valid = calls["masks"][0]
pp = pipe.postprocess
v7 = torch.zeros_like(valid)
v7[0, torch.from_numpy(np.random.default_rng(7).choice(100, 7, replace=False)).cuda()] = True
spread = cs.mask_inputs(np.random.default_rng(cs.SEED + 2), 1)
spread[2] = torch.arange(100, device="cuda", dtype=torch.int32).remainder(9)[None]
cases = [("a", (field, boxes, aidx, pp.norm_anchors), pp.orien_thresh, valid),
         ("b", tuple(spread), 0.3, None),
         ("c", (field, boxes, aidx, pp.norm_anchors), pp.orien_thresh, v7),
         ("e", *cs.painted_inputs(np.random.default_rng(cs.SEED + 8), 1), None),
         ("none valid", (field, boxes, aidx, pp.norm_anchors), pp.orien_thresh,
          torch.zeros_like(valid)),
         ("K=1", (field, boxes[:, :1].contiguous(), aidx[:, :1].contiguous(), pp.norm_anchors),
          pp.orien_thresh, None)]
from torch.profiler import ProfilerActivity, profile


def device_us(fn, n=20):
    """Mean device time of the kernels fn launches, from the profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_time_total > 0]
    return ", ".join(f"{e.key[:40]} {e.device_time_total / e.count:.2f} us x{e.count}" for e in ev)


one = torch.ones(1, device="cuda")
cs.log(f"  floor: time_ms of a 1-element add_ {cs.time_ms(lambda: one.add_(1)) * 1e3:.2f} us")
for name, args, th, v in cases:
    cs.log(f"  ({name}) profiler: {device_us(lambda: assemble_masks_packed(*args, th, valid=v))}")
for rep in range(1):
    for name, args, th, v in cases:
        t = cs.time_ms(lambda: assemble_masks_packed(*args, th, valid=v))
        cs.log(f"  ({name}) {t * 1e3:.2f} us, tiles {cs.tile_counts(args, th, v)}")
cs.log(f"total {time.perf_counter() - t0:.1f} s")
