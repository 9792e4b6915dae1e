"""Kernel 2 as it was before the validity row was fused into it
(probe/designs/unculled.cu, whose wrapper takes no ``valid``), alone and
followed by the ``masks *= valid`` launch that the postprocess then ran, on
cases (a)-(d) of chip_smoke.py's phases 5 and 11.

It runs on a checkout of a commit from before that change (where the main
path records three kernel-2 arguments, not four): unpack that commit with
``git archive``, copy this file to probe/ there, and run from its root on a
machine with the card:
    python3 probe/before.py
"""
import sys
import tempfile
import time

sys.path.insert(0, ".")
import numpy as np
import torch

import chip_smoke as cs
from orienmask_tpu_torch import kernels
from orienmask_tpu_torch.ops.masks import assemble_masks_packed

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
for name in kernels.SIGNATURES:
    kernels.library(name)
cs.log("card:", cs.card_line())


def mul_valid(m, v):
    m *= v[..., None, None].to(torch.uint8)
    return m


def report(name, field, boxes, aidx, table, valid, thresh):
    args = (field, boxes, aidx, table, thresh)
    out = assemble_masks_packed(*args)
    t_k = cs.time_ms(lambda: assemble_masks_packed(*args))
    t_km = cs.time_ms(lambda: mul_valid(assemble_masks_packed(*args), valid))
    t_m = cs.time_ms(lambda: mul_valid(out, valid))
    used = sum(len(set(r.tolist())) for r in aidx)
    cs.log(f"  ({name}) field {tuple(field.shape)} K={boxes.shape[1]} used planes {used} "
           f"valid {int(valid.sum())}/{valid.numel()}: kernel {t_k * 1e3:.2f} us, "
           f"kernel+multiply {t_km * 1e3:.2f} us, multiply alone {t_m * 1e3:.2f} us")


pipe, pp_kw = cs.build_pipeline()
image = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
    0, 256, (1, 480, 640, 3), dtype=np.uint8)).cuda()
calls = cs.main_path_inputs(pipe, image)
field, boxes, aidx = calls["masks"][0]
valid = pipe.run_device(image)["valid"]
pp = pipe.postprocess
for rep in range(2):
    cs.log(f"rep {rep}")
    report("a", field, boxes, aidx, pp.norm_anchors, valid, pp.orien_thresh)
    spread = cs.mask_inputs(np.random.default_rng(cs.SEED + 2), 1)
    spread[2] = torch.arange(100, device="cuda", dtype=torch.int32).remainder(9)[None]
    report("b", *spread, torch.ones((1, 100), dtype=torch.bool, device="cuda"), 0.3)
    v7 = torch.zeros_like(valid)
    v7[0, torch.from_numpy(np.random.default_rng(7).choice(100, 7, replace=False)).cuda()] = True
    report("c", field, boxes, aidx, pp.norm_anchors, v7, pp.orien_thresh)
del pipe

with tempfile.TemporaryDirectory() as wd:
    ev = cs.EvalPath(wd)
    epp = ev.tester.postprocess
    rec = []

    def masks(*args):
        rec.append(tuple(a.clone() for a in args))
        return type(epp)._assemble_masks(epp, *args)

    epp._assemble_masks = masks
    batch = next(iter(ev.loader))
    out = epp.apply_device(ev.tester.forward(torch.as_tensor(batch["image"]).cuda()))
    del epp._assemble_masks
    f, bx, ai = rec[0]
    for rep in range(2):
        report("d", f, bx, ai, epp.norm_anchors, out["valid"], epp.orien_thresh)
cs.log(f"total {time.perf_counter() - t0:.1f} s")
