#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``orienmask_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; without a card it exits non-zero and
prints no result.  Phases, in order (any failure raises and exits non-zero):

1. build the hand-written kernels of ``orienmask_tpu_torch/csrc`` with nvcc
   for sm_90a; print the card and the build time;
2. kernel 1 (exact top-k) against its plain version on the card: values and
   indices bit-identical on every case;
3. kernel 2 (packed mask assembly) against its plain version on the card:
   bytes bit-identical on every case;
4. the main path: the full-width 544² OrienMaskYOLOFPNPlus (seeded random
   weights, bf16) in ``InferencePipeline`` answers requests on a seeded
   480x640 uint8 image; launch counts are read around those requests; the
   postprocess is then run again on the same head tensors with the plain
   versions and must give identical outputs;
5. timings at the main path's shapes: each kernel, its plain version and
   the library call (CUDA events between CUDA-graph replays, median of 50),
   and e2e FPS at 544² batch 1 (10 warm-ups, 5 windows of 200 frames, one
   synchronize per window, median window);
6. kernel 5 (orientation painting) against its plain version on the card:
   pos, neg and torien bit-identical on the train batch's painter inputs
   and on edge cases at 544²;
7. the train path: the published train config at full width (seeded random
   weights, B = 8 synthetic 544² images collated with packed masks and
   max_instances = 100) takes 30 steps through ``make_train_step`` under
   the config's schedule, with launch counts read around them (kernel 5
   once per step); the loss must be finite and fall; a NaN batch must be
   skipped with the state unchanged by bits; the loss on the same heads
   must be identical with kernel 5 and with its plain version;
8. train timings: kernel 5 per launch against its plain version and bound,
   and the train step in float32 and bfloat16 (3 warm-ups, 3 windows of 10
   steps, one synchronize per window, median), with peak memory;
9. kernels 3 and 4 (per-detection mask assembly, unpacked and packed), the
   path of the JAX package's on-chip validation: at its shapes (544², A = 9,
   K = 100, B = 2, per-detection anchor sizes off any table) and on edge
   cases (K = 1, one anchor, coord_h != H, zero-sized and off-table
   detections, W = 8), each bit-identical to its plain version, with launch
   counts read around the run; on table sizes pack_bits(kernel 3) ==
   kernel 4 == kernel 2;
10. the eval path: the published test config (f32, batch 16, the exact
   selection) at full width with seeded random weights saved as a
   reference-layout .pth and read by ``load_checkpoint``; ``Tester`` runs
   over 32 synthetic 544² scenes with COCO ground truth, with launch
   counts read around the loop (kernel 1 twice a batch, kernel 2 once);
   the postprocess with the plain versions on the same heads must give
   identical device outputs and identical 12-stat bbox and segm vectors;
   one batch with spread head logits must match too;
11. eval timings: kernels 3 and 4 and the exact selection (two levels of
   kernel 1 at (16, 1,456,560)) beside their plain versions, the library
   calls and their bounds; ``Tester``'s ms/image per stage, the loop's
   images per second and the seconds of ``coco_eval``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  ``--profile DIR`` also writes
torch.profiler tables of 20 frames and of 3 train steps in each dtype to
DIR.
"""

import argparse
import contextlib
import copy
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

SEED = 0
# H100 SXM (NVIDIA data sheet): the HBM rate, and 67 TFLOP/s of float32
# outside the tensor cores.  That peak counts an FMA as two operations; the
# kernels' counts below are single instructions (multiply, add, compare,
# select, or), each of which takes a whole FMA slot, so they are held
# against half of it.  The mask kernels' counts are those of the predicate
# and packing in ``cuobjdump -sass`` of the built csrc/build/libmasks.so:
# the abs is an operand modifier of the compare, and the second compare
# takes the first's predicate as its `and` input.  Bounds are taken against
# these published peaks.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12 / 2
TIMED_LAUNCHES = 50


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ----------------------------------------------------------------- timing

def time_ms(fn, n=TIMED_LAUNCHES):
    """Median device time of one ``fn()`` call over ``n`` calls.

    ``fn`` is captured once in a CUDA graph; the card then spins while the
    host queues ``n`` replays, each followed by a CUDA event, so the gaps
    between consecutive events are device time alone, without the host's
    dispatch.  Inputs stay in L2 between replays, as the main path leaves
    them (each kernel there reads what the step before it just wrote)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    torch.cuda._sleep(20_000_000)  # ~10 ms: the host queues everything below meanwhile
    events[0].record()
    for ev in events[1:]:
        graph.replay()
        ev.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(events, events[1:])]))


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    32-bit instructions over the scalar issue rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- kernel 1

def topk_cases(rng):
    def normal(b, p):
        return rng.standard_normal((b, p)).astype(np.float32)

    cases = []
    for b in (1, 4):
        for p in (18207, 32000):
            cases.append((f"random B={b} P={p}", normal(b, p), 400))
    levels = np.float32([0.1, 0.2, 0.3, -1.0])
    cases += [
        ("quantized ties", rng.choice(levels, (4, 32000)), 400),
        ("all equal", np.full((2, 18207), 0.25, np.float32), 400),
        ("mostly -1 sentinels", np.where(rng.uniform(size=(4, 18207)) < 0.01,
                                         rng.uniform(0.005, 1, (4, 18207)), -1.0)
         .astype(np.float32), 400),
        ("values <= -3", normal(2, 32000) * 4.0 - 7.0, 400),
        ("-inf mix", np.where(rng.uniform(size=(2, 18207)) < 0.7, -np.inf,
                              normal(2, 18207) - 5.0).astype(np.float32), 400),
        ("all -inf", np.full((1, 1001), -np.inf, np.float32), 400),
        ("signed zeros", rng.choice(np.float32([0.0, -0.0, 1.0]), (2, 5000)), 400),
        ("P not a multiple of 32", normal(3, 1001), 400),
        ("k = P", normal(2, 300), 300),
        ("k = 1024", normal(1, 32000), 1024),
        # rows past one launch: two levels (exact_topk_split)
        ("split, quantized ties", rng.choice(levels, (2, 3 * 32768 + 77)), 400),
        ("split, -inf mix, short last chunk", np.where(
            rng.uniform(size=(1, 2 * 32768 + 100)) < 0.5, -np.inf,
            normal(1, 2 * 32768 + 100)).astype(np.float32), 1024),
    ]
    return cases


def check_topk():
    from orienmask_tpu_torch.ops.topk import exact_topk, exact_topk_plain

    rng = np.random.default_rng(SEED)
    max_err = 0.0
    for name, x, k in topk_cases(rng):
        xd = torch.from_numpy(x).cuda()
        v, i = exact_topk(xd, k)
        pv, pi = exact_topk_plain(xd, k)
        torch.cuda.synchronize()
        same = torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)
        if not same:
            bad = (i != pi).any(dim=1).nonzero().flatten().tolist()
            raise AssertionError(f"exact_topk differs from its plain version on "
                                 f"'{name}' (rows {bad})")
        err = torch.where(v == pv, 0.0, (v - pv).abs()).max().item()
        max_err = max(max_err, err)
        log(f"  exact_topk {name:24s} B={x.shape[0]} P={x.shape[1]} k={k}: identical")
    check_topk_limits()
    return max_err


def check_topk_limits():
    """The C entry point refuses a row past its 16-bit scan and one whose
    keys do not fit in shared memory; the next launch is unaffected."""
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.ops.topk import exact_topk, exact_topk_plain

    for p, k in ((65536, 400), (60000, 1024)):
        x = torch.zeros((1, p), device="cuda")
        v = torch.empty((1, k), device="cuda")
        i = torch.empty((1, k), dtype=torch.int64, device="cuda")
        try:
            kernels.launch("topk", "omt_exact_topk", x.data_ptr(), v.data_ptr(),
                           i.data_ptr(), 1, p, k)
        except RuntimeError as e:
            log(f"  omt_exact_topk P={p} k={k} refused: {e}")
            continue
        raise AssertionError(f"omt_exact_topk took P={p} k={k}, past its limits")
    x = torch.randn((2, 32000), device="cuda")
    if not torch.equal(exact_topk(x, 400)[1], exact_topk_plain(x, 400)[1]):
        raise AssertionError("exact_topk differs after a refused launch")


# --------------------------------------------------------------- kernel 2

def mask_inputs(rng, b, a=9, h=544, w=544, k=100):
    field = rng.standard_normal((b, a, 2, h, w)).astype(np.float32)
    boxes = np.stack([rng.uniform(0.1, 0.9, (b, k)), rng.uniform(0.1, 0.9, (b, k)),
                      rng.uniform(0.02, 0.6, (b, k)), rng.uniform(0.02, 0.6, (b, k))],
                     axis=-1).astype(np.float32)
    boxes[:, -10:] = 0.0  # padded detections: zero-sized boxes
    anchor_idx = rng.integers(0, a - 2, (b, k)).astype(np.int32)  # a-2, a-1 unused
    anchor_idx[:, :8] = 3  # duplicates on one anchor
    table = rng.uniform(0.02, 0.7, (a, 2)).astype(np.float32)
    return [torch.from_numpy(t).cuda() for t in (field, boxes, anchor_idx, table)]


def check_masks():
    from orienmask_tpu_torch.ops.masks import assemble_masks_packed, assemble_masks_packed_plain

    rng = np.random.default_rng(SEED + 1)
    max_err = 0
    for b in (1, 2):
        args = mask_inputs(rng, b)
        got = assemble_masks_packed(*args, 0.3)
        want = assemble_masks_packed_plain(*args, 0.3)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            n = (got != want).sum().item()
            raise AssertionError(f"assemble_masks_packed: {n} bytes differ at B={b}")
        if not got.any() or got[:, -10:].any():
            raise AssertionError("assemble_masks_packed: masks empty, or a padded box has pixels")
        max_err = max(max_err, (got.int() - want.int()).abs().max().item())
        log(f"  assemble_masks_packed B={b} A=9 K=100 544x544: identical "
            f"({(got != 0).float().mean().item():.4f} of bytes nonzero)")
    # a row block of the image: coord_h = full height, row0 = first row
    field, boxes, anchor_idx, table = mask_inputs(rng, 1)
    whole = assemble_masks_packed(field, boxes, anchor_idx, table, 0.3)
    r0, rows = 136, 136
    block = field[:, :, :, r0:r0 + rows].contiguous()
    got = assemble_masks_packed(block, boxes, anchor_idx, table, 0.3, coord_h=544, row0=r0)
    want = assemble_masks_packed_plain(block, boxes, anchor_idx, table, 0.3,
                                       coord_h=544, row0=r0)
    if not (torch.equal(got, want) and torch.equal(got, whole[:, :, r0:r0 + rows])):
        raise AssertionError("assemble_masks_packed: the row0/coord_h block differs")
    log("  assemble_masks_packed rows 136..271 with coord_h=544, row0=136: identical, "
        "and equal to those rows of the whole image")
    return float(max_err)


# --------------------------------------------------------------- kernel 5

def paint_geom(rng, b, n, h=544, w=544, anchors=9):
    """Random painter geometry rows, bounds rounded as kernel_inputs rounds."""
    cx, cy = rng.uniform(0, w - 1, (b, n)), rng.uniform(0, h - 1, (b, n))
    cwx, cwy = rng.uniform(0.5, 120, (b, n)), rng.uniform(0.5, 120, (b, n))
    vx, vy = cwx / 0.6 * 0.7, cwy / 0.6 * 0.7
    x1, x2 = np.round(np.clip(cx - vx, 0, w - 1)), np.round(np.clip(cx + vx, 0, w - 1)) + 1
    y1, y2 = np.round(np.clip(cy - vy, 0, h - 1)), np.round(np.clip(cy + vy, 0, h - 1)) + 1
    anc = rng.integers(0, anchors, (b, n))
    return np.stack([cx, cy, cwx, cwy, x1, x2, y1, y2, anc, np.ones((b, n))],
                    -1).astype(np.float32)


def paint_edge_cases(rng, h=544, w=544):
    """The edge cases of tests/test_torch_paint.py at 544²: (name, geom,
    n_last, masks (B, N, H, W) bool)."""
    b, n = 3, 16
    cases = []
    geom = paint_geom(rng, b, n)
    geom[:, :, 8] = 4
    geom[:, :, 4:8] = [100, 400, 120, 380]
    cases.append(("overlap on one anchor", geom, rng.uniform(size=(b, n, h, w)) < 0.5))
    geom = paint_geom(rng, b, n)
    borders = [[0, 40, 0, h], [w - 40, w, 0, h], [0, w, 0, 40], [0, w, h - 40, h],
               [0, w, 0, h], [0, 1, 0, 1], [w - 1, w, h - 1, h]]
    geom[:, :len(borders), 4:8] = borders
    geom[:, :len(borders), 0:2] = [[0, 0], [w - 1, h - 1], [271.5, 0], [0, h - 1],
                                   [272, 272], [0, 0], [w - 1, h - 1]]
    cases.append(("ROIs on every border", geom, rng.uniform(size=(b, n, h, w)) < 0.3))
    geom = paint_geom(rng, b, n)
    geom[:, 3, 9] = geom[:, 6, 9] = 0
    geom[1, :, 9] = 0
    geom[2, 5:, 9] = 0
    cases.append(("unmatched in the middle, n_last 0", geom,
                  rng.uniform(size=(b, n, h, w)) < 0.5))
    geom = paint_geom(rng, b, n)
    ones = np.ones((b, n, h, w), bool)
    ones[0] = False
    cases.append(("all-one and all-zero masks", geom, ones))
    geom = paint_geom(rng, 8, 100)  # random packed bytes
    cases.append(("random, B=8 N=100", geom,
                  rng.integers(0, 256, (8, 100, h, w // 8), dtype=np.uint8)))
    out = []
    for name, geom, masks in cases:
        act = geom[..., 9] > 0
        n_last = np.where(act, np.arange(1, geom.shape[1] + 1), 0).max(1).astype(np.int32)
        out.append((name, geom, n_last, masks))
    return out


def check_paint_case(name, geom, n_last, masks, pixel_anchors, image_size=(544, 544)):
    """Kernel 5 against its plain version on packed (and, for bool masks,
    unpacked) masks; pos, neg and torien compared as int32 views.  Returns
    the largest absolute difference of torien."""
    from orienmask_tpu_torch.ops.maskops import pack_bits
    from orienmask_tpu_torch.ops.paint import paint_orientation, paint_orientation_plain

    want = paint_orientation_plain(geom, n_last, masks, pixel_anchors, image_size)
    layouts = [("packed", masks)] if masks.dtype == torch.uint8 else \
        [("packed", pack_bits(masks)), ("unpacked", masks)]
    err = 0.0
    for layout, m in layouts:
        got = paint_orientation(geom, n_last, m, pixel_anchors, image_size)
        torch.cuda.synchronize()
        for what, g, w in zip(("pos", "neg", "torien"), got, want):
            if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
                n_bad = (g.view(torch.int32) != w.view(torch.int32)).sum().item()
                raise AssertionError(f"paint_orientation '{name}' ({layout}): {n_bad} "
                                     f"{what} values differ from the plain version")
        err = max(err, (got[2] - want[2]).abs().max().item())
    log(f"  paint_orientation {name:34s} B={geom.shape[0]} N={geom.shape[1]}: identical "
        f"(pos {want[0].mean().item():.4f}, neg {want[1].mean().item():.4f} of pixels)")
    return err


def check_paint(trainer):
    """Phase 6: the train path's own painter inputs, then the edge cases."""
    rng = np.random.default_rng(SEED + 3)
    pixel_anchors = trainer.loss.painter.pixel_anchors
    geom, n_last, masks = trainer.paint_inputs()
    hw = (trainer.loss.painter.image_h, trainer.loss.painter.image_w)
    err = check_paint_case("the train batch (main path)", geom, n_last, masks, pixel_anchors, hw)
    for name, geom, n_last, masks in paint_edge_cases(rng):
        err = max(err, check_paint_case(
            name, torch.from_numpy(geom).cuda(), torch.from_numpy(n_last).cuda(),
            torch.from_numpy(masks).cuda(), pixel_anchors))
    return err


# -------------------------------------------------------------- main path

def build_pipeline():
    from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_infer as cfg
    from orienmask_tpu_torch.data import FastCOCOTransform
    from orienmask_tpu_torch.models import build_model, init_random
    from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
    from orienmask_tpu_torch.pipeline import InferencePipeline

    model = init_random(build_model(cfg["model"]), SEED)
    transform = FastCOCOTransform(cfg["transform"]["pipeline"])
    pp_kw = {k: v for k, v in cfg["postprocess"].items() if k != "type"}
    postprocess = OrienMaskYOLOPostProcess(**pp_kw, pack_masks=True, device="cuda")
    pipe = InferencePipeline(model, transform, postprocess,
                             compute_dtype=cfg["compute_dtype"], device="cuda")
    return pipe, pp_kw


def plain_postprocess(pp_kw):
    """The same postprocess with the kernels' plain versions, on the card."""
    from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
    from orienmask_tpu_torch.ops.masks import assemble_masks_packed_plain
    from orienmask_tpu_torch.ops.topk import exact_topk_plain

    class Plain(OrienMaskYOLOPostProcess):
        def _topk(self, x, k):
            return exact_topk_plain(x, k)

        def _assemble_masks(self, field, boxes, anchor_idx):
            return assemble_masks_packed_plain(field, boxes, anchor_idx, self.norm_anchors,
                                               self.orien_thresh)

    return Plain(**pp_kw, pack_masks=True, device="cuda")


def check_outputs(out, b):
    want = {"bbox": ((b, 100, 5), torch.float32), "cls": ((b, 100), torch.int32),
            "mask": ((b, 100, 544, 68), torch.uint8), "valid": ((b, 100), torch.bool)}
    for key, (shape, dtype) in want.items():
        t = out[key]
        if tuple(t.shape) != shape or t.dtype != dtype or t.device.type != "cuda":
            raise AssertionError(f"{key}: {tuple(t.shape)} {t.dtype} on {t.device}, "
                                 f"expected {shape} {dtype} on the card")
    if not torch.isfinite(out["bbox"]).all():
        raise AssertionError("non-finite boxes or scores")
    if not out["valid"].any():
        raise AssertionError("no valid detection")
    if out["mask"][~out["valid"]].any():
        raise AssertionError("an invalid detection has mask pixels")


def run_main_path(pipe, image, requests):
    """Answer ``requests`` requests through the user entry points; return
    the launch counts of that run alone."""
    from orienmask_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    results = None
    for _ in range(requests - 1):
        results, pad_info = pipe(image)  # host lists
    out = pipe.run_device(image)  # device dict
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    return counts, results, pad_info, out


def check_main_path(pipe, pp_kw, image):
    requests = 4
    counts, results, pad_info, out = run_main_path(pipe, image, requests)
    log(f"  {requests} requests, launches: {counts}")
    if counts["exact_topk"] != 2 * requests or counts["assemble_masks_packed"] != requests:
        raise AssertionError(f"expected {2 * requests} top-k and {requests} mask launches, "
                             f"got {counts}")
    check_outputs(out, 1)
    n = int(out["valid"][0].sum())
    r = results[0]
    if r["bbox"].shape != (n, 5) or r["mask"].shape != (n, 544, 544) or r["mask"].dtype != bool:
        raise AssertionError("host results: wrong shapes")
    if pad_info != (0, 0, 0, 0, 544, 544):
        raise AssertionError(f"pad_info {pad_info}")
    log(f"  outputs: bbox {tuple(out['bbox'].shape)} f32, cls int32, mask "
        f"{tuple(out['mask'].shape)} uint8, valid bool; {n} valid detections, "
        f"score range {r['bbox'][:, 4].min():.6f}..{r['bbox'][:, 4].max():.6f}")

    # the same head tensors through the plain-version postprocess (B = 1, 2)
    plain = plain_postprocess(pp_kw)
    for batch in (image, torch.cat([image, image.flip(2)])):
        heads = pipe.heads(batch)
        got = pipe.postprocess.apply_device(heads)
        want = plain.apply_device(heads)
        torch.cuda.synchronize()
        check_outputs(got, batch.shape[0])
        for key in got:
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"main path '{key}' differs from the plain-version "
                                     f"postprocess at B={batch.shape[0]}")
        log(f"  postprocess B={batch.shape[0]}: kernels == plain versions on the same heads "
            f"({int(got['valid'].sum())} valid detections)")
    return counts


# ----------------------------------------------------------------- timing

def main_path_inputs(pipe, image):
    """The arguments the main path hands each kernel wrapper in one frame,
    recorded by shadowing the postprocess's two kernel methods."""
    pp = pipe.postprocess
    calls = {"topk": [], "masks": []}

    def topk(x, k):
        calls["topk"].append((x.clone(), k))
        return type(pp)._topk(pp, x, k)

    def masks(*args):
        calls["masks"].append(tuple(a.clone() for a in args))
        return type(pp)._assemble_masks(pp, *args)

    pp._topk, pp._assemble_masks = topk, masks
    try:
        pipe.run_device(image)
    finally:
        del pp._topk, pp._assemble_masks
    return calls


def time_kernels(pipe, image):
    from orienmask_tpu_torch.ops.masks import assemble_masks_packed, assemble_masks_packed_plain
    from orienmask_tpu_torch.ops.topk import exact_topk, exact_topk_plain

    pp = pipe.postprocess
    calls = main_path_inputs(pipe, image)

    res = {"exact_topk": {}, "assemble_masks_packed": {}}
    ms = plain = lib = n_bytes = n_ops = 0.0
    for x, k in calls["topk"]:
        b, p = x.shape
        t = time_ms(lambda: exact_topk(x, k))
        tp = time_ms(lambda: exact_topk_plain(x, k))
        tl = time_ms(lambda: torch.topk(x, k))
        log(f"  exact_topk P={p} k={k}: kernel {t:.4f} ms, plain {tp:.4f} ms, "
            f"torch.topk {tl:.4f} ms")
        ms, plain, lib = ms + t, plain + tp, lib + tl
        n_bytes += b * (p * 4 + k * (4 + 8))  # row read once; values and int64 indices
        # key map + four 8-bit radix passes + the selection pass (one
        # operation per element each), and the bitonic sort of k padded
        kpad = 1 << (k - 1).bit_length()
        n_ops += b * (6 * p + kpad * kpad.bit_length() ** 2 // 2)
    res["exact_topk"].update(ms=ms, plain_ms=plain, library_ms=lib)
    res["exact_topk"]["bound_ms"], res["exact_topk"]["bound_by"] = bound(n_bytes, n_ops)

    field, boxes, anchor_idx = calls["masks"][0]
    args = (field, boxes, anchor_idx, pp.norm_anchors, pp.orien_thresh)
    t = time_ms(lambda: assemble_masks_packed(*args))
    tp = time_ms(lambda: assemble_masks_packed_plain(*args))
    log(f"  assemble_masks_packed field {tuple(field.shape)} K={boxes.shape[1]}: "
        f"kernel {t:.4f} ms, plain {tp:.4f} ms")
    b, a, _, h, w = field.shape
    kk = boxes.shape[1]
    # the kernel reads the field planes of the anchors that hold a detection
    used = sum(len(set(row.tolist())) for row in anchor_idx)
    n_bytes = (used * 2 * h * w * 4 + boxes.numel() * 4 + kk * b * 4 + a * 8
               + b * kk * h * (w // 8))
    # per used anchor and pixel: 2 multiplies and 2 adds (the sample
    # position); per detection and pixel: 2 subtracts, 2 compares, and the
    # select and or that pack the bit into its byte
    n_ops = used * h * w * 4 + b * kk * h * w * 6
    log(f"  the main path's detections use {used} of {b * a} anchor planes")
    res["assemble_masks_packed"].update(ms=t, plain_ms=tp, library_ms=None)
    # beside it, for the record: detections spread over all nine anchors
    spread = mask_inputs(np.random.default_rng(SEED + 2), 1)
    spread[2] = torch.arange(100, device="cuda", dtype=torch.int32).remainder(9)[None]
    log(f"  assemble_masks_packed, the same shapes with all 9 anchors used: kernel "
        f"{time_ms(lambda: assemble_masks_packed(*spread, 0.3)):.4f} ms")
    r = res["assemble_masks_packed"]
    r["bound_ms"], r["bound_by"] = bound(n_bytes, n_ops)
    return res


def e2e_fps(pipe, image):
    """bench.py's method: 10 warm-ups, then 5 windows of 200 frames with
    outputs left on the card and one synchronize per window; the median."""
    for _ in range(10):
        pipe.run_device(image)
    torch.cuda.synchronize()
    rates = []
    for _ in range(5):
        start = time.perf_counter()
        for _ in range(200):
            pipe.run_device(image)
        torch.cuda.synchronize()
        rates.append(200 / (time.perf_counter() - start))
    return float(np.median(rates)), rates


def profile(pipe, image, out_dir):
    from pathlib import Path

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(5):
        pipe.run_device(image)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        for _ in range(20):
            pipe.run_device(image)
        torch.cuda.synchronize()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=40)
    # the same ops split by input shapes, which tells the matmuls apart
    by_shape = prof.key_averages(group_by_input_shape=True).table(
        sort_by="cuda_time_total", row_limit=40, max_name_column_width=40,
        max_shapes_column_width=100)
    (out / "profile_544_bs1.txt").write_text(table + "\n\n" + by_shape)
    log(f"  profile of 20 frames written to {out / 'profile_544_bs1.txt'}")


# ------------------------------------------------------------- train path

TRAIN_COUNTS = (2, 4, 6, 7, 8, 12, 24, 100)  # instances per image; one at the cap


def _kw(block):
    return {k: v for k, v in block.items() if k != "type"}


def synthetic_samples(seed=SEED, size=544, counts=TRAIN_COUNTS, num_classes=80):
    """Transformed samples: images uniform in [0, 1]; box sides log-uniform
    in [0.02, 0.8] of the image, so the boxes reach all nine anchors; each
    mask the filled ellipse inscribed in its box; classes uniform."""
    rng = np.random.default_rng(seed)
    c = (np.arange(size) + 0.5) / size  # pixel centres, normalized
    samples = []
    for k in counts:
        image = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
        w, h = np.exp(rng.uniform(np.log(0.02), np.log(0.8), (2, k)))
        cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
        ex = ((c - cx[:, None]) / (w[:, None] / 2)) ** 2  # (k, W)
        ey = ((c - cy[:, None]) / (h[:, None] / 2)) ** 2  # (k, H)
        samples.append({"image": image,
                        "bbox": np.stack([cx, cy, w, h], -1).astype(np.float32),
                        "cls": rng.integers(0, num_classes, k),
                        "mask": ey[:, :, None] + ex[:, None, :] <= 1})
    return samples


class TrainPath:
    """The published train config on the card: OrienMaskYOLOFPNPlus at full
    width and depth with seeded random weights, the config's loss, SGD and
    schedule, and one device's batch (B = 8 at 544², max_instances = 100,
    packed masks) collated by the port's ``collate``."""

    def __init__(self):
        from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus as cfg
        from orienmask_tpu_torch.data import collate
        from orienmask_tpu_torch.models import build_model, init_random
        from orienmask_tpu_torch.ops import OrienMaskYOLOMultiScaleLoss
        from orienmask_tpu_torch.optim import SGD, StepWarmUpLR
        from orienmask_tpu_torch.trainer import make_train_step
        from orienmask_tpu_torch.trainer.train_state import to_device

        self.cfg = cfg
        loader = cfg["train_loader"]
        self.model = init_random(build_model(cfg["model"]), SEED)
        self.loss = OrienMaskYOLOMultiScaleLoss(**_kw(cfg["loss"]), device="cuda")
        self.opt = SGD(self.model.parameters(), **_kw(cfg["optimizer"]))
        self.sched = StepWarmUpLR(**_kw(cfg["lr_scheduler"]), base_lr=self.opt.base_lr)
        self.steps = {dtype: make_train_step(self.model, self.loss, self.opt,
                                             accumulate=cfg["accumulate"],
                                             compute_dtype=dtype, device="cuda")
                      for dtype in ("float32", "bfloat16")}
        samples = synthetic_samples(num_classes=cfg["model"]["num_classes"])
        if len(samples) != loader["batch_size"]:
            raise ValueError(f"{len(samples)} samples for a batch of {loader['batch_size']}")
        self.batch = to_device(collate(samples, max_instances=loader["max_instances"],
                                       pack_masks=loader["pack_masks"]), "cuda")
        self.iteration = 0

    def step(self, dtype=None, batch=None):
        """One train step at the schedule's lr (the config's dtype by default)."""
        logs = self.steps[dtype or self.cfg["compute_dtype"]](
            self.batch if batch is None else batch, self.sched(self.iteration))
        self.iteration += 1
        return logs

    def paint_inputs(self):
        """What the loss hands kernel 5's wrapper for this batch, recorded
        by shadowing the wrapper that its painter calls."""
        from orienmask_tpu_torch.ops import targets

        calls = []

        def record(geom, n_last, masks, *rest):
            calls.append((geom.clone(), n_last.clone(), masks.clone()))

        b = self.batch
        with mock.patch.object(targets, "paint_orientation", record):
            self.loss._paint_shared_batch(b["bbox"], b["valid"], b["mask"])
        return calls[0]

    @torch.no_grad()
    def heads(self):
        self.model.eval()
        out = self.model(self.batch["image"].permute(0, 3, 1, 2), torch.float32)
        self.model.train()
        return out


def run_train_path(tp, steps):
    """``steps`` train steps through the entry point on the fixed batch;
    the launch counts of that run alone and the losses."""
    from orienmask_tpu_torch import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    logs = [tp.step() for _ in range(steps)]
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    losses = torch.stack([log["loss"] for log in logs]).tolist()
    skipped = sum(float(log["skipped"]) for log in logs)
    return counts, losses, skipped


def check_train_path(tp):
    from orienmask_tpu_torch.ops import targets
    from orienmask_tpu_torch.ops.paint import paint_orientation_plain
    from orienmask_tpu_torch.trainer.train_state import unpack_target

    b = tp.batch
    n_valid = b["valid"].sum(1).tolist()
    log(f"  batch: image {tuple(b['image'].shape)} f32, mask {tuple(b['mask'].shape)} uint8 "
        f"packed, instances per image {n_valid}")
    steps = 30
    t = time.perf_counter()
    counts, losses, skipped = run_train_path(tp, steps)
    log(f"  {steps} steps ({tp.cfg['compute_dtype']}, lr {tp.sched(0):.3g}..."
        f"{tp.sched(steps - 1):.4g}) in {time.perf_counter() - t:.2f} s, launches: {counts}")
    if counts["paint_orientation"] != steps or sum(counts.values()) != steps:
        raise AssertionError(f"expected {steps} paint launches and nothing else, got {counts}")
    if not np.isfinite(losses).all() or skipped:
        raise AssertionError(f"non-finite or skipped steps: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    log(f"  loss: first 5 {[round(x, 3) for x in losses[:5]]}, last 5 "
        f"{[round(x, 3) for x in losses[-5:]]}; means {first:.3f} -> {last:.3f}")
    if not last < first:
        raise AssertionError(f"the loss did not fall over {steps} steps: {first} -> {last}")

    # a NaN image: the step is skipped and the state keeps its bits
    model, opt = tp.model, tp.opt
    snap = [t.clone() for t in model.state_dict().values()]
    bufs = [t.clone() for t in opt.buffers] + [opt.step.clone()]
    bad = dict(b, image=b["image"].clone())
    bad["image"][0, 5, 5, 0] = float("nan")
    logs = tp.step(batch=bad)
    if float(logs["skipped"]) != 1.0:
        raise AssertionError("a NaN batch was not skipped")
    for new, old in zip(list(model.state_dict().values()) + opt.buffers + [opt.step],
                        snap + bufs):
        if not torch.equal(new.reshape(-1).view(torch.uint8), old.reshape(-1).view(torch.uint8)):
            raise AssertionError("the NaN batch changed the train state")
    log("  NaN batch: skipped, parameters, BN buffers, momentum and counter unchanged by bits")

    # the same heads through the loss with kernel 5 and with its plain version
    heads = tp.heads()
    target = unpack_target(b)
    _, got, _ = tp.loss(heads, target, training=True)
    with mock.patch.object(targets, "paint_orientation", paint_orientation_plain):
        _, want, _ = tp.loss(heads, target, training=True)
    for key in want:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"loss '{key}' differs with the plain painter: "
                                 f"{got[key].item()} vs {want[key].item()}")
    log(f"  loss with kernel 5 == loss with its plain version in all {len(want)} log keys "
        f"(loss_sum {got['loss_sum'].item():.4f})")
    return counts


def eager_ms(fn, n=5):
    """Mean time of ``fn()`` between CUDA events around ``n`` eager calls,
    for a function that cannot be captured in a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_paint(tp):
    """Kernel 5 at the train path's inputs, its plain version, and its bound."""
    from orienmask_tpu_torch.ops.paint import paint_orientation, paint_orientation_plain

    geom, n_last, masks = tp.paint_inputs()
    pa = tp.loss.painter.pixel_anchors
    hw = (tp.loss.painter.image_h, tp.loss.painter.image_w)
    t = time_ms(lambda: paint_orientation(geom, n_last, masks, pa, hw))
    # the plain version reads its loop bound on the host: no graph capture
    tp_ms = eager_ms(lambda: paint_orientation_plain(geom, n_last, masks, pa, hw))
    b, n = geom.shape[:2]
    a, (h, w) = len(pa), hw
    g = geom.cpu().numpy()
    act = (g[..., 9] > 0) & (np.arange(n) < n_last.cpu().numpy()[:, None])
    x1, x2, y1, y2 = (g[..., i][act] for i in (4, 5, 6, 7))
    roi_px = float(((x2 - x1) * (y2 - y1)).sum())
    # each output written once (pos, neg, torien x and y), the geometry and
    # the mask bytes under the active ROIs read once
    mask_bytes = float(((y2 - y1) * ((x2 - 1) // 8 - x1 // 8 + 1)).sum())
    n_bytes = 4 * b * a * h * w * 4 + mask_bytes + g.nbytes + b * 4
    # ~30 instructions per instance and ROI pixel, ~15 per canvas pixel to
    # finalize (compares, selects, a reciprocal, subtracts and multiplies)
    n_ops = 30 * roi_px + 15 * b * a * h * w
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"  paint_orientation B={b} N={n} ({int(act.sum())} active, {roi_px:.0f} ROI pixels, "
        f"{mask_bytes / 1e6:.2f} MB of mask bytes): kernel {t:.4f} ms, plain {tp_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e6:.0f} M ops)")
    return dict(ms=t, plain_ms=tp_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def time_train(tp, dtype, warmup=3, windows=3, steps=10):
    """e2e_fps's method for the train step: warm-ups, then windows of
    ``steps`` steps with one synchronize each; ms/step per window."""
    for _ in range(warmup):
        tp.step(dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    windows_ms = []
    for _ in range(windows):
        start = time.perf_counter()
        for _ in range(steps):
            logs = tp.step(dtype)
        torch.cuda.synchronize()
        windows_ms.append((time.perf_counter() - start) / steps * 1e3)
    if not torch.isfinite(logs["loss"]) or float(logs["skipped"]):
        raise AssertionError(f"the {dtype} train step gave a non-finite loss")
    ms = float(np.median(windows_ms))
    peak = torch.cuda.max_memory_allocated() / 2**30
    b = tp.batch["image"].shape[0]
    log(f"  train step {dtype} B={b} 544x544: {ms:.2f} ms/step, {b * 1e3 / ms:.1f} img/s "
        f"(median; windows {', '.join(f'{x:.2f}' for x in windows_ms)} ms); peak memory "
        f"{peak:.2f} GiB")
    return {"ms_per_step": ms, "img_per_s": b * 1e3 / ms, "windows_ms": windows_ms,
            "peak_gib": peak}


def profile_train(tp, out_dir, steps=3):
    """torch.profiler tables of ``steps`` train steps in each dtype, sorted
    by device time and by host time."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for dtype in ("float32", "bfloat16"):
        tp.step(dtype)
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                tp.step(dtype)
            torch.cuda.synchronize()
        avg = prof.key_averages()
        path = out / f"profile_train_544_b8_{dtype}.txt"
        path.write_text(avg.table(sort_by="cuda_time_total", row_limit=40) + "\n\n"
                        + avg.table(sort_by="self_cpu_time_total", row_limit=25))
        log(f"  profile of {steps} {dtype} train steps written to {path}")


# ------------------------------------------------------- kernels 3 and 4

def per_detection_inputs(rng, b, a=9, h=544, w=544, k=100):
    """``tools/validate_tpu.py::check_mask_kernel``'s inputs with a batch:
    boxes centred in [0.2, 0.8], sides in [0.05, 0.6], anchors uniform over
    the A planes, each detection's anchor size drawn on its own (no table
    row), the last five detections (of more than five) zero-sized."""
    field = rng.standard_normal((b, a, 2, h, w)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, k, 2)),
                            rng.uniform(0.05, 0.6, (b, k, 2))], -1).astype(np.float32)
    boxes[:, max(k - 5, 1):] = 0.0
    anchor_idx = rng.integers(0, a, (b, k)).astype(np.int32)
    anchor_wh = rng.uniform(0.02, 0.5, (b, k, 2)).astype(np.float32)
    return [torch.from_numpy(t).cuda() for t in (field, boxes, anchor_wh, anchor_idx)]


def per_detection_cases(rng):
    """(name, (field, boxes, anchor_wh, anchor_idx), coord_h)."""
    cases = [("B=2 A=9 K=100 544x544", per_detection_inputs(rng, 2), None)]
    args = per_detection_inputs(rng, 1, k=1)
    cases.append(("K=1", args, None))
    args = per_detection_inputs(rng, 2, k=40)
    args[3].fill_(4)
    cases.append(("all detections on anchor 4", args, None))
    args = per_detection_inputs(rng, 1, h=136)
    cases.append(("rows 0..135 with coord_h=544", args, 544))
    args = per_detection_inputs(rng, 2, h=16, w=8, k=7)
    cases.append(("W=8 H=16", args, None))
    args = per_detection_inputs(rng, 1, k=6)
    args[1][:] = torch.tensor([0.5, 0.5, 2.0, 2.0])  # covers the image
    args[3][0, 1], args[3][0, 2] = 9, -1  # off the table: empty masks
    cases.append(("anchors off the table", args, None))
    return cases


def run_validation_path(cases):
    """The validation path of kernels 3 and 4 (``validate_tpu.py:120-161``'s
    role): each case through both wrappers; the launch counts of that run
    alone and the outputs."""
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.ops.masks import assemble_masks, assemble_masks_bitpacked

    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = [(assemble_masks(*args, 0.3, coord_h=coord_h),
             assemble_masks_bitpacked(*args, 0.3, coord_h=coord_h))
            for _, args, coord_h in cases]
    torch.cuda.synchronize()
    return dict(kernels.launches), outs


def check_per_detection():
    """Phase 9: kernels 3 and 4 against their plain versions, bit for bit,
    and against kernel 2 on table sizes."""
    from orienmask_tpu_torch.ops.maskops import pack_bits
    from orienmask_tpu_torch.ops.masks import (
        assemble_masks,
        assemble_masks_bitpacked,
        assemble_masks_bitpacked_plain,
        assemble_masks_packed,
        assemble_masks_plain,
    )

    rng = np.random.default_rng(SEED + 4)
    cases = per_detection_cases(rng)
    counts, outs = run_validation_path(cases)
    max_err = 0
    n = len(cases)
    log(f"  validation path, {n} cases, launches: {counts}")
    if counts["assemble_masks"] != n or counts["assemble_masks_bitpacked"] != n \
            or sum(counts.values()) != 2 * n:
        raise AssertionError(f"expected {n} launches of each per-detection kernel, got {counts}")
    for (name, args, coord_h), (got, got_packed) in zip(cases, outs):
        want = assemble_masks_plain(*args, 0.3, coord_h=coord_h)
        want_packed = assemble_masks_bitpacked_plain(*args, 0.3, coord_h=coord_h)
        if not torch.equal(got, want):
            raise AssertionError(f"assemble_masks '{name}': {(got != want).sum().item()} "
                                 "pixels differ from the plain version")
        if not torch.equal(got_packed, want_packed):
            raise AssertionError(f"assemble_masks_bitpacked '{name}': "
                                 f"{(got_packed != want_packed).sum().item()} bytes differ")
        if not torch.equal(pack_bits(got.bool()), got_packed):
            raise AssertionError(f"'{name}': pack_bits(kernel 3) != kernel 4")
        max_err = max(max_err, (got.int() - want.int()).abs().max().item(),
                      (got_packed.int() - want_packed.int()).abs().max().item())
        log(f"  assemble_masks, assemble_masks_bitpacked {name:30s} field "
            f"{tuple(args[0].shape)} K={args[1].shape[1]}: identical "
            f"({got.float().mean().item():.4f} of pixels set)")
    got = outs[0][0]
    if not got[0, :95].any() or got[:, -5:].any():
        raise AssertionError("kernel 3: masks empty, or a zero-sized box has pixels")
    off = outs[-1][0]
    if off[0, 1:3].any() or not off[0, 0].any():
        raise AssertionError("kernel 3: a detection off the table has pixels")

    # per-detection sizes that are rows of a per-anchor table: kernel 2 applies
    field, boxes, _, anchor_idx = per_detection_inputs(rng, 2)
    table = torch.from_numpy(rng.uniform(0.02, 0.5, (9, 2)).astype(np.float32)).cuda()
    anchor_wh = table[anchor_idx.long()].contiguous()
    k3 = pack_bits(assemble_masks(field, boxes, anchor_wh, anchor_idx, 0.3).bool())
    k4 = assemble_masks_bitpacked(field, boxes, anchor_wh, anchor_idx, 0.3)
    k2 = assemble_masks_packed(field, boxes, anchor_idx, table, 0.3)
    if not (torch.equal(k3, k4) and torch.equal(k4, k2)):
        raise AssertionError("on table sizes pack_bits(kernel 3), kernel 4 and kernel 2 differ")
    log("  table sizes, B=2 K=100 544x544: pack_bits(kernel 3) == kernel 4 == kernel 2")
    return counts, float(max_err), cases[0][1]


def time_per_detection(args):
    """Kernels 3 and 4 per launch at the validation path's main shapes,
    beside their plain versions and bounds."""
    from orienmask_tpu_torch.ops.masks import (
        assemble_masks,
        assemble_masks_bitpacked,
        assemble_masks_bitpacked_plain,
        assemble_masks_plain,
    )

    field, boxes, _, anchor_idx = args
    b, a, _, h, w = field.shape
    k = boxes.shape[1]
    det_px = b * k * h * w
    # each image reads the field planes of the anchors its detections use
    used = sum(len(set(row.tolist())) for row in anchor_idx)
    in_bytes = used * 2 * h * w * 4 + b * k * (16 + 8 + 4)
    res = {}
    # per detection and pixel: 2 multiplies and 2 adds for the sample
    # position, 2 subtracts and 2 compares; then a select and the byte's
    # placement in its word (kernel 3) or a select and an or (kernel 4)
    for name, fn, plain, out_bytes, ops in (
            ("assemble_masks", assemble_masks, assemble_masks_plain, det_px, 10 * det_px),
            ("assemble_masks_bitpacked", assemble_masks_bitpacked,
             assemble_masks_bitpacked_plain, det_px // 8, 10 * det_px)):
        t = time_ms(lambda: fn(*args, 0.3))
        tp = time_ms(lambda: plain(*args, 0.3))
        bound_ms, bound_by = bound(in_bytes + out_bytes, ops)
        log(f"  {name} field {tuple(field.shape)} K={k}: kernel {t:.4f} ms, plain {tp:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {(in_bytes + out_bytes) / 1e6:.1f} MB, "
            f"{ops / 1e6:.0f} M ops)")
        res[name] = dict(ms=t, plain_ms=tp, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return res


# --------------------------------------------------------------- eval path

EVAL_IMAGES = 32


class EvalPath:
    """The published test config on the card: OrienMaskYOLOFPNPlus at full
    width and depth with seeded random weights, written as a reference-layout
    .pth and read back by ``load_checkpoint``; the config's postprocess
    (exact selection) and f32 forward in ``Tester`` over 32 synthetic 544²
    scenes, batch 16, with a COCO ground-truth file."""

    def __init__(self, workdir):
        from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus_test as cfg
        from orienmask_tpu_torch.data import ArrayDataset, ArrayLoader, make_scenes
        from orienmask_tpu_torch.models import build_model, init_random
        from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
        from orienmask_tpu_torch.trainer import Tester, load_checkpoint

        self.cfg = cfg
        workdir = Path(workdir)
        pth = workdir / "weights.pth"
        torch.save({"state_dict": init_random(build_model(cfg["model"]), SEED).state_dict(),
                    "epoch": 0}, pth)
        self.model = build_model(cfg["model"])
        load_checkpoint(pth, self.model)
        nc = cfg["model"]["num_classes"]
        images, infos, gt = make_scenes(np.random.default_rng(SEED + 5), EVAL_IMAGES,
                                        cfg["postprocess"]["image_size"][0], num_classes=nc)
        self.gt_file = workdir / "instances_synthetic.json"
        self.gt_file.write_text(json.dumps(gt))
        self.n_gt = len(gt["annotations"])
        bs = cfg["test_loader"]["batch_size"]
        self.loader = ArrayLoader(images, infos, bs,
                                  ArrayDataset([f"class{c}" for c in range(nc)], range(1, nc + 1)))
        self.pp_kw = _kw(cfg["postprocess"])
        self.workdir = workdir
        pp = OrienMaskYOLOPostProcess(**self.pp_kw, device="cuda")
        self.tester = Tester(self.model, None, pp, self.loader, str(workdir), str(self.gt_file),
                             compute_dtype=cfg["compute_dtype"], device="cuda")

    def run(self):
        """One ``Tester.test()`` over the set, its tables printed to a
        string; (launch counts of the run alone, printed text)."""
        from orienmask_tpu_torch import kernels

        self.tester.coco_metrics.reset()
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            self.tester.test()
        torch.cuda.synchronize()
        return dict(kernels.launches), out.getvalue()


def record_postprocess(pp, fn):
    """Run ``fn()`` with ``pp.apply_device`` shadowed to keep each call's
    head tensors and outputs; returns the (heads, outputs) list."""
    calls = []

    def apply_device(predict):
        out = type(pp).apply_device(pp, predict)
        calls.append((tuple((b.clone(), o.clone()) for b, o in predict),
                      {k: v.clone() for k, v in out.items()}))
        return out

    pp.apply_device = apply_device
    try:
        fn()
    finally:
        del pp.apply_device
    return calls


def compare_postprocess(name, got, want):
    for key in got:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"eval path {name}: '{key}' differs from the plain-version "
                                 "postprocess")


def spread_heads(ev):
    """One eval batch's heads with the bbox heads' final convs rescaled so
    that their logits spread over about one unit across positions (random
    weights leave them within 1e-5), biases N(0, 1), as
    ``tools/validate_tpu.py`` spreads them."""
    from orienmask_tpu_torch.trainer import Tester

    model = copy.deepcopy(ev.model)
    batch = next(iter(ev.loader))
    image = torch.as_tensor(batch["image"]).cuda()
    gen = torch.Generator().manual_seed(SEED + 6)
    heads = ev.tester.forward(image)
    with torch.no_grad():
        for (bbox, _), name in zip(heads, ("bbox_head32", "bbox_head16", "bbox_head8")):
            conv = getattr(model, name)[1]
            logits = bbox.reshape(*bbox.shape[:3], 3, -1)[..., 4:]
            spread = (logits - logits.mean(dim=(1, 2), keepdim=True)).std().item()
            conv.weight.mul_(1.0 / spread)
            conv.bias.copy_(torch.randn(conv.bias.shape, generator=gen))
    tester = Tester(model, None, ev.tester.postprocess, ev.loader, str(ev.workdir),
                    str(ev.gt_file), compute_dtype=ev.cfg["compute_dtype"], device="cuda")
    return tester.forward(image)


def check_eval_path(ev):
    """Phase 10: the Tester loop with launch counts, then the plain-version
    postprocess on the recorded heads: identical outputs and stats."""
    from orienmask_tpu_torch.eval import COCOMetrics

    tester, pp = ev.tester, ev.tester.postprocess
    n_batches = len(ev.loader)
    t = time.perf_counter()
    runs = []
    calls = record_postprocess(pp, lambda: runs.append(ev.run()))
    counts, text = runs[0]
    log(f"  {EVAL_IMAGES} scenes ({ev.n_gt} ground-truth instances), {n_batches} batches of "
        f"{ev.loader.batch_size} in {time.perf_counter() - t:.2f} s, launches: {counts}")
    if counts["exact_topk"] != 2 * n_batches or counts["assemble_masks_packed"] != n_batches \
            or sum(counts.values()) != 3 * n_batches:
        raise AssertionError(f"expected {2 * n_batches} top-k and {n_batches} mask launches "
                             f"and nothing else, got {counts}")
    m = tester.coco_metrics
    bbox, segm = np.asarray(m.bbox_eval_stats), np.asarray(m.segm_eval_stats)
    if bbox.shape != (12,) or segm.shape != (12,) or not len(m.bbox_results):
        raise AssertionError("the eval path gave no 12-stat vectors or no results")
    for batch_out in (c[1] for c in calls):
        check_outputs(batch_out, ev.loader.batch_size)
    log(f"  bbox {np.round(bbox, 4).tolist()}")
    log(f"  segm {np.round(segm, 4).tolist()}")
    log(f"  {len(m.bbox_results)} detections; per-stage table: "
        + "; ".join(line for line in text.splitlines() if "ms (" in line))

    # the same heads through the plain-version postprocess, the same host code
    plain = plain_postprocess(ev.pp_kw)
    metrics = COCOMetrics(str(ev.gt_file), ev.loader.dataset.CAT2LABEL, True, str(ev.workdir))
    for (heads, got), batch in zip(calls, ev.loader):
        want = plain.apply_device(heads)
        torch.cuda.synchronize()
        compare_postprocess("batch", got, want)
        metrics.update_results(metrics.to_coco_format(batch["info"], plain.to_host_list(want)))
    metrics.coco_eval()
    for key, got, want in (("bbox", bbox, metrics.bbox_eval_stats),
                           ("segm", segm, metrics.segm_eval_stats)):
        if not np.array_equal(got, np.asarray(want)):
            raise AssertionError(f"eval path: {key} stats differ with the plain versions")
    log(f"  postprocess with the plain versions on the same heads: identical outputs in all "
        f"{n_batches} batches, identical bbox and segm stats")

    heads = spread_heads(ev)
    got, want = pp.apply_device(heads), plain.apply_device(heads)
    torch.cuda.synchronize()
    check_outputs(got, ev.loader.batch_size)
    compare_postprocess("spread batch", got, want)
    scores = got["bbox"][..., 4][got["valid"]]
    log(f"  spread head logits, one batch of {ev.loader.batch_size}: identical outputs; "
        f"{int(got['valid'].sum())} valid detections, {scores.unique().numel()} distinct "
        f"scores in {scores.min().item():.4f}..{scores.max().item():.4f}, "
        f"{got['cls'][got['valid']].unique().numel()} classes")
    return counts


def eval_topk_input(ev):
    """The (B, P) rows the exact selection hands kernel 1 in one eval batch."""
    pp = ev.tester.postprocess
    rows = []

    def topk(x, k):
        rows.append((x.clone(), k))
        return type(pp)._topk(pp, x, k)

    pp._topk = topk
    try:
        batch = next(iter(ev.loader))
        pp.apply_device(ev.tester.forward(torch.as_tensor(batch["image"]).cuda()))
    finally:
        del pp._topk
    return rows[0]


def time_eval(ev):
    """Phase 11 (the eval path): the exact selection's two-level kernel 1
    beside torch.topk and a stable sort; the Tester's stages."""
    from orienmask_tpu_torch.ops.topk import CHUNK, exact_topk, exact_topk_plain
    from orienmask_tpu_torch.utils import timer

    x, k = eval_topk_input(ev)
    b, p = x.shape
    t = time_ms(lambda: exact_topk(x, k))
    t_lib = time_ms(lambda: torch.topk(x, k))
    t_sort = time_ms(lambda: exact_topk_plain(x, k))
    n = -(-p // CHUNK)
    # the row read once, the values and int64 indices written once; the
    # two levels' key passes and sorts are ~6 operations a key
    n_bytes = b * (p * 4 + k * 12)
    kpad = 1 << (k - 1).bit_length()
    n_ops = b * (6 * (n * CHUNK + n * k) + (n + 1) * kpad * kpad.bit_length() ** 2 // 2)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"  exact selection (B={b}, P={p}, k={k}; two launches of kernel 1): kernel {t:.4f} ms, "
        f"torch.topk {t_lib:.4f} ms, stable torch.sort {t_sort:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {n_bytes / 1e6:.1f} MB)")
    selection = dict(shape=[b, p], k=k, ms=t, plain_ms=t_sort, library_ms=t_lib,
                     bound_ms=bound_ms, bound_by=bound_by)

    # three more passes over the set (phase 10's chose the convolution
    # algorithms); each stage's median pass.  The Tester's timers split
    # Convert Format into the host copy, the boxes, the masks' resize and
    # their RLE encoding.
    passes = []
    for _ in range(3):
        ev.run()
        passes.append(dict(timer.get_all_elapsed_time(), loop=ev.tester.loop_seconds,
                           coco_eval=ev.tester.coco_eval_seconds))
    bs = ev.loader.batch_size
    med = {key: float(np.median([q[key] for q in passes])) for key in passes[0]}
    stages = {key: med[key] / bs for key in passes[0] if key not in ("loop", "coco_eval")}
    ips = EVAL_IMAGES / med["loop"]
    log(f"  Tester, {EVAL_IMAGES} images at batch {bs}, median of 3 passes: "
        + ", ".join(f"{key} {v:.3f} ms/image" for key, v in stages.items())
        + f"; loop {med['loop']:.2f} s = {ips:.2f} images/s (passes "
        + ", ".join(f"{q['loop']:.2f}" for q in passes) + f" s); coco_eval "
        f"{med['coco_eval']:.2f} s")
    return selection, {"ms_per_image": stages, "images_per_s": ips, "loop_s": med["loop"],
                       "passes": passes, "coco_eval_s": med["coco_eval"]}


# ------------------------------------------------------------------- main

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", help="also write a torch.profiler table")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card", file=sys.stderr)
        return 2
    from orienmask_tpu_torch import kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()

    log("[1] build")
    t = time.perf_counter()
    for name in kernels.SIGNATURES:
        kernels.library(name)  # the first call builds every csrc/*.cu
    log(f"  card: {card_line()} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"  kernels built and loaded in {time.perf_counter() - t:.2f} s "
        f"(nvcc: {kernels.build_seconds if kernels.build_seconds is not None else 0:.2f} s)")

    log("[2] kernel 1: exact_topk vs its plain version")
    topk_err = check_topk()
    log("[3] kernel 2: assemble_masks_packed vs its plain version")
    mask_err = check_masks()

    log("[4] main path: OrienMaskYOLOFPNPlus 544x544 bf16, InferencePipeline")
    t = time.perf_counter()
    pipe, pp_kw = build_pipeline()
    image = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (1, 480, 640, 3), dtype=np.uint8)).cuda()
    log(f"  model built and folded in {time.perf_counter() - t:.2f} s")
    counts = check_main_path(pipe, pp_kw, image)

    log("[5] timings")
    times = time_kernels(pipe, image)
    torch.cuda.reset_peak_memory_stats()
    fps, rates = e2e_fps(pipe, image)
    log(f"  e2e 544x544 bs1: {fps:.2f} FPS (median; windows "
        f"{', '.join(f'{r:.2f}' for r in rates)}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if args.profile:
        profile(pipe, image, args.profile)
    del pipe

    log("[6] kernel 5: paint_orientation vs its plain version")
    t = time.perf_counter()
    tp = TrainPath()
    log(f"  train path set up in {time.perf_counter() - t:.2f} s (full-width model, "
        f"seeded weights, synthetic batch through collate)")
    paint_err = check_paint(tp)

    log("[7] train path: orienmask_yolo_coco_544_anchor4_fpn_plus, B=8, make_train_step")
    train_counts = check_train_path(tp)

    log("[8] train timings")
    times["paint_orientation"] = time_paint(tp)
    train = {dtype: time_train(tp, dtype) for dtype in ("float32", "bfloat16")}
    if args.profile:
        profile_train(tp, args.profile)
    del tp

    log("[9] kernels 3 and 4: assemble_masks, assemble_masks_bitpacked vs plain versions")
    per_det_counts, per_det_err, per_det_args = check_per_detection()

    with tempfile.TemporaryDirectory() as workdir:
        log("[10] eval path: orienmask_yolo_coco_544_anchor4_fpn_plus_test, Tester, B=16")
        t = time.perf_counter()
        ev = EvalPath(workdir)
        log(f"  eval path set up in {time.perf_counter() - t:.2f} s (full-width model, "
            f"seeded weights through a .pth and load_checkpoint, {EVAL_IMAGES} scenes)")
        eval_counts = check_eval_path(ev)

        log("[11] eval timings")
        times.update(time_per_detection(per_det_args))
        selection, eval_times = time_eval(ev)
        del ev

    # launches: each path's count, read around that path's run alone; the
    # times are those of the infer path's inputs (kernels 1, 2), the eval
    # path's exact selection beside them (kernel 1), the validation path's
    # (kernels 3, 4) and the train path's (kernel 5)
    paths = {name: {"infer": counts[name], "eval": eval_counts[name]}
             for name in ("exact_topk", "assemble_masks_packed")}
    kernels_line = {"kernels": [
        dict(name="exact_topk", route="cuda", source="orienmask_tpu_torch/csrc/topk.cu",
             replaces="orienmask_tpu/ops/pallas_topk.py:157",
             launches=sum(paths["exact_topk"].values()), paths=paths["exact_topk"],
             max_abs_err=topk_err, **times["exact_topk"], exact_selection=selection),
        dict(name="assemble_masks_packed", route="cuda",
             source="orienmask_tpu_torch/csrc/masks.cu",
             replaces="orienmask_tpu/ops/pallas_masks.py:247",
             launches=sum(paths["assemble_masks_packed"].values()),
             paths=paths["assemble_masks_packed"], max_abs_err=mask_err,
             **times["assemble_masks_packed"]),
        dict(name="assemble_masks", route="cuda", source="orienmask_tpu_torch/csrc/masks.cu",
             replaces="orienmask_tpu/ops/pallas_masks.py:60",
             launches=per_det_counts["assemble_masks"], max_abs_err=per_det_err,
             **times["assemble_masks"]),
        dict(name="assemble_masks_bitpacked", route="cuda",
             source="orienmask_tpu_torch/csrc/masks.cu",
             replaces="orienmask_tpu/ops/pallas_masks.py:142",
             launches=per_det_counts["assemble_masks_bitpacked"], max_abs_err=per_det_err,
             **times["assemble_masks_bitpacked"]),
        dict(name="paint_orientation", route="cuda", source="orienmask_tpu_torch/csrc/paint.cu",
             replaces="orienmask_tpu/ops/pallas_paint.py:149",
             launches=train_counts["paint_orientation"], max_abs_err=paint_err,
             **times["paint_orientation"]),
    ]}
    log(f"  total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"e2e_fps_544_bs1": fps, "windows": rates, "train_544_b8": train,
                    "eval_544_b16": eval_times}))
    log(card_line())
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
