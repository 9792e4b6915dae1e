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
   synchronize per window, median window).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  ``--profile DIR`` also writes a
torch.profiler table of 20 frames to DIR.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# H100 SXM (NVIDIA data sheet): the HBM rate, and 67 TFLOP/s of float32
# outside the tensor cores.  That peak counts an FMA as two operations; the
# kernels' counts below are single instructions (subtract, compare, shift,
# and, or), each of which takes a whole FMA slot, so they are held against
# half of it.  Bounds are taken against these published peaks.
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
    # per used anchor and pixel: 2 multiplies and 2 adds; per detection and
    # pixel (each on its own anchor): 2 subtracts, 2 abs, 2 compares, 1 and,
    # and the shift and or that pack the bit into its byte
    n_ops = used * h * w * 4 + b * kk * h * w * 9
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

    kernels_line = {"kernels": [
        dict(name="exact_topk", route="cuda", source="orienmask_tpu_torch/csrc/topk.cu",
             replaces="orienmask_tpu/ops/pallas_topk.py:157",
             launches=counts["exact_topk"], max_abs_err=topk_err, **times["exact_topk"]),
        dict(name="assemble_masks_packed", route="cuda",
             source="orienmask_tpu_torch/csrc/masks.cu",
             replaces="orienmask_tpu/ops/pallas_masks.py:247",
             launches=counts["assemble_masks_packed"], max_abs_err=mask_err,
             **times["assemble_masks_packed"]),
    ]}
    log(f"  total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"e2e_fps_544_bs1": fps, "windows": rates}))
    log(card_line())
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
