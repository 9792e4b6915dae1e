#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``orienmask_tpu_torch``) on one NVIDIA card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc``; without a card it exits non-zero and
prints no result.  Phases, in order (any failure raises and exits non-zero):

1. build the hand-written kernels of ``orienmask_tpu_torch/csrc`` with nvcc
   for sm_90a and the host libraries (``csrc/*.cc``: the JPEG scans and
   coder, TIFF's LZW codec, WebP's VP8 and VP8L loops, the native host library
   ``omtpu``) with g++; print the card, the build time
   and ptxas's registers, shared memory and spills for kernels 1–4 and 6;
2. kernel 1 (exact top-k) against its plain version on the card: values and
   indices bit-identical on every case, each with its launch plan (C, chunk),
   batch rows at every cluster size from 3 to 8 among them;
   rows its cluster cannot hold, and a cluster past 16 CTAs, refused;
3. kernel 2 (packed mask assembly) against its plain version on the card:
   bytes bit-identical on every case;
4. the main path: the full-width 544² OrienMaskYOLOFPNPlus (seeded random
   weights, bf16) in ``InferencePipeline`` answers requests on a seeded
   480x640 uint8 image; launch counts are read around those requests; the
   postprocess is then run again on the same head tensors with the plain
   versions and must give identical outputs;
5. timings at the main path's shapes: each kernel, its plain version and
   the library call (CUDA events between CUDA-graph replays, median of 50),
   kernel 1 at cluster sizes 4, 8 and 16 and on batch rows (B = 22 and
   40, clusters of 6 and 3), and e2e FPS at 544² batch 1 (10
   warm-ups, 5 windows of 200 frames, one synchronize per window, median
   window);
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
   K = 100, B = 2, per-detection anchor sizes off any table) and on 13 more
   cases (K = 1, one anchor, coord_h != H, off-table detections, W = 8, a
   painted field with sizes within 5% of the anchors' rows, half sizes of
   zero, -0.0, negative, NaN, inf and subnormal, NaN and +-inf fields, ties
   on pixel coordinates, K = 2,048 and 2,100, A = 40 and 10,000), each
   bit-identical to its plain version with pack_bits(kernel 3) == kernel 4
   and its tile classes printed, with launch counts read around the run; on
   table sizes (random and painted fields) pack_bits(kernel 3) == kernel 4
   == kernel 2;
10. the eval path: the published test config (f32, batch 16, the exact
   selection) at full width with seeded random weights saved as a
   reference-layout .pth and read by ``load_checkpoint``; ``Tester`` runs
   over 32 synthetic 544² scenes with COCO ground truth, with launch
   counts read around the loop (kernel 1 twice a batch, kernels 2 and 6
   once: Convert Format recovers the masks on the card and the native
   library encodes them); the postprocess with the plain versions on the
   same heads must give identical device outputs, and the host route of the
   COCO conversion (``to_host_list``, the numpy resize, the RLE of uint8
   masks) on them the same JSON files and 12-stat bbox and segm vectors as
   the card route; one batch with spread head logits must match too, in
   its outputs and in both routes' COCO dicts;
11. eval timings: kernels 3 and 4 on phase 9's main case and on a painted
   field, each beside its plain version, its bound recounted from the tile
   classes, the unculled count and the per-detection grid's time; the exact
   selection (two levels of kernel 1 at (16, 1,456,560)) beside its plain
   version, the library call and its bound; ``Tester``'s ms/image per
   stage, the loop's images per second and the seconds of ``coco_eval``;
12. the infer CLI at 544²: ``orienmask_tpu_torch.infer.main`` in this
   process with ``--random-weights -d <8 seeded 480x640 PNGs> -j <images
   json> -o <dir>``, for ``orienmask_yolo_coco_544_anchor4_fpn_plus_infer``
   and for the base model's ``orienmask_yolo_coco_544_anchor4_infer``; each
   image's device outputs identical to the plain-version postprocess on its
   heads, the dumped bbox and segm jsons one entry per valid detection and
   identical to the host route's on the same device outputs (each image's
   card-route COCO dicts too), launch counts read around each run (kernel 1
   twice, kernels 2 and 6 once an image);
13. the 736² stream: ``--video <24 seeded 720x1280 PNG frames>`` with
   ``orienmask_yolo_coco_736_anchor4_fpn_plus_infer`` at depth 2, each
   frame's device outputs and streamed host lists identical to the plain
   versions'; kernel 1 at (1, 33,327) and (1, 32,000) and kernel 2 at 736²
   bit for bit against their plain versions, each timed beside its plain
   version, its bound and (kernel 1) torch.topk; streamed FPS at depth 1
   and 2 (frames decoded in host memory, 10 warm-ups, 5 windows of 80
   frames, the median window, with the host's ms a frame inside ``submit``
   and ``retrieve``) and ``run_device`` alone on a frame staged on the card;
14. batched inference at 544², B = 8 and 16: launch counts of one call at
   each, outputs identical to the plain-version postprocess on the same
   heads, kernel 1's launch plans, kernels 1 and 2 at the batch shapes as in
   phase 13, images/s with ``tools/bench_batched.py``'s method (the batch
   staged on the card, 6 warm-ups, max(1, 200 // B) calls a window, 5
   windows, one synchronize a window, the median);
15. JPEG and the visualizer: the committed fixtures of ``probe/jpeg_fixtures``
   (480x640 and odd-sized scenes at 4:4:4, 4:2:2, 4:4:0, 4:2:0, progressive,
   a restart interval, grey, an EXIF rotation) decoded by the port's reader
   (its C++ scan decoder built with g++ here) and each held to the SHA-256 of
   cv2's decode recorded beside it, with the decode ms per 480x640 image;
   the infer CLI at 544² over them with -j -o and with -v -o, and
   ``--video <the fixtures> -o`` at 736² (depth 2): every image's device
   outputs identical to the plain-version postprocess on its heads, kernel 1
   twice and kernel 2 once an image (kernel 6 once with -j), the JSONs'
   entry counts and their identity with the host route's, every written
   file (JPEG under each input's name, ``frame_%06d.jpg``) the bytes
   ``write_image`` writes for the port's visualizer on the plain-version
   host list under the same ``random.seed``; a host list with spread scores drawn too
   (random weights put nothing above conf_thresh 0.3); the reports' Load
   data, Forward & Postprocess and Visualize ms an image;
16. kernel 6 (mask recovery, ``csrc/recover.cu``) against its plain version
   on the card, bit for bit, on noise masks (every pixel a 0.5 tie) at (a)
   the CLI's 544² to 480x640, 100 masks, (b) an eval batch, B = 16 at 544²
   to 544², (c) the JPEG fixture's 427x613, (d) 736² to 720x1280, (e)
   hflip + vflip with asymmetric pads at B = 3, (f) an exact 2x down, and
   on (g) 100 elliptic masks (``data/synthetic.py``'s kind) at the CLI's
   544² to 480x640; each timed beside its plain version and its bound
   (bytes, and a pass's subtraction and fused multiply-add where its
   fraction is non-zero and its two values differ, a rint where any pass
   ran), with its 32x32 tiles counted by the kernel's path (identity,
   uniform 0 or 1, mixed);
17. training and evaluation from files: the port's mini dataset
   (``utils/mini_dataset.py``: 32 seeded PNG scenes at 480x640 and 427x613,
   elliptic and polygonal instances, COCO json with polygons and RLE) and
   the published train config at full width on it (one device's share,
   B = 8, f32, its train transform and 4 loader workers, 3 epochs each
   validated, ``pretrained`` a missing file); ``orienmask_tpu_torch.train
   .main`` in this process, then ``orienmask_tpu_torch.test.main`` on the
   best checkpoint with the val set as its test set, launch counts read
   around each; every epoch's loss finite and epoch 3's below epoch 1's;
   the checkpoints named as the JAX package names them and loaded back;
   kernel 5 on the loader's first batch, and kernels 1 and 2 on every val
   and test batch's heads, bit-identical to their plain versions; the last
   val epoch's COCO JSON identical to the host route's, and kernel 6 to its
   plain version, on the same device outputs (kernel 6 on the test CLI's
   too); the test CLI's 12-stat
   vectors equal to an in-process ``Tester``'s; the train epochs' and val
   epochs' images/s, each step's time on the stream, the trainer's wait for
   its loader, the host data path's ms an image inline and the test CLI's
   stage ms an image;
18. data parallelism: the published train config with its ``n_device=2``
   as published (B = 8 a device, 16 global, f32) as two ranks on the one
   card, spawned with ``torch.multiprocessing`` (gloo with CUDA tensors:
   NCCL takes no two ranks on one device), on phase 17's dataset with 2
   loader workers a rank: first one step of 2 ranks x 4 of phase 7's
   images, then ``train.main`` for 2 epochs of 2 steps each validated,
   then ``test.main`` with ``n_device=2`` on its best checkpoint, launch
   counts read around each rank's runs; both ranks end equal by bits (the
   step's and the train CLI's states), every epoch's loss finite, rank 0's
   merged COCO results the sum of both ranks'; kernel 5 on rank 0's first
   batch and kernels 1, 2 and 6 on its val and test batches bit-identical
   to their plain versions; in this process the same step on all 8
   images with no group and in a one-rank NCCL group (the synced
   BatchNorm, the loss's counts and the gradient sum through NCCL), each
   held to the no-group step at ``tests/test_torch_parallel.py``'s
   tolerances, and the test CLI in one process, whose 12-stat vectors the
   two ranks' must equal; global images/s of the train epochs, each rank's
   step on the stream and its time in collectives, its loader wait and
   peak memory;
19. the train step's options on the published train config at full width
   (B = 8, f32, phase 7's batch): (a) one step with ``remat`` and one
   without from the same state under ``cudnn.deterministic``: loss,
   gradients, parameters, momentum and BatchNorm buffers equal by bits,
   each BatchNorm counted once; then ms a step and peak memory of each in
   turns (off, on, on, off); (b) ``freeze_backbone: 2``,
   ``backbone_batchnorm_eval`` and ``param_groups`` for 3 steps: conv1 and
   conv2 unchanged by bits with zero momentum, every backbone BatchNorm
   buffer unchanged, the rest moved, the last update the plain
   per-parameter SGD formula by bits, kernel 5 on the batch against its
   plain version; (c) the train CLI with those keys and ``remat`` for 2
   steps on 16 of phase 17's scenes; launch counts read around each;
20. int8 on the 544² infer config at full width: (a) every distinct int8
   convolution shape of a frame quantized with the stem (conv1's K = 27
   among them) through im2col and ``torch._int_mm`` against the float64
   plain version, by bits; (b) ``quantize_int8`` calibrated on the seeded
   480x640 image: 4 requests with launch counts, kernels 1 and 2 against
   their plain versions on the int8 heads, the kernels and copies of a
   call and its device time by kernel at batch 1 and B = 16 for int8 and
   bf16 (torch.profiler), e2e FPS at batch 1 (windows of 100 frames) and
   images/s at B = 16 of bf16, then of int8; (c) phase 17's best
   checkpoint in the pipeline in f32, bf16 and int8 (calibrated on the
   first 8 val scenes), the 32 val scenes through each as the infer CLI's
   ``-j`` runs them: detections matched to f32's, matched masks' pixel
   agreement and IoU, bbox and segm AP through the port's COCO evaluation;
21. serving: the 544² infer config's bf16 pipeline exported through
   ``serving.export_pipeline`` (``torch.export``, kernels 1 and 2 as custom
   operators) at (1, 480, 640, 3) and (8, 480, 640, 3) and its int8 pipeline
   (calibrated as in phase 20) at (1, 480, 640, 3), into a temporary
   directory; each artifact loaded and run by a fresh process that cannot
   import ``orienmask_tpu_torch.models``, its outputs bit-identical to the
   live ``run_device``'s on phase 4's seeded image(s), kernels 1 and 2
   launched 2 and 1 times a served call; export and load seconds, the
   artifacts' bytes, and served against live e2e FPS at batch 1 (3 windows
   of 100 frames a turn; live, served, served, live);
22. spatial partitioning (``parallel/spatial.py``): two ranks on the one
   card (gloo with CUDA tensors, spawned as in phase 18), each image's rows
   over both (544²: 288 + 256 input rows): (a) the 544² infer config at
   B = 1 in f32 (TF32 off), its heads against one process's, and in bf16
   over 4 frames with launch counts (kernel 1 twice, kernel 2 once a rank
   and frame), the halo exchanges of a frame counted and their gathers
   timed on the stream, ms a frame against one process; (b)
   ``run_batch_spatial`` on the one-process f32 heads equal to
   ``_run_batch`` by bits and to the plain versions' route, kernel 2's row
   block at row0 0 and 272 equal to its plain version; (c) ``infer
   --spatial 2`` in a subprocess over 4 seeded PNGs at 544² (-j -o) and 6
   720x1280 frames through the 736² ``--video`` config; (d) the int8
   pipeline under the space group against one process's; (e) the spatial
   train step at full width, B = 2 (phase 7's first images), against one
   process at phase 18's tolerances, then the train CLI with ``n_space=2``
   for one epoch on phase 17's kind of dataset (launches: kernel 5 on both
   ranks, kernels 1, 2 and 6 on space rank 0 alone); (f) resnet50 at 544²
   on the card against its CPU forward;
23. image files in and out, and the train resizes: (a) the infer CLI at
   544² (full width, seeded random weights) with -v -o over a directory of
   a JPEG, a PNG, a 24-bit BMP and an LZW TIFF with the predictor written
   by the port's writers and the committed RLE8 BMP, PackBits TIFF and
   tiled Deflate TIFF of ``tests/image_fixtures``, then --video -o over it:
   every output under its input's name and in its format (``frame_%06d.jpg``
   for --video), read back by the port's readers and equal to the bytes
   ``write_image`` writes for the visualizer on the plain-version host
   list, kernel 1 twice and kernel 2 once an image, every image's device
   outputs identical to the plain-version postprocess on its heads; (b) on
   the host, the C++ Huffman coder against the plain one byte for byte on
   six sizes that are not whole MCUs, colour and grey, at qualities 75, 95
   and 98, the C++ LZW codec against the plain one, and the ms of a 480x640
   JPEG encode and decode, BMP write and read, TIFF write and read; (c)
   ``COCODataset`` over the port's mini dataset (8 scenes) through the
   published train transform with its Resize at area, cubic and lanczos4
   in turn, one B = 8 train step at full width for each: a finite loss,
   kernel 5 launched once and equal to its plain version on the batch;
24. WebP and platforms: (a) the infer CLI at 544² (as phase 23) with -v -o
   and --video -o over the committed WebP fixtures (VP8L, VP8 at qualities
   50 and 95, VP8X with ALPH, a 3-frame animation, EXIF orientation 6, a
   33x65 image): each drawing written to its .webp name as VP8L, the bytes
   ``write_image`` writes for the plain-version drawing, read back by the
   port; every WebP fixture read on the host to its committed digest
   (cv2's pixels); the C++ VP8 and VP8L loops equal to their plain
   versions on the fixtures; the host ms of a 480x640 VP8L write and read
   and of the committed 480x640 VP8 read; (b) the bf16 544² pipeline
   exported at (1, 480, 640, 3) for ``["cpu", "cuda"]`` into one artifact,
   loaded by a fresh process without the model code on the card and then
   on the CPU, each served program equal by bits to the live pipeline on
   its device, kernels 1 and 2 launched twice and once a CUDA call.

Each phase's first line gives the seconds since the script's start.  The
last five lines: the end-to-end JSON (``e2e_fps_544_bs1``,
``train_544_b8``, ``eval_544_b16``, ``train_files_544_b8``,
``dp_train_544_b8x2``, ``train_options_544_b8``, ``int8_544``,
``serving_544``, ``spatial_544``);
``{"infer_544_b8": ..., "infer_544_b16": ..., "stream_736": {"depth1": ...,
"depth2": ..., "staged_fps": ...}, "jpeg": {...}, "image_files": {...},
"webp": {...}}``; the card's name and
power limit; the kernels' JSON record: every kernel carries per-path launch
counts (``paths``: kernels 1 and 2 infer, eval, cli, stream_736, batch,
jpeg_cli; kernel 6 eval, cli, jpeg_cli; kernel 5 train; kernels 3 and 4
validation; each also train_cli and test_cli; kernels 1, 2 and 6 dp_train
and dp_test, kernel 5 dp_train, both ranks' counts summed; kernel 5 remat,
train_options and options_cli; kernels 1 and 2 int8, serving and
serving_int8, and with kernel 6 accuracy_f32, accuracy_bf16 and
accuracy_int8; kernels 1 and 2 spatial and spatial_int8, kernel 5
spatial_train, kernels 5, 1, 2 and 6 spatial_train_cli; kernels 1 and 2
image_files_cli and image_files_video, kernel 5 train_resizes; kernels 1 and
2 webp_cli, webp_video and platforms_cuda), kernels 1 and
2 their times at the 736² and batch shapes (``shapes_736``, ``batch``),
kernel 6 phase 16's cases; the last line is ``{"ok": true, "device":
{...}}``.  ``--profile DIR`` also writes
torch.profiler tables of 20 frames and of 3 train steps in each dtype to
DIR.
"""

import argparse
import contextlib
import copy
import io
import json
import os
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
# against half of it.  Kernel 2's bound counts what its function needs
# however it is built (``mask_work``); the per-detection kernels' counts
# (3, 4) and kernel 2's unculled count are those of the predicate and
# packing in ``cuobjdump -sass`` of the built csrc/build/libmasks.so: the
# abs is an operand modifier of the compare, and the second compare takes
# the first's predicate as its `and` input.  Bounds are taken against these
# published peaks.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12 / 2
TIMED_LAUNCHES = 50


def log(*args):
    print(*args, flush=True)


START = time.perf_counter()


def header(text):
    """A phase's first line, with the seconds since the script's start."""
    log(f"{text} (at {time.perf_counter() - START:.1f} s)")


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
        ("split, -inf mix, padded last chunk", np.where(
            rng.uniform(size=(1, 2 * 32768 + 100)) < 0.5, -np.inf,
            normal(1, 2 * 32768 + 100)).astype(np.float32), 1024),
    ]
    # the detect stage's sentinel: -1.0 everywhere but m keys, so T is -1.0
    # (m < k) or the lowest kept score (m = k)
    for p, m in ((18207, 150), (32000, 399), (18207, 400), (32000, 400)):
        x = np.full((1, p), -1.0, np.float32)
        x[0, rng.choice(p, m, replace=False)] = rng.uniform(0.005, 1.0, m)
        cases.append((f"-1.0 but {m} keys, B=1 P={p}", x, 400))
    # the exact selection's level 1: 720 chunks of 32,368, mostly -1.0 with
    # tied kept scores
    x = np.where(rng.uniform(size=(720, 32368)) < 0.02,
                 rng.choice(np.float32([0.25, 0.5, 0.75]), (720, 32368)), -1.0)
    cases += [
        ("eval level 1, tie-heavy", x.astype(np.float32), 400),
        ("P = 5 < C", normal(3, 5), 5),
        ("k = 1", normal(4, 18207), 1),
        ("k = 1, all equal", np.full((2, 32000), 0.5, np.float32), 1),
        # one high part, 10 random low bits: the first two passes find the
        # same bins and the third tells the keys apart (ties among 1024 values)
        ("keys differ in the last 10 bits",
         (np.uint32(0x3e860000) | rng.integers(0, 1024, (2, 18207), dtype=np.uint32))
         .view(np.float32), 400),
        ("last 10 bits, negative", -(np.uint32(0x3f000000) | rng.integers(
            0, 1024, (1, 32000), dtype=np.uint32)).view(np.float32), 1024),
    ]
    # batch inference's detect-stage rows: clusters of 7, 6, 5, 4 and 3 CTAs
    for b in BATCH_CLUSTERS:
        cases.append((f"batch rows B={b} P=18207", normal(b, 18207), 400))
    cases.append(("batch rows B=22, quantized ties", rng.choice(levels, (22, 18207)), 400))
    return cases


# rows of 18,207 keys (the detect stage's) -> the cluster size launch_plan
# gives them: the sizes batch inference reaches besides 4, 8 and 16
BATCH_CLUSTERS = {17: 7, 22: 6, 26: 5, 27: 4, 40: 3}


def check_topk():
    from orienmask_tpu_torch.ops.topk import exact_topk, exact_topk_plain, launch_plan

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
        if name.startswith("batch rows") and launch_plan(*x.shape)[0] != BATCH_CLUSTERS[x.shape[0]]:
            raise AssertionError(f"'{name}': launch plan {launch_plan(*x.shape)}, expected "
                                 f"C = {BATCH_CLUSTERS[x.shape[0]]}")
        log(f"  exact_topk {name:34s} B={x.shape[0]} P={x.shape[1]} k={k} "
            f"(C, chunk) {launch_plan(*x.shape)}: identical")
    check_topk_limits()
    return max_err


def check_topk_limits():
    """The C entry point refuses a row that its cluster cannot hold in
    registers, and the card refuses a cluster past 16 CTAs; either raises,
    and the next launch is unaffected."""
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.ops.topk import exact_topk, exact_topk_plain

    for p, k, c in ((65537, 400, 8), (40000, 400, 4), (18207, 400, 32)):
        x = torch.zeros((1, p), device="cuda")
        v = torch.empty((1, k), device="cuda")
        i = torch.empty((1, k), dtype=torch.int64, device="cuda")
        try:
            kernels.launch("topk", "omt_exact_topk", x.data_ptr(), v.data_ptr(),
                           i.data_ptr(), 1, p, k, c)
        except RuntimeError as e:
            log(f"  omt_exact_topk P={p} k={k} C={c} refused: {e}")
            continue
        raise AssertionError(f"omt_exact_topk took P={p} k={k} C={c}, past its limits")
    x = torch.randn((2, 32000), device="cuda")
    if not torch.equal(exact_topk(x, 400)[1], exact_topk_plain(x, 400)[1]):
        raise AssertionError("exact_topk differs after a refused launch")


# --------------------------------------------------------------- kernel 2

def mask_inputs(rng, b, a=9, h=544, w=544, k=100):
    field = rng.standard_normal((b, a, 2, h, w)).astype(np.float32)
    boxes = np.stack([rng.uniform(0.1, 0.9, (b, k)), rng.uniform(0.1, 0.9, (b, k)),
                      rng.uniform(0.02, 0.6, (b, k)), rng.uniform(0.02, 0.6, (b, k))],
                     axis=-1).astype(np.float32)
    boxes[:, k - min(10, k - 1):] = 0.0  # padded detections: zero-sized boxes
    anchor_idx = rng.integers(0, a - 2, (b, k)).astype(np.int32)  # a-2, a-1 unused
    anchor_idx[:, :8] = 3  # duplicates on one anchor
    table = rng.uniform(0.02, 0.7, (a, 2)).astype(np.float32)
    return [torch.from_numpy(t).cuda() for t in (field, boxes, anchor_idx, table)]


def painted_inputs(rng, b, n=8, k=100, device="cuda"):
    """Kernel 2's inputs on the field that a model which fits its training
    targets predicts: the orientation targets that ``OrientationPainter``
    paints at 544² for ``n`` synthetic instances an image (an ellipse in
    each box, on the anchor of closest shape), as (B, 9, 2, H, W); and
    ``k`` detections an image drawn from those instances, on their anchors,
    with boxes jittered by up to 5% of their sides.  Returns ([field,
    boxes, anchor_idx, table], orien_thresh)."""
    from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus as cfg
    from orienmask_tpu_torch.ops.targets import OrientationPainter

    lc, pc = cfg["loss"], cfg["postprocess"]
    painter = OrientationPainter(lc["image_size"], lc["anchors"], lc["anchor_mask"],
                                 lc["grid_size"], lc["center_region"], lc["valid_region"],
                                 device=device)
    h, w = lc["image_size"]
    anchors = np.asarray(lc["anchors"], np.float32)
    gt = np.concatenate([rng.uniform(0.15, 0.85, (b, n, 2)),
                         rng.uniform(0.05, 0.5, (b, n, 2))], -1).astype(np.float32)
    pw, ph = gt[..., 2:3] * w, gt[..., 3:4] * h
    inter = np.minimum(pw, anchors[:, 0]) * np.minimum(ph, anchors[:, 1])
    anc = (inter / (pw * ph + anchors.prod(1) - inter)).argmax(-1)
    xs, ys = (np.arange(w) + 0.5) / w, (np.arange(h)[:, None] + 0.5) / h
    cx, cy, bw, bh = (gt[..., i, None, None] for i in range(4))
    gt_mask = ((xs - cx) / (bw / 2)) ** 2 + ((ys - cy) / (bh / 2)) ** 2 < 1
    _, _, torien = painter(*(torch.from_numpy(t).to(device) for t in (
        gt, anc, np.ones((b, n), bool), gt_mask)))
    field = torien.permute(0, 1, 4, 2, 3).contiguous()
    inst = rng.integers(0, n, (b, k))
    rows = np.take_along_axis(gt, inst[..., None], 1)
    boxes = rows * (1 + rng.uniform(-0.05, 0.05, rows.shape))
    table = anchors / np.array([w, h], np.float32)
    return [field] + [torch.from_numpy(t).to(device) for t in (
        boxes.astype(np.float32), np.take_along_axis(anc, inst, 1).astype(np.int32),
        table)], pc["orien_thresh"]


def class_counts(cls):
    """{all out, all in, mixed, empty}: the counts of (detection, tile)
    classes from a plain mirror of the culling rule."""
    from orienmask_tpu_torch.ops import masks

    return {name: int((cls == v).sum()) for name, v in (
        ("all_out", masks.ALL_OUT), ("all_in", masks.ALL_IN), ("mixed", masks.MIXED),
        ("empty", masks.EMPTY))}


def tile_counts(args, thresh, valid=None, **kw):
    """Kernel 2's (detection, tile) classes for one call, counted with the
    plain mirror of its rule."""
    from orienmask_tpu_torch.ops import masks

    return class_counts(masks.tile_classes(*args, thresh, valid=valid, **kw))


def mask_cases(rng):
    """(name, [field, boxes, anchor_idx, table], thresh, valid or None, coord_h/row0
    keywords): kernel 2's cases beside the random ones."""
    def tensors(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(t)).cuda() for t in arrays]

    cases = []
    for b in (1, 2, 16):
        cases.append((f"random B={b} A=9 K=100", mask_inputs(rng, b), 0.3, None, {}))
    # a zero field: g is the pixel's own coordinate; with t = 1, t*w = w, and
    # each box's edges sit exactly on column (row) coordinates: ties
    h = w = 544
    k = 100
    cols = np.arange(w, dtype=np.float32) * np.float32(1.0 / w)
    i, j = rng.integers(0, w, (2, 1, k))
    boxes = np.stack([cols[i], cols[j], np.abs(cols[rng.integers(0, w, (1, k))] - cols[i]),
                      np.abs(cols[rng.integers(0, w, (1, k))] - cols[j])], -1)
    field = np.zeros((1, 3, 2, h, w), np.float32)
    table = rng.uniform(0.02, 0.7, (3, 2)).astype(np.float32)
    aidx = rng.integers(0, 3, (1, k)).astype(np.int32)
    cases.append(("zero field, box edges on pixel coordinates (ties)",
                  tensors(field, boxes.astype(np.float32), aidx, table), 1.0, None, {}))
    # NaN and +-inf in the field of every anchor
    args = mask_inputs(rng, 1)
    f = args[0].view(-1)
    spots = torch.from_numpy(rng.choice(f.numel(), 30000, replace=False)).cuda()
    f[spots] = torch.tensor([np.nan, np.inf, -np.inf], device=f.device).repeat(10000)
    cases.append(("NaN and +-inf in the field", args, 0.3, None, {}))
    # boxes over the whole image on a small field: all-in tiles
    args = mask_inputs(rng, 2)
    args[0].mul_(0.01)
    args[1][:, :50] = torch.tensor([0.5, 0.5, 4.0, 4.0], device=args[1].device)
    cases.append(("boxes covering the image", args, 0.3, None, {}))
    # zero-sized and negative boxes
    args = mask_inputs(rng, 1)
    args[1][0, :30, 2] = 0.0
    args[1][0, 30:60, 3] = -0.2
    args[1][0, 60:70, 2:4] = -0.0
    cases.append(("zero-sized and negative boxes", args, 0.3, None, {}))
    # validity: all, none, 7 of 100
    args = mask_inputs(rng, 1)
    for name, valid in (("all", np.ones((1, 100), bool)), ("none", np.zeros((1, 100), bool)),
                        ("7 of 100", np.isin(np.arange(100), rng.choice(100, 7, False))[None])):
        cases.append((f"valid: {name}", args, 0.3, *tensors(valid), {}))
    args = mask_inputs(rng, 3, k=100)
    valid, = tensors(rng.uniform(size=(3, 100)) < 0.5)
    args[2][0, :5] = 9  # off the table
    args[2][1, :5] = -1
    cases.append(("B=3, half valid, anchors off the table", args, 0.3, valid, {}))
    cases.append(("K=1", mask_inputs(rng, 1, k=1), 0.3, None, {}))
    args, thresh = painted_inputs(rng, 2)
    cases.append(("painted field (a fitted model's), B=2", args, thresh, None, {}))
    # a partial last tile of a row (W % 32 != 0: byte stores) and a partial band
    cases.append(("W=40 H=10", mask_inputs(rng, 2, h=10, w=40, k=20), 0.3, None, {}))
    cases.append(("W=8 H=3", mask_inputs(rng, 1, h=3, w=8, k=5), 0.3, None, {}))
    return cases


def check_masks():
    from orienmask_tpu_torch.ops.masks import assemble_masks_packed, assemble_masks_packed_plain

    rng = np.random.default_rng(SEED + 1)
    max_err = 0
    for name, args, thresh, valid, kw in mask_cases(rng):
        got = assemble_masks_packed(*args, thresh, valid=valid, **kw)
        want = assemble_masks_packed_plain(*args, thresh, valid=valid, **kw)
        torch.cuda.synchronize()
        max_err = max(max_err, (got.int() - want.int()).abs().max().item())
        if not torch.equal(got, want):
            n = (got != want).sum().item()
            raise AssertionError(f"assemble_masks_packed '{name}': {n} bytes differ")
        counts = tile_counts(args, thresh, valid, **kw)
        log(f"  assemble_masks_packed {name:50s} field {tuple(args[0].shape)} "
            f"K={args[1].shape[1]}: identical ({(got != 0).float().mean().item():.4f} of bytes "
            f"nonzero; tiles {counts})")
        if name.startswith("random") and (not got.any() or got[:, -10:].any()):
            raise AssertionError("assemble_masks_packed: masks empty, or a padded box has pixels")
        if name == "boxes covering the image" and not counts["all_in"]:
            raise AssertionError("no all-in tile under boxes covering the image")
    # a row block of the image: coord_h = full height, row0 = first row
    field, boxes, anchor_idx, table = mask_inputs(rng, 1)
    whole = assemble_masks_packed(field, boxes, anchor_idx, table, 0.3)
    r0, rows = 136, 136
    block = field[:, :, :, r0:r0 + rows].contiguous()
    got = assemble_masks_packed(block, boxes, anchor_idx, table, 0.3, coord_h=544, row0=r0)
    want = assemble_masks_packed_plain(block, boxes, anchor_idx, table, 0.3,
                                       coord_h=544, row0=r0)
    max_err = max(max_err, (got.int() - want.int()).abs().max().item())
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

def build_pipeline(name="orienmask_yolo_coco_544_anchor4_fpn_plus_infer"):
    """The named infer config's pipeline on the card, seeded random weights."""
    import orienmask_tpu_torch.config as configs
    from orienmask_tpu_torch.data import FastCOCOTransform
    from orienmask_tpu_torch.models import build_model, init_random
    from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
    from orienmask_tpu_torch.pipeline import InferencePipeline

    cfg = getattr(configs, name)
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

        def _assemble_masks(self, field, boxes, anchor_idx, valid, coord_h=None, row0=0):
            return assemble_masks_packed_plain(field, boxes, anchor_idx, self.norm_anchors,
                                               self.orien_thresh, coord_h=coord_h, row0=row0,
                                               valid=valid)

    return Plain(**pp_kw, pack_masks=True, device="cuda")


def check_outputs(out, b, size=544):
    want = {"bbox": ((b, 100, 5), torch.float32), "cls": ((b, 100), torch.int32),
            "mask": ((b, 100, size, size // 8), torch.uint8), "valid": ((b, 100), torch.bool)}
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


def mask_tensor_ops(pipe, image):
    """The operators of one frame that take or give a tensor of the packed
    masks' shape: kernel 2's custom operator ``omt::assemble_masks_packed``
    gives them (its allocation and launch inside it are none of them)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    pp = pipe.postprocess
    shape = (image.shape[0], pp.nms_post, pp.image_h, pp.image_w // 8)
    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(isinstance(t, torch.Tensor) and tuple(t.shape) == shape
                   for t in tree_flatten((args, kwargs, out))[0]):
                ops.append(str(func))
            return out

    with Record():
        pipe.run_device(image)
    torch.cuda.synchronize()
    return ops


def check_main_path(pipe, pp_kw, image):
    requests = 4
    counts, results, pad_info, out = run_main_path(pipe, image, requests)
    log(f"  {requests} requests, launches: {counts}")
    if counts["exact_topk"] != 2 * requests or counts["assemble_masks_packed"] != requests:
        raise AssertionError(f"expected {2 * requests} top-k and {requests} mask launches, "
                             f"got {counts}")
    # kernel 2 writes the masks whole, invalid rows included: no operator
    # touches them after the custom operator gives them (no masks *= valid)
    ops = mask_tensor_ops(pipe, image)
    if ops != ["omt.assemble_masks_packed.default"]:
        raise AssertionError(f"operators on the masks besides kernel 2's: {ops}")
    log(f"  operators on the masks' tensor in one frame: {ops} (kernel 2 writes them whole)")
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


def topk_work(b, p, k):
    """(bytes, operations) that an exact top-k of (b, p) rows needs, however
    it is implemented: each row read once, the values and int64 indices
    written once, and a radix select's compare per key in each of its three
    passes."""
    return b * (p * 4 + k * (4 + 8)), 3 * b * p


def topk_by_cluster(x, k, sizes):
    """Kernel 1 on the rows ``x`` at each cluster size C of ``sizes`` that
    holds them, through the C entry point (not counted as launches)."""
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.ops.topk import KEYS_PER_CTA

    b, p = x.shape
    v = torch.empty((b, k), device="cuda")
    i = torch.empty((b, k), dtype=torch.int64, device="cuda")
    out = []
    for c in sizes:
        if -(-p // c) <= KEYS_PER_CTA:
            out.append((c, time_ms(lambda: kernels.launch(
                "topk", "omt_exact_topk", x.data_ptr(), v.data_ptr(), i.data_ptr(),
                b, p, k, c))))
    return out


def time_kernels(pipe, image):
    from orienmask_tpu_torch.ops.masks import assemble_masks_packed_plain

    pp = pipe.postprocess
    calls = main_path_inputs(pipe, image)

    res = {"exact_topk": {}, "assemble_masks_packed": {}}
    rows = [check_topk_call("main path", x, k) for x, k in calls["topk"]]
    res["exact_topk"].update({key: sum(r[key] for r in rows)
                              for key in ("ms", "plain_ms", "library_ms")})
    works = [topk_work(*x.shape, k) for x, k in calls["topk"]]
    res["exact_topk"]["bound_ms"], res["exact_topk"]["bound_by"] = bound(
        sum(w[0] for w in works), sum(w[1] for w in works))
    log("  exact_topk by cluster size C, the same rows: " + "; ".join(
        f"P={x.shape[1]}: " + ", ".join(f"C={c} {ms:.4f} ms" for c, ms in
                                          topk_by_cluster(x, k, (4, 8, 16)))
        for x, k in calls["topk"]))
    res["exact_topk"]["batch_rows"] = time_batch_rows()

    field, boxes, anchor_idx, valid = calls["masks"][0]
    main_args = (field, boxes, anchor_idx, pp.norm_anchors)
    spread = mask_inputs(np.random.default_rng(SEED + 2), 1)
    spread[2] = torch.arange(100, device="cuda", dtype=torch.int32).remainder(9)[None]
    few = torch.zeros_like(valid)
    few[0, torch.from_numpy(np.random.default_rng(SEED + 7).choice(100, 7, False)).cuda()] = True
    cases = {
        "a": ("the main path's inputs", main_args, pp.orien_thresh, valid),
        "b": ("the same shapes, detections on all 9 anchors", tuple(spread), 0.3, None),
        "c": ("(a) with 7 of 100 detections valid", main_args, pp.orien_thresh, few),
        "e": ("the field painted for 8 instances, a fitted model's",
              *painted_inputs(np.random.default_rng(SEED + 8), 1), None),
    }
    res["assemble_masks_packed"]["cases"] = {
        key: time_mask_case(f"({key}) {name}", *case) for key, (name, *case) in cases.items()}
    a = res["assemble_masks_packed"]["cases"]["a"]
    tp = time_ms(lambda: assemble_masks_packed_plain(*main_args, pp.orien_thresh, valid=valid))
    log(f"  assemble_masks_packed (a): plain {tp:.4f} ms")
    res["assemble_masks_packed"].update(ms=a["ms"], plain_ms=tp, library_ms=None,
                                        bound_ms=a["bound_ms"], bound_by=a["bound_by"])
    return res


def time_batch_rows(k=400):
    """Kernel 1 on batch inference's detect-stage rows (B = 22 and 40 rows
    of 18,207 keys: clusters of 6 and 3 CTAs) beside its plain version and
    torch.topk."""
    rng = np.random.default_rng(SEED + 11)
    return {b: check_topk_call("batch rows", torch.from_numpy(
        rng.standard_normal((b, 18207)).astype(np.float32)).cuda(), k) for b in (22, 40)}


def mask_work(field, boxes, anchor_idx, valid=None):
    """(bytes, operations, unculled) that kernel 2's call needs however it
    is built: the field planes of the anchors that hold a valid detection,
    the boxes, indices, anchor table and validity row read once and the
    masks written once; 4 operations (2 multiplies, 2 adds) per used anchor
    and pixel for the sample positions.  ``unculled``: the predicate at
    every detection and pixel, 6 instructions each in SASS (2 subtracts, 2
    compares with the abs as an operand modifier, the bit's select and or),
    the work of a kernel that culls nothing."""
    b, a, _, h, w = field.shape
    k = boxes.shape[1]
    keep = (anchor_idx >= 0) & (anchor_idx < a)
    if valid is not None:
        keep = keep & valid
    used = sum(len(set(row[m].tolist())) for row, m in zip(anchor_idx, keep))
    n_bytes = (used * 2 * h * w * 4 + boxes.numel() * 4 + anchor_idx.numel() * 4 + a * 8
               + (valid.numel() if valid is not None else 0) + b * k * h * (w // 8))
    return n_bytes, 4 * used * h * w, 6 * b * k * h * w


def time_mask_case(name, args, thresh, valid):
    """Kernel 2 on one case: its time, the bound of what the call needs,
    the unculled count and the tile classes."""
    from orienmask_tpu_torch.ops.masks import assemble_masks_packed

    t = time_ms(lambda: assemble_masks_packed(*args, thresh, valid=valid))
    n_bytes, n_ops, unculled = mask_work(args[0], args[1], args[2], valid)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    tiles = tile_counts(args, thresh, valid)
    log(f"  assemble_masks_packed {name}, field {tuple(args[0].shape)} K={args[1].shape[1]}: "
        f"kernel {t:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.2f} MB, "
        f"{n_ops / 1e6:.2f} M ops; unculled {unculled / 1e6:.1f} M instructions, "
        f"{unculled / SCALAR_OPS_PER_S * 1e3:.4f} ms); tiles {tiles}")
    return dict(ms=t, bound_ms=bound_ms, bound_by=bound_by, unculled_ms=unculled
                / SCALAR_OPS_PER_S * 1e3, tiles=tiles)


def e2e_fps(pipe, image, windows=5, frames=200):
    """bench.py's method: 10 warm-ups, then ``windows`` windows of
    ``frames`` frames with outputs left on the card and one synchronize per
    window; the median."""
    for _ in range(10):
        pipe.run_device(image)
    torch.cuda.synchronize()
    rates = []
    for _ in range(windows):
        start = time.perf_counter()
        for _ in range(frames):
            pipe.run_device(image)
        torch.cuda.synchronize()
        rates.append(frames / (time.perf_counter() - start))
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


def painted_per_detection_inputs(rng, b, k=100, device="cuda"):
    """``painted_inputs`` for kernels 3 and 4: each detection's anchor size
    is its anchor's row of the table jittered by up to 5%.  Returns
    ([field, boxes, anchor_wh, anchor_idx], orien_thresh, table)."""
    (field, boxes, anchor_idx, table), thresh = painted_inputs(rng, b, k=k, device=device)
    jitter = torch.from_numpy(1 + rng.uniform(-0.05, 0.05, (b, k, 2)).astype(np.float32))
    anchor_wh = (table[anchor_idx.long()] * jitter.to(device)).contiguous()
    return [field, boxes, anchor_wh, anchor_idx], thresh, table


def per_detection_cases(rng):
    """(name, (field, boxes, anchor_wh, anchor_idx), orien_thresh, coord_h)."""
    cases = [("B=2 A=9 K=100 544x544", per_detection_inputs(rng, 2), 0.3, None)]
    args = per_detection_inputs(rng, 1, k=1)
    cases.append(("K=1", args, 0.3, None))
    args = per_detection_inputs(rng, 2, k=40)
    args[3].fill_(4)
    cases.append(("all detections on anchor 4", args, 0.3, None))
    args = per_detection_inputs(rng, 1, h=136)
    cases.append(("rows 0..135 with coord_h=544", args, 0.3, 544))
    args = per_detection_inputs(rng, 2, h=16, w=8, k=7)
    cases.append(("W=8 H=16", args, 0.3, None))
    args = per_detection_inputs(rng, 1, k=6)
    args[1][:] = torch.tensor([0.5, 0.5, 2.0, 2.0])  # covers the image
    args[3][0, 1], args[3][0, 2] = 9, -1  # off the table: empty masks
    cases.append(("anchors off the table", args, 0.3, None))
    args, thresh, _ = painted_per_detection_inputs(rng, 2)
    cases.append(("painted field, sizes within 5% of the rows", args, thresh, None))
    # half sizes of zero, -0.0, negative, NaN, +-inf and subnormal, on
    # either axis, with some boxes over the whole image
    args = per_detection_inputs(rng, 1, k=64)
    wh = args[2][0]
    specials = torch.tensor([0.0, -0.0, -0.3, float("nan"), float("inf"), float("-inf"), 1e-40,
                             -0.05], device="cuda")
    wh[:8, 0], wh[8:16, 1], wh[16:24] = specials, specials, specials[:, None]
    args[1][0, ::3] = torch.tensor([0.5, 0.5, 4.0, 4.0], device="cuda")
    cases.append(("sizes zero, negative, NaN, inf, subnormal", args, 0.3, None))
    # NaN and +-inf in the field of every anchor, under small and covering boxes
    args = per_detection_inputs(rng, 1)
    f = args[0].view(-1)
    spots = torch.from_numpy(rng.choice(f.numel(), 30000, replace=False)).cuda()
    f[spots] = torch.tensor([np.nan, np.inf, -np.inf], device=f.device).repeat(10000)
    args[1][0, :20] = torch.tensor([0.5, 0.5, 4.0, 4.0], device="cuda")
    cases.append(("NaN and +-inf in the field", args, 0.3, None))
    # a zero field: g is the pixel's own coordinate; with t = 1 each box's
    # edges sit exactly on column (row) coordinates: ties
    h = w = 544
    k = 100
    cols = np.arange(w, dtype=np.float32) * np.float32(1.0 / w)
    i, j = rng.integers(0, w, (2, 1, k))
    boxes = np.stack([cols[i], cols[j], np.abs(cols[rng.integers(0, w, (1, k))] - cols[i]),
                      np.abs(cols[rng.integers(0, w, (1, k))] - cols[j])], -1)
    cases.append(("zero field, box edges on pixel coordinates (ties)", [
        torch.from_numpy(np.ascontiguousarray(t)).cuda() for t in (
            np.zeros((1, 3, 2, h, w), np.float32), boxes.astype(np.float32),
            rng.uniform(0.02, 0.7, (1, k, 2)).astype(np.float32),
            rng.integers(0, 3, (1, k)).astype(np.int32))], 1.0, None))
    # past one block's detections (1,024): two and three chunks
    for k in (2048, 2100):
        cases.append((f"K={k}, rows 0..135 with coord_h=544",
                      per_detection_inputs(rng, 1, h=136, k=k), 0.3, 544))
    # more anchors than one warp's scan takes, and so many that the block's
    # shared memory passes 48 KiB
    cases.append(("A=40", per_detection_inputs(rng, 1, a=40, h=136), 0.3, None))
    cases.append(("A=10,000 K=1,024 H=W=8", per_detection_inputs(rng, 1, a=10000, h=8, w=8,
                                                                 k=1024), 0.3, None))
    return cases


def per_detection_tiles(args, thresh, coord_h=None):
    """Kernels 3 and 4's (detection, tile) classes for one call, counted
    with the plain mirror of their rule."""
    from orienmask_tpu_torch.ops import masks

    return class_counts(masks.tile_classes_per_detection(*args, thresh, coord_h=coord_h))


def run_validation_path(cases):
    """The validation path of kernels 3 and 4 (``validate_tpu.py:120-161``'s
    role): each case through both wrappers; the launch counts of that run
    alone and the outputs."""
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.ops.masks import assemble_masks, assemble_masks_bitpacked

    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = [(assemble_masks(*args, thresh, coord_h=coord_h),
             assemble_masks_bitpacked(*args, thresh, coord_h=coord_h))
            for _, args, thresh, coord_h in cases]
    torch.cuda.synchronize()
    return dict(kernels.launches), outs


def check_table_sizes(name, field, boxes, anchor_idx, table, thresh):
    """On sizes that are rows of a per-anchor table: pack_bits(kernel 3) ==
    kernel 4 == kernel 2."""
    from orienmask_tpu_torch.ops.maskops import pack_bits
    from orienmask_tpu_torch.ops.masks import (
        assemble_masks,
        assemble_masks_bitpacked,
        assemble_masks_packed,
    )

    anchor_wh = table[anchor_idx.long()].contiguous()
    k3 = pack_bits(assemble_masks(field, boxes, anchor_wh, anchor_idx, thresh).bool())
    k4 = assemble_masks_bitpacked(field, boxes, anchor_wh, anchor_idx, thresh)
    k2 = assemble_masks_packed(field, boxes, anchor_idx, table, thresh)
    if not (torch.equal(k3, k4) and torch.equal(k4, k2)):
        raise AssertionError(f"table sizes, {name}: pack_bits(kernel 3), kernel 4 and kernel 2 "
                             "differ")
    log(f"  table sizes, {name}: pack_bits(kernel 3) == kernel 4 == kernel 2")


def check_per_detection():
    """Phase 9: kernels 3 and 4 against their plain versions, bit for bit,
    and against kernel 2 on table sizes."""
    from orienmask_tpu_torch.ops.maskops import pack_bits
    from orienmask_tpu_torch.ops.masks import (
        assemble_masks_bitpacked_plain,
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
    for (name, args, thresh, coord_h), (got, got_packed) in zip(cases, outs):
        want = assemble_masks_plain(*args, thresh, coord_h=coord_h)
        if not torch.equal(got, want):
            raise AssertionError(f"assemble_masks '{name}': {(got != want).sum().item()} "
                                 "pixels differ from the plain version")
        max_err = max(max_err, (got.int() - want.int()).abs().max().item())
        del want  # K = 2,100's plain versions hold several GB: one at a time
        want_packed = assemble_masks_bitpacked_plain(*args, thresh, coord_h=coord_h)
        if not torch.equal(got_packed, want_packed):
            raise AssertionError(f"assemble_masks_bitpacked '{name}': "
                                 f"{(got_packed != want_packed).sum().item()} bytes differ")
        if not torch.equal(pack_bits(got.bool()), got_packed):
            raise AssertionError(f"'{name}': pack_bits(kernel 3) != kernel 4")
        max_err = max(max_err, (got_packed.int() - want_packed.int()).abs().max().item())
        log(f"  assemble_masks, assemble_masks_bitpacked {name:50s} field "
            f"{tuple(args[0].shape)} K={args[1].shape[1]}: identical "
            f"({got.float().mean().item():.4f} of pixels set; tiles "
            f"{per_detection_tiles(args, thresh, coord_h)})")
    got = outs[0][0]
    if not got[0, :95].any() or got[:, -5:].any():
        raise AssertionError("kernel 3: masks empty, or a zero-sized box has pixels")
    off = outs[5][0]
    if off[0, 1:3].any() or not off[0, 0].any():
        raise AssertionError("kernel 3: a detection off the table has pixels")
    del outs

    # per-detection sizes that are rows of a per-anchor table: kernel 2 applies
    field, boxes, _, anchor_idx = per_detection_inputs(rng, 2)
    table = torch.from_numpy(rng.uniform(0.02, 0.5, (9, 2)).astype(np.float32)).cuda()
    check_table_sizes("B=2 K=100 544x544", field, boxes, anchor_idx, table, 0.3)
    (field, boxes, _, anchor_idx), thresh, table = painted_per_detection_inputs(rng, 2)
    check_table_sizes("painted field, B=2 K=100", field, boxes, anchor_idx, table, thresh)
    painted, thresh, _ = painted_per_detection_inputs(np.random.default_rng(SEED + 9), 2)
    return counts, float(max_err), {"main": (cases[0][1], 0.3), "painted": (painted, thresh)}


# Kernels 3 and 4 before the tiled design, as a per-detection grid (one
# block per image, detection and run of pixels; probe/designs/unculled.cu),
# on the main case, as this script measured them then (NVIDIA H100 80GB
# HBM3, 700.00 W).  probe/perdet.py times both designs in one call.
GRID_US = {"assemble_masks": 107.5, "assemble_masks_bitpacked": 75.2}


def per_detection_work(args, thresh, packed):
    """(bytes, operations, unculled) that a call of kernel 3 or 4 needs:
    the field planes of the anchors each image's detections use, the boxes,
    sizes and indices read once and the masks written once; per used anchor
    and pixel 4 operations for the field's tile bounds (2 min, 2 max); per
    classed (tile, detection) pair 16 for its position bounds and class
    (4 multiplies, 4 adds, 4 subtracts, 4 compares); per pixel of a mixed
    pair 10 (2 multiplies, 2 adds, 2 subtracts, 2 compares, a select and an
    or), counted by ``tile_classes_per_detection``.  ``unculled``: 10 per
    detection and pixel, the predicate everywhere, as the TPU kernels and
    the per-detection grid evaluate it."""
    from orienmask_tpu_torch.ops.masks import TILE_W

    field, boxes, anchor_wh, anchor_idx = args
    b, a, _, h, w = field.shape
    k = boxes.shape[1]
    on = (anchor_idx >= 0) & (anchor_idx < a)
    used = sum(len(set(row[m].tolist())) for row, m in zip(anchor_idx, on))
    out_bytes = b * k * h * w // (8 if packed else 1)
    n_bytes = used * 2 * h * w * 4 + b * k * (16 + 8 + 4) + out_bytes
    tiles = per_detection_tiles(args, thresh)
    classed = tiles["all_out"] + tiles["all_in"] + tiles["mixed"]
    n_ops = 4 * used * h * w + 16 * classed + 10 * TILE_W * tiles["mixed"]
    return n_bytes, n_ops, 10 * b * k * h * w, tiles


def time_per_detection(cases):
    """Kernels 3 and 4 per launch on the validation path's main case and on
    the painted field, beside their plain versions, the recounted bounds,
    the unculled counts and the per-detection grid's times."""
    from orienmask_tpu_torch.ops.masks import (
        assemble_masks,
        assemble_masks_bitpacked,
        assemble_masks_bitpacked_plain,
        assemble_masks_plain,
    )

    res = {}
    for name, fn, plain, packed in (
            ("assemble_masks", assemble_masks, assemble_masks_plain, False),
            ("assemble_masks_bitpacked", assemble_masks_bitpacked,
             assemble_masks_bitpacked_plain, True)):
        per_case = {}
        for case, (args, thresh) in cases.items():
            t = time_ms(lambda: fn(*args, thresh))
            tp = time_ms(lambda: plain(*args, thresh))
            n_bytes, n_ops, unculled, tiles = per_detection_work(args, thresh, packed)
            bound_ms, bound_by = bound(n_bytes, n_ops)
            log(f"  {name} ({case}) field {tuple(args[0].shape)} K={args[1].shape[1]}: kernel "
                f"{t:.4f} ms, plain {tp:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e6:.1f} M ops; unculled "
                f"{unculled / 1e6:.0f} M instructions, "
                f"{unculled / SCALAR_OPS_PER_S * 1e3:.4f} ms); tiles {tiles}"
                + (f"; per-detection grid {GRID_US[name] / 1e3:.4f} ms"
                   if case == "main" else ""))
            per_case[case] = dict(ms=t, plain_ms=tp, bound_ms=bound_ms, bound_by=bound_by,
                                  tiles=tiles)
        main = per_case["main"]
        res[name] = dict(ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                         bound_by=main["bound_by"], library_ms=None, cases=per_case)
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
            or counts["recover_masks"] != n_batches or sum(counts.values()) != 4 * n_batches:
        raise AssertionError(f"expected {2 * n_batches} top-k, {n_batches} mask and "
                             f"{n_batches} recovery launches and nothing else, got {counts}")
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

    # the same heads through the plain-version postprocess, then the host
    # route of the COCO conversion (Tester's on the CPU) on its outputs
    plain = plain_postprocess(ev.pp_kw)
    host_dir = ev.workdir / "host_route"
    host_dir.mkdir(exist_ok=True)
    metrics = COCOMetrics(str(ev.gt_file), ev.loader.dataset.CAT2LABEL, True, str(host_dir))
    t = time.perf_counter()
    for (heads, got), batch in zip(calls, ev.loader):
        want = plain.apply_device(heads)
        torch.cuda.synchronize()
        compare_postprocess("batch", got, want)
        metrics.update_results(metrics.to_coco_format(batch["info"], plain.to_host_list(want)))
    host_s = time.perf_counter() - t
    metrics.coco_eval()
    for key, got, want in (("bbox", bbox, metrics.bbox_eval_stats),
                           ("segm", segm, metrics.segm_eval_stats)):
        if not np.array_equal(got, np.asarray(want)):
            raise AssertionError(f"eval path: {key} stats differ with the plain versions")
    for kind in ("bbox", "segm"):
        card = (ev.workdir / f"{kind}_prediction.json").read_text()
        if card != (host_dir / f"{kind}_prediction.json").read_text():
            raise AssertionError(f"eval path: the card route's {kind} JSON differs from the "
                                 "host route's")
    log(f"  postprocess with the plain versions on the same heads: identical outputs in all "
        f"{n_batches} batches; the host route of the COCO conversion on them ({host_s:.2f} s): "
        f"identical bbox and segm JSON files ({len(m.segm_results)} RLE strings) and stats")

    heads = spread_heads(ev)
    got, want = pp.apply_device(heads), plain.apply_device(heads)
    torch.cuda.synchronize()
    check_outputs(got, ev.loader.batch_size)
    compare_postprocess("spread batch", got, want)
    info = next(iter(ev.loader))["info"]
    card = tester.coco_metrics.to_coco_format_device(info, got, pp.image_w)
    if json.dumps(card) != json.dumps(tester.coco_metrics.to_coco_format(
            info, pp.to_host_list(got))):
        raise AssertionError("spread batch: the card route's COCO dicts differ from the host "
                             "route's")
    scores = got["bbox"][..., 4][got["valid"]]
    log(f"  spread head logits, one batch of {ev.loader.batch_size}: identical outputs and "
        f"identical COCO dicts by both routes ({len(card['segm'])} masks); "
        f"{int(got['valid'].sum())} valid detections, {scores.unique().numel()} distinct "
        f"scores in {scores.min().item():.4f}..{scores.max().item():.4f}, "
        f"{got['cls'][got['valid']].unique().numel()} classes")
    return counts


def eval_kernel_inputs(ev):
    """What one eval batch hands kernels 1 and 2: (the (B, P) rows of the
    exact selection's first top-k, k) and the mask wrapper's arguments."""
    pp = ev.tester.postprocess
    rows, masks = [], []

    def topk(x, k):
        rows.append((x.clone(), k))
        return type(pp)._topk(pp, x, k)

    def assemble(*args):
        masks.append(tuple(a.clone() for a in args))
        return type(pp)._assemble_masks(pp, *args)

    pp._topk, pp._assemble_masks = topk, assemble
    try:
        batch = next(iter(ev.loader))
        pp.apply_device(ev.tester.forward(torch.as_tensor(batch["image"]).cuda()))
    finally:
        del pp._topk, pp._assemble_masks
    return rows[0], masks[0]


def time_eval(ev):
    """Phase 11 (the eval path): the exact selection's two-level kernel 1
    beside torch.topk and a stable sort; the Tester's stages."""
    from orienmask_tpu_torch.ops.topk import exact_topk, exact_topk_plain, launch_plan, split_chunk
    from orienmask_tpu_torch.utils import timer

    (x, k), (field, boxes, anchor_idx, valid) = eval_kernel_inputs(ev)
    pp = ev.tester.postprocess
    masks_d = time_mask_case("(d) the eval path's batch", (field, boxes, anchor_idx,
                                                           pp.norm_anchors),
                             pp.orien_thresh, valid)
    b, p = x.shape
    t = time_ms(lambda: exact_topk(x, k))
    t_lib = time_ms(lambda: torch.topk(x, k))
    t_sort = time_ms(lambda: exact_topk_plain(x, k))
    chunk = split_chunk(p)
    n = -(-p // chunk)
    n_bytes, n_ops = topk_work(b, p, k)
    bound_ms, bound_by = bound(n_bytes, n_ops)
    log(f"  exact selection (B={b}, P={p}, k={k}; two launches of kernel 1, (C, chunk) "
        f"{launch_plan(b, p)}, then {launch_plan(b * n, chunk)} and {launch_plan(b, n * k)}): "
        f"kernel {t:.4f} ms, "
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
    return selection, masks_d, {"ms_per_image": stages, "images_per_s": ips, "loop_s": med["loop"],
                       "passes": passes, "coco_eval_s": med["coco_eval"]}


# ---------------------------------------------------- CLI, stream, batches

CLI_IMAGES = 8
STREAM_FRAMES = 24
# frames an e2e window where phases 20 and 21 compare two pipelines
COMPARE_FRAMES = 100
# frames a streamed-FPS window (at 200, two depths of 5 windows took about
# 120 s of the script's time limit)
STREAM_WINDOW_FRAMES = 80
BATCHES = (8, 16)


def record_run_batch(fn):
    """Run ``fn()`` with ``OrienMaskYOLOPostProcess._run_batch``,
    ``StreamingPipeline.retrieve`` and ``COCOMetrics.to_coco_format_device``
    wrapped to keep each call's head tensors and device outputs, each
    retrieved host list and each COCO conversion; returns (fn's result,
    [(postprocess, heads, outputs)], [host lists], launch counts of the run
    alone, [(metrics, batch info, device outputs, image_w, COCO dicts)])."""
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.eval import COCOMetrics
    from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
    from orienmask_tpu_torch.stream import StreamingPipeline

    run_batch, retrieve = OrienMaskYOLOPostProcess._run_batch, StreamingPipeline.retrieve
    convert = COCOMetrics.to_coco_format_device
    calls, retrieved, converted = [], [], []

    def recording_run_batch(pp, predict):
        out = run_batch(pp, predict)
        calls.append((pp, tuple((b.clone(), o.clone()) for b, o in predict),
                      {k: v.clone() for k, v in out.items()}))
        return out

    def recording_retrieve(stream):
        retrieved.append(retrieve(stream))
        return retrieved[-1]

    def recording_convert(metrics, batch_info, device_out, image_w):
        out = convert(metrics, batch_info, device_out, image_w)
        converted.append((metrics, copy.deepcopy(batch_info),
                          {k: v.clone() for k, v in device_out.items()}, image_w, out))
        return out

    torch.cuda.synchronize()
    kernels.reset_launches()
    with mock.patch.object(OrienMaskYOLOPostProcess, "_run_batch", recording_run_batch), \
            mock.patch.object(StreamingPipeline, "retrieve", recording_retrieve), \
            mock.patch.object(COCOMetrics, "to_coco_format_device", recording_convert):
        result = fn()
    torch.cuda.synchronize()
    return result, calls, retrieved, dict(kernels.launches), converted


def run_cli(argv):
    """``infer.main(argv)`` in this process, its report captured; (report
    lines, recorded calls, retrieved host lists, launch counts, recorded COCO
    conversions)."""
    from orienmask_tpu_torch import infer

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc, calls, retrieved, counts, converted = record_run_batch(lambda: infer.main(argv))
    if rc != 0:
        raise AssertionError(f"infer.main({argv}) returned {rc}")
    return text.getvalue().splitlines(), calls, retrieved, counts, converted


def check_json_routes(name, out, converted, plain):
    """The CLI's -j: each image's card-route COCO dicts (kernel 6, then the
    column-packed encoder) against the host route on the same device outputs
    (``to_host_list``, the numpy resize, the RLE of uint8 masks): identical
    JSON; the dumped files hold exactly the host route's dicts.  Returns the
    host route's seconds."""
    t = time.perf_counter()
    host = {"bbox": [], "segm": []}
    for metrics, info, device_out, image_w, card in converted:
        want = metrics.to_coco_format(info, plain.to_host_list(device_out))
        if json.dumps(card) != json.dumps(want):
            raise AssertionError(f"{name}: image {info[0]['id']}'s card-route COCO dicts differ "
                                 "from the host route's")
        for kind in host:
            host[kind] += want[kind]
    for kind in host:
        if (out / f"{kind}_prediction.json").read_text() != json.dumps(host[kind]):
            raise AssertionError(f"{name}: the dumped {kind} JSON differs from the host route's")
    return time.perf_counter() - t


def check_against_plain(name, calls, pp_kw, size):
    """Each recorded call's outputs against the plain-version postprocess of
    ``pp_kw`` on the same heads: identical device outputs.  Returns the
    plain postprocess and its outputs."""
    plain = plain_postprocess(pp_kw)
    wants = []
    for _, heads, got in calls:
        want = plain._run_batch(heads)
        torch.cuda.synchronize()
        check_outputs(got, heads[0][0].shape[0], size)
        for key in got:
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"{name}: '{key}' differs from the plain-version "
                                     "postprocess on the same heads")
        wants.append(want)
    return plain, wants


def write_cli_inputs(workdir, n=CLI_IMAGES):
    """``n`` (eight) seeded 480x640 PNGs and their COCO images json."""
    from orienmask_tpu_torch.data.image_io import write_png

    images = workdir / "images"
    images.mkdir()
    rng = np.random.default_rng(SEED + 12)
    entries = []
    for i in range(n):
        write_png(images / f"{i:012d}.png", rng.integers(0, 256, (480, 640, 3), np.uint8))
        entries.append({"file_name": f"{i:012d}.png", "height": 480, "width": 640, "id": i + 1})
    (workdir / "images.json").write_text(json.dumps({"images": entries}))
    return images, workdir / "images.json"


def check_cli(workdir):
    """Phase 12: the port's infer CLI over eight PNGs with -j -o, for the
    published model and the base model."""
    import orienmask_tpu_torch.config as configs

    images, images_json = write_cli_inputs(workdir)
    counts = {}
    for name in ("orienmask_yolo_coco_544_anchor4_fpn_plus_infer",
                 "orienmask_yolo_coco_544_anchor4_infer"):
        out = workdir / name
        t = time.perf_counter()
        lines, calls, _, launched, converted = run_cli(
            ["-c", name, "--random-weights", "-d", str(images), "-j", str(images_json),
             "-o", str(out)])
        log(f"  {name}: {len(calls)} images in {time.perf_counter() - t:.2f} s (model build "
            f"included), launches: {launched}")
        log("  report: " + "; ".join(lines))
        if len(calls) != CLI_IMAGES or launched["exact_topk"] != 2 * CLI_IMAGES \
                or launched["assemble_masks_packed"] != CLI_IMAGES \
                or launched["recover_masks"] != CLI_IMAGES or len(converted) != CLI_IMAGES:
            raise AssertionError(f"{name}: expected {CLI_IMAGES} images, kernel 1 twice and "
                                 f"kernels 2 and 6 once an image; got {len(calls)}, {launched}")
        plain, _ = check_against_plain(name, calls, _kw(getattr(configs, name)["postprocess"]),
                                       544)
        n_valid = sum(int(c[2]["valid"].sum()) for c in calls)
        for kind in ("bbox", "segm"):
            dumped = json.loads((out / f"{kind}_prediction.json").read_text())
            if len(dumped) != n_valid or {d["image_id"] for d in dumped} != \
                    set(range(1, CLI_IMAGES + 1)):
                raise AssertionError(f"{name}: {kind} json holds {len(dumped)} entries for "
                                     f"{n_valid} valid detections")
        host_s = check_json_routes(name, out, converted, plain)
        log(f"  {name}: every image identical to the plain-version postprocess on its heads; "
            f"bbox and segm json hold {n_valid} entries each, identical to the host route's "
            f"on the same device outputs ({host_s:.2f} s)")
        for key, value in launched.items():
            counts[key] = counts.get(key, 0) + value
    return counts


def stream_window(stream, frames, n):
    """Submit ``n`` frames (cycling ``frames``), retrieving as the queue
    fills, then drain; (seconds, host seconds in submit, in retrieve)."""
    t_submit = t_retrieve = 0.0
    start = time.perf_counter()
    for i in range(n):
        t = time.perf_counter()
        stream.submit(frames[i % len(frames)])
        t_submit += time.perf_counter() - t
        if stream.ready():
            t = time.perf_counter()
            stream.retrieve()
            t_retrieve += time.perf_counter() - t
    t = time.perf_counter()
    for _ in stream.drain():
        pass
    t_retrieve += time.perf_counter() - t
    return time.perf_counter() - start, t_submit, t_retrieve


def stream_fps(pipe, frames, depth, n=STREAM_WINDOW_FRAMES):
    """Streamed FPS at ``depth``: frames decoded in host memory, 10
    warm-ups, 5 windows of ``n`` frames, the median window; with the host's
    ms a frame inside ``submit`` and ``retrieve`` in that window."""
    from orienmask_tpu_torch.stream import StreamingPipeline

    stream = StreamingPipeline(pipe, depth=depth)
    stream_window(stream, frames, 10)
    windows = [stream_window(stream, frames, n) for _ in range(5)]
    rates = [n / w[0] for w in windows]
    mid = windows[int(np.argsort(rates)[2])]
    return dict(fps=float(np.median(rates)), windows=rates,
                submit_ms=mid[1] / n * 1e3, retrieve_ms=mid[2] / n * 1e3)


def check_topk_call(name, x, k):
    """Kernel 1 on rows one run handed it: bit for bit against its plain
    version, timed beside it, its bound and torch.topk."""
    from orienmask_tpu_torch.ops.topk import exact_topk, exact_topk_plain, launch_plan

    b, p = x.shape
    v, i = exact_topk(x, k)
    pv, pi = exact_topk_plain(x, k)
    torch.cuda.synchronize()
    if not (torch.equal(v.view(torch.int32), pv.view(torch.int32)) and torch.equal(i, pi)):
        raise AssertionError(f"{name}: exact_topk differs from its plain version at ({b}, {p})")
    t = time_ms(lambda: exact_topk(x, k))
    tp = time_ms(lambda: exact_topk_plain(x, k))
    tl = time_ms(lambda: torch.topk(x, k))
    bound_ms, bound_by = bound(*topk_work(b, p, k))
    log(f"  {name} exact_topk B={b} P={p} k={k}, (C, chunk) {launch_plan(b, p)}: identical; "
        f"kernel {t:.4f} ms, plain {tp:.4f} ms, torch.topk {tl:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return dict(shape=[b, p], k=k, plan=list(launch_plan(b, p)), ms=t, plain_ms=tp,
                library_ms=tl, bound_ms=bound_ms, bound_by=bound_by)


def check_mask_call(name, args, thresh, valid):
    """Kernel 2 on the arguments one run handed it: bit for bit against its
    plain version, timed beside it and its bound."""
    from orienmask_tpu_torch.ops.masks import assemble_masks_packed, assemble_masks_packed_plain

    got = assemble_masks_packed(*args, thresh, valid=valid)
    want = assemble_masks_packed_plain(*args, thresh, valid=valid)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: assemble_masks_packed differs from its plain version")
    res = time_mask_case(f"{name} (identical)", args, thresh, valid)
    res["plain_ms"] = time_ms(lambda: assemble_masks_packed_plain(*args, thresh, valid=valid))
    log(f"  {name} assemble_masks_packed: plain {res['plain_ms']:.4f} ms")
    return res


def check_kernels_at(name, pipe, image):
    """Kernels 1 and 2 on what one call of ``pipe`` on ``image`` hands them."""
    pp = pipe.postprocess
    calls = main_path_inputs(pipe, image)
    field, boxes, anchor_idx, valid = calls["masks"][0]
    return {"exact_topk": [check_topk_call(name, x, k) for x, k in calls["topk"]],
            "assemble_masks_packed": check_mask_call(
                name, (field, boxes, anchor_idx, pp.norm_anchors), pp.orien_thresh, valid)}


def check_stream(workdir):
    """Phase 13: the CLI's --video over 24 seeded 720x1280 PNG frames with
    the 736² config at depth 2, kernels 1 and 2 at 736², streamed FPS."""
    import orienmask_tpu_torch.config as configs
    from orienmask_tpu_torch.data.image_io import read_image, write_png

    name = "orienmask_yolo_coco_736_anchor4_fpn_plus_infer"
    frames_dir = workdir / "frames"
    frames_dir.mkdir()
    rng = np.random.default_rng(SEED + 13)
    for i in range(STREAM_FRAMES):
        write_png(frames_dir / f"frame_{i:04d}.png",
                  rng.integers(0, 256, (720, 1280, 3), np.uint8))
    t = time.perf_counter()
    lines, calls, retrieved, counts, _ = run_cli(["-c", name, "--random-weights", "--video",
                                                  str(frames_dir)])
    log(f"  --video: {len(calls)} frames in {time.perf_counter() - t:.2f} s (model build "
        f"included), launches: {counts}; report: " + "; ".join(lines))
    if len(calls) != STREAM_FRAMES or len(retrieved) != STREAM_FRAMES \
            or counts["exact_topk"] != 2 * STREAM_FRAMES \
            or counts["assemble_masks_packed"] != STREAM_FRAMES:
        raise AssertionError(f"--video: expected {STREAM_FRAMES} frames, kernel 1 twice and "
                             f"kernel 2 once a frame; got {len(calls)}, {counts}")
    plain, wants = check_against_plain("--video", calls,
                                       _kw(getattr(configs, name)["postprocess"]), 736)
    for want, host in zip(wants, retrieved):
        for got_r, want_r in zip(host, plain.to_host_list(want)):
            for key in want_r:
                if not np.array_equal(got_r[key], want_r[key]):
                    raise AssertionError(f"--video: the streamed host '{key}' differs from "
                                         "the plain version's")
    log(f"  --video: every streamed frame identical to the plain-version postprocess on its "
        f"heads, device outputs and host lists ({sum(len(h[0]['bbox']) for h in retrieved)} "
        "detections)")

    pipe, _ = build_pipeline(name)
    frames = [read_image(p)[None] for p in sorted(frames_dir.iterdir())]
    times = check_kernels_at("736x736", pipe, torch.from_numpy(frames[0]).cuda())
    fps = {f"depth{d}": stream_fps(pipe, frames, d) for d in (1, 2)}
    staged, _ = e2e_fps(pipe, torch.from_numpy(frames[0]).cuda())
    for key, r in fps.items():
        log(f"  streamed 736x736 {key}: {r['fps']:.2f} FPS (median; windows "
            f"{', '.join(f'{w:.2f}' for w in r['windows'])}); host in submit "
            f"{r['submit_ms']:.3f} ms, in retrieve {r['retrieve_ms']:.3f} ms a frame")
    log(f"  736x736 bs1 with the frame staged on the card (bench.py's method): {staged:.2f} FPS")
    fps["staged_fps"] = staged
    return counts, times, fps


def check_batches():
    """Phase 14: batched inference at 544², B = 8 and 16: outputs against
    the plain-version postprocess, launch counts, kernels at the batch
    shapes, images/s with tools/bench_batched.py's method."""
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.ops.topk import launch_plan

    pipe, pp_kw = build_pipeline()
    plain = plain_postprocess(pp_kw)
    images = torch.from_numpy(np.random.default_rng(SEED + 14).integers(
        0, 256, (max(BATCHES), 480, 640, 3), dtype=np.uint8)).cuda()
    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = {b: pipe.run_device(images[:b]) for b in BATCHES}
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    log(f"  one call at each of B = {BATCHES}, launches: {counts}")
    if counts["exact_topk"] != 2 * len(BATCHES) \
            or counts["assemble_masks_packed"] != len(BATCHES):
        raise AssertionError(f"expected kernel 1 twice and kernel 2 once a call, got {counts}")
    times, rates = {}, {}
    for b in BATCHES:
        check_outputs(outs[b], b)
        heads = pipe.heads(images[:b])
        got, want = pipe.postprocess.apply_device(heads), plain.apply_device(heads)
        torch.cuda.synchronize()
        for key in got:
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"B={b}: '{key}' differs from the plain-version postprocess")
        log(f"  B={b}: kernels == plain versions on the same heads ({int(got['valid'].sum())} "
            f"valid detections); kernel 1's plans (C, chunk): P=18207 {launch_plan(b, 18207)}, "
            f"P=32000 {launch_plan(b, 32000)}")
        times[b] = check_kernels_at(f"B={b}", pipe, images[:b])
        rates[b] = batched_rate(pipe, images[:b])
        log(f"  B={b}: {rates[b]['images_per_s']:.2f} images/s (median; windows "
            f"{', '.join(f'{w:.2f}' for w in rates[b]['windows'])})")
    return counts, times, rates


def batched_rate(pipe, image):
    """tools/bench_batched.py's method: the batch staged on the card, 6
    warm-ups, max(1, 200 // B) calls a window with outputs left on the
    card, one synchronize a window, 5 windows; the median."""
    b = image.shape[0]
    for _ in range(6):
        pipe.run_device(image)
    torch.cuda.synchronize()
    n = max(1, 200 // b)
    rates = []
    for _ in range(5):
        start = time.perf_counter()
        for _ in range(n):
            pipe.run_device(image)
        torch.cuda.synchronize()
        rates.append(n * b / (time.perf_counter() - start))
    return dict(images_per_s=float(np.median(rates)), windows=rates, calls_per_window=n)


# ------------------------------------------------ JPEG and the visualizer

FIXTURES = Path(__file__).resolve().parent / "probe" / "jpeg_fixtures"
DECODE_REPEATS = 5


def check_jpeg_decoder():
    """Phase 15 (a): the committed JPEG fixtures through the port's reader
    (the compiled scan decoder, built here), each against the SHA-256 of
    cv2's RGB decode recorded with it; decode ms per 480x640 image."""
    import hashlib

    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.data import jpeg
    from orienmask_tpu_torch.data.image_io import read_image

    t = time.perf_counter()
    kernels.host_library("jpeg_host")  # g++, at first use
    build_s = time.perf_counter() - t
    digests = json.loads((FIXTURES / "digests.json").read_text())
    for name, want in digests.items():
        image = read_image(FIXTURES / name)
        if list(image.shape) != want["shape"] or \
                hashlib.sha256(image.tobytes()).hexdigest() != want["sha256"]:
            raise AssertionError(f"{name}: the decode differs from cv2's recorded digest")
    # round robin over the 480x640 files, each read as the CLI reads it
    sized = [n for n, want in digests.items() if want["shape"][:2] == [480, 640]]
    runs, scans = {n: [] for n in sized}, {n: [] for n in sized}
    for _ in range(DECODE_REPEATS):
        for name in sized:
            t = time.perf_counter()
            read_image(FIXTURES / name)
            runs[name].append(1e3 * (time.perf_counter() - t))
            data = (FIXTURES / name).read_bytes()
            t = time.perf_counter()
            jpeg.parse(data, jpeg.decode_scan_native)
            scans[name].append(1e3 * (time.perf_counter() - t))
    per_file = {n: float(np.median(v)) for n, v in runs.items()}
    entropy = {n: float(np.median(v)) for n, v in scans.items()}
    mean = float(np.mean(list(per_file.values())))
    log(f"  {len(digests)} fixtures decoded identically to cv2's recorded digests (decoder "
        f"built in {build_s:.2f} s); decode {mean:.2f} ms per 480x640 image (mean over "
        f"{len(per_file)} files of the median of {DECODE_REPEATS} reads; markers and scans alone "
        f"{np.mean(list(entropy.values())):.2f} ms) on the host; card: {card_line()}")
    log("  per file (ms): " + ", ".join(f"{n} {v:.2f}" for n, v in per_file.items()))
    return {"fixtures": len(digests), "identical": len(digests), "build_s": build_s,
            "decode_ms_480x640": mean, "scans_ms_480x640": float(np.mean(list(entropy.values()))),
            "per_file_ms": per_file}


def report_ms(lines):
    """The infer CLI's timer report: {stage: ms an image}."""
    import re

    out = {}
    for line in lines:
        m = re.match(r"^(.+): ([0-9.]+)ms \(", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


def check_drawings(name, out_dir, written, wants, plain, paths, config, seed):
    """Each file the CLI wrote holds the bytes ``write_image`` writes, in
    the format of its name, for the port's visualizer drawing the
    plain-version host list of the same image under the same seed."""
    import random

    from orienmask_tpu_torch.data.image_io import encode_image, read_image
    from orienmask_tpu_torch.utils.visualizer import InferenceVisualizer

    vis = InferenceVisualizer(**_kw(config["visualizer"]))
    size = config["transform"]["pipeline"][0]["size"]
    pad_info = (0, 0, 0, 0, *size)
    random.seed(seed)
    drawn = 0
    for want, path, out in zip(wants, paths, written):
        host = plain.to_host_list(want)[0]
        drawn += int((host["bbox"][:, 4] > vis.conf_thresh).sum())
        expected = vis(host, read_image(path).astype(np.float32), pad_info)
        if (out_dir / out).read_bytes() != encode_image(os.path.splitext(out)[1], expected):
            raise AssertionError(f"{name}: {out} differs from the visualizer on the "
                                 "plain-version host list")
    log(f"  {name}: {len(written)} files identical to the visualizer on the plain-version "
        f"host lists, each in its name's format ({drawn} detections above conf_thresh "
        f"{vis.conf_thresh})")
    return vis, pad_info


def check_jpeg_cli(workdir):
    """Phase 15 (b)-(d): the infer CLI over the JPEG fixtures at 544² with
    -j -o and with -v -o, then --video -o at 736²: every image identical to
    the plain-version postprocess on its heads, kernel 1 twice and kernel 2
    once an image, the JSON entry counts, each written PNG identical to the
    visualizer on the plain-version host list; a host list with spread
    scores drawn too, since random weights put nothing above conf_thresh."""
    import random

    import orienmask_tpu_torch.config as configs
    from orienmask_tpu_torch.data.image_io import image_names, read_image

    names = image_names(FIXTURES)
    paths = [FIXTURES / n for n in names]
    n = len(names)
    counts, reports = {}, {}

    def expect(tag, calls, launched, frames, converted=0):
        if len(calls) != frames or launched["exact_topk"] != 2 * frames \
                or launched["assemble_masks_packed"] != frames \
                or launched["recover_masks"] != converted:
            raise AssertionError(f"{tag}: expected {frames} images, kernel 1 twice, kernel 2 "
                                 f"once an image and kernel 6 {converted} times; got "
                                 f"{len(calls)}, {launched}")
        for key, value in launched.items():
            counts[key] = counts.get(key, 0) + value

    name = "orienmask_yolo_coco_544_anchor4_fpn_plus_infer"
    config = getattr(configs, name)
    out = workdir / "json"
    t = time.perf_counter()
    lines, calls, _, launched, converted = run_cli(
        ["-c", name, "--random-weights", "-d", str(FIXTURES), "-j",
         str(FIXTURES / "images.json"), "-o", str(out)])
    log(f"  -j -o: {len(calls)} JPEGs in {time.perf_counter() - t:.2f} s (model build "
        f"included), launches: {launched}; report: " + "; ".join(lines))
    expect("-j -o", calls, launched, n, converted=n)
    plain, _ = check_against_plain("-j -o", calls, _kw(config["postprocess"]), 544)
    n_valid = sum(int(c[2]["valid"].sum()) for c in calls)
    for kind in ("bbox", "segm"):
        dumped = json.loads((out / f"{kind}_prediction.json").read_text())
        if len(dumped) != n_valid or {d["image_id"] for d in dumped} != set(range(1, n + 1)):
            raise AssertionError(f"-j -o: {kind} json holds {len(dumped)} entries for "
                                 f"{n_valid} valid detections")
    host_s = check_json_routes("-j -o", out, converted, plain)
    log(f"  -j -o: every image identical to the plain-version postprocess on its heads; bbox "
        f"and segm json hold {n_valid} entries each, identical to the host route's on the "
        f"same device outputs ({host_s:.2f} s)")
    reports["json"] = report_ms(lines)

    out = workdir / "drawn"
    random.seed(SEED)
    t = time.perf_counter()
    lines, calls, _, launched, _ = run_cli(["-c", name, "--random-weights", "-d",
                                            str(FIXTURES), "-v", "-o", str(out)])
    log(f"  -v -o: {len(calls)} JPEGs in {time.perf_counter() - t:.2f} s, launches: "
        f"{launched}; report: " + "; ".join(lines))
    expect("-v -o", calls, launched, n)
    plain, wants = check_against_plain("-v -o", calls, _kw(config["postprocess"]), 544)
    written = sorted(p.name for p in out.iterdir())
    if written != names:
        raise AssertionError(f"-v -o wrote {written} for {names}")
    vis, pad_info = check_drawings("-v -o", out, written, wants, plain, paths, config, SEED)
    reports["visualize"] = report_ms(lines)

    # spread scores: 100 detections above conf_thresh, boxes, labels and masks
    host = plain.to_host_list(wants[0])[0]
    host["bbox"] = host["bbox"].copy()
    host["bbox"][:, 4] = np.linspace(0.99, 0.31, len(host["bbox"]), dtype=np.float32)
    host["bbox"][:, :4] = np.random.default_rng(SEED + 15).uniform(
        0.1, 0.9, (len(host["bbox"]), 4)).astype(np.float32) * [1, 1, 0.4, 0.4]
    src = read_image(paths[0]).astype(np.float32)
    times = []
    for _ in range(2):
        random.seed(SEED)
        t = time.perf_counter()
        show = vis(host, src, pad_info)
        times.append(1e3 * (time.perf_counter() - t))
    changed = int((show != np.round(src).astype(np.uint8)).any(axis=2).sum())
    if show.shape != src.shape or show.dtype != np.uint8 or changed == 0:
        raise AssertionError("the spread-score drawing changed nothing")
    spread_ms = float(np.median(times))
    log(f"  spread scores: {len(host['bbox'])} detections drawn on {names[0]} "
        f"({src.shape[1]}x{src.shape[0]}) in {spread_ms:.1f} ms (median of 2), "
        f"{changed} pixels changed")

    name = "orienmask_yolo_coco_736_anchor4_fpn_plus_infer"
    config = getattr(configs, name)
    out = workdir / "frames"
    random.seed(SEED + 1)
    t = time.perf_counter()
    lines, calls, retrieved, launched, _ = run_cli(["-c", name, "--random-weights",
                                                    "--video", str(FIXTURES), "-o", str(out)])
    log(f"  --video -o: {len(calls)} frames in {time.perf_counter() - t:.2f} s (model build "
        f"included), launches: {launched}; report: " + "; ".join(lines))
    expect("--video -o", calls, launched, n)
    if len(retrieved) != n:
        raise AssertionError(f"--video -o: {len(retrieved)} frames retrieved of {n}")
    plain, wants = check_against_plain("--video -o", calls, _kw(config["postprocess"]), 736)
    for want, host in zip(wants, retrieved):
        for got_r, want_r in zip(host, plain.to_host_list(want)):
            for key in want_r:
                if not np.array_equal(got_r[key], want_r[key]):
                    raise AssertionError(f"--video -o: the streamed host '{key}' differs")
    written = sorted(p.name for p in out.iterdir())
    if written != [f"frame_{i:06d}.jpg" for i in range(n)]:
        raise AssertionError(f"--video -o wrote {written}")
    check_drawings("--video -o", out, written, wants, plain, paths, config, SEED + 1)
    stream_line = [ln for ln in lines if ln.startswith("The average streaming time")]
    fps = float(stream_line[0].split("(")[1].split(" fps")[0])
    for key in ("json", "visualize"):
        log(f"  report ({'-j -o' if key == 'json' else '-v -o'}), ms an image: " + ", ".join(
            f"{k} {reports[key][k]:.2f}" for k in ("Load data", "Forward & Postprocess",
                                                   "Convert Format", "Visualize")
            if k in reports[key]) + f"; card: {card_line()}")
    log(f"  --video -o at 736x736: {n} frames at {fps:.2f} FPS (the CLI's report, model "
        f"warm-up and first-frame algorithm choice included)")
    return counts, {"fixtures": n, "reports_ms": reports, "spread_draw_ms": spread_ms,
                    "video_736_fps": fps}


# --------------------------------------------------------------- kernel 6

def ellipse_masks(rng, k, size):
    """``k`` elliptic instance masks at ``size``², drawn as
    ``data/synthetic.py::make_scenes`` draws its ellipses (axes 0.15-0.55 of
    the side, the centre keeping the box inside), packed on the card."""
    from orienmask_tpu_torch.ops.maskops import pack_bits

    ys, xs = np.mgrid[0:size, 0:size] / size
    masks = np.zeros((k, size, size), bool)
    for j in range(k):
        bw, bh = rng.uniform(0.15, 0.55, 2)
        cx = rng.uniform(bw / 2 + 0.02, 0.98 - bw / 2)
        cy = rng.uniform(bh / 2 + 0.02, 0.98 - bh / 2)
        masks[j] = ((xs - cx) / (bw / 2)) ** 2 + ((ys - cy) / (bh / 2)) ** 2 <= 1.0
    return pack_bits(torch.from_numpy(masks).cuda())[None]


def recover_cases(rng):
    """Phase 16's cases: (key, label, packed masks (B, K, H, W/8) on the card,
    infos, valid counts).  Noise bytes in (a)-(f): every mask pixel a coin
    flip, so the resize meets its 0.5 ties everywhere; (g) mask-like."""
    def noise(b, k, size):
        return torch.from_numpy(rng.integers(0, 256, (b, k, size, size // 8),
                                             dtype=np.uint8)).cuda()

    cli = {"collate_pad": (0, 0, 0, 0, 544, 544)}  # the pipeline's resize has no letterbox
    flips = [{"height": 500, "width": 700, "collate_pad": (5, 11, 7, 3, 544, 544),
              "pad": (9, 2, 4, 13, 534, 528), "hflip": True, "vflip": True},
             {"height": 131, "width": 97, "pad": (30, 0, 0, 51, 544, 544), "hflip": True},
             {"height": 544, "width": 544}]
    return [
        ("a", "the CLI's 544² to 480x640, 100 masks", noise(1, 100, 544),
         [dict(cli, height=480, width=640)], [100]),
        ("b", "an eval batch, B = 16 at 544² to 544², 100 masks each", noise(16, 100, 544),
         [{"height": 544, "width": 544}] * 16, [100] * 16),
        ("c", "the JPEG fixture's 544² to 427x613", noise(1, 100, 544),
         [dict(cli, height=427, width=613)], [100]),
        ("d", "736² to 720x1280", noise(1, 100, 736),
         [{"height": 720, "width": 1280, "collate_pad": (0, 0, 0, 0, 736, 736)}], [100]),
        ("e", "hflip + vflip, asymmetric pads, B = 3 (40, 17, 0 masks)", noise(3, 40, 544),
         flips, [40, 17, 0]),
        ("f", "an exact 2x down, 544² to 272²", noise(1, 100, 544),
         [{"height": 272, "width": 272}], [100]),
        ("g", "100 elliptic masks, the CLI's 544² to 480x640", ellipse_masks(rng, 100, 544),
         [dict(cli, height=480, width=640)], [100]),
    ]


def recover_work(packed, geom):
    """(bytes, operations) kernel 6's function needs on these inputs: the
    valid detections' packed masks and the tables read once, the words
    written once.  Operations as the function needs them, not as the kernel
    spends them: a pass's subtraction and fused multiply-add only where its
    fraction is non-zero and its two values differ (else its result is the
    first value; the bottom row's pass only where the rows' fraction is
    non-zero), and a rint where any pass ran.  An identity resize needs
    none."""
    n_bytes = 4 * geom.offsets[-1] + sum(t.numel() * t.element_size() for t in (
        geom.geom, geom.xtab, geom.xfrac, geom.ytab, geom.yfrac))
    n_ops = 0
    shift = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    for i, ((n, (oh, ow)), (xo, yo)) in enumerate(zip(zip(geom.counts, geom.sizes),
                                                      geom.geom[:, 4:6].tolist())):
        if not n:
            continue
        n_bytes += n * packed.shape[2] * packed.shape[3]
        bits = ((packed[i, :n, :, :, None] >> shift) & 1).reshape(n, packed.shape[2], -1)
        x, y = geom.xtab[xo:xo + ow].long(), geom.ytab[yo:yo + oh].long()
        fx, fy = geom.xfrac[xo:xo + ow].double(), geom.yfrac[yo:yo + oh].double()[:, None]
        top, bottom = bits[:, y[:, 0]], bits[:, y[:, 1]]
        a, b, c, d = (t.double() for t in (top[:, :, x[:, 0]], top[:, :, x[:, 1]],
                                           bottom[:, :, x[:, 0]], bottom[:, :, x[:, 1]]))
        pass_top = (fx != 0) & (a != b)
        pass_bottom = (fx != 0) & (fy != 0) & (c != d)
        pass_rows = (fy != 0) & ((b - a) * fx + a != (d - c) * fx + c)
        n_ops += 2 * int(pass_top.sum() + pass_bottom.sum() + pass_rows.sum()) + \
            int((pass_top | pass_bottom | pass_rows).sum())
    return n_bytes, n_ops


def check_recover():
    """Phase 16: kernel 6 against its plain version on every case, bit for
    bit, each timed beside its plain version and its bound, with its tiles
    counted by the path they take (``ops/recover.py::tile_classes``)."""
    from orienmask_tpu_torch.ops.recover import (recover_geometry, recover_masks,
                                                 recover_masks_plain, recover_occupancy,
                                                 tile_classes)

    rng = np.random.default_rng(SEED + 16)
    cases, err = {}, 0
    for key, label, packed, infos, counts in recover_cases(rng):
        geom = recover_geometry(infos, counts, (packed.shape[2], 8 * packed.shape[3]),
                                packed.device)
        got, want = recover_masks(packed, geom), recover_masks_plain(packed, geom)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"kernel 6 ({key}): {got.shape} words, plain {want.shape}")
        bad = int((got != want).sum())
        err = max(err, int(bad > 0))  # the largest pixel difference: bits differ by 1
        if bad:
            raise AssertionError(f"kernel 6 ({key}) {label}: {bad} words differ from the "
                                 "plain version")
        t = time_ms(lambda: recover_masks(packed, geom))
        t_plain = eager_ms(lambda: recover_masks_plain(packed, geom), n=3)
        n_bytes, n_ops = recover_work(packed, geom)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        tiles = tile_classes(packed.cpu().numpy(), geom)
        smem, blocks = recover_occupancy(geom, packed.shape[3])
        log(f"  ({key}) {label}: {geom.offsets[-1]} words identical; kernel {t:.4f} ms, plain "
            f"{t_plain:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.2f} MB, "
            f"{n_ops / 1e6:.1f} M instructions); tiles {tiles}; {smem} B of shared memory "
            f"a block, {blocks} blocks an SM")
        cases[key] = dict(label=label, ms=t, plain_ms=t_plain, bound_ms=bound_ms,
                          bound_by=bound_by, bytes=n_bytes, ops=n_ops, launches=1,
                          words=geom.offsets[-1], tiles=tiles, smem=smem, blocks_per_sm=blocks)
    log(f"  card: {card_line()}")
    return err, cases



# ------------------------------------------------------ training from files

FILES_IMAGES = 32
FILES_SIZES = ((480, 640), (427, 613))
FILES_EPOCHS = 3


def files_configs(workdir, n_device=1, epochs=FILES_EPOCHS, **updates):
    """The port's mini dataset (32 seeded scenes at 480x640 and 427x613,
    elliptic and polygonal instances, COCO json with polygons and RLE) and
    two config files: the published train config at full width and depth on
    it (by default one device's share, B = 8; its own dtype, transforms and
    loader workers; 3 epochs validated each, ``epoch2.ckpt``; ``pretrained``
    a file that is not there; ``updates`` merged last) and its test config
    (the val set, batch 16, ``n_device`` as the train config's).  Returns
    (train config, its file, test config file, seconds writing)."""
    import orienmask_tpu_torch.config as configs
    from orienmask_tpu_torch.utils.mini_dataset import (mini_config, mini_test_config,
                                                        write_mini_dataset)

    t = time.perf_counter()
    paths = write_mini_dataset(workdir / "data", FILES_IMAGES, FILES_SIZES, seed=SEED)
    write_s = time.perf_counter() - t
    cfg = mini_config(paths, workdir / "runs", n_device=n_device, epochs=epochs, val_freq=1,
                      save_freq=2, model={"pretrained": str(workdir / "pretrained_darknet53.pth")},
                      **updates)
    bs = configs.orienmask_yolo_coco_544_anchor4_fpn_plus_test["test_loader"]["batch_size"]
    cfg_file, test_file = workdir / "train_config.json", workdir / "test_config.json"
    cfg_file.write_text(json.dumps(cfg))
    test_file.write_text(json.dumps(dict(mini_test_config(cfg, batch_size=bs), n_device=n_device)))
    return cfg, cfg_file, test_file, write_s


def record_trainer():
    """Patches that keep the trainer, each epoch's result and seconds, each
    val epoch's seconds, the first train batch, and each step's device time
    (CUDA events around it) and host wait before it (the loader's share);
    ``rec["in_step"]`` is true while a step runs."""
    from orienmask_tpu_torch.trainer import trainer as trainer_module

    rec = {"epochs": [], "epoch_s": [], "val_s": [], "events": [], "wait_s": [], "batch": None}
    train_epoch, val_epoch = trainer_module.Trainer._train_epoch, trainer_module.Trainer._val_epoch
    make_train_step = trainer_module.make_train_step

    def recording_train_epoch(trainer, epoch):
        rec["trainer"], rec["last"] = trainer, None
        t = time.perf_counter()
        rec["epochs"].append(train_epoch(trainer, epoch))
        rec["epoch_s"].append(time.perf_counter() - t)
        return rec["epochs"][-1]

    def recording_val_epoch(trainer, epoch):
        t = time.perf_counter()
        out = val_epoch(trainer, epoch)
        rec["val_s"].append(time.perf_counter() - t)
        return out

    def recording_make_train_step(*args, **kw):
        step = make_train_step(*args, **kw)

        def train_step(batch, lr, do_step=True):
            if rec["last"] is not None:
                rec["wait_s"].append(time.perf_counter() - rec["last"])
            if rec["batch"] is None:
                rec["batch"] = batch
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
            rec["in_step"] = True
            out = step(batch, lr, do_step)
            rec["in_step"] = False
            events[1].record()
            rec["events"].append(events)
            rec["last"] = time.perf_counter()
            return out

        return train_step

    patches = [mock.patch.object(trainer_module.Trainer, "_train_epoch", recording_train_epoch),
               mock.patch.object(trainer_module.Trainer, "_val_epoch", recording_val_epoch),
               mock.patch.object(trainer_module, "make_train_step", recording_make_train_step)]
    return rec, patches


def check_routes_and_recovery(name, converted, plain, host_route=True):
    """Each recorded COCO conversion: kernel 6 bit for bit with its plain
    version on its device outputs and, with ``host_route``, the card route's
    dicts identical to the host route's on them."""
    from orienmask_tpu_torch.ops.recover import (recover_geometry, recover_masks,
                                                 recover_masks_plain)

    words = 0
    for metrics, info, device_out, image_w, card in converted:
        if host_route and json.dumps(card) != json.dumps(
                metrics.to_coco_format(info, plain.to_host_list(device_out))):
            raise AssertionError(f"{name}: a batch's card-route COCO dicts differ from the "
                                 "host route's")
        counts = [0 if i.get("_pad", False) else int(v.sum())
                  for i, v in zip(info, device_out["valid"])]
        packed = device_out["mask"]
        geom = recover_geometry(info, counts, (packed.shape[2], image_w), packed.device)
        got, want_words = recover_masks(packed, geom), recover_masks_plain(packed, geom)
        if not torch.equal(got, want_words):
            raise AssertionError(f"{name}: kernel 6 differs from its plain version")
        words += int(geom.offsets[-1])
    return words


def check_heads(name, calls, pp_kw):
    """Kernels 1 and 2 on each recorded batch's heads: the postprocess's
    outputs identical to the plain-version postprocess's; the plain
    postprocess and the valid detections counted."""
    plain = plain_postprocess(pp_kw)
    n_valid = 0
    for _, heads, got in calls:
        want = plain._run_batch(heads)
        for key in got:
            if not torch.equal(got[key], want[key]):
                raise AssertionError(f"{name}: '{key}' differs from the plain-version "
                                     "postprocess on the same heads")
        n_valid += int(got["valid"].sum())
    return plain, n_valid


def check_train_files(workdir):
    """Phase 17: the train CLI on the mini dataset, then the test CLI on its
    best checkpoint, each in this process through ``main(argv)``."""
    from orienmask_tpu_torch import test as test_cli
    from orienmask_tpu_torch import train as train_cli
    from orienmask_tpu_torch.models import build_model
    from orienmask_tpu_torch.ops import targets
    from orienmask_tpu_torch.trainer.builder import build_dataloader, build_tester
    from orienmask_tpu_torch.trainer.checkpoint import load_checkpoint
    from orienmask_tpu_torch.trainer.train_state import to_device

    cfg, cfg_file, test_file, write_s = files_configs(workdir)
    loader_cfg = cfg["train_loader"]
    steps = FILES_IMAGES // loader_cfg["batch_size"]
    val_batches = -(-FILES_IMAGES // cfg["val_loader"]["batch_size"])
    log(f"  dataset: {FILES_IMAGES} PNG scenes at {FILES_SIZES} written in {write_s:.2f} s; "
        f"B = {loader_cfg['batch_size']}, {loader_cfg['num_workers']} loader workers, "
        f"{cfg['compute_dtype']}, {FILES_EPOCHS} epochs of {steps} steps")

    # the host data path alone, inline: load, decode, transform, collate
    inline = build_dataloader(dict(loader_cfg, num_workers=0, drop_last=True), seed=cfg["seed"])
    inline.set_epoch(1)
    t = time.perf_counter()
    for _, _ in zip(range(2), inline):
        pass
    host_ms = (time.perf_counter() - t) * 1e3 / (2 * loader_cfg["batch_size"])

    rec, patches = record_trainer()
    text = io.StringIO()
    t = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        stack.enter_context(contextlib.redirect_stdout(text))
        rc, calls, _, train_counts, converted = record_run_batch(
            lambda: train_cli.main(["-c", str(cfg_file)]))
    train_s = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"train.main returned {rc}")
    if "[DarkNet53] pretrained file not found, skipping" not in text.getvalue():
        raise AssertionError("the missing pretrained file was not reported")
    # kernel 5 paints the targets of each train step and of each val batch's loss
    want = {"paint_orientation": FILES_EPOCHS * (steps + val_batches),
            "exact_topk": 2 * FILES_EPOCHS * val_batches,
            "assemble_masks_packed": FILES_EPOCHS * val_batches,
            "recover_masks": FILES_EPOCHS * val_batches}
    if {k: v for k, v in train_counts.items() if v} != want:
        raise AssertionError(f"train CLI launches {train_counts}, expected {want}")
    log(f"  train CLI: {FILES_EPOCHS} epochs in {train_s:.2f} s (model build included), "
        f"launches: {train_counts}")

    losses = [e["train_loss"] for e in rec["epochs"]]
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"epoch losses {losses}: not finite, or epoch "
                             f"{FILES_EPOCHS}'s not below epoch 1's")
    log(f"  epoch mean losses {[round(x, 3) for x in losses]}; val segm AP "
        f"{[round(e['val_segm_AP'], 4) for e in rec['epochs']]}")

    trainer = rec["trainer"]
    run_dir = Path(trainer.checkpoint_dir)
    names = sorted(os.listdir(run_dir))
    best = [n for n in names if n.startswith("best_epoch")]
    if "epoch2.ckpt" not in names or len(best) != 1 or "temp.ckpt" in names \
            or os.readlink(run_dir / "best_model.ckpt") != best[0]:
        raise AssertionError(f"checkpoints {names}: expected epoch2.ckpt, one best_epochN.ckpt "
                             "and best_model.ckpt linking to it")
    for name in ("epoch2.ckpt", best[0]):
        meta = load_checkpoint(run_dir / name, build_model(cfg["model"]))
        if int(np.asarray(meta["opt_state"]["step"])) != meta["epoch"] * steps:
            raise AssertionError(f"{name}: {meta['opt_state']['step']} updates at epoch "
                                 f"{meta['epoch']}")
    log(f"  run directory {names}; epoch2.ckpt and {best[0]} load back into a fresh model")

    # kernel 5 on the loader's first batch
    batch = to_device(rec["batch"], "cuda")
    painted = []
    with mock.patch.object(targets, "paint_orientation",
                           lambda geom, n_last, masks, *rest: painted.append(
                               (geom.clone(), n_last.clone(), masks.clone()))):
        trainer.loss._paint_shared_batch(batch["bbox"], batch["valid"], batch["mask"])
    painter = trainer.loss.painter
    paint_err = check_paint_case("the loader's first batch", *painted[0], painter.pixel_anchors,
                                 (painter.image_h, painter.image_w))

    pp_kw = _kw(cfg["postprocess"])
    t = time.perf_counter()
    plain, n_valid = check_heads("train CLI (val epochs)", calls, pp_kw)
    last = converted[-val_batches:]  # the last val epoch's (the host route takes seconds a batch)
    words = check_routes_and_recovery("train CLI (last val epoch)", last, plain)
    log(f"  val epochs: {len(calls)} batches identical to the plain-version postprocess "
        f"({n_valid} valid detections); the last epoch's {len(last)} COCO conversions "
        f"identical to the host route's, kernel 6 identical to its plain version on them "
        f"({words} words); checked in {time.perf_counter() - t:.1f} s")

    # the test CLI on the best checkpoint, then a Tester built in this process
    testers = []

    def recording_build_tester(*args, **kw):
        testers.append(build_tester(*args, **kw))
        return testers[-1]

    text = io.StringIO()
    ckpt = str(run_dir / "best_model.ckpt")
    t = time.perf_counter()
    with mock.patch.object(test_cli, "build_tester", recording_build_tester), \
            contextlib.redirect_stdout(text):
        rc, test_calls, _, test_counts, test_converted = record_run_batch(
            lambda: test_cli.main(["-c", str(test_file), "-w", ckpt]))
    test_s = time.perf_counter() - t
    test_bs = json.loads(test_file.read_text())["test_loader"]["batch_size"] // DP_RANKS
    test_batches = -(-FILES_IMAGES // (test_bs * DP_RANKS))  # a rank's
    want = {"exact_topk": 2 * test_batches, "assemble_masks_packed": test_batches,
            "recover_masks": test_batches}
    if rc != 0 or {k: v for k, v in test_counts.items() if v} != want:
        raise AssertionError(f"test CLI: rc {rc}, launches {test_counts}, expected {want}")
    stages = report_ms(text.getvalue().splitlines())
    log(f"  test CLI on {best[0]}: {FILES_IMAGES} images in {test_s:.2f} s (build included), "
        f"launches: {test_counts}")
    t = time.perf_counter()
    plain, n_valid = check_heads("test CLI", test_calls, pp_kw)
    words = check_routes_and_recovery("test CLI", test_converted, plain, host_route=False)
    tester = build_tester(json.loads(test_file.read_text()), ckpt, device="cuda")
    with contextlib.redirect_stdout(io.StringIO()):
        tester.test()
    tester.test_loader.shutdown()
    for kind in ("bbox", "segm"):
        got = np.asarray(getattr(testers[0].coco_metrics, f"{kind}_eval_stats"))
        want_stats = np.asarray(getattr(tester.coco_metrics, f"{kind}_eval_stats"))
        if got.shape != (12,) or not np.array_equal(got, want_stats):
            raise AssertionError(f"test CLI {kind} stats {got} differ from the in-process "
                                 f"Tester's {want_stats}")
    log(f"  test CLI: outputs identical to the plain-version postprocess ({n_valid} valid "
        f"detections), kernel 6 to its plain version ({words} words); bbox and segm 12-stat "
        f"vectors equal to an in-process Tester's (segm AP "
        f"{float(tester.coco_metrics.segm_eval_stats[0]):.4f}); checked in "
        f"{time.perf_counter() - t:.1f} s")

    torch.cuda.synchronize()
    step_ms = [a.elapsed_time(b) for a, b in rec["events"]]
    train_only = [e - v for e, v in zip(rec["epoch_s"], rec["val_s"])]
    rates = [FILES_IMAGES / s for s in train_only]
    val_rates = [FILES_IMAGES / s for s in rec["val_s"]]
    timings = {"train_images_per_s": rates, "val_images_per_s": val_rates,
               "step_ms_median": float(np.median(step_ms)), "step_ms": step_ms,
               "loader_wait_ms_per_step": float(np.mean(rec["wait_s"])) * 1e3,
               "host_data_ms_per_image": host_ms, "test_stage_ms_per_image": stages,
               "epoch_losses": losses}
    log(f"  train epochs {', '.join(f'{r:.2f}' for r in rates)} images/s (val excluded); "
        f"val epochs {', '.join(f'{r:.2f}' for r in val_rates)} images/s; step "
        f"{timings['step_ms_median']:.1f} ms on the stream (median of {len(step_ms)}); the "
        f"trainer waited {timings['loader_wait_ms_per_step']:.1f} ms a step for its loader; "
        f"load + decode + transform + collate inline {host_ms:.1f} ms an image "
        f"({host_ms * loader_cfg['batch_size']:.0f} ms a batch on one core)")
    log(f"  test CLI ms an image: {stages}")
    log(f"  card: {card_line()}")
    counts = {"train_cli": train_counts, "test_cli": test_counts}
    return counts, paint_err, timings, {"cfg": cfg, "best": ckpt}


# ------------------------------------------------------- data parallelism

DP_RANKS = 2
DP_EPOCHS = 2
DP_WORKERS = 2  # loader workers a rank: the card's host has 8 cores for everything
DP_DEADLINE_S = 480
# tests/test_torch_parallel.py's tolerances for a step from the same state:
# logs to 2e-4 of themselves, gradients to 5% in relative L2 a tensor and 4%
# all together (random weights amplify f32 rounding along the backward)
DP_LOG_RTOL, DP_GRAD_RTOL, DP_GRAD_RTOL_ALL = 2e-4, 0.05, 0.04


def free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for sock in socks:
        sock.bind(("localhost", 0))
    ports = [sock.getsockname()[1] for sock in socks]
    for sock in socks:
        sock.close()
    return ports


def state_digest(model, opt):
    """SHA-256 of the parameters, BatchNorm buffers, momentum and update
    counter, in order, by their bytes."""
    import hashlib

    h = hashlib.sha256()
    sgd = [] if opt.buffers is None else [*opt.buffers, opt.step]
    for t in [*model.state_dict().values(), *sgd]:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dp_step(rank=None, space=None, n_images=None):
    """One step of the published train config at full width (seeded
    weights, the schedule's first lr, f32) on phase 7's 8 synthetic images:
    all of them (``rank`` None), the first ``n_images``, or this rank's 4,
    under whatever process group is initialised (with ``space``, its
    spatial step).  Returns (logs, momentum by parameter name on the
    host, state digest, parameters before the step on the host)."""
    from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus as cfg
    from orienmask_tpu_torch.data import collate
    from orienmask_tpu_torch.models import build_model, init_random
    from orienmask_tpu_torch.ops import OrienMaskYOLOMultiScaleLoss
    from orienmask_tpu_torch.optim import SGD, StepWarmUpLR
    from orienmask_tpu_torch.trainer import make_train_step

    model = init_random(build_model(cfg["model"]), SEED)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = SGD(model.parameters(), **_kw(cfg["optimizer"]))
    step = make_train_step(model, OrienMaskYOLOMultiScaleLoss(**_kw(cfg["loss"]), device="cuda"),
                           opt, device="cuda", space=space)
    samples = synthetic_samples(num_classes=cfg["model"]["num_classes"])[:n_images]
    if rank is not None:
        share = len(samples) // DP_RANKS
        samples = samples[rank * share:(rank + 1) * share]
    loader = cfg["train_loader"]
    batch = collate(samples, max_instances=loader["max_instances"], pack_masks=loader["pack_masks"])
    lr = StepWarmUpLR(**_kw(cfg["lr_scheduler"]), base_lr=opt.base_lr)(0)
    logs = {k: float(v) for k, v in step(batch, lr).items()}
    names = [n for n, _ in model.named_parameters()]
    return (logs, {n: b.cpu() for n, b in zip(names, opt.buffers)}, state_digest(model, opt),
            before, opt.weight_decay)


def compare_steps(name, got, want):
    """``got`` against ``want`` (each ``dp_step``'s result from the same
    init): the logs and each parameter's gradient, read from the momentum
    (zero before the step: buf = grad + weight_decay * param)."""
    (got_logs, got_mom, _, _, _), (want_logs, want_mom, _, before, wd) = got, want
    log_err = 0.0
    for key, value in want_logs.items():
        diff = abs(got_logs[key] - value)
        if diff > DP_LOG_RTOL * abs(value) and diff > 2e-6 * abs(want_logs["loss"]):
            raise AssertionError(f"{name}: log {key} {got_logs[key]} vs {value}")
        log_err = max(log_err, diff / max(abs(value), 1e-30))
    worst, diffs, grads = 0.0, [], []
    for n, w in want_mom.items():
        grad = (w.double() - wd * before[n].cpu().double()).reshape(-1)
        diff = (got_mom[n].double() - w.double()).reshape(-1)
        worst = max(worst, float(diff.norm() / grad.norm()))
        diffs.append(diff)
        grads.append(grad)
    together = float(torch.cat(diffs).norm() / torch.cat(grads).norm())
    if worst >= DP_GRAD_RTOL or together >= DP_GRAD_RTOL_ALL:
        raise AssertionError(f"{name}: gradients differ by {worst:.4f} (worst tensor), "
                             f"{together:.4f} (all)")
    return {"log_rel_err": log_err, "grad_rel_l2_worst": worst, "grad_rel_l2_all": together}


def time_collectives(rec):
    """Patches that put CUDA events on the stream around every
    ``all_reduce`` and ``broadcast`` issued while a train step runs
    (``rec["in_step"]``), kept in ``rec["collective_events"]``."""
    import torch.distributed as dist

    rec["collective_events"] = []

    def wrap(fn):
        def wrapped(*args, **kw):
            if not rec.get("in_step"):
                return fn(*args, **kw)
            events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            events[0].record()
            out = fn(*args, **kw)
            events[1].record()
            rec["collective_events"].append(events)
            return out
        return wrapped

    return [mock.patch.object(dist, name, wrap(getattr(dist, name)))
            for name in ("all_reduce", "broadcast")]


def dp_rank(rank, workdir, ports):
    """One rank of phase 18, spawned: the equivalence step in a group of its
    own, then ``train.main`` and ``test.main`` as rank ``rank`` of
    ``DP_RANKS``, each with its launch counts; rank 0 also holds kernels 5,
    1, 2 and 6 to their plain versions on what its runs recorded.  Writes
    ``dp_rank<rank>.json`` (and rank 0 its step's momentum) to
    ``workdir``."""
    from orienmask_tpu_torch import test as test_cli
    from orienmask_tpu_torch import train as train_cli
    from orienmask_tpu_torch.eval import COCOMetrics
    from orienmask_tpu_torch.ops import targets
    from orienmask_tpu_torch.parallel.mesh import destroy_distributed, init_distributed
    from orienmask_tpu_torch.trainer.builder import build_tester
    from orienmask_tpu_torch.trainer.train_state import to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    workdir = Path(workdir)
    out = {"rank": rank}

    init_distributed(f"localhost:{ports[0]}", DP_RANKS, rank, "cuda")
    try:
        logs, momentum, out["step_digest"], _, _ = dp_step(rank)
    finally:
        destroy_distributed()
    if rank == 0:
        torch.save((logs, momentum), workdir / "dp_step.pt")
    del momentum

    cfg = json.loads((workdir / "train_config.json").read_text())
    flags = ["--num-processes", str(DP_RANKS), "--process-id", str(rank)]
    rec, patches = record_trainer()
    merges = []
    merge = COCOMetrics.merge_ranks

    def recording_merge(metrics, directory):
        own = len(metrics.bbox_results)
        merge(metrics, directory)
        merges.append([own, len(metrics.bbox_results)])

    text = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in [*patches, *time_collectives(rec),
                  mock.patch.object(COCOMetrics, "merge_ranks", recording_merge)]:
            stack.enter_context(p)
        stack.enter_context(contextlib.redirect_stdout(text))
        rc, calls, _, out["train_counts"], converted = record_run_batch(lambda: train_cli.main(
            ["-c", str(workdir / "train_config.json"), "--coordinator",
             f"localhost:{ports[1]}", *flags]))
    out["train_s"] = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"rank {rank}: train.main returned {rc}")
    torch.cuda.synchronize()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    trainer = rec["trainer"]
    n_steps = len(rec["events"])
    out.update(
        parallel_line=[line for line in text.getvalue().splitlines() if "[parallel]" in line],
        digest=state_digest(trainer.model, trainer.optimizer), merges=merges,
        run_dir=trainer.checkpoint_dir, epochs=rec["epochs"], epoch_s=rec["epoch_s"],
        val_s=rec["val_s"], step_ms=[a.elapsed_time(b) for a, b in rec["events"]],
        collective_ms_per_step=sum(a.elapsed_time(b) for a, b in rec["collective_events"])
        / n_steps, collectives_per_step=len(rec["collective_events"]) / n_steps,
        loader_wait_ms_per_step=float(np.mean(rec["wait_s"])) * 1e3)
    if rank == 0:
        batch = to_device(rec["batch"], "cuda")
        painted = []
        with mock.patch.object(targets, "paint_orientation",
                               lambda geom, n_last, masks, *rest: painted.append(
                                   (geom.clone(), n_last.clone(), masks.clone()))):
            trainer.loss._paint_shared_batch(batch["bbox"], batch["valid"], batch["mask"])
        painter = trainer.loss.painter
        with contextlib.redirect_stdout(text):
            out["paint_err"] = check_paint_case(
                "rank 0's first batch", *painted[0], painter.pixel_anchors,
                (painter.image_h, painter.image_w))
        plain, out["val_valid"] = check_heads("rank 0's val batches", calls, _kw(cfg["postprocess"]))
        out["val_words"] = check_routes_and_recovery("rank 0's val batches", converted, plain,
                                                     host_route=False)
    del trainer, calls, converted, rec

    testers = []

    def recording_build_tester(*args, **kw):
        testers.append(build_tester(*args, **kw))
        return testers[-1]

    ckpt = str(Path(out["run_dir"]) / "best_model.ckpt")
    with mock.patch.object(test_cli, "build_tester", recording_build_tester), \
            contextlib.redirect_stdout(text):
        rc, test_calls, _, out["test_counts"], test_converted = record_run_batch(
            lambda: test_cli.main(["-c", str(workdir / "test_config.json"), "-w", ckpt,
                                   "--coordinator", f"localhost:{ports[2]}", *flags]))
    if rc != 0:
        raise AssertionError(f"rank {rank}: test.main returned {rc}")
    metrics = testers[0].coco_metrics
    out["test_results"] = len(metrics.bbox_results)
    if rank == 0:
        out["stats"] = {k: np.asarray(getattr(metrics, f"{k}_eval_stats")).tolist()
                        for k in ("bbox", "segm")}
        plain, out["test_valid"] = check_heads("rank 0's test batches", test_calls,
                                               _kw(cfg["postprocess"]))
        out["test_words"] = check_routes_and_recovery("rank 0's test batches", test_converted,
                                                      plain, host_route=False)
    (workdir / f"dp_rank{rank}.json").write_text(json.dumps(out))


def run_ranks(fn, args, deadline_s):
    """``fn(rank, *args)`` in ``DP_RANKS`` spawned processes; raises if one
    fails (the others are stopped) or the deadline passes."""
    import torch.multiprocessing as tmp

    ctx = tmp.start_processes(fn, args=args, nprocs=DP_RANKS, join=False, start_method="spawn")
    deadline = time.perf_counter() + deadline_s
    try:
        while not ctx.join(timeout=5):
            if time.perf_counter() > deadline:
                raise AssertionError(f"the ranks did not finish within {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(timeout=30)


def check_data_parallel(workdir):
    """Phase 18: the published config's n_device=2 as two ranks on the one
    card (gloo with CUDA tensors: NCCL takes no two ranks on one device):
    the equivalence step, the train CLI, the test CLI; then, in this
    process, the step with no group and in a one-rank NCCL group, and the
    one-process test CLI."""
    import torch.distributed as dist

    from orienmask_tpu_torch import test as test_cli
    from orienmask_tpu_torch.trainer.builder import build_tester

    t0 = time.perf_counter()
    cfg, _, test_file, write_s = files_configs(
        workdir, n_device=DP_RANKS, epochs=DP_EPOCHS,
        train_loader={"num_workers": DP_WORKERS}, val_loader={"num_workers": DP_WORKERS})
    bs = cfg["train_loader"]["batch_size"]
    steps = FILES_IMAGES // (bs * DP_RANKS)
    val_batches = -(-FILES_IMAGES // (cfg["val_loader"]["batch_size"] * DP_RANKS))
    test_bs = json.loads(test_file.read_text())["test_loader"]["batch_size"] // DP_RANKS
    test_batches = -(-FILES_IMAGES // (test_bs * DP_RANKS))  # a rank's
    log(f"  dataset: {FILES_IMAGES} scenes written in {write_s:.2f} s; n_device {DP_RANKS}, "
        f"B = {bs} a rank ({bs * DP_RANKS} global), {DP_WORKERS} loader workers a rank, "
        f"{cfg['compute_dtype']}, {DP_EPOCHS} epochs of {steps} steps, each validated")
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    run_ranks(dp_rank, (str(workdir), free_ports(3)), DP_DEADLINE_S)
    ranks_s = time.perf_counter() - t
    ranks = [json.loads((workdir / f"dp_rank{r}.json").read_text()) for r in range(DP_RANKS)]
    r0 = ranks[0]
    log(f"  ranks: {r0['parallel_line']}; spawned, trained and tested in {ranks_s:.2f} s")

    want = {"paint_orientation": DP_EPOCHS * (steps + val_batches),
            "exact_topk": 2 * DP_EPOCHS * val_batches,
            "assemble_masks_packed": DP_EPOCHS * val_batches,
            "recover_masks": DP_EPOCHS * val_batches}
    want_test = {"exact_topk": 2 * test_batches, "assemble_masks_packed": test_batches,
                 "recover_masks": test_batches}
    for r in ranks:
        got = {k: v for k, v in r["train_counts"].items() if v}
        got_test = {k: v for k, v in r["test_counts"].items() if v}
        if got != want or got_test != want_test:
            raise AssertionError(f"rank {r['rank']}: launches train {got} test {got_test}, "
                                 f"expected {want} and {want_test}")
        log(f"  rank {r['rank']} launches: train CLI {got}, test CLI {got_test}")

    # the equivalence step: 2 ranks x 4 images, one process x 8, a one-rank NCCL group x 8
    if len({r["step_digest"] for r in ranks}) != 1:
        raise AssertionError("the ranks' states differ after the equivalence step")
    dp_logs, dp_mom = torch.load(workdir / "dp_step.pt")
    one = dp_step()
    dp_err = compare_steps("2 ranks x 4 vs 1 process x 8", (dp_logs, dp_mom, None, None, None),
                           one)
    calls = []
    all_reduce = dist.all_reduce
    port = free_ports(1)[0]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        with mock.patch.object(dist, "all_reduce",
                               lambda *a, **kw: (calls.append(1), all_reduce(*a, **kw))[1]):
            nccl = dp_step()
    finally:
        dist.destroy_process_group()
    nccl_err = compare_steps("one-rank NCCL group vs no group", nccl, one)
    log(f"  equivalence step (full width, 544², f32): loss 2 ranks x 4 {dp_logs['loss']:.4f}, "
        f"1 process x 8 {one[0]['loss']:.4f}, one-rank NCCL group x 8 {nccl[0]['loss']:.4f} "
        f"({len(calls)} NCCL all_reduces); the ranks equal by bits; against no group: "
        f"2 ranks {dp_err}, NCCL {nccl_err}")
    del one, nccl, dp_mom

    # the train CLI
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError("the ranks end the train CLI with different states")
    losses = [e["train_loss"] for e in r0["epochs"]]
    for r in ranks[1:]:
        if [e["train_loss"] for e in r["epochs"]] != losses:
            raise AssertionError("the ranks logged different epoch losses")
    if not np.isfinite(losses).all() or not np.isfinite([e["val_loss"] for e in r0["epochs"]]).all():
        raise AssertionError(f"non-finite epoch losses {r0['epochs']}")
    merged = [m0[1] for m0 in r0["merges"]]
    if merged != [sum(r["merges"][i][0] for r in ranks) for i in range(len(merged))] \
            or len(merged) != DP_EPOCHS:
        raise AssertionError(f"rank 0's merged results {r0['merges']} are not the ranks' sum "
                             f"{[r['merges'] for r in ranks]}")
    log(f"  train CLI: epoch losses {[round(x, 3) for x in losses]}, val losses "
        f"{[round(e['val_loss'], 3) for e in r0['epochs']]}; parameters, BN buffers, momentum "
        f"and counter equal by bits on both ranks; rank 0 merged {merged} COCO results a val "
        f"epoch (its own {[m[0] for m in r0['merges']]} + rank 1's "
        f"{[m[0] for m in ranks[1]['merges']]})")
    log(f"  rank 0: kernel 5 on its first batch bit for bit; kernels 1 and 2 on its val batches "
        f"({r0['val_valid']} valid detections) and test batches ({r0['test_valid']}), kernel 6 "
        f"on both ({r0['val_words']} and {r0['test_words']} words), identical to the plain "
        f"versions")

    # the test CLI: n_device=2 as two ranks against one process
    testers = []

    def recording_build_tester(*args, **kw):
        testers.append(build_tester(*args, **kw))
        return testers[-1]

    one_file = workdir / "test_config_1.json"
    one_file.write_text(json.dumps(dict(json.loads(test_file.read_text()), n_device=1)))
    ckpt = str(Path(r0["run_dir"]) / "best_model.ckpt")
    with mock.patch.object(test_cli, "build_tester", recording_build_tester), \
            contextlib.redirect_stdout(io.StringIO()):
        if test_cli.main(["-c", str(one_file), "-w", ckpt]) != 0:
            raise AssertionError("the one-process test CLI failed")
    metrics = testers[0].coco_metrics
    for kind in ("bbox", "segm"):
        got = np.asarray(r0["stats"][kind])
        want_stats = np.asarray(getattr(metrics, f"{kind}_eval_stats"))
        if got.shape != (12,) or not np.allclose(got, want_stats, rtol=0, atol=1e-6):
            raise AssertionError(f"test CLI {kind} stats with n_device=2 {got} differ from one "
                                 f"process's {want_stats}")
    if r0["test_results"] != len(metrics.bbox_results):
        raise AssertionError(f"{r0['test_results']} merged results, one process "
                             f"{len(metrics.bbox_results)}")
    log(f"  test CLI, n_device=2 as two ranks: bbox and segm 12-stat vectors equal to one "
        f"process's to 1e-6 ({r0['test_results']} results on rank 0 after the merge)")

    # timings (the card's; the ranks share it)
    images = FILES_IMAGES
    rates = [images / (e - v) for e, v in zip(r0["epoch_s"], r0["val_s"])]
    timings = {
        "train_images_per_s": rates,
        "val_images_per_s": [images / v for v in r0["val_s"]],
        "step_ms_median": [float(np.median(r["step_ms"])) for r in ranks],
        "collective_ms_per_step": [r["collective_ms_per_step"] for r in ranks],
        "collectives_per_step": [r["collectives_per_step"] for r in ranks],
        "loader_wait_ms_per_step": [r["loader_wait_ms_per_step"] for r in ranks],
        "peak_gib": [r["peak_gib"] for r in ranks], "train_cli_s": [r["train_s"] for r in ranks],
        "epoch_losses": losses, "equivalence": {"dp": dp_err, "nccl": nccl_err},
        "phase_s": time.perf_counter() - t0}
    log(f"  train epochs {', '.join(f'{x:.2f}' for x in rates)} global images/s (val excluded); "
        f"val epochs {', '.join(f'{x:.2f}' for x in timings['val_images_per_s'])}")
    for r, step_ms, coll, n_coll, wait, peak in zip(
            range(DP_RANKS), timings["step_ms_median"], timings["collective_ms_per_step"],
            timings["collectives_per_step"], timings["loader_wait_ms_per_step"],
            timings["peak_gib"]):
        log(f"  rank {r}: step {step_ms:.1f} ms on the stream (median), of it {coll:.1f} ms in "
            f"{n_coll:.0f} collectives (gloo copies CUDA tensors through the host: a property "
            f"of two ranks on one card); waited {wait:.1f} ms a step for its loader; peak "
            f"memory {peak:.2f} GiB")
    log(f"  phase 18 in {timings['phase_s']:.1f} s; card: {card_line()}")
    counts = {"dp_train": {k: sum(r["train_counts"][k] for r in ranks) for k in want},
              "dp_test": {k: sum(r["test_counts"][k] for r in ranks) for k in want_test}}
    return counts, r0["paint_err"], timings


# ------------------------------------------------- the train step's options

# phase 19(b)'s keys: the published train config with two backbone stages
# frozen, the backbone's BatchNorms on their running statistics, and
# detectron2-style groups
OPTION_UPDATES = {"model": {"freeze_backbone": 2, "backbone_batchnorm_eval": True},
                  "optimizer": {"param_groups": {"norm_weight_decay": 0.0, "bias_lr_factor": 2.0,
                                                 "bias_weight_decay": 0.0}}}
OPTION_STEPS = 3
REMAT_STEPS = 3  # timed steps a turn; turns: off, on, on, off
OPTIONS_CLI_IMAGES = 16  # two steps of B = 8


class OptionsPath:
    """The published train config at full width and depth (seeded weights,
    f32, phase 7's batch), its model and optimizer blocks updated by
    ``updates``, the optimizer from ``build_optimizer``, one train step
    without and one with ``remat``."""

    def __init__(self, updates=None):
        from orienmask_tpu_torch.config import construct_config
        from orienmask_tpu_torch.config import orienmask_yolo_coco_544_anchor4_fpn_plus as base
        from orienmask_tpu_torch.data import collate
        from orienmask_tpu_torch.models import build_model, init_random
        from orienmask_tpu_torch.ops import OrienMaskYOLOMultiScaleLoss
        from orienmask_tpu_torch.optim import StepWarmUpLR
        from orienmask_tpu_torch.trainer import make_train_step
        from orienmask_tpu_torch.trainer.builder import build_optimizer
        from orienmask_tpu_torch.trainer.train_state import to_device

        self.cfg = cfg = construct_config(copy.deepcopy(base), update=copy.deepcopy(updates or {}))
        self.model = init_random(build_model(cfg["model"]), SEED)
        self.loss = OrienMaskYOLOMultiScaleLoss(**_kw(cfg["loss"]), device="cuda")
        self.opt = build_optimizer(cfg["optimizer"], self.model)
        self.sched = StepWarmUpLR(**_kw(cfg["lr_scheduler"]), base_lr=self.opt.base_lr)
        self.steps = {remat: make_train_step(self.model, self.loss, self.opt,
                                             compute_dtype="float32", device="cuda", remat=remat)
                      for remat in (False, True)}
        loader = cfg["train_loader"]
        self.batch = to_device(collate(synthetic_samples(num_classes=cfg["model"]["num_classes"]),
                                       max_instances=loader["max_instances"],
                                       pack_masks=loader["pack_masks"]), "cuda")
        self.iteration = 0

    def step(self, remat=False, grads=None):
        """One step at the schedule's lr; ``grads`` (a list) receives the
        gradients the optimizer was given."""
        apply = self.opt.apply
        if grads is not None:
            def recording_apply(g, lr, update_gate=None):
                grads.extend(x.clone() for x in g)
                return apply(g, lr, update_gate)
            self.opt.apply = recording_apply
        try:
            logs = self.steps[remat](self.batch, self.sched(self.iteration))
        finally:
            self.opt.apply = apply
        self.iteration += 1
        return logs

    def snapshot(self):
        return ({k: t.clone() for k, t in self.model.state_dict().items()},
                None if self.opt.buffers is None else [b.clone() for b in self.opt.buffers],
                None if self.opt.step is None else self.opt.step.clone(), self.iteration)

    def restore(self, snap):
        state, buffers, step, self.iteration = snap
        self.model.load_state_dict(state)
        self.opt.buffers = None if buffers is None else [b.clone() for b in buffers]
        self.opt.step = None if step is None else step.clone()


def same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.detach().contiguous().reshape(-1).view(torch.uint8),
        b.detach().contiguous().reshape(-1).view(torch.uint8))


def check_remat():
    """Phase 19(a): one step with ``remat`` and one without from the same
    state under ``cudnn.deterministic`` (the weight gradients' convolution
    algorithms reduce in no fixed order otherwise): the loss, every
    gradient, the parameters, the momentum and the BatchNorm buffers equal
    by bits.  Then ms a step and peak memory of each, in turns (off, on, on,
    off) with the default algorithms."""
    from orienmask_tpu_torch import kernels

    t = time.perf_counter()
    op = OptionsPath()
    start = op.snapshot()
    torch.backends.cudnn.deterministic = True
    try:
        results = {}
        for remat in (False, True):
            op.restore(start)
            grads = []
            logs = op.step(remat, grads)
            torch.cuda.synchronize()
            results[remat] = (logs, grads, op.snapshot())
    finally:
        torch.backends.cudnn.deterministic = False
    (off_logs, off_grads, off_state), (on_logs, on_grads, on_state) = results[False], results[True]
    if float(off_logs["loss"]) != float(on_logs["loss"]) or float(on_logs["skipped"]):
        raise AssertionError(f"remat loss {float(on_logs['loss'])} vs "
                             f"{float(off_logs['loss'])}")
    for i, (a, b) in enumerate(zip(on_grads, off_grads)):
        if not same_bits(a, b):
            raise AssertionError(f"remat: gradient {i} differs")
    for k in off_state[0]:
        if not same_bits(on_state[0][k], off_state[0][k]):
            raise AssertionError(f"remat: {k} differs after the step")
    for a, b in zip(on_state[1], off_state[1]):
        if not same_bits(a, b):
            raise AssertionError("remat: a momentum buffer differs")
    tracked = {int(v) for k, v in on_state[0].items() if k.endswith("num_batches_tracked")}
    if tracked != {1}:
        raise AssertionError(f"remat: num_batches_tracked {tracked} after one step")
    log(f"  set up and compared in {time.perf_counter() - t:.1f} s: remat == no remat by bits "
        f"(cudnn.deterministic): loss {float(on_logs['loss']):.4f}, {len(on_grads)} gradients, "
        f"{len(on_state[0])} state tensors, momentum; each BatchNorm counted once")
    # the comparison's copies (gradients, states) would count in the peaks below
    del results, off_grads, on_grads, off_state, on_state, start

    torch.cuda.synchronize()
    kernels.reset_launches()
    turns = {False: [], True: []}
    peaks = {False: [], True: []}
    for remat in (False, True, True, False):
        op.step(remat)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for _ in range(REMAT_STEPS):
            logs = op.step(remat)
        torch.cuda.synchronize()
        turns[remat].append((time.perf_counter() - t) * 1e3 / REMAT_STEPS)
        peaks[remat].append(torch.cuda.max_memory_allocated() / 2**30)
        if not torch.isfinite(logs["loss"]) or float(logs["skipped"]):
            raise AssertionError(f"remat={remat}: a non-finite step")
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    n_steps = 4 * (REMAT_STEPS + 1)
    if counts["paint_orientation"] != n_steps or sum(counts.values()) != n_steps:
        raise AssertionError(f"expected {n_steps} paint launches and nothing else, got {counts}")
    out = {name: {"ms_per_step": float(np.mean(turns[remat])), "turns_ms": turns[remat],
                  "peak_gib": max(peaks[remat])}
           for name, remat in (("off", False), ("on", True))}
    log(f"  B=8 544x544 f32: remat off {out['off']['ms_per_step']:.2f} ms/step (turns "
        f"{', '.join(f'{x:.2f}' for x in turns[False])}), peak {out['off']['peak_gib']:.2f} GiB; "
        f"on {out['on']['ms_per_step']:.2f} ms/step (turns "
        f"{', '.join(f'{x:.2f}' for x in turns[True])}), peak {out['on']['peak_gib']:.2f} GiB; "
        f"launches {counts}")
    return counts, out


def check_frozen_groups():
    """Phase 19(b): OPTION_UPDATES, ``OPTION_STEPS`` steps: conv1 and conv2
    keep their parameters by bits with zero momentum, every backbone
    BatchNorm buffer keeps its bits, everything else moves; the last step's
    update is the plain per-parameter SGD formula by bits; kernel 5 on the
    batch's painter inputs against its plain version."""
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.ops import targets

    t = time.perf_counter()
    op = OptionsPath(OPTION_UPDATES)
    model, opt = op.model, op.opt
    names = [n for n, _ in model.named_parameters()]
    start, _, _, _ = op.snapshot()
    torch.cuda.synchronize()
    kernels.reset_launches()
    for _ in range(OPTION_STEPS - 1):
        op.step()
    before, buffers, _, it = op.snapshot()
    grads = []
    logs = op.step(grads=grads)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    if counts["paint_orientation"] != OPTION_STEPS or sum(counts.values()) != OPTION_STEPS:
        raise AssertionError(f"expected {OPTION_STEPS} paint launches, got {counts}")
    if not torch.isfinite(logs["loss"]) or float(logs["skipped"]):
        raise AssertionError("a non-finite step")
    frozen_prefix = ("backbone.conv1.", "backbone.conv2.")
    mask = dict(zip(names, opt.freeze_mask))
    if [n for n in names if mask[n]] != [n for n in names if n.startswith(frozen_prefix)]:
        raise AssertionError("the freeze mask is not stages conv1 and conv2")
    moved = 0
    for k, v in model.state_dict().items():
        keep = k.startswith(frozen_prefix) or (k.startswith("backbone.") and k not in mask)
        if same_bits(v, start[k]) != keep:
            raise AssertionError(f"{k}: {'moved' if not keep else 'kept'} against expectation")
        moved += not keep
    for n, b in zip(names, opt.buffers):
        if bool(b.any()) == mask[n]:
            raise AssertionError(f"{n}: momentum {'non-zero' if mask[n] else 'all zero'}")
    lr32 = np.float32(op.sched(it))
    m = op.opt.momentum
    for i, n in enumerate(names):
        p0 = before[n]
        if mask[n]:
            continue
        d = grads[i] + opt.wd_factors[i] * p0
        buf = m * buffers[i] + d
        want = p0 - float(lr32 * np.float32(opt.lr_factors[i])) * buf
        if not same_bits(model.state_dict()[n], want) or not same_bits(opt.buffers[i], buf):
            raise AssertionError(f"{n}: the update is not the plain SGD formula's")
    n_factor = sum(f != 1.0 for f in opt.lr_factors)
    n_wd0 = sum(w == 0.0 for w in opt.wd_factors)

    b = op.batch
    calls = []
    with mock.patch.object(targets, "paint_orientation",
                           lambda geom, n_last, masks, *rest: calls.append(
                               (geom.clone(), n_last.clone(), masks.clone()))):
        op.loss._paint_shared_batch(b["bbox"], b["valid"], b["mask"])
    painter = op.loss.painter
    paint_err = check_paint_case("phase 19's batch", *calls[0], painter.pixel_anchors,
                                 (painter.image_h, painter.image_w))
    log(f"  {OPTION_STEPS} steps in {time.perf_counter() - t:.1f} s (set-up included): conv1, "
        f"conv2 kept by bits with zero momentum, every backbone BatchNorm buffer kept, "
        f"{moved} other tensors moved; step {OPTION_STEPS}'s update == the plain SGD formula "
        f"by bits ({n_factor} lr factors of 2, {n_wd0} zero weight decays); loss "
        f"{float(logs['loss']):.4f}; launches {counts}")
    return counts, paint_err


def check_options_cli(workdir, files_cfg):
    """Phase 19(c): the train CLI with OPTION_UPDATES and ``remat`` for one
    epoch of two steps (the first 16 of phase 17's scenes, no validation):
    its step was built with ``remat``, its optimizer holds the groups and
    the mask, and at the end conv1 and conv2 and every backbone BatchNorm
    buffer hold their initial bits."""
    from orienmask_tpu_torch import train as train_cli
    from orienmask_tpu_torch.config import construct_config
    from orienmask_tpu_torch.models import build_model, init_random
    from orienmask_tpu_torch.trainer import trainer as trainer_module

    list_file = Path(files_cfg["train_loader"]["dataset"]["list_file"])
    names = list_file.read_text().split()[:OPTIONS_CLI_IMAGES]
    short = workdir / "options_train.txt"
    short.write_text("\n".join(names) + "\n")
    cfg = construct_config(copy.deepcopy(files_cfg), update=dict(
        copy.deepcopy(OPTION_UPDATES), remat=True, epochs=1, val_freq=2,
        log_dir=str(workdir / "options_runs"),
        train_loader={"dataset": {"list_file": str(short)}}))
    cfg_file = workdir / "options_config.json"
    cfg_file.write_text(json.dumps(cfg))
    rec, patches = record_trainer()
    built = []
    text = io.StringIO()
    t = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        make = trainer_module.make_train_step  # record_trainer's, which times each step
        stack.enter_context(mock.patch.object(
            trainer_module, "make_train_step",
            lambda *a, **kw: built.append(kw) or make(*a, **kw)))
        stack.enter_context(contextlib.redirect_stdout(text))
        rc, _, _, counts, _ = record_run_batch(lambda: train_cli.main(["-c", str(cfg_file)]))
    seconds = time.perf_counter() - t
    steps = OPTIONS_CLI_IMAGES // cfg["train_loader"]["batch_size"]
    if rc != 0 or {k: v for k, v in counts.items() if v} != {"paint_orientation": steps}:
        raise AssertionError(f"train CLI with the options: rc {rc}, launches {counts}")
    if [kw.get("remat") for kw in built] != [True]:
        raise AssertionError(f"the train step was built with {built}")
    trainer = rec["trainer"]
    opt = trainer.optimizer
    if 2.0 not in opt.lr_factors or sum(opt.freeze_mask) == 0:
        raise AssertionError("the CLI's optimizer holds no groups or no mask")
    init = init_random(build_model(cfg["model"]), cfg["seed"]).state_dict()
    for k, v in trainer.model.state_dict().items():
        if k.startswith(("backbone.conv1.", "backbone.conv2.")) or (
                k.startswith("backbone.") and "running_" in k):
            if not same_bits(v.cpu(), init[k]):
                raise AssertionError(f"train CLI: {k} moved")
    losses = [e["train_loss"] for e in rec["epochs"]]
    if not np.isfinite(losses).all():
        raise AssertionError(f"train CLI losses {losses}")
    step_ms = [a.elapsed_time(b) for a, b in rec["events"]]
    log(f"  train CLI with {sorted(OPTION_UPDATES['model'])}, param_groups and remat: {steps} "
        f"steps in {seconds:.1f} s (build and loader start included), loss {losses[0]:.3f}, "
        f"steps {', '.join(f'{x:.1f}' for x in step_ms)} ms on the stream; frozen stages and "
        f"backbone BatchNorm buffers at their initial bits; launches {counts}")
    return counts, {"seconds": seconds, "step_ms": step_ms, "loss": losses[0]}


def check_train_options(workdir, files_cfg):
    """Phase 19: (a) remat, (b) frozen stages, BatchNorm eval and param
    groups, (c) the train CLI with all of them."""
    t = time.perf_counter()
    log(" (a) remat on against off")
    remat_counts, remat = check_remat()
    log(" (b) freeze_backbone 2, backbone_batchnorm_eval, param_groups")
    frozen_counts, paint_err = check_frozen_groups()
    log(" (c) the train CLI with those keys and remat")
    cli_counts, cli = check_options_cli(workdir, files_cfg)
    seconds = time.perf_counter() - t
    log(f"  phase 19 in {seconds:.1f} s; card: {card_line()}")
    counts = {"remat": remat_counts, "train_options": frozen_counts, "options_cli": cli_counts}
    return counts, paint_err, {"remat": remat, "options_cli": cli, "phase_s": seconds}


# ----------------------------------------------------------------- int8

INT8_CALIB = 8  # val scenes phase 20(c) calibrates on


def int8_conv_calls(pipe, image):
    """The int8 convolutions of one frame through ``pipe``: each distinct
    (input shape, kernel shape, stride, padding) once, with its tensors."""
    from orienmask_tpu_torch.ops import int8_conv

    calls = {}
    conv = int8_conv.conv2d_int8

    def recording(q, qkernel, stride=1, padding=0):
        key = (tuple(q.shape), tuple(qkernel.shape), stride, padding)
        calls.setdefault(key, (q.clone(), qkernel, stride, padding))
        return conv(q, qkernel, stride, padding)

    with mock.patch.object(int8_conv, "conv2d_int8", recording):
        pipe.run_device(image)
    torch.cuda.synchronize()
    return calls


def check_int8_convs(pipe, image):
    """Phase 20(a): every distinct quantized layer shape of a frame (stem
    included) through the card's route against the plain version on the
    same tensors, by bits."""
    from orienmask_tpu_torch.ops.int8_conv import conv2d_int8, conv2d_int8_plain

    calls = int8_conv_calls(pipe, image)
    biggest = 0
    for (q_shape, k_shape, stride, padding), (q, qk, _, _) in calls.items():
        got = conv2d_int8(q, qk, stride, padding)
        want = conv2d_int8_plain(q, qk, stride, padding)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"int8 conv {q_shape} x {k_shape} s{stride}: differs from "
                                 "its plain version")
        k = k_shape[1] * k_shape[2] * k_shape[3]
        biggest = max(biggest, got.shape[0] * got.shape[2] * got.shape[3] * (k + -k % 8))
    torch.cuda.synchronize()
    log(f"  {len(calls)} distinct int8 convolution shapes (conv1's K = 27 among them): the "
        f"card's im2col + torch._int_mm == the float64 plain version by bits; largest im2col "
        f"matrix {biggest / 2**20:.1f} MiB at B = {image.shape[0]}")
    return len(calls)


def profile_call(pipe, image, top=6):
    """One ``run_device`` call under torch.profiler: its CUDA kernels and
    copies, the ``torch._int_mm`` calls among the host's calls, its device
    time in ms and the ``top`` kernels by device time (name, ms, count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    pipe.run_device(image)
    torch.cuda.synchronize()
    int_mm = torch._int_mm
    n_int_mm = []
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof, \
            mock.patch.object(torch, "_int_mm",
                              lambda *a: n_int_mm.append(1) or int_mm(*a)):
        pipe.run_device(image)
        torch.cuda.synchronize()
    n_events = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    rows = sorted(((e.key[:70], e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                   if e.device_time_total > 0), key=lambda r: -r[1])
    return n_events, len(n_int_mm), sum(r[1] for r in rows), rows[:top]


def check_int8_path(image):
    """Phases 20(a) and (b): the 544² infer config at full width (seeded
    weights), bf16 and int8 (``quantize_int8`` calibrated on the seeded
    480x640 image, as bench.py calibrates on its image); the int8 path's
    launches of kernels 1 and 2 over 4 requests, its outputs, kernels 1 and
    2 against their plain versions on its heads; the int8 convolutions of
    a frame quantized with the stem against their plain version; the
    kernels and copies of a call and its device time by kernel
    (torch.profiler) at batch 1 and B = 16; e2e FPS at batch 1 and images/s
    at B = 16 of bf16, then of int8."""
    from orienmask_tpu_torch import kernels

    t = time.perf_counter()
    bf16, pp_kw = build_pipeline()
    int8, stem = copy.copy(bf16), copy.copy(bf16)  # one model; each its own folded weights
    int8.quantize_int8(image)
    stem.quantize_int8(image, stem=True)
    torch.cuda.synchronize()
    log(f"  bf16 pipeline built, int8 (and int8 with the stem) calibrated and quantized in "
        f"{time.perf_counter() - t:.1f} s")
    requests = 4
    counts, results, _, out = run_main_path(int8, image, requests)
    if counts["exact_topk"] != 2 * requests or counts["assemble_masks_packed"] != requests:
        raise AssertionError(f"int8 path launches {counts}")
    check_outputs(out, 1)
    plain = plain_postprocess(pp_kw)
    heads = int8.heads(image)
    got, want = int8.postprocess.apply_device(heads), plain.apply_device(heads)
    for key in got:
        if not torch.equal(got[key], want[key]):
            raise AssertionError(f"int8 path '{key}' differs from the plain-version postprocess")
    log(f"  int8 path: {requests} requests, launches {counts}; {int(out['valid'].sum())} valid "
        f"detections; postprocess on its heads == the plain versions'")
    n_shapes = check_int8_convs(stem, image)
    del stem

    batch = image.repeat(16, 1, 1, 1)
    profiles = {(name, b): profile_call(p, x) for name, p in (("bf16", bf16), ("int8", int8))
                for b, x in ((1, image), (16, batch))}
    launches = {name: profiles[(name, 1)][0] for name in ("bf16", "int8")}
    log(f"  CUDA kernels and copies a frame (torch.profiler): bf16 {launches['bf16']}, int8 "
        f"{launches['int8']} ({profiles[('int8', 1)][1]} torch._int_mm calls): int8 costs "
        f"{launches['int8'] - launches['bf16']} more")
    for (name, b), (_, _, device_ms, top) in profiles.items():
        log(f"  {name} B={b}: {device_ms:.3f} ms of device time a call; top kernels: "
            + "; ".join(f"{k} {ms:.3f} ms x{n}" for k, ms, n in top))
    timings = {}
    for name, p in (("bf16", bf16), ("int8", int8)):
        fps, windows = e2e_fps(p, image, frames=COMPARE_FRAMES)
        b16 = batched_rate(p, batch)
        timings[name] = {"e2e_fps": fps, "e2e_windows": windows,
                         "b16_images_per_s": b16["images_per_s"], "b16_windows": b16["windows"],
                         "launches_per_frame": launches[name],
                         "device_ms": {b: profiles[(name, b)][2] for b in (1, 16)}}
        log(f"  {name}: e2e {fps:.2f} FPS at batch 1 (median; windows "
            f"{', '.join(f'{x:.2f}' for x in windows)}); B = 16 {b16['images_per_s']:.2f} "
            f"images/s (windows {', '.join(f'{x:.2f}' for x in b16['windows'])})")
    timings["int_mm_per_frame"] = profiles[("int8", 1)][1]
    timings["int8_conv_shapes"] = n_shapes
    return counts, timings


def match_detections(a, b, n_a, n_b, strict=False):
    """Greedy matching of ``a``'s valid detections, in score order, to
    ``b``'s of the same class: with box IoU >= 0.5, or (``strict``) with
    every box coordinate within 2 pixels of 544; index pairs."""
    boxes_a, boxes_b = a["bbox"][:n_a, :4], b["bbox"][:n_b, :4]
    if strict:
        score = -np.abs(boxes_a[:, None] - boxes_b[None]).max(-1)
        cut = -2.0 / 544
    else:
        def xyxy(bx):
            return np.stack([bx[:, 0] - bx[:, 2] / 2, bx[:, 1] - bx[:, 3] / 2,
                             bx[:, 0] + bx[:, 2] / 2, bx[:, 1] + bx[:, 3] / 2], 1)

        pa, pb = xyxy(boxes_a), xyxy(boxes_b)
        lt = np.maximum(pa[:, None, :2], pb[None, :, :2])
        rb = np.minimum(pa[:, None, 2:], pb[None, :, 2:])
        inter = np.clip(rb - lt, 0, None).prod(-1)
        area = lambda p: (p[:, 2] - p[:, 0]) * (p[:, 3] - p[:, 1])  # noqa: E731
        score = inter / np.maximum(area(pa)[:, None] + area(pb)[None, :] - inter, 1e-12)
        cut = 0.5
    score[a["cls"][:n_a, None] != b["cls"][None, :n_b]] = -np.inf
    pairs, taken = [], set()
    for i in np.argsort(-a["bbox"][:n_a, 4], kind="stable"):
        for j in np.argsort(-score[i], kind="stable"):
            if score[i, j] < cut:
                break
            if j not in taken:
                pairs.append((i, j))
                taken.add(j)
                break
    return pairs


def mask_agreement(ma, mb):
    """(equal pixels, pixels, intersection, union) of packed mask pairs."""
    bits = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=ma.device)
    ua = (ma.unsqueeze(-1) & bits) != 0
    ub = (mb.unsqueeze(-1) & bits) != 0
    return (int((ua == ub).sum()), ua.numel(), int((ua & ub).sum()), int((ua | ub).sum()))


def check_int8_accuracy(workdir, files_cfg, best):
    """Phase 20(c): phase 17's best checkpoint in the 544² infer pipeline in
    f32, bf16 and int8 (bf16 between layers, calibrated on the first
    ``INT8_CALIB`` val scenes); the 32 val scenes through each, as the infer
    CLI's ``-j -o`` runs them (kernels 1, 2 and 6); detections and masks of
    bf16 and int8 against f32's, and each one's bbox and segm AP through the
    port's COCO evaluation."""
    import orienmask_tpu_torch.config as configs
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.data import FastCOCOTransform
    from orienmask_tpu_torch.data.dataset import COCODataset
    from orienmask_tpu_torch.data.image_io import read_image
    from orienmask_tpu_torch.eval import COCOMetrics
    from orienmask_tpu_torch.models import build_model
    from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
    from orienmask_tpu_torch.pipeline import InferencePipeline
    from orienmask_tpu_torch.trainer.checkpoint import load_checkpoint

    t = time.perf_counter()
    cfg = configs.orienmask_yolo_coco_544_anchor4_fpn_plus_infer
    gt_file = files_cfg["val_gt_file"]
    image_dir = files_cfg["val_loader"]["dataset"]["image_dir"]
    gt = json.loads(Path(gt_file).read_text())
    images = [torch.from_numpy(read_image(os.path.join(image_dir, im["file_name"])))
              for im in gt["images"]]
    infos = [{"height": im["height"], "width": im["width"], "id": im["id"]} for im in gt["images"]]
    model = build_model(cfg["model"])
    load_checkpoint(best, model)
    pp_kw = {k: v for k, v in cfg["postprocess"].items() if k != "type"}
    pipes = {}
    for name, dtype in (("f32", "float32"), ("bf16", "bfloat16"), ("int8", "bfloat16")):
        pipes[name] = InferencePipeline(
            model, FastCOCOTransform(cfg["transform"]["pipeline"]),
            OrienMaskYOLOPostProcess(**pp_kw, pack_masks=True, device="cuda"),
            compute_dtype=dtype, device="cuda")
    pipes["int8"].quantize_int8(images[:INT8_CALIB])
    outs, stats, counts = {}, {}, {}
    for name, pipe in pipes.items():
        metrics = COCOMetrics(gt_file=gt_file, cat2label=COCODataset.CAT2LABEL, with_mask=True,
                              save_dir=str(workdir))
        torch.cuda.synchronize()
        kernels.reset_launches()
        outs[name] = []
        for image, info in zip(images, infos):
            out = pipe.run_device(image[None].cuda())
            metrics.update_results(metrics.to_coco_format_device(
                [dict(info, collate_pad=pipe.pad_info)], out, pipe.postprocess.image_w))
            outs[name].append({k: v[0] for k, v in out.items()})
        torch.cuda.synchronize()
        counts[name] = dict(kernels.launches)
        with contextlib.redirect_stdout(io.StringIO()):
            metrics.coco_eval()
        stats[name] = {"bbox_AP": float(metrics.bbox_eval_stats[0]),
                       "bbox_AP50": float(metrics.bbox_eval_stats[1]),
                       "segm_AP": float(metrics.segm_eval_stats[0]),
                       "segm_AP50": float(metrics.segm_eval_stats[1])}
    n = len(images)
    for name, c in counts.items():
        # kernel 6 launches for an image that holds a valid detection; the
        # 3-epoch checkpoint differs by run and may leave an image with none
        held = sum(bool(o["valid"].any()) for o in outs[name])
        want = {"exact_topk": 2 * n, "assemble_masks_packed": n, "recover_masks": held}
        if {k: v for k, v in c.items() if v} != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{name}: launches {c}, expected {want}")
    agreement = {}
    for name in ("bf16", "int8"):
        matched = strict = total = same_count = 0
        eq = px = inter = union = 0
        for ref, got in zip(outs["f32"], outs[name]):
            host_ref = {k: v.cpu().numpy() for k, v in ref.items() if k != "mask"}
            host_got = {k: v.cpu().numpy() for k, v in got.items() if k != "mask"}
            n_ref, n_got = int(host_ref["valid"].sum()), int(host_got["valid"].sum())
            matched += len(match_detections(host_ref, host_got, n_ref, n_got))
            pairs = match_detections(host_ref, host_got, n_ref, n_got, strict=True)
            strict += len(pairs)
            total += max(n_ref, n_got)
            same_count += n_ref == n_got
            if pairs:
                i, j = (torch.tensor(x, device="cuda") for x in zip(*pairs))
                e, p, a, u = mask_agreement(ref["mask"][i], got["mask"][j])
                eq, px, inter, union = eq + e, px + p, inter + a, union + u
        agreement[name] = {"matched_share": matched / max(total, 1),
                           "same_box_share": strict / max(total, 1),
                           "images_with_equal_counts": same_count,
                           "mask_pixel_agreement": eq / max(px, 1),
                           "mask_iou": inter / max(union, 1)}
        a = agreement[name]
        log(f"  {name} against f32: {a['matched_share']:.4f} of the detections matched (same "
            f"class, box IoU >= 0.5), {a['same_box_share']:.4f} with the same box (to 2 px); "
            f"equal counts in {same_count} of {n} images; the same-box pairs' masks agree on "
            f"{a['mask_pixel_agreement']:.6f} of their pixels, IoU {a['mask_iou']:.6f}")
    for name in pipes:
        st = stats[name]
        log(f"  {name}: bbox AP {st['bbox_AP']:.4f} (AP50 {st['bbox_AP50']:.4f}), segm AP "
            f"{st['segm_AP']:.4f} (AP50 {st['segm_AP50']:.4f})")
    log(f"  {n} val scenes through each pipeline in {time.perf_counter() - t:.1f} s; launches "
        f"each {want}")
    return counts, {"agreement": agreement, "ap": stats}


def check_int8(workdir, files_cfg, best):
    """Phase 20: (a) and (b) on the seeded 480x640 image, (c) on phase 17's
    checkpoint and val scenes."""
    t = time.perf_counter()
    image = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (1, 480, 640, 3), dtype=np.uint8)).cuda()
    log(" (a, b) the int8 path at 544x544 against bf16")
    counts, timings = check_int8_path(image)
    log(" (c) accuracy on phase 17's checkpoint: f32, bf16, int8")
    acc_counts, accuracy = check_int8_accuracy(workdir, files_cfg, best)
    seconds = time.perf_counter() - t
    log(f"  phase 20 in {seconds:.1f} s; card: {card_line()}")
    counts = dict(int8=counts, **{f"accuracy_{k}": v for k, v in acc_counts.items()})
    return counts, dict(timings, **accuracy, phase_s=seconds)


# -------------------------------------------------------------- serving

SERVING_SHAPES = ((1, 480, 640, 3), (8, 480, 640, 3))
SERVING_WINDOWS = 3  # e2e_fps windows a turn; turns: live, served, served, live
SERVING_DEADLINE_S = 300


def serve_artifacts(spec_path, out_path):
    """Phase 21's (and 24's) serving host, run in a fresh process with
    ``orienmask_tpu_torch.models`` unimportable: load each artifact of the
    spec on its job's device (the card unless ``device`` says), run each of
    its images once with the launch counts read around the call, and write
    the outputs (``<dir>/served_<name>_<B>.npz``), the
    counts and the load seconds to ``out_path``."""
    torch.backends.cudnn.allow_tf32 = False  # as main() sets them
    torch.backends.cuda.matmul.allow_tf32 = False
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.serving import load_serving

    spec = json.loads(Path(spec_path).read_text())
    result = {}
    for name, job in spec.items():
        device = job.get("device", "cuda")
        t = time.perf_counter()
        served = load_serving(job["dir"], device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        calls = {}
        for image_path in job["images"]:
            image = torch.from_numpy(np.load(image_path)).to(device)
            torch.cuda.synchronize()
            kernels.reset_launches()
            out = served.run_device(image)
            torch.cuda.synchronize()
            counts = dict(kernels.launches)
            b = image.shape[0]
            path = Path(spec_path).parent / f"served_{name}_{b}.npz"
            np.savez(path, **{k: v.cpu().numpy() for k, v in out.items()})
            calls[b] = {"launches": counts, "outputs": str(path)}
        result[name] = {"load_s": load_s, "calls": calls}
    loaded = [m for m, v in sys.modules.items() if v is not None]
    result["model_modules"] = [m for m in loaded if m.startswith("orienmask_tpu_torch.models")]
    Path(out_path).write_text(json.dumps(result))


def start_serving_host(spec_path, out_path):
    """``serve_artifacts`` in a fresh Python process that cannot import
    ``orienmask_tpu_torch.models``, started in the background; its handle
    for ``finish_serving_host``."""
    code = ("import sys\n"
            "sys.modules['orienmask_tpu_torch.models'] = None\n"
            "import chip_smoke\n"
            "chip_smoke.serve_artifacts(sys.argv[1], sys.argv[2])\n")
    log_path = Path(out_path).with_suffix(".log")
    with open(log_path, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-c", code, str(spec_path), str(out_path)],
                                cwd=Path(__file__).resolve().parent, stdout=fh,
                                stderr=subprocess.STDOUT)
    return proc, Path(out_path), log_path, time.perf_counter()


def finish_serving_host(host):
    """Wait for a serving host (killing it past ``SERVING_DEADLINE_S``);
    its result, or raise with its output."""
    proc, out_path, log_path, t0 = host
    try:
        proc.wait(timeout=max(1.0, SERVING_DEADLINE_S - (time.perf_counter() - t0)))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise AssertionError(f"the serving host failed ({proc.returncode}):\n"
                             f"{log_path.read_text()[-6000:]}")
    result = json.loads(out_path.read_text())
    result["process_s"] = time.perf_counter() - t0
    return result


def artifact_bytes(out_dir):
    return {p.name: p.stat().st_size for p in sorted(Path(out_dir).iterdir())}


def check_serving():
    """Phase 21: the 544² infer config's bf16 pipeline exported for
    ``SERVING_SHAPES`` and its int8 pipeline (calibrated as phase 20
    calibrates) for batch 1, into a temporary directory outside the
    repository; each artifact served in a fresh process without the model
    code, its outputs bit-identical to the live ``run_device``'s, kernels 1
    and 2 launched 2 and 1 times a served call; then served against live
    e2e FPS at batch 1, in turns."""
    from orienmask_tpu_torch.serving import export_pipeline, load_serving

    t0 = time.perf_counter()
    bf16, _ = build_pipeline()
    int8 = copy.copy(bf16)  # one model; each its own folded weights
    batch = np.random.default_rng(SEED).integers(
        0, 256, (max(s[0] for s in SERVING_SHAPES), 480, 640, 3), dtype=np.uint8)
    images = {s[0]: batch[:s[0]] for s in SERVING_SHAPES}  # image 0: phases 4 and 20's
    int8.quantize_int8(torch.from_numpy(images[1]).cuda())
    pipes = {"bf16": (bf16, SERVING_SHAPES), "int8": (int8, SERVING_SHAPES[:1])}
    res = {"export_s": {}, "bytes": {}, "load_s": {}, "host_process_s": {}}
    counts = {}
    hosts = {}
    with tempfile.TemporaryDirectory() as workdir:
        work = Path(workdir)
        try:
            # each artifact's host starts as soon as it is written: it loads
            # while the next one exports
            for name, (pipe, shapes) in pipes.items():
                out_dir = work / name
                t = time.perf_counter()
                manifest = export_pipeline(pipe, shapes, out_dir)
                res["export_s"][name] = time.perf_counter() - t
                res["bytes"][name] = artifact_bytes(out_dir)
                log(f"  {name}: exported {len(manifest['programs'])} program(s) and "
                    f"{manifest['n_weights']} weights in {res['export_s'][name]:.1f} s; bytes "
                    f"{res['bytes'][name]}")
                paths = []
                for b in (s[0] for s in shapes):
                    paths.append(str(work / f"image_{b}.npy"))
                    np.save(paths[-1], images[b])
                spec = work / f"spec_{name}.json"
                spec.write_text(json.dumps({name: {"dir": str(out_dir), "images": paths}}))
                hosts[name] = start_serving_host(spec, work / f"served_{name}.json")
            served_by = {name: finish_serving_host(host) for name, host in hosts.items()}
        finally:
            for proc, *_ in hosts.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for name, (pipe, shapes) in pipes.items():
            host = served_by[name]
            if host["model_modules"]:
                raise AssertionError(f"the serving host loaded model code: "
                                     f"{host['model_modules']}")
            res["load_s"][name] = host[name]["load_s"]
            res["host_process_s"][name] = host["process_s"]
            log(f"  {name}: served in a fresh process without orienmask_tpu_torch.models, "
                f"{host['process_s']:.1f} s in all, the artifact loaded in "
                f"{host[name]['load_s']:.2f} s")
            counts[name] = {"exact_topk": 0, "assemble_masks_packed": 0}
            for b, call in host[name]["calls"].items():
                launched = call["launches"]
                if launched["exact_topk"] != 2 or launched["assemble_masks_packed"] != 1 \
                        or sum(launched.values()) != 3:
                    raise AssertionError(f"{name} B={b}: a served call launched {launched}")
                for k in counts[name]:
                    counts[name][k] += launched[k]
                got = dict(np.load(call["outputs"]))
                want = pipe.run_device(torch.from_numpy(images[int(b)]).cuda())
                torch.cuda.synchronize()
                check_outputs(want, int(b))
                for key in want:
                    if not np.array_equal(got[key], want[key].cpu().numpy()) \
                            or got[key].dtype != want[key].cpu().numpy().dtype:
                        raise AssertionError(f"{name} B={b}: served '{key}' differs from the "
                                             "live run_device")
                log(f"  {name} B={b}: served == live by bits ({int(want['valid'].sum())} valid "
                    f"detections); kernel 1 x2, kernel 2 x1 a served call")

        served = load_serving(work / "bf16")
        image = torch.from_numpy(images[1]).cuda()
        turns = []
        for name, p in (("live", bf16), ("served", served), ("served", served), ("live", bf16)):
            fps, windows = e2e_fps(p, image, SERVING_WINDOWS, COMPARE_FRAMES)
            turns.append({"run": name, "fps": fps, "windows": windows})
            log(f"  {name}: e2e {fps:.2f} FPS at batch 1 (median of {SERVING_WINDOWS} windows "
                f"of {COMPARE_FRAMES} frames: {', '.join(f'{x:.2f}' for x in windows)})")
        del served
    res["fps_turns"] = turns
    res["phase_s"] = time.perf_counter() - t0
    log(f"  phase 21 in {res['phase_s']:.1f} s; card: {card_line()}")
    return {"serving": counts["bf16"], "serving_int8": counts["int8"]}, res


# ------------------------------------------------------ spatial partitioning

SPACE_RANKS = 2
SPACE_DEADLINE_S = 420
SPACE_FRAMES = 10  # timed frames a pipeline, after 3 warm-ups
SPACE_STEP_IMAGES = 2  # the equivalence step's B (phase 7's first images)
SPACE_WORKERS = 1  # loader workers a rank in the train CLI
SPACE_CLI_IMAGES = 4
SPACE_VIDEO_FRAMES = 6
# spatial f32 heads against one process's (TF32 off): the same convolutions
# on row shards with their halos, where cuDNN may take another algorithm
SPACE_F32_RTOL = 1e-4
# resnet50 on the card (f32, TF32 off) against its CPU forward
RESNET_RTOL = 1e-4


def infer_pp_kw():
    import orienmask_tpu_torch.config as configs

    cfg = configs.orienmask_yolo_coco_544_anchor4_fpn_plus_infer
    return {k: v for k, v in cfg["postprocess"].items() if k != "type"}


def space_pipeline(space, compute_dtype):
    """The 544² infer config's pipeline (phase 4's seeded weights) in
    ``compute_dtype`` on this rank's card, under ``space`` (None: one
    device)."""
    import orienmask_tpu_torch.config as configs
    from orienmask_tpu_torch.data import FastCOCOTransform
    from orienmask_tpu_torch.models import build_model, init_random
    from orienmask_tpu_torch.ops import OrienMaskYOLOPostProcess
    from orienmask_tpu_torch.pipeline import InferencePipeline

    cfg = configs.orienmask_yolo_coco_544_anchor4_fpn_plus_infer
    device = torch.device("cuda", torch.cuda.current_device())
    pp_kw = infer_pp_kw()
    return InferencePipeline(init_random(build_model(cfg["model"]), SEED),
                             FastCOCOTransform(cfg["transform"]["pipeline"]),
                             OrienMaskYOLOPostProcess(**pp_kw, pack_masks=True, device=device),
                             compute_dtype=compute_dtype, device=device, space=space)


def space_image():
    return torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (1, 480, 640, 3), dtype=np.uint8)).cuda()


def frame_ms(pipe, image, n=SPACE_FRAMES):
    """Host ms a frame of ``run_device`` over ``n`` frames after 3 warm-ups,
    one synchronize at the end."""
    for _ in range(3):
        pipe.run_device(image)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        pipe.run_device(image)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def count_exchanges(pipe, image):
    """One frame with every ``all_gather`` timed on the stream (CUDA events
    around it) and the halo exchanges counted: (halos, other gathers,
    halo bytes sent by this rank, ms in all gathers)."""
    import torch.distributed as dist

    from orienmask_tpu_torch.parallel import spatial

    gather, halo = dist.all_gather, spatial.SpaceGroup.halo
    rec = {"events": [], "halos": 0, "halo_bytes": 0}

    def timed_gather(*args, **kw):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        events[0].record()
        out = gather(*args, **kw)
        events[1].record()
        rec["events"].append(events)
        return out

    def counting_halo(space, x, up, down, fill=0.0):
        if max(up, 0) or max(down, 0):
            rec["halos"] += 1
            rec["halo_bytes"] += x.shape[0] * x.shape[1] * x.shape[3] * x.element_size() \
                * (max(up, 0) + max(down, 0))
        return halo(space, x, up, down, fill)

    with mock.patch.object(dist, "all_gather", timed_gather), \
            mock.patch.object(spatial.SpaceGroup, "halo", counting_halo):
        pipe.run_device(image)
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in rec["events"])
    return rec["halos"], len(rec["events"]) - rec["halos"], rec["halo_bytes"], ms


def space_rank(rank, workdir, ports):
    """One rank of phase 22, spawned (two ranks on the one card, gloo with
    CUDA tensors): (a) the 544² pipeline in f32 and bf16 under
    ``spatial_groups(2)``, launches, halo exchanges and ms a frame; (b)
    ``run_batch_spatial`` on the one-process heads, with the kernels and
    with their plain versions; (d) the int8 pipeline; (e) the spatial train
    step on phase 7's first images, then the train CLI with ``n_space=2``.
    Writes ``space_rank<rank>.json`` and rank 0 its tensors to
    ``workdir``."""
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch import train as train_cli
    from orienmask_tpu_torch.eval import COCOMetrics
    from orienmask_tpu_torch.ops.masks import assemble_masks_packed_plain
    from orienmask_tpu_torch.parallel import spatial
    from orienmask_tpu_torch.parallel.mesh import destroy_distributed, init_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    workdir = Path(workdir)
    out, tensors = {"rank": rank}, {}
    t0 = time.perf_counter()

    def done(what):
        if rank == 0:
            log(f"  rank 0: {what} done at {time.perf_counter() - t0:.1f} s")

    init_distributed(f"localhost:{ports[0]}", SPACE_RANKS, rank, "cuda")
    try:
        space = spatial.spatial_groups(SPACE_RANKS)
        image = space_image()
        # (a) f32 heads; bf16 outputs with launches, exchanges and ms a frame
        pipe = space_pipeline(space, "float32")
        tensors["heads_f32"] = [tuple(t.cpu() for t in pair) for pair in pipe.heads(image)]
        out["f32_ms"] = frame_ms(pipe, image)
        del pipe
        pipe = space_pipeline(space, "bfloat16")
        torch.cuda.synchronize()
        kernels.reset_launches()
        for _ in range(4):
            bf16 = pipe.run_device(image)
        torch.cuda.synchronize()
        out["infer_counts"] = dict(kernels.launches)
        tensors["bf16"] = {k: v.cpu() for k, v in bf16.items()}
        out["halos"], out["other_gathers"], out["halo_bytes"], out["gather_ms"] = \
            count_exchanges(pipe, image)
        out["bf16_ms"] = frame_ms(pipe, image)
        pp = pipe.postprocess
        done("(a)")

        # (b) run_batch_spatial on the one-process heads: kernels and plain
        heads = [tuple(t.cuda() for t in pair) for pair in torch.load(workdir / "one_heads.pt")]
        torch.cuda.synchronize()
        kernels.reset_launches()
        with torch.inference_mode():
            got = spatial.run_batch_spatial(pp, space, heads)
        torch.cuda.synchronize()
        out["run_batch_counts"] = dict(kernels.launches)
        tensors["run_batch"] = {k: v.cpu() for k, v in got.items()}
        plain = plain_postprocess(infer_pp_kw())
        with torch.inference_mode():
            want = spatial.run_batch_spatial(plain, space, heads)
            shard_h = pp.image_h // SPACE_RANKS
            row0 = space.space_index * shard_h
            det = pp._detect([p[0] for p in heads])
            field = pp._upsample_orientation([p[1] for p in heads], rows=(row0, shard_h))
            block = pp._assemble_masks(field, det["bbox"][..., :4].contiguous(), det["anchor"],
                                       det["valid"], coord_h=pp.image_h, row0=row0)
            block_plain = assemble_masks_packed_plain(
                field, det["bbox"][..., :4].contiguous(), det["anchor"], pp.norm_anchors,
                pp.orien_thresh, coord_h=pp.image_h, row0=row0, valid=det["valid"])
        out["plain_equal"] = all(torch.equal(got[k], want[k]) for k in got)
        out["block_equal"] = torch.equal(block, block_plain)
        out["row0"], out["block_words"] = row0, int(block.numel())
        del pipe
        done("(b)")

        # (d) int8 under the space group, calibrated on the frame
        pipe = space_pipeline(space, "bfloat16").quantize_int8(image)
        torch.cuda.synchronize()
        kernels.reset_launches()
        int8 = pipe.run_device(image)
        torch.cuda.synchronize()
        out["int8_counts"] = dict(kernels.launches)
        tensors["int8_heads"] = [tuple(t.cpu() for t in pair) for pair in pipe.heads(image)]
        tensors["int8"] = {k: v.cpu() for k, v in int8.items()}
        out["int8_ms"] = frame_ms(pipe, image)
        del pipe
        done("(d)")

        # (e) the spatial train step
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        logs, momentum, out["step_digest"], _, _ = dp_step(space=space,
                                                           n_images=SPACE_STEP_IMAGES)
        torch.cuda.synchronize()
        out["step_counts"] = dict(kernels.launches)
        out["step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        tensors["step"] = (logs, momentum)
        done("(e) the step")
    finally:
        destroy_distributed()
    if rank == 0:
        torch.save(tensors, workdir / "space_tensors.pt")
    del tensors

    # (e) the train CLI with n_space=2
    flags = ["--coordinator", f"localhost:{ports[1]}", "--num-processes", str(SPACE_RANKS),
             "--process-id", str(rank)]
    rec, patches = record_trainer()
    merges = []
    merge = COCOMetrics.merge_ranks

    def recording_merge(metrics, directory):
        own = len(metrics.bbox_results)
        merge(metrics, directory)
        merges.append([own, len(metrics.bbox_results)])

    text = io.StringIO()
    t = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for p in [*patches, mock.patch.object(COCOMetrics, "merge_ranks", recording_merge)]:
            stack.enter_context(p)
        stack.enter_context(contextlib.redirect_stdout(text))
        rc, _, _, out["cli_counts"], _ = record_run_batch(lambda: train_cli.main(
            ["-c", str(workdir / "train_config.json"), *flags]))
    out["cli_s"] = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"rank {rank}: train.main returned {rc}")
    trainer = rec["trainer"]
    out.update(digest=state_digest(trainer.model, trainer.optimizer), merges=merges,
               epochs=rec["epochs"], step_ms=[a.elapsed_time(b) for a, b in rec["events"]],
               parallel_line=[ln for ln in text.getvalue().splitlines() if "[parallel]" in ln])
    (workdir / f"space_rank{rank}.json").write_text(json.dumps(out))


def check_resnet():
    """(f) resnet50 at 544² (torch's seeded default init, eval mode, f32)
    on the card against its CPU forward: each level's largest difference
    over its largest value, and its ms a forward."""
    from orienmask_tpu_torch.models import resnet50

    torch.manual_seed(SEED)
    model = resnet50().eval()
    x = torch.from_numpy(np.random.default_rng(SEED + 22).standard_normal(
        (1, 3, 544, 544)).astype(np.float32))
    with torch.no_grad():
        want = model(x)
        model.cuda()
        got = model(x.cuda())
        errs = [float((g.cpu().double() - w.double()).abs().max() / w.double().abs().max())
                for g, w in zip(got, want)]
        for _ in range(3):
            model(x.cuda())
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            model(x.cuda())
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / 10 * 1e3
    shapes = [tuple(g.shape) for g in got]
    if max(errs) > RESNET_RTOL or not all(torch.isfinite(g).all() for g in got):
        raise AssertionError(f"resnet50 on the card differs from its CPU forward: {errs}")
    return {"rel_err": errs, "shapes": shapes, "ms": ms}


def check_spatial(workdir):
    """Phase 22: spatial partitioning as two ranks on the one card (gloo
    with CUDA tensors), against one process: (a) the 544² forward in f32 and
    bf16's detections, (b) ``run_batch_spatial`` by bits, (c) the infer CLI
    with ``--spatial 2`` at 544² and over the 736² ``--video`` config, (d)
    int8, (e) the train step and the train CLI with ``n_space=2``, (f)
    resnet50 on the card against its CPU forward."""
    from orienmask_tpu_torch.data.image_io import write_png

    t0 = time.perf_counter()
    # one process: f32 heads, bf16 outputs, int8 heads, ms a frame
    image = space_image()
    pipe = space_pipeline(None, "float32")
    one_heads = pipe.heads(image)
    torch.save([tuple(t.cpu() for t in pair) for pair in one_heads], workdir / "one_heads.pt")
    with torch.inference_mode():
        one_run_batch = pipe.postprocess._run_batch(one_heads)
    one_f32_ms = frame_ms(pipe, image)
    del pipe
    pipe = space_pipeline(None, "bfloat16")
    one_bf16 = pipe.run_device(image)
    one_bf16_ms = frame_ms(pipe, image)
    pipe.quantize_int8(image)
    one_int8_heads, one_int8 = pipe.heads(image), pipe.run_device(image)
    one_int8_ms = frame_ms(pipe, image)
    del pipe
    cfg, _, _, write_s = files_configs(
        workdir, n_device=SPACE_RANKS, epochs=1, n_space=SPACE_RANKS,
        train_loader={"num_workers": SPACE_WORKERS}, val_loader={"num_workers": SPACE_WORKERS})
    log(f"  one process set up in {time.perf_counter() - t0:.2f} s (f32, bf16 and int8 "
        f"pipelines; the train CLI's {FILES_IMAGES} scenes written in {write_s:.2f} s)")
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    run_ranks(space_rank, (str(workdir), free_ports(2)), SPACE_DEADLINE_S)
    ranks_s = time.perf_counter() - t
    ranks = [json.loads((workdir / f"space_rank{r}.json").read_text())
             for r in range(SPACE_RANKS)]
    tensors = torch.load(workdir / "space_tensors.pt")
    r0 = ranks[0]
    log(f"  ranks: {r0['parallel_line']}; spawned and run in {ranks_s:.2f} s")

    # (a) the forward
    errs = []
    for got_pair, want_pair in zip(tensors["heads_f32"], one_heads):
        for got, want in zip(got_pair, want_pair):
            want = want.cpu().double()
            errs.append(float((got.double() - want).abs().max() / want.abs().max()))
    if max(errs) > SPACE_F32_RTOL:
        raise AssertionError(f"(a) spatial f32 heads differ from one process's: {errs}")
    bf16 = tensors["bf16"]
    check_outputs({k: v.cuda() for k, v in bf16.items()}, 1)
    one_bf16 = {k: v.cpu().numpy() for k, v in one_bf16.items()}
    n_valid = int(one_bf16["valid"].sum())
    matched = len(match_detections({k: v.numpy()[0] for k, v in bf16.items()},
                                    {k: v[0] for k, v in one_bf16.items()},
                                    int(bf16["valid"].sum()), n_valid))
    want_infer = {"exact_topk": 8, "assemble_masks_packed": 4}
    for r in ranks:
        got = {k: v for k, v in r["infer_counts"].items() if v}
        if got != want_infer:
            raise AssertionError(f"rank {r['rank']}: 4 bf16 frames launched {got}, expected "
                                 f"{want_infer}")
    log(f"  (a) 544², B = 1: f32 heads (TF32 off) against one process's: largest difference "
        f"{max(errs):.3e} of the largest value (limit {SPACE_F32_RTOL:g}); bf16: {n_valid} "
        f"valid detections, {matched} of them matched to one process's; launches a rank over "
        f"4 frames {want_infer}")
    for r in ranks:
        log(f"  rank {r['rank']}: a frame exchanges {r['halos']} halos ({r['halo_bytes']} bytes "
            f"sent, bf16) and {r['other_gathers']} other gathers (heads, masks), "
            f"{r['gather_ms']:.2f} ms in all gathers on the stream; ms a frame: f32 "
            f"{r['f32_ms']:.2f}, bf16 {r['bf16_ms']:.2f}, int8 {r['int8_ms']:.2f} (one process "
            f"{one_f32_ms:.2f}, {one_bf16_ms:.2f}, {one_int8_ms:.2f})")

    # (b) run_batch_spatial against _run_batch
    for key, want in one_run_batch.items():
        if not torch.equal(tensors["run_batch"][key], want.cpu()):
            raise AssertionError(f"(b) run_batch_spatial's {key} differs from _run_batch's")
    want_pp = {"exact_topk": 2, "assemble_masks_packed": 1}
    for r in ranks:
        got = {k: v for k, v in r["run_batch_counts"].items() if v}
        if got != want_pp or not r["plain_equal"] or not r["block_equal"]:
            raise AssertionError(f"(b) rank {r['rank']}: launches {got} (expected {want_pp}), "
                                 f"plain versions equal {r['plain_equal']}, kernel 2's row "
                                 f"block at row0 {r['row0']} equal to its plain version "
                                 f"{r['block_equal']}")
    log(f"  (b) run_batch_spatial on the one-process f32 heads equals _run_batch by bits "
        f"({int(one_run_batch['valid'].sum())} valid detections); each rank: kernel 1 twice, "
        f"kernel 2 once at row0 {[r['row0'] for r in ranks]}, coord_h 544, each block equal "
        f"to its plain version ({r0['block_words']} bytes), the whole route equal to the plain "
        f"versions' by bits")

    # (d) int8
    int8_errs = []
    for got_pair, want_pair in zip(tensors["int8_heads"], one_int8_heads):
        for got, want in zip(got_pair, want_pair):
            want = want.cpu().double()
            int8_errs.append(float((got.double() - want).abs().max() / want.abs().max()))
    int8 = tensors["int8"]
    check_outputs({k: v.cuda() for k, v in int8.items()}, 1)
    one_int8 = {k: v.cpu().numpy()[0] for k, v in one_int8.items()}
    int8_matched = len(match_detections({k: v.numpy()[0] for k, v in int8.items()}, one_int8,
                                        int(int8["valid"].sum()),
                                        int(one_int8["valid"].sum())))
    for r in ranks:
        got = {k: v for k, v in r["int8_counts"].items() if v}
        if got != {"exact_topk": 2, "assemble_masks_packed": 1}:
            raise AssertionError(f"(d) rank {r['rank']}: an int8 frame launched {got}")
    log(f"  (d) int8 under the space group: heads against one process's int8 heads, largest "
        f"difference {max(int8_errs):.3e} of the largest value; {int8_matched} of "
        f"{int(one_int8['valid'].sum())} detections matched")

    # (e) the spatial train step against one process, then the train CLI
    if len({r["step_digest"] for r in ranks}) != 1:
        raise AssertionError("(e) the ranks' states differ after the spatial step")
    logs, momentum = tensors["step"]
    one = dp_step(n_images=SPACE_STEP_IMAGES)
    step_err = compare_steps(f"spatial 2 ranks x {SPACE_STEP_IMAGES} rows vs one process",
                             (logs, momentum, None, None, None), one)
    for r in ranks:
        if r["step_counts"].get("paint_orientation") != 1:
            raise AssertionError(f"(e) rank {r['rank']}: the step launched {r['step_counts']}")
    log(f"  (e) train step, full width, 544², B = {SPACE_STEP_IMAGES}, f32: loss "
        f"{logs['loss']:.4f} (one process {one[0]['loss']:.4f}); against one process "
        f"{step_err}; the ranks equal by bits; kernel 5 once a rank; peak "
        f"{[round(r['step_peak_gib'], 2) for r in ranks]} GiB")
    del one
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError("(e) the ranks end the train CLI with different states")
    losses = [e["train_loss"] for e in r0["epochs"]]
    if [e["train_loss"] for e in ranks[1]["epochs"]] != losses or not np.isfinite(losses).all():
        raise AssertionError(f"(e) train CLI losses {[r['epochs'] for r in ranks]}")
    if [m[0] for m in ranks[1]["merges"]] != [0] or r0["merges"][0][0] != r0["merges"][0][1]:
        raise AssertionError(f"(e) COCO merges {[r['merges'] for r in ranks]}: space rank 1 "
                             "must add nothing")
    bs = cfg["train_loader"]["batch_size"]
    steps = FILES_IMAGES // bs
    val_batches = -(-FILES_IMAGES // cfg["val_loader"]["batch_size"])
    want_cli = [{"paint_orientation": steps + val_batches, "exact_topk": 2 * val_batches,
                 "assemble_masks_packed": val_batches, "recover_masks": val_batches},
                {"paint_orientation": steps + val_batches}]
    for r, want in zip(ranks, want_cli):
        got = {k: v for k, v in r["cli_counts"].items() if v}
        if got != want:
            raise AssertionError(f"(e) rank {r['rank']}: train CLI launched {got}, expected {want}")
    log(f"  (e) train CLI, n_space=2, n_device=2, B = {bs} (one data index): {steps} steps, "
        f"epoch loss {losses[0]:.3f}, val loss {r0['epochs'][0]['val_loss']:.3f}, the ranks "
        f"equal by bits; rank 0 scored {r0['merges'][0][1]} COCO results, rank 1 added 0; "
        f"launches {[r['cli_counts'] for r in ranks]}; a step "
        f"{[round(float(np.median(r['step_ms'])), 1) for r in ranks]} ms on the stream "
        f"(median), the CLI {[round(r['cli_s'], 1) for r in ranks]} s")

    # (c) the infer CLI with --spatial 2
    images, images_json = write_cli_inputs(workdir, SPACE_CLI_IMAGES)
    frames = workdir / "space_frames"
    frames.mkdir()
    rng = np.random.default_rng(SEED + 22)
    for i in range(SPACE_VIDEO_FRAMES):
        write_png(frames / f"frame_{i:04d}.png", rng.integers(0, 256, (720, 1280, 3), np.uint8))
    cli = {}
    for tag, argv in (
            ("images", ["-c", "orienmask_yolo_coco_544_anchor4_fpn_plus_infer", "-d",
                        str(images), "-j", str(images_json), "-o", str(workdir / "space_cli")]),
            ("video", ["-c", "orienmask_yolo_coco_736_anchor4_fpn_plus_infer", "--video",
                       str(frames)])):
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "orienmask_tpu_torch.infer",
                               "--random-weights", "--spatial", str(SPACE_RANKS), *argv],
                              capture_output=True, text=True, timeout=SPACE_DEADLINE_S)
        if proc.returncode != 0:
            raise AssertionError(f"(c) infer --spatial {SPACE_RANKS} ({tag}) exited "
                                 f"{proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        cli[tag] = {"s": time.perf_counter() - t, "report": [
            ln for ln in proc.stdout.splitlines() if "average" in ln or "Streamed" in ln]}
    dumped = json.loads((workdir / "space_cli" / "bbox_prediction.json").read_text())
    if len(dumped) != 100 * SPACE_CLI_IMAGES or \
            sorted({d["image_id"] for d in dumped}) != list(range(1, SPACE_CLI_IMAGES + 1)):
        raise AssertionError(f"(c) the -j dump holds {len(dumped)} entries")
    if not any(f"Streamed {SPACE_VIDEO_FRAMES} frames" in ln for ln in cli["video"]["report"]):
        raise AssertionError(f"(c) --video report {cli['video']['report']}")
    log(f"  (c) infer --spatial 2: {SPACE_CLI_IMAGES} PNGs at 544² -j -o in "
        f"{cli['images']['s']:.1f} s ({len(dumped)} detections dumped; "
        f"{'; '.join(cli['images']['report'])}); {SPACE_VIDEO_FRAMES} 720x1280 frames through "
        f"the 736² --video config in {cli['video']['s']:.1f} s "
        f"({'; '.join(cli['video']['report'])})")

    # (f) resnet50
    resnet = check_resnet()
    log(f"  (f) resnet50 at 544² on the card against its CPU forward: {resnet['shapes']}, "
        f"largest differences {[f'{e:.2e}' for e in resnet['rel_err']]} of each level's "
        f"largest value (limit {RESNET_RTOL:g}); {resnet['ms']:.2f} ms a forward (f32)")

    timings = {
        "frame_ms": {"spatial": {k: [r[f"{k}_ms"] for r in ranks]
                                 for k in ("f32", "bf16", "int8")},
                     "one_process": {"f32": one_f32_ms, "bf16": one_bf16_ms,
                                     "int8": one_int8_ms}},
        "halos_a_frame": r0["halos"], "other_gathers_a_frame": r0["other_gathers"],
        "halo_bytes_a_frame": [r["halo_bytes"] for r in ranks],
        "gather_ms_a_frame": [r["gather_ms"] for r in ranks],
        "f32_head_rel_err": max(errs), "bf16_matched": [matched, n_valid],
        "int8_head_rel_err": max(int8_errs), "step": step_err,
        "step_ms_median": [float(np.median(r["step_ms"])) for r in ranks],
        "cli_s": {k: v["s"] for k, v in cli.items()}, "resnet50": resnet,
        "phase_s": time.perf_counter() - t0}
    log(f"  phase 22 in {timings['phase_s']:.1f} s; card: {card_line()}")
    counts = {"spatial": {k: sum(r["infer_counts"][k] + r["run_batch_counts"][k]
                                 for r in ranks) for k in want_infer},
              "spatial_int8": {k: sum(r["int8_counts"][k] for r in ranks) for k in want_infer},
              "spatial_train": {"paint_orientation": sum(r["step_counts"]["paint_orientation"]
                                                         for r in ranks)},
              "spatial_train_cli": {k: sum(r["cli_counts"][k] for r in ranks)
                                    for k in want_cli[0]}}
    return counts, timings


# ------------------------------------------------------------------- main

# ---------------------------------------------------- image files (phase 23)

IMAGE_FIXTURES = Path(__file__).resolve().parent / "tests" / "image_fixtures"
# the encoded sizes and qualities (b) holds the native coder to the plain one at:
# none a whole number of 16x16 MCUs, and grey
CODER_SIZES = ((1, 1), (7, 9), (17, 33), (9, 40), (31, 17), (23, 57))
CODER_QUALITIES = (75, 95, 98)
CODEC_REPEATS = 5
RESIZE_IMAGES = 8  # one B = 8 train step an interpolation


def image_files_inputs(workdir):
    """Phase 23 (a)'s directory: the committed RLE8 BMP, PackBits TIFF and
    tiled Deflate TIFF, and a JPEG, a PNG, a 24-bit BMP and an LZW TIFF with
    the predictor written by the port's writers from those fixtures' pixels."""
    from orienmask_tpu_torch.data.image_io import read_image, write_image

    images = workdir / "image_files"
    images.mkdir()
    sources = {}
    for name, fixture in (("d_rle8.bmp", "rle8.bmp"), ("f_packbits.tif", "packbits.tif"),
                          ("g_tiled_deflate.tif", "tiled_deflate.tif")):
        (images / name).write_bytes((IMAGE_FIXTURES / fixture).read_bytes())
        sources[fixture] = read_image(IMAGE_FIXTURES / fixture)
    for name, pixels in (("a_writer.jpg", sources["rle8.bmp"]),
                         ("b_writer.png", sources["packbits.tif"]),
                         ("c_writer_24bit.bmp", sources["tiled_deflate.tif"]),
                         ("e_writer_lzw_predictor.tif", sources["rle8.bmp"][::-1].copy())):
        write_image(images / name, pixels)
    return images


MAGIC = {".jpg": b"\xff\xd8\xff", ".png": b"\x89PNG", ".bmp": b"BM", ".tif": b"II*\x00",
         ".webp": b"RIFF"}


def check_image_files_cli(workdir):
    """Phase 23 (a): ``check_cli_over_files`` over a directory of JPEG,
    PNG, BMP (24-bit and RLE8) and TIFF (LZW with the predictor, PackBits,
    tiled Deflate) files."""
    return check_cli_over_files(workdir, image_files_inputs(workdir), SEED + 23)


def check_cli_over_files(workdir, images, seed):
    """The infer CLI on the card at 544² (the full-width model, seeded
    random weights) with -v -o over the image files of ``images``, then
    --video -o over the same directory: each output under its input's name
    and in its format, read back by the port, the bytes ``write_image``
    writes for the visualizer's drawing of the plain-version host list;
    kernel 1 twice and kernel 2 once an image, the device outputs identical
    to the plain-version postprocess on the same heads; --video writes
    frame_%06d.jpg."""
    import random

    import orienmask_tpu_torch.config as configs
    from orienmask_tpu_torch.data.image_io import image_names, read_image

    names = image_names(images)
    paths = [images / n for n in names]
    n = len(names)
    name = "orienmask_yolo_coco_544_anchor4_fpn_plus_infer"
    config = getattr(configs, name)
    counts = {}
    for tag, argv, written in (
            ("-v -o", ["-d", str(images), "-v"], names),
            ("--video -o", ["--video", str(images)], [f"frame_{i:06d}.jpg" for i in range(n)])):
        out = workdir / ("drawn" if tag == "-v -o" else "frames")
        random.seed(seed)
        t = time.perf_counter()
        lines, calls, _, launched, _ = run_cli(["-c", name, "--random-weights", *argv,
                                                "-o", str(out)])
        log(f"  {tag}: {len(calls)} images in {time.perf_counter() - t:.2f} s (model build "
            f"included), launches: {launched}; report: " + "; ".join(lines))
        if len(calls) != n or launched["exact_topk"] != 2 * n \
                or launched["assemble_masks_packed"] != n:
            raise AssertionError(f"{tag}: expected {n} images, kernel 1 twice and kernel 2 "
                                 f"once an image; got {len(calls)}, {launched}")
        got = sorted(p.name for p in out.iterdir())
        if got != written:
            raise AssertionError(f"{tag} wrote {got}, expected {written}")
        for file in written:
            data = (out / file).read_bytes()
            if not data.startswith(MAGIC[os.path.splitext(file)[1]]):
                raise AssertionError(f"{tag}: {file} is not in its name's format")
            read_image(out / file)
        plain, wants = check_against_plain(tag, calls, _kw(config["postprocess"]), 544)
        check_drawings(tag, out, written, wants, plain, paths, config, seed)
        counts[tag] = launched
    log(f"  inputs: {', '.join(names)}; every output under its input's name (--video: "
        f"frame_%06d.jpg), in its format, read back by the port's readers")
    return counts


def median_ms(fn, n=CODEC_REPEATS):
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times))


def check_codecs():
    """Phase 23 (b): on the card's host, the C++ Huffman coder against the
    plain Python coder, byte for byte, at ``CODER_SIZES`` in colour and grey
    at ``CODER_QUALITIES``; the C++ LZW codec against the plain one; then
    the host ms (median of ``CODEC_REPEATS``) of a 480x640 JPEG encode and
    decode, BMP write and read and TIFF write and read."""
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.data import bmp, jpeg, jpeg_encode, tiff
    from orienmask_tpu_torch.utils.mini_dataset import make_scene

    t = time.perf_counter()
    kernels.host_library("jpeg_host")
    build_s = time.perf_counter() - t
    rng = np.random.default_rng(SEED + 23)
    checked = 0
    for h, w in CODER_SIZES:
        if h % 16 == 0 and w % 16 == 0:
            raise AssertionError(f"{h}x{w} is a whole number of MCUs")
        image = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for grey in (False, True):
            pixels = image[..., 0] if grey else image
            for quality in CODER_QUALITIES:
                coefs, comps, _ = jpeg_encode.component_blocks(pixels, quality)
                ncomp = 1 if grey else 3
                if jpeg_encode.encode_blocks_native(coefs, comps, ncomp) != \
                        jpeg_encode.encode_blocks_py(coefs, comps, ncomp):
                    raise AssertionError(f"the C++ Huffman coder differs from the plain one at "
                                         f"{h}x{w}, grey={grey}, quality {quality}")
                checked += 1
    data = rng.integers(0, 4, 100_000, dtype=np.uint8).tobytes()
    if tiff.lzw_encode_native(data) != tiff.lzw_encode(data) or \
            tiff.lzw_decode_native(tiff.lzw_encode(data), len(data)) != data:
        raise AssertionError("the C++ LZW codec differs from the plain one")
    log(f"  the C++ Huffman coder gives the plain coder's bytes on {checked} cases "
        f"({len(CODER_SIZES)} sizes, none whole MCUs, colour and grey, qualities "
        f"{CODER_QUALITIES}); the C++ LZW codec the plain one's (host libraries ready in "
        f"{build_s:.2f} s)")

    image, _ = make_scene(np.random.default_rng(SEED + 23), 480, 640, 0, 80, 1)
    encoded = {"jpeg": jpeg_encode.encode(image), "bmp": bmp.encode(image),
               "tiff": tiff.encode(image)}
    for kind, decode in (("jpeg", jpeg.decode), ("bmp", bmp.decode), ("tiff", tiff.decode)):
        back = decode(encoded[kind])
        if kind != "jpeg" and not np.array_equal(back, image):
            raise AssertionError(f"the {kind} file does not read back to its pixels")
    ms = {"jpeg_encode": median_ms(lambda: jpeg_encode.encode(image)),
          "jpeg_decode": median_ms(lambda: jpeg.decode(encoded["jpeg"])),
          "bmp_write": median_ms(lambda: bmp.encode(image)),
          "bmp_read": median_ms(lambda: bmp.decode(encoded["bmp"])),
          "tiff_write": median_ms(lambda: tiff.encode(image)),
          "tiff_read": median_ms(lambda: tiff.decode(encoded["tiff"]))}
    log("  host ms a 480x640 image (median of " + f"{CODEC_REPEATS}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in ms.items()) + f"; bytes: " + ", ".join(
        f"{k} {len(v)}" for k, v in encoded.items()) + f"; card: {card_line()}")
    return {"coder_cases": checked, "host_ms_480x640": ms,
            "bytes_480x640": {k: len(v) for k, v in encoded.items()}}


def check_train_resizes(workdir):
    """Phase 23 (c): ``COCODataset`` over the port's mini dataset through
    the published train transform with its Resize at ``area``, ``cubic``
    and ``lanczos4`` in turn, collated to B = 8, then one train step on the
    card at full width for each: a finite loss, kernel 5 launched once and
    equal to its plain version on the batch's painter inputs."""
    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.data import collate
    from orienmask_tpu_torch.data.dataset import COCODataset
    from orienmask_tpu_torch.ops import targets
    from orienmask_tpu_torch.trainer.builder import build_transform
    from orienmask_tpu_torch.trainer.train_state import to_device
    from orienmask_tpu_torch.utils.mini_dataset import write_mini_dataset

    t = time.perf_counter()
    paths = write_mini_dataset(workdir / "resize_data", RESIZE_IMAGES, FILES_SIZES, seed=SEED)
    tp = TrainPath()
    log(f"  dataset of {RESIZE_IMAGES} scenes and the full-width train path set up in "
        f"{time.perf_counter() - t:.2f} s")
    loader = tp.cfg["train_loader"]
    painter = tp.loss.painter
    counts, err, out = {}, 0.0, {}
    for name in ("area", "cubic", "lanczos4"):
        cfg = copy.deepcopy(loader["transform"])
        for step in cfg["pipeline"]:
            if step["type"] == "Resize":
                step["interpolation"] = name
        transform = build_transform(cfg)
        dataset = COCODataset(paths["list_file"], paths["image_dir"], paths["anno_file"],
                              transform)
        t = time.perf_counter()
        samples = []
        for i in range(RESIZE_IMAGES):
            transform.reseed(SEED + i)
            samples.append(dataset[i])
        host_ms = 1e3 * (time.perf_counter() - t) / RESIZE_IMAGES
        batch = to_device(collate(samples, max_instances=loader["max_instances"],
                                  pack_masks=loader["pack_masks"]), "cuda")
        painted = []
        with mock.patch.object(targets, "paint_orientation",
                               lambda geom, n_last, masks, *rest: painted.append(
                                   (geom.clone(), n_last.clone(), masks.clone()))):
            tp.loss._paint_shared_batch(batch["bbox"], batch["valid"], batch["mask"])
        err = max(err, check_paint_case(f"{name}'s batch", *painted[0], painter.pixel_anchors,
                                        (painter.image_h, painter.image_w)))
        torch.cuda.synchronize()
        kernels.reset_launches()
        logs = tp.step(batch=batch)
        torch.cuda.synchronize()
        launched = dict(kernels.launches)
        loss = float(logs["loss"])
        if not np.isfinite(loss) or launched["paint_orientation"] != 1:
            raise AssertionError(f"{name}: loss {loss}, launches {launched}")
        counts[name] = launched
        out[name] = {"loss": loss, "host_ms_an_image": host_ms,
                     "instances": int(batch["valid"].sum())}
        log(f"  {name}: {RESIZE_IMAGES} samples through the train transform at "
            f"{host_ms:.1f} ms an image on the host; one B = {RESIZE_IMAGES} step, loss "
            f"{loss:.4f}, launches {launched}")
    del tp
    return counts, err, out


# ------------------------------------------------- WebP and platforms (24)

# phase 24 (a)'s directory: the committed fixtures a user's -d would hold
WEBP_CLI_FIXTURES = ("webp_vp8l.webp", "webp_vp8_q50.webp", "webp_vp8_q95.webp",
                     "webp_vp8x_alpha.webp", "webp_animated.webp", "webp_exif_6.webp",
                     "webp_odd_33x65.webp")
WEBP_SCENE = (480, 640)  # the seeded scene whose host ms (b) records
PLATFORMS = ("cpu", "cuda")
PLATFORM_SHAPE = (1, 480, 640, 3)


def check_webp_fixtures():
    """Phase 24 (a), on the card's host: every committed WebP fixture reads
    to its committed digest (cv2's pixels, taken where cv2 is); the C++
    loops equal their plain versions on the fixtures (VP8's macroblocks on
    every lossy one but the 480x640, VP8L's entropy decode and predictor on
    the lossless ones, the encoder's mode choice, LZ77 and bit packing on a
    seeded scene)."""
    import hashlib

    from orienmask_tpu_torch import kernels
    from orienmask_tpu_torch.data import vp8, vp8l
    from orienmask_tpu_torch.data.image_io import read_image
    from orienmask_tpu_torch.utils.mini_dataset import make_scene

    t = time.perf_counter()
    kernels.host_library("webp_host")
    build_s = time.perf_counter() - t
    digests = json.loads((IMAGE_FIXTURES / "digests.json").read_text())
    names = sorted(n for n in digests if n.endswith(".webp"))
    for name in names:
        image = read_image(IMAGE_FIXTURES / name)
        if list(image.shape) != digests[name]["shape"] or \
                hashlib.sha256(image.tobytes()).hexdigest() != digests[name]["sha256"]:
            raise AssertionError(f"{name} does not read to cv2's pixels (its digest)")
    loops = 0
    for name in names:
        data = (IMAGE_FIXTURES / name).read_bytes()
        form = digests[name]["form"]
        if form["animated"] or name == "webp_480x640_q95.webp":
            continue
        for fourcc in (b"VP8 ", b"VP8L"):
            at = data.find(fourcc, 12)
            if at < 0:
                continue
            payload = data[at + 8:at + 8 + int.from_bytes(data[at + 4:at + 8], "little")]
            if fourcc == b"VP8 ":
                same = all(np.array_equal(a, b) for a, b in zip(
                    vp8.decode_macroblocks_native(vp8.parse_header(payload)),
                    vp8.decode_macroblocks_py(vp8.parse_header(payload))))
            else:
                same = np.array_equal(vp8l.decode(payload), vp8l.decode(
                    payload, vp8l.decode_image_py, vp8l.predictor_py))
            if not same:
                raise AssertionError(f"{name}: the C++ loops differ from the plain ones")
            loops += 1
    scene, _ = make_scene(np.random.default_rng(SEED + 24), 48, 64, 0, 80, 1)
    argb = vp8l.decode(vp8l.encode(scene)).reshape(-1)
    pairs = [(vp8l.backward_refs_native(argb, 64, c), vp8l.backward_refs_py(argb, 64, c))
             for c in (0, 10)]
    pairs.append((vp8l.predictor_forward_native(argb, 64, 48),
                  vp8l.predictor_forward_py(argb, 64, 48)))
    widths = (argb % 19).astype(np.int64)
    pairs.append(([np.frombuffer(vp8l.BitWriter.pack_native(argb, widths), np.uint8)],
                  [np.frombuffer(vp8l.BitWriter.pack_py(argb.astype(np.int64), widths),
                                 np.uint8)]))
    for got, want in pairs:
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError("the C++ encoder loops differ from the plain ones")
    log(f"  {len(names)} WebP fixtures read to their committed digests; the C++ loops equal "
        f"the plain ones on {loops} bitstreams, and the encoder's (mode choice, LZ77, bit "
        f"packing) on a 48x64 scene (host library ready in {build_s:.2f} s)")
    return {"fixtures": len(names), "loops_checked": loops}


def check_webp_codecs():
    """Phase 24 (a): the host ms (median of ``CODEC_REPEATS``) of a seeded
    480x640 scene written as VP8L and read back, and of the committed
    480x640 VP8 (cv2 at quality 95) read."""
    from orienmask_tpu_torch.data import webp
    from orienmask_tpu_torch.utils.mini_dataset import make_scene

    image, _ = make_scene(np.random.default_rng(SEED + 24), *WEBP_SCENE, 0, 80, 1)
    lossless = webp.encode(image)
    if not np.array_equal(webp.decode(lossless), image):
        raise AssertionError("the VP8L file does not read back to its pixels")
    lossy = (IMAGE_FIXTURES / "webp_480x640_q95.webp").read_bytes()
    ms = {"vp8l_write": median_ms(lambda: webp.encode(image)),
          "vp8l_read": median_ms(lambda: webp.decode(lossless)),
          "vp8_read": median_ms(lambda: webp.decode(lossy))}
    log("  host ms a 480x640 image (median of " + f"{CODEC_REPEATS}): " + ", ".join(
        f"{k} {v:.2f}" for k, v in ms.items()) + f"; VP8L bytes {len(lossless)}, the VP8 "
        f"file's {len(lossy)}; card: {card_line()}")
    return {"host_ms_480x640": ms, "vp8l_bytes_480x640": len(lossless)}


def check_webp_cli(workdir):
    """Phase 24 (a): the committed WebP fixtures (VP8L, VP8 at two
    qualities, VP8X with ALPH, animated, EXIF-rotated, an odd size) through
    the infer CLI (``check_cli_over_files``): -v -o writes each drawing to
    its .webp name as VP8L, read back by the port to the drawing."""
    images = workdir / "webp"
    images.mkdir()
    for name in WEBP_CLI_FIXTURES:
        (images / name).write_bytes((IMAGE_FIXTURES / name).read_bytes())
    return check_cli_over_files(workdir, images, SEED + 24)


def check_platforms():
    """Phase 24 (b): the 544² infer config's bf16 pipeline exported at
    ``PLATFORM_SHAPE`` for ``PLATFORMS`` into one artifact; a fresh process
    without the model code loads it on the card, then on the CPU, and runs
    phase 4's seeded image on each; each served program equals, by bits,
    the live pipeline on that device over the same folded weights
    (``InferencePipeline.to``); the CUDA program launches kernels 1 and 2
    twice and once a call, the CPU program none (their plain versions)."""
    from orienmask_tpu_torch.serving import export_pipeline

    t0 = time.perf_counter()
    pipe, _ = build_pipeline()
    image = np.random.default_rng(SEED).integers(0, 256, PLATFORM_SHAPE, dtype=np.uint8)
    res = {}
    with tempfile.TemporaryDirectory() as workdir:
        work = Path(workdir)
        t = time.perf_counter()
        manifest = export_pipeline(pipe, [PLATFORM_SHAPE], work / "art", platforms=PLATFORMS)
        res["export_s"] = time.perf_counter() - t
        res["bytes"] = artifact_bytes(work / "art")
        log(f"  exported {manifest['programs_by_platform']} in {res['export_s']:.1f} s; bytes "
            f"{res['bytes']}")
        np.save(work / "image.npy", image)
        spec = work / "spec.json"
        spec.write_text(json.dumps({p: {"dir": str(work / "art"), "device": p,
                                        "images": [str(work / "image.npy")]}
                                    for p in ("cuda", "cpu")}))
        host = finish_serving_host(start_serving_host(spec, work / "served.json"))
        if host["model_modules"]:
            raise AssertionError(f"the serving host loaded model code: {host['model_modules']}")
        counts = {}
        for platform in ("cuda", "cpu"):
            call = host[platform]["calls"]["1"]
            live = pipe.to(platform)
            t = time.perf_counter()
            want = live.run_device(torch.from_numpy(image).to(platform))
            live_s = time.perf_counter() - t
            got = dict(np.load(call["outputs"]))
            for key in want:
                w = want[key].cpu().numpy()
                if got[key].dtype != w.dtype or not np.array_equal(got[key], w):
                    raise AssertionError(f"{platform}: served '{key}' differs from the live "
                                         "pipeline on that device")
            launched = call["launches"]
            expected = {"cuda": (2, 1), "cpu": (0, 0)}[platform]
            if (launched["exact_topk"], launched["assemble_masks_packed"]) != expected or \
                    sum(launched.values()) != sum(expected):
                raise AssertionError(f"{platform}: the served call launched {launched}")
            counts[platform] = launched
            res[platform] = {"load_s": host[platform]["load_s"], "live_s": live_s,
                             "valid": int(want["valid"].sum())}
            log(f"  {platform}: loaded in {host[platform]['load_s']:.2f} s in the fresh "
                f"process; served == live by bits ({int(want['valid'].sum())} valid "
                f"detections; the live call {live_s:.2f} s); launches {launched}")
        res["host_process_s"] = host["process_s"]
    res["phase_s"] = time.perf_counter() - t0
    return {"platforms_cuda": counts["cuda"]}, res


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
    global START
    START = t0

    header("[1] build")
    t = time.perf_counter()
    for name in kernels.SIGNATURES:
        kernels.library(name)  # the first call builds every csrc/*.cu
    kernels.host_library("omtpu")  # g++: every csrc/*.cc
    log(f"  card: {card_line()} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"  kernels built and loaded in {time.perf_counter() - t:.2f} s "
        f"(nvcc: {kernels.build_seconds if kernels.build_seconds is not None else 0:.2f} s)")
    for lib in ("topk", "masks", "recover"):
        for line in kernels.build_log.get(lib, f"{lib}.cu not rebuilt here").splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line \
                    or "rebuilt" in line:
                log(f"  ptxas ({lib}.cu): {line.strip()}")

    header("[2] kernel 1: exact_topk vs its plain version")
    topk_err = check_topk()
    header("[3] kernel 2: assemble_masks_packed vs its plain version")
    mask_err = check_masks()

    header("[4] main path: OrienMaskYOLOFPNPlus 544x544 bf16, InferencePipeline")
    t = time.perf_counter()
    pipe, pp_kw = build_pipeline()
    image = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 256, (1, 480, 640, 3), dtype=np.uint8)).cuda()
    log(f"  model built and folded in {time.perf_counter() - t:.2f} s")
    counts = check_main_path(pipe, pp_kw, image)

    header("[5] timings")
    times = time_kernels(pipe, image)
    torch.cuda.reset_peak_memory_stats()
    fps, rates = e2e_fps(pipe, image)
    log(f"  e2e 544x544 bs1: {fps:.2f} FPS (median; windows "
        f"{', '.join(f'{r:.2f}' for r in rates)}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if args.profile:
        profile(pipe, image, args.profile)
    del pipe

    header("[6] kernel 5: paint_orientation vs its plain version")
    t = time.perf_counter()
    tp = TrainPath()
    log(f"  train path set up in {time.perf_counter() - t:.2f} s (full-width model, "
        f"seeded weights, synthetic batch through collate)")
    paint_err = check_paint(tp)

    header("[7] train path: orienmask_yolo_coco_544_anchor4_fpn_plus, B=8, make_train_step")
    train_counts = check_train_path(tp)

    header("[8] train timings")
    times["paint_orientation"] = time_paint(tp)
    train = {dtype: time_train(tp, dtype) for dtype in ("float32", "bfloat16")}
    if args.profile:
        profile_train(tp, args.profile)
    del tp

    header("[9] kernels 3 and 4: assemble_masks, assemble_masks_bitpacked vs plain versions")
    per_det_counts, per_det_err, per_det_cases = check_per_detection()

    with tempfile.TemporaryDirectory() as workdir:
        header("[10] eval path: orienmask_yolo_coco_544_anchor4_fpn_plus_test, Tester, B=16")
        t = time.perf_counter()
        ev = EvalPath(workdir)
        log(f"  eval path set up in {time.perf_counter() - t:.2f} s (full-width model, "
            f"seeded weights through a .pth and load_checkpoint, {EVAL_IMAGES} scenes)")
        eval_counts = check_eval_path(ev)

        header("[11] eval timings")
        times.update(time_per_detection(per_det_cases))
        selection, times["assemble_masks_packed"]["cases"]["d"], eval_times = time_eval(ev)
        del ev

        header("[12] the infer CLI at 544x544: -d -j -o, published and base model")
        cli_counts = check_cli(Path(workdir))
        header("[13] the 736x736 stream: --video, kernels 1 and 2 at 736x736, streamed FPS")
        stream_counts, shapes_736, stream_fps = check_stream(Path(workdir))
    header("[14] batched inference at 544x544, B = 8 and 16")
    batch_counts, batch_shapes, batch_rates = check_batches()
    header("[15] JPEG and the visualizer: the fixtures' decode, the CLI over JPEG at 544x544 "
        "(-j -o, -v -o) and --video -o at 736x736")
    jpeg = check_jpeg_decoder()
    with tempfile.TemporaryDirectory() as workdir:
        jpeg_counts, jpeg_cli = check_jpeg_cli(Path(workdir))
    jpeg.update(jpeg_cli)
    header("[16] kernel 6: recover_masks vs its plain version")
    recover_err, recover_cases_ = check_recover()
    header("[17] training and evaluation from files: the train CLI (3 epochs), then the test CLI")
    with tempfile.TemporaryDirectory() as files_dir:
        files_counts, files_paint_err, train_files, files_run = check_train_files(Path(files_dir))
        header("[18] data parallelism: n_device=2 as two ranks on the card (gloo with CUDA "
            "tensors); the train CLI (2 epochs), then the test CLI")
        with tempfile.TemporaryDirectory() as workdir:
            dp_counts, dp_paint_err, dp_train = check_data_parallel(Path(workdir))
        header("[19] the train step's options: remat, frozen stages, BatchNorm eval, param groups")
        options_counts, options_paint_err, options = check_train_options(
            Path(files_dir), files_run["cfg"])
        header("[20] int8: the int8 convolutions, the quantized pipeline against bf16, accuracy")
        int8_counts, int8 = check_int8(Path(files_dir), files_run["cfg"], files_run["best"])
    header("[21] serving: bf16 and int8 artifacts through torch.export, served without model code")
    serving_counts, serving = check_serving()
    header("[22] spatial partitioning: two ranks on the card (gloo with CUDA tensors), rows of "
        "each image over both; inference, int8, the train step and CLIs; resnet50")
    with tempfile.TemporaryDirectory() as workdir:
        spatial_counts, spatial_544 = check_spatial(Path(workdir))
    header("[23] image files in and out, the train resizes: the infer CLI over JPEG, PNG, BMP "
           "and TIFF (-v -o, --video -o), the codecs on the host, area/cubic/lanczos4 steps")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        files_cli_counts = check_image_files_cli(Path(workdir))
        codecs = check_codecs()
        resize_counts, resize_paint_err, resizes = check_train_resizes(Path(workdir))
    image_files = {"codecs": codecs, "train_resizes": resizes,
                   "phase_s": time.perf_counter() - t}
    log(f"  phase 23 in {image_files['phase_s']:.1f} s; card: {card_line()}")
    header("[24] WebP and platforms: the infer CLI over WebP (-v -o, --video -o), the codecs "
           "on the host, an artifact for the CPU and the card")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        webp_cli_counts = check_webp_cli(Path(workdir))
    webp_files = {**check_webp_fixtures(), **check_webp_codecs()}
    platform_counts, platforms = check_platforms()
    webp_files.update(platforms=platforms, phase_s=time.perf_counter() - t)
    log(f"  phase 24 in {webp_files['phase_s']:.1f} s; card: {card_line()}")

    # launches: each path's count, read around that path's run alone; the
    # times are those of the infer path's inputs (kernels 1, 2), the eval
    # path's exact selection beside them (kernel 1), the validation path's
    # (kernels 3, 4) and the train path's (kernel 5); kernels 1 and 2 also
    # at the 736² stream's and the batches' shapes
    paths = {name: {"infer": counts[name], "eval": eval_counts[name], "cli": cli_counts[name],
                    "stream_736": stream_counts[name], "batch": batch_counts[name],
                    "jpeg_cli": jpeg_counts[name]}
             for name in ("exact_topk", "assemble_masks_packed")}
    for name in ("exact_topk", "assemble_masks_packed"):
        times[name]["shapes_736"] = shapes_736[name]
        times[name]["batch"] = {b: batch_shapes[b][name] for b in BATCHES}
    paths["recover_masks"] = {"eval": eval_counts["recover_masks"],
                              "cli": cli_counts["recover_masks"],
                              "jpeg_cli": jpeg_counts["recover_masks"]}
    paths["paint_orientation"] = {"train": train_counts["paint_orientation"]}
    for name in ("assemble_masks", "assemble_masks_bitpacked"):
        paths[name] = {"validation": per_det_counts[name]}
    for name in ("exact_topk", "assemble_masks_packed"):  # phases 23 (a) and 24
        paths[name]["image_files_cli"] = files_cli_counts["-v -o"][name]
        paths[name]["image_files_video"] = files_cli_counts["--video -o"][name]
        paths[name]["webp_cli"] = webp_cli_counts["-v -o"][name]
        paths[name]["webp_video"] = webp_cli_counts["--video -o"][name]
        paths[name]["platforms_cuda"] = platform_counts["platforms_cuda"][name]
    for name in paths:  # phase 17's CLIs, each kernel's count around each
        for cli, launched in files_counts.items():
            paths[name][cli] = launched[name]
    for path, launched in dp_counts.items():  # phase 18's, both ranks' counts summed
        for name, n in launched.items():
            paths[name][path] = n
    paths["paint_orientation"]["train_resizes"] = sum(
        c["paint_orientation"] for c in resize_counts.values())  # phase 23 (c)
    # phases 19, 20, 21 and 22's
    for path, launched in {**options_counts, **int8_counts, **serving_counts,
                           **spatial_counts}.items():
        for name, n in launched.items():
            if n:
                paths[name][path] = n
    recover_paths = paths["recover_masks"]
    main_case = recover_cases_["b"]  # the eval batch
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
             launches=sum(paths["assemble_masks"].values()), paths=paths["assemble_masks"],
             max_abs_err=per_det_err, **times["assemble_masks"]),
        dict(name="assemble_masks_bitpacked", route="cuda",
             source="orienmask_tpu_torch/csrc/masks.cu",
             replaces="orienmask_tpu/ops/pallas_masks.py:142",
             launches=sum(paths["assemble_masks_bitpacked"].values()),
             paths=paths["assemble_masks_bitpacked"], max_abs_err=per_det_err,
             **times["assemble_masks_bitpacked"]),
        dict(name="paint_orientation", route="cuda", source="orienmask_tpu_torch/csrc/paint.cu",
             replaces="orienmask_tpu/ops/pallas_paint.py:149",
             launches=sum(paths["paint_orientation"].values()),
             paths=paths["paint_orientation"],
             max_abs_err=max(paint_err, files_paint_err, dp_paint_err, options_paint_err,
                             resize_paint_err),
             **times["paint_orientation"]),
        dict(name="recover_masks", route="cuda", source="orienmask_tpu_torch/csrc/recover.cu",
             replaces="orienmask_tpu/eval/coco_eval.py:147",
             launches=sum(recover_paths.values()), paths=recover_paths,
             max_abs_err=recover_err, ms=main_case["ms"], plain_ms=main_case["plain_ms"],
             bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"], library_ms=None,
             cases=recover_cases_),
    ]}
    log(f"  total {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"e2e_fps_544_bs1": fps, "windows": rates, "train_544_b8": train,
                    "eval_544_b16": eval_times, "train_files_544_b8": train_files,
                    "dp_train_544_b8x2": dp_train, "train_options_544_b8": options,
                    "int8_544": int8, "serving_544": serving, "spatial_544": spatial_544}))
    log(json.dumps({"infer_544_b8": batch_rates[8], "infer_544_b16": batch_rates[16],
                    "stream_736": stream_fps, "jpeg": jpeg, "image_files": image_files,
                    "webp": webp_files}))
    log(card_line())
    log(json.dumps(kernels_line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
