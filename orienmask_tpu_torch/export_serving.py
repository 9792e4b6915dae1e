"""Export a serving artifact from an infer config (and a checkpoint) and
verify that the loaded programs give the live pipeline's outputs bit for bit
(counterpart of ``tools/export_serving.py``):

    python -m orienmask_tpu_torch.export_serving -c <config name or .json> \\
        [-w <.pth or .ckpt>] [-o dir] [--shape B,H,W ...] [--skip-verify] [--device cpu] \\
        [--platforms cpu cuda]

Without ``-w`` the model takes seeded random weights (the program is the
same).  The checkpoint is read as the infer CLI reads it.  The artifact is
for the pipeline's own device (``--device``, the card by default) or for
the device types ``--platforms`` lists (``cpu``, ``cuda``); each program
this machine can run is verified on its own device against the live
pipeline there.  An int8 artifact comes from ``serving.export_pipeline`` on
a pipeline after ``quantize_int8``.
"""

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from .device import resolve_device
from .infer import build_pipeline, load_config
from .serving import PLATFORMS, export_pipeline, load_serving


def build_parser():
    parser = argparse.ArgumentParser(description="Export a serving artifact")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-w", "--weights", default=None)
    parser.add_argument("-o", "--output",
                        default=os.path.join(tempfile.gettempdir(), "orienmask_serving"))
    parser.add_argument("--shape", action="append", default=None,
                        help="B,H,W input shape (repeatable); default 1,<net>,<net>")
    parser.add_argument("--skip-verify", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    parser.add_argument("--platforms", nargs="*", choices=PLATFORMS, default=None,
                        help="device types to export for (default: --device's)")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    config = load_config(args.config)
    if not args.weights:
        print("[export] no -w: seeded random weights (the program is the same)")
    args.random_weights = not args.weights
    pipeline = build_pipeline(config, args, device)

    net_h, net_w = pipeline.transform.size
    if args.shape:
        shapes = [tuple(int(x) for x in s.split(",")) + (3,) for s in args.shape]
    else:
        shapes = [(1, net_h, net_w, 3)]

    t0 = time.time()
    manifest = export_pipeline(pipeline, shapes, args.output, platforms=args.platforms or None)
    sizes = {f: os.path.getsize(os.path.join(args.output, f)) // 1024
             for f in sorted(os.listdir(args.output))}
    print("[export] %.1fs -> %s" % (time.time() - t0, args.output))
    print("[export] platforms=%s files(KiB)=%s" % (manifest["platforms"], sizes))

    if args.skip_verify:
        return 0
    for platform in manifest["platforms"]:
        live = pipeline.to(platform)  # export_pipeline checked that it exists
        served = load_serving(args.output, live.device)
        rng = np.random.default_rng(0)
        for shape in shapes:
            image = torch.from_numpy(rng.integers(0, 255, shape, np.uint8)).to(live.device)
            t0 = time.time()
            got = served.run_device(image)
            t_first = time.time() - t0
            want = live.run_device(image)
            for key in want:
                if not torch.equal(want[key], got[key]):
                    raise SystemExit(f"[verify] {platform} {shape}: '{key}' differs from the "
                                     "live pipeline")
            print("[verify] %s bit-exact vs live pipeline on %s (first call %.1fs)"
                  % (shape, platform, t_first))
    print("[export] OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
