"""Where a served frame's host time goes: the 544² bf16 pipeline and its
serving artifact at batch 1 on the card, ms a frame in turns (live, served
as ``ServingModel`` runs it, served with every forward pre-hook of the
exported module removed; twice each, alternated), each over 200 frames
after 10 warm-ups with one synchronize, whether torch's input-check hook
reads ``validate_inputs``, and cProfile's top functions by own time over 50
frames of each.

Run from the repository's root on a machine with the card:
    python3 probe/serving_overhead.py
"""
import cProfile
import io
import pstats
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from orienmask_tpu_torch import kernels  # noqa: E402
from orienmask_tpu_torch.serving import export_pipeline, load_serving  # noqa: E402


def ms_a_frame(fn, image, n=200):
    for _ in range(10):
        fn(image)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn(image)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def top(fn, image, n=50, rows=25):
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(n):
        fn(image)
    torch.cuda.synchronize()
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(rows)
    return out.getvalue()


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for name in kernels.SIGNATURES:
        kernels.library(name)
    cs.log(f"card: {cs.card_line()}, torch {torch.__version__}")
    pipe, _ = cs.build_pipeline()
    image = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
        0, 256, (1, 480, 640, 3), dtype=np.uint8)).cuda()
    with tempfile.TemporaryDirectory() as workdir:
        export_pipeline(pipe, [tuple(image.shape)], workdir)
        served = load_serving(workdir)
        unchecked = load_serving(workdir)
        for fn in unchecked._fns.values():
            fn._forward_pre_hooks.clear()
        runs = {"live": pipe.run_device, "served": served.run_device,
                "served, no input checks": unchecked.run_device}
        for key, want in pipe.run_device(image).items():
            for name, run in runs.items():
                if not torch.equal(run(image)[key], want):
                    raise AssertionError(f"{name}: '{key}' differs from live")
        import inspect

        from torch.export import _unlift

        hook = inspect.getsource(_unlift._check_input_constraints_pre_hook)
        cs.log(f"the input-check hook reads validate_inputs: {'validate_inputs' in hook}")
        turns = ("live", "served", "served, no input checks", "live", "served, no input checks",
                 "served")
        for turn in turns + turns[::-1]:
            cs.log(f"{turn}: {ms_a_frame(runs[turn], image):.3f} ms a frame")
        for name, run in runs.items():
            cs.log(f"--- cProfile, {name}, 50 frames\n{top(run, image)}")


if __name__ == "__main__":
    main()
