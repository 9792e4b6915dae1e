"""Phase 23 of chip_smoke.py alone (image files in and out: the infer CLI at
544² with -v -o and --video -o over JPEG, PNG, BMP and TIFF inputs, the
codecs on the card's host, the train transform's area, cubic and lanczos4
resizes with a B = 8 step each) after the build: the short first call after
a change to the readers, the writers, the resizes or the CLI's outputs.
Writes the phase's launch counts and results to OUT (default
probe/build/image_files_phase.json, ignored by git).

Run from the repository's root on a machine with the card:
    python3 probe/image_files_phase.py [OUT]
"""
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from orienmask_tpu_torch import kernels  # noqa: E402


def main():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    for name in kernels.SIGNATURES:
        kernels.library(name)
    kernels.host_library("omtpu")
    cs.log(f"card: {cs.card_line()}, torch {torch.__version__}, CUDA {torch.version.cuda}; "
           f"build {time.perf_counter() - t0:.1f} s")
    cs.log("[23]")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        cli_counts = cs.check_image_files_cli(Path(workdir))
        codecs = cs.check_codecs()
        resize_counts, paint_err, resizes = cs.check_train_resizes(Path(workdir))
    phase_s = time.perf_counter() - t
    cs.log(f"phase 23 {phase_s:.1f} s; total {time.perf_counter() - t0:.1f} s")
    out = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/image_files_phase.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": cs.card_line(), "phase_s": phase_s,
                               "cli_counts": cli_counts, "codecs": codecs,
                               "resize_counts": resize_counts, "paint_err": paint_err,
                               "resizes": resizes}, indent=1))


if __name__ == "__main__":
    main()
