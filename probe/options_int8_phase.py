"""Phases 19 and 20 of chip_smoke.py alone after the build (the train step's
options and int8), with phase 17 first: its mini dataset and best
checkpoint are what 19(c) and 20(c) run on.  The short first call after a
change to the optimizer, the frozen stages, remat, the quantizer or the
int8 convolution.  Writes the phases' launch counts and results to OUT
(default probe/build/options_int8_phase.json, ignored by git).

Run from the repository's root on a machine with the card:
    python3 probe/options_int8_phase.py [OUT]
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
    with tempfile.TemporaryDirectory() as workdir:
        workdir = Path(workdir)
        cs.log("[17]")
        t = time.perf_counter()
        _, _, _, run = cs.check_train_files(workdir)
        cs.log(f"phase 17 {time.perf_counter() - t:.1f} s")
        cs.log("[19]")
        options_counts, paint_err, options = cs.check_train_options(workdir, run["cfg"])
        cs.log("[20]")
        int8_counts, int8 = cs.check_int8(workdir, run["cfg"], run["best"])
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    out = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/options_int8_phase.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": cs.card_line(), "counts": {**options_counts, **int8_counts},
                               "paint_max_abs_err": paint_err, "options": options,
                               "int8": int8}, indent=1))


if __name__ == "__main__":
    main()
