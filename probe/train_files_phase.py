"""Phase 17 of chip_smoke.py alone (training and evaluation from files: the
train CLI for 3 epochs on the port's mini dataset at full width, then the
test CLI on its best checkpoint) after the build: the short first call
after a change to the data path, the trainer, its checkpoints or the CLIs.
Writes the phase's launch counts and timings to OUT (default
probe/build/train_files_phase.json, ignored by git).

Run from the repository's root on a machine with the card:
    python3 probe/train_files_phase.py [OUT]
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
    cs.log("[17]")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        counts, paint_err, timings, _ = cs.check_train_files(Path(workdir))
    cs.log(f"phase 17 {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t0:.1f} s")
    out = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/train_files_phase.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": cs.card_line(), "counts": counts,
                               "paint_max_abs_err": paint_err, "timings": timings}, indent=1))


if __name__ == "__main__":
    main()
