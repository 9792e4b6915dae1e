"""Phase 21 of chip_smoke.py alone after the build: the bf16 and int8
serving artifacts of the 544² infer config exported through torch.export,
served in a fresh process without the model code, held to the live pipeline
by bits and timed against it.  The short first call after a change to
``serving.py``, ``kernels/ops.py``, the NMS loop or ``pipeline.program``.
Writes the phase's launch counts and results to OUT (default
probe/build/serving_phase.json, ignored by git).

Run from the repository's root on a machine with the card:
    python3 probe/serving_phase.py [OUT]
"""
import json
import sys
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
    cs.log(f"card: {cs.card_line()}, torch {torch.__version__}, CUDA {torch.version.cuda}; "
           f"build {time.perf_counter() - t0:.1f} s")
    cs.log("[21]")
    counts, serving = cs.check_serving()
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    out = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/serving_phase.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": cs.card_line(), "counts": counts, "serving": serving},
                              indent=1))


if __name__ == "__main__":
    main()
