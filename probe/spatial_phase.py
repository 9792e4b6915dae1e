"""Phase 22 of chip_smoke.py alone (spatial partitioning: two ranks on the
one card, each image's rows over both; the 544² pipeline in f32, bf16 and
int8, ``run_batch_spatial``, the infer CLI with ``--spatial 2``, the spatial
train step and the train CLI with ``n_space=2``, resnet50) after the build:
the short first call after a change to ``parallel/spatial.py``, the
models' convolution helper or the spatial paths.  Writes the phase's launch
counts and timings to OUT (default probe/build/spatial_phase.json, ignored
by git).

Run from the repository's root on a machine with the card:
    python3 probe/spatial_phase.py [OUT]
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
    cs.log("[22]")
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        counts, timings = cs.check_spatial(Path(workdir))
    cs.log(f"phase 22 {time.perf_counter() - t:.1f} s; total {time.perf_counter() - t0:.1f} s")
    out = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/spatial_phase.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": cs.card_line(), "counts": counts, "timings": timings},
                              indent=1))


if __name__ == "__main__":
    main()
