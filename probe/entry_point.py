"""Phases 12-14 of chip_smoke.py alone (the infer CLI at 544², the 736²
stream, batches of 8 and 16) after the kernels' build: the short first call
after a change to the inference entry point.  Writes the phases' results to
OUT (default probe/build/entry_point.json, ignored by git).

Run from the repository's root on a machine with the card:
    python3 probe/entry_point.py [OUT]
"""
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, ".")
import torch

import chip_smoke as cs
from orienmask_tpu_torch import kernels

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
t0 = time.perf_counter()
for name in kernels.SIGNATURES:
    kernels.library(name)
cs.log(f"card: {cs.card_line()}, torch {torch.__version__}, CUDA {torch.version.cuda}; "
       f"build {time.perf_counter() - t0:.1f} s")
with tempfile.TemporaryDirectory() as workdir:
    cs.log("[12]")
    cli = cs.check_cli(Path(workdir))
    cs.log("[13]")
    stream_counts, shapes_736, stream_fps = cs.check_stream(Path(workdir))
cs.log("[14]")
batch_counts, batch_shapes, batch_rates = cs.check_batches()
cs.log(f"total {time.perf_counter() - t0:.1f} s")
out = dict(cli=cli, stream=stream_counts, shapes_736=shapes_736, stream_fps=stream_fps,
           batch_counts=batch_counts, batch=batch_shapes, rates=batch_rates)
path = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/entry_point.json")
path.parent.mkdir(parents=True, exist_ok=True)
path.write_text(json.dumps(out, indent=1))
cs.log(json.dumps(dict(rates=batch_rates, stream_fps=stream_fps)))
