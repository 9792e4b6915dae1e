"""Phase 15 of chip_smoke.py alone (the JPEG fixtures' decode, the infer CLI
over JPEG at 544² with -j -o and -v -o, --video -o at 736²) after the
kernels' build: the short first call after a change to the decoder, the
visualizer or the CLI.  Writes the phase's results to OUT (default
probe/build/jpeg_phase.json, ignored by git).

Run from the repository's root on a machine with the card:
    python3 probe/jpeg_phase.py [OUT]
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
cs.log("[15]")
decoder = cs.check_jpeg_decoder()
with tempfile.TemporaryDirectory() as workdir:
    counts, cli = cs.check_jpeg_cli(Path(workdir))
cs.log(f"total {time.perf_counter() - t0:.1f} s")
out = dict(decoder=decoder, counts=counts, cli=cli)
path = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/jpeg_phase.json")
path.parent.mkdir(parents=True, exist_ok=True)
path.write_text(json.dumps(out, indent=1))
cs.log(json.dumps(out))
