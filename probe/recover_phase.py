"""Phase 16 of chip_smoke.py alone (kernel 6, the mask recovery, against
its plain version on cases (a)-(g), timed), then phase 10 (the eval path,
whose Convert Format now recovers the masks on the card, against the host
route) after the build: the short first call after a change to
``csrc/recover.cu``, ``ops/recover.py`` or the COCO conversion.  Writes the
results to OUT (default probe/build/recover_phase.json, ignored by git).

Run from the repository's root on a machine with the card:
    python3 probe/recover_phase.py [OUT]
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
kernels.host_library("omtpu")
cs.log(f"card: {cs.card_line()}, torch {torch.__version__}, CUDA {torch.version.cuda}; "
       f"build {time.perf_counter() - t0:.1f} s")
for line in kernels.build_log.get("recover", "").splitlines():
    if "Compiling entry" in line or "registers" in line or "spill" in line:
        cs.log(f"  ptxas (recover.cu): {line.strip()}")
cs.log("[16]")
err, cases = cs.check_recover()
cs.log("[10]")
with tempfile.TemporaryDirectory() as workdir:
    ev = cs.EvalPath(workdir)
    counts = cs.check_eval_path(ev)
cs.log(f"total {time.perf_counter() - t0:.1f} s")
out = dict(max_abs_err=err, cases=cases, eval_counts=counts)
path = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/recover_phase.json")
path.parent.mkdir(parents=True, exist_ok=True)
path.write_text(json.dumps(out, indent=1))
cs.log(json.dumps(out))
