"""Phase 24 of chip_smoke.py alone (WebP and platforms: the infer CLI at
544² with -v -o and --video -o over the committed WebP fixtures, the WebP
codecs on the card's host, the bf16 pipeline exported for the CPU and the
card and served by a fresh process on each) after the build: the short
first call after a change to the WebP codecs, the serving platforms or the
CLI's outputs.  Writes the phase's launch counts and results to OUT
(default probe/build/webp_phase.json, ignored by git).

Run from the repository's root on a machine with the card:
    python3 probe/webp_phase.py [OUT]
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
    cs.log("[24]")
    t = time.perf_counter()
    out = {"card": cs.card_line()}
    with tempfile.TemporaryDirectory() as workdir:
        out["cli_counts"] = cs.check_webp_cli(Path(workdir))
    out["cli_s"] = time.perf_counter() - t
    out.update(cs.check_webp_fixtures())
    out.update(cs.check_webp_codecs())
    out["platform_counts"], out["platforms"] = cs.check_platforms()
    out["phase_s"] = time.perf_counter() - t
    cs.log(f"phase 24 {out['phase_s']:.1f} s; total {time.perf_counter() - t0:.1f} s")
    path = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/webp_phase.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
