"""Phase 26 of chip_smoke.py alone (XviD/DivX and MJPEG AVI files: the
Advanced Simple Profile and Motion JPEG fixtures to cv2's committed
digests, the still-refused forms refused by name, the C++ loops against the
plain ones, the infer CLI at 736² over the 720x1280 XviD ASP AVI and the
480x640 4:2:2 MJPEG AVI with -o out.mp4, the codecs' host ms a frame) after
the build: the short first call after a change to the ASP or MJPEG reader.
Writes the phase's launch counts and results to OUT (default
probe/build/asp_mjpeg_phase.json, ignored by git).

Run from the repository's root on a machine with the card:
    python3 probe/asp_mjpeg_phase.py [OUT]
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
    cs.log("[26]")
    t = time.perf_counter()
    out = {"card": cs.card_line()}
    out.update(cs.check_asp_mjpeg_fixtures())
    with tempfile.TemporaryDirectory() as workdir:
        weights_s = time.perf_counter()
        out["cli_counts"], out["cli"] = cs.check_asp_mjpeg_cli(Path(workdir))
        out["cli_s_with_weights"] = time.perf_counter() - weights_s
    out["codecs"] = cs.check_asp_mjpeg_codecs()
    out["phase_s"] = time.perf_counter() - t
    cs.log(f"phase 26 {out['phase_s']:.1f} s (the detecting weights made here, as phase 25 "
           f"makes them in the whole script); total {time.perf_counter() - t0:.1f} s")
    path = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/asp_mjpeg_phase.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
