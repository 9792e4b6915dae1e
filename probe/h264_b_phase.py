"""Phase 28 of chip_smoke.py alone (H.264 B slices: every B-slice fixture
to cv2's committed digests, the still-refused forms refused by name, the
C++ slice loop against the plain one, the infer CLI at 736² over the
720x1280 High-profile CABAC MP4 in x264's default GOP and the 480x640 Main
CAVLC AVI with -o out.mp4, the codec's host ms a frame by slice type) after
the build: the short first call after a change to the B-slice reader.
Writes the phase's launch counts and results to OUT (default
probe/build/h264_b_phase.json, ignored by git).

Run from the repository's root on a machine with the card:
    python3 probe/h264_b_phase.py [OUT]
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
    cs.log("[28]")
    t = time.perf_counter()
    out = {"card": cs.card_line()}
    out.update(cs.check_h264_fixtures(28, cs.H264_B_RUNS, cs.PLAIN_PICTURES_B))
    with tempfile.TemporaryDirectory() as workdir:
        weights_s = time.perf_counter()
        out["cli_counts"], out["cli"] = cs.check_h264_cli(Path(workdir), cs.H264_B_RUNS,
                                                          "h264_b", cs.SEED + 28)
        out["cli_s_with_weights"] = time.perf_counter() - weights_s
    out["codecs"] = cs.check_h264_codecs(cs.H264_B_RUNS)
    out["phase_s"] = time.perf_counter() - t
    cs.log(f"phase 28 {out['phase_s']:.1f} s (the detecting weights made here, as phases 25 and "
           f"26 make them in the whole script); total {time.perf_counter() - t0:.1f} s")
    path = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/h264_b_phase.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
