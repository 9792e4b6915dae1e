"""Phase 25 of chip_smoke.py alone (video files in and out: the infer CLI
at 736² with --video over the committed 720x1280 MP4 and AVI and -o
out.mp4 and out.avi, the MPEG-4 codec and containers on the card's host,
streamed FPS from the file against a PNG directory) after the build: the
short first call after a change to the video reader, writer or the CLI's
video loop.  Writes the phase's launch counts and results to OUT (default
probe/build/video_phase.json, ignored by git).

Run from the repository's root on a machine with the card:
    python3 probe/video_phase.py [OUT]
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
    cs.log("[25]")
    t = time.perf_counter()
    out = {"card": cs.card_line()}
    out.update(cs.check_video_fixtures())
    with tempfile.TemporaryDirectory() as workdir:
        out["cli_counts"], out["cli"] = cs.check_video_cli(Path(workdir))
        out["codecs"] = cs.check_video_codecs()
        out["stream_736"] = cs.check_video_stream(Path(workdir))
    out["phase_s"] = time.perf_counter() - t
    cs.log(f"phase 25 {out['phase_s']:.1f} s; total {time.perf_counter() - t0:.1f} s")
    path = Path(sys.argv[1] if len(sys.argv) > 1 else "probe/build/video_phase.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
