"""Where the two infer CLIs' ``--video -o`` outputs differ, by frame size.

``tests/test_torch_video_asp.py`` holds the port's CLI to the JAX CLI on
96x128 XviD and MJPEG AVIs within ``CLI_MEAN_ABS_DIFF`` (4.0, measured at
that size).  This runs the same two CLIs, with the same seeded weights and
visualizer, on those two clips and on the committed 64x80 XviD and 48x64
MJPEG fixtures, and prints for each: the mean absolute difference of the
two outputs as cv2 reads them, the share of pixels the drawings cover
(where the JAX CLI's output differs from the source frame by more than 40
in a channel), the difference inside and outside them, and each output's
difference from the source.

Run from the repository's root on the CPU, with cv2:
    JAX_PLATFORMS=cpu python3 probe/cli_diff_by_size.py
"""
import json
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "probe")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import cv2  # noqa: E402

import make_video_fixtures as fixtures  # noqa: E402
import mpeg4_oracle  # noqa: E402
from orienmask_tpu.models import OrienMaskYOLOFPNPlus as JaxModel  # noqa: E402
from orienmask_tpu.utils.envs import cpu_subprocess_env  # noqa: E402
from test_torch_infer import _config  # noqa: E402
from test_torch_pipeline import SLIM, _variables  # noqa: E402

SEEDED = "import random, runpy, sys; random.seed(0); sys.argv = sys.argv[1:]; "
CLIS = {
    "jax": [sys.executable, "-c", SEEDED + "runpy.run_path(sys.argv[0], run_name='__main__')",
            "infer.py"],
    "port": [sys.executable, "-c", SEEDED + "from orienmask_tpu_torch import infer; "
             "raise SystemExit(infer.main(sys.argv[1:]))", "infer", "--device", "cpu"],
}


def main():
    with tempfile.TemporaryDirectory(prefix="cli_diff_") as tmp:
        compare(Path(tmp))


def compare(root):
    v = _variables(JaxModel(3, 80, backbone_stage_blocks=SLIM))
    with open(root / "weights.ckpt", "wb") as fh:
        pickle.dump({"epoch": 0, "params": v["params"], "batch_stats": v["batch_stats"],
                     "config": _config()}, fh)
    config = dict(_config(), visualizer={"type": "InferenceVisualizer", "dataset": "COCO",
                                         "with_mask": True, "conf_thresh": 0.3, "alpha": 0.6,
                                         "line_thickness": 1})
    (root / "config.json").write_text(json.dumps(config))
    clip = fixtures.pan(26, 96, 128, 8, 2, 1)
    fixtures.oracle_avi(root / "xvid_96x128.avi", clip, fourcc=b"XVID", bf=2,
                        flags="+qpel+mv4", mpeg_quant=1, patch=fixtures.user_data(b"XviD0073"))
    fixtures.mjpeg_avi(root / "mjpeg_96x128.avi", clip, dht=False,
                       cv2_sampling=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422)
    fixture_dir = ROOT / "tests" / "image_fixtures"
    env = dict(cpu_subprocess_env(), OMP_NUM_THREADS="1")
    for src in (root / "xvid_96x128.avi", fixture_dir / "mpeg4_xvid.avi",
                root / "mjpeg_96x128.avi", fixture_dir / "mjpeg_422_webcam.avi"):
        outs = {}
        for name, cmd in CLIS.items():
            path = root / f"{name}_{src.stem}.avi"
            args = ["-c", str(root / "config.json"), "-w", str(root / "weights.ckpt"),
                    "--video", str(src), "-o", str(path)]
            subprocess.run(cmd + args, cwd=ROOT, env=env, check=True, capture_output=True,
                           timeout=600)
            outs[name] = [f.astype(float) for f in mpeg4_oracle.cv2_frames(path)[0]]
        source = [f.astype(float) for f in mpeg4_oracle.cv2_frames(src)[0]]
        rows = []
        for jax_f, port_f, src_f in zip(outs["jax"], outs["port"], source):
            diff = np.abs(jax_f - port_f).mean(axis=2)
            drawn = np.abs(jax_f - src_f).max(axis=2) > 40
            rows.append((diff.mean(), drawn.mean(), diff[drawn].mean() if drawn.any() else 0.0,
                         diff[~drawn].mean(), np.abs(jax_f - src_f).mean(),
                         np.abs(port_f - src_f).mean()))
        m = np.mean(rows, axis=0)
        print(f"{src.name} {source[0].shape[0]}x{source[0].shape[1]}: difference {m[0]:.3f}; "
              f"drawn share {m[1]:.3f}; difference inside the drawings {m[2]:.2f}, outside "
              f"{m[3]:.2f}; JAX output vs source {m[4]:.2f}, port output vs source {m[5]:.2f}")


if __name__ == "__main__":
    main()
