"""Inference CLI (counterpart of the JAX package's ``infer.py``, same flags).

    python -m orienmask_tpu_torch.infer -c <config name or .json> \\
        (-w <.pth or .ckpt> | --random-weights) \\
        (-i <image> | -d <dir> [-l <list>] [-j <images json>] | --video <frames dir>) \\
        [-v] [-s] [-o <dir>]

Input modes: one image (-i), a directory (-d, optionally a list file -l),
COCO images json (-j, with -d; -o keeps the bbox and segm prediction json
files), a frame directory streamed through ``StreamingPipeline`` (--video,
``--stream-depth`` or the config's ``stream_depth``).  Images are read by
``data/image_io.py`` (JPEG, PNG, PPM, .npy).  -v draws each image with
``utils/visualizer.py::InferenceVisualizer`` (the config's visualizer block);
with -o it writes each drawing to ``<output>/<file name>`` with the extension
``.png`` (the JAX CLI writes JPEG under the file's own name; the port has no
JPEG encoder), and -s shows it with matplotlib.  --video with -o turns on -v
and writes ``frame_%06d.png``.  Runs on the card (``--device cuda``, the
default) unless ``--device cpu`` is asked for.  Refused until ported: video
files in and out (``cv2.VideoCapture``/``VideoWriter`` in the JAX CLI) and
row sharding over several devices (--spatial N > 1; --spatial 0 and 1 run
the plain pipeline, as the JAX CLI does).  ``main(argv)`` is the entry point
that tests and ``chip_smoke.py`` call in-process.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from . import config as config_module
from .data import FastCOCOTransform
from .data.dataset import COCODataset
from .data.image_io import UnsupportedImage, frame_paths, image_names, read_image, write_png
from .device import resolve_device
from .eval import COCOMetrics
from .models import build_model, init_random
from .ops import OrienMaskYOLOPostProcess
from .pipeline import InferencePipeline
from .stream import StreamingPipeline
from .trainer.checkpoint import load_checkpoint
from .utils import timer
from .utils.profiler import trace
from .utils.visualizer import InferenceVisualizer

REFUSED = {
    "video_output": "-o *.mp4/*.avi is not ported yet: the JAX CLI writes video files with "
                    "cv2.VideoWriter; pass a directory for frame_%06d.png files (ROADMAP "
                    "Queue 1, 'What the infer CLI still refuses')",
    "spatial": "--spatial is not ported yet for N > 1: row sharding over several devices "
               "(ROADMAP Queue 1, 'What the infer CLI still refuses')",
}


def build_parser():
    parser = argparse.ArgumentParser(description="Model Inference")
    parser.add_argument("-c", "--config", required=True, type=str)
    parser.add_argument("-w", "--weights", default=None, type=str)
    parser.add_argument("-i", "--image", default=None, type=str)
    parser.add_argument("-d", "--image_dir", default=None, type=str)
    parser.add_argument("-l", "--image_list", default=None, type=str)
    parser.add_argument("-j", "--json_file", default=None, type=str)
    parser.add_argument("-n", "--num_images", default=None, type=int)
    parser.add_argument("-b", "--benchmark", default=None, action="store_true")
    parser.add_argument("-v", "--visualize", default=False, action="store_true")
    parser.add_argument("-o", "--output", default=None, type=str)
    parser.add_argument("-s", "--show", default=False, action="store_true")
    parser.add_argument("--random-weights", action="store_true",
                        help="run with seeded random weights (no -w)")
    parser.add_argument("--profile", default=None, type=str,
                        help="write a torch.profiler trace of the main loop to this dir")
    parser.add_argument("--video", default=None, type=str,
                        help="frames directory: streaming mode with an in-flight queue "
                             "(config stream_depth, e.g. the 736x736 config)")
    parser.add_argument("--spatial", default=None, type=int, metavar="N",
                        help="shard each image's rows over N devices (not ported)")
    parser.add_argument("--stream-depth", default=None, type=int,
                        help="override the in-flight frame depth for --video")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (the default; raises without a card) or cpu")
    return parser


def load_config(name):
    if name.endswith(".json"):
        with open(name) as fh:
            return json.load(fh)
    return getattr(config_module, name)


def build_pipeline(config, args, device):
    model = build_model(config["model"])
    if args.weights:
        load_checkpoint(args.weights, model)
    elif args.random_weights:
        init_random(model, seed=0)
    else:
        raise SystemExit("either -w <weights> or --random-weights is required")
    if config["transform"]["type"] != "FastCOCOTransform":
        raise SystemExit(f"transform {config['transform']['type']!r} is not an inference "
                         "transform")
    transform = FastCOCOTransform(config["transform"]["pipeline"])
    postprocess = OrienMaskYOLOPostProcess(
        **{k: v for k, v in config["postprocess"].items() if k != "type"}, device=device)
    return InferencePipeline(model, transform, postprocess,
                             compute_dtype=config.get("compute_dtype", "bfloat16"),
                             device=device)


def load_image(path):
    try:
        return read_image(path)
    except UnsupportedImage as e:
        raise SystemExit(str(e)) from None


def run_video(args, config, pipeline, visualizer):
    """Streaming mode: depth frames stay submitted but not fetched."""
    depth = args.stream_depth or config.get("stream_depth", 2)
    stream = StreamingPipeline(pipeline, depth=depth, device=pipeline.device)
    try:
        paths = frame_paths(args.video, args.num_images)
    except UnsupportedImage as e:
        raise SystemExit(str(e)) from None
    if args.output:
        os.makedirs(args.output, exist_ok=True)
    src_frames = []  # parallel to the in-flight queue
    n_frames = n_out = 0

    def emit(predictions):
        nonlocal n_out
        src = src_frames.pop(0)
        if visualizer is not None:
            show = visualizer(predictions[0], src.astype(np.float32), pipeline.pad_info)
            if args.output:
                write_png(os.path.join(args.output, f"frame_{n_out:06d}.png"), show)
        n_out += 1

    t_start = time.perf_counter()
    with trace(args.profile):
        for path in paths:
            frame = load_image(path)
            if n_frames == 0 and args.benchmark:
                for _ in range(10):  # warm-up outside the timed loop
                    pipeline.run_device(frame[None])
                if pipeline.device.type == "cuda":
                    torch.cuda.synchronize(pipeline.device)
                t_start = time.perf_counter()
            stream.submit(frame[None])
            src_frames.append(frame)
            n_frames += 1
            if stream.ready():
                emit(stream.retrieve())
        for predictions in stream.drain():
            emit(predictions)
    elapsed = time.perf_counter() - t_start
    if n_frames == 0:
        raise SystemExit(f"no frames decoded from {args.video}")
    print(f"Streamed {n_frames} frames (depth={depth}) in {elapsed:.2f}s")
    print("The average streaming time is %.2f ms (%.2f fps)"
          % (1000 * elapsed / n_frames, n_frames / elapsed))
    return 0


def resolve_inputs(args):
    """(file names, image paths, sample infos or None, COCOMetrics or None)."""
    if args.image:
        return [os.path.basename(args.image)], [args.image], None, None
    if args.json_file:
        with open(args.json_file) as fh:
            images = json.load(fh)["images"][: args.num_images]
        names = [im["file_name"] for im in images]
        infos = [{"height": im["height"], "width": im["width"], "id": im["id"]}
                 for im in images]
        metrics = COCOMetrics(gt_file=None, cat2label=COCODataset.CAT2LABEL, with_mask=True,
                              save_dir=args.output if args.output else ".")
        return names, [os.path.join(args.image_dir, n) for n in names], infos, metrics
    if args.image_dir:
        if args.image_list:
            with open(args.image_list) as fh:
                names = [ln.strip() for ln in fh if ln.strip()]
        else:
            # only image files: stray entries (annotation jsons, subdirs)
            # are skipped
            names = image_names(args.image_dir)
        names = names[: args.num_images]
        return names, [os.path.join(args.image_dir, n) for n in names], None, None
    raise ValueError("Either image or image_dir should be given.")


def pyplot():
    """matplotlib.pyplot for -s, or the exit that names what is missing."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise SystemExit("-s/--show needs matplotlib, which is not installed here; "
                         "use -v -o <dir> to write the drawings instead") from None
    return plt


def run_images(args, pipeline, visualizer):
    names, paths, infos, metrics = resolve_inputs(args)
    if args.output:
        os.makedirs(args.output, exist_ok=True)
    timer.reset()
    if args.benchmark:
        warm = load_image(paths[0])[None]
        for _ in range(10):
            pipeline(warm)

    postprocess = pipeline.postprocess
    with trace(args.profile), timer.timer("Main Loop"):
        for idx, path in enumerate(paths):
            with timer.timer("Load data"):
                src_image = load_image(path)
            with timer.timer("Forward & Postprocess") as t:
                out = t.sync(pipeline.run_device(src_image[None]))
            if args.json_file and args.output:
                with timer.timer("Convert Format"):  # masks recovered where they lie
                    info = [dict(infos[idx], collate_pad=pipeline.pad_info)]
                    metrics.update_results(metrics.to_coco_format_device(
                        info, out, postprocess.image_w))
            if visualizer is not None:
                predictions = postprocess.to_host_list(out)
                with timer.timer("Visualize"):
                    show = visualizer(predictions[0], src_image.astype(np.float32),
                                      pipeline.pad_info)
                    if args.show:
                        plt = pyplot()
                        plt.imshow(show)
                        plt.show()
                    if args.output:  # the image's name, as PNG (the JAX CLI writes JPEG)
                        name = os.path.splitext(names[idx])[0] + ".png"
                        write_png(os.path.join(args.output, name), show)

    if args.json_file and metrics is not None:
        with open(metrics.bbox_pred_file, "w") as fh:
            json.dump(metrics.bbox_results, fh)
        with open(metrics.segm_pred_file, "w") as fh:
            json.dump(metrics.segm_results, fh)

    n_iter = len(paths)
    timer_log = timer.get_all_elapsed_time()
    duration = timer_log.pop("Main Loop")
    print("The inference takes {0} seconds.".format(duration / 1000))
    print("The average inference time is %.2f ms (%.2f fps)"
          % (duration / n_iter, 1000 * n_iter / duration))
    for key, value in timer_log.items():
        print("%s: %.2fms (%.2ffps)" % (key, value, 1000 / value))
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.video and args.output and not args.visualize:
        print("--output implies --visualize in --video mode")
        args.visualize = True
    if args.video and args.output and args.output.endswith((".mp4", ".avi")):
        raise SystemExit(REFUSED["video_output"])
    if args.spatial is not None and args.spatial > 1:
        raise SystemExit(REFUSED["spatial"])
    if args.visualize and args.show:
        pyplot()  # exits here, before the model is built, where it is missing
    if args.json_file and not args.output:
        print("WARNING: -j without -o accumulates no detections; the dumped "
              "prediction JSONs will be empty (pass -o to keep them)")
    device = resolve_device(args.device)
    config = load_config(args.config)
    visualizer = None
    if args.visualize:
        if "visualizer" not in config:
            raise SystemExit(f"-v: config {args.config} has no visualizer block")
        visualizer = InferenceVisualizer(
            **{k: v for k, v in config["visualizer"].items() if k != "type"})
    pipeline = build_pipeline(config, args, device)
    if args.video:
        return run_video(args, config, pipeline, visualizer)
    return run_images(args, pipeline, visualizer)


if __name__ == "__main__":
    raise SystemExit(main())
