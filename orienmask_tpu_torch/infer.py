"""Inference CLI (counterpart of the JAX package's ``infer.py``, same flags).

    python -m orienmask_tpu_torch.infer -c <config name or .json> \\
        (-w <.pth or .ckpt> | --random-weights) \\
        (-i <image> | -d <dir> [-l <list>] [-j <images json>] | --video <frames dir>) \\
        [-v] [-s] [-o <dir>]

Input modes: one image (-i), a directory (-d, optionally a list file -l),
COCO images json (-j, with -d; -o keeps the bbox and segm prediction json
files), a frame directory streamed through ``StreamingPipeline`` (--video,
``--stream-depth`` or the config's ``stream_depth``).  Images are read by
``data/image_io.py`` (JPEG, PNG, BMP, TIFF, PPM, .npy).  -v draws each image
with ``utils/visualizer.py::InferenceVisualizer`` (the config's visualizer
block); with -o it writes each drawing to ``<output>/<the input's file
name>`` through ``image_io.write_image``, in the format the name's extension
gives (JPEG, PNG, BMP, TIFF or PPM, as the JAX CLI's ``cv2.imwrite`` does;
``.npy`` inputs, the port's own form, are drawn to ``<name>.png``), and -s
shows it with matplotlib.  --video with -o turns on -v and writes
``frame_%06d.jpg``.  Runs on the card (``--device cuda``, the default) unless
``--device cpu`` is asked for.  Refused until ported: video files in and out
(``cv2.VideoCapture``/``VideoWriter`` in the JAX CLI).

``--spatial N`` (N > 1) shards each image's rows over N devices
(``parallel/spatial.py``).  The JAX CLI runs one process over N local
devices; the port runs one process a device, so this process spawns N
ranks (``torch.multiprocessing``, a rendezvous on a free localhost port;
rank r on ``cuda:(r % cards)``, gloo with CUDA tensors where ranks share a
card, gloo on the CPU with ``--device cpu``).  Every rank reads the same
inputs and runs the same loop, ``--video`` included; rank 0 alone prints,
times and writes.  ``--spatial 0`` and ``1`` run the plain pipeline in this
process, as the JAX CLI does.  ``main(argv)`` is the entry point that tests
and ``chip_smoke.py`` call in-process.
"""

import argparse
import contextlib
import json
import os
import socket
import sys
import time

import numpy as np
import torch

from . import config as config_module
from .data import FastCOCOTransform
from .data.dataset import COCODataset
from .data.image_io import UnsupportedImage, frame_paths, image_names, read_image, write_image
from .device import resolve_device
from .eval import COCOMetrics
from .models import build_model, init_random
from .ops import OrienMaskYOLOPostProcess
from .parallel.mesh import destroy_distributed, init_distributed
from .parallel.spatial import spatial_groups
from .pipeline import InferencePipeline
from .stream import StreamingPipeline
from .trainer.checkpoint import load_checkpoint
from .utils import timer
from .utils.profiler import trace
from .utils.visualizer import InferenceVisualizer

REFUSED = {
    "video_output": "-o *.mp4/*.avi is not ported yet: the JAX CLI writes video files with "
                    "cv2.VideoWriter; pass a directory for frame_%06d.jpg files, the JPEG "
                    "frames the JAX CLI writes there (ROADMAP Queue 1 item 1, 'What the infer "
                    "CLI still refuses')",
}
# how long the --spatial ranks may take to meet, and their collectives to wait
SPATIAL_TIMEOUT_S = 600


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
                        help="shard each image's rows over N devices, one rank each")
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


def build_pipeline(config, args, device, space=None):
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
                             device=device, space=space)


def load_image(path):
    try:
        return read_image(path)
    except UnsupportedImage as e:
        raise SystemExit(str(e)) from None


def run_video(args, config, pipeline, visualizer, primary=True):
    """Streaming mode: depth frames stay submitted but not fetched.  Only
    the ``primary`` rank writes."""
    depth = args.stream_depth or config.get("stream_depth", 2)
    stream = StreamingPipeline(pipeline, depth=depth, device=pipeline.device)
    try:
        paths = frame_paths(args.video, args.num_images)
    except UnsupportedImage as e:
        raise SystemExit(str(e)) from None
    if args.output and primary:
        os.makedirs(args.output, exist_ok=True)
    src_frames = []  # parallel to the in-flight queue
    n_frames = n_out = 0

    def emit(predictions):
        nonlocal n_out
        src = src_frames.pop(0)
        if visualizer is not None and primary:
            show = visualizer(predictions[0], src.astype(np.float32), pipeline.pad_info)
            if args.output:
                write_image(os.path.join(args.output, f"frame_{n_out:06d}.jpg"), show)
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


def output_name(name):
    """Where -v -o writes the drawing of input ``name``: under the same
    name, so in the same format, except that an ``.npy`` input is drawn
    to ``<name>.png``."""
    stem, ext = os.path.splitext(name)
    return stem + ".png" if ext.lower() == ".npy" else name


def pyplot():
    """matplotlib.pyplot for -s, or the exit that names what is missing."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        raise SystemExit("-s/--show needs matplotlib, which is not installed here; "
                         "use -v -o <dir> to write the drawings instead") from None
    return plt


def run_images(args, pipeline, visualizer, primary=True):
    """The -i/-d/-j loop; only the ``primary`` rank converts, draws and
    writes."""
    names, paths, infos, metrics = resolve_inputs(args)
    if not primary:
        metrics, visualizer = None, None
    if args.output and primary:
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
            if metrics is not None and args.output:
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
                    if args.output:  # the input's name and its format, as cv2.imwrite
                        write_image(os.path.join(args.output, output_name(names[idx])), show)

    if metrics is not None:
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
    if args.visualize and args.show:
        pyplot()  # exits here, before the model is built, where it is missing
    if args.json_file and not args.output:
        print("WARNING: -j without -o accumulates no detections; the dumped "
              "prediction JSONs will be empty (pass -o to keep them)")
    device = resolve_device(args.device)
    if args.spatial is not None and args.spatial > 1:
        return run_spatial(argv, args.spatial)
    return run(args, device)


def run(args, device, space=None):
    """The CLI's work on ``device``; under a space group this rank's."""
    primary = space is None or space.rank == 0
    config = load_config(args.config)
    visualizer = None
    if args.visualize:
        if "visualizer" not in config:
            raise SystemExit(f"-v: config {args.config} has no visualizer block")
        visualizer = InferenceVisualizer(
            **{k: v for k, v in config["visualizer"].items() if k != "type"})
    pipeline = build_pipeline(config, args, device, space)
    if args.video:
        return run_video(args, config, pipeline, visualizer, primary)
    return run_images(args, pipeline, visualizer, primary)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spatial_rank(rank, argv, n_space, port, threads):
    """One rank of ``--spatial N``, spawned: joins the group, runs the CLI
    under its space group (rank 0's prints alone reach the output) and
    leaves the group."""
    torch.set_num_threads(threads)
    args = build_parser().parse_args(argv)
    device = init_distributed(f"localhost:{port}", n_space, rank, args.device,
                              timeout_s=SPATIAL_TIMEOUT_S)
    try:
        with contextlib.ExitStack() as stack:
            if rank:
                devnull = stack.enter_context(open(os.devnull, "w"))
                stack.enter_context(contextlib.redirect_stdout(devnull))
            rc = run(args, device, spatial_groups(n_space))
        if rc:
            raise SystemExit(rc)
    finally:
        destroy_distributed()


def run_spatial(argv, n_space):
    """``--spatial N``: N spawned ranks (this process waits for them); a
    rank that fails fails the run."""
    import torch.multiprocessing as mp

    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        mp.start_processes(spatial_rank, args=(argv, n_space, _free_port(),
                                               torch.get_num_threads()),
                           nprocs=n_space, join=True, start_method="spawn")
    except mp.ProcessExitedException as e:
        raise SystemExit(f"--spatial {n_space}: rank {e.error_index} exited with code "
                         f"{e.exit_code}") from None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
