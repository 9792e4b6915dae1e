"""COCO-eval CLI (counterpart of the JAX package's ``test.py``, same contract).

    python -m orienmask_tpu_torch.test -c <config name or .json> -w <.ckpt or .pth>
        [--device cuda|cpu] [--coordinator host:port --num-processes N --process-id R]

Builds the tester of the config's ``test_loader``, ``postprocess`` and
``gt_file`` on the checkpoint (``trainer/builder.py::build_tester``; a
``.ckpt`` rebuilds the model its train config describes), runs it over the
set and prints the bbox and segm tables and each stage's ms per image.
Runs on the card (``--device cuda``, the default) unless ``--device cpu``
is asked for.  A config of ``n_device > 1`` evaluates as that many ranks,
one process a device, launched as the train CLI's are (``--coordinator``,
``--num-processes``, ``--process-id``): the port's form of the JAX tester's
device mesh.  Rank 0 prints the tables.  ``main(argv)`` is the entry point
that tests and ``chip_smoke.py`` call in-process.
"""

import argparse
import sys

from .device import resolve_device
from .infer import load_config
from .parallel.mesh import add_process_arguments, destroy_distributed, init_from_arguments
from .trainer.builder import build_tester


def build_parser():
    parser = argparse.ArgumentParser(description="Test Model")
    parser.add_argument("-c", "--config", required=True, type=str,
                        help="config name or json file path")
    parser.add_argument("-w", "--checkpoint", required=True, type=str,
                        help="model checkpoint to test")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (the default; raises without a card) or cpu")
    add_process_arguments(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = init_from_arguments(args, resolve_device(args.device))
    try:
        tester = build_tester(load_config(args.config), args.checkpoint, device=device)
        try:
            tester.test()
        finally:
            tester.test_loader.shutdown()  # its worker processes
    finally:
        destroy_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
