"""Train CLI (counterpart of the JAX package's ``train.py``, same contract).

    python -m orienmask_tpu_torch.train -c <config name or .json> [-r <.ckpt>] [-w <weights>]
        [--device cuda|cpu] [--coordinator host:port --num-processes N --process-id R]

``-r`` resumes a ``.ckpt`` (the model, the SGD state, the epoch and the
monitor's best; its run directory is reused; without ``-c`` its own config
is used); ``-w`` starts from a ``.ckpt`` or ``.pth``'s weights.  Trains on
the card (``--device cuda``, the default) unless ``--device cpu`` is asked
for.  Data-parallel training runs one process a device: start N of them,
each with ``--num-processes N --process-id R`` and the same
``--coordinator`` (rank 0's host and a free port); rank R takes card
``R % (cards on the host)``, or the CPU with ``--device cpu`` (gloo).  The
process group starts before anything else and ends on the way out.  No
flag, or ``--num-processes 1``, trains in one process.  ``main(argv)`` is
the entry point that tests and ``chip_smoke.py`` call in-process.
"""

import argparse
import sys

from .device import resolve_device
from .infer import load_config
from .parallel.mesh import add_process_arguments, destroy_distributed, init_from_arguments
from .trainer.builder import build_trainer
from .trainer.checkpoint import read_checkpoint


def build_parser():
    parser = argparse.ArgumentParser(description="Train Model")
    parser.add_argument("-c", "--config", default=None, type=str,
                        help="config name or json file path (default: None)")
    parser.add_argument("-r", "--resume", default=None, type=str,
                        help="checkpoint to resume training (default: None)")
    parser.add_argument("-w", "--weights", default=None, type=str,
                        help="weights to start training (default: None)")
    add_process_arguments(parser)
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (the default; raises without a card) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = init_from_arguments(args, resolve_device(args.device))
    try:
        if args.config is not None:
            config = load_config(args.config)
        elif args.resume is not None:
            config = read_checkpoint(args.resume)["config"]
        else:
            raise SystemExit("Configuration file need to be specified.")
        build_trainer(config, resume=args.resume, weights=args.weights, device=device).train()
    finally:
        destroy_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
