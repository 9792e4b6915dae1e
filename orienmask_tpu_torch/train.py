"""Train CLI (counterpart of the JAX package's ``train.py``, same contract).

    python -m orienmask_tpu_torch.train -c <config name or .json> [-r <.ckpt>] [-w <weights>]
        [--device cuda|cpu]

``-r`` resumes a ``.ckpt`` (the model, the SGD state, the epoch and the
monitor's best; its run directory is reused; without ``-c`` its own config
is used); ``-w`` starts from a ``.ckpt`` or ``.pth``'s weights.  Trains on
the card (``--device cuda``, the default) unless ``--device cpu`` is asked
for.  One process, one device: the JAX CLI's multi-process flags
(``--coordinator``, ``--num-processes``, ``--process-id``) are refused with
a message until data parallelism is ported.  ``main(argv)`` is the entry
point that tests and ``chip_smoke.py`` call in-process.
"""

import argparse
import sys

from .device import resolve_device
from .infer import load_config
from .trainer.builder import build_trainer
from .trainer.checkpoint import read_checkpoint

MULTI_PROCESS = ("coordinator", "num_processes", "process_id")
REFUSED = ("--{} is not ported yet: multi-process (data-parallel) training is ROADMAP "
           "Queue 1 item 6; the port trains in one process on one device")


def build_parser():
    parser = argparse.ArgumentParser(description="Train Model")
    parser.add_argument("-c", "--config", default=None, type=str,
                        help="config name or json file path (default: None)")
    parser.add_argument("-r", "--resume", default=None, type=str,
                        help="checkpoint to resume training (default: None)")
    parser.add_argument("-w", "--weights", default=None, type=str,
                        help="weights to start training (default: None)")
    parser.add_argument("--coordinator", default=None, type=str,
                        help="multi-host coordinator address (not ported)")
    parser.add_argument("--num-processes", default=None, type=int, help="(not ported)")
    parser.add_argument("--process-id", default=None, type=int, help="(not ported)")
    parser.add_argument("--device", default="cuda", type=str,
                        help="cuda (the default; raises without a card) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    for flag in MULTI_PROCESS:
        if getattr(args, flag) is not None:
            raise SystemExit(REFUSED.format(flag.replace("_", "-")))
    device = resolve_device(args.device)
    if args.config is not None:
        config = load_config(args.config)
    elif args.resume is not None:
        config = read_checkpoint(args.resume)["config"]
    else:
        raise SystemExit("Configuration file need to be specified.")
    build_trainer(config, resume=args.resume, weights=args.weights, device=device).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
