"""Module-global stage timers (counterpart of ``orienmask_tpu/utils/timer.py``).

A label's timer may hold tensors registered with ``t.sync(x)``; on exit it
waits for the cards those on the card live on (``torch.cuda.synchronize``)
before it reads the wall clock, so a stage's time includes its device work
without a synchronize per op.  The labels are the reference's
(``Network Forward`` / ``Postprocess`` / ...), plus the parts of ``Convert
Format`` that ``Tester`` and ``COCOMetrics.to_coco_format`` time inside it.
"""

import time
from collections import OrderedDict

import numpy as np
import torch

_timer_history = OrderedDict()


def reset():
    _timer_history.clear()


def get_all_elapsed_time():
    """Mean ms of each label since the last ``reset``."""
    return {k: float(np.mean(v)) for k, v in _timer_history.items()}


def _cuda_devices(value, out):
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    return out


class timer:
    """``with timer.timer('stage') as t: ...``; call ``t.sync(x)`` inside the
    block to register tensors (or nested lists, tuples and dicts of them) to
    wait for at exit.  One timer is one entry of its label: a timer entered
    several times (a part of each pass of a loop) adds every block to it."""

    def __init__(self, name):
        self.name = name
        self._sync_targets = []
        self._history = _timer_history.setdefault(name, [])
        self._slot = len(self._history)
        self._history.append(0.0)

    def sync(self, value):
        self._sync_targets.append(value)
        return value

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        for device in _cuda_devices(self._sync_targets, set()):
            torch.cuda.synchronize(device)
        self._history[self._slot] += (time.perf_counter() - self.start) * 1000
