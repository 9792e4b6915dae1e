"""Profiling hooks (counterpart of ``orienmask_tpu/utils/profiler.py``).

``trace(dir)`` records the enclosed region with ``torch.profiler`` (the
host, and the card's kernels where the region runs on one) and writes a
Chrome trace (``trace.json``, readable in Perfetto) and a table of the
operators by device time (``ops.txt``) to ``dir``.  A profiler that cannot
start raises: the region does not run untraced.
"""

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir):
    """Context manager: a torch.profiler trace of the enclosed region into
    ``log_dir`` (nothing when ``log_dir`` is empty)."""
    if not log_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    with open(os.path.join(log_dir, "ops.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by=sort, row_limit=50))
