"""Process helpers over ``torch.distributed`` (counterpart of
``orienmask_tpu/utils/envs.py``).

The port runs one process a device, so a rank is a process and a device at
once: ``get_local_device_count`` is 1.  Every helper is the identity, or
rank 0 of 1, when no process group is initialised; under a group (of any
size) the tensor helpers issue their collective, so a one-rank group runs
the same code as a larger one.

Collectives on host values (numbers, numpy arrays, strings) travel as
tensors on the group's device: the rank's card under NCCL, the CPU under
gloo (gloo also takes CUDA tensors, which the tensor helpers pass as they
are).

``is_tpu_platform`` and ``cpu_subprocess_env`` have no counterpart: the
first gates the JAX package's Pallas kernels (the port picks a kernel or its
plain version by the tensor's device), the second sets up JAX's CPU backend
in a subprocess.
"""

import numpy as np
import torch
import torch.distributed as dist


def initialized():
    return dist.is_available() and dist.is_initialized()


def get_device_rank():
    return dist.get_rank() if initialized() else 0


def get_world_size():
    return dist.get_world_size() if initialized() else 1


def get_local_device_count():
    return 1


def barrier():
    if initialized():
        dist.barrier()


def collective_device():
    """Where host values travel: the current card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(tensor):
    """The sum of ``tensor`` over the ranks, as a new tensor on its device
    (``tensor`` itself without a group)."""
    if not initialized():
        return tensor
    out = tensor.detach().clone()
    dist.all_reduce(out)
    return out


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def reduce_sum(tree):
    """Cross-process sum of every leaf of a pytree of dicts, lists and tuples
    (reference utils/envs.py:23-31).  Tensor leaves come back as tensors on
    their device; numbers and numpy arrays as numpy arrays of their dtype."""
    if not initialized():
        return tree

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return all_reduce_sum(x)
        a = np.asarray(x)
        t = torch.tensor(a.reshape(-1), device=collective_device())  # a copy
        dist.all_reduce(t)
        return t.cpu().numpy().astype(a.dtype).reshape(a.shape)

    return _map_leaves(leaf, tree)


def broadcast_str(s, max_len=64):
    """Rank 0's string to every process (fixed-width transport).

    Used for the run-directory stamp: every rank must derive the same
    checkpoint directory, and the ranks' clocks can straddle a second."""
    if not initialized():
        return s
    raw = s.encode()
    if len(raw) > max_len:
        raise ValueError(f"string too long to broadcast: {len(raw)} bytes > {max_len}")
    buf = torch.zeros(max_len, dtype=torch.int32)
    buf[: len(raw)] = torch.tensor(list(raw), dtype=torch.int32)
    buf = buf.to(collective_device())
    dist.broadcast(buf, src=0)
    out = buf.cpu().numpy()
    return bytes(out[out > 0].astype(np.uint8)).decode()


def reduce_mean(tree):
    if not initialized():
        return tree
    n = get_world_size()
    return _map_leaves(lambda x: x / n, reduce_sum(tree))
