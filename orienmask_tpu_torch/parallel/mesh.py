"""Data parallelism over ``torch.distributed`` (counterpart of
``orienmask_tpu/parallel/mesh.py``).

The JAX package runs one program over a device mesh, and GSPMD inserts the
cross-device reductions.  The port runs one process a device (a rank): each
rank's loader yields its own share of the global batch, and the step issues
its collectives itself (the loss's divisors, the BatchNorm statistics, the
gradient sum, the logs; ``trainer/train_state.py``).  Every rank issues the
same collectives, of the same sizes, in the same order, whatever its data.

Devices and backends: rank r uses ``cuda:(r % torch.cuda.device_count())``
(its local rank where a launcher places ranks host by host, as torchrun
does).  NCCL when every rank has a card of its own (``choose_backend``: the
launcher's local world size, or ``num_processes`` on one host, at most the
card count); gloo with CUDA tensors when ranks share a card (NCCL refuses
two ranks on one device; gloo copies through the host); gloo on the CPU.

``data_mesh``, ``batch_sharding`` and ``replicate_sharding`` have no
counterpart: there is no global array to place.
"""

import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils.envs import initialized

# how long a collective, the rendezvous included, may wait for the other
# ranks: rank 0 trails them by COCO scoring and checkpoint writing each epoch
INIT_TIMEOUT_S = 1800
# the most elements a flat bucket of the gradient sum or the broadcast holds
BUCKET_NUMEL = 1 << 24


def choose_backend(device, num_processes):
    """NCCL when every rank of this host has a card of its own, else gloo.

    The ranks on this host are the launcher's local world size where it
    gives one (``LOCAL_WORLD_SIZE``, which ``torchrun`` sets), else all
    ``num_processes`` (one host).  Every rank must choose the same backend,
    so the rule assumes that every host launches the same number of ranks,
    as ``torchrun --nproc-per-node`` does.  A CPU device takes gloo."""
    if device.type != "cuda":
        return "gloo"
    local = os.environ.get("LOCAL_WORLD_SIZE")
    ranks_here = int(local) if local else num_processes
    return "nccl" if ranks_here <= torch.cuda.device_count() else "gloo"


def check_process_args(coordinator, num_processes, process_id):
    """Raises ValueError unless the three form a valid launch."""
    if num_processes < 1:
        raise ValueError(f"--num-processes {num_processes} must be at least 1")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is out of range for "
                         f"--num-processes {num_processes} (0 .. {num_processes - 1})")
    if num_processes > 1 and coordinator is None:
        raise ValueError(f"--num-processes {num_processes} needs --coordinator host:port "
                         "(where rank 0 meets the others)")


def init_distributed(coordinator=None, num_processes=None, process_id=None, device=None,
                     timeout_s=INIT_TIMEOUT_S):
    """Join the process group of ``num_processes`` ranks at
    ``tcp://<coordinator>`` and meet the others at a barrier at once (JAX
    :18-36: the rendezvous happens while every rank is at the same cheap
    point).  One process (``num_processes`` None or 1) starts no group.
    Returns this rank's device (``device`` None: the card)."""
    device = resolve_device(device)
    num_processes = num_processes or 1
    process_id = process_id or 0
    check_process_args(coordinator, num_processes, process_id)
    if num_processes == 1:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = choose_backend(device, num_processes)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    dist.barrier()
    if process_id == 0:
        how = {"nccl": "NCCL, a card a rank", "gloo": "gloo with CUDA tensors, ranks sharing "
               "cards"}[backend] if device.type == "cuda" else "gloo on the CPU"
        print(f"[parallel] {num_processes} ranks over {how}", flush=True)
    return device


def destroy_distributed():
    if initialized():
        dist.destroy_process_group()


def add_process_arguments(parser):
    """The JAX CLIs' multi-process flags (root ``train.py:17-20``)."""
    parser.add_argument("--coordinator", default=None, type=str,
                        help="host:port where rank 0 meets the others")
    parser.add_argument("--num-processes", default=None, type=int,
                        help="ranks, one device each (default 1: no process group)")
    parser.add_argument("--process-id", default=None, type=int,
                        help="this process's rank, 0 .. num-processes - 1")


def init_from_arguments(args, device):
    """``init_distributed`` from the parsed flags; a bad launch exits with
    its message."""
    try:
        check_process_args(args.coordinator, args.num_processes or 1, args.process_id or 0)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    return init_distributed(args.coordinator, args.num_processes, args.process_id, device)


def shard_batch(batch, device):
    """This rank's collated batch (numpy arrays or tensors; ``info`` left
    out) on its device.  The rank's loader already holds only its share
    (``data/dataloader.py``'s rank split), so no global array is made."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items() if k != "info"}


def local_shard(tree):
    """The identity: a rank's outputs are its own rows already, in its
    loader's order (JAX pulls a process's shards out of a global array)."""
    return tree


def _buckets(tensors):
    """Index lists of one dtype and device, each of at most ``BUCKET_NUMEL``
    elements (a larger tensor alone), in the tensors' order.  They depend
    only on the tensors' order, shapes and dtypes, so every rank cuts the
    same buckets."""
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    out = []
    for idx in groups.values():
        cur, n = [], 0
        for i in idx:
            if cur and n + tensors[i].numel() > BUCKET_NUMEL:
                out.append(cur)
                cur, n = [], 0
            cur.append(i)
            n += tensors[i].numel()
        out.append(cur)
    return out


def _flat_pieces(tensors, idx, collective):
    """``collective`` on the flat concatenation of ``tensors[idx]``; the
    pieces of the result, each in its tensor's shape."""
    flat = torch.cat([tensors[i].reshape(-1) for i in idx])
    collective(flat)
    return zip(idx, flat.split([tensors[i].numel() for i in idx]))


def all_reduce_flat(tensors):
    """The sum over the ranks of each tensor, in flat buckets; the tensors
    themselves without a group."""
    out = list(tensors)
    if not initialized():
        return out
    for idx in _buckets(out):
        for i, piece in _flat_pieces(tensors, idx, dist.all_reduce):
            out[i] = piece.view(tensors[i].shape)
    return out


@torch.no_grad()
def replicate_global(tensors):
    """Rank 0's values of ``tensors`` (parameters, buffers, SGD state) on
    every rank, in place, so that the ranks start from the same bits (JAX
    requires every process to hold the same values already).  Nothing
    without a group."""
    if not initialized():
        return
    for idx in _buckets(tensors):
        for i, piece in _flat_pieces(tensors, idx, lambda t: dist.broadcast(t, src=0)):
            tensors[i].copy_(piece.view(tensors[i].shape))
