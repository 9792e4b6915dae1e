"""The train and eval steps (counterpart of
``orienmask_tpu/trainer/train_state.py``).

The state is not a pytree here: the parameters and the BatchNorm running
statistics live in the ``nn.Module``, the momentum buffers and the step
counter in the ``SGD``.  One train step runs the forward in train mode
(batch statistics), the loss with its targets (kernel 5 paints them), the
backward, the per-step NaN guard and the SGD update, or, with
``accumulate > 1``, adds the gradients to a buffer and applies them with
``lr / accumulate`` when the caller says so.  It returns the log dict as
device scalars and never waits for the card.

Under a process group (``parallel/mesh.py``) a step of N ranks on N shards
computes what the JAX step computes on the global batch over an N-device
mesh: the BatchNorms take the global statistics
(``models/layers.py::sync_batch_norm``), the loss divides by global counts,
so each rank's loss is its share of the global one, and the step sums the
ranks' gradients (flat buckets, the same on every rank) and their log
values (one stacked vector).  The NaN guard reads the summed loss and
gradients, so every rank skips together.  ``torch.autograd.grad`` takes the
gradients, so ``DistributedDataParallel``, whose hooks fire on ``.grad``
accumulation and which averages, has no place here.  With
``accumulate > 1`` each microbatch's gradients are summed over the ranks
before they are accumulated, as JAX's microbatches are global ones.

Under a space group (``space``, ``parallel/spatial.py``; JAX
``spatial_train_step``) a rank holds its data index's whole images and
runs the forward on its rows of them, with the halos; the heads are
gathered whole on every space rank with a backward that keeps the rank's
own rows, the loss runs whole on every space rank with its divisors and
logs summed over the data group (one rank of each data index), and the
gradient sum stays over the world, which adds the space ranks' row shares.
BatchNorm statistics sum over the world with the ranks' counts.
"""


import torch

from ..device import resolve_device
from ..parallel.mesh import all_reduce_flat, shard_batch
from ..parallel.spatial import all_reduce_data, shard_spatial_batch
from ..utils.envs import all_reduce_sum, initialized

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _image_f32(x):
    """uint8-transported images -> the f32 that Normalize(0, 255) gives."""
    if x.dtype == torch.uint8:
        return x.float() * (1.0 / 255.0)
    return x


def unpack_target(batch):
    """Collated batch -> loss target dict.  Masks stay as they came (packed
    or not): the painter takes both."""
    target = {k: batch[k] for k in ("bbox", "cls", "mask", "valid")}
    if "sample_weight" in batch:
        target["sample_weight"] = batch["sample_weight"]
    return target


to_device = shard_batch  # a collated batch (numpy arrays or tensors) on a device


def reduce_logs(logs, reduce=all_reduce_sum):
    """A dict of device scalars (or pairs of them) summed over the ranks in
    one ``all_reduce`` of their stacked vector (``reduce``); the dict itself
    without a group."""
    if not initialized():
        return logs
    keys = list(logs)
    flat = [x for k in keys for x in (logs[k] if isinstance(logs[k], tuple) else (logs[k],))]
    summed = iter(reduce(torch.stack(
        [torch.as_tensor(x, dtype=torch.float32, device=flat[0].device) for x in flat])))
    return {k: (tuple(next(summed) for _ in logs[k]) if isinstance(logs[k], tuple)
                else next(summed)) for k in keys}


def _setup(model, loss_fn, compute_dtype, device):
    device = resolve_device(device)
    if loss_fn.device != device:
        raise ValueError(f"the loss is on {loss_fn.device}, the step on {device}")
    model.to(device)
    if device.type == "cuda":
        model.to(memory_format=torch.channels_last)
    dtype = DTYPES[compute_dtype] if isinstance(compute_dtype, str) else compute_dtype
    return device, dtype


def _space_reduce(space):
    """The sum over the ranks that the loss's counts and the logs take:
    the data group under a space group, else the world."""
    return all_reduce_sum if space is None else lambda t: all_reduce_data(t, space)


def _forward(model, x, dtype, remat, space, full_h):
    """The unfolded forward of ``x`` (B, 3, h, W); under ``space`` ``x`` is
    this rank's rows of ``full_h`` and the heads (JAX layout, (B, h, w, C))
    come back gathered whole."""
    if space is None:
        return model(x, dtype, remat=remat)
    with space.active():
        predict = model(x, dtype, remat=remat)
    return tuple(tuple(space.gather_rows(t, full_h, dim=1) for t in pair) for pair in predict)


def make_train_step(model, loss_fn, optimizer, accumulate=1, compute_dtype="float32",
                    device=None, remat=False, space=None):
    """Returns ``train_step(batch, lr, do_step=True) -> logs``.

    ``model`` moves to ``device`` (None: the card), channels_last there;
    ``optimizer`` is an ``SGD`` over ``model.parameters()``.  ``space``:
    this rank's ``SpaceGroup`` for spatial training (the batch holds its
    data index's whole images; the step keeps its rows).  ``lr`` is the
    scheduled rate of this step.  ``do_step`` (a Python bool) applies the
    accumulated gradients when ``accumulate > 1``.  ``remat`` (the config
    key) rematerializes the backbone's stages (``models/darknet.py``): the
    same values, less memory, the stages' forward run twice.

    NaN guard: a step whose loss or any gradient is not finite logs
    ``skipped = 1`` and leaves the parameters, the momentum, the step counter
    and the BatchNorm buffers as they were (with ``accumulate > 1`` its
    gradients add nothing).  BatchNorm updates its buffers in place during
    the forward, so they are copied before it and put back with
    ``torch.where`` after it, on the card."""
    device, dtype = _setup(model, loss_fn, compute_dtype, device)
    params = list(model.parameters())
    if [id(p) for p in optimizer.params] != [id(p) for p in params]:
        raise ValueError("the optimizer must hold model.parameters(), in order")
    buffers = list(model.buffers())
    grad_acc = [torch.zeros_like(p) for p in params] if accumulate > 1 else None
    reduce = _space_reduce(space)

    def train_step(batch, lr, do_step=True):
        batch = shard_batch(batch, device)
        full_h = batch["image"].shape[1]
        if space is not None:
            batch = shard_spatial_batch(batch, space)
        model.train()
        stats = [b.clone() for b in buffers]
        x = _image_f32(batch["image"]).permute(0, 3, 1, 2)  # NCHW view, channels_last
        predict = _forward(model, x, dtype, remat, space, full_h)
        loss_sum, loss_log, _ = loss_fn(predict, unpack_target(batch), training=True,
                                        reduce=reduce)
        grads = all_reduce_flat(torch.autograd.grad(loss_sum, params))
        logs = reduce_logs(dict({k: v.detach() for k, v in loss_log.items()},
                                loss=loss_sum.detach()), reduce)
        with torch.no_grad():
            finite = torch.stack([torch.isfinite(logs["loss"])]
                                 + [torch.isfinite(g).all() for g in grads]).all()
            for new, old in zip(buffers, stats):
                new.copy_(torch.where(finite, new, old))
            if accumulate > 1:
                for acc, g in zip(grad_acc, grads):
                    acc.add_(torch.where(finite, g, 0.0))
                if do_step:
                    optimizer.apply(grad_acc, lr / accumulate)
                    for acc in grad_acc:
                        acc.zero_()
            else:
                optimizer.apply(grads, lr, update_gate=finite)
        return dict(logs, skipped=1.0 - finite.float())

    return train_step


def make_eval_step(model, loss_fn, compute_dtype="float32", device=None, space=None):
    """Returns ``eval_step(batch) -> (heads, loss log, metric log)``: the
    forward with the running statistics and the loss with its metrics, the
    logs summed over the ranks (one collective).  Under a space group the
    images are whole on every space rank (JAX evaluates them replicated
    over space) and the sums run over the data group."""
    device, dtype = _setup(model, loss_fn, compute_dtype, device)
    reduce = _space_reduce(space)

    @torch.no_grad()
    def eval_step(batch):
        batch = shard_batch(batch, device)
        model.eval()
        out = model(_image_f32(batch["image"]).permute(0, 3, 1, 2), dtype)
        loss_sum, loss_log, metric_log = loss_fn(out, unpack_target(batch), training=False,
                                                 reduce=reduce)
        logs = reduce_logs(dict(loss_log, loss=loss_sum, **metric_log), reduce)
        return (out, {k: logs[k] for k in (*loss_log, "loss")},
                {k: logs[k] for k in metric_log})

    return eval_step
