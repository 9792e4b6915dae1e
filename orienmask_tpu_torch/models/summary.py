"""Network summary (counterpart of ``orienmask_tpu/models/summary.py``).

Shape-only: the forward runs on the ``meta`` device, so nothing is
computed and the full 544x544 model takes an instant.
"""

import torch
from torch.func import functional_call


def _stats(module):
    """BatchNorm statistics: running mean and variance, as JAX's
    ``batch_stats`` hold them (not ``num_batches_tracked``)."""
    return sum(buf.numel() for m in module.modules() if isinstance(m, torch.nn.BatchNorm2d)
               for buf in (m.running_mean, m.running_var))


def model_summary(model, input_shape=(1, 544, 544, 3), print_fn=print):
    """Print per-module parameter counts and output shapes in the JAX layout
    (B, h, w, C); returns the totals and the output shapes."""
    rows = [(name, sum(p.numel() for p in getattr(model, name).parameters()))
            for name in model.module_names()]
    total = sum(n for _, n in rows)
    stats_total = _stats(model)

    meta = {k: torch.empty_like(v, device="meta")
            for k, v in {**dict(model.named_parameters()), **dict(model.named_buffers())}.items()}
    x = torch.empty(tuple(input_shape), device="meta").permute(0, 3, 1, 2)
    with torch.no_grad():
        out = functional_call(model, meta, (x,))
    out_shapes = tuple(tuple(tuple(t.shape) for t in pair) for pair in out)

    width = max(len(r[0]) for r in rows)
    print_fn(f"[{type(model).__name__}] Network Summary  (input {tuple(input_shape)})")
    print_fn("-" * (width + 20))
    for name, n in rows:
        print_fn(f"{name:<{width}}  {n:>14,}")
    print_fn("-" * (width + 20))
    print_fn(f"{'total params':<{width}}  {total:>14,}")
    print_fn(f"{'batch-norm stats':<{width}}  {stats_total:>14,}")
    print_fn(f"outputs: {out_shapes}")
    return {"params": total, "batch_stats": stats_total, "outputs": out_shapes}
