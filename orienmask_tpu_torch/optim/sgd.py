"""SGD with momentum and weight decay (counterpart of
``orienmask_tpu/optim/sgd.py``), torch.optim.SGD's update:

    d    = grad + weight_decay * param
    buf  = momentum * buf + d          (buf = d on the first step)
    param -= lr * buf

The momentum buffers and the step counter live on the parameters' device
and are made at the first ``apply``.  ``update_gate``, a device-side bool,
turns the whole update (parameters, buffers and counter) into a no-op with
``torch.where``: no value goes to the host.

Optional per-parameter lists (one entry a parameter, in order) give
detectron2-style groups and frozen stages, as JAX's factor pytrees do:
``lr_factors`` multiply the lr, ``wd_factors`` replace the weight decay
(absolute values, ``param_groups.py``), and a parameter of ``freeze_mask``
keeps its value while its momentum becomes zeros (the counter still
counts).  JAX's jitted step takes ``lr`` as an f32 scalar and computes
``lr * lr_factor * buf``: the lr is rounded to f32 first and its product
with the factor once more, so that the update is JAX's bit for bit.
"""

import numpy as np
import torch


class SGD:
    def __init__(self, params, lr, momentum=0.0, weight_decay=0.0, lr_factors=None,
                 wd_factors=None, freeze_mask=None):
        self.params = list(params)
        self.base_lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        n = len(self.params)
        for name, per_param in (("lr_factors", lr_factors), ("wd_factors", wd_factors),
                                ("freeze_mask", freeze_mask)):
            if per_param is not None and len(per_param) != n:
                raise ValueError(f"{len(per_param)} {name} for {n} parameters")
        self.lr_factors = [1.0] * n if lr_factors is None else list(lr_factors)
        self.wd_factors = [weight_decay] * n if wd_factors is None else list(wd_factors)
        self.freeze_mask = [False] * n if freeze_mask is None else [bool(f) for f in freeze_mask]
        self.buffers = None
        self.step = None  # int32 device scalar: updates applied so far

    @torch.no_grad()
    def load_state(self, momentum, step):
        """Momentum buffers (one tensor a parameter, in order) and the count
        of updates applied, as a checkpoint holds them."""
        if len(momentum) != len(self.params):
            raise ValueError(f"{len(momentum)} momentum buffers for {len(self.params)} "
                             "parameters")
        self.buffers = [torch.empty_like(p).copy_(m) for p, m in zip(self.params, momentum)]
        self.step = torch.tensor(step, dtype=torch.int32, device=self.params[0].device)

    @torch.no_grad()
    def apply(self, grads, lr, update_gate=None):
        """One update with the already-scheduled ``lr`` (a float)."""
        if self.buffers is None:
            self.buffers = [torch.zeros_like(p) for p in self.params]
            self.step = torch.zeros((), dtype=torch.int32, device=self.params[0].device)
        first = self.step == 0
        m, lr32 = self.momentum, np.float32(lr)
        for p, g, buf, lrf, wd, frozen in zip(self.params, grads, self.buffers, self.lr_factors,
                                              self.wd_factors, self.freeze_mask):
            if frozen:
                buf.zero_()
                continue
            d = g + wd * p
            new_buf = torch.where(first, d, m * buf + d)
            new_p = p - float(lr32 * np.float32(lrf)) * new_buf
            if update_gate is not None:
                new_p = torch.where(update_gate, new_p, p)
                new_buf = torch.where(update_gate, new_buf, buf)
            p.copy_(new_p)
            buf.copy_(new_buf)
        self.step += 1 if update_gate is None else update_gate.to(torch.int32)
