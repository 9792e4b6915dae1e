"""SGD with momentum and weight decay (counterpart of
``orienmask_tpu/optim/sgd.py``), torch.optim.SGD's update:

    d    = grad + weight_decay * param
    buf  = momentum * buf + d          (buf = d on the first step)
    param -= lr * buf

The momentum buffers and the step counter live on the parameters' device
and are made at the first ``apply``.  ``update_gate``, a device-side bool,
turns the whole update (parameters, buffers and counter) into a no-op with
``torch.where``: no value goes to the host.
"""

import torch


class SGD:
    def __init__(self, params, lr, momentum=0.0, weight_decay=0.0):
        self.params = list(params)
        self.base_lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.buffers = None
        self.step = None  # int32 device scalar: updates applied so far

    @torch.no_grad()
    def apply(self, grads, lr, update_gate=None):
        """One update with the already-scheduled ``lr`` (a float)."""
        if self.buffers is None:
            self.buffers = [torch.zeros_like(p) for p in self.params]
            self.step = torch.zeros((), dtype=torch.int32, device=self.params[0].device)
        first = self.step == 0
        m, wd = self.momentum, self.weight_decay
        for p, g, buf in zip(self.params, grads, self.buffers):
            d = g + wd * p
            new_buf = torch.where(first, d, m * buf + d)
            new_p = p - lr * new_buf
            if update_gate is not None:
                new_p = torch.where(update_gate, new_p, p)
                new_buf = torch.where(update_gate, new_buf, buf)
            p.copy_(new_p)
            buf.copy_(new_buf)
        self.step += 1 if update_gate is None else update_gate.to(torch.int32)
