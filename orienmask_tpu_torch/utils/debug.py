"""Debug mode (counterpart of ``orienmask_tpu/utils/debug.py``).

torch has no counterpart of JAX's ``jax_debug_nans``, which raises at the
first primitive that makes a NaN: ``enable_nan_debugging`` turns on
``torch.autograd.set_detect_anomaly`` (a backward that makes a NaN raises,
naming the forward operator that recorded it), and ``checked`` checks the
floating outputs of the wrapped function once it has returned.
"""

import torch
from torch.utils import _pytree as pytree


def enable_nan_debugging(enable=True):
    """Raise at a backward that makes a NaN, with the forward's traceback."""
    torch.autograd.set_detect_anomaly(enable)


class FloatError:
    """What ``checked`` found: ``get()`` is None or the message, ``throw()``
    raises ``FloatingPointError`` with it (JAX checkify's error API)."""

    def __init__(self, message=None):
        self.message = message

    def get(self):
        return self.message

    def throw(self):
        if self.message is not None:
            raise FloatingPointError(self.message)


def checked(fn):
    """Wrap ``fn``: ``checked_fn(*args) -> (error, out)``, with ``error``
    naming every floating output leaf of ``fn`` that holds a NaN or an inf;
    call ``error.throw()`` to raise."""
    def checked_fn(*args, **kwargs):
        out = fn(*args, **kwargs)
        bad = [f"output leaf {i} (nan={int(torch.isnan(t).sum())}, inf={int(torch.isinf(t).sum())})"
               for i, t in enumerate(pytree.tree_leaves(out))
               if isinstance(t, torch.Tensor) and t.is_floating_point()
               and not bool(torch.isfinite(t).all())]
        name = getattr(fn, "__name__", type(fn).__name__)
        return FloatError(f"{name}: non-finite values in " + ", ".join(bad) if bad else None), out

    return checked_fn


def assert_finite_tree(tree, name="tree"):
    """Host-side finite check over a pytree of tensors or numpy arrays."""
    for i, leaf in enumerate(pytree.tree_leaves(tree)):
        t = torch.as_tensor(leaf)
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(
                f"{name}: leaf {i} contains non-finite values "
                f"(nan={int(torch.isnan(t).sum())}, inf={int(torch.isinf(t).sum())})")
