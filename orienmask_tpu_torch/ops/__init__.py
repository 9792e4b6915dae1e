"""The port's operators.  The loss and the postprocess are loaded at first
use (PEP 562), so that importing an operator module (``ops.topk``,
``ops.masks``, ``ops.nms``) loads no model code."""

import importlib

_LAZY = {"OrienMaskYOLOLoss": ".loss", "OrienMaskYOLOMultiScaleLoss": ".loss",
         "OrienMaskYOLOPostProcess": ".postprocess"}

__all__ = list(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_LAZY[name], __name__), name)
