"""Detectron2-style parameter groups as per-parameter factors (counterpart
of ``orienmask_tpu/optim/param_groups.py``; no shipped config uses them).

JAX classifies the leaves of its parameter pytree by shape: a ConvBNLeaky
leaf ``{kernel, scale, bias}`` holds norm parameters in ``scale`` and
``bias``, a plain Conv leaf ``{kernel, bias}`` a conv bias.  Here the same
classes are found by module type: the BatchNorm2d of a ``ConvBNLeaky``
(``conv_block.1.{weight,bias}``) and the ``bias`` of a ``Conv``.
"""

from ..models.layers import Conv, ConvBNLeaky


def param_group_factors(model, weight_decay=1e-4, norm_weight_decay=0.0,
                        bias_lr_factor=1.0, bias_weight_decay=1e-4):
    """(lr factors, weight decays), each a list with one entry a parameter
    of ``model.parameters()``, in that order, for ``optim.SGD``.  The lr
    factors multiply the scheduled lr; the weight decays are absolute."""
    special = {}
    for module in model.modules():
        if isinstance(module, ConvBNLeaky):
            bn = module.conv_block[1]
            special[id(bn.weight)] = special[id(bn.bias)] = (1.0, norm_weight_decay)
        elif isinstance(module, Conv):
            special[id(module.bias)] = (bias_lr_factor, bias_weight_decay)
    pairs = [special.get(id(p), (1.0, weight_decay)) for p in model.parameters()]
    return [lr for lr, _ in pairs], [wd for _, wd in pairs]
