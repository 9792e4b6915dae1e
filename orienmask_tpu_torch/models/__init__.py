from .convert import (
    folded_from_jax,
    init_random,
    load_pretrained_backbone,
    load_reference_state_dict,
    resnet_from_jax,
    variables_from_jax,
    variables_to_jax,
)
from .orienmask_yolo import OrienMaskYOLO
from .orienmask_yolo_fpnplus import OrienMaskYOLOFPNPlus
from .resnet import (
    ResNet,
    load_torchvision,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
    resnext50_32x4d,
    resnext101_32x8d,
    wide_resnet50_2,
    wide_resnet101_2,
)

MODELS = {"OrienMaskYOLO": OrienMaskYOLO, "OrienMaskYOLOFPNPlus": OrienMaskYOLOFPNPlus}


def build_model(model_cfg, **overrides):
    """Model from a config's ``model`` dict, with torch's initial weights:
    ``init_random``, a checkpoint, or ``trainer/builder.py::build_model``
    (seeded weights, then ``pretrained``) set them.  ``freeze_backbone`` and
    ``backbone_batchnorm_eval`` reach the backbone (``models/darknet.py``)."""
    kw = {k: v for k, v in model_cfg.items() if k not in ("type", "pretrained")}
    kw.update(overrides)
    if model_cfg["type"] not in MODELS:
        raise ValueError(f"model {model_cfg['type']!r} is not ported yet")
    return MODELS[model_cfg["type"]](**kw)


__all__ = ["OrienMaskYOLO", "OrienMaskYOLOFPNPlus", "ResNet", "build_model", "folded_from_jax",
           "init_random", "load_pretrained_backbone", "load_reference_state_dict",
           "load_torchvision", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "resnet_from_jax", "resnext50_32x4d", "resnext101_32x8d", "variables_from_jax",
           "variables_to_jax", "wide_resnet50_2", "wide_resnet101_2"]
