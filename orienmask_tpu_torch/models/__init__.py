from .convert import (
    folded_from_jax,
    init_random,
    load_pretrained_backbone,
    load_reference_state_dict,
    variables_from_jax,
    variables_to_jax,
)
from .orienmask_yolo import OrienMaskYOLO
from .orienmask_yolo_fpnplus import OrienMaskYOLOFPNPlus

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


__all__ = ["OrienMaskYOLO", "OrienMaskYOLOFPNPlus", "build_model", "folded_from_jax",
           "init_random", "load_pretrained_backbone", "load_reference_state_dict",
           "variables_from_jax", "variables_to_jax"]
