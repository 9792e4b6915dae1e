from .convert import (
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
    (seeded weights, then ``pretrained``) set them.  The trainer options
    ``freeze_backbone`` and ``backbone_batchnorm_eval`` are not ported: a
    config that sets either is refused, not trained as if unset."""
    for key in ("freeze_backbone", "backbone_batchnorm_eval"):
        if model_cfg.get(key):
            raise ValueError(f"{key} is not ported yet: the port would train the "
                             f"backbone as if it were unset")
    kw = {k: v for k, v in model_cfg.items()
          if k not in ("type", "pretrained", "freeze_backbone",
                       "backbone_batchnorm_eval")}
    kw.update(overrides)
    if model_cfg["type"] not in MODELS:
        raise ValueError(f"model {model_cfg['type']!r} is not ported yet")
    return MODELS[model_cfg["type"]](**kw)


__all__ = ["OrienMaskYOLO", "OrienMaskYOLOFPNPlus", "build_model", "init_random",
           "load_pretrained_backbone", "load_reference_state_dict", "variables_from_jax",
           "variables_to_jax"]
