from .loss import OrienMaskYOLOLoss, OrienMaskYOLOMultiScaleLoss
from .postprocess import OrienMaskYOLOPostProcess

__all__ = ["OrienMaskYOLOLoss", "OrienMaskYOLOMultiScaleLoss", "OrienMaskYOLOPostProcess"]
