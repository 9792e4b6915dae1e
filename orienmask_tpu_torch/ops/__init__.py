from .postprocess import OrienMaskYOLOPostProcess

__all__ = ["OrienMaskYOLOPostProcess"]
