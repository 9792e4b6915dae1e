from .collate import collate
from .transform import FastCOCOTransform

__all__ = ["FastCOCOTransform", "collate"]
