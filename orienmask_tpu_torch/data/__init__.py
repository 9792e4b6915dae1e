from .collate import collate
from .synthetic import ArrayDataset, ArrayLoader, make_scenes
from .transform import FastCOCOTransform

__all__ = ["ArrayDataset", "ArrayLoader", "FastCOCOTransform", "collate", "make_scenes"]
