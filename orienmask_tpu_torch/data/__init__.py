from .collate import collate, collate_plus
from .dataloader import AspectRatioGroupedDataloader, DataLoader
from .dataset import COCODataset, VOCDataset
from .synthetic import ArrayDataset, ArrayLoader, make_scenes
from .transform import COCOTransform, FastCOCOTransform

__all__ = ["ArrayDataset", "ArrayLoader", "AspectRatioGroupedDataloader", "COCODataset",
           "COCOTransform", "DataLoader", "FastCOCOTransform", "VOCDataset", "collate",
           "collate_plus", "make_scenes"]
