"""COCO evaluation: RLE codec, LiteCOCOeval and COCOMetrics (counterpart of
``orienmask_tpu/eval``)."""

from . import rle
from .coco_eval import METRIC_KEYS, COCOMetrics
from .lite_cocoeval import COCOGroundTruth, LiteCOCOeval

__all__ = ["COCOGroundTruth", "COCOMetrics", "LiteCOCOeval", "METRIC_KEYS", "rle"]
