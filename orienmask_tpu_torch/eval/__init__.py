"""COCO evaluation: RLE codec, LiteCOCOeval, COCOMetrics and the log counters
(counterpart of ``orienmask_tpu/eval``)."""

from . import rle
from .coco_eval import METRIC_KEYS, COCOMetrics
from .counter import EvalCounter
from .lite_cocoeval import COCOGroundTruth, LiteCOCOeval

__all__ = ["COCOGroundTruth", "COCOMetrics", "EvalCounter", "LiteCOCOeval", "METRIC_KEYS", "rle"]
