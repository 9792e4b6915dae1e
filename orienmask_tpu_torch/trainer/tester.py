"""COCO test loop with per-stage timing (counterpart of
``orienmask_tpu/trainer/tester.py``).

Per batch: the BN-folded forward in the config's dtype (f32 for the test
configs), the postprocess on the card, the host copy of its outputs and
their COCO-format conversion (timed whole and by part: the copy, the boxes,
the masks' resize and their RLE encoding); then ``COCOMetrics.coco_eval``
over the whole set, the bbox and segm tables, and each stage's ms per
image.  Multi-device evaluation (JAX's ``mesh``) is not ported.
"""

import itertools
import time

import torch

from ..device import resolve_device
from ..eval.coco_eval import METRIC_KEYS, COCOMetrics
from ..pipeline import folded_to_device
from ..utils import timer
from .train_state import DTYPES, _image_f32


def _pipe_table(headers, rows):
    """A pipe-delimited table of strings and floats (floats to 3 places)."""
    def cell(v):
        return "" if v is None else f"{v:.3f}" if isinstance(v, float) else str(v)

    def line(vals):
        return "| " + " | ".join(v.ljust(w) for v, w in zip(vals, widths)) + " |"

    rows = [[cell(v) for v in row] for row in rows]
    widths = [max(len(h), *(len(r[i]) for r in rows)) for i, h in enumerate(headers)]
    rule = "|" + "|".join(":" + "-" * (w + 1) for w in widths) + "|"
    return "\n".join([line(headers), rule] + [line(r) for r in rows])


class Tester:
    def __init__(self, model, state, postprocess, test_loader, checkpoint_dir, gt_file,
                 compute_dtype="float32", device=None):
        """``model``: an ``OrienMaskYOLOFPNPlus``; ``state``: its state dict
        to load (strict), or None when it already holds its weights (for
        example through ``load_checkpoint``).  ``postprocess`` must live on
        ``device`` (None: the card).  ``test_loader`` yields batches
        ``{"image": (B, H, W, 3) uint8 or f32, "info": [dict]}`` and has
        ``batch_size``, ``len()`` and a ``dataset`` with ``CAT2LABEL``,
        ``CLASSES`` and ``with_mask``.  Prediction files go to
        ``checkpoint_dir``."""
        self.device = resolve_device(device)
        if postprocess.device != self.device:
            raise ValueError(f"postprocess is on {postprocess.device}, "
                             f"the tester on {self.device}")
        if state is not None:
            model.load_state_dict(state, strict=True)
        self.model = model
        self.postprocess = postprocess
        self.test_loader = test_loader
        self.checkpoint_dir = checkpoint_dir
        self.gt_file = gt_file
        self.dtype = DTYPES[compute_dtype]
        self.coco_metrics = COCOMetrics(
            gt_file=gt_file,
            cat2label=test_loader.dataset.CAT2LABEL,
            with_mask=getattr(test_loader.dataset, "with_mask", True),
            save_dir=checkpoint_dir,
        )
        self._folded = folded_to_device(model.fold(), self.device, self.dtype)
        self.loop_seconds = self.coco_eval_seconds = None  # wall times of the last test()

    @torch.inference_mode()
    def forward(self, image):
        """(B, H, W, 3) uint8 or f32 on the tester's device -> three
        (bbox, orien) head pairs in the JAX layout (B, h, w, C), f32."""
        x = _image_f32(image).permute(0, 3, 1, 2)  # NCHW view, channels_last
        predict = self.model.apply_folded(self._folded, x, self.dtype)
        return tuple((b.permute(0, 2, 3, 1), o.permute(0, 2, 3, 1)) for b, o in predict)

    def test(self):
        timer.reset()
        start = time.perf_counter()
        for batch in self.test_loader:
            image = torch.as_tensor(batch["image"]).to(self.device)
            info = batch.get("info")

            with timer.timer("Network Forward") as t:
                predict = t.sync(self.forward(image))

            with timer.timer("Postprocess") as t:
                device_out = t.sync(self.postprocess.apply_device(predict))

            with timer.timer("Convert Format"):
                with timer.timer("To Host List"):
                    detections = self.postprocess.to_host_list(device_out)
                dets = self.coco_metrics.to_coco_format(info, detections)

            self.coco_metrics.update_results(dets)

        self.loop_seconds = time.perf_counter() - start
        start = time.perf_counter()
        self.coco_metrics.coco_eval(per_cats=True)
        self.coco_eval_seconds = time.perf_counter() - start
        self.display_coco_eval("bbox")
        if self.coco_metrics.with_mask:
            self.display_coco_eval("segm")

        timer_log = timer.get_all_elapsed_time()
        bs = self.test_loader.batch_size
        print("\n" + "-" * 68)
        print(f"Speed Statistics (batch size = {bs})")
        for key, value in timer_log.items():
            print("%s: %.3fms (%.3ffps)" % (key, value / bs, 1000 * bs / value))

    def display_coco_eval(self, eval_type="bbox"):
        if eval_type == "bbox":
            stats = self.coco_metrics.bbox_eval_stats
            per_cats = self.coco_metrics.bbox_eval_per_cats_stats
        else:
            stats = self.coco_metrics.segm_eval_stats
            per_cats = self.coco_metrics.segm_eval_per_cats_stats
        print(f"\nCOCO eval {eval_type}: \n"
              + _pipe_table(METRIC_KEYS, [[float(v) for v in stats]]))

        pairs = list(zip(self.test_loader.dataset.CLASSES, per_cats))
        if pairs:
            n_cols = min(6, len(pairs) * 2)
            flat = list(itertools.chain(*pairs))
            rows = itertools.zip_longest(*[flat[i::n_cols] for i in range(n_cols)])
            print(f"\nPer-category {eval_type} AP: \n"
                  + _pipe_table(["category", "AP"] * (n_cols // 2), list(rows)))
