"""Inference visualizer (counterpart of ``orienmask_tpu/utils/visualizer.py``)
in numpy, without cv2.

Draws alpha-composited instance masks (area-sorted, cumulative-product
blending) and labelled boxes on the original-resolution image; boxes and
masks are mapped back through the letterbox ``pad_info``.  Each cv2 call of
the JAX module has an exact numpy counterpart here:

* ``cv2.resize(INTER_LINEAR)`` of the float32 masks: ``ops.resize.resize_linear``,
  which does OpenCV's arithmetic (the fraction of each source position computed in
  double and rounded to float, ``1 - f`` in float, each pass a fused
  ``(b - a) * f + a``);
* ``cv2.rectangle`` at thickness 1 (LINE_8) and filled: axis-aligned, so the
  outline and the fill are index ranges clipped to the image;
* ``cv2.putText(FONT_HERSHEY_DUPLEX, 0.4, white, 1, LINE_AA)`` and
  ``cv2.getTextSize``: the glyph atlas ``label_font.npz`` (made by
  ``probe/make_glyph_atlas.py`` with cv2, which checks the rule it relies
  on): each character's coverage at whole-pixel pen positions, blended in
  order as ``(dst * (255 - a) + 255 * a + 127) // 255``.

The mask blend runs a loop over the detections that multiplies and adds in
the order numpy's ``cumprod`` and ``sum(axis=0)`` do, so it gives the JAX
module's bits without its (K, H, W, 3) temporary.
"""

import random
from pathlib import Path

import numpy as np

from ..ops.resize import resize_linear

PALETTE = np.array([
    (244, 67, 54), (233, 30, 99), (156, 39, 176), (103, 58, 183), (63, 81, 181),
    (33, 150, 243), (3, 169, 244), (0, 188, 212), (0, 150, 136), (76, 175, 80),
    (139, 195, 74), (205, 220, 57), (255, 235, 59), (255, 193, 7), (255, 152, 0),
    (255, 87, 34), (121, 85, 72), (158, 158, 158), (96, 125, 139),
], np.float32)

FONT_ATLAS = Path(__file__).resolve().with_name("label_font.npz")


class LabelFont:
    """The label font of the JAX visualizer, from its glyph atlas."""

    def __init__(self, path=FONT_ATLAS):
        with np.load(path) as atlas:
            self.height = int(atlas["height"])
            chars, shapes = str(atlas["chars"]), atlas["shape"]
            offsets = np.cumsum([0] + [int(h) * int(w) for h, w in shapes])
            self.glyphs = {}
            for i, c in enumerate(chars):
                h, w = (int(v) for v in shapes[i])
                coverage = atlas["alpha"][offsets[i]:offsets[i + 1]].reshape(h, w)
                self.glyphs[c] = (int(atlas["advance"][i]), int(atlas["top"][i]),
                                  int(atlas["left"][i]), coverage.astype(np.int32))

    def text_size(self, text):
        """``cv2.getTextSize(text, FONT_HERSHEY_DUPLEX, 0.4, 1)[0]``."""
        return sum(self.glyphs[c][0] for c in text) + 1, self.height

    def put_text(self, image, text, org):
        """``cv2.putText(image, text, org, ..., (255, 255, 255), 1, LINE_AA)``
        on an (H, W, 3) uint8 image, in place."""
        height, width = image.shape[:2]
        x, y = org
        for c in text:
            advance, top, left, coverage = self.glyphs[c]
            y0, x0 = y + top, x + left
            h, w = coverage.shape
            ya, yb, xa, xb = max(y0, 0), min(y0 + h, height), max(x0, 0), min(x0 + w, width)
            if ya < yb and xa < xb:
                a = coverage[ya - y0:yb - y0, xa - x0:xb - x0, None]
                dst = image[ya:yb, xa:xb].astype(np.int32)
                image[ya:yb, xa:xb] = (dst * (255 - a) + 255 * a + 127) // 255
            x += advance


class InferenceVisualizer:
    def __init__(self, dataset, with_mask=True, conf_thresh=0.3, alpha=0.5,
                 line_thickness=1, device=None):
        from ..data import dataset as dataset_module

        if line_thickness != 1:
            raise ValueError(f"line_thickness {line_thickness}: only the configs' 1 is ported")
        ds = getattr(dataset_module, dataset + "Dataset")
        self.classes = ds.CLASSES
        self.with_mask = with_mask
        self.conf_thresh = conf_thresh
        self.alpha = alpha
        self.line_thickness = line_thickness
        self.font = LabelFont()

    def __call__(self, detections, image, pad_info):
        """detections: per-image dict (numpy); image: HxWx3 float RGB original;
        pad_info: (left, right, top, down, h, w) of the network-input letterbox."""
        show = np.asarray(image, np.float32).copy()
        height, width = show.shape[:2]

        bbox = np.asarray(detections["bbox"]).reshape(-1, 5)
        cls = np.asarray(detections["cls"]).reshape(-1)
        keep = bbox[:, -1] > self.conf_thresh
        bbox, cls = bbox[keep], cls[keep]
        masks = np.asarray(detections["mask"])[keep] if self.with_mask else None

        if bbox.shape[0] == 0:
            return np.clip(np.round(show), 0, 255).astype(np.uint8)

        xyxy = self._recover_shape_bbox(bbox[:, :4], width, height, pad_info)
        colors_idx = np.arange(bbox.shape[0]) * 5 + random.randint(1, len(PALETTE))
        colors = PALETTE[colors_idx % len(PALETTE)]

        if self.with_mask:
            all_mask = self._recover_shape_segm(masks, width, height, pad_info)
            order = np.argsort(all_mask.sum(axis=(1, 2)))
            all_mask = all_mask[order]
            self._plot_all_mask(all_mask, show, colors[order])

        show = np.clip(np.round(show), 0, 255).astype(np.uint8)
        for box, score, c, color in zip(xyxy, bbox[:, -1], cls, colors):
            text = "%s %.2f" % (self.classes[int(c)], score)
            self._plot_one_box(box, text, show, color.astype(np.uint8))
        return show

    def _plot_one_box(self, box, text, image, color):
        x1, y1, x2, y2 = [int(v) for v in box]
        height, width = image.shape[:2]
        xa, xb = max(min(x1, x2), 0), min(max(x1, x2), width - 1)
        ya, yb = max(min(y1, y2), 0), min(max(y1, y2), height - 1)
        if xa <= xb:
            for y in (y1, y2):  # the outline's rows and columns, clipped
                if 0 <= y < height:
                    image[y, xa:xb + 1] = color
        if ya <= yb:
            for x in (x1, x2):
                if 0 <= x < width:
                    image[ya:yb + 1, x] = color
        tw, th = self.font.text_size(text)
        _fill(image, (x1, y1), (x1 + tw, y1 - th - 4), color)
        self.font.put_text(image, text, (x1, y1 - 3))

    def _plot_all_mask(self, masks, image, colors):
        """Cumulative-product alpha blending, back-to-front (reference
        visualizer.py:95-100): the JAX module's
        ``image * cumprod(1 - a m)[-1] + a c_0 m_0
        + sum_k (a c_{k+1} m_{k+1}) * cumprod(1 - a m)[k]``, one detection at
        a time in numpy's order of operations."""
        a = self.alpha
        n = masks.shape[0]
        cum = None
        for k in range(n):
            f = 1 - a * masks[k]
            cum = f if cum is None else cum * f
        image *= cum[..., None]
        image += masks[0][..., None] * colors[0] * a
        if n > 1:
            total, cum = None, None
            for k in range(n - 1):
                f = 1 - a * masks[k]
                cum = f if cum is None else cum * f
                term = (masks[k + 1][..., None] * colors[k + 1] * a) * cum[..., None]
                if total is None:
                    total = term
                else:
                    total += term
            image += total

    @staticmethod
    def _recover_shape_bbox(bbox, width, height, pad_info):
        bx, by, bw, bh = [bbox[:, i].astype(np.float64) for i in range(4)]
        left, right, top, down, h, w = pad_info
        nh, nw = h - top - down, w - left - right
        bx = (bx * w - left) / nw
        by = (by * h - top) / nh
        bw, bh = bw * w / nw, bh * h / nh
        return np.round(np.stack([
            (bx - bw / 2) * width, (by - bh / 2) * height,
            (bx + bw / 2) * width, (by + bh / 2) * height,
        ], axis=1)).astype(np.int64)

    @staticmethod
    def _recover_shape_segm(masks, width, height, pad_info):
        left, right, top, down = pad_info[:4]
        m = masks[:, top:masks.shape[1] - down or None,
                  left:masks.shape[2] - right or None]
        out = np.zeros((m.shape[0], height, width), np.float32)
        for i in range(m.shape[0]):
            out[i] = resize_linear(m[i].astype(np.float32), width, height)
        return out


def _fill(image, p1, p2, color):
    """``cv2.rectangle(image, p1, p2, color, -1)``: the corners' box,
    inclusive, clipped to the image."""
    height, width = image.shape[:2]
    xa, xb = max(min(p1[0], p2[0]), 0), min(max(p1[0], p2[0]), width - 1)
    ya, yb = max(min(p1[1], p2[1]), 0), min(max(p1[1], p2[1]), height - 1)
    if xa <= xb and ya <= yb:
        image[ya:yb + 1, xa:xb + 1] = color
