"""Device-side inference transform (counterpart of ``FastCOCOTransform`` in
``orienmask_tpu/data/transform.py``): bilinear resize to the network size,
then normalize."""

import numpy as np
import torch

from ..models.layers import resize_matrices, resize_nhwc


def _pair(x):
    return (x, x) if isinstance(x, int) else tuple(x)


class FastCOCOTransform:
    def __init__(self, pipeline):
        self.size = None
        self.align_corners = False
        self.mean = np.zeros(3, np.float32)
        self.std = np.ones(3, np.float32)
        for item in pipeline:
            kind = item["type"]
            if kind == "Resize":
                self.size = _pair(item["size"])
                if item.get("interpolation", "bilinear") != "bilinear":
                    raise ValueError("FastCOCOTransform only implements bilinear resize")
                self.align_corners = item.get("align_corners", False)
            elif kind == "Normalize":
                self.mean = np.asarray(item["mean"], np.float32)
                self.std = np.asarray(item["std"], np.float32)
            else:
                raise ValueError(f"FastCOCOTransform: unsupported op {kind}")
        self._consts = {}  # (in_h, in_w, device) -> (mh, mw, mean, std)

    def _constants(self, in_h, in_w, device):
        key = (in_h, in_w, str(device))
        if key not in self._consts:
            mh, mw = resize_matrices((in_h, in_w), self.size, self.align_corners, device)
            self._consts[key] = (mh, mw, torch.from_numpy(self.mean).to(device),
                                 torch.from_numpy(self.std).to(device))
        return self._consts[key]

    def apply(self, image):
        """image: (B, H, W, 3) f32 -> resized + normalized (B, h, w, 3) f32:
        two matmuls along H then W (``layers.bilinear_resize``), then
        ``(x - mean) / std``."""
        mh, mw, mean, std = self._constants(image.shape[1], image.shape[2], image.device)
        return (resize_nhwc(image, mh, mw) - mean) / std
