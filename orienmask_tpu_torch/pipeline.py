"""Fused inference: uint8 image -> packed instance masks (counterpart of
``orienmask_tpu/pipeline.py::InferencePipeline``).

One call runs resize + normalize, the BN-folded forward (bf16 convolutions
on cuDNN, channels_last, f32 heads), the detect stage and the mask assembly,
with no host round trip except the NMS convergence check.
"""

import torch

from .device import resolve_device


def folded_to_device(tree, device, dtype):
    """BN-folded weights (``model.fold()``) on ``device``: conv kernels in
    ``dtype`` and channels_last for cuDNN, ConvBNLeaky biases in ``dtype``
    (the same bits as a cast per call), the heads' ``bias_f32`` in f32."""
    if isinstance(tree, list):
        return [folded_to_device(t, device, dtype) for t in tree]
    if isinstance(tree, dict) and "weight" in tree:
        weight = tree["weight"].to(device, dtype)
        out = {"weight": weight.contiguous(memory_format=torch.channels_last)}
        if "bias" in tree:
            out["bias"] = tree["bias"].to(device, dtype)
        if "bias_f32" in tree:
            out["bias_f32"] = tree["bias_f32"].to(device, torch.float32)
        return out
    return {k: folded_to_device(v, device, dtype) for k, v in tree.items()}


class InferencePipeline:
    def __init__(self, model, transform, postprocess, compute_dtype="bfloat16",
                 device=None):
        """``model``: an ``OrienMaskYOLOFPNPlus`` holding its weights (on the
        CPU is fine: only its folded copy moves to ``device``).
        ``postprocess`` must live on the same device."""
        self.device = resolve_device(device)
        if postprocess.device != self.device:
            raise ValueError(f"postprocess is on {postprocess.device}, "
                             f"the pipeline on {self.device}")
        self.model = model
        self.transform = transform
        self.postprocess = postprocess
        self.dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[compute_dtype]
        self.folded = folded_to_device(model.fold(), self.device, self.dtype)
        h, w = transform.size
        # transform resizes to the exact network size; padding is a no-op
        self.pad_info = (0, 0, 0, 0, h, w)

    @torch.inference_mode()
    def heads(self, image):
        """image: (B, H, W, 3) uint8 (tensor or numpy, any device) -> three
        (bbox, orien) head pairs in the JAX layout (B, h, w, C), f32."""
        x = torch.as_tensor(image).to(self.device).float()
        x = self.transform.apply(x)  # (B, h, w, 3) f32
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        predict = self.model.apply_folded(self.folded, x, self.dtype)
        return tuple((b.permute(0, 2, 3, 1), o.permute(0, 2, 3, 1)) for b, o in predict)

    @torch.inference_mode()
    def run_device(self, image):
        """image: (B, H, W, 3) uint8 -> device output dict
        {'bbox', 'cls', 'mask', 'valid'}."""
        return self.postprocess._run_batch(self.heads(image))

    def __call__(self, image):
        """image: (B, H, W, 3) -> (list of per-image detection dicts, pad_info)."""
        return self.postprocess.to_host_list(self.run_device(image)), self.pad_info
