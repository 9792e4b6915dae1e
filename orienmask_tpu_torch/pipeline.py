"""Fused inference: uint8 image -> packed instance masks (counterpart of
``orienmask_tpu/pipeline.py::InferencePipeline``).

One call runs resize + normalize, the BN-folded forward (bf16 convolutions
on cuDNN, channels_last, f32 heads), the detect stage and the mask assembly,
with no host round trip except the NMS convergence check.  ``quantize_int8``
turns the ConvBNLeaky convolutions into int8 ones (``models/quantize.py``).
``program`` is that call as a function of (folded weights, uint8 image):
``run_device`` runs it on ``self.folded``, and ``serving.export_pipeline``
traces it with ``torch.export``, so live and served run the same code.

``space`` (a ``parallel/spatial.py::SpaceGroup``) row-shards the forward
over the ranks of a space group, every rank running the same calls on the
same images (JAX ``mesh=``): the transform on the whole image, the folded
forward on the rank's rows with its halos, the heads gathered whole on
every rank; with ``spatial_masks`` the postprocess's image-resolution tail
too (``run_batch_spatial``).  Every rank returns the whole outputs.
"""

import torch

from .device import resolve_device
from .models.quantize import calibrate_folded, cast_kernels, quantize_folded
from .parallel.spatial import run_batch_spatial, spatial_forward


def folded_to_device(tree, device, dtype):
    """BN-folded weights (``model.fold()``) on ``device``: conv kernels in
    ``dtype`` and channels_last for cuDNN, ConvBNLeaky biases in ``dtype``
    (the same bits as a cast per call), the heads' ``bias_f32`` in f32.
    int8 leaves (``quantize_folded``) keep their types: ``qkernel``
    channels_last, ``in_inv``, ``oscale`` and ``bias`` f32."""
    if isinstance(tree, list):
        return [folded_to_device(t, device, dtype) for t in tree]
    if isinstance(tree, dict) and "qkernel" in tree:
        return {"qkernel": tree["qkernel"].to(device).contiguous(
                    memory_format=torch.channels_last),
                **{k: tree[k].to(device, torch.float32) for k in ("in_inv", "oscale", "bias")}}
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
                 device=None, space=None, spatial_masks="auto"):
        """``model``: an OrienMask model (either variant) holding its weights (on the
        CPU is fine: only its folded copy moves to ``device``).
        ``postprocess`` must live on the same device.  ``space``: this
        rank's ``SpaceGroup`` (``parallel/spatial.py::spatial_groups``), or
        None for one device.  ``spatial_masks`` (with a space group of more
        than one rank): ``"auto"`` row-shards the postprocess's tail where
        the network height divides by ``n_space``, True requires it, False
        runs the replicated ``_run_batch`` on the gathered heads (JAX
        ``InferencePipeline(mesh=, spatial_masks=)``)."""
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
        self.space = space
        self.spatial_masks = False
        if space is not None and space.n_space > 1:
            divides = h % space.n_space == 0
            if spatial_masks is True and not divides:
                raise ValueError(f"spatial_masks: network height {h} not divisible by "
                                 f"n_space={space.n_space}")
            self.spatial_masks = spatial_masks is True or (spatial_masks == "auto" and divides)
        # transform resizes to the exact network size; padding is a no-op
        self.pad_info = (0, 0, 0, 0, h, w)

    def quantize_int8(self, calib_images, stem=False):
        """Switch the folded forward to int8 convolutions (JAX
        ``InferencePipeline.quantize_int8``): the model's folded weights
        with their kernels in the compute dtype (JAX's ``self.folded``) are
        calibrated on ``calib_images`` (raw (N, H, W, 3) images, through
        this pipeline's transform, in f32 on its device), quantized, and put
        on the device.  ``stem=True`` quantizes conv1, conv2 and conv3[0]
        too; the heads' logit convolutions stay float.  The contract of
        ``run_device`` and ``__call__`` is unchanged."""
        folded = cast_kernels(self.model.fold(), self.dtype)
        scales = calibrate_folded(self.model, folded_to_device(folded, self.device, torch.float32),
                                  calib_images, self.transform)
        self.folded = folded_to_device(
            quantize_folded(self.model, folded, scales, exclude_stem=not stem), self.device,
            self.dtype)
        return self

    def _heads(self, folded, image):
        x = self.transform.apply(image.float())  # (B, h, w, 3) f32
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        if self.space is not None:
            predict = spatial_forward(self.model, self.space, self.dtype)(folded, x)
        else:
            predict = self.model.apply_folded(folded, x, self.dtype)
        return tuple((b.permute(0, 2, 3, 1), o.permute(0, 2, 3, 1)) for b, o in predict)

    @torch.inference_mode()
    def heads(self, image):
        """image: (B, H, W, 3) uint8 (tensor or numpy, any device) -> three
        (bbox, orien) head pairs in the JAX layout (B, h, w, C), f32."""
        return self._heads(self.folded, torch.as_tensor(image).to(self.device))

    def program(self, folded, image):
        """(folded weights, (B, H, W, 3) uint8 image on the device) -> device
        dict {'bbox', 'cls', 'mask', 'valid'} (JAX ``InferencePipeline
        ._make_run``): transform, folded forward, postprocess.  Its constants
        for an input shape (the transform's resize matrices, the orientation
        upsample's) are built at its first eager call at that shape.  Under
        a space group this rank's share of it (``parallel/spatial.py``)."""
        predict = self._heads(folded, image)
        if self.spatial_masks:
            return run_batch_spatial(self.postprocess, self.space, predict)
        return self.postprocess._run_batch(predict)

    @torch.inference_mode()
    def run_device(self, image):
        """image: (B, H, W, 3) uint8 -> device output dict
        {'bbox', 'cls', 'mask', 'valid'}."""
        return self.program(self.folded, torch.as_tensor(image).to(self.device))

    def __call__(self, image):
        """image: (B, H, W, 3) -> (list of per-image detection dicts, pad_info)."""
        return self.postprocess.to_host_list(self.run_device(image)), self.pad_info
