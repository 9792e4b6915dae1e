"""Serving artifacts: the fused image->masks program frozen to disk
(counterpart of ``orienmask_tpu/serving.py``).

``export_pipeline`` traces ``InferencePipeline.program`` (resize and
normalize, the folded forward in bf16, f32 or int8, the detect stage, NMS
and kernel 2's packed masks) with ``torch.export`` for each input shape and
saves it beside the folded weights and a JSON manifest.  ``load_serving``
brings it back WITHOUT any model construction, weight folding or tracing:
a serving host needs torch, numpy and the port's operator library
(``kernels/ops.py``, whose CUDA kernels ``kernels.library`` builds from
``csrc/`` at first use), not ``orienmask_tpu_torch.models``.  Artifact
layout:

    manifest.json               input shapes, trim rules, versions, weight metadata
    weights.npz                 folded weights, flattened in pytree order
    program_{B}x{H}x{W}x3_{platform}.pt2
                                one ``torch.export`` program per input shape
                                and platform

The weights are the programs' inputs, not constants in them, so the shapes
and platforms (``cpu``, ``cuda``: programs traced on each device, kernels 1
and 2 reached through their custom operators, whose CPU implementation is
the plain version) share one weight blob, and a new checkpoint of the same
architecture is an npz swap (``update_weights``) that leaves the programs
as they are.  A loader picks the programs of the device it loads on.

The programs are ``torch.export`` graphs of the same ATen operators and
custom operators that the live pipeline runs, not AOTInductor: Inductor
writes and fuses kernels of its own, whose bits need not equal the live
pipeline's, and a served program is held to the live one bit for bit.
"""

import hashlib
import json
import os

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .device import resolve_device
from .kernels import ops as _kernel_ops  # noqa: F401  registers omt:: before a load
from .ops.maskops import unpack_bits_np

MANIFEST = "manifest.json"
WEIGHTS = "weights.npz"
# 3: programs for several platforms (``programs_by_platform``); version 2
# artifacts (one platform, programs listed without one) still load
_FORMAT_VERSION = 3
PLATFORMS = ("cpu", "cuda")
# torch dtypes numpy cannot hold: stored as unsigned views of their width
_VIEWS = {torch.bfloat16: (torch.int16, np.uint16)}


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def _stored(t):
    """A weight leaf as the npz stores it (a host numpy array) and its digest."""
    t = t.detach().cpu()
    if t.dtype in _VIEWS:
        view, np_view = _VIEWS[t.dtype]
        arr = t.view(view).numpy().view(np_view)
    else:
        arr = t.numpy()
    return arr, _digest(arr)


def _digest(arr):
    return hashlib.sha256(arr.tobytes()).hexdigest()  # of the bytes in C order


def _arch_fingerprint(model, spec, flat):
    """Architecture identity: model class, weight-tree structure and each
    leaf's shape and dtype; a ``weights.npz`` of another variant with the
    same leaf count hashes otherwise."""
    h = hashlib.sha256()
    h.update(type(model).__name__.encode())
    h.update(str(spec).encode())
    for leaf in flat:
        h.update(repr(tuple(leaf.shape)).encode())
        h.update(_dtype_name(leaf.dtype).encode())
    return h.hexdigest()


def _write_weights(out_dir, flat):
    blobs, digests = {}, []
    for i, leaf in enumerate(flat):
        blobs["w%05d" % i], digest = _stored(leaf)
        digests.append(digest)
    np.savez(os.path.join(out_dir, WEIGHTS), **blobs)
    return digests


class _Program(torch.nn.Module):
    """``pipeline.program`` as a module of (flat weights, image), the form
    ``torch.export`` traces."""

    def __init__(self, pipeline, spec):
        super().__init__()
        self.run = pipeline.program
        self.spec = spec

    def forward(self, weights, image):
        return self.run(pytree.tree_unflatten(list(weights), self.spec), image)


def _platforms(pipeline, platforms):
    """The device types to export for: ``None`` is the pipeline's own;
    each must be one the port can trace for, present on this machine."""
    if platforms is None:
        return [pipeline.device.type]
    platforms = list(dict.fromkeys(platforms))
    if not platforms:
        raise ValueError("platforms must name at least one of " + ", ".join(PLATFORMS))
    for platform in platforms:
        if platform not in PLATFORMS:
            raise ValueError(
                f"platform {platform!r}: the port exports torch.export programs for "
                f"{', '.join(PLATFORMS)} only; JAX's StableHLO artifacts (platforms such as "
                "'tpu') do not load in the port (ROADMAP Queue 3, 'Serving')")
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("platform 'cuda': no CUDA device is available to trace its "
                               "program on; an export never falls back to another platform")
    return platforms


def _program_name(shape, platform):
    """``program_{B}x{H}x{W}x3_{platform}.pt2``; a loader reads the names
    from the manifest, so version-2 names still load."""
    return "program_" + "x".join(str(int(s)) for s in shape) + f"_{platform}.pt2"


def export_pipeline(pipeline, input_shapes, out_dir, platforms=None):
    """Export ``pipeline`` (an ``InferencePipeline``, bf16, f32 or int8)
    for serving.

    input_shapes: (B, H, W, 3) uint8 input shapes, one program each and
      platform.
    platforms: the device types the artifact runs on, any of ``"cpu"`` and
      ``"cuda"`` (JAX ``platforms=``); None is the pipeline's own device.
      Each platform's programs are traced from the pipeline's folded
      weights placed on that platform's device (``InferencePipeline.to``);
      all share the one ``weights.npz``.  A platform the port cannot trace
      for, or ``"cuda"`` with no card, raises.  A spatial pipeline
      (``space=``) is refused, as JAX's ``export_pipeline`` refuses a mesh:
      its program is one of a group of ranks, whose collectives an artifact
      cannot hold."""
    if getattr(pipeline, "space", None) is not None:
        raise ValueError("export_pipeline: a spatial pipeline (space=...) cannot be exported; "
                         "export the one-device pipeline")
    platforms = _platforms(pipeline, platforms)
    if not input_shapes:
        raise ValueError("input_shapes must name at least one (B, H, W, 3)")
    os.makedirs(out_dir, exist_ok=True)

    flat, spec = pytree.tree_flatten(pipeline.folded)
    digests = _write_weights(out_dir, flat)

    programs, by_platform = {}, {}
    for platform in platforms:
        live = pipeline.to(platform)
        module = _Program(live, spec)
        weights = tuple(pytree.tree_leaves(live.folded))
        by_platform[platform] = []
        for shape in input_shapes:
            shape = tuple(int(s) for s in shape)
            image = torch.zeros(shape, dtype=torch.uint8, device=live.device)
            live.run_device(image)  # builds the shape's constants before tracing
            with torch.no_grad():
                program = torch.export.export(module, (weights, image))
            program.example_inputs = None  # else the file keeps a copy of the weights
            name = _program_name(shape, platform)
            torch.export.save(program, os.path.join(out_dir, name))
            programs[name] = {"input_shape": list(shape), "platform": platform}
            by_platform[platform].append(name)

    post = pipeline.postprocess
    manifest = {
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "platforms": platforms,
        "programs_by_platform": by_platform,
        "n_weights": len(flat),
        "weight_dtypes": [_dtype_name(t.dtype) for t in flat],
        "weight_shapes": [list(t.shape) for t in flat],
        # each leaf's memory format as ``folded_to_device`` gave it (the
        # conv kernels channels_last): cuDNN picks its algorithm by strides
        "weight_strides": [list(t.stride()) for t in flat],
        "weight_digests": digests,
        "arch_fingerprint": _arch_fingerprint(pipeline.model, spec, flat),
        "programs": programs,
        # host-side trim rules (``postprocess.to_host_list``)
        "pack_masks": True,
        "image_size": [int(post.image_h), int(post.image_w)],
        "pad_info": list(pipeline.pad_info),
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=2)
    return manifest


def update_weights(out_dir, folded):
    """Swap in a new checkpoint's folded weights (same architecture) without
    re-exporting the programs: every leaf's dtype and shape is checked
    against the manifest and the digests are refreshed (a raw npz overwrite
    fails the load's checksum)."""
    with open(os.path.join(out_dir, MANIFEST)) as fh:
        manifest = json.load(fh)
    flat = pytree.tree_leaves(folded)
    if len(flat) != manifest["n_weights"]:
        raise ValueError("new weights have %d leaves, the artifact expects %d"
                         % (len(flat), manifest["n_weights"]))
    for i, leaf in enumerate(flat):
        if _dtype_name(leaf.dtype) != manifest["weight_dtypes"][i]:
            raise ValueError("leaf %d dtype %s != manifest %s — different model variant"
                             % (i, _dtype_name(leaf.dtype), manifest["weight_dtypes"][i]))
        if list(leaf.shape) != manifest["weight_shapes"][i]:
            raise ValueError("leaf %d shape %s != manifest %s — different model variant"
                             % (i, list(leaf.shape), manifest["weight_shapes"][i]))
    manifest["weight_digests"] = _write_weights(out_dir, flat)
    with open(os.path.join(out_dir, MANIFEST), "w") as fh:
        json.dump(manifest, fh, indent=2)


def _load_weight(arr, dtype, stride, device):
    """A stored blob as the weight the program was traced with: its dtype
    and its strides (memory format) on ``device``."""
    t = torch.from_numpy(arr)
    if dtype in _VIEWS:
        t = t.view(_VIEWS[dtype][0]).view(dtype)
    out = torch.empty_strided(t.shape, stride, dtype=dtype, device=device)
    return out.copy_(t)


class ServingModel:
    """A loaded serving artifact.  Its API mirrors ``InferencePipeline``:
    ``run_device`` returns the padded device dict, ``__call__`` (per-image
    trimmed host dicts, pad_info).  ``device=None`` is the card."""

    def __init__(self, out_dir, device=None):
        self.device = resolve_device(device)
        with open(os.path.join(out_dir, MANIFEST)) as fh:
            self.manifest = json.load(fh)
        if self.manifest["format_version"] > _FORMAT_VERSION:
            raise ValueError("artifact format %d is newer than this loader"
                             % self.manifest["format_version"])
        if self.device.type not in self.manifest["platforms"]:
            raise ValueError(f"the artifact runs on {self.manifest['platforms']}, not on "
                             f"{self.device.type}")
        n = self.manifest["n_weights"]
        blob = np.load(os.path.join(out_dir, WEIGHTS))
        if len(blob.files) != n:
            raise ValueError(
                "weights.npz has %d blobs but the manifest expects %d — the weight file does "
                "not belong to this artifact" % (len(blob.files), n))
        weights = []
        for i in range(n):
            arr = blob["w%05d" % i]
            if _digest(arr) != self.manifest["weight_digests"][i]:
                raise ValueError("weights.npz blob w%05d checksum mismatch (corrupt file or "
                                 "weights from a different export)" % i)
            if list(arr.shape) != self.manifest["weight_shapes"][i]:
                raise ValueError("weights.npz blob w%05d has shape %s, the manifest expects %s "
                                 "— weights from a different model variant"
                                 % (i, list(arr.shape), self.manifest["weight_shapes"][i]))
            weights.append(_load_weight(arr, getattr(torch, self.manifest["weight_dtypes"][i]),
                                        self.manifest["weight_strides"][i], self.device))
        self.weights = tuple(weights)
        self.arch_fingerprint = self.manifest["arch_fingerprint"]
        self._fns = {}
        names = self.manifest.get("programs_by_platform",
                                  {self.manifest["platforms"][0]: list(self.manifest["programs"])})
        for name in names[self.device.type]:
            meta = self.manifest["programs"][name]
            module = torch.export.load(os.path.join(out_dir, name)).module()
            # ``run_device`` checks the image's shape and dtype and the
            # weights were checked here: the module's own per-call check of
            # its 181 (bf16) or 343 (int8) inputs is left out
            module.validate_inputs = False
            self._fns[tuple(meta["input_shape"])] = module
        self.pad_info = tuple(self.manifest["pad_info"])
        self.image_h, self.image_w = self.manifest["image_size"]
        self.pack_masks = self.manifest["pack_masks"]

    @property
    def input_shapes(self):
        return sorted(self._fns)

    @torch.inference_mode()
    def run_device(self, image):
        """image: (B, H, W, 3) uint8 of an exported shape (tensor or numpy)
        -> device dict {'bbox', 'cls', 'mask', 'valid'}."""
        key = tuple(int(s) for s in image.shape)
        if key not in self._fns:
            raise KeyError("no exported program for input shape %s (artifact has %s)"
                           % (key, self.input_shapes))
        # the program was traced on uint8; a cast would truncate [0, 1] floats to 0
        uint8 = image.dtype == (torch.uint8 if isinstance(image, torch.Tensor) else np.uint8)
        if not uint8:
            raise TypeError(f"ServingModel.run_device expects a uint8 HWC image (got dtype="
                            f"{image.dtype}); pass the raw decoded image, not a normalized one")
        return self._fns[key](self.weights, torch.as_tensor(image).to(self.device))

    def to_host_list(self, device_out):
        out = {k: v.cpu().numpy() for k, v in device_out.items()}
        results = []
        for b in range(out["bbox"].shape[0]):
            n = int(out["valid"][b].sum())
            masks = out["mask"][b, :n]
            if self.pack_masks:  # unpack after the trim
                masks = unpack_bits_np(masks, self.image_w)
            results.append({"bbox": out["bbox"][b, :n], "mask": masks,
                            "cls": out["cls"][b, :n]})
        return results

    def __call__(self, image):
        return self.to_host_list(self.run_device(image)), self.pad_info


def load_serving(out_dir, device=None):
    return ServingModel(out_dir, device)
