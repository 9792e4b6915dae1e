"""PyTorch/CUDA port of OrienMask for NVIDIA Hopper: inference, the train step
and COCO evaluation.

Module names mirror ``orienmask_tpu`` so each port module sits beside its
counterpart.  The package imports torch and numpy only.  Every entry point
takes ``device=None``, meaning ``"cuda"``: without a card it raises unless
the caller asks for ``device="cpu"`` (``device.resolve_device``).

The kernels (top-k and mask assembly for inference and evaluation, the
per-detection mask assemblies, orientation painting for training) live in
``csrc/`` as CUDA C++ for ``sm_90a`` and are built at
first use by ``kernels``; each has a plain PyTorch version beside its
wrapper in ``ops/`` that runs for CPU tensors only.
"""
