"""Device resolution: the card by default, the CPU only when asked for."""

import torch


def resolve_device(device=None):
    """``None`` -> ``cuda``.  Raises when CUDA is asked for (explicitly or by
    default) and no card is present: nothing moves to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
