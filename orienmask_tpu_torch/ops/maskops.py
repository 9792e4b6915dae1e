"""Bit-packing of boolean masks (counterpart of ``orienmask_tpu/ops/maskops.py``)."""

import numpy as np
import torch
import torch.nn.functional as F

def pack_bits(masks):
    """(..., W) bool -> (..., ceil(W/8)) uint8, MSB first (as np.packbits)."""
    pad = (-masks.shape[-1]) % 8
    g = masks.to(torch.uint8)
    if pad:
        g = F.pad(g, (0, pad))
    g = g.reshape(*g.shape[:-1], -1, 8)
    # bit weights 128..1 made on the device: no host copy, so a CUDA graph
    # can capture it
    shift = torch.arange(7, -1, -1, dtype=torch.uint8, device=masks.device)
    return (g << shift).sum(dim=-1).to(torch.uint8)


def unpack_bits_np(packed, width):
    """Inverse of pack_bits on host numpy: (..., W/8) uint8 -> (..., width) bool."""
    bits = np.unpackbits(np.asarray(packed), axis=-1)
    return bits[..., :width].astype(bool)
