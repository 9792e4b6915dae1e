"""Exact int8 convolution of the quantized folded forward (counterpart of
the int8 ``conv_general_dilated`` with ``preferred_element_type=int32`` in
``orienmask_tpu/models/layers.py:70-88``: XLA's work in JAX, not a Pallas
kernel).

On the card it is cuBLAS's int8 tensor-core GEMM through ``torch._int_mm``
(int8 x int8 -> int32).  A 1x1 convolution multiplies the channels_last
activation as it lies, (B*H*W, Cin) x (Cin, Cout); a k x k convolution
first builds its im2col matrix (B*Ho*Wo, k*k*Cin) from the k*k shifted,
strided slices of the zero-padded NHWC activation, stacked in the kernel's
(kh, kw, cin) order (``F.conv2d`` and ``F.unfold`` take no int8 on the
card).  ``_int_mm`` takes M > 16 and K and N multiples of 8: K is
zero-padded to a multiple of 8 (conv1's 27 to 32, exact), and a shape it
refuses raises; nothing falls back to a float convolution.  At 544² and
B = 16 the largest im2col matrix, a 3x3 convolution of 128 channels at
136², takes 341 MB.

The plain version, the spec, runs on the CPU: a float64 ``F.conv2d`` of
the int8 values is exact, since |sum| <= 127² * 4,608 < 2^53.  Both are
exact, so the card's int32 output equals the plain version's bit for bit.
"""

import torch
import torch.nn.functional as F


def conv2d_int8_plain(q, qkernel, stride=1, padding=0):
    """q (B, Cin, H, W) int8, qkernel (Cout, Cin, k, k) int8 -> (B, Cout,
    Ho, Wo) int32, torch's convolution arithmetic (symmetric zero padding)."""
    return F.conv2d(q.double(), qkernel.double(), None, stride, padding).to(torch.int32)


def im2col_nhwc(q, ksize, stride, padding):
    """q (B, C, H, W) (an NCHW view, channels_last in memory) -> the
    (B*Ho*Wo, ksize*ksize*C) matrix of its convolution windows in (kh, kw,
    c) order, and (B, Ho, Wo).  ``padding``: an int, or (rows, columns)
    (a row shard whose halo rows are already in place pads its columns
    alone)."""
    x = q.permute(0, 2, 3, 1)
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    b, hp, wp, c = x.shape
    ho, wo = (hp - ksize) // stride + 1, (wp - ksize) // stride + 1
    taps = [x[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
            for i in range(ksize) for j in range(ksize)]
    cols = taps[0] if ksize == 1 else torch.stack(taps, dim=3)
    return cols.reshape(b * ho * wo, ksize * ksize * c), (b, ho, wo)


def conv2d_int8(q, qkernel, stride=1, padding=0):
    """``conv2d_int8_plain``'s function: the plain version for CPU tensors,
    ``conv2d_int8_gemm`` for CUDA tensors."""
    if q.dtype != torch.int8 or qkernel.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {q.dtype} and {qkernel.dtype}")
    if q.device.type == "cpu":
        return conv2d_int8_plain(q, qkernel, stride, padding)
    if q.device.type != "cuda" or qkernel.device != q.device:
        raise ValueError(f"conv2d_int8 takes CPU or CUDA tensors on one device, got "
                         f"{q.device} and {qkernel.device}")
    return conv2d_int8_gemm(q, qkernel, stride, padding)


def conv2d_int8_gemm(q, qkernel, stride=1, padding=0):
    """The card's route: im2col and ``torch._int_mm`` (the output an NCHW
    view, channels_last in memory).  ``_int_mm`` also runs on the CPU, where
    the tests hold this route's shapes and layouts to the plain version."""
    cout, cin, kh, kw = qkernel.shape
    if kh != kw or q.shape[1] != cin:
        raise ValueError(f"kernel {tuple(qkernel.shape)} for input {tuple(q.shape)}")
    a, (b, ho, wo) = im2col_nhwc(q, kh, stride, padding)
    w = qkernel.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)  # (kh, kw, cin) order
    pad_k = -a.shape[1] % 8
    if pad_k:
        a, w = F.pad(a, (0, pad_k)), F.pad(w, (0, pad_k))
    if a.shape[0] <= 16 or cout % 8:
        raise ValueError(f"torch._int_mm takes M > 16 and N a multiple of 8: M = {a.shape[0]}, "
                         f"N = {cout}")
    y = torch._int_mm(a, w.t())  # (M, Cout) int32; w.t() column-major
    return y.view(b, ho, wo, cout).permute(0, 3, 1, 2)
