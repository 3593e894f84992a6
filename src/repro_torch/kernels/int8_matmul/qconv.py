"""The int8 depth network's dense and pointwise convolutions in one launch.

``qconv_int8_pallas`` computes, for one layer of ``core/depth.py``'s
``forward_int8``, what the JAX package's ``_qconv(...) + b`` and then
``relu`` compute (``repro/core/depth.py``): quantise the float32 NHWC
activation with the per-tensor scale ``xscale``, convolve the int8 values
with the int8 weights in the im2col layout ``(k k cin, cout)`` (JAX's
``SAME`` padding), dequantise as ``(acc sx) wscale``, add the bias and,
unless ``relu=False`` (the head), apply the ReLU.  On a CUDA tensor it
launches ``qconv_int8_launch`` of ``csrc/int8_matmul.cu``, the int8
tensor-core product with the quantisation in its staging and the rest in
its epilogue; ``xscale`` stays on the card (read through a pointer, no
host sync).  The launch is bitwise equal to :func:`qconv_int8_ref`, its
plain version: every int32 sum is exact and every float step is rounded
once, in the same order.  On CPU tensors the wrapper takes the plain
version.  ``qconv_int8_pallas.launches`` counts its kernel launches.

The plain pieces (``SAME`` windows, ``im2col``, ``quantize_activation``,
the int32 convolution and the quantised convolution around it) live here;
``core/depth.py`` builds its depthwise layers and its ``"ref"`` path from
them.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.kernels._build import check
from repro_torch.kernels.int8_matmul.kernel import LIBRARY, MAX_K
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

# float32(1 / 127): XLA turns the reference's ``max(xscale, 1e-8) / 127.0``
# into a product with this constant when it compiles ``forward_int8``.
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def same_windows(x: Tensor, k: int, stride: int) -> list:
    """The ``k k`` shifted, strided views of NHWC ``x`` padded as JAX's
    ``SAME`` (at stride 2 an even input pads (0, 1)), in ``(dy, dx)``
    order: view ``(dy, dx)`` holds, for every output pixel, the input
    under that tap of the window."""
    h, w = x.shape[1], x.shape[2]
    ho, wo = -(-h // stride), -(-w // stride)
    ph = max((ho - 1) * stride + k - h, 0)
    pw = max((wo - 1) * stride + k - w, 0)
    xp = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    return [
        xp[:, dy:dy + (ho - 1) * stride + 1:stride,
           dx:dx + (wo - 1) * stride + 1:stride]
        for dy in range(k) for dx in range(k)
    ]


def im2col(x: Tensor, k: int,
           stride: int = 1) -> Tuple[Tensor, Tuple[int, int, int]]:
    """``(N, H, W, C)`` -> ``(N Ho Wo, k k C)``: one row per output pixel,
    its ``k x k`` window with columns ordered ``(dy, dx, c)``, so the HWIO
    kernel reshaped to ``(k k C, cout)`` multiplies it.  Returns the
    matrix and ``(N, Ho, Wo)``.  The windows are strided slices of the
    padded input, so any dtype works (``F.unfold`` takes no int8)."""
    n, c = x.shape[0], x.shape[3]
    windows = same_windows(x, k, stride)
    ho, wo = windows[0].shape[1:3]
    return (torch.stack(windows, dim=3).reshape(n * ho * wo, k * k * c),
            (n, ho, wo))


def quantize_activation(x: Tensor, xscale: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric per-tensor int8 of ``x``: ``(qx, sx)`` with ``x ~ qx sx``.

    As the JAX package's pipeline computes it under ``jax.jit``: the scale
    is ``max(xscale, 1e-8)`` times float32(1/127) (eager JAX divides by
    127, which can differ by an ulp and flip a rounded activation); the
    input is divided by the scale, not multiplied by its reciprocal, and
    rounded half to even.
    """
    sx = xscale.clamp_min(1e-8) * _INV_127
    return torch.round(x / sx).clamp(-127, 127).to(torch.int8), sx


def kernel_size(x: Tensor, qw: Tensor) -> int:
    """``k`` of a weight in the im2col layout ``(k k cin, cout)``."""
    cin = x.shape[-1]
    k = math.isqrt(qw.shape[0] // cin) if qw.shape[0] % cin == 0 else 0
    if k < 1 or k * k * cin != qw.shape[0]:
        raise ValueError(f"weight rows {qw.shape[0]} are not k k cin for "
                         f"cin={cin}")
    return k


def conv_int32(qx: Tensor, qw: Tensor, stride: int = 1,
               matmul: Callable[[Tensor, Tensor], Tensor] = int8_matmul_ref
               ) -> Tensor:
    """Exact int32 SAME convolution of int8 ``qx (N, H, W, cin)`` with an
    int8 kernel in the im2col layout ``(k k cin, cout)``: :func:`im2col`
    and the int8 product ``matmul``."""
    cols, (n, ho, wo) = im2col(qx, kernel_size(qx, qw), stride)
    return matmul(cols, qw).reshape(n, ho, wo, qw.shape[1])


def quantized_conv(x: Tensor, xscale: Tensor, qw: Tensor, wscale: Tensor,
                   stride: int, conv: Callable[[Tensor, Tensor, int], Tensor]
                   ) -> Tensor:
    """The JAX package's ``_qconv``: ``quantize_activation`` -> ``conv``
    (exact int32, ``conv(qx, qw, stride)``) -> ``(acc sx) wscale``, in
    that order."""
    qx, sx = quantize_activation(x, xscale)
    return conv(qx, qw, stride).to(torch.float32) * sx * wscale


def qconv_int8_ref(x: Tensor, xscale: Tensor, qw: Tensor, wscale: Tensor,
                   b: Tensor, *, stride: int = 1, relu: bool = True,
                   matmul: Callable[[Tensor, Tensor], Tensor] = int8_matmul_ref
                   ) -> Tensor:
    """The plain composition: ``quantize_activation`` -> im2col -> the
    int8 product (``matmul``, exact) -> ``(acc sx) wscale`` -> ``+ b`` ->
    ``relu``.  ``x (N, H, W, cin)`` float32 -> ``(N, Ho, Wo, cout)``."""
    out = quantized_conv(x, xscale, qw, wscale, stride,
                         partial(conv_int32, matmul=matmul)) + b
    return F.relu(out) if relu else out


def check_inputs(x: Tensor, xscale: Tensor, qw: Tensor, wscale: Tensor,
                 b: Tensor, stride: int) -> None:
    """Raise on inputs outside the op's contract or that the kernel does
    not take."""
    if x.ndim != 4 or qw.ndim != 2:
        raise ValueError(f"x must be (N, H, W, cin) and the weight 2-D; got "
                         f"{tuple(x.shape)}, {tuple(qw.shape)}")
    if xscale.ndim != 0:
        raise ValueError(f"xscale must be 0-dim, got {tuple(xscale.shape)}")
    cout = qw.shape[1]
    if tuple(wscale.shape) != (cout,) or tuple(b.shape) != (cout,):
        raise ValueError(f"wscale {tuple(wscale.shape)} and b "
                         f"{tuple(b.shape)} must be ({cout},)")
    if min(x.shape) < 1 or cout < 1:
        raise ValueError(f"empty convolution: x {tuple(x.shape)}, weight "
                         f"{tuple(qw.shape)}")
    kernel_size(x, qw)
    if qw.shape[0] >= MAX_K:
        raise ValueError(f"K={qw.shape[0]} >= 2^17 could overflow the int32 "
                         f"sums")
    if stride < 1:
        raise ValueError(f"stride {stride} < 1")
    if qw.dtype != torch.int8:
        raise TypeError(f"the weight must be int8, got {qw.dtype}")
    if any(t.dtype != torch.float32 for t in (x, xscale, wscale, b)):
        raise TypeError(f"x, xscale, wscale and b must be float32, got "
                        f"{x.dtype}, {xscale.dtype}, {wscale.dtype}, "
                        f"{b.dtype}")
    devices = {t.device for t in (x, xscale, qw, wscale, b)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"qconv runs on cpu or cuda, not {device}")
    if device.type == "cuda":
        for name, t in (("x", x), ("weight", qw), ("wscale", wscale),
                        ("b", b)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous for the kernel")


def qconv_int8_pallas(x: Tensor, xscale: Tensor, qw: Tensor, wscale: Tensor,
                      b: Tensor, *, stride: int = 1,
                      relu: bool = True) -> Tensor:
    """One dense or pointwise int8 layer: float32 NHWC ``x`` -> float32
    NHWC ``relu(dequantise(conv(quantise(x), qw)) + b)``."""
    check_inputs(x, xscale, qw, wscale, b, stride)
    if x.device.type == "cpu":
        return qconv_int8_ref(x, xscale, qw, wscale, b, stride=stride,
                              relu=relu)
    n, h, w, cin = x.shape
    k, cout = kernel_size(x, qw), qw.shape[1]
    out = torch.empty((n, -(-h // stride), -(-w // stride), cout),
                      dtype=torch.float32, device=x.device)
    err = LIBRARY.library().qconv_int8_launch(
        x.data_ptr(), xscale.data_ptr(), qw.data_ptr(), wscale.data_ptr(),
        b.data_ptr(), out.data_ptr(), n, h, w, cin, cout, k, stride,
        int(relu), torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(err, "qconv_int8_launch")
    qconv_int8_pallas.launches += 1
    return out


qconv_int8_pallas.launches = 0
