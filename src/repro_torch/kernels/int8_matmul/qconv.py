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

Under the serving pool's vmap the launch goes through the ``torch.library``
custom op ``repro_torch::qconv_int8`` (outside vmap the wrapper calls its
implementation straight), which also takes one scale per image
(``xscale`` of shape ``(N,)``).  Its vmap rule folds the vmapped dimension
into the batch, so one launch serves every slot, and each slot's
activations keep the scale a solo forward gives them (``x.abs().amax()``
of that slot's own tensor): one slot's frame never changes another's
quantisation.

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

from repro_torch.kernels import _slots
from repro_torch.kernels._build import check, check_contiguous, refuse_grad
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


def image_scales(x: Tensor, sx: Tensor) -> Tensor:
    """``sx`` shaped to broadcast against NHWC ``x``: a per-tensor scale as
    it is, one scale per image as ``(N, 1, 1, 1)``."""
    return sx.reshape(-1, 1, 1, 1) if sx.ndim == 1 else sx


def quantize_activation(x: Tensor, xscale: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric int8 of ``x``: ``(qx, sx)`` with ``x ~ qx sx``, per tensor
    (0-dim ``xscale``) or per image (``xscale`` of shape ``(N,)``; ``sx``
    then broadcasts as ``(N, 1, 1, 1)``).

    As the JAX package's pipeline computes it under ``jax.jit``: the scale
    is ``max(xscale, 1e-8)`` times float32(1/127) (eager JAX divides by
    127, which can differ by an ulp and flip a rounded activation); the
    input is divided by the scale, not multiplied by its reciprocal, and
    rounded half to even.
    """
    sx = image_scales(x, xscale.clamp_min(1e-8) * _INV_127)
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
    if xscale.ndim != 0 and tuple(xscale.shape) != (x.shape[0],):
        raise ValueError(f"xscale must be 0-dim or one per image "
                         f"({x.shape[0]},), got {tuple(xscale.shape)}")
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


def qconv_int8_plain(x: Tensor, xscale: Tensor, qw: Tensor, wscale: Tensor,
                     b: Tensor, stride: int, relu: bool) -> Tensor:
    """The fused layer on a batch of images, the op's CPU implementation:
    :func:`qconv_int8_ref`; ``xscale`` is per tensor or per image."""
    return qconv_int8_ref(x, xscale, qw, wscale, b, stride=stride, relu=relu)


qconv_int8_op = torch.library.custom_op(
    "repro_torch::qconv_int8", mutates_args=(),
    device_types="cpu")(qconv_int8_plain)


@qconv_int8_op.register_kernel("cuda")
def qconv_int8_launch(x, xscale, qw, wscale, b, stride, relu):
    check_contiguous(x=x, weight=qw, wscale=wscale, b=b, xscale=xscale)
    n, h, w, cin = x.shape
    k, cout = kernel_size(x, qw), qw.shape[1]
    out = torch.empty((n, -(-h // stride), -(-w // stride), cout),
                      dtype=torch.float32, device=x.device)
    err = LIBRARY.library().qconv_int8_launch(
        x.data_ptr(), xscale.data_ptr(), qw.data_ptr(), wscale.data_ptr(),
        b.data_ptr(), out.data_ptr(), n, h, w, cin, cout, k, stride,
        int(relu), int(xscale.ndim == 1),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(err, "qconv_int8_launch")
    qconv_int8_pallas.launches += 1
    return out


@qconv_int8_op.register_fake
def _(x, xscale, qw, wscale, b, stride, relu):
    n, h, w, _ = x.shape
    return x.new_empty((n, -(-h // stride), -(-w // stride), qw.shape[1]))


def _qconv_vmap(info, in_dims, x, xscale, qw, wscale, b, stride, relu):
    """One launch for every slot: the vmapped dimension joins the batch, and
    each image keeps its slot's scale (per image from then on)."""
    _slots.require_shared("qconv_int8", in_dims, ((2, "the weight"),
                                                  (3, "wscale"), (4, "b")))
    v = info.batch_size
    n = x.shape[0] if in_dims[0] is None else x.shape[
        1 if in_dims[0] == 0 else 0]
    xs = _slots.fold(x, in_dims[0], v)
    if in_dims[1] is None and xscale.ndim == 0:
        scales = xscale  # one scale for the whole fold, as before
    else:
        scales = xscale.movedim(in_dims[1], 0) if in_dims[1] is not None \
            else xscale.expand(v, *xscale.shape)
        # (V,) per slot, or (V, N) per image -> one scale per folded image.
        if scales.ndim == 2:
            scales = scales.flatten()
        elif n > 1:
            scales = scales.repeat_interleave(n)
        scales = scales.contiguous()
    out = qconv_int8_op(xs, scales, qw, wscale, b, stride, relu)
    return _slots.unfold(out, v), 0


torch.library.register_vmap(qconv_int8_op, _qconv_vmap)


def qconv_int8_pallas(x: Tensor, xscale: Tensor, qw: Tensor, wscale: Tensor,
                      b: Tensor, *, stride: int = 1,
                      relu: bool = True) -> Tensor:
    """One dense or pointwise int8 layer: float32 NHWC ``x`` -> float32
    NHWC ``relu(dequantise(conv(quantise(x), qw)) + b)``."""
    refuse_grad("qconv_int8_pallas", x, xscale, qw, wscale, b)
    check_inputs(x, xscale, qw, wscale, b, stride)
    op = _slots.pick(qconv_int8_op, qconv_int8_plain, qconv_int8_launch,
                     x.device)
    return op(x, xscale, qw, wscale, b, stride, relu)


qconv_int8_pallas.launches = 0
