"""Depth Estimation Module (EPIC paper, Section 3.2), fp32.

Port of ``repro.core.depth``: a FastDepth-style monocular depth CNN on a
64x64 input (the paper resizes the frame to 64x64 and interpolates the
prediction back), with a depthwise-separable encoder and a
nearest-upsample decoder with additive skips.  The int8 path
(``QuantizedParams`` / ``forward_int8``) comes with the int8 kernel.

The public functions keep the JAX package's NHWC layout; the network
runs NCHW inside.  Two framework differences are handled here:

* ``SAME`` padding: for an even input at stride 2, JAX pads (0, 1) while
  ``padding=1`` pads (1, 1); :func:`conv2d_same` pads explicitly.
* ``jax.image.resize`` antialiases when it downsamples;
  :func:`resize_image` asks ``F.interpolate`` for the same.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F
from torch import Tensor, nn

DEPTH_INPUT = 64  # paper: inputs resized to 64x64

# (name, kind, c_in, c_out, stride); kind: 'conv' 3x3, 'dw' depthwise+pointwise
_ENCODER = (
    ("enc0", "conv", 3, 16, 2),  # 64 -> 32
    ("enc1", "dw", 16, 32, 2),  # 32 -> 16
    ("enc2", "dw", 32, 64, 2),  # 16 -> 8
    ("enc3", "dw", 64, 64, 1),  # 8 -> 8
)
_DECODER = (
    ("dec0", "dw", 64, 32, 1),  # up 8 -> 16, skip enc1 out
    ("dec1", "dw", 32, 16, 1),  # up 16 -> 32, skip enc0 out
    ("dec2", "dw", 16, 16, 1),  # up 32 -> 64
)
_HEAD = ("head", "conv", 16, 1, 1)
_SKIPS = ("enc1", "enc0", None)


def conv_init(generator: torch.Generator, kh: int, kw: int, cin: int,
              cout: int) -> Tensor:
    """He-normal ``(cout, cin, kh, kw)`` weight on the generator's device."""
    std = math.sqrt(2.0 / (kh * kw * cin))
    return torch.randn(
        (cout, cin, kh, kw), generator=generator, device=generator.device
    ) * std


def conv2d_same(x: Tensor, w: Tensor, stride: int = 1, groups: int = 1) -> Tensor:
    """NCHW convolution with JAX's ``SAME`` padding (extra pad at the end)."""
    pads = []
    for size, k in ((x.shape[3], w.shape[3]), (x.shape[2], w.shape[2])):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w, stride=stride, groups=groups)


class _Layer(nn.Module):
    """3x3 conv, or depthwise 3x3 + pointwise 1x1; bias; ReLU (not on the
    head).  Parameter names are the JAX pytree's keys."""

    def __init__(self, kind: str, cin: int, cout: int, stride: int,
                 generator: torch.Generator, relu: bool = True):
        super().__init__()
        self.kind, self.stride, self.relu = kind, stride, relu
        if kind == "conv":
            self.w = nn.Parameter(conv_init(generator, 3, 3, cin, cout))
        else:
            # Depthwise (cin, 1, 3, 3) with groups=cin; JAX (3, 3, 1, cin).
            self.dw = nn.Parameter(
                conv_init(generator, 3, 3, 1, cin).reshape(cin, 1, 3, 3)
            )
            self.pw = nn.Parameter(conv_init(generator, 1, 1, cin, cout))
        self.b = nn.Parameter(
            torch.zeros(cout, device=generator.device)
        )

    def forward(self, x: Tensor) -> Tensor:
        if self.kind == "conv":
            x = conv2d_same(x, self.w, self.stride)
        else:
            x = conv2d_same(x, self.dw, self.stride, groups=x.shape[1])
            x = conv2d_same(x, self.pw)
        x = x + self.b[:, None, None]
        return F.relu(x) if self.relu else x


class DepthNet(nn.Module):
    """FastDepth-lite; weights drawn from ``generator`` on its device."""

    def __init__(self, generator: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleDict(
            {
                name: _Layer(kind, cin, cout, stride, generator,
                             relu=name != _HEAD[0])
                for name, kind, cin, cout, stride in _ENCODER + _DECODER
                + (_HEAD,)
            }
        )

    def forward(self, rgb64: Tensor) -> Tensor:
        """``(B, 64, 64, 3)`` RGB in [0, 1] -> ``(B, 64, 64)`` depth > 0."""
        x = rgb64.permute(0, 3, 1, 2)
        skips = {}
        for name, *_ in _ENCODER:
            x = self.layers[name](x)
            skips[name] = x
        for (name, *_), skip in zip(_DECODER, _SKIPS):
            x = self.layers[name](upsample2(x))
            if skip is not None:
                x = x + skips[skip]
        x = self.layers[_HEAD[0]](x)
        # softplus as JAX computes it (logaddexp(x, 0)), then a floor.
        return torch.logaddexp(x[:, 0], torch.zeros_like(x[:, 0])) + 0.05


def init_params(generator: torch.Generator) -> DepthNet:
    """A FastDepth-lite network initialised from ``generator``."""
    return DepthNet(generator)


def n_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def upsample2(x: Tensor) -> Tensor:
    """Nearest-neighbour 2x upsample (NCHW)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def forward(model: DepthNet, rgb64: Tensor) -> Tensor:
    """Predict depth from ``(B, 64, 64, 3)``; returns ``(B, 64, 64)``."""
    return model(rgb64)


def resize_image(img: Tensor, size: int) -> Tensor:
    """Bilinear, antialiased resize of ``(H, W, C)`` or ``(B, H, W, C)``."""
    batched = img.ndim == 4
    x = (img if batched else img[None]).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False, antialias=True)
    x = x.permute(0, 2, 3, 1)
    return x if batched else x[0]


def predict_fullres(model: DepthNet, frame: Tensor) -> Tensor:
    """Paper inference path: frame -> 64x64 -> CNN -> back to ``(H, W)``."""
    h, w = frame.shape[0], frame.shape[1]
    small = resize_image(frame, DEPTH_INPUT)[None]
    d = model(small)  # (1, 64, 64)
    return F.interpolate(d[None], size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]
