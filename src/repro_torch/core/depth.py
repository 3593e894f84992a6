"""Depth Estimation Module (EPIC paper, Section 3.2), fp32 and int8.

Port of ``repro.core.depth``: a FastDepth-style monocular depth CNN on a
64x64 input (the paper resizes the frame to 64x64 and interpolates the
prediction back), with a depthwise-separable encoder and a
nearest-upsample decoder with additive skips, and its int8 post-training
quantisation (:class:`QuantizedParams`, :func:`forward_int8`; the paper
deploys the network in 8-bit integers).  The int8 path runs each dense
and pointwise convolution, with its quantisation, dequantisation, bias
and ReLU, as one launch of the fused int8 kernel on the card
(``kernels/int8_matmul/qconv.py``), and its depthwise convolutions as
nine shifted int32 products; every int32 sum is exact.

The public functions keep the JAX package's NHWC layout; the network
runs NCHW inside.  Two framework differences are handled here:

* ``SAME`` padding: for an even input at stride 2, JAX pads (0, 1) while
  ``padding=1`` pads (1, 1); :func:`conv2d_same` pads explicitly.
* ``jax.image.resize`` antialiases when it downsamples;
  :func:`resize_image` asks ``F.interpolate`` for the same.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from repro_torch.kernels.int8_matmul import ops as int8_ops
from repro_torch.kernels.int8_matmul import qconv as _qc

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


def _exact_cudnn():
    """cuDNN in full float32 (no TF32, which keeps 10 mantissa bits and is
    PyTorch's default for convolutions) and deterministic, for the extent
    of a ``with``; the global switches are restored after it."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _ExactConv2d(torch.autograd.Function):
    """``F.conv2d`` (no padding) whose backward runs under
    :func:`_exact_cudnn` too: autograd runs a convolution's backward after
    the forward's ``with`` has ended, under the switches of that time."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, stride, groups):
        with _exact_cudnn():
            return F.conv2d(x, w, stride=stride, groups=groups)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, stride, groups = inputs
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.groups = stride, groups

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        with _exact_cudnn():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                grad, x, w, None, [ctx.stride] * 2, [0, 0], [1, 1], False,
                [0, 0], ctx.groups,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None


def conv2d_same(x: Tensor, w: Tensor, stride: int = 1, groups: int = 1) -> Tensor:
    """NCHW convolution with JAX's ``SAME`` padding (extra pad at the end).

    cuDNN runs it, and its backward, in full float32 and deterministically
    (:func:`_exact_cudnn`) whatever the caller's global switches, which
    are left as they were: the depth and HIR outputs feed ``floor()`` of
    warped coordinates, and the parity rule compares with TF32 off."""
    pads = []
    for size, k in ((x.shape[3], w.shape[3]), (x.shape[2], w.shape[2])):
        total = max((-(-size // stride) - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    x = F.pad(x, pads)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ExactConv2d.apply(x, w, stride, groups)
    with _exact_cudnn():
        return F.conv2d(x, w, stride=stride, groups=groups)


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


def predict_fullres(model, frame: Tensor) -> Tensor:
    """Paper inference path: frame -> 64x64 -> CNN -> back to ``(H, W)``.

    ``model`` is a :class:`DepthNet`, or a :class:`QuantizedParams` for
    the int8 deployment path (Section 3.2).
    """
    h, w = frame.shape[0], frame.shape[1]
    small = resize_image(frame, DEPTH_INPUT)[None]
    if isinstance(model, QuantizedParams):
        d = forward_int8(model, small)
    else:
        d = model(small)  # (1, 64, 64)
    return F.interpolate(d[None], size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


def loss_fn(model: DepthNet, rgb64: Tensor, depth64: Tensor) -> Tensor:
    """Scale-aware log-depth L2 loss for training on synthetic ground
    truth: ``rgb64`` (B, 64, 64, 3), ``depth64`` (B, 64, 64)."""
    pred = forward(model, rgb64)
    return torch.mean((torch.log(pred) - torch.log(depth64 + 1e-6)) ** 2)


def memory_bytes(model: nn.Module, int8: bool) -> int:
    """Model weight footprint (paper: int8 cuts depth-module memory 4x)."""
    return sum(p.numel() for p in model.parameters()) * (1 if int8 else 4)


# ---------------------------------------------------------------------------
# Int8 post-training quantization (paper Section 3.2).
# ---------------------------------------------------------------------------


def qlayer_shapes(kind: str, cin: int,
                  cout: int) -> Dict[str, Tuple[int, ...]]:
    """The buffers of one quantised layer and their shapes.

    A 3x3 conv keeps its int8 kernel in the im2col layout ``w (9 cin,
    cout)`` (the HWIO kernel reshaped: rows ordered ``(dy, dx, c)``); a
    depthwise-separable layer keeps ``dw (3, 3, cin)`` and ``pw (cin,
    cout)``.  Each int8 kernel has its per-output-channel float scale
    (``*_scale``), and every layer its float bias ``b`` and the
    calibrated max-abs of its input, ``act_scale`` (0-dim).
    """
    if kind == "conv":
        shapes = {"w": (9 * cin, cout), "w_scale": (cout,)}
    else:
        shapes = {"dw": (3, 3, cin), "dw_scale": (cin,),
                  "pw": (cin, cout), "pw_scale": (cout,)}
    return {**shapes, "b": (cout,), "act_scale": ()}


class _QLayer(nn.Module):
    """One quantised layer: :func:`qlayer_shapes`'s tensors as buffers."""

    def __init__(self, kind: str, stride: int, tensors: Dict[str, Tensor]):
        super().__init__()
        self.kind, self.stride = kind, stride
        for name, t in tensors.items():
            self.register_buffer(name, t)


class QuantizedParams(nn.Module):
    """Symmetric per-output-channel int8 weights + float biases/scales.

    The JAX package's ``QuantizedParams`` (qweights, scales, act_scale) as
    one module of buffers per layer (:func:`qlayer_shapes`).
    ``matmul_backend`` is the int8 backend of the dense and pointwise
    convolutions: ``"pallas"``, one fused launch a layer
    (``qconv_int8_pallas``; its plain version for CPU tensors), or
    ``"ref"``, the plain version (``qconv_int8_ref``).  Both are bitwise
    equal.
    """

    def __init__(self, layers: Dict[str, Dict[str, Tensor]],
                 matmul_backend: str = "pallas"):
        super().__init__()
        specs = {name: (kind, cin, cout, stride) for name, kind, cin, cout,
                 stride in _ENCODER + _DECODER + (_HEAD,)}
        if set(layers) != set(specs):
            raise ValueError(
                f"layers {sorted(layers)} do not match {sorted(specs)}"
            )
        modules = {}
        for name, tensors in layers.items():
            kind, cin, cout, stride = specs[name]
            want = qlayer_shapes(kind, cin, cout)
            got = {k: tuple(t.shape) for k, t in tensors.items()}
            if got != want:
                raise ValueError(f"{name}: buffers {got} do not match {want}")
            modules[name] = _QLayer(kind, stride, tensors)
        self.layers = nn.ModuleDict(modules)
        self.matmul_backend = matmul_backend

    @property
    def matmul_backend(self) -> str:
        return self._matmul_backend

    @matmul_backend.setter
    def matmul_backend(self, backend: str) -> None:
        if backend not in int8_ops.BACKENDS:
            raise ValueError(f"unknown int8_matmul backend {backend!r}; "
                             f"known: {int8_ops.BACKENDS}")
        self._matmul_backend = backend


def quantize_weight(w: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-output-channel symmetric int8 quantization (last axis = out ch)."""
    amax = w.abs().amax(dim=tuple(range(w.ndim - 1)), keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _hwio(w: Tensor) -> Tensor:
    """The port's ``(cout, cin, kh, kw)`` kernel in JAX's HWIO layout."""
    return w.detach().permute(2, 3, 1, 0)


@torch.no_grad()
def quantize_params(model: DepthNet, calib_rgb64: Tensor,
                    matmul_backend: str = "pallas") -> QuantizedParams:
    """Post-training quantization with activation calibration.

    Weights are quantised per output channel; activation scales are the
    max-abs of each layer's input over the calibration batch
    (``(B, 64, 64, 3)``).
    """
    act_scale = _calibrate(model, calib_rgb64)
    layers = {}
    for name, kind, cin, cout, _ in _ENCODER + _DECODER + (_HEAD,):
        layer = model.layers[name]
        t = {"b": layer.b.detach().clone(), "act_scale": act_scale[name]}
        if kind == "conv":
            q, s = quantize_weight(_hwio(layer.w))
            t["w"], t["w_scale"] = q.reshape(9 * cin, cout), s.reshape(cout)
        else:
            q, s = quantize_weight(_hwio(layer.dw))
            t["dw"], t["dw_scale"] = q.reshape(3, 3, cin), s.reshape(cin)
            q, s = quantize_weight(_hwio(layer.pw))
            t["pw"], t["pw_scale"] = q.reshape(cin, cout), s.reshape(cout)
        layers[name] = {k: v.contiguous() for k, v in t.items()}
    return QuantizedParams(layers, matmul_backend)


@torch.no_grad()
def _calibrate(model: DepthNet, rgb64: Tensor) -> Dict[str, Tensor]:
    """Record per-layer input max-abs on a calibration batch."""
    record: Dict[str, Tensor] = {}
    x = rgb64.permute(0, 3, 1, 2)
    skips = {}
    for name, *_ in _ENCODER:
        record[name] = x.abs().amax()
        x = model.layers[name](x)
        skips[name] = x
    for (name, *_), skip in zip(_DECODER, _SKIPS):
        x = upsample2(x)
        record[name] = x.abs().amax()
        x = model.layers[name](x)
        if skip is not None:
            x = x + skips[skip]
    record[_HEAD[0]] = x.abs().amax()
    return record


def conv_int32(qx: Tensor, qw: Tensor, stride: int = 1,
               backend: str = "ref") -> Tensor:
    """Exact int32 SAME convolution of int8 ``qx (N, H, W, cin)`` with an
    int8 kernel in the im2col layout ``(k k cin, cout)``, as im2col + the
    ``int8_matmul`` op on ``backend`` (``qconv.conv_int32``)."""
    return _qc.conv_int32(qx, qw, stride,
                          partial(int8_ops.int8_matmul, backend=backend))


def depthwise_int32(qx: Tensor, qw: Tensor, stride: int = 1) -> Tensor:
    """Exact int32 SAME depthwise 3x3 convolution of int8 ``qx (N, H, W,
    C)`` with ``qw (3, 3, C)``: nine shifted products summed in int32."""
    windows = _qc.same_windows(qx.to(torch.int32), 3, stride)
    taps = qw.to(torch.int32).reshape(9, -1)
    out = windows[0] * taps[0]
    for window, tap in zip(windows[1:], taps[1:]):
        out += window * tap
    return out


def _qconv(x: Tensor, qw: Tensor, wscale: Tensor, xscale: Tensor,
           stride: int = 1, depthwise: bool = False,
           backend: str = "ref") -> Tensor:
    """Int8 conv: quantize the input, integer conv, dequantize as
    ``(out sx) wscale`` (the JAX package's order; ``qconv.quantized_conv``).
    """
    conv = (depthwise_int32 if depthwise
            else partial(conv_int32, backend=backend))
    return _qc.quantized_conv(x, xscale, qw, wscale, stride, conv)


def _qblock(x: Tensor, layer: _QLayer, backend: str) -> Tensor:
    if layer.kind == "conv":
        return int8_ops.qconv_int8(x, layer.act_scale, layer.w, layer.w_scale,
                                   layer.b, stride=layer.stride,
                                   backend=backend)
    x = _qconv(x, layer.dw, layer.dw_scale, layer.act_scale, layer.stride,
               depthwise=True)
    # The pointwise input's scale is taken on the device: no host sync.
    return int8_ops.qconv_int8(x, x.abs().amax(), layer.pw, layer.pw_scale,
                               layer.b, backend=backend)


def _upsample2_nhwc(x: Tensor) -> Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


@torch.no_grad()
def forward_int8(q: QuantizedParams, rgb64: Tensor) -> Tensor:
    """Int8 inference path mirroring :func:`forward`: ``(B, 64, 64, 3)``
    -> ``(B, 64, 64)``, NHWC throughout."""
    backend = q.matmul_backend
    x = rgb64
    skips = {}
    for name, *_ in _ENCODER:
        x = _qblock(x, q.layers[name], backend)
        skips[name] = x
    for (name, *_), skip in zip(_DECODER, _SKIPS):
        x = _qblock(_upsample2_nhwc(x), q.layers[name], backend)
        if skip is not None:
            x = x + skips[skip]
    head = q.layers[_HEAD[0]]
    x = int8_ops.qconv_int8(x, head.act_scale, head.w, head.w_scale, head.b,
                            relu=False, backend=backend)[..., 0]
    return torch.logaddexp(x, torch.zeros_like(x)) + 0.05
