"""Carry the JAX package's parameters across to the port's modules.

The JAX package keeps parameters as pytrees of HWIO arrays
(``depth.init_params``, ``hir.init_params``); the port keeps them in
``nn.Module``s, OIHW.  These functions take those pytrees as numpy arrays
(``jax.tree.map(np.asarray, params)``) and return the port's networks
with the same weights:

* a 3x3 or 1x1 kernel ``(kh, kw, cin, cout)`` -> ``(cout, cin, kh, kw)``;
* a depthwise kernel ``(3, 3, 1, cin)`` -> ``(cin, 1, 3, 3)``, run with
  ``groups=cin`` — the same transpose.

The int8 depth network (``depth.quantize_params``'s ``QuantizedParams``)
keeps its int8 kernels in the layout its int8 path multiplies
(``depth.qlayer_shapes``): a 3x3 kernel ``(3, 3, cin, cout)`` reshaped to
the im2col matrix ``(9 cin, cout)``, a depthwise one to ``(3, 3, cin)``, a
pointwise one to ``(cin, cout)``; the per-channel scales ``(1, 1, 1, c)``
become ``(c,)``.

The EFM models keep the reference's pytree layout (linear weights
``(d_in, d_out)``, layer stacks with a leading ``L`` axis, the VLM's
self layers with ``(groups, period)``), so :func:`dense_from_jax`,
:func:`rwkv6_from_jax`, :func:`hybrid_from_jax`, :func:`moe_mla_from_jax`,
:func:`vlm_from_jax` and :func:`encdec_from_jax` only check the tree and
move its leaves.  :func:`adamw_state_from_jax` and
:func:`ef_state_from_jax` carry the optimizer's state across, its trees
checked against the same layout.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import depth as depth_mod
from repro_torch.core.depth import DepthNet
from repro_torch.core.hir import HIRNet
from repro_torch.models import (deepseek, encdec, mamba2, rwkv6, transformer,
                                vision)


def hwio_to_oihw(w) -> torch.Tensor:
    """``(kh, kw, cin, cout)`` -> ``(cout, cin, kh, kw)`` float32."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1))
    )


def _load(module: nn.Module, name: str, value) -> None:
    param = getattr(module, name)
    v = np.asarray(value, np.float32)
    t = hwio_to_oihw(v) if v.ndim == 4 else torch.from_numpy(v.copy())
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(
            f"{name}: shape {tuple(t.shape)} does not fit {tuple(param.shape)}"
        )
    with torch.no_grad():
        param.copy_(t)


def depth_from_jax(params: Mapping[str, Mapping[str, np.ndarray]],
                   device=None) -> DepthNet:
    """A :class:`DepthNet` holding ``repro.core.depth`` parameters."""
    device = resolve_device(device)
    model = DepthNet(torch.Generator(device=device))
    if set(params) != set(model.layers):
        raise ValueError(
            f"layers {sorted(params)} do not match {sorted(model.layers)}"
        )
    for name, layer in params.items():
        for key, value in layer.items():
            _load(model.layers[name], key, value)
    return model


def quantized_depth_from_jax(q, device=None,
                             matmul_backend: str = "pallas"
                             ) -> depth_mod.QuantizedParams:
    """A :class:`~repro_torch.core.depth.QuantizedParams` holding the JAX
    package's ``QuantizedParams`` ``(qweights, scales, act_scale)`` as
    numpy arrays (``jax.tree.map(np.asarray, q)``)."""
    device = resolve_device(device)
    qweights, scales, act_scale = q
    layers = {}
    for name, kind, cin, cout, _ in (depth_mod._ENCODER + depth_mod._DECODER
                                     + (depth_mod._HEAD,)):
        for part, tree in (("qweights", qweights), ("scales", scales),
                           ("act_scale", act_scale)):
            if name not in tree:
                raise ValueError(f"layer {name!r} missing from {part} "
                                 f"{sorted(tree)}")
        layers[name] = {}
        for key, shape in depth_mod.qlayer_shapes(kind, cin, cout).items():
            if key == "act_scale":
                value = act_scale[name]
            elif key.endswith("_scale"):
                value = scales[name][key[:-len("_scale")]]
            else:
                value = qweights[name][key]
            a = np.asarray(value)
            if a.size != math.prod(shape):
                raise ValueError(f"{name}/{key}: shape {a.shape} does not "
                                 f"fit {shape}")
            layers[name][key] = torch.from_numpy(
                np.ascontiguousarray(a).reshape(shape).copy()
            ).to(device)
    return depth_mod.QuantizedParams(layers, matmul_backend)


def hir_from_jax(params: Mapping[str, np.ndarray], device=None) -> HIRNet:
    """An :class:`HIRNet` holding ``repro.core.hir`` parameters."""
    device = resolve_device(device)
    model = HIRNet(torch.Generator(device=device))
    for key, value in params.items():
        _load(model, key, value)
    return model


def _tensor_from_jax(a, device, dtype=None) -> torch.Tensor:
    """An array as a tensor on ``device``, in ``dtype`` (default: its own;
    bf16 arrays are ``ml_dtypes.bfloat16``, which numpy names so)."""
    a = np.asarray(a)
    if dtype is None:
        dtype = (torch.bfloat16 if a.dtype.name == "bfloat16"
                 else torch.from_numpy(np.empty(0, a.dtype)).dtype)
    # float32 holds every bf16 value exactly, so the round trip is exact.
    src = a if a.dtype.kind in "biu" else np.array(a, dtype=np.float32)
    return torch.from_numpy(np.array(src)).to(device=device, dtype=dtype)


def _tree_from_jax(expected, got, path: str, device, keep_dtype=False):
    """``got`` checked against ``expected``'s keys and shapes, its leaves
    in ``expected``'s dtypes (their own with ``keep_dtype``)."""
    if isinstance(expected, dict):
        if not isinstance(got, Mapping) or set(got) != set(expected):
            keys = sorted(got) if isinstance(got, Mapping) else type(got)
            raise ValueError(f"{path or '/'}: keys {keys} do not match "
                             f"{sorted(expected)}")
        return {k: _tree_from_jax(v, got[k], f"{path}/{k}", device,
                                  keep_dtype)
                for k, v in expected.items()}
    a = np.asarray(got)
    if a.shape != tuple(expected.shape):
        raise ValueError(f"{path}: shape {a.shape} does not fit "
                         f"{tuple(expected.shape)}")
    return _tensor_from_jax(a, device, None if keep_dtype else expected.dtype)


def dense_from_jax(params_np, cfg: ModelConfig, device=None):
    """The dense transformer's parameters (``repro.models.transformer``)
    as the port's tree, in ``cfg.param_dtype`` on ``device``.

    ``params_np`` is the JAX pytree as numpy arrays
    (``jax.tree.map(np.asarray, params)``), with the stacked ``L`` axis.
    """
    return _model_from_jax(transformer, params_np, cfg, device)


def rwkv6_from_jax(params_np, cfg: ModelConfig, device=None):
    """The RWKV6 model's parameters (``repro.models.rwkv6``) as the port's
    tree, as :func:`dense_from_jax` does for the dense family."""
    return _model_from_jax(rwkv6, params_np, cfg, device)


def hybrid_from_jax(params_np, cfg: ModelConfig, device=None):
    """The Zamba2 hybrid's parameters (``repro.models.mamba2``) as the
    port's tree, as :func:`dense_from_jax` does for the dense family."""
    return _model_from_jax(mamba2, params_np, cfg, device)


def moe_mla_from_jax(params_np, cfg: ModelConfig, device=None):
    """The DeepSeek model's parameters (``repro.models.deepseek``: MLA,
    MoE, and the MTP tree when ``cfg.mtp``) as the port's tree, as
    :func:`dense_from_jax` does for the dense family."""
    return _model_from_jax(deepseek, params_np, cfg, device)


def vlm_from_jax(params_np, cfg: ModelConfig, device=None):
    """The VLM's parameters (``repro.models.vision``) as the port's tree,
    as :func:`dense_from_jax` does for the dense family."""
    return _model_from_jax(vision, params_np, cfg, device)


def encdec_from_jax(params_np, cfg: ModelConfig, device=None):
    """The encoder-decoder's parameters (``repro.models.encdec``) as the
    port's tree, as :func:`dense_from_jax` does for the dense family."""
    return _model_from_jax(encdec, params_np, cfg, device)


def evu_from_jax(params_np, device=None):
    """The EVU probe's parameters (``repro.core.evu``) as the port's dict
    of float32 tensors on ``device``.  Both keep the reference's layout
    (``(d_in, d_out)`` matrices, a ``"layers"`` list), so this checks the
    tree and moves the leaves."""
    from repro_torch.core import evu

    device = resolve_device(device)
    if not isinstance(params_np, Mapping) or "layers" not in params_np:
        raise ValueError("not an EVU parameter tree: no 'layers' list")
    n_layers = len(params_np["layers"])
    d_model = np.shape(params_np["cls"])[0]
    cfg = evu.EVUConfig(
        d_model=d_model, n_layers=n_layers,
        n_classes=np.shape(params_np["out"])[1],
        n_segments=np.shape(params_np["seg_embed"])[0],
    )
    expected = evu.init_params(torch.Generator(), cfg)  # shapes only
    top = {k: v for k, v in expected.items() if k != "layers"}
    got_top = {k: v for k, v in params_np.items() if k != "layers"}
    out = _tree_from_jax(top, got_top, "", device)
    out["layers"] = [
        _tree_from_jax(e, gl, f"/layers/{i}", device)
        for i, (e, gl) in enumerate(zip(expected["layers"],
                                        params_np["layers"]))
    ]
    return out


def _model_from_jax(module, params_np, cfg: ModelConfig, device,
                    keep_dtype=False):
    device = resolve_device(device)
    expected = module.init(None, cfg, torch.device("meta"))
    return _tree_from_jax(expected, params_np, "", device, keep_dtype)


_FAMILY_MODULES = {"dense": transformer, "rwkv6": rwkv6, "hybrid": mamba2,
                   "moe_mla": deepseek, "vlm": vision, "encdec": encdec}


def _like_params(tree_np, cfg, device):
    """A tree of the parameters' layout (moments, error feedback), checked
    against ``cfg``'s parameter tree, each leaf in its own dtype; with
    ``cfg=None`` any tree of dicts, lists and tuples, as it is."""
    if cfg is not None:
        return _model_from_jax(_FAMILY_MODULES[cfg.family], tree_np, cfg,
                               device, keep_dtype=True)

    def walk(x):
        if isinstance(x, Mapping):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return _tensor_from_jax(x, device)

    device = resolve_device(device)
    return walk(tree_np)


def adamw_state_from_jax(state, cfg: Optional[ModelConfig] = None,
                         device=None):
    """The reference's ``AdamWState`` (``repro.optim.adamw``, as numpy or
    JAX arrays) as the port's: the step an int32 scalar, the moments in
    their own dtype (float32, or the moment dtype they were cast to),
    checked against ``cfg``'s parameter tree when ``cfg`` is given."""
    from repro_torch.optim import adamw

    device = resolve_device(device)
    return adamw.AdamWState(
        step=_tensor_from_jax(state.step, device, torch.int32),
        mu=_like_params(state.mu, cfg, device),
        nu=_like_params(state.nu, cfg, device),
    )


def ef_state_from_jax(ef, cfg: Optional[ModelConfig] = None, device=None):
    """The reference's ``EFState`` (``repro.optim.compress``) as the
    port's: the float32 error tree, as :func:`adamw_state_from_jax` maps
    the moments."""
    from repro_torch.optim import compress

    return compress.EFState(_like_params(ef.error, cfg,
                                         resolve_device(device)))
