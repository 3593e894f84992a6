"""Unified model API: ``build_model(cfg)`` dispatches on ``cfg.family``.

Port of ``repro/models/model.py`` for all six families.  Every family
exposes the same surface, so the server never branches on architecture:

  * ``init(generator)                -> params``  (drawn on ``device``)
  * ``loss_fn(params, batch)         -> scalar loss`` (MoE aux and MTP
    terms included by the family's loss)
  * ``forward(params, batch)         -> logits``
  * ``prefill(params, batch)         -> (logits, serve_state)``
  * ``init_serve(batch, max_seq)     -> serve_state``  (zeros)
  * ``decode_step(params, state, token, pos) -> (logits, state)``

Batch layouts by family, as the reference's:
  dense / moe_mla / rwkv6 / hybrid : {"tokens": (B, S) int}
  vlm                              : + {"img_embed": (B, N, D) float}
  encdec                           : + {"src_embed": (B, S_src, D) float}

The model lives on one device, fixed when it is built: the CUDA card
unless the caller passes ``device="cpu"``.  ``scan_backend`` picks the
scan of the rwkv6 and hybrid prefills: the reference's ``"chunked"`` by
default, ``"pallas"`` for the CUDA kernels (the other families have no
scan).  The encoder-decoder's ``prefill`` runs the encoder only and
returns ``(None, cache)``: the cross K/V and an empty self-cache of the
prompt's length, from which decode starts at position 0.  ``loss_fn``
runs the reference's training forms (attention on ``cfg.attn_backend``,
``"ref"`` by default; the RWKV6 scan on ``"ref"``, the SSD on
``"chunked"``); the CUDA kernels have no backward and their wrappers
raise under grad.

Shape specs, the reference's ``jax.eval_shape`` trees, are tensors on the
``meta`` device (shape and dtype, no storage): ``param_spec()`` (the
family's ``init``), ``serve_spec(batch, max_seq)`` (``init_serve``),
``token_spec(batch)`` and ``batch_spec(shape)``.  The sharding rules
(``launch/sharding.py``) read them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
from torch import Tensor

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]
SCAN_BACKENDS = ("chunked", "ref", "pallas")
FAMILIES = ("dense", "moe_mla", "rwkv6", "hybrid", "vlm", "encdec")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Params]
    loss_fn: Callable[[Params, Dict[str, Tensor]], Tensor]
    forward: Callable[[Params, Dict[str, Tensor]], Tensor]
    prefill: Callable[[Params, Dict[str, Tensor]], Any]
    init_serve: Callable[[int, int], Any]
    decode_step: Callable[[Params, Any, Tensor, int], Any]

    def _meta(self) -> "Model":
        return build_model(self.cfg, device="meta")

    def param_spec(self) -> Params:
        """The parameters' shapes and dtypes (meta tensors, no storage)."""
        return self._meta().init(None)

    def serve_spec(self, batch: int, max_seq: int) -> Any:
        return self._meta().init_serve(batch, max_seq)

    def token_spec(self, batch: int) -> Tensor:
        return torch.empty((batch, 1), dtype=torch.int32, device="meta")

    def batch_spec(self, shape) -> Dict[str, Tensor]:
        """Train/prefill inputs of a ``ShapeSpec``, as meta tensors."""
        b, s = shape.global_batch, shape.seq_len
        cfg = self.cfg

        def meta(*dims, dtype=torch.float32):
            return torch.empty(dims, dtype=dtype, device="meta")

        out = {"tokens": meta(b, s, dtype=torch.int32)}
        if cfg.family == "vlm":
            out["img_embed"] = meta(b, cfg.img_seq, cfg.d_model)
        if cfg.family == "encdec":
            from repro_torch.models.encdec import src_len

            out["src_embed"] = meta(b, src_len(cfg, s), cfg.d_model)
        return out


def build_model(cfg: ModelConfig, device=None, *,
                scan_backend: str = "chunked") -> Model:
    """The model of ``cfg`` on ``device`` (default: the CUDA card)."""
    fam = cfg.family
    if fam not in FAMILIES:
        raise ValueError(f"unknown family: {fam}")
    if scan_backend not in SCAN_BACKENDS:
        raise ValueError(f"unknown scan backend {scan_backend!r}; known: "
                         f"{SCAN_BACKENDS}")
    device = resolve_device(device)
    if fam == "dense":
        from repro_torch.models import transformer as M

        return Model(
            cfg=cfg,
            device=device,
            init=lambda gen: M.init(gen, cfg, device),
            loss_fn=lambda p, b: M.loss_fn(p, b, cfg),
            forward=lambda p, b: M.forward(p, b["tokens"], cfg),
            prefill=lambda p, b: M.prefill(p, b["tokens"], cfg),
            init_serve=lambda bs, s: M.init_cache(cfg, bs, s, device),
            decode_step=lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg),
        )
    if fam == "rwkv6":
        from repro_torch.models import rwkv6 as M

        return Model(
            cfg=cfg,
            device=device,
            init=lambda gen: M.init(gen, cfg, device),
            loss_fn=lambda p, b: M.loss_fn(p, b, cfg),
            forward=lambda p, b: M.forward(p, b["tokens"], cfg),
            prefill=lambda p, b: M.prefill(p, b["tokens"], cfg,
                                           scan_backend=scan_backend),
            init_serve=lambda bs, s: M.init_state(cfg, bs, device),
            decode_step=lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg),
        )
    if fam == "hybrid":
        from repro_torch.models import mamba2 as M

        return Model(
            cfg=cfg,
            device=device,
            init=lambda gen: M.init(gen, cfg, device),
            loss_fn=lambda p, b: M.loss_fn(p, b, cfg),
            forward=lambda p, b: M.forward(p, b["tokens"], cfg),
            prefill=lambda p, b: M.prefill(p, b["tokens"], cfg,
                                           scan_backend=scan_backend),
            init_serve=lambda bs, s: M.init_cache(cfg, bs, s, device),
            decode_step=lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg),
        )
    if fam == "moe_mla":
        from repro_torch.models import deepseek as M

        return Model(
            cfg=cfg,
            device=device,
            init=lambda gen: M.init(gen, cfg, device),
            loss_fn=lambda p, b: M.loss_fn(p, b, cfg),
            forward=lambda p, b: M.forward(p, b["tokens"], cfg)[0],
            prefill=lambda p, b: M.prefill(p, b["tokens"], cfg),
            init_serve=lambda bs, s: M.init_cache(cfg, bs, s, device),
            decode_step=lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg),
        )
    if fam == "vlm":
        from repro_torch.models import vision as M

        return Model(
            cfg=cfg,
            device=device,
            init=lambda gen: M.init(gen, cfg, device),
            loss_fn=lambda p, b: M.loss_fn(p, b, cfg),
            forward=lambda p, b: M.forward(p, b["tokens"], b["img_embed"],
                                           cfg),
            prefill=lambda p, b: M.prefill(p, b["tokens"], b["img_embed"],
                                           cfg),
            init_serve=lambda bs, s: M.init_cache(cfg, bs, s, device),
            decode_step=lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg),
        )
    from repro_torch.models import encdec as M

    def ed_prefill(p, b):
        xk, xv = M.precompute_cross_cache(p, b["src_embed"], cfg)
        bs, s = b["tokens"].shape
        cache = M.init_cache(cfg, bs, s, xk.shape[3], device)
        cache["xk"], cache["xv"] = xk, xv
        return None, cache

    return Model(
        cfg=cfg,
        device=device,
        init=lambda gen: M.init(gen, cfg, device),
        loss_fn=lambda p, b: M.loss_fn(p, b, cfg),
        forward=lambda p, b: M.forward(p, b["src_embed"], b["tokens"], cfg),
        prefill=ed_prefill,
        init_serve=lambda bs, s: M.init_cache(cfg, bs, s, M.src_len(cfg, s),
                                              device),
        decode_step=lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg),
    )
