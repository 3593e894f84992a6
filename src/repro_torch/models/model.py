"""Unified model API: ``build_model(cfg)`` dispatches on ``cfg.family``.

Port of ``repro/models/model.py`` for the dense family.  Every family
exposes the same surface, so the server never branches on architecture:

  * ``init(generator)                -> params``  (drawn on ``device``)
  * ``forward(params, batch)         -> logits``
  * ``prefill(params, batch)         -> (logits, serve_state)``
  * ``init_serve(batch, max_seq)     -> serve_state``  (zeros)
  * ``decode_step(params, state, token, pos) -> (logits, state)``

The batch of the dense family is ``{"tokens": (B, S) int}``.  The model
lives on one device, fixed when it is built: the CUDA card unless the
caller passes ``device="cpu"``.  The reference's ``loss_fn`` (training)
and its shape specs (sharded lowering) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
from torch import Tensor

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]

# Families of the JAX package that the port does not run yet.
_NOT_PORTED = ("moe_mla", "rwkv6", "hybrid", "vlm", "encdec")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Params]
    forward: Callable[[Params, Dict[str, Tensor]], Tensor]
    prefill: Callable[[Params, Dict[str, Tensor]], Any]
    init_serve: Callable[[int, int], Any]
    decode_step: Callable[[Params, Any, Tensor, int], Any]


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model of ``cfg`` on ``device`` (default: the CUDA card)."""
    fam = cfg.family
    if fam in _NOT_PORTED:
        raise NotImplementedError(
            f"family {fam!r} is not ported yet (ROADMAP.md, Queue 1 item 7)"
        )
    if fam != "dense":
        raise ValueError(f"unknown family: {fam}")
    from repro_torch.models import transformer as M

    device = resolve_device(device)
    return Model(
        cfg=cfg,
        device=device,
        init=lambda gen: M.init(gen, cfg, device),
        forward=lambda p, b: M.forward(p, b["tokens"], cfg),
        prefill=lambda p, b: M.prefill(p, b["tokens"], cfg),
        init_serve=lambda bs, s: M.init_cache(cfg, bs, s, device),
        decode_step=lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg),
    )
