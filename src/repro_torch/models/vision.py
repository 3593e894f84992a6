"""Llama-3.2-Vision 11B text backbone with gated cross-attention image
layers.

Port of ``repro/models/vision.py``.  Only the transformer backbone is
modelled; the vision encoder is a stub: ``img_embed`` (B, N, d_model)
arrives as precomputed patch embeddings.

Layout, as the reference: ``n_groups = n_layers // cross_attn_period``
groups of [one gated cross-attention block; ``period`` self-attention
blocks].  The self blocks are one stacked tree with leading axes
``(groups, period)``, the cross blocks one with ``(groups,)``.  The
tanh gates start at 0, the released model's recipe, so at init the
image path adds nothing.

EPIC tie-in: the retained DC-buffer patches *are* the cross-attention
KV, so EPIC's compression shrinks N and with it the cross-KV cache.
``prefill`` returns the cross K/V at the length of the ``img_embed`` it
is given (``init_cache`` sizes them to ``cfg.img_seq``), so a token
stream of any length serves.

Self-attention runs on ``cfg.attn_backend`` through
:func:`~repro_torch.models.transformer.block_apply` (the flash kernel on
``"pallas"``); cross-attention always takes the masked path, as in the
reference.  ``loss_fn`` is the training loss; ``cfg.remat`` recomputes
each self block in the backward pass (the cross blocks are kept, as in
the reference).  The cross-attention decode takes the reference's
decode-sharding hints inside ``layers.cross_attention_decode``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import Tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.transformer import layer_params

Params = Dict[str, Any]


def n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.cross_attn_period


def init_xattn_block(gen, cfg: ModelConfig, lead=(), device=None) -> Params:
    zero = torch.zeros(lead, dtype=cfg.pdt, device=device)
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, cfg.pdt, lead, device),
        "attn": L.init_attention(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.head_dim_,
                                 dtype=cfg.pdt, lead=lead, device=device),
        "ln_kv": L.init_rmsnorm(cfg.d_model, cfg.pdt, lead, device),
        "gate_attn": zero,
        "ln2": L.init_rmsnorm(cfg.d_model, cfg.pdt, lead, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=cfg.pdt,
                          lead=lead, device=device),
        "gate_mlp": zero.clone(),
    }


def xattn_block(p: Params, x: Tensor, img: Tensor, cfg: ModelConfig) -> Tensor:
    """Gated cross-attention + gated MLP (residual deltas tanh-gated)."""
    h = L.rmsnorm(p["ln1"], x)
    kv = L.rmsnorm(p["ln_kv"], img)
    a = L.attention_full(
        p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
        rope_base=0.0,  # no rope across modalities
        causal=False, kv_ctx=kv, compute_dtype=cfg.cdt,
    )
    x = x + (torch.tanh(p["gate_attn"].to(cfg.cdt)) * a).to(x.dtype)
    m = L.mlp(p["mlp"], L.rmsnorm(p["ln2"], x), cfg.cdt)
    return x + (torch.tanh(p["gate_mlp"].to(cfg.cdt)) * m).to(x.dtype)


def init(gen, cfg: ModelConfig, device) -> Params:
    """Random parameters at the reference's scales, drawn on ``device``
    from ``gen`` (``None`` only for the shapes, on the meta device)."""
    g = n_groups(cfg)
    return {
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdt,
                                  device),
        "self_layers": TF.init_block(gen, cfg, (g, cfg.cross_attn_period),
                                     device),
        "xattn_layers": init_xattn_block(gen, cfg, (g,), device),
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdt, device=device),
    }


def forward(p: Params, tokens: Tensor, img_embed: Tensor,
            cfg: ModelConfig) -> Tensor:
    """(B, S) tokens, (B, N, D) image embeddings -> (B, S, V) fp32."""
    x = L.embed(p["embed"], tokens, cfg.cdt)
    img = img_embed.to(cfg.cdt)

    def self_body(x, lp):
        return TF.block_apply(cfg, lp, x)

    if cfg.remat:
        self_body = L.remat_wrap(cfg, self_body)
    for g in range(n_groups(cfg)):
        x = xattn_block(layer_params(p["xattn_layers"], g), x, img, cfg)
        slayers = layer_params(p["self_layers"], g)
        for j in range(cfg.cross_attn_period):
            x = self_body(x, layer_params(slayers, j))
    x = L.rmsnorm(p["final_norm"], x)
    return L.unembed(p["embed"], x, cfg.cdt)


def loss_fn(p: Params, batch: Dict[str, Tensor], cfg: ModelConfig) -> Tensor:
    logits = forward(p, batch["tokens"], batch["img_embed"], cfg)
    return L.next_token_loss(logits, batch["tokens"], batch.get("mask"))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device) -> Dict[str, Tensor]:
    g = n_groups(cfg)
    shape = (g, cfg.cross_attn_period, batch, cfg.n_kv_heads, max_seq,
             cfg.head_dim_)
    xshape = (g, batch, cfg.n_kv_heads, cfg.img_seq, cfg.head_dim_)
    kw = dict(dtype=cfg.cachedt, device=device)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
            "xk": torch.zeros(xshape, **kw), "xv": torch.zeros(xshape, **kw)}


def precompute_cross_cache(p: Params, img_embed: Tensor,
                           cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Project image embeddings to per-group cross K/V once (prefill):
    two (G, B, Hkv, N, Dh) tensors in ``cfg.cachedt``."""
    img = img_embed.to(cfg.cdt)
    ks, vs = [], []
    for g in range(n_groups(cfg)):
        xp = layer_params(p["xattn_layers"], g)
        k, v = L.cross_kv(xp["attn"], L.rmsnorm(xp["ln_kv"], img),
                          cfg.n_kv_heads, compute_dtype=cfg.cdt,
                          cache_dtype=cfg.cachedt)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def prefill(p: Params, tokens: Tensor, img_embed: Tensor,
            cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full-context forward returning (last-token logits, serve cache):
    the self K/V at the prompt's length, the cross K/V at N."""
    x = L.embed(p["embed"], tokens, cfg.cdt)
    img = img_embed.to(cfg.cdt)
    g_n, period = n_groups(cfg), cfg.cross_attn_period
    b, s = tokens.shape
    shape = (g_n, period, b, cfg.n_kv_heads, s, cfg.head_dim_)
    k = torch.empty(shape, dtype=cfg.cachedt, device=x.device)
    v = torch.empty_like(k)
    for g in range(g_n):
        x = xattn_block(layer_params(p["xattn_layers"], g), x, img, cfg)
        slayers = layer_params(p["self_layers"], g)
        for j in range(period):
            x, c = TF.block_apply(cfg, layer_params(slayers, j), x,
                                  cache_dtype=cfg.cachedt)
            k[g, j], v[g, j] = c["k"], c["v"]
    xk, xv = precompute_cross_cache(p, img_embed, cfg)
    x = L.rmsnorm(p["final_norm"], x[:, -1:])
    logits = L.unembed(p["embed"], x, cfg.cdt)
    return logits, {"k": k, "v": v, "xk": xk, "xv": xv}


def _xattn_decode(xp: Params, x: Tensor, xk: Tensor, xv: Tensor,
                  cfg: ModelConfig) -> Tensor:
    """One-token gated cross-attention against precomputed image KV."""
    cdt = cfg.cdt
    a = L.cross_attention_decode(xp["attn"], L.rmsnorm(xp["ln1"], x), xk, xv,
                                 cfg.n_heads, compute_dtype=cdt)
    x = x + (torch.tanh(xp["gate_attn"].to(cdt)) * a).to(x.dtype)
    m = L.mlp(xp["mlp"], L.rmsnorm(xp["ln2"], x), cdt)
    return x + (torch.tanh(xp["gate_mlp"].to(cdt)) * m).to(x.dtype)


def decode_step(p: Params, cache: Dict[str, Tensor], token: Tensor,
                pos: int, cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One serving step: next-token logits + the cache, its self K/V
    updated in place."""
    x = L.embed(p["embed"], token, cfg.cdt)
    for g in range(n_groups(cfg)):
        x = _xattn_decode(layer_params(p["xattn_layers"], g), x,
                          cache["xk"][g], cache["xv"][g], cfg)
        slayers = layer_params(p["self_layers"], g)
        for j in range(cfg.cross_attn_period):
            x, _ = TF.block_decode(
                cfg, layer_params(slayers, j), x,
                {"k": cache["k"][g, j], "v": cache["v"][g, j]}, pos)
    x = L.rmsnorm(p["final_norm"], x)
    return L.unembed(p["embed"], x, cfg.cdt), cache
