"""Dense decoder-only transformer (olmo / tinyllama / qwen2.5 / phi4 family).

Port of ``repro/models/transformer.py``.  The layer stack keeps the
reference's layout, parameters with a leading ``L`` axis, and a Python
loop over the layers takes the place of ``lax.scan``.

Entry points:
  * ``forward``      — full-sequence logits; ``cfg.remat`` recomputes
    each block in the backward pass (``layers.remat_wrap``).
  * ``loss_fn``      — the mean next-token loss (training).
  * ``prefill``      — last-position logits + per-layer KV cache.
  * ``decode_step``  — one token against the cache (serving).

Left out: the sliding window that only the hybrid family's shared blocks
pass.

Under tensor parallelism (``launch.mesh.use_mesh(..., tp=)``, which the
serving steps of ``serve/efm.py`` set on a mesh) the parameters are each
rank's blocks and the layers issue the collectives
(``models/layers.py``); ``prefill`` and ``decode_step`` then build and
update the rank's block of the serve cache, as the serve specs place it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def _norm_init(cfg: ModelConfig, lead=(), device=None) -> Params:
    if cfg.norm == "rmsnorm":
        return L.init_rmsnorm(cfg.d_model, cfg.pdt, lead, device)
    if cfg.norm == "layernorm":
        return L.init_layernorm(cfg.d_model, parametric=True, dtype=cfg.pdt,
                                lead=lead, device=device)
    if cfg.norm == "layernorm_nonparam":
        return L.init_layernorm(cfg.d_model, parametric=False)
    raise ValueError(cfg.norm)


def norm_apply(cfg: ModelConfig, p: Params, x: Tensor) -> Tensor:
    if cfg.norm == "rmsnorm":
        return L.rmsnorm(p, x)
    return L.layernorm(p, x)


def init_block(gen, cfg: ModelConfig, lead=(), device=None) -> Params:
    return {
        "ln1": _norm_init(cfg, lead, device),
        "attn": L.init_attention(
            gen,
            cfg.d_model,
            cfg.n_heads,
            cfg.n_kv_heads,
            cfg.head_dim_,
            qkv_bias=cfg.qkv_bias,
            dtype=cfg.pdt,
            lead=lead,
            device=device,
        ),
        "ln2": _norm_init(cfg, lead, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=cfg.pdt,
                          lead=lead, device=device),
    }


def layer_params(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def block_apply(cfg: ModelConfig, p: Params, x: Tensor, *,
                cache_dtype: Optional[torch.dtype] = None):
    """One block. With ``cache_dtype`` set it returns ``(x, cache)``, the
    layer's KV cache taken from the block's own K/V projections."""
    h = norm_apply(cfg, p["ln1"], x)
    a = L.attention_full(
        p["attn"],
        h,
        cfg.n_heads,
        cfg.n_kv_heads,
        rope_base=cfg.rope_base,
        backend=cfg.attn_backend,
        compute_dtype=cfg.cdt,
        cache_dtype=cache_dtype,
    )
    if cache_dtype is not None:
        a, cache = a
    x = x + a.to(x.dtype)
    h = norm_apply(cfg, p["ln2"], x)
    x = x + L.mlp(p["mlp"], h, cfg.cdt).to(x.dtype)
    return x if cache_dtype is None else (x, cache)


def block_decode(
    cfg: ModelConfig,
    p: Params,
    x: Tensor,
    cache: Dict[str, Tensor],
    pos: int,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    h = norm_apply(cfg, p["ln1"], x)
    a, cache = L.attention_decode(
        p["attn"],
        h,
        cache,
        pos,
        cfg.n_heads,
        cfg.n_kv_heads,
        rope_base=cfg.rope_base,
        compute_dtype=cfg.cdt,
    )
    x = x + a.to(x.dtype)
    h = norm_apply(cfg, p["ln2"], x)
    x = x + L.mlp(p["mlp"], h, cfg.cdt).to(x.dtype)
    return x, cache


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def init(gen: Optional[torch.Generator], cfg: ModelConfig, device) -> Params:
    """Random parameters at the reference's scales, drawn on ``device``
    from ``gen`` (``None`` only for the shapes, on the meta device)."""
    p: Params = {
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdt,
                                  device),
        "layers": init_block(gen, cfg, (cfg.n_layers,), device),
        "final_norm": _norm_init(cfg, device=device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = L.init_linear(gen, cfg.d_model, cfg.vocab,
                                     dtype=cfg.pdt, device=device)
    return p


def _logits(cfg: ModelConfig, p: Params, x: Tensor) -> Tensor:
    x = norm_apply(cfg, p["final_norm"], x)
    if "lm_head" in p:
        return L.gather_vocab(L.linear(p["lm_head"], x, cfg.cdt).float(),
                              "lm_head")
    return L.unembed(p["embed"], x, cfg.cdt)


def forward(p: Params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    """(B, S) int -> (B, S, V) fp32 logits."""
    x = L.embed(p["embed"], tokens, cfg.cdt)

    def body(x, lp):
        return block_apply(cfg, lp, x)

    if cfg.remat:
        body = L.remat_wrap(cfg, body)
    for i in range(cfg.n_layers):
        x = body(x, layer_params(p["layers"], i))
    return _logits(cfg, p, x)


def loss_fn(p: Params, batch: Dict[str, Tensor], cfg: ModelConfig) -> Tensor:
    logits = forward(p, batch["tokens"], cfg)
    return L.next_token_loss(logits, batch["tokens"], batch.get("mask"))


def init_cache(
    cfg: ModelConfig, batch: int, max_seq: int, device
) -> Dict[str, Tensor]:
    """Stacked per-layer KV cache (L, B, Hkv, S, Dh)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=cfg.cachedt, device=device),
        "v": torch.zeros(shape, dtype=cfg.cachedt, device=device),
    }


def prefill(
    p: Params, tokens: Tensor, cfg: ModelConfig
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full-context forward that also returns the stacked KV cache.

    Each layer's cache comes from the K/V its block computes, which the
    reference computes a second time in ``attention_prefill_cache``; the
    values are the same (rotated keys, cast to ``cache_dtype``).
    """
    x = L.embed(p["embed"], tokens, cfg.cdt)
    cache: Dict[str, Tensor] = {}
    for i in range(cfg.n_layers):
        x, cache_l = block_apply(cfg, layer_params(p["layers"], i), x,
                                 cache_dtype=cfg.cachedt)
        for name, t in cache_l.items():
            if i == 0:  # the rank's block of the cache (init_cache's shape
                # on one device)
                cache[name] = t.new_zeros((cfg.n_layers, *t.shape))
            cache[name][i] = t
    return _logits(cfg, p, x[:, -1:]), cache


def decode_step(
    p: Params,
    cache: Dict[str, Tensor],
    token: Tensor,  # (B, 1) int
    pos: int,
    cfg: ModelConfig,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One serving step: next-token logits + the cache, updated in place."""
    x = L.embed(p["embed"], token, cfg.cdt)
    for i in range(cfg.n_layers):
        cache_l = {"k": cache["k"][i], "v": cache["v"][i]}
        x, _ = block_decode(cfg, layer_params(p["layers"], i), x, cache_l,
                            pos)
    return _logits(cfg, p, x), cache
