"""Multi-head Latent Attention (DeepSeek V2/V3).

Port of ``repro/models/mla.py``.  MLA compresses the KV cache into a
low-rank latent ``c_kv`` of width ``kv_lora_rank`` plus one shared RoPE
key of width ``qk_rope_dim``: the cache is (S, kv_lora + rope) per token
instead of (S, 2*H*Dh).

Two execution forms (mathematically identical):

  * decompressed (prefill): up-project c_kv to per-head K/V and run
    ordinary attention, on ``cfg.attn_backend``: ``"chunked"``
    (:func:`~repro_torch.models.layers.attention_chunked`, qk head dim
    ``nope + rope``, v head dim ``v_head_dim``) or the masked softmax.
    No kernel: the reference has none for MLA, and the flash kernel's
    contract needs the same head dim for q, k and v;
  * absorbed (decode): fold W_UK into the query and W_UV into the output,
    so attention runs directly against the compressed cache.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def init_mla(gen, cfg: ModelConfig, lead=(), device=None) -> Params:
    h, nope, rope_d, vdim = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                             cfg.v_head_dim)
    kw = dict(dtype=cfg.pdt, lead=lead, device=device)
    p: Params = {}
    if cfg.q_lora_rank:
        p["wq_a"] = L.init_linear(gen, cfg.d_model, cfg.q_lora_rank, **kw)
        p["q_norm"] = L.init_rmsnorm(cfg.q_lora_rank, cfg.pdt, lead, device)
        p["wq_b"] = L.init_linear(gen, cfg.q_lora_rank, h * (nope + rope_d),
                                  **kw)
    else:
        p["wq"] = L.init_linear(gen, cfg.d_model, h * (nope + rope_d), **kw)
    p["wkv_a"] = L.init_linear(gen, cfg.d_model, cfg.kv_lora_rank, **kw)
    p["kv_norm"] = L.init_rmsnorm(cfg.kv_lora_rank, cfg.pdt, lead, device)
    p["wk_rope"] = L.init_linear(gen, cfg.d_model, rope_d, **kw)
    p["wk_b"] = L.init_linear(gen, cfg.kv_lora_rank, h * nope, **kw)
    p["wv_b"] = L.init_linear(gen, cfg.kv_lora_rank, h * vdim, **kw)
    p["wo"] = L.init_linear(gen, h * vdim, cfg.d_model, **kw)
    return p


def _queries(p: Params, x: Tensor, cfg: ModelConfig,
             positions: Tensor) -> Tuple[Tensor, Tensor]:
    """Project + rope queries. Returns (q_nope (B,H,S,nope), q_rope
    (B,H,S,rope))."""
    b, s, _ = x.shape
    h, nope, rope_d = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = L.linear(p["wq_b"],
                     L.rmsnorm(p["q_norm"], L.linear(p["wq_a"], x, cfg.cdt)),
                     cfg.cdt)
    else:
        q = L.linear(p["wq"], x, cfg.cdt)
    q = q.reshape(b, s, h, nope + rope_d).transpose(1, 2)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    cos, sin = L.rope_cos_sin(positions, rope_d, cfg.rope_base)
    return q_nope, L.apply_rope(q_rope, cos, sin)


def _latents(p: Params, x: Tensor, cfg: ModelConfig,
             positions: Tensor) -> Tuple[Tensor, Tensor]:
    """Compressed latents: c_kv (B,S,r) normalised, k_rope (B,S,rope)
    roped."""
    c_kv = L.rmsnorm(p["kv_norm"], L.linear(p["wkv_a"], x, cfg.cdt))
    k_rope = L.linear(p["wk_rope"], x, cfg.cdt)
    cos, sin = L.rope_cos_sin(positions, cfg.qk_rope_dim, cfg.rope_base)
    return c_kv, L.apply_rope(k_rope, cos, sin)


def mla_full(p: Params, x: Tensor, cfg: ModelConfig, *,
             positions: Optional[Tensor] = None) -> Tensor:
    """Decompressed full-sequence MLA (prefill). (B,S,D) -> (B,S,D)."""
    b, s, _ = x.shape
    h, nope, rope_d, vdim = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                             cfg.v_head_dim)
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _queries(p, x, cfg, positions)
    c_kv, k_rope = _latents(p, x, cfg, positions)

    k_nope = L.linear(p["wk_b"], c_kv, cfg.cdt).reshape(
        b, s, h, nope).transpose(1, 2)
    v = L.linear(p["wv_b"], c_kv, cfg.cdt).reshape(
        b, s, h, vdim).transpose(1, 2)
    q = torch.cat([q_nope, q_rope], dim=-1)  # (B,H,S,nope+rope)
    k = torch.cat([k_nope, k_rope[:, None].expand(b, h, s, rope_d)], dim=-1)
    if cfg.attn_backend == "chunked":
        o = L.attention_chunked(q, k, v, causal=True)
    else:
        scale = 1.0 / math.sqrt(nope + rope_d)
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * scale
        keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~keep, L._NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(cfg.cdt)
        o = torch.matmul(probs, v)
    o = o.transpose(1, 2).reshape(b, s, h * vdim)
    return L.linear(p["wo"], o, cfg.cdt)


def mla_prefill_cache(p: Params, x: Tensor,
                      cfg: ModelConfig) -> Dict[str, Tensor]:
    """Compressed cache for a prefix: c_kv (B,S,r) + k_rope (B,S,rope)."""
    s = x.shape[1]
    c_kv, k_rope = _latents(p, x, cfg, torch.arange(s, device=x.device))
    return {"c_kv": c_kv.to(cfg.cachedt), "k_rope": k_rope.to(cfg.cachedt)}


def init_mla_cache(cfg: ModelConfig, n_layers: int, batch: int,
                   max_seq: int, device=None) -> Dict[str, Tensor]:
    kw = dict(dtype=cfg.cachedt, device=device)
    return {
        "c_kv": torch.zeros((n_layers, batch, max_seq, cfg.kv_lora_rank),
                            **kw),
        "k_rope": torch.zeros((n_layers, batch, max_seq, cfg.qk_rope_dim),
                              **kw),
    }


def mla_decode(
    p: Params,
    x: Tensor,  # (B, 1, D)
    cache: Dict[str, Tensor],  # c_kv (B,S,r), k_rope (B,S,rope)
    pos: int,
    cfg: ModelConfig,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Absorbed one-token MLA decode against the compressed cache.

    The new latents are written into ``cache`` in place; a position
    outside the cache raises (the reference's ``dynamic_update_slice``
    would clamp it), as in the dense decode.
    """
    pos = int(pos)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    skv = c_kv.shape[1]
    if not 0 <= pos < skv:
        raise IndexError(f"decode position {pos} outside the cache [0, {skv})")
    b = x.shape[0]
    h, nope, rope_d, vdim, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                                cfg.v_head_dim, cfg.kv_lora_rank)
    positions = torch.full((1,), pos, device=x.device)
    q_nope, q_rope = _queries(p, x, cfg, positions)  # (B,H,1,*)
    c_new, kr_new = _latents(p, x, cfg, positions)  # (B,1,r), (B,1,rope)
    c_kv[:, pos:pos + 1] = c_new.to(c_kv.dtype)
    k_rope[:, pos:pos + 1] = kr_new.to(k_rope.dtype)

    # Absorb W_UK into q: q_abs[b,h,r] = sum_n q_nope[b,h,n] W_UK[r, h, n].
    wk_b = p["wk_b"]["w"].to(cfg.cdt).reshape(r, h, nope)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope[:, :, 0], wk_b)

    ckv_f = c_kv.to(cfg.cdt)
    kr_f = k_rope.to(cfg.cdt)
    scores = (torch.matmul(q_abs, ckv_f.transpose(1, 2))
              + torch.matmul(q_rope[:, :, 0], kr_f.transpose(1, 2)))
    scores = scores.float() / math.sqrt(nope + rope_d)
    keep = torch.arange(skv, device=x.device) <= pos
    scores = scores.masked_fill(~keep, L._NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(cfg.cdt)
    ctx = torch.matmul(probs, ckv_f)  # (B,H,r)

    # Absorb W_UV on the way out: o[b,h,v] = sum_r ctx[b,h,r] W_UV[r,h,v].
    wv_b = p["wv_b"]["w"].to(cfg.cdt).reshape(r, h, vdim)
    o = torch.einsum("bhr,rhv->bhv", ctx, wv_b).reshape(b, 1, h * vdim)
    return L.linear(p["wo"], o, cfg.cdt), cache
