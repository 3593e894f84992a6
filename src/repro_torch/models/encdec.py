"""Seamless-M4T v2 large backbone: speech encoder + text decoder.

Port of ``repro/models/encdec.py``.  The modality frontend is a stub: the
encoder consumes precomputed audio-frame embeddings ``src_embed``
(B, S_src, d_model), and the conformer convolution modules are a
standard pre-LN transformer encoder, as in the reference.

Encoder: bidirectional self-attention (RoPE) + GeLU FFN, on
``cfg.attn_backend`` (the flash kernel's non-causal instance on
``"pallas"``).  Decoder: causal self-attention (RoPE) on
``cfg.attn_backend``, then cross-attention over the encoder output on
the masked path (the reference's routing), then a GeLU FFN.  LayerNorm
with eps 1e-5, the tanh GeLU.

Serving decodes the decoder one token at a time against (a) the
self-attention KV cache and (b) the cross K/V precomputed from the
encoder output.  ``loss_fn`` is the training loss; ``cfg.remat``
recomputes each encoder and decoder block in the backward pass.  The
cross-attention decode takes the reference's decode-sharding hints inside
``layers.cross_attention_decode``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import Tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_params

Params = Dict[str, Any]


def src_len(cfg: ModelConfig, seq_len: int) -> int:
    return max(16, int(seq_len * cfg.src_seq_frac))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _ln(cfg, lead, device) -> Params:
    return L.init_layernorm(cfg.d_model, dtype=cfg.pdt, lead=lead,
                            device=device)


def _attn(gen, cfg, lead, device) -> Params:
    return L.init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim_, dtype=cfg.pdt, lead=lead,
                            device=device)


def init_enc_block(gen, cfg: ModelConfig, lead=(), device=None) -> Params:
    return {
        "ln1": _ln(cfg, lead, device),
        "attn": _attn(gen, cfg, lead, device),
        "ln2": _ln(cfg, lead, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, kind="gelu",
                          dtype=cfg.pdt, lead=lead, device=device),
    }


def init_dec_block(gen, cfg: ModelConfig, lead=(), device=None) -> Params:
    return {
        "ln1": _ln(cfg, lead, device),
        "self_attn": _attn(gen, cfg, lead, device),
        "ln_x": _ln(cfg, lead, device),
        "cross_attn": _attn(gen, cfg, lead, device),
        "ln2": _ln(cfg, lead, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, kind="gelu",
                          dtype=cfg.pdt, lead=lead, device=device),
    }


def enc_block(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    h = L.layernorm(p["ln1"], x)
    x = x + L.attention_full(
        p["attn"], h, cfg.n_heads, cfg.n_kv_heads,
        rope_base=cfg.rope_base, causal=False,
        backend=cfg.attn_backend, compute_dtype=cfg.cdt,
    ).to(x.dtype)
    return x + L.mlp(p["mlp"], L.layernorm(p["ln2"], x), cfg.cdt).to(x.dtype)


def dec_block(p: Params, x: Tensor, enc_out: Tensor,
              cfg: ModelConfig) -> Tensor:
    h = L.layernorm(p["ln1"], x)
    x = x + L.attention_full(
        p["self_attn"], h, cfg.n_heads, cfg.n_kv_heads,
        rope_base=cfg.rope_base, causal=True,
        backend=cfg.attn_backend, compute_dtype=cfg.cdt,
    ).to(x.dtype)
    h = L.layernorm(p["ln_x"], x)
    x = x + L.attention_full(
        p["cross_attn"], h, cfg.n_heads, cfg.n_kv_heads,
        rope_base=0.0, causal=False, kv_ctx=enc_out, compute_dtype=cfg.cdt,
    ).to(x.dtype)
    return x + L.mlp(p["mlp"], L.layernorm(p["ln2"], x), cfg.cdt).to(x.dtype)


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def init(gen, cfg: ModelConfig, device) -> Params:
    """Random parameters at the reference's scales, drawn on ``device``
    from ``gen`` (``None`` only for the shapes, on the meta device)."""
    return {
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdt,
                                  device),
        "enc_layers": init_enc_block(gen, cfg, (cfg.enc_layers,), device),
        "enc_norm": _ln(cfg, (), device),
        "dec_layers": init_dec_block(gen, cfg, (cfg.dec_layers,), device),
        "dec_norm": _ln(cfg, (), device),
    }


def encode(p: Params, src_embed: Tensor, cfg: ModelConfig) -> Tensor:
    x = src_embed.to(cfg.cdt)

    def body(x, lp):
        return enc_block(lp, x, cfg)

    if cfg.remat:
        body = L.remat_wrap(cfg, body)
    for i in range(cfg.enc_layers):
        x = body(x, layer_params(p["enc_layers"], i))
    return L.layernorm(p["enc_norm"], x)


def forward(p: Params, src_embed: Tensor, tgt_tokens: Tensor,
            cfg: ModelConfig) -> Tensor:
    """(B, S_src, D) source, (B, S) target tokens -> (B, S, V) fp32."""
    enc_out = encode(p, src_embed, cfg)
    x = L.embed(p["embed"], tgt_tokens, cfg.cdt)

    def body(x, lp):
        return dec_block(lp, x, enc_out, cfg)

    if cfg.remat:
        body = L.remat_wrap(cfg, body)
    for i in range(cfg.dec_layers):
        x = body(x, layer_params(p["dec_layers"], i))
    x = L.layernorm(p["dec_norm"], x)
    return L.unembed(p["embed"], x, cfg.cdt)


def loss_fn(p: Params, batch: Dict[str, Tensor], cfg: ModelConfig) -> Tensor:
    logits = forward(p, batch["src_embed"], batch["tokens"], cfg)
    return L.next_token_loss(logits, batch["tokens"], batch.get("mask"))


# ---------------------------------------------------------------------------
# Serving (decoder step)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, src_seq: int,
               device) -> Dict[str, Tensor]:
    shape = (cfg.dec_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim_)
    xshape = (cfg.dec_layers, batch, cfg.n_kv_heads, src_seq, cfg.head_dim_)
    kw = dict(dtype=cfg.cachedt, device=device)
    return {"k": torch.zeros(shape, **kw), "v": torch.zeros(shape, **kw),
            "xk": torch.zeros(xshape, **kw), "xv": torch.zeros(xshape, **kw)}


def precompute_cross_cache(p: Params, src_embed: Tensor,
                           cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Encode the source and project per-decoder-layer cross K/V: two
    (L, B, Hkv, S_src, Dh) tensors in ``cfg.cachedt``."""
    enc_out = encode(p, src_embed, cfg)
    ks, vs = [], []
    for i in range(cfg.dec_layers):
        k, v = L.cross_kv(layer_params(p["dec_layers"], i)["cross_attn"],
                          enc_out, cfg.n_kv_heads, compute_dtype=cfg.cdt,
                          cache_dtype=cfg.cachedt)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def _cross_decode(lp: Params, x: Tensor, xk: Tensor, xv: Tensor,
                  cfg: ModelConfig) -> Tensor:
    a = L.cross_attention_decode(lp["cross_attn"], L.layernorm(lp["ln_x"], x),
                                 xk, xv, cfg.n_heads, compute_dtype=cfg.cdt)
    return x + a.to(x.dtype)


def decode_step(p: Params, cache: Dict[str, Tensor], token: Tensor,
                pos: int, cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decoder step: next-token logits + the cache, its self K/V
    updated in place."""
    x = L.embed(p["embed"], token, cfg.cdt)
    for i in range(cfg.dec_layers):
        lp = layer_params(p["dec_layers"], i)
        h = L.layernorm(lp["ln1"], x)
        a, _ = L.attention_decode(
            lp["self_attn"], h, {"k": cache["k"][i], "v": cache["v"][i]},
            pos, cfg.n_heads, cfg.n_kv_heads, rope_base=cfg.rope_base,
            compute_dtype=cfg.cdt,
        )
        x = x + a.to(x.dtype)
        x = _cross_decode(lp, x, cache["xk"][i], cache["xv"][i], cfg)
        x = x + L.mlp(lp["mlp"], L.layernorm(lp["ln2"], x),
                      cfg.cdt).to(x.dtype)
    x = L.layernorm(p["dec_norm"], x)
    return L.unembed(p["embed"], x, cfg.cdt), cache
