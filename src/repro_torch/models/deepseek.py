"""DeepSeek V2-Lite / V3 decoder: MLA attention + MoE FFN (+ MTP head).

Port of ``repro/models/deepseek.py``.  Stack layout, as the reference:
  * layers [0, first_k_dense): MLA attention + dense SwiGLU of d_ff_dense;
  * layers [first_k_dense, L): MLA attention + routed MoE (+ shared
    experts);
  * optional MTP module (V3): one extra dense block that predicts token
    t+2 from [h_t ; emb(t_{t+1})].  Only the training loss reads it.

The dense prefix and the MoE stack are two stacked parameter trees
(leading ``L`` axis each), run by Python loops over their layers;
``cfg.remat`` recomputes each block in the backward pass.  ``loss_fn``
adds ``moe_aux_coef`` times the mean load-balance term and, with
``cfg.mtp``, ``mtp_loss_coef`` times the MTP head's loss.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import Tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.transformer import layer_params

Params = Dict[str, Any]


def _init_dense_block(gen, cfg: ModelConfig, lead=(), device=None) -> Params:
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, cfg.pdt, lead, device),
        "attn": MLA.init_mla(gen, cfg, lead, device),
        "ln2": L.init_rmsnorm(cfg.d_model, cfg.pdt, lead, device),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff_dense, dtype=cfg.pdt,
                          lead=lead, device=device),
    }


def _init_moe_block(gen, cfg: ModelConfig, lead=(), device=None) -> Params:
    return {
        "ln1": L.init_rmsnorm(cfg.d_model, cfg.pdt, lead, device),
        "attn": MLA.init_mla(gen, cfg, lead, device),
        "ln2": L.init_rmsnorm(cfg.d_model, cfg.pdt, lead, device),
        "moe": MOE.init_moe(gen, cfg, lead, device),
    }


def init(gen, cfg: ModelConfig, device) -> Params:
    """Random parameters at the reference's scales, drawn on ``device``
    from ``gen`` (``None`` only for the shapes, on the meta device)."""
    n_moe = cfg.n_layers - cfg.first_k_dense
    p: Params = {
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdt,
                                  device),
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdt, device=device),
    }
    if cfg.first_k_dense:
        p["dense_layers"] = _init_dense_block(gen, cfg, (cfg.first_k_dense,),
                                              device)
    p["moe_layers"] = _init_moe_block(gen, cfg, (n_moe,), device)
    if cfg.mtp:
        p["mtp"] = {
            "proj": L.init_linear(gen, 2 * cfg.d_model, cfg.d_model,
                                  dtype=cfg.pdt, device=device),
            "block": _init_dense_block(gen, cfg.replace(d_ff_dense=cfg.d_ff),
                                       device=device),
            "norm_h": L.init_rmsnorm(cfg.d_model, cfg.pdt, device=device),
            "norm_e": L.init_rmsnorm(cfg.d_model, cfg.pdt, device=device),
        }
    return p


def _dense_block(cfg: ModelConfig, lp: Params, x: Tensor) -> Tensor:
    x = x + MLA.mla_full(lp["attn"], L.rmsnorm(lp["ln1"], x), cfg).to(x.dtype)
    return x + L.mlp(lp["mlp"], L.rmsnorm(lp["ln2"], x), cfg.cdt).to(x.dtype)


def _moe_block(cfg: ModelConfig, lp: Params,
               x: Tensor) -> Tuple[Tensor, Tensor]:
    x = x + MLA.mla_full(lp["attn"], L.rmsnorm(lp["ln1"], x), cfg).to(x.dtype)
    y, aux = MOE.moe_ffn(lp["moe"], L.rmsnorm(lp["ln2"], x), cfg)
    return x + y.to(x.dtype), aux


def _backbone(p: Params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Run the full stack; returns (hidden, mean aux term)."""

    def dense_body(x, lp):
        return _dense_block(cfg, lp, x)

    def moe_body(x, lp):
        return _moe_block(cfg, lp, x)

    if cfg.remat:
        dense_body = L.remat_wrap(cfg, dense_body)
        moe_body = L.remat_wrap(cfg, moe_body)
    for i in range(cfg.first_k_dense):
        x = dense_body(x, layer_params(p["dense_layers"], i))
    auxes = []
    for i in range(cfg.n_layers - cfg.first_k_dense):
        x, aux = moe_body(x, layer_params(p["moe_layers"], i))
        auxes.append(aux)
    return x, torch.stack(auxes).mean()


def forward(p: Params, tokens: Tensor,
            cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Returns (logits (B,S,V) float32, MoE aux term)."""
    x = L.embed(p["embed"], tokens, cfg.cdt)
    x, aux = _backbone(p, x, cfg)
    x = L.rmsnorm(p["final_norm"], x)
    return L.unembed(p["embed"], x, cfg.cdt), aux


def mtp_loss(p: Params, h: Tensor, tokens: Tensor,
             cfg: ModelConfig) -> Tensor:
    """The MTP head's mean loss: from h_t and emb(t_{t+1}), token t+2."""
    mp = p["mtp"]
    h_in = L.rmsnorm(mp["norm_h"], h[:, :-2])
    e_in = L.rmsnorm(mp["norm_e"],
                     L.embed(p["embed"], tokens[:, 1:-1], cfg.cdt))
    z = L.linear(mp["proj"], torch.cat([h_in, e_in], -1), cfg.cdt)
    z = _dense_block(cfg.replace(d_ff_dense=cfg.d_ff), mp["block"], z)
    logits = L.unembed(p["embed"], z, cfg.cdt)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tokens[:, 2:].long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def loss_fn(p: Params, batch: Dict[str, Tensor], cfg: ModelConfig) -> Tensor:
    tokens = batch["tokens"]
    x = L.embed(p["embed"], tokens, cfg.cdt)
    h, aux = _backbone(p, x, cfg)
    logits = L.unembed(p["embed"], L.rmsnorm(p["final_norm"], h), cfg.cdt)
    loss = L.next_token_loss(logits, tokens, batch.get("mask"))
    loss = loss + cfg.moe_aux_coef * aux
    if cfg.mtp:
        loss = loss + cfg.mtp_loss_coef * mtp_loss(p, h, tokens, cfg)
    return loss


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device) -> Dict[str, Any]:
    cache: Dict[str, Any] = {"moe": MLA.init_mla_cache(
        cfg, cfg.n_layers - cfg.first_k_dense, batch, max_seq, device)}
    if cfg.first_k_dense:
        cache["dense"] = MLA.init_mla_cache(cfg, cfg.first_k_dense, batch,
                                            max_seq, device)
    return cache


def _layer_cache(stack: Dict[str, Tensor], i: int) -> Dict[str, Tensor]:
    """Layer ``i`` of a stacked cache (views: decode writes through)."""
    return {k: v[i] for k, v in stack.items()}


def prefill(p: Params, tokens: Tensor,
            cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Any]]:
    """Last-position logits and the compressed cache of the prompt."""
    x = L.embed(p["embed"], tokens, cfg.cdt)
    cache = init_cache(cfg, tokens.shape[0], tokens.shape[1], x.device)

    def write(name, i, lp, x):
        c = MLA.mla_prefill_cache(lp["attn"], L.rmsnorm(lp["ln1"], x), cfg)
        for k, v in c.items():
            cache[name][k][i] = v

    for i in range(cfg.first_k_dense):
        lp = layer_params(p["dense_layers"], i)
        write("dense", i, lp, x)
        x = _dense_block(cfg, lp, x)
    for i in range(cfg.n_layers - cfg.first_k_dense):
        lp = layer_params(p["moe_layers"], i)
        write("moe", i, lp, x)
        x, _ = _moe_block(cfg, lp, x)
    logits = L.unembed(p["embed"], L.rmsnorm(p["final_norm"], x[:, -1:]),
                       cfg.cdt)
    return logits, cache


def decode_step(p: Params, cache: Dict[str, Any], token: Tensor, pos: int,
                cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Any]]:
    """One serving step: next-token logits + the cache, updated in place."""
    x = L.embed(p["embed"], token, cfg.cdt)
    for name, key in (("dense", "dense_layers"), ("moe", "moe_layers")):
        if key not in p:
            continue
        for i in range(cache[name]["c_kv"].shape[0]):
            lp = layer_params(p[key], i)
            a, _ = MLA.mla_decode(lp["attn"], L.rmsnorm(lp["ln1"], x),
                                  _layer_cache(cache[name], i), pos, cfg)
            x = x + a.to(x.dtype)
            h = L.rmsnorm(lp["ln2"], x)
            if name == "dense":
                y = L.mlp(lp["mlp"], h, cfg.cdt)
            else:
                y, _ = MOE.moe_ffn(lp["moe"], h, cfg)
            x = x + y.to(x.dtype)
    logits = L.unembed(p["embed"], L.rmsnorm(p["final_norm"], x), cfg.cdt)
    return logits, cache
