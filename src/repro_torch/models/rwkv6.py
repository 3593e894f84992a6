"""RWKV6 "Finch" language model (attention-free, data-dependent decay).

Port of ``repro/models/rwkv6.py``.  Block = TimeMix (the RWKV6 linear
attention with per-channel dynamic decay, computed by the ``rwkv6_scan``
op) + ChannelMix (squared-ReLU FFN with token-shift), both with the RWKV6
"ddlerp" dynamic token-shift mixing:

  delta_t  = x_{t-1} - x_t
  xx       = x + delta * mu_x
  mix_i    = mu_i + tanh(xx @ A) @ B_i          (low-rank, per branch i)
  x_i      = x + delta * mix_i                  for i in {r, k, v, w, g}

Decay: w_log = -exp(w0 + tanh(x_w @ Aw) @ Bw)   (always < 0, data-dependent)

Serving state per layer: (shift_tm (B, D), shift_cm (B, D), wkv (B, H, K,
V)), O(1) in context length.  The layer stack keeps the reference's
layout (a leading ``L`` axis) and a Python loop takes the place of
``lax.scan``.  ``prefill`` takes the scan's backend: the reference's
``"chunked"`` by default, ``"pallas"`` for the CUDA kernel.  ``forward``
and ``loss_fn`` (training) run the scan on ``"ref"``, as the reference's
do; ``cfg.remat`` recomputes each block in the backward pass.

Tensor parallelism (``serve/efm.py``'s serving steps on a mesh; the plan
is ``layers.tensor_parallel()``): ``tm/wr``, ``tm/wg``, ``cm/wr`` are
column blocks, ``tm/wo`` row blocks, ``tm/wk``, ``tm/wv``, ``cm/wk``,
``cm/wv`` column blocks only where the heads and their width divide the
model axis (whole otherwise), the mixing vectors whole.  The scan runs split over K, as the
serve specs place ``wkv`` (L, B, H, K, V): decay, state and the intra-chunk
terms are each k's own and meet only in ``o = sum_k r[k] (...)``, so each
rank scans its K-slice of every head (r, k, ``w_log`` and u cut to it, v
whole) and the partial o is all-reduced in float32; the state never
moves.  r, k and v are all-gathered where their weights are split, the
``tm/wo`` products all-reduced (``layers.linear_row``).  The channel mix
gathers ``cm/wk``'s columns (``cm/wv`` reads all of ``d_ff``) and its
output's block of ``d_model``.  The token-shift states are split over D:
decode all-gathers each before its mixing and keeps its block of the new
one.  Where K does not divide the axis, ``wkv`` is whole and every rank
scans all of K.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan
from repro_torch.launch import collectives as C
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_params

Params = Dict[str, Any]

_TM_BRANCHES = 5  # r, k, v, w, g


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def init_block(gen, cfg: ModelConfig, lead=(), device=None) -> Params:
    d, r = cfg.d_model, cfg.rwkv_lora_rank
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    s = 1.0 / math.sqrt(d)
    pdt = cfg.pdt

    def zeros(*shape):
        return torch.zeros((*lead, *shape), dtype=pdt, device=device)

    def lin(din, dout):
        return L.init_linear(gen, din, dout, dtype=pdt, lead=lead,
                             device=device)

    def ln():
        return L.init_layernorm(d, dtype=pdt, lead=lead, device=device)

    return {
        "ln1": ln(),
        "tm": {
            "mu_x": zeros(d),
            "mu": zeros(_TM_BRANCHES, d),
            "lora_a": L._normal(gen, (*lead, d, r), s, pdt, device),
            "lora_b": zeros(_TM_BRANCHES, r, d),
            "w0": torch.full((*lead, d), -2.0, dtype=pdt, device=device),
            "decay_a": L._normal(gen, (*lead, d, cfg.rwkv_decay_lora_rank),
                                 s, pdt, device),
            "decay_b": zeros(cfg.rwkv_decay_lora_rank, d),
            "u": L._normal(gen, (*lead, h, hd), 0.3, pdt, device),
            "wr": lin(d, d),
            "wk": lin(d, d),
            "wv": lin(d, d),
            "wg": lin(d, d),
            "gn_scale": torch.ones((*lead, h, hd), dtype=pdt, device=device),
            "gn_bias": zeros(h, hd),
            "wo": lin(d, d),
        },
        "ln2": ln(),
        "cm": {
            "mu_k": zeros(d),
            "mu_r": zeros(d),
            "wk": lin(d, cfg.d_ff),
            "wv": lin(cfg.d_ff, d),
            "wr": lin(d, d),
        },
    }


def _ddlerp(tm: Params, x: Tensor, x_prev: Tensor, cdt) -> Tuple[Tensor, ...]:
    """RWKV6 dynamic token-shift mixing -> (x_r, x_k, x_v, x_w, x_g)."""
    delta = x_prev - x
    xx = x + delta * tm["mu_x"].to(cdt)
    low = torch.tanh(torch.matmul(xx, tm["lora_a"].to(cdt)))  # (..., r)
    d = x.shape[-1]
    mu = tm["mu"].to(cdt).reshape((_TM_BRANCHES,) + (1,) * (x.ndim - 1) + (d,))
    mixes = mu + torch.einsum("...r,brd->b...d", low,
                              tm["lora_b"].to(cdt))  # (5, ..., d)
    return tuple(x + delta * mixes[i] for i in range(_TM_BRANCHES))


def _decay_log(tm: Params, x_w: Tensor, cdt) -> Tensor:
    """Data-dependent per-channel log decay (< 0)."""
    dyn = torch.matmul(
        torch.tanh(torch.matmul(x_w, tm["decay_a"].to(cdt))),
        tm["decay_b"].to(cdt),
    )
    return -torch.exp(tm["w0"].to(cdt) + dyn)


def _group_norm(tm: Params, o: Tensor, eps: float = 1e-5) -> Tensor:
    """Per-head layernorm of the wkv output. o: (B, T, H, hd)."""
    mu = torch.mean(o, dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, correction=0)
    y = (o - mu) * torch.rsqrt(var + eps)
    return y * tm["gn_scale"].to(o.dtype) + tm["gn_bias"].to(o.dtype)


def _shift(x: Tensor) -> Tensor:
    """x_{t-1} along the sequence axis, zeros at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def time_mix(
    tm: Params,
    x: Tensor,
    cfg: ModelConfig,
    *,
    backend: str = "ref",
    return_state: bool = False,
):
    """Full-sequence TimeMix. x: (B, T, D) -> (B, T, D) [, final wkv state]."""
    b, t, d = x.shape
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    cdt = cfg.cdt
    tp = L.tensor_parallel()
    x_r, x_k, x_v, x_w, x_g = _ddlerp(tm, x, _shift(x), cdt)

    def heads(y):
        return y.reshape(b, t, h, hd).transpose(1, 2)

    r = heads(_projection(tp, tm, "wr", x_r, cdt))
    k = heads(_projection(tp, tm, "wk", x_k, cdt))
    v = heads(_projection(tp, tm, "wv", x_v, cdt))
    g = F.silu(L.linear(tm["wg"], x_g, cdt))
    w_log = heads(_decay_log(tm, x_w, cdt))

    ks = _k_slice(tp, hd)  # the rank's channels of K (all without a plan)
    o, s_fin = rwkv6_scan(r[..., ks], k[..., ks], v, w_log[..., ks],
                          tm["u"].to(cdt)[:, ks], backend=backend,
                          chunk=cfg.scan_chunk)  # (B, H, T, hd)
    # On "pallas" o is the view of a (B, T, H, hd) buffer: the transpose is
    # contiguous, and so are the all-reduce's copy and the cast, so the
    # reshape after the norm copies nothing.
    o = _sum_over_k(tp, o.transpose(1, 2)).to(cdt)  # (B, T, H, hd)
    o = _group_norm(tm, o).reshape(b, t, d)
    out = _out_projection(tp, tm, o, g, cdt)
    if return_state:
        return out, s_fin
    return out


def _projection(tp, tm: Params, name: str, x: Tensor, cdt) -> Tensor:
    """TimeMix projection ``name`` (``wr``, ``wk``, ``wv``) over every
    column: all-gathered where its weight is this rank's column block."""
    return L.whole_cols(tp, L.linear(tm[name], x, cdt), f"tm/{name}")


def _k_slice(tp, hd: int) -> slice:
    """The channels of K this rank scans: its block where the plan splits
    ``wkv`` over K, all of them otherwise."""
    if tp is None or "wkv" not in tp.state:
        return slice(None)
    return slice(*L.model_block(hd, tp))


def _sum_over_k(tp, o: Tensor) -> Tensor:
    """The scan's output summed over every rank's K-slice, in float32
    (``o`` as it is where each rank scans all of K)."""
    if tp is None or "wkv" not in tp.state:
        return o
    return L._sum_over_model(tp, o)


def _out_projection(tp, tm: Params, o: Tensor, g: Tensor, cdt) -> Tensor:
    """``wo(o * g)``; where ``tm/wo`` is split (row blocks, and ``tm/wg``'s
    column blocks: both on ``d_model``), on the rank's block of o's
    channels, the partial products all-reduced."""
    if L._split(tp, "tm/wo"):
        o = L.block_of(tp, o)
    return L.linear_row(tm["wo"], o * g, cdt, "tm/wo")


def _channel_mix_tokens(cm: Params, x: Tensor, x_prev: Tensor, cdt) -> Tensor:
    tp = L.tensor_parallel()
    delta = x_prev - x
    x_k = x + delta * cm["mu_k"].to(cdt)
    x_r = x + delta * cm["mu_r"].to(cdt)
    k = torch.square(torch.relu(L.linear(cm["wk"], x_k, cdt)))
    k = L.whole_cols(tp, k, "cm/wk")  # cm/wv reads all of d_ff
    r = torch.sigmoid(L.linear(cm["wr"], x_r, cdt))
    v = L.linear(cm["wv"], k, cdt)
    split = [L._split(tp, f"cm/{n}") for n in ("wr", "wv")]
    if not any(split):
        return r * v
    # the product on the rank's block of d_model, gathered after it
    r, v = (y if s else L.block_of(tp, y) for y, s in zip((r, v), split))
    return C.all_gather(r * v, tp.group, -1)


def channel_mix(cm: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    return _channel_mix_tokens(cm, x, _shift(x), cfg.cdt)


def block_apply(cfg: ModelConfig, lp: Params, x: Tensor, *,
                backend: str = "ref") -> Tensor:
    x = x + time_mix(lp["tm"], L.layernorm(lp["ln1"], x), cfg,
                     backend=backend).to(x.dtype)
    x = x + channel_mix(lp["cm"], L.layernorm(lp["ln2"], x), cfg).to(x.dtype)
    return x


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def init(gen: Optional[torch.Generator], cfg: ModelConfig, device) -> Params:
    """Random parameters at the reference's scales, drawn on ``device``
    from ``gen`` (``None`` only for the shapes, on the meta device)."""
    return {
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdt,
                                  device),
        "ln_in": L.init_layernorm(cfg.d_model, dtype=cfg.pdt, device=device),
        "layers": init_block(gen, cfg, (cfg.n_layers,), device),
        "final_norm": L.init_layernorm(cfg.d_model, dtype=cfg.pdt,
                                       device=device),
    }


def forward(p: Params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    """(B, S) int -> (B, S, V) fp32 logits (the scan on ``"ref"``, as the
    reference's ``block_apply`` has it)."""
    x = L.embed(p["embed"], tokens, cfg.cdt)
    x = L.layernorm(p["ln_in"], x)

    def body(x, lp):
        return block_apply(cfg, lp, x)

    if cfg.remat:
        body = L.remat_wrap(cfg, body)
    for i in range(cfg.n_layers):
        x = body(x, layer_params(p["layers"], i))
    x = L.layernorm(p["final_norm"], x)
    return L.unembed(p["embed"], x, cfg.cdt)


def loss_fn(p: Params, batch: Dict[str, Tensor], cfg: ModelConfig) -> Tensor:
    logits = forward(p, batch["tokens"], cfg)
    return L.next_token_loss(logits, batch["tokens"], batch.get("mask"))


def prefill(
    p: Params, tokens: Tensor, cfg: ModelConfig, *,
    scan_backend: str = "chunked",
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Ingest a prefix; returns (last-token logits, recurrent serve state).

    ``scan_backend`` is the ``rwkv6_scan`` backend of every layer:
    ``"chunked"`` (the reference's), ``"ref"`` or ``"pallas"``.
    """
    tp = L.tensor_parallel()
    x = L.embed(p["embed"], tokens, cfg.cdt)
    x = L.layernorm(p["ln_in"], x)
    sh_tm, sh_cm, wkv = [], [], []
    for i in range(cfg.n_layers):
        lp = layer_params(p["layers"], i)
        h1 = L.layernorm(lp["ln1"], x)
        a, s_fin = time_mix(lp["tm"], h1, cfg, backend=scan_backend,
                            return_state=True)
        x = x + a.to(x.dtype)
        h2 = L.layernorm(lp["ln2"], x)
        x = x + channel_mix(lp["cm"], h2, cfg).to(x.dtype)
        sh_tm.append(L.state_block(tp, h1[:, -1], "shift_tm"))
        sh_cm.append(L.state_block(tp, h2[:, -1], "shift_cm"))
        wkv.append(s_fin)
    x = L.layernorm(p["final_norm"], x[:, -1:])
    logits = L.unembed(p["embed"], x, cfg.cdt)
    state = {
        "shift_tm": torch.stack(sh_tm).float(),
        "shift_cm": torch.stack(sh_cm).float(),
        "wkv": torch.stack(wkv).float(),
    }
    return logits, state


# ---------------------------------------------------------------------------
# Serving: O(1) recurrent state
# ---------------------------------------------------------------------------


def init_state(cfg: ModelConfig, batch: int, device) -> Dict[str, Tensor]:
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    f32 = torch.float32
    return {
        "shift_tm": torch.zeros((cfg.n_layers, batch, cfg.d_model),
                                dtype=f32, device=device),
        "shift_cm": torch.zeros((cfg.n_layers, batch, cfg.d_model),
                                dtype=f32, device=device),
        "wkv": torch.zeros((cfg.n_layers, batch, h, hd, hd), dtype=f32,
                           device=device),
    }


def _tm_step(
    tm: Params, x: Tensor, shift: Tensor, wkv: Tensor, cfg: ModelConfig
) -> Tuple[Tensor, Tensor]:
    """One-token TimeMix. x: (B, D); wkv: (B, H, K, V), this rank's
    K-slice under tensor parallelism."""
    b, d = x.shape
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    cdt = cfg.cdt
    tp = L.tensor_parallel()
    x_r, x_k, x_v, x_w, x_g = _ddlerp(tm, x, shift, cdt)
    ks = _k_slice(tp, hd)
    r = _projection(tp, tm, "wr", x_r, cdt).reshape(b, h, hd)[..., ks]
    k = _projection(tp, tm, "wk", x_k, cdt).reshape(b, h, hd)[..., ks]
    v = _projection(tp, tm, "wv", x_v, cdt).reshape(b, h, hd)
    g = F.silu(L.linear(tm["wg"], x_g, cdt))
    w_log = _decay_log(tm, x_w, cdt).reshape(b, h, hd)[..., ks]
    u = tm["u"].to(cdt)[:, ks]

    kv = k[..., None] * v[..., None, :]  # (B, H, K, V)
    o = torch.einsum("bhk,bhkv->bhv", r.to(wkv.dtype),
                     wkv + u[None, :, :, None] * kv)
    o = _sum_over_k(tp, o)
    wkv_new = torch.exp(w_log)[..., None] * wkv + kv
    o = _group_norm(tm, o[:, None])[:, 0]  # (B, H, hd)
    o = o.reshape(b, d)
    return _out_projection(tp, tm, o, g, cdt), wkv_new


def decode_step(
    p: Params,
    state: Dict[str, Tensor],
    token: Tensor,  # (B, 1)
    pos: int,  # unused (stateful arch); kept for API parity
    cfg: ModelConfig,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    cdt = cfg.cdt
    tp = L.tensor_parallel()
    x = L.embed(p["embed"], token[:, 0], cdt)
    x = L.layernorm(p["ln_in"], x)
    sh_tm, sh_cm, wkv = [], [], []
    for i in range(cfg.n_layers):
        lp = layer_params(p["layers"], i)
        h1 = L.layernorm(lp["ln1"], x)
        shift = L.whole_state(tp, state["shift_tm"][i], "shift_tm")
        a, wkv_new = _tm_step(lp["tm"], h1, shift.to(cdt), state["wkv"][i],
                              cfg)
        x = x + a.to(x.dtype)
        h2 = L.layernorm(lp["ln2"], x)
        shift = L.whole_state(tp, state["shift_cm"][i], "shift_cm")
        x = x + _channel_mix_tokens(lp["cm"], h2, shift.to(cdt),
                                    cdt).to(x.dtype)
        sh_tm.append(L.state_block(tp, h1, "shift_tm"))
        sh_cm.append(L.state_block(tp, h2, "shift_cm"))
        wkv.append(wkv_new)
    x = L.layernorm(p["final_norm"], x)
    logits = L.unembed(p["embed"], x, cdt)[:, None, :]
    return logits, {
        "shift_tm": torch.stack(sh_tm).float(),
        "shift_cm": torch.stack(sh_cm).float(),
        "wkv": torch.stack(wkv).float(),
    }
