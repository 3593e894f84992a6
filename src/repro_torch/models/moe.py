"""Mixture-of-Experts FFN (DeepSeek V2-Lite / V3): sort-based dispatch.

Port of ``repro/models/moe.py``.  A static-shape sort-and-capacity
dispatch, as in the reference:

  1. router top-k -> (T*K) flat assignments;
  2. a stable argsort by expert id groups the assignments per expert;
  3. rank within the expert from the counts; assignments past the
     per-expert capacity C (:func:`moe_capacity`) are dropped (the token
     keeps its other experts);
  4. one gather builds the (E, C, D) expert inputs, three batched
     products against the stacked per-expert weights (E, D, F) run all
     experts at once (``torch.bmm``: the reference runs them as einsums,
     outside any Pallas kernel), one scatter-add applies the gates back
     to (T, D).

DeepSeek specifics: ``moe_shared`` always-on shared experts (a dense
SwiGLU of width ``shared * moe_d_ff``) are added to the routed output;
the gates are the softmax over the selected top-k renormalised (V2
convention); a Switch-style load-balance term is returned beside the
output.

Left out: the expert-parallel dispatch (``moe_ffn_ep``,
``_quant_all_to_all``, ``_shard_map``), which needs a device mesh
(``ROADMAP.md`` Queue 1 item 6).  Without a mesh the reference's
``moe_ffn_ep`` returns ``None`` and ``moe_ffn`` takes the sort path; the
port has no mesh, so ``moe_impl="ep"`` takes it too.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]


def init_moe(gen, cfg: ModelConfig, lead=(), device=None) -> Params:
    e, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
    scale = 1.0 / math.sqrt(d)
    p: Params = {
        # the router stays float32 (numerics)
        "router": L._normal(gen, (*lead, d, e), scale, torch.float32, device),
        "gate_w": L._normal(gen, (*lead, e, d, f), scale, cfg.pdt, device),
        "up_w": L._normal(gen, (*lead, e, d, f), scale, cfg.pdt, device),
        "down_w": L._normal(gen, (*lead, e, f, d), 1.0 / math.sqrt(f),
                            cfg.pdt, device),
    }
    if cfg.moe_shared:
        p["shared"] = L.init_mlp(gen, d, cfg.moe_shared * f, kind="swiglu",
                                 dtype=cfg.pdt, lead=lead, device=device)
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: ``ceil(T K / E * cf)`` rounded up to a multiple
    of 8, at least 8."""
    c = int(math.ceil(n_tokens * cfg.moe_top_k / cfg.moe_experts
                      * cfg.moe_capacity_factor))
    return max(8, -(-c // 8) * 8)


def _route(p: Params, x2: Tensor, cfg: ModelConfig):
    """float32 router + DeepSeek's renormalised top-k gates + the
    load-balance term.  Returns ``(gates (T,K), eids (T,K), aux)``.

    ``jax.lax.top_k`` puts the lower index first among equal
    probabilities: a stable descending sort does the same
    (``torch.topk`` does not promise an order among ties)."""
    e, k = cfg.moe_experts, cfg.moe_top_k
    logits = torch.matmul(x2.float(), p["router"])  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, eids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eids = gates[:, :k], eids[:, :k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    hit = torch.zeros_like(probs).scatter_(1, eids, 1.0)  # (T, E) 0/1
    frac_tokens = hit.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = e * torch.sum(frac_tokens * mean_prob)
    return gates, eids, aux


def _dispatch(x2: Tensor, gates: Tensor, eids: Tensor, e: int, c: int):
    """Sort-based capacity dispatch. Returns ``(xg (E,C,D), (tok_by_slot,
    gate_by_slot, valid))``, each of the three ``(E*C,)`` in slot order.

    Kept assignments write their slot of a buffer of ``E*C + 1`` whose
    last row is the sentinel the dropped ones write, then cut off.  The
    counts per expert come from a scatter-add (``torch.bincount`` would
    read its maximum back to the host)."""
    t, d = x2.shape
    k = eids.shape[1]
    dev = x2.device
    eid_flat = eids.reshape(-1)  # (T*K,)
    tok_flat = torch.arange(t, dtype=torch.int32, device=dev
                            ).repeat_interleave(k)
    gate_flat = gates.reshape(-1)

    order = torch.argsort(eid_flat, stable=True)
    s_eid = eid_flat[order]
    s_tok = tok_flat[order]
    s_gate = gate_flat[order]

    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, eid_flat, torch.ones_like(eid_flat))
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(t * k, device=dev) - starts[s_eid]
    keep = ranks < c
    slot = torch.where(keep, s_eid * c + ranks, e * c)  # sentinel = E*C

    tok_by_slot = torch.zeros(e * c + 1, dtype=torch.int32, device=dev)
    tok_by_slot[slot] = s_tok
    gate_by_slot = torch.zeros(e * c + 1, dtype=torch.float32, device=dev)
    gate_by_slot[slot] = torch.where(keep, s_gate, 0.0)
    valid = torch.zeros(e * c + 1, dtype=torch.bool, device=dev)
    valid[slot] = keep
    tok_by_slot, gate_by_slot, valid = (
        tok_by_slot[:e * c], gate_by_slot[:e * c], valid[:e * c])
    xg = x2[tok_by_slot.long()].reshape(e, c, d) * valid.reshape(
        e, c, 1).to(x2.dtype)
    return xg, (tok_by_slot, gate_by_slot, valid)


def _combine(y: Tensor, info, t: int, cdt) -> Tensor:
    """Gate-weighted scatter-add of the expert outputs back to (T, D), in
    ``cdt`` and in slot order."""
    tok_by_slot, gate_by_slot, valid = info
    e, c, d = y.shape
    y_flat = y.reshape(e * c, d) * gate_by_slot[:, None].to(cdt)
    y_flat = torch.where(valid[:, None], y_flat, 0.0)
    return torch.zeros((t, d), dtype=cdt, device=y.device).index_add_(
        0, tok_by_slot.long(), y_flat)


def _expert_ffn(p: Params, xg: Tensor, cdt) -> Tensor:
    """Batched per-expert SwiGLU: (E, C, D) -> (E, C, D)."""
    xg = xg.to(cdt)
    h = F.silu(torch.bmm(xg, p["gate_w"].to(cdt))) * torch.bmm(
        xg, p["up_w"].to(cdt))
    return torch.bmm(h, p["down_w"].to(cdt))


def moe_ffn(p: Params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Routed MoE over (B, S, D).  Both ``moe_impl``s take the sort path
    (``"ep"`` needs a mesh: see the module docstring)."""
    return moe_ffn_sort(p, x, cfg)


def moe_ffn_sort(p: Params, x: Tensor,
                 cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Single-program dispatch: one global sort. Returns ``(out, aux)``."""
    b, s, d = x.shape
    t = b * s
    e = cfg.moe_experts
    c = moe_capacity(cfg, t)
    x2 = x.reshape(t, d)
    gates, eids, aux = _route(p, x2, cfg)
    xg, info = _dispatch(x2, gates, eids, e, c)

    cdt = cfg.cdt
    y = _expert_ffn(p, xg, cdt)
    out = _combine(y, info, t, cdt)
    if cfg.moe_shared:
        out = out + L.mlp(p["shared"], x2, cdt)
    return out.reshape(b, s, d).to(x.dtype), aux
