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
     outside any Pallas kernel), and the gated outputs go back to (T, D).

The way back (:func:`_combine`) is deterministic: each token folds its
own kept contributions in ascending slot order from zeros in float32 and
rounds to the compute dtype once.  That is what ``index_add_`` computes
on the CPU (it adds in index order, a bf16 tensor in float32), so the
result is bitwise the scatter-add's there, and two runs on the card agree
bitwise (an ``index_add_`` on CUDA adds with atomics, in no fixed
order).

DeepSeek specifics: ``moe_shared`` always-on shared experts (a dense
SwiGLU of width ``shared * moe_d_ff``) are added to the routed output;
the gates are the softmax over the selected top-k renormalised (V2
convention); a Switch-style load-balance term is returned beside the
output.

Expert parallelism (:func:`moe_ffn_ep`, ``moe_impl="ep"``): under an
ambient mesh (``launch.mesh.use_mesh``) each rank routes and dispatches
its own tokens, and the (E, C_loc, D) buffers cross the EP group by
all-to-all (int8 with per-row scales both ways when ``moe_a2a_quant``:
:func:`_quant_all_to_all`), so a rank runs only its own experts.  With
no ambient mesh, a one-rank EP group, or E or S not divisible by it,
``moe_ffn`` takes the sort path, as the reference's does.
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
    # Each token's slots, ascending (the sentinel E*C, a dropped
    # assignment, sorts last): the order _combine adds them in.
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    slots_by_token = torch.sort(slot_of.reshape(t, k), dim=1).values
    return xg, (tok_by_slot, gate_by_slot, valid, slots_by_token)


def _combine(y: Tensor, info, t: int, cdt) -> Tensor:
    """Gate-weighted sum of the expert outputs back to (T, D), in ``cdt``.

    Token ``t`` adds its kept slots' gated rows in ascending slot order to
    zeros in float32, rounded to ``cdt`` once: ``index_add_``'s result on
    the CPU, with no atomics (see the module docstring)."""
    _, gate_by_slot, _, slots_by_token = info
    e, c, d = y.shape
    # Only kept slots are read; row E*C is the dropped assignments' zero
    # row.
    y_flat = y.reshape(e * c, d) * gate_by_slot[:, None].to(cdt)
    y_flat = torch.cat([y_flat, y_flat.new_zeros((1, d))])
    rows = y_flat[slots_by_token]  # (T, K, D), one gather
    out = torch.zeros((t, d), dtype=torch.float32, device=y.device)
    for j in range(rows.shape[1]):
        out.add_(rows[:, j])  # in float32: bf16 rows convert exactly
    return out.to(cdt)


def _expert_ffn(p: Params, xg: Tensor, cdt) -> Tensor:
    """Batched per-expert SwiGLU: (E, C, D) -> (E, C, D)."""
    xg = xg.to(cdt)
    h = F.silu(torch.bmm(xg, p["gate_w"].to(cdt))) * torch.bmm(
        xg, p["up_w"].to(cdt))
    return torch.bmm(h, p["down_w"].to(cdt))


def moe_ffn(p: Params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Routed MoE over (B, S, D). Dispatches on ``cfg.moe_impl``.

    Expert stacks may come as this rank's EP shard (fewer than E rows: the
    sharded train step passes them so); if the EP path does not apply,
    they are gathered over the EP group for the sort path."""
    if cfg.moe_impl == "ep":
        out = moe_ffn_ep(p, x, cfg)
        if out is not None:
            return out
    if p["gate_w"].shape[0] != cfg.moe_experts:
        p = _gather_experts(p, cfg)
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


# ---------------------------------------------------------------------------
# Expert-parallel dispatch (all-to-all over the EP group)
# ---------------------------------------------------------------------------


def _quantize_rows(v: Tensor):
    """Symmetric int8 per row (last dim): ``(q8, scale float32)``; the
    scale ``max|v| / 127 + 1e-12`` in ``v``'s dtype, as the reference's."""
    scale = torch.amax(torch.abs(v), dim=-1, keepdim=True) / torch.tensor(
        127.0, dtype=v.dtype, device=v.device) + 1e-12
    q8 = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q8, scale.to(torch.float32)


def _quant_exchange(v: Tensor, group, split_axis: int,
                    concat_axis: int) -> Tensor:
    from repro_torch.launch.collectives import tiled_all_to_all

    q8, s = _quantize_rows(v)
    return (tiled_all_to_all(q8, group, split_axis, concat_axis).to(v.dtype)
            * tiled_all_to_all(s, group, split_axis, concat_axis)).to(v.dtype)


class _QuantAllToAll(torch.autograd.Function):
    """int8 all-to-all with float32 per-row scales both ways: the
    cotangent is quantised and exchanged back the same way (the
    reference's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, v, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return _quant_exchange(v, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _quant_exchange(g, group, concat_axis, split_axis), None, \
            None, None


def _quant_all_to_all(x: Tensor, group, split_axis: int,
                      concat_axis: int) -> Tensor:
    """int8-quantised all-to-all over ``group`` (DeepSeek-V3's fp8
    dispatch, in int8): per-row scales ride along as float32."""
    return _QuantAllToAll.apply(x, group, split_axis, concat_axis)


def _ep_names(cfg: ModelConfig) -> Tuple[str, ...]:
    return ("data", "model") if cfg.ep_axes == "dp_model" else ("model",)


def _gather_experts(p: Params, cfg: ModelConfig) -> Params:
    """``p`` with its expert stacks gathered whole over the ambient EP
    group (they came as this rank's shard)."""
    from repro_torch.launch import collectives as C
    from repro_torch.launch import mesh as M

    amb = M.current()
    if amb is None:
        raise ValueError(
            f"expert stacks of {p['gate_w'].shape[0]} rows (of "
            f"{cfg.moe_experts}) need the ambient mesh they were sharded on")
    group = M.axis_group(amb.mesh, _ep_names(cfg))
    return {**p, **{k: C.all_gather(p[k], group, 0)
                    for k in ("gate_w", "up_w", "down_w")}}


def _token_layout(ax, names, b: int, cfg: ModelConfig, ep_names):
    """The reference's two token layouts inside the EP region: ``(batch
    axes, seq axes)``, or ``None`` when no layout covers the EP axes."""
    all_axes = [n for n in names if n in ("pod", "data", "model")]
    batch_axes = seq_axes = None
    if cfg.shard_strategy in ("dp", "fsdp"):
        # layout 1: batch sharded over a prefix covering every EP axis
        for start in range(len(all_axes)):
            use = tuple(all_axes[start:])
            if b % math.prod(ax[n] for n in use) == 0 and all(
                    n in use for n in ep_names):
                batch_axes = use
                break
    if batch_axes is None:
        # layout 2: batch over the non-model DP axes, seq over "model"
        dp_names = tuple(n for n in ("pod", "data") if n in ax)
        for start in range(len(dp_names) + 1):
            use = dp_names[start:]
            if b % (math.prod(ax[n] for n in use) if use else 1) == 0:
                batch_axes = tuple(use) or None
                break
        seq_axes = ("model",)
        covered = set(batch_axes or ()) | set(seq_axes)
        if not set(ep_names) <= covered:
            return None
    return tuple(batch_axes or ()), tuple(seq_axes or ()), all_axes


def moe_ffn_ep(p: Params, x: Tensor, cfg: ModelConfig):
    """EP MoE: local routing + all-to-all token exchange (DeepSeek-style).

    ``x`` is this rank's rows of the activations, split over the ambient
    mesh's ``batch_axes`` (the sharded steps split the batch so).  Inside
    the region every rank owns a disjoint token block, laid out as the
    reference's ``shard_map`` lays it: layout 1 (``"dp"``/``"fsdp"``) the
    batch over a DP prefix covering every EP axis; layout 2 the batch over
    the pure-DP axes and the sequence over ``"model"`` (each rank takes its
    slice, and the output is all-gathered back along the sequence).  Only
    the capacity-bounded (E, C_loc, D) dispatch buffers cross the EP
    group; each rank runs its E / n_ep experts, from its shard of the
    expert stacks or its block of whole ones.  ``aux`` is averaged over
    the token axes.  The reference's ``shard_map`` region (and its
    ``_shard_map`` shim) is this explicit local slice and gather.
    Returns ``None`` where the reference's does: no
    ambient mesh, an EP axis missing, ``n_ep == 1``, E or S not divisible
    by it, or no layout covering the EP axes.
    """
    from repro_torch.launch import collectives as C
    from repro_torch.launch import mesh as M

    amb = M.current()
    if amb is None:
        return None
    mesh = amb.mesh
    ax = M.mesh_shape(mesh)
    names = M.mesh_axes(mesh)
    ep_names = _ep_names(cfg)
    if any(n not in ax for n in ep_names):
        return None
    n_ep = math.prod(ax[n] for n in ep_names)
    e = cfg.moe_experts
    b_loc, s, d = x.shape
    b = b_loc * M.axes_size(mesh, amb.batch_axes)
    if n_ep == 1 or e % n_ep != 0 or s % n_ep != 0:
        return None
    layout = _token_layout(ax, names, b, cfg, ep_names)
    if layout is None:
        return None
    batch_axes, seq_axes, all_axes = layout
    if batch_axes != amb.batch_axes:
        raise ValueError(
            f"moe_ffn_ep: this rank's rows are split over {amb.batch_axes}, "
            f"but the EP region lays the batch over {batch_axes}")
    pod_extra = tuple(n for n in all_axes if n not in batch_axes
                      and n not in seq_axes and n not in ep_names)
    e_loc = e // n_ep
    cdt = cfg.cdt
    ep_group = M.axis_group(mesh, ep_names)

    if seq_axes:
        m, n_m = mesh.get_local_rank("model"), ax["model"]
        x_loc = x.narrow(1, m * (s // n_m), s // n_m)
    else:
        x_loc = x
    bl, sl, _ = x_loc.shape
    t = bl * sl
    c_loc = max(4, -(-int(t * cfg.moe_top_k / e
                          * cfg.moe_capacity_factor) // 4) * 4)
    x2 = x_loc.reshape(t, d)
    gates, eids, aux = _route({"router": p["router"]}, x2, cfg)
    xg, info = _dispatch(x2, gates, eids, e, c_loc)  # (E, C_loc, D)
    # Peer i owns expert rows [i*e_loc, (i+1)*e_loc): send it its slices,
    # receive everyone's slices for this rank's experts.
    exchange = _quant_all_to_all if cfg.moe_a2a_quant else C.all_to_all
    xr = exchange(xg, ep_group, 0, 1)  # (e_loc, n_ep*C_loc, D)
    if p["gate_w"].shape[0] == e:
        lo = M.axis_index(mesh, ep_names) * e_loc
        experts = {k: p[k].narrow(0, lo, e_loc)
                   for k in ("gate_w", "up_w", "down_w")}
    else:
        experts = p
    y = _expert_ffn(experts, xr, cdt)  # (e_loc, n_ep*C_loc, D)
    y = exchange(y, ep_group, 1, 0)  # (E, C_loc, D), as dispatched
    out = _combine(y.to(cdt), info, t, cdt)
    if cfg.moe_shared:
        out = out + L.mlp(p["shared"], x2, cdt)
    mean_axes = tuple(dict.fromkeys(batch_axes + seq_axes + pod_extra))
    if mean_axes:
        aux = C.all_reduce_mean(aux, M.axis_group(mesh, mean_axes))
    out = out.reshape(bl, sl, d).to(x.dtype)
    if seq_axes:
        out = C.all_gather(out, mesh.get_group("model"), 1)
    return out, aux
