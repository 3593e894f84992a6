"""Zamba2 hybrid: Mamba-2 (SSD) backbone + shared attention blocks.

Port of ``repro/models/mamba2.py``.  A stack of Mamba-2 layers; every
``cfg.shared_attn_period`` layers, one of ``cfg.n_shared_blocks``
weight-shared transformer blocks runs on the concatenation ``[x ; x_emb0]``
(current residual + original embedding, width 2*D), and a per-invocation
linear projects its output back to D.  The shared blocks alternate
(ABAB...), as in the released 2.7B model.

Mamba-2 block (per layer): in_proj -> (z, x, B, C, dt); causal depthwise
conv over (x, B, C); SSD scan (``kernels/mamba2_ssd``: the chunked form
or the CUDA kernel for prefill, the O(1) recurrence for decode); gated
RMSNorm; out projection.

Serving state: per layer (conv_state (B, W-1, conv_ch), ssm (B, H, N, P))
plus a KV cache per shared-block *invocation*.  When the context exceeds
``cfg.attn_window`` the shared attention becomes sliding-window (slot =
pos % window, with each slot's absolute position in ``slot_pos``).

The layer stack keeps the reference's layout (a leading ``L`` axis) and
Python loops take the place of ``lax.scan``.  ``prefill`` takes the
scan's backend (the reference's ``"chunked"`` by default, ``"pallas"``
for the CUDA kernel) and each shared block's cache from the K/V its
attention already computed, where the reference computes them again in
``attention_prefill_cache``.  Its shared attention runs on
``cfg.attn_backend``, as ``forward``'s does in both packages (the
reference's ``prefill`` leaves it on the masked default), so
``"pallas"`` puts a prefill within the window on the flash kernel.
``forward`` and ``loss_fn`` (training) run the ``"chunked"`` SSD;
``cfg.remat`` recomputes each Mamba layer in the backward pass (the
shared blocks are kept, as in the reference).

Tensor parallelism (``serve/efm.py``'s serving steps on a mesh; the plan
is ``layers.tensor_parallel()``): each rank runs the SSD on its block of
the heads where the serve specs split ``ssm`` over them (all heads
otherwise).  ``in_proj``'s column block does not line up with those heads
(its output is [z, x, B, C, dt]), so a split ``in_proj``'s output is
all-gathered; the rank takes its heads' z, x and dt and the whole B and C,
and convolves its x channels with B and C (the conv's weights are whole:
sliced).  The gated RMSNorm over ``d_inner`` takes its sum of squares by
a float32 all-reduce where the heads are split, and ``out_proj`` (row
blocks) all-reduces its partial products.  The conv state is split over
its channels, which do not line up with the rank's x channels either: it
is cut from the whole pre-conv (x, B, C) at prefill, and all-gathered
before each decode step's window.  The shared blocks run
``layers.attention_full`` / ``layers.mlp`` on their blocks, ``out`` as a
row-parallel projection, and their K/V cache holds the rank's kv heads
where they divide the model axis.  Where they do not, ``wk``/``wv`` are
whole and the cache is split over its window's slots: the prefill lays
out the rank's block of slots from every position's K/V, and a decode
step writes the new K/V on the rank that holds its slot, attends every
query head over the rank's slots and combines the partial softmaxes over
the axis (``layers._softmax_over_model``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_ssd.ops import mamba2_ssd
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_params

Params = Dict[str, Any]

HEAD_P = 64  # Mamba-2 head width (P); heads = d_inner // HEAD_P


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // HEAD_P
    conv_ch = d_inner + 2 * cfg.ssm_state
    return d_inner, n_heads, conv_ch, cfg.ssm_state


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------


def init_mamba_block(gen, cfg: ModelConfig, lead=(), device=None) -> Params:
    d = cfg.d_model
    d_inner, h, conv_ch, n = _dims(cfg)
    pdt = cfg.pdt
    f32 = torch.float32
    # in_proj emits [z, x, B, C, dt]
    d_proj = 2 * d_inner + 2 * n + h
    return {
        "ln": L.init_rmsnorm(d, pdt, lead, device),
        "in_proj": L.init_linear(gen, d, d_proj, dtype=pdt, lead=lead,
                                 device=device),
        "conv_w": L._normal(gen, (*lead, cfg.ssm_conv, conv_ch),
                            1.0 / math.sqrt(cfg.ssm_conv), pdt, device),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=pdt, device=device),
        "a_log": torch.zeros((*lead, h), dtype=f32, device=device),  # A = -1
        "dt_bias": torch.log(torch.expm1(
            torch.full((*lead, h), 0.01, dtype=f32, device=device)
        )),  # softplus^-1(0.01)
        "d_skip": torch.ones((*lead, h), dtype=pdt, device=device),
        "gn": L.init_rmsnorm(d_inner, pdt, lead, device),
        "out_proj": L.init_linear(gen, d_inner, d, dtype=pdt, lead=lead,
                                  device=device),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: Tensor):
    d_inner, h, _, n = _dims(cfg)
    z = zxbcdt[..., :d_inner]
    xin = zxbcdt[..., d_inner:2 * d_inner]
    bm = zxbcdt[..., 2 * d_inner:2 * d_inner + n]
    cm = zxbcdt[..., 2 * d_inner + n:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xin, bm, cm, dt


def _softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_block(
    p: Params,
    x: Tensor,
    cfg: ModelConfig,
    *,
    backend: str = "chunked",
    return_state: bool = False,
):
    """Full-sequence Mamba-2 mixer. x: (B, S, D) -> (B, S, D) [, states]."""
    b, s, d = x.shape
    d_inner, h, conv_ch, n = _dims(cfg)
    cdt = cfg.cdt
    f32 = torch.float32
    tp = L.tensor_parallel()
    xn = L.rmsnorm(p["ln"], x)
    z, xin, bm, cm, dt = _split_proj(cfg, L.whole_cols(
        tp, L.linear(p["in_proj"], xn, cdt), "in_proj"))

    # causal depthwise conv over (x, B, C): the rank's heads' x channels
    xbc = torch.cat([xin, bm, cm], dim=-1)  # (B,S,conv_ch)
    hs, xs = _heads_of(tp, cfg)
    d_loc, h_loc = xs.stop - xs.start, hs.stop - hs.start
    xbc_r, conv_w, conv_b = _conv_channels(p, xbc, xs, d_inner)
    pad = F.pad(xbc_r, (0, 0, cfg.ssm_conv - 1, 0))
    conv = 0
    for i in range(cfg.ssm_conv):
        conv = conv + pad[:, i:i + s] * conv_w[i].to(cdt)
    conv = F.silu(conv + conv_b.to(cdt))
    xin = conv[..., :d_loc]
    bm = conv[..., d_loc:d_loc + n].to(f32)
    cm = conv[..., d_loc + n:].to(f32)

    dt = _softplus(dt[..., hs].to(f32) + p["dt_bias"][hs])  # (B,S,H) > 0
    a = -torch.exp(p["a_log"][hs])  # (H,) < 0
    a_log_t = (dt * a).transpose(1, 2)  # (B,H,S)
    xh = xin.to(f32).reshape(b, s, h_loc, HEAD_P)
    xh = (xh * dt[..., None]).transpose(1, 2)  # (B,H,S,P)

    y, s_fin = mamba2_ssd(xh, a_log_t, bm, cm, backend=backend,
                          chunk=cfg.scan_chunk)
    y = y + xh * p["d_skip"][hs].to(f32)[None, :, None, None]
    y = y.transpose(1, 2).reshape(b, s, d_loc).to(cdt)
    out = _gated_out(tp, p, y, z[..., xs], d_inner, cdt)
    if return_state:
        conv_state = L.state_block(
            tp, xbc[:, s - (cfg.ssm_conv - 1):].to(f32), "conv")
        return out, conv_state, s_fin
    return out


def _heads_of(tp, cfg: ModelConfig) -> Tuple[slice, slice]:
    """The SSD heads this rank runs and their channels of ``d_inner``: its
    block where the plan splits ``ssm`` over the heads, all of them
    otherwise."""
    _, h, _, _ = _dims(cfg)
    h0, h1 = (0, h) if tp is None or "ssm" not in tp.state else \
        L.model_block(h, tp)
    return slice(h0, h1), slice(h0 * HEAD_P, h1 * HEAD_P)


def _conv_channels(p: Params, xbc: Tensor, xs: slice, d_inner: int):
    """``(x[xs], B, C)`` of ``xbc`` (..., conv_ch) and the conv's weights
    and bias for those channels (all of them when ``xs`` is all of x)."""
    if xs.stop - xs.start == d_inner:
        return xbc, p["conv_w"], p["conv_b"]
    return tuple(torch.cat([t[..., xs], t[..., d_inner:]], dim=-1)
                 for t in (xbc, p["conv_w"], p["conv_b"]))


def _gated_out(tp, p: Params, y: Tensor, z: Tensor, d_inner: int,
               cdt) -> Tensor:
    """``out_proj(gn(y * silu(z)))`` on the rank's channels of ``d_inner``
    (``y``, ``z``): the norm's sum of squares all-reduced where they are a
    block of it, ``out_proj``'s rows cut to them and its partial products
    all-reduced where it is split."""
    y = y * F.silu(z)
    if y.shape[-1] < d_inner:  # the rank's heads
        y = L.rmsnorm_split(p["gn"], y, tp)
    else:
        y = L.rmsnorm(p["gn"], y)
        if L._split(tp, "out_proj"):
            y = L.block_of(tp, y)
    return L.linear_row(p["out_proj"], y, cdt, "out_proj")


# ---------------------------------------------------------------------------
# Shared attention block (runs on [x ; x_emb0], width 2*D)
# ---------------------------------------------------------------------------


def init_shared_block(gen, cfg: ModelConfig, lead=(), device=None) -> Params:
    d2 = 2 * cfg.d_model
    head_dim = d2 // cfg.n_heads
    kw = dict(dtype=cfg.pdt, lead=lead, device=device)
    return {
        "ln1": L.init_rmsnorm(d2, cfg.pdt, lead, device),
        "attn": L.init_attention(gen, d2, cfg.n_heads, cfg.n_kv_heads,
                                 head_dim, **kw),
        "ln2": L.init_rmsnorm(d2, cfg.pdt, lead, device),
        "mlp": L.init_mlp(gen, d2, cfg.d_ff, **kw),
        "out": L.init_linear(gen, d2, cfg.d_model, **kw),
    }


def shared_block(
    p: Params,
    x: Tensor,
    emb0: Tensor,
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
) -> Tensor:
    """Shared transformer block on concat input; returns a D-wide delta."""
    h = torch.cat([x, emb0], dim=-1)
    h = h + L.attention_full(
        p["attn"],
        L.rmsnorm(p["ln1"], h),
        cfg.n_heads,
        cfg.n_kv_heads,
        rope_base=cfg.rope_base,
        backend=cfg.attn_backend,
        compute_dtype=cfg.cdt,
        window=window,
    ).to(h.dtype)
    h = h + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], h), cfg.cdt).to(h.dtype)
    return _shared_out(p, h, cfg.cdt)


def _shared_out(p: Params, h: Tensor, cdt) -> Tensor:
    """The shared block's ``out`` projection back to D: row-parallel, on
    the rank's block of ``h``'s 2D channels, where it is split."""
    tp = L.tensor_parallel()
    if L._split(tp, "out"):
        h = L.block_of(tp, h)
    return L.linear_row(p["out"], h, cdt, "out")


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def n_shared_invocations(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_period


def init(gen: Optional[torch.Generator], cfg: ModelConfig, device) -> Params:
    """Random parameters at the reference's scales, drawn on ``device``
    from ``gen`` (``None`` only for the shapes, on the meta device)."""
    return {
        "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model, cfg.pdt,
                                  device),
        "layers": init_mamba_block(gen, cfg, (cfg.n_layers,), device),
        "shared": init_shared_block(gen, cfg, (cfg.n_shared_blocks,),
                                    device),
        "final_norm": L.init_rmsnorm(cfg.d_model, cfg.pdt, device=device),
    }


def _serve_window(cfg: ModelConfig, max_seq: int) -> Optional[int]:
    if cfg.attn_window is not None and max_seq > cfg.attn_window:
        return cfg.attn_window
    return None


def _groups(cfg: ModelConfig):
    """``(invocation, its Mamba layers, its shared block's index)``: the
    layers of a group, then one shared block, alternating ABAB..."""
    period = cfg.shared_attn_period
    for gi in range(n_shared_invocations(cfg)):
        yield gi, range(gi * period, (gi + 1) * period), gi % cfg.n_shared_blocks


def forward(p: Params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    """(B, S) int -> (B, S, V) fp32 logits."""
    x = L.embed(p["embed"], tokens, cfg.cdt)
    emb0 = x

    def mamba_body(x, lp):
        return x + mamba_block(lp, x, cfg).to(x.dtype)

    if cfg.remat:
        mamba_body = L.remat_wrap(cfg, mamba_body)
    for _, layers, bi in _groups(cfg):
        for i in layers:
            x = mamba_body(x, layer_params(p["layers"], i))
        sp = layer_params(p["shared"], bi)
        x = x + shared_block(sp, x, emb0, cfg).to(x.dtype)
    x = L.rmsnorm(p["final_norm"], x)
    return L.unembed(p["embed"], x, cfg.cdt)


def loss_fn(p: Params, batch: Dict[str, Tensor], cfg: ModelConfig) -> Tensor:
    logits = forward(p, batch["tokens"], cfg)
    return L.next_token_loss(logits, batch["tokens"], batch.get("mask"))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device, tp=None) -> Dict[str, Tensor]:
    """The zero serve cache; with a tensor-parallel plan ``tp``, this
    rank's block of it (the leaves ``tp.state`` splits: ``conv`` over its
    channels, ``ssm`` over heads, ``k``/``v`` over kv heads or slots)."""
    d_inner, h, conv_ch, n = _dims(cfg)
    n_inv = n_shared_invocations(cfg)
    w = _serve_window(cfg, max_seq) or max_seq
    head_dim = 2 * cfg.d_model // cfg.n_heads
    f32 = torch.float32

    def local(name, size):
        return size // tp.size if tp is not None and name in tp.state \
            else size

    # K/V over kv heads, or over the window's slots (``tp.cache_seq``)
    over_slots = tp is not None and tp.cache_seq
    kv_shape = (n_inv, batch, cfg.n_kv_heads if over_slots else
                local("k", cfg.n_kv_heads), local("k", w) if over_slots
                else w, head_dim)
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                             local("conv", conv_ch)), dtype=f32,
                            device=device),
        "ssm": torch.zeros((cfg.n_layers, batch, local("ssm", h), n, HEAD_P),
                           dtype=f32, device=device),
        "k": torch.zeros(kv_shape, dtype=cfg.cachedt, device=device),
        "v": torch.zeros(kv_shape, dtype=cfg.cachedt, device=device),
        "slot_pos": torch.full((n_inv, batch, w), -1, dtype=torch.int32,
                               device=device),
    }


def prefill(
    p: Params, tokens: Tensor, cfg: ModelConfig, *,
    scan_backend: str = "chunked",
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Ingest a prefix; returns (last-token logits, serve cache).

    The shared-attention KV caches keep the last ``window`` positions in
    modular (slot = pos % window) layout, so decode continues from
    ``pos = S``.  ``scan_backend`` is the ``mamba2_ssd`` backend of every
    Mamba layer: ``"chunked"`` (the reference's), ``"ref"`` or
    ``"pallas"``.
    """
    b, s = tokens.shape
    tp = L.tensor_parallel()
    x = L.embed(p["embed"], tokens, cfg.cdt)
    emb0 = x
    cache = init_cache(cfg, b, s, x.device, tp)
    w = _serve_window(cfg, s) or s
    # positions kept in the windowed cache and their modular slots
    kept = torch.arange(max(0, s - w), s, device=x.device)
    slots = torch.remainder(kept, w)
    win = None if w >= s else cfg.attn_window
    over_slots = tp is not None and tp.cache_seq
    if over_slots:  # the position each of the rank's slots keeps
        lo, hi = L.model_block(w, tp)
        held = (s - w) + torch.remainder(
            torch.arange(lo, hi, device=x.device) - s, w)
    for gi, layers, bi in _groups(cfg):
        for i in layers:
            y, cache["conv"][i], cache["ssm"][i] = mamba_block(
                layer_params(p["layers"], i), x, cfg, backend=scan_backend,
                return_state=True)
            x = x + y.to(x.dtype)
        sp = layer_params(p["shared"], bi)
        h = torch.cat([x, emb0], dim=-1)
        a, kv = L.attention_full(
            sp["attn"], L.rmsnorm(sp["ln1"], h), cfg.n_heads, cfg.n_kv_heads,
            rope_base=cfg.rope_base, backend=cfg.attn_backend,
            compute_dtype=cfg.cdt, cache_dtype=cfg.cachedt, window=win,
            cache_block=False)
        hh = h + a.to(h.dtype)
        hh = hh + L.mlp(sp["mlp"], L.rmsnorm(sp["ln2"], hh),
                        cfg.cdt).to(hh.dtype)
        x = x + _shared_out(sp, hh, cfg.cdt).to(x.dtype)
        # scatter the kept suffix into modular slots
        if over_slots:
            cache["k"][gi] = kv["k"][:, :, held]
            cache["v"][gi] = kv["v"][:, :, held]
        else:
            cache["k"][gi][:, :, slots] = kv["k"][:, :, kept]
            cache["v"][gi][:, :, slots] = kv["v"][:, :, kept]
        cache["slot_pos"][gi][:, slots] = kept.to(torch.int32)
    x = L.rmsnorm(p["final_norm"], x[:, -1:])
    return L.unembed(p["embed"], x, cfg.cdt), cache


def _mamba_step(
    p: Params,
    x: Tensor,  # (B, D)
    conv_state: Tensor,  # (B, W-1, conv_ch)
    ssm: Tensor,  # (B, H, N, P)
    cfg: ModelConfig,
) -> Tuple[Tensor, Tensor, Tensor]:
    b, d = x.shape
    d_inner, h, conv_ch, n = _dims(cfg)
    cdt = cfg.cdt
    f32 = torch.float32
    tp = L.tensor_parallel()
    xn = L.rmsnorm(p["ln"], x)
    z, xin, bm, cm, dt = _split_proj(cfg, L.whole_cols(
        tp, L.linear(p["in_proj"], xn, cdt), "in_proj"))
    xbc = torch.cat([xin, bm, cm], dim=-1)  # (B, conv_ch)
    conv_state = L.whole_state(tp, conv_state, "conv")
    win = torch.cat([conv_state.to(cdt), xbc[:, None]], dim=1)  # (B, W, ch)
    hs, xs = _heads_of(tp, cfg)
    d_loc, h_loc = xs.stop - xs.start, hs.stop - hs.start
    win_r, conv_w, conv_b = _conv_channels(p, win, xs, d_inner)
    conv = torch.einsum("bwc,wc->bc", win_r, conv_w.to(cdt)) + \
        conv_b.to(cdt)
    conv = F.silu(conv)
    new_conv_state = L.state_block(tp, win[:, 1:].to(f32), "conv")

    xin = conv[..., :d_loc].to(f32)
    bm = conv[..., d_loc:d_loc + n].to(f32)
    cm = conv[..., d_loc + n:].to(f32)
    dt = _softplus(dt[..., hs].to(f32) + p["dt_bias"][hs])  # (B, H)
    a = -torch.exp(p["a_log"][hs])
    decay = torch.exp(dt * a)  # (B, H)
    xh = xin.reshape(b, h_loc, HEAD_P) * dt[..., None]
    ssm_new = (decay[..., None, None] * ssm
               + bm[:, None, :, None] * xh[:, :, None, :])  # (B,H,N,P)
    y = torch.einsum("bn,bhnp->bhp", cm, ssm_new) + xh * p["d_skip"][
        hs].to(f32)[None, :, None]
    y = y.reshape(b, d_loc).to(cdt)
    return (_gated_out(tp, p, y, z[..., xs], d_inner, cdt), new_conv_state,
            ssm_new)


def _shared_decode(
    p: Params,
    x: Tensor,  # (B, 1, D)
    emb0: Tensor,  # (B, 1, D)
    k_c: Tensor,  # (B, Hkv, W, Dh), written in place
    v_c: Tensor,
    slot_pos: Tensor,  # (B, W), written in place
    pos: int,
    cfg: ModelConfig,
) -> Tensor:
    b = x.shape[0]
    d2 = 2 * cfg.d_model
    head_dim = d2 // cfg.n_heads
    w = k_c.shape[2]
    cdt = cfg.cdt
    tp = L.tensor_parallel()
    h = torch.cat([x, emb0], dim=-1)
    hn = L.rmsnorm(p["ln1"], h)
    ap = p["attn"]
    # Under tensor parallelism: the rank's query heads (all of them, and
    # its columns of wo's rows, where they split mid-head) and its kv heads.
    over_slots = tp is not None and tp.cache_seq  # the rank's slots
    q, h0, cols = L._query_heads(tp, L.linear(ap["wq"], hn, cdt),
                                 cfg.n_heads, every_head=over_slots)
    k_new = L.linear(ap["wk"], hn, cdt)
    v_new = L.linear(ap["wv"], hn, cdt)
    k_new = L._split_heads(k_new, k_new.shape[-1] // head_dim)
    v_new = L._split_heads(v_new, v_new.shape[-1] // head_dim)
    # A fill on the device, not a copy from the host (see attention_decode).
    cos, sin = L.rope_cos_sin(torch.full((1,), pos, device=x.device),
                              head_dim, cfg.rope_base)
    q = L.apply_rope(q, cos, sin)
    k_new = L.apply_rope(k_new, cos, sin)

    lo = tp.rank * w if over_slots else 0  # the rank's first slot
    slot = pos % (w * tp.size if over_slots else w)
    if lo <= slot < lo + w:  # the rank holding the slot writes it
        k_c[:, :, slot - lo:slot - lo + 1] = k_new.to(k_c.dtype)
        v_c[:, :, slot - lo:slot - lo + 1] = v_new.to(v_c.dtype)
    slot_pos[:, slot] = pos
    kc, vc = L._kv_heads(tp, k_c, v_c, h0, q.shape[1], cfg.n_heads,
                         cfg.n_kv_heads)
    group = q.shape[1] // kc.shape[1]
    kr = L._repeat_kv(kc.to(cdt), group)
    vr = L._repeat_kv(vc.to(cdt), group)
    logits = torch.matmul(q, kr.transpose(-1, -2)).float()
    logits = logits / math.sqrt(head_dim)
    held = slot_pos[:, lo:lo + w]
    valid = (held >= 0) & (held <= pos)
    logits = logits.masked_fill(~valid[:, None, None, :], L._NEG_INF)
    if over_slots:
        o = L._softmax_over_model(tp, logits, vr).to(cdt)
    else:
        probs = torch.softmax(logits, dim=-1).to(cdt)
        o = torch.matmul(probs, vr)
    o = L._merge_heads(o)
    h = h + L.linear_row(ap["wo"], o if cols is None else o[..., cols], cdt,
                         "wo").to(h.dtype)
    h = h + L.mlp(p["mlp"], L.rmsnorm(p["ln2"], h), cdt).to(h.dtype)
    return _shared_out(p, h, cdt)


def decode_step(
    p: Params,
    cache: Dict[str, Tensor],
    token: Tensor,  # (B, 1)
    pos: int,
    cfg: ModelConfig,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One serving step: next-token logits + the cache, updated in place
    (the reference's serving step donates it)."""
    pos = int(pos)
    x = L.embed(p["embed"], token, cfg.cdt)  # (B,1,D)
    emb0 = x
    for gi, layers, bi in _groups(cfg):
        for i in layers:
            dx, cache["conv"][i], cache["ssm"][i] = _mamba_step(
                layer_params(p["layers"], i), x[:, 0], cache["conv"][i],
                cache["ssm"][i], cfg)
            x = x + dx[:, None].to(x.dtype)
        dx = _shared_decode(layer_params(p["shared"], bi), x, emb0,
                            cache["k"][gi], cache["v"][gi],
                            cache["slot_pos"][gi], pos, cfg)
        x = x + dx.to(x.dtype)
    x = L.rmsnorm(p["final_norm"], x)
    return L.unembed(p["embed"], x, cfg.cdt), cache
