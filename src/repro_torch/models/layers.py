"""Shared EFM building blocks: norms, RoPE, GQA attention, MLPs, embeddings.

Port of ``repro/models/layers.py``.  Conventions (as in the reference):
  * Parameters are plain nested dicts of tensors — no ``nn.Module``.
  * ``init_*`` builds params from a ``torch.Generator`` (draws in float32
    on the generator's device, then casts to ``dtype``); ``lead`` adds
    leading axes, so a layer stack is one init with ``lead=(L,)`` in
    place of the reference's vmap-init.
  * Weights are stored in ``param_dtype`` and compute runs in
    ``compute_dtype``; reductions (norms, softmax) in float32.
  * Attention layouts: activations (B, S, D_model), per-head (B, H, S, Dh).
  * Linear weights are ``(d_in, d_out)``, the reference's layout.

Training: :func:`next_token_loss` and :func:`remat_wrap`
(``torch.utils.checkpoint`` in place of ``jax.checkpoint``).

Sharded decode: :func:`ambient_mesh_axes` reads the ambient mesh
(``launch.mesh.use_mesh``), :func:`decode_seq_shard` makes the
reference's flash-decoding decision on it, and :func:`_wsc` places a
DTensor by a spec.  The model code runs on plain tensors on each rank, so
the decode-layout hints (in :func:`attention_decode` and
:func:`cross_attention_decode`, which the VLM and the encoder-decoder
share) leave them as they are.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels.flash_attention.kernel import flash_attention_pallas

Params = Dict[str, Any]
_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Initialisers / linear
# ---------------------------------------------------------------------------


def _normal(gen, shape, scale, dtype, device) -> Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def init_linear(
    gen: Optional[torch.Generator],
    d_in: int,
    d_out: int,
    *,
    bias: bool = False,
    dtype: torch.dtype = torch.float32,
    scale: Optional[float] = None,
    lead: Tuple[int, ...] = (),
    device=None,
) -> Params:
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    p: Params = {"w": _normal(gen, (*lead, d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def linear(p: Params, x: Tensor, compute_dtype=torch.float32) -> Tensor:
    y = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def init_embedding(gen, vocab: int, d_model: int, dtype=torch.float32,
                   device=None) -> Params:
    return {"table": _normal(gen, (vocab, d_model), 0.02, dtype, device)}


def embed(p: Params, tokens: Tensor, compute_dtype=torch.float32) -> Tensor:
    return p["table"].to(compute_dtype)[tokens.long()]


def unembed(p: Params, x: Tensor, compute_dtype=torch.float32) -> Tensor:
    """Tied unembedding: logits = x @ table^T (always fp32 out)."""
    return torch.matmul(
        x.to(compute_dtype), p["table"].to(compute_dtype).T
    ).float()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype=torch.float32, lead=(), device=None) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def init_layernorm(d: int, *, parametric: bool = True, dtype=torch.float32,
                   lead=(), device=None) -> Params:
    """LayerNorm params. ``parametric=False`` (OLMo) has no learnables."""
    if parametric:
        return {
            "scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device),
        }
    return {}


def layernorm(p: Params, x: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if "scale" in p:
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (rotate-half / NeoX-Llama convention)
# ---------------------------------------------------------------------------


def rope_cos_sin(
    positions: Tensor, head_dim: int, base: float = 10000.0
) -> Tuple[Tensor, Tensor]:
    """cos/sin tables for given positions. positions: (...,) int.

    Returns (..., head_dim/2) each.  The frequencies are formed in float32
    as ``1 / base ** (arange / half)``, the reference's exact form.
    """
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (base ** (exps / float(half)))
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Apply rotary embedding. x: (..., S, Dh); cos/sin: (S, Dh/2).

    cos/sin are cast to ``x.dtype`` before the products, as in the
    reference, so on the bf16 path the rotation rounds in bf16.
    """
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# What ``"dots"`` keeps: the products without batch dimensions (the
# projections, ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``);
# attention's and the experts' batched ``bmm``s are recomputed with the rest.
_DOTS_SAVEABLE = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def remat_wrap(cfg, fn):
    """``fn`` recomputed in the backward pass, with the configured policy:
    ``"full"`` saves only the layer's inputs (the memory lever when
    ``"dots"`` still overflows), ``"dots"`` also the outputs of the
    unbatched products (``aten.mm``/``addmm``)."""
    if cfg.remat_policy == "full":
        def run(*args):
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
    else:
        def run(*args):
            return checkpoint(
                fn, *args, use_reentrant=False, preserve_rng_state=False,
                context_fn=partial(create_selective_checkpoint_contexts,
                                   _DOTS_SAVEABLE))
    return run


# ---------------------------------------------------------------------------
# Decode-attention sharding (flash-decoding layout)
# ---------------------------------------------------------------------------


def ambient_mesh_axes() -> Dict[str, int]:
    """Axis sizes of the ambient mesh (``launch.mesh.use_mesh``); {} when
    none."""
    from repro_torch.launch import mesh as M

    amb = M.current()
    return {} if amb is None else M.mesh_shape(amb.mesh)


def decode_seq_shard(batch: int, n_kv_heads: int, skv: int):
    """The decode-attention layout on the ambient mesh, as the reference
    decides it: when kv-heads don't divide the model axis the serve cache
    is sharded on its seq dim (``launch/sharding.cache_spec_for``), and
    the logits stay seq-sharded (the flash-decoding partitioning).
    Returns ``(batch_axes | None,)`` when that layout applies, else
    ``None``."""
    ax = ambient_mesh_axes()
    model = ax.get("model", 1)
    if model <= 1 or n_kv_heads % model == 0 or skv % model != 0:
        return None
    dps = [a for a in ("pod", "data") if a in ax]
    for start in range(len(dps)):
        use = tuple(dps[start:])
        if batch % math.prod(ax[a] for a in use) == 0:
            return (use,)
    return (None,)


def _wsc(x: Tensor, spec) -> Tensor:
    """A DTensor redistributed to ``spec`` on its mesh; a plain tensor (the
    model code's, one rank's rows) unchanged."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import P, to_placements

    return x.redistribute(x.device_mesh, to_placements(P(*spec),
                                                       x.device_mesh))


def _decode_hints(kr: Tensor, vr: Tensor, logits_fn, batch: int,
                  n_kv_heads: int):
    """The reference's decode-layout hints around ``logits_fn(kr)``."""
    seqsh = decode_seq_shard(batch, n_kv_heads, kr.shape[2])
    if seqsh is None:
        return kr, vr, logits_fn(kr)
    (bax,) = seqsh
    kr = _wsc(kr, (bax, None, "model", None))
    vr = _wsc(vr, (bax, None, "model", None))
    return kr, vr, _wsc(logits_fn(kr), (bax, None, None, "model"))


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def init_attention(
    gen,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    *,
    qkv_bias: bool = False,
    dtype=torch.float32,
    lead=(),
    device=None,
) -> Params:
    kw = dict(dtype=dtype, lead=lead, device=device)
    return {
        "wq": init_linear(gen, d_model, n_heads * head_dim, bias=qkv_bias, **kw),
        "wk": init_linear(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw),
        "wv": init_linear(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias, **kw),
        "wo": init_linear(gen, n_heads * head_dim, d_model, **kw),
    }


def _split_heads(x: Tensor, n_heads: int) -> Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1).transpose(1, 2)


def _merge_heads(x: Tensor) -> Tensor:
    """(B, H, S, D) -> (B, S, H * D): a view when ``x`` is the (B, H, S, D)
    view of a (B, S, H, D) buffer (the flash kernels' output), a copy
    otherwise."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _repeat_kv(x: Tensor, group: int) -> Tensor:
    """``jnp.repeat(x, group, axis=1)``: query head h reads kv head
    ``h // group`` (``Tensor.repeat`` would pair them wrongly)."""
    return x.repeat_interleave(group, dim=1)


def attention_full(
    p: Params,
    x: Tensor,  # (B, S, D)
    n_heads: int,
    n_kv_heads: int,
    *,
    rope_base: float = 10000.0,
    causal: bool = True,
    backend: str = "ref",
    kv_ctx: Optional[Tensor] = None,  # cross-attention context (B, Sk, D)
    compute_dtype=torch.float32,
    cache_dtype: Optional[torch.dtype] = None,
    window: Optional[int] = None,
):
    """Full-sequence attention (train / prefill). Returns (B, S, D).

    ``backend="pallas"`` runs the flash-attention kernel (its plain
    version on the CPU); ``"chunked"`` runs :func:`attention_chunked`;
    anything else the masked-softmax reference, which rounds its logits
    to ``compute_dtype`` before the f32 softmax where the kernel keeps
    them in f32.

    ``window`` is a sliding window: query ``i`` sees keys ``j`` with
    ``i - window < j``.  The flash kernel has no window: ``"pallas"`` runs
    it only when ``window is None`` and takes the masked reference path
    otherwise, as the reference routes (``repro/models/layers.py``).

    With ``kv_ctx`` (B, Sk, D) it is cross-attention: keys and values
    project from the context, nothing is rotated and every query sees
    every key.  The flash kernel is taken only for self-attention, so
    cross-attention always runs the masked path on ``"pallas"``, as the
    reference routes.

    With ``cache_dtype`` set it returns ``(out, cache)``: the prefix's KV
    cache, rotated keys and values cast to ``cache_dtype``, which the
    reference's ``attention_prefill_cache`` computes a second time.
    """
    b, s, _ = x.shape
    src = x if kv_ctx is None else kv_ctx
    q = _split_heads(linear(p["wq"], x, compute_dtype), n_heads)
    k = _split_heads(linear(p["wk"], src, compute_dtype), n_kv_heads)
    v = _split_heads(linear(p["wv"], src, compute_dtype), n_kv_heads)
    head_dim = q.shape[-1]

    if kv_ctx is None and rope_base > 0:
        cos, sin = rope_cos_sin(torch.arange(s, device=x.device), head_dim,
                                rope_base)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    group = n_heads // n_kv_heads
    if backend == "pallas" and kv_ctx is None and window is None:
        # The kernels read these (B, S, H, D)-backed views through their
        # strides and return a (B, S, Hq, D)-backed view, which
        # _merge_heads reshapes without a copy.
        o = flash_attention_pallas(q, k, v, causal=causal)
    elif backend == "chunked":
        o = attention_chunked(
            q, _repeat_kv(k, group), _repeat_kv(v, group),
            causal=causal and kv_ctx is None, window=window,
        )
    else:
        kr = _repeat_kv(k, group)
        vr = _repeat_kv(v, group)
        logits = torch.matmul(q, kr.transpose(-1, -2)).float()
        logits = logits / math.sqrt(head_dim)
        if kv_ctx is None and (causal or window is not None):
            qpos = torch.arange(s, device=x.device)[:, None]
            kpos = torch.arange(s, device=x.device)[None, :]
            keep = torch.ones((s, s), dtype=torch.bool, device=x.device)
            if causal:
                keep = kpos <= qpos
            if window is not None:
                keep = keep & (kpos > qpos - window)
            logits = logits.masked_fill(~keep, _NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(compute_dtype)
        o = torch.matmul(probs, vr)
    out = linear(p["wo"], _merge_heads(o), compute_dtype)
    if cache_dtype is None:
        return out
    return out, {"k": k.to(cache_dtype), "v": v.to(cache_dtype)}


def attention_decode(
    p: Params,
    x: Tensor,  # (B, 1, D) current-token activations
    cache: Dict[str, Tensor],  # {'k','v'}: (B, Hkv, S, Dh)
    pos: int,  # write/read position
    n_heads: int,
    n_kv_heads: int,
    *,
    rope_base: float = 10000.0,
    compute_dtype=torch.float32,
    window: Optional[int] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One decode step against a KV cache. Returns (out (B,1,D), cache).

    With ``window`` the step sees the positions ``pos - window < j <=
    pos`` of the cache.

    The new K/V are written into ``cache`` in place (the reference's
    serving step donates the cache to the same effect).  A position
    outside the cache raises: ``dynamic_update_slice`` in the reference
    would clamp it and write silently at the wrong place.
    """
    pos = int(pos)
    skv = cache["k"].shape[2]
    if not 0 <= pos < skv:
        raise IndexError(f"decode position {pos} outside the cache [0, {skv})")
    q = _split_heads(linear(p["wq"], x, compute_dtype), n_heads)  # (B,H,1,Dh)
    k_new = _split_heads(linear(p["wk"], x, compute_dtype), n_kv_heads)
    v_new = _split_heads(linear(p["wv"], x, compute_dtype), n_kv_heads)
    head_dim = q.shape[-1]
    if rope_base > 0:
        # A fill on the device: torch.tensor([pos]) would copy from the
        # host and wait for the stream, once per layer and token.
        cos, sin = rope_cos_sin(torch.full((1,), pos, device=x.device),
                                head_dim, rope_base)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)

    ck, cv = cache["k"], cache["v"]
    ck[:, :, pos:pos + 1] = k_new.to(ck.dtype)
    cv[:, :, pos:pos + 1] = v_new.to(cv.dtype)
    group = n_heads // n_kv_heads
    kr = _repeat_kv(ck.to(compute_dtype), group)
    vr = _repeat_kv(cv.to(compute_dtype), group)
    kr, vr, logits = _decode_hints(
        kr, vr, lambda kr: torch.matmul(q, kr.transpose(-1, -2)).float()
        / math.sqrt(head_dim), x.shape[0], n_kv_heads)
    kpos = torch.arange(skv, device=x.device)
    keep = kpos <= pos
    if window is not None:
        keep = keep & (kpos > pos - window)
    logits = logits.masked_fill(~keep, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(compute_dtype)
    o = torch.matmul(probs, vr)
    out = linear(p["wo"], _merge_heads(o), compute_dtype)
    return out, cache


def cross_kv(p: Params, ctx: Tensor, n_kv_heads: int, *,
             compute_dtype=torch.float32,
             cache_dtype=torch.bfloat16) -> Tuple[Tensor, Tensor]:
    """A context's cross-attention K/V, (B, Hkv, Sk, Dh) each in
    ``cache_dtype``: projected once at prefill, read by
    :func:`cross_attention_decode` at every step."""
    k = _split_heads(linear(p["wk"], ctx, compute_dtype), n_kv_heads)
    v = _split_heads(linear(p["wv"], ctx, compute_dtype), n_kv_heads)
    return k.to(cache_dtype), v.to(cache_dtype)


def cross_attention_decode(p: Params, x: Tensor, xk: Tensor, xv: Tensor,
                           n_heads: int, *,
                           compute_dtype=torch.float32) -> Tensor:
    """One token's cross-attention (B, 1, D) against precomputed context
    K/V (B, Hkv, Sk, Dh): no RoPE, every key seen.  Returns (B, 1, D)."""
    b = x.shape[0]
    q = _split_heads(linear(p["wq"], x, compute_dtype), n_heads)
    group = n_heads // xk.shape[1]
    kr = _repeat_kv(xk.to(compute_dtype), group)
    vr = _repeat_kv(xv.to(compute_dtype), group)
    kr, vr, logits = _decode_hints(
        kr, vr, lambda kr: torch.matmul(q, kr.transpose(-1, -2)).float()
        / math.sqrt(q.shape[-1]), b, xk.shape[1])
    probs = torch.softmax(logits, dim=-1).to(compute_dtype)
    o = torch.matmul(probs, vr).transpose(1, 2).reshape(b, 1, -1)
    return linear(p["wo"], o, compute_dtype)


def attention_chunked(
    q: Tensor,  # (B, H, Sq, Dh)
    k: Tensor,  # (B, H, Sk, Dh)
    v: Tensor,  # (B, H, Sk, Dh)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 1024,
    k_chunk: int = 1024,
) -> Tensor:
    """Online-softmax blockwise attention (Rabe–Staats) in plain PyTorch.

    Never materialises the (Sq, Sk) probability matrix: the running
    (m, l, acc) are carried over kv chunks, as in the reference's scan.
    """
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    dv = v.shape[-1]
    qc = min(q_chunk, sq)
    kc = min(k_chunk, sk)
    sq_real, sk_real = sq, sk
    if sq % qc or sk % kc:  # pad to chunk multiples; padded keys masked
        sq_p = -(-sq // qc) * qc
        sk_p = -(-sk // kc) * kc
        q = F.pad(q, (0, 0, 0, sq_p - sq))
        k = F.pad(k, (0, 0, 0, sk_p - sk))
        v = F.pad(v, (0, 0, 0, sk_p - sk))
        sq, sk = sq_p, sk_p
    scale = 1.0 / math.sqrt(dh)
    f32 = torch.float32
    dev = q.device

    outs = []
    for qi in range(sq // qc):
        q_blk = q[:, :, qi * qc:(qi + 1) * qc]
        m = torch.full((b, h, qc), -torch.inf, dtype=f32, device=dev)
        l = torch.zeros((b, h, qc), dtype=f32, device=dev)
        acc = torch.zeros((b, h, qc, dv), dtype=f32, device=dev)
        qpos = qi * qc + torch.arange(qc, device=dev)
        for ki in range(sk // kc):
            k_blk = k[:, :, ki * kc:(ki + 1) * kc]
            v_blk = v[:, :, ki * kc:(ki + 1) * kc]
            s = torch.matmul(q_blk, k_blk.transpose(-1, -2)).float() * scale
            kpos = ki * kc + torch.arange(kc, device=dev)
            mask = (kpos[None, :] < sk_real).expand(qc, kc)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            s = s.masked_fill(~mask, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + pr.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                pr.to(v_blk.dtype), v_blk
            ).float()
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=2)
    return out[:, :, :sq_real].to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(
    gen,
    d_model: int,
    d_ff: int,
    *,
    kind: str = "swiglu",
    dtype=torch.float32,
    lead=(),
    device=None,
) -> Params:
    kw = dict(dtype=dtype, lead=lead, device=device)
    if kind == "swiglu":
        return {
            "gate": init_linear(gen, d_model, d_ff, **kw),
            "up": init_linear(gen, d_model, d_ff, **kw),
            "down": init_linear(gen, d_ff, d_model, **kw),
        }
    if kind == "gelu":
        return {
            "up": init_linear(gen, d_model, d_ff, **kw),
            "down": init_linear(gen, d_ff, d_model, **kw),
        }
    raise ValueError(kind)


def mlp(p: Params, x: Tensor, compute_dtype=torch.float32) -> Tensor:
    if "gate" in p:
        h = F.silu(linear(p["gate"], x, compute_dtype)) * linear(
            p["up"], x, compute_dtype
        )
    else:
        # jax.nn.gelu defaults to the tanh approximation.
        h = F.gelu(linear(p["up"], x, compute_dtype), approximate="tanh")
    return linear(p["down"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def next_token_loss(logits: Tensor, tokens: Tensor,
                    mask: Optional[Tensor] = None) -> Tensor:
    """Mean next-token cross-entropy (``logsumexp - gold``). logits
    (B,S,V); tokens (B,S); ``mask`` (B,S) weights the targets, the mean
    over ``max(sum(mask), 1)``."""
    lg = logits[:, :-1]
    tg = tokens[:, 1:].long()
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tg[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    m = mask[:, 1:].float()
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
