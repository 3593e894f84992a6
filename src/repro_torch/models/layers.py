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

Tensor parallelism (the serving steps of the dense family, and of RWKV6
and the hybrid through these layers and their own, ``models/rwkv6.py``
and ``models/mamba2.py``): when the ambient mesh carries a
``launch.mesh.TensorParallel`` (:func:`tensor_parallel`), each parameter
is this rank's block of it, as the sharding rules place it over
``"model"``, and the layers compute on the blocks (Megatron's plan, which
GSPMD derives from the same specs in the reference):

* column-parallel projections (``wq/wk/wv``, ``gate/up``, ``lm_head``)
  give the rank's output columns, with no collective;
* row-parallel ones (``wo``, ``down``; :func:`linear_row`) multiply the
  rank's input columns by its rows and all-reduce the partial products,
  summed in float32, a replicated bias added once after the sum;
* :func:`embed` looks up the rank's vocabulary range, zeroes the other
  tokens' rows and all-reduces in the compute dtype (one nonzero term a
  row: exact); :func:`unembed` and the ``lm_head`` path give the rank's
  vocabulary of logits, all-gathered in float32 (:func:`gather_vocab`);
* :func:`attention_full` attends the rank's whole query heads with the kv
  heads they read (its own when ``n_kv_heads`` divides over ``"model"``,
  else a slice of the replicated ones); where the heads split mid-head
  it all-gathers q, attends every head and keeps the columns its block
  of ``wo``'s rows takes;
* :func:`attention_decode` does the same against a cache split over kv
  heads (or whole); against a cache split over its sequence (the
  flash-decoding layout) each rank attends every head over its slice of
  the positions, and the partial max, sum and output are combined:
  all-reduce max, then all-reduce sum, both in float32;
* the helpers the recurrent families share: :func:`whole_cols` gathers a
  split projection's columns, :func:`whole_state` a split state leaf,
  :func:`block_of` / :func:`state_block` cut a whole tensor to the rank's
  block, and :func:`rmsnorm_split` normalises channels split over the
  axis by a float32 all-reduce of the sum of squares.

Every collective goes through ``launch/collectives.py`` over the
``"model"`` group, so ``launch.hloparse.Recorder`` records it; on a
one-rank model axis each is the identity and issues nothing.
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
from repro_torch.launch import collectives as C
from repro_torch.launch import mesh as M
from repro_torch.launch.sharding import model_block

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


def tensor_parallel():
    """The ambient mesh's ``launch.mesh.TensorParallel``, or ``None`` when
    every weight is whole (no mesh, or another family's sharded step)."""
    amb = M.current()
    return None if amb is None else amb.tp


def _split(tp, owner: str) -> bool:
    """Whether ``owner``'s weights are this rank's shard over "model"."""
    return tp is not None and owner in tp.sharded


def _sum_over_model(tp, y: Tensor) -> Tensor:
    """``y``'s partial sums added over the model axis, in float32, cast
    back to ``y``'s dtype (the identity on one rank)."""
    if tp.size == 1:
        return y
    return C.all_reduce_sum(y.float(), tp.group).to(y.dtype)


def linear_row(p: Params, x: Tensor, compute_dtype, owner: str) -> Tensor:
    """:func:`linear` of a row-parallel projection: under tensor
    parallelism with ``owner`` split, ``x`` holds the input columns of
    this rank's rows of ``p["w"]``; the partial products are all-reduced
    (in float32) and a bias, replicated, is added once after the sum."""
    tp = tensor_parallel()
    if not _split(tp, owner):
        return linear(p, x, compute_dtype)
    y = _sum_over_model(tp, torch.matmul(x.to(compute_dtype),
                                         p["w"].to(compute_dtype)))
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def init_embedding(gen, vocab: int, d_model: int, dtype=torch.float32,
                   device=None) -> Params:
    return {"table": _normal(gen, (vocab, d_model), 0.02, dtype, device)}


def embed(p: Params, tokens: Tensor, compute_dtype=torch.float32) -> Tensor:
    """Rows of the table for ``tokens``.  Vocab-parallel under tensor
    parallelism: the rank's rows of its vocabulary range, zeros for the
    other tokens, all-reduced in ``compute_dtype`` (exact: one rank holds
    each token)."""
    table = p["table"].to(compute_dtype)
    tp = tensor_parallel()
    if not _split(tp, "embed"):
        return table[tokens.long()]
    t = tokens.long() - tp.rank * table.shape[0]
    inside = (t >= 0) & (t < table.shape[0])
    x = table[torch.where(inside, t, 0)].masked_fill(~inside[..., None], 0)
    return C.all_reduce_sum(x, tp.group)


def gather_vocab(logits: Tensor, owner: str) -> Tensor:
    """Logits over the rank's vocabulary (``owner``'s columns or rows)
    all-gathered over the model axis into the whole vocabulary, in the
    logits' dtype; unchanged when ``owner`` is whole."""
    return whole_cols(tensor_parallel(), logits, owner)


def whole_cols(tp, y: Tensor, owner: str) -> Tensor:
    """``y``, the output columns of ``owner``'s projection on this rank,
    over every column: all-gathered over the model axis in ``y``'s dtype
    where ``owner`` is split, unchanged where it is whole."""
    if not _split(tp, owner):
        return y
    return C.all_gather(y, tp.group, -1)


def whole_state(tp, x: Tensor, name: str) -> Tensor:
    """Serve-state leaf ``name``'s block ``x`` on this rank (split over
    its last dim) all-gathered over the model axis where the plan splits
    it (``TensorParallel.state``); unchanged where it is whole."""
    if tp is None or name not in tp.state:
        return x
    return C.all_gather(x, tp.group, -1)


def block_of(tp, x: Tensor, dim: int = -1) -> Tensor:
    """This rank's block of ``x``'s dim ``dim`` (a view), as a split over
    the model axis cuts it (:func:`model_block`): a replicated vector or
    a whole activation cut to the block a split neighbour holds."""
    lo, hi = model_block(x.shape[dim], tp)
    return x.narrow(dim, lo, hi - lo)


def state_block(tp, x: Tensor, name: str, dim: int = -1) -> Tensor:
    """:func:`block_of` where the plan splits serve-state leaf ``name``
    over the model axis, ``x`` where it is whole."""
    if tp is None or name not in tp.state:
        return x
    return block_of(tp, x, dim)


def unembed(p: Params, x: Tensor, compute_dtype=torch.float32) -> Tensor:
    """Tied unembedding: logits = x @ table^T (always fp32 out); over the
    whole vocabulary under tensor parallelism too (:func:`gather_vocab`)."""
    return gather_vocab(torch.matmul(
        x.to(compute_dtype), p["table"].to(compute_dtype).T
    ).float(), "embed")


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


def rmsnorm_split(p: Params, x: Tensor, tp, eps: float = 1e-6) -> Tensor:
    """:func:`rmsnorm` over channels split over the model axis: ``x``
    holds this rank's block of them and ``p["scale"]`` is whole; the mean
    of squares is the float32 sum of squares all-reduced over the axis,
    over the whole width (the plain :func:`rmsnorm` on one rank)."""
    if tp.size == 1:
        return rmsnorm(p, x, eps)
    xf = x.float()
    ss = C.all_reduce_sum(torch.sum(xf * xf, dim=-1, keepdim=True), tp.group)
    y = xf * torch.rsqrt(ss / (x.shape[-1] * tp.size) + eps)
    return (y * block_of(tp, p["scale"]).float()).to(x.dtype)


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


def _query_heads(tp, q: Tensor, n_heads: int, every_head: bool = False):
    """The query heads this rank attends, from its projection ``q`` (B,
    S, columns): ``(q (B, hq, S, Dh), h0, cols)``, its heads being ``h0 ..
    h0 + hq - 1`` and ``cols`` the columns of the merged output that its
    block of ``wo``'s rows takes (``None``: all of them).  Whole heads
    stay local; heads split mid-head, or every head where ``every_head``
    (the rank attends a block of the positions), are all-gathered over the
    model axis."""
    if tp is None:
        return _split_heads(q, n_heads), 0, None
    width = q.shape[-1] * (tp.size if _split(tp, "wq") else 1)
    if (_split(tp, "wq") and n_heads % tp.size == 0
            and not every_head):  # wo's rows split too
        h0, h1 = model_block(n_heads, tp)
        return _split_heads(q, h1 - h0), h0, None
    if _split(tp, "wq"):
        q = C.all_gather(q, tp.group, -1)
    cols = slice(*model_block(width, tp)) if _split(tp, "wo") else None
    return _split_heads(q, n_heads), 0, cols


def _kv_heads(tp, k: Tensor, v: Tensor, h0: int, hq: int, n_heads: int,
              n_kv_heads: int) -> Tuple[Tensor, Tensor]:
    """The kv heads that query heads ``h0 .. h0 + hq - 1`` read, from the
    heads this rank holds (B, hk, S, Dh): its own block when ``wk`` is
    split (``n_kv_heads`` divides over the model axis), else a slice of
    the whole set (views), or, where the query heads do not map onto a
    run of kv heads in equal groups, one kv head a query head (a copy)."""
    if tp is None or _split(tp, "wk"):
        return k, v
    group = n_heads // n_kv_heads
    if hq % group == 0 or group % hq == 0:
        k0, k1 = h0 // group, (h0 + hq - 1) // group + 1
        return k[:, k0:k1], v[:, k0:k1]
    idx = torch.arange(h0, h0 + hq, device=k.device) // group
    return k.index_select(1, idx), v.index_select(1, idx)


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
    cache_block: bool = True,
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
    reference's ``attention_prefill_cache`` computes a second time.  Under
    a plan whose cache is split over its sequence, the cache is the rank's
    block of the positions; with ``cache_block=False`` every position, for
    a caller that lays them out itself (the hybrid's modular window).
    """
    b, s, _ = x.shape
    src = x if kv_ctx is None else kv_ctx
    tp = tensor_parallel()  # set on the tensor-parallel serving steps
    q, h0, cols = _query_heads(tp, linear(p["wq"], x, compute_dtype),
                               n_heads)
    head_dim = q.shape[-1]
    k = linear(p["wk"], src, compute_dtype)
    v = linear(p["wv"], src, compute_dtype)
    k = _split_heads(k, k.shape[-1] // head_dim)
    v = _split_heads(v, v.shape[-1] // head_dim)

    if kv_ctx is None and rope_base > 0:
        cos, sin = rope_cos_sin(torch.arange(s, device=x.device), head_dim,
                                rope_base)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    k_all, v_all = k, v  # the rank's cache: every kv head it holds
    k, v = _kv_heads(tp, k, v, h0, q.shape[1], n_heads, n_kv_heads)
    group = q.shape[1] // k.shape[1]
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
    o = _merge_heads(o)
    out = linear_row(p["wo"], o if cols is None else o[..., cols],
                     compute_dtype, "wo")
    if cache_dtype is None:
        return out
    if tp is not None and tp.cache_seq and cache_block:  # its positions
        lo, hi = model_block(s, tp)
        k_all, v_all = k_all[:, :, lo:hi], v_all[:, :, lo:hi]
    return out, {"k": k_all.to(cache_dtype), "v": v_all.to(cache_dtype)}


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
    tp = tensor_parallel()
    # The flash-decoding layout: this rank holds a block of the positions,
    # and attends every head over it.
    over_seq = tp is not None and tp.cache_seq
    s_loc = cache["k"].shape[2]
    skv = s_loc * (tp.size if over_seq else 1)
    if not 0 <= pos < skv:
        raise IndexError(f"decode position {pos} outside the cache [0, {skv})")
    q, h0, cols = _query_heads(tp, linear(p["wq"], x, compute_dtype),
                               n_heads, every_head=over_seq)  # (B,H,1,Dh)
    head_dim = q.shape[-1]
    k_new = linear(p["wk"], x, compute_dtype)
    v_new = linear(p["wv"], x, compute_dtype)
    k_new = _split_heads(k_new, k_new.shape[-1] // head_dim)
    v_new = _split_heads(v_new, v_new.shape[-1] // head_dim)
    if rope_base > 0:
        # A fill on the device: torch.tensor([pos]) would copy from the
        # host and wait for the stream, once per layer and token.
        cos, sin = rope_cos_sin(torch.full((1,), pos, device=x.device),
                                head_dim, rope_base)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)

    ck, cv = cache["k"], cache["v"]
    lo = tp.rank * s_loc if over_seq else 0  # the rank's first position
    if lo <= pos < lo + s_loc:  # the rank holding pos writes it
        ck[:, :, pos - lo:pos - lo + 1] = k_new.to(ck.dtype)
        cv[:, :, pos - lo:pos - lo + 1] = v_new.to(cv.dtype)
    kc, vc = _kv_heads(tp, ck, cv, h0, q.shape[1], n_heads, n_kv_heads)
    group = q.shape[1] // kc.shape[1]
    kr = _repeat_kv(kc.to(compute_dtype), group)
    vr = _repeat_kv(vc.to(compute_dtype), group)
    kr, vr, logits = _decode_hints(
        kr, vr, lambda kr: torch.matmul(q, kr.transpose(-1, -2)).float()
        / math.sqrt(head_dim), x.shape[0], n_kv_heads)
    kpos = torch.arange(lo, lo + s_loc, device=x.device)
    keep = kpos <= pos
    if window is not None:
        keep = keep & (kpos > pos - window)
    logits = logits.masked_fill(~keep, _NEG_INF)
    if over_seq:
        o = _softmax_over_model(tp, logits, vr).to(compute_dtype)
    else:
        probs = torch.softmax(logits, dim=-1).to(compute_dtype)
        o = torch.matmul(probs, vr)
    o = _merge_heads(o)
    out = linear_row(p["wo"], o if cols is None else o[..., cols],
                     compute_dtype, "wo")
    return out, cache


def _softmax_over_model(tp, logits: Tensor, v: Tensor) -> Tensor:
    """``softmax(logits) @ v`` where each rank holds a block of the
    positions (``logits`` (..., S_rank), ``v`` (..., S_rank, Dh)): the
    largest logit by an all-reduce max, then the exponentials' products
    with ``v`` and their sums by one all-reduce sum, both in float32."""
    top = C.all_reduce_max(logits.amax(dim=-1, keepdim=True), tp.group)
    e = torch.exp(logits - top)
    part = C.all_reduce_sum(torch.cat(
        [torch.matmul(e, v.float()), e.sum(dim=-1, keepdim=True)], dim=-1),
        tp.group)
    return part[..., :-1] / part[..., -1:]


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
    return linear_row(p["down"], h, compute_dtype, "down")


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
