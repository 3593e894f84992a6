"""EFM serving steps: prefill and batched decode, on one card or sharded
over a device mesh.

Port of ``repro/serve/efm.py``.  PyTorch runs eagerly, so each step is a
plain callable, without gradients.  The steps take any family's batch
(``models/model.py``: tokens, plus ``img_embed`` for the VLM and
``src_embed`` for the encoder-decoder, whose prefill returns no logits
and whose decode starts at position 0); ``pad_for_decode`` gives a
prefill's state room for the decoded tokens, the caller's job in the
reference (``examples/serve_stream.py``).

``mesh=None`` returns the step alone, on the model's device.  With a mesh
(and the reference's ``shape_spec``) each returns ``(step, specs)`` as the
reference does: one process per device, each rank running the family's
code on its batch rows under the ambient mesh (``launch.mesh.use_mesh``).
Plain tensors passed in are taken as the whole value, each rank cutting
its own block (no collective).

The dense family (TinyLlama, OLMo, Qwen2.5, Phi-4-mini), RWKV6 and the
Zamba2 hybrid (``shard_strategy "tp"``) run tensor-parallel, as the
reference's GSPMD partitions them: every parameter stays as
``param_specs`` places it, each rank computes on its blocks
(``to_local()``), and the layers all-reduce and all-gather activations
over the ``"model"`` axis (``models/layers.py``, ``models/rwkv6.py``,
``models/mamba2.py``); no parameter is gathered.  The state is built and
updated as each rank's block of ``serve_specs`` (the K/V cache over kv
heads, or over the sequence where kv heads do not divide; RWKV6's
``wkv`` over K and its shifts over D; the hybrid's ``ssm`` over heads and
``conv`` over channels, its windowed cache over kv heads or, where they
do not divide, over its slots), and both steps return it as DTensors so
placed.

The other families (MoE/MLA, the VLM, the encoder-decoder) and every
family under ``"dp"``/``"fsdp"`` still gather every parameter whole on
each rank and run the unsharded code on the rank's rows; their prefill
returns the cache split over the batch rows.

Prefill returns its logits split over the batch rows; decode returns them
replicated (the reference's ``P()``) and the state placed by its specs.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor
from torch.utils import _pytree as pytree

from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.models.model import Model


def _whole(tree):
    from torch.distributed.tensor import DTensor

    return pytree.tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


# Where each serve-state leaf keeps its batch dim, counted from the end
# (the sharding rules find it by size, which a layer count can equal).
_BATCH_FROM_END = {"k": 4, "v": 4, "xk": 4, "xv": 4, "wkv": 4, "ssm": 4,
                   "c_kv": 3, "k_rope": 3, "conv": 3, "shift_tm": 2,
                   "shift_cm": 2, "slot_pos": 2}


def _rows(mesh, tree, batch_axes, specs=None):
    """``NamedSharding``s splitting each state leaf's batch dim over
    ``batch_axes``: the rows one rank computes; with ``specs`` (the serve
    specs) each leaf keeps their splits over ``"model"`` too."""
    leaves, treespec = pytree.tree_flatten_with_path(tree)
    kept = ([()] * len(leaves) if specs is None else
            [tuple(e if "model" in S.spec_axes(e) else None for e in spec)
             for spec in S.leaves_like(tree, specs)])

    def one(path, x, model):
        spec = list(model) + [None] * (x.ndim - len(model))
        spec[x.ndim - _BATCH_FROM_END[S._key_str(path[-1])]] = (
            batch_axes or None)
        return S.NamedSharding(mesh, S.P(*spec))

    return pytree.tree_unflatten(
        [one(p, x, m) for (p, x), m in zip(leaves, kept)], treespec)


def _need_shape(shape_spec) -> None:
    if shape_spec is None:
        raise ValueError("a step on a mesh is built for one shape: pass "
                         "shape_spec (configs.base.ShapeSpec)")


def _cache_seq(sspecs) -> bool:
    """Whether the serve specs split the K/V cache (.., B, H, S, D) over
    its sequence on ``"model"``."""
    return "k" in sspecs and "model" in S.spec_axes(sspecs["k"][-2])


def _tensor_parallel(model: Model) -> bool:
    """Whether the steps run ``model`` tensor-parallel on a mesh (the
    others gather every parameter whole)."""
    cfg = model.cfg
    return (cfg.family in ("dense", "rwkv6", "hybrid")
            and cfg.shard_strategy == "tp")


def _tp_plan(mesh, pspecs, sspecs):
    """The rank's ``TensorParallel`` for parameters placed by ``pspecs``
    and a serve state placed by ``sspecs``."""
    return M.tensor_parallel(
        mesh, S.model_sharded(pspecs), cache_seq=_cache_seq(sspecs),
        state=[name for name, spec in sspecs.items()
               if any("model" in S.spec_axes(e) for e in spec)])


def _placed(x, sharding):
    """A rank's block as the DTensor ``sharding`` places (no collective)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x, sharding.mesh, sharding.placements,
                              run_check=False)


def jit_prefill(model: Model, mesh=None, shape_spec=None):
    """Full-context ingest: ``step(params, batch) -> (logits, cache)``;
    on a mesh ``(step, {"params", "batch"})``."""
    if mesh is None:
        @torch.no_grad()
        def prefill(params, batch):
            return model.prefill(params, batch)

        return prefill

    _need_shape(shape_spec)
    pspecs = S.param_specs(model.cfg, model.param_spec(), mesh)
    bspecs = S.batch_specs(model.cfg, shape_spec, mesh)
    on_batch = S.named(mesh, bspecs)
    b_axes = S.spec_axes(bspecs["tokens"][0])
    on_logits = S.NamedSharding(mesh, S.P(b_axes or None))

    if _tensor_parallel(model):
        b, s = shape_spec.global_batch, shape_spec.seq_len
        sshape = model.serve_spec(b, s)
        sspecs = S.serve_specs(model.cfg, sshape, mesh, b)
        tp = _tp_plan(mesh, pspecs, sspecs)
        on_params, on_cache = S.named(mesh, pspecs), S.named(mesh, sspecs)
        on_block = _rows(mesh, sshape, b_axes, sspecs)

        @torch.no_grad()
        def tp_prefill(params, batch):
            if tuple(batch["tokens"].shape) != (b, s):
                raise ValueError(f"tokens {tuple(batch['tokens'].shape)}: "
                                 f"this step was built for {(b, s)}")
            local = S.local_blocks(batch, on_batch)
            with M.use_mesh(mesh, b_axes, tp):
                logits, cache = model.prefill(
                    S.local_blocks(params, on_params), local)
            return _placed(logits, on_logits), pytree.tree_map(
                lambda x, blk, on: S.place(_placed(x, blk), on), cache,
                on_block, on_cache)

        return tp_prefill, {"params": pspecs, "batch": bspecs}

    @torch.no_grad()
    def sharded_prefill(params, batch):
        local = {k: S.place(v, on_batch[k]).to_local()
                 for k, v in batch.items()}
        with M.use_mesh(mesh, b_axes):
            logits, cache = model.prefill(_whole(params), local)
        out = None if logits is None else _placed(logits, on_logits)
        cache = pytree.tree_map(_placed, cache, _rows(mesh, cache, b_axes))
        return out, cache

    return sharded_prefill, {"params": pspecs, "batch": bspecs}


def jit_decode_step(model: Model, mesh=None, shape_spec=None):
    """One-token decode: ``step(params, state, token, pos) -> (logits,
    state)``; the state's cache is updated in place (the reference donates
    it).  On a mesh ``(step, {"params", "state", "token"})``."""
    if mesh is None:
        @torch.no_grad()
        def decode(params, state, token, pos):
            return model.decode_step(params, state, token, pos)

        return decode

    from torch.distributed.tensor import Replicate

    _need_shape(shape_spec)
    b = shape_spec.global_batch
    pspecs = S.param_specs(model.cfg, model.param_spec(), mesh)
    sshape = model.serve_spec(b, shape_spec.seq_len)
    sspecs = S.serve_specs(model.cfg, sshape, mesh, b)
    dp = S._dp(mesh, b)
    tok_spec = S.P(dp if dp else None, None)
    on_state = S.named(mesh, sspecs)
    on_rows = _rows(mesh, sshape, dp)
    on_token = S.NamedSharding(mesh, tok_spec)
    on_logits = S.NamedSharding(mesh, S.P(dp or None))
    replicated = [Replicate()] * len(M.mesh_axes(mesh))
    specs = {"params": pspecs, "state": sspecs, "token": tok_spec}

    if _tensor_parallel(model):
        tp = _tp_plan(mesh, pspecs, sspecs)
        on_params = S.named(mesh, pspecs)
        # The rank computes on its rows and its "model" block; the state
        # comes and goes placed by the serve specs, which differ from that
        # only where a layer count equals the batch (_BATCH_FROM_END).
        on_block = _rows(mesh, sshape, dp, sspecs)

        @torch.no_grad()
        def tp_decode(params, state, token, pos):
            local = pytree.tree_map(lambda x, blk: S.place(x, blk).to_local(),
                                    state, on_block)  # written in place
            tok = S.place(token, on_token).to_local()
            with M.use_mesh(mesh, dp or (), tp):
                logits, local = model.decode_step(
                    S.local_blocks(params, on_params), local, tok, pos)
            return (_placed(logits, on_logits).redistribute(mesh, replicated),
                    pytree.tree_map(
                        lambda x, blk, on: S.place(_placed(x, blk), on),
                        local, on_block, on_state))

        return tp_decode, specs

    @torch.no_grad()
    def sharded_decode(params, state, token, pos):
        rows = pytree.tree_map(lambda x, r: S.place(x, r).to_local(),
                               state, on_rows)
        tok = S.place(token, on_token).to_local()
        with M.use_mesh(mesh, dp or ()):
            logits, rows = model.decode_step(_whole(params), rows, tok, pos)
        logits = _placed(logits, on_logits).redistribute(mesh, replicated)
        state = pytree.tree_map(
            lambda x, r, on: S.place(_placed(x, r), on), rows, on_rows,
            on_state)
        return logits, state

    return sharded_decode, specs


def pad_for_decode(model: Model, state, n: int):
    """``model``'s prefill ``state`` with room for ``n`` decoded tokens
    after the prompt, as ``examples/serve_stream.py`` pads: the
    self-attention caches get ``n`` more positions (the dense and VLM
    K/V, DeepSeek's compressed caches; the hybrid's window gets ``n``
    empty slots, ``slot_pos = -1``).  The cross K/V, RWKV6's O(1) state
    and the encoder-decoder's self-cache (its decode starts at position
    0) stay as they are.  Returns a new dict that shares the tensors it
    does not pad with ``state``; ``state`` is unchanged."""
    def pad(t):
        return F.pad(t, (0, 0, 0, n))

    fam = model.cfg.family
    if fam == "moe_mla":
        return {name: {k: pad(v) for k, v in stack.items()}
                for name, stack in state.items()}
    out = dict(state)
    if fam in ("dense", "vlm", "hybrid"):
        out["k"], out["v"] = pad(state["k"]), pad(state["v"])
    if fam == "hybrid":
        out["slot_pos"] = F.pad(state["slot_pos"], (0, n), value=-1)
    return out


@torch.no_grad()
def greedy_decode_loop(
    model: Model, params, state, first_token: Tensor, start_pos: int,
    n_tokens: int,
) -> Tuple[Tensor, Any]:
    """Host-side greedy loop for the examples (small models).

    Returns the ``(B, 1 + n_tokens)`` tokens, ``first_token`` first, and
    the state.  ``torch.argmax`` takes the first index on ties, as
    ``jnp.argmax`` does.
    """
    tok = first_token
    out = [tok]
    for i in range(n_tokens):
        logits, state = model.decode_step(params, state, tok, start_pos + i)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1), state
