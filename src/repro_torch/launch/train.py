"""The train step: loss and gradient, accumulation, AdamW on a schedule,
and its sharded form over a device mesh.

Port of ``repro/launch/train.py``.  ``make_train_step(model, ...)`` builds
``(params, opt_state, batch, step) -> (params, opt_state, metrics)``:

  * the family's ``loss_fn`` (MoE aux and MTP terms included) and its
    gradient by ``torch.autograd.grad`` over detached copies of the
    parameters that require grad (``torch.func`` does not compose with
    activation checkpointing); with ``accum=1`` the gradients keep the
    parameters' dtype, as ``jax.value_and_grad`` gives them;
  * optional microbatch accumulation: the batch's leading axis split in
    ``accum``, gradients summed in float32 from zeros and scaled by
    ``1/accum``, as the reference's ``lax.scan`` does;
  * optional EF-int8 gradient exchange over a named axis of the ambient
    mesh (``grad_axis``; ``launch/compression.py``);
  * AdamW with the warmup-cosine schedule, global-norm clipping and the
    moment-dtype knob (moments cast to float32 for the update and back).

Nothing is updated in place: the caller's trees stay as they were.

**The sharded step** (``grad_specs``, and :func:`jit_train_step`, which
places its inputs).  One process per device; parameters are DTensors
placed by ``param_specs``, the moments by ``opt_specs`` (ZeRO-1), the
batch by ``batch_specs``.  Each rank runs the family's code on its own
batch rows, on plain tensors: every parameter gathered whole
(``full_tensor()``), except the MoE expert stacks under ``moe_impl="ep"``,
which stay this rank's EP shard while ``moe_ffn_ep`` moves the tokens.
The rank's loss is the mean over its rows; the step's gradient is that of
the mean over the global batch, so each leaf's gradient is summed over
every rank holding a copy (from ``Partial`` onto the moments' placement:
a reduce-scatter where ZeRO-1 shards it) and divided by the number of
ranks.  AdamW updates the local shards (the global norm from every
shard's squares), and the parameters are re-placed by their spec.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import Tensor
from torch.utils import _pytree as pytree

from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.models.model import Model
from repro_torch.models.moe import _ep_names
from repro_torch.optim import adamw, schedule


def cast_moments(state: adamw.AdamWState, dtype) -> adamw.AdamWState:
    return adamw.AdamWState(
        step=state.step,
        mu=pytree.tree_map(lambda x: x.to(dtype), state.mu),
        nu=pytree.tree_map(lambda x: x.to(dtype), state.nu),
    )


def init_train_state(
    model: Model, generator: torch.Generator, *, moment_dtype=torch.float32
) -> Tuple[Any, adamw.AdamWState]:
    params = model.init(generator)
    opt = adamw.init(params)
    if moment_dtype != torch.float32:
        opt = cast_moments(opt, moment_dtype)
    return params, opt


def value_and_grad(loss_fn, params: Any,
                   batch: Dict[str, Tensor]) -> Tuple[Tensor, Any]:
    """``(loss, d loss / d params)``, the gradients in ``params``' tree and
    dtypes (zeros for a leaf the loss does not read)."""
    leaves, spec = pytree.tree_flatten(params)
    live = [x.detach().requires_grad_(True) for x in leaves]
    with torch.enable_grad():
        loss = loss_fn(pytree.tree_unflatten(live, spec), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def make_train_step(
    model: Model,
    opt_cfg: adamw.AdamWConfig,
    *,
    accum: int = 1,
    warmup_steps: int = 200,
    total_steps: int = 10_000,
    grad_axis: Optional[str] = None,  # EF-int8 exchange axis
    grad_specs: Any = None,  # the moments' NamedShardings: the sharded step
):
    loss_fn = model.loss_fn

    def grads_of(params, batch):
        if accum == 1:
            return value_and_grad(loss_fn, params, batch)
        mbs = pytree.tree_map(
            lambda x: x.reshape((accum, x.shape[0] // accum) + x.shape[1:]),
            batch)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        g = pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)
        for i in range(accum):
            loss_i, g_i = value_and_grad(
                loss_fn, params, pytree.tree_map(lambda x: x[i], mbs))
            loss = loss + loss_i
            g = pytree.tree_map(lambda a, b: a + b, g, g_i)
        inv = 1.0 / accum
        return loss * inv, pytree.tree_map(lambda x: x * inv, g)

    def lr_of(step):
        return schedule.warmup_cosine(
            step,
            peak_lr=opt_cfg.lr,
            warmup_steps=warmup_steps,
            total_steps=total_steps,
            device=model.device,
        )

    if grad_specs is not None:
        return _sharded_step(model, opt_cfg, grads_of, lr_of, grad_axis,
                             grad_specs)

    def train_step(params, opt_state, batch, step):
        loss, grads = grads_of(params, batch)
        if grad_axis is not None:
            from repro_torch.launch.compression import ef_int8_allreduce

            grads = ef_int8_allreduce(grads, grad_axis)
        lr = lr_of(step)
        mdt = pytree.tree_leaves(opt_state.mu)[0].dtype
        with torch.no_grad():
            new_params, new_opt, gnorm = adamw.update(
                grads, cast_moments(opt_state, torch.float32), params,
                opt_cfg, lr=lr)
        if mdt != torch.float32:
            new_opt = cast_moments(new_opt, mdt)
        metrics = {"loss": loss, "gnorm": gnorm, "lr": lr}
        return new_params, new_opt, metrics

    return train_step


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------


def _is_ep_shard(cfg, path, p, mesh) -> bool:
    """Whether a parameter DTensor is an expert stack sharded over exactly
    the EP axes (its local block is this rank's EP shard)."""
    from torch.distributed.tensor import Replicate, Shard

    if cfg.moe_impl != "ep" or S._key_str(path[-1]) not in S.EXPERT_NAMES:
        return False
    ep = _ep_names(cfg)
    axes = M.mesh_axes(mesh)
    if any(n not in axes for n in ep) or M.axes_size(mesh, ep) == 1:
        return False
    shards = {pl.dim for pl in p.placements if isinstance(pl, Shard)}
    return shards == {p.ndim - 3} and all(  # (..., E, D, F): E
        isinstance(pl, Shard) == (name in ep)
        and isinstance(pl, (Shard, Replicate))
        for name, pl in zip(axes, p.placements))


def _batch_axes(batch, mesh) -> Tuple[str, ...]:
    from torch.distributed.tensor import Shard

    tokens = batch["tokens"]
    return tuple(n for n, pl in zip(M.mesh_axes(mesh), tokens.placements)
                 if isinstance(pl, Shard) and pl.dim == 0)


def _sharded_step(model, opt_cfg, grads_of, lr_of, grad_axis, grad_specs):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate

    cfg = model.cfg
    targets = pytree.tree_leaves(grad_specs)
    if not all(isinstance(t, S.NamedSharding) for t in targets):
        raise TypeError("grad_specs is a tree of launch.sharding."
                        "NamedSharding (launch.sharding.named)")
    mesh = targets[0].mesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"the sharded step runs on a DeviceMesh, not "
                        f"{type(mesh).__name__}")
    axes = M.mesh_axes(mesh)
    n_ranks = mesh.size()
    everyone = M.axis_group(mesh, axes)
    if grad_axis is not None and grad_axis not in axes:
        raise ValueError(f"grad_axis {grad_axis!r} not in mesh axes {axes}")

    def train_step(params, opt_state, batch, step):
        flat, spec = pytree.tree_flatten_with_path(params)
        targets = S.leaves_like(params, grad_specs)
        ep = [_is_ep_shard(cfg, path, p, mesh) for path, p in flat]
        plain = [p.to_local() if e else p.full_tensor()
                 for (_, p), e in zip(flat, ep)]
        b_axes = _batch_axes(batch, mesh)
        local_batch = {k: v.to_local() for k, v in batch.items()}
        with M.use_mesh(mesh, b_axes):
            loss, grads = grads_of(pytree.tree_unflatten(plain, spec),
                                   local_batch)
        loss = loss.clone()
        dist.all_reduce(loss, group=everyone)
        loss = loss / n_ranks
        grads = pytree.tree_leaves(grads)
        exchanged = [False] * len(grads)
        if grad_axis is not None:
            from repro_torch.launch.compression import ef_int8_allreduce

            if any(e and grad_axis in _ep_names(cfg) for e in ep):
                raise ValueError(
                    f"grad_axis {grad_axis!r} shards the expert stacks; "
                    f"their shards cannot be averaged over it")
            grads = ef_int8_allreduce(grads, grad_axis, mesh)
            exchanged = [True] * len(grads)

        g_local, p_local, target_pl = [], [], []
        for (_, p), g, e, x, tgt in zip(flat, grads, ep, exchanged, targets):
            src = []
            for name, pl in zip(axes, p.placements):
                if e and name in _ep_names(cfg):
                    src.append(pl)
                elif x and name == grad_axis:
                    src.append(Replicate())
                else:
                    src.append(Partial("sum"))
            copies = n_ranks // math.prod(
                mesh.size(i) for i, pl in enumerate(src)
                if isinstance(pl, Replicate))
            want = tgt.placements
            g = DTensor.from_local(g, mesh, src, run_check=False)
            for i in range(len(axes)):  # one collective a mesh dim
                g = g.redistribute(mesh, want[:i + 1] + tuple(src[i + 1:]))
            g = g.to_local()
            g_local.append(g if copies == 1 else g / copies)
            p_local.append(p.redistribute(mesh, want).to_local())
            target_pl.append(want)

        # The global norm: each shard's squares, counted once over the
        # ranks that hold a copy of it.
        sq = 0
        for g, want in zip(g_local, target_pl):
            part = torch.sum(torch.square(g.float()))
            rep = math.prod(mesh.size(i) for i, pl in enumerate(want)
                            if isinstance(pl, Replicate))
            sq = sq + (part if rep == 1 else part / rep)
        dist.all_reduce(sq, group=everyone)
        gnorm = torch.sqrt(sq)

        def local(x):
            return x.to_local() if isinstance(x, DTensor) else x

        mdt = pytree.tree_leaves(opt_state.mu)[0].dtype
        state = adamw.AdamWState(
            local(opt_state.step),
            [local(m).float() for m in S.leaves_like(params, opt_state.mu)],
            [local(v).float() for v in S.leaves_like(params, opt_state.nu)])
        lr = lr_of(step)
        with torch.no_grad():
            new_p, new_opt, gnorm = adamw.update(
                g_local, state, p_local, opt_cfg, lr=lr, norm=gnorm)
        rep = [Replicate()] * len(axes)
        new_params = pytree.tree_unflatten([
            DTensor.from_local(x, mesh, want, run_check=False).redistribute(
                mesh, p.placements)
            for x, want, (_, p) in zip(new_p, target_pl, flat)], spec)

        def moments(xs):
            return pytree.tree_unflatten([
                DTensor.from_local(x.to(mdt), mesh, want, run_check=False)
                for x, want in zip(xs, target_pl)], spec)

        new_state = adamw.AdamWState(
            DTensor.from_local(new_opt.step, mesh, rep, run_check=False),
            moments(new_opt.mu), moments(new_opt.nu))
        metrics = {"loss": loss, "gnorm": gnorm, "lr": lr}
        return new_params, new_state, metrics

    return train_step


def jit_train_step(
    model: Model,
    mesh,
    opt_cfg: adamw.AdamWConfig,
    *,
    shape_spec,
    moment_dtype=torch.float32,
    accum: int = 1,
    donate: bool = True,
    **step_kw,
):
    """The sharded train step and its specs: ``(step_fn, {"params", "opt",
    "batch"})``.

    ``step_fn(params, opt_state, batch, step)`` takes the trees
    :func:`init_train_state` gives (whole tensors, identical on every
    rank: each keeps its own block, with no communication) or the placed
    trees a previous call returned, and the global batch (each rank takes
    its rows); it returns parameters and moments as DTensors placed by the
    specs.  With ``accum`` > 1 each microbatch is a block of the global
    batch's rows split over the ranks, as in the reference.
    ``moment_dtype`` is set at init (the specs are the same);
    ``donate`` is the reference's buffer donation, which eager PyTorch
    does not need: the step frees its inputs' copies as it goes.
    """
    cfg = model.cfg
    pshape = model.param_spec()
    pspecs = S.param_specs(cfg, pshape, mesh)
    ospecs = S.opt_specs(cfg, pshape, mesh)
    bspecs = S.batch_specs(cfg, shape_spec, mesh)
    step = make_train_step(model, opt_cfg, accum=accum,
                           grad_specs=S.named(mesh, ospecs.mu), **step_kw)
    on_params = S.named(mesh, pspecs)
    on_opt = S.named(mesh, ospecs)
    on_batch = S.named(mesh, bspecs)
    n_rows = M.axes_size(mesh, S.spec_axes(bspecs["tokens"][0]))

    def microbatch_major(x):
        """Rows reordered so that each rank's ``accum`` local microbatches
        are its blocks of the global ones: microbatch i is the global
        batch's i-th block of rows, split over the ranks, as the
        reference's step splits a sharded batch."""
        if accum == 1 or n_rows == 1 or type(x) is not torch.Tensor:
            return x  # one microbatch, one row block, or placed already
        lead = (accum, n_rows, x.shape[0] // (accum * n_rows))
        return x.reshape(lead + x.shape[1:]).transpose(0, 1).reshape(x.shape)

    def step_fn(params, opt_state, batch, step_i):
        batch = {k: microbatch_major(v) for k, v in batch.items()}
        return step(S.place_tree(params, on_params),
                    S.place_tree(opt_state, on_opt),
                    S.place_tree(batch, on_batch), step_i)

    return step_fn, {"params": pspecs, "opt": ospecs, "batch": bspecs}
