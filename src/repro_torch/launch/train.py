"""The train step: loss and gradient, accumulation, AdamW on a schedule.

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
  * AdamW with the warmup-cosine schedule, global-norm clipping and the
    moment-dtype knob (moments cast to float32 for the update and back).

Nothing is updated in place: the caller's trees stay as they were.  The
EF-int8 gradient exchange (``grad_axis``), ZeRO-1 gradient specs
(``grad_specs``) and the sharded ``jit_train_step`` need a device mesh
(``ROADMAP.md`` Queue 1 item 6) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor
from torch.utils import _pytree as pytree

from repro_torch.models.model import Model
from repro_torch.optim import adamw, schedule

_MESH = ("needs a device mesh, which is not ported yet (ROADMAP.md, "
         "Queue 1 item 6)")


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
    grad_axis: Optional[str] = None,
    grad_specs: Any = None,
):
    if grad_axis is not None:
        raise NotImplementedError(f"the EF-int8 gradient exchange {_MESH}")
    if grad_specs is not None:
        raise NotImplementedError(f"ZeRO-1 gradient specs {_MESH}")
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

    def train_step(params, opt_state, batch, step):
        loss, grads = grads_of(params, batch)
        lr = schedule.warmup_cosine(
            step,
            peak_lr=opt_cfg.lr,
            warmup_steps=warmup_steps,
            total_steps=total_steps,
            device=model.device,
        )
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


def jit_train_step(model: Model, mesh, opt_cfg: adamw.AdamWConfig, **_):
    """The reference's pjit-ed step with its shardings: not ported."""
    raise NotImplementedError(f"the sharded train step {_MESH}")
