"""Functional AdamW with global-norm clipping: the EFM trainer's optimizer.

Port of ``repro/optim/adamw.py``.  Tree in, tree out, no in-place update.
Moments are float32 whatever the parameter dtype; the bias corrections
``1 - b**t`` are taken on a float32 step; clipping scales each gradient
in its own dtype; the global norm sums float32 squares leaf by leaf.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import Tensor
from torch.utils import _pytree as pytree


class AdamWState(NamedTuple):
    step: Tensor  # () int32
    mu: Any  # tree like params (float32)
    nu: Any  # tree like params (float32)


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0


def _zeros32(params: Any) -> Any:
    return pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def init(params: Any) -> AdamWState:
    """Step 0 and zero moments, on the parameters' device."""
    device = pytree.tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      _zeros32(params), _zeros32(params))


def global_norm(tree: Any) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in pytree.tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float,
                        norm: Optional[Tensor] = None) -> Tuple[Any, Tensor]:
    """``grads`` scaled to a global norm of at most ``max_norm``, and the
    norm before scaling (``norm``: given, for gradient shards)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return pytree.tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def update(
    grads: Any,
    state: AdamWState,
    params: Any,
    cfg: AdamWConfig,
    lr: Optional[Tensor] = None,  # overrides cfg.lr (schedules)
    norm: Optional[Tensor] = None,  # the global norm, when ``grads`` are
    # this rank's shards of a sharded tree
) -> Tuple[Any, AdamWState, Tensor]:
    """Returns (new_params, new_state, pre-clip grad norm)."""
    if cfg.clip_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm, norm)
    else:
        gnorm = global_norm(grads) if norm is None else norm
    step = state.step + 1
    t = step.float()
    lr_t = cfg.lr if lr is None else lr
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t

    def upd(p, g, m, v):
        gf = g.float()
        m = b1 * m + (1.0 - b1) * gf
        v = b2 * v + (1.0 - b2) * torch.square(gf)
        mhat = m / bc1
        vhat = v / bc2
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps)
        step_ = step_ + cfg.weight_decay * p.float()
        return (p.float() - lr_t * step_).to(p.dtype), m, v

    flat_p, spec = pytree.tree_flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, pytree.tree_leaves(grads), pytree.tree_leaves(state.mu),
        pytree.tree_leaves(state.nu))]
    new_p, new_m, new_v = (pytree.tree_unflatten([o[i] for o in out], spec)
                           for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), gnorm
