"""LR schedules: pure functions of the step counter.

Port of ``repro/optim/schedule.py``.  Each returns a float32 tensor
computed in float32, as the reference's ``jnp`` arithmetic is; divisions
are by float32 tensors, not by Python floats, which CUDA PyTorch takes as
a product with the reciprocal.  ``device`` places an integer ``step``;
a tensor ``step`` keeps its own.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor


def _t(step, device) -> Tensor:
    return torch.as_tensor(step, dtype=torch.float32, device=device)


def warmup_cosine(
    step,
    *,
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    min_ratio: float = 0.1,
    device=None,
) -> Tensor:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``min_ratio * peak_lr`` at ``total_steps``."""
    t = _t(step, device)

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=t.device)

    warm = peak_lr * t / f32(max(1.0, warmup_steps))
    frac = torch.clamp(
        (t - warmup_steps) / f32(max(1.0, total_steps - warmup_steps)),
        0.0, 1.0)
    cos = peak_lr * (
        min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    )
    return torch.where(t < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, device=None, **_) -> Tensor:
    return torch.full_like(_t(step, device), peak_lr)
