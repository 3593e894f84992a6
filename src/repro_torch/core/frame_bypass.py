"""Frame Bypass Check (EPIC paper, Sections 3.5 and 4.2).

Port of ``repro.core.frame_bypass``: a pixel-wise RGB difference against
a reference frame decides whether a frame is skipped before any TSRC
work; a counter guarantees one processed frame in every ``theta``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import Tensor


class BypassConfig(NamedTuple):
    gamma: float = 0.02  # mean-abs RGB difference threshold
    theta: int = 30  # max consecutive bypassed frames (safeguard)


class BypassState(NamedTuple):
    ref_frame: Tensor  # (H, W, 3) reference frame F_ref held in-sensor
    counter: Tensor  # () int32 — consecutive bypasses c
    initialized: Tensor  # () bool — first frame must always process


def init(frame_hw: Tuple[int, int], device) -> BypassState:
    h, w = frame_hw
    return BypassState(
        ref_frame=torch.zeros((h, w, 3), dtype=torch.float32, device=device),
        counter=torch.zeros((), dtype=torch.int32, device=device),
        initialized=torch.zeros((), dtype=torch.bool, device=device),
    )


def check(
    state: BypassState, frame: Tensor, cfg: BypassConfig
) -> Tuple[BypassState, Tensor, Tensor]:
    """Run the gate on one frame: ``(new_state, process, diff)``."""
    diff = (frame - state.ref_frame).abs().mean()
    exceeded = diff > cfg.gamma
    force = state.counter >= cfg.theta  # safeguard: c would exceed theta
    process = exceeded | force | ~state.initialized
    new_ref = torch.where(process, frame, state.ref_frame)
    new_counter = torch.where(
        process, torch.zeros_like(state.counter), state.counter + 1
    )
    return (
        BypassState(new_ref, new_counter, torch.ones_like(state.initialized)),
        process,
        diff,
    )
