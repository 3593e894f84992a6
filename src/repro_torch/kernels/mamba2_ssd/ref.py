"""Plain PyTorch oracle for the Mamba-2 SSD (state-space dual) scan.

Port of ``repro/kernels/mamba2_ssd/ref.py``: the sequential recurrence,
one step per token, with a scalar per-step decay ``a_t = exp(a_log_t)``
(a_log < 0), input projection B_t and readout C_t shared across heads
(one group), per head:

  h_t[n, p] = a_t * h_{t-1}[n, p] + B_t[n] * x_t[p]
  y_t[p]    = sum_n C_t[n] * h_t[n, p]

Shapes: x ``(B, H, T, P)``; a_log ``(B, H, T)``; Bm, Cm ``(B, T, N)``;
returns y ``(B, H, T, P)`` and the final state ``(B, H, N, P)``, float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor


def mamba2_ssd_ref(
    x: Tensor,
    a_log: Tensor,
    bm: Tensor,
    cm: Tensor,
    init_state: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    b, h, t, p = x.shape
    n = bm.shape[-1]
    if init_state is None:
        s = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    else:
        s = init_state.float()
    ys = []
    for i in range(t):
        bx = bm[:, None, i, :, None] * x[:, :, i, None, :]  # (B, H, N, P)
        s = torch.exp(a_log[:, :, i])[..., None, None] * s + bx
        ys.append(torch.einsum("bn,bhnp->bhp", cm[:, i].to(s.dtype), s))
    return torch.stack(ys, dim=2), s
