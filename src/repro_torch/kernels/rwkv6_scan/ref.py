"""Plain PyTorch oracle for the RWKV6 (Finch) linear-attention scan.

Port of ``repro/kernels/rwkv6_scan/ref.py``: the sequential recurrence,
one step per token, with a data-dependent per-channel decay
``w_t = exp(w_log_t)`` (w_log < 0) and a bonus ``u``, per head:

  o_t[j]   = sum_i r_t[i] * ( S_{t-1}[i, j] + u[i] k_t[i] v_t[j] )
  S_t[i,j] = w_t[i] * S_{t-1}[i, j] + k_t[i] v_t[j]

Shapes: r, k, w_log ``(B, H, T, K)``; v ``(B, H, T, V)``; u ``(H, K)``;
returns o ``(B, H, T, V)`` and the final state ``(B, H, K, V)``, both
float32.  The products ``k v`` and ``u k v`` round in the inputs' dtype
and meet the float32 state there, as JAX's type promotion has them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor


def rwkv6_scan_ref(
    r: Tensor,
    k: Tensor,
    v: Tensor,
    w_log: Tensor,
    u: Tensor,
    init_state: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if init_state is None:
        s = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    else:
        s = init_state.float()
    uu = u[None, :, :, None]
    outs = []
    for i in range(t):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]  # (B, H, K, V)
        m = s + uu * kv  # float32, as JAX promotes
        o = torch.einsum("bhk,bhkv->bhv", r[:, :, i].to(m.dtype), m)
        s = torch.exp(w_log[:, :, i])[..., None] * s + kv
        outs.append(o)
    return torch.stack(outs, dim=2), s
