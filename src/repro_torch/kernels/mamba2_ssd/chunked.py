"""Chunked (matmul-form) Mamba-2 SSD scan in plain PyTorch.

Port of ``repro/kernels/mamba2_ssd/chunked.py``.  The SSD recurrence with
a scalar per-step decay a_t = exp(a_log_t) factors into dense products
over chunks of C tokens (the "state space dual" block decomposition):

  intra:  y_t += sum_{s<=t} exp(A_t - A_s) (C_t . B_s) x_s
  inter:  y_t += exp(A_t) * C_t @ S0
  state:  S'   = exp(A_C) S0 + sum_s exp(A_C - A_s) B_s x_s^T

A is the inclusive within-chunk cumsum of a_log (< 0); every exponent is
<= 0, so the float32 arithmetic cannot overflow.  It is the plain version
the CUDA kernel (``kernel.py``) is held against.

One departure from the reference, for accuracy: A is taken in float64 and
kept as a float32 pair ``hi + lo`` (``kernels/_cumsum.py``), and each
difference as ``(hi_t - hi_s) + (lo_t - lo_s)``.  With a float32 A a
strong decay (a_log = -exp(2 z)) put the kernel and this form 3.2e-4
apart on an H100 at the reference test's (2, 4, 256, 64, 64) shape
(``chip_smoke.py`` phase 13), each summing its float32 cumsum in another
order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.kernels._cumsum import split_cumsums


def mamba2_ssd_chunked(
    x: Tensor,  # (B, H, T, P)
    a_log: Tensor,  # (B, H, T)
    bm: Tensor,  # (B, T, N)
    cm: Tensor,  # (B, T, N)
    init_state: Optional[Tensor] = None,
    *,
    chunk: int = 64,
) -> Tuple[Tensor, Tensor]:
    b, h, t, p = x.shape
    n = bm.shape[-1]
    c = min(chunk, t)
    t_pad = -(-t // c) * c
    if t_pad != t:
        # zero-x / zero-a_log padding steps are identities on the state
        x = F.pad(x, (0, 0, 0, t_pad - t))
        a_log = F.pad(a_log, (0, t_pad - t))
        bm = F.pad(bm, (0, 0, 0, t_pad - t))
        cm = F.pad(cm, (0, 0, 0, t_pad - t))
    t_full, t = t, t_pad
    nc = t // c

    xc = x.float().reshape(b, h, nc, c, p)
    ac = a_log.float().reshape(b, h, nc, c)
    bc = bm.float().reshape(b, nc, c, n)
    cc = cm.float().reshape(b, nc, c, n)

    (acum, alo), _ = split_cumsums(ac, dim=-1)  # inclusive (B,H,nc,C)
    # decay factors D[t,s] = exp(A_t - A_s), s <= t (else masked)
    expo = torch.clamp((acum[..., :, None] - acum[..., None, :])
                       + (alo[..., :, None] - alo[..., None, :]), max=0.0)
    mask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    d = torch.where(mask, torch.exp(expo), torch.zeros_like(expo))
    g = torch.matmul(cc, bc.transpose(-1, -2))  # (B,nc,C,C) shared heads
    y_intra = torch.matmul(g[:, None] * d, xc)

    a_last = acum[..., -1] + alo[..., -1]  # (B,H,nc)
    c_dec = cc[:, None] * torch.exp(acum + alo)[..., None]  # (B,H,nc,C,N)
    b_hat = bc[:, None] * torch.exp(
        (acum[..., -1:] - acum) + (alo[..., -1:] - alo))[..., None]

    if init_state is None:
        s = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    else:
        s = init_state.float()
    y_inter = []
    for i in range(nc):
        y_inter.append(torch.matmul(c_dec[:, :, i], s))
        s = torch.exp(a_last[:, :, i])[..., None, None] * s + torch.matmul(
            b_hat[:, :, i].transpose(-1, -2), xc[:, :, i])
    y = y_intra + torch.stack(y_inter, dim=2)
    return y.reshape(b, h, t, p)[:, :, :t_full], s
