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

:func:`mamba2_ssd_chunk_parallel` takes the same arithmetic in the four
steps the CUDA kernel spreads over (batch row, head, chunk): C B^T once
per (batch row, chunk), each chunk's own state, the state passing over
the chunks, and each chunk's output, written into a (B, T, H, P) buffer.
It is the plain version of that decomposition (the kernel wrapper's CPU
route); ``mamba2_ssd_chunked`` stays the plain version the kernel is held
against on the card.
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


def mamba2_ssd_chunk_parallel(
    x: Tensor,  # (B, H, T, P)
    a_log: Tensor,  # (B, H, T)
    bm: Tensor,  # (B, T, N)
    cm: Tensor,  # (B, T, N)
    *,
    chunk: int = 64,
) -> Tuple[Tensor, Tensor]:
    """The SSD scan from a zero state as the kernel decomposes it
    (``csrc/mamba2_ssd.cu``); ``T % min(chunk, T) == 0``.  Returns y as the
    (B, H, T, P) view of a (B, T, H, P) buffer, and the final state."""
    b, h, t, p = x.shape
    n = bm.shape[-1]
    c = min(chunk, t)
    nc = t // c
    xc = x.float().reshape(b, h, nc, c, p)
    bc = bm.float().reshape(b, nc, c, n)
    cc = cm.float().reshape(b, nc, c, n)
    (hi, lo), _ = split_cumsums(a_log.float().reshape(b, h, nc, c), dim=-1)

    # 1. Per (b, chunk), shared by the heads: G = C B^T.
    g = torch.matmul(cc, bc.transpose(-1, -2))  # (B, nc, C, C)
    # 2. Per (b, h, chunk): the chunk's own state (B exp(ca_C - ca))^T x.
    b_hat = bc[:, None] * torch.exp(
        (hi[..., -1:] - hi) + (lo[..., -1:] - lo))[..., None]
    s_own = torch.matmul(b_hat.transpose(-1, -2), xc)  # (B, H, nc, N, P)
    # 3. Per (b, h), in order: each chunk's incoming state.
    decay = torch.exp(hi[..., -1] + lo[..., -1])  # (B, H, nc)
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    incoming = []
    for i in range(nc):
        incoming.append(state)
        state = decay[..., i, None, None] * state + s_own[:, :, i]
    # 4. Per (b, h, chunk): y = (G o L) x + exp(ca) (C h_in).
    expo = torch.clamp((hi[..., :, None] - hi[..., None, :])
                       + (lo[..., :, None] - lo[..., None, :]), max=0.0)
    mask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    lmat = torch.where(mask, torch.exp(expo), torch.zeros_like(expo))
    c_dec = cc[:, None] * torch.exp(hi + lo)[..., None]  # (B, H, nc, C, N)
    y = torch.matmul(g[:, None] * lmat, xc) + torch.matmul(
        c_dec, torch.stack(incoming, dim=2))
    out = torch.empty((b, t, h, p), dtype=torch.float32, device=x.device)
    out.view(b, nc, c, h, p).copy_(y.permute(0, 2, 3, 1, 4))
    return out.transpose(1, 2), state
