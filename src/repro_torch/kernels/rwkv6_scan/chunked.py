"""Chunked (matmul-form) RWKV6 scan in plain PyTorch.

Port of ``repro/kernels/rwkv6_scan/chunked.py``.  C tokens at a time go
through dense products, and the (K, V) state is carried across chunks by
a loop of T/C steps:

  intra-chunk:  o_t += sum_{s<t} (r_t . exp(We_t - W_s) . k_s) v_s
                + (r_t . u . k_t) v_t                               (bonus)
  inter-chunk:  o_t += (r_t * exp(We_t)) @ S0
  state:        S'  = diag(exp(W_C)) S0 + (k_s * exp(W_C - W_s))^T v

W is the within-chunk inclusive cumsum of w_log (< 0), We the exclusive
one.  Every exponent above is <= 0, so the float32 arithmetic cannot
overflow, whatever the decay (splitting exp(We_t - W_s) into
exp(We_t) * exp(-W_s), as the Pallas kernel does, can).  It is the plain
version the CUDA kernel (``kernel.py``) is held against.

One departure from the reference, for accuracy: the cumsums are taken in
float64 and kept as float32 pairs ``hi + lo`` (``kernels/_cumsum.py``),
and each exponent is ``(hi_t - hi_s) + (lo_t - lo_s)``.  With float32
cumsums a strong decay (w_log = -exp(2 z)) puts this form further from
the sequential oracle than the reference's gate of 2e-4 allows, as the
reference's own ``test_rwkv6_chunked_matches_ref`` finds on some draws.
The products stay float32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from repro_torch.kernels._cumsum import split_cumsums


def rwkv6_scan_chunked(
    r: Tensor,
    k: Tensor,
    v: Tensor,
    w_log: Tensor,
    u: Tensor,
    init_state: Optional[Tensor] = None,
    *,
    chunk: int = 32,
) -> Tuple[Tensor, Tensor]:
    """Same contract as ``rwkv6_scan_ref``. r/k/w_log: (B,H,T,K); v: (B,H,T,V)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    c = min(chunk, t)
    t_pad = -(-t // c) * c
    if t_pad != t:
        # zero-k / zero-w_log padding steps are identities on the state
        r, k, v, w_log = (F.pad(a, (0, 0, 0, t_pad - t))
                          for a in (r, k, v, w_log))
    t_full, t = t, t_pad
    nc = t // c

    def cshape(x, d):
        return x.float().reshape(b, h, nc, c, d)

    rc, kc, wc = cshape(r, dk), cshape(k, dk), cshape(w_log, dk)
    vc = cshape(v, dv)
    uf = u.float()  # (H, K)

    (w_in, w_in_lo), (w_ex, w_ex_lo) = split_cumsums(wc, dim=-2)
    # log-space intra-chunk pair weights; exponent <= 0 for s < t by
    # construction, the clamp guards the (unused) upper triangle.
    expo = torch.clamp(
        (w_ex[..., :, None, :] - w_in[..., None, :, :])
        + (w_ex_lo[..., :, None, :] - w_in_lo[..., None, :, :]), max=0.0)
    # P[t,s] = sum_k r[t,k] k[s,k] exp(We[t,k]-W[s,k])
    p = torch.einsum("bhntk,bhnsk,bhntsk->bhnts", rc, kc, torch.exp(expo))
    mask = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)
    o_intra = torch.matmul(torch.where(mask, p, torch.zeros_like(p)), vc)
    bonus = torch.einsum("bhntk,hk,bhntk->bhnt", rc, uf, kc)
    o_intra = o_intra + bonus[..., None] * vc

    r_dec = rc * torch.exp(w_ex + w_ex_lo)  # queries decayed to chunk start
    w_last = w_in[..., -1, :] + w_in_lo[..., -1, :]  # (B,H,nc,K) chunk decay
    k_hat = kc * torch.exp(  # keys decayed to chunk end
        (w_in[..., -1:, :] - w_in) + (w_in_lo[..., -1:, :] - w_in_lo))

    if init_state is None:
        s = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    else:
        s = init_state.float()
    o_inter = []
    for n in range(nc):
        o_inter.append(torch.matmul(r_dec[:, :, n], s))
        s = torch.exp(w_last[:, :, n])[..., None] * s + torch.matmul(
            k_hat[:, :, n].transpose(-1, -2), vc[:, :, n])
    o = o_intra + torch.stack(o_inter, dim=2)
    return o.reshape(b, h, t, dv)[:, :, :t_full], s
