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

:func:`rwkv6_scan_chunk_parallel` takes the same arithmetic in the steps
the CUDA kernel spreads over (chunk, head, batch row): each chunk's own
state, the state passing over the chunks, and each chunk's output, whose
pair weights come by secondary chunking.  The chunk is cut into leaves of
:data:`LEAF` rows, whose pairs are taken in log space; the pairs of two
leaves are taken level by level, in blocks of 2h rows (h = LEAF, 2 LEAF,
...): for t in a block's upper half and s in its lower half, with e the
lower half's last row, exp(We_t - W_s) = exp(We_t - W_e) exp(W_e - W_s),
both factors <= 1, so the pairs are one product of a scaled r and a
scaled k.  The exclusive cumsum is the inclusive one shifted by a row.  It
writes o into a (B, T, H, V) buffer.  It is the plain version of that
decomposition (the kernel wrapper's CPU route); ``rwkv6_scan_chunked``
stays the plain version the kernel is held against on the card.
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


LEAF = 8  # rows of A's diagonal sub-blocks; csrc/rwkv6_scan.cu's kLeaf


def rwkv6_scan_chunk_parallel(
    r: Tensor, k: Tensor, v: Tensor, w_log: Tensor, u: Tensor, *,
    chunk: int = 32,
) -> Tuple[Tensor, Tensor]:
    """The RWKV6 scan from a zero state as the kernel decomposes it
    (``csrc/rwkv6_scan.cu``); ``T % min(chunk, T) == 0``.  Returns o as the
    (B, H, T, V) view of a (B, T, H, V) buffer, and the final state."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    c = min(chunk, t)
    nc = t // c

    def cshape(x, d):
        return x.float().reshape(b, h, nc, c, d)

    rc, kc, vc = cshape(r, dk), cshape(k, dk), cshape(v, dv)
    (wh, wl), _ = split_cumsums(cshape(w_log, dk), dim=-2)
    eh, el = (F.pad(x[..., :-1, :], (0, 0, 1, 0)) for x in (wh, wl))  # We

    # 1. Per (b, h, chunk): the chunk's own state and its decay.
    k_hat = kc * torch.exp((wh[..., -1:, :] - wh) + (wl[..., -1:, :] - wl))
    s_own = torch.matmul(k_hat.transpose(-1, -2), vc)  # (B, H, nc, K, V)
    decay = torch.exp(wh[..., -1, :] + wl[..., -1, :])  # (B, H, nc, K)
    # 2. Per (b, h), in order: each chunk's incoming state.
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    incoming = []
    for i in range(nc):
        incoming.append(state)
        state = decay[..., i, :, None] * state + s_own[:, :, i]
    # 3. Per (b, h, chunk): A, then o = A v + (r e^We) S_in.
    a = torch.zeros((b, h, nc, c, c), dtype=torch.float32, device=r.device)
    for i0 in range(0, c, LEAF):  # the leaves, in log space
        leaf = slice(i0, min(i0 + LEAF, c))
        expo = torch.clamp(
            (eh[..., leaf, None, :] - wh[..., None, leaf, :])
            + (el[..., leaf, None, :] - wl[..., None, leaf, :]), max=0.0)
        pairs = torch.einsum("...tk,...sk,...tsk->...ts", rc[..., leaf, :],
                             kc[..., leaf, :], torch.exp(expo))
        a[..., leaf, leaf] = torch.tril(pairs, diagonal=-1)
    half = LEAF
    while half < c:  # pairs of leaves, by the halves of blocks of 2 half
        for base in range(0, c - half, 2 * half):
            lower = slice(base, base + half)
            upper = slice(base + half, min(base + 2 * half, c))
            e = slice(base + half - 1, base + half)
            r_b = rc[..., upper, :] * torch.exp(
                (eh[..., upper, :] - wh[..., e, :])
                + (el[..., upper, :] - wl[..., e, :]))
            k_b = kc[..., lower, :] * torch.exp(
                (wh[..., e, :] - wh[..., lower, :])
                + (wl[..., e, :] - wl[..., lower, :]))
            a[..., upper, lower] = torch.matmul(r_b, k_b.transpose(-1, -2))
        half *= 2
    bonus = torch.einsum("bhntk,hk,bhntk->bhnt", rc, u.float(), kc)
    a = a + torch.diag_embed(bonus)
    r_dec = rc * torch.exp(eh + el)
    o = torch.matmul(a, vc) + torch.matmul(r_dec, torch.stack(incoming, dim=2))
    out = torch.empty((b, t, h, dv), dtype=torch.float32, device=r.device)
    out.view(b, nc, c, h, dv).copy_(o.permute(0, 2, 3, 1, 4))
    return out.transpose(1, 2), state
