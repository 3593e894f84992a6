"""Adaptive patch storage -> EFM token stream (port of
``repro.core.packing``, the EPIC/EFM bridge).

Converts a retained-patch record (EPIC's DC buffer or any baseline's)
into a fixed-length token sequence an Embodied Foundation Model consumes:

  token_i = [ flattened 8x8x3 thumbnail of patch i | metadata features ]

metadata = (normalised timestamp, origin row/col, saliency,
log-popularity, normalised last use).  Tokens are ordered by timestamp
(a stable sort, as ``jnp.argsort``); invalid slots pack as zeros with a
padding mask.  When more patches than tokens are retained, the stream is
subsampled uniformly in time, with the JAX package's float32 index
arithmetic (computed on the host: the shapes are static).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import Tensor

THUMB = 8  # thumbnail side for token content features
TOKEN_FEAT = THUMB * THUMB * 3 + 6  # 198 (meta incl. t_last)


class TokenStream(NamedTuple):
    tokens: Tensor  # (L, TOKEN_FEAT) float32
    mask: Tensor  # (L,) bool


def _thumb(rgb: Tensor) -> Tensor:
    """(N, P, P, 3) -> (N, THUMB, THUMB, 3) via average pooling."""
    n, p, _, c = rgb.shape
    if p % THUMB:
        raise ValueError(f"patch {p} is not a multiple of {THUMB}")
    k = p // THUMB
    return rgb.reshape(n, THUMB, k, THUMB, k, c).mean(dim=(2, 4))


def _subsample_index(n: int, seq_len: int) -> np.ndarray:
    """``round(linspace(0, n - 1, seq_len))`` as ``jnp.linspace`` computes
    it in float32 (``stop * (i / (seq_len - 1))``, the last point exact)."""
    if seq_len == 1:
        return np.zeros(1, np.int64)
    div = np.float32(seq_len - 1)
    step = np.arange(seq_len - 1, dtype=np.float32) / div
    pts = np.append(np.float32(n - 1) * step, np.float32(n - 1))
    return np.round(pts).astype(np.int64)


def pack(
    rgb: Tensor,  # (N, P, P, 3)
    t: Tensor,  # (N,)
    origin: Tensor,  # (N, 2)
    valid: Tensor,  # (N,)
    seq_len: int,
    *,
    saliency: Optional[Tensor] = None,
    popularity: Optional[Tensor] = None,
    t_last: Optional[Tensor] = None,
    t_max=1.0,
    frame_size: float = 128.0,
) -> TokenStream:
    """Pack retained patches into a fixed-length, time-ordered token
    stream on their device.  ``t_max`` is a number or a 0-dim tensor."""
    n, dev = rgb.shape[0], rgb.device
    f32 = dict(dtype=torch.float32, device=dev)
    if saliency is None:
        saliency = torch.ones(n, **f32)
    if popularity is None:
        popularity = torch.ones(n, **f32)
    if t_last is None:
        t_last = t  # unmatched / baseline methods: last use = capture
    t_norm = torch.as_tensor(t_max, **f32).clamp_min(1.0)

    thumbs = _thumb(rgb).reshape(n, -1)
    meta = torch.stack(
        [
            t / t_norm,
            origin[:, 0] / frame_size,
            origin[:, 1] / frame_size,
            saliency,
            torch.log1p(popularity),
            t_last / t_norm,
        ],
        dim=-1,
    )
    feats = torch.cat([thumbs, meta], dim=-1)  # (N, TOKEN_FEAT)
    feats = torch.where(valid[:, None], feats, torch.zeros_like(feats))

    # Order by time; invalid entries sort last.
    key = torch.where(valid, t, torch.full_like(t, torch.inf))
    order = torch.argsort(key, stable=True)
    feats = feats[order]
    valid_sorted = valid[order]

    if n >= seq_len:
        # uniform temporal subsample (truncation would drop the stream's
        # tail and make late-segment questions unanswerable)
        idx = torch.as_tensor(_subsample_index(n, seq_len), device=dev)
        return TokenStream(feats[idx], valid_sorted[idx])
    pad = seq_len - n
    return TokenStream(
        torch.cat([feats, torch.zeros(pad, TOKEN_FEAT, **f32)], 0),
        torch.cat([valid_sorted,
                   torch.zeros(pad, dtype=torch.bool, device=dev)], 0),
    )


def pack_dc_buffer(buf, seq_len: int, t_max, frame_size: float
                   ) -> TokenStream:
    return pack(
        buf.rgb, buf.t, buf.origin, buf.valid, seq_len,
        saliency=buf.saliency, popularity=buf.popularity,
        t_last=buf.t_last, t_max=t_max, frame_size=frame_size,
    )


def pack_retained(rp, seq_len: int, t_max, frame_size: float,
                  *, saliency: Optional[Tensor] = None) -> TokenStream:
    """Pack any compressor's ``RetainedPatches`` export.

    EPIC's export carries saliency / popularity / last-use metadata;
    baselines leave those ``None`` and :func:`pack` substitutes neutral
    defaults — one tokenizer path for every method.  ``saliency``
    overrides the stored per-patch saliency (e.g. gaze proximity).
    """
    return pack(
        rp.rgb, rp.t, rp.origin, rp.valid, seq_len,
        saliency=rp.saliency if saliency is None else saliency,
        popularity=rp.popularity, t_last=rp.t_last,
        t_max=t_max, frame_size=frame_size,
    )
