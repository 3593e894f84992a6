"""Plain PyTorch oracle for blockwise (flash) attention.

Port of ``repro/kernels/flash_attention/ref.py``; the contract shared with
the kernel:

  * q: (B, Hq, S, D), k/v: (B, Hkv, S, D) with Hq % Hkv == 0 (GQA — each
    group of Hq/Hkv query heads reads one kv head).
  * optional causal mask; softmax scale 1/sqrt(D) unless overridden.
  * output: (B, Hq, S, D) float32.

As in the reference, the logits are formed in the inputs' dtype before
the f32 softmax; the kernel (``kernel.py``) forms them in f32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor


def attention_ref(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tensor:
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"query heads {hq} are not a multiple of kv heads {hkv}")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kr = k.repeat_interleave(group, dim=1)  # jnp.repeat: head h reads h // group
    vr = v.repeat_interleave(group, dim=1)
    logits = torch.matmul(q, kr.transpose(-1, -2)).float() * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, vr.float())
