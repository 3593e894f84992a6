"""Dispatching wrapper for attention (ref | pallas), with the JAX
package's keys: ``"ref"`` is the plain oracle (``ref.py``), ``"pallas"``
the CUDA kernel (``kernel.py``), which takes its plain version only for
CPU tensors."""

from __future__ import annotations

from typing import Optional

from torch import Tensor

from repro_torch.kernels.flash_attention.kernel import flash_attention_pallas
from repro_torch.kernels.flash_attention.ref import attention_ref


def attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    backend: str = "ref",
) -> Tensor:
    """GQA attention. q: (B, Hq, S, D); k/v: (B, Hkv, S, D)."""
    if backend == "ref":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if backend == "pallas":
        return flash_attention_pallas(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown backend: {backend!r}; known: 'ref', 'pallas'")
