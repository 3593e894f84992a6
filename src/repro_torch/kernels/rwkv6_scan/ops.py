"""Dispatching wrapper for the RWKV6 scan op, with the JAX package's keys:
``"ref"`` is the sequential oracle (``ref.py``), ``"chunked"`` the
chunked plain version (``chunked.py``), ``"pallas"`` the CUDA kernel
(``kernel.py``), which takes its plain version only for CPU tensors."""

from __future__ import annotations

from typing import Optional, Tuple

from torch import Tensor

from repro_torch.kernels.rwkv6_scan.chunked import rwkv6_scan_chunked
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

BACKENDS = ("ref", "chunked", "pallas")


def rwkv6_scan(
    r: Tensor,
    k: Tensor,
    v: Tensor,
    w_log: Tensor,
    u: Tensor,
    init_state: Optional[Tensor] = None,
    *,
    backend: str = "ref",
    chunk: int = 64,
) -> Tuple[Tensor, Tensor]:
    """RWKV6 linear-attention scan; returns (o, final_state)."""
    if backend == "ref":
        return rwkv6_scan_ref(r, k, v, w_log, u, init_state)
    if backend == "chunked":
        return rwkv6_scan_chunked(r, k, v, w_log, u, init_state, chunk=chunk)
    if backend == "pallas":
        if init_state is not None:
            raise ValueError("the pallas scan starts from a zero state; "
                             "pass init_state=None")
        return rwkv6_scan_pallas(r, k, v, w_log, u, chunk=chunk)
    raise ValueError(f"unknown backend: {backend!r}; known: {BACKENDS}")
