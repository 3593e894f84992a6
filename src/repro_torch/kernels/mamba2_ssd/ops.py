"""Dispatching wrapper for the Mamba-2 SSD scan op, with the JAX package's
keys: ``"ref"`` is the sequential oracle (``ref.py``), ``"chunked"`` the
chunked plain version (``chunked.py``), ``"pallas"`` the CUDA kernel
(``kernel.py``), which takes its plain version only for CPU tensors."""

from __future__ import annotations

from typing import Optional, Tuple

from torch import Tensor

from repro_torch.kernels.mamba2_ssd.chunked import mamba2_ssd_chunked
from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_ref

BACKENDS = ("ref", "chunked", "pallas")


def mamba2_ssd(
    x: Tensor,
    a_log: Tensor,
    bm: Tensor,
    cm: Tensor,
    init_state: Optional[Tensor] = None,
    *,
    backend: str = "ref",
    chunk: int = 64,
) -> Tuple[Tensor, Tensor]:
    """Mamba-2 SSD scan; returns (y, final_state)."""
    if backend == "ref":
        return mamba2_ssd_ref(x, a_log, bm, cm, init_state)
    if backend == "chunked":
        return mamba2_ssd_chunked(x, a_log, bm, cm, init_state, chunk=chunk)
    if backend == "pallas":
        if init_state is not None:
            raise ValueError("the pallas scan starts from a zero state; "
                             "pass init_state=None")
        return mamba2_ssd_pallas(x, a_log, bm, cm, chunk=chunk)
    raise ValueError(f"unknown backend: {backend!r}; known: {BACKENDS}")
