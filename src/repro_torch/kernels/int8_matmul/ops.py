"""Dispatching wrapper for the int8 matmul op, with the JAX package's
keys: ``"ref"`` is the plain version (``ref.py``), ``"pallas"`` the CUDA
kernel (``kernel.py``), which takes its plain version only for CPU
tensors."""

from __future__ import annotations

from torch import Tensor

from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

BACKENDS = ("ref", "pallas")


def int8_matmul(a: Tensor, b: Tensor, *, backend: str = "ref") -> Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32."""
    if backend == "ref":
        return int8_matmul_ref(a, b)
    if backend == "pallas":
        return int8_matmul_pallas(a, b)
    raise ValueError(f"unknown backend: {backend!r}; known: {BACKENDS}")
