"""Dispatching wrappers for the int8 matmul op, with the JAX package's
keys: ``"ref"`` is the plain version (``ref.py``), ``"pallas"`` the CUDA
kernel (``kernel.py``), which takes its plain version only for CPU
tensors; and for the depth network's fused convolution (``qconv.py``)."""

from __future__ import annotations

from torch import Tensor

from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas
from repro_torch.kernels.int8_matmul.qconv import (qconv_int8_pallas,
                                                   qconv_int8_ref)
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

BACKENDS = ("ref", "pallas")


def int8_matmul(a: Tensor, b: Tensor, *, backend: str = "ref") -> Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32."""
    if backend == "ref":
        return int8_matmul_ref(a, b)
    if backend == "pallas":
        return int8_matmul_pallas(a, b)
    raise ValueError(f"unknown backend: {backend!r}; known: {BACKENDS}")


def qconv_int8(x: Tensor, xscale: Tensor, qw: Tensor, wscale: Tensor,
               b: Tensor, *, stride: int = 1, relu: bool = True,
               backend: str = "ref") -> Tensor:
    """One dense or pointwise int8 layer: ``"pallas"`` is the fused launch
    (``qconv_int8_pallas``), ``"ref"`` its plain version
    (``qconv_int8_ref``)."""
    if backend == "ref":
        return qconv_int8_ref(x, xscale, qw, wscale, b, stride=stride,
                              relu=relu)
    if backend == "pallas":
        return qconv_int8_pallas(x, xscale, qw, wscale, b, stride=stride,
                                 relu=relu)
    raise ValueError(f"unknown backend: {backend!r}; known: {BACKENDS}")
