"""Plain PyTorch version of the int8 matmul op (the int8 depth path).

Port of ``repro/kernels/int8_matmul/ref.py``.  Contract: ``C = A @ B``
with ``A`` int8 ``(M, K)``, ``B`` int8 ``(K, N)``, exact int32
accumulation (no saturation; |a|, |b| <= 128, so |sum| <= K * 2^14,
which fits int32 for K < 2^17).

Two framework traps: on the CPU, ``int8 @ int8`` returns int8 and wraps,
so the product is taken in int64; on a CUDA tensor PyTorch has no
integer matmul, so the product is taken in float64, which is exact here
(every partial sum is an integer below 2^53).
"""

from __future__ import annotations

import torch
from torch import Tensor


def int8_matmul_ref(a: Tensor, b: Tensor) -> Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact."""
    wide = torch.int64 if a.device.type == "cpu" else torch.float64
    return torch.matmul(a.to(wide), b.to(wide)).to(torch.int32)
