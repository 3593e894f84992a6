"""int8 matmul on the card: the wrapper of the hand-written CUDA kernel.

``int8_matmul_pallas`` keeps the name and the op contract of the JAX
package's Pallas kernel (``repro/kernels/int8_matmul/kernel.py``):
``(M, K) int8 x (K, N) int8 -> (M, N) int32``, exact.  It launches
``csrc/int8_matmul.cu`` (int8 tensor-core products), whose header says
what bounds the kernel; the Pallas tile sizes and its zero-padding have
no counterpart (the kernel masks the ragged edges itself).  The same
library holds the fused convolution behind ``qconv.py``.

For tensors on the CPU the wrapper takes :func:`int8_matmul_ref`, the
plain version; for tensors on a CUDA device it launches the kernel or
raises.  ``int8_matmul_pallas.launches`` counts its kernel launches.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import Tensor

from repro_torch.kernels._build import (INT, PTR, CudaLibrary, check,
                                        refuse_grad)
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

LIBRARY = CudaLibrary(
    "int8_matmul",
    Path(__file__).resolve().parent / "csrc",
    # a b c, m k n, stream
    {"int8_matmul_launch": (PTR, PTR, PTR, INT, INT, INT, PTR),
     # x xscale w wscale bias y, batch h w cin cout ks stride relu
     # per_image, stream
     "qconv_int8_launch": (PTR,) * 6 + (INT,) * 9 + (PTR,)},
)

# |a|, |b| <= 128: K * 2^14 must stay below 2^31 (ref.py's overflow bound).
MAX_K = 1 << 17


def check_inputs(a: Tensor, b: Tensor) -> None:
    """Raise on inputs outside the op's contract or that the kernel does
    not take."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(
            f"a and b must be 2-D, got {tuple(a.shape)} and {tuple(b.shape)}"
        )
    (m, k), (k2, n) = a.shape, b.shape
    if k != k2:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if min(m, k, n) < 1:
        raise ValueError(f"empty product: M={m}, K={k}, N={n}")
    if k >= MAX_K:
        raise ValueError(f"K={k} >= 2^17 could overflow the int32 sums")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"a and b must be int8, got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a and b lie on different devices: {a.device}, "
                         f"{b.device}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8 matmul runs on cpu or cuda, not {a.device}")
    if a.device.type == "cuda":
        for name, t in (("a", a), ("b", b)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous for the kernel")


def int8_matmul_pallas(a: Tensor, b: Tensor) -> Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact.

    Replaces ``repro/kernels/int8_matmul/kernel.py :: int8_matmul_pallas``.
    """
    refuse_grad("int8_matmul_pallas", a, b)
    check_inputs(a, b)
    if a.device.type == "cpu":
        return int8_matmul_ref(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    err = LIBRARY.library().int8_matmul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    check(err, "int8_matmul_launch")
    int8_matmul_pallas.launches += 1
    return out


int8_matmul_pallas.launches = 0
