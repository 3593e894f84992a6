"""The Mamba-2 SSD scan on the card: the wrapper of the hand-written CUDA
kernel.

``mamba2_ssd_pallas`` keeps the name and the op contract of the JAX
package's Pallas kernel (``repro/kernels/mamba2_ssd/kernel.py``): x
``(B, H, T, P)``, a_log ``(B, H, T)``, B and C ``(B, T, N)`` shared across
heads, from a zero state, ``T % min(chunk, T) == 0``; returns y
``(B, H, T, P)`` and the final state ``(B, H, N, P)``, both float32.  It
launches ``csrc/mamba2_ssd.cu`` (three kernels: the chunks' own states and
C Bᵀ, the state passing, the outputs; counted as one launch of the op),
whose header says what bounds it.  The kernel reads its inputs through
their strides, so the model's ``(B, T, H, P)`` tensors seen as
``(B, H, T, P)`` go in uncopied; the last dim of x, B and C must be
contiguous.  y is written into a ``(B, T, H, P)`` buffer and returned as
its ``(B, H, T, P)`` view, so the model's transpose back is a view too.

For tensors on the CPU the wrapper takes :func:`mamba2_ssd_chunk_parallel`,
the plain version of the kernel's decomposition; for tensors on a CUDA
device it launches the kernel or raises.  ``mamba2_ssd_pallas.launches``
counts its launches.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch
from torch import Tensor

from repro_torch.kernels._build import (I64, INT, PTR, SHARED_CSRC,
                                        CudaLibrary, check, refuse_grad)
from repro_torch.kernels.mamba2_ssd.chunked import mamba2_ssd_chunk_parallel

LIBRARY = CudaLibrary(
    "mamba2_ssd",
    Path(__file__).resolve().parent / "csrc",
    # x a b c y h, scratch: states gbuf decay; b nh t p n chunk, the strides
    # of x a (b, h, t) and of b c (b, t), dtype, stream
    {"mamba2_ssd_launch": (PTR,) * 9 + (INT,) * 6 + (I64,) * 10
     + (INT, PTR)},
    include=(SHARED_CSRC,),
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 64  # a CTA's tile: chunk rows
MAX_STATE = 64  # and N rows of the state


def check_inputs(x: Tensor, a_log: Tensor, bm: Tensor, cm: Tensor,
                 chunk: int) -> None:
    """Raise on inputs outside the op's contract (as the Pallas wrapper
    asserts) or that the kernel does not take."""
    if x.ndim != 4 or a_log.ndim != 3 or bm.ndim != 3:
        raise ValueError(f"x must be 4-D, a_log and B 3-D; got "
                         f"{tuple(x.shape)}, {tuple(a_log.shape)}, "
                         f"{tuple(bm.shape)}")
    b, h, t, p = x.shape
    n = bm.shape[-1]
    if tuple(a_log.shape) != (b, h, t):
        raise ValueError(f"a_log {tuple(a_log.shape)} must be ({b}, {h}, {t})")
    if tuple(bm.shape[:2]) != (b, t) or tuple(cm.shape) != tuple(bm.shape):
        raise ValueError(f"B {tuple(bm.shape)} and C {tuple(cm.shape)} must "
                         f"both be ({b}, {t}, N)")
    if min(b, h, t, p, n) == 0:
        raise ValueError(f"empty scan: x {tuple(x.shape)}, B {tuple(bm.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk {chunk} < 1")
    c = min(chunk, t)
    if t % c:
        raise ValueError(f"T={t} breaks the contract T % min(chunk, T) == 0 "
                         f"(chunk {chunk})")
    if x.dtype not in _DTYPE_CODES or any(
            y.dtype != x.dtype for y in (a_log, bm, cm)):
        raise TypeError(f"x, a_log, B, C must share one of float32, "
                        f"bfloat16; got {x.dtype}, {a_log.dtype}, "
                        f"{bm.dtype}, {cm.dtype}")
    devices = {y.device for y in (x, a_log, bm, cm)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the SSD scan runs on cpu or cuda, not {device}")
    if device.type == "cuda":
        if c > MAX_CHUNK:
            raise ValueError(f"chunk {c} above the kernel's {MAX_CHUNK}")
        if n > MAX_STATE:
            raise ValueError(f"N={n} above the kernel's {MAX_STATE}")
        for name, y in (("x", x), ("B", bm), ("C", cm)):
            if y.stride(-1) != 1:
                raise ValueError(f"{name} must be contiguous in its last dim "
                                 f"for the kernel; strides {y.stride()}")


def mamba2_ssd_pallas(
    x: Tensor, a_log: Tensor, bm: Tensor, cm: Tensor, *, chunk: int = 64,
) -> Tuple[Tensor, Tensor]:
    """Chunked SSD scan from a zero state -> (y, final state), float32.

    Replaces ``repro/kernels/mamba2_ssd/kernel.py :: mamba2_ssd_pallas``.
    """
    refuse_grad("mamba2_ssd_pallas", x, a_log, bm, cm)
    check_inputs(x, a_log, bm, cm, chunk)
    if x.device.type == "cpu":
        return mamba2_ssd_chunk_parallel(x, a_log, bm, cm, chunk=chunk)
    b, h, t, p = x.shape
    n = bm.shape[-1]
    c = min(chunk, t)
    nc = t // c

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    y, s = f32(b, t, h, p), f32(b, h, n, p)
    states, gbuf, decay = f32(b, h, nc, n, p), f32(b, nc, c, c), f32(b, h, nc)
    err = LIBRARY.library().mamba2_ssd_launch(
        x.data_ptr(), a_log.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        y.data_ptr(), s.data_ptr(), states.data_ptr(), gbuf.data_ptr(),
        decay.data_ptr(), b, h, t, p, n, c, *x.stride()[:3],
        *a_log.stride(), *bm.stride()[:2], *cm.stride()[:2],
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(err, "mamba2_ssd_launch")
    mamba2_ssd_pallas.launches += 1
    return y.transpose(1, 2), s


mamba2_ssd_pallas.launches = 0
