"""The RWKV6 scan on the card: the wrapper of the hand-written CUDA kernel.

``rwkv6_scan_pallas`` keeps the name and the op contract of the JAX
package's Pallas kernel (``repro/kernels/rwkv6_scan/kernel.py``): r, k,
w_log ``(B, H, T, K)``, v ``(B, H, T, V)``, u ``(H, K)``, from a zero
state, ``T % min(chunk, T) == 0``; returns o ``(B, H, T, V)`` and the
final state ``(B, H, K, V)``, both float32.  It launches
``csrc/rwkv6_scan.cu`` (three kernels: the chunks' own states, the state
passing, the outputs, the last once per 64 channels of K; counted as one
launch of the op), whose header says what bounds it.  The kernel reads r, k, v and w_log through their
strides, so the model's ``(B, T, H, K)`` tensors seen as ``(B, H, T, K)``
go in uncopied; their last dim must be contiguous.  o is written into a
``(B, T, H, V)`` buffer and returned as its ``(B, H, T, V)`` view, so the
model's transpose back is a view too.

For tensors on the CPU the wrapper takes
:func:`rwkv6_scan_chunk_parallel`, the plain version of the kernel's
decomposition; for tensors on a CUDA device it launches the kernel or
raises.  ``rwkv6_scan_pallas.launches`` counts its launches.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import torch
from torch import Tensor

from repro_torch.kernels._build import (I64, INT, PTR, SHARED_CSRC,
                                        CudaLibrary, check, refuse_grad)
from repro_torch.kernels.rwkv6_scan.chunked import rwkv6_scan_chunk_parallel

LIBRARY = CudaLibrary(
    "rwkv6_scan",
    Path(__file__).resolve().parent / "csrc",
    # r k v w u o s, scratch: states decay; b h t dk dv chunk, the (b, h, t)
    # strides of r k v w, dtype, stream
    {"rwkv6_scan_launch": (PTR,) * 9 + (INT,) * 6 + (I64,) * 12
     + (INT, PTR)},
    include=(SHARED_CSRC,),
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 64  # a CTA's tile: chunk rows


def check_inputs(r: Tensor, k: Tensor, v: Tensor, w_log: Tensor, u: Tensor,
                 chunk: int) -> None:
    """Raise on inputs outside the op's contract (as the Pallas wrapper
    asserts) or that the kernel does not take."""
    if r.ndim != 4 or v.ndim != 4 or u.ndim != 2:
        raise ValueError(f"r, v must be 4-D and u 2-D, got {tuple(r.shape)}, "
                         f"{tuple(v.shape)}, {tuple(u.shape)}")
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if tuple(k.shape) != tuple(r.shape) or tuple(w_log.shape) != tuple(r.shape):
        raise ValueError(f"k {tuple(k.shape)} and w_log {tuple(w_log.shape)} "
                         f"must be shaped as r {tuple(r.shape)}")
    if tuple(v.shape[:3]) != (b, h, t) or tuple(u.shape) != (h, dk):
        raise ValueError(f"v {tuple(v.shape)} must be ({b}, {h}, {t}, V) and "
                         f"u {tuple(u.shape)} ({h}, {dk})")
    if min(b, h, t, dk, dv) == 0:
        raise ValueError(f"empty scan: r {tuple(r.shape)}, v {tuple(v.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk {chunk} < 1")
    c = min(chunk, t)
    if t % c:
        raise ValueError(f"T={t} breaks the contract T % min(chunk, T) == 0 "
                         f"(chunk {chunk})")
    if r.dtype not in _DTYPE_CODES or any(
            x.dtype != r.dtype for x in (k, v, w_log)):
        raise TypeError(f"r, k, v, w_log must share one of float32, "
                        f"bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{w_log.dtype}")
    if u.dtype not in _DTYPE_CODES:
        raise TypeError(f"u must be float32 or bfloat16, not {u.dtype}")
    devices = {x.device for x in (r, k, v, w_log, u)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"the rwkv6 scan runs on cpu or cuda, not {device}")
    if device.type == "cuda":
        if c > MAX_CHUNK:
            raise ValueError(f"chunk {c} above the kernel's {MAX_CHUNK}")
        for name, x in (("r", r), ("k", k), ("v", v), ("w_log", w_log)):
            if x.stride(-1) != 1:
                raise ValueError(f"{name} must be contiguous in its last dim "
                                 f"for the kernel; strides {x.stride()}")


def rwkv6_scan_pallas(
    r: Tensor, k: Tensor, v: Tensor, w_log: Tensor, u: Tensor, *,
    chunk: int = 64,
) -> Tuple[Tensor, Tensor]:
    """Chunked RWKV6 scan from a zero state -> (o, final state), float32.

    Replaces ``repro/kernels/rwkv6_scan/kernel.py :: rwkv6_scan_pallas``.
    """
    refuse_grad("rwkv6_scan_pallas", r, k, v, w_log, u)
    check_inputs(r, k, v, w_log, u, chunk)
    if r.device.type == "cpu":
        return rwkv6_scan_chunk_parallel(r, k, v, w_log, u, chunk=chunk)
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    c = min(chunk, t)
    nc = t // c

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=r.device)

    o, s = f32(b, t, h, dv), f32(b, h, dk, dv)
    states, decay = f32(b, h, nc, dk, dv), f32(b, h, nc, dk)
    # (H, K): a few hundred values, read as contiguous float32
    uf = u.float().contiguous()
    err = LIBRARY.library().rwkv6_scan_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
        uf.data_ptr(), o.data_ptr(), s.data_ptr(), states.data_ptr(),
        decay.data_ptr(), b, h, t, dk, dv, c,
        *(n for x in (r, k, v, w_log) for n in x.stride()[:3]),
        _DTYPE_CODES[r.dtype], torch.cuda.current_stream(r.device).cuda_stream,
    )
    check(err, "rwkv6_scan_launch")
    rwkv6_scan_pallas.launches += 1
    return o.transpose(1, 2), s


rwkv6_scan_pallas.launches = 0
