"""Flash attention on the card: the wrapper of the hand-written CUDA kernel.

``flash_attention_pallas`` keeps the name and the op contract of the JAX
package's Pallas kernel (``repro/kernels/flash_attention/kernel.py``):
q ``(B, Hq, S, D)``, k / v ``(B, Hkv, S, D)``, query head ``h`` reads kv
head ``h // (Hq / Hkv)``, f32 inside, output in ``q.dtype``.  It launches
``csrc/flash_attention.cu``, whose header says what bounds the kernel.

For tensors on the CPU the wrapper takes :func:`flash_attention_plain`,
the plain PyTorch version of the same contract; for tensors on a CUDA
device it launches the kernel or raises.  ``flash_attention_pallas
.launches`` counts its kernel launches.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import torch
from torch import Tensor

from repro_torch.kernels._build import FLOAT, INT, PTR, CudaLibrary, check

LIBRARY = CudaLibrary(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc",
    # q k v o, b hq hkv s d causal, scale, dtype, stream
    {"fa_forward_launch": (PTR,) * 4 + (INT,) * 6 + (FLOAT, INT, PTR)},
)

HEAD_DIMS = (8, 16, 32, 64, 128)  # the kernel's template instances
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30


def check_inputs(q: Tensor, k: Tensor, v: Tensor) -> None:
    """Raise on inputs outside the op's contract (as the Pallas wrapper
    asserts) or that the kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q, k, v must be 4-D (B, H, S, D), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if tuple(k.shape) != (b, hkv, s, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(
            f"k and v must be (B, Hkv, S, D) = ({b}, Hkv, {s}, {d}), got "
            f"{tuple(k.shape)} and {tuple(v.shape)}"
        )
    if min(b, hq, d) == 0:
        raise ValueError(f"empty q {tuple(q.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"query heads {hq} are not a multiple of kv heads {hkv}")
    if s == 0 or s % min(128, s):
        raise ValueError(
            f"sequence length {s} breaks the contract S % min(128, S) == 0"
        )
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must share one of float32, bfloat16; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q, k, v lie on different devices: {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda, not {device}")
    if device.type == "cuda":
        if d not in HEAD_DIMS:
            raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous for the kernel")


def flash_attention_plain(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
    scale: Optional[float] = None,
) -> Tensor:
    """The kernel's contract in plain PyTorch: f32 logits, masked with
    -1e30, softmax normalised by a guarded sum, output in ``q.dtype``."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, _NEG_INF)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, vf) / torch.where(l > 0, l, torch.ones_like(l))
    return out.to(q.dtype)


def flash_attention_pallas(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
    scale: Optional[float] = None,
) -> Tensor:
    """Blockwise attention. q: (B, Hq, S, D); k/v: (B, Hkv, S, D).

    Replaces ``repro/kernels/flash_attention/kernel.py ::
    flash_attention_pallas``; the Pallas block sizes have no counterpart
    (the kernel tiles for the card itself).
    """
    check_inputs(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    b, hq, s, d = q.shape
    out = torch.empty_like(q)
    err = LIBRARY.library().fa_forward_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, hq, k.shape[1], s, d, int(causal), float(scale),
        _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err, "fa_forward_launch")
    flash_attention_pallas.launches += 1
    return out


flash_attention_pallas.launches = 0
