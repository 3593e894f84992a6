"""Flash attention on the card: the wrapper of the hand-written CUDA kernels.

``flash_attention_pallas`` keeps the name and the op contract of the JAX
package's Pallas kernel (``repro/kernels/flash_attention/kernel.py``):
q ``(B, Hq, S, D)``, k / v ``(B, Hkv, S, D)``, query head ``h`` reads kv
head ``h // (Hq / Hkv)``, f32 inside, output in ``q.dtype``.  Two
instances compute it; :func:`route` picks one from the dtype and head dim,
and a refused launch raises (nothing retries on the other):

* ``"tensor_core"``: bf16 at head dims 64 and 128,
  ``csrc/flash_attention_wgmma.cu`` (wgmma products, TMA loads);
* ``"tf32"``: float32 at every head dim of :data:`HEAD_DIMS` and bf16 at
  8, 16, 32 and 160, ``csrc/flash_attention_tf32.cu`` (3xTF32 products on
  ``mma.sync``).

Each source's header says what bounds its kernel.  Both read q, k and v
through their strides (the last dim contiguous; for the tensor cores the
other strides and the base 16-byte aligned, as TMA needs), so the models'
``(B, S, H, D)`` projections seen as ``(B, H, S, D)`` go in uncopied; the
output is a ``(B, S, Hq, D)`` buffer returned as its ``(B, Hq, S, D)``
view, so merging the heads back is a reshape, not a copy.

For tensors on the CPU the wrapper takes :func:`flash_attention_plain`,
the plain PyTorch version of the same contract; for tensors on a CUDA
device it launches a kernel or raises.  ``flash_attention_pallas
.launches`` counts the launches of both instances.
:func:`flash_attention_3xtf32_plain` repeats the ``"tf32"`` kernel's
arithmetic in PyTorch (TF32 splits, tile by tile), so that the CPU shows
the decomposition holds the reference's gates.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import torch
from torch import Tensor

from repro_torch.kernels._build import (FLOAT, I64, INT, PTR, SHARED_CSRC,
                                        CudaLibrary, check, refuse_grad)

LIBRARY = CudaLibrary(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc",
    # q k v o, b hq hkv s d causal, scale, [dtype,] the (b, h, s) strides
    # of q k v o, stream
    {"fa_tf32_launch": (PTR,) * 4 + (INT,) * 6 + (FLOAT, INT)
     + (I64,) * 12 + (PTR,),
     "fa_tensor_core_launch": (PTR,) * 4 + (INT,) * 6 + (FLOAT,)
     + (I64,) * 12 + (PTR,)},
    include=(SHARED_CSRC,),
)

HEAD_DIMS = (8, 16, 32, 64, 128, 160)  # head dims some instance takes
TENSOR_CORE_HEAD_DIMS = (64, 128)  # bf16 on wgmma
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NEG_INF = -1e30
_TMA_ALIGN = 16  # bytes: TMA's rule for the base and every outer stride


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel instance that takes ``dtype`` at head dim ``d`` on the
    card: ``"tensor_core"`` or ``"tf32"``; raises for neither.

    bf16 at 64 and 128 goes to the wgmma kernel (bf16 products).  Every
    other case goes to the 3xTF32 kernel.  Plain TF32 products round their
    inputs to 10 bits (about 5e-4 relative), far past the reference's
    float32 gate of 2e-5; 3xTF32 splits each float32 operand into a TF32
    hi and lo and sums lo.hi + hi.lo + hi.hi, each product exact in the
    float32 accumulator, so only lo.lo (2^-22 relative) is lost, below
    the ulps the softmax's summation order moves.  bf16 is exact in TF32,
    so its products lose nothing.
    """
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"flash attention takes float32 or bfloat16, not "
                        f"{dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernels' {HEAD_DIMS}")
    if dtype == torch.bfloat16 and d in TENSOR_CORE_HEAD_DIMS:
        return "tensor_core"
    return "tf32"


def tf32_block_k(dtype: torch.dtype, d: int) -> int:
    """Keys of a tile of the ``"tf32"`` kernel at ``(dtype, d)`` (its
    ``Smem::kBlockK``): 32 up to head dim 64 and for float32 at 160, else
    64."""
    return 32 if d <= 64 or (dtype == torch.float32 and d > 128) else 64


def kernel_strides(t: Tensor) -> tuple:
    """The (b, h, s) element strides the kernels read ``t`` through.  A
    dim of size 1 is never stepped over, so its stride is whatever
    PyTorch left there; it becomes the contiguous one, which TMA's
    alignment rule always accepts."""
    b, h, s, d = t.shape
    contiguous = (h * s * d, s * d, d)
    return tuple(c if n == 1 else st
                 for n, st, c in zip((b, h, s), t.stride()[:3], contiguous))


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
        tensor_core = route(q.dtype, d) == "tensor_core"
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(-1) != 1:
                raise ValueError(f"{name} must be contiguous in its last dim "
                                 f"for the kernel; strides {t.stride()}")
            if tensor_core and (
                    t.data_ptr() % _TMA_ALIGN
                    or any(st <= 0 or st * t.element_size() % _TMA_ALIGN
                           for st in kernel_strides(t))):
                raise ValueError(
                    f"{name} needs a {_TMA_ALIGN}-byte aligned base and "
                    f"positive {_TMA_ALIGN}-byte aligned strides for the "
                    f"tensor-core kernel's TMA loads; strides {t.stride()}")


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


def round_tf32(x: Tensor) -> Tensor:
    """``cvt.rna.tf32.f32`` on float32 values: keep 10 mantissa bits,
    rounded to nearest with ties away from zero, by integer ops on the
    bits (adding half the unit of the 13 dropped bits to the magnitude
    carries into the kept ones; a carry out of the largest finite binade
    gives inf).  NaN stays NaN."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2**31, r - 2**32, r).to(torch.int32)
    return torch.where(torch.isnan(x), x, r.view(torch.float32))


def split_tf32(x: Tensor):
    """``x = hi + lo`` as the kernels split it (``tf32_tiles.cuh``
    ``split_tf32`` and ``split_tf32_bits`` alike): hi rounded to TF32, lo
    the float32 remainder rounded again."""
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def matmul_3xtf32(a: Tensor, b: Tensor, exact_a: bool = False,
                  exact_b: bool = False) -> Tensor:
    """``a @ b`` (float32) as the kernel's ``mma.sync`` sums it: lo.hi +
    hi.lo + hi.hi of the TF32 splits, each product exact in float32;
    ``exact_a`` / ``exact_b`` say an operand is exact in TF32 (widened
    bf16), whose lo is zero and whose products are not taken."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    out = torch.matmul(ah, bh)
    if not exact_a:
        out = torch.matmul(al, bh) + out
    if not exact_b:
        out = torch.matmul(ah, bl) + out
    return out


def flash_attention_3xtf32_plain(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
    scale: Optional[float] = None,
) -> Tensor:
    """The ``"tf32"`` kernel's arithmetic in plain PyTorch: S = Q K^T and
    O += P V in 3xTF32 (one product for bf16's exact Q K^T, two for its
    P V), the online softmax over the kernel's tiles of keys
    (:func:`tf32_block_k`) in float32, masked logits -1e30, l guarded,
    output in ``q.dtype``.  Tiles above the diagonal, which the kernel
    skips, add p = 0 here; the kernel's exp2 with log2 e folded into the
    scale is taken as exp."""
    b, hq, s, d = q.shape
    group = hq // k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    block_k = tf32_block_k(q.dtype, d)
    exact = q.dtype == torch.bfloat16
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    m = torch.full((b, hq, s, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, hq, s, 1), device=q.device)
    acc = torch.zeros((b, hq, s, d), device=q.device)
    rows = torch.arange(s, device=q.device)[:, None]
    for k0 in range(0, s, block_k):
        kt, vt = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        logits = matmul_3xtf32(qf, kt.transpose(-1, -2), exact, exact) * scale
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2], device=q.device)
            logits = logits.masked_fill(keys[None, :] > rows, _NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + matmul_3xtf32(p, vt, exact_b=exact)
        m = m_new
    out = acc / torch.where(l > 0, l, torch.ones_like(l))
    return out.to(q.dtype)


def flash_attention_pallas(
    q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
    scale: Optional[float] = None,
) -> Tensor:
    """Blockwise attention. q: (B, Hq, S, D); k/v: (B, Hkv, S, D).

    Replaces ``repro/kernels/flash_attention/kernel.py ::
    flash_attention_pallas``; the Pallas block sizes have no counterpart
    (the kernels tile for the card themselves).  On the card the result is
    the ``(B, Hq, S, D)`` view of a ``(B, S, Hq, D)`` buffer.
    """
    refuse_grad("flash_attention_pallas", q, k, v)
    check_inputs(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    b, hq, s, d = q.shape
    out = torch.empty((b, s, hq, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, k.shape[1], s, d, int(causal), float(scale))
    strides = [n for t in (q, k, v, out) for n in kernel_strides(t)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route(q.dtype, d) == "tensor_core":
        entry = "fa_tensor_core_launch"
        err = LIBRARY.library().fa_tensor_core_launch(*args, *strides, stream)
    else:
        entry = "fa_tf32_launch"
        err = LIBRARY.library().fa_tf32_launch(
            *args, _DTYPE_CODES[q.dtype], *strides, stream)
    check(err, entry)
    flash_attention_pallas.launches += 1
    return out


flash_attention_pallas.launches = 0
