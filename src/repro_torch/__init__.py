"""EPIC in PyTorch for NVIDIA Hopper: the port of the JAX package ``repro``.

The package mirrors ``src/repro`` file for file and imports nothing from
it, nor JAX.  The reproject-match, flash-attention, int8 matmul, RWKV6
scan and Mamba-2 SSD scan kernels are hand-written CUDA
(``kernels/*/csrc``, built by ``kernels/_build.py``); everything else is
plain PyTorch.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``: :func:`resolve_device` raises when no card is present
rather than carrying on on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    A CUDA device without an index gets the current one, so devices
    compare equal to those of tensors allocated on them.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                "pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
