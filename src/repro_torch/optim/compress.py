"""Error-feedback int8 gradient compression.

Port of ``repro/optim/compress.py``:

  acc   = grad + error              # carry last round's quantisation error
  q     = round(acc / scale) int8   # per-leaf symmetric scale = max|acc|/127
  error = acc - q * scale           # error feedback (kept local, float32)

``compress`` returns (int8 tree, scales, new error state); the int8
payload is what an all-reduce would carry; ``decompress`` restores
float32.  ``torch.round`` rounds half to even, as ``jnp.round`` does, and
the scale divides by a float32 tensor (CUDA PyTorch takes a division by
a Python float as a product with its reciprocal), so payload and scales
are the reference's exactly.  ``launch/compression.py`` carries them
over a mesh axis (an all-gather of the payload and the scales).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
from torch.utils import _pytree as pytree


class EFState(NamedTuple):
    error: Any  # tree like grads (float32)


def init(params: Any) -> EFState:
    return EFState(pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def compress(grads: Any, ef: EFState) -> Tuple[Any, Any, EFState]:
    def one(g, e):
        acc = g.float() + e
        scale = torch.amax(torch.abs(acc)) / torch.tensor(
            127.0, device=acc.device) + 1e-12
        q = torch.clamp(torch.round(acc / scale), -127, 127).to(torch.int8)
        err = acc - q.float() * scale
        return q, scale, err

    leaves, spec = pytree.tree_flatten(grads)
    out = [one(g, e) for g, e in zip(leaves, pytree.tree_leaves(ef.error))]
    q, scales, err = (pytree.tree_unflatten([o[i] for o in out], spec)
                      for i in range(3))
    return q, scales, EFState(err)


def decompress(q: Any, scales: Any) -> Any:
    return pytree.tree_map(lambda qq, s: qq.float() * s, q, scales)
