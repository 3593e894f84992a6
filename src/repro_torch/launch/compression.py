"""EF-int8 gradient exchange over a named mesh axis.

Port of ``repro/launch/compression.py``: the cross-pod hop, where DCN
bandwidth is the gradient all-reduce's bottleneck.  Each rank quantises
its gradient leaf to int8 with one float32 scale (``max|g| / 127 +
1e-12``, rounding half to even, as ``optim/compress.py`` does), all-gathers
the 4x-smaller payload and the scales over the axis, and dequantises and
averages locally in float32.  The stateless variant, as in the reference:
the error-feedback residual is ``optim/compress.py``'s to thread.

The whole tree crosses in two collectives: one int8 buffer holding every
leaf's payload and one float32 vector of the scales.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.launch import mesh as M
from repro_torch.launch.collectives import gather_blocks


def quantize(g: torch.Tensor):
    """``(q int8, scale float32 0-dim)`` of one gradient leaf."""
    gf = g.float()
    scale = torch.amax(torch.abs(gf)) / torch.tensor(
        127.0, device=gf.device) + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


@torch.no_grad()
def ef_int8_allreduce(grads: Any, axis: str, mesh=None) -> Any:
    """int8-compressed mean all-reduce of ``grads`` over mesh axis ``axis``
    of ``mesh`` (default: the ambient mesh)."""
    if mesh is None:
        amb = M.current()
        if amb is None:
            raise ValueError("ef_int8_allreduce needs a mesh: pass one or "
                             "run under launch.mesh.use_mesh")
        mesh = amb.mesh
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    leaves, spec = pytree.tree_flatten(grads)
    qs, scales = zip(*(quantize(g) for g in leaves))
    flat = torch.cat([q.flatten() for q in qs])
    scale = torch.stack(scales)
    flat_all = gather_blocks(flat, group)
    scale_all = gather_blocks(scale, group)
    out, off = [], 0
    for i, g in enumerate(leaves):
        q = flat_all[:, off:off + g.numel()].reshape((n, *g.shape))
        off += g.numel()
        rec = q.float() * scale_all[:, i].reshape((n,) + (1,) * g.ndim)
        out.append(torch.mean(rec, dim=0).to(g.dtype))
    return pytree.tree_unflatten(out, spec)

