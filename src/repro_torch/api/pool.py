"""StreamPool — batched multi-stream serving (port of ``repro.api.pool``).

Wraps a compressor session over a leading stream axis: ``torch.func.vmap``
of the compressor's per-session step (:meth:`session_body`) carries every
stream's state across chunk ingests, the deployment where one card
ingests many glasses streams in lock-step.  The step makes no host sync,
and each kernel on it is a custom op whose vmap rule launches once for all
the streams (``kernels/_slots.py``), so a chunk of N streams costs the
launches of one.

The reference's mesh-sharded mode (``shard_map`` over a stream mesh) waits
for ROADMAP.md Queue 1 item 6; passing a mesh raises.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch
from torch import Tensor
from torch.utils import _pytree as pytree

from repro_torch.api.types import SensorChunk


def _mesh_not_ported(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "stream sharding over a device mesh is not ported yet "
            "(ROADMAP.md Queue 1 item 6); serve on one card with mesh=None"
        )


def _reject_k_ladder(compressor, what: str) -> None:
    if getattr(compressor, "k_ladder", None) is not None:
        raise ValueError(
            f"{what} runs every stream in lock-step and cannot batch an "
            f"adaptive-K compressor (k_ladder is host-side, per-session "
            f"state); serve adaptive streams through "
            f"repro_torch.serve.StreamServer(ServerConfig(k_ladder=...)), "
            f"which keeps per-stream rung state over a slotted pool"
        )


def tree_map(fn: Callable, *trees: Any) -> Any:
    """``fn`` over the tensors of same-shaped state trees; ``None`` leaves
    (a baseline's absent fields) stay ``None``."""
    return pytree.tree_map(
        lambda *xs: None if xs[0] is None else fn(*xs), *trees
    )


def vmap_body(body: Callable) -> Callable:
    """``run(states, chunks)``: ``body`` (a compressor's ``session_body()``)
    vmapped over the leading stream axis of the state's tensors and of the
    chunk's; ``None`` leaves of the state and an absent depth track stay
    ``None`` for every stream."""

    def run(states: Any, chunks: SensorChunk) -> Tuple[Any, Any]:
        tensors, rebuild = _split(states)
        out = {}

        def one(tensors, frames, poses, gazes, depth):
            new, stats = body(rebuild(tensors), frames, poses, gazes, depth)
            new_tensors, out["rebuild"] = _split(new)
            return new_tensors, stats

        new_tensors, stats = torch.func.vmap(
            one, in_dims=(0, 0, 0, 0, None if chunks.depth is None else 0)
        )(tensors, *chunks)
        return out["rebuild"](new_tensors), stats

    return run


def _split(tree: Any) -> Tuple[List[Tensor], Callable]:
    """The tree's tensors (vmap takes no ``None``) and the function that
    puts a list of like tensors back in their places."""
    leaves, spec = pytree.tree_flatten(tree)

    def rebuild(tensors):
        it = iter(tensors)
        return pytree.tree_unflatten(
            [None if x is None else next(it) for x in leaves], spec)

    return [x for x in leaves if x is not None], rebuild


def stack_states(one: Any, n: int) -> Any:
    """``n`` copies of one session state along a new leading axis."""
    return tree_map(lambda x: x.unsqueeze(0).repeat(n, *([1] * x.ndim)), one)


class StreamPool:
    """A batch of ``n_streams`` independent compressor sessions.

    All methods take / return state trees whose tensors carry a leading
    ``(n_streams, ...)`` axis; :meth:`step` expects the chunk's tensors
    shaped ``(n_streams, T, ...)``.  Results equal ``n_streams`` separate
    sessions (``tests/test_torch_serve.py``).
    """

    def __init__(self, compressor, n_streams: int, *, mesh=None):
        _mesh_not_ported(mesh)
        _reject_k_ladder(compressor, "StreamPool")
        self.compressor = compressor
        self.n_streams = n_streams
        self.device = compressor.device
        self._step = vmap_body(compressor.session_body())

    def init(self) -> Any:
        """Stacked fresh states: one session per stream."""
        return stack_states(self.compressor.init(), self.n_streams)

    def step(self, states: Any, chunks: SensorChunk) -> Tuple[Any, Any]:
        """Ingest one chunk per stream; returns (states, stats), each with
        the leading stream axis."""
        if chunks.frames.ndim != 5 or chunks.frames.shape[0] != self.n_streams:
            raise ValueError(
                f"StreamPool({self.n_streams}) expects chunk arrays with a "
                f"leading stream axis, frames (n_streams, T, H, W, 3); got "
                f"frames shape {tuple(chunks.frames.shape)}"
            )
        return self._step(states, chunks.to(self.device))

    def export(self, states: Any):
        """The stacked retained records (``None`` fields stay ``None``)."""
        return self.compressor.export(states)

    def tokens(self, states: Any, seq_len: int):
        tensors, rebuild = _split(states)
        return torch.func.vmap(
            lambda t: self.compressor.tokens(rebuild(t), seq_len)
        )(tensors)
