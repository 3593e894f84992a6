"""StreamPool — batched and mesh-sharded multi-stream serving (port of
``repro.api.pool``).

Wraps a compressor session over a leading stream axis: ``torch.func.vmap``
of the compressor's per-session step (:meth:`session_body`) carries every
stream's state across chunk ingests, the deployment where one card
ingests many glasses streams in lock-step.  The step makes no host sync,
and each kernel on it is a custom op whose vmap rule launches once for all
the streams (``kernels/_slots.py``), so a chunk of N streams costs the
launches of one.

**Sharded serving mode**: pass a mesh (``launch.mesh.make_stream_mesh``)
and each rank (one process per device) owns ``n_streams / axis_size``
sessions, a contiguous block along the stream axis, and steps them
through the same vmapped body; the step has no collective.  States and
stats are DTensors split over the stream axis (``full_tensor()`` gathers
them); ``step`` takes the whole chunk batch and each rank reads its rows.
The program is the unsharded pool's, so a one-device mesh is
bit-identical to ``mesh=None`` and a k-device mesh equals k independent
pools.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
from torch import Tensor
from torch.utils import _pytree as pytree

from repro_torch.api.types import SensorChunk


class StreamShard:
    """This rank's block of a stream-sharded pool: ``n`` slots or streams
    split evenly over mesh axis ``axis`` (default: the mesh's first)."""

    def __init__(self, mesh, n: int, axis: Optional[str], what: str,
                 device: torch.device):
        from repro_torch.launch import mesh as M

        names = M.mesh_axes(mesh)
        self.axis = axis if axis is not None else names[0]
        if self.axis not in names:
            raise ValueError(
                f"axis {self.axis!r} not in mesh axes {names}")
        k = M.mesh_shape(mesh)[self.axis]
        if n % k != 0:
            raise ValueError(
                f"{what}={n} must divide evenly over the {k}-way "
                f"{self.axis!r} mesh axis")
        if mesh.device_type != device.type:
            raise ValueError(
                f"a {mesh.device_type} mesh cannot serve a compressor on "
                f"{device}")
        self.mesh = mesh
        self.n_local = n // k
        self.lo = mesh.get_local_rank(self.axis) * self.n_local
        self.group = mesh.get_group(self.axis)

    def owns(self, i: int) -> bool:
        return self.lo <= i < self.lo + self.n_local

    def rows(self, x: Tensor) -> Tensor:
        """This rank's rows of a whole ``(n, ...)`` tensor."""
        return x.narrow(0, self.lo, self.n_local)

    def chunk(self, chunks: SensorChunk) -> SensorChunk:
        return SensorChunk(*(None if x is None else self.rows(x)
                             for x in chunks))

    def wrap(self, tree: Any) -> Any:
        """Local ``(n_local, ...)`` tensors as DTensors split over the
        axis."""
        from torch.distributed.tensor import DTensor

        from repro_torch.launch.sharding import P, to_placements

        placements = to_placements(P(self.axis), self.mesh)
        return tree_map(lambda x: DTensor.from_local(
            x, self.mesh, placements, run_check=False), tree)

    def gather(self, x: Tensor, dim: int = 0) -> Tensor:
        """The axis group's blocks of ``x`` concatenated along ``dim`` in
        slot order (a collective call)."""
        import torch.distributed as dist

        from repro_torch.launch.collectives import gather_blocks

        if dist.get_world_size(self.group) == 1:
            return x
        return torch.cat(gather_blocks(x, self.group).unbind(0), dim=dim)

    def broadcast(self, tree: Any, owner: int) -> Any:
        """``tree`` as the rank holding index ``owner`` has it, on every
        rank of the axis group (a collective call; the tensors are
        overwritten on the others)."""
        import torch.distributed as dist

        src = dist.get_global_rank(self.group, owner // self.n_local)

        def one(x):
            buf = x.view(torch.uint8) if x.dtype == torch.bool else x
            dist.broadcast(buf, src=src, group=self.group)
            return x

        return tree_map(one, tree)


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

    def __init__(self, compressor, n_streams: int, *, mesh=None,
                 axis: Optional[str] = None):
        _reject_k_ladder(compressor, "StreamPool")
        self.compressor = compressor
        self.n_streams = n_streams
        self.device = compressor.device
        self.mesh = mesh
        self.shard = None if mesh is None else StreamShard(
            mesh, n_streams, axis, "n_streams", self.device)
        self.axis = None if self.shard is None else self.shard.axis
        self._step = vmap_body(compressor.session_body())

    def _local(self, tree: Any) -> Any:
        from torch.distributed.tensor import DTensor

        return tree_map(
            lambda x: x.to_local() if isinstance(x, DTensor) else x, tree)

    def init(self) -> Any:
        """Stacked fresh states: one session per stream (on a mesh, this
        rank's streams, split over the stream axis)."""
        if self.shard is None:
            return stack_states(self.compressor.init(), self.n_streams)
        return self.shard.wrap(stack_states(self.compressor.init(),
                                            self.shard.n_local))

    def step(self, states: Any, chunks: SensorChunk) -> Tuple[Any, Any]:
        """Ingest one chunk per stream; returns (states, stats), each with
        the leading stream axis."""
        if chunks.frames.ndim != 5 or chunks.frames.shape[0] != self.n_streams:
            raise ValueError(
                f"StreamPool({self.n_streams}) expects chunk arrays with a "
                f"leading stream axis, frames (n_streams, T, H, W, 3); got "
                f"frames shape {tuple(chunks.frames.shape)}"
            )
        if self.shard is None:
            return self._step(states, chunks.to(self.device))
        out = self._step(self._local(states),
                         self.shard.chunk(chunks).to(self.device))
        return tuple(self.shard.wrap(x) for x in out)

    def export(self, states: Any):
        """The stacked retained records (``None`` fields stay ``None``)."""
        if self.shard is None:
            return self.compressor.export(states)
        return self.shard.wrap(self.compressor.export(self._local(states)))

    def tokens(self, states: Any, seq_len: int):
        tensors, rebuild = _split(self._local(states))
        out = torch.func.vmap(
            lambda t: self.compressor.tokens(rebuild(t), seq_len)
        )(tensors)
        return out if self.shard is None else self.shard.wrap(out)
