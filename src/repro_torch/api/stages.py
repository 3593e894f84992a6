"""Stage-graph pipeline: pluggable per-frame stages (port of
``repro.api.stages``).

The per-frame work of every compression method — EPIC's bypass → depth →
HIR saliency → TSRC chain (paper Figure 3c) and the four baselines'
select → retain bodies — is an ordered composition of
:class:`FrameStage` objects threaded over a shared :class:`FrameCtx`.
Stages are built by registry name, so new stages plug in without
editing the loop.

Two framework differences: the ``lax.cond`` of :class:`Gated` is a host
``if`` on the gate (one device-to-host sync per frame), or, in its select
form, the inner stages run and ``torch.where`` picks their results or the
passed-through ones (what ``vmap`` of ``lax.cond`` computes; the serving
pool's slot-batched step uses it); and the ``lax.scan`` of
:meth:`StageGraph.scan` is a Python loop over the chunk's frames.
"""

from __future__ import annotations

from typing import (
    Any,
    Callable,
    Dict,
    NamedTuple,
    Optional,
    Protocol,
    Sequence,
    Tuple,
    runtime_checkable,
)

import torch
from torch import Tensor

from repro_torch.api.registry import register_combinator


class FrameCtx(NamedTuple):
    """Shared per-frame carry threaded through the stages of one frame.

    Sensor inputs and the frame clock ``t`` are set by the graph runner;
    stages communicate through the derived fields (``None`` until their
    producer runs) and add per-frame counters to ``stats`` (keyed by
    stage name, read by the graph's ``finalize``).
    """

    frame: Tensor  # (H, W, 3)
    pose: Tensor  # (4, 4)
    gaze: Tensor  # (2,)
    depth: Optional[Tensor]  # (H, W) oracle depth, or None
    t: Tensor  # () frame clock (graph-owned)
    process: Tensor  # () bool — downstream gate (bypass writes this)
    dmap: Optional[Tensor] = None  # (H, W) predicted/oracle depth
    sal_mask: Optional[Tensor] = None  # (G*G,) bool SRD saliency
    sal_score: Optional[Tensor] = None  # (G*G,) float saliency strength
    patches: Optional[Tensor] = None  # (K, P, P, 3) candidate patches
    origins: Optional[Tensor] = None  # (K, 2) candidate origins
    keep: Optional[Tensor] = None  # () bool — retain this frame
    stats: Dict[str, Any] = {}

    def with_stat(self, name: str, value: Any) -> "FrameCtx":
        return self._replace(stats={**self.stats, name: value})


@runtime_checkable
class FrameStage(Protocol):
    """One step of a per-frame pipeline: ``init`` gives the stage's state
    (``None`` if stateless), ``apply`` maps (state, ctx) to (state, ctx)."""

    name: str

    def init(self) -> Any:
        ...

    def apply(self, state: Any, ctx: FrameCtx) -> Tuple[Any, FrameCtx]:
        ...


def where_tree(pred: Tensor, on_true: Any, on_false: Any) -> Any:
    """``torch.where(pred, a, b)`` leaf by leaf over two trees of the same
    structure (tensors, ``None``, tuples, NamedTuples, dicts)."""
    if on_true is None:
        return None
    if isinstance(on_true, Tensor):
        return torch.where(pred, on_true, on_false)
    if isinstance(on_true, dict):
        if on_true.keys() != on_false.keys():
            raise ValueError(
                f"where_tree needs the same keys, got {sorted(on_true)} and "
                f"{sorted(on_false)}"
            )
        return {k: where_tree(pred, on_true[k], on_false[k])
                for k in on_true}
    items = [where_tree(pred, a, b) for a, b in zip(on_true, on_false)]
    if hasattr(on_true, "_fields"):  # a NamedTuple
        return type(on_true)(*items)
    return type(on_true)(items)


@register_combinator("gated")
class Gated:
    """Combinator: run ``stages`` only when ``ctx.process`` is true.

    A closed gate runs none of the inner stages' compute: their states
    pass through and ``skip_stats(states, ctx)`` supplies the stats the
    skipped stages would have emitted.  Only the inner states and stats
    leave the gate.  Reading the gate costs one device-to-host sync.

    ``select=True`` is the gate without a host read: the inner stages
    always run, and their states and stats are chosen with ``torch.where``
    against the passed-through states and ``skip_stats`` — the same values,
    with no sync, so the step can be vmapped over a batch of sessions (the
    serving pool's step; ``vmap`` of the reference's ``lax.cond`` computes
    this select too).
    """

    def __init__(
        self,
        stages: Sequence[FrameStage],
        skip_stats: Callable[[Tuple[Any, ...], FrameCtx], Dict[str, Any]],
        *,
        select: bool = False,
    ):
        self.stages = tuple(stages)
        self.skip_stats = skip_stats
        self.select = select
        self.name = "gated[" + ",".join(s.name for s in self.stages) + "]"

    def init(self) -> Tuple[Any, ...]:
        return tuple(s.init() for s in self.stages)

    def apply(
        self, states: Tuple[Any, ...], ctx: FrameCtx
    ) -> Tuple[Tuple[Any, ...], FrameCtx]:
        if not self.select and not bool(ctx.process):
            delta = self.skip_stats(states, ctx)
            return states, ctx._replace(stats={**ctx.stats, **delta})
        c = ctx._replace(stats={})
        out = []
        for stage, st in zip(self.stages, states):
            st, c = stage.apply(st, c)
            out.append(st)
        ran, delta = tuple(out), c.stats
        if self.select:
            ran = where_tree(ctx.process, ran, states)
            delta = where_tree(ctx.process, delta,
                               self.skip_stats(states, ctx))
        return ran, ctx._replace(stats={**ctx.stats, **delta})


def _stack(items: Sequence[Any]) -> Any:
    """Stack per-frame stats (NamedTuples or dicts of 0-dim tensors)."""
    first = items[0]
    if isinstance(first, Tensor):
        return torch.stack(list(items))
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    return type(first)(*(_stack(xs) for xs in zip(*items)))


class StageGraph:
    """An ordered FrameStage composition + frame clock + stats finalizer.

    The graph state is ``(per_stage_states, clock)``; the clock is a
    0-dim tensor on ``device`` made by ``clock_init`` (default float32
    zero) and advanced by ``clock_next`` after every frame (default
    ``t + 1.0``; the baselines count frames in int32).
    ``finalize(ctx) -> stats`` shapes the per-stage counters into the
    method's public per-frame stats.
    """

    def __init__(
        self,
        stages: Sequence[FrameStage],
        *,
        device,
        finalize: Optional[Callable[[FrameCtx], Any]] = None,
        clock_init: Optional[Callable[[], Tensor]] = None,
        clock_next: Callable[[Tensor], Tensor] = lambda t: t + 1.0,
    ):
        self.stages = tuple(stages)
        self.device = torch.device(device)
        self.finalize = finalize
        self.clock_init = clock_init or (
            lambda: torch.zeros((), dtype=torch.float32, device=self.device)
        )
        self.clock_next = clock_next

    # -- state management ----------------------------------------------------

    def init_state(self) -> Tuple[Tuple[Any, ...], Tensor]:
        return tuple(s.init() for s in self.stages), self.clock_init()

    def pack_state(
        self, values: Dict[str, Any], clock: Tensor
    ) -> Tuple[Tuple[Any, ...], Tensor]:
        """Assemble a graph state from named per-stage states; every
        stateful stage must be in ``values``."""
        remaining = dict(values)

        def pack(stage) -> Any:
            if isinstance(stage, Gated):
                return tuple(pack(s) for s in stage.stages)
            if stage.name in remaining:
                return remaining.pop(stage.name)
            if stage.init() is not None:
                raise KeyError(
                    f"stateful stage {stage.name!r} missing from pack_state "
                    f"values {sorted(values)}"
                )
            return None

        packed = tuple(pack(s) for s in self.stages)
        if remaining:
            raise KeyError(
                f"pack_state got values for unknown stages "
                f"{sorted(remaining)}; graph stages: {self.stage_names()}"
            )
        return packed, clock

    def unpack_state(
        self, state: Tuple[Tuple[Any, ...], Tensor]
    ) -> Tuple[Dict[str, Any], Tensor]:
        """Named per-stage states (stateful stages only) + the clock."""
        states, clock = state
        out: Dict[str, Any] = {}

        def unpack(stage, st) -> None:
            if isinstance(stage, Gated):
                for s, inner in zip(stage.stages, st):
                    unpack(s, inner)
            elif st is not None:
                out[stage.name] = st

        for stage, st in zip(self.stages, states):
            unpack(stage, st)
        return out, clock

    def stage_names(self) -> Tuple[str, ...]:
        names = []

        def walk(stage):
            if isinstance(stage, Gated):
                for s in stage.stages:
                    walk(s)
            else:
                names.append(stage.name)

        for s in self.stages:
            walk(s)
        return tuple(names)

    # -- execution -----------------------------------------------------------

    def step_frame(
        self,
        state: Tuple[Tuple[Any, ...], Tensor],
        frame: Tensor,
        pose: Tensor,
        gaze: Tensor,
        depth: Optional[Tensor] = None,
    ) -> Tuple[Tuple[Tuple[Any, ...], Tensor], Any]:
        """Run every stage on one frame; returns (state, frame stats)."""
        states, t = state
        ctx = FrameCtx(
            frame=frame,
            pose=pose,
            gaze=gaze,
            depth=depth,
            t=t,
            process=torch.ones((), dtype=torch.bool, device=self.device),
            stats={},
        )
        out = []
        for stage, st in zip(self.stages, states):
            st, ctx = stage.apply(st, ctx)
            out.append(st)
        stats = self.finalize(ctx) if self.finalize is not None else ctx.stats
        return (tuple(out), self.clock_next(t)), stats

    def scan(
        self,
        state: Tuple[Tuple[Any, ...], Tensor],
        frames: Tensor,
        poses: Tensor,
        gazes: Tensor,
        depth: Optional[Tensor] = None,
    ) -> Tuple[Tuple[Tuple[Any, ...], Tensor], Any]:
        """Run the graph over a chunk's frames in order; per-frame stats
        come back stacked along a leading time axis."""
        if frames.shape[0] == 0:
            raise ValueError("StageGraph.scan needs at least one frame")
        per_frame = []
        for i in range(frames.shape[0]):
            state, st = self.step_frame(
                state, frames[i], poses[i], gazes[i],
                None if depth is None else depth[i],
            )
            per_frame.append(st)
        return state, _stack(per_frame)
