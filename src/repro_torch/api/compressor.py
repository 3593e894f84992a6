"""Streaming ``Compressor`` protocol and its five implementations, EPIC
and the four baselines FV / SD / TD / GC (port of
``repro.api.compressor``).

  ``init() -> state``                 a fresh session state;
  ``step(state, chunk) -> (state, stats)``
                                      ingest a :class:`SensorChunk`; the
                                      carry is the whole state, so chunked
                                      ingest equals one-shot ingest;
  ``export(state) -> RetainedPatches`` the retained representation;
  ``tokens(state, seq_len) -> TokenStream``
                                      the EFM-ready token stream
                                      (``core/packing.py``).
"""

from __future__ import annotations

import itertools
from typing import (
    Any, NamedTuple, Optional, Protocol, Tuple, runtime_checkable,
)

import torch
from torch import Tensor

from repro_torch import resolve_device
from repro_torch.api import registry as registry_mod
from repro_torch.api import stages as stage_mod
from repro_torch.api.registry import register_compressor
from repro_torch.api.types import SensorChunk, concat_stats, iter_chunks
from repro_torch.core import baselines
from repro_torch.core import dc_buffer as dcb
from repro_torch.core import packing
from repro_torch.core import pipeline as pipe
from repro_torch.core import retained as ret
from repro_torch.serve.adaptive import make_controller


@runtime_checkable
class Compressor(Protocol):
    """Method-agnostic streaming compressor session protocol."""

    name: str

    def init(self) -> Any:
        ...

    def step(self, state: Any, chunk: SensorChunk) -> Tuple[Any, Any]:
        ...

    def export(self, state: Any) -> ret.RetainedPatches:
        ...

    def tokens(self, state: Any, seq_len: int) -> packing.TokenStream:
        ...


def run_session(
    comp: Compressor,
    stream: SensorChunk,
    chunk_size: Optional[int] = None,
) -> Tuple[Any, Any]:
    """Ingest a materialized stream through one fresh session, in chunks of
    ``chunk_size`` (``None``: one step).  Returns ``(final_state, stats)``
    with the stats concatenated over the stream."""
    state = comp.init()
    stats = []
    for chunk in iter_chunks(stream, chunk_size or max(stream.n_frames, 1)):
        state, cs = comp.step(state, chunk)
        stats.append(cs)
    return state, concat_stats(stats)


@register_compressor("epic")
class EPICCompressor:
    """EPIC (paper Figure 3c) behind the session protocol.

    ``device=None`` runs on the CUDA card and raises without one; pass
    ``device="cpu"`` for the CPU.  Chunks are moved to the device as
    float32; the models (a ``DepthNet`` or an int8 ``QuantizedParams``,
    an ``HIRNet``) must already live there, parameters and buffers.

    Adaptive K (``k_ladder``, e.g. ``(8, 16, 24, 48)``): a host-side
    :class:`~repro_torch.serve.adaptive.KLadderController` walks
    ``cfg.prefilter_k`` across the rungs between chunks — one rung up
    when the chunk overflowed its candidate budget, one down when its
    peak ``n_full_checks`` fits the rung below with ``shrink_margin``x
    room.  Each visited rung keeps its fixed-K config for the session;
    the rule reads two counters per chunk in one host sync, and
    ``k_trajectory`` lists the K of every past chunk.  The rung is
    per-session state on the instance: one compressor per stream.
    """

    def __init__(
        self,
        cfg: pipe.EPICConfig,
        models: Optional[pipe.EPICModels] = None,
        *,
        device=None,
        k_ladder: Optional[Tuple[int, ...]] = None,
        shrink_margin: int = 2,
    ):
        self.cfg = cfg
        self.models = pipe.EPICModels() if models is None else models
        self.device = resolve_device(device)
        for model in self.models:
            if model is not None and any(
                t.device != self.device
                for t in itertools.chain(model.parameters(), model.buffers())
            ):
                raise ValueError(
                    f"{type(model).__name__} is not on the compressor's "
                    f"device {self.device}"
                )
        self._ctl = make_controller(
            k_ladder,
            start_k=cfg.prefilter_k,
            shrink_margin=shrink_margin,
            what="cfg.prefilter_k",
        )
        self.k_ladder = None if self._ctl is None else self._ctl.ladder
        self.shrink_margin = shrink_margin
        self._rung_cfgs: dict = {}  # K -> the fixed-K config of that rung

    @property
    def k_trajectory(self) -> list:
        """K used by each past chunk, in order (adaptive K only)."""
        return self._ctl.k_trajectory

    def init(self) -> pipe.EPICState:
        return pipe.init_state(self.cfg, self.device)

    def step(
        self, state: pipe.EPICState, chunk: SensorChunk
    ) -> Tuple[pipe.EPICState, pipe.FrameStats]:
        chunk = chunk.validate().to(self.device)
        if self._ctl is None:
            return self._scan(self.cfg, state, chunk)
        k = self._ctl.begin_chunk()
        cfg_k = self._rung_cfgs.get(k)
        if cfg_k is None:
            cfg_k = self._rung_cfgs[k] = self.cfg._replace(prefilter_k=k)
        state, stats = self._scan(cfg_k, state, chunk)
        overflow, peak_full = torch.stack([
            stats.n_prefilter_overflow.sum(dtype=torch.int64),
            stats.n_full_checks.max().to(torch.int64),
        ]).tolist()  # one host sync per chunk
        self._ctl.update(overflow, peak_full)
        return state, stats

    def session_body(self):
        """The per-session chunk step for a slot-batched pool:
        ``body(state, frames, poses, gazes, depth) -> (state, stats)`` on
        tensors already on the device, with the bypass gate in its select
        form and the graph built once, so that a call makes no host sync and
        ``torch.func.vmap`` batches it over the slots.  An adaptive-K
        compressor has none: its rung moves on the host between chunks."""
        if self._ctl is not None:
            raise ValueError(
                "an adaptive-K compressor walks its rung on the host between "
                "chunks and has no batchable step; serve adaptive streams "
                "through repro_torch.serve.StreamServer("
                "ServerConfig(k_ladder=...))"
            )
        return pipe.scan_body(self.cfg, self.models, self.device)

    def _scan(self, cfg, state, chunk):
        return pipe.scan_frames(
            state,
            chunk.frames,
            chunk.poses,
            chunk.gazes,
            chunk.depth,
            self.models,
            cfg,
        )

    def export(self, state: pipe.EPICState) -> ret.RetainedPatches:
        return dcb.to_retained(state.buf)

    def tokens(
        self, state: pipe.EPICState, seq_len: int
    ) -> packing.TokenStream:
        return packing.pack_dc_buffer(
            state.buf, seq_len, state.t, float(self.cfg.frame_hw[0])
        )


# ---------------------------------------------------------------------------
# Streaming baselines
# ---------------------------------------------------------------------------


class BaselineConfig(NamedTuple):
    """Static configuration shared by the four streaming baselines.

    ``budget_patches`` is the retained-patch capacity (the "matched
    memory budget" of Table 1); ``-1`` means unbounded, i.e. capacity for
    every patch of an ``n_frames``-long stream (the FV reference).
    ``n_frames`` is the nominal stream length used for per-frame budget
    splits (SD/GC) and the temporal stride (TD); streams may run longer,
    and ingestion stops retaining once the budget is exhausted.
    """

    frame_hw: Tuple[int, int] = (64, 64)
    patch: int = 16
    budget_patches: int = -1
    n_frames: int = 40

    @property
    def grid(self) -> int:
        if self.frame_hw[0] != self.frame_hw[1]:
            raise ValueError(f"square frames assumed, got {self.frame_hw}")
        return self.frame_hw[0] // self.patch

    @property
    def per_frame(self) -> int:
        return self.grid * self.grid

    @property
    def capacity(self) -> int:
        if self.budget_patches > 0:
            return self.budget_patches
        return self.n_frames * self.per_frame


class BaselineState(NamedTuple):
    """Carried session state of a streaming baseline."""

    rp: ret.RetainedPatches  # fixed-capacity retained buffer
    cursor: Tensor  # () int32 — next write slot (counts past capacity)
    frame_idx: Tensor  # () int32 — frames ingested so far


class BaselineFrameStats(NamedTuple):
    """Per-frame counters (mirrors the shape contract of FrameStats)."""

    processed: Tensor  # bool — frame contributed retained patches
    n_inserted: Tensor  # int32 — patches written this frame
    buffer_valid: Tensor  # int32 — occupancy after the frame


class _StreamingBaseline:
    """Stage-graph baseline: subclasses name their per-frame selection
    stage in ``_select_spec``; the graph is ``select.* -> retain`` with an
    int32 frame clock, and its state is exactly the
    :class:`BaselineState` fields ``(rp, cursor, frame_idx)``.

    ``device=None`` runs on the CUDA card and raises without one.
    """

    name = "base"

    def __init__(self, cfg: BaselineConfig, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def _select_spec(self) -> Tuple[str, dict]:
        """Registry name + kwargs of the per-frame selection stage."""
        raise NotImplementedError

    def _graph(self) -> stage_mod.StageGraph:
        name, kwargs = self._select_spec()
        stages = [
            registry_mod.make_stage(name, **kwargs),
            registry_mod.make_stage(
                "retain", capacity=self.cfg.capacity, patch=self.cfg.patch,
                device=self.device,
            ),
        ]
        return stage_mod.StageGraph(
            stages,
            device=self.device,
            finalize=lambda ctx: BaselineFrameStats(*ctx.stats["retain"]),
            clock_init=lambda: torch.zeros((), dtype=torch.int32,
                                           device=self.device),
            clock_next=lambda t: t + 1,
        )

    def _to_graph_state(self, graph, state: BaselineState):
        return graph.pack_state(
            {"retain": (state.rp, state.cursor)}, state.frame_idx
        )

    def _from_graph_state(self, graph, gstate) -> BaselineState:
        named, frame_idx = graph.unpack_state(gstate)
        rp, cursor = named["retain"]
        return BaselineState(rp=rp, cursor=cursor, frame_idx=frame_idx)

    def init(self) -> BaselineState:
        graph = self._graph()
        return self._from_graph_state(graph, graph.init_state())

    @torch.no_grad()
    def step(
        self, state: BaselineState, chunk: SensorChunk
    ) -> Tuple[BaselineState, BaselineFrameStats]:
        chunk = chunk.validate().to(self.device)
        graph = self._graph()
        gstate, stats = graph.scan(
            self._to_graph_state(graph, state),
            chunk.frames,
            chunk.poses,
            chunk.gazes,
            chunk.depth,
        )
        return self._from_graph_state(graph, gstate), stats

    def session_body(self):
        """The per-session chunk step for a slot-batched pool (see
        :meth:`EPICCompressor.session_body`): the graph built once, no host
        sync."""
        graph = self._graph()

        @torch.no_grad()
        def body(state, frames, poses, gazes, depth):
            gstate, stats = graph.scan(
                self._to_graph_state(graph, state), frames, poses, gazes,
                depth,
            )
            return self._from_graph_state(graph, gstate), stats

        return body

    def export(self, state: BaselineState) -> ret.RetainedPatches:
        return state.rp

    def tokens(
        self, state: BaselineState, seq_len: int
    ) -> packing.TokenStream:
        return packing.pack_retained(
            state.rp,
            seq_len,
            state.frame_idx.to(torch.float32),
            float(self.cfg.frame_hw[0]),
        )


@register_compressor("fv")
class FullVideo(_StreamingBaseline):
    """FV: retain every patch of every frame (memory-unbounded reference)."""

    def _select_spec(self):
        return "select.fv", dict(patch=self.cfg.patch)


@register_compressor("td")
class TemporalDown(_StreamingBaseline):
    """TD: keep every k-th frame at full resolution, k set by the budget."""

    def _select_spec(self):
        n_keep = max(1, self.cfg.capacity // self.cfg.per_frame)
        stride = max(1, self.cfg.n_frames // n_keep)
        return "select.td", dict(
            patch=self.cfg.patch, stride=stride, n_keep=n_keep
        )


class _PerFrameBudget(_StreamingBaseline):
    """Shared sizing for the two per-frame-budget baselines (SD / GC)."""

    @property
    def _gg(self) -> int:
        cfg = self.cfg
        return baselines.per_frame_grid(cfg.n_frames, cfg.grid, cfg.capacity)


@register_compressor("sd")
class SpatialDown(_PerFrameBudget):
    """SD: keep all frames, each downsampled to fit the per-frame budget."""

    def _select_spec(self):
        return "select.sd", dict(
            patch=self.cfg.patch, gg=self._gg, frame_hw=self.cfg.frame_hw
        )


@register_compressor("gc")
class GazeCrop(_PerFrameBudget):
    """GC: a budget-sized square crop centred at the gaze point."""

    def _select_spec(self):
        crop = min(self._gg * self.cfg.patch, self.cfg.frame_hw[0])
        return "select.gc", dict(
            patch=self.cfg.patch, crop=crop, frame_hw=self.cfg.frame_hw
        )
