"""Streaming ``Compressor`` protocol and EPIC's implementation (port of
``repro.api.compressor``; the baselines and ``tokens()`` come later).

  ``init() -> state``                 a fresh session state;
  ``step(state, chunk) -> (state, stats)``
                                      ingest a :class:`SensorChunk`; the
                                      carry is the whole state, so chunked
                                      ingest equals one-shot ingest;
  ``export(state) -> RetainedPatches`` the retained representation.
"""

from __future__ import annotations

from typing import Any, Optional, Protocol, Tuple, runtime_checkable

from repro_torch import resolve_device
from repro_torch.api.registry import register_compressor
from repro_torch.api.types import SensorChunk, concat_stats, iter_chunks
from repro_torch.core import dc_buffer as dcb
from repro_torch.core import pipeline as pipe
from repro_torch.core import retained as ret


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
    float32; the models must already live there.  ``k_ladder`` (adaptive
    K) is not ported yet and raises ``NotImplementedError``.
    """

    def __init__(
        self,
        cfg: pipe.EPICConfig,
        models: Optional[pipe.EPICModels] = None,
        *,
        device=None,
        k_ladder: Optional[Tuple[int, ...]] = None,
    ):
        if k_ladder is not None:
            raise NotImplementedError(
                "k_ladder (adaptive K, serve/adaptive.py) is not ported yet"
            )
        self.cfg = cfg
        self.models = pipe.EPICModels() if models is None else models
        self.device = resolve_device(device)
        for model in self.models:
            if model is not None and any(
                p.device != self.device for p in model.parameters()
            ):
                raise ValueError(
                    f"{type(model).__name__} is not on the compressor's "
                    f"device {self.device}"
                )

    def init(self) -> pipe.EPICState:
        return pipe.init_state(self.cfg, self.device)

    def step(
        self, state: pipe.EPICState, chunk: SensorChunk
    ) -> Tuple[pipe.EPICState, pipe.FrameStats]:
        chunk = chunk.validate().to(self.device)
        return pipe.scan_frames(
            state,
            chunk.frames,
            chunk.poses,
            chunk.gazes,
            chunk.depth,
            self.models,
            self.cfg,
        )

    def export(self, state: pipe.EPICState) -> ret.RetainedPatches:
        return dcb.to_retained(state.buf)
