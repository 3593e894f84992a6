"""repro_torch.api — the streaming compressor API of the port.

  SensorChunk, iter_chunks, concat_stats      (types)
  FrameCtx, FrameStage, Gated, StageGraph     (stages)
  Compressor, EPICCompressor, run_session,
  BaselineConfig, BaselineState, BaselineFrameStats,
  FullVideo, TemporalDown, SpatialDown, GazeCrop
                                              (compressor, loaded lazily)
  StreamPool                                  (pool, loaded lazily)
  the registries' get/register/available/validate functions.
"""

from __future__ import annotations

from repro_torch.api.registry import (  # noqa: F401
    available_backends,
    available_combinators,
    available_compressors,
    available_stages,
    get_backend,
    get_combinator,
    get_compressor,
    get_stage,
    make_combinator,
    make_stage,
    register_backend,
    register_combinator,
    register_compressor,
    register_stage,
    validate_backend,
    validate_k_ladder,
    validate_patch_k,
    validate_prefilter_k,
)
from repro_torch.api.stages import (  # noqa: F401
    FrameCtx,
    FrameStage,
    Gated,
    StageGraph,
)
from repro_torch.api.types import (  # noqa: F401
    SensorChunk,
    concat_stats,
    iter_chunks,
)

_LAZY = {
    **dict.fromkeys(
        ("Compressor", "EPICCompressor", "run_session", "BaselineConfig",
         "BaselineState", "BaselineFrameStats", "FullVideo", "TemporalDown",
         "SpatialDown", "GazeCrop"),
        "repro_torch.api.compressor",
    ),
    "StreamPool": "repro_torch.api.pool",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
