"""repro_torch.serve — the live multi-stream serving runtime and the EFM
serving steps (port of ``repro.serve``).

  SlottedPool, SlotStates, StaleSlotError  (slots)     fixed-capacity live
                                                       pool: active masks,
                                                       generations, one
                                                       slot-batched step
  TieredPool, validate_tiers               (tiers)     size-classed
                                                       sub-pools, device-side
                                                       migration
  KLadderController, RungScheduler,
  DispatchPlan                             (adaptive)  per-stream adaptive K
                                                       and the tick's rung
                                                       dispatch order
  Prefetch, ChunkQueue                     (ingest)    host-to-device chunk
                                                       prefetch, bounded
                                                       per-stream queues
  StreamServer, ServerConfig               (server)    the serving loop
  DegradeController, DegradeConfig,
  LevelPolicy, validate_degrade            (degrade)   graceful degradation
  ServeCheckpointer, save_server,
  restore_server, snapshot_server          (checkpoint) live-slot snapshot
                                                       and restore into a
                                                       fresh process
  StreamTelemetry, tick_readback,
  pool_stream_counters                     (telemetry) per-stream counters,
                                                       one sync per tick
  jit_prefill, jit_decode_step,
  greedy_decode_loop                       (efm)       the EFM prefill/decode
                                                       steps

Everything loads lazily, as there: ``repro_torch.api`` imports
``adaptive``, so this package must not pull the serving stack or the
model zoo in ``efm`` at import time.
"""

from __future__ import annotations

_LAZY = {
    "SlottedPool": "repro_torch.serve.slots",
    "SlotStates": "repro_torch.serve.slots",
    "StaleSlotError": "repro_torch.serve.slots",
    "TieredPool": "repro_torch.serve.tiers",
    "validate_tiers": "repro_torch.serve.tiers",
    "KLadderController": "repro_torch.serve.adaptive",
    "RungScheduler": "repro_torch.serve.adaptive",
    "DispatchPlan": "repro_torch.serve.adaptive",
    "Prefetch": "repro_torch.serve.ingest",
    "ChunkQueue": "repro_torch.serve.ingest",
    "StreamServer": "repro_torch.serve.server",
    "ServerConfig": "repro_torch.serve.server",
    "DegradeController": "repro_torch.serve.degrade",
    "DegradeConfig": "repro_torch.serve.degrade",
    "LevelPolicy": "repro_torch.serve.degrade",
    "validate_degrade": "repro_torch.serve.degrade",
    "ServeCheckpointer": "repro_torch.serve.checkpoint",
    "save_server": "repro_torch.serve.checkpoint",
    "restore_server": "repro_torch.serve.checkpoint",
    "snapshot_server": "repro_torch.serve.checkpoint",
    "StreamTelemetry": "repro_torch.serve.telemetry",
    "tick_readback": "repro_torch.serve.telemetry",
    "pool_stream_counters": "repro_torch.serve.telemetry",
    "jit_prefill": "repro_torch.serve.efm",
    "jit_decode_step": "repro_torch.serve.efm",
    "greedy_decode_loop": "repro_torch.serve.efm",
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
