"""EPIC streaming compressor — the algorithm of paper Figure 3 (c).

Port of ``repro.core.pipeline``.  Each frame runs

  Frame Bypass Check
      -> [bypassed: nothing else happens]
      -> depth estimation -> HIR saliency -> TSRC against the DC buffer

as a stage graph (:func:`build_epic_graph`): ``bypass`` always runs and
gates ``depth`` → ``saliency`` → ``tsrc``.  ``process_frame`` /
``scan_frames`` / ``compress_stream`` keep the JAX package's
``EPICState`` / ``FrameStats`` contract.  Feeding a stream in chunks is
identical to feeding it at once: the carry is the whole state.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from repro_torch import resolve_device
from repro_torch.api import registry as _registry
from repro_torch.api.stages import Gated, StageGraph
from repro_torch.core import dc_buffer as dcb
from repro_torch.core import depth as depth_mod
from repro_torch.core import energy
from repro_torch.core import frame_bypass
from repro_torch.core import geometry as geo
from repro_torch.core import retained as ret
from repro_torch.core import tsrc as tsrc_mod


class _EPICConfig(NamedTuple):
    frame_hw: Tuple[int, int] = (128, 128)
    patch: int = 16
    capacity: int = 192
    # TSRC thresholds
    tau: float = 0.08
    o_min: float = 0.5
    c_min: float = 0.6
    window: int = 32
    backend: str = "fused"
    prefilter_k: int = 0  # 0 = dense TRD; K > 0 = sparse top-K candidates
    patch_k: int = 0  # 0 = dense patch axis; P_k > 0 = salient compaction
    # Frame bypass
    gamma: float = 0.02
    theta: int = 30
    # DC buffer retention
    w_popularity: float = 1.0
    w_recency: float = 0.1
    # Camera: focal length as a fraction of frame width
    focal_frac: float = 0.8

    @property
    def grid(self) -> int:
        if self.frame_hw[0] != self.frame_hw[1]:
            raise ValueError(f"square frames assumed, got {self.frame_hw}")
        return self.frame_hw[0] // self.patch

    @property
    def n_patches(self) -> int:
        return self.grid * self.grid

    def intrinsics(self, device) -> geo.Intrinsics:
        h, w = self.frame_hw
        return geo.Intrinsics.create(
            self.focal_frac * w, w / 2.0, h / 2.0, device
        )

    def buffer_config(self) -> dcb.DCBufferConfig:
        return dcb.DCBufferConfig(
            capacity=self.capacity,
            patch=self.patch,
            w_popularity=self.w_popularity,
            w_recency=self.w_recency,
        )

    def tsrc_config(self) -> tsrc_mod.TSRCConfig:
        return tsrc_mod.TSRCConfig(
            tau=self.tau,
            o_min=self.o_min,
            c_min=self.c_min,
            window=self.window,
            backend=self.backend,
            prefilter_k=self.prefilter_k,
            patch_k=self.patch_k,
        )

    def bypass_config(self) -> frame_bypass.BypassConfig:
        return frame_bypass.BypassConfig(gamma=self.gamma, theta=self.theta)


class EPICConfig(_registry.BackendValidatedConfig, _EPICConfig):
    """EPIC pipeline configuration (fields above).

    Construction and ``_replace`` fail fast on an unregistered ``backend``
    or a negative ``prefilter_k`` / ``patch_k``.  The default backend is
    ``"fused"``, the CUDA kernel; ``"ref"`` is the plain PyTorch version.
    """

    __slots__ = ()


class EPICModels(NamedTuple):
    depth_model: Any = None  # DepthNet or QuantizedParams; None -> oracle
    hir_model: Any = None  # HIRNet; None -> all-salient (temporal only)


class EPICState(NamedTuple):
    bypass: frame_bypass.BypassState
    buf: dcb.DCBuffer
    t: Tensor  # () float32 frame index


class FrameStats(NamedTuple):
    processed: Tensor  # bool — passed the bypass gate
    bypass_diff: Tensor
    n_salient: Tensor
    n_matched: Tensor
    n_inserted: Tensor
    n_bbox_checks: Tensor
    n_full_checks: Tensor
    buffer_valid: Tensor
    n_prefilter_overflow: Tensor  # sparse-TRD top-K truncations (0 dense)
    n_patch_overflow: Tensor  # patch-compaction truncations (0 dense)
    n_patch_checked: Tensor  # compacted patch slots gathered (0 dense)


def init_state(cfg: EPICConfig, device) -> EPICState:
    return EPICState(
        bypass=frame_bypass.init(cfg.frame_hw, device),
        buf=dcb.init(cfg.buffer_config(), device),
        t=torch.zeros((), dtype=torch.float32, device=device),
    )


def _zero_tsrc_stats(buf: dcb.DCBuffer) -> tsrc_mod.TSRCStats:
    z = torch.zeros((), dtype=torch.int32, device=buf.valid.device)
    return tsrc_mod.TSRCStats(z, z, z, z, z, dcb.count_valid(buf), z, z, z)


def build_epic_graph(
    cfg: EPICConfig, models: EPICModels, device, *, select_gate: bool = False
) -> StageGraph:
    """Compose EPIC's per-frame pipeline as a stage graph (Figure 3c).

    ``bypass`` runs on every frame; ``depth`` → ``saliency`` → ``tsrc``
    run behind its gate (a host ``if``; ``select_gate=True``: the select
    form of :class:`~repro_torch.api.stages.Gated`, no host sync).  The
    graph state holds exactly the :class:`EPICState` fields ``(bypass,
    buf, t)``.
    """
    make = _registry.make_stage
    gated_stages = [
        make("depth", model=models.depth_model),
        make(
            "saliency",
            model=models.hir_model,
            grid=cfg.grid,
            frame_hw=cfg.frame_hw,
        ),
        make(
            "tsrc",
            buf_cfg=cfg.buffer_config(),
            tsrc_cfg=cfg.tsrc_config(),
            intr=cfg.intrinsics(device),
        ),
    ]
    tsrc_idx = next(i for i, s in enumerate(gated_stages) if s.name == "tsrc")
    gated = Gated(
        gated_stages,
        # A bypassed frame leaves the buffer untouched and reports zero
        # TSRC counters (buffer occupancy passes through).
        skip_stats=lambda states, ctx: {
            "tsrc": _zero_tsrc_stats(states[tsrc_idx])
        },
        select=select_gate,
    )

    def finalize(ctx) -> FrameStats:
        b = ctx.stats["bypass"]
        t = ctx.stats["tsrc"]
        return FrameStats(b.processed, b.diff, *t)

    return StageGraph(
        [
            make("bypass", cfg=cfg.bypass_config(), frame_hw=cfg.frame_hw,
                 device=device),
            gated,
        ],
        device=device,
        finalize=finalize,
    )


def _to_graph_state(graph: StageGraph, state: EPICState):
    return graph.pack_state({"bypass": state.bypass, "tsrc": state.buf},
                            state.t)


def _from_graph_state(graph: StageGraph, gstate) -> EPICState:
    named, t = graph.unpack_state(gstate)
    return EPICState(bypass=named["bypass"], buf=named["tsrc"], t=t)


@torch.no_grad()
def process_frame(
    state: EPICState,
    frame: Tensor,
    pose: Tensor,
    gaze: Tensor,
    depth_gt: Optional[Tensor],
    models: EPICModels,
    cfg: EPICConfig,
) -> Tuple[EPICState, FrameStats]:
    """Run the full EPIC algorithm on one frame, on ``state``'s device."""
    graph = build_epic_graph(cfg, models, state.t.device)
    gstate, stats = graph.step_frame(
        _to_graph_state(graph, state), frame, pose, gaze, depth_gt
    )
    return _from_graph_state(graph, gstate), stats


@torch.no_grad()
def scan_frames(
    state: EPICState,
    frames: Tensor,  # (T, H, W, 3)
    poses: Tensor,  # (T, 4, 4)
    gazes: Tensor,  # (T, 2)
    depth_gt: Optional[Tensor],  # (T, H, W) oracle depth, or None
    models: EPICModels,
    cfg: EPICConfig,
) -> Tuple[EPICState, FrameStats]:
    """Run EPIC over a chunk of frames from ``state`` (the chunked-ingest
    primitive), on ``state``'s device; stats have a leading time axis."""
    if models.depth_model is None and depth_gt is None:
        raise ValueError("need depth_gt when no depth model is given")
    graph = build_epic_graph(cfg, models, state.t.device)
    gstate, stats = graph.scan(
        _to_graph_state(graph, state), frames, poses, gazes, depth_gt
    )
    return _from_graph_state(graph, gstate), stats


def scan_body(cfg: EPICConfig, models: EPICModels, device):
    """:func:`scan_frames` as a function of tensors only, for the serving
    pool's slot-batched step (``torch.func.vmap`` over it): the graph is
    built once, here (its intrinsics are made now, not on every chunk),
    and its gate is the select form, so a call makes no host sync.
    ``body(state, frames, poses, gazes, depth_gt) -> (state, stats)``."""
    graph = build_epic_graph(cfg, models, device, select_gate=True)

    @torch.no_grad()
    def body(state, frames, poses, gazes, depth_gt):
        if models.depth_model is None and depth_gt is None:
            raise ValueError("need depth_gt when no depth model is given")
        gstate, stats = graph.scan(
            _to_graph_state(graph, state), frames, poses, gazes, depth_gt
        )
        return _from_graph_state(graph, gstate), stats

    return body


def compress_stream(
    frames: Tensor,
    poses: Tensor,
    gazes: Tensor,
    cfg: EPICConfig,
    models: EPICModels = EPICModels(),
    depth_gt: Optional[Tensor] = None,
    *,
    device=None,
) -> Tuple[EPICState, FrameStats]:
    """Compress a whole stream in one call (``device=None``: the card).

    Convenience over the session API ``repro_torch.api.EPICCompressor``,
    which ingests chunks and gives the same result.
    """
    from repro_torch.api.types import SensorChunk

    device = resolve_device(device)
    chunk = SensorChunk(frames, poses, gazes, depth_gt).validate().to(device)
    return scan_frames(
        init_state(cfg, device), *chunk, models, cfg
    )


# ---------------------------------------------------------------------------
# Energy-model bridge.
# ---------------------------------------------------------------------------


def stream_counters(cfg: EPICConfig, stats: FrameStats, *, int8_depth=True):
    """Convert scan stats into ``energy.StreamCounters`` for the cost model.

    With ``cfg.prefilter_k > 0`` the ``n_full_checks`` feeding the energy
    model is the real per-frame candidate count of the sparse TRD path.
    ``int8_depth`` is accepted and ignored, as in the JAX package (the
    energy model charges depth MACs at the int8 rate on the accelerator
    either way).  One-stream adapter over :func:`pool_stream_counters`.
    """
    return pool_stream_counters(
        cfg, FrameStats(*(x[None] for x in stats))
    )[0]


def pool_stream_counters(cfg: EPICConfig, stats: FrameStats, *,
                         streams=None):
    """Per-stream ``energy.StreamCounters`` over pooled stats whose
    tensors carry leading ``(n_streams, T)`` axes.

    All reductions are taken on the device and cross to the host in one
    transfer (one sync for the whole pool).  ``streams`` optionally
    selects a subset of stream indices.
    """
    h, w = cfg.frame_hw
    t = int(stats.processed.shape[1])
    rows = torch.stack([
        stats.processed.sum(dim=1, dtype=torch.int64),
        stats.n_full_checks.sum(dim=1, dtype=torch.int64),
        stats.n_bbox_checks.sum(dim=1, dtype=torch.int64),
        stats.n_inserted.sum(dim=1, dtype=torch.int64),
        stats.buffer_valid[:, -1].to(torch.int64),
        # Patch-compacted association gathers: per frame, each of the
        # n_full_checks candidates' bbox rows is read against each
        # compacted patch slot (0 when no compaction ran).
        (stats.n_full_checks * stats.n_patch_checked).sum(
            dim=1, dtype=torch.int64),
    ])
    n_proc, full_checks, bbox_checks, inserted, final_valid, pair_reads = (
        rows.cpu().tolist()
    )
    patch_bytes = ret.patch_rgb_bytes(cfg.patch)
    entry_bytes = ret.dc_entry_bytes(cfg.patch)
    if streams is None:
        streams = range(stats.processed.shape[0])
    return [
        energy.StreamCounters(
            n_frames=t,
            frame_px=h * w,
            n_processed=n_proc[i],
            depth_macs=depth_mod_macs() * n_proc[i],
            hir_macs=hir_macs() * n_proc[i],
            n_bbox_checks=bbox_checks[i],
            n_full_checks=full_checks[i],
            patch_px=cfg.patch * cfg.patch,
            stored_bytes=final_valid[i] * entry_bytes,
            dc_traffic_bytes=(
                full_checks[i] * patch_bytes
                + inserted[i] * entry_bytes
                + pair_reads[i] * ret.bbox_row_bytes()
            ),
        )
        for i in streams
    ]


def depth_mod_macs() -> int:
    """Analytic MAC count of FastDepth-lite on a 64x64 input."""
    macs = 0
    res = 64
    for _, kind, cin, cout, stride in depth_mod._ENCODER:
        res //= stride
        if kind == "conv":
            macs += res * res * 9 * cin * cout
        else:
            macs += res * res * (9 * cin + cin * cout)
    for _, kind, cin, cout, _ in depth_mod._DECODER:
        res *= 2
        macs += res * res * (9 * cin + cin * cout)
    macs += res * res * 9 * 16 * 1  # head
    return macs


def hir_macs() -> int:
    """Analytic MAC count of the 3-layer HIR CNN on a 64x64 input."""
    return 32 * 32 * 9 * 4 * 16 + 16 * 16 * 9 * 16 * 32 + 16 * 16 * 9 * 32 * 1
