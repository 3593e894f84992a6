"""Registered FrameStage implementations for EPIC and the baselines
(port of ``repro.core.frame_stages``).

  ``bypass``   — frame-bypass gate (Sections 3.5 / 4.2); writes
                 ``ctx.process`` and the per-frame diff.
  ``depth``    — FastDepth-lite prediction (fp32 or int8), or the oracle
                 depth track.
  ``saliency`` — HIR gaze-conditioned saliency (SRD, Section 3.3), or
                 all-salient without a model.
  ``tsrc``     — the TSRC update against the DC buffer (Section 3.4);
                 owns the buffer state.
  ``select.fv``/``select.sd``/``select.td``/``select.gc``
               — the baselines' per-frame patch selection policies.
  ``retain``   — fixed-capacity append of the selected patches (the
                 baselines' retained-buffer state).

The gaze crop and the retention write index with device tensors rather
than reading the crop corner or the cursor on the host, so the baselines
make no device-to-host sync per frame.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
from torch import Tensor

from repro_torch.api.registry import register_stage
from repro_torch.api.stages import FrameCtx
from repro_torch.core import dc_buffer as dcb
from repro_torch.core import depth as depth_mod
from repro_torch.core import frame_bypass, hir
from repro_torch.core import geometry as geo
from repro_torch.core import retained as ret
from repro_torch.core import tsrc as tsrc_mod


class BypassFrameStats(NamedTuple):
    processed: Tensor  # bool — passed the gate
    diff: Tensor  # mean-abs RGB difference vs the reference frame


@register_stage("bypass")
class BypassStage:
    """Frame Bypass Check: gates every downstream stage via ``ctx.process``."""

    name = "bypass"

    def __init__(self, cfg: frame_bypass.BypassConfig, frame_hw, device):
        self.cfg = cfg
        self.frame_hw = tuple(frame_hw)
        self.device = device

    def init(self) -> frame_bypass.BypassState:
        return frame_bypass.init(self.frame_hw, self.device)

    def apply(self, state, ctx: FrameCtx):
        state, process, diff = frame_bypass.check(state, ctx.frame, self.cfg)
        ctx = ctx._replace(process=process).with_stat(
            self.name, BypassFrameStats(process, diff)
        )
        return state, ctx


@register_stage("depth")
class DepthStage:
    """Depth estimation (Section 3.2) once per processed frame;
    ``model=None`` passes the chunk's ground-truth depth through."""

    name = "depth"

    def __init__(self, model: Any = None):
        self.model = model

    def init(self) -> None:
        return None

    def apply(self, state, ctx: FrameCtx):
        if self.model is not None:
            dmap = depth_mod.predict_fullres(self.model, ctx.frame)
        else:
            if ctx.depth is None:
                raise ValueError(
                    "depth stage in oracle mode requires the chunk's depth "
                    "track (models.depth_model is None and chunk.depth is "
                    "None)"
                )
            dmap = ctx.depth
        return state, ctx._replace(dmap=dmap)


@register_stage("saliency")
class SaliencyStage:
    """HIR saliency (SRD, Section 3.3); all-salient when ``model=None``."""

    name = "saliency"

    def __init__(self, model: Any, grid: int, frame_hw):
        self.model = model
        self.grid = grid
        self.frame_hw = tuple(frame_hw)

    def init(self) -> None:
        return None

    def apply(self, state, ctx: FrameCtx):
        n_patches = self.grid * self.grid
        if self.model is not None:
            rgb64 = depth_mod.resize_image(ctx.frame, hir.HIR_INPUT)
            heat = hir.gaze_heatmap(ctx.gaze, hir.HIR_INPUT, self.frame_hw)
            logits = hir.forward(
                self.model, rgb64[None], heat[None], self.grid
            )[0].reshape(-1)
            sal_mask = hir.binary_saliency(logits)
            sal_score = torch.sigmoid(logits)
        else:
            dev = ctx.frame.device
            sal_mask = torch.ones(n_patches, dtype=torch.bool, device=dev)
            sal_score = torch.ones(n_patches, dtype=torch.float32, device=dev)
        return state, ctx._replace(sal_mask=sal_mask, sal_score=sal_score)


@register_stage("tsrc")
class TSRCStage:
    """TSRC update (Section 3.4): owns the DC buffer state; the dense or
    sparse TRD is chosen by ``tsrc_cfg``."""

    name = "tsrc"

    def __init__(
        self,
        buf_cfg: dcb.DCBufferConfig,
        tsrc_cfg: tsrc_mod.TSRCConfig,
        intr: geo.Intrinsics,
    ):
        self.buf_cfg = buf_cfg
        self.tsrc_cfg = tsrc_cfg
        self.intr = intr

    def init(self) -> dcb.DCBuffer:
        return dcb.init(self.buf_cfg, self.intr.f.device)

    def apply(self, buf: dcb.DCBuffer, ctx: FrameCtx):
        buf, tstats = tsrc_mod.tsrc_step(
            buf,
            self.buf_cfg,
            self.tsrc_cfg,
            ctx.frame,
            ctx.dmap,
            ctx.sal_mask,
            ctx.sal_score,
            ctx.pose,
            ctx.t,
            self.intr,
        )
        return buf, ctx.with_stat(self.name, tstats)


# ---------------------------------------------------------------------------
# Baseline stages: per-frame patch selection + fixed-capacity retention.
# ---------------------------------------------------------------------------


def _true(like: Tensor) -> Tensor:
    return torch.ones((), dtype=torch.bool, device=like.device)


@register_stage("select.fv")
class SelectFullVideo:
    """FV: every patch of every frame (memory-unbounded reference)."""

    name = "select.fv"

    def __init__(self, patch: int):
        self.patch = patch

    def init(self) -> None:
        return None

    def apply(self, state, ctx: FrameCtx):
        patches, origins = tsrc_mod.extract_patches(ctx.frame, self.patch)
        return state, ctx._replace(
            patches=patches, origins=origins, keep=_true(ctx.frame)
        )


@register_stage("select.td")
class SelectTemporalDown:
    """TD: keep every ``stride``-th frame at full resolution."""

    name = "select.td"

    def __init__(self, patch: int, stride: int, n_keep: int):
        self.patch = patch
        self.stride = stride
        self.n_keep = n_keep

    def init(self) -> None:
        return None

    def apply(self, state, ctx: FrameCtx):
        patches, origins = tsrc_mod.extract_patches(ctx.frame, self.patch)
        keep = (ctx.t % self.stride == 0) & (
            ctx.t // self.stride < self.n_keep
        )
        return state, ctx._replace(
            patches=patches, origins=origins, keep=keep
        )


@register_stage("select.sd")
class SelectSpatialDown:
    """SD: every frame, downsampled (antialiased, as ``jax.image.resize``)
    to a ``gg x gg`` patch grid."""

    name = "select.sd"

    def __init__(self, patch: int, gg: int, frame_hw):
        self.patch = patch
        self.gg = gg
        self.frame_hw = tuple(frame_hw)

    def init(self) -> None:
        return None

    def apply(self, state, ctx: FrameCtx):
        h = self.frame_hw[0]
        new_hw = self.gg * self.patch
        small = depth_mod.resize_image(ctx.frame, new_hw)
        patches, origins = tsrc_mod.extract_patches(small, self.patch)
        return state, ctx._replace(
            patches=patches,
            origins=origins * (h / new_hw),
            keep=_true(ctx.frame),
        )


@register_stage("select.gc")
class SelectGazeCrop:
    """GC: a budget-sized square crop centred at the gaze point."""

    name = "select.gc"

    def __init__(self, patch: int, crop: int, frame_hw):
        self.patch = patch
        self.crop = crop
        self.frame_hw = tuple(frame_hw)

    def init(self) -> None:
        return None

    def apply(self, state, ctx: FrameCtx):
        h, w = self.frame_hw
        crop = self.crop
        cy = (ctx.gaze[1] - crop / 2).clamp(0, h - crop).to(torch.int32)
        cx = (ctx.gaze[0] - crop / 2).clamp(0, w - crop).to(torch.int32)
        span = torch.arange(crop, dtype=torch.int32, device=ctx.frame.device)
        region = ctx.frame[(cy + span)[:, None], (cx + span)[None, :]]
        patches, origins = tsrc_mod.extract_patches(region, self.patch)
        corner = torch.stack([cy, cx]).to(torch.float32)
        return state, ctx._replace(
            patches=patches,
            origins=origins + corner,
            keep=_true(ctx.frame),
        )


class RetainFrameStats(NamedTuple):
    """Per-frame counters of the retention stage (mirrors the shape
    contract of the EPIC ``FrameStats``)."""

    processed: Tensor  # bool — frame contributed retained patches
    n_inserted: Tensor  # int32 — patches written this frame
    buffer_valid: Tensor  # int32 — occupancy after the frame


@register_stage("retain")
class RetainStage:
    """Fixed-capacity append of the selected patches.

    State is ``(RetainedPatches, cursor)``.  Slot ``s`` takes patch
    ``s - cursor`` when the frame is kept and that patch exists; slots
    past the capacity are dropped, the cursor keeps counting, and the
    reported occupancy saturates at the capacity.
    """

    name = "retain"

    def __init__(self, capacity: int, patch: int, device):
        self.capacity = capacity
        self.patch = patch
        self.device = device

    def init(self) -> Tuple[ret.RetainedPatches, Tensor]:
        cap, p = self.capacity, self.patch
        f32 = dict(dtype=torch.float32, device=self.device)
        rp = ret.RetainedPatches(
            rgb=torch.zeros((cap, p, p, 3), **f32),
            t=torch.zeros((cap,), **f32),
            origin=torch.zeros((cap, 2), **f32),
            valid=torch.zeros((cap,), dtype=torch.bool, device=self.device),
        )
        return rp, torch.zeros((), dtype=torch.int32, device=self.device)

    def apply(self, state, ctx: FrameCtx):
        rp, cursor = state
        patches, origins, keep = ctx.patches, ctx.origins, ctx.keep
        k = patches.shape[0]
        src = torch.arange(self.capacity, dtype=torch.int32,
                           device=cursor.device) - cursor
        written = keep & (src >= 0) & (src < k)
        src = src.clamp(0, k - 1).long()
        t_f = ctx.t.to(torch.float32)
        rp = rp._replace(
            rgb=torch.where(written[:, None, None, None], patches[src],
                            rp.rgb),
            t=torch.where(written, t_f, rp.t),
            origin=torch.where(written[:, None], origins[src], rp.origin),
            valid=rp.valid | written,
        )
        cursor = cursor + keep.to(torch.int32) * k
        stats = RetainFrameStats(
            processed=keep,
            n_inserted=written.sum(dtype=torch.int32),
            buffer_valid=torch.clamp_max(cursor, self.capacity),
        )
        return (rp, cursor), ctx.with_stat(self.name, stats)
