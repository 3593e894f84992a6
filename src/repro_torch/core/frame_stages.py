"""Registered FrameStage implementations for EPIC (port of
``repro.core.frame_stages``; the baselines' stages come later).

  ``bypass``   — frame-bypass gate (Sections 3.5 / 4.2); writes
                 ``ctx.process`` and the per-frame diff.
  ``depth``    — FastDepth-lite prediction, or the oracle depth track.
  ``saliency`` — HIR gaze-conditioned saliency (SRD, Section 3.3), or
                 all-salient without a model.
  ``tsrc``     — the TSRC update against the DC buffer (Section 3.4);
                 owns the buffer state.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import Tensor

from repro_torch.api.registry import register_stage
from repro_torch.api.stages import FrameCtx
from repro_torch.core import dc_buffer as dcb
from repro_torch.core import depth as depth_mod
from repro_torch.core import frame_bypass, hir
from repro_torch.core import geometry as geo
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
