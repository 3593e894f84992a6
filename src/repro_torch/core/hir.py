"""Human Intention Based Refinement (HIR) module (EPIC paper, Section 3.3).

Port of ``repro.core.hir``: a 3-layer CNN predicts one saliency logit per
patch from the 64x64 frame and a Gaussian gaze heatmap; the binary map is
``logit > 0`` (Spatial Redundancy Detection).  Public functions keep the
JAX package's NHWC layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from repro_torch.core.depth import conv2d_same, conv_init

HIR_INPUT = 64  # HIR operates on the same 64x64 downsampled view as depth


class HIRNet(nn.Module):
    """3-layer CNN: 4ch (RGB + gaze) -> 16 -> 32 -> 1; parameter names are
    the JAX pytree's keys (``w1`` ... ``b3``), weights OIHW."""

    def __init__(self, generator: torch.Generator):
        super().__init__()
        dev = generator.device
        self.w1 = nn.Parameter(conv_init(generator, 3, 3, 4, 16))
        self.b1 = nn.Parameter(torch.zeros(16, device=dev))
        self.w2 = nn.Parameter(conv_init(generator, 3, 3, 16, 32))
        self.b2 = nn.Parameter(torch.zeros(32, device=dev))
        self.w3 = nn.Parameter(conv_init(generator, 3, 3, 32, 1))
        self.b3 = nn.Parameter(torch.zeros(1, device=dev))

    def forward(self, rgb64: Tensor, heat64: Tensor, patch_grid: int) -> Tensor:
        """``(B, 64, 64, 3)`` + ``(B, 64, 64)`` -> ``(B, G, G)`` logits."""
        x = torch.cat([rgb64, heat64[..., None]], dim=-1).permute(0, 3, 1, 2)
        x = F.relu(conv2d_same(x, self.w1, 2) + self.b1[:, None, None])  # 32
        x = F.relu(conv2d_same(x, self.w2, 2) + self.b2[:, None, None])  # 16
        x = conv2d_same(x, self.w3, 1) + self.b3[:, None, None]
        # Average-pool logits onto the patch grid.
        b, _, hh, _ = x.shape
        if hh % patch_grid:
            raise ValueError(f"patch grid {patch_grid} does not divide {hh}")
        k = hh // patch_grid
        return x[:, 0].reshape(b, patch_grid, k, patch_grid, k).mean(dim=(2, 4))


def init_params(generator: torch.Generator) -> HIRNet:
    """An HIR network initialised from ``generator``."""
    return HIRNet(generator)


def gaze_heatmap(gaze_uv: Tensor, size: int, frame_hw: tuple,
                 sigma_frac: float = 0.08) -> Tensor:
    """Gaussian bump at the gaze ``(..., 2)`` (frame pixels) on a
    ``(..., size, size)`` grid, in [0, 1]."""
    h, w = frame_hw
    gu = gaze_uv[..., 0] / w * size
    gv = gaze_uv[..., 1] / h * size
    rr = torch.arange(size, dtype=torch.float32, device=gaze_uv.device)
    vv, uu = torch.meshgrid(rr, rr, indexing="ij")
    sigma = sigma_frac * size
    d2 = (uu - gu[..., None, None]) ** 2 + (vv - gv[..., None, None]) ** 2
    return torch.exp(-d2 / (2.0 * sigma**2))


def forward(model: HIRNet, rgb64: Tensor, heat64: Tensor,
            patch_grid: int) -> Tensor:
    """Per-patch saliency logits ``(B, G, G)``."""
    return model(rgb64, heat64, patch_grid)


def binary_saliency(logits: Tensor) -> Tensor:
    """Binary saliency map S_t."""
    return logits > 0.0


def loss_fn(model: HIRNet, rgb64: Tensor, heat64: Tensor, labels: Tensor,
            patch_grid: int) -> Tensor:
    """BCE against ground-truth patch relevance labels ``(B, G, G)`` in
    {0, 1}, in the reference's form ``max(x, 0) - x y + log1p(exp(-|x|))``
    (``F.binary_cross_entropy_with_logits`` rounds differently)."""
    logits = forward(model, rgb64, heat64, patch_grid)
    return torch.mean(
        logits.clamp_min(0) - logits * labels
        + torch.log1p(torch.exp(-logits.abs()))
    )


def n_params(model: HIRNet) -> int:
    """The network's number of scalar parameters."""
    return sum(int(p.numel()) for p in model.parameters())
