"""Synthetic egocentric world: analytic renderer (port of
``repro.data.synthetic``).

A pinhole camera moves through a textured ground plane with K textured
spheres ("objects"); rendering is analytic ray casting with unnormalised
rays (z = 1 in the camera frame), so the ray parameter is the
camera-frame depth.  Every frame comes with exact depth, pose and gaze.

The random draws (scene, fixations, pose jitter, gaze noise) are made
with a ``numpy.random.Generator``; JAX's generator gives other numbers,
so the renderer is a function of scene and trajectory arrays, and a
parity test hands both packages the same arrays.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import Tensor

from repro_torch import resolve_device
from repro_torch.core import geometry as geo

_PALETTE = np.array(
    [
        [0.90, 0.20, 0.20],
        [0.20, 0.75, 0.25],
        [0.25, 0.35, 0.95],
        [0.95, 0.80, 0.20],
        [0.80, 0.25, 0.85],
        [0.20, 0.85, 0.85],
        [0.95, 0.55, 0.15],
        [0.55, 0.30, 0.10],
        [0.60, 0.85, 0.30],
        [0.35, 0.20, 0.75],
    ],
    dtype=np.float32,
)

PLANE_Y = 1.2  # ground plane height (+y is down)
SKY_DEPTH = 25.0


class Scene(NamedTuple):
    centers: Tensor  # (K, 3) sphere centres
    radii: Tensor  # (K,)
    colors: Tensor  # (K, 3)
    freqs: Tensor  # (K,) per-object texture frequency


class Stream(NamedTuple):
    """A rendered egocentric stream with full ground truth."""

    frames: Tensor  # (T, H, W, 3)
    depth: Tensor  # (T, H, W)
    obj_id: Tensor  # (T, H, W) int32; -1 sky, 0 plane, 1..K spheres
    poses: Tensor  # (T, 4, 4) camera-to-world
    gazes: Tensor  # (T, 2) pixel (u, v)
    gaze_target: Tensor  # (T,) int64 attended object (1..K)
    segment_of_frame: Tensor  # (T,) int64 fixation segment index


def make_scene(rng: np.random.Generator, n_obj: int, device) -> Scene:
    """Spheres spread in depth and azimuth, resting on the ground plane."""
    x = np.linspace(-3.2, 3.2, n_obj, dtype=np.float32) + rng.uniform(
        -0.4, 0.4, n_obj
    ).astype(np.float32)
    z = rng.uniform(2.6, 6.5, n_obj).astype(np.float32)
    radii = rng.uniform(0.55, 0.85, n_obj).astype(np.float32)
    centers = np.stack([x, np.float32(PLANE_Y) - radii, z], axis=-1)
    idx = np.arange(n_obj)
    colors = _PALETTE[idx % _PALETTE.shape[0]]
    freqs = (4.0 + 3.0 * (idx % 3)).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return Scene(t(centers), t(radii), t(colors), t(freqs))


def look_at_pose(eye: Tensor, target: Tensor) -> Tensor:
    """Camera-to-world pose(s) looking from ``eye`` toward ``target``
    (``(..., 3)``); camera +x right, +y down, +z forward."""
    fwd = target - eye
    fwd = fwd / (torch.linalg.vector_norm(fwd, dim=-1, keepdim=True) + 1e-8)
    down_w = torch.zeros_like(fwd)
    down_w[..., 1] = 1.0
    right = torch.linalg.cross(down_w, fwd, dim=-1)
    right = right / (
        torch.linalg.vector_norm(right, dim=-1, keepdim=True) + 1e-8
    )
    down = torch.linalg.cross(fwd, right, dim=-1)
    rot = torch.stack([right, down, fwd], dim=-1)  # columns = camera axes
    return geo.pose_from_rt(rot, eye)


def _fma_dot(xs, ys) -> Tensor:
    """``sum_j xs[j] * ys[j]`` rounded as XLA's CPU einsum rounds a short
    contraction: the first product rounded to float32, then each further
    term added by one fused multiply-add, in index order.  Each step is
    taken in float64 (where a float32 product is exact) and rounded to
    float32.  ``torch.einsum`` rounds as XLA does on some CPUs and not on
    others, so the renderer does not leave the order to it."""
    acc = None
    for x, y in zip(xs, ys):
        term = x.double() * y.double()
        acc = term.float() if acc is None else (acc.double() + term).float()
    return acc


def _sum_squares(x: Tensor) -> Tensor:
    """``sum(x * x, -1)`` over a last axis of 3 as eager JAX computes it:
    each product rounded, then added in index order."""
    sq = [x[..., i] * x[..., i] for i in range(3)]
    return (sq[0] + sq[1]) + sq[2]


def render_frame(
    scene: Scene, pose: Tensor, intr: geo.Intrinsics, hw: Tuple[int, int]
) -> Tuple[Tensor, Tensor, Tensor]:
    """Ray-cast one frame: ``rgb (H, W, 3)``, ``depth (H, W)`` (camera
    z), ``obj_id (H, W)`` int32."""
    h, w = hw
    dev = pose.device
    uu, vv = torch.meshgrid(
        torch.arange(w, dtype=torch.float32, device=dev),
        torch.arange(h, dtype=torch.float32, device=dev),
        indexing="xy",
    )
    # Unnormalised camera-frame ray dirs with z=1 -> ray param == depth.
    dirs_cam = torch.stack(
        [(uu - intr.cx) / intr.f, (vv - intr.cy) / intr.f,
         torch.ones_like(uu)],
        dim=-1,
    )  # (H, W, 3)
    rot = pose[:3, :3]
    eye = pose[:3, 3]
    dirs = _fma_dot([rot[:, j] for j in range(3)],
                    [dirs_cam[..., j:j + 1] for j in range(3)])  # rot @ d

    big = 1e6
    # Ground plane y = PLANE_Y.
    dy = dirs[..., 1]
    t_plane = (PLANE_Y - eye[1]) / torch.where(
        dy.abs() > 1e-6, dy, torch.full_like(dy, 1e-6)
    )
    t_plane = torch.where(t_plane > 1e-3, t_plane, torch.full_like(dy, big))

    # Spheres.
    oc = eye[None, :] - scene.centers  # (K, 3)
    b = _fma_dot([dirs[..., i:i + 1] for i in range(3)],
                 [oc[:, i] for i in range(3)])  # (H, W, K)
    a = _sum_squares(dirs)[..., None]  # (H, W, 1)
    c = _sum_squares(oc)[None, None, :] - scene.radii[None, None, :] ** 2
    disc = b * b - a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    t_sph = (-b - sq) / a
    t_sph = torch.where((disc > 0) & (t_sph > 1e-3), t_sph,
                        torch.full_like(t_sph, big))

    t_all = torch.cat([t_plane[..., None], t_sph], dim=-1)  # (H, W, 1+K)
    t_hit, hit = t_all.min(dim=-1)  # hit: 0 plane, 1..K spheres
    is_sky = t_hit >= big * 0.5
    depth = torch.where(is_sky, torch.full_like(t_hit, SKY_DEPTH), t_hit)
    obj_id = torch.where(is_sky, torch.full_like(hit, -1), hit).to(torch.int32)

    # Shading: plane checker + per-object striped texture + lambert-ish term.
    point = eye[None, None, :] + t_hit[..., None] * dirs
    checker = torch.remainder(
        torch.floor(point[..., 0]) + torch.floor(point[..., 2]), 2.0
    )
    plane_rgb = (0.35 + 0.25 * checker)[..., None] * torch.tensor(
        [1.0, 0.95, 0.85], device=dev
    )

    k_idx = (hit - 1).clamp(0, scene.centers.shape[0] - 1)
    base = scene.colors[k_idx]  # (H, W, 3)
    local = point - scene.centers[k_idx]
    stripes = 0.75 + 0.25 * torch.sin(
        scene.freqs[k_idx] * (local[..., 0] + 2.0 * local[..., 1])
    )
    normal = local / (
        torch.linalg.vector_norm(local, dim=-1, keepdim=True) + 1e-8
    )
    light = torch.tensor([0.4, -0.8, -0.45], device=dev)
    light = light / torch.linalg.vector_norm(light)
    facing = _fma_dot([normal[..., i] for i in range(3)],
                      [-light[i] for i in range(3)])  # normal . -light
    lambert = 0.55 + 0.45 * facing.clamp(0.0, 1.0)
    sphere_rgb = base * (stripes * lambert)[..., None]

    sky_rgb = torch.tensor([0.55, 0.70, 0.90], device=dev)
    rgb = torch.where(
        (obj_id == 0)[..., None],
        plane_rgb,
        torch.where((obj_id > 0)[..., None], sphere_rgb, sky_rgb),
    )
    return rgb.clamp(0.0, 1.0), depth, obj_id


class StreamConfig(NamedTuple):
    n_frames: int = 60
    hw: Tuple[int, int] = (128, 128)
    n_obj: int = 6
    n_segments: int = 4  # fixation segments
    motion_amp: float = 0.8  # lateral head translation amplitude
    motion_freq: float = 0.05  # cycles per frame
    walk_speed: float = 0.02  # forward drift per frame (0 = standing)
    jitter: float = 0.01  # pose jitter (radians / metres)
    gaze_jitter_px: float = 2.0
    focal_frac: float = 0.8

    def intrinsics(self, device) -> geo.Intrinsics:
        h, w = self.hw
        return geo.Intrinsics.create(
            self.focal_frac * w, w / 2.0, h / 2.0, device
        )


def generate_stream(
    rng: np.random.Generator, cfg: StreamConfig, device=None
) -> Tuple[Stream, Scene]:
    """Render a whole stream with a fixation schedule (``device=None``:
    the card).  Draws with ``rng``, then renders as the JAX package does."""
    device = resolve_device(device)
    scene = make_scene(rng, cfg.n_obj, device)
    seg_draw = rng.integers(0, cfg.n_obj, cfg.n_segments)
    jitter = rng.standard_normal((cfg.n_frames, 3)).astype(np.float32)
    gaze_noise = rng.standard_normal((cfg.n_frames, 2)).astype(np.float32)
    intr = cfg.intrinsics(device)
    t_axis = torch.arange(cfg.n_frames, dtype=torch.float32, device=device)

    # Fixation schedule: each segment attends one object (1..K).
    seg_len = cfg.n_frames // cfg.n_segments
    seg_targets = 1 + torch.as_tensor(seg_draw, device=device)
    seg_of_frame = (t_axis / seg_len).long().clamp(0, cfg.n_segments - 1)
    gaze_target = seg_targets[seg_of_frame]  # (T,)

    # Head trajectory: slow lateral sway + drift toward the attended object.
    sway = cfg.motion_amp * torch.sin(
        2 * torch.pi * cfg.motion_freq * t_axis
    )
    eye = torch.stack(
        [sway, torch.zeros_like(t_axis), -0.5 + cfg.walk_speed * t_axis],
        dim=-1,
    )
    eye = eye + cfg.jitter * torch.as_tensor(jitter, device=device)
    target_pts = scene.centers[gaze_target - 1]  # (T, 3)
    ahead = eye + torch.tensor([0.0, 0.3, 5.0], device=device)
    look = 0.5 * ahead + 0.5 * target_pts
    poses = look_at_pose(eye, look)

    h, w = cfg.hw
    frames, depth, obj_id, gazes = [], [], [], []
    uv_max = torch.tensor([w - 2.0, h - 2.0], device=device)
    noise = torch.as_tensor(gaze_noise, device=device)
    for i in range(cfg.n_frames):
        rgb, d, obj = render_frame(scene, poses[i], intr, cfg.hw)
        cam_pt = geo.transform_points(geo.invert_pose(poses[i]),
                                      target_pts[i])
        uv, _, _ = geo.project(cam_pt, intr)
        uv = uv + cfg.gaze_jitter_px * noise[i]
        gazes.append(torch.minimum(uv.clamp_min(1.0), uv_max))
        frames.append(rgb)
        depth.append(d)
        obj_id.append(obj)
    stream = Stream(
        torch.stack(frames), torch.stack(depth), torch.stack(obj_id),
        poses, torch.stack(gazes), gaze_target, seg_of_frame,
    )
    return stream, scene


def patch_relevance_labels(obj_id: Tensor, gaze_target: Tensor,
                           patch: int) -> Tensor:
    """HIR training labels: a patch is relevant iff more than 2% of its
    pixels belong to the attended object.  ``obj_id`` (T, H, W),
    ``gaze_target`` (T,) -> (T, G, G) float32 in {0, 1}."""
    t, h, _ = obj_id.shape
    g = h // patch
    m = (obj_id == gaze_target[:, None, None]).to(torch.float32)
    m = m[:, : g * patch, : g * patch].reshape(t, g, patch, g, patch)
    return (m.mean(dim=(2, 4)) > 0.02).to(torch.float32)


def depth_training_batch(
    rng: np.random.Generator, cfg: StreamConfig, batch: int, device=None
) -> Tuple[Tensor, Tensor]:
    """Random rendered views resized to 64x64: ``(rgb64 (B, 64, 64, 3),
    depth64 (B, 64, 64))``, for depth-model training and int8 calibration
    (``device=None``: the card)."""
    from repro_torch.core import depth as depth_mod

    stream, _ = generate_stream(rng, cfg._replace(n_frames=batch), device)
    rgb64 = depth_mod.resize_image(stream.frames, 64)
    d64 = depth_mod.resize_image(stream.depth[..., None], 64)[..., 0]
    return rgb64, d64
