"""Geometry-based frame/patch reprojection (EPIC paper, Section 3.1, Eq. 1).

PyTorch port of ``repro.core.geometry``, same conventions:

* Pixel coordinates ``(u, v)``: ``u`` along width (column), ``v`` along
  height (row), origin at the top-left pixel centre.
* Camera frame (OpenCV): ``+x`` right, ``+y`` down, ``+z`` forward;
  ``depth`` is the camera-frame ``z``.
* Intrinsics ``K = [[f, 0, cx], [0, f, cy], [0, 0, 1]]``.
* A pose is the camera-to-world transform ``T_wc`` as a 4x4 matrix.

The rigid transforms are written out element by element, in the order
the reproject-match kernel evaluates them, so the plain versions and the
CUDA kernel round the same way (a matrix product would sum in another
order).  The intrinsics are 0-dim tensors on the data's device: on CUDA,
PyTorch divides by a host scalar as a multiplication by its reciprocal,
which is not the IEEE division the kernel does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import Tensor

_EPS = 1e-6


class Intrinsics(NamedTuple):
    """Pinhole camera intrinsics (square pixels), as float32 0-dim tensors."""

    f: Tensor
    cx: Tensor
    cy: Tensor

    @staticmethod
    def create(f: float, cx: float, cy: float, device) -> "Intrinsics":
        """Each value filled on ``device`` (no host-to-device copy, so no
        host sync on the card)."""
        return Intrinsics(*(
            torch.full((), v, dtype=torch.float32, device=device)
            for v in (f, cx, cy)
        ))


def pose_from_rt(rot: Tensor, trans: Tensor) -> Tensor:
    """``(..., 4, 4)`` pose from ``(..., 3, 3)`` rotation and ``(..., 3)``
    translation."""
    batch = torch.broadcast_shapes(rot.shape[:-2], trans.shape[:-1])
    rot = rot.expand(*batch, 3, 3)
    trans = trans.expand(*batch, 3)
    top = torch.cat([rot, trans[..., :, None]], dim=-1)
    bottom = torch.zeros(*batch, 1, 4, dtype=rot.dtype, device=rot.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def rotation_xyz(angles: Tensor) -> Tensor:
    """Rotation matrix from XYZ Euler angles (radians). angles: (..., 3)."""
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx_, sx = torch.cos(ax), torch.sin(ax)
    cy_, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    o = torch.ones_like(ax)
    z = torch.zeros_like(ax)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat([[o, z, z], [z, cx_, -sx], [z, sx, cx_]])
    ry = mat([[cy_, z, sy], [z, o, z], [-sy, z, cy_]])
    rz = mat([[cz, -sz, z], [sz, cz, z], [z, z, o]])
    return rz @ ry @ rx


def _rotate(rot: Tensor, x: Tensor, y: Tensor, z: Tensor, i: int) -> Tensor:
    """Row ``i`` of ``rot @ [x, y, z]``, summed left to right."""
    return rot[..., i, 0] * x + rot[..., i, 1] * y + rot[..., i, 2] * z


def invert_pose(pose: Tensor) -> Tensor:
    """Invert a rigid 4x4 transform analytically (R^T, -R^T t)."""
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    tx, ty, tz = pose[..., 0, 3], pose[..., 1, 3], pose[..., 2, 3]
    new_t = torch.stack(
        [-_rotate(rot_t, tx, ty, tz, i) for i in range(3)], dim=-1
    )
    return pose_from_rt(rot_t, new_t)


def relative_transform(src_pose: Tensor, dst_pose: Tensor) -> Tensor:
    """T_{p1->p2}: maps points in the *src* camera frame to the *dst*
    frame; both poses camera-to-world: ``inv(T_wc_dst) @ T_wc_src``."""
    return invert_pose(dst_pose) @ src_pose


def lift(uv: Tensor, depth: Tensor, intr: Intrinsics) -> Tensor:
    """``(..., 2)`` pixels + ``(...,)`` depth -> ``(..., 3)`` camera points."""
    x = (uv[..., 0] - intr.cx) / intr.f * depth
    y = (uv[..., 1] - intr.cy) / intr.f * depth
    return torch.stack([x, y, depth], dim=-1)


def project(xyz: Tensor, intr: Intrinsics) -> Tuple[Tensor, Tensor, Tensor]:
    """Project camera-frame points: ``(uv, z, valid)``, valid = in front."""
    z = xyz[..., 2]
    valid = z > _EPS
    safe_z = torch.where(valid, z, torch.ones_like(z))
    u = xyz[..., 0] / safe_z * intr.f + intr.cx
    v = xyz[..., 1] / safe_z * intr.f + intr.cy
    return torch.stack([u, v], dim=-1), z, valid


def transform_points(t4: Tensor, xyz: Tensor) -> Tensor:
    """Apply a 4x4 rigid transform (broadcast over ``t4``'s batch axes) to
    ``(..., 3)`` points: ``x2 = t00 x + t01 y + t02 z + t03``."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return torch.stack(
        [_rotate(t4, x, y, z, i) + t4[..., i, 3] for i in range(3)], dim=-1
    )


def reproject_points(
    uv: Tensor, depth: Tensor, intr: Intrinsics, t_rel: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Lift -> transform -> project (the paper's Eq. 1).

    ``t_rel`` maps the source camera frame to the destination frame.
    Returns ``(uv2, z2, valid)``.
    """
    return project(transform_points(t_rel, lift(uv, depth, intr)), intr)


def _t_cw(intr: Intrinsics, depth: Tensor) -> Tensor:
    """T_cw(f, d) per point, ``(..., 4, 4)``: homogeneous ``[u, v, f, 1]``
    -> camera-frame ``[x, y, z, 1]`` with x = d (u - cx) / f,
    y = d (v - cy) / f, z = d."""
    d_over_f = depth / intr.f
    z = torch.zeros_like(depth)
    o = torch.ones_like(depth)
    rows = [
        torch.stack([d_over_f, z, z, -d_over_f * intr.cx], -1),
        torch.stack([z, d_over_f, z, -d_over_f * intr.cy], -1),
        torch.stack([z, z, d_over_f, z], -1),
        torch.stack([z, z, z, o], -1),
    ]
    return torch.stack(rows, -2)


def _t_wc(intr: Intrinsics) -> Tensor:
    """T_wc(f), ``(4, 4)``: camera-frame ``[x, y, z, 1]`` -> homogeneous
    image ``[u w, v w, f w, w]`` (w = z)."""
    f, cx, cy = intr.f, intr.cx, intr.cy
    z = torch.zeros_like(f)
    o = torch.ones_like(f)
    return torch.stack([
        torch.stack([f, z, cx, z]),
        torch.stack([z, f, cy, z]),
        torch.stack([z, z, f, z]),
        torch.stack([z, z, o, z]),
    ])


def eq1_reproject(
    uv: Tensor, depth: Tensor, intr: Intrinsics, t_rel: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """The paper's Eq. 1 as a literal chain of 4x4 matrices,
    ``[o'_f2, f, 1] = T_wc(f) T_{p1->p2} T_cw(f, d1) [o'_f1, f, 1]``:
    the same function as :func:`reproject_points`, kept as the
    faithfulness reference.  Returns ``(uv2, z2, valid)``."""
    homog = torch.stack([uv[..., 0], uv[..., 1],
                         intr.f.expand(uv[..., 0].shape),
                         torch.ones_like(uv[..., 0])], -1)
    chain = _t_wc(intr) @ t_rel @ _t_cw(intr, depth)  # (..., 4, 4)
    out = torch.einsum("...ij,...j->...i", chain, homog)
    w = out[..., 3]
    valid = w > _EPS
    safe_w = torch.where(valid, w, torch.ones_like(w))
    return out[..., :2] / safe_w[..., None], w, valid


def patch_pixel_grid(origin_yx: Tensor, patch: int) -> Tensor:
    """``(..., P, P, 2)`` pixel-centre ``(u, v)`` of a patch at ``origin_yx``
    (``(..., 2)`` top-left row, col)."""
    rr = torch.arange(patch, dtype=torch.float32, device=origin_yx.device)
    vv, uu = torch.meshgrid(rr, rr, indexing="ij")
    u = uu + origin_yx[..., 1][..., None, None]
    v = vv + origin_yx[..., 0][..., None, None]
    return torch.stack([u, v], dim=-1)


def warp_patch_coords(
    origin_yx: Tensor,
    depth_patch: Tensor,
    intr: Intrinsics,
    t_rel: Tensor,
    patch: int,
) -> Tuple[Tensor, Tensor]:
    """Warp a source patch's pixel grid into the destination view.

    Batched over leading axes: ``origin_yx (..., 2)``, ``depth_patch
    (..., P, P)``, ``t_rel (..., 4, 4)``.  Returns ``coords (..., P, P, 2)``
    and ``valid (..., P, P)`` (destination z > 0).
    """
    grid = patch_pixel_grid(origin_yx, patch)
    uv2, _, valid = reproject_points(
        grid, depth_patch, intr, t_rel[..., None, None, :, :]
    )
    return uv2, valid


def bilinear_sample(image: Tensor, coords: Tensor) -> Tuple[Tensor, Tensor]:
    """Bilinearly sample ``image (H, W, C)`` at ``coords (..., 2)`` of (u, v).

    Returns ``values (..., C)`` (0 where invalid) and ``valid (...,)``: all
    four taps inside the image.  Coordinates are clamped as floats before
    the cast to int, so far-off points never overflow the index.
    """
    h, w = image.shape[0], image.shape[1]
    u, v = coords[..., 0], coords[..., 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    valid = (u0 >= 0) & (u0 + 1 <= w - 1) & (v0 >= 0) & (v0 + 1 <= h - 1)
    u0c = u0.clamp(0.0, float(w - 2)).long()
    v0c = v0.clamp(0.0, float(h - 2)).long()
    p00 = image[v0c, u0c]
    p01 = image[v0c, u0c + 1]
    p10 = image[v0c + 1, u0c]
    p11 = image[v0c + 1, u0c + 1]
    w00 = ((1 - du) * (1 - dv))[..., None]
    w01 = (du * (1 - dv))[..., None]
    w10 = ((1 - du) * dv)[..., None]
    w11 = (du * dv)[..., None]
    out = p00 * w00 + p01 * w01 + p10 * w10 + p11 * w11
    return torch.where(valid[..., None], out, torch.zeros_like(out)), valid


def reproject_bbox(
    origin_yx: Tensor,
    corner_depths: Tensor,
    intr: Intrinsics,
    t_rel: Tensor,
    patch: int,
) -> Tuple[Tensor, Tensor]:
    """Reproject a patch's four corners (accelerator prefilter, Section 4.1.1).

    Args:
      origin_yx: (..., 2) patch top-left (row, col).
      corner_depths: (..., 4) depth at [tl, tr, bl, br].
      t_rel: (4, 4) or (..., 4, 4).

    Returns:
      bbox (..., 4) as (vmin, umin, vmax, umax); valid (...,): all four
      corners in front of the destination camera.
    """
    p = float(patch - 1)
    r0, c0 = origin_yx[..., 0], origin_yx[..., 1]
    rows = torch.stack([r0, r0, r0 + p, r0 + p], -1)  # [tl, tr, bl, br]
    cols = torch.stack([c0, c0 + p, c0, c0 + p], -1)
    corners_uv = torch.stack([cols, rows], -1)
    if t_rel.ndim > 2:
        t_rel = t_rel[..., None, :, :]
    uv2, _, valid = reproject_points(corners_uv, corner_depths, intr, t_rel)
    vmin = uv2[..., 1].amin(-1)
    vmax = uv2[..., 1].amax(-1)
    umin = uv2[..., 0].amin(-1)
    umax = uv2[..., 0].amax(-1)
    return torch.stack([vmin, umin, vmax, umax], -1), valid.all(-1)


def bbox_overlap_fraction(bbox: Tensor, origin_yx: Tensor, patch: int) -> Tensor:
    """Fraction of a PxP patch (at ``origin_yx``) covered by ``bbox``."""
    pv0 = origin_yx[..., 0]
    pu0 = origin_yx[..., 1]
    pv1 = pv0 + patch
    pu1 = pu0 + patch
    iv = (torch.minimum(bbox[..., 2], pv1)
          - torch.maximum(bbox[..., 0], pv0)).clamp_min(0.0)
    iu = (torch.minimum(bbox[..., 3], pu1)
          - torch.maximum(bbox[..., 1], pu0)).clamp_min(0.0)
    return iv * iu / float(patch * patch)
