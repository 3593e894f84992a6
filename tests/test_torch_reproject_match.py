"""Reproject-match in the PyTorch port against the JAX package.

The port's plain version (the CPU path of every wrapper) is held to the
JAX ``reproject_match_ref`` and to the Pallas kernels run in interpret
mode, at the reference's own tolerances (``tests/test_kernels.py``):
diff and coverage within 1e-5, bbox within 1e-3.  The fused rows are
booleans and must agree exactly.  ``warp_order.py``, the plain version in
the CUDA kernel's summation order, is held to the same references and to
``ref.py`` within 1e-6.  The CUDA kernel itself is tested on the card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    intrinsics_pair,
    reproject_inputs,
    to_numpy,
    to_torch,
)
from repro.kernels.reproject_match.fused import (
    reproject_match_fused as j_fused,
)
from repro.kernels.reproject_match.kernel import (
    reproject_match_pallas as j_pallas,
    reproject_match_pallas_tiled as j_tiled,
)
from repro.kernels.reproject_match.ref import reproject_match_ref as j_ref
from repro_torch.core import geometry as tgeo
from repro_torch.kernels.reproject_match import ops
from repro_torch.kernels.reproject_match.fused import (
    reproject_match_fused,
    reproject_match_fused_ref,
)
from repro_torch.kernels.reproject_match.kernel import (
    reproject_match_pallas,
    reproject_match_pallas_tiled,
)
from repro_torch.kernels.reproject_match.ref import reproject_match_ref
from repro_torch.kernels.reproject_match.warp_order import (
    reproject_match_fused_warp_order,
    reproject_match_warp_order,
)

CASES = [(4, 16, 128, 32), (7, 16, 128, 64), (3, 32, 256, 64), (1, 8, 64, 16)]
# The kernel's warp at its edges: P^2 < 32 (lanes idle), P = 32 (32 pixels
# a lane), and a 144x144 frame (M = 81: bool rows not 4-byte aligned).
WARP_CASES = CASES + [(5, 2, 64, 16), (6, 5, 64, 16), (2, 32, 128, 32),
                      (9, 16, 144, 32)]
TAU, O_MIN, C_MIN = 0.08, 0.5, 0.6


def _assert_scores_close(ref, port):
    d0, c0, b0 = (np.asarray(x) for x in ref)
    d1, c1, b1 = (to_numpy(x) for x in port)
    np.testing.assert_allclose(d0, d1, atol=1e-5)
    np.testing.assert_allclose(c0, c1, atol=1e-5)
    np.testing.assert_allclose(b0, b1, atol=1e-3)


def _both(arrays, hw):
    """(jax args, torch args) for the same numpy inputs."""
    ji, ti = intrinsics_pair(hw)
    return (
        [jnp.asarray(a) for a in arrays] + [ji],
        [to_torch(a) for a in arrays] + [ti],
    )


def _edge_inputs(p=16, hw=128):
    """Entries that exercise the degenerate branches: all pixels behind
    the camera; the top rows behind (invalid bbox, valid pixels); windows
    clamped at each frame corner; a valid bbox with no pixel inside its
    window (``nvalid == 0``)."""
    rng = np.random.default_rng(3)
    trans = np.array(
        [
            [0.0, 0.0, -10.0],  # everything behind the camera
            [0.0, 0.0, -1.0],  # with the depth ramp below: top rows behind
            [-0.1, -0.1, 0.0],  # top-left corner: window clamped at 0, 0
            [0.1, -0.1, 0.0],  # top-right
            [-0.1, 0.1, 0.0],  # bottom-left
            [0.1, 0.1, 0.0],  # bottom-right: clamped at H - w, W - w
            [6.0, 0.0, 0.0],  # far off the frame: nvalid == 0
        ],
        np.float32,
    )
    n = trans.shape[0]
    t_rel = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    t_rel[:, :3, 3] = trans
    origin = np.array(
        [[56, 56], [56, 56], [0, 0], [0, hw - p], [hw - p, 0],
         [hw - p, hw - p], [56, 56]],
        np.float32,
    )
    depth = np.full((n, p, p), 1.0, np.float32)
    depth[1] = np.linspace(0.5, 1.5, p, dtype=np.float32)[:, None]
    rgb = rng.uniform(size=(n, p, p, 3)).astype(np.float32)
    frame = rng.uniform(size=(hw, hw, 3)).astype(np.float32)
    return [rgb, depth, origin, t_rel, frame]


def _matching_inputs(n=6, p=16, hw=64, seed=0):
    """Entries cut from a smooth frame and moved slightly, so that some
    (entry, patch) pairs pass every threshold and the fused rows hold
    both values."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    frame = np.stack(
        [0.5 + 0.4 * np.sin(xx / 9.0 + k) * np.cos(yy / 11.0 - k)
         for k in range(3)],
        -1,
    ).astype(np.float32)
    g = hw // p
    cells = rng.choice(g * g, n, replace=False)
    origin = np.stack([(cells // g) * p, (cells % g) * p], -1).astype(np.float32)
    rgb = np.stack(
        [frame[int(o[0]):int(o[0]) + p, int(o[1]):int(o[1]) + p] for o in origin]
    )
    rgb[n // 2:] = rng.uniform(size=rgb[n // 2:].shape)  # half cannot match
    depth = np.full((n, p, p), 2.0, np.float32)
    t_rel = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    t_rel[:, :2, 3] = rng.normal(scale=0.02, size=(n, 2))
    return [rgb, depth, origin, t_rel, frame]


@pytest.mark.parametrize("n,p,hw,window", CASES)
def test_plain_matches_jax_ref_and_pallas(n, p, hw, window):
    jargs, targs = _both(reproject_inputs(n * 7 + p, n, p, hw), hw)
    port = reproject_match_ref(*targs, window)
    _assert_scores_close(j_ref(*jargs, window), port)
    _assert_scores_close(
        j_pallas(*jargs, window=window, interpret=True), port
    )


@pytest.mark.parametrize("n,p,hw,window", WARP_CASES)
def test_warp_order_matches_jax_and_the_plain_version(n, p, hw, window):
    jargs, targs = _both(reproject_inputs(n * 7 + p, n, p, hw), hw)
    warp = reproject_match_warp_order(*targs, window)
    _assert_scores_close(j_ref(*jargs, window), warp)
    _assert_scores_close(
        j_pallas(*jargs, window=window, interpret=True), warp
    )
    plain = reproject_match_ref(*targs, window)
    for a, b in zip(warp[:2], plain[:2]):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=0,
                                   atol=1e-6)
    assert torch.equal(warp[2], plain[2])  # the same corner warp


@pytest.mark.parametrize("window", [16, 32, 64])
def test_warp_order_on_degenerate_entries(window):
    jargs, targs = _both(_edge_inputs(), 128)
    warp = reproject_match_warp_order(*targs, window)
    _assert_scores_close(j_ref(*jargs, window), warp)
    for a, b in zip(warp, reproject_match_ref(*targs, window)):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("hw", [64, 144])
def test_fused_warp_order_rows_match_jax(hw):
    p, window = 16, 32
    jargs, targs = _both(_matching_inputs(hw=hw, p=p), hw)
    jout = j_fused(*jargs, window=window, tau=TAU, o_min=O_MIN, c_min=C_MIN,
                   interpret=True)
    out = reproject_match_fused_warp_order(
        *targs, window=window, tau=TAU, o_min=O_MIN, c_min=C_MIN
    )
    _assert_scores_close(jout[:3], out[:3])
    assert out[3].shape == (6, (hw // p) ** 2)  # n = 6 entries, M patches
    for j, t in zip(jout[3:], out[3:]):
        np.testing.assert_array_equal(np.asarray(j), to_numpy(t))
    assert to_numpy(out[3]).any() and not to_numpy(out[3]).all()
    plain = reproject_match_fused_ref(
        *targs, window=window, tau=TAU, o_min=O_MIN, c_min=C_MIN
    )
    for a, b in zip(out[3:], plain[3:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("window", [16, 32, 64])
def test_degenerate_entries(window):
    jargs, targs = _both(_edge_inputs(), 128)
    diff, cov, bbox = reproject_match_ref(*targs, window)
    _assert_scores_close(j_ref(*jargs, window), (diff, cov, bbox))
    _assert_scores_close(
        j_pallas(*jargs, window=window, interpret=True), (diff, cov, bbox)
    )
    diff, cov = to_numpy(diff), to_numpy(cov)
    # All behind: no valid pixel, invalid bbox.
    assert diff[0] == 1.0 and cov[0] == 0.0
    # Top rows behind: the bbox is invalid, so coverage is 0 although the
    # lower rows are valid pixels.
    assert diff[1] < 1.0 and cov[1] == 0.0
    assert (cov[2:6] > 0).all()
    # Far off the frame: a valid bbox, but nothing inside the window.
    assert diff[6] == 1.0 and cov[6] == 0.0
    # The windows at the four frame corners are clamped inside the frame.
    from repro_torch.kernels.reproject_match.ref import window_origin

    worig = to_numpy(window_origin(bbox, window, (128, 128)))
    np.testing.assert_array_equal(
        worig[2:6],
        [[0, 0], [0, 128 - window], [128 - window, 0],
         [128 - window, 128 - window]],
    )


def test_fused_rows_match_jax_and_thresholded_scores():
    hw, p, window = 64, 16, 32
    jargs, targs = _both(_matching_inputs(hw=hw, p=p), hw)
    jd, jc, jb, jpair, jov = j_fused(
        *jargs, window=window, tau=TAU, o_min=O_MIN, c_min=C_MIN,
        interpret=True,
    )
    d, c, b, pair, ov = reproject_match_fused(
        *targs, window=window, tau=TAU, o_min=O_MIN, c_min=C_MIN
    )
    _assert_scores_close((jd, jc, jb), (d, c, b))
    np.testing.assert_array_equal(np.asarray(jpair), to_numpy(pair))
    np.testing.assert_array_equal(np.asarray(jov), to_numpy(ov))
    assert to_numpy(pair).any() and not to_numpy(pair).all()
    # The rows are the thresholded plain scores.
    _, origins = _patch_origins(hw, p)
    overlap = tgeo.bbox_overlap_fraction(b[:, None, :], origins[None], p)
    ref_ov = overlap >= O_MIN
    ref_pair = ((d <= TAU) & (c >= C_MIN))[:, None] & ref_ov
    assert torch.equal(ov, ref_ov) and torch.equal(pair, ref_pair)


def _patch_origins(hw, p):
    from repro_torch.core.tsrc import extract_patches

    return extract_patches(torch.zeros(hw, hw, 3), p)


@pytest.mark.parametrize("n", [13, 3])
def test_tiled_ragged_matches_jax(n):
    jargs, targs = _both(reproject_inputs(n * 13 + 8, n, 16, 128), 128)
    port = reproject_match_pallas_tiled(*targs, window=32)
    _assert_scores_close(
        j_tiled(*jargs, window=32, tile_n=8, interpret=True), port
    )
    for a, b in zip(port, reproject_match_pallas(*targs, window=32)):
        assert torch.equal(a, b)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor through each wrapper gives the plain result and no
    kernel launch."""
    wrappers = (reproject_match_pallas, reproject_match_pallas_tiled,
                reproject_match_fused)
    before = [w.launches for w in wrappers]
    _, targs = _both(reproject_inputs(1, 5, 16, 128), 128)
    plain = reproject_match_ref(*targs, 32)
    fused_plain = reproject_match_fused_ref(
        *targs, window=32, tau=TAU, o_min=O_MIN, c_min=C_MIN
    )
    outs = [
        reproject_match_pallas(*targs, window=32),
        reproject_match_pallas_tiled(*targs, window=32),
        reproject_match_fused(*targs, window=32)[:3],
    ]
    for out in outs:
        for a, b in zip(out, plain):
            assert torch.equal(a, b)
    for a, b in zip(reproject_match_fused(*targs, window=32), fused_plain):
        assert torch.equal(a, b)
    for backend in ("ref", "pallas", "pallas_tiled", "fused"):
        out = ops.reproject_match(*targs, window=32, backend=backend)
        for a, b in zip(out, plain):
            assert torch.equal(a, b)
    assert [w.launches for w in wrappers] == before == [0, 0, 0]


@pytest.mark.parametrize(
    "bad",
    ["dtype", "device_mix", "shape", "window_big", "window_small", "patch"],
)
def test_wrapper_rejects_bad_inputs(bad):
    args = [to_torch(a) for a in reproject_inputs(2, 3, 16, 64)]
    intr = intrinsics_pair(64)[1]
    window = 32
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "device_mix":
        args[4] = args[4].to("meta")
    elif bad == "shape":
        args[1] = args[1][:, :8]
    elif bad == "window_big":
        window = 65
    elif bad == "window_small":
        window = 1
    elif bad == "patch":
        args[0], args[1] = args[0][:, :1, :1], args[1][:, :1, :1]
    with pytest.raises((TypeError, ValueError)):
        reproject_match_pallas(*args, intr, window=window)
