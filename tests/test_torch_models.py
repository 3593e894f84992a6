"""Depth, HIR and the synthetic renderer in the PyTorch port against the
JAX package, with the JAX parameters carried across by
``repro_torch.convert``.

Tolerances: 1e-5 absolute for images, heatmaps and saliency logits
(values of order 1).  Depth is held to 1e-5 relative (plus 1e-5
absolute): it leaves a softplus with values up to about 10, and float32
convolutions that sum in another order differ by a few ulps of the value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import stream_64, to_numpy, to_torch
from repro.core import depth as jdepth
from repro.core import geometry as jgeo
from repro.core import hir as jhir
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.core import depth as tdepth
from repro_torch.core import geometry as tgeo
from repro_torch.core import hir as thir
from repro_torch.data import synthetic as tsyn


@pytest.fixture(scope="module")
def frames():
    return stream_64()["frames"][:6]


@pytest.fixture(scope="module")
def frames128():
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:128, 0:128].astype(np.float32)
    smooth = 0.5 + 0.4 * np.sin(xx / 7.0)[..., None] * np.cos(yy / 5.0)[..., None]
    noise = rng.uniform(size=(2, 128, 128, 3)).astype(np.float32)
    return np.clip(smooth + 0.2 * noise, 0.0, 1.0).astype(np.float32)


def _jax_params(init, seed):
    return init(jax.random.PRNGKey(seed))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("src,dst", [(128, 64), (64, 128), (64, 64)])
def test_resize_matches_jax(frames128, src, dst):
    img = frames128[:, :src, :src]
    j = jdepth.resize_image(jnp.asarray(img), dst)
    t = tdepth.resize_image(to_torch(img), dst)
    np.testing.assert_allclose(np.asarray(j), to_numpy(t), atol=1e-5)
    # Unbatched, and a one-channel map (the depth upsample).
    np.testing.assert_allclose(
        np.asarray(jdepth.resize_image(jnp.asarray(img[0]), dst)),
        to_numpy(tdepth.resize_image(to_torch(img[0]), dst)),
        atol=1e-5,
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_depth_forward_and_fullres_match_jax(frames, frames128, seed):
    params = _jax_params(jdepth.init_params, seed)
    model = convert.depth_from_jax(_np_tree(params), device="cpu")
    rgb64 = frames[:4]
    with torch.no_grad():
        t = tdepth.forward(model, to_torch(rgb64))
        tfull = tdepth.predict_fullres(model, to_torch(frames128[0]))
    np.testing.assert_allclose(
        np.asarray(jdepth.forward(params, jnp.asarray(rgb64))),
        to_numpy(t), rtol=1e-5, atol=1e-5,
    )
    jfull = jdepth.predict_fullres(params, jnp.asarray(frames128[0]))
    assert tfull.shape == (128, 128)
    np.testing.assert_allclose(np.asarray(jfull), to_numpy(tfull),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [3, 7])
def test_hir_forward_and_saliency_match_jax(frames, seed):
    params = _jax_params(jhir.init_params, seed)
    model = convert.hir_from_jax(_np_tree(params), device="cpu")
    gazes = stream_64()["gazes"][:6]
    rgb64 = jdepth.resize_image(jnp.asarray(frames), 64)
    jheat = jhir.gaze_heatmap(jnp.asarray(gazes), 64, (64, 64))
    theat = thir.gaze_heatmap(to_torch(gazes), 64, (64, 64))
    np.testing.assert_allclose(np.asarray(jheat), to_numpy(theat), atol=1e-5)
    jlog = jhir.forward(params, rgb64, jheat, 4)
    with torch.no_grad():
        tlog = thir.forward(model, tdepth.resize_image(to_torch(frames), 64),
                            theat, 4)
    np.testing.assert_allclose(np.asarray(jlog), to_numpy(tlog), atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(jhir.binary_saliency(jlog)),
        to_numpy(thir.binary_saliency(tlog)),
    )


def test_init_params_shapes_match_jax():
    g = torch.Generator().manual_seed(0)
    for jp, tm in (
        (jdepth.init_params(jax.random.PRNGKey(0)), tdepth.init_params(g)),
        (jhir.init_params(jax.random.PRNGKey(0)), thir.init_params(g)),
    ):
        assert jdepth.n_params(jp) == tdepth.n_params(tm)
        # Converting the JAX tree checks every shape against the module.
        module = type(tm)
        conv = (convert.depth_from_jax if module is tdepth.DepthNet
                else convert.hir_from_jax)
        conv(_np_tree(jp), device="cpu")


def _scene_arrays(seed, n_obj=4):
    rng = np.random.default_rng(seed)
    centers = np.stack(
        [np.linspace(-3.2, 3.2, n_obj), 1.2 - rng.uniform(0.55, 0.85, n_obj),
         rng.uniform(2.6, 6.5, n_obj)], -1,
    ).astype(np.float32)
    radii = (1.2 - centers[:, 1]).astype(np.float32)
    colors = rng.uniform(0.1, 0.9, size=(n_obj, 3)).astype(np.float32)
    freqs = (4.0 + 3.0 * (np.arange(n_obj) % 3)).astype(np.float32)
    return centers, radii, colors, freqs


def test_render_frame_matches_jax():
    hw = (64, 64)
    arrays = _scene_arrays(0)
    jscene = jsyn.Scene(*map(jnp.asarray, arrays))
    tscene = tsyn.Scene(*map(to_torch, arrays))
    eyes = np.array([[0.0, 0.0, -0.5], [0.5, -0.1, -0.2], [-0.6, 0.05, 0.3]],
                    np.float32)
    looks = eyes + np.array([0.1, 0.35, 5.0], np.float32)
    jintr = jgeo.Intrinsics.create(0.8 * 64, 32.0, 32.0)
    tintr = tgeo.Intrinsics.create(0.8 * 64, 32.0, 32.0, "cpu")
    jposes = jax.vmap(jsyn.look_at_pose)(jnp.asarray(eyes), jnp.asarray(looks))
    tposes = tsyn.look_at_pose(to_torch(eyes), to_torch(looks))
    np.testing.assert_allclose(np.asarray(jposes), to_numpy(tposes), atol=1e-6)
    for i in range(len(eyes)):
        jrgb, jd, jobj = jsyn.render_frame(jscene, jposes[i], jintr, hw)
        trgb, td, tobj = tsyn.render_frame(tscene, to_torch(jposes[i]), tintr, hw)
        np.testing.assert_array_equal(np.asarray(jobj), to_numpy(tobj))
        np.testing.assert_allclose(np.asarray(jd), to_numpy(td),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(np.asarray(jrgb), to_numpy(trgb), atol=1e-5)


def test_generate_stream_is_seeded_and_sane():
    cfg = tsyn.StreamConfig(n_frames=6, hw=(32, 32), n_obj=3)
    s1, _ = tsyn.generate_stream(np.random.default_rng(4), cfg, device="cpu")
    s2, _ = tsyn.generate_stream(np.random.default_rng(4), cfg, device="cpu")
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    assert s1.frames.shape == (6, 32, 32, 3) and s1.frames.dtype == torch.float32
    assert torch.isfinite(s1.frames).all() and (s1.depth > 0).all()
    assert ((s1.gazes >= 1.0) & (s1.gazes <= 30.0)).all()
    assert (s1.obj_id > 0).any()  # some object is in view
