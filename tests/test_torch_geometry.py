"""The Eq. 1 chain and the relative transform of the PyTorch port's
``core/geometry.py``, and ``core/hir.n_params``, against the JAX package.

The reference's own cases (``tests/test_geometry.py``: the identity
relative transform, the literal 4x4 Eq. 1 chain against lift -> transform
-> project, reprojecting there and back), on poses made by the
reference's ``rotation_xyz`` / ``pose_from_rt`` from seeded numpy angles
and translations.  Both packages get the same inputs; float32 on both
sides, so the tolerance is 1e-5 on values of order 1-100 (the two sum
the 4x4 products in other orders; pixels near 100 get 2e-5 relative).
The property bounds between the two formulations are the reference's
(``rtol=1e-4, atol=1e-3`` on pixels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch
from repro.core import geometry as jgeo
from repro.core import hir as jhir
from repro_torch import convert
from repro_torch.core import geometry as tgeo
from repro_torch.core import hir as thir

TOL = 1e-5


def _pose(seed):
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    trans = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
    return np.asarray(jgeo.pose_from_rt(jgeo.rotation_xyz(jnp.asarray(angles)),
                                        jnp.asarray(trans)))


def _intr():
    return (jgeo.Intrinsics.create(100.0, 64.0, 64.0),
            tgeo.Intrinsics.create(100.0, 64.0, 64.0, "cpu"))


@pytest.mark.parametrize("seeds", [(1, 1), (2, 9), (4, 7781)])
def test_relative_transform_matches_jax(seeds):
    a, b = map(_pose, seeds)
    j = np.asarray(jgeo.relative_transform(jnp.asarray(a), jnp.asarray(b)))
    t = tgeo.relative_transform(to_torch(a), to_torch(b))
    np.testing.assert_allclose(to_numpy(t), j, atol=TOL)
    if seeds[0] == seeds[1]:  # tests/test_geometry.py:32-34
        np.testing.assert_allclose(to_numpy(t), np.eye(4), atol=TOL)


def test_eq1_reproject_matches_jax_and_the_standard_pipeline():
    """tests/test_geometry.py:89: the literal chain equals lift ->
    transform -> project, here on fixed draws of its ranges."""
    rng = np.random.default_rng(0)
    uv = rng.uniform(1.0, 126.0, (64, 2)).astype(np.float32)
    d = rng.uniform(0.5, 20.0, 64).astype(np.float32)
    jintr, tintr = _intr()
    for seed in range(8):
        t_rel = _pose(seed)
        ja = jgeo.eq1_reproject(jnp.asarray(uv), jnp.asarray(d), jintr,
                                jnp.asarray(t_rel))
        ta = tgeo.eq1_reproject(to_torch(uv), to_torch(d), tintr,
                                to_torch(t_rel))
        np.testing.assert_array_equal(np.asarray(ja[2]), to_numpy(ta[2]))
        np.testing.assert_allclose(to_numpy(ta[0]), np.asarray(ja[0]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(to_numpy(ta[1]), np.asarray(ja[1]),
                                   atol=TOL)
        uv_s, z_s, v_s = tgeo.reproject_points(to_torch(uv), to_torch(d),
                                               tintr, to_torch(t_rel))
        assert torch.equal(v_s, ta[2])
        ok = to_numpy(v_s)
        np.testing.assert_allclose(to_numpy(ta[0])[ok], to_numpy(uv_s)[ok],
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(to_numpy(ta[1])[ok], to_numpy(z_s)[ok],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 17, 500])
def test_reprojection_there_and_back_matches_jax(seed):
    """tests/test_geometry.py:102: through relative_transform both ways."""
    a, b = _pose(seed), _pose(seed + 7777)
    jintr, tintr = _intr()
    uv = np.array([[50.0, 80.0], [10.0, 30.0]], np.float32)
    d = np.array([5.0, 2.5], np.float32)
    j_ab = jgeo.relative_transform(jnp.asarray(a), jnp.asarray(b))
    j_ba = jgeo.relative_transform(jnp.asarray(b), jnp.asarray(a))
    t_ab = tgeo.relative_transform(to_torch(a), to_torch(b))
    t_ba = tgeo.relative_transform(to_torch(b), to_torch(a))
    juv2, jz2, jv1 = jgeo.reproject_points(jnp.asarray(uv), jnp.asarray(d),
                                           jintr, j_ab)
    juv3, jz3, _ = jgeo.reproject_points(juv2, jz2, jintr, j_ba)
    tuv2, tz2, tv1 = tgeo.reproject_points(to_torch(uv), to_torch(d), tintr,
                                           t_ab)
    tuv3, tz3, tv2 = tgeo.reproject_points(tuv2, tz2, tintr, t_ba)
    np.testing.assert_array_equal(np.asarray(jv1), to_numpy(tv1))
    np.testing.assert_allclose(to_numpy(tuv3), np.asarray(juv3), atol=1e-4)
    np.testing.assert_allclose(to_numpy(tz3), np.asarray(jz3), atol=TOL)
    ok = to_numpy(tv1 & tv2)
    np.testing.assert_allclose(to_numpy(tuv3)[ok], uv[ok], rtol=1e-3,
                               atol=1e-2)


def test_hir_n_params_matches_jax():
    params = jhir.init_params(jax.random.PRNGKey(3))
    model = convert.hir_from_jax(jax.tree.map(np.asarray, params),
                                 device="cpu")
    assert thir.n_params(model) == jhir.n_params(params)
    assert thir.n_params(thir.init_params(torch.Generator().manual_seed(0))) \
        == jhir.n_params(params)
