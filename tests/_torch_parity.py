"""Shared parity helpers for the PyTorch port's tests.

One set of numpy inputs, made from a seed, goes through the JAX package
and through its counterpart in ``repro_torch`` on the CPU; the results
are compared leaf by leaf: integers and booleans exactly, floats within a
stated tolerance.  TF32 is off (it matters only on a CUDA card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
# The suite runs in several worker processes; one intra-op thread each.
torch.set_num_threads(1)

FLOAT_ATOL = 1e-5


def to_torch(x):
    """numpy (or JAX) array -> a writable CPU tensor of the same dtype."""
    return None if x is None else torch.from_numpy(np.array(x))


def to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_leaves_match(ref, port, *, atol=FLOAT_ATOL, rtol=0.0, what=""):
    """Compare two sequences of leaves: exact for ints/bools, allclose for
    floats."""
    ref, port = list(ref), list(port)
    assert len(ref) == len(port), (what, len(ref), len(port))
    for i, (a, b) in enumerate(zip(ref, port)):
        a, b = np.asarray(a), to_numpy(b)
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what}[{i}]")
        else:
            np.testing.assert_allclose(
                a, b, atol=atol, rtol=rtol, err_msg=f"{what}[{i}]"
            )


def assert_namedtuple_match(ref, port, **kw):
    """Field-by-field :func:`assert_leaves_match` of two NamedTuples."""
    assert ref._fields == port._fields, (ref._fields, port._fields)
    for f in ref._fields:
        a, b = getattr(ref, f), getattr(port, f)
        if a is None or b is None:
            assert a is None and b is None, f
            continue
        assert_leaves_match([a], [b], what=f, **kw)


def reproject_inputs(seed, n, p, hw):
    """Random reproject-match inputs as numpy (the reference tests'
    distribution: uniform RGB, depth in [1, 4], small random motions)."""
    import jax.numpy as jnp

    from repro.core import geometry as geo

    rng = np.random.default_rng(seed)
    rgb = rng.uniform(size=(n, p, p, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, size=(n, p, p)).astype(np.float32)
    origin = np.stack(
        [rng.integers(0, hw - p, n), rng.integers(0, hw - p, n)], -1
    ).astype(np.float32)
    angles = (rng.normal(size=(n, 3)) * 0.05).astype(np.float32)
    trans = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    t_rel = np.asarray(
        geo.pose_from_rt(geo.rotation_xyz(jnp.asarray(angles)),
                         jnp.asarray(trans))
    )
    frame = rng.uniform(size=(hw, hw, 3)).astype(np.float32)
    return [rgb, depth, origin, t_rel, frame]


def intrinsics_pair(hw):
    """The same intrinsics for both packages: ``(jax, torch)``."""
    from repro.core import geometry as jgeo
    from repro_torch.core import geometry as tgeo

    f, c = 0.8 * hw, hw / 2.0
    return jgeo.Intrinsics.create(f, c, c), tgeo.Intrinsics.create(f, c, c, "cpu")


@functools.lru_cache(maxsize=None)
def stream_64(n_frames=40):
    """The ``tests/test_stages.py`` stream (64x64, 4 objects, key 0),
    rendered once by the JAX package, as numpy arrays."""
    import jax

    from repro.data import synthetic as jsyn

    scfg = jsyn.StreamConfig(n_frames=n_frames, hw=(64, 64), n_obj=4)
    s, _ = jsyn.generate_stream(jax.random.PRNGKey(0), scfg)
    return {
        k: np.asarray(getattr(s, k))
        for k in ("frames", "poses", "gazes", "depth")
    }


def perturb_constant_leaves(params, seed=0, scale=0.1):
    """A parameter pytree as numpy, each leaf that an ``init`` fills with
    one value (zeros, ones, a constant decay) moved by seeded noise, so
    that parity runs exercise the terms those leaves would switch off; the
    random leaves are kept as drawn."""
    import jax

    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        if a.size > 1 and np.all(a == a.flat[0]):
            return (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree.map(move, params)
