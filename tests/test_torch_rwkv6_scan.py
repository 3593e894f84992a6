"""The RWKV6 scan in the PyTorch port against the JAX package.

The same numpy inputs, made from fixed seeds with the reference test's
draws (``tests/test_kernels.py:205-223``: r, k, v ~ 0.5 N(0, 1), w_log =
-exp(0.5 N(0, 1) - 2), u ~ 0.3 N(0, 1)), go through the reference's
sequential ``ref``, its ``chunked`` form and its Pallas kernel in
interpret mode, and through the port's ``ref``, ``chunked`` and
``"pallas"`` route (on the CPU, the kernel wrapper's plain version,
``rwkv6_scan_chunk_parallel``: the kernel's decomposition).

Tolerance: 2e-4, the reference's own gate for the kernel against the
oracle (``tests/test_kernels.py:231-232``).  The forms sum in other
orders; at these scales they agree to a few 1e-6.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch
from repro.kernels.rwkv6_scan.chunked import rwkv6_scan_chunked as j_chunked
from repro.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas as j_pallas
from repro.kernels.rwkv6_scan.ref import rwkv6_scan_ref as j_ref
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.rwkv6_scan.chunked import (LEAF,
                                                    rwkv6_scan_chunk_parallel,
                                                    rwkv6_scan_chunked)
from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

TOL = 2e-4
# The reference test's shapes (tests/test_kernels.py:218-223).
SHAPES = [(1, 2, 128, 32, 32, 32), (2, 4, 256, 64, 64, 64),
          (1, 1, 64, 16, 48, 16), (1, 2, 192, 64, 64, 64)]


def _inputs(seed, b, h, t, dk, dv, *, strong=False):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((b, h, t, dk)) * 0.5
    k = rng.standard_normal((b, h, t, dk)) * 0.5
    v = rng.standard_normal((b, h, t, dv)) * 0.5
    z = rng.standard_normal((b, h, t, dk))
    w_log = -np.exp(2.0 * z) if strong else -np.exp(z * 0.5 - 2.0)
    u = rng.standard_normal((h, dk)) * 0.3
    return [a.astype(np.float32) for a in (r, k, v, w_log, u)]


@functools.lru_cache(maxsize=None)
def _jax_outputs(shape):
    """The reference's three forms on one shape's inputs, as numpy."""
    *dims, chunk = shape
    args = [jnp.asarray(a) for a in _inputs(shape[2] + shape[3], *dims)]
    return {
        "ref": j_ref(*args),
        "chunked": j_chunked(*args, chunk=chunk),
        "pallas": j_pallas(*args, chunk=chunk, interpret=True),
    }


@pytest.mark.parametrize("backend", ["ref", "chunked", "pallas"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_scan_matches_the_reference_forms(shape, backend):
    *dims, chunk = shape
    args = [to_torch(a) for a in _inputs(shape[2] + shape[3], *dims)]
    o, s = ops.rwkv6_scan(*args, backend=backend, chunk=chunk)
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    for form, (jo, js) in _jax_outputs(shape).items():
        np.testing.assert_allclose(np.asarray(jo), to_numpy(o), atol=TOL,
                                   err_msg=f"o vs the reference's {form}")
        np.testing.assert_allclose(np.asarray(js), to_numpy(s), atol=TOL,
                                   err_msg=f"S vs the reference's {form}")


@pytest.mark.parametrize("t", [128, 96])
def test_chunk_invariance(t):
    """Chunk size is an implementation detail (as
    tests/test_kernels.py:267-274 holds the SSD kernel); T = 96 is padded
    by the chunked form to a multiple of 64."""
    args = [to_torch(a) for a in _inputs(9, 1, 2, t, 32, 32)]
    o32, s32 = rwkv6_scan_chunked(*args, chunk=32)
    for chunk in (8, 16, 64):
        o, s = rwkv6_scan_chunked(*args, chunk=chunk)
        np.testing.assert_allclose(to_numpy(o32), to_numpy(o), atol=TOL)
        np.testing.assert_allclose(to_numpy(s32), to_numpy(s), atol=TOL)


@pytest.mark.parametrize("backend", ["ref", "chunked"])
def test_init_state_matches_the_reference(backend):
    r, k, v, w, u = _inputs(3, 2, 2, 64, 16, 16)
    s0 = np.random.default_rng(4).standard_normal((2, 2, 16, 16)).astype(
        np.float32)
    jfn = j_ref if backend == "ref" else functools.partial(j_chunked, chunk=16)
    jo, js = jfn(*map(jnp.asarray, (r, k, v, w, u, s0)))
    o, s = ops.rwkv6_scan(*map(to_torch, (r, k, v, w, u, s0)),
                          backend=backend, chunk=16)
    np.testing.assert_allclose(np.asarray(jo), to_numpy(o), atol=TOL)
    np.testing.assert_allclose(np.asarray(js), to_numpy(s), atol=TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_strong_decay_chunked_stays_finite_and_near_the_oracle(shape):
    """w_log = -exp(2 z): decays down to e^-400 a step.  The chunked form
    (and the kernel's plain version) must stay finite and within 2e-4 of
    the sequential oracle, which its float64 cumsums
    (``kernels/_cumsum.py``) make possible."""
    *dims, chunk = shape
    args = [to_torch(a) for a in _inputs(shape[2] + 7, *dims, strong=True)]
    o_ref, s_ref = rwkv6_scan_ref(*args)
    for o, s in (rwkv6_scan_chunked(*args, chunk=chunk),
                 rwkv6_scan_pallas(*args, chunk=chunk)):
        assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
        np.testing.assert_allclose(to_numpy(o_ref), to_numpy(o), atol=TOL)
        np.testing.assert_allclose(to_numpy(s_ref), to_numpy(s), atol=TOL)


def test_pallas_route_refuses_what_the_kernel_does_not_take():
    r, k, v, w, u = map(to_torch, _inputs(0, 1, 2, 48, 16, 16))
    s0 = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="zero state"):
        ops.rwkv6_scan(r, k, v, w, u, s0, backend="pallas", chunk=16)
    with pytest.raises(ValueError, match="T % min"):
        rwkv6_scan_pallas(r, k, v, w, u, chunk=32)
    with pytest.raises(TypeError, match="share"):
        rwkv6_scan_pallas(r, k.double(), v, w, u, chunk=16)
    with pytest.raises(ValueError, match="shaped as r"):
        rwkv6_scan_pallas(r, k[:, :, :8], v, w, u, chunk=8)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.rwkv6_scan(r, k, v, w, u, backend="bogus")
    before = rwkv6_scan_pallas.launches
    rwkv6_scan_pallas(r, k, v, w, u, chunk=16)
    assert rwkv6_scan_pallas.launches == before  # the CPU launches nothing


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunk_parallel_matches_the_reference_forms(shape):
    """The kernel's decomposition, called directly, at the reference
    test's shapes against the reference's three forms."""
    *dims, chunk = shape
    args = [to_torch(a) for a in _inputs(shape[2] + shape[3], *dims)]
    o, s = rwkv6_scan_chunk_parallel(*args, chunk=chunk)
    assert o.transpose(1, 2).is_contiguous()  # a (B, T, H, V) buffer
    for form, (jo, js) in _jax_outputs(shape).items():
        np.testing.assert_allclose(np.asarray(jo), to_numpy(o), atol=TOL,
                                   err_msg=f"o vs the reference's {form}")
        np.testing.assert_allclose(np.asarray(js), to_numpy(s), atol=TOL,
                                   err_msg=f"S vs the reference's {form}")


def _jax_forms(args, chunk, strong):
    """The reference's forms on float32 copies of the port's inputs (bf16
    widened, as the kernel widens them).  On a strong decay only the
    sequential oracle: the reference's chunked form takes float32 cumsums
    (past the gate on such draws) and its Pallas body's exp(-W) overflows
    once a chunk's summed decay passes about 88."""
    jargs = [jnp.asarray(to_numpy(a.float())) for a in args]
    forms = {"ref": j_ref(*jargs)}
    if not strong:
        forms["chunked"] = j_chunked(*jargs, chunk=chunk)
        forms["pallas"] = j_pallas(*jargs, chunk=chunk, interpret=True)
    return forms


# (B, H, T, K, V, chunk): T = C, several chunks, and chunks of one leaf (of
# LEAF rows), a leaf and a half, two, three, four, five and eight leaves;
# K = 72 takes the kernel's 64-channel tiles twice, the second partial, with
# V = 30 not a multiple of 4.
PARALLEL_SHAPES = [(1, 2, 32, 16, 16, 32), (2, 3, 128, 32, 24, 32),
                   (2, 2, 64, 8, 16, 8), (1, 2, 36, 8, 8, 12),
                   (1, 2, 48, 16, 16, 16), (1, 2, 72, 16, 8, 24),
                   (1, 2, 80, 16, 16, 40), (1, 2, 128, 32, 32, 64),
                   (1, 2, 32, 72, 30, 16)]


@pytest.mark.parametrize("shape", PARALLEL_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "model"])
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
def test_chunk_parallel_matches_the_reference(shape, dtype, layout, strong):
    """The plain version of the kernel's decomposition against the
    reference: float32 and bf16 inputs, in the contiguous layout and in the
    models' ((B, T, H, .) seen as (B, H, T, .)), on the reference test's
    decay and the strong one, at chunks on either side of the leaf and
    level edges; and against the port's chunked form."""
    *dims, chunk = shape
    r, k, v, w, u = (to_torch(a) for a in _inputs(sum(shape), *dims,
                                                  strong=strong))
    r, k, v, w = (x.to(dtype) for x in (r, k, v, w))
    if layout == "model":
        r, k, v, w = (x.transpose(1, 2).contiguous().transpose(1, 2)
                      for x in (r, k, v, w))
        assert not r.is_contiguous()
    args = (r, k, v, w, u)
    o, s = rwkv6_scan_chunk_parallel(*args, chunk=chunk)
    assert o.dtype == torch.float32 and s.dtype == torch.float32
    assert o.transpose(1, 2).is_contiguous()  # a (B, T, H, V) buffer
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(s).all())
    for form, (jo, js) in _jax_forms(args, chunk, strong).items():
        np.testing.assert_allclose(np.asarray(jo), to_numpy(o), atol=TOL,
                                   err_msg=f"o vs the reference's {form}")
        np.testing.assert_allclose(np.asarray(js), to_numpy(s), atol=TOL,
                                   err_msg=f"S vs the reference's {form}")
    po, ps = rwkv6_scan_chunked(*args, chunk=chunk)
    np.testing.assert_allclose(to_numpy(po), to_numpy(o), atol=TOL)
    np.testing.assert_allclose(to_numpy(ps), to_numpy(s), atol=TOL)


def test_leaves_cover_the_chunks_tested():
    """The edge shapes above take one leaf, a partial second one, and two
    to eight whole ones (one to three levels of products)."""
    assert sorted({min(s[-1], s[2]) / LEAF for s in PARALLEL_SHAPES}) == [
        1, 1.5, 2, 3, 4, 5, 8]
