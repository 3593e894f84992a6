"""The Mamba-2 SSD scan in the PyTorch port against the JAX package.

The same numpy inputs, made from fixed seeds with the reference test's
draws (``tests/test_kernels.py:238-256``: x, B, C ~ 0.5 N(0, 1), a_log =
-exp(0.5 N(0, 1) - 2)), go through the reference's sequential ``ref``,
its ``chunked`` form and its Pallas kernel in interpret mode, and through
the port's ``ref``, ``chunked`` and ``"pallas"`` route (on the CPU, the
kernel wrapper's plain version, ``mamba2_ssd_chunk_parallel``: the
kernel's decomposition).

Tolerance: 2e-4, the reference's own gate for the kernel against the
oracle (``tests/test_kernels.py:263-264``).  The forms sum in other
orders; at these scales they agree to about 1e-5.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch
from repro.kernels.mamba2_ssd.chunked import mamba2_ssd_chunked as j_chunked
from repro.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas as j_pallas
from repro.kernels.mamba2_ssd.ref import mamba2_ssd_ref as j_ref
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.mamba2_ssd import ops
from repro_torch.kernels.mamba2_ssd.chunked import (mamba2_ssd_chunk_parallel,
                                                    mamba2_ssd_chunked)
from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_ref
from repro_torch.models import mamba2

TOL = 2e-4
# The reference test's shapes (tests/test_kernels.py:250-255).
SHAPES = [(1, 2, 128, 32, 16, 32), (2, 4, 256, 64, 64, 64),
          (1, 1, 64, 64, 64, 64), (1, 3, 192, 32, 64, 32)]


def _inputs(seed, b, h, t, p, n, *, strong=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, t, p)) * 0.5
    z = rng.standard_normal((b, h, t))
    a_log = -np.exp(2.0 * z) if strong else -np.exp(z * 0.5 - 2.0)
    bm = rng.standard_normal((b, t, n)) * 0.5
    cm = rng.standard_normal((b, t, n)) * 0.5
    return [a.astype(np.float32) for a in (x, a_log, bm, cm)]


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
    y, s = ops.mamba2_ssd(*args, backend=backend, chunk=chunk)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    for form, (jy, js) in _jax_outputs(shape).items():
        np.testing.assert_allclose(np.asarray(jy), to_numpy(y), atol=TOL,
                                   err_msg=f"y vs the reference's {form}")
        np.testing.assert_allclose(np.asarray(js), to_numpy(s), atol=TOL,
                                   err_msg=f"h vs the reference's {form}")


@pytest.mark.parametrize("t", [128, 96])
def test_chunk_invariance(t):
    """As tests/test_kernels.py:267-274: the chunk size must not show in
    the result (T = 96 is padded by the chunked form)."""
    args = [to_torch(a) for a in _inputs(9, 1, 2, t, 32, 32)]
    y32, s32 = mamba2_ssd_chunked(*args, chunk=32)
    for chunk in (8, 16, 64):
        y, s = mamba2_ssd_chunked(*args, chunk=chunk)
        np.testing.assert_allclose(to_numpy(y32), to_numpy(y), atol=TOL)
        np.testing.assert_allclose(to_numpy(s32), to_numpy(s), atol=TOL)


@pytest.mark.parametrize("backend", ["ref", "chunked"])
def test_init_state_matches_the_reference(backend):
    x, a, bm, cm = _inputs(3, 2, 2, 64, 16, 16)
    s0 = np.random.default_rng(4).standard_normal((2, 2, 16, 16)).astype(
        np.float32)
    jfn = j_ref if backend == "ref" else functools.partial(j_chunked, chunk=16)
    jy, js = jfn(*map(jnp.asarray, (x, a, bm, cm, s0)))
    y, s = ops.mamba2_ssd(*map(to_torch, (x, a, bm, cm, s0)),
                          backend=backend, chunk=16)
    np.testing.assert_allclose(np.asarray(jy), to_numpy(y), atol=TOL)
    np.testing.assert_allclose(np.asarray(js), to_numpy(s), atol=TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_strong_decay_chunked_stays_finite_and_near_the_oracle(shape):
    """a_log = -exp(2 z): the chunked form and the kernel's plain version
    stay finite and within 2e-4 of the sequential oracle."""
    *dims, chunk = shape
    args = [to_torch(a) for a in _inputs(shape[2] + 7, *dims, strong=True)]
    y_ref, s_ref = mamba2_ssd_ref(*args)
    for y, s in (mamba2_ssd_chunked(*args, chunk=chunk),
                 mamba2_ssd_pallas(*args, chunk=chunk)):
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
        np.testing.assert_allclose(to_numpy(y_ref), to_numpy(y), atol=TOL)
        np.testing.assert_allclose(to_numpy(s_ref), to_numpy(s), atol=TOL)


def test_pallas_route_refuses_what_the_kernel_does_not_take():
    x, a, bm, cm = map(to_torch, _inputs(0, 1, 2, 48, 16, 8))
    s0 = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="zero state"):
        ops.mamba2_ssd(x, a, bm, cm, s0, backend="pallas", chunk=16)
    with pytest.raises(ValueError, match="T % min"):
        mamba2_ssd_pallas(x, a, bm, cm, chunk=32)
    with pytest.raises(TypeError, match="share"):
        mamba2_ssd_pallas(x, a.double(), bm, cm, chunk=16)
    with pytest.raises(ValueError, match="must both be"):
        mamba2_ssd_pallas(x, a, bm, cm[:, :, :4], chunk=16)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.mamba2_ssd(x, a, bm, cm, backend="bogus")
    before = mamba2_ssd_pallas.launches
    mamba2_ssd_pallas(x, a, bm, cm, chunk=16)
    assert mamba2_ssd_pallas.launches == before  # the CPU launches nothing


def _jax_ref_and_chunked(args, chunk):
    """The reference's sequential oracle and chunked form on float32 copies
    of the port's inputs (bf16 inputs widened, as the kernel widens them)."""
    jargs = [jnp.asarray(to_numpy(a.float())) for a in args]
    return {"ref": j_ref(*jargs), "chunked": j_chunked(*jargs, chunk=chunk)}


@pytest.mark.parametrize("shape", [(1, 2, 64, 16, 8, 64),
                                   (2, 3, 128, 32, 16, 32)],
                         ids=["T=C", "4 chunks"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["contiguous", "model"])
@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
def test_chunk_parallel_matches_the_reference(shape, dtype, layout, strong):
    """The plain version of the kernel's decomposition against the
    reference's ``ref`` and ``chunked`` forms: float32 and bf16 inputs, in
    the contiguous layout and in the models' ((B, T, H, .) seen as (B, H,
    T, .)), on the reference test's decay and the strong one."""
    *dims, chunk = shape
    x, a, bm, cm = (to_torch(v).to(dtype) for v in _inputs(
        sum(shape), *dims, strong=strong))
    if layout == "model":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
        assert not x.is_contiguous()
    y, s = mamba2_ssd_chunk_parallel(x, a, bm, cm, chunk=chunk)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    assert y.transpose(1, 2).is_contiguous()  # a (B, T, H, P) buffer
    for form, (jy, js) in _jax_ref_and_chunked((x, a, bm, cm), chunk).items():
        np.testing.assert_allclose(np.asarray(jy), to_numpy(y), atol=TOL,
                                   err_msg=f"y vs the reference's {form}")
        np.testing.assert_allclose(np.asarray(js), to_numpy(s), atol=TOL,
                                   err_msg=f"h vs the reference's {form}")
    py, ps = mamba2_ssd_chunked(x, a, bm, cm, chunk=chunk)
    np.testing.assert_allclose(to_numpy(py), to_numpy(y), atol=TOL)
    np.testing.assert_allclose(to_numpy(ps), to_numpy(s), atol=TOL)


def test_mixer_output_is_the_same_on_the_view():
    """The Zamba2 mixer with its scan on ``"pallas"`` (y the (B, H, T, P)
    view of a (B, T, H, P) buffer, the CPU route) and on ``"chunked"`` (a
    contiguous y): the same output and final SSM state."""
    cfg = get_smoke_config("zamba2-2.7b").replace(
        param_dtype="float32", compute_dtype="float32", scan_chunk=16)
    g = torch.Generator().manual_seed(0)
    p = mamba2.init_mamba_block(g, cfg, device="cpu")
    x = torch.randn(2, 48, cfg.d_model, generator=g)
    outs = {b: mamba2.mamba_block(p, x, cfg, backend=b, return_state=True)
            for b in ("pallas", "chunked")}
    (out, conv, ssm), (pout, pconv, pssm) = outs["pallas"], outs["chunked"]
    assert out.shape == (2, 48, cfg.d_model) and out.is_contiguous()
    np.testing.assert_allclose(to_numpy(out), to_numpy(pout), atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(conv, pconv)
    np.testing.assert_allclose(to_numpy(ssm), to_numpy(pssm), atol=TOL)
