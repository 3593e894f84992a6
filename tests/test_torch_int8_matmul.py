"""The int8 matmul op of the PyTorch port against the JAX package's
Pallas kernel (interpret mode), exactly, at the reference test's shapes
(``tests/test_kernels.py``) and the all--128 case; its dispatcher and
the wrapper's input checks.  The inputs are drawn with numpy and handed
to both packages.  The CUDA kernel itself is held against the plain
version on the card in ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_torch
from repro.kernels.int8_matmul.kernel import int8_matmul_pallas as jpallas
from repro.kernels.int8_matmul.ref import int8_matmul_ref as jref
from repro_torch.kernels.int8_matmul import ops
from repro_torch.kernels.int8_matmul.kernel import int8_matmul_pallas
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

SHAPES = [(128, 128, 128), (256, 384, 128), (130, 200, 70), (1, 9, 1),
          (64, 1, 64)]


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    return a, b


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_plain_version_equals_the_pallas_kernel(m, k, n):
    a, b = _operands(m, k, n, m + k + n)
    want = np.asarray(jpallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = int8_matmul_ref(to_torch(a), to_torch(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        np.asarray(jref(jnp.asarray(a), jnp.asarray(b))), want)


def test_extremes_are_exact():
    """All -128 at K=512: 512 * 128^2 = 2^23 in every output."""
    a = np.full((64, 512), -128, np.int8)
    b = np.full((512, 64), -128, np.int8)
    want = np.asarray(jpallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    got = int8_matmul_ref(to_torch(a), to_torch(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert int(got[0, 0]) == 512 * 128 * 128


def test_int8_product_of_pytorch_wraps_on_the_cpu():
    """Why the plain version widens first: ``int8 @ int8`` stays int8."""
    a = torch.full((1, 4), 100, dtype=torch.int8)
    b = torch.full((4, 1), 100, dtype=torch.int8)
    assert (a @ b).dtype == torch.int8
    assert int(int8_matmul_ref(a, b)) == 40000


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_dispatcher_backends_agree_on_the_cpu(backend):
    a, b = _operands(130, 200, 70, 0)
    before = int8_matmul_pallas.launches
    out = ops.int8_matmul(to_torch(a), to_torch(b), backend=backend)
    np.testing.assert_array_equal(
        out.numpy(), int8_matmul_ref(to_torch(a), to_torch(b)).numpy())
    # On the CPU the wrapper takes its plain version: no kernel launch.
    assert int8_matmul_pallas.launches == before


def test_dispatcher_rejects_an_unknown_backend():
    a, b = _operands(2, 3, 4, 0)
    with pytest.raises(ValueError, match="pallas"):
        ops.int8_matmul(to_torch(a), to_torch(b), backend="bogus")


def _i8(*shape):
    return torch.zeros(shape, dtype=torch.int8)


@pytest.mark.parametrize(
    "a,b,error,match",
    [
        (_i8(4, 3), _i8(4, 2), ValueError, "inner dims"),
        (_i8(4), _i8(4, 2), ValueError, "2-D"),
        (_i8(0, 3), _i8(3, 2), ValueError, "empty"),
        (torch.zeros(4, 3), _i8(3, 2), TypeError, "int8"),
        (_i8(1, 1 << 17), _i8(1 << 17, 1), ValueError, "overflow"),
    ],
)
def test_wrapper_rejects_inputs_outside_the_contract(a, b, error, match):
    with pytest.raises(error, match=match):
        int8_matmul_pallas(a, b)
