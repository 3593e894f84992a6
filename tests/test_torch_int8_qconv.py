"""The fused int8 convolution (``qconv_int8_pallas``) of the PyTorch port.

On CPU tensors the wrapper takes its plain version, the composition
``quantize_activation -> im2col -> int8 product -> (acc sx) wscale -> + b
-> relu``.  It is held bitwise (``torch.equal``) to the depth network's
composition before the fused launch existed (``depth._qconv(...) + b``,
then ``relu``), at the eight dense and pointwise layers of one 64x64
frame and at edge cases, and within ``FWD_ATOL = 1e-5`` to the JAX
package's jitted ``_qconv`` plus bias and ReLU (``repro/core/depth.py``),
the tolerance of ``tests/test_torch_depth_int8.py``.  The kernel itself is
held bitwise to the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import to_numpy, to_torch
from repro.core import depth as jdepth
from repro_torch.core import depth as tdepth
from repro_torch.kernels.int8_matmul import ops
from repro_torch.kernels.int8_matmul.qconv import (conv_int32,
                                                   qconv_int8_pallas,
                                                   qconv_int8_ref,
                                                   quantize_activation)

FWD_ATOL = 1e-5

# (label, input (N, H, W, cin), k, cout, stride, relu): the eight layers of
# forward_int8 at its 64x64 input, then the edge cases.
FRAME_LAYERS = [
    ("enc0", (1, 64, 64, 3), 3, 16, 2, True),
    ("enc1.pw", (1, 16, 16, 16), 1, 32, 1, True),
    ("enc2.pw", (1, 8, 8, 32), 1, 64, 1, True),
    ("enc3.pw", (1, 8, 8, 64), 1, 64, 1, True),
    ("dec0.pw", (1, 16, 16, 64), 1, 32, 1, True),
    ("dec1.pw", (1, 32, 32, 32), 1, 16, 1, True),
    ("dec2.pw", (1, 64, 64, 16), 1, 16, 1, True),
    ("head", (1, 64, 64, 16), 3, 1, 1, False),
]
EDGE_LAYERS = [
    ("odd H and W at stride 2", (2, 33, 31, 8), 3, 16, 2, True),
    ("K=27, odd input at stride 2", (1, 15, 17, 3), 3, 5, 2, True),
    ("N=1 without ReLU", (1, 12, 10, 16), 3, 1, 1, False),
    ("M=75 (no multiple of a tile)", (3, 5, 5, 12), 1, 70, 1, True),
    ("K=300 (past one staged tile)", (1, 9, 7, 300), 1, 9, 1, True),
]


def _layer(shape, k, cout, seed, *, scale=2.0):
    """x, xscale (its max-abs), int8 weight in the im2col layout, wscale
    and b, as numpy; x centred so that the ReLU cuts some outputs."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    w = rng.integers(-127, 128, (k * k * shape[-1], cout)).astype(np.int8)
    wscale = rng.uniform(1e-3, 2e-2, cout).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, np.float32(np.abs(x).max()), w, wscale, b


def _before(x, xscale, w, wscale, b, stride, relu):
    """The depth network's composition before the fused launch."""
    out = tdepth._qconv(x, w, wscale, xscale, stride, backend="ref") + b
    return F.relu(out) if relu else out


def _jax(x, xscale, w, wscale, b, k, stride, relu):
    fn = jax.jit(jdepth._qconv, static_argnums=(4,))
    out = fn(jnp.asarray(x), jnp.asarray(w.reshape(k, k, x.shape[-1], -1)),
             jnp.asarray(wscale), jnp.asarray(xscale), stride) + b
    return np.asarray(jax.nn.relu(out) if relu else out)


@pytest.mark.parametrize("label,shape,k,cout,stride,relu",
                         FRAME_LAYERS + EDGE_LAYERS,
                         ids=[c[0] for c in FRAME_LAYERS + EDGE_LAYERS])
def test_qconv_is_bitwise_the_composition_and_near_jax(label, shape, k, cout,
                                                       stride, relu):
    x, xscale, w, wscale, b = _layer(shape, k, cout, sum(shape) + k + cout)
    args = [to_torch(a) for a in (x, xscale, w, wscale, b)]
    before = qconv_int8_pallas.launches
    got = qconv_int8_pallas(*args, stride=stride, relu=relu)
    assert qconv_int8_pallas.launches == before  # the CPU launches nothing
    ho, wo = -(-shape[1] // stride), -(-shape[2] // stride)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (shape[0], ho, wo, cout)
    assert torch.equal(got, _before(*args, stride, relu))
    np.testing.assert_allclose(to_numpy(got),
                               _jax(x, xscale, w, wscale, b, k, stride, relu),
                               atol=FWD_ATOL, rtol=0)


def test_all_zero_input_takes_the_clamped_scale():
    """max|x| = 0: the scale is clamped to 1e-8, every q is 0 and the
    output is relu(b)."""
    x, _, w, wscale, b = _layer((1, 6, 6, 8), 3, 4, 3)
    x[:] = 0.0
    args = [to_torch(a) for a in (x, np.float32(0.0), w, wscale, b)]
    got = qconv_int8_pallas(*args, stride=2)
    assert torch.equal(got, _before(*args, 2, True))
    assert torch.equal(got, F.relu(to_torch(b)).expand_as(got))
    np.testing.assert_allclose(
        to_numpy(got), _jax(x, np.float32(0.0), w, wscale, b, 3, 2, True),
        atol=FWD_ATOL, rtol=0)


def test_half_steps_round_to_even():
    """x exactly half a step between two int8 values (xscale 127 makes
    the step 1.0): rint rounds to the even neighbour, as the reference's
    jnp.round does."""
    halves = np.arange(-130, 130, dtype=np.float32) + 0.5
    x = np.resize(halves, (1, 10, 13, 4)).astype(np.float32)
    xs = np.float32(127.0)
    q, sx = quantize_activation(to_torch(x), torch.tensor(xs))
    assert float(sx) == 1.0
    want = np.clip(np.round(x), -127, 127)  # numpy rounds half to even
    np.testing.assert_array_equal(to_numpy(q), want.astype(np.int8))
    _, _, w, wscale, b = _layer(x.shape, 3, 6, 5)
    args = [to_torch(a) for a in (x, xs, w, wscale, b)]
    got = qconv_int8_pallas(*args)
    assert torch.equal(got, _before(*args, 1, True))
    np.testing.assert_allclose(to_numpy(got),
                               _jax(x, xs, w, wscale, b, 3, 1, True),
                               atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("label,shape,k,cout,stride,relu", EDGE_LAYERS,
                         ids=[c[0] for c in EDGE_LAYERS])
def test_conv_int32_is_exact_at_the_edge_shapes(label, shape, k, cout,
                                                stride, relu):
    """The plain int32 convolution under the composition against the JAX
    package's int32 ``SAME`` convolution, exactly: odd sizes pad as XLA
    pads at stride 2."""
    rng = np.random.default_rng(sum(shape) + k)
    qx = rng.integers(-127, 128, shape).astype(np.int8)
    w = rng.integers(-127, 128, (k * k * shape[-1], cout)).astype(np.int8)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(qx, jnp.int32),
        jnp.asarray(w.reshape(k, k, shape[-1], cout), jnp.int32),
        (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv_int32(to_torch(qx), to_torch(w), stride)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("backend", ops.BACKENDS)
def test_dispatcher_backends_are_the_plain_composition(backend):
    x, xscale, w, wscale, b = _layer((2, 9, 9, 8), 3, 12, 11)
    args = [to_torch(a) for a in (x, xscale, w, wscale, b)]
    got = ops.qconv_int8(*args, stride=2, backend=backend)
    assert torch.equal(got, qconv_int8_ref(*args, stride=2))


def test_dispatcher_rejects_an_unknown_backend():
    args = [to_torch(a) for a in _layer((1, 4, 4, 4), 1, 2, 0)]
    with pytest.raises(ValueError, match="known"):
        ops.qconv_int8(*args, backend="bogus")


def _bad(change):
    args = dict(zip(("x", "xscale", "qw", "wscale", "b"),
                    (to_torch(a) for a in _layer((1, 6, 6, 8), 3, 4, 0))))
    args.update(change(args))
    return args


@pytest.mark.parametrize("change,error,match", [
    (lambda a: {"x": a["x"].double()}, TypeError, "float32"),
    (lambda a: {"qw": a["qw"].float()}, TypeError, "int8"),
    (lambda a: {"xscale": a["xscale"].to("meta")}, ValueError,
     "different devices"),
    # One scale per image is the contract too: a 1-D xscale of another
    # length than the batch is not.
    (lambda a: {"xscale": a["xscale"].reshape(1).expand(2)}, ValueError,
     "0-dim or one per image"),
    (lambda a: {"qw": a["qw"][:70]}, ValueError, "k k cin"),
    (lambda a: {"wscale": a["wscale"][:3]}, ValueError, r"\(4,\)"),
    (lambda a: {"x": a["x"][0]}, ValueError, "N, H, W, cin"),
], ids=["x float64", "weight float32", "xscale elsewhere", "xscale 1-D",
        "weight rows", "wscale shape", "x 3-D"])
def test_wrapper_rejects_inputs_outside_the_contract(change, error, match):
    args = _bad(change)
    before = qconv_int8_pallas.launches
    with pytest.raises(error, match=match):
        qconv_int8_pallas(args["x"], args["xscale"], args["qw"],
                          args["wscale"], args["b"])
    assert qconv_int8_pallas.launches == before


def test_forward_int8_backends_are_bitwise_equal():
    """``forward_int8`` on ``"pallas"`` (the fused launch's route) and
    ``"ref"``: one output, bitwise, on the CPU."""
    g = torch.Generator().manual_seed(0)
    net = tdepth.init_params(g)
    q = tdepth.quantize_params(net, torch.rand(4, 64, 64, 3, generator=g))
    x = torch.rand(2, 64, 64, 3, generator=g)
    outs = {}
    for backend in ops.BACKENDS:
        q.matmul_backend = backend
        outs[backend] = tdepth.forward_int8(q, x)
    assert outs["ref"].shape == (2, 64, 64)
    assert all(torch.equal(outs["ref"], o) for o in outs.values())
