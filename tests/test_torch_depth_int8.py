"""The int8 depth path of the PyTorch port against the JAX package:
quantisation, each layer's int32 accumulator, ``forward_int8`` and the
compressor with an int8 depth network.  One set of numpy inputs goes to
both packages; the JAX ``QuantizedParams`` reach the port through
``repro_torch.convert.quantized_depth_from_jax``.

Tolerances, with their reasons:

* int8 weights, their scales, biases and every int32 accumulator: exact.
* ``act_scale`` is the max-abs of a float32 convolution's output on the
  calibration batch; XLA and PyTorch's CPU convolution sum in other
  orders, so past the first layer it may differ by a few ulps (held to
  4e-7 relative; the first layer's, the input's max-abs, is exact).
* ``forward_int8``: within 1e-5 of ``jax.jit(forward_int8)``, the form the
  pipeline runs (values are depths of order 1-10; XLA may fuse a
  dequantisation's product and bias add).  XLA also compiles the
  activation scale ``max(s, 1e-8) / 127`` as a product with
  float32(1/127), which eager JAX does not: on frame 12 of the
  ``stream_64`` run that ulp flips a rounded activation and moves 9 depth
  pixels by up to 0.0135 between eager and jitted JAX.  The port computes
  the scale as the jitted reference does, so it holds to 1e-5 there too.
* Compressor: counters and integer/boolean buffer state exact; float
  state within 1e-5 absolute and relative, as the fp32 depth case of
  ``tests/test_torch_pipeline.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_leaves_match, stream_64, to_numpy, to_torch
from repro import api as japi
from repro.core import depth as jdepth
from repro.core import hir as jhir
from repro.core import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro_torch import api as tapi
from repro_torch import convert
from repro_torch.core import depth as tdepth
from repro_torch.core import pipeline as tpipe
from repro_torch.data import synthetic as tsyn

ACT_SCALE_RTOL = 4e-7
FWD_ATOL = 1e-5

# (layer, weight key, input (H, W, C) at the 64x64 depth input, stride)
CONVS = [
    ("enc0", "w", (64, 64, 3), 2),
    ("enc1", "dw", (32, 32, 16), 2), ("enc1", "pw", (16, 16, 16), 1),
    ("enc2", "dw", (16, 16, 32), 2), ("enc2", "pw", (8, 8, 32), 1),
    ("enc3", "dw", (8, 8, 64), 1), ("enc3", "pw", (8, 8, 64), 1),
    ("dec0", "dw", (16, 16, 64), 1), ("dec0", "pw", (16, 16, 64), 1),
    ("dec1", "dw", (32, 32, 32), 1), ("dec1", "pw", (32, 32, 32), 1),
    ("dec2", "dw", (64, 64, 16), 1), ("dec2", "pw", (64, 64, 16), 1),
    ("head", "w", (64, 64, 16), 1),
]


@pytest.fixture(scope="module")
def calib():
    """The calibration batch, drawn and rendered by the port (numpy)."""
    scfg = tsyn.StreamConfig(n_frames=6, hw=(32, 32), n_obj=3)
    rgb64, d64 = tsyn.depth_training_batch(np.random.default_rng(0), scfg, 4,
                                           device="cpu")
    assert tuple(rgb64.shape) == (4, 64, 64, 3)
    assert tuple(d64.shape) == (4, 64, 64)
    return to_numpy(rgb64)


@pytest.fixture(scope="module")
def nets(calib):
    """``(jax params, jax QuantizedParams, port DepthNet, port
    QuantizedParams converted from the JAX one)``."""
    params = jdepth.init_params(jax.random.PRNGKey(1))
    qp = jdepth.quantize_params(params, jnp.asarray(calib))
    tnet = convert.depth_from_jax(jax.tree.map(np.asarray, params),
                                  device="cpu")
    tq = convert.quantized_depth_from_jax(jax.tree.map(np.asarray, qp),
                                          device="cpu")
    return params, qp, tnet, tq


@pytest.mark.parametrize("shape", [(3, 3, 3, 16), (3, 3, 1, 32),
                                   (1, 1, 64, 32)])
def test_quantize_weight_is_bitwise(shape):
    w = np.random.default_rng(len(shape) + shape[-1]).normal(
        size=shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-8 floor
    jq, js = jdepth.quantize_weight(jnp.asarray(w))
    tq, ts = tdepth.quantize_weight(to_torch(w))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(to_numpy(tq), np.asarray(jq))
    np.testing.assert_array_equal(to_numpy(ts), np.asarray(js))


def test_quantize_params_matches_jax(calib, nets):
    _, _, tnet, tq = nets
    mine = tdepth.quantize_params(tnet, to_torch(calib))
    for name, layer in tq.layers.items():
        for key, want in layer.named_buffers():
            got = getattr(mine.layers[name], key)
            assert got.dtype == want.dtype, (name, key)
            if key != "act_scale":
                assert torch.equal(got, want), (name, key)
            elif name == "enc0":  # max|input|: no convolution behind it
                assert torch.equal(got, want)
            else:
                np.testing.assert_allclose(to_numpy(got), to_numpy(want),
                                           rtol=ACT_SCALE_RTOL, atol=0,
                                           err_msg=name)


@pytest.mark.parametrize("layer,key,hwc,stride", CONVS,
                         ids=[f"{c[0]}.{c[1]}" for c in CONVS])
def test_int32_accumulator_is_exact(nets, layer, key, hwc, stride):
    """The same int8 input through the reference's int32 convolution and
    the port's im2col + int8_matmul (dense) or shifted products
    (depthwise); then the dequantised output of ``_qconv`` on both
    (the reference jitted, as the pipeline runs it)."""
    _, qp, _, tq = nets
    rng = np.random.default_rng(stride * 1000 + hwc[-1])
    qx = rng.integers(-127, 128, (2,) + hwc).astype(np.int8)
    qw = qp.qweights[layer][key]
    groups = hwc[-1] if key == "dw" else 1
    want = jax.lax.conv_general_dilated(
        jnp.asarray(qx, jnp.int32), qw.astype(jnp.int32), (stride, stride),
        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
    )
    tw = getattr(tq.layers[layer], key)
    if key == "dw":
        got = tdepth.depthwise_int32(to_torch(qx), tw, stride)
    else:
        got = tdepth.conv_int32(to_torch(qx), tw, stride, backend="pallas")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))

    x = rng.uniform(0.0, 3.0, (2,) + hwc).astype(np.float32)
    xscale = np.float32(np.abs(x).max())
    want = jax.jit(jdepth._qconv, static_argnums=(4, 5))(
        jnp.asarray(x), qw, qp.scales[layer][key], jnp.asarray(xscale),
        stride, groups)
    got = tdepth._qconv(to_torch(x), tw,
                        getattr(tq.layers[layer], f"{key}_scale"),
                        torch.tensor(xscale), stride,
                        depthwise=key == "dw", backend="pallas")
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_int8_matches_jitted_reference(nets, seed):
    _, qp, _, tq = nets
    x = np.random.default_rng(seed).uniform(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(jdepth.forward_int8)(qp, jnp.asarray(x)))
    got = to_numpy(tdepth.forward_int8(tq, to_torch(x)))
    assert got.shape == (2, 64, 64)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


def test_predict_fullres_takes_the_int8_path(nets):
    _, qp, tnet, tq = nets
    frame = stream_64()["frames"][3]
    want = np.asarray(jax.jit(jdepth.predict_fullres)(qp, jnp.asarray(frame)))
    got = to_numpy(tdepth.predict_fullres(tq, to_torch(frame)))
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=FWD_ATOL)
    fp32 = to_numpy(tdepth.predict_fullres(tnet, to_torch(frame)))
    assert not np.array_equal(fp32, got)


def test_matmul_backends_agree_and_are_validated(nets):
    _, _, _, tq = nets
    x = to_torch(np.random.default_rng(2).uniform(
        size=(1, 64, 64, 3)).astype(np.float32))
    tq.matmul_backend = "ref"
    plain = tdepth.forward_int8(tq, x)
    tq.matmul_backend = "pallas"
    assert torch.equal(plain, tdepth.forward_int8(tq, x))
    with pytest.raises(ValueError, match="int8_matmul backend"):
        tq.matmul_backend = "bogus"


def test_memory_bytes_matches_jax(nets):
    params, _, tnet, _ = nets
    for int8 in (True, False):
        assert tdepth.memory_bytes(tnet, int8) == jdepth.memory_bytes(
            params, int8)


def test_convert_checks_layers_and_shapes(nets):
    _, qp, _, _ = nets
    q = jax.tree.map(np.asarray, qp)
    with pytest.raises(ValueError, match="head"):
        convert.quantized_depth_from_jax(
            (q.qweights, q.scales,
             {k: v for k, v in q.act_scale.items() if k != "head"}),
            device="cpu")
    bad = {**q.qweights, "enc0": {**q.qweights["enc0"],
                                  "w": q.qweights["enc0"]["w"][:2]}}
    with pytest.raises(ValueError, match="enc0/w"):
        convert.quantized_depth_from_jax((bad, q.scales, q.act_scale),
                                         device="cpu")


def test_compressor_device_check_covers_buffers(nets):
    """A quantised network keeps its tensors as buffers: one on another
    device than the compressor's is refused."""
    _, _, _, tq = nets
    elsewhere = tpipe.EPICModels(depth_model=copy.deepcopy(tq).to("meta"))
    assert not list(tq.parameters())
    with pytest.raises(ValueError, match="QuantizedParams"):
        tapi.EPICCompressor(tpipe.EPICConfig(), elsewhere, device="cpu")


def _depth_int8_setup():
    """``tests/test_depth_int8.py``: 6 frames of 32x32, 3 objects."""
    key = jax.random.PRNGKey(0)
    scfg = jsyn.StreamConfig(n_frames=6, hw=(32, 32), n_obj=3)
    s, _ = jsyn.generate_stream(key, scfg)
    params = jdepth.init_params(jax.random.fold_in(key, 1))
    rgb64, _ = jsyn.depth_training_batch(jax.random.fold_in(key, 2), scfg, 4)
    qp = jdepth.quantize_params(params, rgb64)
    stream = [np.asarray(x) for x in (s.frames, s.poses, s.gazes)]
    cfg = dict(frame_hw=(32, 32), patch=16, capacity=12, tau=0.2,
               gamma=0.015, theta=4, window=8)
    return stream, qp, None, cfg


def _stream_64_setup(calib):
    """``tests/test_torch_pipeline.py``'s run: 40 frames of 64x64 with an
    int8 depth network and the HIR network."""
    s = stream_64(40)
    params = jdepth.init_params(jax.random.PRNGKey(3))
    qp = jdepth.quantize_params(params, jnp.asarray(calib))
    hir = jhir.init_params(jax.random.PRNGKey(3))
    cfg = dict(frame_hw=(64, 64), patch=16, capacity=32, tau=0.10,
               gamma=0.015, theta=8, window=16)
    return [s["frames"], s["poses"], s["gazes"]], qp, hir, cfg


@pytest.mark.parametrize("setup", ["test_depth_int8", "stream_64"])
def test_compressor_with_int8_depth_matches_jax(calib, setup):
    stream, qp, hir, cfg = (_depth_int8_setup() if setup == "test_depth_int8"
                            else _stream_64_setup(calib))
    tq = convert.quantized_depth_from_jax(jax.tree.map(np.asarray, qp),
                                          device="cpu")
    thir = None if hir is None else convert.hir_from_jax(
        jax.tree.map(np.asarray, hir), device="cpu")
    jcomp = japi.EPICCompressor(jpipe.EPICConfig(**cfg),
                                jpipe.EPICModels(qp, hir))
    jstate, jstats = jax.jit(jcomp.step)(
        jcomp.init(), japi.SensorChunk(*stream))
    tcomp = tapi.EPICCompressor(tpipe.EPICConfig(**cfg),
                                tpipe.EPICModels(tq, thir), device="cpu")
    tstate, tstats = tcomp.step(tcomp.init(),
                                tapi.SensorChunk(*map(to_torch, stream)))
    assert_leaves_match(jstats, tstats, rtol=1e-5, what="FrameStats")
    assert_leaves_match(jax.tree.leaves(jstate),
                        [*tstate.bypass, *tstate.buf, tstate.t],
                        rtol=1e-5, what="EPICState")
    assert int(tstats.buffer_valid[-1]) > 0
    assert int(tstats.processed.sum()) > 1
    assert bool(torch.isfinite(tstate.buf.depth).all())
