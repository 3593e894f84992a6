"""AdamW, the LR schedules and EF-int8 compression in the PyTorch port
against the JAX package (``repro.optim``), mirroring
``tests/test_substrates.py``.

The same numpy trees, made from a seed, go through both packages.
Tolerances: float32 results within 1e-6 relative to the leaf's largest
value (the packages take ``pow``, ``sqrt`` and reductions in their own
order: a few ulps); bf16 results within one bf16 unit in the last place
(2^-8 relative: a float32 difference of one ulp can move a value across
a bf16 rounding boundary); the int8 payload, the scales, the step counts
and the dtypes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro_torch import convert
from repro_torch.optim import adamw, compress, schedule

F32_REL = 1e-6
BF16_REL = 2.0 ** -8
SHAPES = {"a": (8, 8), "b": (8,), "c": {"w": (3, 4, 5)}}


def _tree(seed, scale=1.0, dtype=np.float32, shapes=SHAPES):
    rng = np.random.default_rng(seed)

    def walk(s):
        if isinstance(s, dict):
            return {k: walk(v) for k, v in s.items()}
        return (scale * rng.standard_normal(s)).astype(np.float32)

    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)),
                        walk(shapes))


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _port(tree):
    return convert._like_params(tree, None, "cpu")


def _assert_tree(ref, port, rel=F32_REL, what=""):
    """Key by key (JAX orders dict leaves by key, the port by insertion)."""
    if isinstance(port, dict):
        assert set(port) == set(ref), what
        for k in port:
            _assert_tree(ref[k], port[k], rel, f"{what}/{k}")
        return
    a = np.asarray(ref)
    assert str(port.dtype).split(".")[-1] == a.dtype.name, what
    a, b = a.astype(np.float32), to_numpy(port.float())
    tol = rel * max(float(np.abs(a).max()), 1e-30)
    np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _state(seed, params, step):
    """A mid-run state: random first moments, positive second moments."""
    mu = _tree(seed, 0.01)
    nu = jax.tree.map(lambda a: np.abs(a), _tree(seed + 1, 1e-4))
    return jadamw.AdamWState(np.int32(step), mu, nu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("scheduled", [False, True])
def test_adamw_update_matches_jax(dtype, clip, scheduled):
    jdt = jnp.dtype(dtype)
    params = _tree(0, dtype=jdt)
    grads = _tree(1, 0.5, dtype=jdt)  # global norm ~5: clipping acts
    state = _state(2, params, 3)
    cfg_j = jadamw.AdamWConfig(lr=1e-2, clip_norm=clip)
    cfg_t = adamw.AdamWConfig(lr=1e-2, clip_norm=clip)
    lr_j = lr_t = None
    if scheduled:
        lr_j = jschedule.warmup_cosine(7, peak_lr=1e-2, warmup_steps=2,
                                       total_steps=20)
        lr_t = schedule.warmup_cosine(7, peak_lr=1e-2, warmup_steps=2,
                                      total_steps=20)
    jp, js, jg = jadamw.update(_jax(grads), jax.tree.map(jnp.asarray, state),
                               _jax(params), cfg_j, lr=lr_j)
    tp, ts, tg = adamw.update(_port(grads),
                              convert.adamw_state_from_jax(state, None,
                                                           "cpu"),
                              _port(params), cfg_t, lr=lr_t)
    assert ts.step.dtype == torch.int32 and int(ts.step) == int(js.step) == 4
    assert tg.dtype == torch.float32
    np.testing.assert_allclose(float(tg), float(jg), rtol=F32_REL)
    _assert_tree(jp, tp, BF16_REL if dtype == "bfloat16" else F32_REL,
                 "params")
    _assert_tree(js.mu, ts.mu, what="mu")
    _assert_tree(js.nu, ts.nu, what="nu")


def test_global_norm_and_clip_match_jax():
    grads = _tree(3, 2.0)
    jn = jadamw.global_norm(_jax(grads))
    tn = adamw.global_norm(_port(grads))
    np.testing.assert_allclose(float(tn), float(jn), rtol=F32_REL)
    jc, jn2 = jadamw.clip_by_global_norm(_jax(grads), 1.0)
    tc, tn2 = adamw.clip_by_global_norm(_port(grads), 1.0)
    _assert_tree(jc, tc, what="clipped")
    assert float(adamw.global_norm(tc)) == pytest.approx(1.0, rel=1e-6)


def test_adamw_init_is_float32_zeros_on_bf16_params():
    params = _port(_tree(0, dtype=jnp.bfloat16))
    st = adamw.init(params)
    assert st.step.dtype == torch.int32 and int(st.step) == 0
    for m, v in zip(*(torch.utils._pytree.tree_leaves(t)
                      for t in (st.mu, st.nu))):
        assert m.dtype == v.dtype == torch.float32
        assert not m.any() and not v.any() and m is not v


def test_adamw_clip_and_dtype():
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    g = {"w": torch.full((4,), 100.0, dtype=torch.bfloat16)}
    cfg = adamw.AdamWConfig(lr=1e-2, clip_norm=1.0, weight_decay=0.0)
    p2, st2, gn = adamw.update(g, adamw.init(params), params, cfg)
    assert p2["w"].dtype == torch.bfloat16
    assert float(gn) == pytest.approx(200.0, rel=1e-2)  # pre-clip norm
    assert st2.mu["w"].dtype == torch.float32


def _quad_problem():
    rng = np.random.default_rng(0)
    target = {"a": torch.from_numpy(rng.standard_normal((8, 8)).astype(
        np.float32)), "b": torch.ones(8)}
    params = {k: torch.zeros_like(v) for k, v in target.items()}

    def grad(p):
        return {k: 2.0 * (p[k] - target[k]) for k in p}

    def loss(p):
        return float(sum(torch.sum(torch.square(p[k] - target[k]))
                         for k in p))

    return params, grad, loss


def test_adamw_converges_quadratic():
    params, grad, loss = _quad_problem()
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0)
    state = adamw.init(params)
    l0 = loss(params)
    for _ in range(200):
        params, state, _ = adamw.update(grad(params), state, params, cfg)
    assert loss(params) < 1e-2 * l0


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

STEPS = [0, 1, 9, 10, 11, 55, 99, 100, 150]


@pytest.mark.parametrize("warmup", [0, 10])
def test_warmup_cosine_matches_jax(warmup):
    kw = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=100)
    j = np.asarray(jschedule.warmup_cosine(jnp.asarray(STEPS), **kw))
    t = schedule.warmup_cosine(torch.tensor(STEPS), **kw)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(t), j, rtol=F32_REL, atol=0)
    for s in STEPS:  # scalar steps, as the train step passes them
        ts = schedule.warmup_cosine(s, **kw)
        assert ts.dtype == torch.float32 and ts.shape == ()
        np.testing.assert_allclose(float(ts), float(
            jschedule.warmup_cosine(s, **kw)), rtol=F32_REL)
    # Step 0 gets the peak without warmup, 0 with it; the warmup boundary
    # and the end hit the peak and the floor.
    assert float(t[0]) == pytest.approx(3e-4 if warmup == 0 else 0.0,
                                        rel=1e-6)
    assert float(t[STEPS.index(10)]) == pytest.approx(
        3e-4 if warmup == 10 else 3e-4 * (0.1 + 0.45 * (1 + np.cos(
            np.pi * 0.1))), rel=1e-6)
    assert float(t[STEPS.index(100)]) == pytest.approx(3e-5, rel=1e-6)
    assert float(t[-1]) == float(t[STEPS.index(100)])


def test_constant_matches_jax():
    j = jschedule.constant(jnp.asarray(STEPS), peak_lr=1e-3)
    t = schedule.constant(torch.tensor(STEPS), peak_lr=1e-3,
                          warmup_steps=4)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(to_numpy(t), np.asarray(j))
    assert float(schedule.constant(3, peak_lr=1e-3)) == float(j[0])


# ---------------------------------------------------------------------------
# EF-int8 compression
# ---------------------------------------------------------------------------


def _ties():
    """max|acc| = 127, so the scale is 1 and every x.5 is a tie: half to
    even (2.5 -> 2, -3.5 -> -4, 0.5 -> 0)."""
    return np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -127.0],
                    np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_payload_and_scales_match_jax_exactly(dtype):
    jdt = jnp.dtype(dtype)
    grads = _tree(5, 0.3, dtype=jdt)
    grads["ties"] = np.asarray(jnp.asarray(_ties(), jdt))
    error = _tree(6, 1e-3)
    error["ties"] = np.zeros(8, np.float32)
    jq, js, jef = jcompress.compress(_jax(grads),
                                     jcompress.EFState(_jax(error)))
    tq, ts, tef = compress.compress(
        _port(grads), convert.ef_state_from_jax(
            jcompress.EFState(error), None, "cpu"))
    for k in ("a", "b", "ties"):
        assert tq[k].dtype == torch.int8 and ts[k].dtype == torch.float32
        assert ts[k].shape == ()
        np.testing.assert_array_equal(to_numpy(tq[k]), np.asarray(jq[k]))
        np.testing.assert_array_equal(to_numpy(ts[k]), np.asarray(js[k]))
    np.testing.assert_array_equal(to_numpy(tq["c"]["w"]),
                                  np.asarray(jq["c"]["w"]))
    np.testing.assert_array_equal(to_numpy(ts["c"]["w"]),
                                  np.asarray(js["c"]["w"]))
    np.testing.assert_array_equal(to_numpy(tq["ties"]),
                                  [127, 2, -4, 0, 0, 2, 126, -127])
    _assert_tree(jef.error, tef.error, what="error")
    _assert_tree(jcompress.decompress(jq, js), compress.decompress(tq, ts),
                 rel=0.0, what="decompressed")


def test_ef_int8_tracks_uncompressed_sgd():
    """Error feedback: compressed SGD converges to the same optimum."""
    params, grad, loss = _quad_problem()
    pc = {k: v.clone() for k, v in params.items()}
    ef = compress.init(params)
    lr = 0.05
    for _ in range(300):
        params = {k: p - lr * g for (k, p), g in
                  zip(params.items(), grad(params).values())}
        q, scales, ef = compress.compress(grad(pc), ef)
        gd = compress.decompress(q, scales)
        pc = {k: p - lr * gd[k] for k, p in pc.items()}
    lf, lc = loss(params), loss(pc)
    assert lc < 1e-3, lc
    assert abs(lc - lf) < 1e-3


def test_optimizer_states_convert_against_a_models_tree():
    """The converters check moments and error feedback against a model's
    parameter tree and keep their dtypes (bf16 moments stay bf16)."""
    from repro.launch import train as jtrain

    _, _, cfg, params, _ = _train_case()
    jopt = jax.tree.map(np.asarray, jtrain.cast_moments(
        jadamw.init(_jax(params)), jnp.bfloat16))
    st = convert.adamw_state_from_jax(jopt, cfg, "cpu")
    assert st.mu["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    ef = convert.ef_state_from_jax(jcompress.init(params), cfg, "cpu")
    assert ef.error["embed"]["table"].dtype == torch.float32
    bad = dict(jopt.mu)
    bad.pop("final_norm")
    with pytest.raises(ValueError, match="keys"):
        convert.adamw_state_from_jax(jopt._replace(mu=bad), cfg, "cpu")


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def _max(t):
    return float(t.max()) if t.numel() else 0.0


def _train_case(arch="tinyllama-1.1b"):
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import build_model as jax_build_model
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    gen = torch.Generator().manual_seed(0)
    tm = build_model(tcfg, device="cpu")
    params = jax.tree.map(np.asarray, torch.utils._pytree.tree_map(
        to_numpy, tm.init(gen)))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, tcfg.vocab, (4, 16)).astype(
        np.int32)}
    return jax_build_model(jcfg), tm, tcfg, params, batch


@pytest.mark.parametrize("accum,moments", [(1, "float32"), (2, "float32"),
                                           (1, "bfloat16")])
def test_train_step_matches_jax(accum, moments):
    """One step of ``make_train_step`` from the same state in both packages
    (at step 3, past a warmup of 2): metrics, moments and parameters.

    Metrics within 1e-5 relative; moments within 1e-5 of their leaf's
    largest value (bf16 moments: one bf16 ulp).  The first AdamW step
    moves every parameter by about lr on the sign of its gradient alone
    (m / sqrt(v) = g / |g|), so an element whose gradient is a rounding
    residue, below 1e-4 of its leaf's largest |g|, may move either way:
    the comparison exempts those (the reference's first moment, (1 - b1)
    times the clipped gradient, marks them) and holds them within 2 lr.
    The rest: within 1e-6 of the leaf's largest |p| plus 1e-4 lr (the step
    g / (|g| + eps) moves by eps / |g| times the gradient's relative
    difference, most just above the threshold)."""
    from repro.launch import train as jtrain
    from repro.optim import adamw as jadamw
    from repro_torch.launch import train as ttrain

    jm, tm, tcfg, params, batch = _train_case()
    opt_j = jadamw.init(_jax(params))
    if moments != "float32":
        opt_j = jtrain.cast_moments(opt_j, jnp.dtype(moments))
    lr, step, kw = 1e-3, 3, dict(accum=accum, warmup_steps=2,
                                 total_steps=20)
    jp, jo, jmet = jax.jit(jtrain.make_train_step(
        jm, jadamw.AdamWConfig(lr=lr), **kw))(_jax(params), opt_j,
                                              _jax(batch), step)
    to = convert.adamw_state_from_jax(jax.tree.map(np.asarray, opt_j), tcfg,
                                      "cpu")
    assert to.mu["embed"]["table"].dtype == getattr(torch, moments)
    tp, to, tmet = ttrain.make_train_step(tm, adamw.AdamWConfig(lr=lr), **kw)(
        convert.dense_from_jax(params, tcfg, device="cpu"), to,
        {k: torch.from_numpy(v) for k, v in batch.items()}, step)
    for k in ("loss", "gnorm", "lr"):
        assert tmet[k].dtype == torch.float32 and tmet[k].shape == ()
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    assert int(to.step) == int(jo.step) == 1
    rel = BF16_REL if moments == "bfloat16" else 1e-5
    _assert_tree(jax.tree.map(np.asarray, jo.mu), to.mu, rel, "mu")
    _assert_tree(jax.tree.map(np.asarray, jo.nu), to.nu, rel, "nu")
    ref_mu = convert.adamw_state_from_jax(jax.tree.map(np.asarray, jo), tcfg,
                                          "cpu").mu
    ref_p = convert.dense_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")
    tree = torch.utils._pytree
    for (path, a), b, m in zip(tree.tree_flatten_with_path(ref_p)[0],
                               tree.tree_leaves(tp), tree.tree_leaves(ref_mu)):
        assert b.dtype == a.dtype == torch.float32
        m = m.float().abs()
        keep = m >= 1e-4 * m.max()
        d = (b - a).abs()
        assert _max(d[keep]) <= 1e-6 * float(a.abs().max()) + 1e-4 * lr, path
        assert _max(d[~keep]) <= 2 * lr, path


def test_train_step_accumulates_in_float32_and_keeps_dtypes_without():
    """``accum=1`` gives gradients in the parameters' dtype, as
    ``jax.value_and_grad`` does; ``accum=2`` sums float32 gradients from
    zeros and scales them by 1/2: equal to the mean of the microbatches'
    gradients."""
    from repro_torch.launch import train as ttrain

    _, tm, tcfg, params, batch = _train_case()
    tp = convert.dense_from_jax(params, tcfg, device="cpu")
    tp = torch.utils._pytree.tree_map(lambda x: x.to(torch.bfloat16), tp)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, g1 = ttrain.value_and_grad(tm.loss_fn, tp, tbatch)
    assert all(g.dtype == torch.bfloat16
               for g in torch.utils._pytree.tree_leaves(g1))
    halves = [ttrain.value_and_grad(tm.loss_fn, tp, {
        "tokens": tbatch["tokens"][i * 2:(i + 1) * 2]})[1] for i in (0, 1)]
    seen = {}

    def update(grads, state, params, cfg, lr=None):
        seen["grads"] = grads
        return params, state, torch.zeros(())

    step = ttrain.make_train_step(tm, adamw.AdamWConfig(), accum=2)
    orig = ttrain.adamw.update
    ttrain.adamw.update = update
    try:
        step(tp, adamw.init(tp), tbatch, 0)
    finally:
        ttrain.adamw.update = orig
    for g, a, b in zip(*(torch.utils._pytree.tree_leaves(t) for t in (
            seen["grads"], halves[0], halves[1]))):
        assert g.dtype == torch.float32
        assert torch.equal(g, (torch.zeros_like(g) + a + b) * 0.5)


def test_train_step_refuses_what_needs_a_mesh():
    """The EF-int8 exchange needs an ambient mesh, the sharded step its
    moments' shardings on a ``DeviceMesh`` (the steps themselves:
    ``test_torch_distributed.py``)."""
    from _torch_parity import to_torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import AbstractMesh

    _, tm, _, params, batch = _train_case()
    tparams = torch.utils._pytree.tree_map(to_torch, params)
    step = ttrain.make_train_step(tm, adamw.AdamWConfig(), grad_axis="pod")
    with pytest.raises(ValueError, match="needs a mesh"):
        step(tparams, adamw.init(tparams),
             {"tokens": to_torch(batch["tokens"])}, 0)
    with pytest.raises(TypeError, match="NamedSharding"):
        ttrain.make_train_step(tm, adamw.AdamWConfig(), grad_specs=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttrain.jit_train_step(tm, AbstractMesh((1, 1), ("data", "model")),
                              adamw.AdamWConfig(),
                              shape_spec=ShapeSpec("x", "train", 8, 2))


def test_init_train_state_casts_the_moments():
    from repro_torch.launch import train as ttrain

    _, tm, *_ = _train_case()
    params, opt = ttrain.init_train_state(
        tm, torch.Generator().manual_seed(0), moment_dtype=torch.bfloat16)
    leaves = torch.utils._pytree.tree_leaves
    assert len(leaves(opt.mu)) == len(leaves(params))
    assert all(m.dtype == torch.bfloat16 and not m.any()
               for m in leaves(opt.mu) + leaves(opt.nu))
