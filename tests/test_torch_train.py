"""Training in the PyTorch port against the JAX package: every family's
loss and gradient, remat, the train step, the depth network's loss; and
the kernel wrappers and ``conv2d_same`` under grad.

Each of the ten ``ARCH_IDS`` at its smoke configuration: one parameter
tree as numpy (drawn by the port's ``init`` from a seeded generator,
its constant leaves moved by seeded noise, so the VLM's tanh gates open;
both packages keep the same tree layout) goes into the JAX model as it
is and into the port through ``convert.*_from_jax``, and the same numpy
batch, made from a seed, goes through both ``loss_fn``s; the reference's
gradients (``jax.value_and_grad``) come back through the same converter.
Only fixed seeds, no hypothesis.

Tolerances: losses within 1e-5 (values ~5); each gradient leaf within
1e-4 of that leaf's largest reference |g| (the packages sum the float32
products, the scans' cumsums and the softmaxes in other orders: about
1e-6 of it on the dense, MoE, VLM and encoder-decoder families, up to
3e-5 on the RWKV6 and SSD scans); remat's gradients bitwise those
without it (the same float32 operations, recomputed, on one thread).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from _torch_parity import perturb_constant_leaves, to_numpy, to_torch
from repro.configs import ARCH_IDS
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import deepseek as jdeepseek
from repro.models import encdec as jencdec
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.models import deepseek as tdeepseek
from repro_torch.models import layers as TL

B, S = 2, 16
LOSS_TOL = 1e-5
GRAD_REL = 1e-4
FROM_JAX = {"dense": convert.dense_from_jax, "rwkv6": convert.rwkv6_from_jax,
            "hybrid": convert.hybrid_from_jax,
            "moe_mla": convert.moe_mla_from_jax,
            "vlm": convert.vlm_from_jax, "encdec": convert.encdec_from_jax}


def _batch(cfg, seed=1, b=B, s=S):
    """The family's batch as numpy, with a seeded 0/1 ``mask``."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["img_embed"] = 0.1 * rng.standard_normal(
            (b, cfg.img_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["src_embed"] = 0.1 * rng.standard_normal(
            (b, jencdec.src_len(cfg, s), cfg.d_model)).astype(np.float32)
    batch["mask"] = (rng.uniform(size=(b, s)) > 0.3).astype(np.float32)
    return batch


def _without_mask(batch):
    return {k: v for k, v in batch.items() if k != "mask"}


def _params_np(cfg, seed=0):
    """A parameter tree of ``cfg``'s family as numpy arrays."""
    gen = torch.Generator().manual_seed(seed)
    tree = build_model(cfg, device="cpu").init(gen)
    return perturb_constant_leaves(pytree.tree_map(to_numpy, tree), seed)


def _port_batch(batch):
    return {k: to_torch(v) for k, v in batch.items()}


def _grads(loss_fn, params, batch):
    """The port's ``(loss, grads)``, as the train step takes them."""
    return ttrain.value_and_grad(loss_fn, params, batch)


def _assert_grads(ref_tree, port_tree, rel=GRAD_REL, what=""):
    ref_leaves, spec = pytree.tree_flatten(ref_tree)
    port_leaves = pytree.tree_leaves(port_tree)
    paths = [pytree.keystr(p) for p, _ in
             pytree.tree_flatten_with_path(ref_tree)[0]]
    assert len(ref_leaves) == len(port_leaves)
    for path, a, b in zip(paths, ref_leaves, port_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape, (what, path)
        tol = rel * max(float(a.abs().max()), 1e-12)
        np.testing.assert_allclose(to_numpy(b.float()), to_numpy(a.float()),
                                   rtol=0, atol=tol, err_msg=f"{what}{path}")


@pytest.fixture(scope="module", params=ARCH_IDS)
def case(request):
    """(arch, JAX model, port model, JAX params, port params, batch) and
    the reference's loss and gradients with and without the mask, those
    carried into the port's tree."""
    arch = request.param
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    params = _params_np(tcfg)
    batch = _batch(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    vg = jax.value_and_grad(jm.loss_fn)

    @jax.jit
    def both(p, b):
        return vg(p, b), vg(p, _without_mask(b))

    conv = FROM_JAX[jcfg.family]
    ref = {}
    for masked, (loss, g) in zip((True, False), both(jp, jax.tree.map(
            jnp.asarray, batch))):
        ref[masked] = (float(loss), conv(jax.tree.map(np.asarray, g), tcfg,
                                         device="cpu"))
    return dict(arch=arch, cfg=tcfg, model=tm, jparams=jp,
                params=conv(params, tcfg, device="cpu"), batch=batch,
                ref=ref)


@pytest.mark.parametrize("masked", [True, False])
def test_loss_and_grads_match_jax(case, masked):
    batch = case["batch"] if masked else _without_mask(case["batch"])
    loss, grads = _grads(case["model"].loss_fn, case["params"],
                         _port_batch(batch))
    ref_loss, ref_grads = case["ref"][masked]
    assert abs(float(loss) - ref_loss) <= LOSS_TOL, (float(loss), ref_loss)
    _assert_grads(ref_grads, grads, what=case["arch"])


def test_three_sgd_steps_lower_the_loss(case):
    """Three SGD steps at lr 0.3 lower the loss (``test_arch_smoke``)."""
    p, batch, losses = case["params"], _port_batch(case["batch"]), []
    for _ in range(3):
        loss, g = _grads(case["model"].loss_fn, p, batch)
        p = pytree.tree_map(lambda w, gw: w - 0.3 * gw.to(w.dtype), p, g)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


@pytest.mark.parametrize("policy", ["dots", "full"])
def test_remat_grads_equal_those_without(case, policy):
    model = build_model(case["cfg"].replace(remat=True, remat_policy=policy),
                        device="cpu")
    batch = _port_batch(case["batch"])
    loss, grads = _grads(model.loss_fn, case["params"], batch)
    ref_loss, ref_grads = _grads(case["model"].loss_fn, case["params"], batch)
    assert float(loss) == float(ref_loss)
    for a, b in zip(pytree.tree_leaves(ref_grads), pytree.tree_leaves(grads)):
        assert torch.equal(a, b)


def _ops_in_backward(model, params, batch):
    """How many ``aten.mm`` and ``aten.bmm`` the backward pass runs (the
    recomputed forward's included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {"mm": 0, "bmm": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in counts:
                counts[name] += 1
            return func(*args, **(kwargs or {}))

    leaves, spec = pytree.tree_flatten(params)
    live = [x.detach().requires_grad_(True) for x in leaves]
    loss = model.loss_fn(pytree.tree_unflatten(live, spec), batch)
    with Count():
        torch.autograd.grad(loss, live)
    return counts


def test_remat_policies_recompute_what_the_reference_recomputes():
    """``"dots"`` saves the unbatched products (the backward runs no more
    ``mm`` than without remat) and recomputes attention's batched ones;
    ``"full"`` recomputes both."""
    cfg = get_smoke_config("tinyllama-1.1b")
    params = convert.dense_from_jax(_params_np(cfg), cfg, device="cpu")
    batch = _port_batch(_without_mask(_batch(cfg)))
    base, dots, full = (
        _ops_in_backward(build_model(c, device="cpu"), params, batch)
        for c in (cfg, cfg.replace(remat=True, remat_policy="dots"),
                  cfg.replace(remat=True, remat_policy="full")))
    assert dots["mm"] == base["mm"] and dots["bmm"] > base["bmm"], (base,
                                                                    dots)
    assert full["mm"] > base["mm"] and full["bmm"] > base["bmm"], (base,
                                                                   full)


# ---------------------------------------------------------------------------
# DeepSeek's aux and MTP terms, each on its own
# ---------------------------------------------------------------------------


def test_deepseek_aux_and_mtp_terms_match_jax():
    """DeepSeek-V3's smoke config (``mtp=True``): the load-balance term
    (``forward``'s aux) and the MTP head's loss, each with its gradient,
    on their own (at the default coefficients, 0.001 and 0.3, the main
    test would hide them under the loss's); the reference's MTP term is
    its loss with ``mtp`` less its loss without, over the coefficient."""
    arch = "deepseek-v3-671b"
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    assert jcfg.mtp and tcfg.mtp
    params = _params_np(tcfg)
    jp = jax.tree.map(jnp.asarray, params)
    tp = convert.moe_mla_from_jax(params, tcfg, device="cpu")
    batch = _without_mask(_batch(jcfg, seed=3))
    tokens = jnp.asarray(batch["tokens"])
    off = jcfg.replace(mtp=False)

    def aux(p):
        return jdeepseek.forward(p, tokens, jcfg)[1]

    def mtp(p):  # the MTP term alone: the loss with it less the loss without
        b = {"tokens": tokens}
        return (jdeepseek.loss_fn(p, b, jcfg) - jdeepseek.loss_fn(p, b, off)
                ) / jcfg.mtp_loss_coef

    ref = jax.jit(lambda p: (jax.value_and_grad(aux)(p),
                             jax.value_and_grad(mtp)(p)))(jp)
    ttok = to_torch(batch["tokens"])

    def port_aux(p):
        return tdeepseek.forward(p, ttok, tcfg)[1]

    def port_mtp(p):
        x = TL.embed(p["embed"], ttok, tcfg.cdt)
        h, _ = tdeepseek._backbone(p, x, tcfg)
        return tdeepseek.mtp_loss(p, h, ttok, tcfg)

    for name, fn, (ref_v, ref_g) in (("aux", port_aux, ref[0]),
                                     ("mtp", port_mtp, ref[1])):
        v, g = _grads(lambda p, _: fn(p), tp, None)
        # The MTP reference is a difference of two losses of ~5 over 0.3:
        # a few 1e-6 of cancellation, inside the loss tolerance.
        assert abs(float(v) - float(ref_v)) <= LOSS_TOL, (name, float(v),
                                                          float(ref_v))
        assert float(v) > 0
        _assert_grads(convert.moe_mla_from_jax(
            jax.tree.map(np.asarray, ref_g), tcfg, device="cpu"), g,
            what=name)


# ---------------------------------------------------------------------------
# The depth network's loss
# ---------------------------------------------------------------------------


def test_depth_loss_and_grad_match_jax():
    """``depth.loss_fn`` and its gradient: the loss within 1e-5 relative
    (the depth parity rule), each weight's gradient within 1e-4 of its
    largest reference |g|."""
    from repro.core import depth as jdepth
    from repro_torch.core import depth as tdepth

    params = jax.tree.map(np.asarray,
                          jdepth.init_params(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    rgb = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, size=(2, 64, 64)).astype(np.float32)
    jl, jg = jax.value_and_grad(jdepth.loss_fn)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(rgb),
        jnp.asarray(depth))
    model = convert.depth_from_jax(params, device="cpu")
    loss = tdepth.loss_fn(model, to_torch(rgb), to_torch(depth))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    ref = {k: v.detach() for k, v in convert.depth_from_jax(
        jax.tree.map(np.asarray, jg), device="cpu").named_parameters()}
    for name, p in model.named_parameters():
        tol = GRAD_REL * max(float(ref[name].abs().max()), 1e-12)
        np.testing.assert_allclose(to_numpy(p.grad), to_numpy(ref[name]),
                                   rtol=0, atol=tol, err_msg=name)


def test_conv2d_same_scopes_cudnn_and_restores_the_switches(monkeypatch):
    """The convolution, and its backward, run with TF32 off and cuDNN
    deterministic whatever the global switches, which it leaves as it
    found them (PyTorch's defaults here: cuDNN may use TF32)."""
    from repro_torch.core import depth as tdepth

    cudnn = torch.backends.cudnn
    seen = []

    def switches():
        return (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
                cudnn.allow_tf32)

    def spy(name, fn):
        def run(*args, **kwargs):
            seen.append((name, switches()))
            return fn(*args, **kwargs)
        return run

    monkeypatch.setattr(torch.nn.functional, "conv2d",
                        spy("forward", torch.nn.functional.conv2d))
    monkeypatch.setattr(torch.ops.aten, "convolution_backward",
                        spy("backward", torch.ops.aten.convolution_backward))
    before = switches()
    try:
        for flags in ((True, True, False, True), (True, False, True, False)):
            (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
             cudnn.allow_tf32) = flags
            seen.clear()
            x = torch.randn(1, 4, 8, 8, requires_grad=True)
            w = torch.randn(6, 4, 3, 3, requires_grad=True)
            with torch.no_grad():
                tdepth.conv2d_same(x, w, 2)
            tdepth.conv2d_same(x, w, 2).sum().backward()
            assert [n for n, _ in seen] == ["forward", "forward", "backward"]
            assert all(s == (True, False, True, False) for _, s in seen), seen
            assert switches() == flags
            assert x.grad is not None and w.grad is not None
    finally:
        (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
         cudnn.allow_tf32) = before


# ---------------------------------------------------------------------------
# The kernel wrappers under grad
# ---------------------------------------------------------------------------


def _meta(*shape, grad=False, dtype=torch.float32):
    return torch.empty(shape, device="meta", dtype=dtype,
                       requires_grad=grad)


def _wrapper_calls():
    """Each wrapper with one input that requires grad, on a device that is
    not the CPU (``meta``: nothing is computed), and with none."""
    from repro_torch.core import geometry as geo
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)
    from repro_torch.kernels.int8_matmul.qconv import qconv_int8_pallas
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.reproject_match.fused import (
        reproject_match_fused)
    from repro_torch.kernels.reproject_match.kernel import (
        reproject_match_pallas, reproject_match_pallas_tiled)
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas

    intr = geo.Intrinsics.create(51.2, 32.0, 32.0, "cpu")

    def rm(fn):
        return lambda g: fn(_meta(2, 8, 8, 3, grad=g), _meta(2, 8, 8),
                            _meta(2, 2), _meta(2, 4, 4), _meta(64, 64, 3),
                            intr, window=16)

    return {
        "flash_attention_pallas": lambda g: flash_attention_pallas(
            _meta(1, 2, 8, 16, grad=g), _meta(1, 2, 8, 16),
            _meta(1, 2, 8, 16)),
        "rwkv6_scan_pallas": lambda g: rwkv6_scan_pallas(
            _meta(1, 2, 8, 4), _meta(1, 2, 8, 4), _meta(1, 2, 8, 4),
            _meta(1, 2, 8, 4, grad=g), _meta(2, 4), chunk=8),
        "mamba2_ssd_pallas": lambda g: mamba2_ssd_pallas(
            _meta(1, 2, 8, 4, grad=g), _meta(1, 2, 8), _meta(1, 8, 4),
            _meta(1, 8, 4), chunk=8),
        "qconv_int8_pallas": lambda g: qconv_int8_pallas(
            _meta(1, 8, 8, 4, grad=g), _meta(), _meta(
                36, 4, dtype=torch.int8), _meta(4), _meta(4)),
        "reproject_match_pallas": rm(reproject_match_pallas),
        "reproject_match_pallas_tiled": rm(reproject_match_pallas_tiled),
        "reproject_match_fused": rm(reproject_match_fused),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_grad_before_any_launch(name, monkeypatch):
    """Off the CPU, an input that requires grad stops the wrapper before it
    checks or launches anything: a launch returns a tensor without a
    ``grad_fn``.  Under ``no_grad``, or with no such input, it goes on
    (and here stops at the device check or the missing library)."""
    from repro_torch.kernels import _build

    def no_launch(self):
        raise AssertionError("launched")

    monkeypatch.setattr(_build.CudaLibrary, "library", no_launch)
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match=f"{name}: an input requires grad"):
        call(True)
    for args in ((True, torch.no_grad()), (False, torch.enable_grad())):
        with args[1], pytest.raises(Exception) as info:
            call(args[0])
        assert "requires grad" not in str(info.value)


def test_int8_matmul_inputs_cannot_require_grad():
    """``int8_matmul_pallas`` takes int8 tensors, which cannot require
    grad: no gradient can be lost there."""
    with pytest.raises(RuntimeError):
        torch.zeros(4, 4, dtype=torch.int8).requires_grad_(True)


def test_plain_forms_of_the_kernels_stay_differentiable():
    """On the CPU each wrapper runs its plain form, which autograd goes
    through: its input gradients equal those of the sequential oracle
    within the scans' 2e-4 gate (flash: 1e-5)."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.mamba2_ssd.kernel import mamba2_ssd_pallas
    from repro_torch.kernels.mamba2_ssd.ref import mamba2_ssd_ref
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_pallas
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    rng = np.random.default_rng(7)

    def t(*shape, scale=0.5):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).requires_grad_(True)

    q, k, v = t(1, 4, 32, 16), t(1, 2, 32, 16), t(1, 2, 32, 16)
    r, rk, rv, u = t(1, 2, 32, 8), t(1, 2, 32, 8), t(1, 2, 32, 8), t(2, 8)
    w = (-torch.exp(t(1, 2, 32, 8) - 2.0)).detach().requires_grad_(True)
    x, bm, cm = t(1, 2, 32, 8), t(1, 32, 4), t(1, 32, 4)
    a = (-torch.exp(t(1, 2, 32) - 2.0)).detach().requires_grad_(True)
    for label, inputs, kernel, oracle, tol in (
            ("flash", (q, k, v), lambda *z: flash_attention_pallas(*z),
             lambda *z: attention_ref(*z), 1e-5),
            ("rwkv6", (r, rk, rv, w, u),
             lambda *z: rwkv6_scan_pallas(*z, chunk=8)[0],
             lambda *z: rwkv6_scan_ref(*z)[0], 2e-4),
            ("ssd", (x, a, bm, cm), lambda *z: mamba2_ssd_pallas(
                *z, chunk=8)[0], lambda *z: mamba2_ssd_ref(*z)[0], 2e-4)):
        out = kernel(*inputs)
        assert out.grad_fn is not None, label
        cot = torch.from_numpy(rng.standard_normal(out.shape).astype(
            np.float32))
        got = torch.autograd.grad(out, inputs, cot)
        want = torch.autograd.grad(oracle(*inputs), inputs, cot)
        for i, (g1, g2) in enumerate(zip(got, want)):
            np.testing.assert_allclose(to_numpy(g1), to_numpy(g2), rtol=0,
                                       atol=tol, err_msg=f"{label}[{i}]")


@pytest.mark.parametrize("arch,key", [("tinyllama-1.1b", "attn_backend"),
                                      ("zamba2-2.7b", "attn_backend")])
def test_loss_on_the_kernel_backend_differentiates_on_the_cpu(arch, key):
    """A loss on ``attn_backend="pallas"`` takes the flash wrapper's plain
    form on the CPU: its gradients are those of ``"ref"`` within the
    gradient tolerance (on the card the wrapper raises instead)."""
    cfg = get_smoke_config(arch)
    params = FROM_JAX[cfg.family](_params_np(cfg), cfg, device="cpu")
    batch = _port_batch(_batch(cfg))
    _, ref = _grads(build_model(cfg, device="cpu").loss_fn, params, batch)
    _, got = _grads(build_model(cfg.replace(**{key: "pallas"}),
                                device="cpu").loss_fn, params, batch)
    _assert_grads(ref, got, what=arch)
