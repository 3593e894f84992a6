"""The EVU probe (Table 1's EFM stand-in) and the HIR training loss in the
PyTorch port, held to the JAX package on the CPU.

The same numpy inputs, made from a seed, go through ``repro.core.evu`` /
``repro.core.hir`` and their ports, the port's parameters converted from
the reference's (``convert.evu_from_jax``, ``convert.hir_from_jax``).
TF32 is off.  Tolerances:

* ``forward`` logits and ``loss_fn`` within 1e-5 (float32 products of
  width <= 256, summed in another order);
* gradients within 1e-5 of each leaf's largest reference entry;
* 20 Adam steps of ``train_eval``'s update on *given* batch indices
  (the reference draws them from ``jax.random``, the port from a
  ``torch.Generator``) within 1e-4: Adam divides by ``sqrt(v)``, which
  turns gradient ulps into parameter steps of up to ``lr`` size in the
  first steps, where ``v`` is still small;
* ``hir.loss_fn`` within 1e-6; ``patch_relevance_labels`` exactly.

Fixed seeds only; no ``@given``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_torch
from repro.core import evu as jevu
from repro.core import hir as jhir
from repro.core.packing import TOKEN_FEAT
from repro.data import synthetic as jsyn
from repro_torch import convert
from repro_torch.core import evu
from repro_torch.core import hir
from repro_torch.data import synthetic as SYN

CFGS = {
    "small": dict(d_model=32, n_heads=4, n_layers=2, n_classes=5,
                  n_segments=4),
    "table1": dict(d_model=64, n_heads=4, n_layers=2, n_classes=5,
                   n_segments=4),
}


def _cfg(name, **kw):
    return evu.EVUConfig(**CFGS[name], **kw), jevu.EVUConfig(**CFGS[name],
                                                             **kw)


def _params(jcfg, seed=0):
    p = jevu.init_params(jax.random.PRNGKey(seed), jcfg)
    return p, convert.evu_from_jax(jax.tree.map(np.asarray, p), device="cpu")


def _batch(seed, n, length, n_seg, n_cls):
    """Random token streams; the timestamp columns include the segment
    edges exactly, values below 0 and above 1 (clipped), so ``_augment``'s
    truncate-then-clip is exercised at its boundaries."""
    rng = np.random.default_rng(seed)
    tokens = rng.uniform(0, 1, (n, length, TOKEN_FEAT)).astype(np.float32)
    edges = np.array([-0.3, 0.0, 0.25, 0.5, 0.75, 1.0, 1.4], np.float32)
    for col in (evu.THUMB_FEAT, evu.THUMB_FEAT + 5):
        pick = rng.random((n, length)) < 0.3
        tokens[..., col] = np.where(
            pick, edges[rng.integers(0, len(edges), (n, length))],
            tokens[..., col],
        )
    mask = rng.random((n, length)) < 0.8
    mask[:, 0] = True
    mask[-1] = False  # one example with every token padded
    return {
        "tokens": tokens,
        "mask": mask,
        "seg": rng.integers(0, n_seg, n).astype(np.int32),
        "label": rng.integers(0, n_cls, n).astype(np.int32),
    }


def _t(batch):
    return {k: to_torch(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_tree_close(ref, port, atol, what):
    for i, (a, b) in enumerate(zip(jax.tree.leaves(ref),
                                   list(evu.leaves(port)))):
        np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                                   atol=atol, rtol=0, err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_and_loss_match_the_reference(name):
    cfg, jcfg = _cfg(name)
    jp, p = _params(jcfg)
    b = _batch(1, 6, 12, cfg.n_segments, cfg.n_classes)
    ref = jax.jit(functools.partial(jevu.forward, cfg=jcfg))(
        jp, *(jnp.asarray(b[k]) for k in ("tokens", "mask", "seg"))
    )
    got = evu.forward(p, *(to_torch(b[k]) for k in ("tokens", "mask",
                                                     "seg")), cfg)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=1e-5,
                               rtol=0)
    ref_loss = jax.jit(functools.partial(jevu.loss_fn, cfg=jcfg))(jp, _j(b))
    np.testing.assert_allclose(float(ref_loss),
                               float(evu.loss_fn(p, _t(b), cfg)), atol=1e-5,
                               rtol=0)


def test_augment_truncates_then_clips_as_the_reference():
    cfg, jcfg = _cfg("small")
    b = _batch(2, 4, 16, cfg.n_segments, cfg.n_classes)
    ref = jevu._augment(jnp.asarray(b["tokens"]), jnp.asarray(b["seg"]),
                        jcfg)
    got = evu._augment(to_torch(b["tokens"]), to_torch(b["seg"]), cfg)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("name", sorted(CFGS))
def test_gradients_match_the_reference(name):
    cfg, jcfg = _cfg(name)
    jp, p = _params(jcfg, seed=3)
    b = _batch(4, 8, 10, cfg.n_segments, cfg.n_classes)
    ref = jax.jit(jax.grad(functools.partial(jevu.loss_fn, cfg=jcfg)))(
        jp, _j(b)
    )
    _, got = evu.grad(p, _t(b), cfg)
    for i, (a, g) in enumerate(zip(jax.tree.leaves(ref),
                                   list(evu.leaves(got)))):
        a = np.asarray(a)
        np.testing.assert_allclose(
            a, g.numpy(), atol=1e-5 * float(np.abs(a).max()), rtol=0,
            err_msg=f"leaf {i}",
        )


def _reference_adam(jcfg, train):
    """``evu.train_eval``'s step (evu.py:145-163) on given indices."""

    @jax.jit
    def step(p, m, v, i, idx):
        batch = jax.tree.map(lambda x: x[idx], train)
        g = jax.grad(jevu.loss_fn)(p, batch, jcfg)
        b1, b2 = 0.9, 0.999
        m = jax.tree.map(lambda a, b: b1 * a + (1 - b1) * b, m, g)
        v = jax.tree.map(lambda a, b: b2 * a + (1 - b2) * b * b, v, g)
        t = i + 1.0
        p = jax.tree.map(
            lambda pp, mm, vv: pp
            - jcfg.lr * (mm / (1 - b1**t))
            / (jnp.sqrt(vv / (1 - b2**t)) + 1e-8),
            p, m, v,
        )
        return p, m, v

    return step


def test_twenty_adam_steps_on_given_indices_match_the_reference():
    cfg, jcfg = _cfg("small", batch=8, lr=3e-3)
    jp, p = _params(jcfg, seed=5)
    train = _batch(6, 32, 12, cfg.n_segments, cfg.n_classes)
    step = _reference_adam(jcfg, _j(train))
    jm = jax.tree.map(jnp.zeros_like, jp)
    jv = jax.tree.map(jnp.zeros_like, jp)
    m = evu.tree_map(torch.zeros_like, p)
    v = evu.tree_map(torch.zeros_like, p)
    tt = _t(train)
    rng = np.random.default_rng(7)
    for i in range(20):
        idx = rng.integers(0, 32, cfg.batch)
        jp, jm, jv = step(jp, jm, jv, float(i), jnp.asarray(idx))
        p, m, v = evu.adam_step(
            p, m, v, i, {k: x[torch.from_numpy(idx)] for k, x in tt.items()},
            cfg,
        )
    _assert_tree_close(jp, p, 1e-4, "params")
    _assert_tree_close(jm, m, 1e-5, "m")


def _separable_qa(seed, n, cfg, length=16):
    """A question set the probe can answer: every token carries its
    segment in the timestamp columns, tokens of the queried segment carry
    the answer's one-hot in their first features and the others a random
    distractor class."""
    rng = np.random.default_rng(seed)
    f = TOKEN_FEAT
    tokens = 0.1 * rng.uniform(0, 1, (n, length, f)).astype(np.float32)
    seg_of_tok = np.arange(length) % cfg.n_segments
    t = (seg_of_tok + 0.5) / cfg.n_segments
    tokens[..., evu.THUMB_FEAT] = t
    tokens[..., evu.THUMB_FEAT + 5] = t
    seg = rng.integers(0, cfg.n_segments, n)
    label = rng.integers(0, cfg.n_classes, n)
    distract = rng.integers(0, cfg.n_classes, (n, length))
    cls = np.where(seg_of_tok[None] == seg[:, None], label[:, None],
                   distract)
    np.put_along_axis(tokens, cls[..., None], 1.0, axis=2)
    return {
        "tokens": tokens,
        "mask": np.ones((n, length), bool),
        "seg": seg.astype(np.int32),
        "label": label.astype(np.int32),
    }


def test_train_eval_accuracy_is_within_the_bound_of_the_reference():
    """The two runs draw different initialisations and batch indices
    (``jax.random`` against a ``torch.Generator``), so they are two samples
    of one training procedure, not one run.  On a separable question set
    both reach high accuracy; the bound, 0.1 on 128 test questions, is
    about three binomial standard errors at an accuracy of 0.9."""
    cfg, jcfg = _cfg("small", steps=150, batch=32, lr=3e-3)
    train = _separable_qa(0, 256, cfg)
    test = _separable_qa(1, 128, cfg)
    ref, _ = jevu.train_eval(jax.random.PRNGKey(0), _j(train), _j(test),
                             jcfg)
    got, p = evu.train_eval(0, _t(train), _t(test), cfg, device="cpu")
    assert ref >= 0.9 and got >= 0.9, (ref, got)
    assert abs(ref - got) <= 0.1, (ref, got)
    assert next(evu.leaves(p)).device.type == "cpu"


def test_hir_loss_matches_the_reference():
    jp = jhir.init_params(jax.random.PRNGKey(3))
    model = convert.hir_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(8)
    rgb = rng.uniform(0, 1, (6, 64, 64, 3)).astype(np.float32)
    heat = rng.uniform(0, 1, (6, 64, 64)).astype(np.float32)
    lab = (rng.random((6, 4, 4)) < 0.3).astype(np.float32)
    ref = jax.jit(jhir.loss_fn, static_argnums=4)(
        jp, jnp.asarray(rgb), jnp.asarray(heat), jnp.asarray(lab), 4
    )
    got = hir.loss_fn(model, to_torch(rgb), to_torch(heat), to_torch(lab), 4)
    np.testing.assert_allclose(float(ref), float(got.detach()), atol=1e-6,
                               rtol=0)


def test_hir_loss_gradient_trains_like_the_reference():
    """One SGD step of the Table-1 fine-tune (lr 0.05) from the same
    parameters lands on the same parameters within 1e-6."""
    jp = jhir.init_params(jax.random.PRNGKey(4))
    model = convert.hir_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(9)
    rgb = rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    heat = rng.uniform(0, 1, (4, 64, 64)).astype(np.float32)
    lab = (rng.random((4, 4, 4)) < 0.3).astype(np.float32)
    g = jax.jit(jax.grad(jhir.loss_fn), static_argnums=4)(
        jp, jnp.asarray(rgb), jnp.asarray(heat), jnp.asarray(lab), 4
    )
    ref = jax.tree.map(lambda a, b: a - 0.05 * b, jp, g)
    loss = hir.loss_fn(model, to_torch(rgb), to_torch(heat), to_torch(lab), 4)
    loss.backward()
    with torch.no_grad():
        for prm in model.parameters():
            prm -= 0.05 * prm.grad
    got = convert.hir_from_jax(jax.tree.map(np.asarray, ref), device="cpu")
    for (name, a), b in zip(got.named_parameters(), model.parameters()):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0, msg=name)


def test_patch_relevance_labels_are_exact():
    rng = np.random.default_rng(10)
    obj = rng.integers(0, 4, (5, 64, 64)).astype(np.int32)
    # patches holding 5 and 6 pixels of the attended object: 1.95% and
    # 2.34% of 256, either side of the 2% threshold
    obj[0] = 0
    obj[0, 0, :5] = 2
    obj[0, 16, 16:22] = 2
    target = np.array([2, 1, 3, 0, 2], np.int32)
    ref = jsyn.patch_relevance_labels(jnp.asarray(obj), jnp.asarray(target),
                                      16)
    got = SYN.patch_relevance_labels(to_torch(obj), to_torch(target), 16)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert got[0, 0, 0] == 0 and got[0, 1, 1] == 1


def test_patch_relevance_labels_of_a_rendered_stream():
    s, _ = SYN.generate_stream(np.random.default_rng(0),
                               SYN.StreamConfig(n_frames=6, hw=(64, 64),
                                                n_obj=4), device="cpu")
    ref = jsyn.patch_relevance_labels(jnp.asarray(s.obj_id.numpy()),
                                      jnp.asarray(s.gaze_target.numpy()), 16)
    got = SYN.patch_relevance_labels(s.obj_id, s.gaze_target, 16)
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


def test_evu_from_jax_checks_the_tree():
    _, jcfg = _cfg("small")
    jp = jax.tree.map(np.asarray, jevu.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    p = convert.evu_from_jax(jp, device="cpu")
    assert p["in_proj"].shape == jp["in_proj"].shape
    assert len(p["layers"]) == len(jp["layers"])
    bad = dict(jp, out=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError, match="out"):
        convert.evu_from_jax(bad, device="cpu")
    with pytest.raises(ValueError, match="layers"):
        convert.evu_from_jax({"cls": jp["cls"]}, device="cpu")


def test_init_params_is_seeded_and_on_the_generators_device():
    cfg, _ = _cfg("small")
    a = evu.init_params(torch.Generator().manual_seed(1), cfg)
    b = evu.init_params(torch.Generator().manual_seed(1), cfg)
    for x, y in zip(evu.leaves(a), evu.leaves(b)):
        assert torch.equal(x, y) and x.device.type == "cpu"
    assert a["in_proj"].shape == (TOKEN_FEAT + cfg.n_segments + 2,
                                  cfg.d_model)
