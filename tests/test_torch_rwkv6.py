"""The RWKV6 answer path in the PyTorch port against the JAX package.

``rwkv6-3b``'s ``SMOKE_CONFIG`` (2 layers, d_model 64, 4 heads of 16,
scan chunk 8): the JAX parameters, drawn by the reference's ``init``, with
its constant leaves (the zero-initialised mixing, LoRA and bias leaves,
the base decay) moved by seeded noise so that their terms are exercised,
go through ``convert.rwkv6_from_jax`` into the
port, and the same token ids, made from a seed, go through both.

The reference's prefill runs its scan ``"chunked"`` (``model.py:102``);
the port's prefill is held against it on each of its scan backends,
``"pallas"`` (the CUDA kernel's route, its plain version on the CPU)
included.  ``forward`` runs the scan on ``"ref"`` in both packages.

Tolerance: 1e-5, as the dense parity tests (the models are float32 end to
end and the packages differ in summation order: a few ulps of values of
order 1).  The serve state is float32 in both; its wkv sums over the
prompt reach tens, where the reference's own chunked form and its
sequential oracle already differ by several ulps, so it is held to 1e-5
relative as well.  Greedy tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_leaves_match, perturb_constant_leaves,
                           to_torch)
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.serve import efm as jefm
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.serve import efm as tefm

ARCH = "rwkv6-3b"
B, PROMPT, NEW = 2, 24, 4
TOL = 1e-5
STATE_RTOL = 1e-5
STATE = ("shift_tm", "shift_cm", "wkv")


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the same params in the port), both perturbed."""
    cfg = jax_smoke_config(ARCH)
    params = perturb_constant_leaves(
        jax_build_model(cfg).init(jax.random.PRNGKey(0)))
    return (jax.tree.map(jnp.asarray, params),
            convert.rwkv6_from_jax(params, get_smoke_config(ARCH),
                                   device="cpu"))


def _tokens(seed=1):
    rng = np.random.default_rng(seed)
    vocab = get_smoke_config(ARCH).vocab
    return rng.integers(0, vocab, (B, PROMPT + NEW)).astype(np.int32)


def _state_leaves(state):
    return [state[k] for k in STATE]


@pytest.mark.parametrize("scan_backend", ["chunked", "pallas", "ref"])
def test_forward_prefill_and_decode_match_jax(pair, scan_backend):
    jparams, tparams = pair
    jm = jax_build_model(jax_smoke_config(ARCH))
    tm = build_model(get_smoke_config(ARCH), device="cpu",
                     scan_backend=scan_backend)
    toks = _tokens()

    full_j = jax.jit(jm.forward)(jparams, {"tokens": jnp.asarray(toks)})
    full_t = tm.forward(tparams, {"tokens": to_torch(toks)})
    assert_leaves_match([full_j], [full_t], atol=TOL, what="forward")

    prompt = toks[:, :PROMPT]
    lj, sj = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(prompt)})
    lt, st = tm.prefill(tparams, {"tokens": to_torch(prompt)})
    assert_leaves_match([lj], [lt], atol=TOL, what="prefill logits")
    assert_leaves_match(_state_leaves(sj), _state_leaves(st), atol=TOL,
                        rtol=STATE_RTOL, what="prefill state")
    assert all(st[k].dtype == torch.float32 for k in STATE)

    # Teacher-forced decode: every step's logits and the state.
    step = jax.jit(jm.decode_step)
    for i in range(NEW):
        pos = PROMPT + i
        ldj, sj = step(jparams, sj, jnp.asarray(toks[:, pos:pos + 1]),
                       jnp.int32(pos))
        ldt, st = tm.decode_step(tparams, st, to_torch(toks[:, pos:pos + 1]),
                                 pos)
        assert_leaves_match([ldj], [ldt], atol=TOL, what=f"decode {i}")
        assert_leaves_match(_state_leaves(sj), _state_leaves(st), atol=TOL,
                            rtol=STATE_RTOL, what=f"state after decode {i}")


def test_greedy_tokens_equal_jax(pair):
    jparams, tparams = pair
    jm = jax_build_model(jax_smoke_config(ARCH))
    tm = build_model(get_smoke_config(ARCH), device="cpu",
                     scan_backend="pallas")
    toks = _tokens(seed=2)[:, :PROMPT]
    lj, sj = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    first = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    out_j, _ = jefm.greedy_decode_loop(jm, jparams, sj, first, PROMPT, NEW)
    lt, st = tefm.jit_prefill(tm)(tparams, {"tokens": to_torch(toks)})
    first_t = torch.argmax(lt[:, -1:], dim=-1).to(torch.int32)
    out_t, _ = tefm.greedy_decode_loop(tm, tparams, st, first_t, PROMPT, NEW)
    np.testing.assert_array_equal(np.asarray(out_j), out_t.numpy())


def test_init_serve_is_the_zero_state():
    cfg = get_smoke_config(ARCH)
    tm = build_model(cfg, device="cpu")
    state = tm.init_serve(B, PROMPT)
    spec = jax.eval_shape(lambda: jax_build_model(
        jax_smoke_config(ARCH)).init_serve(B, PROMPT))
    for k in STATE:
        assert tuple(state[k].shape) == tuple(spec[k].shape)
        assert state[k].dtype == torch.float32 and not bool(state[k].any())


def test_init_matches_the_reference_tree_and_scales():
    cfg = get_smoke_config(ARCH)
    spec = jax.eval_shape(jax_build_model(jax_smoke_config(ARCH)).init,
                          jax.random.PRNGKey(0))
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    j_leaves = jax.tree_util.tree_leaves_with_path(spec)
    t_leaves = jax.tree_util.tree_leaves_with_path(params)
    assert [jax.tree_util.keystr(p) for p, _ in j_leaves] == [
        jax.tree_util.keystr(p) for p, _ in t_leaves]
    for (_, j), (_, t) in zip(j_leaves, t_leaves):
        assert tuple(j.shape) == tuple(t.shape)
        assert str(t.dtype) == "torch." + str(j.dtype)
    tm = params["layers"]["tm"]
    assert abs(float(tm["wr"]["w"].std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    assert abs(float(tm["u"].std()) / 0.3 - 1.0) < 0.1
    assert bool((tm["w0"] == -2.0).all()) and not bool(tm["lora_b"].any())


def test_full_config_matches_the_reference():
    j, t = jax_get_config(ARCH), get_config(ARCH)
    assert j.__dict__ == t.__dict__
    assert (t.n_layers, t.d_model, t.d_model // t.rwkv_head_dim, t.d_ff,
            t.vocab) == (32, 2560, 40, 8960, 65536)
    js, ts = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    assert js.__dict__ == ts.__dict__


def test_rwkv6_from_jax_rejects_a_wrong_tree(pair):
    jparams, _ = pair
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="keys"):
        convert.rwkv6_from_jax(dict(np_params, extra={"w": np.zeros(3)}),
                               cfg, device="cpu")
    wrong = jax.tree.map(lambda a: a, np_params)
    wrong["layers"]["tm"]["u"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="u: shape"):
        convert.rwkv6_from_jax(wrong, cfg, device="cpu")


def test_unknown_scan_backend_raises():
    with pytest.raises(ValueError, match="scan backend"):
        build_model(get_smoke_config(ARCH), device="cpu", scan_backend="bogus")


def test_time_mix_output_is_the_same_on_the_view(pair):
    """TimeMix with its scan on ``"pallas"`` (o the (B, H, T, V) view of a
    (B, T, H, V) buffer, the CPU route) and on ``"chunked"`` (a contiguous
    o): the same output and final wkv state."""
    from repro_torch.models import rwkv6

    cfg = get_smoke_config(ARCH)
    tm = rwkv6.layer_params(pair[1]["layers"], 0)["tm"]
    x = torch.randn(B, PROMPT, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    outs = {b: rwkv6.time_mix(tm, x, cfg, backend=b, return_state=True)
            for b in ("pallas", "chunked")}
    (out, s), (pout, ps) = outs["pallas"], outs["chunked"]
    assert out.shape == (B, PROMPT, cfg.d_model) and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), pout.numpy(), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(s.numpy(), ps.numpy(), atol=TOL, rtol=TOL)
