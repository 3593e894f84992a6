"""The Zamba2 hybrid answer path in the PyTorch port against the JAX
package, and the sliding window of the attention layers.

``zamba2-2.7b``'s ``SMOKE_CONFIG`` (4 Mamba-2 layers, d_model 64, SSM
state 16, 2 shared blocks each invoked once, attention window 64, scan
chunk 8): the JAX parameters, drawn by the reference's ``init``, with
its constant leaves (biases, norm scales, skip and decay parameters) moved
by seeded noise so that their terms are exercised, go through ``convert.hybrid_from_jax`` into the port, and the same token
ids, made from a seed, go through both.

The reference's prefill runs its scan ``"chunked"`` (``mamba2.py:93``);
the port's prefill is held against it on ``"chunked"`` and on
``"pallas"`` (the CUDA kernel's route, its plain version on the CPU).

Tolerances, as the dense parity tests: 1e-5 with ``cache_dtype=
"float32"`` (float32 end to end, the packages differ in summation order);
2e-2 with the default bf16 cache, the reference's own bound for it
(``tests/test_arch_smoke.py``).  Logits are held to them as they are.
The serve state's float leaves are held to them times the leaf's scale
(its largest |value|, at least 1): the shared blocks' keys and values
are several times larger than 1, and each Mamba layer roughly doubles
the few-ulp differences of the first layer's projections.  ``slot_pos``
and greedy tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_leaves_match, perturb_constant_leaves,
                           to_numpy, to_torch)
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.serve import efm as jefm
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.serve import efm as tefm

ARCH = "zamba2-2.7b"
B, PROMPT, NEW = 2, 24, 4
F32_TOL = 1e-5
BF16_CACHE_TOL = 2e-2
FLOAT_LEAVES = ("conv", "ssm", "k", "v")


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the same params in the port), both perturbed."""
    params = perturb_constant_leaves(jax_build_model(jax_smoke_config(ARCH)).init(
        jax.random.PRNGKey(0)))
    return (jax.tree.map(jnp.asarray, params),
            convert.hybrid_from_jax(params, get_smoke_config(ARCH),
                                    device="cpu"))


def _cfgs(**kw):
    return (jax_smoke_config(ARCH).replace(**kw),
            get_smoke_config(ARCH).replace(**kw))


def _tokens(n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, get_smoke_config(ARCH).vocab, (B, n)).astype(
        np.int32)


def _pad_cache(cache, n):
    """``n`` more KV slots (the caller's job, as for the dense caches):
    positions below the window keep slot = position, so the new tokens
    land in the added slots, marked empty by ``slot_pos = -1``."""
    out = dict(cache)
    for k in ("k", "v"):
        widths = [(0, 0)] * cache[k].ndim
        widths[3] = (0, n)
        out[k] = jnp.pad(cache[k], widths)
    out["slot_pos"] = jnp.pad(cache["slot_pos"], ((0, 0), (0, 0), (0, n)),
                              constant_values=-1)
    return out


def _to_port_cache(cache):
    out = {}
    for k, v in cache.items():
        a = np.asarray(v, np.float32 if v.dtype == jnp.bfloat16 else v.dtype)
        t = to_torch(a)
        out[k] = t.bfloat16() if v.dtype == jnp.bfloat16 else t
    return out


def _assert_cache(jc, tc, tol, what):
    for k in FLOAT_LEAVES:
        a = np.asarray(jc[k], np.float32)
        scale = max(1.0, float(np.abs(a).max()))
        assert_leaves_match([a], [tc[k].float()], atol=tol * scale,
                            what=f"{what} {k}")
    assert_leaves_match([jc["slot_pos"]], [tc["slot_pos"]],
                        what=f"{what} slot_pos")


def _prefill_and_decode(pair, toks, prompt, cache_dtype, tol, scan_backend,
                        pad, **cfg_kw):
    jparams, tparams = pair
    jcfg, tcfg = _cfgs(cache_dtype=cache_dtype, **cfg_kw)
    jm = jax_build_model(jcfg)
    tm = build_model(tcfg, device="cpu", scan_backend=scan_backend)
    lj, cj = jax.jit(jm.prefill)(jparams,
                                 {"tokens": jnp.asarray(toks[:, :prompt])})
    lt, ct = tm.prefill(tparams, {"tokens": to_torch(toks[:, :prompt])})
    assert ct["k"].dtype == tcfg.cachedt
    assert_leaves_match([lj], [lt], atol=F32_TOL, what="prefill logits")
    _assert_cache(cj, ct, tol, "prefill")

    if pad:
        cj = _pad_cache(cj, NEW)
    ct = _to_port_cache(cj)
    step = jax.jit(jm.decode_step)
    for i in range(NEW):
        pos = prompt + i
        ldj, cj = step(jparams, cj, jnp.asarray(toks[:, pos:pos + 1]),
                       jnp.int32(pos))
        ldt, ct = tm.decode_step(tparams, ct, to_torch(toks[:, pos:pos + 1]),
                                 pos)
        assert_leaves_match([ldj], [ldt], atol=tol, what=f"decode {i}")
    _assert_cache(cj, ct, tol, "decoded")


@pytest.mark.parametrize("cache_dtype,tol,scan_backend", [
    ("float32", F32_TOL, "chunked"), ("float32", F32_TOL, "pallas"),
    ("bfloat16", BF16_CACHE_TOL, "pallas"),
])
def test_forward_prefill_and_decode_match_jax(pair, cache_dtype, tol,
                                              scan_backend):
    jparams, tparams = pair
    jcfg, tcfg = _cfgs(cache_dtype=cache_dtype)
    toks = _tokens(PROMPT + NEW)
    full_j = jax.jit(jax_build_model(jcfg).forward)(
        jparams, {"tokens": jnp.asarray(toks)})
    full_t = build_model(tcfg, device="cpu").forward(
        tparams, {"tokens": to_torch(toks)})
    assert_leaves_match([full_j], [full_t], atol=F32_TOL, what="forward")
    _prefill_and_decode(pair, toks, PROMPT, cache_dtype, tol, scan_backend,
                        pad=True)


@pytest.mark.parametrize("scan_backend", ["chunked", "pallas"])
def test_windowed_prefill_and_decode_past_the_window_match_jax(
        pair, scan_backend):
    """S = 128 > attn_window = 64: the prefill attends through the window
    and keeps the last 64 positions in modular slots (``slot_pos`` equal
    to the reference's); decode then continues past the window, each new
    token overwriting the oldest slot, as the reference's
    tests/test_arch_smoke.py:146 drives it."""
    toks = _tokens(128 + NEW, seed=3)
    _prefill_and_decode(pair, toks, 128, "float32", F32_TOL, scan_backend,
                        pad=False)


@pytest.mark.parametrize("s", [PROMPT, 128])  # below / above the window
def test_pallas_attention_matches_jax(pair, s, monkeypatch):
    """``attn_backend="pallas"``: the forward pass runs the flash kernel
    (JAX: the Pallas kernel in interpret mode; the port: its plain version
    on the CPU) at every S; the port's prefill runs it within the window
    and the masked path past it (``window`` set), where the reference's
    prefill takes the masked path throughout.  Decode continues from the
    prefill's cache as in the tests above."""
    calls = []
    real = TL.flash_attention_pallas

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(TL, "flash_attention_pallas", spy)
    jparams, tparams = pair
    jcfg, tcfg = _cfgs(cache_dtype="float32", attn_backend="pallas")
    toks = _tokens(s + NEW, seed=4)
    full_j = jax.jit(jax_build_model(jcfg).forward)(
        jparams, {"tokens": jnp.asarray(toks[:, :s])})
    full_t = build_model(tcfg, device="cpu").forward(
        tparams, {"tokens": to_torch(toks[:, :s])})
    assert_leaves_match([full_j], [full_t], atol=F32_TOL, what="forward")
    n_inv = tcfg.n_layers // tcfg.shared_attn_period
    assert len(calls) == n_inv
    calls.clear()
    _prefill_and_decode(pair, toks, s, "float32", F32_TOL, "pallas",
                        pad=s <= tcfg.attn_window, attn_backend="pallas")
    assert len(calls) == (n_inv if s <= tcfg.attn_window else 0)


def test_greedy_tokens_equal_jax(pair):
    jparams, tparams = pair
    jcfg, tcfg = _cfgs(cache_dtype="float32")
    jm = jax_build_model(jcfg)
    tm = build_model(tcfg, device="cpu", scan_backend="pallas")
    toks = _tokens(PROMPT, seed=2)
    lj, cj = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    first = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    cj = _pad_cache(cj, NEW)
    out_j, _ = jefm.greedy_decode_loop(jm, jparams, cj, first, PROMPT, NEW)
    lt, _ = tefm.jit_prefill(tm)(tparams, {"tokens": to_torch(toks)})
    first_t = torch.argmax(lt[:, -1:], dim=-1).to(torch.int32)
    out_t, _ = tefm.greedy_decode_loop(tm, tparams, _to_port_cache(cj),
                                       first_t, PROMPT, NEW)
    np.testing.assert_array_equal(np.asarray(out_j), out_t.numpy())


def test_init_serve_matches_the_reference():
    for max_seq in (PROMPT, 100):  # below and above the window of 64
        jcfg, tcfg = _cfgs()
        spec = jax.eval_shape(
            lambda: jax_build_model(jcfg).init_serve(B, max_seq))
        cache = build_model(tcfg, device="cpu").init_serve(B, max_seq)
        assert set(cache) == set(spec)
        for k, v in cache.items():
            assert tuple(v.shape) == tuple(spec[k].shape), k
            assert str(v.dtype) == "torch." + str(spec[k].dtype), k
        assert bool((cache["slot_pos"] == -1).all())


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
    lay = params["layers"]
    assert abs(float(lay["in_proj"]["w"].std()) * cfg.d_model ** 0.5
               - 1.0) < 0.1
    assert abs(float(lay["conv_w"].std()) * cfg.ssm_conv ** 0.5 - 1.0) < 0.1
    assert torch.allclose(torch.nn.functional.softplus(lay["dt_bias"]),
                          torch.tensor(0.01))


def test_full_config_matches_the_reference():
    j, t = jax_get_config(ARCH), get_config(ARCH)
    assert j.__dict__ == t.__dict__
    d_inner = t.ssm_expand * t.d_model
    assert (t.n_layers, t.d_model, t.ssm_state, d_inner, d_inner // 64,
            t.n_layers // t.shared_attn_period, t.vocab) == (
        54, 2560, 64, 5120, 80, 9, 32000)
    assert jax_smoke_config(ARCH).__dict__ == get_smoke_config(ARCH).__dict__


def test_hybrid_from_jax_rejects_a_wrong_tree(pair):
    jparams, _ = pair
    np_params = jax.tree.map(np.asarray, jparams)
    cfg = get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="keys"):
        convert.hybrid_from_jax(dict(np_params, extra={"w": np.zeros(3)}),
                                cfg, device="cpu")
    wrong = jax.tree.map(lambda a: a, np_params)
    wrong["shared"]["out"]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="w: shape"):
        convert.hybrid_from_jax(wrong, cfg, device="cpu")


# ---------------------------------------------------------------------------
# The sliding window of the attention layers.
# ---------------------------------------------------------------------------


def _attn_params(seed):
    jp = JL.init_attention(jax.random.PRNGKey(seed), 32, 4, 2, 8,
                           qkv_bias=True)
    return jp, jax.tree.map(lambda a: to_torch(np.asarray(a)), jp)


@pytest.mark.parametrize("backend,causal,window", [
    ("ref", True, 5), ("ref", False, 5), ("chunked", True, 5),
    ("ref", True, 16),
])
def test_attention_full_window_matches_jax(backend, causal, window):
    jp, tp = _attn_params(3)
    x = np.random.default_rng(5).standard_normal((2, 16, 32)).astype(
        np.float32)
    j = JL.attention_full(jp, jnp.asarray(x), 4, 2, backend=backend,
                          causal=causal, window=window)
    t = TL.attention_full(tp, to_torch(x), 4, 2, backend=backend,
                          causal=causal, window=window)
    np.testing.assert_allclose(np.asarray(j), to_numpy(t), atol=F32_TOL)


@pytest.mark.parametrize("sq,chunk,window", [(48, 16, 8), (40, 16, 20)])
def test_attention_chunked_window_matches_jax(sq, chunk, window):
    rng = np.random.default_rng(sq + window)
    q, k, v = [rng.standard_normal((1, 2, sq, 16)).astype(np.float32)
               for _ in range(3)]
    j = JL.attention_chunked(*map(jnp.asarray, (q, k, v)), window=window,
                             q_chunk=chunk, k_chunk=chunk)
    t = TL.attention_chunked(*map(to_torch, (q, k, v)), window=window,
                             q_chunk=chunk, k_chunk=chunk)
    np.testing.assert_allclose(np.asarray(j), to_numpy(t), atol=F32_TOL)


@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_window_matches_jax(window):
    jp, tp = _attn_params(4)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, 32)).astype(np.float32)
    cache = {n: rng.standard_normal((2, 2, 12, 8)).astype(np.float32)
             for n in ("k", "v")}
    j, jc = JL.attention_decode(jp, jnp.asarray(x),
                                jax.tree.map(jnp.asarray, cache),
                                jnp.int32(9), 4, 2, window=window)
    t, tc = TL.attention_decode(tp, to_torch(x),
                                jax.tree.map(to_torch, cache), 9, 4, 2,
                                window=window)
    np.testing.assert_allclose(np.asarray(j), to_numpy(t), atol=F32_TOL)
    np.testing.assert_allclose(np.asarray(jc["k"]), to_numpy(tc["k"]),
                               atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_backend_with_a_window_takes_the_masked_path_as_jax(
        causal, monkeypatch):
    """With a window the reference's ``backend="pallas"`` takes the masked
    path (the kernel runs only when ``window is None``); so does the
    port's, and it launches nothing."""
    monkeypatch.setattr(TL, "flash_attention_pallas", None)  # never called
    jp, tp = _attn_params(3)
    x = np.random.default_rng(6).standard_normal((2, 16, 32)).astype(
        np.float32)
    j = JL.attention_full(jp, jnp.asarray(x), 4, 2, backend="pallas",
                          causal=causal, window=5)
    t = TL.attention_full(tp, to_torch(x), 4, 2, backend="pallas",
                          causal=causal, window=5)
    np.testing.assert_allclose(np.asarray(j), to_numpy(t), atol=F32_TOL)
