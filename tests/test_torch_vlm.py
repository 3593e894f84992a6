"""The VLM answer path (Llama-3.2-Vision-11B) in the PyTorch port against
the JAX package, and cross-attention in ``attention_full``.

``llama-3.2-vision-11b``'s ``SMOKE_CONFIG`` (4 self layers in 2 groups of
2, each group after one gated cross-attention block; d_model 64, GQA 4/2,
``img_seq`` 16): the JAX parameters, drawn by the reference's ``init``,
with their constant leaves moved by seeded noise (the norm scales) and
the tanh gates, which start at 0 and would hide the whole image path,
drawn of order 1 from a seed, go through ``convert.vlm_from_jax`` into
the port, and the same token ids and image embeddings, made from a
seed, go through both.  The image
embeddings are 12 tokens long, not ``img_seq``: the cross K/V take the
length of the embeddings given, as an EPIC token stream of any length
needs.  Self-attention runs on ``"pallas"`` (the JAX side's Pallas
kernel in interpret mode, the port's kernel's plain version) and on
``"ref"``.

Tolerances, as the dense parity tests: 1e-5 with ``cache_dtype=
"float32"``, 2e-2 with the default bf16 cache; greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_leaves_match, perturb_constant_leaves,
                           to_numpy, to_torch)
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models import vision as JV
from repro.serve import efm as jefm
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import vision as TV
from repro_torch.models.transformer import layer_params
from repro_torch.serve import efm as tefm

ARCH = "llama-3.2-vision-11b"
B, PROMPT, NEW, N_IMG = 2, 24, 4, 12
F32_TOL = 1e-5
BF16_CACHE_TOL = 2e-2


def _cfgs(**kw):
    kw.setdefault("attn_backend", "pallas")
    return (jax_smoke_config(ARCH).replace(**kw),
            get_smoke_config(ARCH).replace(**kw))


@pytest.fixture(scope="module")
def pair():
    """(JAX params, the same params in the port), both perturbed."""
    params = perturb_constant_leaves(
        jax_build_model(jax_smoke_config(ARCH)).init(jax.random.PRNGKey(0)))
    # Gates of order 1 (tanh 0.5-0.9), so that the image path weighs as
    # much as the text path.
    rng = np.random.default_rng(1)
    for g in ("gate_attn", "gate_mlp"):
        n = params["xattn_layers"][g].shape
        params["xattn_layers"][g] = (rng.uniform(0.5, 1.5, n) * rng.choice(
            [-1, 1], n)).astype(np.float32)
    return (jax.tree.map(jnp.asarray, params),
            convert.vlm_from_jax(params, get_smoke_config(ARCH),
                                 device="cpu"))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _batch(n_tok, seed=1, n_img=N_IMG):
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, n_tok)).astype(np.int32),
            "img_embed": _x((B, n_img, cfg.d_model), seed + 100)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: to_torch(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Cross-attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "chunked", "pallas"])
def test_cross_attention_matches_jax(backend):
    """``kv_ctx`` of another length than x: keys and values from the
    context, no RoPE, every key seen; ``"pallas"`` takes the masked path,
    as the reference routes."""
    rng = np.random.default_rng(5)
    jp = JL.init_attention(jax.random.PRNGKey(3), 32, 4, 2, 8)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a)), jp)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 10, 32)).astype(np.float32)
    j = JL.attention_full(jp, jnp.asarray(x), 4, 2, backend=backend,
                          causal=False, rope_base=0.0,
                          kv_ctx=jnp.asarray(ctx))
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_pallas)

    before = flash_attention_pallas.launches
    t = TL.attention_full(tp, to_torch(x), 4, 2, backend=backend,
                          causal=False, rope_base=0.0, kv_ctx=to_torch(ctx))
    assert flash_attention_pallas.launches == before
    np.testing.assert_allclose(np.asarray(j), to_numpy(t), atol=F32_TOL)


def test_cross_attention_ignores_causal_and_the_rope_base():
    """As the reference: with ``kv_ctx`` the mask is all ones and nothing
    is rotated, whatever ``causal`` and ``rope_base`` say."""
    rng = np.random.default_rng(6)
    jp = JL.init_attention(jax.random.PRNGKey(4), 32, 4, 4, 8)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a)), jp)
    x = to_torch(rng.standard_normal((1, 8, 32)).astype(np.float32))
    ctx = to_torch(rng.standard_normal((1, 8, 32)).astype(np.float32))
    plain = TL.attention_full(tp, x, 4, 4, causal=False, rope_base=0.0,
                              kv_ctx=ctx)
    for backend in ("ref", "chunked"):
        other = TL.attention_full(tp, x, 4, 4, causal=True, backend=backend,
                                  rope_base=10000.0, kv_ctx=ctx)
        np.testing.assert_allclose(to_numpy(other), to_numpy(plain),
                                   atol=F32_TOL)


def test_xattn_block_matches_jax(pair):
    jp, tp = pair
    jcfg, tcfg = _cfgs()
    x, img = _x((B, 20, jcfg.d_model), 7), _x((B, N_IMG, jcfg.d_model), 8)
    for g in range(JV.n_groups(jcfg)):
        jx = jax.tree.map(lambda a: a[g], jp["xattn_layers"])
        j = JV.xattn_block(jx, jnp.asarray(x), jnp.asarray(img), jcfg)
        t = TV.xattn_block(layer_params(tp["xattn_layers"], g), to_torch(x),
                           to_torch(img), tcfg)
        assert_leaves_match([j], [t], atol=F32_TOL, what=f"group {g}")
        assert float(np.abs(np.asarray(j) - x).max()) > 0.1  # gates open


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["pallas", "ref"])
def test_forward_matches_jax(pair, backend):
    jp, tp = pair
    jcfg, tcfg = _cfgs(attn_backend=backend)
    batch = _batch(PROMPT + NEW)
    j = jax.jit(jax_build_model(jcfg).forward)(jp, _jb(batch))
    t = build_model(tcfg, device="cpu").forward(tp, _tb(batch))
    assert_leaves_match([j], [t], atol=F32_TOL, what="forward")


def _pad_cache(cache, n):
    """``n`` more self-attention positions (the caller's job, as
    ``examples/serve_stream.py`` pads); the cross K/V stay as they are."""
    out = dict(cache)
    for k in ("k", "v"):
        widths = [(0, 0)] * cache[k].ndim
        widths[-2] = (0, n)
        out[k] = jnp.pad(cache[k], widths)
    return out


def _to_port(cache, dtype):
    return {k: to_torch(np.asarray(v, np.float32)).to(dtype)
            for k, v in cache.items()}


@pytest.mark.parametrize("cache_dtype,tol", [("float32", F32_TOL),
                                             ("bfloat16", BF16_CACHE_TOL)])
def test_prefill_and_decode_match_jax(pair, cache_dtype, tol):
    jp, tp = pair
    jcfg, tcfg = _cfgs(cache_dtype=cache_dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    batch = _batch(PROMPT + NEW)
    prompt = dict(batch, tokens=batch["tokens"][:, :PROMPT])
    lj, cj = jax.jit(jm.prefill)(jp, _jb(prompt))
    lt, ct = tm.prefill(tp, _tb(prompt))
    assert_leaves_match([lj], [lt], atol=F32_TOL, what="prefill logits")
    g, period = JV.n_groups(jcfg), jcfg.cross_attn_period
    assert tuple(ct["k"].shape) == (g, period, B, jcfg.n_kv_heads, PROMPT,
                                    jcfg.head_dim_)
    assert tuple(ct["xk"].shape) == (g, B, jcfg.n_kv_heads, N_IMG,
                                     jcfg.head_dim_)
    for k in ("k", "v", "xk", "xv"):
        assert ct[k].dtype == tcfg.cachedt
        assert_leaves_match([cj[k].astype(jnp.float32)], [ct[k].float()],
                            atol=tol, what=f"prefill cache {k}")

    ct = tefm.pad_for_decode(tm, _to_port(cj, tcfg.cachedt), NEW)
    cj = _pad_cache(cj, NEW)
    step = jax.jit(jm.decode_step)
    toks = batch["tokens"]
    for i in range(NEW):
        pos = PROMPT + i
        ldj, cj = step(jp, cj, jnp.asarray(toks[:, pos:pos + 1]),
                       jnp.int32(pos))
        ldt, ct = tm.decode_step(tp, ct, to_torch(toks[:, pos:pos + 1]), pos)
        assert_leaves_match([ldj], [ldt], atol=tol, what=f"decode {i}")
    assert_leaves_match([cj["k"].astype(jnp.float32)], [ct["k"].float()],
                        atol=tol, what="decoded cache")


def test_greedy_tokens_equal_jax(pair):
    jp, tp = pair
    jcfg, tcfg = _cfgs(cache_dtype="float32")
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    batch = _batch(PROMPT, seed=2)
    lj, cj = jax.jit(jm.prefill)(jp, _jb(batch))
    first = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    ct = tefm.pad_for_decode(tm, _to_port(cj, torch.float32), NEW)
    cj = _pad_cache(cj, NEW)
    out_j, _ = jefm.greedy_decode_loop(jm, jp, cj, first, PROMPT, NEW)
    lt, _ = tefm.jit_prefill(tm)(tp, _tb(batch))
    first_t = torch.argmax(lt[:, -1:], dim=-1).to(torch.int32)
    out_t, _ = tefm.greedy_decode_loop(tm, tp, ct, first_t, PROMPT, NEW)
    np.testing.assert_array_equal(np.asarray(out_j), to_numpy(out_t))


@pytest.mark.parametrize("n_img", [N_IMG, 16])
def test_decode_matches_forward(pair, n_img):
    """The port's own property (``tests/test_arch_smoke.py``): a prefill
    of S - 1 tokens and one decode step against the forward's logits at
    S - 2 and S - 1, with ``img_seq`` image tokens and with fewer."""
    _, tp = pair
    _, tcfg = _cfgs(cache_dtype="float32")
    tm = build_model(tcfg, device="cpu")
    batch = _tb(_batch(PROMPT, seed=3, n_img=n_img))
    full = tm.forward(tp, batch)
    lp, cache = tm.prefill(tp, dict(batch, tokens=batch["tokens"][:, :-1]))
    np.testing.assert_allclose(to_numpy(lp[:, -1]),
                               to_numpy(full[:, PROMPT - 2]), atol=F32_TOL)
    cache = tefm.pad_for_decode(tm, cache, 1)
    ld, _ = tm.decode_step(tp, cache, batch["tokens"][:, -1:], PROMPT - 1)
    np.testing.assert_allclose(to_numpy(ld[:, -1]),
                               to_numpy(full[:, PROMPT - 1]), atol=F32_TOL)


def test_zero_gates_hide_the_image_at_init():
    """``init`` draws the gates at 0, as the reference: tanh(0) = 0, so
    the logits do not depend on the image until the gates move."""
    _, tcfg = _cfgs()
    tm = build_model(tcfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    for g in ("gate_attn", "gate_mlp"):
        assert params["xattn_layers"][g].shape == (TV.n_groups(tcfg),)
        assert not params["xattn_layers"][g].any()
    a = tm.forward(params, _tb(_batch(16, seed=4)))
    b = tm.forward(params, _tb(_batch(16, seed=4, n_img=5)))
    assert torch.equal(a, b)


def test_init_serve_is_the_reference_cache():
    jcfg, tcfg = _cfgs()
    spec = jax.eval_shape(lambda: jax_build_model(jcfg).init_serve(B, 32))
    got = build_model(tcfg, device="cpu").init_serve(B, 32)
    assert set(got) == set(spec)
    for k, s in spec.items():
        assert tuple(got[k].shape) == s.shape and not got[k].any()


def test_vlm_from_jax_rejects_a_wrong_tree(pair):
    jp, _ = pair
    np_params = jax.tree.map(np.asarray, jp)
    bad = dict(np_params, lm_head={"w": np.zeros((64, 128), np.float32)})
    with pytest.raises(ValueError, match="keys"):
        convert.vlm_from_jax(bad, get_smoke_config(ARCH), device="cpu")
    flat = dict(np_params, self_layers=jax.tree.map(
        lambda a: a.reshape((-1,) + a.shape[2:]), np_params["self_layers"]))
    with pytest.raises(ValueError, match="shape"):
        convert.vlm_from_jax(flat, get_smoke_config(ARCH), device="cpu")
