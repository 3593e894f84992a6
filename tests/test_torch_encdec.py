"""The encoder-decoder answer path (SeamlessM4T-large-v2) in the PyTorch
port against the JAX package.

``seamless-m4t-large-v2``'s ``SMOKE_CONFIG`` (2 encoder and 2 decoder
layers, d_model 64, 4 heads, LayerNorm, GeLU): the JAX parameters, drawn
by the reference's ``init`` with their constant leaves (LayerNorm scales
and biases) moved by seeded noise, go through ``convert.encdec_from_jax``
into the port, and the same source embeddings and token ids, made from a
seed, go through both.  The encoder's bidirectional and the decoder's
causal self-attention run on ``"pallas"`` (the JAX side's Pallas kernel
in interpret mode, the port's kernel's plain version) and on ``"ref"``;
cross-attention takes the masked path on both.

The prefill runs the encoder only and returns ``(None, cache)``: the
cross K/V and an empty self-cache of the prompt's length; decode starts
at position 0 (``tests/test_arch_smoke.py``).

Tolerances, as the dense parity tests: 1e-5 with ``cache_dtype=
"float32"``, 2e-2 with the default bf16 cache; greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (assert_leaves_match, perturb_constant_leaves,
                           to_numpy, to_torch)
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import encdec as JED
from repro.serve import efm as jefm
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import encdec as TED
from repro_torch.models.transformer import layer_params
from repro_torch.serve import efm as tefm

ARCH = "seamless-m4t-large-v2"
B, S, S_SRC, NEW = 2, 16, 32, 6
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
    return (jax.tree.map(jnp.asarray, params),
            convert.encdec_from_jax(params, get_smoke_config(ARCH),
                                    device="cpu"))


def _batch(seed=1, n_tok=S):
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (B, n_tok)).astype(np.int32),
            "src_embed": rng.standard_normal((B, S_SRC, cfg.d_model)).astype(
                np.float32)}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: to_torch(v) for k, v in batch.items()}


def test_src_len_matches_jax():
    for seq in (1, 16, 32, 100, 1024, 32768):
        for cfg in (get_smoke_config(ARCH), get_config(ARCH)):
            assert TED.src_len(cfg, seq) == JED.src_len(cfg, seq)


@pytest.mark.parametrize("backend", ["pallas", "ref"])
def test_encoder_and_blocks_match_jax(pair, backend):
    jp, tp = pair
    jcfg, tcfg = _cfgs(attn_backend=backend)
    batch = _batch()
    j = JED.encode(jp, jnp.asarray(batch["src_embed"]), jcfg)
    t = TED.encode(tp, to_torch(batch["src_embed"]), tcfg)
    assert_leaves_match([j], [t], atol=F32_TOL, what="encode")
    x = np.random.default_rng(2).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    for i in range(jcfg.dec_layers):
        jl = jax.tree.map(lambda a: a[i], jp["dec_layers"])
        dj = JED.dec_block(jl, jnp.asarray(x), j, jcfg)
        dt = TED.dec_block(layer_params(tp["dec_layers"], i), to_torch(x), t,
                           tcfg)
        assert_leaves_match([dj], [dt], atol=F32_TOL, what=f"dec_block {i}")


@pytest.mark.parametrize("backend", ["pallas", "ref"])
def test_forward_matches_jax(pair, backend):
    jp, tp = pair
    jcfg, tcfg = _cfgs(attn_backend=backend)
    batch = _batch()
    j = jax.jit(jax_build_model(jcfg).forward)(jp, _jb(batch))
    t = build_model(tcfg, device="cpu").forward(tp, _tb(batch))
    assert_leaves_match([j], [t], atol=F32_TOL, what="forward")


@pytest.mark.parametrize("cache_dtype,tol", [("float32", F32_TOL),
                                             ("bfloat16", BF16_CACHE_TOL)])
def test_prefill_and_decode_from_position_0_match_jax(pair, cache_dtype, tol):
    jp, tp = pair
    jcfg, tcfg = _cfgs(cache_dtype=cache_dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    batch = _batch()
    lj, cj = jax.jit(jm.prefill)(jp, _jb(batch))
    lt, ct = tm.prefill(tp, _tb(batch))
    assert lj is None and lt is None
    assert tuple(ct["k"].shape) == (jcfg.dec_layers, B, jcfg.n_kv_heads, S,
                                    jcfg.head_dim_)
    assert tuple(ct["xk"].shape) == (jcfg.dec_layers, B, jcfg.n_kv_heads,
                                     S_SRC, jcfg.head_dim_)
    for k in ("k", "v", "xk", "xv"):
        assert ct[k].dtype == tcfg.cachedt
        assert_leaves_match([cj[k].astype(jnp.float32)], [ct[k].float()],
                            atol=tol, what=f"prefill cache {k}")
    assert not ct["k"].any() and not ct["v"].any()

    step = jax.jit(jm.decode_step)
    toks = batch["tokens"]
    for t in range(NEW):
        ldj, cj = step(jp, cj, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        ldt, ct = tm.decode_step(tp, ct, to_torch(toks[:, t:t + 1]), t)
        assert_leaves_match([ldj], [ldt], atol=tol, what=f"decode {t}")
    assert_leaves_match([cj["k"].astype(jnp.float32)], [ct["k"].float()],
                        atol=tol, what="decoded cache")


def test_greedy_tokens_equal_jax(pair):
    jp, tp = pair
    jcfg, tcfg = _cfgs(cache_dtype="float32")
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    batch = _batch(seed=3)
    first = batch["tokens"][:, :1]
    _, cj = jax.jit(jm.prefill)(jp, _jb(batch))
    out_j, _ = jefm.greedy_decode_loop(jm, jp, cj, jnp.asarray(first), 0, NEW)
    _, ct = tefm.jit_prefill(tm)(tp, _tb(batch))
    out_t, _ = tefm.greedy_decode_loop(tm, tp, ct, to_torch(first), 0, NEW)
    np.testing.assert_array_equal(np.asarray(out_j), to_numpy(out_t))


def test_decode_matches_forward(pair):
    """The port's own property (``tests/test_arch_smoke.py``): decoding
    tokens 0..S-2 one at a time from an empty self-cache gives the
    forward's logits at every position."""
    _, tp = pair
    _, tcfg = _cfgs(cache_dtype="float32")
    tm = build_model(tcfg, device="cpu")
    batch = _tb(_batch(seed=4))
    full = tm.forward(tp, batch)
    _, cache = tm.prefill(tp, batch)
    for t in range(S - 1):
        ld, cache = tm.decode_step(tp, cache, batch["tokens"][:, t:t + 1], t)
        np.testing.assert_allclose(to_numpy(ld[:, 0]), to_numpy(full[:, t]),
                                   atol=F32_TOL)


def test_init_serve_is_the_reference_cache():
    jcfg, tcfg = _cfgs()
    for seq in (8, 64):
        spec = jax.eval_shape(
            lambda: jax_build_model(jcfg).init_serve(B, seq))
        got = build_model(tcfg, device="cpu").init_serve(B, seq)
        assert set(got) == set(spec)
        for k, s in spec.items():
            assert tuple(got[k].shape) == s.shape and not got[k].any()


def test_encdec_from_jax_rejects_a_wrong_tree(pair):
    jp, _ = pair
    np_params = jax.tree.map(np.asarray, jp)
    bad = dict(np_params)
    bad.pop("enc_norm")
    with pytest.raises(ValueError, match="keys"):
        convert.encdec_from_jax(bad, get_smoke_config(ARCH), device="cpu")
    short = dict(np_params, dec_layers=jax.tree.map(
        lambda a: a[:1], np_params["dec_layers"]))
    with pytest.raises(ValueError, match="shape"):
        convert.encdec_from_jax(short, get_smoke_config(ARCH), device="cpu")
