"""The MoE/MLA answer path (DeepSeek V2-Lite and V3) in the PyTorch port
against the JAX package.

The ``SMOKE_CONFIG``s of ``deepseek-v2-lite-16b`` (3 layers, the first
dense; 8 experts top-2 plus 1 shared; MLA r 32, nope 16, rope 8, v 16;
full-rank queries) and ``deepseek-v3-671b`` (4 layers, ``q_lora_rank``
48, the MTP tree): the JAX parameters, drawn by the reference's ``init``
with their constant leaves (norm scales) moved by seeded noise, go
through ``convert.moe_mla_from_jax`` into the port, and the same inputs,
made from a seed with numpy, go through both.

MLA's decompressed prefill (``"ref"`` and ``"chunked"``), its cache and
its absorbed decode; the router (expert ids exact), the capacity, the
sort dispatch (slot tokens and validity exact) and the combine, with and
without dropped assignments; the whole model's forward, prefill and
decode.

Tolerances, as the dense parity tests (``tests/test_torch_efm.py``):
1e-5 with ``cache_dtype="float32"`` (float32 end to end, the packages
differ in summation order), 2e-2 with the default bf16 cache (the
reference's own bound for it, ``tests/test_arch_smoke.py``); integers
and booleans exact.
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
from repro.models import mla as JMLA
from repro.models import moe as JMOE
from repro.serve import efm as jefm
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TMOE
from repro_torch.models.transformer import layer_params
from repro_torch.serve import efm as tefm

ARCHS = ("deepseek-v2-lite-16b", "deepseek-v3-671b")
B, PROMPT, NEW = 2, 24, 4
F32_TOL = 1e-5
BF16_CACHE_TOL = 2e-2


def _cfgs(arch, **kw):
    return (jax_smoke_config(arch).replace(**kw),
            get_smoke_config(arch).replace(**kw))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX params, the same params in the port), perturbed."""
    arch = request.param
    params = perturb_constant_leaves(
        jax_build_model(jax_smoke_config(arch)).init(jax.random.PRNGKey(0)))
    return (arch, jax.tree.map(jnp.asarray, params),
            convert.moe_mla_from_jax(params, get_smoke_config(arch),
                                     device="cpu"))


def _layer(tree, key, i=0):
    """Layer ``i`` of the stack ``key`` in both packages' trees."""
    jt, tt = tree
    return (jax.tree.map(lambda a: a[i], jt[key]),
            layer_params(tt[key], i))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(cfg, n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ref", "chunked"])
def test_mla_full_matches_jax(pair, backend):
    arch, jp, tp = pair
    jcfg, tcfg = _cfgs(arch, attn_backend=backend)
    for key in ("dense_layers", "moe_layers"):
        ja, ta = _layer((jp, tp), key)
        x = _x((B, 20, jcfg.d_model), 3)
        j = JMLA.mla_full(ja["attn"], jnp.asarray(x), jcfg)
        t = TMLA.mla_full(ta["attn"], to_torch(x), tcfg)
        assert_leaves_match([j], [t], atol=F32_TOL, what=f"{key} {backend}")


@pytest.mark.parametrize("sq,chunk", [(40, 16), (48, 24)])
def test_attention_chunked_with_a_narrower_v_matches_jax(sq, chunk):
    """MLA's chunked form: qk head dim nope + rope, a narrower v (as 192
    and 128 at full width), over several query and key chunks."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    q, k = _x((1, 2, sq, 24), sq), _x((1, 2, sq, 24), sq + 1)
    v = _x((1, 2, sq, 16), sq + 2)
    j = JL.attention_chunked(*map(jnp.asarray, (q, k, v)), causal=True,
                             q_chunk=chunk, k_chunk=chunk)
    t = TL.attention_chunked(*map(to_torch, (q, k, v)), causal=True,
                             q_chunk=chunk, k_chunk=chunk)
    assert t.shape == (1, 2, sq, 16)
    np.testing.assert_allclose(np.asarray(j), to_numpy(t), atol=F32_TOL)


@pytest.mark.parametrize("cache_dtype,tol", [("float32", F32_TOL),
                                             ("bfloat16", BF16_CACHE_TOL)])
def test_mla_prefill_cache_and_absorbed_decode_match_jax(pair, cache_dtype,
                                                         tol):
    arch, jp, tp = pair
    jcfg, tcfg = _cfgs(arch, cache_dtype=cache_dtype)
    ja, ta = _layer((jp, tp), "moe_layers", 1)
    x = _x((B, 16 + NEW, jcfg.d_model), 5)
    jc = JMLA.mla_prefill_cache(ja["attn"], jnp.asarray(x[:, :16]), jcfg)
    tc = TMLA.mla_prefill_cache(ta["attn"], to_torch(x[:, :16]), tcfg)
    for k in ("c_kv", "k_rope"):
        assert tc[k].dtype == tcfg.cachedt
        assert_leaves_match([jc[k].astype(jnp.float32)], [tc[k].float()],
                            atol=tol, what=k)
    jc = jax.tree.map(lambda a: jnp.pad(a, ((0, 0), (0, NEW), (0, 0))), jc)
    tc = {k: to_torch(np.asarray(v.astype(jnp.float32))).to(tcfg.cachedt)
          for k, v in jc.items()}
    for i in range(NEW):
        pos = 16 + i
        xt = x[:, pos:pos + 1]
        jo, jc = JMLA.mla_decode(ja["attn"], jnp.asarray(xt), jc,
                                 jnp.int32(pos), jcfg)
        to, tc = TMLA.mla_decode(ta["attn"], to_torch(xt), tc, pos, tcfg)
        assert_leaves_match([jo], [to], atol=tol, what=f"decode {i}")
    assert_leaves_match([jc["c_kv"].astype(jnp.float32)],
                        [tc["c_kv"].float()], atol=tol, what="cache")


def test_absorbed_decode_equals_the_decompressed_form(pair):
    """The port's own MLA property: one absorbed decode step at position
    t after a cache of t tokens gives ``mla_full``'s output at t."""
    arch, _, tp = pair
    _, tcfg = _cfgs(arch, cache_dtype="float32")
    ta = layer_params(tp["dense_layers"], 0)["attn"]
    x = to_torch(_x((B, 12, tcfg.d_model), 6))
    full = TMLA.mla_full(ta, x, tcfg)
    cache = TMLA.mla_prefill_cache(ta, x[:, :11], tcfg)
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 1))
             for k, v in cache.items()}
    out, _ = TMLA.mla_decode(ta, x[:, 11:], cache, 11, tcfg)
    np.testing.assert_allclose(to_numpy(out[:, 0]), to_numpy(full[:, 11]),
                               atol=F32_TOL)


@pytest.mark.parametrize("pos", [16, -1])
def test_mla_decode_outside_the_cache_raises(pair, pos):
    arch, _, tp = pair
    _, tcfg = _cfgs(arch)
    ta = layer_params(tp["moe_layers"], 0)["attn"]
    cache = {k: v[0] for k, v in TMLA.init_mla_cache(tcfg, 1, B, 16).items()}
    before = {k: v.clone() for k, v in cache.items()}
    with pytest.raises(IndexError, match="outside the cache"):
        TMLA.mla_decode(ta, to_torch(_x((B, 1, tcfg.d_model), 7)), cache,
                        pos, tcfg)
    assert all(torch.equal(before[k], cache[k]) for k in cache)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def test_route_matches_jax(pair):
    arch, jp, tp = pair
    jcfg, tcfg = _cfgs(arch)
    ja, ta = _layer((jp, tp), "moe_layers")
    x2 = _x((64, jcfg.d_model), 8)
    jg, je, jaux = JMOE._route(ja["moe"], jnp.asarray(x2), jcfg)
    tg, te, taux = TMOE._route(ta["moe"], to_torch(x2), tcfg)
    assert_leaves_match([je, jg, jaux],
                        [te, tg, taux], atol=F32_TOL, what="route")


def test_route_puts_the_lower_expert_first_on_ties():
    """``lax.top_k`` order: among equal probabilities the lower index
    first (rows of identical router columns tie exactly)."""
    jcfg, tcfg = _cfgs("deepseek-v2-lite-16b")
    rng = np.random.default_rng(9)
    router = np.repeat(rng.standard_normal((jcfg.d_model, 4)), 2,
                       axis=1).astype(np.float32)  # experts 2i, 2i+1 tie
    x2 = _x((32, jcfg.d_model), 10)
    _, je, _ = JMOE._route({"router": jnp.asarray(router)}, jnp.asarray(x2),
                           jcfg)
    _, te, _ = TMOE._route({"router": to_torch(router)}, to_torch(x2), tcfg)
    np.testing.assert_array_equal(np.asarray(je), to_numpy(te))
    assert (to_numpy(te[:, 1]) == to_numpy(te[:, 0]) + 1).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_tokens", [1, 4, 48, 64, 100, 4096])
@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_moe_capacity_matches_jax(arch, n_tokens, cf):
    jcfg, tcfg = _cfgs(arch, moe_capacity_factor=cf)
    assert TMOE.moe_capacity(tcfg, n_tokens) == JMOE.moe_capacity(
        jcfg, n_tokens)


def test_capacity_at_the_full_width_prefill():
    """DeepSeek-V2-Lite at 4 prompts of 1024 tokens: 480 slots an expert
    (4096 x 6 / 64 x 1.25), a multiple of 8."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    assert TMOE.moe_capacity(get_config("deepseek-v2-lite-16b"), 4096) == \
        JMOE.moe_capacity(jax_get_config("deepseek-v2-lite-16b"), 4096) == 480


@pytest.mark.parametrize("cf,drops", [(1.0, True), (8.0, False)])
def test_dispatch_and_combine_match_jax(pair, cf, drops):
    """The sort dispatch, with capacity factor 1.0 (assignments past the
    capacity are dropped, the same ones in both) and 8.0 (none)."""
    arch, jp, tp = pair
    jcfg, tcfg = _cfgs(arch, moe_capacity_factor=cf)
    ja, ta = _layer((jp, tp), "moe_layers")
    t = 96
    x2 = _x((t, jcfg.d_model), 11)
    c = JMOE.moe_capacity(jcfg, t)
    jg, je, _ = JMOE._route(ja["moe"], jnp.asarray(x2), jcfg)
    tg, te, _ = TMOE._route(ta["moe"], to_torch(x2), tcfg)
    jxg, jinfo = JMOE._dispatch(jnp.asarray(x2), jg, je, jcfg.moe_experts, c)
    txg, tinfo = TMOE._dispatch(to_torch(x2), tg, te, tcfg.moe_experts, c)
    n_kept = int(to_numpy(tinfo[2]).sum())
    assert (n_kept < t * jcfg.moe_top_k) == drops, n_kept
    assert_leaves_match([jinfo[0], jinfo[2], jinfo[1], jxg],
                        [tinfo[0], tinfo[2], tinfo[1], txg], atol=F32_TOL,
                        what="dispatch")
    y = _x(tuple(jxg.shape), 12)
    jout = JMOE._combine(jnp.asarray(y), jinfo, t, jnp.float32)
    tout = TMOE._combine(to_torch(y), tinfo, t, torch.float32)
    assert_leaves_match([jout], [tout], atol=F32_TOL, what="combine")


@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("impl", ["sort", "ep"])
def test_moe_ffn_matches_jax(pair, cf, impl):
    """``moe_ffn`` with and without drops; ``moe_impl="ep"`` takes the
    sort path on both sides (no mesh)."""
    arch, jp, tp = pair
    jcfg, tcfg = _cfgs(arch, moe_capacity_factor=cf, moe_impl=impl)
    ja, ta = _layer((jp, tp), "moe_layers", 1)
    x = _x((B, 40, jcfg.d_model), 13)
    jo, jaux = JMOE.moe_ffn(ja["moe"], jnp.asarray(x), jcfg)
    to, taux = TMOE.moe_ffn(ta["moe"], to_torch(x), tcfg)
    assert_leaves_match([jo, jaux], [to, taux], atol=F32_TOL, what="moe")
    so, saux = TMOE.moe_ffn_sort(ta["moe"], to_torch(x), tcfg)
    assert torch.equal(so, to) and torch.equal(saux, taux)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def _pad_cache(cache, n):
    """``n`` more positions of the compressed caches (the caller's job)."""
    return jax.tree.map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, n), (0, 0))), cache)


def _to_port(cache, dtype):
    return {name: {k: to_torch(np.asarray(v, np.float32)).to(dtype)
                   for k, v in stack.items()}
            for name, stack in cache.items()}


@pytest.mark.parametrize("cache_dtype,tol", [("float32", F32_TOL),
                                             ("bfloat16", BF16_CACHE_TOL)])
def test_forward_prefill_and_decode_match_jax(pair, cache_dtype, tol):
    arch, jparams, tparams = pair
    jcfg, tcfg = _cfgs(arch, cache_dtype=cache_dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    toks = _tokens(jcfg, PROMPT + NEW)

    full_j = jax.jit(jm.forward)(jparams, {"tokens": jnp.asarray(toks)})
    full_t = tm.forward(tparams, {"tokens": to_torch(toks)})
    assert_leaves_match([full_j], [full_t], atol=F32_TOL, what="forward")

    lj, cj = jax.jit(jm.prefill)(jparams,
                                 {"tokens": jnp.asarray(toks[:, :PROMPT])})
    lt, ct = tm.prefill(tparams, {"tokens": to_torch(toks[:, :PROMPT])})
    assert set(ct) == set(cj) == {"dense", "moe"}
    assert_leaves_match([lj], [lt], atol=F32_TOL, what="prefill logits")
    for name in cj:
        for k in ("c_kv", "k_rope"):
            assert ct[name][k].dtype == tcfg.cachedt
            assert_leaves_match([cj[name][k].astype(jnp.float32)],
                                [ct[name][k].float()], atol=tol,
                                what=f"prefill cache {name}/{k}")

    ct = tefm.pad_for_decode(tm, _to_port(cj, tcfg.cachedt), NEW)
    cj = _pad_cache(cj, NEW)
    step = jax.jit(jm.decode_step)
    for i in range(NEW):
        pos = PROMPT + i
        ldj, cj = step(jparams, cj, jnp.asarray(toks[:, pos:pos + 1]),
                       jnp.int32(pos))
        ldt, ct = tm.decode_step(tparams, ct, to_torch(toks[:, pos:pos + 1]),
                                 pos)
        assert_leaves_match([ldj], [ldt], atol=tol, what=f"decode {i}")
    assert_leaves_match([cj["moe"]["c_kv"].astype(jnp.float32)],
                        [ct["moe"]["c_kv"].float()], atol=tol,
                        what="decoded cache")


def test_greedy_tokens_equal_jax(pair):
    arch, jparams, tparams = pair
    jcfg, tcfg = _cfgs(arch, cache_dtype="float32")
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    toks = _tokens(jcfg, PROMPT, seed=2)
    lj, cj = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    first = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    ct = tefm.pad_for_decode(tm, _to_port(cj, torch.float32), NEW)
    cj = _pad_cache(cj, NEW)
    out_j, _ = jefm.greedy_decode_loop(jm, jparams, cj, first, PROMPT, NEW)
    lt, _ = tefm.jit_prefill(tm)(tparams, {"tokens": to_torch(toks)})
    first_t = torch.argmax(lt[:, -1:], dim=-1).to(torch.int32)
    out_t, _ = tefm.greedy_decode_loop(tm, tparams, ct, first_t, PROMPT, NEW)
    np.testing.assert_array_equal(np.asarray(out_j), to_numpy(out_t))


def test_decode_matches_forward(pair):
    """The port's own property (``tests/test_arch_smoke.py``): prefill of
    S - 1 tokens, then one absorbed decode step, against the forward's
    logits at S - 2 and S - 1 (capacity factor 8: nothing dropped)."""
    arch, _, tparams = pair
    _, tcfg = _cfgs(arch, cache_dtype="float32")
    tm = build_model(tcfg, device="cpu")
    toks = to_torch(_tokens(tcfg, PROMPT, seed=3))
    full = tm.forward(tparams, {"tokens": toks})
    lp, cache = tm.prefill(tparams, {"tokens": toks[:, :-1]})
    np.testing.assert_allclose(to_numpy(lp[:, -1]),
                               to_numpy(full[:, PROMPT - 2]), atol=F32_TOL)
    cache = tefm.pad_for_decode(tm, cache, 1)
    ld, _ = tm.decode_step(tparams, cache, toks[:, -1:], PROMPT - 1)
    np.testing.assert_allclose(to_numpy(ld[:, -1]),
                               to_numpy(full[:, PROMPT - 1]), atol=F32_TOL)


def test_init_serve_is_the_reference_cache(pair):
    arch, _, _ = pair
    jcfg, tcfg = _cfgs(arch)
    spec = jax.eval_shape(lambda: jax_build_model(jcfg).init_serve(B, 32))
    got = build_model(tcfg, device="cpu").init_serve(B, 32)
    for name in spec:
        for k, s in spec[name].items():
            assert tuple(got[name][k].shape) == s.shape
            assert got[name][k].dtype == tcfg.cachedt
            assert not got[name][k].any()


def test_moe_mla_from_jax_rejects_a_wrong_tree(pair):
    arch, jparams, _ = pair
    _, tcfg = _cfgs(arch)
    np_params = jax.tree.map(np.asarray, jparams)
    bad = dict(np_params)
    bad.pop("moe_layers")
    with pytest.raises(ValueError, match="keys"):
        convert.moe_mla_from_jax(bad, tcfg, device="cpu")
    wrong = dict(np_params, final_norm={"scale": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        convert.moe_mla_from_jax(wrong, tcfg, device="cpu")


def _index_add_combine(y, info, t, cdt):
    """The scatter-add combine ``_combine`` replaced: ``index_add_`` in slot
    order (on the CPU it adds each row in turn, a bf16 tensor in
    float32)."""
    tok_by_slot, gate_by_slot, valid = info[:3]
    e, c, d = y.shape
    y_flat = y.reshape(e * c, d) * gate_by_slot[:, None].to(cdt)
    y_flat = torch.where(valid[:, None], y_flat, 0.0)
    return torch.zeros((t, d), dtype=cdt).index_add_(
        0, tok_by_slot.long(), y_flat)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_deterministic_combine_is_the_index_add_combine_bitwise(dtype, cf):
    """The fixed-order combine equals the ``index_add_`` scatter it
    replaced, bitwise, with drops (capacity factor 1.0) and without, in
    float32 and bf16."""
    cfg = get_smoke_config("deepseek-v2-lite-16b").replace(
        moe_capacity_factor=cf)
    gen = torch.Generator().manual_seed(3)
    t, e, k = 96, cfg.moe_experts, cfg.moe_top_k
    x2 = torch.randn((t, cfg.d_model), generator=gen)
    router = torch.randn((cfg.d_model, e), generator=gen)
    gates, eids, _ = TMOE._route({"router": router}, x2, cfg)
    c = TMOE.moe_capacity(cfg, t)
    _, info = TMOE._dispatch(x2, gates, eids, e, c)
    assert (int(info[2].sum()) < t * k) == (cf == 1.0)
    y = torch.randn((e, c, cfg.d_model), generator=gen).to(dtype)
    got = TMOE._combine(y, info, t, dtype)
    want = _index_add_combine(y, info, t, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deterministic_combine_on_the_highest_expert_ids(dtype):
    """Tokens routed to the k = 3 highest expert ids (their slots the last
    ones of the buffer), beside tokens on the lowest, with large values:
    bitwise the ``index_add_`` combine (three rows a token, where rounding
    each add in bf16 would differ from ``index_add_``'s float32 sum)."""
    e, k, c, d, t = 8, 3, 4, 16, 5
    eids = torch.tensor([[e - 1, e - 2, e - 3], [0, 1, 2], [e - 3, e - 1,
                         e - 2], [1, 0, 2], [e - 2, e - 3, e - 1]])
    gen = torch.Generator().manual_seed(4)
    gates = torch.softmax(torch.randn((t, k), generator=gen), -1)
    x2 = torch.randn((t, d), generator=gen)
    _, info = TMOE._dispatch(x2, gates, eids, e, c)
    assert sorted(info[3][0].tolist()) == info[3][0].tolist()
    assert info[3][0].min() >= (e - 3) * c  # the last experts' slots
    y = (torch.randn((e, c, d), generator=gen) * 100).to(dtype)
    got = TMOE._combine(y, info, t, dtype)
    assert torch.equal(got, _index_add_combine(y, info, t, dtype))
    assert not torch.equal(got[0], torch.zeros_like(got[0]))
