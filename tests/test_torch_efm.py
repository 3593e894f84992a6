"""The EFM answer path (dense family) in the PyTorch port against the JAX
package.

For each dense architecture's ``SMOKE_CONFIG`` with
``attn_backend="pallas"`` (the JAX side runs its Pallas kernel in
interpret mode, the port its kernel's plain version), the JAX parameters
go through ``convert.dense_from_jax`` into the port and the same token
ids, made from a seed, go through both.

Tolerances:
  * 1e-5 with ``cache_dtype="float32"``: the models are float32 end to
    end, and the two frameworks differ only in summation order (a few
    ulps of values of order 1).  Greedy tokens must be equal.
  * 2e-2 with the default bf16 cache, the reference's own bound for it
    (``tests/test_arch_smoke.py``): a 1-ulp float32 difference can flip
    a bf16 rounding of a cached value (about 4e-3 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_leaves_match, to_numpy, to_torch
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.serve import efm as jefm
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.serve import efm as tefm

B, PROMPT, NEW = 2, 24, 8
# The dense architectures (test_torch_{moe_mla,rwkv6,hybrid,vlm,encdec}.py
# hold the other families).
DENSE_IDS = tuple(a for a in ARCH_IDS if get_config(a).family == "dense")
F32_TOL = 1e-5
BF16_CACHE_TOL = 2e-2


def _cfgs(arch, **kw):
    kw.setdefault("attn_backend", "pallas")
    return (jax_smoke_config(arch).replace(**kw),
            get_smoke_config(arch).replace(**kw))


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (B, PROMPT + NEW)).astype(np.int32)


@pytest.fixture(scope="module", params=DENSE_IDS)
def pair(request):
    """(arch, JAX params, the same params in the port) for one arch."""
    jcfg, tcfg = _cfgs(request.param)
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    return request.param, params, convert.dense_from_jax(np_params, tcfg,
                                                          device="cpu")


def _pad_cache(cache, n):
    """Pad the prefill cache out to ``prompt + n`` positions (the callers'
    job, as in tests/test_arch_smoke.py)."""
    def pad(a):
        widths = [(0, 0)] * a.ndim
        widths[-2] = (0, n)
        return jnp.pad(a, widths)
    return jax.tree.map(pad, cache)


def _to_port_cache(cache):
    return {k: to_torch(np.asarray(v, np.float32)).to(
        torch.float32 if v.dtype == jnp.float32 else torch.bfloat16)
        for k, v in cache.items()}


@pytest.mark.parametrize("cache_dtype,tol", [("float32", F32_TOL),
                                             ("bfloat16", BF16_CACHE_TOL)])
def test_forward_prefill_and_decode_match_jax(pair, cache_dtype, tol):
    arch, jparams, tparams = pair
    jcfg, tcfg = _cfgs(arch, cache_dtype=cache_dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    toks = _tokens(jcfg)

    full_j = jax.jit(jm.forward)(jparams, {"tokens": jnp.asarray(toks)})
    full_t = tm.forward(tparams, {"tokens": to_torch(toks)})
    assert_leaves_match([full_j], [full_t], atol=F32_TOL, what="forward")

    prompt = {"tokens": jnp.asarray(toks[:, :PROMPT])}
    lj, cj = jax.jit(jm.prefill)(jparams, prompt)
    lt, ct = tm.prefill(tparams, {"tokens": to_torch(toks[:, :PROMPT])})
    assert ct["k"].dtype == tcfg.cachedt
    assert_leaves_match([lj], [lt], atol=F32_TOL, what="prefill logits")
    assert_leaves_match([cj["k"].astype(jnp.float32),
                         cj["v"].astype(jnp.float32)],
                        [ct["k"].float(), ct["v"].float()], atol=tol,
                        what="prefill cache")

    # Teacher-forced decode: every step's logits and the final cache.
    cj = _pad_cache(cj, NEW)
    ct = _to_port_cache(cj)
    step = jax.jit(jm.decode_step)
    for i in range(NEW):
        pos = PROMPT + i
        ldj, cj = step(jparams, cj, jnp.asarray(toks[:, pos:pos + 1]),
                       jnp.int32(pos))
        ldt, ct = tm.decode_step(tparams, ct, to_torch(toks[:, pos:pos + 1]),
                                 pos)
        assert_leaves_match([ldj], [ldt], atol=tol, what=f"decode {i}")
    assert_leaves_match([cj["k"].astype(jnp.float32)], [ct["k"].float()],
                        atol=tol, what="decoded cache")


def test_greedy_tokens_equal_jax(pair):
    arch, jparams, tparams = pair
    jcfg, tcfg = _cfgs(arch, cache_dtype="float32")
    jm, tm = jax_build_model(jcfg), build_model(tcfg, device="cpu")
    toks = _tokens(jcfg, seed=2)[:, :PROMPT]
    lj, cj = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(toks)})
    first = jnp.argmax(lj[:, -1:], axis=-1).astype(jnp.int32)
    cj = _pad_cache(cj, NEW)
    ct = _to_port_cache(cj)
    out_j, _ = jefm.greedy_decode_loop(jm, jparams, cj, first, PROMPT, NEW)
    prefill = tefm.jit_prefill(tm)
    lt, _ = prefill(tparams, {"tokens": to_torch(toks)})
    first_t = torch.argmax(lt[:, -1:], dim=-1).to(torch.int32)
    out_t, _ = tefm.greedy_decode_loop(tm, tparams, ct, first_t, PROMPT, NEW)
    np.testing.assert_array_equal(np.asarray(out_j), to_numpy(out_t))


def test_jit_decode_step_is_the_model_step(pair):
    arch, _, tparams = pair
    _, tcfg = _cfgs(arch, cache_dtype="float32")
    tm = build_model(tcfg, device="cpu")
    toks = to_torch(_tokens(tcfg))
    cache = tm.init_serve(B, PROMPT + NEW)
    a, _ = tefm.jit_decode_step(tm)(tparams, cache, toks[:, :1], 0)
    cache = tm.init_serve(B, PROMPT + NEW)
    b, _ = tm.decode_step(tparams, cache, toks[:, :1], 0)
    assert torch.equal(a, b) and not a.requires_grad


@pytest.mark.parametrize("arch", DENSE_IDS)
def test_init_matches_the_reference_tree_and_scales(arch):
    jcfg, tcfg = _cfgs(arch)
    spec = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    params = build_model(tcfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    j_leaves = jax.tree_util.tree_leaves_with_path(spec)
    t_leaves = jax.tree_util.tree_leaves_with_path(params)
    assert [jax.tree_util.keystr(p) for p, _ in j_leaves] == [
        jax.tree_util.keystr(p) for p, _ in t_leaves]
    for (_, j), (_, t) in zip(j_leaves, t_leaves):
        assert tuple(j.shape) == tuple(t.shape)
        assert t.dtype == tcfg.pdt
    wq = params["layers"]["attn"]["wq"]["w"]
    assert abs(float(wq.std()) * tcfg.d_model ** 0.5 - 1.0) < 0.1
    assert abs(float(params["embed"]["table"].std()) / 0.02 - 1.0) < 0.1


def test_full_configs_match_the_reference():
    from repro.configs import get_config as jax_get_config

    for arch in ARCH_IDS:
        j, t = jax_get_config(arch), get_config(arch)
        assert j.__dict__ == t.__dict__, arch
        assert str(t.pdt) == "torch." + str(jnp.dtype(j.pdt))


def test_arch_ids_are_the_references():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS

    assert ARCH_IDS == JAX_ARCH_IDS


def _reference_arch_ids():
    from repro.configs import ARCH_IDS as JAX_ARCH_IDS

    return JAX_ARCH_IDS


@pytest.mark.parametrize("arch", _reference_arch_ids())
def test_every_reference_config_is_the_ports(arch):
    """``CONFIG``, ``SMOKE_CONFIG`` and ``SHAPES`` equal the reference's
    field for field."""
    from repro.configs import get_config as jax_get_config
    from repro.configs import get_shapes as jax_get_shapes
    from repro_torch.configs import get_shapes

    assert jax_get_config(arch).__dict__ == get_config(arch).__dict__
    assert jax_smoke_config(arch).__dict__ == get_smoke_config(arch).__dict__
    assert [s.__dict__ for s in jax_get_shapes(arch)] == [
        s.__dict__ for s in get_shapes(arch)]


@pytest.mark.parametrize("arch", _reference_arch_ids())
def test_every_reference_arch_builds_on_the_cpu(arch):
    """``build_model`` of the smoke config on the CPU: the parameter tree
    has the reference's paths, shapes and dtype, and a forward gives
    finite (B, S, V) logits."""
    cfg = get_smoke_config(arch)
    spec = jax.eval_shape(jax_build_model(jax_smoke_config(arch)).init,
                          jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    j_leaves = jax.tree_util.tree_leaves_with_path(spec)
    t_leaves = jax.tree_util.tree_leaves_with_path(params)
    assert [jax.tree_util.keystr(p) for p, _ in j_leaves] == [
        jax.tree_util.keystr(p) for p, _ in t_leaves]
    for (path, j), (_, t) in zip(j_leaves, t_leaves):
        assert tuple(j.shape) == tuple(t.shape), jax.tree_util.keystr(path)
        assert str(t.dtype) == "torch." + str(j.dtype), path
    rng = np.random.default_rng(0)
    batch = {"tokens": to_torch(rng.integers(0, cfg.vocab, (B, 16)))}
    if cfg.family == "vlm":
        batch["img_embed"] = torch.randn(B, 10, cfg.d_model)
    if cfg.family == "encdec":
        batch["src_embed"] = torch.randn(B, 16, cfg.d_model)
    logits = model.forward(params, batch)
    assert logits.shape == (B, 16, cfg.vocab) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = get_smoke_config("tinyllama-1.1b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.dense_from_jax({}, cfg)


def test_a_mesh_raises():
    """A step on a mesh is built for one shape: without ``shape_spec`` it
    raises (the sharded steps themselves: ``test_torch_distributed.py``)."""
    from repro_torch.launch.mesh import AbstractMesh

    tm = build_model(get_smoke_config("olmo-1b"), device="cpu")
    for fn in (tefm.jit_prefill, tefm.jit_decode_step):
        with pytest.raises(ValueError, match="shape_spec"):
            fn(tm, mesh=AbstractMesh((1, 1), ("data", "model")))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pad_for_decode_makes_room_after_the_prompt(arch):
    """``pad_for_decode`` on each family's prefill state leaves the state
    as it was and grows only its self-attention caches; one decode step
    into the room it made gives the forward's logits at that position
    (position 0 for the encoder-decoder, whose self-cache it keeps)."""
    cfg = get_smoke_config(arch).replace(cache_dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (B, 16), generator=gen)
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["img_embed"] = torch.randn(B, 10, cfg.d_model, generator=gen)
    if cfg.family == "encdec":
        batch["src_embed"] = torch.randn(B, 16, cfg.d_model, generator=gen)
    full = model.forward(params, batch)
    logits, state = model.prefill(params, dict(batch, tokens=tokens[:, :-1]))
    flat = dict(jax.tree_util.tree_leaves_with_path(state))
    before = {k: v.clone() for k, v in flat.items()}
    padded = dict(jax.tree_util.tree_leaves_with_path(
        tefm.pad_for_decode(model, state, 1)))
    assert padded.keys() == flat.keys()
    grown = {jax.tree_util.keystr(k) for k, v in padded.items()
             if v.shape != flat[k].shape}
    assert grown == {
        "dense": {"['k']", "['v']"}, "vlm": {"['k']", "['v']"},
        "hybrid": {"['k']", "['v']", "['slot_pos']"},
        "moe_mla": {f"['{n}']['{k}']" for n in state
                    for k in ("c_kv", "k_rope")},
    }.get(cfg.family, set())
    for k, v in padded.items():
        assert torch.equal(flat[k], before[k])
        assert torch.equal(v[tuple(slice(0, n) for n in flat[k].shape)],
                           flat[k])
    pos = 0 if logits is None else tokens.shape[1] - 1
    ld, _ = model.decode_step(params, tefm.pad_for_decode(model, state, 1),
                              tokens[:, pos:pos + 1], pos)
    np.testing.assert_allclose(to_numpy(ld[:, -1]), to_numpy(full[:, pos]),
                               atol=F32_TOL)


@pytest.mark.parametrize("pos", [PROMPT, -1, PROMPT + 5])
def test_writing_past_the_cache_raises(pos):
    """The reference's dynamic_update_slice would clamp and write at the
    wrong place; the port refuses."""
    cfg = get_smoke_config("tinyllama-1.1b")
    tm = build_model(cfg, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    cache = tm.init_serve(B, PROMPT)
    before = {k: v.clone() for k, v in cache.items()}
    with pytest.raises(IndexError, match="outside the cache"):
        tm.decode_step(params, cache, torch.zeros(B, 1, dtype=torch.int32),
                       pos)
    assert all(torch.equal(before[k], cache[k]) for k in cache)


def test_dense_from_jax_rejects_a_wrong_tree(pair):
    arch, jparams, _ = pair
    _, tcfg = _cfgs(arch)
    np_params = jax.tree.map(np.asarray, jparams)
    bad = dict(np_params, extra={"w": np.zeros(3)})
    with pytest.raises(ValueError, match="keys"):
        convert.dense_from_jax(bad, tcfg, device="cpu")
    wrong = jax.tree.map(lambda a: a, np_params)
    wrong["final_norm"] = {"scale": np.zeros(3, np.float32)} if (
        tcfg.norm != "layernorm_nonparam") else {"x": np.zeros(3)}
    with pytest.raises(ValueError):
        convert.dense_from_jax(wrong, tcfg, device="cpu")


# ---------------------------------------------------------------------------
# Layers the dense configs do not all reach.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,causal,chunk", [
    (48, True, 16), (40, True, 16), (40, False, 16), (48, False, 24),
])
def test_attention_chunked_matches_jax(sq, causal, chunk):
    rng = np.random.default_rng(sq + chunk)
    q, k, v = [rng.standard_normal((1, 2, sq, 16)).astype(np.float32)
               for _ in range(3)]
    j = JL.attention_chunked(*map(jnp.asarray, (q, k, v)), causal=causal,
                             q_chunk=chunk, k_chunk=chunk)
    t = TL.attention_chunked(*map(to_torch, (q, k, v)), causal=causal,
                             q_chunk=chunk, k_chunk=chunk)
    np.testing.assert_allclose(np.asarray(j), to_numpy(t), atol=F32_TOL)


@pytest.mark.parametrize("backend,causal", [("ref", True), ("ref", False),
                                            ("chunked", True),
                                            ("pallas", False)])
def test_attention_full_backends_match_jax(backend, causal):
    rng = np.random.default_rng(5)
    jp = JL.init_attention(jax.random.PRNGKey(3), 32, 4, 2, 8, qkv_bias=True)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a)), jp)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    j = JL.attention_full(jp, jnp.asarray(x), 4, 2, backend=backend,
                          causal=causal)
    t = TL.attention_full(tp, to_torch(x), 4, 2, backend=backend,
                          causal=causal)
    np.testing.assert_allclose(np.asarray(j), to_numpy(t), atol=F32_TOL)


def test_prefill_cache_matches_jax_attention_prefill_cache():
    """The cache ``attention_full`` returns beside its output is the one
    the reference's ``attention_prefill_cache`` builds from the same
    input, in both cache dtypes."""
    rng = np.random.default_rng(6)
    jp = JL.init_attention(jax.random.PRNGKey(4), 32, 4, 2, 8, qkv_bias=True)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a)), jp)
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        j = JL.attention_prefill_cache(jp, jnp.asarray(x), 4, 2,
                                       cache_dtype=jdt)
        _, t = TL.attention_full(tp, to_torch(x), 4, 2, backend="pallas",
                                 cache_dtype=tdt)
        for name in ("k", "v"):
            assert t[name].dtype == tdt
            np.testing.assert_allclose(
                np.asarray(j[name], np.float32), to_numpy(t[name].float()),
                atol=F32_TOL if tdt == torch.float32 else BF16_CACHE_TOL)


def test_gelu_mlp_and_parametric_layernorm_match_jax():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    jp = JL.init_mlp(jax.random.PRNGKey(1), 24, 40, kind="gelu")
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a)), jp)
    np.testing.assert_allclose(
        np.asarray(JL.mlp(jp, jnp.asarray(x))),
        to_numpy(TL.mlp(tp, to_torch(x))), atol=F32_TOL)
    ln = {"scale": rng.standard_normal(24).astype(np.float32),
          "bias": rng.standard_normal(24).astype(np.float32)}
    np.testing.assert_allclose(
        np.asarray(JL.layernorm(jax.tree.map(jnp.asarray, ln),
                                jnp.asarray(x))),
        to_numpy(TL.layernorm(jax.tree.map(to_torch, ln), to_torch(x))),
        atol=F32_TOL)


def test_rope_matches_jax_in_bf16():
    """cos/sin are cast to x's dtype before the products, so the bf16
    rotation rounds each product in bf16 on both sides and they agree
    exactly on these inputs (casting after the products instead moves
    about 40% of the values by up to 1.6e-2)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 2, 64, 16)).astype(np.float32)
    pos = np.arange(1000, 1064)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(np.asarray(jc), to_numpy(tc), atol=F32_TOL)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    j = JL.apply_rope(xb, jc, js)
    t = TL.apply_rope(to_torch(x).bfloat16(), tc, ts)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(j, np.float32),
                                  to_numpy(t.float()))
