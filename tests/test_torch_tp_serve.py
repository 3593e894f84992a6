"""Tensor-parallel serving of the dense family on four gloo ranks, against
``mesh=None`` and the JAX package's own GSPMD run.

One spawn of four ranks (``tests/_torch_dist.py``) runs ``jit_prefill``
and ``jit_decode_step`` of the four dense smoke configurations
(TinyLlama-1.1B, OLMo-1B, Qwen2.5-3B, Phi-4-mini; float32, cache in
float32) on the meshes (data 2, model 2) and (data 1, model 4): 4 x 32
seeded prompt tokens, then 4 greedy decode steps (``mesh=None``'s argmax)
against a cache of 36.  The parameters are the reference's ``init``,
carried across by ``convert.dense_from_jax`` and placed by
``param_specs``.  Together the cases reach a cache split over kv heads
(TinyLlama at model 2, OLMo at 2 and 4), a cache split over the sequence
with K/V replicated (TinyLlama, Qwen, Phi at model 4), heads split
mid-head (Phi at model 4: 6 heads of 16 over 96 columns), a tied
vocab-parallel table (OLMo, Qwen, Phi) and an untied ``lm_head``
(TinyLlama), QKV bias (Qwen) and a non-parametric LayerNorm (OLMo).

Held, each case, on every rank:
  * the logits of the prefill and of every decode step within 1e-5
    (``F32_TOL``) of ``mesh=None``'s on the same rank, and within 1e-5
    of the reference's ``jit_prefill``/``jit_decode_step`` on a
    ``jax.sharding.Mesh`` of the same shape over four forced host devices
    (one subprocess, started beside the ranks), whose greedy tokens must
    be the same;
  * the collectives each rank issues (``launch.hloparse.Recorder``) in the
    prefill and in every decode step equal, op for op (name, bytes, group
    size, order), the list :func:`expected_records` works out from the
    configuration and the specs: each one moves an activation, none a
    parameter;
  * ``DTensor.full_tensor`` raises for the length of every step (patched
    on each rank): nothing is gathered whole inside it;
  * the returned cache and decode state are DTensors placed by
    ``serve_specs``, each local block of its spec's shape, their whole
    values within 1e-5 of ``mesh=None``'s.

One more case, TinyLlama at 4 layers on (2, 2), has as many layers as
rows: the serve specs, which find the batch dim by its size, split the
cache's layers over "data" there, while each rank computes on its rows.
Its logits, cache and state are held to ``mesh=None`` and its placements
to the specs.

Also here, in process: which kv heads ``layers._kv_heads`` hands each
rank's query heads, for head counts no smoke configuration has.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from _torch_dist import spawn
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_smoke_config
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.models import build_model, layers

WORLD = 4
F32_TOL = 1e-5
BATCH, PROMPT, NEW = 4, 32, 4
ARCHS = ("tinyllama-1.1b", "olmo-1b", "qwen2.5-3b", "phi4-mini-3.8b")
MESHES = ((2, 2), (1, 4))
CASES = {f"{arch}@{d}x{m}": (arch, (d, m)) for arch in ARCHS
         for d, m in MESHES}
# A layer count equal to the batch: the serve specs, which find the batch
# dim by its size, split the cache's layers over "data", while each rank
# computes on its rows.
LAYERS_AS_BATCH = "tinyllama-1.1b@2x2/4 layers"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SUB_ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
            "OMP_NUM_THREADS": "1"}
for _k in ("JAX_PLATFORMS", "HOME", "TMPDIR"):
    if _k in os.environ:
        _SUB_ENV[_k] = os.environ[_k]


def _jax_params(arch, n_layers=None):
    cfg = jax_smoke_config(arch).replace(cache_dtype="float32")
    cfg = cfg.replace(n_layers=n_layers or cfg.n_layers)
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def payload():
    out = {}
    rng = np.random.default_rng(3)
    for name, (arch, mesh) in CASES.items():
        vocab = get_smoke_config(arch).vocab
        out[name] = {"arch": arch, "mesh": mesh, "new": NEW,
                     "params": _jax_params(arch),
                     "tokens": rng.integers(0, vocab, (BATCH, PROMPT))
                     .astype(np.int32)}
    arch = "tinyllama-1.1b"
    out[LAYERS_AS_BATCH] = {
        "arch": arch, "mesh": (2, 2), "new": NEW, "n_layers": BATCH,
        "params": _jax_params(arch, BATCH),
        "tokens": rng.integers(0, get_smoke_config(arch).vocab,
                               (BATCH, PROMPT)).astype(np.int32)}
    return out


# The reference's steps on a (data, model) mesh of four forced host
# devices: each case's prefill and greedy decode logits.
_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import pickle
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeSpec
    from repro.launch import sharding as S
    from repro.models import build_model
    from repro.serve import efm
    cases = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    for name, case in cases.items():
        cfg = get_smoke_config(case["arch"]).replace(cache_dtype="float32")
        model = build_model(cfg)
        mesh = Mesh(np.array(jax.devices()).reshape(case["mesh"]),
                    ("data", "model"))
        tokens = jnp.asarray(case["tokens"])
        (b, s), n = tokens.shape, case["new"]
        put = lambda x, spec: jax.device_put(x, S.named(mesh, spec))
        with mesh:
            prefill, ps = efm.jit_prefill(model, mesh,
                                          ShapeSpec("p", "prefill", s, b))
            decode, ds = efm.jit_decode_step(
                model, mesh, ShapeSpec("d", "decode", s + n, b))
            params = jax.tree.map(jnp.asarray, case["params"])
            logits, cache = prefill(put(params, ps["params"]),
                                    put({"tokens": tokens}, ps["batch"]))
            got = [np.asarray(logits)]
            state = jax.tree.map(
                lambda t: jnp.pad(t, [(0, 0)] * 3 + [(0, n), (0, 0)]), cache)
            tok, toks = tokens[:, -1:], []
            for i in range(n):
                lg, state = decode(
                    put(params, ds["params"]), put(state, ds["state"]),
                    put(tok, ds["token"]), put(jnp.int32(s + i), P()))
                got.append(np.asarray(lg))
                tok = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
                toks.append(np.asarray(tok))
        out[name] = {"logits": got, "tokens": toks}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


@pytest.fixture(scope="module")
def runs(payload, tmp_path_factory):
    """The ranks' results and the reference's, the reference's subprocess
    running beside the ranks."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    src, dst = tmp / "cases.pkl", tmp / "ref.pkl"
    with open(src, "wb") as f:
        pickle.dump({name: payload[name] for name in CASES}, f)
    ref = subprocess.Popen([sys.executable, "-c", _REF, str(src), str(dst)],
                           stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                           text=True, env=_SUB_ENV, cwd=ROOT)
    try:
        ranks = spawn("tp_serve_suite", WORLD, tmp, payload)
        _, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    with open(dst, "rb") as f:
        return ranks, pickle.load(f)


# ---------------------------------------------------------------------------
# The collectives, worked out from the configuration and the specs
# ---------------------------------------------------------------------------


def expected_records(arch, mesh_shape, kind):
    """The collectives one rank issues in a prefill of BATCH x PROMPT or in
    a decode step against a cache of PROMPT + NEW, in order, as
    ``(op, bytes of its output on the rank, group size)``: float32
    activations throughout."""
    cfg = get_smoke_config(arch).replace(cache_dtype="float32")
    d, m = mesh_shape
    mesh = M.AbstractMesh(mesh_shape, ("data", "model"))
    model = build_model(cfg, device="cpu")
    split = S.model_sharded(S.param_specs(cfg, model.param_spec(), mesh))
    seq = PROMPT if kind == "prefill" else PROMPT + NEW
    cache = S.serve_specs(cfg, model.serve_spec(BATCH, seq), mesh,
                          BATCH)["k"]
    over_seq = kind == "decode" and "model" in S.spec_axes(cache[-2])
    rows = BATCH // d
    tokens = rows * (PROMPT if kind == "prefill" else 1)
    h, dh, width = cfg.n_heads, cfg.head_dim_, cfg.d_model
    whole_heads = "wq" in split and h % m == 0
    f32 = 4
    out = []
    if m > 1:
        if "embed" in split:
            out.append(("all-reduce", tokens * width * f32, m))
        for _ in range(cfg.n_layers):
            if "wq" in split and (over_seq or not whole_heads):
                out.append(("all-gather", tokens * h * dh * f32, m))
            if over_seq:  # the flash-decoding combine: max, then sums
                out.append(("all-reduce", rows * h * f32, m))
                out.append(("all-reduce", rows * h * (dh + 1) * f32, m))
            for owner in ("wo", "down"):
                if owner in split:
                    out.append(("all-reduce", tokens * width * f32, m))
        head = "embed" if cfg.tie_embeddings else "lm_head"
        if head in split:
            out.append(("all-gather", rows * cfg.vocab * f32, m))
    if kind == "decode" and d > 1:  # the logits replicated over the rows
        out.append(("all-gather", BATCH * cfg.vocab * f32, d))
    return out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_logits_equal_mesh_none_on_every_rank(name, runs):
    ranks, _ = runs
    for r in ranks:
        res = r[name]
        assert len(res["errs"]) == 1 + NEW
        assert max(res["errs"]) <= F32_TOL, res["errs"]
        assert res["cache_err"] <= F32_TOL, res["cache_err"]
        assert res["state_err"] <= F32_TOL, res["state_err"]
        tokens = [t.tolist() for t in res["tokens"]]
        assert tokens == [t.tolist() for t in ranks[0][name]["tokens"]]


@pytest.mark.parametrize("name", list(CASES))
def test_logits_equal_the_references_gspmd_run(name, runs):
    ranks, ref = runs
    got, want = ranks[0][name], ref[name]
    assert [t.tolist() for t in got["tokens"]] == [
        t.tolist() for t in want["tokens"]], "the greedy tokens differ"
    for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        assert a.shape == b.shape == (BATCH, 1, get_smoke_config(
            CASES[name][0]).vocab)
        np.testing.assert_allclose(a, b, rtol=0, atol=F32_TOL,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_each_ranks_collectives_are_the_worked_out_list(name, runs):
    arch, mesh = CASES[name]
    want_prefill = expected_records(arch, mesh, "prefill")
    want_decode = expected_records(arch, mesh, "decode")
    assert want_prefill and want_decode
    for r in runs[0]:
        records = r[name]["records"]
        assert records[0] == want_prefill
        for step in records[1:]:
            assert step == want_decode


@pytest.mark.parametrize("name", list(CASES))
def test_caches_come_back_placed_by_the_serve_specs(name, runs):
    for r in runs[0]:
        assert r[name]["cache_placed"] and r[name]["state_placed"]


def test_cache_of_as_many_layers_as_rows(runs):
    """Four layers at a batch of four on (2, 2): each rank computes on its
    rows, and the cache and state still come back placed by the serve
    specs (layers over "data"), their whole values ``mesh=None``'s."""
    cfg = get_smoke_config("tinyllama-1.1b").replace(n_layers=BATCH)
    mesh = M.AbstractMesh((2, 2), ("data", "model"))
    model = build_model(cfg, device="cpu")
    spec = S.serve_specs(cfg, model.serve_spec(BATCH, PROMPT), mesh,
                         BATCH)["k"]
    assert S.spec_axes(spec[0]) == ("data",) and spec[1] is None
    for r in runs[0]:
        res = r[LAYERS_AS_BATCH]
        assert max(res["errs"]) <= F32_TOL, res["errs"]
        assert res["cache_err"] <= F32_TOL, res["cache_err"]
        assert res["state_err"] <= F32_TOL, res["state_err"]
        assert res["cache_placed"] and res["state_placed"]


def test_the_cases_reach_every_layout():
    """What the module's docstring says the cases cover."""
    seen = set()
    for arch, (d, m) in CASES.values():
        cfg = get_smoke_config(arch)
        mesh = M.AbstractMesh((d, m), ("data", "model"))
        model = build_model(cfg, device="cpu")
        split = S.model_sharded(S.param_specs(cfg, model.param_spec(), mesh))
        cache = S.serve_specs(cfg, model.serve_spec(BATCH, PROMPT + NEW),
                              mesh, BATCH)["k"]
        seen.add("kv heads" if "model" in S.spec_axes(cache[2]) else
                 "sequence" if "model" in S.spec_axes(cache[3]) else "whole")
        if cfg.n_heads % m:
            seen.add("mid-head")
        seen.add("tied" if cfg.tie_embeddings else "lm_head")
        if not {"wk", "wv"} & split:
            seen.add("kv replicated")
    assert seen == {"kv heads", "sequence", "mid-head", "tied", "lm_head",
                    "kv replicated"}


@pytest.mark.parametrize("n_heads,n_kv_heads,size", [
    (8, 2, 4), (8, 2, 2), (24, 6, 8), (12, 4, 3), (12, 3, 6), (16, 2, 16),
])
def test_kv_heads_serve_each_ranks_query_heads(n_heads, n_kv_heads, size):
    """Query head h reads kv head h // group, however the query heads fall
    on the ranks (``_kv_heads`` on replicated K/V)."""
    group = n_heads // n_kv_heads
    k = torch.arange(n_kv_heads, dtype=torch.float32).reshape(
        1, n_kv_heads, 1, 1).expand(1, n_kv_heads, 3, 2)
    for rank in range(size):
        tp = SimpleNamespace(size=size, rank=rank, sharded=frozenset(),
                             group=None)
        hq = n_heads // size
        h0 = rank * hq
        kk, vv = layers._kv_heads(tp, k, k, h0, hq, n_heads, n_kv_heads)
        assert hq % kk.shape[1] == 0
        got = layers._repeat_kv(kk, hq // kk.shape[1])[:, :, 0, 0]
        want = torch.tensor([(h0 + i) // group for i in range(hq)],
                            dtype=torch.float32)
        assert torch.equal(got[0], want), (rank, got)
