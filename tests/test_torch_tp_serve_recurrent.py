"""Tensor-parallel serving of RWKV6 and the Zamba2 hybrid on four gloo
ranks, against ``mesh=None`` and the JAX package's own GSPMD run.

One spawn of four ranks (``tests/_torch_dist.py``) runs ``jit_prefill``
and ``jit_decode_step`` of the RWKV6-3B and Zamba2-2.7B smoke
configurations (float32, cache in float32; the port's scans on
``"pallas"``, whose route on the CPU is each kernel's plain version of
its decomposition, and the hybrid's shared attention on ``"pallas"``
too) on the meshes (data 2, model 2) and (data 1, model 4): 8 x 32
seeded prompt tokens, then 4 greedy decode steps (``mesh=None``'s argmax).
A batch of 8 is no layer count of these configurations, so the serve
specs, which find the batch dim by its size, put the rows where each rank
computes them (``test_torch_tp_serve.py`` holds the other case).
The parameters are the reference's ``init`` with its constant leaves
moved by seeded noise (``_torch_parity.perturb_constant_leaves``, so the
mixing, bonus, skip and norm terms are exercised), carried across by
``convert.rwkv6_from_jax`` / ``hybrid_from_jax`` and placed by
``param_specs``.  Five more cases: RWKV6 at ``d_model`` 48 with 3 heads
on (2, 2), whose ``wk``/``wv`` stay whole and whose ``wr``/``wg`` split
mid-head, as RWKV6-3B's 40 heads do at model 16; RWKV6 at ``d_ff`` 130 on
(1, 4), where ``tm/wk`` is split and ``cm/wk`` whole (one bare name, two
owners); the hybrid with an attention window of 16 under the 32-token
prompt on (2, 2), its windowed cache over kv heads; and the hybrid with 2
kv heads on (1, 4), without and with that window, its cache split over
its slots (``wk``/``wv`` whole).  Together the cases reach ``wkv`` split
over K (4 and 8 channels of 16 a rank), ``in_proj`` split (model 2) and
whole (model 4: 290 columns), ``ssm`` split over heads (model 2) and
whole (model 4: 2 heads), ``conv`` split over its channels, and the
windowed cache over kv heads and over slots
(:func:`test_the_cases_reach_every_layout`).

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
    configuration and the specs: each one moves an activation or a state
    block, none a parameter;
  * ``DTensor.full_tensor`` raises for the length of every step;
  * the returned state is DTensors placed by ``serve_specs``, each local
    block of its spec's shape, its whole float leaves within 1e-5 times
    the leaf's scale (its largest |value|, at least 1) of ``mesh=None``'s,
    as ``test_torch_hybrid.py`` holds the hybrid's state, ``slot_pos``
    equal.

Also here, without ranks: ``sharding.model_sharded`` telling apart RWKV6's
``tm`` and ``cm`` owners of one name, and the plans of RWKV6-3B and
Zamba2-2.7B at published width on the production meshes.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from torch.utils import _pytree as pytree

from _torch_dist import spawn
from _torch_parity import perturb_constant_leaves
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.models import build_model
from repro_torch.serve import efm

WORLD = 4
F32_TOL = 1e-5
F32 = 4
BATCH, PROMPT, NEW = 8, 32, 4
MESHES = ((2, 2), (1, 4))
# name: (arch, mesh, config overrides in both packages)
CASES = {f"{arch}@{d}x{m}": (arch, (d, m), {})
         for arch in ("rwkv6-3b", "zamba2-2.7b") for d, m in MESHES}
CASES.update({
    "rwkv6-3b@2x2/3 heads": ("rwkv6-3b", (2, 2),
                             {"d_model": 48, "n_heads": 3, "n_kv_heads": 3}),
    "rwkv6-3b@1x4/d_ff 130": ("rwkv6-3b", (1, 4), {"d_ff": 130}),
    "zamba2-2.7b@2x2/window 16": ("zamba2-2.7b", (2, 2),
                                  {"attn_window": 16}),
    "zamba2-2.7b@1x4/2 kv heads": ("zamba2-2.7b", (1, 4),
                                   {"n_kv_heads": 2}),
    "zamba2-2.7b@1x4/2 kv heads, window 16": (
        "zamba2-2.7b", (1, 4), {"n_kv_heads": 2, "attn_window": 16}),
})
# The port only: the hybrid's shared attention on the flash kernel's route
# (the reference's prefill keeps it on the masked path).
PORT = {"rwkv6-3b": {}, "zamba2-2.7b": {"attn_backend": "pallas"}}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SUB_ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
            "OMP_NUM_THREADS": "1"}
for _k in ("JAX_PLATFORMS", "HOME", "TMPDIR"):
    if _k in os.environ:
        _SUB_ENV[_k] = os.environ[_k]


def _cfg(name):
    arch, _, kw = CASES[name]
    return get_smoke_config(arch).replace(cache_dtype="float32", **kw)


@pytest.fixture(scope="module")
def payload():
    out = {}
    rng = np.random.default_rng(5)
    for name, (arch, mesh, kw) in CASES.items():
        jcfg = jax_smoke_config(arch).replace(cache_dtype="float32", **kw)
        params = perturb_constant_leaves(
            jax_build_model(jcfg).init(jax.random.PRNGKey(0)))
        out[name] = {"arch": arch, "mesh": mesh, "new": NEW, "cfg": kw,
                     "port": PORT[arch], "scan_backend": "pallas",
                     "params": jax.tree.map(np.asarray, params),
                     "tokens": rng.integers(0, jcfg.vocab, (BATCH, PROMPT))
                     .astype(np.int32)}
    return out


# The reference's steps on a (data, model) mesh of four forced host
# devices: each case's prefill and greedy decode logits.  The prefill's
# state is padded for decode as the port's ``efm.pad_for_decode`` pads it.
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

    def pad(cfg, state, n):
        if cfg.family != "hybrid":
            return state
        out = dict(state)
        for k in ("k", "v"):
            out[k] = jnp.pad(state[k], [(0, 0)] * 3 + [(0, n), (0, 0)])
        out["slot_pos"] = jnp.pad(state["slot_pos"], [(0, 0), (0, 0), (0, n)],
                                  constant_values=-1)
        return out

    cases = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    for name, case in cases.items():
        cfg = get_smoke_config(case["arch"]).replace(cache_dtype="float32",
                                                     **case["cfg"])
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
            logits, state = prefill(put(params, ps["params"]),
                                    put({"tokens": tokens}, ps["batch"]))
            got = [np.asarray(logits)]
            state = pad(cfg, state, n)
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
    tmp = tmp_path_factory.mktemp("tp_serve_recurrent")
    src, dst = tmp / "cases.pkl", tmp / "ref.pkl"
    with open(src, "wb") as f:
        pickle.dump(payload, f)
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


def _split_state(cfg, model, mesh, seq):
    specs = S.serve_specs(cfg, model.serve_spec(BATCH, seq), mesh, BATCH)
    return {name for name, spec in specs.items()
            if any("model" in S.spec_axes(e) for e in spec)}


def _over_slots(cfg, model, mesh, seq):
    """Whether the serve specs split the hybrid's K/V over its slots."""
    spec = S.serve_specs(cfg, model.serve_spec(BATCH, seq), mesh,
                         BATCH)["k"]
    return "model" in S.spec_axes(spec[3])


def expected_records(name, kind):
    """The collectives one rank issues in a prefill of BATCH x PROMPT or in
    a decode step, in order, as ``(op, bytes of its output on the rank,
    group size)``: float32 activations and state throughout."""
    cfg = _cfg(name)
    d, m = CASES[name][1]
    mesh = M.AbstractMesh((d, m), ("data", "model"))
    model = build_model(cfg, device="cpu")
    split = S.model_sharded(S.param_specs(cfg, model.param_spec(), mesh))
    decode = kind == "decode"
    seq = PROMPT + NEW if decode else PROMPT
    state = _split_state(cfg, model, mesh, seq)
    rows = BATCH // d
    tokens = rows * (1 if decode else PROMPT)
    width = cfg.d_model
    out = []

    def add(op, n, group=m):
        out.append((op, n * F32, group))

    if m > 1:
        if "embed" in split:
            add("all-reduce", tokens * width)
        if cfg.family == "rwkv6":
            for _ in range(cfg.n_layers):
                if decode and "shift_tm" in state:  # the shift, gathered
                    add("all-gather", tokens * width)
                for owner in ("tm/wr", "tm/wk", "tm/wv"):
                    if owner in split:
                        add("all-gather", tokens * width)
                if "wkv" in state:  # the scan's partial o over K
                    add("all-reduce", tokens * width)
                if "tm/wo" in split:
                    add("all-reduce", tokens * width)
                if decode and "shift_cm" in state:
                    add("all-gather", tokens * width)
                if "cm/wk" in split:
                    add("all-gather", tokens * cfg.d_ff)
                if {"cm/wr", "cm/wv"} & split:
                    add("all-gather", tokens * width)
        else:
            d_inner = cfg.ssm_expand * width
            n_ssm = d_inner // 64
            conv_ch = d_inner + 2 * cfg.ssm_state
            d_proj = conv_ch + d_inner + n_ssm
            d2 = 2 * width
            # decode over the rank's slots: every query head, combined
            combine = decode and _over_slots(cfg, model, mesh, seq)
            for _ in range(cfg.n_layers // cfg.shared_attn_period):
                for _ in range(cfg.shared_attn_period):
                    if "in_proj" in split:
                        add("all-gather", tokens * d_proj)
                    if decode and "conv" in state:
                        add("all-gather", rows * (cfg.ssm_conv - 1) * conv_ch)
                    if "ssm" in state:  # the gated norm's sum of squares
                        add("all-reduce", tokens)
                    if "out_proj" in split:
                        add("all-reduce", tokens * width)
                if "wq" in split and (combine or cfg.n_heads % m):
                    add("all-gather", tokens * d2)
                if combine:  # the partial softmaxes: max, then sums
                    add("all-reduce", rows * cfg.n_heads)
                    add("all-reduce", rows * (d2 + cfg.n_heads))
                for owner in ("wo", "down"):
                    if owner in split:
                        add("all-reduce", tokens * d2)
                if "out" in split:
                    add("all-reduce", tokens * width)
        if "embed" in split:
            add("all-gather", rows * cfg.vocab)
    if decode and d > 1:  # the logits replicated over the rows
        add("all-gather", BATCH * cfg.vocab, d)
    return out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


def _scaled(errs):
    return max(e / max(1.0, scale) for e, scale in errs.values())


@pytest.mark.parametrize("name", list(CASES))
def test_logits_equal_mesh_none_on_every_rank(name, runs):
    ranks, _ = runs
    for r in ranks:
        res = r[name]
        assert len(res["errs"]) == 1 + NEW
        assert max(res["errs"]) <= F32_TOL, res["errs"]
        assert _scaled(res["cache_errs"]) <= F32_TOL, res["cache_errs"]
        assert _scaled(res["state_errs"]) <= F32_TOL, res["state_errs"]
        tokens = [t.tolist() for t in res["tokens"]]
        assert tokens == [t.tolist() for t in ranks[0][name]["tokens"]]


@pytest.mark.parametrize("name", list(CASES))
def test_logits_equal_the_references_gspmd_run(name, runs):
    ranks, ref = runs
    got, want = ranks[0][name], ref[name]
    assert [t.tolist() for t in got["tokens"]] == [
        t.tolist() for t in want["tokens"]], "the greedy tokens differ"
    for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        assert a.shape == b.shape == (BATCH, 1, _cfg(name).vocab)
        np.testing.assert_allclose(a, b, rtol=0, atol=F32_TOL,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_each_ranks_collectives_are_the_worked_out_list(name, runs):
    want_prefill = expected_records(name, "prefill")
    want_decode = expected_records(name, "decode")
    assert want_prefill and want_decode
    for r in runs[0]:
        records = r[name]["records"]
        assert records[0] == want_prefill
        for step in records[1:]:
            assert step == want_decode


@pytest.mark.parametrize("name", list(CASES))
def test_states_come_back_placed_by_the_serve_specs(name, runs):
    for r in runs[0]:
        assert r[name]["cache_placed"] and r[name]["state_placed"]


def test_the_cases_reach_every_layout():
    """What the module's docstring says the cases cover."""
    seen = set()
    for name, (arch, (d, m), _) in CASES.items():
        cfg = _cfg(name)
        mesh = M.AbstractMesh((d, m), ("data", "model"))
        model = build_model(cfg, device="cpu")
        split = S.model_sharded(S.param_specs(cfg, model.param_spec(), mesh))
        sspecs = S.serve_specs(cfg, model.serve_spec(BATCH, PROMPT), mesh,
                               BATCH)
        assert efm._tensor_parallel(model), name
        state = _split_state(cfg, model, mesh, PROMPT)
        if cfg.family == "rwkv6":
            if "model" in S.spec_axes(sspecs["wkv"][3]):
                seen.add(f"wkv over K, {cfg.rwkv_head_dim // m} a rank")
            if "tm/wr" in split and (cfg.d_model // cfg.rwkv_head_dim) % m:
                seen.add("wr mid-head")
            if not {"tm/wk", "tm/wv"} & split:
                seen.add("wk whole")
            if "tm/wk" in split and "cm/wk" not in split:
                seen.add("tm/wk split, cm/wk whole")
        else:
            seen.add("in_proj split" if "in_proj" in split
                     else "in_proj whole")
            seen.add("ssm over heads" if "ssm" in state else "ssm whole")
            if "conv" in state:
                seen.add("conv split")
            window = "windowed cache" if cfg.attn_window < PROMPT \
                else "cache"
            for dim, over in ((2, "kv heads"), (3, "slots")):
                if "model" in S.spec_axes(sspecs["k"][dim]):
                    seen.add(f"{window} over {over}")
    assert seen == {"wkv over K, 8 a rank", "wkv over K, 4 a rank",
                    "wr mid-head", "wk whole", "tm/wk split, cm/wk whole",
                    "in_proj split", "in_proj whole", "ssm over heads",
                    "ssm whole", "conv split", "cache over kv heads",
                    "windowed cache over kv heads", "cache over slots",
                    "windowed cache over slots"}


def test_model_sharded_tells_apart_owners_of_one_name():
    """RWKV6 names ``wk``, ``wv`` and ``wr`` in both its time mix and its
    channel mix.  At ``d_ff`` 130 on model 4, ``tm/wk`` is split (d_model
    64 divides) and ``cm/wk`` (64 -> 130) whole: the bare ``wk`` must not
    stand for both; ``wv`` (64 -> 64 in both) is split in both."""
    cfg = get_smoke_config("rwkv6-3b").replace(d_ff=130)
    mesh = M.AbstractMesh((1, 4), ("data", "model"))
    specs = S.param_specs(cfg, build_model(cfg, device="meta").param_spec(),
                          mesh)
    assert specs["layers"]["tm"]["wk"]["w"] == S.P(None, None, "model")
    assert specs["layers"]["cm"]["wk"]["w"] == S.P()
    split = S.model_sharded(specs)
    assert {"tm/wk", "tm/wv", "cm/wv", "tm/wr", "cm/wr"} <= split
    assert "cm/wk" not in split and "wk" not in split
    assert {"wv", "wr", "wg", "wo", "embed"} <= split
    # the dense family's bare names are as they were
    dense = get_smoke_config("tinyllama-1.1b")
    specs = S.param_specs(dense, build_model(dense, device="meta")
                          .param_spec(), M.AbstractMesh((2, 2),
                                                        ("data", "model")))
    assert {"wq", "wk", "wv", "wo", "gate", "up", "down", "lm_head",
            "embed"} <= S.model_sharded(specs)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_published_configs_serve_tensor_parallel_on_production_meshes(
        multi_pod):
    """RWKV6-3B and Zamba2-2.7B at published width on (16, 16) and
    (2, 16, 16): both take the tensor-parallel steps; RWKV6-3B's 40 heads
    keep ``wk``/``wv`` whole (3.83 GB) and split ``wr``/``wg`` mid-head,
    ``wkv`` over K (4 a rank); Zamba2-2.7B splits ``in_proj``, its 80 SSD
    heads (5 a rank), ``conv`` and its kv heads."""
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = M.AbstractMesh((2, 16, 16) if multi_pod else (16, 16), names)
    for arch in ("rwkv6-3b", "zamba2-2.7b"):
        cfg = get_config(arch)
        model = build_model(cfg, device="meta")
        pshape = model.param_spec()
        pspecs = S.param_specs(cfg, pshape, mesh)
        split = S.model_sharded(pspecs)
        sshape = model.serve_spec(32, 32768)
        sspecs = S.serve_specs(cfg, sshape, mesh, 32)
        assert efm._tensor_parallel(model), arch
        assert not efm._cache_seq(sspecs)
        state = _split_state(cfg, model, mesh, 32768)
        if arch == "rwkv6-3b":
            whole = sum(x.numel() * x.element_size() for x, spec in zip(
                pytree.tree_leaves(pshape), S.leaves_like(pshape, pspecs))
                if spec == S.P())
            assert round(whole / 1e9, 2) == 3.83
            assert not {"tm/wk", "tm/wv", "cm/wk", "cm/wv", "wk",
                        "wv"} & split
            assert {"tm/wr", "tm/wg", "tm/wo", "cm/wr", "embed"} <= split
            assert state == {"wkv", "shift_tm", "shift_cm"}
            assert S.local_shape(tuple(sshape["wkv"].shape), sspecs["wkv"],
                                 mesh)[3] == 4
        else:
            assert {"in_proj", "out_proj", "wq", "wk", "wv", "wo", "gate",
                    "up", "down", "out", "embed"} <= split
            assert state == {"ssm", "conv", "k", "v"}
            assert S.local_shape(tuple(sshape["ssm"].shape), sspecs["ssm"],
                                 mesh)[2] == 5
