"""The port's mesh and distribution layer on four gloo ranks, against the
JAX package.

One spawn of four ranks (``tests/_torch_dist.py``: a ``FileStore`` under
``tmp_path``, a 60 s group timeout, a 120 s join limit) runs every case
of this module; the parent holds each rank's results against the
reference, run here in the parent process and, for ``moe_ffn_ep``, in one
subprocess with four forced host devices.  The ranks import no JAX.
Inputs are numpy, drawn from fixed seeds; parameters are the port's
``init`` (its constant leaves moved by seeded noise).

Tolerances, as each case states:
  * ``ef_int8_allreduce`` on 4 ranks: int8 payload and scales exactly the
    reference's ``optim.compress.compress``, the mean within 1e-6 of
    max|g| of the reference's under ``jax.vmap(..., axis_name=)``;
  * ``jit_train_step`` on (data 2, model 2) for TinyLlama and
    DeepSeek-V2-Lite (``moe_impl="ep"``, ``"tp"`` and ``"fsdp"``;
    capacity factor 8: nothing dropped), ``accum`` 2, and every other
    family on (data 4, model 1): one step against the reference's
    unsharded ``make_train_step`` (the DeepSeek steps, in both EP
    layouts, with the load-balance term off: see TRAIN) -- the loss
    within 1e-5 relative; by PR 26's rule (``chip_smoke.hold_step``) the
    gradient norm within 1e-4 relative, the first moments within 1e-4 of
    their leaf's largest value and the parameters by :func:`_step_err`
    (the ranks' gradients are summed in another order than one batch's);
    each rank's local bytes of parameters and moments as their specs
    reckon them;
  * ``moe_ffn_ep`` on (2, 2), ``"tp"``/``"model"`` and ``"fsdp"``/
    ``"dp_model"`` at capacity factor 1.0 (tokens dropped): outputs within
    1e-5 and gradients within 1e-4 of the reference's ``moe_ffn_ep``; with
    ``moe_a2a_quant``, outputs within 1e-5 of the reference's quantised
    ones, and at capacity factor 8 (nothing dropped, as the reference's
    own test runs it) inside its bounds against the sort path (0.03 of
    max|y|, 0.1 of each gradient leaf's max);
  * ``jit_prefill``/``jit_decode_step`` on (data 2, model 1): the logits
    within 1e-5 of ``mesh=None`` (``test_torch_efm.py``'s F32_TOL);
  * ``restore(shardings=)``: a checkpoint saved from (2, 2) restores
    bitwise onto (4, 1) and onto no mesh.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from _torch_dist import spawn
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import compression as jcompression
from repro.launch import train as jtrain
from repro.models import build_model as jax_build_model
from repro.models import encdec as jencdec
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.configs import get_smoke_config
from repro_torch.models import build_model, moe

WORLD = 4
F32_TOL = 1e-5
LOSS_TOL = 1e-5  # relative
TRAIN_TOL = 1e-4  # PR 26's: gnorm, first moments (relative to their scale)
LR, STEP, WARMUP, TOTAL = 1e-3, 3, 2, 20
# name: (arch, config overrides, mesh, accum)
TRAIN = {
    "tinyllama": ("tinyllama-1.1b", {}, (2, 2), 2),
    "deepseek": ("deepseek-v2-lite-16b",
                 {"moe_impl": "ep", "moe_aux_coef": 0.0}, (2, 2), 2),
    "deepseek_fsdp": ("deepseek-v2-lite-16b",
                      {"moe_impl": "ep", "moe_aux_coef": 0.0,
                       "shard_strategy": "fsdp", "ep_axes": "dp_model"},
                      (2, 2), 2),
    "rwkv6": ("rwkv6-3b", {}, (4, 1), 1),
    "hybrid": ("zamba2-2.7b", {}, (4, 1), 1),
    "vlm": ("llama-3.2-vision-11b", {}, (4, 1), 1),
    "encdec": ("seamless-m4t-large-v2", {}, (4, 1), 1),
}
EFM = {"tinyllama": "tinyllama-1.1b", "deepseek": "deepseek-v2-lite-16b",
       "rwkv6": "rwkv6-3b", "hybrid": "zamba2-2.7b",
       "vlm": "llama-3.2-vision-11b", "encdec": "seamless-m4t-large-v2"}
# Under EP each rank's region averages its own load-balance term (the
# reference's pmean over the token axes; held in the moe_ffn_ep cases),
# which is not the unsharded step's term over the whole microbatch, so the
# DeepSeek steps run with that term off.  (The reference's own sharded
# jit_train_step cannot stand in: under jax 0.9 it raises ShardingTypeError
# on both EP layouts.)
MOE_CASES = {
    "tp": {"ep_axes": "model", "shard_strategy": "tp"},
    "fsdp": {"ep_axes": "dp_model", "shard_strategy": "fsdp"},
}
_SUB_ENV = {"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}
for _k in ("JAX_PLATFORMS", "HOME", "TMPDIR"):
    if _k in os.environ:
        _SUB_ENV[_k] = os.environ[_k]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(arch, cfg_kw=None, seed=0):
    """The port's parameters of ``arch``'s smoke configuration as numpy
    (insertion order kept), constant leaves moved by seeded noise."""
    cfg = get_smoke_config(arch).replace(**(cfg_kw or {}))
    tree = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)

    def move(t):
        a = t.numpy()
        if a.size > 1 and np.all(a == a.flat[0]):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return pytree.tree_map(move, tree)


def _batch(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["img_embed"] = 0.1 * rng.standard_normal(
            (b, cfg.img_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["src_embed"] = 0.1 * rng.standard_normal(
            (b, jencdec.src_len(cfg, s), cfg.d_model)).astype(np.float32)
    return out


def _ef_grads():
    rng = np.random.default_rng(5)
    shapes = {"a": (8, 16), "b": (33,), "c": (4, 4, 4)}
    return [{k: (rng.standard_normal(s) * (1 + r)).astype(np.float32)
             for k, s in shapes.items()} for r in range(WORLD)]


def _moe_cases():
    base = get_smoke_config("deepseek-v2-lite-16b")
    rng = np.random.default_rng(2)
    x = (0.3 * rng.standard_normal((8, 16, base.d_model))).astype(np.float32)
    cases = {}
    for name, kw in MOE_CASES.items():
        for suffix, quant, cf in (("", False, 1.0), ("_int8", True, 1.0),
                                  ("_int8_cf8", True, 8.0)):
            ckw = dict(kw, moe_capacity_factor=cf, moe_a2a_quant=quant)
            p = moe.init_moe(torch.Generator().manual_seed(1),
                             base.replace(**ckw))
            cases[name + suffix] = {
                "cfg": ckw, "x": x,
                "params": pytree.tree_map(lambda t: t.numpy(), p)}
    return cases


@pytest.fixture(scope="module")
def payload():
    train = {}
    for name, (arch, kw, mesh, accum) in TRAIN.items():
        cfg = get_smoke_config(arch).replace(**kw)
        train[name] = {"arch": arch, "cfg": kw, "mesh": mesh, "accum": accum,
                       "params": _params(arch, kw),
                       "batch": _batch(cfg, 8, 16), "lr": LR, "step": STEP,
                       "warmup": WARMUP, "total": TOTAL}
    efm = {}
    for name, arch in EFM.items():
        cfg = get_smoke_config(arch).replace(cache_dtype="float32")
        efm[name] = {"arch": arch, "cfg": {"cache_dtype": "float32"},
                     "params": _params(arch), "batch": _batch(cfg, 4, 8),
                     "new": 3}
    return {"ef": _ef_grads(), "moe_ep": _moe_cases(), "train": train,
            "efm": efm, "restore": "tinyllama"}


@pytest.fixture(scope="module")
def ranks(payload, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    return spawn("distributed_suite", WORLD, tmp, payload, str(tmp))


# ---------------------------------------------------------------------------
# EF-int8
# ---------------------------------------------------------------------------


def test_ef_int8_allreduce_matches_jax_on_four_ranks(payload, ranks):
    grads = payload["ef"]
    stacked = {k: jnp.stack([g[k] for g in grads]) for k in grads[0]}
    ref = jax.vmap(lambda g: jcompression.ef_int8_allreduce(g, "data"),
                   axis_name="data")(stacked)
    for r, res in enumerate(ranks):
        q, scales, _ = jcompress.compress(
            {k: jnp.asarray(v) for k, v in grads[r].items()},
            jcompress.init({k: jnp.asarray(v) for k, v in grads[r].items()}))
        for k in grads[r]:
            got_q, got_s = res["ef"]["payload"][k]
            np.testing.assert_array_equal(got_q, np.asarray(q[k]))
            assert got_s.dtype == np.float32
            np.testing.assert_array_equal(got_s, np.asarray(scales[k]))
            top = max(float(np.abs(g[k]).max()) for g in grads)
            np.testing.assert_allclose(res["ef"]["out"][k],
                                       np.asarray(ref[k][r]), rtol=0,
                                       atol=1e-6 * top, err_msg=k)


# ---------------------------------------------------------------------------
# The sharded train step
# ---------------------------------------------------------------------------


def _walk(ref, got, fn, path=""):
    if isinstance(got, dict):
        assert set(got) == set(ref), path
        for k in got:
            _walk(ref[k], got[k], fn, f"{path}/{k}")
        return
    fn(np.asarray(ref), np.asarray(got), path)


@pytest.fixture(scope="module")
def reference_steps(payload):
    out = {}
    for name, case in payload["train"].items():
        jcfg = jax_smoke_config(case["arch"]).replace(**case["cfg"])
        jm = jax_build_model(jcfg)
        params = jax.tree.map(jnp.asarray, case["params"])
        step = jtrain.make_train_step(
            jm, jadamw.AdamWConfig(lr=LR), accum=case["accum"],
            warmup_steps=WARMUP, total_steps=TOTAL)
        p, o, m = jax.jit(step)(params, jadamw.init(params),
                                jax.tree.map(jnp.asarray, case["batch"]),
                                STEP)
        out[name] = jax.tree.map(np.asarray, (p, o, m))
    return out


def _step_err(ref_p, ref_mu, got_p, lr=LR, beta1=0.9, eps=1e-8):
    """Parameters after one AdamW step against the reference's, as the
    largest difference over what is allowed (pass: <= 1), PR 26's rule
    (``chip_smoke.step_err``): an element moves by lr g / (|g| + eps), so
    a gradient within TRAIN_TOL of its leaf's largest |g| moves it by at
    most lr eps TRAIN_TOL max|g| / (|g| + eps)^2 (never more than 2 lr);
    a rounding-residue gradient (below 1e-4 of the leaf's largest) only
    within 2 lr; plus 1e-6 of the leaf's max|p|."""
    a, b = ref_p.astype(np.float64), got_p.astype(np.float64)
    g = np.abs(ref_mu.astype(np.float64)) / (1 - beta1)
    top = g.max()
    moved = np.minimum(lr * eps * TRAIN_TOL * top / (g + eps) ** 2, 2 * lr)
    allowed = np.where(g >= 1e-4 * top, moved, 2 * lr)
    allowed = allowed + 1e-6 * np.abs(a).max()
    return float((np.abs(a - b) / allowed).max())


@pytest.mark.parametrize("name", list(TRAIN))
def test_jit_train_step_matches_the_unsharded_reference(name, ranks,
                                                        reference_steps):
    jp, jo, jm = reference_steps[name]
    got = ranks[0][f"train/{name}"]
    np.testing.assert_allclose(got["metrics"]["loss"], float(jm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(got["metrics"]["gnorm"], float(jm["gnorm"]),
                               rtol=TRAIN_TOL)
    np.testing.assert_allclose(got["metrics"]["lr"], float(jm["lr"]),
                               rtol=1e-6)
    assert all(r[f"train/{name}"]["metrics"] == got["metrics"]
               for r in ranks), "ranks disagree on the metrics"
    assert all(r[f"train/{name}"]["step"] == 1 for r in ranks)

    def moment(a, b, path):
        tol = TRAIN_TOL * max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=path)

    _walk(jo.mu, got["mu"], moment)
    worst = {}

    def params(ref_p, got_p, ref_mu, path=""):
        if isinstance(got_p, dict):
            for k in got_p:
                params(ref_p[k], got_p[k], ref_mu[k], f"{path}/{k}")
            return
        worst[path] = _step_err(np.asarray(ref_p), np.asarray(ref_mu), got_p)

    params(jp, got["params"], jo.mu)
    assert max(worst.values()) <= 1.0, worst


@pytest.mark.parametrize("name", list(TRAIN))
def test_each_ranks_local_bytes_are_the_specs(name, ranks):
    assert all(r[f"train/{name}"]["bytes"] for r in ranks)


# ---------------------------------------------------------------------------
# Expert-parallel MoE
# ---------------------------------------------------------------------------

# The reference's moe_ffn_ep (and its sort path) on four forced host
# devices, for each MoE case.
_MOE_REF = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np, pickle
    from repro.configs import get_smoke_config
    from repro.models import moe as MOE
    cases = pickle.load(open(sys.argv[1], "rb"))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    out = {}
    for name, case in cases.items():
        cfg = get_smoke_config("deepseek-v2-lite-16b").replace(**case["cfg"])
        p = jax.tree.map(jnp.asarray, case["params"])
        x = jnp.asarray(case["x"])
        with mesh:
            y, aux = jax.jit(lambda p, x: MOE.moe_ffn_ep(p, x, cfg))(p, x)
            g = jax.jit(jax.grad(
                lambda p, x: MOE.moe_ffn_ep(p, x, cfg)[0].sum()))(p, x)
        ys, _ = MOE.moe_ffn_sort(p, x, cfg)
        gs = jax.grad(lambda p, x: MOE.moe_ffn_sort(p, x, cfg)[0].sum())(p, x)
        out[name] = {"y": np.asarray(y), "aux": float(aux), "g": flat(g),
                     "y_sort": np.asarray(ys), "g_sort": flat(gs)}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


@pytest.fixture(scope="module")
def moe_reference(payload, tmp_path_factory):
    import pickle

    tmp = tmp_path_factory.mktemp("moe_ref")
    src, dst = tmp / "cases.pkl", tmp / "out.pkl"
    with open(src, "wb") as f:
        pickle.dump(payload["moe_ep"], f)
    r = subprocess.run([sys.executable, "-c", _MOE_REF, str(src), str(dst)],
                       capture_output=True, text=True, timeout=300,
                       env=_SUB_ENV, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


def _ep_result(ranks, name, payload):
    """The global output assembled from the ranks' rows, and the
    gradients (summed over the ranks) keyed as the reference keys them."""
    case = payload["moe_ep"][name]
    y = np.zeros_like(case["x"])
    for r in ranks:
        res = r[f"moe_ep/{name}"]
        y[res["lo"]:res["lo"] + res["y"].shape[0]] = res["y"]
    paths = [pytree.keystr(p) for p, _ in
             pytree.tree_flatten_with_path(case["params"])[0]]
    grads = dict(zip(paths, ranks[0][f"moe_ep/{name}"]["grads"]))
    return y, grads


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_ffn_ep_matches_the_reference_with_drops(name, payload, ranks,
                                                     moe_reference):
    ref = moe_reference[name]
    y, grads = _ep_result(ranks, name, payload)
    np.testing.assert_allclose(y, ref["y"], rtol=0, atol=1e-5)
    auxes = {r[f"moe_ep/{name}"]["aux"] for r in ranks}
    assert len(auxes) == 1
    np.testing.assert_allclose(auxes.pop(), ref["aux"], rtol=1e-6)
    assert set(grads) == set(ref["g"])
    for k, g in grads.items():
        np.testing.assert_allclose(g, ref["g"][k], rtol=0, atol=1e-4,
                                   err_msg=k)
    # capacity factor 1.0 drops tokens, so the EP path is not the sort path
    assert np.abs(y - ref["y_sort"]).max() > 1e-3


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_ffn_ep_int8_exchange_matches_the_reference(name, payload, ranks,
                                                        moe_reference):
    ref = moe_reference[name + "_int8"]
    y, _ = _ep_result(ranks, name + "_int8", payload)
    np.testing.assert_allclose(y, ref["y"], rtol=0, atol=1e-5)
    # Against the sort path where nothing is dropped (capacity factor 8),
    # as the reference's own test bounds its int8 dispatch.
    ref = moe_reference[name + "_int8_cf8"]
    y, grads = _ep_result(ranks, name + "_int8_cf8", payload)
    np.testing.assert_allclose(y, ref["y"], rtol=0, atol=1e-5)
    rel = np.abs(ref["y_sort"] - y).max() / np.abs(ref["y_sort"]).max()
    assert rel < 0.03, rel
    grel = max(np.abs(g - ref["g_sort"][k]).max()
               / (np.abs(g).max() + 1e-9) for k, g in grads.items())
    assert grel < 0.1, grel


# ---------------------------------------------------------------------------
# Sharded prefill / decode, restore onto other meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(EFM))
def test_sharded_prefill_and_decode_equal_one_device(name, ranks):
    for r in ranks[:2]:
        errs = r[f"efm/{name}"]
        assert errs["decode"] <= F32_TOL, errs
        assert errs.get("prefill", 0.0) <= F32_TOL, errs
    assert all(r[f"efm/{name}"] is None for r in ranks[2:])


def test_restore_onto_other_meshes_is_bitwise(ranks):
    for r in ranks:
        res = r["restore"]
        assert res["step"] == 1 and res["placed"]
        for key in ("onto", "plain"):
            for a, b in zip(pytree.tree_leaves(res["saved"]),
                            pytree.tree_leaves(res[key])):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The training driver
# ---------------------------------------------------------------------------


def test_train_efm_driver_falls_and_restarts_once(tmp_path):
    # One intra-op thread, as the spawned ranks take: beside other test
    # processes on the same cores a thread per core made this run ~50x
    # slower (six concurrent copies: 150 s each not enough, against 9 s).
    env = dict(_SUB_ENV, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_efm", "--small",
         "--steps", "20", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[-1] == "OK"
    assert any("restarts=1" in line for line in lines), r.stdout
    first, last = next(line for line in lines if "first10" in line).split(
        "first10=")[1].split(" last10=")
    assert float(last) < float(first)
    # the driver removed its checkpoints
    assert not [n for n in os.listdir(tmp_path) if n.startswith("efm_ckpt")]

