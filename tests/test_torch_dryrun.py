"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's ``repro.launch.dryrun``.

(i) For all ten architectures at their full published configurations,
    every shape of ``get_shapes`` and both production meshes ((16, 16)
    and (2, 16, 16)): the port's ``param_bytes_per_device``,
    ``param_count``, ``opt_bytes_per_device``, ``cache_bytes_per_device``
    and ``skipped`` equal the reference's, exactly.  The reference's side
    runs in one subprocess that imports ``repro.launch.dryrun`` (its
    ``XLA_FLAGS`` line must not reach this worker) and calls its
    ``sharded_bytes`` on ``jax.sharding.AbstractMesh`` specs, as its
    ``lower_cell`` does before lowering, with nothing lowered.
(ii) In one subprocess, for each family's smoke configuration (as
    ``overrides`` of the full one) on fake process groups of 256 and 512
    ranks: ``run_cell``'s train step is ``ok``, with its collectives
    recorded; the prefill's ``flops`` per device equal ``FlopCounterMode``
    over the unsharded meta prefill of one rank's rows, and its
    ``argument_size_in_bytes`` equals ``sharded_bytes`` of the parameters
    and the batch.  RWKV6 and Zamba2 loop over time in Python (training
    takes the per-token ``"ref"`` scan, prefill the chunked one), which
    meta tensors make no cheaper: their ``run_cell`` step is
    ``decode_32k``, their train step is traced (``lower``/``trace``) at
    64 tokens a row on the production meshes, and their prefill runs
    with ``scan_chunk`` at the sequence length.
(iii) ``run_cell`` in a process that holds a gloo group raises.
(iv) An ``attn_backend="pallas"`` override on meta records the flash
    wrapper's ``ValueError`` (no fallback to the plain version).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import ARCH_IDS, get_shapes
from repro_torch.launch import dryrun as D

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SUB_ENV = {"PYTHONPATH": os.path.join(ROOT, "src"), "PATH": "/usr/bin:/bin",
            "OMP_NUM_THREADS": "1"}
for _k in ("JAX_PLATFORMS", "HOME"):
    if _k in os.environ:
        _SUB_ENV[_k] = os.environ[_k]

CELLS = [(arch, s.name, mp) for arch in ARCH_IDS for s in get_shapes(arch)
         for mp in (False, True)]

_REF_BYTES = textwrap.dedent("""
    import json
    from repro.launch import dryrun as D  # sets XLA_FLAGS: a process of its own
    import jax, jax.numpy as jnp
    from repro.configs import ARCH_IDS, get_config, get_shapes
    from repro.launch import sharding as S
    from repro.launch import train as TR
    from repro.models import build_model
    from repro.optim import adamw

    def mesh(mp):
        names = ("pod", "data", "model") if mp else ("data", "model")
        shape = (2, 16, 16) if mp else (16, 16)
        try:
            return jax.sharding.AbstractMesh(shape, names)
        except TypeError:
            return jax.sharding.AbstractMesh(tuple(zip(names, shape)))

    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = build_model(cfg)
        pshape = model.param_spec()
        for shape in get_shapes(arch):
            for mp in (False, True):
                key = f"{arch}|{shape.name}|{int(mp)}"
                if shape.skip:
                    out[key] = {"skipped": shape.skip}
                    continue
                m = mesh(mp)
                aux = {"param_bytes_per_device": D.sharded_bytes(
                           pshape, S.param_specs(cfg, pshape, m), m),
                       "param_count": sum(l.size for l in
                                          jax.tree.leaves(pshape))}
                if shape.kind == "train":
                    mdt = jnp.dtype(cfg.opt_moment_dtype)
                    oshape = jax.eval_shape(
                        lambda p: TR.cast_moments(adamw.init(p), mdt), pshape)
                    aux["opt_bytes_per_device"] = D.sharded_bytes(
                        oshape, S.opt_specs(cfg, pshape, m), m)
                elif shape.kind == "decode":
                    b = shape.global_batch
                    sshape = model.serve_spec(b, shape.seq_len)
                    aux["cache_bytes_per_device"] = D.sharded_bytes(
                        sshape, S.serve_specs(cfg, sshape, m, b), m)
                out[key] = aux
    print(json.dumps(out))
""")


def _run(code, *args, timeout=600):
    out = subprocess.run([sys.executable, "-c", code, *args], env=_SUB_ENV,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_bytes():
    return _run(_REF_BYTES)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_bytes_counts_and_skips_are_the_references(ref_bytes, arch):
    for a, shape, mp in CELLS:
        if a != arch:
            continue
        want = ref_bytes[f"{arch}|{shape}|{int(mp)}"]
        assert D.cell_bytes(arch, shape, mp) == want, (shape, mp)


_FAMILIES = ("tinyllama-1.1b", "deepseek-v2-lite-16b", "rwkv6-3b",
             "zamba2-2.7b", "llama-3.2-vision-11b", "seamless-m4t-large-v2")

_META_CELLS = textwrap.dedent("""
    import dataclasses, json, sys, warnings
    import torch
    import torch.distributed as dist
    from torch.utils import _pytree as pytree
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config, get_shapes, get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as S
    from repro_torch.models import build_model
    from repro_torch.serve import efm
    warnings.simplefilter("ignore")

    def smoke(arch, seq):
        full, small = get_config(arch), get_smoke_config(arch)
        ov = {f.name: getattr(small, f.name)
              for f in dataclasses.fields(full)
              if getattr(small, f.name) != getattr(full, f.name)}
        if small.family in ("rwkv6", "hybrid"):
            ov["scan_chunk"] = seq
        return ov

    out = {}
    for arch in json.loads(sys.argv[1]):
        shapes = {s.name: s for s in get_shapes(arch)}
        scans = get_smoke_config(arch).family in ("rwkv6", "hybrid")
        for mp in (False, True):
            rec = D.run_cell(arch, "decode_32k" if scans else "train_4k", mp,
                             verbose=False, overrides=smoke(arch, 4096))
            out[f"{arch}|step|{int(mp)}"] = {
                k: rec.get(k) for k in ("ok", "error")} | {
                "n_collectives": sum(rec["collectives"]["counts"].values())
                if rec["ok"] else 0}
            if scans:
                cfg = get_config(arch).replace(**smoke(arch, 64))
                with D.fake_world(512 if mp else 256):
                    got = D.trace(D.lower(
                        build_model(cfg, device="meta"),
                        ShapeSpec("train_64", "train", 64, 256),
                        D.production_mesh(mp)))
                out[f"{arch}|train64|{int(mp)}"] = len(got["records"])
        shape = shapes["prefill_32k"]
        ov = smoke(arch, shape.seq_len)
        rec = D.run_cell(arch, "prefill_32k", False, verbose=False,
                         overrides=ov)
        cfg = get_config(arch).replace(**ov)
        model = build_model(cfg, device="meta")
        pshape, batch = model.param_spec(), model.batch_spec(shape)
        mesh = M.AbstractMesh((16, 16), ("data", "model"))
        bspecs = S.batch_specs(cfg, shape, mesh)
        rows = shape.global_batch // M.axes_size(
            mesh, S.spec_axes(bspecs["tokens"][0]))
        with FlopCounterMode(display=False) as fc:
            efm.jit_prefill(model)(pshape, {k: v[:rows]
                                            for k, v in batch.items()})
        out[f"{arch}|prefill"] = {
            "ok": rec["ok"], "error": rec.get("error"),
            "flops": rec.get("flops"), "plain_flops": float(
                fc.get_total_flops()),
            "args": rec.get("argument_size_in_bytes"),
            "spec_args": D.sharded_bytes(pshape, S.param_specs(
                cfg, pshape, mesh), mesh) + D.sharded_bytes(batch, bspecs,
                                                             mesh)}

    pallas = D.run_cell("tinyllama-1.1b", "prefill_32k", False,
                        verbose=False, overrides=dict(
                            smoke("tinyllama-1.1b", 0),
                            attn_backend="pallas"))
    out["pallas"] = {k: pallas.get(k) for k in ("ok", "error")}

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        D.run_cell("tinyllama-1.1b", "train_4k", False, verbose=False)
    except RuntimeError as e:
        out["held_group"] = str(e)
    dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def meta_cells():
    return _run(_META_CELLS, json.dumps(_FAMILIES))


@pytest.mark.parametrize("arch", _FAMILIES)
def test_each_familys_meta_step_runs_on_256_and_512_ranks(meta_cells, arch):
    for mp in (0, 1):
        rec = meta_cells[f"{arch}|step|{mp}"]
        assert rec["ok"], rec["error"]
        assert rec["n_collectives"] > 0
        if f"{arch}|train64|{mp}" in meta_cells:
            assert meta_cells[f"{arch}|train64|{mp}"] > 0


@pytest.mark.parametrize("arch", _FAMILIES)
def test_prefill_flops_and_argument_bytes_per_device(meta_cells, arch):
    rec = meta_cells[f"{arch}|prefill"]
    assert rec["ok"], rec["error"]
    assert rec["flops"] == rec["plain_flops"] > 0
    assert rec["args"] == rec["spec_args"]


def test_a_process_holding_a_group_is_refused(meta_cells):
    assert "already holds a 'gloo' process group" in meta_cells["held_group"]


def test_a_pallas_override_on_meta_records_the_wrappers_error(meta_cells):
    rec = meta_cells["pallas"]
    assert rec["ok"] is False
    assert rec["error"].startswith("ValueError") and "meta" in rec["error"]


def test_the_cli_writes_one_record_a_cell_and_skips_existing(tmp_path):
    out = tmp_path / "cells.jsonl"
    for _ in range(2):
        assert D.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k",
                       "--out", str(out), "--skip-existing"]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["mesh"], r["ok"]) for r in recs] == [("16x16", True),
                                                    ("2x16x16", True)]
    assert all("not deployable" in r["skipped"] for r in recs)
