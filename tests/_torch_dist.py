"""Spawned gloo ranks for the port's distributed tests.

:func:`spawn` starts ``world`` processes (the ``spawn`` start method, so
no rank inherits the parent's JAX), joins them into one gloo group on a
``FileStore`` under the test's ``tmp_path`` (never a fixed port, so
``xdist`` workers cannot collide), runs one of this module's rank
programs on every rank and returns each rank's result.  The group is
given a 60 s timeout and the ranks a 120 s join limit; a rank that fails,
dies or overruns fails the call, and no process outlives it.

The rank programs import ``torch`` and ``repro_torch`` only.  They take
numpy inputs made in the parent and return numpy results, which the
parent holds against the reference.
"""

from __future__ import annotations

import os
import queue as queue_mod
import time
import traceback
from datetime import timedelta

import numpy as np

INIT_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 120


def _entry(rank, world, store_path, program, args, out):
    import faulthandler

    import torch
    import torch.distributed as dist

    # A rank that overruns prints its stacks before the parent kills it.
    faulthandler.dump_traceback_later(JOIN_TIMEOUT_S - 10, exit=False)
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=INIT_TIMEOUT_S))
        result = globals()[program](rank, world, *args)
        out.put((rank, True, result))
    except BaseException:  # reported to the parent, which fails the test
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(program: str, world: int, tmp_path, *args,
          timeout: float = JOIN_TIMEOUT_S):
    """Run rank program ``program(rank, world, *args)`` on ``world`` gloo
    ranks; returns the results in rank order."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store_path = os.path.join(str(tmp_path), f"store_{program}")
    procs = [ctx.Process(target=_entry,
                         args=(r, world, store_path, program, args, out),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results = {}
    try:
        while len(results) < world and time.monotonic() < deadline:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    time.sleep(1.0)  # let a dying rank's report arrive
                    while not out.empty():
                        rank, ok, value = out.get()
                        results[rank] = (ok, value)
                    break
                continue
            results[rank] = (ok, value)
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = [f"rank {r}:\n{v}" for r, (ok, v) in sorted(results.items())
              if not ok]
    if errors:
        raise AssertionError("\n".join(errors))
    missing = sorted(set(range(world)) - set(results))
    if missing:
        codes = [p.exitcode for p in procs]
        raise AssertionError(
            f"ranks {missing} gave no result within {timeout:.0f} s "
            f"(exit codes {codes})")
    return [results[r][1] for r in range(world)]


# ---------------------------------------------------------------------------
# Shared pieces of the rank programs
# ---------------------------------------------------------------------------


def _t(x):
    import torch

    return None if x is None else torch.from_numpy(np.array(x))


def _np(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().cpu().numpy()


def _tree(fn, tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_map(lambda x: None if x is None else fn(x), tree)


def _mesh(shape, names, ranks=None):
    """A CPU ``DeviceMesh`` of ``shape`` over ``ranks`` (default: the first
    ``prod(shape)`` ranks of the world)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    ids = torch.arange(n) if ranks is None else torch.as_tensor(ranks)
    return DeviceMesh("cpu", ids.reshape(shape), mesh_dim_names=names)


# ---------------------------------------------------------------------------
# test_torch_distributed.py: EF-int8, the sharded train step, EP MoE,
# sharded prefill/decode, restore onto other meshes
# ---------------------------------------------------------------------------


def _ef_case(rank, world, grads):
    from repro_torch.launch import compression as C

    mesh = _mesh((world, 1), ("data", "model"))
    mine = _tree(_t, grads[rank])
    out = C.ef_int8_allreduce(mine, "data", mesh)
    payload = _tree(lambda g: tuple(x.numpy() for x in C.quantize(g)), mine)
    return {"out": _tree(_np, out), "payload": payload}


def _moe_ep_case(rank, world, case):
    """``moe_ffn_ep`` on (2, 2): this rank's output rows, its aux, and
    the gradient of the sum of the global output (each rank's share
    divided by the ranks that hold a copy of its rows), summed over the
    ranks."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as S
    from repro_torch.models import moe

    mesh = _mesh((2, 2), ("data", "model"))
    cfg = get_smoke_config("deepseek-v2-lite-16b").replace(**case["cfg"])
    x = _t(case["x"])
    b_axes = S._dp(mesh, x.shape[0],
                   include_model=cfg.shard_strategy in ("dp", "fsdp")) or ()
    rows = x.shape[0] // M.axes_size(mesh, b_axes)
    lo = M.axis_index(mesh, b_axes) * rows
    params = _tree(lambda a: _t(a).requires_grad_(True), case["params"])
    with M.use_mesh(mesh, b_axes):
        out = moe.moe_ffn_ep(params, x[lo:lo + rows], cfg)
    assert out is not None, "moe_ffn_ep fell back to the sort path"
    y, aux = out
    copies = mesh.size() // M.axes_size(mesh, b_axes)
    leaves = torch.utils._pytree.tree_leaves(params)
    grads = torch.autograd.grad(y.sum() / copies, leaves)
    for g in grads:
        dist.all_reduce(g)
    return {"lo": lo, "y": _np(y), "aux": float(aux),
            "grads": [_np(g) for g in grads]}


def _local_bytes_match(tree, specs, mesh) -> bool:
    """Whether each DTensor leaf's local block is the size its spec gives
    (the spec's reckoning of per-rank bytes)."""
    from torch.utils import _pytree as pytree

    from repro_torch.launch import sharding as S

    for x, spec in zip(pytree.tree_leaves(tree),
                       S.leaves_like(tree, specs)):
        want = S.local_shape(tuple(x.shape), spec, mesh)
        local = x.to_local()
        if (tuple(local.shape) != want or local.numel() * local.element_size()
                != int(np.prod(want)) * x.element_size()):
            return False
    return True


def _train_case(rank, world, case):
    """One step of ``jit_train_step`` on a ``case["mesh"]`` (data, model)
    mesh from whole numpy trees; the whole parameters, moments and
    metrics after it, and the collectives the step issued (``Recorder``)."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import train
    from repro_torch.launch.hloparse import Recorder
    from repro_torch.models import build_model
    from repro_torch.optim import adamw

    mesh = _mesh(case["mesh"], ("data", "model"))
    cfg = get_smoke_config(case["arch"]).replace(**case.get("cfg", {}))
    model = build_model(cfg, device="cpu")
    params = _tree(_t, case["params"])
    batch = _tree(_t, case["batch"])
    b, s = batch["tokens"].shape
    step_fn, specs = train.jit_train_step(
        model, mesh, adamw.AdamWConfig(lr=case["lr"]),
        shape_spec=ShapeSpec("x", "train", s, b), accum=case["accum"],
        warmup_steps=case["warmup"], total_steps=case["total"])
    with Recorder() as rec:
        p, o, m = step_fn(params, adamw.init(params), batch, case["step"])
    out = {"records": [tuple(r) for r in rec.records],
           "bytes": _local_bytes_match(p, specs["params"], mesh)
           and _local_bytes_match(o.mu, specs["opt"].mu, mesh)
           and _local_bytes_match(o.nu, specs["opt"].nu, mesh),
           "metrics": {k: float(v) for k, v in m.items()}}
    full = (pytree.tree_map(_np, p), pytree.tree_map(_np, o.mu),
            pytree.tree_map(_np, o.nu))
    if rank == 0:
        out["params"], out["mu"], out["nu"] = full
    out["step"] = int(o.step.full_tensor())
    out["p"], out["o"] = p, o  # kept for the restore case, not returned
    return out


def _efm_case(rank, world, case):
    """``jit_prefill`` and ``jit_decode_step`` on (data 2, model 1) over
    ranks 0 and 1, against ``mesh=None`` on the same rank: the largest
    differences of the prefill logits and of each decoded step's."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import build_model
    from repro_torch.serve import efm

    mesh = _mesh((2, 1), ("data", "model"))  # every rank makes it
    if rank >= 2:
        return None
    cfg = get_smoke_config(case["arch"]).replace(**case.get("cfg", {}))
    model = build_model(cfg, device="cpu")
    params = _tree(_t, case["params"])
    batch = _tree(_t, case["batch"])
    b, s = batch["tokens"].shape
    n = case["new"]
    prefill, _ = efm.jit_prefill(model, mesh, ShapeSpec("x", "prefill", s, b))
    decode, _ = efm.jit_decode_step(model, mesh,
                                    ShapeSpec("x", "decode", s + n, b))
    plain_prefill = efm.jit_prefill(model)
    plain_decode = efm.jit_decode_step(model)
    errs = {}
    logits, cache = prefill(params, batch)
    ref_logits, ref_cache = plain_prefill(params, batch)
    if logits is not None:
        errs["prefill"] = float((logits.full_tensor() - ref_logits).abs()
                                .max())
    fam = cfg.family
    state = efm.pad_for_decode(model, pytree.tree_map(_full, cache), n)
    ref_state = efm.pad_for_decode(model, ref_cache, n)
    tok = batch["tokens"][:, -1:]
    start = 0 if fam == "encdec" else s
    if fam == "encdec":
        tok = batch["tokens"][:, :1]
    worst = 0.0
    for i in range(n):
        lg, state = decode(params, state, tok, start + i)
        rlg, ref_state = plain_decode(params, ref_state, tok, start + i)
        lg = lg.full_tensor()
        worst = max(worst, float((lg - rlg).abs().max()))
        tok = torch.argmax(rlg[:, -1:], dim=-1).to(torch.int32)
        state = pytree.tree_map(_full, state)
    errs["decode"] = worst
    return errs


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _restore_case(rank, world, trained, tmp):
    """The (2, 2) train step's DTensor parameters saved, restored onto
    (4, 1) and onto no mesh: each leaf whole, as numpy."""
    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import store
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as S
    from repro_torch.models import build_model

    params, arch = trained
    directory = os.path.join(tmp, "ckpt")
    store.save(directory, 1, params)
    mesh = _mesh((4, 1), ("data", "model"))
    model = build_model(get_smoke_config(arch), device="cpu")
    specs = S.param_specs(model.cfg, model.param_spec(), mesh)
    like = pytree.tree_map(_full, params)
    onto, step = store.restore(directory, like, shardings=S.named(mesh, specs))
    placed = all(tuple(x.placements) == s.placements for x, s in zip(
        pytree.tree_leaves(onto),
        S.leaves_like(onto, S.named(mesh, specs))))
    plain, _ = store.restore(directory, like)
    return {"step": step, "placed": placed,
            "onto": pytree.tree_map(_np, onto),
            "plain": pytree.tree_map(_np, plain),
            "saved": pytree.tree_map(_np, params)}


def distributed_suite(rank, world, payload, tmp):
    out = {"ef": _ef_case(rank, world, payload["ef"])}
    for name, case in payload["moe_ep"].items():
        out[f"moe_ep/{name}"] = _moe_ep_case(rank, world, case)
    trained = {}
    for name, case in payload["train"].items():
        res = _train_case(rank, world, case)
        trained[name] = (res.pop("p"), case["arch"])
        res.pop("o")
        out[f"train/{name}"] = res
    for name, case in payload["efm"].items():
        out[f"efm/{name}"] = _efm_case(rank, world, case)
    out["restore"] = _restore_case(rank, world, trained[payload["restore"]],
                                   tmp)
    return out


# ---------------------------------------------------------------------------
# test_torch_sharded_serve.py: the stream-sharded StreamServer / StreamPool
# ---------------------------------------------------------------------------


def _serve_run(payload, mesh):
    """The reference's ``TestShardedServe`` schedule: three streams on four
    slots under a ladder, two ticks, one close and one admit, a tick."""
    from repro_torch import api
    from repro_torch.core import pipeline as P
    from repro_torch.serve import ServerConfig, StreamServer

    cfg = P.EPICConfig(**payload["cfg"])
    srv = StreamServer(api.EPICCompressor(cfg, device="cpu"),
                       ServerConfig(**payload["server"]), mesh=mesh)
    chunks = {sid: [api.SensorChunk(*(_t(x) for x in c)) for c in cs]
              for sid, cs in payload["chunks"].items()}
    for sid in chunks:
        srv.admit(sid)
    for step_i in range(2):
        for sid in chunks:
            srv.submit(sid, chunks[sid][step_i])
        srv.tick()
    srv.close(1)
    srv.admit("fresh")
    srv.submit("fresh", chunks[1][0])
    srv.tick()
    return srv


def sharded_serve_suite(rank, world, payload):
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import api
    from repro_torch.core import pipeline as P
    from repro_torch.launch.mesh import make_stream_mesh
    from repro_torch.serve import ServerConfig, StreamServer

    mesh = make_stream_mesh(device="cpu")
    sharded = _serve_run(payload, mesh)
    local = _serve_run(payload, None)
    out = {"owned": [s for s in range(payload["server"]["capacity"])
                     if sharded.pool.owns(s)]}
    for sid in (0, 2, "fresh"):
        a = pytree.tree_leaves(sharded.state(sid))
        b = pytree.tree_leaves(local.state(sid))
        out[f"bitwise/{sid}"] = len(a) == len(b) and all(
            torch.equal(x, y) for x, y in zip(a, b))
        out[f"k/{sid}"] = (list(sharded.telemetry(sid).k_trajectory),
                           list(local.telemetry(sid).k_trajectory))
        out[f"export/{sid}"] = [None if x is None else _np(x)
                                for x in sharded.export(sid)]
    out["counters"] = (sharded.server_counters(), local.server_counters())
    cfg = P.EPICConfig(**payload["cfg"])
    errors = {}
    for name, kw in (("divide", dict(capacity=3, chunk_frames=8)),
                     ("tiers", dict(capacity=4, chunk_frames=8,
                                    tiers=(2, 2)))):
        try:
            StreamServer(api.EPICCompressor(cfg, device="cpu"),
                         ServerConfig(**kw), mesh=mesh)
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors

    # The sharded StreamPool: four streams, one chunk each.
    comp = api.EPICCompressor(P.EPICConfig(**payload["pool_cfg"]),
                              device="cpu")
    batch = api.SensorChunk(*(_t(x) for x in payload["pool_chunk"]))
    pool = api.StreamPool(comp, 4, mesh=mesh)
    states, stats = pool.step(pool.init(), batch)
    ref_pool = api.StreamPool(comp, 4)
    ref_states, ref_stats = ref_pool.step(ref_pool.init(), batch)
    pairs = list(zip(pytree.tree_leaves((states, stats)),
                     pytree.tree_leaves((ref_states, ref_stats))))
    out["pool_bitwise"] = all(torch.equal(a.full_tensor(), b)
                              for a, b in pairs)
    out["pool_local_rows"] = {tuple(a.to_local().shape[:1]) for a, _ in pairs}
    try:
        api.StreamPool(comp, 3, mesh=mesh)
    except ValueError as e:
        errors["pool_divide"] = str(e)
    out.update(_sharded_checkpoint(rank, payload, mesh, sharded, local))
    return out


def _sharded_checkpoint(rank, payload, mesh, sharded, local):
    """One more chunk queued on every live stream of both servers; the
    sharded server saved (every rank), once by ``save_server`` and once
    through a ``ServeCheckpointer`` (the write on rank 0's thread), and
    the mesh=None one (rank 0); the checkpointer's step restored into a
    fresh sharded server, and one tick of all three: whether the restored
    server's streams are bitwise the uninterrupted sharded run's and the
    mesh=None run's."""
    import torch
    import torch.distributed as dist
    from torch.utils import _pytree as pytree

    from repro_torch import api
    from repro_torch.core import pipeline as P
    from repro_torch.serve import ServerConfig, StreamServer
    from repro_torch.serve import checkpoint as CK

    more = {0: payload["chunks"][0][1], 2: payload["chunks"][2][1],
            "fresh": payload["chunks"][1][1]}
    for srv in (sharded, local):
        for sid, c in more.items():
            srv.submit(sid, api.SensorChunk(*(_t(x) for x in c)))
    root = payload["ckpt"]
    path = CK.save_server(os.path.join(root, "sharded"), sharded.n_ticks,
                          sharded)
    if rank == 0:
        CK.save_server(os.path.join(root, "local"), local.n_ticks, local)
    dist.barrier()
    ckpt = CK.ServeCheckpointer(os.path.join(root, "async"), sharded,
                                every_ticks=1, keep=1)
    ckpt.save_now()
    fresh = StreamServer(
        api.EPICCompressor(P.EPICConfig(**payload["cfg"]), device="cpu"),
        ServerConfig(**payload["server"]), mesh=mesh)
    restored = ckpt.restore(fresh.compressor, server=fresh).server
    for srv in (sharded, restored, local):
        srv.tick()
    out = {"ckpt_path": path}
    for sid in (0, 2, "fresh"):
        states = [pytree.tree_leaves(s.state(sid))
                  for s in (restored, sharded, local)]
        out[f"restored/{sid}"] = all(
            len(a) == len(states[0])
            and all(torch.equal(x, y) for x, y in zip(a, states[0]))
            for a in states[1:]) and len({
                tuple(s.telemetry(sid).k_trajectory)
                for s in (restored, sharded, local)}) == 1
    out["restored_counters"] = (restored.server_counters(),
                                sharded.server_counters())
    return out


# ---------------------------------------------------------------------------
# test_torch_tp_serve.py, test_torch_tp_serve_recurrent.py: tensor-parallel
# prefill and decode of the dense, RWKV6 and hybrid families
# ---------------------------------------------------------------------------


def _check_placed(tree, specs, mesh):
    """Whether each DTensor leaf is placed by its spec, its local block of
    the spec's shape."""
    from torch.utils import _pytree as pytree

    from repro_torch.launch import sharding as S

    for x, spec in zip(pytree.tree_leaves(tree), S.leaves_like(tree, specs)):
        if (tuple(x.placements) != S.to_placements(spec, mesh)
                or tuple(x.to_local().shape)
                != S.local_shape(tuple(x.shape), spec, mesh)):
            return False
    return True


def _leaf_errs(got, want):
    """Each state leaf's largest difference from ``want``'s and ``want``'s
    largest |value|; an integer leaf's difference is 0 where equal, inf
    where not."""
    out = {}
    for k, w in want.items():
        g, w = _np(got[k]), w.numpy()
        if np.issubdtype(w.dtype, np.floating):
            out[k] = (float(abs(g - w).max()), float(abs(w).max()))
        else:
            out[k] = (0.0 if np.array_equal(g, w) else float("inf"), 0.0)
    return out


def _tp_case(rank, case):
    """The family's step on ``case["mesh"]`` from the reference's
    parameters, placed by ``param_specs``: each logits' largest difference
    from ``mesh=None``'s on the same rank, the logits themselves (rank 0),
    the greedy tokens (``mesh=None``'s argmax), each step's collectives
    (``Recorder``), each state leaf's difference from ``mesh=None``'s and
    whether the caches come back as the serve specs place them.
    ``case["cfg"]`` overrides the smoke configuration in both packages,
    ``case["port"]`` in the port only; ``case["scan_backend"]`` is the
    port's scan backend."""
    import torch
    from torch.utils import _pytree as pytree

    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import sharding as S
    from repro_torch.launch.hloparse import Recorder
    from repro_torch.models import build_model
    from repro_torch.serve import efm

    mesh = _mesh(case["mesh"], ("data", "model"))
    cfg = get_smoke_config(case["arch"]).replace(
        cache_dtype="float32", **case.get("cfg", {}), **case.get("port", {}))
    cfg = cfg.replace(n_layers=case.get("n_layers", cfg.n_layers))
    model = build_model(cfg, device="cpu",
                        scan_backend=case.get("scan_backend", "chunked"))
    whole = getattr(convert, f"{cfg.family}_from_jax")(case["params"], cfg,
                                                        device="cpu")
    tokens = _t(case["tokens"])
    b, s = tokens.shape
    n = case["new"]
    prefill, pspecs = efm.jit_prefill(model, mesh,
                                      ShapeSpec("p", "prefill", s, b))
    decode, dspecs = efm.jit_decode_step(model, mesh,
                                         ShapeSpec("d", "decode", s + n, b))
    params = S.place_tree(whole, S.named(mesh, pspecs["params"]))
    plain_prefill = efm.jit_prefill(model)
    plain_decode = efm.jit_decode_step(model)

    out = {"records": [], "logits": [], "errs": [], "tokens": []}
    with S.full_tensor_refused(), Recorder() as rec:
        logits, cache = prefill(params, {"tokens": tokens})
    ref_logits, ref_cache = plain_prefill(whole, {"tokens": tokens})
    out["records"].append([tuple(r) for r in rec.records])
    prefill_specs = S.serve_specs(cfg, model.serve_spec(b, s), mesh, b)
    out["cache_placed"] = _check_placed(cache, prefill_specs, mesh)
    out["cache_errs"] = _leaf_errs(cache, ref_cache)
    out["cache_err"] = max(e for e, _ in out["cache_errs"].values())
    lg = _np(logits)
    out["logits"].append(lg)
    out["errs"].append(float(abs(lg - ref_logits.numpy()).max()))

    state = efm.pad_for_decode(model, pytree.tree_map(_full, cache), n)
    ref_state = efm.pad_for_decode(model, ref_cache, n)
    tok = tokens[:, -1:]
    for i in range(n):
        with S.full_tensor_refused(), Recorder() as rec:
            lg, state = decode(params, state, tok, s + i)
        rlg, ref_state = plain_decode(whole, ref_state, tok, s + i)
        out["records"].append([tuple(r) for r in rec.records])
        lg = _np(lg)
        out["logits"].append(lg)
        out["errs"].append(float(abs(lg - rlg.numpy()).max()))
        tok = torch.argmax(rlg[:, -1:], dim=-1).to(torch.int32)
        out["tokens"].append(tok.numpy())
    out["state_placed"] = _check_placed(state, dspecs["state"], mesh)
    out["state_errs"] = _leaf_errs(state, ref_state)
    out["state_err"] = max(e for e, _ in out["state_errs"].values())
    if rank:
        out.pop("logits")
    return out


def tp_serve_suite(rank, world, payload):
    return {name: _tp_case(rank, case) for name, case in payload.items()}
