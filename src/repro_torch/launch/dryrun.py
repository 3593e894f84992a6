"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on a fake
process group of the production mesh's size.

Port of ``repro/launch/dryrun.py``.  For each cell this:
  1. builds the FULL published config as meta tensors (no parameter is
     ever allocated);
  2. makes a ``"fake"`` process group (``torch.testing``'s ``FakeStore``)
     of 256 or 512 ranks with this process as rank 0, and a CPU
     ``DeviceMesh`` over it: (16, 16) ``("data", "model")`` or (2, 16,
     16) ``("pod", "data", "model")``;
  3. places every input as meta DTensors by the port's own specs
     (``launch/sharding.py``), each rank's block a tensor of its own;
  4. runs the entry point once (``launch.train.jit_train_step``,
     ``serve.efm.jit_prefill``, ``serve.efm.jit_decode_step``) under the
     collective :class:`~repro_torch.launch.hloparse.Recorder`,
     :class:`FlopCount` and ``MemTracker``: the counterpart of the
     reference's lower + compile, so a sharding mismatch, a collective
     that does not compose or a shape error fails HERE;
  5. writes one JSONL record per cell.

A record holds the reference's keys where a counterpart exists: ``arch``,
``shape``, ``mesh``, ``ok``, ``overrides``, ``skipped``;
``param_bytes_per_device``, ``param_count``, ``opt_bytes_per_device``
(train), ``cache_bytes_per_device`` (decode), from the specs alone
(:func:`cell_bytes`); ``argument_size_in_bytes`` and
``output_size_in_bytes``, this rank's bytes of the placed inputs and of
the outputs; ``temp_size_in_bytes``, ``MemTracker``'s peak less the
arguments; ``flops``, ``FlopCounterMode``'s formulas' count on this
rank (:class:`FlopCount`);
``collectives``, :func:`~repro_torch.launch.hloparse.analyze_records`
of this rank's collectives.  ``lower_s``/``compile_s`` are one
``trace_s``; ``generated_code_size_in_bytes`` and ``bytes_accessed``
have no counterpart (no program is compiled).  ``peak_bytes`` and
``fits`` hold the peak against the H100's 80 GB (``mesh.HBM_BYTES``).

The port runs each rank's share of the work on plain tensors, every
weight gathered whole (``launch/train.py``), so the figures are the
port's plan, not XLA's.  A process that already holds a process group
is refused: it has room for one default group, and the dry-run's must be
the fake one.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all [--skip-existing] [--opt]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config, get_shapes
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as S
from repro_torch.launch.hloparse import Recorder, analyze_records
from repro_torch.models import build_model

RESULTS = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "build", "dryrun"
)

# The optimized recipes per (arch x shape kind): the port's copy of the
# reference's ``benchmarks/opt_config.OPT_OVERRIDES`` (``--opt``).
_DENSE_TRAIN = dict(
    shard_strategy="dp", attn_backend="chunked", remat_policy="full"
)
_DENSE_PREFILL = dict(shard_strategy="dp", attn_backend="chunked")
OPT_OVERRIDES = {
    "olmo-1b": {"train": _DENSE_TRAIN, "prefill": _DENSE_PREFILL},
    "tinyllama-1.1b": {"train": _DENSE_TRAIN, "prefill": _DENSE_PREFILL},
    "qwen2.5-3b": {"train": _DENSE_TRAIN, "prefill": _DENSE_PREFILL},
    "phi4-mini-3.8b": {"train": _DENSE_TRAIN, "prefill": _DENSE_PREFILL},
    "deepseek-v2-lite-16b": {
        "train": dict(moe_impl="ep", attn_backend="chunked",
                      remat_policy="full", moe_capacity_factor=1.0,
                      shard_strategy="fsdp"),
        "prefill": dict(moe_impl="ep", attn_backend="chunked"),
    },
    "deepseek-v3-671b": {
        "train": dict(moe_impl="ep", shard_strategy="fsdp",
                      attn_backend="chunked", remat_policy="full",
                      moe_capacity_factor=1.0, moe_a2a_quant=True),
        "prefill": dict(moe_impl="ep", attn_backend="chunked",
                        moe_capacity_factor=1.0, moe_a2a_quant=True),
    },
    "rwkv6-3b": {
        "train": dict(shard_strategy="dp", remat_policy="full"),
        "prefill": dict(shard_strategy="dp"),
    },
    "zamba2-2.7b": {
        "train": dict(shard_strategy="dp", attn_backend="chunked",
                      remat_policy="full"),
        "prefill": dict(shard_strategy="dp", attn_backend="chunked"),
    },
    "llama-3.2-vision-11b": {
        "train": dict(attn_backend="chunked", remat_policy="full"),
        "prefill": dict(attn_backend="chunked"),
    },
    "seamless-m4t-large-v2": {
        "train": dict(shard_strategy="dp", attn_backend="chunked",
                      remat_policy="full"),
        "prefill": dict(shard_strategy="dp", attn_backend="chunked"),
    },
}


def overrides_for(arch: str, kind: str) -> dict:
    return OPT_OVERRIDES.get(arch, {}).get(kind, {})


def sharded_bytes(tree: Any, specs: Any, mesh) -> int:
    """Exact per-device resident bytes for a spec'd tree (``specs`` a
    :class:`~repro_torch.launch.sharding.P` tree; ``mesh`` a
    ``DeviceMesh`` or ``launch.mesh.AbstractMesh``)."""
    sizes = M.mesh_shape(mesh)
    total = 0
    for leaf, spec in zip(pytree.tree_leaves(tree),
                          S.leaves_like(tree, specs)):
        denom = 1
        for entry in spec:
            for a in S.spec_axes(entry):
                denom *= sizes[a]
        total += leaf.numel() * leaf.element_size() // denom
    return total


def _mesh_layout(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _cell(arch: str, shape_name: str, overrides: Optional[Dict[str, Any]]):
    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = next(s for s in get_shapes(arch) if s.name == shape_name)
    return cfg, shape


def _moments(pshape, cfg):
    from repro_torch.launch import train as TR
    from repro_torch.optim import adamw

    return TR.cast_moments(adamw.init(pshape), _moment_dtype(cfg))


def _moment_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.opt_moment_dtype)


def cell_bytes(arch: str, shape_name: str, multi_pod: bool,
               overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The cell's spec'd byte counts, from the specs alone (no process
    group): ``{"skipped": reason}`` for a shape the reference skips, else
    ``param_bytes_per_device``, ``param_count`` and
    ``opt_bytes_per_device`` (train) or ``cache_bytes_per_device``
    (decode), on the production mesh's shape."""
    cfg, shape = _cell(arch, shape_name, overrides)
    if shape.skip:
        return {"skipped": shape.skip}
    mesh = M.AbstractMesh(*_mesh_layout(multi_pod))
    model = build_model(cfg, device="meta")
    pshape = model.param_spec()
    aux: Dict[str, Any] = {
        "param_bytes_per_device": sharded_bytes(
            pshape, S.param_specs(cfg, pshape, mesh), mesh),
        "param_count": sum(x.numel() for x in pytree.tree_leaves(pshape)),
    }
    if shape.kind == "train":
        aux["opt_bytes_per_device"] = sharded_bytes(
            _moments(pshape, cfg), S.opt_specs(cfg, pshape, mesh), mesh)
    elif shape.kind == "decode":
        b = shape.global_batch
        sshape = model.serve_spec(b, shape.seq_len)
        aux["cache_bytes_per_device"] = sharded_bytes(
            sshape, S.serve_specs(cfg, sshape, mesh, b), mesh)
    return aux


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A ``"fake"`` process group of ``n_ranks`` ranks for the ``with``
    block, this process its rank 0 (collectives return at once and move
    nothing).  A process that already holds a default group raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            f"this process already holds a {dist.get_backend()!r} process "
            f"group of {dist.get_world_size()} ranks; the dry-run makes a "
            f"fake group of its own: run it in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()
        M._GROUPS.clear()  # their groups died with the world


def production_mesh(multi_pod: bool):
    """The production ``DeviceMesh`` over the fake world's CPU ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = _mesh_layout(multi_pod)
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def _placed(tree: Any, shardings: Any) -> Any:
    """Meta DTensors of ``tree``'s shapes placed by ``shardings`` (a
    ``NamedSharding`` tree), each rank's block a meta tensor of its own."""
    from torch.distributed.tensor import DTensor

    def one(x, s):
        local = torch.empty(S.local_shape(tuple(x.shape), s.spec, s.mesh),
                            dtype=x.dtype, device="meta")
        return DTensor.from_local(local, s.mesh, s.placements,
                                  run_check=False, shape=x.shape,
                                  stride=S._contiguous(x.shape))

    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(
        [one(x, s) for x, s in zip(leaves, S.leaves_like(tree, shardings))],
        spec)


def _local(x):
    from torch.distributed.tensor import DTensor

    return x._local_tensor if isinstance(x, DTensor) else x


def local_bytes(tree: Any) -> int:
    """This rank's bytes of a tree's tensors (a DTensor's local block)."""
    return sum(_local(x).numel() * _local(x).element_size()
               for x in pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


class Lowered(NamedTuple):
    """An entry point and its placed meta inputs."""

    fn: Any
    args: Tuple[Any, ...]


def lower(model, shape, mesh) -> Lowered:
    """``model``'s entry point for ``shape`` (a ``ShapeSpec``) on
    ``mesh``, with its inputs placed as meta DTensors by the specs the
    entry point gives."""
    cfg = model.cfg
    pshape = model.param_spec()
    if shape.kind == "train":
        from repro_torch.launch import train as TR
        from repro_torch.optim.adamw import AdamWConfig

        fn, specs = TR.jit_train_step(
            model, mesh, AdamWConfig(), shape_spec=shape,
            moment_dtype=_moment_dtype(cfg), accum=cfg.train_accum)
        return Lowered(fn, (
            _placed(pshape, S.named(mesh, specs["params"])),
            _placed(_moments(pshape, cfg), S.named(mesh, specs["opt"])),
            _placed(model.batch_spec(shape), S.named(mesh, specs["batch"])),
            0))
    from repro_torch.serve import efm

    if shape.kind == "prefill":
        fn, specs = efm.jit_prefill(model, mesh, shape)
        return Lowered(fn, (
            _placed(pshape, S.named(mesh, specs["params"])),
            _placed(model.batch_spec(shape), S.named(mesh, specs["batch"]))))
    b = shape.global_batch
    fn, specs = efm.jit_decode_step(model, mesh, shape)
    return Lowered(fn, (
        _placed(pshape, S.named(mesh, specs["params"])),
        _placed(model.serve_spec(b, shape.seq_len),
                S.named(mesh, specs["state"])),
        _placed(model.token_spec(b), S.NamedSharding(mesh, specs["token"])),
        shape.seq_len - 1))


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               overrides: Optional[Dict[str, Any]] = None):
    """Returns ``(Lowered or None, aux dict with spec'd byte counts)``.
    Runs inside :func:`fake_world` of the mesh's size."""
    aux = cell_bytes(arch, shape_name, multi_pod, overrides)
    if "skipped" in aux:
        return None, aux
    cfg, shape = _cell(arch, shape_name, overrides)
    lowered = lower(build_model(cfg, device="meta"), shape,
                    production_mesh(multi_pod))
    aux["argument_size_in_bytes"] = local_bytes(lowered.args)
    return lowered, aux


class FlopCount(TorchDispatchMode):
    """``FlopCounterMode``'s count, by its formula for each op that has
    one, without its search of every other op for a decomposition that
    holds a product: under a dispatch mode the composite ops (``linear``,
    ``einsum``, ``matmul``) arrive decomposed already, and the search
    doubled the host time of a meta prefill (RWKV6-3B's smoke
    configuration at prefill_32k: 14.4 s against 7.2, and 26.9 against
    20.5 beside the recorder and ``MemTracker``).  DTensor calls pass
    through to DTensor, whose local calls are then counted."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def trace(lowered: Lowered) -> Dict[str, Any]:
    """Run the entry point once on its meta inputs; its per-device
    figures and this rank's collective records."""
    from torch.distributed._tools.mem_tracker import MemTracker

    flops = FlopCount()
    mem = MemTracker()
    mem.track_external(*[_local(x) for x in pytree.tree_leaves(lowered.args)
                         if isinstance(x, torch.Tensor)])
    rec = Recorder()
    with flops, mem, rec:
        out = lowered.fn(*lowered.args)
    peak = max(snap["Total"] for snap in
               mem.get_tracker_snapshot("peak").values())
    return {"out": out, "records": rec.records, "peak": int(peak),
            "flops": int(flops.total)}


def run_cell(
    arch: str, shape_name: str, multi_pod: bool, *, verbose: bool = True,
    overrides: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    rec: Dict[str, Any] = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "ok": False,
    }
    if overrides:
        rec["overrides"] = overrides
    t0 = time.time()
    skip = _cell(arch, shape_name, overrides)[1].skip
    if skip:
        rec.update(ok=True, skipped=skip)
        return rec
    shape, _ = _mesh_layout(multi_pod)
    with fake_world(math.prod(shape)):  # refuses a process holding a group
        try:
            lowered, aux = lower_cell(arch, shape_name, multi_pod, overrides)
            rec.update(aux)
            got = trace(lowered)
            rec["trace_s"] = round(time.time() - t0, 2)
            args = rec["argument_size_in_bytes"]
            rec["output_size_in_bytes"] = local_bytes(got["out"])
            rec["temp_size_in_bytes"] = got["peak"] - args
            rec["peak_bytes"] = got["peak"]
            rec["fits"] = got["peak"] <= M.HBM_BYTES
            rec["flops"] = float(got["flops"])
            rec["collectives"] = analyze_records(got["records"])
            rec["ok"] = True
            if verbose:
                print(
                    f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
                    f"(trace {rec['trace_s']}s, flops={rec['flops']:.3e}, "
                    f"coll={rec['collectives']['total_bytes']:.3e}B "
                    f"wire={rec['collectives']['wire_bytes']:.3e}B, "
                    f"peak={got['peak'] / 1e9:.2f}GB "
                    f"{'fits' if rec['fits'] else 'DOES NOT FIT'})"
                )
        except Exception as e:  # noqa: BLE001 — record and continue
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
            if verbose:
                print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
                      f"FAIL {e}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the optimized recipes (OPT_OVERRIDES)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    out_path = args.out or os.path.join(
        os.path.abspath(RESULTS),
        "dryrun_opt.jsonl" if args.opt else "dryrun.jsonl",
    )
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)

    done = set()
    if args.skip_existing and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass

    cells = []
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    for arch in archs:
        for shape in get_shapes(arch):
            if args.shape and shape.name != args.shape:
                continue
            for mp in (False, True):
                if args.mesh == "pod" and mp:
                    continue
                if args.mesh == "multipod" and not mp:
                    continue
                cells.append((arch, shape.name, shape.kind, mp))

    n_fail = 0
    with open(out_path, "a") as f:
        for arch, shape_name, kind, mp in cells:
            mesh_name = "2x16x16" if mp else "16x16"
            if (arch, shape_name, mesh_name) in done:
                continue
            ov = overrides_for(arch, kind) if args.opt else None
            rec = run_cell(arch, shape_name, mp, overrides=ov)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            if not rec["ok"]:
                n_fail += 1
    print(f"[dryrun] finished; {n_fail} failures -> {out_path}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
