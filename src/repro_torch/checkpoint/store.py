"""Atomic, sharded checkpoints (port of ``repro.checkpoint.store``; a
directory written by either package is read by the other to the same
arrays, bitwise).

Layout: ``<dir>/step_<n>/`` holding ``shard_<i>.npz`` files plus
``manifest.json`` (leaf key -> shard and array name, dtype name, step).
Writes go to ``step_<n>.tmp`` and are renamed only after the manifest is
fsynced — a crashed save can never shadow the previous good step
(restore scans for the newest *complete* directory, identified by the
manifest written last).

A sharded tree (DTensor leaves, one process per device) is gathered
whole on every rank and written once, by rank 0, the others waiting at a
barrier; so it restores onto any mesh, or none, as the reference's does.
``restore(..., shardings=)`` places the leaves onto target
``NamedSharding``s (``launch/sharding.py``); a DTensor leaf of ``like``
comes back placed as it is.

Leaves are saved as full arrays under the reference's keys: the
``jax.tree_util.keystr`` of each path entry joined by ``/`` — ``['k']``
for a dict key (dicts flatten in sorted key order, as in JAX), ``[0]``
for a list or tuple index, ``.field`` for a NamedTuple attribute; ``None``
is an empty subtree, not a leaf.  bfloat16 is stored as its ``uint16``
bits with dtype name ``bfloat16``; a Python scalar leaf round-trips
through ``.item()``.

:class:`AsyncSaver` snapshots to host memory (card tensors through
pinned buffers, one host sync for the whole tree) and writes in a
daemon thread, so the caller never blocks on disk.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"

# Errors that mean "this step directory is damaged or vanished" rather
# than "the caller asked for something impossible": a concurrent gc_old
# deleted the directory between selection and open (FileNotFoundError),
# a crash truncated a shard (zipfile/OSError) or the manifest (the json
# decode error is a ValueError subclass), or a shard lost a leaf
# (KeyError).  ``restore(step=None)`` falls back to the next-newest
# complete step on any of these.
_DAMAGED_STEP_ERRORS = (OSError, KeyError, ValueError, zipfile.BadZipFile)

_TORCH_DTYPES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """``[(key string, child), ...]`` of a container, ``None`` for a
    leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    return None


def _flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out.extend(
            _flatten_with_paths(child, f"{prefix}/{key}" if prefix else key)
        )
    return out


def _unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        # Sorted order is the order the leaves were flattened in.
        rebuilt = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: rebuilt[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(x, leaves) for x in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host leaf as ``(array to store, dtype name)``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind == "V":  # a named numpy extension dtype (bfloat16)
        name = arr.dtype.name
        arr = arr.view(np.uint16 if arr.dtype.itemsize == 2 else np.uint8)
    return arr, name


def _is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sharded(tree: Any) -> bool:
    return any(_is_dtensor(x) for _, x in _flatten_with_paths(tree))


def _writer() -> bool:
    """Whether this process writes a sharded tree's files (rank 0)."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def save(
    directory: str,
    step: int,
    tree: Any,
    *,
    n_shards: int = 4,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Atomic synchronous save. Returns the final step directory.

    A sharded tree is gathered whole on every rank (a collective call),
    written by rank 0 and waited for at a barrier by every rank."""
    final = os.path.join(directory, f"step_{step:08d}")
    if _sharded(tree):
        tree = host_snapshot(tree)
        if _writer():
            _write(directory, step, tree, n_shards, extra_meta)
        _barrier()
        return final
    return _write(directory, step, tree, n_shards, extra_meta)


def _write(directory: str, step: int, tree: Any, n_shards: int,
           extra_meta: Optional[Dict[str, Any]]) -> str:
    flat = _flatten_with_paths(tree)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    # A crashed save leaves its ``step_*.tmp`` behind (the rename never
    # ran); clean *all* stale tmp dirs here, not just this step's.
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(
                    os.path.join(directory, name), ignore_errors=True
                )
    os.makedirs(tmp, exist_ok=True)

    shards: List[Dict[str, np.ndarray]] = [dict() for _ in range(n_shards)]
    mapping = {}
    for i, (key, leaf) in enumerate(flat):
        si = i % n_shards
        arr, dtype_name = _to_numpy(leaf)
        shards[si][f"arr_{i}"] = arr
        mapping[key] = {"shard": si, "name": f"arr_{i}", "dtype": dtype_name}
    for si, shard in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{si}.npz"), **shard)
    manifest = {
        "step": step,
        "n_shards": n_shards,
        "leaves": mapping,
        "time": time.time(),
        **(extra_meta or {}),
    }
    # manifest last: its presence marks the checkpoint complete
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def host_snapshot(tree: Any) -> Any:
    """A host copy of every leaf of ``tree``, consistent at the call:
    card tensors go through pinned buffers with one host sync for the
    whole tree, CPU tensors and arrays are copied (a later in-place write
    to the live tree cannot reach the snapshot), scalars kept.  DTensor
    leaves are gathered whole first (a collective call on every rank)."""
    leaves = [leaf for _, leaf in _flatten_with_paths(tree)]
    out, on_card = [], []
    for x in leaves:
        if _is_dtensor(x):
            x = x.full_tensor()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cpu":
                out.append(x.detach().clone())
            else:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x.detach(), non_blocking=True)
                out.append(h)
                on_card.append(x.device)
        elif isinstance(x, np.ndarray):
            out.append(x.copy())
        else:
            out.append(x)
    for dev in set(on_card):
        torch.cuda.synchronize(dev)
    return _unflatten(tree, iter(out))


class AsyncSaver:
    """Snapshot-to-host then write-in-background; at most one in flight.

    A write failure in the background thread (disk full, permissions,
    a vanished directory) is re-raised on the next :meth:`save` or
    :meth:`wait` — a checkpoint loop never silently stops persisting.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._barrier = False
        self.last_path: Optional[str] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:  # a sharded save: every rank waits for rank 0
            self._barrier = False
            _barrier()
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def save(self, directory: str, step: int, tree: Any, **kw):
        """Snapshot ``tree`` to the host now; write it in the background.
        A sharded tree is gathered on every rank and written by rank 0;
        :meth:`wait` holds every rank until it is written."""
        self.wait()
        sharded = _sharded(tree)
        snapshot = host_snapshot(tree)
        if sharded:
            self._barrier = True
            if not _writer():
                return
        self.save_host(directory, step, snapshot, **kw)

    def save_host(self, directory: str, step: int, host_tree: Any, **kw):
        """Write a host tree the caller has already taken (with
        :func:`host_snapshot`, e.g. under a lock that keeps it consistent
        with host bookkeeping) in the background."""
        self.wait()

        def _run():
            try:
                self.last_path = save(directory, step, host_tree, **kw)
            except BaseException as e:  # surfaced on next save()/wait()
                self._exc = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()


def complete_steps(directory: str) -> List[int]:
    """All complete checkpoint steps in ``directory``, ascending
    (complete = the manifest, written last, is present)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if not os.path.exists(os.path.join(directory, name, MANIFEST)):
            continue  # incomplete (crashed mid-save)
        try:
            steps.append(int(name[len("step_"):]))
        except ValueError:
            continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """Newest COMPLETE checkpoint step in ``directory`` (manifest present)."""
    steps = complete_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> Dict[str, Any]:
    """The manifest of one step (includes any ``extra_meta`` the save
    attached — e.g. the serve layer's session metadata)."""
    path = os.path.join(directory, f"step_{step:08d}", MANIFEST)
    with open(path) as f:
        return json.load(f)


class LeafSpec:
    """A leaf of a ``like`` tree given by shape and dtype alone (the
    counterpart of ``jax.ShapeDtypeStruct``): restored as a tensor on
    ``device`` (``None``: the CPU)."""

    def __init__(self, shape, dtype: torch.dtype, device=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.device = torch.device("cpu") if device is None else device


def restore(
    directory: str,
    like: Any,
    *,
    step: Optional[int] = None,
    device=None,
    shardings: Any = None,
) -> Tuple[Any, int]:
    """Load into the structure of ``like``.

    A tensor or :class:`LeafSpec` leaf of ``like`` comes back as a tensor
    on ``device`` (``None``: that leaf's own device), a numpy leaf as a
    numpy array (a bfloat16 one as a CPU tensor), a Python scalar as a
    Python scalar.  ``shardings`` (a ``NamedSharding`` tree like ``like``,
    or one for every tensor leaf) places each tensor leaf onto its
    mesh: every rank keeps its block of the whole array it read.  A
    DTensor leaf of ``like`` comes back placed as it is.

    With ``step=None`` the newest complete checkpoint is resolved
    *once* and loaded; if it turns out damaged (a shard truncated or
    deleted by a crashed writer, the whole directory deleted by a
    concurrent :func:`gc_old`) the restore falls back to the
    next-newest complete step rather than failing on debris.  An
    explicit ``step`` never falls back.
    """
    def load(s):
        if shardings is None:
            return _load_step(directory, s, like, device)
        return _load_step(directory, s, like, device, shardings)

    if step is not None:
        return load(step), step
    steps = complete_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint in {directory}")
    last_err: Optional[BaseException] = None
    for s in reversed(steps):
        try:
            return load(s), s
        except _DAMAGED_STEP_ERRORS as e:
            last_err = e
    raise last_err  # every complete-looking step failed to load


def _as_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    want = _TORCH_DTYPES.get(dtype_name)
    if want is None:
        raise ValueError(f"dtype {dtype_name!r} has no torch counterpart")
    return torch.from_numpy(arr).to(want)


def _targets(like: Any, shardings: Any) -> List[Any]:
    """One target ``NamedSharding`` (or ``None``) per leaf of ``like``."""
    from repro_torch.launch.sharding import NamedSharding

    n = len(_flatten_with_paths(like))
    if shardings is None:
        return [None] * n
    if isinstance(shardings, NamedSharding):
        return [shardings] * n
    return [s for _, s in _flatten_with_paths(shardings)]


def _place(t: torch.Tensor, leaf: Any, target: Any) -> torch.Tensor:
    """The whole array ``t`` as a DTensor: on ``target``, or (``None``)
    placed as the DTensor ``leaf`` of ``like`` is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import local_block

    if target is None:
        mesh, placements = leaf.device_mesh, tuple(leaf.placements)
    else:
        mesh, placements = target.mesh, target.placements
    t = t.to(mesh.device_type)
    return DTensor.from_local(
        local_block(t, mesh, placements).contiguous(), mesh, placements,
        run_check=False, shape=t.shape, stride=t.stride())


def _load_step(directory: str, step: int, like: Any, device,
               shardings: Any = None) -> Any:
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    files = {
        si: np.load(os.path.join(d, f"shard_{si}.npz"))
        for si in range(manifest["n_shards"])
    }
    targets = _targets(like, shardings)
    leaves = []
    for (key, leaf), target in zip(_flatten_with_paths(like), targets):
        ent = manifest["leaves"].get(key)
        if ent is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = files[ent["shard"]][ent["name"]]
        want_shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"shape mismatch for {key}: ckpt {arr.shape} vs {want_shape}"
            )
        if isinstance(leaf, (torch.Tensor, LeafSpec)) or (
            ent["dtype"] == "bfloat16"  # numpy has no bfloat16 of its own
        ):
            t = _as_tensor(arr, ent["dtype"])
            if target is not None or _is_dtensor(leaf):
                leaves.append(_place(t, leaf, target))
                continue
            home = getattr(leaf, "device", torch.device("cpu"))
            leaves.append(t.to(home if device is None else device))
        elif not hasattr(leaf, "shape"):  # python scalar leaf round-trips
            leaves.append(arr.item() if arr.ndim == 0 else arr)
        else:
            leaves.append(arr)
    return _unflatten(like, iter(leaves))


def gc_old(directory: str, keep: int = 3):
    """Delete all but the newest ``keep`` complete checkpoints.

    Tolerates a step vanishing mid-delete: deletion is best-effort, and a
    concurrent ``restore(step=None)`` that loses the race to a deleted
    directory falls back to the next-newest step on its own.
    """
    for s in complete_steps(directory)[:-keep]:
        shutil.rmtree(
            os.path.join(directory, f"step_{s:08d}"), ignore_errors=True
        )
