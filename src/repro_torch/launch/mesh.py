"""Device meshes over ``torch.distributed`` ranks, and the H100's figures.

Port of ``repro/launch/mesh.py``.  One process per device (SPMD, as
``torchrun`` starts it): a ``torch.distributed.device_mesh.DeviceMesh``
stands in for ``jax.sharding.Mesh``, with the same axis names.

Mesh topology, as the reference's:
  single-pod: (16, 16)    axes ("data", "model")
  multi-pod : (2, 16, 16) axes ("pod", "data", "model")

``make_production_mesh`` is a function, so importing this module touches
no process group.  :class:`AbstractMesh` carries a shape and axis names
only: the sharding rules (``launch/sharding.py``) read nothing else, so
specs for a production mesh are computed without its ranks.

The ambient mesh is the counterpart of the reference's ``with mesh:``:
:func:`use_mesh` makes a mesh current for the process, and
``models.layers.ambient_mesh_axes`` and ``models.moe.moe_ffn_ep`` read it
(:func:`current`).  It also records which mesh axes split the batch rows
of the tensors the model code sees on this rank (``batch_axes``), since
each rank runs the family's code on its own rows, and, for the dense
family's serving steps, the :class:`TensorParallel` plan by which the
layers compute on each rank's parameter blocks (``tp``).

A process group whose backend does not match the device raises: NCCL for
the card, gloo for ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import (Any, Dict, FrozenSet, Iterator, NamedTuple, Optional,
                    Tuple)

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import resolve_device

# --- NVIDIA H100 SXM5 80GB, datasheet figures ---------------------------
# The card these figures describe, as ``nvidia-smi --query-gpu=name,
# power.limit --format=csv,noheader`` names it at its full power limit.
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense tensor-core bf16
HBM_BW = 3.35e12  # B/s, HBM3
NVLINK_BW = 450e9  # B/s each way (NVLink 4, 18 links)
HBM_BYTES = 80e9  # bytes

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


class AbstractMesh:
    """A mesh's shape and axis names, without ranks: what the sharding
    rules read (``mesh.shape[name]``, ``mesh.axis_names``)."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} and axis names {axis_names} "
                             f"differ in length")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_axes(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, major first."""
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names or ())
    return tuple(mesh.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`AbstractMesh`."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh_axes(mesh), mesh.shape))
    return dict(mesh.shape)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes: ('pod','data') when multi-pod else ('data',)."""
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def _backend_for(device: torch.device) -> str:
    want = _BACKEND.get(device.type)
    if want is None:
        raise ValueError(f"no process-group backend for device {device}")
    return want


def ensure_group(device=None) -> torch.device:
    """The default process group, checked against ``device`` (default: the
    card).  With none initialised, one is made here (NCCL on the card,
    gloo on the CPU): from ``torchrun``'s environment when it names a
    world of several ranks, else a one-rank group on an in-process store.
    A group whose backend does not serve the device raises."""
    device = resolve_device(device)
    want = _backend_for(device)
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:  # torchrun's env
            dist.init_process_group(want)
        else:
            dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                    world_size=1)
    have = str(dist.get_backend())
    if want not in have:
        raise RuntimeError(
            f"the default process group's backend is {have!r}, which does "
            f"not serve {device.type} tensors (needs {want!r})")
    return device


def _mesh(device: torch.device, shape: Tuple[int, ...],
          names: Tuple[str, ...]) -> DeviceMesh:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return init_device_mesh(device.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16) with ``"pod"`` in
    front; the world must hold exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    device = ensure_group(device)
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(
            f"the production mesh {shape} needs {n} ranks; this world has "
            f"{dist.get_world_size()}")
    return _mesh(device, shape, axes)


def make_host_mesh(model_axis: int = 1, device=None) -> DeviceMesh:
    """``("data", "model")`` over every rank of the world (a one-rank
    world on one device when no group is initialised)."""
    device = ensure_group(device)
    n = dist.get_world_size()
    if model_axis < 1 or n % model_axis != 0:
        raise ValueError(f"model axis {model_axis} does not divide evenly "
                         f"into {n} ranks")
    return _mesh(device, (n // model_axis, model_axis), ("data", "model"))


def make_stream_mesh(n_devices: int = 0, device=None) -> DeviceMesh:
    """1-D mesh over the ``streams`` axis for sharded serving (``StreamPool``,
    ``SlottedPool``, ``StreamServer``).

    ``n_devices=0`` uses every rank; a one-rank mesh is valid and its pool
    is bit-identical to the unsharded one, so the same serving code runs
    from one card to many."""
    device = ensure_group(device)
    world = dist.get_world_size()
    n = n_devices or world
    if not 0 < n <= world:
        raise ValueError(f"a stream mesh of {n} ranks in a world of {world}")
    if n == world:
        return _mesh(device, (n,), ("streams",))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return DeviceMesh(device.type, torch.arange(n),
                      mesh_dim_names=("streams",))


# ---------------------------------------------------------------------------
# Groups over one or several mesh axes
# ---------------------------------------------------------------------------

# Keyed by the mesh's layout and the axes, so equal meshes share groups
# and every rank makes the same ``new_group`` calls in the same order.
_GROUPS: Dict[Tuple, object] = {}


def axis_group(mesh: DeviceMesh, names: Tuple[str, ...]):
    """The process group over mesh axes ``names`` (major first) that holds
    this rank; its group ranks run row-major over those axes, as a JAX
    collective over a tuple of axis names counts them.  Groups over
    several axes are made once per mesh, by every rank (each
    ``new_group`` is a collective call)."""
    axes = mesh_axes(mesh)
    names = tuple(n for n in axes if n in names)
    if len(names) == 1:
        return mesh.get_group(names[0])
    key = (tuple(mesh.mesh.flatten().tolist()), tuple(mesh.mesh.shape),
           axes, names)
    group = _GROUPS.get(key)
    if group is None:
        ranks = mesh.mesh
        keep = [axes.index(n) for n in names]
        rest = [i for i in range(len(axes)) if i not in keep]
        grid = ranks.permute(*rest, *keep).reshape(-1, math.prod(
            ranks.shape[i] for i in keep))
        me = dist.get_rank()
        for row in grid.tolist():
            g = dist.new_group(row)
            if me in row:
                group = g
        _GROUPS[key] = group
    return group


def axis_index(mesh: DeviceMesh, names: Tuple[str, ...]) -> int:
    """This rank's index along mesh axes ``names``, row-major (major first)."""
    idx = 0
    shape = mesh_shape(mesh)
    for n in mesh_axes(mesh):
        if n in names:
            idx = idx * shape[n] + mesh.get_local_rank(n)
    return idx


def axes_size(mesh, names) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[n] for n in names if n in shape)


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------


class TensorParallel(NamedTuple):
    """Tensor parallelism over the mesh's ``"model"`` axis, as the serving
    steps of the dense, RWKV6 and hybrid families run it
    (``serve/efm.py``): each rank holds the blocks its parameters' specs
    give it and computes on them, and the layers (``models/layers.py``,
    ``models/rwkv6.py``, ``models/mamba2.py``) issue the collectives over
    ``group``."""

    group: Any  # the process group over "model"
    size: int  # ranks on "model"
    rank: int  # this rank's index on "model"
    # The parameter owners whose block on this rank is a shard over
    # "model" (``launch.sharding.model_sharded``: "wq", "tm/wk", "embed",
    # ...); the others are whole.
    sharded: FrozenSet[str]
    # Whether the serve cache is split over its sequence on "model" (the
    # flash-decoding layout) rather than over its kv heads or not at all.
    cache_seq: bool
    # The serve-state leaves ("wkv", "ssm", "conv", "shift_tm", ...) whose
    # block on this rank is split over "model" beside its rows; the others
    # are whole on every rank of the axis.
    state: FrozenSet[str] = frozenset()


def tensor_parallel(mesh: DeviceMesh, sharded, cache_seq: bool = False,
                    state=()) -> TensorParallel:
    """The :class:`TensorParallel` of this rank on ``mesh``'s ``"model"``
    axis (a mesh without one is a model axis of 1)."""
    if "model" not in mesh_axes(mesh):
        return TensorParallel(None, 1, 0, frozenset(sharded), cache_seq,
                              frozenset(state))
    return TensorParallel(axis_group(mesh, ("model",)),
                          mesh_shape(mesh)["model"],
                          mesh.get_local_rank("model"), frozenset(sharded),
                          cache_seq, frozenset(state))


class Ambient(NamedTuple):
    mesh: DeviceMesh
    # Mesh axes that split the batch rows of the activations the model
    # code sees on this rank (major first); () when every rank sees the
    # whole batch.
    batch_axes: Tuple[str, ...]
    # Set when the model code runs on each rank's parameter blocks (the
    # tensor-parallel serving steps); None when every weight is whole.
    tp: Optional[TensorParallel] = None


# Process-wide, not per thread: autograd runs a card's backward (and the
# recomputation of a checkpointed layer, ``moe_ffn_ep`` in it) on a
# thread of its own, which must see the mesh the forward saw.
_STACK: list = []


def current() -> Optional[Ambient]:
    """The innermost :func:`use_mesh`, or ``None``."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh, batch_axes: Tuple[str, ...] = (),
             tp: Optional[TensorParallel] = None) -> Iterator[DeviceMesh]:
    """Make ``mesh`` the ambient mesh (the reference's ``with mesh:``);
    with ``tp`` the model code runs tensor-parallel on it."""
    _STACK.append(Ambient(mesh, tuple(batch_axes or ()), tp))
    try:
        yield mesh
    finally:
        _STACK.pop()
