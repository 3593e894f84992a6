"""Logical-axis sharding rules for every family (port of
``repro/launch/sharding.py``), and their DTensor placements.

The rules are the reference's, spec for spec:

  params
    * embedding table (V, D)          -> vocab over "model"
    * column-parallel projections     -> output dim over "model"
      (wq/wk/wv/wg/wr, gate/up, wq_b/wk_b/wv_b, in_proj, lm_head)
      ... except K/V projections when n_kv_heads % model != 0, which stay
      replicated.
    * row-parallel projections        -> input dim over "model"
      (wo, down, out_proj, out)
    * MoE expert stacks (L, E, D, F)  -> E over "model" (EP), or over
      ("data", "model") when cfg.ep_axes == "dp_model".
    * everything else (norms, biases, LoRA/router/conv, rwkv mixing
      vectors) -> replicated.
    ``shard_strategy="dp"`` replicates every weight; ``"fsdp"`` shards the
    largest dim over ("data", "model") where it divides.
  optimizer moments (ZeRO-1)
    * the param spec plus "data" on the largest still-unsharded dim that
      divides.
  batches   -> batch dim over all DP axes ("pod", "data").
  KV caches -> kv-head dim over "model" when divisible, else cache seq
               over "model"; batch over "data" when divisible.

Stack prefixes: layer-stacked params carry a leading (L,) (the vision
self-layers (G, P)), which the rules skip.

A spec is a :class:`P`: a tuple with one entry per tensor dim, ``None``,
a mesh axis name or a tuple of names (a 1-tuple is the bare name, as
JAX's ``PartitionSpec`` normalises it).  :func:`to_placements` turns it
into DTensor placements on a ``DeviceMesh``: ``Shard(d)`` on every mesh
dim named in entry ``d`` (several names shard dim ``d`` major axis
first, XLA's row-major tiling), ``Replicate()`` on the others.

Trees are walked with ``torch.utils._pytree``; paths print as the
reference's ``"layers/attn/wq/w"``.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Any, Iterator, Optional, Tuple

from torch.distributed.tensor import Replicate, Shard
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.mesh import mesh_axes, mesh_shape

COL_NAMES = {
    "wq", "wk", "wv", "wg", "wr", "gate", "up", "wq_b", "wk_b", "wv_b",
    "in_proj", "lm_head",
}
ROW_NAMES = {"wo", "down", "out_proj", "out"}
EXPERT_NAMES = {"gate_w", "up_w", "down_w"}
STACK1 = (
    "layers", "moe_layers", "dense_layers", "enc_layers", "dec_layers",
    "xattn_layers", "shared",
)


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class P(tuple):
    """A partition spec: ``P("model", None)``, ``P(None, ("data", "model"))``.
    A leaf of ``torch.utils._pytree`` (a tuple subclass it does not
    descend into)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _key_str(k) -> str:
    for attr in ("key", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _path_str(path) -> str:
    return "/".join(_key_str(k) for k in path)


def _n_stack(ps: str) -> int:
    if "self_layers" in ps:
        return 2
    if any(re.search(rf"(^|/){s}(/|$)", ps) for s in STACK1):
        return 1
    return 0


def _name_owner(path_str: str) -> Tuple[str, str]:
    """A parameter's leaf name and owner: leaf tensors are
    ``.../<module>/w|b`` (owned by the module) or a bare named tensor."""
    parts = path_str.split("/")
    name = parts[-1]
    return name, (parts[-2] if len(parts) >= 2 and name in ("w", "b")
                  else name)


def param_spec(cfg: ModelConfig, path_str: str, shape: Tuple[int, ...],
               mesh) -> P:
    model = _axis_size(mesh, "model")
    data = _axis_size(mesh, "data")
    ns = _n_stack(path_str)
    if cfg.shard_strategy == "dp":
        return P()  # replicated weights; batch over every mesh axis
    name, owner = _name_owner(path_str)
    if cfg.shard_strategy == "fsdp":
        # Embeddings keep the vocab->model rule (see the reference).
        if owner == "embed" or name == "table":
            return P("model", None) if shape[0] % model == 0 else P()
        if owner == "lm_head":
            return P(None, "model") if shape[-1] % model == 0 else P()
        # the largest dim over ("data","model") combined when it divides,
        # else one dim per axis.
        body = shape[ns:]
        order = sorted(range(len(body)), key=lambda i: -body[i])
        spec = [None] * len(shape)
        both = data * model
        for i in order:
            if body[i] % both == 0:
                spec[ns + i] = ("data", "model")
                return P(*spec)
        placed = []
        for ax, size in (("data", data), ("model", model)):
            for i in order:
                if ns + i not in placed and body[i] % size == 0:
                    spec[ns + i] = ax
                    placed.append(ns + i)
                    break
        return P(*spec)
    body = shape[ns:]

    def spec(*tail):
        return P(*((None,) * ns + tail))

    if owner == "embed" or name == "table":
        if shape[0] % model == 0:
            return P("model", None)
        return P()
    if owner in EXPERT_NAMES or name in EXPERT_NAMES:
        ep: Any = ("data", "model") if cfg.ep_axes == "dp_model" else "model"
        ep_size = model * (data if cfg.ep_axes == "dp_model" else 1)
        if body[0] % max(ep_size, 1) == 0:
            return spec(ep, None, None)
        return spec("model", None, None) if body[0] % model == 0 else P()
    if name == "b" and owner in COL_NAMES:
        if owner in ("wk", "wv") and cfg.n_kv_heads % model != 0:
            return P()
        if body[-1] % model == 0:
            return spec("model")
        return P()
    if len(body) != 2 or name == "b":
        return P()  # norms, scalars, conv, LoRA, router, mixing vectors
    d_in, d_out = body
    if owner in COL_NAMES:
        if owner in ("wk", "wv") and cfg.n_kv_heads % model != 0:
            return P()
        if d_out % model == 0:
            return spec(None, "model")
        return P()
    if owner in ROW_NAMES:
        if d_in % model == 0:
            return spec("model", None)
        return P()
    return P()


def _map_with_path(fn, tree):
    leaves, spec = pytree.tree_flatten_with_path(tree)
    return pytree.tree_unflatten(
        [fn(_path_str(p), x) for p, x in leaves], spec)


def param_specs(cfg: ModelConfig, params_tree: Any, mesh) -> Any:
    """A :class:`P` tree for a parameter (or shape) tree."""
    return _map_with_path(
        lambda ps, x: param_spec(cfg, ps, tuple(x.shape), mesh), params_tree)


def zero1_spec(spec: P, shape: Tuple[int, ...], mesh) -> P:
    """Add 'data' (ZeRO-1) on the largest unsharded, divisible dim."""
    data = _axis_size(mesh, "data")
    if data == 1:
        return spec
    cur = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in cur:
        if e is None:
            continue
        used.update(e if isinstance(e, tuple) else (e,))
    if "data" in used:
        return spec  # already data-sharded (e.g. EP over (data, model))
    best, best_size = None, 0
    for i in range(len(shape) - 1, -1, -1):
        if cur[i] is None and shape[i] % data == 0 and shape[i] > best_size:
            best, best_size = i, shape[i]
    if best is None:
        return spec
    cur[best] = "data"
    return P(*cur)


def opt_specs(cfg: ModelConfig, params_tree: Any, mesh) -> Any:
    """AdamWState spec: step replicated; mu/nu = param spec + ZeRO-1."""
    from repro_torch.optim.adamw import AdamWState

    moments = _map_with_path(
        lambda ps, x: zero1_spec(param_spec(cfg, ps, tuple(x.shape), mesh),
                                 tuple(x.shape), mesh), params_tree)
    return AdamWState(step=P(), mu=moments, nu=moments)


# ---------------------------------------------------------------------------
# Batches / caches
# ---------------------------------------------------------------------------


def _dp(mesh, n: int, *,
        include_model: bool = False) -> Optional[Tuple[str, ...]]:
    """DP axes whose product divides n (largest usable prefix)."""
    names = ("pod", "data", "model") if include_model else ("pod", "data")
    shape = mesh_shape(mesh)
    axes = [a for a in names if a in shape]
    for start in range(len(axes)):
        use = tuple(axes[start:])
        if n % math.prod(shape[a] for a in use) == 0:
            return use
    return None


def batch_specs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Any:
    dp = _dp(mesh, shape.global_batch,
             include_model=cfg.shard_strategy in ("dp", "fsdp"))
    bspec = dp if dp else None
    out = {"tokens": P(bspec, None)}
    if cfg.family == "vlm":
        out["img_embed"] = P(bspec, None, None)
    if cfg.family == "encdec":
        out["src_embed"] = P(bspec, None, None)
    return out


def cache_spec_for(cfg: ModelConfig, path_str: str, shape: Tuple[int, ...],
                   mesh, batch: int) -> P:
    """Serve-state sharding. Handles every family's cache layout."""
    model = _axis_size(mesh, "model")
    dp = _dp(mesh, batch)
    name = path_str.split("/")[-1]
    nd = len(shape)
    bdim = next((i for i, s in enumerate(shape) if s == batch), None)
    spec: list = [None] * nd
    if dp and bdim is not None:
        spec[bdim] = dp

    if name in ("k", "v", "xk", "xv"):
        # (..., B, Hkv, S, Dh)
        hdim, sdim = nd - 3, nd - 2
        if shape[hdim] % model == 0:
            spec[hdim] = "model"
        elif shape[sdim] % model == 0:
            spec[sdim] = "model"  # flash-decoding style seq shard
    elif name in ("c_kv", "k_rope"):
        # MLA latent cache (L, B, S, r): seq over model
        sdim = nd - 2
        if shape[sdim] % model == 0:
            spec[sdim] = "model"
    elif name == "wkv":
        # rwkv6 state (L, B, H, K, V): K over model if divisible else none
        if shape[3] % model == 0:
            spec[3] = "model"
    elif name == "ssm":
        # zamba2 ssd state (L, B, H, N, P): heads over model
        if shape[2] % model == 0:
            spec[2] = "model"
    elif name in ("shift_tm", "shift_cm", "conv"):
        if shape[-1] % model == 0:
            spec[-1] = "model"
    return P(*spec)


def serve_specs(cfg: ModelConfig, state_tree: Any, mesh, batch: int) -> Any:
    return _map_with_path(
        lambda ps, x: cache_spec_for(cfg, ps, tuple(x.shape), mesh, batch),
        state_tree)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: P, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    axes = mesh_axes(mesh)
    out = [Replicate()] * len(axes)
    for dim, entry in enumerate(spec):
        names = spec_axes(entry)
        idx = [axes.index(n) for n in names if n in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} names mesh axes out of "
                             f"the mesh's order {axes}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``): a pytree leaf
    with the DTensor placements it stands for."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return to_placements(self.spec, self.mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r})"


def named(mesh, spec_tree: Any) -> Any:
    """A :class:`NamedSharding` tree for a :class:`P` tree."""
    return pytree.tree_map(lambda s: NamedSharding(mesh, s), spec_tree,
                           is_leaf=is_spec)


def local_shape(shape: Tuple[int, ...], spec: P, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor placed by ``spec`` (the
    specs shard only dims they divide)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        for n in spec_axes(entry):
            out[dim] //= sizes.get(n, 1)
    return tuple(out)


def local_block(x, mesh, placements):
    """This rank's block of a full tensor ``x`` under ``placements`` (a
    view): each ``Shard(d)`` over mesh dim ``i`` takes this rank's chunk
    of what the earlier mesh dims left, as DTensor lays shards out."""
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            size = x.shape[pl.dim] // n
            x = x.narrow(pl.dim, mesh.get_local_rank(i) * size, size)
    return x


def place(x, sharding: NamedSharding):
    """``x`` as a DTensor placed by ``sharding``: a DTensor is
    redistributed (collectives where its placements differ); a plain
    tensor is taken to be the whole value, identical on every rank, and
    each rank keeps its own block (no communication)."""
    from torch.distributed.tensor import DTensor

    mesh, placements = sharding.mesh, sharding.placements
    if isinstance(x, DTensor):
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(mesh, placements)
    return DTensor.from_local(local_block(x, mesh, placements).contiguous(),
                              mesh, placements, run_check=False,
                              shape=x.shape, stride=_contiguous(x.shape))


def _contiguous(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def local_blocks(tree: Any, shardings: Any) -> Any:
    """Each leaf's block on this rank as a plain tensor, by ``shardings``
    (a :class:`NamedSharding` tree with ``tree``'s keys): a DTensor's
    local tensor (redistributed first only where its placements differ), a
    plain tensor's :func:`local_block` (a view: no copy, no collective)."""
    from torch.distributed.tensor import DTensor

    def one(x, s):
        if isinstance(x, DTensor):
            return place(x, s).to_local()
        return local_block(x, s.mesh, s.placements)

    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(
        [one(x, s) for x, s in zip(leaves, leaves_like(tree, shardings))],
        spec)


def _qualified_owner(path_str: str) -> str:
    """A parameter's owner with the modules that hold it, below the layer
    stacks: ``"layers/tm/wk/w"`` -> ``"tm/wk"``, ``"layers/in_proj/b"``
    -> ``"in_proj"``, the embedding's ``table`` -> ``"embed"``."""
    name, _ = _name_owner(path_str)
    if name == "table":
        return "embed"
    parts = path_str.split("/")
    if name in ("w", "b"):
        parts = parts[:-1]
    return "/".join(p for p in parts
                    if p not in STACK1 and p != "self_layers")


def model_sharded(spec_tree: Any) -> frozenset:
    """The owners of the leaves whose spec splits a dim over ``"model"``:
    each by its path below the layer stacks (``"attn/wq"``, ``"tm/wk"``,
    ``"in_proj"``, the embedding's ``table`` as ``"embed"``), and by its
    bare name (``"wq"``, ``"down"``) where every owner of that name is
    split.  A name that a family gives a split owner and a whole one
    (RWKV6's ``tm/wk`` and ``cm/wk`` where ``d_ff`` does not divide the
    model axis and ``d_model`` does) stands only qualified."""
    owners: dict = {}  # qualified owner -> whether a leaf of it is split
    leaves = pytree.tree_flatten_with_path(spec_tree, is_leaf=is_spec)[0]
    for path, spec in leaves:
        owner = _qualified_owner(_path_str(path))
        owners[owner] = owners.get(owner, False) or any(
            "model" in spec_axes(e) for e in spec)

    def bare(split):
        return {o.rsplit("/", 1)[-1] for o, s in owners.items() if s == split}

    split = {o for o, s in owners.items() if s}
    return frozenset(split | (bare(True) - bare(False)))


@contextlib.contextmanager
def full_tensor_refused() -> Iterator[None]:
    """``DTensor.full_tensor`` raising for the ``with`` block: a step run
    inside it gathers no DTensor whole (the tensor-parallel serving steps
    of the dense, RWKV6 and hybrid families hold to that)."""
    from torch.distributed.tensor import DTensor

    def refuse(self, *args, **kwargs):
        raise AssertionError("DTensor.full_tensor called where nothing may "
                             "be gathered whole")

    saved = DTensor.full_tensor
    DTensor.full_tensor = refuse
    try:
        yield
    finally:
        DTensor.full_tensor = saved


def model_block(n: int, tp) -> Tuple[int, int]:
    """``[lo, hi)`` of a dim of ``n`` that this rank's block covers when
    the dim is split over ``"model"`` (``tp``: a ``launch.mesh.
    TensorParallel``): rank ``r`` holds the ``r``-th of ``tp.size`` equal
    blocks, as :func:`local_block` cuts them."""
    size = n // tp.size
    return tp.rank * size, (tp.rank + 1) * size


def leaves_like(tree: Any, other: Any) -> list:
    """The leaves of ``other`` in the order of ``tree``'s, matched by key
    path (two dicts of the same keys may hold them in different orders)."""
    by_path = {pytree.keystr(p): x
               for p, x in pytree.tree_flatten_with_path(other)[0]}
    return [by_path[pytree.keystr(p)]
            for p, _ in pytree.tree_flatten_with_path(tree)[0]]


def place_tree(tree: Any, shardings: Any) -> Any:
    """:func:`place` leaf by leaf; ``shardings`` is a :class:`NamedSharding`
    tree with ``tree``'s keys."""
    leaves, spec = pytree.tree_flatten(tree)
    return pytree.tree_unflatten(
        [place(x, s) for x, s in zip(leaves, leaves_like(tree, shardings))],
        spec)
