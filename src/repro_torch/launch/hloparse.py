"""Collective byte accounting: post-SPMD HLO text, and the collectives a
torch run issues.

Port of ``repro/launch/hloparse.py``.  Two readers give one summary
(``total_bytes``, ``wire_bytes``, ``by_op``, ``counts``, ``detail``):

* :func:`analyze_collectives` reads the reference's optimized HLO text
  (a copy of the reference's parser: the same dict for the same text, so
  the port reads the reference's dumps).  XLA's ``cost_analysis()``
  counts a while-loop body once, so it

    * splits the module into computations;
    * records, per computation, every collective op's output bytes and
      replica-group size;
    * walks the call graph from ENTRY, multiplying by
      ``backend_config.known_trip_count`` at each while;
    * keeps ``tpu_wire_bytes``: bf16 collectives that XLA's CPU
      float-normalization upcast to f32 counted at half their bytes.

* :func:`analyze_records` reads the port's counterpart of that HLO: the
  collectives a torch run issues, as :class:`Recorder` catches them,
  each ``(op, output bytes, group size)``.  Python runs every layer, so
  there is no trip count: ``counts`` is the number of calls.  There is
  no ``tpu_wire_bytes``: NCCL runs a bf16 collective in bf16.

The wire estimate uses the reference's ring factors:
    all-reduce         2(n-1)/n  x buffer
    all-gather         (n-1)/n   x buffer (output)
    reduce-scatter     (n-1)/n   x output
    all-to-all         (n-1)/n   x buffer
    collective-permute 1         x buffer
(The reference's docstring says a reduce-scatter's factor applies to its
input; its code applies it to the output, and this module follows the
code.)
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s4": 1, "u4": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}
_SHAPE_PAT = (r"(?:pred|s4|u4|s8|u8|s16|u16|bf16|f16|s32|u32|f32|s64|u64|f64)"
              r"\[[0-9,]*\]")
_COLL_PAT = re.compile(
    r"= (?P<shape>\(?.*?\)?) "
    r"(?P<op>all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)"
    r"(?P<async>-start|-done)?\((?P<args>%?[\w\.\-]*)"
)
_WHILE_PAT = re.compile(r"while\(.*?body=%?(?P<body>[\w\.\-]+)")
_TRIP_PAT = re.compile(r'"known_trip_count":\{"n":"(\d+)"\}')
_GROUP_PAT = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUP_LIST_PAT = re.compile(r"replica_groups=\{\{([0-9,]+)\}")
_COND_PAT = re.compile(
    r"conditional\(.*?(?:branch_computations=\{([^}]*)\}|"
    r"true_computation=%?([\w\.\-]+), false_computation=%?([\w\.\-]+))"
)

_RING = {
    "all-reduce": lambda n: 2.0 * (n - 1) / n if n > 1 else 0.0,
    "all-gather": lambda n: (n - 1) / n if n > 1 else 0.0,
    "reduce-scatter": lambda n: (n - 1) / n if n > 1 else 0.0,
    "all-to-all": lambda n: (n - 1) / n if n > 1 else 0.0,
    "collective-permute": lambda n: 1.0,
}


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in re.finditer(_SHAPE_PAT, shape_str):
        s = m.group(0)
        dt = s[: s.index("[")]
        dims = s[s.index("[") + 1: -1]
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str) -> int:
    m = _GROUP_PAT.search(line)
    if m:
        return int(m.group(2))
    m = _GROUP_LIST_PAT.search(line)
    if m:
        return len(m.group(1).split(","))
    return 0  # unknown -> world


def split_computations(text: str) -> Dict[str, List[str]]:
    comps: Dict[str, List[str]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w\.\-]+)(?:\.[\d]+)? \(.*\{", line)
        if line.startswith("ENTRY"):
            name = re.match(r"^ENTRY %?([\w\.\-]+)", line).group(1)
            cur = "__entry__"
            comps[cur] = []
            comps["__entry_name__"] = [name]
            continue
        if m and not line.startswith(" "):
            cur = m.group(1)
            comps[cur] = []
            continue
        if line.startswith("}"):
            cur = None
            continue
        if cur is not None:
            comps[cur].append(line)
    return comps


def _summary(by_key: Dict[Tuple[str, int], float],
             counts: Dict[str, float],
             tpu: Optional[Dict[Tuple[str, int], float]] = None) -> Dict:
    """The summary dict of per-(op, group size) bytes; ``tpu`` adds the
    reference's ``tpu_wire_bytes`` keys."""
    total = 0.0
    wire = 0.0
    wire_tpu = 0.0
    by_op: Dict[str, float] = defaultdict(float)
    detail = []
    for (op, gsize), nbytes in sorted(by_key.items()):
        n = gsize if gsize > 0 else 2
        total += nbytes
        w = _RING[op](n) * nbytes
        wire += w
        by_op[op] += nbytes
        row = {"op": op, "group": gsize, "bytes": nbytes, "wire_bytes": w}
        if tpu is not None:
            wt = _RING[op](n) * tpu[(op, gsize)]
            wire_tpu += wt
            row["tpu_wire_bytes"] = wt
        detail.append(row)
    out = {"total_bytes": total, "wire_bytes": wire}
    if tpu is not None:
        out["tpu_wire_bytes"] = wire_tpu
    out.update(by_op=dict(by_op), counts=dict(counts), detail=detail)
    return out


def analyze_collectives(text: str) -> Dict:
    """Collective bytes of a post-SPMD HLO module's text, loops counted by
    their trip counts (the reference's dict, key for key)."""
    comps = split_computations(text)
    comps.pop("__entry_name__", None)

    # per computation: collectives and child loops
    coll: Dict[str, List[Tuple[str, int, int, float]]] = defaultdict(list)
    children: Dict[str, List[Tuple[str, int]]] = defaultdict(list)
    for name, lines in comps.items():
        for line in lines:
            cm = _COLL_PAT.search(line)
            if cm and cm.group("async") != "-done":
                # XLA CPU float-normalization upcasts bf16 collectives to
                # f32 (a convert fusion feeds them); a TPU runs them in
                # bf16, so the TPU wire estimate halves those bytes.
                upcast = (
                    "f32[" in cm.group("shape")
                    and "convert" in cm.group("args")
                )
                coll[name].append(
                    (
                        cm.group("op"),
                        _shape_bytes(cm.group("shape")),
                        _group_size(line),
                        0.5 if upcast else 1.0,
                    )
                )
            wm = _WHILE_PAT.search(line)
            if wm:
                tm = _TRIP_PAT.search(line)
                trip = int(tm.group(1)) if tm else 1
                children[name].append((wm.group("body"), trip))
            cnd = _COND_PAT.search(line)
            if cnd:
                if cnd.group(1):
                    branches = re.findall(r"%?([\w\.\-]+)", cnd.group(1))
                else:
                    branches = [cnd.group(2), cnd.group(3)]
                for b in branches:
                    if b in comps:
                        children[name].append((b, 1))

    # multipliers via DFS from entry
    mult: Dict[str, float] = defaultdict(float)
    mult["__entry__"] = 1.0
    stack = ["__entry__"]
    seen_edges = set()
    while stack:
        cur = stack.pop()
        for child, trip in children.get(cur, ()):
            key = (cur, child)
            mult[child] += mult[cur] * trip
            if key not in seen_edges:
                seen_edges.add(key)
                stack.append(child)

    by_key: Dict[Tuple[str, int], float] = defaultdict(float)
    by_key_tpu: Dict[Tuple[str, int], float] = defaultdict(float)
    counts: Dict[str, float] = defaultdict(float)
    for name, ops in coll.items():
        m = mult.get(name, 0.0)
        if m == 0.0 and name != "__entry__":
            # computation not reachable through a parsed while: count once
            m = 1.0
        for op, nbytes, gsize, dt_factor in ops:
            by_key[(op, gsize)] += m * nbytes
            by_key_tpu[(op, gsize)] += m * nbytes * dt_factor
            counts[op] += m
    return _summary(by_key, counts, by_key_tpu)


# ---------------------------------------------------------------------------
# The collectives a torch run issues
# ---------------------------------------------------------------------------


class Record(NamedTuple):
    """One collective call: the reference's op name, the bytes of its
    output on this rank, the size of its group."""

    op: str
    nbytes: int
    group: int


def analyze_records(records: Iterable[Record]) -> Dict:
    """The summary of :func:`analyze_collectives` for recorded calls:
    ``counts`` is the number of calls, and there is no
    ``tpu_wire_bytes``."""
    by_key: Dict[Tuple[str, int], int] = defaultdict(int)
    counts: Dict[str, int] = defaultdict(int)
    for op, nbytes, group in records:
        if op not in _RING:
            raise ValueError(
                f"unknown collective {op!r}; known: {tuple(_RING)}")
        by_key[(op, group)] += nbytes
        counts[op] += 1
    return _summary(by_key, counts)


def _nbytes(xs) -> int:
    if isinstance(xs, torch.Tensor):
        return xs.numel() * xs.element_size()
    return sum(_nbytes(x) for x in xs)


# The op each call stands for, and which argument holds its output on
# this rank (an index into the call's arguments; None: its result).
# XLA has no broadcast collective; a broadcast puts one buffer on each
# link of its group, as a collective-permute does.  A point-to-point
# transfer is counted once, at its send.
_FUNCTIONAL = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_coalesced_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "broadcast_": ("collective-permute", 0),
    "send": ("collective-permute", 0),
}
# Calls that move no buffer, or whose bytes another call records.
_UNCOUNTED = {"wait_tensor", "_wrap_tensor_autograd", "barrier",
              "monitored_barrier_", "recv_", "recv_any_source_"}
_NAMESPACES = ("c10d", "c10d_functional", "_c10d_functional")


def _group_of(func, args, kwargs) -> int:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for i, a in enumerate(func._schema.arguments):
        value = args[i] if i < len(args) else kwargs.get(a.name)
        if a.name == "group_name":
            return _resolve_process_group(value).size()
        if a.name == "process_group":
            return dist.ProcessGroup.unbox(value).size()
    raise ValueError(f"{func} names no process group")


class Recorder(TorchDispatchMode):
    """Records every collective that runs under it, in issue order
    (``self.records``, each a :class:`Record`): the ``c10d.*``,
    ``c10d_functional.*`` and ``_c10d_functional.*`` calls, with their
    output bytes on this rank and their group's size.  DTensor calls pass
    through to DTensor, whose own collectives are then recorded.  A
    collective this module does not know raises."""

    def __init__(self):
        super().__init__()
        self.records: List[Record] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace not in _NAMESPACES:
            return out
        name = func._schema.name.split("::")[-1]
        if name in _UNCOUNTED:
            return out
        if func.namespace == "c10d":
            if name not in _C10D:
                raise NotImplementedError(
                    f"the collective recorder does not know {func}")
            op, i = _C10D[name]
            nbytes = _nbytes(args[i])
        else:
            if name not in _FUNCTIONAL:
                raise NotImplementedError(
                    f"the collective recorder does not know {func}")
            op, nbytes = _FUNCTIONAL[name], _nbytes(out)
        self.records.append(Record(op, nbytes, _group_of(func, args,
                                                          kwargs)))
        return out


if __name__ == "__main__":
    import sys

    with open(sys.argv[1]) as f:
        print(json.dumps(analyze_collectives(f.read()), indent=2))
