"""SlottedPool — a fixed-capacity live pool of sessions (port of
``repro.serve.slots``).

:class:`repro_torch.api.pool.StreamPool` batches a *static* population;
a live server needs churn — streams joining and leaving at any tick —
without building a new step program.  ``SlottedPool`` provides that over
the same slot-batched step:

* the pool holds ``capacity`` **slots**; every step program runs over the
  full capacity, so its shapes never depend on how many streams are live;
* each slot has an ``active`` flag and a **generation** counter on the
  device, beside the stacked session states (one leading slot axis);
* ``step`` runs the compressor's session body on *every* slot
  (``torch.func.vmap``; each kernel on it launches once for all slots) and
  keeps an inactive slot's previous state by a masked select; the caller's
  mask is intersected with ``active`` inside the step, so a stale mask can
  never step an evicted slot;
* ``admit`` copies the cached fresh-session image into a free slot on the
  device and bumps its generation; ``evict`` clears the flag and leaves
  the state bytes behind.

**Stream sharding** (``mesh=``, ``launch.mesh.make_stream_mesh``): one
process per device, each owning ``capacity / k`` consecutive slots.  The
host slot table is replicated (every rank admits, evicts and steps the
same sessions), the device state holds this rank's slots only, and each
rank steps them through the same vmapped body with no collective; a
step's stats come back for the local slots.  Reading one slot's state
(``slot_state``, ``export``, ``tokens``) broadcasts it from its owner, a
collective call every rank makes.

Bitwise contract (``tests/test_torch_serve.py``): a slot stepped with its
mask set equals an independent session; evicting a slot and re-admitting
into it gives a fresh session; inactive slots never perturb active ones.

Rung-bucketed dispatch for per-stream adaptive K uses :meth:`step`'s
``make_body`` / ``key`` hooks: the server runs one full-capacity masked
step per rung in use, each built once and cached under its key — moving
slots between rungs changes mask values, never shapes.  :meth:`step_multi`
is the coalesced variant: several rung bodies in one program, each slot
stepped by its own rung's body.

A "program" here is the built step of one variant (the vmapped session
body with its graph, intrinsics and masked select), made at its first use
for a chunk shape; :meth:`step_cache_sizes` counts them per key, the
port's counterpart of the reference's jit cache.  Admission, eviction,
migration and swaps are in-place device copies and build nothing.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, List, NamedTuple, Optional

import torch
from torch import Tensor
from torch.utils import _pytree as pytree

from repro_torch.api.pool import (
    StreamShard,
    _reject_k_ladder,
    stack_states,
    tree_map,
    vmap_body,
)
from repro_torch.api.types import SensorChunk

# Session id used (and released) by ``SlottedPool.prewarm``.
_PREWARM_SENTINEL = "__prewarm__"


class StaleSlotError(KeyError):
    """A cached ``(slot, generation)`` handle outlived its occupant."""


class SlotStates(NamedTuple):
    """Device state of a :class:`SlottedPool`: every tensor carries the
    leading ``(capacity, ...)`` slot axis."""

    sessions: Any  # stacked per-slot session states
    active: Tensor  # (capacity,) bool — slot holds a live stream
    generation: Tensor  # (capacity,) int32 — bumped on every admit


def _mask_like(mask: Tensor, leaf: Tensor) -> Tensor:
    """Broadcast a ``(capacity,)`` mask against a ``(capacity, ...)`` leaf."""
    return mask.reshape(mask.shape + (1,) * (leaf.ndim - 1))


def _signature(chunks: SensorChunk) -> Hashable:
    """What a built step program is specialised to: the chunk's shapes."""
    return tuple(None if x is None else tuple(x.shape) for x in chunks)


def _combine(a: Tensor, b: Tensor) -> Tensor:
    """Union of two disjointly masked stats leaves."""
    return a | b if a.dtype == torch.bool else a + b


class _Program:
    """One step variant: its session bodies, built on first use, and the
    chunk shapes it has been specialised to."""

    def __init__(self, make_bodies):
        self.make_bodies = tuple(make_bodies)
        self.runs: Optional[List[Callable]] = None
        self.signatures: set = set()

    def __call__(self, states: SlotStates, chunks: SensorChunk,
                 masks: List[Tensor]):
        """Every body over every slot from the same states; slot s keeps
        body i's result where ``masks[i] & active`` holds at s."""
        if self.runs is None:
            self.runs = [vmap_body(make()) for make in self.make_bodies]
        self.signatures.add(_signature(chunks))
        sessions, out_stats = states.sessions, None
        for run, mask in zip(self.runs, masks):
            # The caller's mask can only narrow the live population.
            mask = mask & states.active
            new_sessions, stats = run(states.sessions, chunks)
            sessions = tree_map(
                lambda new, old: torch.where(_mask_like(mask, new), new, old),
                new_sessions, sessions,
            )
            stats = tree_map(
                lambda x: torch.where(_mask_like(mask, x), x,
                                      torch.zeros_like(x)),
                stats,
            )
            out_stats = stats if out_stats is None else tree_map(
                _combine, out_stats, stats)
        return states._replace(sessions=sessions), out_stats


class SlottedPool:
    """A live, fixed-capacity pool of compressor sessions.

    Stateful: it owns the device :class:`SlotStates` (``self.states``) and
    the host-side slot table (admission order is host state).

    Args:
      compressor: the session implementation filling the slots (its
        ``session_body``, ``init`` and ``device``).
      capacity: number of slots (the batch width of every step).
      mesh / axis: optional stream mesh, as in ``StreamPool``: each rank
        steps its own ``capacity / k`` slots; ``capacity`` must divide
        evenly over the axis size.
      fresh: optional pre-built fresh-session state (the speculative
        admission image); a :class:`~repro_torch.serve.tiers.TieredPool`
        builds it once for all its tiers.  ``None`` calls
        ``compressor.init()`` once here.
    """

    def __init__(
        self,
        compressor,
        capacity: int,
        *,
        mesh=None,
        axis: Optional[str] = None,
        fresh: Optional[Any] = None,
    ):
        _reject_k_ladder(compressor, "SlottedPool")
        self.compressor = compressor
        self.capacity = capacity
        self.device = compressor.device
        self.mesh = mesh
        self.shard = None if mesh is None else StreamShard(
            mesh, capacity, axis, "capacity", self.device)
        self.axis = None if self.shard is None else self.shard.axis
        # Device slots of this rank: all of them, or its block on a mesh.
        n_dev = capacity if self.shard is None else self.shard.n_local
        # Host mirror of the allocation state (the device `active` mask is
        # authoritative for compute; the mirror avoids a host sync on
        # every admission decision).
        self.session_at: List[Optional[Hashable]] = [None] * capacity
        self._slot_of: Dict[Hashable, int] = {}
        self._host_generation: List[int] = [0] * capacity
        self._fresh = compressor.init() if fresh is None else fresh
        self._steps: Dict[Hashable, _Program] = {}
        self._ones_mask: Optional[Tensor] = None
        self.states = SlotStates(
            sessions=stack_states(self._fresh, n_dev),
            active=torch.zeros((n_dev,), dtype=torch.bool,
                               device=self.device),
            generation=torch.zeros((n_dev,), dtype=torch.int32,
                                   device=self.device),
        )

    # -- slot allocation (host) ----------------------------------------------

    @property
    def n_active(self) -> int:
        return len(self._slot_of)

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.session_at) if s is None]

    def slot_of(self, session_id: Hashable) -> int:
        try:
            return self._slot_of[session_id]
        except KeyError:
            raise KeyError(
                f"session {session_id!r} is not admitted; live sessions: "
                f"{sorted(map(repr, self._slot_of))}"
            ) from None

    def generation_of(self, slot: int) -> int:
        return self._host_generation[slot]

    def _host_bind(self, slot: int, session_id: Hashable) -> None:
        """Host-side slot assignment (shared by admit and the tiered pool's
        migration; mirrors the device generation bump)."""
        self.session_at[slot] = session_id
        self._slot_of[session_id] = slot
        self._host_generation[slot] += 1

    def _host_unbind(self, slot: int) -> None:
        del self._slot_of[self.session_at[slot]]
        self.session_at[slot] = None

    # -- device-side slot writes ---------------------------------------------

    def _local_slot(self, slot: int) -> Optional[int]:
        """``slot``'s index among this rank's device slots, or ``None``
        when another rank holds it."""
        if self.shard is None:
            return slot
        return slot - self.shard.lo if self.shard.owns(slot) else None

    def _write_slot(self, slot: int, one: Any) -> None:
        """Copy one session state into ``slot``, bump its generation and
        mark it active: in-place device copies, no host sync."""
        slot = self._local_slot(slot)
        if slot is None:
            return
        for buf, x in zip(pytree.tree_leaves(self.states.sessions),
                          pytree.tree_leaves(one)):
            if buf is not None:
                buf[slot].copy_(x)
        self.states.active[slot].fill_(True)
        self.states.generation[slot].add_(1)

    def _read_slot(self, slot: int) -> Any:
        """A copy of the session state held by ``slot`` (device tensors);
        on a mesh, broadcast from the rank holding it."""
        local = self._local_slot(slot)
        if self.shard is None:
            return tree_map(lambda x: x[local].clone(), self.states.sessions)
        held = 0 if local is None else local
        return self.shard.broadcast(
            tree_map(lambda x: x[held].clone(), self.states.sessions), slot)

    # -- admission / eviction ------------------------------------------------

    def admit(self, session_id: Hashable, slot: Optional[int] = None) -> int:
        """Admit a new stream: copy the fresh session into a free slot.

        Returns the slot index.  Raises ``RuntimeError`` when the pool is
        full and ``ValueError`` on a duplicate session id.
        """
        if session_id in self._slot_of:
            raise ValueError(f"session {session_id!r} already admitted")
        if slot is None:
            free = self.free_slots()
            if not free:
                raise RuntimeError(
                    f"pool full: all {self.capacity} slots active"
                )
            slot = free[0]
        elif self.session_at[slot] is not None:
            raise ValueError(
                f"slot {slot} still holds session "
                f"{self.session_at[slot]!r}; evict it first"
            )
        self._write_slot(slot, self._fresh)
        self._host_bind(slot, session_id)
        return slot

    def prewarm(self) -> None:
        """One admit/evict round trip on slot 0 through a sentinel binding,
        as the reference does before the first real admission (there it
        compiles the lifecycle programs; here nothing is built, and the
        slot ends free with its generation advanced)."""
        if self.session_at[0] is not None:
            raise RuntimeError("prewarm() must run before any admission")
        self.admit(_PREWARM_SENTINEL, slot=0)
        self.evict(0)

    def evict(self, slot: int) -> None:
        """Deactivate a slot.  Its state bytes stay in place (masked no-op
        from now on); the next ``admit`` into it overwrites them."""
        if self.session_at[slot] is None:
            raise ValueError(f"slot {slot} is already free")
        local = self._local_slot(slot)
        if local is not None:
            self.states.active[local].fill_(False)
        self._host_unbind(slot)

    def evict_session(self, session_id: Hashable) -> int:
        slot = self.slot_of(session_id)
        self.evict(slot)
        return slot

    # -- stepping ------------------------------------------------------------

    def _program(self, key: Hashable, make_bodies) -> _Program:
        prog = self._steps.get(key)
        if prog is None:
            prog = self._steps[key] = _Program(make_bodies)
        return prog

    def _check_chunks(self, chunks: SensorChunk) -> None:
        if chunks.frames.ndim != 5 or chunks.frames.shape[0] != self.capacity:
            raise ValueError(
                f"SlottedPool({self.capacity}) expects chunk arrays with "
                f"a leading slot axis, frames (capacity, T, H, W, 3); got "
                f"frames shape {tuple(chunks.frames.shape)}"
            )

    def step(
        self,
        chunks: SensorChunk,
        *,
        mask: Optional[Tensor] = None,
        make_body: Optional[Callable[[], Callable]] = None,
        key: Hashable = None,
    ) -> Any:
        """Ingest one chunk per slot through a masked full-capacity step.

        ``chunks`` carries the leading ``(capacity, T, ...)`` slot axis on
        the pool's device (idle slots receive placeholder rows, their
        compute discarded by the mask).  ``mask`` defaults to every active
        slot; the device ``active`` flags are always intersected in the
        step.

        ``make_body``/``key`` select a step *variant*: ``key`` names the
        program in the pool's cache, and on its first use ``make_body()``
        gives its per-session body (default: the pool compressor's
        ``session_body``).  Mask and state values never build a program.

        Returns the per-frame stats tree, ``(capacity, T, ...)``, zeroed on
        masked-out slots (on a mesh, this rank's slots only);
        ``self.states`` is replaced.
        """
        self._check_chunks(chunks)
        prog = self._program(
            key, (make_body or self.compressor.session_body,)
        )
        if mask is None:
            mask = self._all_slots_mask()
        elif self.shard is not None:
            mask = self.shard.rows(mask)
        self.states, stats = prog(self.states, self._local_chunks(chunks),
                                  [mask])
        return stats

    def _local_chunks(self, chunks: SensorChunk) -> SensorChunk:
        return chunks if self.shard is None else self.shard.chunk(chunks)

    def owns(self, slot: int) -> bool:
        """Whether this rank's device holds ``slot`` (always, unsharded)."""
        return self.shard is None or self.shard.owns(slot)

    def gather_slots(self, x: Tensor, dim: int = 0) -> Tensor:
        """Per-slot rows of this rank's slots (along ``dim``) joined over
        the mesh into the whole pool's, in slot order (a collective call
        on a mesh; ``x`` itself unsharded)."""
        return x if self.shard is None else self.shard.gather(x, dim)

    def step_multi(
        self,
        chunks: SensorChunk,
        masks: Tensor,
        make_bodies,
        key: Hashable,
    ) -> Any:
        """Coalesced step: ``len(make_bodies)`` disjoint slot groups in one
        program.  ``masks`` is ``(n_groups, capacity)`` bool, row ``i``
        selecting the slots stepped by body ``i``; ``key`` names the
        combination in the cache :meth:`step` uses.  Each body runs over
        every slot and a masked select keeps its own group's result, so
        the outcome equals the groups' separate steps.  Returns the
        combined stats, zeroed outside the union of the masks."""
        self._check_chunks(chunks)
        prog = self._program(key, make_bodies)
        if self.shard is not None:
            masks = masks.narrow(1, self.shard.lo, self.shard.n_local)
        self.states, stats = prog(self.states, self._local_chunks(chunks),
                                  list(masks))
        return stats

    def _all_slots_mask(self) -> Tensor:
        if self._ones_mask is None:
            self._ones_mask = torch.ones(
                (self.states.active.shape[0],), dtype=torch.bool,
                device=self.device)
        return self._ones_mask

    def step_cache_sizes(self) -> Dict[Hashable, int]:
        """Built step programs per variant key (one per chunk shape) — the
        no-rebuild telemetry the serve tests assert on."""
        return {k: len(p.signatures) for k, p in self._steps.items()}

    def block_until_ready(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- per-slot access -----------------------------------------------------

    def slot_state(
        self, slot: int, *, expect_generation: Optional[int] = None
    ) -> Any:
        """A copy of the session state held by one slot.

        ``expect_generation`` is the staleness fence for callers that
        cached a ``(slot, generation)`` handle: if the slot has since been
        re-admitted or migrated into, the read fails instead of returning
        the new occupant's state.
        """
        if (
            expect_generation is not None
            and expect_generation != self._host_generation[slot]
        ):
            raise StaleSlotError(
                f"slot {slot} is at generation "
                f"{self._host_generation[slot]}, caller expected "
                f"{expect_generation}: the slot was re-admitted since "
                f"this handle was taken"
            )
        return self._read_slot(slot)

    def session_state(self, session_id: Hashable) -> Any:
        return self.slot_state(self.slot_of(session_id))

    def export(self, session_id: Hashable):
        return self.compressor.export(self.session_state(session_id))

    def tokens(self, session_id: Hashable, seq_len: int):
        return self.compressor.tokens(
            self.session_state(session_id), seq_len
        )
