"""TieredPool — size-classed sub-pools so idle slots cost nothing (port
of ``repro.serve.tiers``).

A flat :class:`~repro_torch.serve.slots.SlottedPool` steps its full
capacity on every dispatch, however few slots are live.  ``TieredPool``
splits one logical pool into size-classed sub-pools — tier 0 the small
**hot** tier, the last the large **warm/cold** one — each an ordinary
``SlottedPool`` with its own step programs:

* a tier is stepped **only when it has ready chunks**, so a warm tier of
  admitted but idle sessions costs no device time per tick;
* the serving layer (:class:`~repro_torch.serve.server.StreamServer`)
  promotes active streams into the hot tier and demotes idle ones;
* **tier migration** (:meth:`migrate` / :meth:`swap`) moves a slot's
  session state between the tiers' stacked tensors by device-side copies
  and bumps the destination generation, which fences stale ``(slot,
  generation)`` handles as re-admission does;
* **speculative admission**: ``compressor.init()`` runs once per pool and
  every tier's admit copies that one fresh image.

Slots are addressed globally: tier ``t``'s local slot ``s`` is global slot
``offsets[t] + s``.  Bitwise contract (``tests/test_torch_tiered_serve.py``):
a session stepped in any tier, however often it migrates, equals the same
session stepped in a flat pool.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Optional, Tuple

from repro_torch.api.pool import tree_map
from repro_torch.serve.slots import _PREWARM_SENTINEL, SlottedPool


def validate_tiers(tiers, capacity: int) -> Tuple[int, ...]:
    """Fail-fast check of a tier split: positive sizes summing to the
    pool capacity (the global-slot math and the serving facade both
    assume the split is a partition of ``capacity``)."""
    tiers = tuple(int(t) for t in tiers)
    if not tiers or any(t < 1 for t in tiers):
        raise ValueError(
            f"tiers must be a non-empty tuple of positive slot counts, "
            f"got {tiers!r}"
        )
    if sum(tiers) != capacity:
        raise ValueError(
            f"tiers {tiers} sum to {sum(tiers)}, expected the pool "
            f"capacity {capacity}"
        )
    return tiers


class TieredPool:
    """Size-classed sub-pools behind one slotted-pool-shaped surface.

    Args:
      compressor: the session implementation (shared by every tier).
      capacities: slot count per tier, hot (stepped most) first.
    """

    def __init__(self, compressor, capacities):
        capacities = tuple(int(c) for c in capacities)
        if not capacities or any(c < 1 for c in capacities):
            raise ValueError(
                f"capacities must be positive per tier, got {capacities!r}"
            )
        self.compressor = compressor
        # Speculative admission: one fresh-session image for the whole
        # pool, built exactly once and scattered on every admit.
        self._fresh = compressor.init()
        self.tiers: List[SlottedPool] = [
            SlottedPool(compressor, c, fresh=self._fresh) for c in capacities
        ]
        self.capacities = capacities
        self.capacity = sum(capacities)
        offs, total = [], 0
        for c in capacities:
            offs.append(total)
            total += c
        self.offsets = tuple(offs)
        self.n_migrations = 0
        self.n_swaps = 0

    # -- addressing ----------------------------------------------------------

    @property
    def n_active(self) -> int:
        return sum(t.n_active for t in self.tiers)

    def tier_of(self, session_id: Hashable) -> int:
        for ti, tier in enumerate(self.tiers):
            if session_id in tier._slot_of:
                return ti
        raise KeyError(
            f"session {session_id!r} is not admitted; live sessions: "
            f"{sorted(map(repr, self.live_sessions()))}"
        )

    def locate(self, session_id: Hashable) -> Tuple[int, int]:
        """``(tier, local_slot)`` of a live session."""
        ti = self.tier_of(session_id)
        return ti, self.tiers[ti]._slot_of[session_id]

    def slot_of(self, session_id: Hashable) -> int:
        """Global slot index (``offsets[tier] + local``)."""
        ti, slot = self.locate(session_id)
        return self.offsets[ti] + slot

    def unpack_slot(self, global_slot: int) -> Tuple[int, int]:
        for ti in reversed(range(len(self.tiers))):
            if global_slot >= self.offsets[ti]:
                return ti, global_slot - self.offsets[ti]
        raise IndexError(f"global slot {global_slot} out of range")

    def generation_of(self, global_slot: int) -> int:
        ti, slot = self.unpack_slot(global_slot)
        return self.tiers[ti].generation_of(slot)

    def live_sessions(self) -> List[Hashable]:
        return [s for t in self.tiers for s in t._slot_of]

    def free_slots(self) -> List[int]:
        return [
            self.offsets[ti] + s
            for ti, tier in enumerate(self.tiers)
            for s in tier.free_slots()
        ]

    # -- admission / eviction ------------------------------------------------

    def admit(
        self, session_id: Hashable, *, tier: Optional[int] = None
    ) -> int:
        """Admit into the *coldest* tier with a free slot (new sessions
        earn the hot tier through observed arrivals), or into an
        explicit ``tier``.  Returns the global slot."""
        if any(session_id in t._slot_of for t in self.tiers):
            raise ValueError(f"session {session_id!r} already admitted")
        if tier is None:
            for ti in reversed(range(len(self.tiers))):
                if self.tiers[ti].free_slots():
                    tier = ti
                    break
            else:
                raise RuntimeError(
                    f"pool full: all {self.capacity} slots active "
                    f"across {len(self.tiers)} tiers"
                )
        slot = self.tiers[tier].admit(session_id)
        return self.offsets[tier] + slot

    def evict_session(self, session_id: Hashable) -> int:
        ti, slot = self.locate(session_id)
        self.tiers[ti].evict(slot)
        return self.offsets[ti] + slot

    def prewarm(self) -> None:
        """The reference's lifecycle warm-up, step for step (admit/evict per
        tier, the migration per adjacent tier pair in both directions, the
        swap per adjacent pair), through sentinel sessions in each slot 0
        that are released at the end: only the generation counters
        advance.  The port builds nothing for these moves; the warm-up
        keeps the generations the reference's server reports."""
        if self.n_active:
            raise RuntimeError("prewarm() must run before any admission")
        names = [f"{_PREWARM_SENTINEL}{i}" for i in range(len(self.tiers))]
        for ti, tier in enumerate(self.tiers):
            tier.admit(names[ti], slot=0)
        for ti in range(1, len(self.tiers)):
            self.swap(names[ti - 1], names[ti])  # compiles pair swap
            self.swap(names[ti - 1], names[ti])  # cached; restores slots
        for tier in self.tiers:
            tier.evict(0)
        sid = _PREWARM_SENTINEL
        self.tiers[0].admit(sid, slot=0)
        for ti in range(1, len(self.tiers)):
            self.migrate(sid, ti)  # compiles (ti-1 -> ti)
            self.migrate(sid, ti - 1)  # compiles (ti -> ti-1)
            self.migrate(sid, ti)  # cached; advance for the next pair
        ti, slot = self.locate(sid)
        self.tiers[ti].evict(slot)
        # Sentinel traffic is warmup, not telemetry.
        self.n_migrations = 0
        self.n_swaps = 0

    # -- tier migration (device-side gather/scatter) -------------------------

    def migrate(self, session_id: Hashable, to_tier: int) -> int:
        """Move a live session's slot state to another tier: device-side
        copies of each state tensor, no host copy of the bytes.  The
        destination slot's generation bumps (staleness fence); the source
        slot frees.  Returns the new global slot."""
        src, i = self.locate(session_id)
        if to_tier == src:
            raise ValueError(
                f"session {session_id!r} is already in tier {src}"
            )
        free = self.tiers[to_tier].free_slots()
        if not free:
            raise RuntimeError(
                f"tier {to_tier} full "
                f"({self.capacities[to_tier]} slots); demote or swap"
            )
        j = free[0]
        a, b = self.tiers[src], self.tiers[to_tier]
        b._write_slot(j, tree_map(lambda x: x[i], a.states.sessions))
        a.states.active[i].fill_(False)
        a._host_unbind(i)
        b._host_bind(j, session_id)
        self.n_migrations += 1
        return self.offsets[to_tier] + j

    def swap(self, session_a: Hashable, session_b: Hashable) -> None:
        """Exchange two live sessions' slots across tiers on the device —
        the full-pool promotion path (a hot idler and a warm riser trade
        places; no free slot needed).  Both generations bump."""
        ta, i = self.locate(session_a)
        tb, j = self.locate(session_b)
        if ta == tb:
            raise ValueError(
                f"sessions {session_a!r} and {session_b!r} are both in "
                f"tier {ta}; swap is for cross-tier rebalancing"
            )
        if ta > tb:
            # (hotter, colder), as the reference orders the pair.
            session_a, session_b = session_b, session_a
            ta, i, tb, j = tb, j, ta, i
        a, b = self.tiers[ta], self.tiers[tb]
        va = a._read_slot(i)
        a._write_slot(i, tree_map(lambda x: x[j], b.states.sessions))
        b._write_slot(j, va)
        a._host_unbind(i)
        b._host_unbind(j)
        a._host_bind(i, session_b)
        b._host_bind(j, session_a)
        self.n_swaps += 1

    # -- stepping / access ---------------------------------------------------

    def step_cache_sizes(self) -> Dict[Hashable, int]:
        """Built step programs across every tier's variants, keyed
        ``(tier, variant_key)``."""
        return {
            (ti, k): n
            for ti, tier in enumerate(self.tiers)
            for k, n in tier.step_cache_sizes().items()
        }

    def session_state(self, session_id: Hashable) -> Any:
        ti, slot = self.locate(session_id)
        return self.tiers[ti].slot_state(slot)

    def export(self, session_id: Hashable):
        return self.compressor.export(self.session_state(session_id))

    def tokens(self, session_id: Hashable, seq_len: int):
        return self.compressor.tokens(
            self.session_state(session_id), seq_len
        )

    def block_until_ready(self) -> None:
        for tier in self.tiers:
            tier.block_until_ready()
