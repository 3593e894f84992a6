"""Per-stream adaptive K: the host-side bucket-ladder controller and the
tick's rung scheduler (port of ``repro.serve.adaptive``).

:class:`KLadderController` is a plain host-side object with no tensors.
``EPICCompressor(k_ladder=...)`` owns one per session, and
``StreamServer`` one per stream; each walks ``cfg.prefilter_k`` across the
ladder's rungs between chunks:

* **grow** one rung when the chunk reported any ``n_prefilter_overflow``
  (the candidate budget truncated real work);
* **shrink** one rung when the chunk's peak per-frame ``n_full_checks``
  would fit the next-lower rung with a ``shrink_margin``x margin.

The rule is a pure function of the per-chunk stats trajectory: a fixed
ladder and a fixed chunk sequence always give the same K trajectory, and
a controller that never moves gives the fixed-K run.

:class:`RungScheduler` orders (and optionally coalesces) a serving tick's
per-rung pool dispatches into :class:`DispatchPlan` s.
"""

from __future__ import annotations

from collections import deque
from typing import (
    Any,
    Dict,
    Hashable,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
)

from repro_torch.api import registry as _registry


def validate_shrink_margin(shrink_margin: int) -> int:
    """Fail-fast check of the controller's shrink margin.

    ``margin < 1`` makes the shrink condition vacuous: the controller
    would sink a rung after every overflow-free chunk and oscillate
    under load.
    """
    if not isinstance(shrink_margin, int) or shrink_margin < 1:
        raise ValueError(
            f"shrink_margin must be an int >= 1, got {shrink_margin!r}"
        )
    return shrink_margin


class KLadderController:
    """Host-side rung state of one adaptive-K stream.

    Args:
      ladder: static, strictly increasing ``prefilter_k`` buckets.
      start_k: the rung to start on; ``0`` starts at the bottom rung, any
        other value must be a ladder rung.
      shrink_margin: shrink to the next-lower rung only when the peak
        candidate count fits it with this multiplicative margin.
      what: name used in the ``start_k`` error message.
      history_limit: bound on the kept ``k_trajectory`` (``None``: the
        whole history; an int keeps the most recent entries in a ring).
        The decision rule reads only the current rung.
    """

    def __init__(
        self,
        ladder: Sequence[int],
        *,
        start_k: int = 0,
        shrink_margin: int = 2,
        what: str = "start_k",
        history_limit: Optional[int] = None,
    ):
        self.ladder: Tuple[int, ...] = _registry.validate_k_ladder(ladder)
        self.shrink_margin = validate_shrink_margin(shrink_margin)
        if history_limit is not None and history_limit < 1:
            raise ValueError(
                f"history_limit must be >= 1 or None, got {history_limit}"
            )
        if start_k in self.ladder:
            self._rung = self.ladder.index(start_k)
        elif start_k == 0:
            self._rung = 0
        else:
            raise ValueError(
                f"{what}={start_k} is not a rung of "
                f"k_ladder={self.ladder} (use 0 to start at the "
                f"bottom rung)"
            )
        #: K used by each past chunk, in order: a list, or a ``deque``
        #: ring under ``history_limit``.
        self.k_trajectory: Any = (
            [] if history_limit is None else deque(maxlen=history_limit)
        )
        # Highest rung update() may grow to (the top of the ladder unless
        # capped).
        self._max_rung = len(self.ladder) - 1

    @property
    def k(self) -> int:
        """The current rung's ``prefilter_k``."""
        return self.ladder[self._rung]

    @property
    def rung_cap(self) -> int:
        """The highest ladder index :meth:`update` may grow to."""
        return self._max_rung

    def set_rung_cap(self, rung: Optional[int]) -> None:
        """Clamp the controller at ladder index ``rung`` (``None``: no
        cap).  Capping below the current rung moves the rung down at once;
        while the cap holds, :meth:`update` never grows past it."""
        cap = len(self.ladder) - 1 if rung is None else rung
        if not 0 <= cap < len(self.ladder):
            raise ValueError(
                f"rung cap {rung} out of range for the "
                f"{len(self.ladder)}-rung ladder"
            )
        self._max_rung = cap
        if self._rung > cap:
            self._rung = cap

    def begin_chunk(self) -> int:
        """Record the K the next chunk will run with, and return it."""
        k = self.k
        self.k_trajectory.append(k)
        return k

    def update(self, overflow: int, peak_full: int) -> int:
        """Advance the rung from one chunk's scalar counters.

        ``overflow`` is the chunk's summed ``n_prefilter_overflow``;
        ``peak_full`` its max per-frame ``n_full_checks``.  Returns the K
        the next chunk will use.
        """
        if overflow > 0 and self._rung < self._max_rung:
            self._rung += 1
        elif (
            self._rung > 0
            and peak_full * self.shrink_margin <= self.ladder[self._rung - 1]
        ):
            self._rung -= 1
        return self.k


class DispatchPlan(NamedTuple):
    """One pool dispatch of a serving tick, as ordered by the
    :class:`RungScheduler`.

    ``rungs`` holds one rung key per coalesced group (a single-element
    tuple is a plain per-rung masked step; ``None`` is the fixed-K
    rung); ``sids`` is the parallel tuple of session-id groups.
    """

    tier: int
    rungs: Tuple[Optional[int], ...]
    sids: Tuple[Tuple[Hashable, ...], ...]

    @property
    def key(self) -> Hashable:
        """The step-variant cache key this plan dispatches under."""
        return self.rungs[0] if len(self.rungs) == 1 else self.rungs


class RungScheduler:
    """Tick-level cost model over rung dispatches.

    The server hands it the tick's ``(tier, rung) -> sids`` groups; it
    returns an ordered list of :class:`DispatchPlan`:

    * **ordering**: dispatches are issued most-expensive first (by the
      measured per-rung cost model), so the longest device program is
      in flight while the host assembles and dispatches the rest — CUDA
      launches are asynchronous, so issue order is pure overlap and
      changes no result;
    * **coalescing** (``coalesce=True``): when the post-pop backlog is
      at most ``coalesce_backlog`` queued chunks (i.e. the tick is
      dispatch-overhead-bound, not compute-bound), adjacent rungs
      within a tier are merged pairwise into one
      :meth:`~repro_torch.serve.slots.SlottedPool.step_multi` dispatch —
      bitwise identical per slot, one dispatch instead of two.  Pairing
      is **deterministic** (ascending adjacent rungs), never
      cost-dependent: the set of built program keys is a function of
      traffic alone, so a warmed server cannot be coaxed into a
      post-warmup compile by noisy timings.

    The cost model itself is measured, not assumed: whenever a tick ran
    exactly one dispatch, its wall time (dispatch + the tick's single
    readback) is attributed to that variant's EMA — no extra host syncs
    ever.  Unmeasured rungs fall back to a prior proportional to their
    K (candidate budget ~ work).
    """

    def __init__(
        self,
        *,
        coalesce: bool = False,
        coalesce_backlog: int = 0,
        ema_alpha: float = 0.3,
    ):
        if not 0.0 < ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha must be in (0, 1], {ema_alpha}")
        self.coalesce = coalesce
        self.coalesce_backlog = coalesce_backlog
        self.ema_alpha = ema_alpha
        self._cost: Dict[Hashable, float] = {}
        self.n_coalesced = 0

    # -- cost model ----------------------------------------------------------

    def estimate(self, key: Hashable) -> float:
        """Estimated dispatch cost (seconds once measured; before any
        measurement, a relative prior proportional to the rung K)."""
        est = self._cost.get(key)
        if est is not None:
            return est
        if isinstance(key, tuple):
            return sum(self.estimate(k) for k in key)
        # Relative prior: cost scales with the candidate budget.  1e-6
        # keeps the prior below any plausible measured seconds so real
        # measurements dominate ordering as soon as they exist.
        return 1e-6 * float(key if key else 1)

    def observe_tick(self, keys: Sequence[Hashable], wall_s: float) -> None:
        """Attribute one tick's wall time.  Only single-dispatch ticks
        are attributable (the tick's one readback fences the work of
        every dispatch it issued); multi-dispatch ticks are skipped."""
        if len(keys) != 1:
            return
        key = keys[0]
        prev = self._cost.get(key)
        self._cost[key] = (
            wall_s if prev is None
            else (1 - self.ema_alpha) * prev + self.ema_alpha * wall_s
        )

    def cost_estimates(self) -> Dict[Hashable, float]:
        return dict(self._cost)

    # -- planning ------------------------------------------------------------

    def plan(
        self,
        groups: Dict[Tuple[int, Optional[int]], List[Hashable]],
        *,
        backlog: int = 0,
    ) -> List[DispatchPlan]:
        """Order (and maybe coalesce) one tick's ``(tier, rung)``
        groups into dispatch plans."""
        by_tier: Dict[int, List[Tuple[Optional[int], List[Hashable]]]] = {}
        for (tier, rung), sids in groups.items():
            by_tier.setdefault(tier, []).append((rung, sids))
        plans: List[DispatchPlan] = []
        for tier, rung_groups in by_tier.items():
            rung_groups.sort(
                key=lambda rg: -1 if rg[0] is None else rg[0]
            )
            if (
                self.coalesce
                and backlog <= self.coalesce_backlog
                and len(rung_groups) > 1
            ):
                # Deterministic ascending pairing of adjacent rungs.
                for lo in range(0, len(rung_groups) - 1, 2):
                    pair = rung_groups[lo:lo + 2]
                    plans.append(DispatchPlan(
                        tier=tier,
                        rungs=tuple(r for r, _ in pair),
                        sids=tuple(tuple(s) for _, s in pair),
                    ))
                    self.n_coalesced += 1
                if len(rung_groups) % 2:
                    r, sids = rung_groups[-1]
                    plans.append(DispatchPlan(tier, (r,), (tuple(sids),)))
            else:
                plans.extend(
                    DispatchPlan(tier, (r,), (tuple(sids),))
                    for r, sids in rung_groups
                )
        # Most expensive first: its device time overlaps the host-side
        # assembly of everything behind it.  Tie-break on (tier, rungs)
        # for a deterministic issue order.
        plans.sort(
            key=lambda p: (
                -self.estimate(p.key),
                p.tier,
                tuple(-1 if r is None else r for r in p.rungs),
            )
        )
        return plans


def make_controller(
    ladder: Optional[Sequence[int]],
    *,
    start_k: int = 0,
    shrink_margin: int = 2,
    what: str = "start_k",
) -> Optional[KLadderController]:
    """``None``-propagating constructor: no ladder -> no controller."""
    if ladder is None:
        return None
    return KLadderController(
        ladder, start_k=start_k, shrink_margin=shrink_margin, what=what
    )
