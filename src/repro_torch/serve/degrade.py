"""Graceful degradation under overload: deterministic pressure levels
(port of ``repro.serve.degrade``; host logic, a copy).

A :class:`DegradeController` maps a scalar **pressure** signal through
hysteresis into a few discrete levels; each level's :class:`LevelPolicy`
names what :class:`~repro_torch.serve.server.StreamServer` applies every
tick while the level holds:

* **cap adaptive-K rungs** (``rung_cap_down``) this many rungs below the
  top of the ladder — cheaper chunks, the same built step programs;
* **flip queues to drop-oldest + shed stale** (``queue_policy``,
  ``stale_after_ticks``, in ticks, so shed counts are deterministic);
* **defer cold tiers** (``defer_tiers``): the coldest N tiers of a tiered
  pool are not dispatched while the level holds.

No action builds a new step program: capped rungs are ladder rungs,
shedding removes queued work, deferral masks dispatch.

**Pressure** is the max of the queue backlog fraction, the mean arrival
EMA times ``arrival_weight`` (0 disables) and the per-tick service wall
time over ``latency_budget_s`` (``None`` disables — the default, which
keeps pressure a pure function of the chunk/tick sequence).
**Hysteresis**: level ``i`` is entered when pressure holds at or above
``enter[i]`` for ``dwell_ticks`` observations and left when it holds at
or below ``exit[i]`` for as long, one level a step.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from repro_torch.obs.metrics import (
    MetricsRegistry,
    counter_property,
    gauge_property,
)
from repro_torch.serve.ingest import _QUEUE_POLICIES


class LevelPolicy(NamedTuple):
    """The actions one pressure level applies (all strictly
    work-reducing; see the module docstring)."""

    rung_cap_down: int = 0
    queue_policy: Optional[str] = None
    stale_after_ticks: Optional[int] = None
    defer_tiers: int = 0


#: Level 0 — no degradation: the configured behaviour, untouched.
NEUTRAL_POLICY = LevelPolicy()

_DEFAULT_LEVELS = (
    # Level 1 "pressured": freshest-data-wins queues, one rung down.
    LevelPolicy(rung_cap_down=1, queue_policy="drop_oldest",
                stale_after_ticks=4),
    # Level 2 "shedding": two rungs down, tighter staleness deadline,
    # cold-tier dispatch deferred.
    LevelPolicy(rung_cap_down=2, queue_policy="drop_oldest",
                stale_after_ticks=2, defer_tiers=1),
)


class DegradeConfig(NamedTuple):
    """Static shape of the degradation ladder.

    ``enter[i]`` / ``exit[i]`` are the hysteresis thresholds of level
    ``i+1`` (``exit[i] < enter[i]``; ``enter`` strictly increasing);
    ``levels[i]`` its policy.  ``dwell_ticks`` observations must
    confirm a threshold before the level moves (one step at a time).
    """

    enter: Tuple[float, ...] = (0.65, 0.9)
    exit: Tuple[float, ...] = (0.4, 0.65)
    levels: Tuple[LevelPolicy, ...] = _DEFAULT_LEVELS
    dwell_ticks: int = 2
    arrival_weight: float = 0.0
    latency_budget_s: Optional[float] = None


def validate_degrade(cfg: DegradeConfig) -> DegradeConfig:
    """Fail fast on a malformed degradation ladder."""
    n = len(cfg.levels)
    if n == 0:
        raise ValueError("degrade ladder needs at least one level")
    if len(cfg.enter) != n or len(cfg.exit) != n:
        raise ValueError(
            f"enter/exit/levels lengths must match, got "
            f"{len(cfg.enter)}/{len(cfg.exit)}/{n}"
        )
    for i in range(n):
        if cfg.exit[i] >= cfg.enter[i]:
            raise ValueError(
                f"level {i + 1}: exit {cfg.exit[i]} must be strictly "
                f"below enter {cfg.enter[i]} (hysteresis)"
            )
        if i and cfg.enter[i] <= cfg.enter[i - 1]:
            raise ValueError("enter thresholds must be strictly increasing")
    if cfg.dwell_ticks < 1:
        raise ValueError(f"dwell_ticks must be >= 1, got {cfg.dwell_ticks}")
    if cfg.arrival_weight < 0.0:
        raise ValueError("arrival_weight must be >= 0")
    if cfg.latency_budget_s is not None and cfg.latency_budget_s <= 0:
        raise ValueError("latency_budget_s must be positive (or None)")
    for i, lvl in enumerate(cfg.levels):
        if lvl.rung_cap_down < 0 or lvl.defer_tiers < 0:
            raise ValueError(
                f"level {i + 1}: rung_cap_down/defer_tiers must be >= 0"
            )
        if lvl.queue_policy is not None and (
            lvl.queue_policy not in _QUEUE_POLICIES
        ):
            raise ValueError(
                f"level {i + 1}: unknown queue policy "
                f"{lvl.queue_policy!r}; available: {_QUEUE_POLICIES}"
            )
        if lvl.stale_after_ticks is not None and lvl.stale_after_ticks < 1:
            raise ValueError(
                f"level {i + 1}: stale_after_ticks must be >= 1 (or None)"
            )
    return cfg


class DegradeController:
    """Hysteresis state machine from pressure to a discrete level.

    Attach one to a :class:`~repro_torch.serve.server.StreamServer` (its
    ``degrade`` attribute, like the optional latency recorder); the
    server feeds :meth:`observe` once per tick and applies
    :attr:`policy`.  The controller holds no tensors and no clock —
    with ``latency_budget_s`` unset its trajectory is a pure function
    of the observed backlog sequence, so two identical runs degrade
    (and shed) identically.

    The counters live in a :class:`~repro_torch.obs.metrics.MetricsRegistry`
    as the ``degrade_*`` family (pass ``metrics=`` — typically the
    server's own registry — to co-locate them with ``serve_*``; a
    private registry backs them otherwise).  ``level``/``pressure``/
    ``n_*`` are properties over the same cells every export reads.
    """

    level = gauge_property("degrade_level", cast=int)
    pressure = gauge_property("degrade_pressure", cast=float)
    n_observed = counter_property("degrade_observed_total")
    n_transitions = counter_property("degrade_transitions_total")
    #: Chunks shed on this controller's staleness policy (the
    #: server adds each tick's shed count).
    n_shed = counter_property("degrade_shed_total")

    def __init__(
        self,
        cfg: DegradeConfig = DegradeConfig(),
        *,
        metrics: Optional[Any] = None,
    ):
        self.cfg = validate_degrade(cfg)
        self.metrics = (
            metrics if metrics is not None else MetricsRegistry()
        )
        self.level = 0
        self.pressure = 0.0
        self._up = 0
        self._down = 0
        self.n_observed = 0
        self.n_transitions = 0
        self.n_shed = 0
        self.ticks_at_level: List[int] = [0] * (len(cfg.levels) + 1)

    @property
    def policy(self) -> LevelPolicy:
        """The current level's actions (level 0 = neutral)."""
        if self.level == 0:
            return NEUTRAL_POLICY
        return self.cfg.levels[self.level - 1]

    def observe(
        self,
        backlog_frac: float,
        *,
        arrival_ema: float = 0.0,
        service_s: Optional[float] = None,
    ) -> int:
        """Feed one tick's signals; returns the (possibly new) level."""
        p = float(backlog_frac)
        if self.cfg.arrival_weight > 0.0:
            p = max(p, self.cfg.arrival_weight * float(arrival_ema))
        if self.cfg.latency_budget_s is not None and service_s is not None:
            p = max(p, float(service_s) / self.cfg.latency_budget_s)
        self.pressure = p
        self.n_observed += 1
        n = len(self.cfg.levels)
        if self.level < n and p >= self.cfg.enter[self.level]:
            self._up += 1
            self._down = 0
        elif self.level > 0 and p <= self.cfg.exit[self.level - 1]:
            self._down += 1
            self._up = 0
        else:
            self._up = self._down = 0
        if self._up >= self.cfg.dwell_ticks:
            self.level += 1
            self.n_transitions += 1
            self._up = self._down = 0
        elif self._down >= self.cfg.dwell_ticks:
            self.level -= 1
            self.n_transitions += 1
            self._up = self._down = 0
        self.ticks_at_level[self.level] += 1
        return self.level

    def counters(self) -> Dict[str, object]:
        return {
            "level": self.level,
            "pressure": round(self.pressure, 4),
            "n_observed": self.n_observed,
            "n_transitions": self.n_transitions,
            "n_shed": self.n_shed,
            "ticks_at_level": list(self.ticks_at_level),
        }
