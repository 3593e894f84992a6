"""Fault-tolerant execution loop: failure detection, restart, stragglers
(port of ``repro.runtime.fault``; ``FaultPlan`` draws the same schedule).

On a fleet this wraps a distributed runtime + a coordinator health
channel; in one process the same control flow is exercised with
*injected* failures (``tests/test_torch_checkpoint.py``), which is what
matters for correctness of the recovery path:

  * ``FaultTolerantLoop.run`` executes steps; any ``WorkerFailure`` (or
    generic exception from the step fn) triggers restore-from-latest-
    checkpoint and replay. Data iterators are step-indexed so replayed
    steps see identical batches (bit-exact recovery, property-tested).
  * Straggler mitigation: per-step wall times feed an EWMA; steps slower
    than ``straggler_factor`` x EWMA are counted and reported — the
    datacenter action (re-slice / evict the slow host) is a deployment
    hook (``on_straggler``), since on one host there is nothing to evict.
  * Elastic restore: checkpoints store full logical arrays, so a restart
    may load them onto another device (see checkpoint/store.py).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    Dict,
    Hashable,
    Iterable,
    List,
    Optional,
    Tuple,
)

import numpy as np

from repro_torch.checkpoint import store


class WorkerFailure(RuntimeError):
    """Raised (or injected) when a worker/host dies mid-step."""


@dataclass
class LoopConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 8
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1


@dataclass
class LoopStats:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    step_times: List[float] = field(default_factory=list)


class FaultTolerantLoop:
    def __init__(
        self,
        cfg: LoopConfig,
        step_fn: Callable[[Any, Any], Tuple[Any, Dict[str, Any]]],
        make_batch: Callable[[int], Any],
        *,
        device=None,
        on_straggler: Optional[Callable[[int, float], None]] = None,
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.make_batch = make_batch
        self.device = device
        self.on_straggler = on_straggler
        self.saver = store.AsyncSaver()
        self.stats = LoopStats()

    def _restore(self, state: Any) -> Tuple[Any, int]:
        # One restore call resolves + loads the newest complete step
        # (falling back past damaged debris on its own) — a separate
        # latest_step probe here would race gc_old between the probe
        # and the load.
        try:
            return store.restore(
                self.cfg.ckpt_dir, state, device=self.device
            )
        except FileNotFoundError:
            return state, 0  # no checkpoint yet: restart from scratch

    def run(self, state: Any, n_steps: int, *, start_step: int = 0) -> Any:
        """Run to ``n_steps`` total, recovering from failures."""
        step = start_step
        ewma = None
        restarts = 0
        # initial checkpoint so a very early failure can restore
        self.saver.save(self.cfg.ckpt_dir, step, state, n_shards=2)
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                batch = self.make_batch(step)
                state, _metrics = self.step_fn(state, batch)
                dt = time.perf_counter() - t0
                self.stats.step_times.append(dt)
                if ewma is None:
                    ewma = dt
                elif dt > self.cfg.straggler_factor * ewma:
                    self.stats.stragglers += 1
                    if self.on_straggler:
                        self.on_straggler(step, dt / ewma)
                    # straggler steps do not poison the EWMA
                else:
                    a = self.cfg.ewma_alpha
                    ewma = (1 - a) * ewma + a * dt
                step += 1
                self.stats.steps_run += 1
                if step % self.cfg.ckpt_every == 0:
                    self.saver.save(
                        self.cfg.ckpt_dir, step, state, n_shards=2
                    )
                    store.gc_old(self.cfg.ckpt_dir, self.cfg.keep)
            except WorkerFailure:
                restarts += 1
                self.stats.restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise
                self.saver.wait()  # never restore over an in-flight save
                state, step = self._restore(state)
        self.saver.wait()
        self.saver.save(self.cfg.ckpt_dir, step, state, n_shards=2)
        self.saver.wait()
        return state


class FailureInjector:
    """Deterministically fail at given crash points (for tests/soaks).

    Crash points are arbitrary hashables: step indices for the training
    loop, or labels like ``("mid_tick", 3)`` / ``"mid_save"`` for the
    serve-layer crash soak (``tests/test_torch_checkpoint.py``).  Each point
    fires exactly once, so the recovery path's *replay* of the same
    point does not re-crash.

    With a :class:`~repro_torch.obs.trace.FlightRecorder` attached
    (``recorder=`` + ``dump_dir=``), every kill point writes the
    recorder's retained tick window as a Chrome-trace post-mortem
    (``flight-<point>.json``) *before* the injected
    :class:`WorkerFailure` propagates — the crash the soak exercises
    leaves the same artifact a production crash handler would.  Dump
    failures never mask the injected fault.
    """

    def __init__(
        self,
        fail_at: Iterable[Hashable],
        *,
        recorder: Optional[Any] = None,
        dump_dir: Optional[str] = None,
    ):
        self.fail_at = set(fail_at)
        self.seen: set = set()
        self.calls = 0
        self.recorder = recorder
        self.dump_dir = dump_dir
        #: Post-mortem dumps written so far, in kill order.
        self.dump_paths: List[str] = []

    def _dump(self, point: Hashable) -> None:
        if self.recorder is None or self.dump_dir is None:
            return
        safe = "".join(
            ch if ch.isalnum() or ch in "-_" else "-" for ch in str(point)
        ).strip("-") or "point"
        path = os.path.join(
            self.dump_dir, f"flight-{safe}-{len(self.dump_paths)}.json"
        )
        try:
            self.recorder.dump(path)
            self.dump_paths.append(path)
        except OSError:
            pass  # a failed post-mortem must not mask the fault itself

    def maybe_fail(self, point: Hashable):
        self.calls += 1
        if point in self.fail_at and point not in self.seen:
            self.seen.add(point)
            self._dump(point)
            raise WorkerFailure(f"injected failure at {point!r}")


class FaultPlan:
    """Seeded lossy-link schedule: one action per data-frame send.

    The wire-layer :class:`~repro_torch.wire.fault.FaultyTransport` asks the
    plan what to do with each data frame it forwards; the answer is one
    of :data:`ACTIONS`.  Determinism is the whole point — a fixed
    ``(seed, rates, at, warmup)`` always yields the identical action
    sequence, so a loss soak's fault pattern (and therefore its
    retransmit/NACK counts) is pinned run over run:

    * ``rates`` maps fault names to per-send probabilities (the
      remainder delivers); one uniform draw is consumed per send index
      *regardless* of overrides, so pinning an index with ``at`` never
      shifts the rest of the schedule;
    * ``at`` pins specific send indices to specific actions — a soak
      can guarantee every fault kind actually fires;
    * indices below ``warmup`` always deliver (let the programs compile
      and the session settle before the link turns hostile).

    ``counts`` tallies the actions actually taken.
    """

    ACTIONS = ("deliver", "drop", "dup", "reorder", "corrupt", "truncate")

    def __init__(
        self,
        *,
        seed: int = 0,
        rates: Optional[Dict[str, float]] = None,
        at: Optional[Dict[int, str]] = None,
        warmup: int = 0,
    ):
        self.rates = dict(rates or {})
        for name, rate in self.rates.items():
            if name not in self.ACTIONS or name == "deliver":
                raise ValueError(
                    f"unknown fault {name!r}; available: "
                    f"{self.ACTIONS[1:]}"
                )
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"rate for {name!r} must be in [0, 1]")
        if sum(self.rates.values()) > 1.0:
            raise ValueError(
                f"fault rates sum to {sum(self.rates.values())} > 1"
            )
        self.at = dict(at or {})
        for idx, name in self.at.items():
            if name not in self.ACTIONS:
                raise ValueError(
                    f"at[{idx}]={name!r} is not one of {self.ACTIONS}"
                )
        self.warmup = warmup
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.n_sent = 0
        self.counts: Dict[str, int] = {a: 0 for a in self.ACTIONS}

    def next_action(self) -> str:
        """The action for the next data-frame send (advances the plan)."""
        i = self.n_sent
        self.n_sent += 1
        # One draw per index no matter what decides the action, so `at`
        # pins and the warmup window never shift the schedule's tail.
        u = float(self._rng.random())
        if i in self.at:
            action = self.at[i]
        elif i < self.warmup:
            action = "deliver"
        else:
            action = "deliver"
            lo = 0.0
            for name, rate in self.rates.items():
                if lo <= u < lo + rate:
                    action = name
                    break
                lo += rate
        self.counts[action] += 1
        return action
