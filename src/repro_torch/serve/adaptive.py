"""Per-stream adaptive K: the host-side bucket-ladder controller (port of
``repro.serve.adaptive``; its ``RungScheduler`` waits for the serving
slice).

:class:`KLadderController` is a plain host-side object with no tensors.
``EPICCompressor(k_ladder=...)`` owns one per session and walks
``cfg.prefilter_k`` across the ladder's rungs between chunks:

* **grow** one rung when the chunk reported any ``n_prefilter_overflow``
  (the candidate budget truncated real work);
* **shrink** one rung when the chunk's peak per-frame ``n_full_checks``
  would fit the next-lower rung with a ``shrink_margin``x margin.

The rule is a pure function of the per-chunk stats trajectory: a fixed
ladder and a fixed chunk sequence always give the same K trajectory, and
a controller that never moves gives the fixed-K run.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Optional, Sequence, Tuple

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
