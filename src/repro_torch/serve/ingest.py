"""Chunk ingest for the serving runtime (port of ``repro.serve.ingest``).

Both pieces are bit-identical to synchronous ingest
(``tests/test_torch_serve.py``): they move only *when* bytes cross the
host-to-device boundary, never what is computed.

* :class:`Prefetch` — a chunk-axis combinator (registered as
  ``"prefetch"``, next to the frame-axis ``"gated"``): wraps an iterable
  of :class:`~repro_torch.api.types.SensorChunk` and keeps ``depth``
  chunks in flight.  On the card a chunk goes host to device as
  ``non_blocking`` copies from pinned memory on a side stream, and the
  consumer's stream waits on an event recorded after them, so the copy
  of chunk ``i+1`` overlaps the step of chunk ``i``; on the CPU it is a
  plain conversion.
* :class:`ChunkQueue` — the server-side bounded per-stream queue, with
  backpressure (``"refuse"``) or freshest-data-wins (``"drop_oldest"``)
  and tick-stamped staleness shedding.

:func:`chunk_to_device` is the copy both the server's ``submit`` and
``Prefetch`` make: no host sync for a chunk that lies on the host.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Deque, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.registry import register_combinator
from repro_torch.api.types import SensorChunk


def chunk_to_device(chunk: SensorChunk, device: torch.device) -> SensorChunk:
    """Every field of ``chunk`` as a contiguous float32 tensor on
    ``device``, in memory of its own: never a view of the caller's
    buffer, which the caller may reuse.  Host data bound for the card is
    staged in pinned memory and copied ``non_blocking`` on the current
    stream: the copy makes no host sync and is ordered before any later
    work on that stream."""

    def put(x):
        if x is None:
            return None
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x, dtype=np.float32))
        if device.type == "cuda" and x.device.type == "cpu":
            staged = x.to(torch.float32).contiguous().pin_memory()
            return staged.to(device, non_blocking=True)
        return x.to(device, torch.float32, copy=True,
                    memory_format=torch.contiguous_format)

    return SensorChunk(*(put(x) for x in chunk))


@register_combinator("prefetch")
class Prefetch:
    """Iterate chunks with the host-to-device copy running ahead.

    Args:
      chunks: the upstream chunk source (an iterable of
        :class:`SensorChunk`, fields numpy arrays or tensors).
      depth: how many chunks to keep in flight beyond the one being
        consumed (``1`` = double buffering).
      device: where the chunks go (``None``: the CUDA card, which raises
        without one; ``"cpu"`` for a plain conversion).

    The copies stage the same values, so iterating through a ``Prefetch``
    is bit-identical to iterating the source.
    """

    name = "prefetch"

    def __init__(
        self,
        chunks: Iterable[Any],
        *,
        depth: int = 1,
        device=None,
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.chunks = chunks
        self.depth = depth
        self.device = resolve_device(device)

    def _put(self, chunk: Any, stream) -> Tuple[SensorChunk, Any]:
        if stream is None:
            return chunk_to_device(chunk, self.device), None
        with torch.cuda.stream(stream):
            out = chunk_to_device(chunk, self.device)
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def _take(self, entry: Tuple[SensorChunk, Any]) -> SensorChunk:
        chunk, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for x in chunk:
                if x is not None:
                    # Made on the side stream, used on the consumer's: the
                    # allocator must not reuse the memory before that use.
                    x.record_stream(consumer)
        return chunk

    def __iter__(self) -> Iterator[SensorChunk]:
        stream = (torch.cuda.Stream(self.device)
                  if self.device.type == "cuda" else None)
        buf: Deque[Tuple[SensorChunk, Any]] = deque()
        for chunk in self.chunks:
            buf.append(self._put(chunk, stream))
            if len(buf) > self.depth:
                yield self._take(buf.popleft())
        while buf:
            yield self._take(buf.popleft())


_QUEUE_POLICIES = ("refuse", "drop_oldest")


class ChunkQueue:
    """Bounded FIFO of pending :class:`SensorChunk` for one stream.

    ``maxlen`` bounds host memory per stream.  A push onto a full queue
    follows ``policy``:

    * ``"refuse"`` (default): the *new* chunk is refused (``push``
      returns ``False``) and counted in ``n_overflow`` — the server
      surfaces the aggregate as its backpressure telemetry (a wire
      producer sees it as a NACK and retries);
    * ``"drop_oldest"``: the *oldest* queued chunk is discarded to
      admit the new one (``push`` returns ``True``; the drop is counted
      in ``n_dropped``) — freshest-data-wins for latency-sensitive
      streams that would rather skip frames than fall behind.

    Every entry records its enqueue timestamp (``clock()``, default
    ``time.monotonic``), so latency telemetry can split queueing delay
    from compute delay; ``pop_entry`` hands the timestamp back with the
    chunk while ``pop`` keeps the legacy chunk-only signature.

    Entries may additionally carry a **logical tick stamp** (``push``'s
    ``tick`` argument; the server stamps its ``n_ticks``).
    :meth:`shed_stale` drops queued chunks whose stamp has fallen
    behind a staleness deadline — the graceful-degradation
    controller's load-shedding primitive.  Ticks, not wall seconds,
    so shed counts are deterministic for a deterministic chunk/tick
    sequence.
    """

    def __init__(
        self,
        maxlen: int = 2,
        *,
        policy: str = "refuse",
        clock: Callable[[], float] = time.monotonic,
    ):
        if maxlen < 1:
            raise ValueError(f"queue maxlen must be >= 1, got {maxlen}")
        if policy not in _QUEUE_POLICIES:
            raise ValueError(
                f"unknown queue policy {policy!r}; "
                f"available: {_QUEUE_POLICIES}"
            )
        self.maxlen = maxlen
        self.policy = policy
        self.clock = clock
        self._q: Deque[Tuple[SensorChunk, float, Optional[int]]] = deque()
        self.n_pushed = 0
        self.n_overflow = 0
        self.n_dropped = 0
        self.n_shed = 0

    def __len__(self) -> int:
        return len(self._q)

    def push(
        self,
        chunk: SensorChunk,
        *,
        ts: Optional[float] = None,
        tick: Optional[int] = None,
    ) -> bool:
        if self.refuse_if_full():
            return False
        if len(self._q) >= self.maxlen:  # "drop_oldest"
            self._q.popleft()
            self.n_dropped += 1
        self._q.append((chunk, self.clock() if ts is None else ts, tick))
        self.n_pushed += 1
        return True

    def refuse_if_full(self) -> bool:
        """Whether a push now is refused (a full ``"refuse"`` queue),
        counting the refusal in ``n_overflow``.  :meth:`push` refuses
        through it; a caller may ask first, before it copies the chunk."""
        if len(self._q) >= self.maxlen and self.policy == "refuse":
            self.n_overflow += 1
            return True
        return False

    def pop(self) -> Optional[SensorChunk]:
        return self._q.popleft()[0] if self._q else None

    def pop_entry(self) -> Optional[Tuple[SensorChunk, float]]:
        """Pop ``(chunk, enqueue_ts)`` — ``None`` when empty."""
        entry = self._q.popleft() if self._q else None
        return None if entry is None else (entry[0], entry[1])

    def pop_full(self) -> Optional[Tuple[SensorChunk, float, Optional[int]]]:
        """Pop ``(chunk, enqueue_ts, enqueue_tick)`` — ``None`` when
        empty; the tick is ``None`` for unstamped pushes."""
        return self._q.popleft() if self._q else None

    def shed_stale(self, before_tick: int) -> int:
        """Drop queued chunks stamped before ``before_tick`` (FIFO, so
        stale entries are always at the head).  Unstamped entries are
        never shed.  Returns the number dropped (also ``n_shed``)."""
        n = 0
        while (
            self._q
            and self._q[0][2] is not None
            and self._q[0][2] < before_tick
        ):
            self._q.popleft()
            self.n_shed += 1
            n += 1
        return n

    def peek(self) -> Optional[SensorChunk]:
        return self._q[0][0] if self._q else None
