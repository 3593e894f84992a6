"""Lossy-link transport wrapper: seeded drop/dup/reorder/corrupt/truncate
(port of ``repro.wire.fault``: the same schedule for the same seed).

:class:`FaultyTransport` sits between a producer (typically a
:class:`~repro_torch.wire.server.ResumableSession`) and any transport with
``send(msg) -> Reply`` (loopback or a real :class:`~repro_torch.wire.server.
WireClient` socket), and damages **data frames** on the deterministic
schedule of a :class:`~repro_torch.runtime.fault.FaultPlan`.  Control frames
and replies always pass through untouched — the model is a lossy
glasses *uplink*, not a broken client library.

Fault semantics (all observable to the producer only through the
protocol's own recovery machinery):

* ``drop`` — the frame is swallowed and an ACK is synthesized, because
  a fire-and-forget uplink has no immediate loss signal; a strict-seq
  server discovers the hole when the next frame arrives and NACKs
  ``seq_gap``, which the session answers with a selective retransmit;
* ``dup`` — delivered twice; the duplicate's reply (the server's
  ``out_of_order`` duplicate signal) is absorbed;
* ``reorder`` — the frame is held (ACK synthesized) and re-delivered
  as a late arrival right after the next forwarded data frame, its
  reply absorbed.  A second reorder while one frame is held releases
  the first (the hold is single-slot, so held frames cannot pile up);
* ``corrupt`` — one payload bit is flipped; the server's CRC check
  refuses it as ``bad_frame`` and the session resends pristine bytes;
* ``truncate`` — only a prefix is delivered; the decode fails the same
  way.

Every action is counted on the plan (``plan.counts``), so a seeded
soak can pin the exact number of each fault kind injected.

Under ``strict_seq=True`` ingest, a :class:`ResumableSession` over a
``FaultyTransport`` converges to the **bit-identical** per-stream state
of the lossless run (pinned in ``tests/test_torch_wire.py``), provided
losses never outlive the session's bounded replay window.  Lax-mode
ingest makes no such promise: a reordered frame's late copy is refused
``out_of_order`` and its content is simply lost.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.runtime.fault import FaultPlan  # noqa: F401  (re-export)
from repro_torch.wire import codec


class FaultyTransport:
    """Wrap ``transport.send`` with a :class:`FaultPlan`'s schedule."""

    def __init__(self, transport, plan: FaultPlan):
        self.transport = transport
        self.plan = plan
        self._held: Optional[bytes] = None

    def __getattr__(self, name):
        # Forward reconnect()/close()/... so a ResumableSession can sit
        # directly on top of the wrapped transport.
        return getattr(self.transport, name)

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _synth_ack(msg) -> codec.Reply:
        _, _, _, sid, seq, *_ = codec.FRAME_HEADER.unpack_from(
            bytes(memoryview(msg)[: codec.FRAME_HEADER.size])
        )
        return codec.Reply(codec.ACK, sid, seq)

    @staticmethod
    def _flip_bit(msg) -> bytes:
        out = bytearray(msg)
        out[-1] ^= 0x01  # last payload byte: breaks the CRC, not the header
        return bytes(out)

    def _release_held(self) -> None:
        if self._held is not None:
            held, self._held = self._held, None
            # Late arrival: the reply (ACK if it fills a gap, or the
            # server's out_of_order duplicate signal) is absorbed — the
            # real sender is long gone.
            self.transport.send(held)

    # -- the transport surface -----------------------------------------------

    def send(self, msg) -> codec.Reply:
        if bytes(memoryview(msg)[:4]) != codec.DATA_MAGIC:
            return self.transport.send(msg)
        action = self.plan.next_action()
        if action == "drop":
            return self._synth_ack(msg)
        if action == "reorder":
            prev, self._held = self._held, bytes(msg)
            if prev is not None:
                self.transport.send(prev)
            return self._synth_ack(msg)
        wire = msg
        if action == "corrupt":
            wire = self._flip_bit(msg)
        elif action == "truncate":
            wire = bytes(memoryview(msg)[: codec.DATA_HEADER_NBYTES + 1])
        reply = self.transport.send(wire)
        if action == "dup":
            self.transport.send(wire)  # duplicate's reply absorbed
        self._release_held()
        return reply
