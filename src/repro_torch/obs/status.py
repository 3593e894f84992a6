"""Server introspection: the host-side truth behind the STATUS frame (port
of ``repro.obs.status``; host-side Python, the same JSON document).

:func:`collect_status` snapshots one :class:`~repro_torch.wire.server.
IngestServer` (and the :class:`~repro_torch.serve.server.StreamServer` behind
it) into a JSON-safe dict — tier occupancy, per-stream queue depths,
credit outstanding/granted, degrade level, wire seq cursors, both
counter views, and the full ``STATUS_REASONS`` table so a client can
render every NACK it will ever receive without a second lookup.

The ingest server serves it over the wire as the ``STATUS`` control
frame (EPWC op 5, see :mod:`repro_torch.wire.codec`): the caller already
holds the ingest lock when the handler runs, so the snapshot is
consistent with respect to concurrent submits and ticks.

JSON constraints: dict keys are strings (stream ids are stringified;
clients that need ints convert back), values are plain
int/float/str/bool/None/list/dict.
"""

from __future__ import annotations

from typing import Any, Dict

#: Bumped when the status payload shape changes incompatibly.
STATUS_SCHEMA = 1


def _tier_occupancy(srv) -> list:
    pools = list(srv.pool.tiers) if srv._tiered else [srv.pool]
    return [
        {
            "tier": i,
            "capacity": p.capacity,
            "n_active": p.n_active,
            "free_slots": len(p.free_slots()),
        }
        for i, p in enumerate(pools)
    ]


def collect_status(ingest) -> Dict[str, Any]:
    """One consistent, JSON-safe snapshot of an ingest frontier.

    Call with the ingest lock held (the wire STATUS handler does; a
    host-side caller that is the only thread may call it bare).
    """
    from repro_torch.wire import codec  # wire is an optional layer elsewhere

    srv = ingest.srv
    degrade = srv.degrade
    return {
        "schema": STATUS_SCHEMA,
        "tick": srv.n_ticks,
        "tiers": _tier_occupancy(srv),
        "queue_depths": {
            str(sid): len(q) for sid, q in srv._queues.items()
        },
        "credit": {
            "outstanding": sum(ingest._credit.values()),
            "granted": ingest.n_credit_granted,
            "requests": ingest.n_credit_requests,
            "by_stream": {
                str(sid): int(v) for sid, v in ingest._credit.items()
            },
        },
        "degrade": (
            {"level": 0, "pressure": 0.0, "attached": False}
            if degrade is None
            else {"attached": True, **degrade.counters()}
        ),
        "seq_cursors": {
            str(sid): int(v) for sid, v in ingest._seq_seen.items()
        },
        "server_counters": {
            k: v for k, v in srv.server_counters().items()
        },
        # The per-stream gap map is re-keyed to strings here (not left
        # to json.dumps' implicit coercion) so the payload is identical
        # whether it is inspected host-side or after a wire round-trip.
        "wire_counters": {
            **ingest.counters(),
            "seq_gaps_by_stream": {
                str(k): int(v)
                for k, v in ingest.seq_gaps_by_stream.items()
            },
        },
        "status_reasons": {
            str(code): reason
            for code, reason in codec.STATUS_REASONS.items()
        },
    }
