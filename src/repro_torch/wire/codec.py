"""Versioned zero-copy wire format for
:class:`~repro_torch.api.types.SensorChunk` (port of ``repro.wire.codec``;
the bytes are the reference's, byte for byte).

One **data frame** carries one chunk of one stream:

::

    offset  size  field
    ------  ----  -----------------------------------------------------
    0       4     magic  b"EPWF"
    4       2     version (u16, currently 1)
    6       2     flags   (bit 0: depth field present)
    8       8     stream id (u64)
    16      8     seq (u64, per-stream chunk counter)
    24      8     timestamp (u64 ns, producer's monotonic clock)
    32      4     payload CRC32 (zlib.crc32 over the whole payload)
    36      8     payload nbytes (u64)
    44      4x26  field table: 4 slots (frames, poses, gazes, depth),
                  each ``<BB6I``: dtype code, ndim, up to 6 dims
    148     ...   payload: the 4 raw field buffers, C-order, back to back

The header is a fixed 148 bytes (``FRAME_HEADER.size`` + 4 slots), so a
transport can read exactly ``DATA_HEADER_NBYTES`` bytes and know the
frame's total length; decode slices the payload through ``memoryview``
into ``torch.frombuffer`` views — **no payload copy** — and fails fast on
truncated, corrupt (CRC), wrong-magic, or wrong-version frames.

Two small fixed-size companions share the transport framing:

* **control frames** (magic ``b"EPWC"``): session ``OPEN`` / ``CLOSE``
  for one stream id — the ingest server maps them to slot admit/evict —
  plus ``RESUME`` (one extra u64: the client's seq cursor), which
  re-binds a dropped connection to its live or just-restored slot and
  tells the client where to start replaying its send window, and
  ``CREDIT`` (one extra u64: the requested window), the client half of
  credit-based flow control — the server's ACK carries the number of
  credits actually granted (sized to the stream's queue headroom, so a
  paced producer never runs into ``NACK_BACKPRESSURE``), and
  ``STATUS`` (op 5), the introspection request — answered not with an
  EPWR ack but with a **status reply** (magic ``b"EPWS"``): a small
  fixed header + a UTF-8 JSON snapshot of the server's occupancy,
  queues, credit state, degrade level, seq cursors and the
  ``STATUS_REASONS`` table (see :mod:`repro_torch.obs.status`);
* **replies** (magic ``b"EPWR"``): per-message ACK/NACK with a status
  code, so producers see backpressure (``NACK_BACKPRESSURE``) and
  admission failures (``NACK_POOL_FULL``) instead of silent drops.

Encode accepts tensors or numpy field arrays (card tensors are fetched
to the host together, with one sync); decode returns CPU tensor views of
the buffer, which ``StreamServer.submit`` stages through pinned memory to
the card — the decode→device path round-trips bit-identically (pinned in
``tests/test_torch_wire.py``).  Dtype code 12 is ``torch.bfloat16``.
"""

from __future__ import annotations

import struct
import warnings
import zlib
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.api.types import SensorChunk

Buffer = Union[bytes, bytearray, memoryview]

# Decode views a read-only buffer (``bytes``), which PyTorch warns about
# once a process; the views are only read, and ``submit`` copies them.
# One filter, installed here, so no decode touches the global filters.
warnings.filterwarnings(
    "ignore", message="The given buffer is not writable", category=UserWarning
)

WIRE_VERSION = 1

DATA_MAGIC = b"EPWF"
CTRL_MAGIC = b"EPWC"
REPLY_MAGIC = b"EPWR"
STATUS_MAGIC = b"EPWS"

_FLAG_HAS_DEPTH = 1

# magic, version, flags, stream_id, seq, timestamp_ns, crc32, payload_nbytes
FRAME_HEADER = struct.Struct("<4sHHQQQIQ")
# dtype code, ndim, 6 dims (unused dims zero)
FIELD_SLOT = struct.Struct("<BB6I")
N_FIELD_SLOTS = 4  # frames, poses, gazes, depth
MAX_NDIM = 6
DATA_HEADER_NBYTES = FRAME_HEADER.size + N_FIELD_SLOTS * FIELD_SLOT.size

# magic, version, op, stream_id
CONTROL = struct.Struct("<4sHHQ")
# RESUME rides the control magic with one extra u64: the first seq the
# client has NOT seen ACKed (``last_acked + 1``, so a fresh session —
# last_acked = -1 — still packs as unsigned 0).
RESUME = struct.Struct("<4sHHQQ")
# CREDIT shares the RESUME layout; the extra u64 is the number of send
# credits the client requests.  The server's ACK carries the grant.
CREDIT = RESUME
OP_OPEN = 1
OP_CLOSE = 2
OP_RESUME = 3
OP_CREDIT = 4
# STATUS: request the server's introspection snapshot — tier
# occupancy, queue depths, credit state, degrade level, seq cursors and
# the STATUS_REASONS table.  The reply is a STATUS REPLY frame (magic
# EPWS, JSON payload), not a plain EPWR ack; stream_id is ignored
# (status is server-wide) and 0 by convention.
OP_STATUS = 5
_OPS = {
    OP_OPEN: "open",
    OP_CLOSE: "close",
    OP_RESUME: "resume",
    OP_CREDIT: "credit",
    OP_STATUS: "status",
}

# magic, version, status, stream_id, seq
REPLY = struct.Struct("<4sHHQQ")
# STATUS REPLY header: magic, version, reserved (0), payload nbytes —
# followed by a UTF-8 JSON payload (the introspection snapshot of
# repro_torch.obs.status.collect_status).  Variable length: status is a
# low-rate diagnostic channel, so a JSON body beats inventing a binary
# schema for a dict that grows with every serving feature.
STATUS_REPLY = struct.Struct("<4sHHQ")
MAX_STATUS_NBYTES = 1 << 24  # fail fast on absurd/corrupt lengths
ACK = 0
NACK_BACKPRESSURE = 1
NACK_POOL_FULL = 2
NACK_UNKNOWN_STREAM = 3
NACK_BAD_FRAME = 4
NACK_DUP_STREAM = 5
NACK_OUT_OF_ORDER = 6
NACK_SEQ_GAP = 7
STATUS_NAMES = {
    ACK: "ack",
    NACK_BACKPRESSURE: "backpressure",
    NACK_POOL_FULL: "pool_full",
    NACK_UNKNOWN_STREAM: "unknown_stream",
    NACK_BAD_FRAME: "bad_frame",
    NACK_DUP_STREAM: "dup_stream",
    NACK_OUT_OF_ORDER: "out_of_order",
    NACK_SEQ_GAP: "seq_gap",
}
# One producer-visible sentence per status code: what happened and what
# the producer should do about it.  Every code in STATUS_NAMES has
# exactly one entry (pinned by a table-driven test), so client logs and
# error messages never invent their own wording per call site.
STATUS_REASONS = {
    ACK: "accepted",
    NACK_BACKPRESSURE: (
        "stream queue is full; retry the same seq after a serving tick "
        "(or pace on a CREDIT window to avoid the round trip)"
    ),
    NACK_POOL_FULL: (
        "no free serving slot for a new stream; close a stream, retry "
        "later, or serve with an eviction policy"
    ),
    NACK_UNKNOWN_STREAM: (
        "stream id is not open on this server (never opened, closed, "
        "or evicted); send OPEN — or RESUME if the slot may be live"
    ),
    NACK_BAD_FRAME: (
        "message failed to decode (truncated, corrupt CRC, bad magic "
        "or version) or is unserveable as submitted; re-encode and "
        "resend the same seq"
    ),
    NACK_DUP_STREAM: (
        "stream id is already open; pick a fresh id (or RESUME the "
        "existing session instead of re-opening it)"
    ),
    NACK_OUT_OF_ORDER: (
        "seq regressed or duplicated a frame the server already "
        "served; the frame was not re-served"
    ),
    NACK_SEQ_GAP: (
        "strict-seq stream is missing earlier seqs; the reply's seq is "
        "the first missing one — retransmit [reply.seq, attempted seq) "
        "in order, then resend the attempted frame"
    ),
}

# Wire dtype codes.  Fixed small vocabulary: the codec fails fast on a
# dtype it cannot name rather than shipping opaque bytes.
_CODE_TO_DTYPE = {
    0: torch.uint8,
    1: torch.int8,
    2: torch.uint16,
    3: torch.int16,
    4: torch.uint32,
    5: torch.int32,
    6: torch.uint64,
    7: torch.int64,
    8: torch.float16,
    9: torch.float32,
    10: torch.float64,
    11: torch.bool,
    12: torch.bfloat16,
}
_DTYPE_TO_CODE = {dt: code for code, dt in _CODE_TO_DTYPE.items()}
# numpy arrays name their dtype; bfloat16 arrives as a named void dtype
# (ml_dtypes), recognised by name so that nothing imports ml_dtypes.
_NAME_TO_CODE = {str(dt).removeprefix("torch."): c
                 for dt, c in _DTYPE_TO_CODE.items()}

class WireFormatError(ValueError):
    """A frame that must not be ingested: truncated, wrong magic or
    version, malformed field table, or inconsistent sizes."""


class WireCRCError(WireFormatError):
    """Payload bytes do not match the header's CRC32."""


class WireFrame(NamedTuple):
    """A decoded data frame: header scalars + a zero-copy chunk view."""

    stream_id: int
    seq: int
    timestamp_ns: int
    chunk: SensorChunk  # CPU tensor views into the source buffer


class ControlFrame(NamedTuple):
    op: int  # OP_OPEN / OP_CLOSE / OP_RESUME / OP_CREDIT
    stream_id: int
    # RESUME: the first seq the client has not seen ACKed
    # (``last_acked + 1``).  CREDIT: the requested credit count.
    # 0 for OPEN/CLOSE.
    seq: int = 0

    @property
    def op_name(self) -> str:
        return _OPS.get(self.op, f"op{self.op}")


class Reply(NamedTuple):
    status: int
    stream_id: int
    seq: int

    @property
    def ok(self) -> bool:
        return self.status == ACK

    @property
    def status_name(self) -> str:
        return STATUS_NAMES.get(self.status, f"status{self.status}")


class _Field(NamedTuple):
    """One field as the wire sees it: code, shape and raw C-order bytes."""

    code: int
    shape: Tuple[int, ...]
    data: bytes


def _host_fields(xs) -> list:
    """Each field as a contiguous host array or tensor; card tensors are
    copied into pinned memory together and waited for once."""
    out, on_card = [], False
    for x in xs:
        if x is None or not isinstance(x, torch.Tensor):
            out.append(None if x is None else np.ascontiguousarray(x))
        elif x.device.type == "cpu":
            out.append(x.detach().contiguous())
        else:
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            h.copy_(x.detach(), non_blocking=True)
            out.append(h)
            on_card = True
    if on_card:
        torch.cuda.synchronize()
    return out


def _field(x) -> Optional[_Field]:
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        code = _DTYPE_TO_CODE.get(x.dtype)
        name = str(x.dtype)
        data = lambda: x.reshape(-1).view(torch.uint8).numpy().tobytes()
    else:
        code = _NAME_TO_CODE.get(x.dtype.name) if x.dtype.isnative else None
        name = str(x.dtype)
        data = x.tobytes
    if code is None:
        raise WireFormatError(
            f"dtype {name} has no wire code; supported: "
            f"{sorted(_NAME_TO_CODE)}"
        )
    if x.ndim > MAX_NDIM:
        raise WireFormatError(
            f"ndim {x.ndim} exceeds the wire maximum {MAX_NDIM}"
        )
    return _Field(code, tuple(x.shape), data())


def _pack_slot(f: Optional[_Field]) -> bytes:
    if f is None:
        return FIELD_SLOT.pack(0, 0, 0, 0, 0, 0, 0, 0)
    dims = list(f.shape) + [0] * (MAX_NDIM - len(f.shape))
    return FIELD_SLOT.pack(f.code, len(f.shape), *dims)


def encode_chunk(
    chunk: SensorChunk,
    *,
    stream_id: int,
    seq: int,
    timestamp_ns: int,
) -> bytes:
    """Serialize one chunk into a self-delimiting data frame."""
    fields = [_field(x) for x in _host_fields(chunk)]
    flags = 0 if chunk.depth is None else _FLAG_HAS_DEPTH
    payload = b"".join(f.data for f in fields if f is not None)
    header = FRAME_HEADER.pack(
        DATA_MAGIC,
        WIRE_VERSION,
        flags,
        stream_id,
        seq,
        timestamp_ns,
        zlib.crc32(payload),
        len(payload),
    )
    table = b"".join(_pack_slot(f) for f in fields)
    return header + table + payload


def frame_nbytes(buf: Buffer) -> int:
    """Total frame length, from a prefix of ≥ ``FRAME_HEADER.size``
    bytes (lets a byte-stream transport delimit frames itself)."""
    if len(buf) < FRAME_HEADER.size:
        raise WireFormatError(
            f"need {FRAME_HEADER.size} header bytes to size a frame, "
            f"got {len(buf)}"
        )
    magic, version, _, _, _, _, _, payload_nbytes = FRAME_HEADER.unpack_from(
        bytes(memoryview(buf)[: FRAME_HEADER.size])
    )
    _check_magic_version(magic, DATA_MAGIC, version)
    return DATA_HEADER_NBYTES + payload_nbytes


def _check_magic_version(magic: bytes, expect: bytes, version: int) -> None:
    if magic != expect:
        raise WireFormatError(
            f"bad magic {magic!r} (expected {expect!r})"
        )
    if version != WIRE_VERSION:
        raise WireFormatError(
            f"wire version {version} not supported (this codec speaks "
            f"version {WIRE_VERSION})"
        )


def decode_frame(buf: Buffer, *, verify_crc: bool = True) -> WireFrame:
    """Decode a data frame into header scalars + zero-copy field views.

    The returned ``SensorChunk`` fields are ``torch.frombuffer`` views
    of ``buf`` (CPU tensors) — no payload bytes are copied.  Mutating the
    source buffer changes them; copy (``StreamServer.submit`` does, to
    the card) before the buffer is reused.  Raises
    :class:`WireFormatError` on any structural problem and
    :class:`WireCRCError` on payload corruption.
    """
    view = memoryview(buf)
    if len(view) < DATA_HEADER_NBYTES:
        raise WireFormatError(
            f"truncated frame: {len(view)} bytes < "
            f"{DATA_HEADER_NBYTES}-byte header"
        )
    (
        magic,
        version,
        flags,
        stream_id,
        seq,
        timestamp_ns,
        crc,
        payload_nbytes,
    ) = FRAME_HEADER.unpack_from(bytes(view[: FRAME_HEADER.size]))
    _check_magic_version(magic, DATA_MAGIC, version)
    total = DATA_HEADER_NBYTES + payload_nbytes
    if len(view) < total:
        raise WireFormatError(
            f"truncated frame: header promises {total} bytes, "
            f"got {len(view)}"
        )

    has_depth = bool(flags & _FLAG_HAS_DEPTH)
    slots = []
    for i in range(N_FIELD_SLOTS):
        off = FRAME_HEADER.size + i * FIELD_SLOT.size
        code, ndim, *dims = FIELD_SLOT.unpack_from(
            bytes(view[off : off + FIELD_SLOT.size])
        )
        if ndim > MAX_NDIM:
            raise WireFormatError(f"field {i}: ndim {ndim} > {MAX_NDIM}")
        slots.append((code, tuple(dims[:ndim])))
    want_fields = 4 if has_depth else 3

    payload = view[DATA_HEADER_NBYTES : total]
    if verify_crc and zlib.crc32(payload) != crc:
        raise WireCRCError(
            f"payload CRC mismatch on stream {stream_id} seq {seq}"
        )

    arrays = []
    lo = 0
    for i in range(want_fields):
        code, shape = slots[i]
        dtype = _CODE_TO_DTYPE.get(code)
        if dtype is None:
            raise WireFormatError(f"field {i}: unknown dtype code {code}")
        nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if lo + nbytes > payload_nbytes:
            raise WireFormatError(
                f"field {i}: table wants {nbytes} bytes at offset {lo} "
                f"but payload is {payload_nbytes} bytes"
            )
        arrays.append(_view(payload[lo : lo + nbytes], dtype, shape))
        lo += nbytes
    if lo != payload_nbytes:
        raise WireFormatError(
            f"payload has {payload_nbytes - lo} trailing bytes beyond "
            f"the field table"
        )

    chunk = SensorChunk(
        arrays[0], arrays[1], arrays[2], arrays[3] if has_depth else None
    ).validate()
    return WireFrame(stream_id, seq, timestamp_ns, chunk)


def _view(buf: memoryview, dtype: torch.dtype, shape) -> torch.Tensor:
    if not len(buf):
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(buf, dtype=dtype).reshape(shape)


# -- control / reply frames --------------------------------------------------


def encode_control(op: int, stream_id: int) -> bytes:
    if op == OP_RESUME:
        raise WireFormatError(
            "RESUME carries a seq cursor; use encode_resume()"
        )
    if op == OP_CREDIT:
        raise WireFormatError(
            "CREDIT carries a requested window; use encode_credit()"
        )
    if op not in _OPS:
        raise WireFormatError(f"unknown control op {op}")
    return CONTROL.pack(CTRL_MAGIC, WIRE_VERSION, op, stream_id)


def encode_resume(stream_id: int, last_acked_seq: int) -> bytes:
    """The reconnect handshake: re-bind a dropped connection to its
    live (or just-restored) stream, keyed on (stream id, last-acked
    seq).  ``last_acked_seq`` is the highest seq the *client* has seen
    ACKed (``-1`` for none); the wire carries ``last_acked_seq + 1`` so
    the field stays unsigned."""
    if last_acked_seq < -1:
        raise WireFormatError(
            f"last_acked_seq must be >= -1, got {last_acked_seq}"
        )
    return RESUME.pack(
        CTRL_MAGIC, WIRE_VERSION, OP_RESUME, stream_id, last_acked_seq + 1
    )


def encode_credit(stream_id: int, requested: int) -> bytes:
    """Request send credits for one stream.

    ``requested`` is the window the client would like; the server's ACK
    reply carries the number actually granted in its ``seq`` field —
    ``min(requested, queue headroom - credits already outstanding)``,
    possibly 0 when the stream's queue is full.  A granted credit is
    consumed by one accepted data frame.
    """
    if requested < 1:
        raise WireFormatError(
            f"credit request must be >= 1, got {requested}"
        )
    return CREDIT.pack(
        CTRL_MAGIC, WIRE_VERSION, OP_CREDIT, stream_id, requested
    )


def decode_control(buf: Buffer) -> ControlFrame:
    if len(buf) < CONTROL.size:
        raise WireFormatError(
            f"truncated control frame: {len(buf)} < {CONTROL.size}"
        )
    magic, version, op, stream_id = CONTROL.unpack_from(
        bytes(memoryview(buf)[: CONTROL.size])
    )
    _check_magic_version(magic, CTRL_MAGIC, version)
    if op in (OP_RESUME, OP_CREDIT):
        wide = RESUME if op == OP_RESUME else CREDIT
        name = _OPS[op].upper()
        if len(buf) < wide.size:
            raise WireFormatError(
                f"truncated {name} frame: {len(buf)} < {wide.size}"
            )
        *_, seq = wide.unpack_from(bytes(memoryview(buf)[: wide.size]))
        return ControlFrame(op, stream_id, seq)
    if op not in _OPS:
        raise WireFormatError(f"unknown control op {op}")
    return ControlFrame(op, stream_id)


def encode_reply(status: int, stream_id: int, seq: int = 0) -> bytes:
    return REPLY.pack(REPLY_MAGIC, WIRE_VERSION, status, stream_id, seq)


def decode_reply(buf: Buffer) -> Reply:
    if len(buf) < REPLY.size:
        raise WireFormatError(
            f"truncated reply: {len(buf)} < {REPLY.size}"
        )
    magic, version, status, stream_id, seq = REPLY.unpack_from(
        bytes(memoryview(buf)[: REPLY.size])
    )
    _check_magic_version(magic, REPLY_MAGIC, version)
    return Reply(status, stream_id, seq)


def encode_status_reply(status: dict) -> bytes:
    """Serialize one introspection snapshot as a STATUS REPLY frame."""
    import json

    payload = json.dumps(status, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_STATUS_NBYTES:
        raise WireFormatError(
            f"status payload of {len(payload)} bytes exceeds the "
            f"{MAX_STATUS_NBYTES}-byte limit"
        )
    header = STATUS_REPLY.pack(
        STATUS_MAGIC, WIRE_VERSION, 0, len(payload)
    )
    return header + payload


def decode_status_reply(buf: Buffer) -> dict:
    """Decode a STATUS REPLY frame back into the snapshot dict."""
    import json

    view = memoryview(buf)
    if len(view) < STATUS_REPLY.size:
        raise WireFormatError(
            f"truncated status reply: {len(view)} < {STATUS_REPLY.size}"
        )
    magic, version, _reserved, nbytes = STATUS_REPLY.unpack_from(
        bytes(view[: STATUS_REPLY.size])
    )
    _check_magic_version(magic, STATUS_MAGIC, version)
    if nbytes > MAX_STATUS_NBYTES:
        raise WireFormatError(
            f"status payload of {nbytes} bytes exceeds the "
            f"{MAX_STATUS_NBYTES}-byte limit"
        )
    total = STATUS_REPLY.size + nbytes
    if len(view) < total:
        raise WireFormatError(
            f"truncated status reply: header promises {total} bytes, "
            f"got {len(view)}"
        )
    try:
        return json.loads(bytes(view[STATUS_REPLY.size : total]))
    except ValueError as e:
        raise WireFormatError(f"malformed status payload: {e}") from None


def decode_message(
    buf: Buffer, *, verify_crc: bool = True
) -> Tuple[str, Union[WireFrame, ControlFrame, Reply]]:
    """Dispatch one framed message on its magic.

    Returns ``("data", WireFrame)``, ``("control", ControlFrame)``,
    ``("reply", Reply)`` or ``("status", dict)``; raises
    :class:`WireFormatError` otherwise.
    """
    head = bytes(memoryview(buf)[:4])
    if head == DATA_MAGIC:
        return "data", decode_frame(buf, verify_crc=verify_crc)
    if head == CTRL_MAGIC:
        return "control", decode_control(buf)
    if head == REPLY_MAGIC:
        return "reply", decode_reply(buf)
    if head == STATUS_MAGIC:
        return "status", decode_status_reply(buf)
    raise WireFormatError(f"bad magic {head!r}")
