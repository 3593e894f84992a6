"""Shared types for the streaming compressor API (port of
``repro.api.types``).

:class:`SensorChunk` bundles the synchronized sensor modalities of one
span of an egocentric stream — the chunked-ingest unit a compressor's
``step`` consumes.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import Tensor


class SensorChunk(NamedTuple):
    """A span of synchronized sensor data (leading time axis ``T``).

    ``depth`` is ``None`` unless running with oracle depth.
    """

    frames: Tensor  # (T, H, W, 3) RGB
    poses: Tensor  # (T, 4, 4) camera-to-world (IMU track)
    gazes: Tensor  # (T, 2) gaze point (u, v) in pixels
    depth: Optional[Tensor] = None  # (T, H, W) metric depth, oracle mode

    @property
    def n_frames(self) -> int:
        return self.frames.shape[0]

    def validate(self) -> "SensorChunk":
        """Fail fast on cross-field shape disagreement; returns ``self``."""
        t = self.frames.shape[0]
        for name in ("poses", "gazes", "depth"):
            f = getattr(self, name)
            if f is not None and f.shape[0] != t:
                raise ValueError(
                    f"SensorChunk field shapes disagree on the leading "
                    f"axis: frames has {t}, {name} has {f.shape[0]} "
                    f"(frames{tuple(self.frames.shape)} vs "
                    f"{name}{tuple(f.shape)})"
                )
        if self.depth is not None and (
            tuple(self.depth.shape) != tuple(self.frames.shape[:-1])
        ):
            raise ValueError(
                f"SensorChunk depth{tuple(self.depth.shape)} must match "
                f"frames{tuple(self.frames.shape)} minus the channel axis "
                f"(expected {tuple(self.frames.shape[:-1])})"
            )
        return self

    def slice(self, start: int, stop: int) -> "SensorChunk":
        """Time slice (static indices)."""
        self.validate()
        return SensorChunk(
            self.frames[start:stop],
            self.poses[start:stop],
            self.gazes[start:stop],
            None if self.depth is None else self.depth[start:stop],
        )

    def to(self, device) -> "SensorChunk":
        """Every field as a contiguous float32 tensor on ``device`` (numpy
        arrays, float64 included, are converted)."""

        def conv(x):
            if x is None:
                return None
            if not isinstance(x, Tensor):
                x = torch.from_numpy(np.array(x, dtype=np.float32))
            return x.to(device=device, dtype=torch.float32).contiguous()

        return SensorChunk(*(conv(x) for x in self))


_REMAINDERS = ("keep", "drop", "pad")


def iter_chunks(
    chunk: SensorChunk, chunk_size: int, *, remainder: str = "keep"
) -> Iterator[SensorChunk]:
    """Split a materialized stream into successive ingest chunks.

    ``remainder`` handles a length that is not a multiple of
    ``chunk_size``: ``"keep"`` yields the short final chunk, ``"drop"``
    discards it, ``"pad"`` repeats its last frame up to ``chunk_size``
    (which ticks the frame clock, so it changes the state).
    """
    if remainder not in _REMAINDERS:
        raise ValueError(
            f"unknown remainder policy {remainder!r}; "
            f"available: {_REMAINDERS}"
        )
    n = chunk.n_frames
    full_end = (n // chunk_size) * chunk_size
    for start in range(0, full_end, chunk_size):
        yield chunk.slice(start, start + chunk_size)
    if full_end == n or remainder == "drop":
        return
    tail = chunk.slice(full_end, n)
    if remainder == "keep":
        yield tail
        return
    pad = chunk_size - (n - full_end)

    def _pad(x):
        x = torch.as_tensor(x)
        return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)

    yield SensorChunk(
        _pad(tail.frames),
        _pad(tail.poses),
        _pad(tail.gazes),
        None if tail.depth is None else _pad(tail.depth),
    )


def concat_stats(stats: Sequence):
    """Concatenate per-chunk stats NamedTuples along the time axis, giving
    the layout a one-shot ingest would have produced."""
    if len(stats) == 1:
        return stats[0]
    return type(stats[0])(*(torch.cat(xs, dim=0) for xs in zip(*stats)))
