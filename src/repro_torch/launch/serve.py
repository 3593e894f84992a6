"""Deprecated shim: the serving steps live in :mod:`repro_torch.serve.efm`.

Port of ``repro/launch/serve.py``, which re-exports the EFM prefill and
decode steps for backward compatibility; import from
``repro_torch.serve.efm``.
"""

from __future__ import annotations

from repro_torch.serve.efm import (  # noqa: F401
    greedy_decode_loop,
    jit_decode_step,
    jit_prefill,
)

__all__ = ["jit_prefill", "jit_decode_step", "greedy_decode_loop"]
