"""repro_torch.serve — serving on the card.

  jit_prefill, jit_decode_step, greedy_decode_loop   (efm)  the EFM
                                                     prefill/decode steps
  KLadderController, make_controller                 (adaptive) adaptive K

The names of the reference's ``repro.serve`` that the port has load
lazily, as there: ``repro_torch.api`` imports ``adaptive``, so this
package must not pull the model zoo in ``efm`` at import time.
"""

from __future__ import annotations

_LAZY = {
    "KLadderController": "repro_torch.serve.adaptive",
    "jit_prefill": "repro_torch.serve.efm",
    "jit_decode_step": "repro_torch.serve.efm",
    "greedy_decode_loop": "repro_torch.serve.efm",
}

__all__ = list(_LAZY)


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)
