"""Checkpoint substrate (port of ``repro.checkpoint``): atomic sharded npz
steps, async save, restore with damaged-step fallback."""

from repro_torch.checkpoint import store  # noqa: F401
from repro_torch.checkpoint.store import (  # noqa: F401
    AsyncSaver,
    complete_steps,
    gc_old,
    latest_step,
    read_manifest,
    restore,
    save,
)
