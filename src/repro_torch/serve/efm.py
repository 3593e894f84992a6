"""EFM serving steps: prefill and batched decode, on one card.

Port of ``repro/serve/efm.py``.  The reference compiles each step with
``jax.jit`` over a device mesh and returns it with its sharding specs;
PyTorch runs eagerly, so here each step is a plain callable on the
model's device, without gradients.  Sharding over a mesh is not ported
yet (``ROADMAP.md``, Queue 1 item 6): passing a mesh raises.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch import Tensor

from repro_torch.models.model import Model


def _one_card(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "serving over a device mesh is not ported yet "
            "(ROADMAP.md, Queue 1 item 6); pass mesh=None"
        )


def jit_prefill(model: Model, mesh=None) -> Callable:
    """Full-context ingest: ``step(params, batch) -> (logits, cache)``."""
    _one_card(mesh)

    @torch.no_grad()
    def prefill(params, batch):
        return model.prefill(params, batch)

    return prefill


def jit_decode_step(model: Model, mesh=None) -> Callable:
    """One-token decode: ``step(params, state, token, pos) -> (logits,
    state)``; the state's cache is updated in place (the reference
    donates it)."""
    _one_card(mesh)

    @torch.no_grad()
    def decode(params, state, token, pos):
        return model.decode_step(params, state, token, pos)

    return decode


@torch.no_grad()
def greedy_decode_loop(
    model: Model, params, state, first_token: Tensor, start_pos: int,
    n_tokens: int,
) -> Tuple[Tensor, Any]:
    """Host-side greedy loop for the examples (small models).

    Returns the ``(B, 1 + n_tokens)`` tokens, ``first_token`` first, and
    the state.  ``torch.argmax`` takes the first index on ties, as
    ``jnp.argmax`` does.
    """
    tok = first_token
    out = [tok]
    for i in range(n_tokens):
        logits, state = model.decode_step(params, state, tok, start_pos + i)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out.append(tok)
    return torch.cat(out, dim=1), state
