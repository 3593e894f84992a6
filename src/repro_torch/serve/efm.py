"""EFM serving steps: prefill and batched decode, on one card.

Port of ``repro/serve/efm.py``.  The reference compiles each step with
``jax.jit`` over a device mesh and returns it with its sharding specs;
PyTorch runs eagerly, so here each step is a plain callable on the
model's device, without gradients.  The steps take any family's batch
(``models/model.py``: tokens, plus ``img_embed`` for the VLM and
``src_embed`` for the encoder-decoder, whose prefill returns no logits
and whose decode starts at position 0); ``pad_for_decode`` gives a
prefill's state room for the decoded tokens, the caller's job in the
reference (``examples/serve_stream.py``).  Sharding over a mesh is not
ported yet (``ROADMAP.md``, Queue 1 item 6): passing a mesh raises.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
import torch.nn.functional as F
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


def pad_for_decode(model: Model, state, n: int):
    """``model``'s prefill ``state`` with room for ``n`` decoded tokens
    after the prompt, as ``examples/serve_stream.py`` pads: the
    self-attention caches get ``n`` more positions (the dense and VLM
    K/V, DeepSeek's compressed caches; the hybrid's window gets ``n``
    empty slots, ``slot_pos = -1``).  The cross K/V, RWKV6's O(1) state
    and the encoder-decoder's self-cache (its decode starts at position
    0) stay as they are.  Returns a new dict that shares the tensors it
    does not pad with ``state``; ``state`` is unchanged."""
    def pad(t):
        return F.pad(t, (0, 0, 0, n))

    fam = model.cfg.family
    if fam == "moe_mla":
        return {name: {k: pad(v) for k, v in stack.items()}
                for name, stack in state.items()}
    out = dict(state)
    if fam in ("dense", "vlm", "hybrid"):
        out["k"], out["v"] = pad(state["k"]), pad(state["v"])
    if fam == "hybrid":
        out["slot_pos"] = F.pad(state["slot_pos"], (0, n), value=-1)
    return out


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
