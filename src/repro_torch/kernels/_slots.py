"""Slot-batched kernels: the helpers of the custom ops' vmap rules.

The serving pool (``serve/slots.py``) steps every slot's session at once,
as ``torch.func.vmap`` over one session's step.  A kernel wrapper launches
through raw device pointers, which vmap cannot see through, so each kernel
on that step is a ``torch.library`` custom op whose launch serves any
number of slots, and its vmap rule hands the vmapped dimension to it as a
slot axis (the reproject-match ops take any leading slot axes; the int8
convolution folds the slots into its batch of images): one launch for all
the slots, whatever their number.  An input the step shares
between the slots (the intrinsics, the weights) comes in unbatched.
Outside vmap a wrapper calls the op's implementation straight
(:func:`pick`).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import Tensor


def pick(op: Callable, plain: Callable, launch: Callable,
         device: torch.device) -> Callable:
    """What computes ``op`` here: ``op`` itself under vmap (its vmap rule
    makes one launch of every slot), else its implementation for
    ``device`` called straight.  The custom op's dispatcher costs tens of
    microseconds of host time a call, and the solo step, which is bound by
    its host, makes up to nine such calls a processed frame (one
    reproject-match launch, eight int8 layers)."""
    if torch._C._are_functorch_transforms_active():
        return op
    return launch if device.type == "cuda" else plain


def lead(x: Tensor, dim: Optional[int], size: int) -> Tensor:
    """``x`` with its vmapped dimension ``dim`` moved to the front,
    contiguous.  An unbatched ``x`` (``dim is None``) is repeated for each
    of the ``size`` vmapped entries.  No copy when the vmapped dimension
    already leads a contiguous tensor, as the pool's do."""
    x = x.expand(size, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.contiguous()


def fold(x: Tensor, dim: Optional[int], size: int) -> Tensor:
    """:func:`lead`, then the vmapped dimension folded into the leading
    axis that follows it: ``(V, S, ...)`` -> ``(V S, ...)``."""
    return lead(x, dim, size).flatten(0, 1)


def over_slots(fn: Callable, n_lead: int) -> Callable:
    """``fn`` of one slot, vmapped over ``n_lead`` leading slot axes (``fn``
    itself for none): the plain version of a launch that takes any number
    of them."""
    for _ in range(n_lead):
        fn = torch.func.vmap(fn)
    return fn


def unfold(x: Tensor, size: int) -> Tensor:
    """Inverse of :func:`fold` on an output: ``(V S, ...)`` -> ``(V, S,
    ...)``, the vmapped dimension at 0."""
    return x.unflatten(0, (size, x.shape[0] // size))


def require_shared(op: str, in_dims, names) -> None:
    """Raise unless the inputs ``names`` (by position in ``in_dims``) are
    unbatched: the launch reads them once for every slot."""
    for i, name in names:
        if in_dims[i] is not None:
            raise NotImplementedError(
                f"{op}: {name} is shared by every slot of a launch; it "
                f"cannot differ across the vmapped dimension"
            )
