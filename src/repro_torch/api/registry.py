"""Name-based registries for compressors, kernel backends, stages and
combinators (PyTorch port of ``repro.api.registry``).

The keys are those of the JAX package, so a configuration written for it
ports unchanged:

* **Compressors** — ``"epic"`` and the four baselines ``"fv"``, ``"sd"``,
  ``"td"``, ``"gc"``.
* **Kernel backends** — the reproject-match implementations ``"ref"``
  (plain PyTorch), ``"pallas"``, ``"pallas_tiled"`` and ``"fused"`` (the
  hand-written CUDA kernel, launched three ways).  A backend callable may
  carry a ``fused_match`` attribute, which the TSRC step uses, when
  present, to run match + thresholds + patch-update mask as one kernel.
* **Frame stages** — ``"bypass"``, ``"depth"``, ``"saliency"``, ``"tsrc"``,
  the baselines' ``"select.fv"``, ``"select.sd"``, ``"select.td"``,
  ``"select.gc"`` and ``"retain"``.
* **Combinators** — ``"gated"``.

Lookups fail fast with a ``KeyError`` that lists the available names.
This module is stdlib only: kernel modules import it when they load.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict, Tuple

_COMPRESSORS: Dict[str, type] = {}
_KERNEL_BACKENDS: Dict[str, Callable] = {}
_STAGES: Dict[str, Callable] = {}
_COMBINATORS: Dict[str, Callable] = {}


def _lookup(table: Dict[str, Any], what: str, name: str) -> Any:
    try:
        return table[name]
    except KeyError:
        raise KeyError(
            f"unknown {what} {name!r}; available: {sorted(table)}"
        ) from None


def register_compressor(name: str) -> Callable[[type], type]:
    """Class decorator: register a Compressor implementation under ``name``."""

    def deco(cls: type) -> type:
        _COMPRESSORS[name] = cls
        cls.name = name
        return cls

    return deco


def get_compressor(name: str) -> type:
    """Look up a Compressor class by registry name (e.g. ``"epic"``)."""
    _ensure_builtin_compressors()
    return _lookup(_COMPRESSORS, "compressor", name)


def available_compressors() -> Tuple[str, ...]:
    _ensure_builtin_compressors()
    return tuple(sorted(_COMPRESSORS))


def _ensure_builtin_compressors() -> None:
    from repro_torch.api import compressor  # noqa: F401


def register_backend(name: str) -> Callable[[Callable], Callable]:
    """Decorator: register a kernel backend callable under ``name``."""

    def deco(fn: Callable) -> Callable:
        _KERNEL_BACKENDS[name] = fn
        return fn

    return deco


def get_backend(name: str) -> Callable:
    """Look up a kernel backend (e.g. ``"ref"`` / ``"fused"``) by name."""
    _ensure_builtin_backends()
    return _lookup(_KERNEL_BACKENDS, "kernel backend", name)


def available_backends() -> Tuple[str, ...]:
    _ensure_builtin_backends()
    return tuple(sorted(_KERNEL_BACKENDS))


def validate_backend(name: str) -> str:
    """Fail-fast check that ``name`` is a registered kernel backend."""
    get_backend(name)
    return name


def _ensure_builtin_backends() -> None:
    from repro_torch.kernels.reproject_match import fused, ops  # noqa: F401


def _validate_topk_knob(name: str, k: int, dense_doc: str) -> int:
    """Shared fail-fast check for the sparse-TRD top-K knobs."""
    try:
        ki = operator.index(k)
    except TypeError:
        raise TypeError(
            f"{name} must be an int ({dense_doc}), got {type(k).__name__}"
        ) from None
    if ki < 0:
        raise ValueError(f"{name} must be >= 0 ({dense_doc}), got {ki}")
    return ki


def validate_prefilter_k(k: int) -> int:
    """``prefilter_k``: 0 = dense TRD, K > 0 = sparse top-K candidates."""
    return _validate_topk_knob(
        "prefilter_k", k, "0 = dense TRD, K > 0 = sparse top-K candidates"
    )


def validate_patch_k(k: int) -> int:
    """``patch_k``: 0 = dense patch axis, P_k > 0 = salient compaction."""
    return _validate_topk_knob(
        "patch_k", k, "0 = dense patch axis, P_k > 0 = salient compaction"
    )


def validate_k_ladder(ladder) -> Tuple[int, ...]:
    """Fail-fast check of an adaptive-K bucket ladder: a non-empty
    sequence of strictly increasing positive ints, the ``prefilter_k``
    rungs the host-side controller walks between chunks."""
    try:
        rungs = tuple(operator.index(k) for k in ladder)
    except TypeError:
        raise TypeError(
            f"k_ladder must be a sequence of ints, got {ladder!r}"
        ) from None
    if not rungs:
        raise ValueError("k_ladder must be non-empty")
    if any(k <= 0 for k in rungs):
        raise ValueError(
            f"k_ladder buckets must be positive prefilter_k values, "
            f"got {rungs}"
        )
    if any(b <= a for a, b in zip(rungs, rungs[1:])):
        raise ValueError(
            f"k_ladder must be strictly increasing, got {rungs}"
        )
    return rungs


class BackendValidatedConfig:
    """Mixin for NamedTuple configs carrying a kernel ``backend`` field.

    Validates the backend (and ``prefilter_k`` / ``patch_k`` where the
    config has them) on construction AND on ``_replace``, which rebuilds
    through ``_make`` and would otherwise bypass ``__new__``.  Use as
    ``class MyConfig(BackendValidatedConfig, _MyConfigBase)``.
    """

    __slots__ = ()

    @staticmethod
    def _validate(cfg):
        validate_backend(cfg.backend)
        if hasattr(cfg, "prefilter_k"):
            validate_prefilter_k(cfg.prefilter_k)
        if hasattr(cfg, "patch_k"):
            validate_patch_k(cfg.patch_k)
        return cfg

    def __new__(cls, *args, **kwargs):
        return cls._validate(super().__new__(cls, *args, **kwargs))

    def _replace(self, **kwargs):
        return self._validate(super()._replace(**kwargs))


def register_stage(name: str) -> Callable[[Any], Any]:
    """Decorator: register a FrameStage class/factory under ``name``."""

    def deco(factory: Any) -> Any:
        _STAGES[name] = factory
        return factory

    return deco


def get_stage(name: str) -> Callable:
    """Look up a FrameStage factory by registry name (e.g. ``"tsrc"``)."""
    _ensure_builtin_stages()
    return _lookup(_STAGES, "frame stage", name)


def make_stage(name: str, *args: Any, **kwargs: Any) -> Any:
    """Construct a registered stage: ``get_stage(name)(*args, **kwargs)``."""
    return get_stage(name)(*args, **kwargs)


def available_stages() -> Tuple[str, ...]:
    _ensure_builtin_stages()
    return tuple(sorted(_STAGES))


def _ensure_builtin_stages() -> None:
    from repro_torch.core import frame_stages  # noqa: F401


def register_combinator(name: str) -> Callable[[Any], Any]:
    """Decorator: register a pipeline combinator (e.g. ``"gated"``)."""

    def deco(factory: Any) -> Any:
        _COMBINATORS[name] = factory
        return factory

    return deco


def get_combinator(name: str) -> Callable:
    """Look up a combinator factory by registry name (e.g. ``"gated"``)."""
    _ensure_builtin_combinators()
    return _lookup(_COMBINATORS, "combinator", name)


def make_combinator(name: str, *args: Any, **kwargs: Any) -> Any:
    """Construct a registered combinator: ``get_combinator(name)(...)``."""
    return get_combinator(name)(*args, **kwargs)


def available_combinators() -> Tuple[str, ...]:
    _ensure_builtin_combinators()
    return tuple(sorted(_COMBINATORS))


def _ensure_builtin_combinators() -> None:
    from repro_torch.api import stages  # noqa: F401
