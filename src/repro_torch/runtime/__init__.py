"""Runtime substrate (port of ``repro.runtime``): fault-tolerant loop,
failure injection, stragglers."""

from repro_torch.runtime import fault  # noqa: F401
from repro_torch.runtime.fault import (  # noqa: F401
    FailureInjector,
    FaultTolerantLoop,
    LoopConfig,
    WorkerFailure,
)
