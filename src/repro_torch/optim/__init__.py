"""Optimizer substrate: AdamW, LR schedules, EF-int8 gradient compression.

Port of ``repro/optim``; the parameter trees are nested dicts (or any
``torch.utils._pytree`` tree) of tensors.
"""

from repro_torch.optim import adamw, compress, schedule  # noqa: F401
from repro_torch.optim.adamw import AdamWConfig, AdamWState  # noqa: F401
