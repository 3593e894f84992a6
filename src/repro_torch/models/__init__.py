"""EFM model zoo — unified via :func:`repro_torch.models.model.build_model`."""

from repro_torch.models.model import Model, build_model  # noqa: F401
