"""EFM model zoo — unified via :func:`repro_torch.models.model.build_model`.

Six families, as the JAX package's: dense (``transformer``), MoE/MLA
(``deepseek`` on ``mla`` and ``moe``), RWKV6 (``rwkv6``), the Zamba2
hybrid (``mamba2``), the VLM (``vision``) and the encoder-decoder
(``encdec``), on the shared blocks of ``layers``.
"""

from repro_torch.models.model import Model, build_model  # noqa: F401
