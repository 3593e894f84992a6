"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (OLMo's signature choice), untied-free: OLMo ties
embeddings at 1B. [arXiv:2402.00838; hf]
"""

from repro_torch.configs.base import ModelConfig, lm_shapes

ARCH_ID = "olmo-1b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    norm="layernorm_nonparam",
    rope_base=10000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)

SHAPES = lm_shapes(long_ok=False)
