"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064. RoPE + SwiGLU + GQA. [arXiv:2412.08905; hf]
"""

from repro_torch.configs.base import ModelConfig, lm_shapes

ARCH_ID = "phi4-mini-3.8b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab=200064,
    norm="rmsnorm",
    rope_base=10000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=192,
    vocab=128,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)

SHAPES = lm_shapes(long_ok=False)
