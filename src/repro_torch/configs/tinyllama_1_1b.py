"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000. Llama-2 architecture at small scale. [arXiv:2401.02385; hf]
"""

from repro_torch.configs.base import ModelConfig, lm_shapes

ARCH_ID = "tinyllama-1.1b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab=32000,
    norm="rmsnorm",
    rope_base=10000.0,
    tie_embeddings=False,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=96,
    vocab=128,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)

SHAPES = lm_shapes(long_ok=False)
