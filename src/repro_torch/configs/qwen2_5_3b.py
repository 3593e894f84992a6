"""qwen2.5-3b [dense] — 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936. GQA with QKV bias (the Qwen2 signature). [hf:Qwen/Qwen2.5; hf]
"""

from repro_torch.configs.base import ModelConfig, lm_shapes

ARCH_ID = "qwen2.5-3b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    norm="rmsnorm",
    qkv_bias=True,
    rope_base=1000000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=128,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)

SHAPES = lm_shapes(long_ok=False)
