"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; gated cross-attention image layers every 5 layers.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision tower is a stub: ``img_embed`` (B, img_seq=1600, d_model)
arrives precomputed. EPIC's retained patches are exactly this tensor —
the most direct consumer of the paper's technique.
"""

from repro_torch.configs.base import ModelConfig, lm_shapes

ARCH_ID = "llama-3.2-vision-11b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    norm="rmsnorm",
    rope_base=500000.0,
    tie_embeddings=False,
    cross_attn_period=5,
    img_seq=1600,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab=128,
    cross_attn_period=2,
    img_seq=16,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)

SHAPES = lm_shapes(long_ok=False)
