"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (kv=32) d_ff=10240
ssm_state=64; Mamba-2 backbone + 2 alternating shared attention blocks
(one invocation every 6 Mamba layers). [arXiv:2411.15242; hf]

``attn_window`` bounds the shared-attention KV at 500k context, which is
what lets this hybrid run the long_500k shape.
"""

from repro_torch.configs.base import ModelConfig, lm_shapes

ARCH_ID = "zamba2-2.7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    norm="rmsnorm",
    rope_base=10000.0,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    shared_attn_period=6,
    n_shared_blocks=2,
    attn_window=4096,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    scan_chunk=64,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    ssm_state=16,
    shared_attn_period=2,
    n_shared_blocks=2,
    attn_window=64,  # > smoke S: windowing exercised by its own test
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
    scan_chunk=8,
)

SHAPES = lm_shapes(long_ok=True)
