"""rwkv6-3b [ssm] — Finch: 32L d_model=2560 (attention-free) d_ff=8960
vocab=65536; data-dependent decay. [arXiv:2404.05892; hf]

O(1) recurrent serving state -> runs the long_500k shape.
"""

from repro_torch.configs.base import ModelConfig, lm_shapes

ARCH_ID = "rwkv6-3b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="rwkv6",
    n_layers=32,
    d_model=2560,
    n_heads=40,  # d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    norm="layernorm",
    rwkv_head_dim=64,
    rwkv_lora_rank=32,
    rwkv_decay_lora_rank=64,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
    scan_chunk=32,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    rwkv_head_dim=16,
    rwkv_lora_rank=8,
    rwkv_decay_lora_rank=8,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
    scan_chunk=8,
)

SHAPES = lm_shapes(long_ok=True)
