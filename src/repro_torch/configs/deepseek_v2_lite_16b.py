"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408(expert)
vocab=102400; MLA kv_lora=512; 2 shared + routed top-6 experts.

Released V2-Lite: 27 layers, first layer dense (d_ff 10944), 64 routed
experts top-6 + 2 shared, per-expert width 1408; MLA q full-rank (no
q_lora at Lite scale), kv_lora_rank 512, qk_nope 128, qk_rope 64,
v_head_dim 128. The assignment sheet's "MoE 64e top-6 / 160 routed"
wording mixes V2 and V2-Lite; we follow the released V2-Lite config (64
routed experts). [arXiv:2405.04434; hf]
"""

from repro_torch.configs.base import ModelConfig, lm_shapes

ARCH_ID = "deepseek-v2-lite-16b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe_mla",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per-expert width
    vocab=102400,
    norm="rmsnorm",
    rope_base=10000.0,
    moe_experts=64,
    moe_top_k=6,
    moe_shared=2,
    moe_d_ff=1408,
    first_k_dense=1,
    d_ff_dense=10944,
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=32,
    vocab=128,
    moe_experts=8,
    moe_top_k=2,
    moe_shared=1,
    moe_d_ff=32,
    first_k_dense=1,
    d_ff_dense=128,
    kv_lora_rank=32,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    moe_capacity_factor=8.0,  # no drops at smoke scale -> decode == forward
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)

SHAPES = lm_shapes(long_ok=False)
