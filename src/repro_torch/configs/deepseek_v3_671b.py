"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280; MLA; 1 shared + 256 routed top-8; MTP. [arXiv:2412.19437; hf]

Released V3: first 3 layers dense (d_ff 18432), q_lora_rank 1536,
kv_lora_rank 512, qk_nope 128, qk_rope 64, v_head 128, MTP depth 1.
"""

from repro_torch.configs.base import ModelConfig, lm_shapes

ARCH_ID = "deepseek-v3-671b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="moe_mla",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,  # per-expert width
    vocab=129280,
    norm="rmsnorm",
    rope_base=10000.0,
    moe_experts=256,
    moe_top_k=8,
    moe_shared=1,
    moe_d_ff=2048,
    first_k_dense=3,
    d_ff_dense=18432,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp=True,
    ep_axes="dp_model",  # 670B of experts only fit EP over (data, model)
    opt_moment_dtype="bfloat16",  # fp32 moments alone exceed pod HBM
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4,
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
    q_lora_rank=48,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    mtp=True,
    moe_capacity_factor=8.0,  # no drops at smoke scale -> decode == forward
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)

SHAPES = lm_shapes(long_ok=False)
