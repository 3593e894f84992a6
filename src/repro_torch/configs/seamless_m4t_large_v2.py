"""seamless-m4t-large-v2 [audio] — enc-dec, 24L enc + 24L dec,
d_model=1024 16H (kv=16) d_ff=8192 vocab=256206. [arXiv:2308.11596; hf]

Backbone-only per the assignment: the speech frontend is a stub and the
encoder consumes precomputed frame embeddings ``src_embed``
(B, seq*src_seq_frac, d_model).
"""

from repro_torch.configs.base import ModelConfig, lm_shapes

ARCH_ID = "seamless-m4t-large-v2"

CONFIG = ModelConfig(
    name=ARCH_ID,
    family="encdec",
    n_layers=48,  # 24 enc + 24 dec
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    norm="layernorm",
    rope_base=10000.0,
    enc_layers=24,
    dec_layers=24,
    src_seq_frac=0.5,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
    remat=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    enc_layers=2,
    dec_layers=2,
    param_dtype="float32",
    compute_dtype="float32",
    remat=False,
)

SHAPES = lm_shapes(long_ok=False)
