"""ModelConfig — the single schema every assigned architecture instantiates.

Port of ``repro/configs/base.py``: the same fields and defaults, so that
configs read the same in both packages; the dtype names map to ``torch``
dtypes.  One dataclass covers all six families (dense / moe_mla / rwkv6 /
hybrid / vlm / encdec); family-specific fields default to "off".  The
distribution and remat knobs are kept as fields, but nothing in the port
reads them yet.  Each ``src/repro_torch/configs/<id>.py`` exports:

  * ``CONFIG``       — the exact published configuration,
  * ``SMOKE_CONFIG`` — a reduced same-family twin for CPU smoke tests,
  * ``SHAPES``       — the assigned input-shape set for the dry-run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe_mla | rwkv6 | hybrid | vlm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    norm: str = "rmsnorm"  # rmsnorm | layernorm | layernorm_nonparam
    qkv_bias: bool = False
    rope_base: float = 10000.0
    tie_embeddings: bool = True

    # --- MoE / MLA (deepseek family) ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared: int = 0  # number of shared experts
    moe_d_ff: int = 0  # per-expert hidden width
    first_k_dense: int = 0  # leading dense layers in a MoE stack
    d_ff_dense: int = 0  # d_ff of those dense layers
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.001
    kv_lora_rank: int = 0  # MLA compressed-KV width (0 -> plain GQA)
    q_lora_rank: int = 0  # MLA query compression (0 -> none)
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False  # multi-token-prediction head (deepseek-v3)
    mtp_loss_coef: float = 0.3

    # --- SSM / RWKV ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 32
    rwkv_decay_lora_rank: int = 64

    # --- hybrid (zamba2) ---
    shared_attn_period: int = 0  # a shared attn block every k ssm layers
    n_shared_blocks: int = 0  # distinct shared blocks (alternating)
    attn_window: Optional[int] = None  # sliding-window attention size

    # --- vlm (llama-3.2-vision) ---
    cross_attn_period: int = 0  # group size; last layer of each group xattns
    img_seq: int = 0  # stub image-embedding token count

    # --- encdec (seamless) ---
    enc_layers: int = 0
    dec_layers: int = 0
    src_seq_frac: float = 1.0  # encoder source length vs shape seq_len

    # --- distribution knobs ---
    ep_axes: str = "model"  # "model" | "dp_model" (FSDP+EP for huge MoE)
    opt_moment_dtype: str = "float32"  # bf16 moments for the 671B config
    shard_strategy: str = "tp"  # "tp" | "dp" | "fsdp" (see launch/sharding)
    moe_impl: str = "sort"  # "sort" | "ep" (shard_map all-to-all dispatch)
    moe_a2a_quant: bool = False  # int8 EP dispatch (DeepSeek fp8-style)
    train_accum: int = 1  # microbatch gradient-accumulation steps

    # --- numerics / perf knobs ---
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    cache_dtype: str = "bfloat16"
    remat: bool = False
    remat_policy: str = "dots"  # "dots" (save matmul outs) | "full"
    scan_layers: bool = True
    attn_backend: str = "ref"  # ref | pallas
    scan_chunk: int = 64  # rwkv6/mamba2 chunk length

    # ----- derived -----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdt(self):
        return _DTYPES[self.param_dtype]

    @property
    def cdt(self):
        return _DTYPES[self.compute_dtype]

    @property
    def cachedt(self):
        return _DTYPES[self.cache_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (shape) cell: what to lower and at what size."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int
    skip: Optional[str] = None  # reason string if inapplicable to the arch


# The four LM-family shapes from the assignment.
def lm_shapes(
    *, long_ok: bool, long_skip_reason: str = "full quadratic attention at 524288 is not deployable"
) -> Tuple[ShapeSpec, ...]:
    return (
        ShapeSpec("train_4k", "train", 4096, 256),
        ShapeSpec("prefill_32k", "prefill", 32768, 32),
        ShapeSpec("decode_32k", "decode", 32768, 128),
        ShapeSpec(
            "long_500k",
            "decode",
            524288,
            1,
            skip=None if long_ok else long_skip_reason,
        ),
    )
