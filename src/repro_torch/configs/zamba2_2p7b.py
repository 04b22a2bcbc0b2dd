"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf] 54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64. Shared transformer block applied every 6 mamba layers
(weights reused — the zamba2 "shared block" scheme).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid", arch_kind="mamba_hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, head_dim=80,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    hybrid_attn_every=6,
)
