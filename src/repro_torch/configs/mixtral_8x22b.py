"""mixtral-8x22b [moe]: 8 experts top-2, SWA. [arXiv:2401.04088; hf]

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2.
SWA window 4096 → sub-quadratic decode (rolling-buffer cache), so the
long_500k shape runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe", arch_kind="decoder",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768, head_dim=128,
    n_experts=8, n_experts_active=2, moe_d_ff=16384,
    sliding_window=4096,
)
