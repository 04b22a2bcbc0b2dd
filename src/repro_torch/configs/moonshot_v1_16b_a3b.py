"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (GQA kv=16)
expert d_ff=1408 vocab=163840, MoE 64e top-6.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", arch_kind="decoder",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=163840, head_dim=128,
    n_experts=64, n_experts_active=6, moe_d_ff=1408,
    moe_path="ep",       # §Perf: shard_map expert parallelism + FLiMS dispatch
)
