"""internvl2-76b [vlm]: InternViT frontend (STUB) + llama-70B-class backbone.

[arXiv:2404.16821; unverified] 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256. ``input_specs`` supplies 256 precomputed patch embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm", arch_kind="decoder",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab_size=128256, head_dim=128,
    n_vision_tokens=256,
)
