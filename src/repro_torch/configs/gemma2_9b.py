"""gemma2-9b [dense]: local+global alternating, logit softcap.

[arXiv:2408.00118; hf] 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense", arch_kind="decoder",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14336,
    vocab_size=256000, head_dim=256,
    attn_softcap=50.0, logit_softcap=30.0,
    sliding_window=4096, local_global_alternate=True,
    embed_scale=True,
)
