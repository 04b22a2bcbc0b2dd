"""gemma2-27b [dense]: local+global alternating attention, logit softcap.

[arXiv:2408.00118; hf] 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000. head_dim=128; attn softcap 50, final logit softcap 30;
local layers are 4096-window SWA.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense", arch_kind="decoder",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, d_ff=36864,
    vocab_size=256000, head_dim=128,
    attn_softcap=50.0, logit_softcap=30.0,
    sliding_window=4096, local_global_alternate=True,
    embed_scale=True,
)
