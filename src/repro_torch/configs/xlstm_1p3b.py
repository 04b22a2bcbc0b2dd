"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

48L d_model=2048 4H d_ff=0 (projection blocks) vocab=50304.
1 sLSTM per 8 blocks (7:1 mLSTM:sLSTM). Recurrent state is O(1) →
long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm", arch_kind="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, head_dim=512,
    slstm_every=8,
)
