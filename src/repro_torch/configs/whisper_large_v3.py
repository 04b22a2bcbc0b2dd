"""whisper-large-v3 [audio]: enc-dec; conv frontend STUB.

[arXiv:2212.04356; unverified] 32L enc + 32L dec, d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866. ``input_specs`` supplies precomputed frame
embeddings; text length = frames/8.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio", arch_kind="encdec",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51866, head_dim=64,
    n_encoder_layers=32, encoder_seq=1500,
)
