"""Architecture registry of the port: copies of the JAX package's
configuration files, one module per architecture, published widths and
all. The copies keep the JAX package's approximations of the published
models:

- ``moonshot_v1_16b_a3b`` has Moonlight-16B-A3B's widths but plain
  multi-head attention for its MLA, 48 layers for its 27, no shared
  experts, no dense first layer, softmax routing and a tied head;
- ``zamba2_2p7b``'s shared block is one [attention, MLP] block applied
  before every 6 Mamba2 layers, its weights reused at each application,
  without the published model's per-application LoRA adapters;
- ``internvl2_76b``'s vision encoder is a stub: the batch carries 256
  patch embeddings (``"vision"``);
- ``whisper_large_v3``'s audio front end is a stub (the batch carries frame
  embeddings, ``"frames"``), and its positions use RoPE where Whisper has
  absolute embeddings;
- every head is tied to the token embedding.
"""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import ModelConfig

ARCHS = [
    "zamba2_2p7b", "gemma2_27b", "qwen3_1p7b", "gemma2_9b", "qwen1p5_110b",
    "mixtral_8x22b", "moonshot_v1_16b_a3b", "internvl2_76b", "xlstm_1p3b",
    "whisper_large_v3",
]

_ALIAS = {
    "zamba2-2.7b": "zamba2_2p7b",
    "gemma2-27b": "gemma2_27b",
    "qwen3-1.7b": "qwen3_1p7b",
    "gemma2-9b": "gemma2_9b",
    "qwen1.5-110b": "qwen1p5_110b",
    "mixtral-8x22b": "mixtral_8x22b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "internvl2-76b": "internvl2_76b",
    "xlstm-1.3b": "xlstm_1p3b",
    "whisper-large-v3": "whisper_large_v3",
}


def get_config(name: str) -> ModelConfig:
    mod = import_module(f"repro_torch.configs.{_ALIAS.get(name, name)}")
    return mod.CONFIG
