"""Architecture registry of the port: copies of the JAX package's
configuration files for the models the port drives (Mixtral-8x22B,
Moonlight-16B-A3B and Qwen3-1.7B, uniform attention decoders). The copies
keep the JAX package's approximations: ``moonshot_v1_16b_a3b`` has
Moonlight-16B-A3B's widths but plain multi-head attention for its MLA, 48
layers for its 27, no shared experts, no dense first layer, softmax
routing and a tied head."""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import ModelConfig

ARCHS = ["mixtral_8x22b", "moonshot_v1_16b_a3b", "qwen3_1p7b"]

_ALIAS = {
    "mixtral-8x22b": "mixtral_8x22b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen3-1.7b": "qwen3_1p7b",
}


def get_config(name: str) -> ModelConfig:
    mod = import_module(f"repro_torch.configs.{_ALIAS.get(name, name)}")
    return mod.CONFIG
