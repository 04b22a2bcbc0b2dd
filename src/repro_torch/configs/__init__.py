"""Architecture registry of the port: copies of the JAX package's
configuration files for the models the port drives (the MoE layers of
Mixtral-8x22B and Moonlight-16B-A3B), with their published widths."""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.config import ModelConfig

ARCHS = ["mixtral_8x22b", "moonshot_v1_16b_a3b"]

_ALIAS = {
    "mixtral-8x22b": "mixtral_8x22b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
}


def get_config(name: str) -> ModelConfig:
    mod = import_module(f"repro_torch.configs.{_ALIAS.get(name, name)}")
    return mod.CONFIG
