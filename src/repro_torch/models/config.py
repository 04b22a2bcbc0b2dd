"""Model configuration (counterpart of ``repro/models/config.py``).

``ModelConfig`` is a copy of the JAX package's dataclass, so the
configuration files under ``repro_torch/configs`` are copies of the JAX
package's, published widths and all. The MoE layer reads ``d_model``,
``d_ff`` / ``moe_d_ff``, ``n_experts``, ``n_experts_active``, ``moe_path``
and ``param_dtype``; ``reduced()`` gives the same family at smoke-test
size. ``TrainConfig`` is the JAX package's, field for field; only
``grad_compression="none"`` is taken until the sharded ops are ported
(ROADMAP queue 1 item 4). ``torch_dtype`` maps a dtype name to torch's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` and so on."""
    return getattr(torch, name)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    arch_kind: str                 # decoder | encdec | mamba_hybrid | xlstm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 → d_model // n_heads
    # --- attention options ---------------------------------------------
    rope_theta: float = 10_000.0
    qk_norm: bool = False          # qwen3
    qkv_bias: bool = False         # qwen1.5
    attn_softcap: float = 0.0      # gemma2 (50.0)
    logit_softcap: float = 0.0     # gemma2 (30.0)
    sliding_window: int = 0        # SWA width (mixtral 4096; gemma2 local 4096)
    local_global_alternate: bool = False   # gemma2
    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    n_experts_active: int = 0
    moe_d_ff: int = 0              # expert hidden size (moonshot: 1408)
    moe_path: str = "dense"        # dense | grouped (FLiMS-sorted EP) | sorted
    # --- SSM / hybrid / xlstm ---------------------------------------------
    ssm_state: int = 0             # mamba2 d_state (zamba2: 64)
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    hybrid_attn_every: int = 0     # zamba2: shared attn block period
    slstm_every: int = 0           # xlstm: every k-th block is sLSTM
    # --- enc-dec (whisper) ------------------------------------------------
    n_encoder_layers: int = 0
    encoder_seq: int = 0           # frame positions (stub frontend)
    # --- vlm ----------------------------------------------------------------
    n_vision_tokens: int = 0       # patch positions (stub frontend)
    # --- numerics / system -------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    embed_scale: bool = False      # gemma multiplies embeddings by sqrt(d)
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    remat: bool = True
    scan_layers: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self, **kw) -> "ModelConfig":
        """Smoke-test-sized version of the same family."""
        base = dict(
            n_layers=min(self.n_layers, 4) if not self.hybrid_attn_every
            else 2 * self.hybrid_attn_every,
            d_model=128, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256, vocab_size=512, head_dim=32,
            moe_d_ff=64 if self.moe_d_ff else 0,
            n_experts=min(self.n_experts, 4),
            n_experts_active=min(self.n_experts_active, 2),
            n_encoder_layers=min(self.n_encoder_layers, 2),
            encoder_seq=64 if self.encoder_seq else 0,
            n_vision_tokens=16 if self.n_vision_tokens else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_state=min(self.ssm_state, 16),
            sliding_window=min(self.sliding_window, 32),
            param_dtype="float32", compute_dtype="float32",
            remat=False,
        )
        if self.slstm_every:
            base["n_layers"] = 2 * self.slstm_every
        base.update(kw)
        return dataclasses.replace(self, **base)


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    z_loss: float = 1e-4
    microbatch: int = 0            # 0 = no gradient accumulation
    grad_compression: str = "none" # "none" | "int8_ef" (not ported yet)
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.grad_compression != "none":
            raise ValueError(
                f"grad_compression={self.grad_compression!r}: only 'none' "
                "runs in the port; int8 error-feedback compression needs "
                "the sharded ops (ROADMAP queue 1 item 4)")
