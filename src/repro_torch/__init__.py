"""``repro_torch`` — the PyTorch / CUDA port of the FLiMS sorting engine.

A second package beside the JAX reference ``repro``: the same layering
(core, kernels, engine, guard, obs) and op surface, with every Pallas TPU
kernel on the ported path replaced by a hand-written CUDA kernel for Hopper
(``csrc/``). It imports ``torch`` and never ``jax`` or ``repro``.
"""
