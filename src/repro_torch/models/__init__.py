"""The models the port drives: the decoder stack (``model.build_model``:
attention, dense MLP or the MoE layer on the fused routing op) and the MoE
layer on its own."""
