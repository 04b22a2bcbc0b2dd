"""The models the port drives: the MoE layer on the fused routing op."""
