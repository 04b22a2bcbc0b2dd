"""The JAX package's examples on the port: ``quickstart``,
``distributed_sort``, ``moe_routing``, ``serve_lm`` and ``train_lm``, each
run by ``python -m repro_torch.examples.<name>`` (``--device cpu`` for the
plain versions on the CPU; the card by default). Each prints self-checking
``...: True`` lines."""
