"""Collectives, differentiable ones among them (``comm``), the
activation-sharding context (``act``), the sharding rules and SPMD block
helpers (``sharding``) and GPipe (``pipeline``) over
``torch.distributed``: the port's counterpart of ``repro/parallel``."""
