"""Collectives (``comm``), activation-sharding context (``act``) and the
data-layout helpers of the sharded ops (``sharding``) over
``torch.distributed``: the port's counterpart of ``repro/parallel``."""
