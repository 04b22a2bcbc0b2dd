"""``repro_torch.guard`` — input validation at the engine boundary and the
variant fallback ladder (counterparts of ``repro.guard.validate`` and
``repro.guard.fallback``)."""
from repro_torch.guard.fallback import (guarded_call, recoverable,
                                        reference_variant)
from repro_torch.guard.validate import (EngineInputError, QueueFull,
                                        RequestRejected, default_nan_policy,
                                        set_nan_policy)

__all__ = ["EngineInputError", "QueueFull", "RequestRejected",
           "default_nan_policy", "guarded_call", "recoverable",
           "reference_variant", "set_nan_policy"]
