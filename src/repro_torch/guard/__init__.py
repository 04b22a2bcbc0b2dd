"""``repro_torch.guard`` — the engine's fault-tolerance layer (counterpart of
``repro.guard``): input validation at the engine boundary
(:mod:`~repro_torch.guard.validate`), the variant fallback ladder
(:mod:`~repro_torch.guard.fallback`), opt-in postconditions on engine
results behind ``REPRO_VERIFY=1`` / :func:`enable_verify`
(:mod:`~repro_torch.guard.verify`) and deterministic fault injectors for
the chaos tests (:mod:`~repro_torch.guard.inject`)."""
from repro_torch.guard.fallback import (guarded_call, recoverable,
                                        reference_variant)
from repro_torch.guard.inject import InjectedFault
from repro_torch.guard.validate import (EngineInputError, QueueFull,
                                        RequestRejected, default_nan_policy,
                                        set_nan_policy)
from repro_torch.guard.verify import (checked, disable_verify, enable_verify,
                                      failures, reset_failures,
                                      verify_enabled)

__all__ = ["EngineInputError", "InjectedFault", "QueueFull",
           "RequestRejected", "checked", "default_nan_policy",
           "disable_verify", "enable_verify", "failures", "guarded_call",
           "recoverable", "reference_variant", "reset_failures",
           "set_nan_policy", "verify_enabled"]
