"""``repro_torch.guard`` — input validation at the engine boundary
(counterpart of ``repro.guard.validate``; the fallback ladder of the JAX
package is not part of the port's dispatch)."""
from repro_torch.guard.validate import (EngineInputError, default_nan_policy,
                                        set_nan_policy)

__all__ = ["EngineInputError", "default_nan_policy", "set_nan_policy"]
