"""``repro_torch.optim`` — AdamW with float32 master weights (counterpart
of ``repro.optim``; the gradient compression of ``repro.optim.compress``
waits for the sharded ops, ROADMAP queue 1 item 4)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     lr_schedule)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "lr_schedule",
           "global_norm", "clip_by_global_norm"]
