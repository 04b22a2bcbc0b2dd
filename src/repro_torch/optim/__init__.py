"""``repro_torch.optim`` — AdamW with float32 master weights and the int8
error-feedback ``psum`` of ``compress`` (counterpart of ``repro.optim``)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     lr_schedule)
from repro_torch.optim.compress import compressed_psum_int8, ef_state_init

__all__ = ["AdamWState", "adamw_init", "adamw_update", "lr_schedule",
           "global_norm", "clip_by_global_norm", "compressed_psum_int8",
           "ef_state_init"]
