from repro_torch.data.pipeline import (SyntheticLM, make_batch_specs,
                                       pack_by_length)

__all__ = ["SyntheticLM", "make_batch_specs", "pack_by_length"]
