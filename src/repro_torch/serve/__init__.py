"""``repro_torch.serve`` — the serving side of the port; so far the ragged
sampler (counterpart of ``repro.serve.sampler``)."""
from repro_torch.serve.sampler import (RaggedSampler, SamplingState,
                                       prefix_keep_mask, sorted_prefix_sample)

__all__ = ["RaggedSampler", "SamplingState", "prefix_keep_mask",
           "sorted_prefix_sample"]
