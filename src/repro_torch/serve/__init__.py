"""``repro_torch.serve`` — continuous-batching serving (counterpart of
``repro.serve``).

A :class:`Scheduler` admits and retires requests against a static padded
super-batch, KV residency lives behind a ``KVConnectorBase``-style insert /
lookup interface (:class:`SlotKVCache`), and every decode step samples all
live requests through one ``engine.topk`` call (:class:`RaggedSampler`).

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serve import Request, SamplingParams, serve_batch
    model = build_model(get_config("moonshot_v1_16b_a3b"))
    params = model.init(torch.Generator("cuda").manual_seed(0))
    done, seconds, sched = serve_batch(model, params, reqs, n_slots=8,
                                       max_seq=256)
"""
from repro_torch.guard.validate import QueueFull, RequestRejected
from repro_torch.serve.kv_cache import KVConnectorBase, SlotKVCache
from repro_torch.serve.request import Completion, Request, SamplingParams
from repro_torch.serve.sampler import (RaggedSampler, SamplingState,
                                       prefix_keep_mask, sorted_prefix_sample)
from repro_torch.serve.scheduler import DecodeState, Scheduler, serve_batch

__all__ = [
    "Completion", "DecodeState", "KVConnectorBase", "QueueFull",
    "RaggedSampler", "Request", "RequestRejected", "SamplingParams",
    "SamplingState", "Scheduler", "SlotKVCache", "prefix_keep_mask",
    "serve_batch", "sorted_prefix_sample",
]
