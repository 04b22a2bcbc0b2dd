"""Data pipeline: a deterministic synthetic LM stream and FLiMS-based
packing (counterpart of ``repro/data/pipeline.py``).

The synthetic stream is drawn per ``(seed, step)`` from a
``torch.Generator`` on the stream's device, so a restarted job replays the
same batches without a data-loader checkpoint (the bits are not
``jax.random``'s). ``make_batch_specs`` gives ``meta``-device stand-ins of
every model input. ``pack_by_length`` puts the paper's sorter in the data
path: documents are length-sorted by FLiMS argsort and next-fit packed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import torch

from repro_torch.core.mergesort import flims_argsort

__all__ = ["SyntheticLM", "make_batch_specs", "pack_by_length"]


@dataclass
class SyntheticLM:
    """A random walk over the vocabulary with steps in [-3, 3]: the next
    token is predictable from the current one, so the loss falls under
    training."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    device: str = "cuda"

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed << 32) + step)
        kw = dict(generator=gen, device=self.device, dtype=torch.int64)
        start = torch.randint(0, V, (B, 1), **kw)
        steps = torch.randint(-3, 4, (B, S), **kw)
        toks = torch.remainder(start + torch.cumsum(steps, dim=1), V).to(
            torch.int32)
        mask = torch.ones((B, S), dtype=torch.float32, device=self.device)
        mask[:, -1] = 0.0
        return {"tokens": toks, "targets": torch.roll(toks, -1, dims=1),
                "mask": mask}

    def batches(self, start_step: int = 0) -> Iterator[Dict[str,
                                                           torch.Tensor]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def make_batch_specs(cfg, seq_len: int, global_batch: int):
    """``meta``-device tensors of every model input's shape and dtype (no
    allocation): tokens / targets / mask; the encoder-decoder's frames
    with ``max(seq_len // 8, 8)`` text positions; a VLM's vision prefix
    with ``seq_len - n_vision_tokens`` of them."""
    spec = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                            device="meta")
    B = global_batch
    text = seq_len
    specs = {}
    if cfg.arch_kind == "encdec":
        text = max(seq_len // 8, 8)
        specs["frames"] = spec((B, seq_len, cfg.d_model), torch.float32)
    elif cfg.n_vision_tokens:
        text = seq_len - cfg.n_vision_tokens
        specs["vision"] = spec((B, cfg.n_vision_tokens, cfg.d_model),
                               torch.float32)
    specs.update(tokens=spec((B, text), torch.int32),
                 targets=spec((B, text), torch.int32),
                 mask=spec((B, text), torch.float32))
    return specs


def pack_by_length(doc_lengths: torch.Tensor, bin_size: int):
    """Length-sorted next-fit-decreasing packing by FLiMS argsort.

    Returns ``(order, bin id of each doc in that order)``, both int32:
    documents visited longest first (ties in input order), the current bin
    filled up to ``bin_size`` and a new one opened when a document does not
    fit (one open bin, within 2x of optimal). The fill is a sequential
    scan, run on the host over the sorted lengths."""
    order = flims_argsort(doc_lengths.to(torch.int32), descending=True)
    sorted_len = doc_lengths[order.long()].tolist()
    fill, nbins, bins = bin_size + 1, 0, []
    for ln in sorted_len:
        if fill + ln <= bin_size:
            fill += ln
        else:
            fill, nbins = ln, nbins + 1
        bins.append(nbins - 1)
    return order, torch.tensor(bins, dtype=torch.int32,
                               device=doc_lengths.device)
