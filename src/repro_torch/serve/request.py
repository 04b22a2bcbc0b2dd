"""Request/completion records for the continuous-batching serve subsystem
(counterpart of ``repro/serve/request.py``).

A :class:`Request` is everything the scheduler needs to know about one
user's generation: the prompt tokens, the stop conditions (EOS id and/or a
new-token budget), and per-request :class:`SamplingParams`. Requests are
host-side objects: the scheduler turns them into rows of the static
super-batch state tensors on admission, so heterogeneous requests never
change a shape the step runs at. A :class:`Completion` is the retired counterpart.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence

_uid = itertools.count()


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs, all applied within the sampler's sorted
    top-k prefix: temperature (``<= 0`` means greedy),
    ``top_k`` (``0`` = the sampler's full candidate width), nucleus ``top_p``
    (``1.0`` = off), and ``min_p`` (``0.0`` = off)."""
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    min_p: float = 0.0


@dataclasses.dataclass
class Request:
    """One generation request. ``eos_id=None`` disables EOS stopping (the
    request runs to ``max_new_tokens``); ``deadline_s=None`` disables
    wall-clock retirement (otherwise the scheduler retires the request
    with ``status="TIMEOUT"`` once it has been live that many seconds)."""
    prompt: Sequence[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    deadline_s: Optional[float] = None
    uid: int = dataclasses.field(default_factory=lambda: next(_uid))

    def __post_init__(self):
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.uid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.uid}: max_new_tokens must be >= 1")


@dataclasses.dataclass
class Completion:
    """A retired request: the generated tokens (EOS included when hit) and
    why it stopped (``'eos'`` | ``'length'`` | ``'timeout'`` | ``'error'``).
    ``status`` is the coarse health verdict — ``"OK"`` for a normal finish,
    ``"TIMEOUT"`` for deadline retirement, ``"ERROR"`` for a poisoned slot
    (non-finite logits) isolated out of the super-batch."""
    uid: int
    prompt: List[int]
    tokens: List[int]
    finish_reason: str
    n_steps: int            # decode steps this request was live for
    status: str = "OK"

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)
