"""Continuous-batching scheduler: admit and retire over a static super-batch
(counterpart of ``repro/serve/scheduler.py``).

The model decodes a fixed ``(n_slots,)`` super-batch every step; admission
and retirement only rewrite rows of the state tensors and slots of the KV
cache. One iteration is:

1. **admit**: pop waiting requests into every free slot: one prefill per
   request, a loop of ``decode_step`` over the
   prompt padded to ``prefill_len`` with a per-token commit mask (token
   ``t`` reaches the cache only where ``t < length - 1``; the last prompt
   token is fed by the first decode step, and pad tokens never touch the
   cache), then one ``KVConnectorBase.insert``.
2. **step**: ``decode_step`` over all slots and one
   :class:`~repro_torch.serve.sampler.RaggedSampler` call (one
   ``engine.topk`` for the whole batch). Inactive slots decode garbage that
   is masked, and their cache writes land on retired rows, which
   re-admission overwrites.
3. **retire**: host-side EOS / max-new-token / deadline checks on the
   sampled row; finished requests free their slot. A row with any
   non-finite logit (a mask computed in the same step) retires with
   ``status="ERROR"`` and leaves the rest of the batch alone.

Shape stability stands where the JAX package counts ``jax.jit`` traces:
eager torch has nothing to retrace, so the prefill and the step each record
the shapes, dtypes and devices of their tensor arguments, and ``traces``
(and the ``serve.trace`` counter) counts the distinct signatures seen. Every
prefill runs at a (``prefill_len``,) prompt and every step at
(``n_slots``,) rows, so a run costs 2 however requests come and go; a
later CUDA-graph capture of the step replays exactly one such signature.

Randomness: an explicit ``torch.Generator`` on the device, seeded from
``seed``, draws the sampler's noise.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.butterfly import tree_leaves, tree_map
from repro_torch.guard.validate import QueueFull, RequestRejected
from repro_torch.serve.kv_cache import SlotKVCache
from repro_torch.serve.request import Completion, Request
from repro_torch.serve.sampler import RaggedSampler, SamplingState


class DecodeState(NamedTuple):
    """The mutable rows of the static super-batch (every tensor (B,))."""
    last_tok: torch.Tensor   # int32: the token each slot feeds next step
    pos: torch.Tensor        # int32: position of last_tok
    active: torch.Tensor     # bool: slot currently serving a request
    sampling: SamplingState


@dataclasses.dataclass
class _Live:
    """Host-side bookkeeping for one admitted request."""
    req: Request
    slot: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    steps: int = 0
    admitted_at: float = 0.0      # time.monotonic() at admission


def _signature(args) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) if
                 isinstance(t, torch.Tensor) else type(t)
                 for t in tree_leaves(list(args)))


def _device_of(params, device):
    if device is not None:
        return torch.device(device)
    for leaf in tree_leaves(params) if params is not None else ():
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cuda")


class Scheduler:
    """Admits, decodes and retires requests continuously.

    ``model`` / ``params`` are a :func:`repro_torch.models.model.build_model`
    decoder and its weights (or anything with ``decode_step`` and
    ``init_cache(batch, max_seq, device=)``); the scheduler runs on the
    device of ``params`` unless ``device=`` says otherwise. ``n_slots`` is
    the static super-batch width, ``max_seq`` the cache length,
    ``prefill_len`` the static padded prompt width of every admission.
    Tokens come from a :class:`RaggedSampler` of width ``top_k_width``
    (``variant`` pins its ``engine.topk`` variant) and the cache lives in a
    :class:`SlotKVCache`. ``max_waiting`` bounds the submit queue
    (0 = unbounded), past which ``submit`` raises
    :class:`~repro_torch.guard.validate.QueueFull`.
    """

    def __init__(self, model, params, *, n_slots: int, max_seq: int,
                 prefill_len: int = 32, top_k_width: int = 64,
                 variant: Optional[str] = None, max_waiting: int = 0,
                 seed: int = 0, device=None):
        if prefill_len < 1:
            raise ValueError("prefill_len must be >= 1")
        self.model = model
        self.params = params
        self.device = _device_of(params, device)
        self.n_slots = int(n_slots)
        self.max_seq = int(max_seq)
        self.prefill_len = int(prefill_len)
        self.max_waiting = int(max_waiting)
        self.sampler = RaggedSampler(top_k_width, variant)
        self.kv = SlotKVCache(model, n_slots, max_seq, self.device)
        self.waiting: Deque[Request] = collections.deque()
        self.live: Dict[int, _Live] = {}
        self.completed: List[Completion] = []
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._traces = {"step": 0, "prefill": 0}
        self._seen = {"step": set(), "prefill": set()}
        dev = self.device
        self.state = DecodeState(
            last_tok=torch.zeros((self.n_slots,), dtype=torch.int32,
                                 device=dev),
            pos=torch.zeros((self.n_slots,), dtype=torch.int32, device=dev),
            active=torch.zeros((self.n_slots,), dtype=torch.bool, device=dev),
            sampling=SamplingState.full(self.n_slots, device=dev))
        # a pristine batch-1 cache, every prefill's starting point (the
        # prefill never writes into it)
        self._zero_cache = model.init_cache(1, self.max_seq, device=dev)

    @property
    def traces(self) -> int:
        """Distinct argument signatures the prefill and the step have run
        at (the counterpart of the JAX scheduler's compile count)."""
        return self._traces["step"] + self._traces["prefill"]

    def _record(self, name: str, *args) -> None:
        sig = _signature(args)
        if sig not in self._seen[name]:
            self._seen[name].add(sig)
            self._traces[name] += 1
            obs.inc("serve.trace")

    # -- the two static-shape functions -------------------------------------
    def _prefill(self, prompt: torch.Tensor, length: torch.Tensor, cache):
        """``prefill_len`` decode steps of one request at batch 1, token
        ``t`` committed to the cache only where ``t < length - 1``."""
        self._record("prefill", prompt, length, cache)
        ts = torch.arange(self.prefill_len, dtype=torch.int32,
                          device=prompt.device)
        commit = ts < length - 1
        for t in range(self.prefill_len):
            _, new = self.model.decode_step(self.params, prompt[t:t + 1],
                                            ts[t:t + 1], cache)
            cache = tree_map(lambda n, o: torch.where(commit[t], n, o),
                             new, cache)
        return cache

    def _step(self, cache, state: DecodeState):
        self._record("step", cache, state)
        logits, cache = self.model.decode_step(self.params, state.last_tok,
                                               state.pos, cache)
        # per-slot health: a row with any non-finite logit is isolated by
        # _retire; the mask rides the step, no extra call
        finite = torch.isfinite(logits).all(-1)
        tok = self.sampler.sample(self.generator, logits, state.sampling)
        tok = torch.where(state.active, tok, 0).to(torch.int32)
        pos = torch.where(state.active, state.pos + 1, state.pos)
        return tok, finite, DecodeState(tok, pos, state.active,
                                        state.sampling), cache

    # -- admission ------------------------------------------------------------
    def _reject(self, exc: RequestRejected) -> RequestRejected:
        obs.inc("serve.rejected")
        obs.event("serve.reject", op=exc.op, **exc.details)
        return exc

    def submit(self, req: Request) -> None:
        """Queue a request, or refuse it with a structured
        :class:`~repro_torch.guard.validate.RequestRejected` before it can
        wedge the super-batch."""
        if self.max_waiting and len(self.waiting) >= self.max_waiting:
            raise self._reject(QueueFull(
                "serve.submit", f"request {req.uid}: submit queue full "
                f"({len(self.waiting)}/{self.max_waiting} waiting); retry "
                "after the batch drains", uid=req.uid,
                waiting=len(self.waiting), max_waiting=self.max_waiting))
        n = len(req.prompt)
        if n < 1:       # defence in depth: Request.__post_init__ also bars it
            raise self._reject(RequestRejected(
                "serve.submit", f"request {req.uid}: empty prompt",
                uid=req.uid))
        if n > self.prefill_len:
            raise self._reject(RequestRejected(
                "serve.submit",
                f"request {req.uid}: prompt length {n} exceeds the "
                f"scheduler's static prefill_len={self.prefill_len}",
                uid=req.uid, prompt_len=n, prefill_len=self.prefill_len))
        if n + req.max_new_tokens > self.max_seq:
            raise self._reject(RequestRejected(
                "serve.submit",
                f"request {req.uid}: prompt {n} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_seq={self.max_seq}",
                uid=req.uid, prompt_len=n,
                max_new_tokens=req.max_new_tokens, max_seq=self.max_seq))
        known = ({r.uid for r in self.waiting}
                 | {ls.req.uid for ls in self.live.values()}
                 | {c.uid for c in self.completed})
        if req.uid in known:
            raise self._reject(RequestRejected(
                "serve.submit", f"request {req.uid}: duplicate uid (already "
                "waiting, live, or completed in this scheduler)",
                uid=req.uid))
        self.waiting.append(req)
        obs.inc("serve.submitted")
        obs.gauge("serve.waiting", len(self.waiting))

    def admit(self) -> int:
        """Move waiting requests into free slots: one static prefill and one
        slot insert each. Returns the number admitted."""
        n = 0
        while self.waiting:
            slot = self.kv.allocate()
            if slot is None:
                break
            req = self.waiting.popleft()
            with obs.span("serve.prefill"):
                prompt = np.zeros((self.prefill_len,), np.int32)
                prompt[:len(req.prompt)] = req.prompt
                cached = self._prefill(
                    torch.from_numpy(prompt).to(self.device),
                    torch.tensor(len(req.prompt), dtype=torch.int32,
                                 device=self.device),
                    self._zero_cache)
                self.kv.insert(slot, cached)
            st = self.state
            st.last_tok[slot] = int(req.prompt[-1])
            st.pos[slot] = len(req.prompt) - 1
            st.active[slot] = True
            self.state = st._replace(sampling=st.sampling.set_row(
                slot, req.params))
            self.live[slot] = _Live(req, slot, admitted_at=time.monotonic())
            obs.inc("serve.admitted")
            obs.event("serve.admit", uid=req.uid, slot=slot,
                      prompt_len=len(req.prompt))
            n += 1
        obs.gauge("serve.live_slots", len(self.live))
        obs.gauge("serve.waiting", len(self.waiting))
        return n

    # -- decode and retirement ------------------------------------------------
    def step(self) -> np.ndarray:
        """One iteration over every live slot: decode, sample (one engine
        call), retire finished rows. Returns the host copy of the sampled
        tokens (retired and idle rows read 0)."""
        if not self.live:
            raise RuntimeError("no live requests to step (admit first)")
        with obs.span("serve.step"):
            tok, finite, self.state, cache = self._step(self.kv.cache,
                                                        self.state)
            self.kv.swap(cache)
            tok_host = tok.cpu().numpy()       # waits: the whole step's time
            finite_host = finite.cpu().numpy()
        obs.inc("serve.tokens", len(self.live))
        self._retire(tok_host, finite_host)
        obs.gauge("serve.traces", self.traces)
        return tok_host

    def _retire(self, tok_host: np.ndarray,
                finite_host: Optional[np.ndarray] = None) -> None:
        now = time.monotonic()
        for slot in list(self.live):
            ls = self.live[slot]
            t = int(tok_host[slot])
            ls.steps += 1
            # a poisoned slot (non-finite logits): its sampled token is
            # garbage; isolate the row, leave the rest of the batch alone
            if finite_host is not None and not bool(finite_host[slot]):
                reason, status = "error", "ERROR"
                obs.inc("serve.poisoned")
            else:
                ls.tokens.append(t)
                hit_eos = ls.req.eos_id is not None and t == ls.req.eos_id
                timed_out = (ls.req.deadline_s is not None
                             and now - ls.admitted_at >= ls.req.deadline_s)
                if (not hit_eos and not timed_out
                        and len(ls.tokens) < ls.req.max_new_tokens):
                    continue
                if hit_eos:
                    reason, status = "eos", "OK"
                elif timed_out and len(ls.tokens) < ls.req.max_new_tokens:
                    reason, status = "timeout", "TIMEOUT"
                    obs.inc("serve.timeout")
                else:
                    reason, status = "length", "OK"
            self.completed.append(Completion(
                uid=ls.req.uid, prompt=list(ls.req.prompt),
                tokens=ls.tokens, finish_reason=reason, n_steps=ls.steps,
                status=status))
            del self.live[slot]
            self.kv.free(slot)
            self.state.active[slot] = False
            obs.inc("serve.retired")
            obs.event("serve.retire", uid=ls.req.uid, slot=slot,
                      reason=reason, status=status, n_tokens=len(ls.tokens))
        obs.gauge("serve.live_slots", len(self.live))

    # -- the run loop ---------------------------------------------------------
    def run(self, requests: Sequence[Request] = ()) -> List[Completion]:
        """Serve until the queue and the batch drain."""
        for r in requests:
            self.submit(r)
        while self.waiting or self.live:
            self.admit()
            if self.live:
                self.step()
        return self.completed

    def stats(self) -> dict:
        """Serving stats from the obs registry (needs ``obs.enable()``):
        step-latency percentiles from the ``serve.step`` timer and the
        ``serve.*`` counters."""
        snap = obs.snapshot()
        out = {"traces": self.traces, "live": len(self.live),
               "waiting": len(self.waiting),
               "completed": len(self.completed)}
        out.update({k: v for k, v in snap.get("counters", {}).items()
                    if k.startswith("serve.")})
        t = snap.get("timers", {}).get("serve.step")
        if t:
            out["step_p50_us"] = t["p50_us"]
            out["step_p99_us"] = t["p99_us"]
            out["steps"] = t["count"]
        return out


def serve_batch(model, params, requests: Sequence[Request], *,
                n_slots: int, max_seq: int, prefill_len: int = 32,
                top_k_width: int = 64, variant: Optional[str] = None,
                max_waiting: int = 0, seed: int = 0, device=None):
    """One-shot run: build a :class:`Scheduler`, run the requests to
    completion, return ``(completions, wall_seconds, scheduler)``."""
    sched = Scheduler(model, params, n_slots=n_slots, max_seq=max_seq,
                      prefill_len=prefill_len, top_k_width=top_k_width,
                      variant=variant, max_waiting=max_waiting, seed=seed,
                      device=device)
    t0 = time.perf_counter()
    done = sched.run(requests)
    return done, time.perf_counter() - t0, sched
