"""The port's continuous-batching scheduler, KV connector and reporting,
mirroring ``tests/test_serve.py``, and served greedy completions against
the JAX package's ``serve_batch``.

- A counter model (greedy decode of token t emits t + 1 mod the vocabulary)
  makes every scheduler decision predictable on the host: EOS backfill,
  FIFO drain, slot reuse, geometry and malformed-request rejection,
  backpressure, deadlines, mid-run admission at unchanged shapes, and a
  poisoned row (non-finite logits) retired with ``status="ERROR"`` while
  its neighbours decode on.
- A reduced Qwen3 decoder: exactly one ``engine.topk`` call a decode step
  (the obs timers) and ``traces == 2`` (one prefill and one step argument
  signature) after a run with admission and retirement mid-run.
- Reduced Moonlight-16B-A3B with the JAX package's weights
  (``models.convert.decoder_params_from_jax``): greedy completions of
  ``serve_batch`` equal JAX ``serve_batch``'s token for token, over more
  requests than slots (admissions overlap retirements, EOS and length
  stops). The CPU planner serves ``topk`` from ``torch`` here and ``xla``
  there, which order the same way (``tests/test_torch_guard.py``). The
  same for reduced Zamba2, xLSTM and Gemma-2-9B (window 8), where most
  prompts are shorter than ``prefill_len``: the pad tokens must leave the
  recurrent states and the rolling buffer untouched.
- ``SlotKVCache`` finds each leaf's slot axis by building the cache at two
  widths on ``meta`` (``tests/test_serve.py``'s layouts, and xLSTM's
  states with their batch on axis 2).
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.obs import reporting as JR  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import SamplingParams as JSamplingParams  # noqa: E402
from repro.serve import serve_batch as jserve_batch  # noqa: E402
from repro_torch import engine as TE  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.butterfly import tree_map  # noqa: E402
from repro_torch.models.convert import decoder_params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.obs import reporting as TRP  # noqa: E402
from repro_torch.serve import (QueueFull, Request, RequestRejected,  # noqa: E402,E501
                               SamplingParams, Scheduler, SlotKVCache,
                               serve_batch)

VOCAB = 64
POISON = 1000                   # fed, never emitted (outputs stay below VOCAB)


@pytest.fixture(autouse=True)
def clean_state():
    TE.clear_plans()
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()
    TE.clear_plans()


def _fake_model(vocab=VOCAB):
    """Counter model: greedy decode of token t emits t + 1 (mod vocab); a
    row fed ``POISON`` gets NaN logits."""
    def init_cache(batch, max_seq, device="cpu"):
        return {"kv": torch.zeros((batch, max_seq, 2), device=device)}

    def decode_step(params, tok, pos, cache):
        logits = torch.nn.functional.one_hot((tok.long() + 1) % vocab,
                                             vocab).float() * 10.0
        logits[tok == POISON] = float("nan")
        return logits, cache

    return SimpleNamespace(init_cache=init_cache, decode_step=decode_step)


def _greedy_req(last, n, eos=None):
    return Request(prompt=[1, 2, last], max_new_tokens=n, eos_id=eos,
                   params=SamplingParams(temperature=0.0))


def _sched(model, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("prefill_len", 8)
    kw.setdefault("top_k_width", 8)
    return Scheduler(model, params=None, device="cpu", **kw)


def _ramp(last, n, vocab=VOCAB):
    return [(last + 1 + i) % vocab for i in range(n)]


# -- admission and retirement --------------------------------------------------

def test_eos_mid_batch_retires_and_backfills():
    sched = _sched(_fake_model())
    done = sched.run([_greedy_req(10, 10, eos=13), _greedy_req(20, 10),
                      _greedy_req(30, 4)])
    by_uid = {c.uid: c for c in done}
    assert len(done) == 3
    a, b, c = (by_uid[r] for r in sorted(by_uid))
    assert a.finish_reason == "eos" and a.tokens == _ramp(10, 3)
    assert b.finish_reason == "length" and b.tokens == _ramp(20, 10)
    assert c.finish_reason == "length" and c.tokens == _ramp(30, 4)
    # request c was admitted into a's slot while b was still live
    assert [x.uid for x in done] == [a.uid, c.uid, b.uid]


def test_queue_starvation_drains_fifo():
    obs.enable()
    reqs = [_greedy_req(10 * (i + 1), 6 + i) for i in range(6)]
    sched = _sched(_fake_model())
    done = sched.run(reqs)
    assert sorted(c.uid for c in done) == sorted(r.uid for r in reqs)
    for r in reqs:
        c = next(x for x in done if x.uid == r.uid)
        assert c.tokens == _ramp(r.prompt[-1], r.max_new_tokens)
    assert not sched.waiting and not sched.live
    admits = [e["data"]["uid"] for e in obs.snapshot()["events"]
              if e["kind"] == "serve.admit"]
    assert admits == [r.uid for r in reqs]          # FIFO


def test_slot_reuse_after_retirement():
    sched = _sched(_fake_model(), n_slots=1)
    done = sched.run([_greedy_req(5, 2), _greedy_req(40, 3)])
    assert [c.tokens for c in done] == [_ramp(5, 2), _ramp(40, 3)]
    assert sched.kv.allocate() == 0       # the slot went back to the list
    sched.kv.free(0)
    with pytest.raises(ValueError):
        sched.kv.free(0)


def test_submit_validates_static_geometry():
    sched = _sched(_fake_model(), prefill_len=4, max_seq=16)
    with pytest.raises(ValueError):
        sched.submit(Request(prompt=[1] * 5, max_new_tokens=2))
    with pytest.raises(ValueError):
        sched.submit(Request(prompt=[1, 2], max_new_tokens=15))


def test_kv_insert_writes_one_slot_on_the_models_axis():
    """The connector writes the slot's slice in place, on each leaf's own
    slot axis, found by building the model's cache at two widths on
    ``meta``: axis 1 of the decoder's (L, B, W, K, hd) caches, axis 2 of
    xLSTM's mLSTM states (groups, k - 1, B, ...)."""
    def build(batch, max_seq, device="cpu"):
        return (torch.zeros((4, batch, max_seq), device=device),
                {"b": torch.zeros((2, batch, 3), device=device)})
    kv = SlotKVCache(SimpleNamespace(init_cache=build), n_slots=3,
                     max_seq=8, device="cpu")
    assert kv.axes == (1, {"b": 1})
    leaf = kv.cache[0]
    slot = kv.allocate()
    kv.insert(slot, (torch.ones((4, 1, 8)), {"b": torch.full((2, 1, 3), 2.)}))
    assert kv.cache[0] is leaf                       # in place
    assert float(kv.cache[0][:, slot].min()) == 1.0
    assert float(kv.cache[1]["b"][:, slot].min()) == 2.0
    other = [s for s in range(3) if s != slot]
    assert float(kv.cache[0][:, other].abs().max()) == 0.0
    for arch, axes in (("qwen3_1p7b", (1, 1)),
                       ("xlstm_1p3b", {"mlstm": {"C": 2, "n": 2, "m": 2},
                                       "slstm": dict.fromkeys("cnhm", 1)})):
        kv = SlotKVCache(build_model(get_config(arch).reduced()), n_slots=3,
                         max_seq=8, device="cpu")
        assert kv.axes == axes


def test_kv_cache_batch_axis_discovery():
    """The connector finds the slot axis of every cache layout the model
    zoo produces (dicts, nested tuples, non-leading batch axes), and
    refuses a leaf with no or two batch-dependent dimensions
    (``tests/test_serve.py``'s case)."""
    def build(batch, max_seq, device="cpu"):
        return {"a": torch.zeros((4, batch, max_seq), device=device),
                "b": (torch.zeros((batch, 3), device=device),
                      torch.zeros((2, 5, batch, max_seq, 7), device=device))}
    kv = SlotKVCache(SimpleNamespace(init_cache=build), n_slots=3,
                     max_seq=8, device="cpu")
    slot = kv.allocate()
    sub = tree_map(lambda x: x + 1.0, build(1, 8))
    kv.insert(slot, sub)
    assert float(kv.cache["a"][:, slot].min()) == 1.0
    assert float(kv.cache["b"][0][slot].min()) == 1.0
    assert float(kv.cache["b"][1][:, :, slot].min()) == 1.0
    other = [s for s in range(3) if s != slot]
    assert float(kv.cache["a"][:, other].abs().max()) == 0.0
    assert float(kv.cache["b"][1][:, :, other].abs().max()) == 0.0
    for bad in (lambda b, m, device="cpu": torch.zeros((b, b), device=device),
                lambda b, m, device="cpu": torch.zeros((4, m),
                                                       device=device)):
        with pytest.raises(ValueError, match="batch-dependent"):
            SlotKVCache(SimpleNamespace(init_cache=bad), n_slots=3,
                        max_seq=8, device="cpu")


def test_admission_mid_run_no_new_signature():
    sched = _sched(_fake_model(), n_slots=3)
    sched.submit(_greedy_req(10, 8))
    sched.admit()
    for _ in range(2):
        sched.step()
    traces_before = sched.traces
    assert traces_before == 2
    sched.submit(_greedy_req(20, 2))      # mid-run admission
    sched.admit()
    for _ in range(3):
        sched.step()
    assert sched.traces == traces_before
    assert len(sched.completed) == 1


def test_submit_rejects_malformed_requests():
    obs.enable()
    sched = _sched(_fake_model())
    r = _greedy_req(10, 4)
    sched.submit(r)
    with pytest.raises(RequestRejected, match="duplicate"):
        sched.submit(r)
    with pytest.raises(RequestRejected, match="prefill_len"):
        sched.submit(Request(prompt=list(range(100)), max_new_tokens=4))
    with pytest.raises(RequestRejected, match="max_seq"):
        sched.submit(Request(prompt=[1, 2], max_new_tokens=1000))
    assert issubclass(QueueFull, ValueError)
    assert obs.snapshot()["counters"]["serve.rejected"] == 3
    done = sched.run()
    assert len(done) == 1 and done[0].status == "OK"


def test_bounded_queue_backpressure():
    sched = _sched(_fake_model(), max_waiting=2)
    sched.submit(_greedy_req(10, 4))
    sched.submit(_greedy_req(20, 4))
    with pytest.raises(QueueFull):
        sched.submit(_greedy_req(30, 4))
    assert len(sched.run()) == 2
    sched.submit(_greedy_req(30, 4))
    assert len(sched.run()) == 3


def test_deadline_retires_with_timeout_status():
    sched = _sched(_fake_model(), max_seq=256)
    slow = Request(prompt=[1, 2, 10], max_new_tokens=200, deadline_s=0.0,
                   params=SamplingParams(temperature=0.0))
    fast = _greedy_req(20, 4)
    by_uid = {c.uid: c for c in sched.run([slow, fast])}
    t = by_uid[slow.uid]
    assert t.status == "TIMEOUT" and t.finish_reason == "timeout"
    assert 0 < len(t.tokens) < 200
    ok = by_uid[fast.uid]
    assert ok.status == "OK" and ok.tokens == _ramp(20, 4)


def test_no_deadline_means_no_timeout():
    done = _sched(_fake_model()).run([_greedy_req(10, 6)])
    assert done[0].status == "OK" and done[0].finish_reason == "length"


def test_poisoned_row_retires_with_error():
    obs.enable()
    sched = _sched(_fake_model(), n_slots=4)
    good = [_greedy_req(10 * (i + 1), 6) for i in range(3)]
    bad = Request(prompt=[5, POISON], max_new_tokens=6,
                  params=SamplingParams(temperature=0.0))
    by_uid = {c.uid: c for c in sched.run(good + [bad])}
    p = by_uid[bad.uid]
    assert p.status == "ERROR" and p.finish_reason == "error"
    assert p.tokens == []
    for r in good:
        c = by_uid[r.uid]
        assert c.status == "OK" and c.tokens == _ramp(r.prompt[-1], 6)
    assert sched.traces == 2
    assert obs.snapshot()["counters"]["serve.poisoned"] == 1


# -- a real decoder: one engine.topk a step, two signatures --------------------

def test_one_engine_call_per_step_and_two_traces():
    obs.enable()
    cfg = get_config("qwen3_1p7b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    sched = Scheduler(model, params, n_slots=3, max_seq=32, prefill_len=8,
                      top_k_width=16, variant="torch")
    reqs = [Request(prompt=list(range(1, 2 + i)), max_new_tokens=3 + i,
                    params=SamplingParams()) for i in range(5)]
    done = sched.run(reqs)
    assert len(done) == 5 and all(c.status == "OK" for c in done)
    assert [len(c.tokens) for c in sorted(done, key=lambda c: c.uid)] == \
        [3, 4, 5, 6, 7]
    snap = obs.snapshot()
    steps = snap["timers"]["serve.step"]["count"]
    topk = {k: v["count"] for k, v in snap["timers"].items()
            if k.startswith("engine.topk.")}
    assert topk == {"engine.topk.torch": steps}
    assert sched.traces == 2 == snap["counters"]["serve.trace"]
    st = sched.stats()
    assert st["steps"] == steps and st["serve.retired"] == 5
    line = TRP.serve_stats_line(snap)
    assert line.startswith(f"[serve] step={steps} ") and "traces=2" in line


def test_reporting_renders_as_jax_does():
    snap = {"enabled": True, "counters": {"serve.tokens": 40, "a.b": 2},
            "gauges": {"serve.live_slots": 3},
            "timers": {"serve.step": {"count": 10, "p50_us": 1500.0,
                                      "p99_us": 2.5e6, "max_us": 3e6,
                                      "total_us": 4e6}},
            "events": [{"kind": "serve.admit", "data": {"uid": i}}
                       for i in range(14)]}
    assert TRP.render_report(snap) == JR.render_report(snap).replace(
        "repro.obs", "repro_torch.obs")
    assert TRP.serve_stats_line(snap, 7) == JR.serve_stats_line(snap, 7)
    c = {"plan_cache.hit": 5, "moe.dropped_tokens": 3}
    assert TRP.stats_line(4, [0.01, 0.02], 8, c) == \
        JR.stats_line(4, [0.01, 0.02], 8, c)
    assert obs.report({"enabled": False}).endswith("(empty)")


# -- greedy completions against JAX serve_batch --------------------------------

def _requests(req_cls, params_cls, specs):
    return [req_cls(prompt=p, max_new_tokens=n, eos_id=e, uid=1000 + i,
                    params=params_cls(temperature=0.0))
            for i, (p, n, e) in enumerate(specs)]


def _jax_and_port(arch, kw, seed):
    """The reduced config's JAX model and weights, and the port's model and
    the same weights."""
    jm = jbuild(jget_config(arch).reduced(**kw))
    jp = jm.init(jax.random.PRNGKey(seed))
    params = decoder_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, build_model(get_config(arch).reduced(**kw)), params


def _served(done):
    return {c.uid: (c.tokens, c.finish_reason, c.status) for c in done}


SERVE_KW = dict(n_slots=3, max_seq=24, prefill_len=8, top_k_width=16)


def _specs(rng, vocab):
    """7 greedy requests, prompts of 1-8 tokens (most shorter than
    ``prefill_len``, so pad tokens pass the commit mask), 2-8 new ones."""
    return [(rng.integers(1, vocab, int(rng.integers(1, 9))).tolist(),
             int(rng.integers(2, 9)), None) for _ in range(7)]


def test_greedy_serve_batch_matches_jax():
    jm, jp, model, params = _jax_and_port("moonshot_v1_16b_a3b", {}, 4)
    specs = _specs(np.random.default_rng(5), model.cfg.vocab_size)
    jobs.disable()
    jdone, _, jsched = jserve_batch(
        jm, jp, _requests(JRequest, JSamplingParams, specs), **SERVE_KW)
    jtok = {c.uid: c.tokens for c in jdone}
    # EOS on the token JAX emits third, for two requests
    specs[1] = specs[1][:2] + (jtok[1001][min(2, len(jtok[1001]) - 1)],)
    specs[4] = specs[4][:2] + (jtok[1004][0],)
    jdone, _, _ = jserve_batch(
        jm, jp, _requests(JRequest, JSamplingParams, specs), **SERVE_KW)
    done, _, sched = serve_batch(
        model, params, _requests(Request, SamplingParams, specs), **SERVE_KW)
    assert sched.traces == 2
    got, exp = _served(done), _served(jdone)
    assert got == exp
    assert {r for _, r, _ in got.values()} == {"eos", "length"}
    assert [c.uid for c in done] == [c.uid for c in jdone]


@pytest.mark.parametrize("arch,kw", [
    ("zamba2_2p7b", {}),
    ("xlstm_1p3b", {}),
    ("gemma2_9b", dict(sliding_window=8)),
], ids=["zamba2", "xlstm", "gemma2_swa"])
def test_greedy_serve_batch_matches_jax_families(arch, kw):
    """The recurrent and local / global families through the scheduler:
    greedy completions equal JAX ``serve_batch``'s token for token, over
    more requests than slots, so slots are reused and each prefill passes
    pad tokens that must leave every state leaf (Mamba2 ``S`` / ``conv``,
    the mLSTM / sLSTM states with their -30 stabilisers, the rolling local
    buffer) as it was."""
    jm, jp, model, params = _jax_and_port(arch, kw, 6)
    specs = _specs(np.random.default_rng(7), model.cfg.vocab_size)
    assert sum(len(p) < SERVE_KW["prefill_len"] for p, _, _ in specs) >= 5
    jobs.disable()
    jdone, _, _ = jserve_batch(
        jm, jp, _requests(JRequest, JSamplingParams, specs), **SERVE_KW)
    done, _, sched = serve_batch(
        model, params, _requests(Request, SamplingParams, specs), **SERVE_KW)
    assert sched.traces == 2
    assert _served(done) == _served(jdone)
    assert [c.uid for c in done] == [c.uid for c in jdone]
