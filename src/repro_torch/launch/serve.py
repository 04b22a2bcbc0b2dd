"""Thin serving CLI over ``repro_torch.serve`` (counterpart of
``repro/launch/serve.py``).

Decoder architectures serve through the continuous-batching
:class:`repro_torch.serve.Scheduler`: one prefill per admission, a static
super-batch decode step, and one ragged ``engine.topk`` sampling call a
step for every live request. The encoder-decoder keeps a compact loop
here: one ``model.prefill`` (the encoder and the cross caches), then a
decode step and ``sample_topk`` a token.

The sampler routes through ``repro_torch.engine``: the planner picks the
top-k variant per device, ``--flims-topk`` / ``--torch-topk`` pin one, and
``--plans plans.json`` preloads a plan table (this port's or the JAX
package's). Weights, prompts and the sampling noise come from seeded
generators; the server runs on ``--device`` (``cuda`` unless asked for
``cpu``).

Run small on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3_1p7b \\
      --reduced --device cpu --batch 4 --prompt-len 16 --gen 32 \\
      --top-p 0.9 --stats 8
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.models.model import build_model, sample_topk
from repro_torch.obs.reporting import serve_stats_line
from repro_torch.serve import Request, SamplingParams, Scheduler

#: stub audio frames of the encoder-decoder's prompts, as the JAX CLI's
ENCDEC_FRAMES = 32


def _serve_encdec(model, cfg, params, prompts, gen, n_new, max_seq,
                  use_flims_topk, topk):
    """The compact loop of the encoder-decoder: prefill once, then one
    decode step and one ``sample_topk`` a token."""
    batch, prompt_len = prompts.shape
    dev = prompts.device
    frames = torch.randn((batch, ENCDEC_FRAMES, cfg.d_model), generator=gen,
                         device=dev)
    _, cache = model.prefill(params, {"frames": frames, "tokens": prompts},
                             max_seq)
    tok = prompts[:, -1]
    out = []
    t0 = time.time()
    for t in range(n_new):
        logits, cache = model.decode_step(
            params, tok, torch.full((batch,), prompt_len + t,
                                    dtype=torch.int32, device=dev), cache)
        tok = sample_topk(gen, logits, k=topk, use_flims=use_flims_topk)
        out.append(tok.cpu().numpy())    # waits: the full step's latency
    return np.stack(out, axis=1), time.time() - t0


def serve(cfg, batch: int, prompt_len: int, gen: int, max_seq: int = 0,
          use_flims_topk: bool = None, seed: int = 0, topk: int = 16,
          stats_every: int = 0, temperature: float = 1.0,
          top_p: float = 1.0, min_p: float = 0.0, n_slots: int = 0,
          deadline_s: float = 0.0, max_waiting: int = 0, device="cuda"):
    """Serve ``batch`` random prompts to completion; returns ``(tokens
    (batch, gen), wall seconds)``. Rows retired early (deadline or poison
    isolation) are padded with -1."""
    model = build_model(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    params = model.init(g)
    max_seq = max_seq or (prompt_len + gen)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=g, device=device, dtype=torch.int32)
    if cfg.arch_kind == "encdec":
        return _serve_encdec(model, cfg, params, prompts, g, gen, max_seq,
                             use_flims_topk, topk)

    if stats_every:
        obs.enable()
    variant = (None if use_flims_topk is None
               else ("flims" if use_flims_topk else "torch"))
    sched = Scheduler(model, params, n_slots=n_slots or batch,
                      max_seq=max_seq, prefill_len=prompt_len,
                      top_k_width=topk, variant=variant,
                      max_waiting=max_waiting, seed=seed)
    sp = SamplingParams(temperature=temperature, top_p=top_p, min_p=min_p)
    reqs = [Request(prompt=[int(x) for x in row], max_new_tokens=gen,
                    params=sp, deadline_s=deadline_s or None)
            for row in prompts.cpu().numpy()]
    for r in reqs:
        sched.submit(r)
    t0 = time.time()
    it = 0
    while sched.waiting or sched.live:
        sched.admit()
        if sched.live:
            sched.step()
        it += 1
        if stats_every and it % stats_every == 0:
            print(serve_stats_line(obs.snapshot(), step=it), flush=True)
    dt = time.time() - t0
    by_uid = {c.uid: c for c in sched.completed}
    # deadline / poison retirements can be short: pad rows to (batch, gen)
    toks = np.full((len(reqs), gen), -1, np.int32)
    for i, r in enumerate(reqs):
        got = by_uid[r.uid].tokens
        toks[i, :len(got)] = got
    return toks, dt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--slots", type=int, default=0,
                    help="static super-batch width (0 = --batch; fewer "
                         "slots than requests exercises continuous "
                         "admission)")
    ap.add_argument("--topk", type=int, default=16,
                    help="sampler candidate-prefix width")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="sampling temperature (<= 0 -> greedy)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling cut within the top-k prefix")
    ap.add_argument("--min-p", type=float, default=0.0,
                    help="min-p sampling cut within the top-k prefix")
    ap.add_argument("--torch-topk", action="store_true",
                    help="pin the sampler to the torch top-k")
    ap.add_argument("--flims-topk", action="store_true",
                    help="pin the sampler to the FLiMS merge-tree top-k")
    ap.add_argument("--plans", default=None,
                    help="JSON plan table to preload into the engine")
    ap.add_argument("--save-plans", default=None, metavar="OUT",
                    help="write the engine's plan table (resolved during "
                         "this run) back to JSON, for a later --plans")
    ap.add_argument("--deadline", type=float, default=0.0, metavar="S",
                    help="per-request wall-clock deadline in seconds; "
                         "requests still live past it retire with "
                         "status=TIMEOUT (0 = off)")
    ap.add_argument("--max-waiting", type=int, default=0, metavar="N",
                    help="bound the submit queue at N requests; a full "
                         "queue rejects with QueueFull backpressure "
                         "(0 = unbounded)")
    ap.add_argument("--verify", action="store_true",
                    help="enable the guard layer's postcondition checks "
                         "(sortedness / permutation monitors on the engine "
                         "calls)")
    ap.add_argument("--stats", type=int, default=0, metavar="N",
                    help="enable repro_torch.obs and print a [serve] line "
                         "every N loop iterations, plus a final obs report")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.plans:
        from repro_torch import engine
        engine.load_plans(args.plans)
    use_flims = None                     # the planner decides per device
    if args.torch_topk:
        use_flims = False
    elif args.flims_topk:
        use_flims = True
    if args.stats:
        obs.enable()
    if args.verify:
        from repro_torch.guard import enable_verify
        enable_verify()
    toks, dt = serve(cfg, args.batch, args.prompt_len, args.gen,
                     use_flims_topk=use_flims, topk=args.topk, stats_every=args.stats,
                     temperature=args.temperature, top_p=args.top_p,
                     min_p=args.min_p, n_slots=args.slots,
                     deadline_s=args.deadline, max_waiting=args.max_waiting,
                     device=args.device)
    print(f"[serve] generated {toks.shape} tokens in {dt:.2f}s "
          f"({toks.shape[0] * toks.shape[1] / dt:.1f} tok/s)")
    print(toks[:2, :16])
    if args.verify:
        from repro_torch.guard import checked, failures
        print(f"[serve] verify: {failures()} failures of {checked()} checks")
    if args.stats:
        print(obs.report())
    if args.save_plans:
        from repro_torch import engine
        engine.save_plans(args.save_plans)
        print(f"[serve] wrote engine plan table to {args.save_plans}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
