"""End-to-end training driver with fault tolerance (counterpart of
``repro/launch/train.py``), on one device.

- auto-resume from the newest checkpoint (``--resume auto``), at the step
  its ``extra["next_step"]`` names;
- an atomic, async checkpoint every ``checkpoint_every`` steps and at the
  last one;
- SIGTERM / SIGINT -> checkpoint and exit (preemption);
- a straggler line for a step slower than 3x the running median of the
  last 50;
- deterministic data replay (the synthetic stream is seeded per step).

The loop runs on ``device`` ("cuda" unless the caller asks for "cpu");
weights come from a ``torch.Generator`` seeded with ``tcfg.seed`` there.
With ``mesh`` (a ``launch.mesh.Mesh``; every rank runs the loop) it runs
on the mesh's device under ``parallel.act.set_context(mesh)``: the state
is this rank's blocks (``launch.steps.MeshLayout``), each parameter leaf
drawn from the same generator as the one-process init and cut as it is
drawn, the batch cut from the same global batch, and the checkpoints are
written whole by rank 0 and restored onto any mesh. Like the JAX trainer,
the loop applies no gradient compression.

Run small on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_1p7b \\
      --reduced --device cpu --steps 50 --batch 8 --seq 128
"""
from __future__ import annotations

import argparse
import signal
import sys
import time
from statistics import median

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.steps import make_train_step
from repro_torch.models.config import TrainConfig
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel.act import clear_context, set_context


class TrainLoop:
    def __init__(self, cfg, tcfg: TrainConfig, mesh=None, device="cuda"):
        self.cfg, self.tcfg, self.mesh = cfg, tcfg, mesh
        self.device = torch.device(mesh.device if mesh is not None
                                   else device)
        self.model, self.step_fn = make_train_step(cfg, tcfg, mesh)
        self.layout = getattr(self.step_fn, "layout", None)
        self.ckpt = CheckpointManager(tcfg.checkpoint_dir,
                                      async_save=tcfg.async_checkpoint)
        self.data = SyntheticLM(cfg.vocab_size, tcfg.seq_len,
                                tcfg.global_batch, tcfg.seed,
                                device=str(self.device))
        self._stop = False
        self.step_times = []

    def _install_signals(self):
        def handler(signum, frame):
            print(f"[train] signal {signum}: checkpoint-and-exit",
                  flush=True)
            self._stop = True

        return {sig: signal.signal(sig, handler)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    def init_state(self):
        """``(params, opt)`` of step 0: whole, or on a mesh this rank's
        blocks of the same draws."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        if self.layout is not None:
            params = self.layout.init(gen)
            return params, self.layout.opt_init(params)
        params = self.model.init(gen)
        return params, adamw_init(params)

    def batch(self, step: int):
        """The batch of ``step``: the global one, or this rank's block."""
        b = self.data.batch(step)
        return b if self.layout is None else self.layout.batch_block(b)

    def _shardings(self):
        if self.layout is None:
            return None
        return (self.layout.param_shardings(), self.layout.opt_shardings())

    def run(self, resume: str = "auto", max_steps=None):
        """Train from step 0 (or the newest checkpoint with ``resume=
        "auto"``) to ``max_steps`` (default ``tcfg.total_steps``). Returns
        ``(params, opt, losses of the steps run)``. The signal handlers
        are the caller's again on return."""
        previous = self._install_signals()
        if self.mesh is not None:
            set_context(self.mesh)
        try:
            return self._run(resume, max_steps)
        finally:
            if self.mesh is not None:
                clear_context()
            for sig, h in previous.items():
                signal.signal(sig, h)

    def resume_state(self, resume: str = "auto"):
        """``(params, opt, start)``: the state of step 0, or with ``resume=
        "auto"`` the newest checkpoint's and the step its ``next_step``
        names."""
        params, opt = self.init_state()
        start = 0
        if resume == "auto" and self.ckpt.latest_step() is not None:
            s = self.ckpt.latest_step()
            (params, opt), extra = self.ckpt.restore(s, (params, opt),
                                                     self._shardings())
            start = int(extra.get("next_step", s))
            print(f"[train] resumed from checkpoint step {s}", flush=True)
        return params, opt, start

    def _agree(self, flag: bool) -> bool:
        from repro_torch.parallel import comm
        for a in self.mesh.axis_names:
            flag = comm.agree_flag(flag, a, self.mesh)
        return flag

    def _run(self, resume, max_steps):
        tc = self.tcfg
        params, opt, start = self.resume_state(resume)
        total = max_steps or tc.total_steps
        losses = []
        for step in range(start, total):
            t0 = time.time()
            params, opt, metrics = self.step_fn(params, opt,
                                                self.batch(step))
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.time() - t0
            self.step_times.append(dt)
            if len(self.step_times) > 5:
                med = median(self.step_times[-50:])
                if dt > 3.0 * med:
                    print(f"[train] STRAGGLER step {step}: {dt:.2f}s vs "
                          f"median {med:.2f}s", flush=True)
            if step % 10 == 0:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt:.2f}s)", flush=True)
            if self.mesh is not None:
                # a signal reaches one rank: every rank stops at this step
                self._stop = self._agree(self._stop)
            if (step + 1) % tc.checkpoint_every == 0 or self._stop \
                    or step + 1 == total:
                self.ckpt.save(step + 1, (params, opt),
                               {"next_step": step + 1, "loss": loss},
                               shardings=self._shardings())
            if self._stop:
                self.ckpt.wait()
                print("[train] clean preemption exit", flush=True)
                return params, opt, losses
        self.ckpt.wait()
        return params, opt, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                       lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(args.steps // 10, 1),
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir)
    loop = TrainLoop(cfg, tcfg, device=args.device)
    _, _, losses = loop.run(resume=args.resume, max_steps=args.steps)
    if losses:
        print(f"[train] first loss {losses[0]:.4f} -> last "
              f"{losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
