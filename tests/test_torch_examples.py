"""The port's examples (``src/repro_torch/examples``) run as
``python -m repro_torch.examples.<name> --device cpu`` subprocesses, each
exiting 0 with every self-check line true (a line ending ``: True``, or
``== torch.topk: True``), as many as the example prints. Exact checks:
merges, sorts and top-k against numpy / torch; the MoE dispatch against
the dense compute within 1e-2, as the JAX example holds it; finite losses.
"""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECK = re.compile(r":\s*(True|False)\s*$")

# (example, extra arguments, self-check lines it prints)
EXAMPLES = [("quickstart", [], 6), ("moe_routing", [], 2),
            ("serve_lm", [], 1), ("train_lm", ["--steps", "12"], 1),
            ("distributed_sort", ["--ranks", "4"], 3)]


@pytest.mark.parametrize("name,extra,n_checks", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_example_runs(tmp_path, name, extra, n_checks):
    if name == "train_lm":
        extra = extra + ["--ckpt", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
         "cpu", *extra], capture_output=True, text=True, timeout=300,
        env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    checks = [m.group(1) for line in out.stdout.splitlines()
              for m in [CHECK.search(line)] if m]
    assert checks == ["True"] * n_checks, out.stdout[-3000:]
