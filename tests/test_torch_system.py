"""The port's trainer, data pipeline and launch helpers end to end on the
CPU: ``tests/test_system.py`` mirrored, and the data and launch helpers
against the JAX package's.

- ``test_training_reduces_loss``, ``test_resume_is_exact`` (rtol 1e-4, as
  the JAX test), ``test_data_pipeline_deterministic`` and
  ``test_serve_generates`` on ``device="cpu"`` (the dry-run test needs the
  sharded ops, ROADMAP queue 1 item 4); the train and serve CLIs;
- ``pack_by_length`` bit for bit against JAX (FLiMS argsort, ties in input
  order); ``make_batch_specs`` and ``abstract_state`` / ``abstract_cache``:
  the JAX shapes and dtypes on the ``meta`` device, leaf paths as both
  checkpoint managers name them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.butterfly import tree_leaves  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models.config import TrainConfig  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads for this file's many small ops: under the
    parallel test run the default (a thread a core in each worker) spins
    against the other workers and ran the 60-step loop ~40x slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("n,bin_size", [(37, 100), (300, 512), (1, 8)])
def test_pack_by_length_matches_jax(n, bin_size):
    rng = np.random.default_rng(n)
    lens = rng.integers(1, bin_size + 1, n).astype(np.int32)
    lens[: n // 3] = lens[0]                   # ties keep input order
    jo, jb = JD.pack_by_length(jnp.asarray(lens), bin_size)
    to, tb = TD.pack_by_length(torch.from_numpy(lens), bin_size)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert to.dtype == tb.dtype == torch.int32


_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


@pytest.mark.parametrize("arch", ["qwen3_1p7b", "whisper_large_v3",
                                  "internvl2_76b"])
def test_batch_specs_match_jax(arch):
    j = JD.make_batch_specs(jget_config(arch), 1024, 8)
    t = TD.make_batch_specs(get_config(arch), 1024, 8)
    assert list(t) == list(j)
    for name in j:
        assert tuple(t[name].shape) == j[name].shape
        assert t[name].dtype == _DTYPES[j[name].dtype]
        assert t[name].device.type == "meta"


def test_abstract_state_matches_jax():
    """Full-width Moonlight on the meta device: every parameter and
    optimizer leaf's path (as both checkpoint managers name it), shape and
    dtype as ``jax.eval_shape`` gives them."""
    from repro.checkpoint.manager import _flatten as jflatten
    from repro_torch.checkpoint.manager import _flatten
    arch = "moonshot_v1_16b_a3b"
    _, jp, jo = JS.abstract_state(jget_config(arch), "train_4k")
    _, tp, to = TS.abstract_state(get_config(arch), "train_4k")
    jnames, jl, _ = jflatten((jp, jo))
    flat = _flatten((tp, to))
    assert [n for n, _ in flat] == jnames
    for a, (_, b) in zip(jl, flat):
        assert tuple(b.shape) == a.shape and b.dtype == _DTYPES[a.dtype]
        assert b.device.type == "meta"
    jc = JS.abstract_cache(jget_config("qwen3_1p7b"), "decode_32k")
    tc = TS.abstract_cache(get_config("qwen3_1p7b"), "decode_32k")
    assert [tuple(x.shape) for x in tree_leaves(tc)] == \
        [x.shape for x in jax.tree.leaves(jc)]
    assert TS.long_500k_applicable(get_config("zamba2_2p7b"))
    assert not TS.long_500k_applicable(get_config("qwen3_1p7b"))


def test_training_reduces_loss(tmp_path):
    from repro_torch.launch.train import TrainLoop
    cfg = get_config("qwen3_1p7b").reduced()
    tcfg = TrainConfig(global_batch=8, seq_len=128, lr=1e-3, total_steps=60,
                       warmup_steps=5, checkpoint_every=1000,
                       checkpoint_dir=str(tmp_path))
    loop = TrainLoop(cfg, tcfg, device="cpu")
    _, _, losses = loop.run(resume="no", max_steps=60)
    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first - 0.1, (first, last)


def test_resume_is_exact(tmp_path):
    """30 straight steps == 20 steps + checkpoint + restart + 10 steps."""
    from repro_torch.launch.train import TrainLoop
    cfg = get_config("qwen3_1p7b").reduced()

    def mk(tdir):
        return TrainConfig(global_batch=4, seq_len=64, lr=1e-3,
                           total_steps=30, warmup_steps=2,
                           checkpoint_every=20, checkpoint_dir=tdir)

    loop = TrainLoop(cfg, mk(str(tmp_path / "a")), device="cpu")
    _, _, straight = loop.run(resume="no", max_steps=30)
    d2 = str(tmp_path / "b")
    TrainLoop(cfg, mk(d2), device="cpu").run(resume="no", max_steps=20)
    loop2 = TrainLoop(cfg, mk(d2), device="cpu")
    _, _, resumed = loop2.run(resume="auto", max_steps=30)
    assert len(resumed) == 10
    np.testing.assert_allclose(straight[-5:], resumed[-5:], rtol=1e-4)


def test_data_pipeline_deterministic():
    d = TD.SyntheticLM(1000, 64, 4, seed=3, device="cpu")
    b1, b2 = d.batch(17), d.batch(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], d.batch(18)["tokens"])
    toks = b1["tokens"]
    assert toks.dtype == torch.int32 and toks.shape == (4, 64)
    assert ((toks >= 0) & (toks < 1000)).all()
    step = (toks[:, 1:] - toks[:, :-1]) % 1000
    assert ((step <= 3) | (step >= 997)).all()       # a walk of |step| <= 3
    assert torch.equal(b1["targets"], torch.roll(toks, -1, 1))
    assert (b1["mask"][:, -1] == 0).all() and (b1["mask"][:, :-1] == 1).all()


@pytest.mark.parametrize("arch", ["qwen3_1p7b", "whisper_large_v3"])
def test_serve_generates(arch):
    from repro_torch.launch.serve import serve
    cfg = get_config(arch).reduced()
    toks, dt = serve(cfg, batch=2, prompt_len=4, gen=6, device="cpu")
    assert toks.shape == (2, 6)
    assert (toks >= 0).all() and (toks < cfg.vocab_size).all()


def test_train_cli_runs(tmp_path, capsys):
    from repro_torch.launch import serve as TSV
    from repro_torch.launch import train as TT
    assert TT.main(["--arch", "qwen3_1p7b", "--reduced", "--device", "cpu",
                    "--steps", "3", "--batch", "2", "--seq", "32",
                    "--ckpt-dir", str(tmp_path)]) == 0
    assert (tmp_path / "step_3" / "meta.json").exists()
    assert TSV.main(["--arch", "qwen3_1p7b", "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "4", "--gen", "3",
                     "--verify", "--stats", "2"]) == 0
    out = capsys.readouterr().out
    assert "first loss" in out and "generated (2, 3)" in out
    assert "verify: 0 failures" in out
