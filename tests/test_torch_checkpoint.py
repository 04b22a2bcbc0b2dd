"""The port's checkpoint manager (``tests/test_checkpoint.py`` mirrored),
its bf16 leaves, and a directory the JAX manager wrote.

Eight of the JAX file's nine tests run here on torch trees; the ninth,
``test_elastic_reshard_subprocess`` (save on a 4-device mesh, restore onto
8), is ``tests/test_torch_distributed_train.py``'s
``test_elastic_restore_from_four_ranks`` (gloo ranks). Beside them: a bf16
leaf goes to disk as its uint16 bits (never float32) with its dtype in
``meta.json`` and comes back bit for bit; ``restore`` puts each leaf on
``like``'s device and dtype; and a reduced Qwen3 ``(params, opt)`` tree
saved by the JAX ``CheckpointManager`` restores in the port, whose next
training step gives JAX's next loss (rtol 2e-5: float32 sums in another
order) and JAX's updated parameters (``test_torch_train.py``'s
``UPDATE_TOL``).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402,E501
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.butterfly import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models.config import TrainConfig  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.int32)}}


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def _equal(t1, t2):
    l1, l2 = tree_leaves(t1), tree_leaves(t2)
    return len(l1) == len(l2) and all(
        a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(l1, l2))


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = _tree()
    mgr.save(7, tree, {"next_step": 7, "note": "x"})
    assert mgr.latest_step() == 7
    restored, extra = mgr.restore(7, _zeros_like(tree))
    assert _equal(tree, restored)
    assert extra["note"] == "x"


def test_async_save_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]


def test_async_save_copies_before_returning(tmp_path):
    """The train loop updates its tensors in place right after ``save``
    returns: the write must hold the values of the call."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    tree = _tree()
    mgr.save(1, tree)
    tree["a"].add_(100.0)
    mgr.wait()
    restored, _ = mgr.restore(1, _zeros_like(tree))
    assert torch.equal(restored["a"], _tree()["a"])


def test_atomicity_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree())
    for d in os.listdir(tmp_path):
        assert not d.endswith(".tmp")


def test_tree_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree())
    with pytest.raises(AssertionError):
        mgr.restore(1, {"different": torch.zeros((2,))})


def test_stale_tmp_swept_on_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree())
    os.makedirs(tmp_path / "step_2.tmp")          # crash-mid-save debris
    with pytest.warns(UserWarning, match="stale"):
        mgr2 = CheckpointManager(str(tmp_path))
    assert not (tmp_path / "step_2.tmp").exists()
    assert mgr2.all_steps() == [1]                # real checkpoints intact


def test_restore_skips_corrupt_meta(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    t1 = _tree()
    t2 = tree_map(lambda a: a + 1, t1)
    mgr.save(1, t1)
    mgr.save(2, t2)
    (tmp_path / "step_2" / "meta.json").write_text("{not json")
    with pytest.warns(UserWarning, match="corrupt"):
        restored, _ = mgr.restore(2, _zeros_like(t1))
    assert _equal(t1, restored)


def test_restore_skips_missing_arrays(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    t1 = _tree()
    mgr.save(1, t1)
    mgr.save(2, t1)
    os.remove(tmp_path / "step_2" / "arrays.npz")
    with pytest.warns(UserWarning, match="corrupt"):
        restored, _ = mgr.restore(2, _zeros_like(t1))
    assert _equal(t1, restored)


def test_restore_raises_when_nothing_intact(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree())
    (tmp_path / "step_1" / "meta.json").write_text("")
    with pytest.raises(FileNotFoundError):
        with pytest.warns(UserWarning):
            mgr.restore(1, _tree())


# -- beyond the JAX file ----------------------------------------------------

def test_bf16_leaves_stored_as_bits(tmp_path):
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((33, 7)).astype(
        np.float32)).to(torch.bfloat16)
    params = {"w": w, "n": torch.ones(7, dtype=torch.bfloat16)}
    tree = (params, adamw_init(params))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(4, tree)
    meta = json.loads((tmp_path / "step_4" / "meta.json").read_text())
    assert meta["names"][:2] == ["0/n", "0/w"]
    assert meta["names"][2:5] == ["1/.step", "1/.m/n", "1/.m/w"]
    assert meta["dtypes"][:3] == ["bfloat16", "bfloat16", "int32"]
    with np.load(tmp_path / "step_4" / "arrays.npz") as z:
        assert z["a1"].dtype == np.uint16 and z["a1"].shape == (33, 7)
        assert z["a2"].dtype == np.int32 and z["a2"].shape == ()
    like = (tree_map(torch.zeros_like, params), adamw_init(params))
    restored, _ = mgr.restore(4, like)
    assert _equal(tree[0], restored[0])
    assert restored[1].step.shape == () and int(restored[1].step) == 0
    assert type(restored[1]).__name__ == "AdamWState"
    assert _equal(tree[1].master, restored[1].master)


def test_restore_takes_like_dtype_and_keeps_key_order(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    tree = {"z": torch.arange(4, dtype=torch.float32), "a": [torch.ones(2)]}
    mgr.save(1, tree)
    like = {"z": torch.zeros(4, dtype=torch.float64), "a": [torch.zeros(2)]}
    restored, _ = mgr.restore(1, like)
    assert list(restored) == ["z", "a"]
    assert restored["z"].dtype == torch.float64
    assert torch.equal(restored["z"], torch.arange(4, dtype=torch.float64))


def test_restores_a_jax_checkpoint_and_steps_as_jax(tmp_path):
    """The JAX manager saves a reduced Qwen3 ``(params, opt)`` after one
    JAX step; the port restores it into its own fresh state and takes the
    next step, which matches the JAX step from the same checkpoint."""
    jcfg = jget_config("qwen3_1p7b").reduced()
    cfg = get_config("qwen3_1p7b").reduced()
    tc = dict(global_batch=2, seq_len=32, lr=1e-3, warmup_steps=2,
              total_steps=10)
    jmodel, jstep = JS.make_train_step(jcfg, JTrainConfig(**tc))
    jstep = jax.jit(jstep)
    rng = np.random.default_rng(8)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 32)).astype(
                    np.int32),
                "targets": rng.integers(0, cfg.vocab_size, (2, 32)).astype(
                    np.int32),
                "mask": np.ones((2, 32), np.float32)} for _ in range(2)]
    jp = jmodel.init(jax.random.PRNGKey(3))
    jo = JA.adamw_init(jp)
    jp, jo, _ = jstep(jp, jo, jax.tree.map(jnp.asarray, batches[0]))
    jmgr = JCheckpointManager(str(tmp_path), async_save=False)
    jmgr.save(1, (jp, jo), {"next_step": 1})
    jp2, _, jmet = jstep(jp, jo, jax.tree.map(jnp.asarray, batches[1]))

    model, step = TS.make_train_step(cfg, TrainConfig(**tc))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr.latest_step() == 1
    (params, opt), extra = mgr.restore(1, (params, adamw_init(params)))
    assert extra == {"next_step": 1} and int(opt.step) == 1
    params, opt, met = step(params, opt, {k: torch.from_numpy(v) for k, v
                                          in batches[1].items()})
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=2e-5)
    from repro.checkpoint.manager import _flatten as jflatten
    from repro_torch.checkpoint.manager import _flatten
    jl = jflatten(jp2)[1]
    for (_, g), r in zip(_flatten(params), jl):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-6,
                                   atol=5e-6)
