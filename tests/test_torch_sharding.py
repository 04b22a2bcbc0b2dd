"""The port's sharding rules against the JAX package's, spec for spec, in
one process.

``param_specs`` (both ``zero`` settings), ``batch_spec``, ``cache_specs``
and ``launch.steps.cell_shardings`` of all ten configs at their published
widths (``meta`` tensors in the port, ``jax.eval_shape`` in JAX), on the
port's ``AbstractMesh`` and JAX's ``jax.sharding.AbstractMesh`` of the
test shape (2, 4) ``("data", "model")`` and the production shapes (16, 16)
and (2, 16, 16) ``("pod", "data", "model")`` -- no process is needed for
either -- under ``ShardingConfig()``, ``expert_mode="ffn"``,
``fsdp_axis=""`` and ``shard_kv_seq=True``. Leaves are matched by the
path both checkpoint managers write, specs compared as tuples
(``tuple(PartitionSpec)``). Beside them: ``shard_leaf`` cuts every rank's
block so that the blocks tile the leaf exactly once, ``block_slices``
agrees with it, ``gather_leaf`` and ``param_blocks`` on a world of 1.
The multi-rank gathers are ``tests/test_torch_distributed_train.py``.
"""
import dataclasses
import functools
import itertools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models.config import ShardingConfig as JShardingConfig  # noqa: E402,E501
from repro.parallel import sharding as JSH  # noqa: E402
from repro_torch.checkpoint.manager import _flatten  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models.config import ShardingConfig  # noqa: E402
from repro_torch.parallel import sharding as TSH  # noqa: E402

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SCS = {"default": {}, "ffn": {"expert_mode": "ffn"},
       "no_fsdp": {"fsdp_axis": ""}, "kv_seq": {"shard_kv_seq": True}}
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


class _Spec:
    """A spec held as a leaf, so that ``_flatten`` stops at it."""

    def __init__(self, spec):
        self.spec = spec


def _jax_names(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _jax_flat(tree):
    """(name, spec tuple) of a JAX spec or sharding tree, in JAX order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (P, jax.sharding.Sharding)))
    return [(_jax_names(p), tuple(getattr(s, "spec", s))) for p, s in flat]


def _port_flat(tree, specs):
    """(name, spec) of a port spec (or sharding) tree over ``tree``."""
    boxed = TSH.tree_map_like(lambda _, s: _Spec(getattr(s, "spec", s)),
                              tree, specs)
    return [(n, b.spec) for n, b in _flatten(boxed)]


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), JAbstractMesh(sizes, axes)


def _scs(name):
    return ShardingConfig(**SCS[name]), JShardingConfig(**SCS[name])


@functools.lru_cache(maxsize=None)
def _abstract(arch, shape):
    """The cell's stand-ins on both sides (cached: ten configs at full
    width, each traced once)."""
    t_model, t_params, t_opt = TS.abstract_state(get_config(arch), shape)
    j_model, j_params, j_opt = JS.abstract_state(jget_config(arch), shape)
    return t_params, t_opt, j_params, j_opt


def _same(got, want, what):
    assert [n for n, _ in got] == [n for n, _ in want], what
    bad = [(n, g, w) for (n, g), (_, w) in zip(got, want) if g != w]
    assert not bad, (what, bad[:5])


@pytest.mark.parametrize("sc_name", list(SCS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh_name, sc_name):
    tm, jm = _meshes(mesh_name)
    tsc, jsc = _scs(sc_name)
    t_params, _, j_params, _ = _abstract(arch, "train_4k")
    for zero in (False, True):
        _same(_port_flat(t_params, TSH.param_specs(t_params, tsc, tm,
                                                   zero=zero)),
              _jax_flat(JSH.param_specs(j_params, jsc, jm, zero=zero)),
              (arch, mesh_name, sc_name, zero))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(arch, mesh_name):
    tm, jm = _meshes(mesh_name)
    for sc_name in SCS:
        tsc, jsc = _scs(sc_name)
        for shape in SHAPES:
            tb = TS.input_specs(get_config(arch), shape)
            jb = JS.input_specs(jget_config(arch), shape)
            _same(_port_flat(tb, TSH.batch_spec(tb, tsc, tm)),
                  _jax_flat(JSH.batch_spec(jb, jsc, jm)),
                  (arch, mesh_name, sc_name, shape, "batch"))
        tc = TS.abstract_cache(get_config(arch), "decode_32k")
        jc = JS.abstract_cache(jget_config(arch), "decode_32k")
        _same(_port_flat(tc, TSH.cache_specs(tc, tsc, tm)),
              _jax_flat(JSH.cache_specs(jc, jsc, jm)),
              (arch, mesh_name, sc_name, "cache"))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_shardings_match_jax(arch, shape):
    for mesh_name in MESHES:
        tm, jm = _meshes(mesh_name)
        tsc, jsc = _scs("default")
        got = TS.cell_shardings(get_config(arch), shape, tm, tsc)
        want = JS.cell_shardings(jget_config(arch), shape, jm, jsc)
        assert set(got) == set(want), (arch, shape)
        for part in want:
            t_tree, t_sh = got[part]
            j_tree, j_sh = want[part]
            # the stand-ins: the JAX shapes, leaf for leaf
            t_shapes = [(n, tuple(x.shape)) for n, x in _flatten(t_tree)]
            j_flat, _ = jax.tree_util.tree_flatten_with_path(j_tree)
            assert t_shapes == [(_jax_names(p), tuple(x.shape))
                                for p, x in j_flat], (arch, shape, part)
            if isinstance(t_sh, TSH.NamedSharding):
                assert t_sh.spec == tuple(j_sh.spec), (arch, shape, part)
                assert t_sh.mesh is tm
                continue
            _same(_port_flat(t_tree, t_sh), _jax_flat(j_sh),
                  (arch, shape, mesh_name, part))


def test_expert_mode_reads_the_layer_count():
    """The JAX rule's expert-mode test reads ``shape[0]`` -- the layer
    count of a stacked leaf: kept, so Moonlight cut to 4 layers shards its
    experts on a ``model`` axis of 4 and their f on one of 8."""
    cfg = dataclasses.replace(get_config("moonshot_v1_16b_a3b"), n_layers=4)
    jcfg = dataclasses.replace(jget_config("moonshot_v1_16b_a3b"),
                               n_layers=4)
    t_params = TS.abstract_state(cfg, "train_4k", with_opt=False)[1]
    j_params = JS.abstract_state(jcfg, "train_4k", with_opt=False)[1]
    for sizes in ((1, 4), (2, 8), (1, 3)):
        tm = AbstractMesh(sizes, ("data", "model"))
        jm = JAbstractMesh(sizes, ("data", "model"))
        got = TSH.param_specs(t_params, ShardingConfig(), tm)
        _same(_port_flat(t_params, got),
              _jax_flat(JSH.param_specs(j_params, JShardingConfig(), jm)),
              sizes)
        wi = got["blocks"]["moe"]["wi"]
        # 4 layers: an expert split on model 4, f split on model 8
        assert wi == {(1, 4): (None, "model", None, None),
                      (2, 8): (None, None, None, "model"),
                      (1, 3): (None, None, None, None)}[sizes], (sizes, wi)


class _Coords:
    """A rank's coordinates on a mesh of ``sizes``, no process behind it
    (``shard_leaf`` reads sizes and indices only)."""

    def __init__(self, sizes, axes, coords):
        self.axis_names = axes
        self.shape = dict(zip(axes, sizes))
        self.coords = dict(zip(axes, coords))

    def axis_size(self, a):
        return self.shape[a]

    def axis_index(self, a):
        return self.coords[a]


@pytest.mark.parametrize("spec", [
    ("data", None), (None, "model"), ("model", "data"),
    (("pod", "data"), None), (None, ("data", "model")), (None, None),
    ("pod", ("model", "data"))])
def test_shard_leaf_blocks_tile_the_leaf(spec):
    sizes, axes = (2, 2, 4), ("pod", "data", "model")
    x = torch.arange(16 * 32, dtype=torch.float32).reshape(16, 32)
    seen = torch.zeros_like(x)
    for coords in itertools.product(*(range(s) for s in sizes)):
        m = _Coords(sizes, axes, coords)
        blk = TSH.shard_leaf(x, spec, m)
        sl = TSH.block_slices(tuple(x.shape), spec, m)
        assert torch.equal(blk, x[sl])
        seen[sl] += 1
    # every element in exactly the blocks of the ranks that replicate it
    reps = np.prod(sizes) // np.prod(
        [sizes[axes.index(a)] for e in spec for a in TSH.spec_axes(e)])
    assert bool((seen == reps).all())


def test_shard_leaf_row_major_over_a_dims_axes():
    """A dim split over ``("pod", "data")`` gives block ``pod * D +
    data``, as ``NamedSharding`` does."""
    x = torch.arange(8)
    m = _Coords((2, 4), ("pod", "data"), (1, 2))
    assert TSH.shard_leaf(x, (("pod", "data"),), m).tolist() == [6]
    assert TSH.shard_leaf(x, (("data", "pod"),), m).tolist() == [5]


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    old = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    m = make_mesh((1, 1), ("data", "model"), backend="gloo", rank=0,
                  world_size=1, store_dir=str(tmp_path_factory.mktemp("st")),
                  device="cpu")
    yield m
    dist.destroy_process_group()
    if old is None:
        os.environ.pop("GLOO_SOCKET_IFNAME", None)
    else:
        os.environ["GLOO_SOCKET_IFNAME"] = old


def test_blocks_on_a_world_of_one(world1):
    cfg = get_config("qwen3_1p7b").reduced()
    from repro_torch.models.model import build_model
    params = build_model(cfg).init(torch.Generator().manual_seed(3),
                                   device="cpu")
    specs = TSH.param_specs(params, ShardingConfig(), world1)
    blocks = TSH.param_blocks(params, specs, world1)
    for (n, a), (_, b), (_, s) in zip(_flatten(params), _flatten(blocks),
                                      _port_flat(params, specs)):
        assert torch.equal(a, b), n
        assert torch.equal(TSH.gather_leaf(b, s, world1), a), n


def test_act_context_is_seen_from_another_thread():
    """Autograd runs a card's backward, and with it remat's recompute of
    the MoE layer, on a device thread of its own: the context the mesh
    train step sets must be seen there (a thread-local one sent the
    recompute down the one-group path with a rank's expert band)."""
    import threading
    from repro_torch.parallel import act
    before = act.context_mesh()
    m = AbstractMesh((2, 2), ("data", "model"))
    seen = {}
    with act.context(m, ("pod", "data"), "model"):
        t = threading.Thread(target=lambda: seen.update(
            mesh=act.context_mesh(), tp=act.model_axis()))
        t.start()
        t.join()
    assert seen == {"mesh": m, "tp": "model"}
    assert act.context_mesh() is before
