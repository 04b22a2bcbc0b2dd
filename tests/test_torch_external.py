"""Parity of the port's out-of-core sort with the JAX package's, on the CPU.

``repro_torch.engine.external_sort`` on its ``torch`` and ``stream_cuda``
variants (the latter through the kernels' plain versions on CPU tensors)
against JAX ``engine.external_sort(variant="xla")`` and ``jnp.sort`` /
``jnp.argsort(stable=True)``; the streaming kernel K8's plain version
against the JAX merge-tree kernel K4 in interpret mode (the same nested
partition and dataflow over uniform runs; the JAX K8 itself does not run
on this jax); the ``stream_cuda`` / ``stream_torch`` executors against
JAX ``stream_xla``; and the out-of-core helpers against the JAX ones. Inputs
come from a seeded numpy generator, a few thousand keys at most, with
``tile_elems=1024, fan_in=4``; a case parametrised over the port's
variants draws its inputs once and computes the JAX reference once.

Tolerance: exact. Keys, payloads and permutations are equal bit for bit;
float keys are compared as int32 bit patterns, so signed zeros count.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import engine as JE  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.engine import external as jext  # noqa: E402
from repro.engine.planner import Plan as JPlan  # noqa: E402
from repro.engine.schedule import MergeSchedule as JSched  # noqa: E402
from repro.engine.schedule import merge_runs as jmerge_runs  # noqa: E402
from repro.engine.schedule import stream_pass as jstream_pass  # noqa: E402
from repro.kernels import stream_merge as jk8  # noqa: E402
from repro.kernels.merge_tree import merge_tree_runs as jk4  # noqa: E402
from repro.kernels.merge_tree import merge_tree_runs_kv as jk4kv  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch import engine as TE  # noqa: E402
from repro_torch import kernels, obs  # noqa: E402
from repro_torch.engine import external as text  # noqa: E402
from repro_torch.engine import planner as tplanner  # noqa: E402
from repro_torch.engine.schedule import MergeSchedule as TSched  # noqa: E402
from repro_torch.engine.schedule import merge_runs as tmerge_runs  # noqa
from repro_torch.engine.schedule import stream_pass as tstream_pass  # noqa
from repro_torch.guard.validate import EngineInputError  # noqa: E402
from repro_torch.kernels import stream_merge as tk8  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402

RNG = np.random.default_rng(37)
FPOOL = np.array([0.0, -0.0, 2.5, -1.0, -np.inf, 7.0], np.float32)
VARIANTS = ["torch", "stream_cuda"]


def same(j, t):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape, (j.shape, t.shape)
    if j.dtype == np.float32:
        assert t.dtype == np.float32
        j, t = j.view(np.int32), t.view(np.int32)
    np.testing.assert_array_equal(j, t.astype(j.dtype))


def _ext(x, **kw):
    kw.setdefault("tile_elems", 1024)
    kw.setdefault("fan_in", 4)
    return TE.external_sort(torch.from_numpy(np.ascontiguousarray(x)),
                            **kw)


def _jext(x, **kw):
    kw.setdefault("tile_elems", 1024)
    kw.setdefault("fan_in", 4)
    return JE.external_sort(jnp.asarray(x), variant="xla", **kw)


#: a case's inputs and JAX results, shared by the port's variants
cached = functools.lru_cache(maxsize=None)


def _events(kind):
    return [e["data"] for e in obs.snapshot()["events"] if e["kind"] == kind]


@pytest.fixture(autouse=True)
def clean_state():
    for m in (JE, TE):
        m.clear_plans()
    obs.disable()
    obs.reset()
    yield
    for m in (JE, TE):
        m.clear_plans()
    obs.disable()
    obs.reset()
    jobs.disable()


# --------------------------------------------------------------------------
# engine.external_sort, key-only
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("n", [1500, 4096, 10_000])
def test_external_sort_matches_jax(variant, descending, n):
    x, jout, jsorted = _normal_case(n, descending)
    out = _ext(x, descending=descending, variant=variant)
    same(jout, out)
    same(jsorted, out)


@cached
def _normal_case(n, descending):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    return (x, np.asarray(_jext(x, descending=descending)),
            np.asarray(jnp.sort(jnp.asarray(x), descending=descending)))


@pytest.mark.parametrize("descending", [True, False])
def test_external_sort_signed_zeros_torch_variant(descending):
    # the reference variant orders a +0/-0 tie as jnp.sort does
    x = RNG.choice(FPOOL, 4096)
    same(_jext(x, descending=descending),
         _ext(x, descending=descending, variant="torch"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_external_sort_int_keys_with_ties(variant):
    x, jout = _int_ties_case()
    out = _ext(x, variant=variant)
    same(jout, out)
    np.testing.assert_array_equal(out.numpy(), -np.sort(-x))


@cached
def _int_ties_case():
    x = np.random.default_rng(9000).integers(-3, 3, 9000).astype(np.int32)
    return x, np.asarray(_jext(x))


def test_external_sort_rejects_2d():
    with pytest.raises(ValueError, match="1-D"):
        TE.external_sort(torch.zeros((4, 4)))


def test_external_sort_lane_guard():
    big = torch.empty(2 ** 31, device="meta")
    with pytest.raises(EngineInputError, match="int32"):
        TE.external_sort(big)


# --------------------------------------------------------------------------
# engine.external_sort, stable KV
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("descending", [True, False])
def test_external_sort_stable_perm(variant, descending):
    keys, jk, jp, jperm = _stable_perm_case(descending)
    ks, perm = _ext(keys, variant=variant, descending=descending,
                    values=torch.arange(6000, dtype=torch.int32))
    same(jp, perm)
    same(jk, ks)
    same(jperm, perm)


@cached
def _stable_perm_case(descending):
    keys = np.random.default_rng(6000).integers(0, 5, 6000).astype(
        np.int32)                                       # heavy ties
    jk, jp = _jext(keys, descending=descending,
                   values=jnp.arange(6000, dtype=jnp.int32))
    jperm = jnp.argsort(jnp.asarray(keys), stable=True, descending=descending)
    return keys, np.asarray(jk), np.asarray(jp), np.asarray(jperm)


@pytest.mark.parametrize("variant", VARIANTS)
def test_external_sort_all_equal_keys_stable(variant):
    keys = np.zeros(5000, np.float32)
    ks, perm = _ext(keys, variant=variant, stable=True,
                    values=torch.arange(5000, dtype=torch.int32))
    same(_all_equal_perm(), perm)
    same(keys, ks)


@cached
def _all_equal_perm():
    return np.asarray(jnp.argsort(jnp.zeros(5000, jnp.float32), stable=True,
                                  descending=True))


@pytest.mark.parametrize("variant", VARIANTS)
def test_external_sort_payload_pytree(variant):
    keys, jk, jv = _payload_case()
    ks, vs = _ext(keys, variant=variant,
                  values={"a": torch.arange(3000, dtype=torch.int32),
                          "b": torch.from_numpy(keys) * 2.0})
    same(jk, ks)
    same(jv["a"], vs["a"])
    same(jv["b"], vs["b"])


@cached
def _payload_case():
    keys = np.random.default_rng(3000).standard_normal(3000).astype(
        np.float32)
    jk, jv = _jext(keys, values={"a": jnp.arange(3000, dtype=jnp.int32),
                                 "b": jnp.asarray(keys) * 2.0})
    return keys, np.asarray(jk), {k: np.asarray(v) for k, v in jv.items()}


@pytest.mark.parametrize("variant", VARIANTS)
def test_external_sort_nan_policies(variant):
    x, jouts = _nan_case()
    for d in (True, False):
        same(jouts[d], _ext(x, descending=d, nan="sort_last",
                            variant=variant))
    with pytest.raises(EngineInputError):
        _ext(x, nan="raise", variant=variant)


@cached
def _nan_case():
    rng = np.random.default_rng(2500)
    x = rng.standard_normal(2500).astype(np.float32)
    x[rng.random(2500) < 0.1] = np.nan
    return x, {d: np.asarray(_jext(x, descending=d, nan="sort_last"))
               for d in (True, False)}


# --------------------------------------------------------------------------
# edge contracts and the pass count
# --------------------------------------------------------------------------

def test_single_tile_delegates_to_engine_sort():
    x = RNG.standard_normal(700).astype(np.float32)
    obs.enable()
    out = TE.external_sort(torch.from_numpy(x), tile_elems=1024)
    assert len(_events("external.delegate")) == 1
    assert not _events("external.run_form")
    assert any(e["op"] == "sort" for e in _events("plan.resolve"))
    np.testing.assert_array_equal(out.numpy(), -np.sort(-x))


@pytest.mark.parametrize("variant", VARIANTS)
def test_fan_in_larger_than_run_count(variant):
    x = RNG.standard_normal(4 * 1024).astype(np.float32)
    obs.enable()
    out = _ext(x, fan_in=64, variant=variant)
    passes = _events("external.pass")
    assert len(passes) == 1 and passes[0]["fan_in"] == 4
    np.testing.assert_array_equal(out.numpy(), -np.sort(-x))


@pytest.mark.parametrize("kv", [False, True])
@pytest.mark.parametrize("variant", VARIANTS)
def test_pass_count_and_bytes_match_jax(variant, kv):
    x, jpass, jform = _pass_count_case(kv)
    kw = dict(stable=True) if kv else {}
    obs.enable()
    _ext(x, variant=variant, **kw)
    passes, form = _events("external.pass"), _events("external.run_form")
    assert len(passes) == troof.external_passes(16, 4) == 2
    assert all(p["level_kind"] == "hbm_run" for p in passes)
    assert [p["bytes_streamed"] for p in passes] == \
        [p["bytes_streamed"] for p in jpass]
    assert form[0]["runs"] == 16
    assert form[0]["bytes_streamed"] == jform[0]["bytes_streamed"]


@cached
def _pass_count_case(kv):
    n = 16 * 1024                       # 16 runs, fan 4 -> 2 passes
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    jobs.enable()
    jobs.reset()
    _jext(x, **(dict(stable=True) if kv else {}))
    ev = jobs.snapshot()["events"]
    jobs.disable()
    jobs.reset()
    return (x, [e["data"] for e in ev if e["kind"] == "external.pass"],
            [e["data"] for e in ev if e["kind"] == "external.run_form"])


# --------------------------------------------------------------------------
# K8's plain version against the JAX merge-tree kernel (interpret mode)
# --------------------------------------------------------------------------

def _uniform_runs(runs, run_len, *, descending=True, ties=0):
    if ties:
        x = RNG.integers(0, ties, (runs, run_len)).astype(np.int32)
    else:
        x = RNG.choice(FPOOL, (runs, run_len))
    x = np.sort(x, axis=1, kind="stable")
    return x[:, ::-1].copy() if descending else x


def _jk4(x, r, runs, run_len, fan, w, block_out, descending=True):
    """JAX K4 over the same uniform runs with K8's output block."""
    C = tk8._block(block_out, run_len, fan, w)
    starts = jnp.arange(runs, dtype=jnp.int32) * run_len
    lens = jnp.full((runs,), run_len, jnp.int32)
    kw = dict(group=fan, n_out=runs * run_len, w=w, block_out=C)
    if r is None:
        return jk4(jnp.asarray(x.ravel()), starts, lens, **kw)
    return jk4kv(jnp.asarray(x.ravel()), jnp.asarray(r.ravel()), starts,
                 lens, descending=descending, **kw)


@pytest.mark.parametrize("geom", [(8, 64, 4, 8, 128), (4, 32, 2, 8, 32),
                                  (16, 16, 16, 8, 32)])
def test_stream_kernel_plain_matches_jax_k4(geom):
    runs, run_len, fan, w, block_out = geom
    x = _uniform_runs(runs, run_len)
    out = tk8.stream_merge_runs(torch.from_numpy(x.ravel()), runs=runs,
                                run_len=run_len, fan_in=fan, w=w,
                                block_out=block_out)
    assert out.shape[0] == runs * run_len
    same(_jk4(x, None, runs, run_len, fan, w, block_out), out)


@pytest.mark.parametrize("descending", [True, False])
def test_stream_kernel_kv_plain_matches_jax_k4(descending):
    runs, run_len, fan, w, block_out = 8, 64, 4, 8, 64
    k = _uniform_runs(runs, run_len, descending=descending, ties=3)
    r = np.arange(runs * run_len, dtype=np.int32).reshape(runs, run_len)
    ok, orr = tk8.stream_merge_runs_kv(
        torch.from_numpy(k.ravel()), torch.from_numpy(r.ravel()), runs=runs,
        run_len=run_len, fan_in=fan, w=w, block_out=block_out,
        descending=descending)
    jk, jr = _jk4(k, r, runs, run_len, fan, w, block_out, descending)
    same(jk, ok)
    same(jr, orr)


def test_stream_kernel_chains_with_slack():
    # pass 1 leaves the slack pass 2 needs (sentinels), pass 2 reads it as
    # is; distinct keys, so the sorted keys are the oracle
    w, block_out = 8, 128
    runs, run_len, fan = 16, 64, 4
    x = np.sort(RNG.standard_normal((runs, run_len)).astype(np.float32),
                axis=1)[:, ::-1].copy()
    slack = tk8.stream_slack(fan, w, block_out)
    buf = torch.cat([torch.from_numpy(x.ravel()),
                     torch.full((slack,), -np.inf)])
    b1 = tk8.stream_merge_runs(buf, runs=runs, run_len=run_len, fan_in=fan,
                               w=w, block_out=block_out, out_slack=slack)
    n = runs * run_len
    assert b1.shape[0] == n + slack
    assert bool((b1[n:] == -np.inf).all())
    b2 = tk8.stream_merge_runs(b1, runs=runs // fan, run_len=run_len * fan,
                               fan_in=fan, w=w, block_out=block_out)
    same(-np.sort(-x.reshape(runs // fan, -1), axis=1).ravel(), b1[:n])
    same(-np.sort(-x.ravel()), b2)


# --------------------------------------------------------------------------
# K8's persistent CUDA design: what the wrapper computes, and its hinge
# --------------------------------------------------------------------------

def _kv_runs(runs, run_len, descending):
    """Keys from FPOOL (+0.0, -0.0, -inf, ties) with a permutation of ranks,
    each run in the compound (key, rank) order."""
    k = RNG.choice(FPOOL, (runs, run_len))
    r = RNG.permutation(runs * run_len).astype(np.int32).reshape(runs,
                                                                 run_len)
    for i in range(runs):
        p = np.lexsort((r[i], -k[i] if descending else k[i]))
        k[i], r[i] = k[i][p], r[i][p]
    return torch.from_numpy(k.ravel().copy()), torch.from_numpy(r.ravel().copy())


@pytest.mark.parametrize("geom", [(8, 64, 4, 8), (16, 32, 8, 8),
                                  (4, 128, 2, 16), (8, 64, 2, 32),
                                  (4, 256, 2, 128)])
def test_stream_plain_output_does_not_depend_on_block(geom):
    """The hinge of the CUDA kernel's persistent design: a span streams
    through the tree from one partition, which is the per-block kernel at
    an output block of the span's length. The plain version gives the same
    bits at every block from w to the group's length, key-only and KV both
    directions, on keys with +0.0/-0.0, -inf and heavy ties."""
    runs, run_len, fan, w = geom
    kw = dict(runs=runs, run_len=run_len, fan_in=fan, w=w)
    blocks = [w << i for i in range((fan * run_len // w).bit_length())]
    assert blocks[-1] == fan * run_len
    for descending in (True, False):
        k, r = _kv_runs(runs, run_len, descending)
        outs = []
        for bo in blocks:
            got = tk8.stream_merge_runs_kv(k, r, block_out=bo,
                                           descending=descending, **kw)
            if descending:
                got += (tk8.stream_merge_runs(k, block_out=bo, **kw),)
            outs.append([x.view(torch.int32) if x.dtype == torch.float32
                         else x for x in got])
        for o in outs[1:]:
            for a, b in zip(outs[0], o):
                assert torch.equal(a, b)


@pytest.mark.parametrize("groups,bpg", [(16, 2048), (2, 16384), (1, 32768),
                                        (4096, 8), (3, 5), (1, 1)])
def test_stream_spans_tile_each_group(groups, bpg):
    """The CUDA kernel's span split: a group's spans tile its blocks in
    order with no gap or overlap, never cross a group, differ by at most
    one block, fit one span per CTA once the CTAs cover the groups, and
    are single blocks once the CTAs outnumber the blocks."""
    for ctas in sorted({1, 2, max(1, groups - 1), groups, groups + 1, 396,
                        528, groups * bpg, groups * bpg + 7}):
        spg = tk8.stream_spans(groups, bpg, ctas)
        assert 1 <= spg <= bpg
        spans = tk8.span_blocks(groups, bpg, spg)
        assert len(spans) == groups * spg
        if ctas >= groups:
            assert len(spans) <= ctas
        if ctas >= groups * bpg:
            assert spg == bpg
        for g in range(groups):
            mine = [(b0, b1) for gg, b0, b1 in spans if gg == g]
            assert mine[0][0] == 0 and mine[-1][1] == bpg
            assert all(a[1] == b[0] for a, b in zip(mine, mine[1:]))
            sizes = [b1 - b0 for b0, b1 in mine]
            assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
        assert [g for g, _, _ in spans] == sorted(g for g, _, _ in spans)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_stream_planner_widths_are_the_kernels(dtype):
    """Every w the planner can give the out-of-core sort (any n) is one the
    CUDA kernel runs, one warp per tree node: its range 8 to 128 is the
    planner's, end to end. (The kernel's shared memory at each of these
    plans is read from the compiled kernel, on the card.)"""
    ws = {tplanner.heuristic_plan("external_sort", tplanner.plan_key(
        "external_sort", n=1 << e, dtype=dtype, backend="cuda")).w
        for e in range(34)}
    assert ws == {8, 16, 32, 64, 128}
    assert (tk8.W_MIN, tk8.W_MAX) == (min(ws), max(ws))


# --------------------------------------------------------------------------
# the stream executors against JAX stream_xla
# --------------------------------------------------------------------------

@pytest.mark.parametrize("executor", ["stream_cuda", "stream_torch"])
def test_stream_pass_helper(executor):
    runs, run_len, fan = 8, 32, 8
    x, jout = _stream_pass_case()
    out, _ = tstream_pass(torch.from_numpy(x.ravel()), None, runs=runs,
                          run_len=run_len, fan_in=fan, executor=executor,
                          w=8, block_out=64, descending=True)
    same(jout, out[:runs * run_len])


@cached
def _stream_pass_case():
    x = np.sort(np.random.default_rng(8).integers(0, 4, (8, 32)).astype(
        np.int32), axis=1)[:, ::-1].copy()
    jout, _ = jstream_pass(jnp.asarray(x.ravel()), None, runs=8, run_len=32,
                           fan_in=8, executor="stream_xla", w=8,
                           block_out=64, descending=True, interpret=True)
    return x, np.asarray(jout)


def test_stream_torch_signed_zeros_match_stream_xla():
    runs, run_len, fan = 8, 32, 4
    x = _uniform_runs(runs, run_len)
    jout, _ = jstream_pass(jnp.asarray(x.ravel()), None, runs=runs,
                           run_len=run_len, fan_in=fan, executor="stream_xla",
                           w=8, block_out=64, descending=True,
                           interpret=True)
    out, _ = tstream_pass(torch.from_numpy(x.ravel()), None, runs=runs,
                          run_len=run_len, fan_in=fan,
                          executor="stream_torch", w=8, block_out=64,
                          descending=True)
    same(jout, out)


@pytest.mark.parametrize("variant", ["stream_cuda", "stream_torch"])
@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("kv", [False, True])
def test_stream_executors_ragged_merge_runs(variant, descending, kv):
    keys, off, ranks, jout = _ragged_case(descending, kv)
    obs.enable()
    out = tmerge_runs(torch.from_numpy(keys), torch.from_numpy(off),
                      ranks=None if ranks is None else torch.from_numpy(ranks),
                      schedule=TSched(variant, levels_per_pass=2, w=8,
                                      block_out=64),
                      runs_per_group=3, descending=descending)
    if kv:
        same(jout[0], out[0])
        same(jout[1], out[1])
    else:
        same(jout, out)
    passes = _events("schedule.pass")
    assert passes and all(p["level_kind"] == "hbm_run" for p in passes)
    # 3 runs per group complete to 4: one pass instead of two levels
    assert _events("schedule.reduce")[-1]["hbm_trips_saved"] == 1


@cached
def _ragged_case(descending, kv):
    # ragged and empty runs, 2 groups of 3, through the schedule
    rng = np.random.default_rng(86)
    lens = [13, 0, 40, 7, 25, 1]
    sgn = -1 if descending else 1
    ks = [sgn * np.sort(sgn * rng.integers(0, 4, n).astype(np.int32))
          for n in lens]
    keys = np.concatenate(ks).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    ranks = np.arange(keys.shape[0], dtype=np.int32) if kv else None
    jout = jmerge_runs(jnp.asarray(keys), jnp.asarray(off),
                       ranks=None if ranks is None else jnp.asarray(ranks),
                       schedule=JSched("stream_xla", levels_per_pass=2, w=8,
                                       block_out=64),
                       runs_per_group=3, descending=descending)
    jout = tuple(map(np.asarray, jout)) if kv else np.asarray(jout)
    return keys, off, ranks, jout


@pytest.mark.parametrize("kv", [False, True])
def test_merge_runs_stream_variant_through_the_engine(kv):
    # the public op with a stream variant pinned; int keys, so the numpy
    # stable sort is the oracle (JAX parity is held above)
    lens = [32, 0, 75, 32, 9]
    vals = RNG.integers(0, 6, sum(lens)).astype(np.int32)
    keys = np.concatenate([-np.sort(-vals[a:b]) for a, b in
                           zip(np.cumsum([0] + lens[:-1]), np.cumsum(lens))])
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    perm = np.argsort(-keys, kind="stable")
    for v in ("stream_cuda", "stream_torch"):
        if kv:
            mk, mv = TE.merge_runs(keys, off, variant=v, device="cpu",
                                   values=np.arange(keys.shape[0]))
            np.testing.assert_array_equal(mv.numpy(), perm)
            np.testing.assert_array_equal(mk.numpy(), keys[perm])
        else:
            out = TE.merge_runs(keys, off, variant=v, device="cpu")
            np.testing.assert_array_equal(out.numpy(), keys[perm])


# --------------------------------------------------------------------------
# helpers, traffic model, planner
# --------------------------------------------------------------------------

def test_slack_block_and_dofs_match_jax():
    for fan in (2, 4, 8, 16):
        for w in (8, 32, 128):
            for bo in (32, 1024, 4096):
                assert tk8.stream_slack(fan, w, bo) == \
                    jk8.stream_slack(fan, w, bo)
                for run_len in (w, 256, 1 << 20):
                    if run_len >= w:
                        assert tk8._block(bo, run_len, fan, w) == \
                            jk8._block(bo, run_len, fan, w)
    for t, f in ((0, 0), (3000, 5), (1, 1), (1 << 21, 16), (100, 3)):
        for w in (8, 128):
            jp = jext.resolve_dofs(JPlan("xla", w=w), 10 ** 6, tile_elems=t,
                                   fan_in=f, backend="cpu")
            tp = text.resolve_dofs(tplanner.Plan("torch", w=w), 10 ** 6,
                                   tile_elems=t, fan_in=f)
            assert (tp.tile_elems, tp.fan_in) == (jp.tile_elems, jp.fan_in)
    p = tplanner.Plan.from_dict(tp.to_dict())
    assert (p.tile_elems, p.fan_in) == (tp.tile_elems, tp.fan_in)


def test_traffic_model_matches_jax():
    for runs in (1, 2, 8, 9, 13, 16, 128, 1000):
        for fan in (2, 4, 8, 16):
            assert troof.external_passes(runs, fan) == \
                jroof.external_passes(runs, fan)
    assert troof.external_passes(128, 8) == 3
    for n, it, tile, fan in ((16 * 1024, 4, 1024, 4), (1 << 27, 4, 1 << 20, 8),
                             (1 << 27, 8, 1 << 20, 8), (10 ** 6, 4, 3000, 5)):
        assert troof.external_sort_bytes(n, it, tile, fan) == \
            jroof.external_sort_bytes(n, it, tile, fan)
    assert troof.external_sort_bytes(1 << 27, 4, 1 << 20, 8) == \
        2 * (1 << 27) * 4 * 4


def test_mem_bw_cuda_and_override(monkeypatch):
    monkeypatch.delenv("REPRO_MEM_BW_GBPS", raising=False)
    assert troof.mem_bw("cuda") == 3.35e12
    assert set(troof.MEM_BW_BY_BACKEND) == {"cuda"}
    with pytest.raises(ValueError):
        troof.mem_bw("cpu")
    monkeypatch.setenv("REPRO_MEM_BW_GBPS", "123.5")
    assert troof.mem_bw("cuda") == 123.5e9
    assert troof.mem_bw("cpu") == 123.5e9


def test_plans_from_jax_maps_stream_variants():
    table = {"plans": {
        "external_sort|tpu|float32|n1048576|s0": {
            "variant": "stream_pallas", "w": 32, "tile_elems": 4096,
            "fan_in": 16, "levels": 2},
        "external_sort|cpu|int32|n65536|s0": {
            "variant": "xla", "tile_elems": 1024, "fan_in": 4},
        "merge_runs|tpu|float32|n1024|s8": {"variant": "stream_xla"}}}
    out = tplanner.plans_from_jax(table)
    p = out["external_sort|cuda|float32|n1048576|s0"]
    assert p["variant"] == "stream_cuda"
    assert (p["tile_elems"], p["fan_in"], p["levels"]) == (4096, 16, 2)
    assert out["external_sort|cpu|int32|n65536|s0"]["variant"] == "torch"
    assert out["merge_runs|cuda|float32|n1024|s8"]["variant"] == \
        "stream_torch"


def test_heuristic_and_registry():
    h = tplanner.heuristic_plan
    key = lambda dt, be: tplanner.plan_key("external_sort", n=1 << 27,
                                           dtype=dt, backend=be)
    p = h("external_sort", key(torch.float32, "cuda"))
    assert (p.variant, p.levels, p.w, p.block_out) == ("stream_cuda", 2,
                                                       128, 4096)
    assert h("external_sort", key(torch.float64, "cuda")).variant == "torch"
    assert h("external_sort", key(torch.float32, "cpu")).variant == "torch"
    assert TE.registry.variants("external_sort") == ("stream_cuda", "torch")
    assert {"stream_cuda", "stream_torch"} <= set(
        TE.registry.variants("merge_runs"))


def test_cpu_tensor_never_launches_a_kernel():
    kernels.reset_launches()
    _ext(RNG.standard_normal(5000).astype(np.float32), variant="stream_cuda")
    assert kernels.launch_counts() == {}
