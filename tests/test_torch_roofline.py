"""``repro_torch.launch.roofline`` against ``repro.launch.roofline``: every
pure-Python model equal to the JAX one, exactly (integer arithmetic, and
the same float products in the same order): ``param_count_active`` and
``model_flops_estimate`` on all ten configs at train / prefill / decode,
and the traffic models over a grid of their arguments. The hardware
constants are the one intended difference: the H100's, not the TPU's.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch.steps import SHAPES  # noqa: E402


def test_every_function_of_the_jax_module_is_ported():
    names = {n for n, v in vars(JR).items()
             if callable(v) and not n.startswith("_")
             and getattr(v, "__module__", "") == JR.__name__}
    assert names <= set(vars(TR)), names - set(vars(TR))


def test_h100_constants():
    assert (TR.PEAK_FLOPS, TR.HBM_BW, TR.LINK_BW) == (989e12, 3.35e12,
                                                      450e9)
    assert TR.MEM_BW_BY_BACKEND["cuda"] == TR.HBM_BW
    assert TR.DEVICE_BYTES == 80e9


@pytest.mark.parametrize("arch", ARCHS)
def test_model_counts_match_jax(arch):
    assert sorted(ARCHS) == sorted(JARCHS)
    cfg, jcfg = get_config(arch), jget(arch)
    assert TR.param_count_active(cfg) == JR.param_count_active(jcfg)
    for name, s in SHAPES.items():
        args = (s["kind"], s["seq_len"], s["global_batch"])
        assert TR.model_flops_estimate(cfg, *args) == \
            JR.model_flops_estimate(jcfg, *args), name
    for kind in ("train", "prefill", "decode"):
        assert TR.model_flops_estimate(cfg, kind, 128, 3) == \
            JR.model_flops_estimate(jcfg, kind, 128, 3)
    red, jred = cfg.reduced(), jcfg.reduced()
    assert TR.param_count_active(red) == JR.param_count_active(jred)


def test_traffic_models_match_jax():
    for n_runs, lpp in itertools.product([0, 1, 2, 3, 7, 8, 129, 4096],
                                         [0, 1, 2, 3]):
        assert TR.merge_tree_passes(n_runs, lpp) == \
            JR.merge_tree_passes(n_runs, lpp)
    for n, size, chunk, lpp in itertools.product(
            [1, 1000, 1 << 20, (1 << 24) + 3], [1, 4, 8], [0, 1, 256, 4096],
            [1, 2, 3]):
        assert TR.sort_stream_bytes(n, size, chunk, lpp) == \
            JR.sort_stream_bytes(n, size, chunk, lpp)
    for n, size, tile, fan in itertools.product(
            [1, 1 << 20, 1 << 27], [4, 8], [1, 1 << 20], [1, 2, 8, 16]):
        assert TR.external_sort_bytes(n, size, tile, fan) == \
            JR.external_sort_bytes(n, size, tile, fan)
        assert TR.external_passes(n // max(tile, 1), fan) == \
            JR.external_passes(n // max(tile, 1), fan)
    for T, E, k, fused in itertools.product([1, 2048, 4096, 65536],
                                            [8, 64, 160], [1, 2, 6],
                                            [True, False]):
        assert TR.moe_route_bytes(T, E, k, fused) == \
            JR.moe_route_bytes(T, E, k, fused)
        for d, cap, size in ((2048, 241, 2), (6144, 1281, 4)):
            assert TR.moe_dispatch_bytes(T, E, k, d, cap, size, fused) == \
                JR.moe_dispatch_bytes(T, E, k, d, cap, size, fused)
    for n in (0, 1, 4096, 1 << 30):
        assert TR.stream_bytes(n, 4, 3) == JR.stream_bytes(n, 4, 3)
        assert TR.bound_us(n, "cuda") == n / TR.HBM_BW * 1e6


def test_analyse_terms():
    """``analyse`` on a counted cost: the three terms at the H100's rates,
    the largest the bottleneck, the model's FLOPs over the chips against
    the counted FLOPs."""
    from repro_torch.launch.op_cost import Cost
    cost = Cost(flops=2 * 989e12, bytes=3.35e12, coll={"psum": 450e9 // 2},
                args_bytes=10**9, output_bytes=10**9, temp_bytes=3 * 10**9)
    r = TR.analyse(cost, model_flops=4 * 989e12, n_chips=4)
    assert (r.t_compute, r.t_memory, r.t_collective) == (2.0, 1.0, 0.5)
    assert r.bottleneck == "compute" and r.useful_ratio == 0.5
    assert r.mem_per_device_gb == 5.0
    assert TR.collective_bytes(cost)["psum"] == 450e9 // 2
    assert set(TR.collective_bytes(cost)) == set(TR.COLLECTIVES)
