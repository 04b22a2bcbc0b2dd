"""Paper Table 2 in the port: comparator counts, pipeline depths and the
comparison mergers, against the JAX package on the CPU.

The formulas of ``repro_torch.core.butterfly`` equal ``repro.core``'s at
every w; one FLiMS cycle and one full 2w merger of the port are counted by
the comparisons they run (every ``aten.gt`` lane, seen through a
``TorchDispatchMode``: the selector's w and each CAS stage's w/2), and
``repro_torch.core.baselines`` (``basic_merge``, ``mms_merge``,
``wms_merge``) match the JAX mergers on the same numpy inputs, made from a
seeded generator with +0.0/-0.0, -inf and NaNs among them.

Tolerance: exact; float keys are compared as int32 bit patterns.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.core as J  # noqa: E402
from repro_torch.core import baselines as TBL  # noqa: E402
from repro_torch.core import butterfly as TB  # noqa: E402
from repro_torch.core.lanes import flims_cycle  # noqa: E402

RNG = np.random.default_rng(67)
POOL = np.array([np.nan, 0.0, -0.0, 1.5, -np.inf, 4.0, 4.0], np.float32)
COUNTS = ["comparators_flims", "comparators_flimsj", "comparators_basic",
          "comparators_pmt", "comparators_mms", "comparators_wms",
          "comparators_ehms"]


@pytest.mark.parametrize("w", [4, 8, 16, 32, 64, 128, 256, 512])
def test_table2_formulas_match_jax(w):
    for name in COUNTS:
        assert getattr(TB, name)(w) == getattr(J, name)(w), name
    lg = int(math.log2(w))
    assert TB.comparators_flims(w) == w + (w // 2) * lg
    for other in ("mms", "wms", "ehms", "basic"):
        assert TB.comparators_flims(w) < getattr(TB, f"comparators_{other}")(w)
    for d in ("basic", "pmt", "mms", "vms", "wms", "ehms", "flims", "flimsj"):
        assert TB.pipeline_depth(d, w) == J.pipeline_depth(d, w)


class _CountGt(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.lanes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket is torch.ops.aten.gt:
            self.lanes += out.numel()
        return out


@pytest.mark.parametrize("w", [4, 8, 16, 32])
def test_cycle_comparator_counts(w):
    """One FLiMS cycle runs w + (w/2) log2(w) comparisons; one fig. 4 full
    2w merger w + w log2(w), more than FLiMS's."""
    x = torch.zeros(w, dtype=torch.int32)
    with _CountGt() as c:
        flims_cycle(x, x)
    assert c.lanes == TB.comparators_flims(w)
    with _CountGt() as c:
        TB.bitonic_merge_full(torch.zeros(2 * w, dtype=torch.int32))
    assert c.lanes == TB.comparators_basic(w) > TB.comparators_flims(w)


def _desc(n):
    x = RNG.choice(POOL, n).astype(np.float32)
    return np.sort(x)[::-1].copy()


@pytest.mark.parametrize("name", ["basic_merge", "mms_merge", "wms_merge"])
@pytest.mark.parametrize("w", [4, 16])
@pytest.mark.parametrize("lens", [(0, 0), (0, 9), (50, 37), (64, 1)])
def test_baseline_mergers_match_jax(name, w, lens):
    a, b = _desc(lens[0]), _desc(lens[1])
    exp = np.asarray(getattr(J, name)(jnp.array(a), jnp.array(b), w))
    got = getattr(TBL, name)(torch.from_numpy(a), torch.from_numpy(b), w)
    assert exp.shape == tuple(got.shape)
    np.testing.assert_array_equal(exp.view(np.int32),
                                  got.numpy().view(np.int32))
    ints = [np.sort(RNG.integers(-9, 9, n).astype(np.int32))[::-1].copy()
            for n in lens]
    got = getattr(TBL, name)(*(torch.from_numpy(v) for v in ints), w)
    np.testing.assert_array_equal(got.numpy(),
                                  np.sort(np.concatenate(ints))[::-1])
