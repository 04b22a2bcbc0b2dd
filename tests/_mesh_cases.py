"""Seeded inputs of the 4-rank parity cases, shared by the JAX subprocess
and the torch ranks of ``tests/test_torch_distributed.py`` (numpy only, so
both sides import it)."""
import numpy as np

P = 4
INT_MIN = np.iinfo(np.int32).min


def sort_cases():
    """name -> (keys, payload or None, sample_sort kwargs)."""
    out = {}
    rng = np.random.default_rng(0)
    out["int"] = (rng.integers(-10**6, 10**6, P * 512).astype(np.int32),
                  None, dict(w=16))
    rng = np.random.default_rng(1)
    kv = rng.integers(-50, 50, P * 256).astype(np.int32)
    kv[::97] = INT_MIN               # sentinel-valued keys among the real
    out["kv"] = (kv, np.arange(P * 256, dtype=np.int32), dict(w=16))
    rng = np.random.default_rng(7)
    f = rng.standard_normal(P * 512).astype(np.float32)
    out["f32"] = (f, np.arange(P * 512, dtype=np.int32) * 3, dict(w=32))
    rng = np.random.default_rng(3)
    z = np.minimum(rng.zipf(2.0, P * 512), 10**6).astype(np.int32)
    # at P = 4 the default cap_factor 4 makes the base cap n_local, which
    # nothing overflows: cap_factor 1 (base n_local / 4) does
    out["zipf_r0"] = (z, None, dict(w=16, cap_factor=1, retries=0))
    out["zipf"] = (z, None, dict(w=16, cap_factor=1))
    rng = np.random.default_rng(5)
    for n_local in (1, 2, 4):
        out[f"tiny{n_local}"] = (
            rng.integers(-9, 9, P * n_local).astype(np.int32), None,
            dict(w=8))
    return out


def engine_sort_cases():
    """name -> (keys, payload or None, plan fields for engine.sharded_sort
    (None: the heuristic plan))."""
    rng = np.random.default_rng(3)
    z = np.minimum(rng.zipf(2.0, P * 512), 10**6).astype(np.int32)
    n = P * 128
    gidx = np.arange(n, dtype=np.int32)
    rng = np.random.default_rng(11)
    return {
        "zipf_default": (z, None, None),
        "zipf_regular": (z, None, dict(variant="tree_vmapped",
                                       splitter="regular", w=16,
                                       cap_factor=1)),
        "equal": (np.full(n, 7, np.int32), gidx, None),
        "ties": (rng.choice([3, 7, 9], n).astype(np.int32), gidx, None),
    }


def topk_case():
    rng = np.random.default_rng(2)
    x = rng.integers(-40, 40, P * 256).astype(np.int32)     # heavy ties
    return x, np.arange(P * 256, dtype=np.int32) * 5, (1, 16, 100, 1000)


def route_case():
    """(logits (T, E), k, capacities)."""
    rng = np.random.default_rng(13)
    return (rng.standard_normal((64, 16)).astype(np.float32), 2,
            (5, 1, 128))


MOE_EXPERTS = 8


def moe_case(d: int, f: int):
    """(router, wi, wg, wo, x) float32 for E = MOE_EXPERTS."""
    rng = np.random.default_rng(17)
    E = MOE_EXPERTS
    g = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (g(d, E) * 0.5, g(E, d, f) * 0.1, g(E, d, f) * 0.1,
            g(E, f, d) * 0.1, g(2, 8, d))


def decode_case(d: int, H: int, K: int, hd: int):
    """Attention weights, (B, W, K, hd) caches, x (B, 1, d), pos (B,)."""
    rng = np.random.default_rng(19)
    g = lambda *s: rng.standard_normal(s).astype(np.float32)
    p = {"wq": g(d, H * hd) * 0.1, "wk": g(d, K * hd) * 0.1,
         "wv": g(d, K * hd) * 0.1, "wo": g(H * hd, d) * 0.1,
         "q_norm": np.ones(hd, np.float32), "k_norm": np.ones(hd, np.float32)}
    B, W = 2, 64
    return (p, g(B, W, K, hd), g(B, W, K, hd), g(B, 1, d),
            np.array([40, 50], np.int32))
