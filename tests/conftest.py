import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the CUDA kernels have no CPU "
        "mode); skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True, scope="session")
def _verify_monitors_stay_clean():
    """When the suite runs with REPRO_VERIFY=1 (the CI chaos job's smoke
    leg), every armed in-graph postcondition must have passed: a single
    verify failure anywhere in the session fails the run here."""
    yield
    from repro.guard import verify
    if verify.verify_enabled():
        import jax
        jax.effects_barrier()
        assert verify.failures() == 0, (
            f"{verify.failures()} guard.verify failure(s) out of "
            f"{verify.checked()} checks across the session")


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_executables():
    """Drop jit caches after each test module. The suite compiles ~1.5k XLA
    programs in one process; on single-core CPU runners the accumulated
    compiled executables eventually segfault the native compiler mid-run.
    Modules don't share jitted functions, so per-module release costs
    nothing but keeps the long single-process run bounded."""
    yield
    import jax
    jax.clear_caches()
