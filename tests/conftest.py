"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests must see the
real single CPU device; only launch/dryrun.py forces 512 placeholders."""

import numpy as np
import pytest

# The container has no `hypothesis`; install the vendored deterministic
# shim so the property suites (test_kernels, test_property_delta) run as
# seeded parametrization instead of skipping.  A real install wins.
try:
    import hypothesis  # noqa: F401
except ImportError:
    from repro._vendor import hypothesis_shim
    hypothesis_shim.install()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one "
        "(run on the GPU with `pytest -m cuda tests/test_torch_cuda.py`)")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def assert_close(a, b, rtol=2e-4, atol=2e-4, msg=""):
    import jax.numpy as jnp
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=msg)
