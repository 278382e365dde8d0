"""The port's OLS and matrix-powers apps against the JAX package's, and
``update`` against ``update_reeval``, at small sizes on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.apps as japps
import repro.data.updates as jdata
import repro_torch.apps as tapps
import repro_torch.data as tdata

TOL = 1e-5   # f32 parity, relative to the largest entry


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() or 1.0)


def _drive(japp, tapp, inputs, stream, count=5):
    japp.initialize(inputs)
    tapp.initialize(inputs)
    for _ in range(count):
        u, v = stream.next_update()
        ja = japp.update(jnp.asarray(u), jnp.asarray(v))
        jb = japp.update_reeval(jnp.asarray(u), jnp.asarray(v))
        ta = tapp.update(u, v)
        tb = tapp.update_reeval(u, v)
    assert _rel(ta.numpy(), ja) <= TOL
    assert _rel(tb.numpy(), jb) <= TOL
    assert _rel(ta.numpy(), tb.numpy()) <= TOL
    for k, v in tapp.engine.views.items():
        assert _rel(v.numpy(), japp.engine.views[k]) <= TOL, k


def test_ols_matches_jax():
    m, n, p = 64, 16, 2
    inputs, beta_true = tapps.OLS.synthesize(m, n, p, seed=1)
    jinputs, jbeta = japps.OLS.synthesize(m, n, p, seed=1)
    np.testing.assert_array_equal(beta_true, jbeta)
    for k in inputs:
        np.testing.assert_array_equal(inputs[k], np.asarray(jinputs[k]))
    tapp = tapps.OLS(m, n, p, device="cpu")
    _drive(japps.OLS(m, n, p), tapp, inputs,
           tdata.UpdateStream(n=m, m=n, scale=0.05, seed=2))
    # the estimate stays close to the generating coefficients
    assert np.abs(tapp.output().numpy() - beta_true).mean() < 0.5


@pytest.mark.parametrize("model,backend", [("linear", "xla"),
                                           ("exp", "xla"),
                                           ("exp", "pallas"),
                                           ("skip", "xla")])
def test_matrix_powers_matches_jax(model, backend):
    """``backend="pallas"`` runs the JAX side's applies through its Pallas
    kernel in interpret mode."""
    n = 32
    inputs = tapps.MatrixPowers.synthesize(n, seed=0)
    np.testing.assert_array_equal(
        inputs["A"], np.asarray(japps.MatrixPowers.synthesize(n, seed=0)["A"]))
    _drive(japps.MatrixPowers(n=n, k=8, model=model, s=2,
                              apply_backend=backend),
           tapps.MatrixPowers(n=n, k=8, model=model, s=2, device="cpu"),
           inputs, tdata.UpdateStream(n=n, m=n, seed=3))


def test_row_update_and_speedup_estimate_match_jax():
    japp, tapp = japps.OLS(256, 64), tapps.OLS(256, 64, device="cpu")
    assert tapp.speedup_estimate() == japp.speedup_estimate() > 1.0
    delta = np.linspace(-1, 1, 64)
    for a, b in zip(tapp.row_update(3, delta), japp.row_update(3, delta)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_update_streams_are_the_same_draws():
    ts = tdata.UpdateStream(n=40, m=12, rank=2, seed=5, zipf=1.5)
    js = jdata.UpdateStream(n=40, m=12, rank=2, seed=5, zipf=1.5)
    for _ in range(3):
        for a, b in zip(ts.next_update(), js.next_update()):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.batch(4), js.batch(4)):
        np.testing.assert_array_equal(a, b)


def test_registry_holds_this_slices_apps():
    assert tapps.available_apps() == ["matrix_powers", "ols"]
    assert tapps.get_app("ols") is tapps.OLS
    with pytest.raises(KeyError, match="pagerank"):
        tapps.get_app("pagerank")


def test_apps_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapps.OLS(16, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapps.MatrixPowers(n=8, k=4)
