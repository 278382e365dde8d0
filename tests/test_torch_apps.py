"""The port's six paper apps against the JAX package's, and ``update``
against ``update_reeval``, at small sizes on the CPU."""

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
    assert tapps.available_apps() == [
        "fivm_learning", "general_iterative", "gradient_descent",
        "matrix_powers", "ols", "pagerank", "sums_powers"]
    assert tapps.get_app("ols") is tapps.OLS
    assert tapps.get_app("pagerank") is tapps.PageRank
    assert tapps.get_app("fivm_learning") is tapps.FivmLearning
    with pytest.raises(KeyError, match="pagerank"):
        tapps.get_app("nope")


def _same_inputs(tin, jin):
    assert set(tin) == set(jin)
    for k in tin:
        assert isinstance(tin[k], np.ndarray) and tin[k].dtype == np.float32
        np.testing.assert_array_equal(tin[k], np.asarray(jin[k]))


@pytest.mark.parametrize("model", ["linear", "exp", "skip"])
def test_sums_of_powers_matches_jax(model):
    n = 32
    inputs = tapps.SumsOfPowers.synthesize(n, seed=1)
    _same_inputs(inputs, japps.SumsOfPowers.synthesize(n, seed=1))
    _drive(japps.SumsOfPowers(n=n, k=8, model=model, s=2),
           tapps.SumsOfPowers(n=n, k=8, model=model, s=2, device="cpu"),
           inputs, tdata.UpdateStream(n=n, m=n, seed=4))


@pytest.mark.parametrize("model,with_b", [("exp", True), ("exp", False),
                                          ("linear", True),
                                          ("skip", True)])
def test_general_iterative_matches_jax(model, with_b):
    n, p = 32, 3
    inputs = tapps.GeneralIterative.synthesize(n, p, with_b=with_b, seed=2)
    _same_inputs(inputs, japps.GeneralIterative.synthesize(
        n, p, with_b=with_b, seed=2))
    _drive(japps.GeneralIterative(n, p, k=8, model=model, s=2,
                                  with_b=with_b),
           tapps.GeneralIterative(n, p, k=8, model=model, s=2,
                                  with_b=with_b, device="cpu"),
           inputs, tdata.UpdateStream(n=n, m=n, seed=5))


@pytest.mark.parametrize("model", ["linear", "exp"])
def test_gradient_descent_matches_jax(model):
    m, n, p = 48, 16, 2
    inputs = tapps.BatchGradientDescent.synthesize(m, n, p, seed=3)
    _same_inputs(inputs, japps.BatchGradientDescent.synthesize(
        m, n, p, seed=3))
    japp = japps.BatchGradientDescent(m, n, p, k=8, model=model)
    tapp = tapps.BatchGradientDescent(m, n, p, k=8, model=model,
                                      device="cpu")
    _drive(japp, tapp, inputs, tdata.UpdateStream(n=m, m=n, seed=6))
    delta = np.linspace(-1, 1, n)
    for a, b in zip(tapp.row_update(5, delta), japp.row_update(5, delta)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("model", ["linear", "exp"])
def test_pagerank_edge_updates_match_jax(model):
    n = 32
    inputs = tapps.PageRank.synthesize(n, seed=4)
    _same_inputs(inputs, japps.PageRank.synthesize(n, seed=4))
    japp = japps.PageRank(n, k=8, model=model)
    tapp = tapps.PageRank(n, k=8, model=model, device="cpu")
    japp.initialize(inputs)
    tapp.initialize(inputs)
    rng = np.random.default_rng(7)
    for page in (3, 17, 3):
        col = rng.random(n).astype(np.float32)
        col /= col.sum()
        tu, tv = tapp.edge_update(page, col)
        ju, jv = japp.edge_update(page, col)
        assert_close_np(tu, ju)
        np.testing.assert_array_equal(tv, np.asarray(jv))
        ta = tapp.update(tu, tv)
        tb = tapp.update_reeval(tu, tv)
        ja = japp.update(ju, jv)
    assert _rel(ta.numpy(), ja) <= TOL
    assert _rel(ta.numpy(), tb.numpy()) <= TOL
    np.testing.assert_allclose(tapp.engine.views["M"][:, 3].numpy(), col,
                               rtol=1e-5, atol=1e-6)
    for k, v in tapp.engine.views.items():
        assert _rel(v.numpy(), japp.engine.views[k]) <= TOL, k


def assert_close_np(a, b):
    np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


def test_apps_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapps.OLS(16, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapps.MatrixPowers(n=8, k=4)
