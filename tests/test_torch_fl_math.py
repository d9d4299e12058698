"""The port's federated math and data against the JAX package.

* ``core/niid``, ``core/server_update`` (FedDU, Formulas 4-7) and
  ``core/momentum`` (FedDUM, Formulas 8/12) on the same numpy inputs:
  tolerance 1e-6 (f32 elementwise arithmetic; logs may differ in the last
  bit between the two libraries).
* The FedAP rate math of ``core/pruning``: equal eigen-gap rates, Formula
  15 within 1e-6, and the Fisher spectrum of per-sample gradients within
  1e-5 relative (another summation order).
* ``build_lm_federated_data`` array-equal to the JAX function for two seeds
  (both are numpy end to end), and ``device_arrays`` within 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import momentum as jmom
from repro.core import niid as jniid
from repro.core import pruning as jpruning
from repro.core import server_update as jsu
from repro.data.pipeline import build_lm_federated_data as jax_build
from repro.data.synthetic import TokenSpec as JaxTokenSpec
from repro_torch.core import momentum, niid, pruning, server_update
from repro_torch.data.pipeline import build_lm_federated_data
from repro_torch.data.synthetic import TokenSpec
from repro_torch.utils.tree import tree_leaves, tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-6, rtol=1e-6)


def _dist(rng, *shape):
    d = rng.random(shape).astype(np.float32)
    d[..., 0] = 0.0                         # a zero entry: 0 log 0 = 0
    return d / d.sum(-1, keepdims=True)


class TestNiid:
    def test_divergences_and_distributions(self):
        rng = np.random.default_rng(0)
        p, q = _dist(rng, 5, 8), _dist(rng, 8)
        for name in ("kl_divergence", "js_divergence", "non_iid_degree"):
            np.testing.assert_allclose(
                getattr(niid, name)(p, q).numpy(),
                np.asarray(getattr(jniid, name)(p, q)), **TOL)
        sizes = rng.integers(5, 50, 5).astype(np.float32)
        np.testing.assert_allclose(
            niid.global_distribution(p, sizes).numpy(),
            np.asarray(jniid.global_distribution(p, sizes)), **TOL)
        sel = np.asarray([3, 0, 4])
        np.testing.assert_allclose(
            niid.round_distribution(p, sizes, sel).numpy(),
            np.asarray(jniid.round_distribution(p, sizes, sel)), **TOL)
        labels = rng.integers(0, 6, 40).astype(np.int32)
        np.testing.assert_allclose(
            niid.label_distribution(labels, 7).numpy(),
            np.asarray(jniid.label_distribution(labels, 7)), **TOL)


def _tree(rng, dtype=np.float32):
    return {"a": rng.standard_normal((3, 4)).astype(dtype),
            "b": {"c": rng.standard_normal((5,)).astype(dtype)}}


def _port(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_tree_close(got, want, **tol):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **(tol or TOL))


class TestFedDU:
    @pytest.mark.parametrize("kind", ["1-acc", "inv"])
    def test_f_prime(self, kind):
        acc = np.float32(0.37)
        np.testing.assert_allclose(
            server_update.f_prime(acc, kind).numpy(),
            np.asarray(jsu.f_prime(acc, kind)), **TOL)

    @pytest.mark.parametrize("cfg", [
        dict(), dict(C=0.5, decay=0.9, f_prime_kind="inv"),
        dict(static_tau_eff=2.5)])
    def test_tau_eff(self, cfg):
        args = dict(acc=np.float32(0.3), round_idx=np.float32(7.0),
                    n0=np.float32(50.0), n_prime=np.float32(120.0),
                    d_round=np.float32(0.4), d_server=np.float32(0.02),
                    tau=5)
        got = server_update.tau_eff(server_update.FedDUConfig(**cfg), **args)
        want = jsu.tau_eff(jsu.FedDUConfig(**cfg), **args)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_feddu_apply_functional_and_in_place(self):
        rng = np.random.default_rng(1)
        w, g = _tree(rng), _tree(rng)
        t_eff, eta = np.float32(1.7), np.float32(0.05)
        want = jsu.feddu_apply(w, g, t_eff, eta)
        _assert_tree_close(server_update.feddu_apply(
            _port(w), _port(g), t_eff, torch.tensor(eta)), want)
        out = _port(w)
        server_update.feddu_apply(out, _port(g), t_eff, torch.tensor(eta),
                                  out=out)
        _assert_tree_close(out, want)


class TestFedDUM:
    def test_pseudo_gradient_and_momentum_step(self):
        rng = np.random.default_rng(2)
        w_prev, proposed, m = _tree(rng), _tree(rng), _tree(rng)
        cfg_j = jmom.FedDUMConfig(beta_server=0.8, eta_server=0.7)
        cfg_t = momentum.FedDUMConfig(beta_server=0.8, eta_server=0.7)
        g_j = jmom.server_pseudo_gradient(w_prev, proposed)
        _assert_tree_close(momentum.server_pseudo_gradient(
            _port(w_prev), _port(proposed)), g_j)
        w_j, m_j = jmom.server_momentum_step(w_prev, m, g_j, cfg_j)
        w_t, m_t = momentum.server_momentum_step(
            _port(w_prev), _port(m), _port(jax.tree.map(np.asarray, g_j)),
            cfg_t)
        _assert_tree_close(w_t, w_j)
        _assert_tree_close(m_t, m_j)
        # in place over the inputs, as the round engine calls it
        wp, mp, gp = _port(w_prev), _port(m), _port(proposed)
        momentum.server_pseudo_gradient(wp, gp, out=gp)
        momentum.server_momentum_step(wp, mp, gp, cfg_t, out=(wp, mp))
        _assert_tree_close(wp, w_j)
        _assert_tree_close(mp, m_j)


class TestFedAPRates:
    @pytest.mark.parametrize("eigs,lip", [
        ([0.0, 0.1, 5.0, 5.2], 0.5), ([0.0, 0.01, 0.02, 0.03], 0.5),
        ([0.0, 3.0, 3.1, 9.0], 0.1)])
    def test_expected_rate_from_spectrum(self, eigs, lip):
        e = np.asarray(eigs, np.float32)
        got = pruning.expected_rate_from_spectrum(torch.from_numpy(e), lip)
        want = jpruning.expected_rate_from_spectrum(jnp.asarray(e), lip)
        assert float(got) == float(want)

    def test_aggregate_rates(self):
        rates = np.asarray([0.25, 0.5, 0.75], np.float32)
        sizes = np.asarray([30.0, 12.0, 12.0], np.float32)
        degrees = np.asarray([0.01, 0.4, 0.6], np.float32)
        np.testing.assert_allclose(
            float(pruning.aggregate_rates(rates, sizes, degrees)),
            float(jpruning.aggregate_rates(rates, sizes, degrees)), **TOL)
        # equal rates aggregate to exactly that rate (the kept-count
        # boundary of FedAP's lane-aligned decision)
        assert float(pruning.aggregate_rates(
            np.full(3, 0.75, np.float32), sizes, degrees)) == 0.75

    def test_fisher_spectrum_and_lipschitz(self):
        """Per-sample gradients of a small softmax regression: the port's
        leaf-by-leaf Gram against the reference's concatenated one."""
        rng = np.random.default_rng(4)
        params = {"w": rng.standard_normal((6, 4)).astype(np.float32),
                  "b": rng.standard_normal((4,)).astype(np.float32)}
        init = {k: v * 0.5 for k, v in params.items()}
        x = rng.standard_normal((5, 6)).astype(np.float32)
        y = rng.integers(0, 4, 5)

        def jloss(p, xb, yb):
            logp = jax.nn.log_softmax(xb @ p["w"] + p["b"])
            return -jnp.mean(jnp.take_along_axis(logp, yb[:, None], 1))

        def tloss(p, xb, yb):
            logp = torch.log_softmax(xb @ p["w"] + p["b"], -1)
            return -logp.gather(1, yb[:, None]).mean()

        from repro_torch.core import engine

        jps = lambda p, b: jax.vmap(lambda xi, yi: jax.grad(jloss)(
            p, xi[None], yi[None]))(*b)
        tps = lambda p, b: [engine.grad(tloss, p, xi[None], yi[None])
                            for xi, yi in zip(*b)]
        want = jpruning.fisher_spectrum(jps, params, (x, y))
        xt, yt = torch.from_numpy(x), torch.from_numpy(y)
        got = pruning.fisher_spectrum(tps, _port(params), (xt, yt))
        scale = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5 * scale, rtol=0)
        lip_j = jpruning.lipschitz_estimate(
            lambda p, b: jax.grad(jloss)(p, *b), params, init, (x, y))
        lip_t = pruning.lipschitz_estimate(
            lambda p, b: engine.grad(tloss, p, *b), _port(params),
            _port(init), (xt, yt))
        np.testing.assert_allclose(float(lip_t), float(lip_j), rtol=1e-5)


class TestLMData:
    @pytest.mark.parametrize("seed", [0, 3])
    def test_build_lm_federated_data_equals_jax(self, seed):
        spec = dict(vocab_size=2048, num_topics=16, seq_len=17,
                    num_sequences=256, seed=seed)
        kw = dict(num_clients=8, server_fraction=0.1, seed=seed)
        got = build_lm_federated_data(spec=TokenSpec(**spec), **kw)
        want = jax_build(spec=JaxTokenSpec(**spec), **kw)
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        dev_t, dev_j = got.device_arrays("cpu"), want.device_arrays()
        assert set(dev_t) == set(dev_j)
        for k in dev_j:
            np.testing.assert_allclose(dev_t[k].numpy(), np.asarray(dev_j[k]),
                                       err_msg=k, **TOL)
