"""FedAP's spec-driven half (Algorithm 3, steps 3-4) against the JAX package.

Each function of the port's ``core/pruning.py`` spec half meets its
reference on the same inputs, with conv tensors carried across layouts
(HWIO <-> OIHW, NHWC <-> NCHW):

* ``get_path``/``set_path``, ``global_threshold`` (its index is the
  float32 product, including a p* where float32 and float64 floors
  differ), ``per_layer_rates``, ``feature_map_scores``/``ranks`` (ranks of
  built low-rank maps; dense activation energy within 1e-6),
  ``select_filters`` (many ties: the same numpy argsort keeps the same
  set), ``shrink_params``, ``filter_masks``, ``param_masks``,
  ``model_flops_fraction``, ``fedap_rates`` and ``fedap_prune``: equal;
* shrink against ``param_masks`` on SimpleCNN (normalisation-free): the
  masked model's logits and kept-coordinate gradients are the shrunk
  model's;
* ``fedap_decision`` on SimpleCNN from the same params and data: equal
  p*, layer rates and kept sets (p* within one float32 ulp where every
  participant's rate is equal, R3);
* ``normalized_server_gradient`` and its ``_scan`` form within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fedap as jax_fedap
from repro.core import pruning as jp
from repro.core import server_update as jax_su
from repro.data.pipeline import build_federated_data as jax_build
from repro.data.synthetic import SyntheticSpec as JaxSpec
from repro.models import cnn as jax_cnn
from repro_torch import interop
from repro_torch.core import engine, fedap, pruning, server_update
from repro_torch.data.pipeline import build_federated_data
from repro_torch.data.synthetic import SyntheticSpec
from repro_torch.models import cnn
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE = (8, 8, 3)
WORLD = dict(num_clients=20, server_fraction=0.08, device_pool=2000)
SPEC = dict(num_classes=10, image_shape=SHAPE, train_size=3000,
            test_size=400, noise_scale=0.5)


def _random_params(model, seed):
    shapes = jax.eval_shape(model.init, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        scale = np.sqrt(2.0 / fan_in) if len(s.shape) > 1 else 0.1
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree.map(leaf, shapes)


@pytest.fixture(scope="module")
def simple():
    """SimpleCNN in both packages from the same params, plus a batch."""
    jm = jax_cnn.SimpleCNN(image_shape=SHAPE)
    tm = cnn.SimpleCNN(image_shape=SHAPE, device="cpu")
    pn = _random_params(jm, 0)
    x = np.random.default_rng(1).standard_normal((12,) + SHAPE).astype(
        np.float32)
    return {"jm": jm, "tm": tm, "pn": pn,
            "pt": interop.cnn_params_from_jax(pn, "cpu"), "x": x,
            "js": jm.prune_spec(pn), "ts": tm.prune_spec(None)}


def _to_np(tree):
    return interop.cnn_params_to_numpy(tree)


def _assert_trees_equal(got_np, want):
    assert jax.tree.structure(got_np) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got_np), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _kept(simple, rate=0.5, seed=3):
    rng = np.random.default_rng(seed)
    out = {}
    for l in simple["js"].layers:
        d = jp.get_path(simple["pn"], l.weight).shape[l.filter_axis]
        out[l.name] = np.sort(rng.choice(d, d - int(rate * d),
                                         replace=False))
    return out


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------

def test_get_and_set_path():
    t = torch.zeros(2)
    tree = {"a": {"b": t, "c": [torch.ones(1), torch.ones(3)]}}
    assert pruning.get_path(tree, ("a", "b")) is t
    assert tuple(pruning.get_path(tree, ("a", "c", 1)).shape) == (3,)
    new = pruning.set_path(tree, ("a", "c", 0), torch.full((1,), 5.0))
    assert float(new["a"]["c"][0]) == 5.0 and float(tree["a"]["c"][0]) == 1
    assert isinstance(new["a"]["c"], list) and new["a"]["b"] is t
    for bad in (("a", "x"), ("a", "c", 7), ("a", "b", "z")):
        with pytest.raises(KeyError, match="no leaf"):
            pruning.get_path(tree, bad)
        with pytest.raises(KeyError, match="no leaf"):
            pruning.set_path(tree, bad, 0)


# ---------------------------------------------------------------------------
# step 3: threshold and per-layer rates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p_star", [0.0, 0.1, 0.3, 0.5, 0.77, 0.9, 1.0])
def test_global_threshold_and_layer_rates(simple, p_star):
    thr = pruning.global_threshold(simple["pt"], simple["ts"], p_star)
    want = jp.global_threshold(simple["pn"], simple["js"], p_star)
    assert float(thr) == float(want)
    got_r = pruning.per_layer_rates(simple["pt"], simple["ts"], thr)
    want_r = jp.per_layer_rates(simple["pn"], simple["js"], want)
    assert {k: float(v) for k, v in got_r.items()} == {
        k: float(v) for k, v in want_r.items()}


def test_global_threshold_index_is_the_float32_product():
    """A p* whose float32 product with R floors one above the float64
    one: the port takes the reference's (float32) index."""
    r = 100000
    vals = np.arange(r, dtype=np.float32)
    spec = pruning.PruneSpec(layers=(pruning.PrunableLayer("w", ("w",), 0),))
    jspec = jp.PruneSpec(layers=(jp.PrunableLayer("w", ("w",), 0),))
    cands = [p for p in np.linspace(0.001, 0.999, 2000).astype(np.float32)
             if int(np.float32(p) * np.float32(r)) != int(np.float64(p) * r)]
    assert cands, "no p* separates float32 and float64 indices"
    for p in map(float, cands[:3]):
        want = jp.global_threshold({"w": vals}, jspec, p)
        got = pruning.global_threshold({"w": torch.from_numpy(vals)}, spec,
                                       p)
        assert float(got) == float(want) == float(int(np.float32(p) * r))
        assert float(got) != float(int(np.float64(p) * r))


# ---------------------------------------------------------------------------
# step 4: HRank scores and selection
# ---------------------------------------------------------------------------

def _low_rank_maps(seed, b=5, h=6, w=7, d=9):
    """NHWC maps whose per-sample [H, W] ranks vary from 0 to min(H, W),
    with many ties across filters."""
    rng = np.random.default_rng(seed)
    out = np.zeros((b, h, w, d), np.float32)
    for i in range(b):
        for c in range(d):
            rank = int(rng.integers(0, min(h, w) + 1)) if c % 3 else 2
            u = rng.standard_normal((h, rank))
            v = rng.standard_normal((rank, w))
            out[i, :, :, c] = np.maximum(u @ v, 0) if c % 4 == 0 else u @ v
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_conv_scores_and_ranks_equal(seed):
    maps = _low_rank_maps(seed)
    got = pruning.feature_map_scores(torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(maps, -1, 1))))
    want = jp.feature_map_scores(jnp.asarray(maps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ranks = pruning.feature_map_ranks(torch.from_numpy(
        np.ascontiguousarray(np.moveaxis(maps, -1, 1))))
    np.testing.assert_array_equal(ranks.numpy(),
                                  np.asarray(jp.feature_map_ranks(
                                      jnp.asarray(maps))))


def test_dense_scores_and_ranks_close():
    a = np.random.default_rng(4).standard_normal((7, 30)).astype(np.float32)
    for fn_t, fn_j in ((pruning.feature_map_scores, jp.feature_map_scores),
                       (pruning.feature_map_ranks, jp.feature_map_ranks)):
        np.testing.assert_allclose(fn_t(torch.from_numpy(a)).numpy(),
                                   np.asarray(fn_j(jnp.asarray(a))),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("rate,align,min_keep", [
    (0.5, None, 1), (0.33, None, 1), (0.9, None, 4), (0.2, 8, 1),
    (0.7, 16, 1), (1.0, None, 1)])
def test_select_filters_keeps_the_reference_set_under_ties(rate, align,
                                                           min_keep):
    scores = np.random.default_rng(5).integers(0, 4, 40).astype(np.float32)
    want = jp.select_filters(jnp.asarray(scores), rate, align=align,
                             min_keep=min_keep)
    for given in (scores, torch.from_numpy(scores)):
        got = pruning.select_filters(given, rate, align=align,
                                     min_keep=min_keep)
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(scores)) < len(scores) // 4


# ---------------------------------------------------------------------------
# shrink and masks
# ---------------------------------------------------------------------------

def test_shrink_filter_and_param_masks_equal(simple):
    kept = _kept(simple)
    _assert_trees_equal(
        _to_np(pruning.shrink_params(simple["pt"], simple["ts"], kept)),
        jp.shrink_params(simple["pn"], simple["js"], kept))
    fm = pruning.filter_masks(simple["pt"], simple["ts"], kept)
    want = jp.filter_masks(simple["pn"], simple["js"], kept)
    assert set(fm) == set(want)
    for k in fm:
        np.testing.assert_array_equal(fm[k].numpy(), np.asarray(want[k]))
    _assert_trees_equal(
        _to_np(pruning.param_masks(simple["pt"], simple["ts"], kept)),
        jp.param_masks(simple["pn"], simple["js"], kept))
    small = pruning.shrink_params(simple["pt"], simple["ts"], kept)
    assert pruning.model_flops_fraction(simple["pt"], small) == \
        jp.model_flops_fraction(simple["pn"], jp.shrink_params(
            simple["pn"], simple["js"], kept))
    assert simple["pt"]["conv2"]["w"].shape[0] == 64   # input not modified


def test_resnet_shrink_and_param_masks_equal():
    jm = jax_cnn.ResNet18(width=8, num_classes=10, image_shape=SHAPE)
    tm = cnn.ResNet18(width=8, num_classes=10, image_shape=SHAPE,
                      device="cpu")
    pn = _random_params(jm, 2)
    pt = interop.cnn_params_from_jax(pn, "cpu")
    rng = np.random.default_rng(0)
    kept = {l.name: np.sort(rng.choice(
        jp.get_path(pn, l.weight).shape[-1], 5, replace=False))
        for l in jm.prune_spec(pn).layers}
    _assert_trees_equal(_to_np(pruning.shrink_params(pt, tm.prune_spec(pt),
                                                     kept)),
                        jp.shrink_params(pn, jm.prune_spec(pn), kept))
    _assert_trees_equal(_to_np(pruning.param_masks(pt, tm.prune_spec(pt),
                                                   kept)),
                        jp.param_masks(pn, jm.prune_spec(pn), kept))


def test_shrink_equals_param_masks_on_a_normalisation_free_model(simple):
    """SimpleCNN masked by param_masks computes the shrunk model's logits,
    and its gradients are the shrunk model's on the kept coordinates and 0
    elsewhere."""
    tm, spec, kept = simple["tm"], simple["ts"], _kept(simple, 0.4, 9)
    x = torch.from_numpy(simple["x"])
    y = torch.arange(x.shape[0]) % 10
    masks = pruning.param_masks(simple["pt"], spec, kept)
    masked = {k: {n: t * masks[k][n] for n, t in v.items()}
              for k, v in simple["pt"].items()}
    small = pruning.shrink_params(simple["pt"], spec, kept)
    with torch.no_grad():
        torch.testing.assert_close(tm.apply(masked, x), tm.apply(small, x),
                                   rtol=0, atol=1e-6)
    g_masked = engine.grad(lambda p: tm.loss_and_acc(p, x, y)[0], masked)
    g_small = engine.grad(lambda p: tm.loss_and_acc(p, x, y)[0], small)
    g_masked = {k: {n: t * masks[k][n] for n, t in v.items()}
                for k, v in g_masked.items()}
    for (a, b) in zip(jax.tree.leaves(pruning.shrink_params(g_masked, spec,
                                                            kept)),
                      jax.tree.leaves(g_small)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def test_fedap_rates_and_prune_equal(simple):
    rng = np.random.default_rng(6)
    spectra = [np.sort(np.abs(rng.standard_normal(16)).astype(np.float32)
                       * s) for s in (1.0, 3.0, 10.0)]
    lips = [np.float32(v) for v in (0.05, 0.2, 0.01)]
    sizes, niid = np.array([60., 40., 40.]), np.array([0.01, 0.3, 0.2])
    cfg_t = pruning.FedAPConfig(max_rate=0.8)
    cfg_j = jp.FedAPConfig(max_rate=0.8)
    p_t, r_t = pruning.fedap_rates(
        spectra=[torch.from_numpy(e) for e in spectra], lipschitzes=lips,
        sizes=sizes, niid=niid, params=simple["pt"], spec=simple["ts"],
        cfg=cfg_t)
    p_j, r_j = jp.fedap_rates(
        spectra=[jnp.asarray(e) for e in spectra], lipschitzes=lips,
        sizes=jnp.asarray(sizes), niid=jnp.asarray(niid),
        params=simple["pn"], spec=simple["js"], cfg=cfg_j)
    assert float(p_t) == pytest.approx(float(p_j), abs=1e-7)
    assert {k: float(v) for k, v in r_t.items()} == {
        k: float(v) for k, v in r_j.items()}
    with torch.no_grad():
        fm_t = simple["tm"].feature_maps(simple["pt"],
                                         torch.from_numpy(simple["x"]))
    fm_j = simple["jm"].feature_maps(simple["pn"], jnp.asarray(simple["x"]))
    small_t, kept_t = pruning.fedap_prune(simple["pt"], simple["ts"], r_t,
                                          fm_t, cfg_t)
    small_j, kept_j = jp.fedap_prune(simple["pn"], simple["js"], r_j, fm_j,
                                     cfg_j)
    assert set(kept_t) == set(kept_j)
    for k in kept_t:
        np.testing.assert_array_equal(kept_t[k], kept_j[k])
    _assert_trees_equal(_to_np(small_t), small_j)


@pytest.mark.parametrize("min_rate", [0.0, 0.3])
def test_fedap_decision_on_simplecnn_equals_jax(simple, min_rate):
    """Same params, data and participant seed (the JAX probe jitted, on the
    probe rows only).  With ``min_rate=0.3`` p* is clamped, and p*, layer
    rates and kept filters are equal.  With 0, every participant's eigen-gap
    rate here is 1/8: the port's float64 aggregate is 0.125 and the
    reference's float32 one lands an ulp below (ROADMAP R3), which moves its
    threshold index by one; given the port's p*, the JAX decision is the
    port's."""
    data_t = build_federated_data(spec=SyntheticSpec(**SPEC), **WORLD)
    data_j = jax_build(spec=JaxSpec(**SPEC), **WORLD)
    init_n = _random_params(simple["jm"], 11)
    cfg = dict(probe_size=8, participants=3, min_rate=min_rate)
    got = fedap.fedap_decision(
        simple["tm"], data_t, pruning.FedAPConfig(**cfg), simple["pt"],
        init_params=interop.cnn_params_from_jax(init_n, "cpu"),
        rng=np.random.default_rng(4))
    rate = jax_fedap.participant_rate
    probe = jax.jit(lambda p, p0, x, y: rate(simple["jm"], p, p0, x, y,
                                             jp.FedAPConfig(**cfg)))
    patch = pytest.MonkeyPatch()
    patch.setattr(jax_fedap, "participant_rate",
                  lambda m, p, p0, x, y, c: probe(p, p0, x[:c.probe_size],
                                                  y[:c.probe_size]))

    def jax_decision():
        return jax_fedap.fedap_decision(
            simple["jm"], data_j, jp.FedAPConfig(**cfg), simple["pn"],
            init_params=init_n, rng=np.random.default_rng(4))

    try:
        own = jax_decision()
        patch.setattr(jax_fedap, "aggregate_rates",
                      lambda *a, **k: jnp.float32(got.p_star))
        want = jax_decision()
    finally:
        patch.undo()
    assert abs(np.float32(got.p_star) - np.float32(own.p_star)) <= \
        np.spacing(np.float32(got.p_star))
    if min_rate:
        assert got.p_star == own.p_star == np.float32(min_rate)
        assert own.layer_rates == want.layer_rates
    assert got.p_star == want.p_star
    assert got.layer_rates == want.layer_rates
    assert set(got.kept) == set(want.kept)
    for k in got.kept:
        np.testing.assert_array_equal(got.kept[k], want.kept[k])
    assert got.summary()["kept_counts"] == want.summary()["kept_counts"]


# ---------------------------------------------------------------------------
# FedDU's normalized server gradient
# ---------------------------------------------------------------------------

def _lin_batches(tau, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((5, 4)).astype(np.float32),
             rng.standard_normal((5, 3)).astype(np.float32))
            for _ in range(tau)]


def _jax_grad(p, batch):
    return jax.grad(lambda q: jnp.mean(
        (batch[0] @ q["w"] + q["b"] - batch[1]) ** 2))(p)


def _torch_grad(p, batch):
    x, y = (torch.from_numpy(a) for a in batch)
    return engine.grad(lambda q: torch.mean((x @ q["w"] + q["b"] - y) ** 2),
                       p)


@pytest.mark.parametrize("tau", [0, 1, 4])
def test_normalized_server_gradient_equals_jax(tau):
    rng = np.random.default_rng(tau)
    pn = {"w": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(3).astype(np.float32)}
    pt = {k: torch.from_numpy(v) for k, v in pn.items()}
    batches = _lin_batches(tau, 8)
    want = jax_su.normalized_server_gradient(pn, batches, _jax_grad, 0.05)
    got = server_update.normalized_server_gradient(pt, batches, _torch_grad,
                                                   0.05)
    for k in pn:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=0)
    torch.testing.assert_close(pt["w"], torch.from_numpy(pn["w"]))
    if tau:
        stack = tuple(np.stack(a) for a in zip(*batches))
        want_s = jax_su.normalized_server_gradient_scan(
            pn, stack, _jax_grad, 0.05)
        got_s = server_update.normalized_server_gradient_scan(
            pt, stack, lambda p, b: _torch_grad(p, tuple(
                np.asarray(t) for t in b)), 0.05)
        for k in pn:
            np.testing.assert_allclose(got_s[k].numpy(),
                                       np.asarray(want_s[k]), atol=1e-6,
                                       rtol=0)
            torch.testing.assert_close(got_s[k], got[k], rtol=0, atol=0)
