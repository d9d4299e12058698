"""The port's paper CNNs against the JAX package's, within 1e-5.

SimpleCNN, LeNet5, VGG11 and ResNet18-GN take the same params, drawn with
numpy in the JAX layouts and carried across by
``interop.cnn_params_from_jax`` (HWIO -> OIHW), and the same NHWC images
from a numpy seed.  Checked at 1e-5 (absolute, float32): logits,
every feature map (the port's are NCHW), loss, accuracy and every gradient,
dense and with FedAP's filter masks (SimpleCNN's convs; LeNet5's convs and
its unaligned fc1/fc2, whose bias goes in before the mask; ResNet18's
conv1s through GroupNorm).  Image sizes 8, 9 and 10 cover the SAME edges:
odd pools pad their end with -inf, ResNet's stride-2 3x3 convs pad (0, 1)
on an even input and (1, 1) on an odd one.  ``flops_per_example`` must be
equal, and a shrunk ResNet18 (gn1 at a width that is no multiple of 8, so
GroupNorm takes fewer groups) must match too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jax_pruning
from repro.models import cnn as jax_cnn
from repro_torch import interop
from repro_torch.core import engine
from repro_torch.models import cnn
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
BATCH = 6

CASES = {
    "simplecnn-9": ("SimpleCNN", {}, (9, 9, 3)),
    "lenet5-10": ("LeNet5", {}, (10, 10, 3)),
    "lenet5-9": ("LeNet5", {}, (9, 9, 1)),
    "vgg11-9": ("VGG11", {"width_mult": 0.125}, (9, 9, 3)),
    "resnet18-8": ("ResNet18", {"width": 8, "num_classes": 10}, (8, 8, 3)),
    "resnet18-9": ("ResNet18", {"width": 8, "num_classes": 10}, (9, 9, 3)),
}


def random_params(model, seed):
    """Params of ``model``'s shapes (JAX layouts) drawn with numpy: He-scaled
    weights, and biases and GroupNorm scales away from their 0/1 init so
    they count.  (The JAX init runs op by op: ~17 s for ResNet18 here.)"""
    shapes = jax.eval_shape(model.init, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        scale = np.sqrt(2.0 / fan_in) if len(s.shape) > 1 else 0.3
        return (rng.standard_normal(s.shape) * scale).astype(np.float32)

    return jax.tree.map(leaf, shapes)


class Pair:
    """One model in both packages, from the same params, with the JAX
    forward, loss and gradient jitted as one function."""

    def __init__(self, case):
        name, kw, shape = CASES[case]
        self.shape = shape
        self.jm = getattr(jax_cnn, name)(image_shape=shape, **kw)
        self.tm = getattr(cnn, name)(image_shape=shape, device="cpu", **kw)
        self.pn = random_params(self.jm, len(case))
        self.pj = jax.tree.map(jnp.asarray, self.pn)
        self.pt = interop.cnn_params_from_jax(self.pn, "cpu")
        rng = np.random.default_rng(7)
        self.x = rng.standard_normal((BATCH,) + shape).astype(np.float32)
        ncls = self.pn["out"]["w"].shape[-1]
        self.y = rng.integers(0, ncls, BATCH).astype(np.int32)

        def loss(p, x, y, m):
            logits, maps = self.jm.apply(p, x, collect=True, masks=m)
            l, acc = jax_cnn.softmax_xent_acc(logits, y)
            return l, (acc, logits, maps)

        self._jax = jax.jit(jax.value_and_grad(loss, has_aux=True))
        self._cache = {}

    def jax_run(self, masks=None):
        """(loss, acc, logits, maps, grads) of the JAX model."""
        key = None if masks is None else tuple(
            (k, v.tobytes()) for k, v in sorted(masks.items()))
        if key not in self._cache:
            m = None if masks is None else {k: jnp.asarray(v)
                                            for k, v in masks.items()}
            (l, (acc, logits, maps)), g = self._jax(
                self.pj, jnp.asarray(self.x), jnp.asarray(self.y), m)
            self._cache[key] = (l, acc, logits, maps, g)
        return self._cache[key]

    def port_grad(self, masks=None):
        x, y = torch.from_numpy(self.x), torch.from_numpy(self.y)
        (loss, acc), g = engine.value_and_grad_aux(
            lambda p: self.tm.loss_and_acc(p, x, y, masks=masks), self.pt)
        return float(loss), float(acc), interop.cnn_params_to_numpy(g)


_PAIRS: dict = {}


@pytest.fixture(scope="module")
def pairs():
    yield lambda case: _PAIRS.setdefault(case, Pair(case))
    _PAIRS.clear()


def _nchw(a):
    a = np.asarray(a)
    return np.moveaxis(a, -1, 1) if a.ndim == 4 else a


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=0,
                               err_msg=what)


def _masks_np(pair, rate, seed):
    """A random kept set per prunable layer and its [d] 0/1 masks."""
    spec = pair.jm.prune_spec(pair.pn)
    rng = np.random.default_rng(seed)
    kept = {}
    for l in spec.layers:
        d = jax_pruning.get_path(pair.pn, l.weight).shape[l.filter_axis]
        kept[l.name] = np.sort(rng.choice(d, d - int(rate * d),
                                          replace=False))
    return kept, {k: np.array(v) for k, v in jax_pruning.filter_masks(
        pair.pn, spec, kept).items()}


@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_feature_maps(pairs, case):
    p = pairs(case)
    _, _, want_logits, want_maps, _ = p.jax_run()
    with torch.no_grad():
        logits, maps = p.tm.apply(p.pt, torch.from_numpy(p.x), collect=True)
    _close(logits.numpy(), want_logits, "logits")
    assert set(maps) == set(want_maps)
    for k in maps:
        assert tuple(maps[k].shape) == _nchw(want_maps[k]).shape, k
        _close(maps[k].numpy(), _nchw(want_maps[k]), k)
    with torch.no_grad():
        fm = p.tm.feature_maps(p.pt, torch.from_numpy(p.x))
    assert all(torch.equal(fm[k], maps[k]) for k in maps)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_accuracy_and_gradients(pairs, case):
    p = pairs(case)
    l_j, a_j, _, _, g_j = p.jax_run()
    loss, acc, g = p.port_grad()
    _close(loss, l_j, "loss")
    _close(acc, a_j, "accuracy")
    flat_j = jax.tree_util.tree_flatten_with_path(g_j)[0]
    flat_t = jax.tree.leaves(g)
    assert len(flat_j) == len(flat_t)
    for (path, want), got in zip(flat_j, flat_t):
        assert got.shape == want.shape, path
        _close(got, want, jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", ["simplecnn-9", "lenet5-10", "lenet5-9",
                                  "resnet18-8"])
def test_masked_forward_and_gradients(pairs, case):
    """Filter masks through the forward and backward: conv maps zeroed
    after the ReLU; LeNet5's fc1 (120) and fc2 (84) are unaligned, so
    masked_dense masks the plain product after adding the bias."""
    p = pairs(case)
    kept, masks = _masks_np(p, 0.5, seed=len(case))
    mt = {k: torch.from_numpy(v) for k, v in masks.items()}
    l_j, _, want_logits, want_maps, g_j = p.jax_run(masks)
    with torch.no_grad():
        logits, maps = p.tm.apply(p.pt, torch.from_numpy(p.x), collect=True,
                                  masks=mt)
    _close(logits.numpy(), want_logits, "masked logits")
    for k, m in masks.items():
        _close(maps[k].numpy(), _nchw(want_maps[k]), k)
        dropped = np.flatnonzero(m == 0)
        axis = 1 if maps[k].ndim == 4 else -1
        assert not maps[k].index_select(
            axis, torch.from_numpy(dropped)).any(), k
    loss, _, g = p.port_grad(mt)
    _close(loss, l_j, "masked loss")
    for got, want in zip(jax.tree.leaves(g), jax.tree.leaves(g_j)):
        _close(got, want, "masked gradient")


@pytest.mark.parametrize("case", list(CASES))
def test_flops_per_example_equal(pairs, case):
    p = pairs(case)
    assert p.tm.flops_per_example(p.pt) == p.jm.flops_per_example(p.pj)
    assert p.tm.flops_per_example(p.pt, (16, 16, 3)) == \
        p.jm.flops_per_example(p.pj, (16, 16, 3))


def test_simplecnn_at_the_paper_size_has_its_parameter_count():
    model = cnn.SimpleCNN(image_shape=(16, 16, 3), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert sum(t.numel() for t in jax.tree.leaves(params)) == 122570
    assert all(float(params[k]["b"].abs().sum()) == 0 for k in params)
    assert tuple(params["conv1"]["w"].shape) == (32, 3, 3, 3)
    assert tuple(params["fc1"]["w"].shape) == (16, 64, 64)


@pytest.mark.parametrize("case", ["resnet18-8", "lenet5-9"])
def test_interop_round_trip(pairs, case):
    p = pairs(case)
    back = interop.cnn_params_to_numpy(p.pt)
    assert jax.tree.structure(back) == jax.tree.structure(p.pn)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p.pn)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    conv = p.pt["conv1"]["w"] if "conv1" in p.pt else p.pt["stem"]["w"]
    src = p.pn["conv1"]["w"] if "conv1" in p.pn else p.pn["stem"]["w"]
    assert tuple(conv.shape) == (src.shape[3], src.shape[2], *src.shape[:2])


@pytest.mark.parametrize("size,k,stride,want", [
    (8, 3, 2, (0, 1)), (9, 3, 2, (1, 1)), (8, 1, 2, (0, 0)), (9, 1, 2, (0, 0)),
    (10, 5, 1, (2, 2)), (5, 2, 2, (0, 1)), (4, 2, 2, (0, 0)), (1, 2, 2, (0, 1)),
])
def test_same_padding(size, k, stride, want):
    assert cnn.same_padding(size, k, stride) == want


def test_max_pool_pads_odd_edges_with_minus_infinity():
    x = -torch.ones((1, 1, 5, 5)) - torch.arange(25.).reshape(1, 1, 5, 5)
    want = jax_cnn.max_pool(jnp.asarray(np.moveaxis(x.numpy(), 1, -1)))
    got = cnn.max_pool(x)
    assert tuple(got.shape) == (1, 1, 3, 3)
    np.testing.assert_array_equal(got.numpy(), _nchw(want))


@pytest.mark.parametrize("channels", [8, 12, 20, 5])
def test_group_norm_population_variance_and_gcd_groups(channels):
    rng = np.random.default_rng(channels)
    x = rng.standard_normal((3, 5, 4, channels)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(channels).astype(np.float32)
    bias = rng.standard_normal(channels).astype(np.float32)
    want = jax_cnn.group_norm(jnp.asarray(x), scale, bias)
    got = cnn.group_norm(torch.from_numpy(np.moveaxis(x, -1, 1)),
                         torch.from_numpy(scale), torch.from_numpy(bias))
    _close(got.numpy(), _nchw(want), "group norm")


def test_shrunk_resnet_matches(pairs):
    """ResNet18 shrunk by the JAX package (gn1 kept at 5 of 8 channels,
    one group) and carried across: the port's forward and gradients on the
    smaller tree match."""
    p = pairs("resnet18-8")
    spec = p.jm.prune_spec(p.pn)
    kept = {l.name: np.arange(5) for l in spec.layers}
    small = jax.tree.map(np.asarray, jax_pruning.shrink_params(
        p.pj, spec, kept))
    st = interop.cnn_params_from_jax(small, "cpu")
    assert tuple(st["s0b0"]["gn1"]["scale"].shape) == (5,)
    (_, (_, want, _)), g_j = p._jax(small, jnp.asarray(p.x),
                                    jnp.asarray(p.y), None)
    with torch.no_grad():
        got = p.tm.apply(st, torch.from_numpy(p.x))
    _close(got.numpy(), want, "shrunk logits")
    g_t = engine.grad(lambda q: p.tm.loss_and_acc(
        q, torch.from_numpy(p.x), torch.from_numpy(p.y))[0], st)
    for got, want in zip(jax.tree.leaves(interop.cnn_params_to_numpy(g_t)),
                         jax.tree.leaves(g_j)):
        _close(got, want, "shrunk gradient")


@pytest.mark.parametrize("case", ["simplecnn-9", "lenet5-10", "vgg11-9",
                                  "resnet18-8"])
def test_prune_spec_is_the_reference_spec_in_port_axes(pairs, case):
    """Same layers, paths and coupling; a conv's filter axis 3 (HWIO) is 0
    (OIHW) and a next conv's input axis 2 is 1; other axes are kept."""
    p = pairs(case)
    want = p.jm.prune_spec(p.pn)
    got = p.tm.prune_spec(p.pt)

    def port_axis(path, axis, tree):
        ndim = np.ndim(jax_pruning.get_path(tree, path))
        return {3: 0, 2: 1}[axis] if ndim == 4 else axis

    assert len(got.layers) == len(want.layers)
    for g, w in zip(got.layers, want.layers):
        assert (g.name, g.weight) == (w.name, w.weight)
        assert g.filter_axis == port_axis(w.weight, w.filter_axis, p.pn)
        assert [(c.path, c.axis) for c in g.coupled] == [
            (c.path, port_axis(c.path, c.axis, p.pn)) for c in w.coupled]
