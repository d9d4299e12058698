"""The ``window=`` keyword of ``LM.loss`` and ``LM.init_cache`` against the
JAX package.

``LM.loss(window=)`` passes the window to ``apply`` (the dense family's
attention sees only the last ``window`` keys), and ``LM.init_cache(window=)``
allocates ``min(cache_len, window)`` rows for the dense family, a ring
buffer that decode wraps around (``index mod S``), as the reference's
``src/repro/models/lm.py`` does.  Held against JAX on the tiny dense config
of ``tests/test_serving.py``: the windowed loss within 1e-5, equal cache
shapes, and a lockstep decode run past the ring's length against the
reference's XLA decode (f32, another summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models.lm import LM as JaxLM
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = dict(atol=1e-5, rtol=1e-5)

TINY = JaxModelConfig(name="dense-tiny", family="dense", rope="1d",
                      norm="rmsnorm", act="silu", param_dtype="float32",
                      remat="none", num_layers=2, d_model=128, num_heads=4,
                      num_kv_heads=2, d_ff=512, vocab_size=2048)


@pytest.fixture(scope="module")
def world():
    jparams = JaxLM(TINY).init(jax.random.key(0))
    model = LM(ModelConfig.from_dict(TINY.to_dict()), device="cpu")
    params = interop.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jparams, model, params


def _batch(seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, TINY.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, TINY.vocab_size, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("window", ["auto", None, 4, 16])
def test_loss_with_window_matches_jax(world, window):
    jparams, model, params = world
    batch = _batch(3)
    want = JaxLM(TINY).loss(jparams, jax.tree.map(jnp.asarray, batch),
                            window=window)
    got = model.loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                     window=window)
    np.testing.assert_allclose(float(got), float(want), **TOL)


def test_window_changes_the_loss(world):
    """A window shorter than the sequence changes what attention sees."""
    _, model, params = world
    batch = {k: torch.from_numpy(v) for k, v in _batch(4).items()}
    assert abs(float(model.loss(params, batch, window=4))
               - float(model.loss(params, batch))) > 1e-4


@pytest.mark.parametrize("cache_len,window", [(16, None), (16, 6), (4, 6),
                                              (8, 8)])
def test_init_cache_shapes_match_jax(world, cache_len, window):
    _, model, _ = world
    want = JaxLM(TINY).init_cache(3, cache_len, window=window)
    got = model.init_cache(3, cache_len, window=window)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
    rows = cache_len if window is None else min(cache_len, window)
    assert got["k"].shape[2] == rows


def test_lockstep_decode_past_the_ring_matches_jax_xla(world):
    """A 6-row ring (cache_len 16, window 6) decoded for 10 steps from index
    0: the writes wrap at step 6, after which every row is attended."""
    jparams, model, params = world
    jm = JaxLM(TINY, attn_impl="xla")
    b, cache_len, window, steps = 3, 16, 6, 10
    jc = jm.init_cache(b, cache_len, window=window)
    pc = model.init_cache(b, cache_len, window=window)
    rng = np.random.default_rng(5)
    for _ in range(steps):
        tok = rng.integers(0, TINY.vocab_size, (b, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jparams, jc, {"tokens": jnp.asarray(tok)})
        pl, pc = model.decode_step(params, pc, {"tokens": torch.from_numpy(tok)})
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    assert int(pc["index"]) == int(jc["index"]) == steps > window
    np.testing.assert_allclose(pc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    np.testing.assert_allclose(pc["v"].numpy(), np.asarray(jc["v"]), **TOL)


def test_hybrid_init_cache_still_raises():
    """The hybrid's ``init_cache(window=)``: its shared attention keeps
    ``min(cache_len, window, sliding_window)`` rows, and every leaf has the
    reference's shape and dtype."""
    from repro.configs import get_config as jax_get_config

    jcfg = jax_get_config("zamba2-1.2b").reduced()
    model = LM(ModelConfig.from_dict(jcfg.to_dict()), device="cpu")
    for cache_len, window, rows in ((16, 8, 8), (100, None, 64),
                                    (100, 80, 64)):
        got = model.init_cache(1, cache_len, window=window)
        want = JaxLM(jcfg).init_cache(1, cache_len, window=window)
        assert got["shared_attn"]["k"].shape[2] == rows
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
