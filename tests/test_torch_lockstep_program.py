"""The lockstep step as one keyed program (``serving.lockstep.
LockstepSession``) against the reference's greedy loop through
``jax.jit(model.decode_step)`` (``examples/serve_decode.py::
serve_lockstep``), for every family the loop serves:

* hybrid: zamba2 reduced to 4 layers with two shared-attention groups,
  dense and masked at rate 0.5 (the reference's hybrid decode drops
  ``masks=``, so the masked session is held to JAX decoding the
  mask-zeroed params, as ``test_torch_hybrid_decode.py`` does);
* ssm: xlstm reduced to 4 layers (three mLSTM blocks and one sLSTM);
* encdec: whisper reduced with its 12 heads (the cross K/V written by
  ``prefill_cross`` before each request);
* vlm: qwen2-vl reduced, each step fed the one-hot embedding of its token,
  built inside the step.

Each session serves two requests of the same shapes, token for token the
JAX loop's, with one program key over prefill, decode and the second
request, and its cache and token buffer in the storages they started in.
The step's recorded operations (``lower_step``) change nothing, and under
emulated CUDA-graph capture (``test_torch_programs.fake_graphs``) the
replayed steps give the eager tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import HybridConfig
from repro.models.lm import LM as JaxLM
from repro_torch import interop
from repro_torch.analysis import op_lint
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.serving.lockstep import LockstepSession
from repro_torch.utils.tree import tree_leaves
from test_torch_programs import fake_graphs  # noqa: F401  (fixture)
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFGS = {
    "hybrid": jax_get_config("zamba2-1.2b").reduced(
        num_layers=4, hybrid=HybridConfig(attn_every=2)),
    "ssm": jax_get_config("xlstm-125m").reduced(num_layers=4),
    "encdec": jax_get_config("whisper-small").reduced(num_heads=12,
                                                      num_kv_heads=12),
    "vlm": jax_get_config("qwen2-vl-7b").reduced(),
}
B, P, N_NEW, CACHE_LEN = 2, 4, 5, 16

_JAX: dict = {}


def _jax(name):
    """The JAX model, its jitted decode step and params (numpy), and the
    port's model and params, once per family."""
    if name not in _JAX:
        cfg = CFGS[name]
        jm = JaxLM(cfg)
        jparams = jax.jit(jm.init)(jax.random.key(0))
        _JAX[name] = {
            "cfg": cfg, "jm": jm, "step": jax.jit(jm.decode_step),
            "jparams": jparams,
            "model": LM(ModelConfig.from_dict(cfg.to_dict()), device="cpu"),
            "params": interop.params_from_jax(
                jax.tree.map(np.asarray, jparams), "cpu")}
    return _JAX[name]


def _requests(name, seed):
    """Two prompts [B, P] (and, for encdec, two frame sets)."""
    cfg = CFGS[name]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
        frames = None
        if cfg.family == "encdec":
            frames = rng.standard_normal(
                (B, cfg.encoder.frames, cfg.d_model)).astype(np.float32)
        out.append((prompt, frames))
    return out


def _jax_greedy(name, jparams, prompt, frames):
    """The reference's lockstep loop: cross K/V once (encdec), the prompt a
    token a step, then greedy argmax; a vlm step takes the one-hot
    embedding of its token."""
    j = _jax(name)
    cfg, jm, step = j["cfg"], j["jm"], j["step"]
    cache = jm.init_cache(B, CACHE_LEN)
    extra = {}
    if frames is not None:
        extra = {"enc_embeds": jnp.asarray(frames)}
        cache = jm.prefill_cross(jparams, cache, extra)

    def batch(tok):
        if cfg.family == "vlm":
            return {"embeds": jax.nn.one_hot(tok[:, 0], cfg.d_model,
                                             dtype=jnp.float32)[:, None]}
        return {"tokens": tok, **extra}

    for t in range(P):
        logits, cache = step(jparams, cache, batch(jnp.asarray(
            prompt[:, t:t + 1])))
    tok, out = jnp.argmax(logits[:, -1], -1)[:, None], []
    for _ in range(N_NEW):
        logits, cache = step(jparams, cache, batch(tok.astype(jnp.int32)))
        tok = jnp.argmax(logits[:, -1], -1)[:, None]
        out.append(np.asarray(tok[:, 0]))
    return np.stack(out, 1)


def _masked(name):
    """(port masks at rate 0.5, the JAX params those masks zero)."""
    j = _jax(name)
    jm, jparams = j["jm"], j["jparams"]
    kept = jm.decide_kept(jparams, 0.5)
    zeroed = jax.tree.map(lambda p, m: p * m, jparams,
                          jm.param_masks(jparams, kept))
    masks = interop.masks_from_jax(
        jax.tree.map(np.asarray, jm.filter_masks(jparams, kept)), "cpu")
    return masks, zeroed


def _frames(frames):
    return None if frames is None else torch.from_numpy(frames)


CASES = [("hybrid", False), ("hybrid", True), ("ssm", False),
         ("encdec", False), ("vlm", False)]


@pytest.mark.parametrize("name,masked", CASES,
                         ids=[f"{n}{'-masked' if m else ''}"
                              for n, m in CASES])
def test_session_serves_two_requests_on_one_program(name, masked):
    j = _jax(name)
    masks, jparams = _masked(name) if masked else (None, j["jparams"])
    session = LockstepSession.new(j["model"], j["params"], B, CACHE_LEN,
                                  masks=masks)
    ptrs = [t.data_ptr() for t in tree_leaves(session.cache)]
    tok_ptr = session.tok.data_ptr()
    for r, (prompt, frames) in enumerate(_requests(name, seed=3)):
        got = session.decode(torch.from_numpy(prompt), N_NEW,
                             enc_embeds=_frames(frames))
        assert got.dtype == torch.int64 and got.shape == (B, N_NEW)
        np.testing.assert_array_equal(
            got.numpy(), _jax_greedy(name, jparams, prompt, frames),
            err_msg=f"request {r}")
        assert session.program_counts() == {"step": 1}
    assert session.steps == 2 * (P + N_NEW)
    assert [t.data_ptr() for t in tree_leaves(session.cache)] == ptrs
    assert session.tok.data_ptr() == tok_ptr


@pytest.mark.parametrize("name", ["hybrid", "encdec"])
def test_lower_step_records_one_step_and_changes_nothing(name):
    j = _jax(name)
    session = LockstepSession.new(j["model"], j["params"], B, CACHE_LEN)
    prompt, frames = _requests(name, seed=4)[0]
    session.decode(torch.from_numpy(prompt), 1, enc_embeds=_frames(frames))
    before = [t.clone() for t in tree_leaves(session.cache)]
    tok = session.tok.clone()
    lowered = session.lower_step()
    assert lowered.graph is None and lowered.ops
    assert op_lint.check_stream(name, lowered.ops) == []
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(session.cache), before))
    assert torch.equal(session.tok, tok) and session.steps == P + 1


@pytest.mark.parametrize("name", ["hybrid", "vlm"])
def test_replayed_steps_give_the_eager_tokens(fake_graphs, name):
    """The step captured at its second call and replayed from then on (the
    graph semantics emulated on the CPU) decodes the eager session's
    tokens: every step but the first is a replay, the second request's
    included."""
    j = _jax(name)
    eager = LockstepSession.new(j["model"], j["params"], B, CACHE_LEN)
    captured = LockstepSession.new(j["model"], j["params"], B, CACHE_LEN)
    fake_graphs(captured._program)
    for prompt, frames in _requests(name, seed=5):
        want = eager.decode(torch.from_numpy(prompt), N_NEW)
        got = captured.decode(torch.from_numpy(prompt), N_NEW)
        assert torch.equal(got, want)
    assert captured._program.captures == 1
    assert captured._program.replays == 2 * (P + N_NEW) - 1
    assert captured.program_counts() == {"step": 1}
