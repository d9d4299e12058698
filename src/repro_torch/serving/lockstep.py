"""Lockstep greedy decoding: every sequence at the same depth.

Counterpart of the reference's ``examples/serve_decode.py::serve_lockstep``,
the way the reference serves the families whose decode state has no
per-slot cache index (the hybrid's Mamba2 state and ring-buffer attention
caches, the ssm family's mLSTM/sLSTM recurrent states, the encdec family's
self and cross caches; ``DecodeEngine`` refuses them), and the way its
script serves the vlm family.  It is the same loop for every family: only
``model.init_cache`` and ``model.decode_step`` differ, an encdec model's
cross K/V are written once by ``model.prefill_cross`` before the prompt,
and a vlm model's step input is the reference loop's one-hot embedding of
the token (``one_hot(token, d_model)``: a token id >= d_model embeds as
zeros, a quirk of that loop kept for parity).  The prompt is prefilled one
token a step through ``model.decode_step``, then tokens are decoded greedily
with argmax on the device.  Nothing inside the steps reads a tensor to the
host: the generated tokens are read once, at the end.

Where the reference jits the step (``decode = jax.jit(model.decode_step)``),
a :class:`LockstepSession` runs it as one ``core.programs.Program``: on the
card one CUDA graph for the session's params, cache and token buffer, run
eagerly at the first step, captured at the second and replayed for every
later step, prefill and decode alike, and for a second request of the same
shapes (the session resets its cache in place).  The step reads the token
buffer ``[B,1]`` int32, runs ``decode_step`` and writes the argmax back into
it; the prompt column is copied into the buffer before each prefill step
and the decoded tokens are copied out of it, on the device.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core import programs
from repro_torch.utils.tree import tree_leaves, tree_map


def lockstep_decode(model, params, prompt, n_new: int, *, masks=None,
                    cache_len=None, timings=None, enc_embeds=None):
    """Greedy decode of ``n_new`` tokens after ``prompt`` (int tensor [B,P],
    P >= 1) with ``model`` (an ``LM``) on its device.

    The cache holds ``cache_len`` rows (default P + n_new); a hybrid's shared
    attention cuts it to its window, past which it is a ring buffer (an ssm
    model's recurrent state has no rows).  As in
    the reference's loop, the argmax after the last prompt token is the first
    decode step's input, and the tokens returned are the argmax of each of
    the ``n_new`` decode steps.  ``masks`` (``{"mlp": [L, d_ff] 0/1}``) route
    every FFN through the block-skipping masked path.  ``timings`` (a dict),
    when given, receives ``prefill_s`` and ``decode_s`` on the host clock,
    the device synchronised after each loop, as the reference's loop times
    them.  ``enc_embeds`` [B, F, d] (an encdec model's encoder frames, which
    it requires) go through ``model.prefill_cross`` once, before the
    prompt.  The steps run through a :class:`LockstepSession` made for this
    call (a caller serving many requests keeps one session instead).

    Returns (tokens [B, n_new] int64 on the host, decode steps run: P +
    n_new)."""
    _check_request(model, prompt, n_new, enc_embeds)
    b, p = prompt.shape
    session = LockstepSession.new(model, params, b, cache_len or p + n_new,
                                  masks=masks)
    out = session.decode(prompt, n_new, timings=timings,
                         enc_embeds=enc_embeds)
    return out.cpu(), p + n_new


def _check_request(model, prompt, n_new, enc_embeds) -> None:
    if prompt.ndim != 2 or prompt.shape[1] < 1:
        raise ValueError(f"prompt must be [B, P] with P >= 1, got "
                         f"{tuple(prompt.shape)}")
    if n_new < 1:
        raise ValueError(f"n_new must be >= 1, got {n_new}")
    encdec = model.cfg.family == "encdec"
    if encdec != (enc_embeds is not None):
        raise ValueError(f"enc_embeds= is required for, and only for, the "
                         f"encdec family (this model is "
                         f"{model.cfg.family!r})")


def step_input(model, tok) -> dict:
    """One decode step's batch for the int32 tokens ``tok`` [B,1]: the
    tokens, or for a vlm model the reference loop's one-hot embedding of
    them [B,1,d_model] (f32; all zeros for an id >= d_model, as
    ``jax.nn.one_hot`` gives)."""
    if model.cfg.family == "vlm":
        cols = torch.arange(model.cfg.d_model, device=tok.device)
        return {"embeds": (tok[..., None] == cols).float()}
    return {"tokens": tok}


def run_steps(model, params, cache, prompt, n_new: int, *, masks=None,
              timings=None):
    """The loop's P + n_new decode steps from ``cache`` (updated in place;
    an encdec cache already holds its cross K/V), ``prompt`` int32 [B,P] on
    the model's device, through a :class:`LockstepSession` over that cache.
    Returns the generated tokens [B, n_new] on the device; nothing is read
    to the host, and the device is synchronised only when ``timings`` is
    given."""
    return LockstepSession(model, params, cache, masks=masks).run(
        prompt, n_new, timings=timings)


class LockstepSession:
    """One batch of lockstep decoding on ``model``: the cache (``model.
    init_cache``'s tree, owned and updated in place), an int32 token buffer
    ``[B,1]`` and the step program keyed on the params, the cache, the
    buffer and the masks.  Every step of every request of the session runs
    that one program (a replay on the card once captured): a second request
    of the same shapes captures nothing new.

    The program holds :meth:`_step_body` weakly, so a dropped session frees
    its graph and its memory pool at once."""

    def __init__(self, model, params, cache: dict, *, masks=None):
        self.model, self.params, self.masks = model, params, masks
        self.cache = cache
        self.tok = torch.zeros((_batch(model, cache), 1), dtype=torch.int32,
                               device=model.device)
        self._program = programs.Program(self._step_body, name="lockstep",
                                         device=model.device)
        self.steps = 0      # decode steps run (each one model.decode_step)

    @classmethod
    def new(cls, model, params, batch_size: int, cache_len: int, *,
            masks=None) -> "LockstepSession":
        """A session over a fresh ``model.init_cache(batch_size,
        cache_len)``."""
        with torch.inference_mode():
            cache = model.init_cache(batch_size, cache_len)
        return cls(model, params, cache, masks=masks)

    @torch.inference_mode()
    def _step_body(self, cache: dict, tok: torch.Tensor, params,
                   masks) -> None:
        """The step program: ``decode_step`` on the token buffer, its argmax
        written back into it, every cache tensor left in the storage it
        started in (the index, which the step replaces, is copied back)."""
        old = tree_leaves(cache)
        logits, new = self.model.decode_step(
            params, cache, step_input(self.model, tok), masks=masks)
        tok.copy_(logits[:, -1].argmax(-1, keepdim=True))
        programs.settle(new, old)

    def reset(self) -> None:
        """The cache back to ``model.init_cache``'s values, in place."""
        with torch.inference_mode():
            fresh = self.model.init_cache(self.tok.shape[0],
                                          _rows(self.cache))
            tree_map(lambda dst, src: dst.copy_(src), self.cache, fresh)

    def decode(self, prompt, n_new: int, *, timings=None, enc_embeds=None):
        """One request: the cache reset (when a request ran before),
        ``enc_embeds`` through ``model.prefill_cross`` (encdec), then
        :meth:`run`.  ``prompt`` int [B,P] on any device.  Returns the
        generated tokens [B, n_new] int64 on the device."""
        _check_request(self.model, prompt, n_new, enc_embeds)
        if self.steps:
            self.reset()
        if enc_embeds is not None:
            with torch.inference_mode():
                self.model.prefill_cross(self.params, self.cache, {
                    "enc_embeds": enc_embeds.to(self.model.device)})
        prompt = prompt.to(device=self.model.device, dtype=torch.int32)
        return self.run(prompt, n_new, timings=timings)

    def run(self, prompt, n_new: int, *, timings=None):
        """P + n_new steps from the cache as it stands, ``prompt`` int32
        [B,P] on the model's device: each prompt column copied into the
        token buffer before its step, then ``n_new`` steps on the buffer's
        own argmax, each copied out after its step.  Returns the tokens
        [B, n_new] int64 on the device; nothing is read to the host, and
        the device is synchronised only when ``timings`` is given."""
        dev = self.model.device

        def lap(key, t0):
            if timings is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                timings[key] = time.perf_counter() - t0
            return time.perf_counter()

        step = self._program.bind(self.cache, self.tok, self.params,
                                  self.masks)
        with torch.inference_mode():
            out = torch.empty((prompt.shape[0], n_new), dtype=torch.int64,
                              device=dev)
            t0 = time.perf_counter()
            for t in range(prompt.shape[1]):
                self.tok.copy_(prompt[:, t:t + 1])
                step()
            t0 = lap("prefill_s", t0)
            for i in range(n_new):
                step()
                out[:, i:i + 1].copy_(self.tok)
            lap("decode_s", t0)
        self.steps += prompt.shape[1] + n_new
        return out

    def program_counts(self) -> dict:
        """The session's programs: ``{"step": 1}`` however many steps and
        requests of its shapes it runs (captures on the card, keys on the
        CPU)."""
        return {"step": self._program._cache_size()}

    def lower_step(self):
        """The step program for the session's current tensors, without
        running it on them: ``ops`` is one step's operation record
        (``launch.cost.CostCounter(record=True)``, which ``analysis.op_lint``
        reads), taken over a copy of the cache and token buffer; on the card
        ``graph`` is the captured ``torch.cuda.CUDAGraph`` (made now if the
        session has not run two steps yet), None on the CPU.  A
        :class:`~repro_torch.serving.engine.LoweredWave` of one step."""
        from repro_torch.launch.cost import CostCounter
        from repro_torch.serving.engine import LoweredWave

        with torch.inference_mode():
            cache, tok = tree_map(torch.clone, (self.cache, self.tok))
        with CostCounter(record=True) as counter:
            self._step_body(cache, tok, self.params, self.masks)
        cap = self._program.lower(
            self.cache, self.tok, self.params, self.masks,
            scratch=(cache, tok, self.params, self.masks))
        return LoweredWave(ops=counter.ops, totals=counter.totals,
                           graph=None if cap is None else cap.graph)


def _batch(model, cache: dict) -> int:
    """B of a decode cache: dim 0 of an ssm model's per-layer states, else
    dim 1 of a stacked [L|G, B, ...] KV or Mamba2 state leaf."""
    if model.ssm:
        return int(tree_leaves(cache["l0"])[0].shape[0])
    return int(next(x for x in tree_leaves(cache) if x.ndim == 5).shape[1])


def _rows(cache: dict) -> int:
    """The ``cache_len`` that remakes ``cache``: its attention rows (dim 2
    of a [L|G, B, S, KV, hd] self-attention leaf; an encdec cache's cross
    K/V are sized by the frames), or 1 where there are none (ssm)."""
    kv = cache.get("self") or cache.get("shared_attn") or cache
    k = kv.get("k")
    return int(k.shape[2]) if k is not None else 1
