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
"""
from __future__ import annotations

import time

import torch


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
    prompt.

    Returns (tokens [B, n_new] int64 on the host, decode steps run: P +
    n_new)."""
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
    b, p = prompt.shape
    cache = model.init_cache(b, cache_len or p + n_new)
    prompt = prompt.to(device=model.device, dtype=torch.int32)
    with torch.inference_mode():
        if encdec:
            model.prefill_cross(params, cache, {
                "enc_embeds": enc_embeds.to(model.device)})
        out = run_steps(model, params, cache, prompt, n_new, masks=masks,
                        timings=timings)
    return out.cpu(), p + n_new


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
    the model's device.  Returns the generated tokens [B, n_new] on the
    device; nothing is read to the host, and the device is synchronised
    only when ``timings`` is given."""
    def lap(key, t0):
        if timings is not None:
            if model.device.type == "cuda":
                torch.cuda.synchronize(model.device)
            timings[key] = time.perf_counter() - t0
        return time.perf_counter()

    out = torch.empty((prompt.shape[0], n_new), dtype=torch.int64,
                      device=model.device)
    t0 = time.perf_counter()
    for t in range(prompt.shape[1]):
        logits, cache = model.decode_step(
            params, cache, step_input(model, prompt[:, t:t + 1]), masks=masks)
    t0 = lap("prefill_s", t0)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    for i in range(n_new):
        logits, cache = model.decode_step(
            params, cache, step_input(model, tok.to(torch.int32)),
            masks=masks)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out[:, i:i + 1].copy_(tok)
    lap("decode_s", t0)
    return out
