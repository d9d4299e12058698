"""Serving demo on the PyTorch port: continuous batching or lockstep decode.

The port's counterpart of ``examples/serve_decode.py``.  For the dense
and moe families this drives ``repro_torch.serving.DecodeEngine``: a fixed pool of
decode slots, requests admitted as slots free up, prompts prefilled one
token a step through the same step, finished sequences retired by the
on-device done-mask.  ``--prune-rate`` serves a FedAP-style pruned model
of the dense family either ``masked`` (the block-skipping ``masked_matmul``
kernel at dense shapes) or ``shrunk`` (compacted d_ff).

  PYTHONPATH=src python examples/serve_decode_torch.py --arch olmo-1b \\
      --requests 8 --slots 4 --tokens 16 --prune-rate 0.5 --serve-mode shrunk
  PYTHONPATH=src python examples/serve_decode_torch.py --arch arctic-480b

The hybrid, ssm, vlm and encdec families decode with the lockstep loop
(a ``repro_torch.serving.LockstepSession``): every sequence at the same
depth, each step one program (a CUDA graph replay on the card once
captured).
A vlm step's input is the one-hot embedding of its token, as in the
reference's loop; whisper's encoder frames are random, drawn from
``--seed``, and its cross K/V are computed once before the prompt.
``--prune-rate`` applies to the engine's dense family only.

  PYTHONPATH=src python examples/serve_decode_torch.py --arch xlstm-125m
  PYTHONPATH=src python examples/serve_decode_torch.py --arch zamba2-1.2b \\
      --tokens 32 --device cpu
  PYTHONPATH=src python examples/serve_decode_torch.py --arch whisper-small

Every config is the arch's ``reduced()`` one, with random weights from
``--seed``.  ``--device`` defaults to ``cuda``.
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.core import pruning_lm
from repro_torch.models.lm import LM
from repro_torch.serving import DecodeEngine, LockstepSession, ServeConfig
from repro_torch.utils.tree import tree_map


def serve_continuous(cfg, args):
    """Engine path: continuous batching, optional pruned serving."""
    rng = np.random.default_rng(args.seed)
    model = LM(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(args.seed))
    masks = None
    tag = "dense"
    if args.prune_rate > 0 and cfg.family != "dense":
        raise SystemExit("--prune-rate prunes the scanned FFN stack; use a "
                         "dense-family --arch")
    if args.prune_rate > 0:
        kept = pruning_lm.ffn_kept_indices(params, cfg, args.prune_rate,
                                           align=128)
        if args.serve_mode == "masked":
            masks = model.filter_masks(params, {"mlp": kept})
            # zero the pruned coordinates as mask-mode training would have
            params = tree_map(lambda p, m: p * m.to(p.dtype), params,
                              model.param_masks(params, {"mlp": kept}))
            tag = f"masked@{args.prune_rate}"
        else:
            params = pruning_lm.shrink_ffn_at(params, kept)
            cfg = dataclasses.replace(cfg, d_ff=int(kept.shape[-1]))
            model = LM(cfg, device=args.device)
            tag = f"shrunk@{args.prune_rate} (d_ff={cfg.d_ff})"

    scfg = ServeConfig(slots=args.slots,
                       cache_len=args.prompt + args.tokens,
                       max_prompt=args.prompt, max_new_tokens=args.tokens,
                       steps_per_wave=args.steps_per_wave)
    engine = DecodeEngine(model, params, scfg, masks=masks,
                          device=model.device)
    prompts = [rng.integers(0, cfg.vocab_size,
                            size=rng.integers(1, args.prompt + 1))
               .astype(np.int32) for _ in range(args.requests)]

    # a warm-up request builds the kernels outside the timed region
    engine.submit(prompts[0])
    while engine.pending:
        engine.step_wave()

    t0 = time.perf_counter()
    completions = engine.run(prompts)
    # the engine reads its done-mask to the host every wave, so the clock
    # reads after the final wave's device work completed
    elapsed = time.perf_counter() - t0

    generated = sum(len(c.tokens) for c in completions)
    print(f"arch={cfg.name} (reduced, {tag}) slots={args.slots} "
          f"requests={args.requests}")
    print(f"{generated} tokens in {elapsed:.2f}s "
          f"({generated / elapsed:.1f} tok/s continuous batching)")
    print("sample:", completions[0].tokens[:16].tolist())


def serve_lockstep(cfg, args):
    """Lockstep path for families without per-slot cache indices: every
    sequence at the same depth, one decode step a token."""
    if args.prune_rate > 0:
        raise SystemExit("--prune-rate prunes the scanned FFN stack; use a "
                         "dense-family --arch")
    model = LM(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    enc = None
    if cfg.family == "encdec":
        enc = torch.from_numpy(rng.standard_normal(
            (args.slots, cfg.encoder.frames, cfg.d_model)).astype(np.float32))
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.slots, args.prompt)).astype(np.int32))
    timings = {}
    session = LockstepSession.new(model, params, args.slots,
                                  args.prompt + args.tokens)
    gen = session.decode(prompt, args.tokens, timings=timings,
                         enc_embeds=enc).cpu()
    prefill_s, decode_s = timings["prefill_s"], timings["decode_s"]
    print(f"arch={cfg.name} (reduced) batch={args.slots}")
    print(f"prefill {args.prompt} tok: {prefill_s:.2f}s; "
          f"decode {args.tokens} tok: {decode_s:.2f}s "
          f"({args.slots * args.tokens / decode_s:.1f} tok/s)")
    print("sample:", gen[0][:16].tolist())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b", choices=list(ARCH_NAMES))
    ap.add_argument("--requests", type=int, default=8,
                    help="queued requests (engine path)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode-slot pool (engine) / batch (lockstep)")
    ap.add_argument("--prompt", type=int, default=16,
                    help="max prompt length")
    ap.add_argument("--tokens", type=int, default=32,
                    help="max new tokens per request")
    ap.add_argument("--steps-per-wave", type=int, default=8)
    ap.add_argument("--prune-rate", type=float, default=0.0,
                    help="FedAP-style FFN prune rate (engine path)")
    ap.add_argument("--serve-mode", default="shrunk",
                    choices=("masked", "shrunk"),
                    help="how to serve the pruned model")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    if cfg.family in ("dense", "moe"):
        serve_continuous(cfg, args)
    else:
        serve_lockstep(cfg, args)


if __name__ == "__main__":
    main()
