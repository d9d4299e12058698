"""K5 and the serving path of one checkout, to compare checkouts on one card.

    python3 tools/serving_ab.py --tree DIR --label NAME

Imports ``repro_torch`` from ``DIR/src`` (this checkout's with ``--tree .``,
or another one's), builds that checkout's kernels, and prints one JSON line
``{"label": NAME, ...}`` with:

* ``k5``: ``decode_attention`` in bf16 at B = 8, S = 512, KV = 16, hd = 128
  (the serving cache) for lengths drawn from 1..16, 1..64, 1..128 (what a
  serving wave reaches: prompts of 1-64 tokens plus up to 64 new) and 1..512:
  the median CUDA-event ms of one call with L2 flushed before it (``cold``)
  and with the inputs left in L2 (``warm``; each call queued behind a spin
  of the card, so that the host's launch is not timed), and the host's
  microseconds per call when calls are issued back to back (``host_us``,
  2000 calls, no sync between);
* ``serving``: olmo-1b at full width, bf16, dense, with ``chip_smoke.py``'s
  serving configuration and every slot admitted, three times: the host-clock
  ms per step of one wave, the device kernel ms per step of the next wave
  under ``torch.profiler``, the part of that spent in K5's kernels, and
  each kernel's ms and launches per step (``by_kernel``).

To compare two checkouts, run it in turns (A, B, B, A) in one session on
one card and compare each one's two runs with the other's.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def k5_numbers(torch, cs, k5, timer) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    b, s, kvh, hd = 8, 512, 16, 128
    out = {}
    for hi in (16, 64, 128, 512):
        lens = torch.randint(1, hi + 1, (b,), generator=gen, device="cuda",
                             dtype=torch.int32)
        q, k, v = cs._k5_case(torch, gen, b, s, kvh, 1, hd, torch.bfloat16,
                              lens)

        def call():
            return k5.decode_attention(q, k, v, lens)

        cold = timer(call)
        # warm: the inputs stay in L2, and each call is queued behind a
        # ~0.5 ms spin of the card, so that the events time the card and
        # not the host's launch
        pairs = []
        for _ in range(timer.reps):
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        warm = statistics.median(a.elapsed_time(e) for a, e in pairs)
        for _ in range(50):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            call()
        host_us = 1e6 * (time.perf_counter() - t0) / 2000
        torch.cuda.synchronize()
        out[f"1..{hi}"] = {"cold_ms": cold, "warm_ms": warm,
                           "host_us": host_us}
    return out


def serving_numbers(torch, cs) -> list:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.serving import ServeConfig, load_servable

    cfg = get_config("olmo-1b")
    model = LM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    scfg = ServeConfig(slots=8, cache_len=512, max_prompt=64,
                       max_new_tokens=64, steps_per_wave=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(1, 65)))
               .astype(np.int32) for _ in range(16)]
    sv = load_servable({"params": params, "kept": None, "mode": "mask",
                        "model_config": cfg}, "dense", device="cuda")
    cs._full_engine(torch, sv, scfg, prompts)              # warm-up
    n = scfg.steps_per_wave
    runs = []
    for _ in range(3):
        eng = cs._full_engine(torch, sv, scfg, prompts)
        t0 = time.perf_counter()
        eng._wave()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / n
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            eng._wave()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"
                   and e.self_device_time_total > 0]
        dev = sum(e.self_device_time_total for e in kernels) / 1e3 / n
        k5_dev = sum(e.self_device_time_total for e in kernels
                     if "decode_" in e.key) / 1e3 / n
        by_kernel = {e.key: [e.self_device_time_total / 1e3 / n,
                             e.count / n] for e in kernels}
        runs.append({"host_ms_per_step": wall, "kernel_ms_per_step": dev,
                     "k5_ms_per_step": k5_dev, "by_kernel": by_kernel})
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="checkout whose src/repro_torch is measured")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("serving_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs          # puts this checkout's src on the path

    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as k5

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    _build.build_all()
    timer = cs.Timer(torch)
    k5_out = k5_numbers(torch, cs, k5, timer)
    del timer
    print(json.dumps({"label": args.label, "card": card,
                      "repro_torch": os.path.dirname(k5.__file__),
                      "k5": k5_out,
                      "serving": serving_numbers(torch, cs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
