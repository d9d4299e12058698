"""K6 (``ssd_scan``) of one checkout on the card, to compare checkouts on one card.

    python3 tools/ssd_ab.py --tree DIR --label NAME [--scoring]

Imports ``repro_torch`` from ``DIR/src`` (this checkout's with ``--tree .``,
or another one's), builds that checkout's kernels, and prints one JSON line
``{"label": NAME, ...}`` with, for K6 at zamba2-1.2b's shape (B = 1,
S = 8192, nh = 64, p = 64, N = 64) in bf16 and f32 and at a ragged shape
(B = 2, S = 1000) in bf16:

* ``ms``: the median CUDA-event time of one call with L2 flushed before each
  (``chip_smoke.Timer``), and ``bound_ms`` (``chip_smoke._k6_bound``: the
  larger of the bytes' time and the sequential recurrence's flops at the
  type's peak);
* ``passes_ms``: device time per launch of each of the call's kernels under
  ``torch.profiler`` (10 calls, L2 flushed before each), by kernel name;
* ``err``: the largest error against the plain version
  (``ref.ssd_scan_ref``) relative to max(1, max |plain|), and ``bitwise``:
  whether two launches agree bit for bit;
* ``peak_mib``: the device memory one call allocates beyond its inputs
  (output and workspace).

With ``--scoring`` (``scoring``): zamba2-1.2b at full width and depth (38
Mamba2 layers), bf16, seeded random weights, through
``load_servable(attn_impl="pallas")``: the host-clock seconds of five
full-sequence forwards (``loss_and_acc`` under ``no_grad``, B = 1 x
S = 8192) after a warm-up, their median, tokens/s, peak memory and K6's
launches per forward.

To compare two checkouts, run it for each in turns (A, B, B, A) on one
card, one right after another, and compare each one's two runs with the
other's.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

NH, P, N, CHUNK = 64, 64, 64, 256      # zamba2's SSD shape, the reference's chunk


def passes_ms(torch, call, flush) -> dict:
    """Device ms per launch of each kernel that ``call`` runs, by name."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            flush.zero_()
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        name = re.search(r"ssd_\w*kernel", ev.key)
        if name:
            out[name.group(0)] = ev.device_time_total / ev.count / 1e3
    return out


def kernel_numbers(torch, cs, k6, ref, timer) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = {}
    for label, b, s, dtype in (("zamba2_bf16", 1, 8192, torch.bfloat16),
                               ("zamba2_f32", 1, 8192, torch.float32),
                               ("ragged_bf16", 2, 1000, torch.bfloat16)):
        args = (randn(b, s, NH, P, dtype=dtype), randn(b, s, N, dtype=dtype),
                randn(b, s, N, dtype=dtype), randn(b, s, NH, dtype=dtype),
                0.1 * randn(NH), randn(NH), randn(NH))

        def call():
            return k6.ssd_scan(*args, chunk=CHUNK)

        got = call()
        again = call()
        want = ref.ssd_scan_ref(*args)
        _, err = cs.max_rel_err(torch, got, want)
        bitwise = bool(torch.equal(got, again))
        del got, again, want
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        out[label] = {"ms": timer(call),
                      "passes_ms": passes_ms(torch, call, timer.flush),
                      "err": err, "bitwise": bitwise, "peak_mib": peak}
        bound, by, _ = cs._k6_bound(b, s, NH, P, N, args[0].element_size(),
                                    str(dtype).split(".")[-1])
        out[label] |= {"bound_ms": bound, "bound_by": by}
    return out


def scoring_numbers(torch) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as k6
    from repro_torch.models.lm import LM
    from repro_torch.serving import load_servable

    cfg = get_config("zamba2-1.2b")
    model = LM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    del model
    seq = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 8193)).astype(np.int64)).cuda()
    x, y = seq[:, :-1], seq[:, 1:]
    sv = load_servable({"params": params, "kept": None, "mode": "mask",
                        "model_config": cfg}, "dense", attn_impl="pallas",
                       device="cuda")
    walls = []
    with torch.no_grad():
        sv.model.loss_and_acc(sv.params, x, y, masks=sv.masks)     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k6.launches = 0
        for _ in range(5):
            t0 = time.perf_counter()
            loss, _ = sv.model.loss_and_acc(sv.params, x, y, masks=sv.masks)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    med = statistics.median(walls)
    return {"s_per_forward": walls, "median_s": med,
            "tokens_per_s": 8192 / med, "loss": float(loss),
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "k6_launches_per_forward": k6.launches / 5}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="checkout whose src/repro_torch is measured")
    ap.add_argument("--label", required=True)
    ap.add_argument("--scoring", action="store_true",
                    help="also time zamba2-1.2b scoring forwards")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ssd_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs          # puts this checkout's src on the path

    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ssd_scan as k6

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    _build.build_all()
    for line in _build.build_logs().get("ssd_scan", "").splitlines():
        if any(k in line for k in ("entry function", "registers", "spill",
                                   "error")):
            print(f"[ssd_ab build] {line.strip()}", file=sys.stderr)
    timer = cs.Timer(torch)
    result = {"label": args.label, "card": card,
              "repro_torch": os.path.dirname(k6.__file__),
              "kernels": kernel_numbers(torch, cs, k6, ref, timer)}
    del timer
    if args.scoring:
        result["scoring"] = scoring_numbers(torch)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
