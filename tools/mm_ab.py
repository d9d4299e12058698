"""K1, K2 and K3 of one checkout on the card, to compare checkouts on one card.

    python3 tools/mm_ab.py --tree DIR --label NAME [--serving]

Imports ``repro_torch`` from ``DIR/src`` (this checkout's with ``--tree .``,
or another one's), builds that checkout's kernels, and prints one JSON line
``{"label": NAME, ...}`` with, for each case, the kernel's and
``torch.matmul``'s median CUDA-event ms with L2 flushed before each call,
taken in turns (kernel, matmul, matmul, kernel; ``chip_smoke.Timer.turns``),
their ratio, the bound (``chip_smoke._mm_bound``), the largest error against
the plain version relative to max(1, max |plain|), and whether two launches
are bitwise equal:

* ``k1_decode_*``: K1 in bf16 and f32 at M = 8 (serving's slots), K = 2048,
  N = 8192, every column block kept (serving's mask) and half of them, also
  with L2 flushed by a read instead of a write (``*_read_flush``: the
  write leaves L2 full of dirty lines that the next kernel's reads must
  write back), each beside ``read_floor_ms``: ``tools/read_floor.cu``
  reading the same number of bytes of w once, under the same timer;
* ``k1_train``, ``k2_train``, ``k3_train``: K1, K2 and K3 in f32 at M = 512
  (training's B x S), K = 2048, N = 8192, every block kept, and K1 and K3
  with half kept (``*_half``; ``torch.matmul`` still computes every block);

and with ``--serving`` (``serving``): olmo-1b at full width, bf16, with
``chip_smoke.py``'s serving configuration and every slot admitted, dense and
masked at rate 0.5, three waves each: the device kernel ms per step of a
wave under ``torch.profiler`` and the part of it in K1's kernels.

To compare two checkouts, run it in turns (A, B, B, A) in one session on
one card and compare each one's two runs with the other's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def read_flush_timer(cs, torch):
    """``chip_smoke.Timer`` with L2 flushed by reading 256 MB instead of
    writing it, so that no dirty line is left for the timed call."""

    class ReadFlushTimer(cs.Timer):
        def _flush(self) -> None:
            self.flush.sum()

    return ReadFlushTimer(torch)


def read_floor(torch):
    """The launcher of ``tools/read_floor.cu``, built with the kernels' nvcc
    flags into ``build/tools/``."""
    import ctypes

    from repro_torch.kernels import _build

    out = os.path.join(os.path.dirname(HERE), "build", "tools")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libread_floor.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                    os.path.join(HERE, "read_floor.cu")], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(lib).read_floor_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    word = torch.zeros(4, dtype=torch.int32, device="cuda")
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count

    def run(t, nbytes):
        err = fn(t.data_ptr(), nbytes // 16, word.data_ptr(), blocks,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"read_floor: cudaError {err}")
    return run


def kernel_numbers(torch, cs, k1, ref, timer) -> dict:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kdim, n = 2048, 8192
    nb = n // 128
    half = torch.zeros(nb, device="cuda")
    half[torch.randperm(nb, generator=gen, device="cuda")[: nb // 2]] = 1.0
    ones = torch.ones(nb, device="cuda")
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        w = (torch.randn((kdim, n), generator=gen, device="cuda")
             / kdim ** 0.5).to(dtype)
        x = torch.randn((8, kdim), generator=gen, device="cuda").to(dtype)
        for label, bm in (("ones", ones), ("half", half)):
            cases.append((f"k1_decode_{dname}_{label}", "fwd", k1.masked_matmul,
                          ref.masked_matmul_ref, lambda a, b: a @ b, x, w, bm))
    w = torch.randn((kdim, n), generator=gen, device="cuda") / kdim ** 0.5
    x = torch.randn((512, kdim), generator=gen, device="cuda")
    dy = torch.randn((512, n), generator=gen, device="cuda")
    cases += [("k1_train", "fwd", k1.masked_matmul, ref.masked_matmul_ref,
               lambda a, b: a @ b, x, w, ones),
              ("k2_train", "dx", k1.masked_matmul_dx, ref.masked_matmul_dx_ref,
               lambda a, b: a @ b.T, dy, w, ones),
              ("k3_train", "dw", k1.masked_matmul_dw, ref.masked_matmul_dw_ref,
               lambda a, b: a.T @ b, x, dy, ones),
              ("k1_train_half", "fwd", k1.masked_matmul, ref.masked_matmul_ref,
               lambda a, b: a @ b, x, w, half),
              ("k3_train_half", "dw", k1.masked_matmul_dw,
               ref.masked_matmul_dw_ref, lambda a, b: a.T @ b, x, dy, half)]
    floor = read_floor(torch)
    read_timer = read_flush_timer(cs, torch)
    out = {}
    for name, kind, fn, plain, lib, a, b, bm in cases:
        got = fn(a, b, bm)
        again = fn(a, b, bm)
        want = plain(a, b, bm)
        torch.cuda.synchronize()
        _, rel = cs.max_rel_err(torch, got, want)
        ms, lib_ms = timer.turns(lambda: fn(a, b, bm), lambda: lib(a, b))
        m = a.shape[0]
        kept = int((bm > 0).sum())
        bound, by = cs._mm_bound(kind, m, kdim, n, kept, a.element_size(),
                                 str(a.dtype).split(".")[-1])
        out[name] = {"ms": ms, "matmul_ms": lib_ms, "ratio": ms / lib_ms,
                     "bound_ms": bound, "bound_by": by, "kept": kept,
                     "rel_err": rel, "bitwise_repeat": bool(torch.equal(got, again))}
        if name.startswith("k1_decode"):
            nbytes = b.element_size() * kdim * 128 * kept
            out[name].update(
                read_floor_ms=timer(lambda: floor(b, nbytes)),
                read_flush_ms=read_timer(lambda: fn(a, b, bm)),
                read_flush_matmul_ms=read_timer(lambda: lib(a, b)),
                read_flush_floor_ms=read_timer(lambda: floor(b, nbytes)))
        print(f"[mm_ab] {name}: {json.dumps(out[name])}", file=sys.stderr,
              flush=True)
    return out


def serving_numbers(torch, cs) -> dict:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.serving import ServeConfig, load_servable

    cfg = get_config("olmo-1b")
    model = LM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    kept = model.decide_kept(params, 0.5)
    scfg = ServeConfig(slots=8, cache_len=512, max_prompt=64,
                       max_new_tokens=64, steps_per_wave=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(1, 65)))
               .astype(np.int32) for _ in range(16)]
    n = scfg.steps_per_wave
    out = {}
    for mode in ("dense", "masked"):
        sv = load_servable({"params": params, "kept": kept if mode == "masked"
                            else None, "mode": "mask", "model_config": cfg},
                           mode, device="cuda")
        cs._full_engine(torch, sv, scfg, prompts)              # warm-up
        runs = []
        for _ in range(3):
            eng = cs._full_engine(torch, sv, scfg, prompts)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                eng._wave()
                torch.cuda.synchronize()
            kernels = [e for e in prof.key_averages()
                       if e.device_type.name == "CUDA"
                       and e.self_device_time_total > 0]
            dev = sum(e.self_device_time_total for e in kernels) / 1e3 / n
            k1_dev = sum(e.self_device_time_total for e in kernels
                         if "masked_gemv" in e.key
                         or "masked_matmul_kernel" in e.key) / 1e3 / n
            runs.append({"kernel_ms_per_step": dev,
                         "k1_ms_per_step": k1_dev})
        out[mode] = runs
        del sv
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="checkout whose src/repro_torch is measured")
    ap.add_argument("--label", required=True)
    ap.add_argument("--serving", action="store_true",
                    help="also profile dense and masked serving waves")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("mm_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs          # puts this checkout's src on the path

    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    _build.build_all()
    for text in _build.build_logs().values():
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill", "error")):
                print(f"[mm_ab build] {line.strip()}", file=sys.stderr)
    timer = cs.Timer(torch)
    result = {"label": args.label, "card": card,
              "repro_torch": os.path.dirname(k1.__file__),
              "kernels": kernel_numbers(torch, cs, k1, ref, timer)}
    del timer
    if args.serving:
        result["serving"] = serving_numbers(torch, cs)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
