"""Variants of ``csrc/ssd_scan.cu`` built side by side and timed on one card.

    python3 tools/ssd_variants.py [--only NAME,NAME,...]

Builds the source as it is (``base``) and each variant of :data:`VARIANTS`
(a text substitution of the source) into ``build/variants/<name>/``, one
``nvcc`` process each, in parallel, with the kernels' flags; then times K6
at zamba2-1.2b's shape (B = 1, S = 8192, nh = 64, p = 64, N = 64) in bf16
and f32, each at the chunk that variant's library runs, and prints one JSON
line ``{"card": ..., "<variant>": {"<dtype> Q=<chunk>": {"ms": ...,
"passes_ms": {kernel: ms}, "err": ...}}}``: the median CUDA-event time of
one call with L2 flushed before each (``chip_smoke.Timer``), the device time
of each pass under ``torch.profiler`` (``tools/ssd_ab.py``'s
``passes_ms``), and the largest difference from ``base``'s output of the
same type, relative to max(1, max |base|).

The variants record the choices the source makes: each type's chunk, the
instance for p = 64, the form of y's address, the heads that share one C B^T in pass 3, the heads and warps of a pass-1
block, how far ahead pass 2 loads, whether the passes run their chunks in
reverse (so that one pass finds the last one's newest writes in L2), and
the f32 carry loop kept rolled. Variants marked "ablation" drop work the
result needs, so their error is large by construction; only their times
mean anything.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

_PASS1_BLOCK = "  const int c = blockIdx.x, h0 = blockIdx.y * kHG1, b = blockIdx.z;"
_PASS3_BLOCK = "  const int c = blockIdx.x, h0 = blockIdx.y * kHG, b = blockIdx.z;"
_CARRY_LOOP = ("    constexpr int kUnroll = sizeof(T) == 2 ? kN / 16 : 1;\n"
               "#pragma unroll kUnroll")
_CHUNK = "constexpr int kChunk = sizeof(T) == 2 ? 128 : 64;"


def _const(name, value, new):
    return [(f"constexpr int {name} = {value};", f"constexpr int {name} = {new};")]


# name -> [(text in the source, replacement)]
VARIANTS = {
    # the other chunk for each type: bf16 at 64, f32 at 128 (one block an SM)
    "chunk_swap": [(_CHUNK, _CHUNK.replace("? 128 : 64", "? 64 : 128"))],
    # p = 64 through the general sub-head instance (runtime p, column tests)
    "subheads_general": [("  const bool whole = P == kP;",
                          "  const bool whole = false;")],
    # pass 3: y's address written as step0 * y_row + h * p, the same value
    # (ptxas allocates pass 3's registers differently)
    "y_address_by_row": [(
        "    T* yb = static_cast<T*>(a.y) + (step0 * a.nh + sub.h) * P + sub.col;",
        "    T* yb = static_cast<T*>(a.y) + step0 * y_row + static_cast<size_t>(sub.h) * P"
        " + sub.col;")],
    # pass 3: C B^T shared by 8 heads a block (512 blocks at zamba2, not 256)
    "pass3_heads_8": _const("kHG", 16, 8),
    # pass 1: 8 or 2 heads a block instead of 4
    "pass1_heads_8": _const("kHG1", 4, 8),
    "pass1_heads_2": _const("kHG1", 4, 2),
    # pass 1: one warp for each 16 rows of p, all of N (4 warps, not 8)
    "pass1_whole_n": _const("kStateSplitN", 2, 1),
    # pass 2: 4 or 16 chunks' loads in flight a thread instead of 8
    "pass2_ahead_4": _const("kAhead", 8, 4),
    "pass2_ahead_16": _const("kAhead", 8, 16),
    # passes 1 and 3 walk the chunks from the last, so that pass 2 finds
    # pass 1's newest S_c, and pass 3 pass 2's newest states, in L2
    "reverse_chunks": [
        (_PASS1_BLOCK, _PASS1_BLOCK.replace("c = blockIdx.x,",
                                            "c = a.nc - 2 - blockIdx.x,")),
        (_PASS3_BLOCK, _PASS3_BLOCK.replace("c = blockIdx.x,",
                                            "c = a.nc - 1 - blockIdx.x,"))],
    # the f32 carry loop unrolled like bf16's (ptxas then spills)
    "f32_carry_unrolled": [(_CARRY_LOOP, "#pragma unroll")],
    # ablation: pass 3 without its G X products (the loads stay)
    "ablation_no_gx": [(
        "      load_b_t(fb, xcur, 16 * np, 16 * kk, lane);\n"
        "      mma2<true, false>(acc[2 * np], acc[2 * np + 1], fa, fb);",
        "      load_b_t(fb, xcur, 16 * np, 16 * kk, lane);\n"
        "      if (lane == 99) mma2<true, false>(acc[2 * np], acc[2 * np + 1], fa, fb);")],
    # ablation: pass 3 without its carried-state products
    "ablation_no_carry": [(
        "        mma2<false, true>(acc[2 * np], acc[2 * np + 1], fa, fb);",
        "        if (lane == 99) mma2<false, true>(acc[2 * np], acc[2 * np + 1], fa, fb);")],
    # ablation: G without its decay exp
    "ablation_no_exp": [(
        "  return j <= i ? ex2(c2i - c2j) * (cb * dtvj) : 0.f;",
        "  return j <= i ? (c2i - c2j) * (cb * dtvj) : 0.f;")],
}


def build(name, subs, src, csrc, flags, nvcc):
    text = src
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant {name}: text not found:\n{old}")
        text = text.replace(old, new)
    out = os.path.join(ROOT, "build", "variants", name)
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "ssd_scan.cu")
    with open(cu, "w") as f:
        f.write(text)
    lib = os.path.join(out, "libssd_scan.so")
    proc = subprocess.run([nvcc, *flags, "-I", csrc, "-o", lib, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {name} does not build:\n{proc.stdout}"
                           f"{proc.stderr}")
    spills = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
              if "spill" in line and " 0 bytes spill stores" not in line]
    return lib, spills


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help="comma-separated variants")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ssd_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs          # puts this checkout's src on the path
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as k6
    from tools.ssd_ab import passes_ms

    names = [n for n in args.only.split(",") if n] or list(VARIANTS)
    jobs = {"base": []} | {n: VARIANTS[n] for n in names}
    src = (_build.CSRC / "ssd_scan.cu").read_text()
    nvcc = _build._nvcc()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {n: pool.submit(build, n, subs, src, str(_build.CSRC),
                               _build.NVCC_FLAGS, nvcc)
                for n, subs in jobs.items()}
        libs = {n: f.result() for n, f in futs.items()}
    _build.build_all()

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    nh, p, n = 64, 64, 64
    data = {dtype: (randn(1, 8192, nh, p, dtype=dtype),
                    randn(1, 8192, n, dtype=dtype),
                    randn(1, 8192, n, dtype=dtype),
                    randn(1, 8192, nh, dtype=dtype), 0.1 * randn(nh),
                    randn(nh), randn(nh))
            for dtype in (torch.bfloat16, torch.float32)}
    timer = cs.Timer(torch)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    result = {"card": card}
    want = {}
    for name, (lib, spills) in libs.items():
        for kernel in ("ssd_scan", "ssd_scan_chunk"):
            _, symbol, argtypes = _build.SIGNATURES[kernel]
            fn = getattr(ctypes.CDLL(lib), symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _build._loaded[kernel] = fn
        k6.library_chunk.cache_clear()
        rec = {"spills": spills} if spills else {}
        for dtype, args_ in data.items():

            def call():
                return k6.ssd_scan(*args_)

            got = call()
            torch.cuda.synchronize()
            if name == "base":
                want[dtype] = got
            _, err = cs.max_rel_err(torch, got, want[dtype])
            label = f"{str(dtype).split('.')[-1]} Q={k6.library_chunk(dtype)}"
            rec[label] = {"ms": timer(call),
                          "passes_ms": passes_ms(torch, call, timer.flush),
                          "err": err}
            del got
        result[name] = rec
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
