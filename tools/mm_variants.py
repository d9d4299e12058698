"""Variants of ``csrc/masked_matmul.cu`` built side by side and timed on one card.

    python3 tools/mm_variants.py [--only NAME,NAME,...]

Builds the source as it is (``base``) and each variant of :data:`VARIANTS`
(a text substitution of the source) into ``build/variants/<name>/``, one
``nvcc`` process each, in parallel, with the kernels' flags; then times, for
each library, K1 in bf16 at decode (M = 8, K = 2048, N = 8192, every column
block kept and half of them), K1 in f32 at M = 512 and K3 in f32 at M = 512
(every block kept), each in turns with ``torch.matmul``
(``chip_smoke.Timer.turns``: L2 flushed by a write before each call), and
prints one JSON line ``{"card": ..., "<variant>": {case: [kernel ms, matmul
ms, max error relative to max(1, max |plain|)]}}``.

The variants record the choices the source makes: the ring of the GEMM
body and the form of one address in it (the body's speed moves with
ptxas's register allocation), and what the decode GEMV's split merge
costs.
Variants marked "ablation" drop work the result needs, so their error is
large by construction; only their times mean anything.
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

_RING = """constexpr int kGmBK = 64;
constexpr int kGmStages = 2;
constexpr int kGmUnroll = 16;"""


def _ring(bk, stages, unroll):
    return [(_RING, f"constexpr int kGmBK = {bk};\n"
             f"constexpr int kGmStages = {stages};\n"
             f"constexpr int kGmUnroll = {unroll};")]


# name -> [(text in the source, replacement)]
VARIANTS = {
    # the GEMM body with 3 stages of 32, each unrolled whole
    "ring_32x3_u32": _ring(32, 3, 32),
    # the GEMM body with its 64-deep stage unrolled whole
    "ring_64x2_u64": _ring(64, 2, 64),
    # the GEMM body with A's copy written in one expression, as an earlier
    # version of it was (the same copies, addresses and zero fill)
    "loader_inline": [(
        "      const int p = p0 + acol;\n"
        "      const int r = r0 + row;\n"
        "      const bool ok = p < P && r < R;\n"
        "      const T* src = a + (static_cast<size_t>(r) * lda + p);   // see kGmUnroll\n"
        "      cp_async16(as + row * BM + acol, ok ? src : a, ok);",
        "      const int p = p0 + acol, r = r0 + row;\n"
        "      const bool ok = p < P && r < R;\n"
        "      cp_async16(as + row * BM + acol, ok ? a + static_cast<size_t>(r) * lda + p : a,"
        " ok);")],
    # ablation: the decode GEMV without its split merge (no partial written,
    # no arrival, y left unwritten)
    "decode_no_merge": [
        ("  if (m >= M) return;\n  const size_t at",
         "  if (m >= M || splits > 1) return;\n  const size_t at"),
        ("  __syncthreads();                             // this block's partial"
         " is written\n  if (tid == 0) {",
         "  return;\n  if (tid == 0) {")],
}


def build(name, subs, src, csrc, flags, nvcc):
    text = src
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {old[:60]!r} is not in the source")
        text = text.replace(old, new)
    out = os.path.join(ROOT, "build", "variants", name)
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, "masked_matmul.cu")
    with open(cu, "w") as f:
        f.write(text)
    lib = os.path.join(out, "libmasked_matmul.so")
    proc = subprocess.run([nvcc, *flags, "-I", csrc, "-o", lib, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return name, lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("mm_variants: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs          # puts this checkout's src on the path
    from repro_torch.kernels import _build, ref

    names = [n for n in args.only.split(",") if n] or list(VARIANTS)
    csrc = str(_build.CSRC)
    with open(os.path.join(csrc, "masked_matmul.cu")) as f:
        src = f.read()
    jobs = {"base": []} | {n: VARIANTS[n] for n in names}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(pool.map(lambda kv: build(kv[0], kv[1], src, csrc,
                                              _build.NVCC_FLAGS,
                                              _build._nvcc()), jobs.items()))

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    timer = cs.Timer(torch)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kdim, n = 2048, 8192
    nb = n // 128
    ones = torch.ones(nb, device="cuda")
    half = torch.zeros(nb, device="cuda")
    half[torch.randperm(nb, generator=gen, device="cuda")[: nb // 2]] = 1.0
    wb = (torch.randn((kdim, n), generator=gen, device="cuda")
          / kdim ** 0.5).to(torch.bfloat16)
    xb = torch.randn((8, kdim), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((kdim, n), generator=gen, device="cuda") / kdim ** 0.5
    x = torch.randn((512, kdim), generator=gen, device="cuda")
    dy = torch.randn((512, n), generator=gen, device="cuda")
    result = {"card": card}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        fwd = lib.masked_matmul_launch
        fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        dw = lib.masked_matmul_dw_launch
        dw.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        plan = lib.masked_matmul_decode_splits
        plan.argtypes = [ctypes.c_int] * 4

        def k1(a, b, bm, out, ws):
            m = a.shape[0]
            err = fwd(a.data_ptr(), b.data_ptr(), bm.data_ptr(), out.data_ptr(),
                      ws.data_ptr(), m, kdim, n, 0 if a.dtype == torch.float32
                      else 1, stream)
            if err:
                raise RuntimeError(f"{name}: K1 cudaError {err}")
            return out

        def k3(a, b, bm, out):
            err = dw(a.data_ptr(), b.data_ptr(), bm.data_ptr(), out.data_ptr(),
                     a.shape[0], kdim, n, 0, stream)
            if err:
                raise RuntimeError(f"{name}: K3 cudaError {err}")
            return out

        ws = torch.zeros(max(n // 64 + 4 + plan(8, kdim, n, sms) * 8 * n,
                             kdim * 512), dtype=torch.int32, device="cuda")
        cases = {
            "k1_decode_bf16_ones": (lambda bm: (lambda: k1(xb, wb, bm, yb, ws)),
                                    ones, lambda: xb @ wb,
                                    lambda: ref.masked_matmul_ref(xb, wb, ones)),
            "k1_decode_bf16_half": (lambda bm: (lambda: k1(xb, wb, bm, yb, ws)),
                                    half, lambda: xb @ wb,
                                    lambda: ref.masked_matmul_ref(xb, wb, half)),
            "k1_f32_m512": (lambda bm: (lambda: k1(x, w, bm, y, ws)), ones,
                            lambda: x @ w,
                            lambda: ref.masked_matmul_ref(x, w, ones)),
            "k3_f32_m512": (lambda bm: (lambda: k3(x, dy, bm, dwt)), ones,
                            lambda: x.T @ dy,
                            lambda: ref.masked_matmul_dw_ref(x, dy, ones)),
        }
        yb = torch.empty((8, n), dtype=torch.bfloat16, device="cuda")
        y = torch.empty((512, n), device="cuda")
        dwt = torch.empty((kdim, n), device="cuda")
        rec = {}
        for case, (make, bm, lib_call, plain) in cases.items():
            call = make(bm)
            got = call().clone()
            _, rel = cs.max_rel_err(torch, got, plain())
            ms, lib_ms = timer.turns(call, lib_call)
            rec[case] = [ms, lib_ms, rel]
        result[name] = rec
        print(f"[mm_variants] {name}: {json.dumps(rec)}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
