#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   — require CUDA, print the card's name and power limit, TF32 off;
2. build    — compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
              (one process per source, in parallel) into ``build/``;
3. kernels  — each CUDA kernel against its plain PyTorch version on the card
              at the serving path's shapes, in float32 and bfloat16, with
              CUDA-event times of the kernel, the plain version and one
              library call of the same function, beside the bound;
4. parity   — olmo-1b at full width, 2 layers, float32: teacher-forced
              decode steps on the card (kernels) against the CPU (plain
              versions), dense and masked at prune rate 0.5, plus the
              masked model against its shrunk twin;
5. serving  — olmo-1b at full width, all 16 layers, bfloat16: the
              continuous-batching DecodeEngine over ``load_servable`` in
              dense, masked@0.5 and shrunk@0.5 modes, with each kernel's
              launch count checked against the decode steps taken, and one
              wave run under ``torch.cuda.set_sync_debug_mode("error")``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12                     # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12,               # FP32 outside the tensor cores
              "bfloat16": 989e12}             # dense tensor-core rate
# max |kernel - plain| allowed, relative to max(1, max |plain|): f32 sums in
# another order (~1e-7 per term); bf16 may round to a neighbouring step
# (2**-7 of the value).
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median CUDA-event time of one call, with L2 flushed before each
    repeat (the serving path meets every K/V page and weight cold)."""

    def __init__(self, torch, reps: int = 30):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 * 2 ** 20, dtype=torch.float32,
                                 device="cuda")      # 256 MB > 50 MB of L2

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        pairs = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def max_rel_err(torch, got, want) -> tuple[float, float]:
    """(max |got - want|, that divided by max(1, max |want|))."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = max(1.0, float(want.abs().max()) if want.numel() else 0.0)
    return err, err / scale


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phases 1-2: device and build
# ---------------------------------------------------------------------------

def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}"
        f" torch {torch.__version__} cuda {torch.version.cuda}; TF32 off")
    return card


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.2f} s "
        f"(sm_90a, nvcc, one process per source)")
    for name, text in sorted(_build.build_logs().items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _k5_case(torch, gen, b, s, kvh, g, hd, dtype, lengths):
    h = g * kvh
    q = torch.randn((b, 1, h, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, kvh, hd), generator=gen, device="cuda").to(dtype)
    if lengths is not None:
        # garbage, NaN included, past every valid prefix: never attended
        stale = (torch.arange(s, device="cuda")[None, :]
                 >= lengths[:, None])[:, :, None, None]
        k = torch.where(stale, torch.full_like(k, float("nan")), k)
        v = torch.where(stale, torch.full_like(v, 1e4), v)
    return q, k, v


def _k5_bound_ms(b, h, kvh, hd, lens_sum, elt, dtype_name) -> float:
    nbytes = elt * (2 * b * h * hd + 2 * lens_sum * kvh * hd) + 4 * b
    flops = 4 * lens_sum * h * hd
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name])


def _k1_bound_ms(m, k, n, kept_blocks, elt, dtype_name) -> float:
    nbytes = elt * (m * k + k * 128 * kept_blocks + m * n) + 4 * (n // 128)
    flops = 2 * m * k * 128 * kept_blocks
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name])


def phase_kernels(torch, timer) -> dict:
    """Returns {kernel name: record of its main-path case (bfloat16)}."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = {}

    # K5 decode_attention: the serving shapes (8 slots, 512-slot pages,
    # olmo-1b's 16 kv heads of 128), ragged lengths, stale NaN rows
    b, s, kvh, hd = 8, 512, 16, 128
    lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda",
                         dtype=torch.int32)
    cases = [("main", kvh, 1, s, lens), ("gqa-g4", 4, 4, s, lens),
             ("no-lengths", kvh, 1, s, None),
             ("S=500", kvh, 1, 500, torch.clamp(lens, max=500))]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, kv_, g, s_, ln in cases:
            q, k, v = _k5_case(torch, gen, b, s_, kv_, g, hd, dtype, ln)
            got = k5.decode_attention(q, k, v, ln)
            want = ref.decode_attention_ref(q, k, v, ln)
            torch.cuda.synchronize()
            err, rel = max_rel_err(torch, got, want)
            log(f"[kernels] decode_attention {label} {dname} B={b} S={s_} "
                f"KV={kv_} G={g} hd={hd}: max_abs_err={err:.3e} "
                f"rel={rel:.3e} (tol {TOL[dname]:.3e})")
            require(bool(torch.isfinite(got).all()), "decode_attention: "
                    "non-finite output (stale rows leaked)")
            require(rel <= TOL[dname], f"decode_attention {label} {dname}: "
                    f"error {rel:.3e} over tolerance")
            if label != "main":
                continue
            ms = timer(lambda: k5.decode_attention(q, k, v, ln))
            plain_ms = timer(lambda: ref.decode_attention_ref(q, k, v, ln))
            qt = q.transpose(1, 2).contiguous()                  # [B,H,1,hd]
            kt = k.transpose(1, 2).contiguous().nan_to_num()     # [B,KV,S,hd]
            vt = v.transpose(1, 2).contiguous()
            mask = (torch.arange(s_, device="cuda")[None, :]
                    < ln[:, None])[:, None, None, :]
            lib_ms = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))
            bound = _k5_bound_ms(b, kv_ * g, kv_, hd, int(ln.sum()),
                                 q.element_size(), dname)
            log(f"[kernels] decode_attention {dname} kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                f"bound {bound:.4f} ms (bytes)")
            if dtype == torch.bfloat16:
                records["decode_attention"] = {
                    "name": "decode_attention", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                    "replaces": "src/repro/kernels/decode_attention.py:110",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": "bytes",
                    "library_ms": lib_ms}

    # K1 masked_matmul: the FFN up/gate products at decode (M = slots)
    kdim, n = 2048, 8192
    nb = n // 128
    half = torch.zeros(nb, device="cuda")
    half[torch.randperm(nb, generator=gen, device="cuda")[: nb // 2]] = 1.0
    masks = [("rate0.5", half), ("ones", torch.ones(nb, device="cuda")),
             ("zeros", torch.zeros(nb, device="cuda"))]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        w = (torch.randn((kdim, n), generator=gen, device="cuda")
             / kdim ** 0.5).to(dtype)
        for m in (8, 5):
            x = torch.randn((m, kdim), generator=gen, device="cuda").to(dtype)
            for label, bm in masks:
                got = k1.masked_matmul(x, w, bm)
                want = ref.masked_matmul_ref(x, w, bm)
                torch.cuda.synchronize()
                err, rel = max_rel_err(torch, got, want)
                log(f"[kernels] masked_matmul {label} {dname} M={m} K={kdim} "
                    f"N={n}: max_abs_err={err:.3e} rel={rel:.3e} "
                    f"(tol {TOL[dname]:.3e})")
                require(rel <= TOL[dname], f"masked_matmul {label} {dname} "
                        f"M={m}: error {rel:.3e} over tolerance")
                if label == "zeros":
                    require(float(got.float().abs().max()) == 0.0,
                            "masked_matmul: pruned blocks not exactly zero")
                if m != 8 or label != "rate0.5":
                    continue
                ms = timer(lambda: k1.masked_matmul(x, w, bm))
                plain_ms = timer(lambda: ref.masked_matmul_ref(x, w, bm))
                lib_ms = timer(lambda: torch.matmul(x, w))
                kept = int((bm > 0).sum())
                bound = _k1_bound_ms(m, kdim, n, kept, x.element_size(), dname)
                log(f"[kernels] masked_matmul {dname} kept {kept}/{nb} blocks: "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, dense "
                    f"matmul {lib_ms:.4f} ms, bound {bound:.4f} ms (bytes)")
                if dtype == torch.bfloat16:
                    records["masked_matmul"] = {
                        "name": "masked_matmul", "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
                        "replaces": "src/repro/kernels/masked_matmul.py:122",
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": "bytes",
                        "library_ms": lib_ms}
    return records


# ---------------------------------------------------------------------------
# phase 4: the decode path on the card against the CPU, float32
# ---------------------------------------------------------------------------

PARITY_TOL = 1e-4   # f32 logits, relative to max(1, max |cpu|): 2 layers and
                    # the head sum 2048- and 8192-long products in another order


def phase_parity(torch) -> None:
    import dataclasses

    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=2,
                              param_dtype="float32")
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg, device="cuda")
    params_c = cpu.init(torch.Generator().manual_seed(1))
    params_g = interop.params_from_jax(params_c, "cuda")
    kept = cpu.decide_kept(params_c, 0.5)
    masks_c = cpu.filter_masks(params_c, kept)
    masks_g = interop.masks_from_jax(masks_c, "cuda")
    blocks = masks_c["mlp"].reshape(cfg.num_layers, -1, 128).amax(-1)
    log(f"[parity] olmo-1b d_model={cfg.d_model} d_ff={cfg.d_ff} "
        f"L={cfg.num_layers} f32; rate 0.5 keeps "
        f"{kept['mlp'].shape[1]}/{cfg.d_ff} units, "
        f"{int((blocks == 0).sum())}/{blocks.numel()} FFN column blocks "
        f"fully pruned")
    shrunk_g = gpu.shrink_params(params_g, kept)
    shrunk_model = LM(dataclasses.replace(cfg, d_ff=kept["mlp"].shape[1]),
                      device="cuda")
    b, s_len = 4, 64
    rng = torch.Generator().manual_seed(2)
    start = torch.tensor([0, 3, 7, 12], dtype=torch.int32)
    caches = {"cpu": cpu.init_cache(b, s_len),
              "cpu_m": cpu.init_cache(b, s_len),
              "dense": gpu.init_cache(b, s_len),
              "masked": gpu.init_cache(b, s_len),
              "shrunk": shrunk_model.init_cache(b, s_len)}
    for c in caches.values():
        c["index"] = start.to(c["k"].device)
    with torch.inference_mode():
        for step in range(4):
            tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=rng,
                                dtype=torch.int32)
            tok_g = tok.cuda()
            want, caches["cpu"] = cpu.decode_step(params_c, caches["cpu"],
                                                  {"tokens": tok})
            want_m, caches["cpu_m"] = cpu.decode_step(
                params_c, caches["cpu_m"], {"tokens": tok}, masks=masks_c)
            got, caches["dense"] = gpu.decode_step(params_g, caches["dense"],
                                                   {"tokens": tok_g})
            got_m, caches["masked"] = gpu.decode_step(
                params_g, caches["masked"], {"tokens": tok_g}, masks=masks_g)
            got_s, caches["shrunk"] = shrunk_model.decode_step(
                shrunk_g, caches["shrunk"], {"tokens": tok_g})
            for label, a, ref_ in (("dense card~cpu", got, want),
                                   ("masked card~cpu", got_m, want_m),
                                   ("masked~shrunk card", got_m, got_s)):
                err, rel = max_rel_err(torch, a.cpu(), ref_.cpu())
                log(f"[parity] step {step} {label}: max_abs_err={err:.3e} "
                    f"rel={rel:.3e} (tol {PARITY_TOL:.0e})")
                require(bool(torch.isfinite(a).all()),
                        f"parity {label}: non-finite logits")
                require(rel <= PARITY_TOL, f"parity {label} step {step}: "
                        f"{rel:.3e} over tolerance")


# ---------------------------------------------------------------------------
# phase 5: serving olmo-1b at full width on the card
# ---------------------------------------------------------------------------

def phase_serving(torch) -> dict:
    """Returns {kernel name: launches over the three modes' runs}."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.models.lm import LM
    from repro_torch.serving import DecodeEngine, ServeConfig, load_servable

    cfg = get_config("olmo-1b")
    model = LM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    kept = model.decide_kept(params, 0.5)
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"[serving] olmo-1b full width: {cfg.num_layers} layers, "
        f"{n_params / 1e9:.3f} B params, {cfg.param_dtype}")
    scfg = ServeConfig(slots=8, cache_len=512, max_prompt=64,
                       max_new_tokens=64, steps_per_wave=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(1, 65)))
               .astype(np.int32) for _ in range(16)]
    source = {"params": params, "kept": kept, "mode": "mask",
              "model_config": cfg}
    launches = {"decode_attention": 0, "masked_matmul": 0}
    tokens_by_mode = {}
    for mode in ("dense", "masked", "shrunk"):
        src = source if mode != "dense" else {**source, "kept": None}
        sv = load_servable(src, mode, device="cuda")
        if sv.masks is not None:
            blocks = sv.masks["mlp"].reshape(cfg.num_layers, -1, 128).amax(-1)
            log(f"[serving] masked: {int((blocks == 0).sum())}/"
                f"{blocks.numel()} FFN column blocks fully pruned")
        DecodeEngine(sv.model, sv.params, scfg, masks=sv.masks,
                     device="cuda").run(prompts[:2])          # warm-up
        eng = DecodeEngine(sv.model, sv.params, scfg, masks=sv.masks,
                           device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k5.launches = 0
        k1.launches = 0
        t0 = time.perf_counter()
        done = eng.run(prompts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n5, n1 = k5.launches, k1.launches
        n_tok = sum(len(c.tokens) for c in done)
        log(f"[serving] {mode}: {len(done)} requests, {n_tok} tokens, "
            f"{eng.steps} decode steps in {dt:.3f} s -> "
            f"{n_tok / dt:.1f} tokens/s, {1e3 * dt / eng.steps:.3f} ms/step, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches decode_attention={n5} masked_matmul={n1}")
        require(len(done) == len(prompts) and
                all(c.status == "ok" for c in done),
                f"{mode}: failed requests")
        require(all(len(c.tokens) == scfg.max_new_tokens and
                    int(c.tokens.min()) >= 0 and
                    int(c.tokens.max()) < cfg.vocab_size for c in done),
                f"{mode}: malformed completions")
        require(n5 == eng.steps * cfg.num_layers,
                f"{mode}: decode_attention launched {n5} times, expected "
                f"{eng.steps} steps x {cfg.num_layers} layers")
        want1 = eng.steps * 2 * cfg.num_layers if mode == "masked" else 0
        require(n1 == want1, f"{mode}: masked_matmul launched {n1} times, "
                f"expected {want1}")
        launches["decode_attention"] += n5
        launches["masked_matmul"] += n1
        tokens_by_mode[mode] = [c.tokens for c in done]
        _profile_wave(torch, mode, sv, scfg, prompts)
        if mode == "masked":
            _sync_free_wave(torch, sv, scfg, prompts)
        del sv, eng
    same = np.mean([np.mean(a == b) for a, b in zip(tokens_by_mode["masked"],
                                                   tokens_by_mode["shrunk"])])
    log(f"[serving] masked and shrunk agree on {100 * same:.1f}% of tokens "
        f"(bf16 rounding differs between the two products)")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _full_engine(torch, sv, scfg, prompts):
    """An engine with every slot admitted and one wave run."""
    from repro_torch.serving import DecodeEngine

    eng = DecodeEngine(sv.model, sv.params, scfg, masks=sv.masks,
                       device="cuda")
    for p in prompts[: scfg.slots]:
        eng.submit(p)
    eng.step_wave()
    torch.cuda.synchronize()
    return eng


def _profile_wave(torch, mode, sv, scfg, prompts) -> None:
    """Where a decode step's time goes: the host-clock time of one wave
    (no profiler), and the device time of the kernels of another wave under
    torch.profiler — their ratio is the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    eng = _full_engine(torch, sv, scfg, prompts)
    t0 = time.perf_counter()
    eng._wave()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / scfg.steps_per_wave
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._wave()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and e.self_device_time_total > 0]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
        / scfg.steps_per_wave
    if not kernels:
        log(f"[profile] {mode}: wave {wall_ms:.3f} ms/step on the host "
            f"clock; device time not measured (the profiler saw no CUDA "
            f"kernels)")
        return
    busy = 100 * dev_ms / wall_ms
    log(f"[profile] {mode}: wave {wall_ms:.3f} ms/step on the host clock, "
        f"kernels {dev_ms:.3f} ms/step on the device -> busy {busy:.1f}%, "
        f"idle {100 - busy:.1f}%")
    n = scfg.steps_per_wave
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile] {mode}:   {e.self_device_time_total / 1e3 / n:8.4f} "
            f"ms/step  {e.count // n:4d}/step  {e.key[:90]}")


def _sync_free_wave(torch, sv, scfg, prompts) -> None:
    """One wave of masked serving under sync-debug "error": any host sync
    inside the decode steps raises."""
    eng = _full_engine(torch, sv, scfg, prompts)
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._wave()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"[serving] one wave ({scfg.steps_per_wave} steps) ran under "
        f"set_sync_debug_mode('error') without a host sync")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    phase_device(torch)
    phase_build()
    timer = Timer(torch)
    records = phase_kernels(torch, timer)
    phase_parity(torch)
    launches = phase_serving(torch)
    for name, rec in records.items():
        rec["launches"] = launches[name]
        rec.update(tpu_kernel=rec["replaces"], max_err=rec["max_abs_err"],
                   kernel_ms=rec["ms"])
        require(rec["launches"] > 0, f"{name}: never launched on the path")
    log(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
