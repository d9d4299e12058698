#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   — require CUDA, print the card's name and power limit, TF32 off;
2. build    — compile ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
              (one process per source, in parallel) into ``build/``; print
              ptxas's registers and spills and each library's count of
              tensor-core (``HGMMA``) and TMA-load (``UTMALDG``) SASS
              instructions, which must be above 0 for masked_matmul and
              flash_attention, and the count of mma.sync (``HMMA``)
              instructions, which must be above 0 for ssd_scan, and require
              no spills in the wgmma kernels, K1's decode GEMV and the GEMM
              body of K1 (f32) and K3, K2's split and sum kernels, K5's split
              kernel and K6's three passes;
3. kernels  — each CUDA kernel against its plain PyTorch version on the card
              at its paths' shapes (serving: K5, with a serving wave's
              lengths, lengths at its split boundaries and 0, K1 at M = 8;
              zamba2's decode: K5 at 32 kv heads of 64, G = 1, ragged
              lengths over 512 rows and every length past a 4096-row ring;
              training: K1, K2, K3 at M = 512 and 500, K = 2048, N = 8192,
              K2 also with one kept block and seven; scoring: K1 in bf16 at M = 8192, 8000 and 100, K4 at
              olmo-1b's and zamba2's attention shapes, ragged and GQA cases,
              K6 at zamba2's SSD shapes, a ragged S, an S below its chunk,
              head dims 32 and 96, and on apply_mamba2's split views), in
              float32 and bfloat16, K1 (decode and f32), K2, K3, K5 and K6
              also bitwise equal over two launches, with CUDA-event times of
              the kernel (K1's decode, K2's and K5's split count and grid
              printed), the plain version and one library call of the same
              function,
              beside the bound (K1 at decode with every block kept, serving's
              mask, and with half kept, each timed in turns with
              torch.matmul);
4. parity   — olmo-1b at full width, 2 layers, float32: teacher-forced
              decode steps on the card (kernels) against the CPU (plain
              versions), dense and masked at prune rate 0.5, plus the
              masked model against its shrunk twin;
5. hybrid-parity — zamba2 at full width, 6 layers (one group), float32:
              72 teacher-forced decode steps on the card against the CPU,
              with the model's window, with a 64-row window (the steps
              cross into the ring buffer) and masked on that ring;
6. train-parity — olmo-1b and zamba2 at full width, 2 layers, float32: the
              masked loss and every gradient, then one kernel-mode FedDUMAP
              round, on the card against the CPU;
7. training — a FedDUMAP ``FederatedTrainer`` run of ``fedap_plan(4,
              prune_round=2, mode="mask")`` in kernel mode, float32, at full
              width: olmo-1b (all 16 layers), then zamba2 (12 layers, two
              groups), then qwen2-vl-7b (2 of 28 layers), with each
              masked_matmul kernel's launch count checked against the
              gradient evaluations, then timed and profiled rounds (every
              round after the first on a state a CUDA graph replay);
8. serving  — olmo-1b at full width, all 16 layers, bfloat16: the
              continuous-batching DecodeEngine over ``load_servable`` in
              dense, masked@0.5 and shrunk@0.5 modes, with each kernel's
              launch count checked against the decode steps taken, one
              wave run under ``torch.cuda.set_sync_debug_mode("error")``,
              and the modes' device kernel time per step on adjacent lines;
              then zamba2-1.2b, all 38 layers, bfloat16, through
              ``lockstep_decode`` (8 prompts of 64 tokens, 32 new) in the
              same three modes: tokens/s, ms/step, K5 7 and K1 76 (masked)
              launches a step, a profiled window and a sync-checked one of
              captured steps, and (dense, masked) the captured step against
              its eager body (``[capture] zamba2 <mode> lockstep``: two
              requests of 32 + 16 token for token, launches equal, ms/step
              in turns, busy share, peaks);
9. score-parity — float32 logits of ``attn_impl="pallas"`` (K4, K6)
              against ``attn_impl="xla"`` (plain attention, chunked scan) on
              the card: zamba2-1.2b at full width, 12 layers, S = 8192, and
              olmo-1b at full width, 2 layers, S = 2048, beside the logits'
              own response to one f32 rounding of the embeddings;
10. scoring — full-sequence scoring (``loss_and_acc`` under no_grad)
              through ``load_servable(..., attn_impl="pallas")``: olmo-1b,
              all 16 layers, bf16, B = 4 x S = 2048, dense / masked@0.5 /
              shrunk@0.5, then zamba2-1.2b, all 38 layers, bf16, B = 1 x
              S = 8192; tokens/s, the device's busy share and time per
              kernel (torch.profiler), peak memory, and the launch counts
              (K4 16 per olmo forward, K1 32 in masked mode; K4 7 and K6 38
              per zamba2 forward); then ``launch.cost.CostCounter`` on the
              masked olmo forward and on one masked decode step (8 slots x
              512 rows), each count equal to the meta device's, the
              counter's K4/K1/K5 calls equal to the wrappers' launches, and
              the counted FLOPs over the timed forward as TFLOP/s and as a
              share of the bf16 peak;
11. cnn-parity — the paper's CNNs at full width in float32 (TF32 off), card
              against CPU from the same params: SimpleCNN (16x16x3), VGG11
              (32x32x3) and ResNet18-GN (32x32x3, 100 classes) logits and
              gradients on a batch of 32; SimpleCNN's HRank ranks over a
              probe of 32 (per-sample differences counted, the kept sets at
              rate 0.5 equal) and one FedDUMAP round with a mask prune;
12. training cnn — the paper protocol through ``FederatedTrainer``:
              ``SyntheticSpec()`` data, 100 clients of 400 samples, 2,000
              server samples, 10 clients a round, E = CNN_LOCAL_EPOCHS (1;
              the paper's 5, cut for the script's clock), B = 10, FedAP with
              a probe of 32 and 6 participants; SimpleCNN with a prune at
              round 1 (shrink and mask for 2 rounds, mask then shrink at 2
              for 3) and
              VGG11 (32x32x3) for 2 rounds with a shrink at round 1: s/round
              (the median of the rounds after the first, each timed alone),
              local samples/s, peak memory, the busy share of a profiled
              round, p*, kept counts, MFLOPs before and after, the accuracy
              trajectory, and 0 launches of masked_matmul (no paper CNN
              reaches a TPU kernel);
13. paper-parity — SimpleCNN at the paper protocol's width (10x10x3), f32,
              card against CPU from the same params and batches: one
              FedProx round, two FedDyn rounds with client dropout (one
              client dropped, then all: that round leaves the client state
              and momentum bitwise unchanged on the card and moves the
              params by exactly -h/alpha), and the FedDF and FedKT hooks;
14. paper   — ``repro_torch.experiments.run_one`` for the 16 algorithms of
              the paper's comparison at its protocol (2 rounds, prune or
              hook at round 1, Eval every 2), then the scenario grid's
              smoke cells (FedAvg, FedProx, FedDyn at dropout 0.25): a line
              a run with s/round, local samples/s, the busy share of a
              profiled one-client slice, peak memory, accuracy, MFLOPs and
              p*/kept, and the baselines' own checks (IMC/PruneFL zeros,
              HRank's shrink, Data-sharing's and Hybrid-FL's data, FedDyn's
              h after round 1);
15. reliability — the health guard at olmo-1b's full width (16 layers,
              f32, kernel mode): a ``reject_client`` round with NaNGrad on
              one selected client against the unguarded round with that
              client inactive (train-parity's allowance), ``skip_round``
              bitwise a no-op on params, server_m and masks, and the s/round
              and peak of guard off / reject / skip taken in turns; kill and
              resume (``KillAfterChunk(2)``, a checkpoint every chunk, a
              fresh trainer's ``resume``) of olmo-1b at 2 layers and of the
              paper protocol's FedDUMAP SimpleCNN run with a shrink (2
              clients x 1 epoch a round), each
              after two uninterrupted runs that must be bitwise equal (the
              determinism check), with the snapshot's bytes and its write
              and load seconds; and an olmo-1b ``DecodeEngine`` run with
              ``NaNLogits`` on slot 1, every wave under sync-debug "error":
              slot 1 ends in "error", the others with the fault-free tokens;
16. xlstm-parity — xlstm-125m reduced to 4 layers (three mLSTM blocks, one
              sLSTM), f32 with TF32 off, card against CPU from the same
              params: the forward's logits (B = 2 x S = 128, two scan
              chunks), 64 teacher-forced decode steps (logits and every
              state tensor), the loss gradient and one FedDUM round; then
              bf16: each block on one input, and the LM's forward and decode
              no farther from the f32 logits than the CPU's bf16 run;
17. xlstm   — xlstm-125m at full width and depth (12 layers, 188.9 M
              params, seeded weights): bf16 scoring through
              ``load_servable(..., attn_impl="pallas")`` (B = 4 x S = 2048,
              s/forward, tokens/s, peak; the busy share of a forward at S =
              256 under the profiler), bf16 serving through
              ``lockstep_decode`` (8 prompts of 64 tokens, 64 new: ms/step,
              tokens/s, launches a step and busy share of a profiled window,
              a window under sync-debug "error", the captured step against
              its eager body), f32 FedDUM training at S =
              128 (s/round, tokens/s, peak), then
              ``examples/serve_decode_torch.py`` and
              ``examples/fl_llm_train_torch.py`` at their defaults, and the
              latter again with ``--rounds 2 --backend mesh`` (a world of
              one over NCCL), as subprocesses, which must exit 0.  No TPU kernel lies on the family's path;
18. moe-parity — arctic-480b and llama4-maverick reduced (2 layers, d
              256, 4 experts) with their own head layouts (56 and 40 heads
              of 128 padded to 64 and 48 over 8 kv heads), f32, card against
              CPU: one ``apply_moe`` with both auxiliary losses, the
              forward's logits through plain attention and through K4, the
              loss with its aux and every gradient leaf, 8 decode steps from
              per-slot fill levels (K5 at G = 8 and 6); ``fedap_lm`` at rate
              0.5 on a 16-expert arctic: the CPU keeps the same experts, and
              a leaf-at-a-time prune equals it bitwise;
19. moe     — arctic-480b at full width (128 experts of 4864, top-2, the
              dense residual FFN, 56 heads padded to 64 over 8 kv heads of
              128) cut to 2 of 35 layers, bf16, seeded weights, ``dense``
              then ``experts@0.5`` (fedap_lm's 64 of 128 experts, gathered a
              leaf at a time): scoring through ``load_servable(...,
              attn_impl="pallas")`` at B = 4 x S = 2048 (K4 2 launches a
              forward, a profiled forward) and serving through
              ``DecodeEngine`` at the olmo-1b serving phase's settings (K5 2
              launches a step; tokens/s, ms/step, launches a step and busy
              share of a profiled wave, peak, a wave under sync-debug
              "error"); then f32 FedDUM training of arctic's structure cut
              to 4 layers, d 2048, 16 experts of 1216 at S = 128: two runs
              of one round from one state bitwise equal, then two timed
              rounds.  The kernels phase also holds K4 at arctic's scoring
              shape (64 heads over 8) and K5 at G = 8 and 6 against their
              plain versions, timed beside SDPA (``enable_gqa``);
20. vlm-parity — qwen2-vl-7b reduced (2 layers, d 256) with its own head
              layout (28 heads padded to 32 over 4 kv heads of 128), f32,
              card against CPU: logits from embeds with Qwen2-VL M-RoPE
              positions (text, a patch grid, text) through plain attention
              and K4, the loss over the text and every gradient leaf, 16
              decode steps through the embeds path from fill levels (K5 at
              G = 8);
21. vlm     — qwen2-vl-7b at full width and depth (28 layers, 7.72 B
              params, bf16, seeded) in dense, masked@0.5 and shrunk@0.5
              modes: scoring through ``load_servable(attn_impl="pallas")``
              and ``model.loss`` at B = 4 x (64 text + a 32 x 32 patch grid
              + 960 text) with M-RoPE positions and the loss masked off the
              patches (K4 28, K1 56 masked a forward; the dense loss against
              ``"xla"``), serving through ``DecodeEngine`` (8 prompts of
              1-64 tokens, 32 new; K5 28, K1 56 masked a step; a profiled
              wave and one under sync-debug "error"; the captured engine
              against its eager body, ``[capture] qwen2-vl-7b dense``); its
              training phase's FedDUMAP plan in f32 at 2 of 28 layers
              (K1-K3) runs after phase 7's two, as ``training qwen2-vl``;
22. whisper-parity — whisper-small reduced (2 + 2 layers, d 256, 64
              frames) with its own head layout (12 heads padded to 16, KV
              alongside), f32, card against CPU: the encoder, logits
              through plain attention and K4 (causal on the decoder, no
              mask on the cross-attention: 2 a layer, counted), the loss
              and every gradient leaf, ``prefill_cross``'s K/V and 16
              decode steps;
23. whisper — whisper-small at full width and depth (12 + 12 layers, 1500
              frames, bf16, seeded): scoring at B = 8 x S = 448 (K4 24 a
              forward: the causal self-attention and the unmasked
              cross-attention of each decoder layer; the loss against
              ``"xla"``), ``lockstep_decode`` of 8 sequences with a 4-token
              prompt and 124 new tokens after ``prefill_cross`` (K5 12 a
              step, a profiled window, one under sync-debug "error", the
              captured step against its eager body), and
              an f32 loss gradient, finite and bitwise equal over two runs.
              The kernels phase also holds K4 at qwen2-vl's scoring shape
              and whisper's self- and cross-attention shapes (Sq 448 over
              Skv 1500 and 1500 over 448, no mask), K5 at qwen2-vl's G = 8
              and whisper's lockstep lengths, and K1-K3 at qwen2-vl's FFN
              (K 3584, N 18944) against their plain versions, timed beside
              SDPA and ``torch.matmul``.
24. steps   — ``launch.steps`` at olmo-1b's full width and depth (f32, the
              training phase's world and batch): one ``make_fl_train_step``
              round in kernel mode bitwise equal to
              ``FederatedTrainer.round_step`` (the first round on each
              state eager, the step's second captured), K1-K3 192 each a
              round,
              ``with_masks`` moving no state tensor, the serve steps equal
              to ``LM.apply``/``decode_step``; whisper-small f32 at full
              width and depth trained 2 rounds through the step (finite,
              bitwise repeatable; s/round, peak) and at 2 + 2 layers card
              against CPU; one olmo-1b kernel-masked gradient with remat
              none / block / dots (equal losses and gradients, memory held
              after the forward, peak, time, K1 recomputed by block and
              dots);
25. mesh    — ``FederatedTrainer(backend="mesh")`` as a world of one over
              NCCL, its rounds captured with the all-reduces inside: the
              training phase's olmo-1b plan, its history, final
              params and K1-K3 launches bitwise equal to that phase's
              local (captured) run; s/round of the mesh's replays, the
              all-reduces a round (one per ``_reduce`` call and dtype) and
              their host time; ``experiments.run_one(backend="mesh")`` for the
              paper phase's FedDUMAP run (a shrink) equal to its local
              record; a mesh kill and resume of the reliability phase's
              cut SimpleCNN plan, bitwise; then ``DecodeEngine(mesh=)``
              serving the serving phase's masked olmo-1b (16 prompts, K1
              and K5): completions token for token and launches equal to
              that phase's mesh-less engine, one wave and its all-gather
              under sync-debug "error", and waves of both engines timed in
              turns (ms/step);
26. capture — the reference's compiled programs as CUDA graphs
              (``core.programs``), each against its eager body: olmo-1b's
              ``DecodeEngine`` at the serving phase's settings in dense,
              masked@0.5 and shrunk@0.5 modes (completions token for token,
              K1/K5 launches equal, ``program_counts()`` {"admit": 1,
              "wave": 1}, replays under sync-debug "error", ms/step in
              turns and busy share; qwen2-vl-7b dense in the vlm phase),
              SimpleCNN's FedDUMAP round at the paper protocol and olmo-1b's
              kernel-mode round (8 layers, f32): states and metrics bitwise
              equal, s/round in turns, busy share and peaks; on that world
              ``FederatedTrainer.round_step`` captured against eager and
              the mesh round (the NCCL world of one) against the local
              captured round, each bitwise; whisper-small's batch-dict
              ``train_step`` (f32, full depth) captured against eager,
              bitwise; then ``analysis.compile_budget.check(device="cuda")``
              over the local, mesh and serving scenarios.  Every other phase runs the
              captured engine and rounds too: the training phases' rounds
              after the first on a state are graph replays.
27. tp      — tensor parallelism over the ``model`` mesh axis (one card
              holds one rank; NCCL refuses two on one device): olmo-1b at
              full width and depth on a (1, 1) mesh over the NCCL world of
              one, the sharded train step (f32, kernel mode, a FedAP
              decision at 0.5 injected; eager, then captured), prefill
              (bf16, K4, 4 x 512) and 32 masked decode steps (K5, K1)
              bitwise the unsharded steps; each rank's block of one
              full-width layer of olmo-1b (model 2 and 4) and chatglm3-6b
              (2: kv split; 4: kv whole), its parts computed on the card
              and summed by the check against the whole block (attention
              through K4 and the FFN in f32 and bf16, the FFN's f32
              gradients, the vocab-parallel loss and argmax with the ranks
              as threads); rank 0 of deepseek-67b on a (1, 4) mesh at full
              width and all 95 layers (bf16, 33.7 GB drawn on the card): a
              1 x 2048 prefill (K4) and 16 masked decode steps (K5, K1),
              its bytes against the dry run's per-device bytes, its
              recorded collectives against the dry run's counts, ms a
              step; and K1, K4 and K5 at that rank's shapes against their
              plain versions, timed beside the library call.

Each phase after the build prints its peak device memory; ``[time]`` lines
give each phase's wall seconds and the total.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import gc
import json
import math
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
            self._flush()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    def _flush(self) -> None:
        self.flush.zero_()

    def turns(self, fn, other) -> tuple[float, float]:
        """Times of ``fn`` and ``other`` taken in turns (fn, other, other,
        fn): the mean of each one's two medians, so that a drift of the
        card's speed during the four runs falls on both alike."""
        a1, b1 = self(fn), self(other)
        b2, a2 = self(other), self(fn)
        return (a1 + a2) / 2, (b1 + b2) / 2


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


# libraries whose bf16 paths must run on the tensor cores through TMA
TENSOR_CORE_LIBS = ("masked_matmul", "flash_attention")
# libraries whose products must run on mma.sync tensor-core instructions
MMA_LIBS = ("ssd_scan",)
# kernels whose ptxas report must show no spill: the wgmma kernels, K1's
# decode GEMV (both bodies), the GEMM body of K1 (f32) and K3, K2's split and
# sum kernels, K5's split kernel, K6's three passes
NO_SPILL = ("wgmma", "masked_gemv", "masked_gemm_", "masked_dx_",
            "decode_split_", "ssd_chunk_state", "ssd_state_pass",
            "ssd_chunk_scan")


def phase_build() -> None:
    import re

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.2f} s "
        f"(sm_90a, nvcc, one process per source)")
    for name, text in sorted(_build.build_logs().items()):
        kernel = label = "?"
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:
                kernel = entry.group(1)
                # the kernel's name and template arguments in the symbol
                short = re.search(r"\d+([a-z][a-z_]*_kernel)(I\w*?EE)?", kernel)
                label = "".join(short.groups("")) if short else kernel
            if ("registers" in line or "spill" in line or "error" in line
                    or "Performance Loss" in line):
                log(f"[build] {name}: {label}: {line.strip()}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if spill and any(k in kernel for k in NO_SPILL):
                require(spill.groups() == ("0", "0"), f"build: {kernel} "
                        f"spills ({line.strip()})")
    for name, path in sorted(_build.library_paths().items()):
        sass = subprocess.run([_build.tool("cuobjdump"), "-sass", str(path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass))
                  for op in ("HGMMA", "UTMALDG", "HMMA")}
        log(f"[build] {name} SASS: HGMMA {counts['HGMMA']}, UTMALDG "
            f"{counts['UTMALDG']}, HMMA {counts['HMMA']}")
        if name in TENSOR_CORE_LIBS:
            require(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0,
                    f"build: {name} has no wgmma or no TMA load in its SASS "
                    f"({counts})")
        if name in MMA_LIBS:
            require(counts["HMMA"] > 0, f"build: {name} has no mma.sync "
                    f"tensor-core instruction in its SASS ({counts})")


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


def _bound(flops, nbytes, dtype_name):
    """(bound ms, "bytes" or "operations") of work that moves ``nbytes`` and
    does ``flops`` at the H100's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _k5_bound_ms(b, h, kvh, hd, lens_sum, elt, dtype_name) -> float:
    """K5's bound from its wrapper's ``work`` at this call's lengths."""
    from repro_torch.kernels import decode_attention as k5

    return _bound(*k5.work(b, h, kvh, hd, elt, lens_sum), dtype_name)[0]


def _mm_bound(kind, m, k, n, kept_blocks, elt, dtype_name):
    """(bound ms, "bytes" or "operations") of one masked product, from the
    wrappers' ``work`` at this call's kept blocks."""
    from repro_torch.kernels import masked_matmul as k1

    return _bound(*k1.work(kind, m, k, n, elt, kept_blocks), dtype_name)


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
    # a serving wave's lengths: prompts of 1-64 tokens plus up to 64 new
    serve_lens = torch.randint(1, 129, (b,), generator=gen, device="cuda",
                               dtype=torch.int32)
    cases = [("main", kvh, 1, s, lens), ("serving-lengths", kvh, 1, s,
                                         serve_lens),
             ("gqa-g4", 4, 4, s, lens), ("no-lengths", kvh, 1, s, None),
             ("S=500", kvh, 1, 500, torch.clamp(lens, max=500))]
    # lengths at the edges of the split schedule: 0, one split, one row into
    # the next, one short of two splits, S, 1
    for s_ in (s, 500, 301):
        rows = -(-s_ // k5.decode_splits(s_))                # rows a split
        edge = torch.tensor([0, rows, rows + 1, 2 * rows - 1, s_, 1, 0,
                             3 * rows], dtype=torch.int32, device="cuda")
        cases.append((f"edges-S={s_}", kvh, 1, s_, edge))
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for label, kv_, g, s_, ln in cases:
            q, k, v = _k5_case(torch, gen, b, s_, kv_, g, hd, dtype, ln)
            got = k5.decode_attention(q, k, v, ln)
            again = k5.decode_attention(q, k, v, ln)
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
            require(torch.equal(got, again), f"decode_attention {label} "
                    f"{dname}: two launches differ")
            if ln is not None and not bool(ln.bool().all()):
                require(float(got[ln == 0].float().abs().max()) == 0.0,
                        "decode_attention: a length of 0 must give 0")
            if label not in ("main", "serving-lengths") or (
                    label != "main" and dtype != torch.bfloat16):
                continue
            splits = k5.decode_splits(s_)
            gb, lanes, nb_ = k5.decode_layout(hd, q.element_size(), g)
            log(f"[kernels] decode_attention {label} {dname} timed call: "
                f"{splits} splits of {-(-s_ // splits)} rows, grid "
                f"({kv_ * -(-g // gb)}, {b}, {splits}) x 128 threads, "
                f"{lanes} lanes a row, {nb_} row steps in flight a warp; "
                f"lengths {int(ln.min())}..{int(ln.max())}")
            plain_ms = timer(lambda: ref.decode_attention_ref(q, k, v, ln))
            qt = q.transpose(1, 2).contiguous()                  # [B,H,1,hd]
            kt = k.transpose(1, 2).contiguous().nan_to_num()     # [B,KV,S,hd]
            vt = v.transpose(1, 2).contiguous()
            mask = (torch.arange(s_, device="cuda")[None, :]
                    < ln[:, None])[:, None, None, :]
            ms, lib_ms = timer.turns(
                lambda: k5.decode_attention(q, k, v, ln),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask))
            bound = _k5_bound_ms(b, kv_ * g, kv_, hd, int(ln.sum()),
                                 q.element_size(), dname)
            log(f"[kernels] decode_attention {label} {dname} kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                f"bound {bound:.4f} ms (bytes)")
            if dtype == torch.bfloat16 and label == "main":
                records["decode_attention"] = {
                    "name": "decode_attention", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
                    "replaces": "src/repro/kernels/decode_attention.py:110",
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": "bytes",
                    "library_ms": lib_ms}

    records["decode_attention"].update(_hybrid_k5(torch, timer, gen))

    # K1 masked_matmul: the FFN up/gate products at decode (M = slots); every
    # block kept is serving's mask (FedAP at rate 0.5 prunes no whole block)
    kdim, n = 2048, 8192
    nb = n // 128
    half = torch.zeros(nb, device="cuda")
    half[torch.randperm(nb, generator=gen, device="cuda")[: nb // 2]] = 1.0
    masks = [("ones", torch.ones(nb, device="cuda")), ("rate0.5", half),
             ("zeros", torch.zeros(nb, device="cuda"))]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        w = (torch.randn((kdim, n), generator=gen, device="cuda")
             / kdim ** 0.5).to(dtype)
        for m in (8, 5):
            x = torch.randn((m, kdim), generator=gen, device="cuda").to(dtype)
            for label, bm in masks:
                got = k1.masked_matmul(x, w, bm)
                again = k1.masked_matmul(x, w, bm)
                want = ref.masked_matmul_ref(x, w, bm)
                torch.cuda.synchronize()
                err, rel = max_rel_err(torch, got, want)
                log(f"[kernels] masked_matmul {label} {dname} M={m} K={kdim} "
                    f"N={n}: max_abs_err={err:.3e} rel={rel:.3e} "
                    f"(tol {TOL[dname]:.3e})")
                require(rel <= TOL[dname], f"masked_matmul {label} {dname} "
                        f"M={m}: error {rel:.3e} over tolerance")
                require(torch.equal(got, again), f"masked_matmul {label} "
                        f"{dname} M={m}: two launches differ")
                if label == "zeros":
                    require(float(got.float().abs().max()) == 0.0,
                            "masked_matmul: pruned blocks not exactly zero")
                if m != 8 or label == "zeros":
                    continue
                splits, per = k1.decode_plan(m, kdim, n, sms)
                ms, lib_ms = timer.turns(lambda: k1.masked_matmul(x, w, bm),
                                         lambda: torch.matmul(x, w))
                plain_ms = timer(lambda: ref.masked_matmul_ref(x, w, bm))
                kept = int((bm > 0).sum())
                bound, by = _mm_bound("fwd", m, kdim, n, kept,
                                      x.element_size(), dname)
                log(f"[kernels] masked_matmul {dname} M={m} kept {kept}/{nb} "
                    f"blocks: {splits} splits of {per * k1.GV_BK} rows, grid "
                    f"({n // k1.GV_COLS}, {splits}) x 256 threads; kernel "
                    f"{ms:.4f} ms ({x.element_size() * kdim * 128 * kept / ms / 1e9:.2f}"
                    f" TB/s of w), plain {plain_ms:.4f} ms, torch.matmul "
                    f"(all blocks) {lib_ms:.4f} ms ({ms / lib_ms:.3f}x), "
                    f"bound {bound:.4f} ms ({by})")
                if dtype != torch.bfloat16:
                    continue
                rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound, "bound_by": by,
                       "library_ms": lib_ms}
                if label == "ones":
                    records["masked_matmul"] = {
                        "name": "masked_matmul", "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/masked_matmul.cu",
                        "replaces": "src/repro/kernels/masked_matmul.py:122",
                        **rec}
                else:
                    records["masked_matmul"].update(
                        {f"half_{k}": v for k, v in rec.items()})
    for name, rec in _training_kernels(torch, timer, gen).items():
        records.setdefault(name, {}).update(rec)
    records["masked_matmul"].update(_scoring_k1(torch, timer, gen))
    records.update(_scoring_kernels(torch, timer, gen))
    for name, rec in _moe_kernels(torch, timer, gen).items():
        records[name].update(rec)
    for name, rec in _vlm_whisper_kernels(torch, timer, gen).items():
        records[name].update(rec)
    return records


def _gqa_heads(h, kvh):
    """The query-head order under which SDPA's ``enable_gqa`` grouping (head
    h' reads kv head h' // G) is the port's (head h = g KV + kv reads kv):
    SDPA's head h' = kv G + g is the port's head g KV + kv."""
    g = h // kvh
    return [gi * kvh + kv for kv in range(kvh) for gi in range(g)]


def _moe_kernels(torch, timer, gen) -> dict:
    """K4 and K5 at the moe family's GQA shapes, each against its plain
    version in f32 and bf16 and timed in bf16 beside its bound and SDPA
    (``enable_gqa``, the query heads reordered to its grouping, checked
    against the plain version): K4 at arctic-480b's scoring (B=4, S=2048,
    64 padded heads over 8 kv heads of 128, causal; ``moe_*`` keys of its
    record); K5 at arctic's serving (B=8, S=512, G = 8; ``moe_*`` keys) and
    llama4-maverick's (48 padded heads over 8, G = 6; ``llama4_*`` keys),
    ragged lengths with stale NaN rows, each launched twice and compared
    bitwise."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ref

    out = {"flash_attention": {}, "decode_attention": {}}
    b, s, h, kvh, hd = 4, 2048, 64, 8, 128
    perm = torch.tensor(_gqa_heads(h, kvh), device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        q, k, v = (torch.randn((b, s, n, hd), generator=gen, device="cuda")
                   .to(dtype) for n in (h, kvh, kvh))
        got = k4.flash_attention(q, k, v, causal=True)
        again = k4.flash_attention(q, k, v, causal=True)
        want = ref.flash_attention_ref(q, k, v, causal=True)
        err = _k4_check(torch, f"arctic-480b B={b} S={s} H={h} KV={kvh} "
                        f"hd={hd} causal", dname, got, want, again)
        del got, again
        if dtype != torch.bfloat16:
            del want, q, k, v
            continue
        qt = q[:, :, perm].transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        lib = torch.empty_like(q)
        lib[:, :, perm] = sdpa().transpose(1, 2)
        lib_err = max_rel_err(torch, lib, want)[1]
        require(lib_err <= 2 * BF16_STEP, f"sdpa (enable_gqa) is not the "
                f"same function: {lib_err:.3e}")
        del lib, want
        ms, lib_ms = timer.turns(
            lambda: k4.flash_attention(q, k, v, causal=True), sdpa)
        plain_ms = timer(lambda: ref.flash_attention_ref(q, k, v,
                                                         causal=True))
        bound, by, flops = _k4_bound(b, s, s, h, kvh, hd, True, None,
                                     q.element_size(), dname)
        log(f"[kernels] flash_attention arctic-480b {dname}: kernel {ms:.4f} "
            f"ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
            f"sdpa (enable_gqa) {lib_ms:.4f} ms ({ms / lib_ms:.3f}x), bound "
            f"{bound:.4f} ms ({by}), {100 * bound / ms:.1f}% of it")
        out["flash_attention"] = {
            "moe_max_abs_err": err, "moe_ms": ms, "moe_plain_ms": plain_ms,
            "moe_bound_ms": bound, "moe_bound_by": by,
            "moe_library_ms": lib_ms}
        del q, k, v, qt, kt, vt

    b, s, kvh, hd = 8, 512, 8, 128
    for tag, g in (("moe", 8), ("llama4", 6)):
        h = g * kvh
        perm = torch.tensor(_gqa_heads(h, kvh), device="cuda")
        ln = torch.randint(1, 129, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v = _k5_case(torch, gen, b, s, kvh, g, hd, dtype, ln)
            got = k5.decode_attention(q, k, v, ln)
            again = k5.decode_attention(q, k, v, ln)
            want = ref.decode_attention_ref(q, k, v, ln)
            torch.cuda.synchronize()
            err, rel = max_rel_err(torch, got, want)
            gb = k5.decode_layout(hd, q.element_size(), g)[0]
            log(f"[kernels] decode_attention {tag} B={b} S={s} H={h} KV={kvh}"
                f" G={g} hd={hd} {dname} lengths {int(ln.min())}.."
                f"{int(ln.max())}: max_abs_err={err:.3e} rel={rel:.3e} (tol "
                f"{TOL[dname]:.3e}); {gb} heads a block; two launches "
                f"bitwise equal: {bool(torch.equal(got, again))}")
            require(bool(torch.isfinite(got).all()) and rel <= TOL[dname],
                    f"decode_attention {tag} {dname}: error {rel:.3e}")
            require(torch.equal(got, again), f"decode_attention {tag} "
                    f"{dname}: two launches differ")
            if dtype != torch.bfloat16:
                continue
            qt = q[:, :, perm].transpose(1, 2).contiguous()    # [B,H,1,hd]
            kt = k.transpose(1, 2).contiguous().nan_to_num()
            vt = v.transpose(1, 2).contiguous()
            mask = (torch.arange(s, device="cuda")[None, :]
                    < ln[:, None])[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)

            lib = torch.empty_like(q)
            lib[:, :, perm] = sdpa().transpose(1, 2)
            require(max_rel_err(torch, lib, want)[1] <= 2 * TOL[dname],
                    f"sdpa (enable_gqa) at {tag} is not the same function")
            ms, lib_ms = timer.turns(
                lambda: k5.decode_attention(q, k, v, ln), sdpa)
            plain_ms = timer(lambda: ref.decode_attention_ref(q, k, v, ln))
            bound = _k5_bound_ms(b, h, kvh, hd, int(ln.sum()),
                                 q.element_size(), dname)
            log(f"[kernels] decode_attention {tag} G={g} {dname}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa (enable_gqa) "
                f"{lib_ms:.4f} ms, bound {bound:.4f} ms (bytes), "
                f"{100 * bound / ms:.1f}% of it")
            out["decode_attention"].update({
                f"{tag}_max_abs_err": err, f"{tag}_ms": ms,
                f"{tag}_plain_ms": plain_ms, f"{tag}_bound_ms": bound,
                f"{tag}_bound_by": "bytes", f"{tag}_library_ms": lib_ms})
    return out


def _hybrid_k5(torch, timer, gen) -> dict:
    """K5 at zamba2's shared attention (32 kv heads of 64, G = 1), where the
    hybrid's lockstep decode runs it: B = 8 over a 512-row cache with ragged
    lengths (stale NaN rows past them), and over a 4096-row ring (the
    window) with every length past S (index + 1 = 4097..5000: all rows
    valid), in f32 and bf16, each launched twice and compared bitwise.  The
    bf16 S = 512 case is timed beside SDPA and gives the ``zamba_*`` keys of
    K5's record."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import ref

    b, kvh, hd = 8, 32, 64
    out = {}
    for label, s_ in (("zamba2 ragged", 512), ("zamba2 ring", 4096)):
        lo, hi = (1, s_) if s_ == 512 else (s_ + 1, 5000)
        ln = torch.randint(lo, hi + 1, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v = _k5_case(torch, gen, b, s_, kvh, 1, hd, dtype,
                               ln if s_ == 512 else None)
            got = k5.decode_attention(q, k, v, ln)
            again = k5.decode_attention(q, k, v, ln)
            want = ref.decode_attention_ref(q, k, v, ln)
            torch.cuda.synchronize()
            err, rel = max_rel_err(torch, got, want)
            log(f"[kernels] decode_attention {label} {dname} B={b} S={s_} "
                f"KV={kvh} G=1 hd={hd} lengths {int(ln.min())}..{int(ln.max())}"
                f": max_abs_err={err:.3e} rel={rel:.3e} (tol "
                f"{TOL[dname]:.3e}); two launches bitwise equal: "
                f"{bool(torch.equal(got, again))}")
            require(bool(torch.isfinite(got).all()), f"decode_attention "
                    f"{label}: non-finite output")
            require(rel <= TOL[dname], f"decode_attention {label} {dname}: "
                    f"error {rel:.3e} over tolerance")
            require(torch.equal(got, again), f"decode_attention {label} "
                    f"{dname}: two launches differ")
            if s_ != 512 or dtype != torch.bfloat16:
                continue
            plain_ms = timer(lambda: ref.decode_attention_ref(q, k, v, ln))
            qt = q.transpose(1, 2).contiguous()
            kt = k.transpose(1, 2).contiguous().nan_to_num()
            vt = v.transpose(1, 2).contiguous()
            mask = (torch.arange(s_, device="cuda")[None, :]
                    < ln[:, None])[:, None, None, :]
            ms, lib_ms = timer.turns(
                lambda: k5.decode_attention(q, k, v, ln),
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask))
            bound = _k5_bound_ms(b, kvh, kvh, hd, int(ln.sum()),
                                 q.element_size(), dname)
            log(f"[kernels] decode_attention {label} {dname} kernel {ms:.4f} "
                f"ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                f"{bound:.4f} ms (bytes), {100 * bound / ms:.1f}% of it")
            out = {"zamba_max_abs_err": err, "zamba_ms": ms,
                   "zamba_plain_ms": plain_ms, "zamba_bound_ms": bound,
                   "zamba_bound_by": "bytes", "zamba_library_ms": lib_ms}
    return out


SCORE_M = 8192      # masked scoring: B x S = 4 x 2048 tokens into the FFN


def _scoring_k1(torch, timer, gen) -> dict:
    """K1 in bfloat16 at masked scoring's FFN shape (M = 8192, K = 2048,
    N = 8192), a ragged M = 8000 and an M = 100 just past the decode tile,
    with all-ones, rate-0.5 and all-zeros block masks.  The all-ones case at
    M = 8192 is the path's (FedAP at rate 0.5 prunes no whole block) and
    gives the ``scoring_*`` keys of K1's record."""
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.kernels import ref

    kdim, n, dname = TRAIN_K, TRAIN_N, "bfloat16"
    nb = n // 128
    half = torch.zeros(nb, device="cuda")
    half[torch.randperm(nb, generator=gen, device="cuda")[: nb // 2]] = 1.0
    masks = [("ones", torch.ones(nb, device="cuda")), ("rate0.5", half),
             ("zeros", torch.zeros(nb, device="cuda"))]
    w = (torch.randn((kdim, n), generator=gen, device="cuda")
         / kdim ** 0.5).to(torch.bfloat16)
    rec = {}
    for m in (SCORE_M, 8000, 100):
        x = torch.randn((m, kdim), generator=gen,
                        device="cuda").to(torch.bfloat16)
        for label, bm in masks:
            got = k1.masked_matmul(x, w, bm)
            want = ref.masked_matmul_ref(x, w, bm)
            torch.cuda.synchronize()
            err, rel = max_rel_err(torch, got, want)
            log(f"[kernels] masked_matmul {label} {dname} M={m} K={kdim} "
                f"N={n}: max_abs_err={err:.3e} rel={rel:.3e} "
                f"(tol {TOL[dname]:.3e})")
            require(bool(torch.isfinite(got).all()),
                    "masked_matmul: non-finite output")
            require(rel <= TOL[dname], f"masked_matmul {label} {dname} "
                    f"M={m}: error {rel:.3e} over tolerance")
            if label == "zeros":
                require(float(got.float().abs().max()) == 0.0,
                        "masked_matmul: pruned blocks not exactly zero")
            del got, want
            if m != SCORE_M or label == "zeros":
                continue
            ms = timer(lambda: k1.masked_matmul(x, w, bm))
            kept = int((bm > 0).sum())
            bound, by = _mm_bound("fwd", m, kdim, n, kept, x.element_size(),
                                  dname)
            flops = 2 * m * kdim * 128 * kept
            if label != "ones":
                log(f"[kernels] masked_matmul {dname} M={m} kept {kept}/{nb} "
                    f"blocks: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                    f"TFLOP/s), bound {bound:.4f} ms ({by})")
                continue
            plain_ms = timer(lambda: ref.masked_matmul_ref(x, w, bm))
            lib_ms = timer(lambda: torch.matmul(x, w))
            log(f"[kernels] masked_matmul {dname} M={m} kept {kept}/{nb} "
                f"blocks: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                f"TFLOP/s), plain {plain_ms:.4f} ms, torch.matmul "
                f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
            rec = {"scoring_ms": ms, "scoring_plain_ms": plain_ms,
                   "scoring_bound_ms": bound, "scoring_bound_by": by,
                   "scoring_library_ms": lib_ms, "scoring_max_abs_err": err}
    return rec


TRAIN_M, TRAIN_K, TRAIN_N = 512, 2048, 8192   # B x S, d_model, d_ff


def _training_kernels(torch, timer, gen) -> dict:
    """K1, K2 and K3 at the training path's FFN shapes (M = 4 x 128 tokens,
    and a ragged M = 500), float32 (what training runs) and bfloat16, with
    rate-0.5, all-ones and all-zeros block masks.  The all-ones f32 case at
    M = 512 is the path's (FedAP's kept units fill no block's worth of
    pruning) and gives each record; K1 keeps its serving record and adds
    its training time as ``train_*`` keys."""
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.kernels import ref

    kdim, n = TRAIN_K, TRAIN_N
    nb = n // 128
    perm = torch.randperm(nb, generator=gen, device="cuda")
    half = torch.zeros(nb, device="cuda")
    half[perm[: nb // 2]] = 1.0
    one, seven = torch.zeros(nb, device="cuda"), torch.zeros(nb, device="cuda")
    one[perm[:1]] = 1.0                   # fewer kept blocks than K2's splits
    seven[perm[:7]] = 1.0                 # a kept count the splits do not divide
    masks = [("ones", torch.ones(nb, device="cuda")), ("rate0.5", half),
             ("zeros", torch.zeros(nb, device="cuda")), ("one-kept", one),
             ("seven-kept", seven)]
    kernels = {
        "masked_matmul": ("fwd", 122, k1.masked_matmul, ref.masked_matmul_ref,
                          lambda a, b: torch.matmul(a, b)),
        "masked_matmul_dx": ("dx", 142, k1.masked_matmul_dx,
                             ref.masked_matmul_dx_ref,
                             lambda a, b: torch.matmul(a, b.T)),
        "masked_matmul_dw": ("dw", 162, k1.masked_matmul_dw,
                             ref.masked_matmul_dw_ref,
                             lambda a, b: torch.matmul(a.T, b)),
    }
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        w = (torch.randn((kdim, n), generator=gen, device="cuda")
             / kdim ** 0.5).to(dtype)
        for m in (TRAIN_M, 500):
            x = torch.randn((m, kdim), generator=gen, device="cuda").to(dtype)
            dy = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
            operands = {"fwd": (x, w), "dx": (dy, w), "dw": (x, dy)}
            for name, (kind, line, fn, plain, lib) in kernels.items():
                a, b = operands[kind]
                for label, bm in masks:
                    if label.endswith("-kept") and kind != "dx":
                        continue
                    got = fn(a, b, bm)
                    want = plain(a, b, bm)
                    torch.cuda.synchronize()
                    err, rel = max_rel_err(torch, got, want)
                    log(f"[kernels] {name} {label} {dname} M={m} K={kdim} "
                        f"N={n}: max_abs_err={err:.3e} rel={rel:.3e} "
                        f"(tol {TOL[dname]:.3e})")
                    require(bool(torch.isfinite(got).all()),
                            f"{name}: non-finite output")
                    require(rel <= TOL[dname], f"{name} {label} {dname} M={m}"
                            f": error {rel:.3e} over tolerance")
                    if label == "zeros":
                        require(float(got.float().abs().max()) == 0.0,
                                f"{name}: pruned blocks not exactly zero")
                    require(torch.equal(got, fn(a, b, bm)), f"{name} {label} "
                            f"{dname} M={m}: two launches differ")
                    if m != TRAIN_M or label not in ("ones", "rate0.5"):
                        continue
                    if kind == "dx":
                        splits = k1.dx_splits(
                            m, kdim, n, torch.cuda.get_device_properties(
                                0).multi_processor_count)
                        log(f"[kernels] {name} {dname} timed call: {splits} "
                            f"splits, grid ({kdim // k1.DX_COLS}, "
                            f"{-(-m // k1.DX_ROWS)}, {splits}) x 256 threads "
                            f"+ split sum")
                    ms, lib_ms = timer.turns(lambda: fn(a, b, bm),
                                             lambda: lib(a, b))
                    plain_ms = timer(lambda: plain(a, b, bm))
                    kept = int((bm > 0).sum())
                    bound, by = _mm_bound(kind, m, kdim, n, kept,
                                          a.element_size(), dname)
                    log(f"[kernels] {name} {dname} M={m} kept {kept}/{nb} "
                        f"blocks: kernel {ms:.4f} ms "
                        f"({2e-9 * m * kdim * 128 * kept / ms:.1f} TFLOP/s), "
                        f"plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} "
                        f"ms, bound {bound:.4f} ms ({by})")
                    if dtype != torch.float32 or label != "ones":
                        continue
                    rec = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                           "bound_by": by, "library_ms": lib_ms,
                           "max_abs_err": err}
                    if name == "masked_matmul":
                        records[name] = {f"train_{k}": v
                                         for k, v in rec.items()}
                    else:
                        records[name] = {
                            "name": name, "route": "cuda",
                            "source": "src/repro_torch/kernels/csrc/"
                                      "masked_matmul.cu",
                            "replaces": "src/repro/kernels/masked_matmul.py:"
                                        f"{line}", **rec}
    return records


# K4/K6 f32 tolerances: max |kernel - plain| relative to max(1, max |plain|),
# the reference tests' own numbers (tests/test_kernels.py: flash 2e-5, ssd
# 2e-4); the f32 sums run in another order (K6 also in chunks, against the
# sequential definition, its products in 3xTF32 or split bf16 hi + lo).  bf16
# is held per element: both sides compute in f32 from the same bf16 inputs
# and round once to bf16, so |kernel - plain| <= 2^-7 |plain| (one bf16
# step) + the f32 allowance.
SCORE_TOL = {"flash_attention": 2e-5, "ssd_scan": 2e-4}
BF16_STEP = 2.0 ** -7


def _k4_bound(b, sq, skv, h, kvh, hd, causal, window, elt, dtype_name):
    """(bound ms, "bytes" or "operations", flops) from K4's ``work``: q, k,
    v read once and the output written once; 4 flops per visible (query,
    key, head-dim) triple (QK^T and PV), the pairs counted from this
    mask."""
    from repro_torch.kernels import flash_attention as k4

    flops, nbytes = k4.work(b, sq, skv, h, kvh, hd, elt, causal=causal,
                            window=window)
    return (*_bound(flops, nbytes, dtype_name), flops)


def _k4_check(torch, label, dname, got, want, again=None):
    """K4 against its plain version under the scoring rule (f32: SCORE_TOL
    relative to max(1, max |plain|); bf16: per element, one bf16 step of
    |plain| plus that allowance); launched twice when ``again`` is given,
    the two bitwise equal.  Returns max |got - want|."""
    torch.cuda.synchronize()
    err, rel = max_rel_err(torch, got, want)
    tol = SCORE_TOL["flash_attention"]
    wantf = want.float()
    allowed = (BF16_STEP * wantf.abs() if dname == "bfloat16" else 0) \
        + tol * max(1.0, float(wantf.abs().max()))
    worst = float(((got.float() - wantf).abs() / allowed).max())
    same = again is None or bool(torch.equal(got, again))
    log(f"[kernels] flash_attention {label} {dname}: max_abs_err={err:.3e} "
        f"rel={rel:.3e}; |err| / allowance <= {worst:.3f} (limit 1)"
        + ("" if again is None else f"; two launches bitwise equal: {same}"))
    require(bool(torch.isfinite(got).all()) and worst <= 1.0,
            f"flash_attention {label} {dname}: error over tolerance")
    require(same, f"flash_attention {label} {dname}: two launches differ")
    return err


def _k6_bound(b, s, nh, p, n, elt, dtype_name):
    """(bound ms, "bytes" or "operations", flops) of the function, not of
    one way to compute it (K6's ``work``): x, B, C, dt read and y written
    once; the sequential recurrence's 4 B S nh p N flops at the type's
    peak."""
    from repro_torch.kernels import ssd_scan as k6

    flops, nbytes = k6.work(b, s, nh, p, n, elt)
    return (*_bound(flops, nbytes, dtype_name), flops)


def _scoring_kernels(torch, timer, gen) -> dict:
    """K4 and K6 at the scoring path's shapes against their plain versions:
    K4 at olmo-1b's (B=4, S=2048, 16 heads of 128, causal; f32 and bf16) and
    zamba2's (B=1, S=8192, 32 heads of 64, window 4096; f32 and bf16), a
    ragged S and a GQA case; K6 at zamba2's (B=1, S=8192, nh=64, p=64,
    N=64, chunk 256; f32 and bf16), a slow-decay f32 case whose state spans
    hundreds of steps, and a ragged S.  The bf16 olmo-1b K4 case and the
    bf16 K6 case give the records; zamba2's K4 adds ``zamba_*`` keys."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as k6

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def check(name, label, dname, got, want):
        torch.cuda.synchronize()
        err, rel = max_rel_err(torch, got, want)
        tol = SCORE_TOL[name]
        if dname == "float32":
            worst = rel / tol
            text = f"rel={rel:.3e} (tol {tol:.0e})"
        else:
            wantf = want.float()
            allowed = BF16_STEP * wantf.abs() + tol * max(
                1.0, float(wantf.abs().max()))
            worst = float(((got.float() - wantf).abs() / allowed).max())
            text = (f"rel={rel:.3e}; per element |err| / (2^-7 |plain| + "
                    f"{tol:.0e} max(1, max |plain|)) <= {worst:.3f} (limit 1)")
            del wantf, allowed
        log(f"[kernels] {name} {label} {dname}: max_abs_err={err:.3e} {text}")
        require(bool(torch.isfinite(got).all()), f"{name} {label}: "
                f"non-finite output")
        require(got.dtype == want.dtype and got.shape == want.shape,
                f"{name} {label}: {got.dtype} {tuple(got.shape)} against "
                f"{want.dtype} {tuple(want.shape)}")
        require(worst <= 1.0, f"{name} {label} {dname}: error over "
                f"tolerance ({text})")
        return err

    records = {}
    # label, B, S, H, KV, hd, window, dtypes, timed
    k4_cases = [("olmo-1b", 4, 2048, 16, 16, 128, None,
                 (torch.float32, torch.bfloat16), True),
                ("zamba2-1.2b", 1, 8192, 32, 32, 64, 4096,
                 (torch.float32, torch.bfloat16), True),
                ("ragged-S=1000", 2, 1000, 16, 16, 128, None,
                 (torch.float32, torch.bfloat16), False),
                ("gqa-16:4", 2, 1024, 16, 4, 128, None,
                 (torch.float32, torch.bfloat16), False)]
    for label, b, s, h, kvh, hd, window, dtypes, timed in k4_cases:
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            q = randn(b, s, h, hd, dtype=dtype)
            k = randn(b, s, kvh, hd, dtype=dtype)
            v = randn(b, s, kvh, hd, dtype=dtype)
            got = k4.flash_attention(q, k, v, causal=True, window=window)
            want = ref.flash_attention_ref(q, k, v, causal=True,
                                           window=window)
            err = check("flash_attention",
                        f"{label} B={b} S={s} H={h} KV={kvh} hd={hd} "
                        f"window={window}", dname, got, want)
            del got, want
            if not timed or dtype != torch.bfloat16:
                continue
            ms = timer(lambda: k4.flash_attention(q, k, v, causal=True,
                                                  window=window))
            plain_ms = timer(lambda: ref.flash_attention_ref(
                q, k, v, causal=True, window=window))
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            if window is None:
                lib_ms = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
            else:
                mask = ref.visible(s, s, causal=True, window=window,
                                   device="cuda")
                lib_ms = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask))
            bound, by, flops = _k4_bound(b, s, s, h, kvh, hd, True, window,
                                         q.element_size(), dname)
            log(f"[kernels] flash_attention {label} {dname}: kernel {ms:.4f} "
                f"ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} "
                f"ms, sdpa {lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
            rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": by, "library_ms": lib_ms}
            if label == "olmo-1b":
                records["flash_attention"] = {
                    "name": "flash_attention", "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              "flash_attention.cu",
                    "replaces": "src/repro/kernels/flash_attention.py:102",
                    **rec}
            else:
                records["flash_attention"].update(
                    {f"zamba_{key}": val for key, val in rec.items()})
            del qt, kt, vt

    # label, B, S, nh, p, dtypes, timed; N of zamba2 and the reference's
    # chunk (the kernel runs its own, ssd_scan.KERNEL_CHUNK, which the CPU
    # replay of its schedule uses).  With dt and dt_bias ~ N(0, 1) most
    # heads forget within a few steps; the slow-decay case (a_log 0,
    # dt_bias from -7 to -3 over the heads, softplus 1e-3..5e-2 a step, dt
    # 0.5 N(0, 1)) keeps the state for 20 to 1000 steps, so the state
    # carried across chunks counts.  S = 100 is one partial chunk (no state
    # passed).  p = 32 and 96 run the sub-heads of 64 columns of p with a
    # zero-filled part.  Each case runs twice: the kernel sums in a fixed
    # order, so the two agree bit for bit.
    for dtype, q in k6.KERNEL_CHUNK.items():
        require(k6.library_chunk(dtype) == q, f"ssd_scan: the library runs "
                f"{dtype} in chunks of {k6.library_chunk(dtype)}, the CPU "
                f"replay in chunks of {q}")
    n, chunk = 64, 256
    both = (torch.float32, torch.bfloat16)
    f32 = {}
    for label, b, s, nh, p, dtypes, timed in (
            ("zamba2-1.2b", 1, 8192, 64, 64, both, True),
            ("zamba2-1.2b slow-decay", 1, 8192, 64, 64, (torch.float32,),
             False),
            ("ragged-S=1000", 2, 1000, 64, 64, both, False),
            ("S=100 < chunk", 2, 100, 64, 64, both, False),
            ("head dim 32", 2, 1000, 8, 32, both, False),
            ("head dim 96", 2, 1000, 8, 96, both, False)):
        slow = "slow-decay" in label
        for dtype in dtypes:
            dname = str(dtype).split(".")[-1]
            args = (randn(b, s, nh, p, dtype=dtype), randn(b, s, n, dtype=dtype),
                    randn(b, s, n, dtype=dtype),
                    (0.5 if slow else 1.0) * randn(b, s, nh, dtype=dtype),
                    (0.0 if slow else 0.1) * randn(nh, dtype=torch.float32),
                    randn(nh, dtype=torch.float32),
                    torch.linspace(-7.0, -3.0, nh, device="cuda") if slow
                    else randn(nh, dtype=torch.float32))
            got = k6.ssd_scan(*args, chunk=chunk)
            want = ref.ssd_scan_ref(*args)
            err = check("ssd_scan", f"{label} B={b} S={s} nh={nh} p={p} "
                        f"N={n} chunk {k6.KERNEL_CHUNK[dtype]}", dname, got,
                        want)
            again = k6.ssd_scan(*args, chunk=chunk)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"ssd_scan {label} {dname}: two "
                    f"launches differ")
            del got, want, again
            if not timed:
                continue
            ms = timer(lambda: k6.ssd_scan(*args, chunk=chunk))
            bound, by, flops = _k6_bound(b, s, nh, p, n,
                                         args[0].element_size(), dname)
            log(f"[kernels] ssd_scan {label} {dname}: kernel {ms:.4f} ms, "
                f"bound {bound:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP of the "
                f"sequential recurrence), {100 * bound / ms:.1f}% of it")
            if dtype == torch.float32:
                f32 = {"f32_ms": ms, "f32_bound_ms": bound, "f32_bound_by": by}
                continue
            plain_ms = timer(lambda: ref.ssd_scan_ref(*args))
            log(f"[kernels] ssd_scan {label} {dname}: plain {plain_ms:.4f} "
                f"ms, library none (no single PyTorch call computes it)")
            records["ssd_scan"] = {
                "name": "ssd_scan", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
                "replaces": "src/repro/kernels/ssd_scan.py:84",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": None, **f32}
    # apply_mamba2's inputs: torch.split views of its conv output (x, B, C)
    # and fused projection (dt), read in place, bit for bit as contiguous
    # copies
    b, s, nh, p = 2, 1000, 64, 64
    for dtype in both:
        xi, bm, cm = torch.split(randn(b, s, nh * p + 2 * n, dtype=dtype),
                                 [nh * p, n, n], dim=-1)
        dt = randn(b, s, 2 * nh * p + 2 * n + nh, dtype=dtype)[..., -nh:]
        views = (xi.reshape(b, s, nh, p), bm, cm, dt)
        rows = k6.row_strides(*views)
        require(rows is not None, "ssd_scan: the split views are not read in "
                "place")
        rest = (0.1 * randn(nh, dtype=torch.float32),
                randn(nh, dtype=torch.float32), randn(nh, dtype=torch.float32))
        got = k6.ssd_scan(*views, *rest)
        want = k6.ssd_scan(*(t.contiguous() for t in views), *rest)
        torch.cuda.synchronize()
        require(torch.equal(got, want), f"ssd_scan {dtype}: split views and "
                f"contiguous copies differ")
        log(f"[kernels] ssd_scan split views {str(dtype).split('.')[-1]} "
            f"B={b} S={s}: row strides {rows}, equal to contiguous inputs")
        del got, want, views, xi, bm, cm, dt
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
    rng = torch.Generator().manual_seed(2)  # lint: generator-ok (params and batch: two fixed inputs)
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


HYBRID_STEPS = 72   # decode steps of the hybrid parity: past a 64-row ring


def phase_hybrid_parity(torch) -> None:
    """zamba2 at full width, 6 layers (one group: the shared attention and
    six Mamba2 layers), f32, B = 2: teacher-forced decode of 80 seeded
    tokens on the card (K5, K1 when masked) against the same port code on
    the CPU (plain versions), logits at every step, in three runs: dense
    with the model's 4096-token window (80 cache rows); dense with
    ``sliding_window=64`` in a copy of the config, so that the steps cross
    into the ring (a correctness check of the ring regime, not a
    measurement); and masked at rate 0.5 on that ring, beside the shrunk
    model on the card."""
    import dataclasses

    import numpy as np

    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.models.lm import LM

    base = dataclasses.replace(get_config("zamba2-1.2b"), num_layers=6,
                               param_dtype="float32")
    cpu = LM(base, device="cpu")
    params_c = cpu.init(torch.Generator().manual_seed(6))
    params_g = interop.params_from_jax(params_c, "cuda")
    kept = cpu.decide_kept(params_c, 0.5)
    masks_c = cpu.filter_masks(params_c, kept)
    masks_g = interop.masks_from_jax(masks_c, "cuda")
    b = 2
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, base.vocab_size, (b, HYBRID_STEPS)).astype(np.int32))
    ring = dataclasses.replace(base, sliding_window=64)
    shrunk = LM(dataclasses.replace(ring, d_ff=int(kept["mlp"].shape[1])),
                device="cuda")
    shrunk_g = shrunk.shrink_params(params_g, kept)
    for label, cfg, masked in (("dense window 4096", base, False),
                               ("dense ring 64", ring, False),
                               ("masked ring 64", ring, True)):
        cpu, gpu = LM(cfg, device="cpu"), LM(cfg, device="cuda")
        # the masked run also decodes the shrunk model on the card
        twin = shrunk if masked else None
        caches = {"cpu": cpu.init_cache(b, HYBRID_STEPS),
                  "card": gpu.init_cache(b, HYBRID_STEPS),
                  "twin": twin.init_cache(b, HYBRID_STEPS) if twin else None}
        rows = caches["card"]["shared_attn"]["k"].shape[2]
        worst = {"card~cpu": (0.0, 0.0, -1), "masked~shrunk card":
                 (0.0, 0.0, -1)}
        counts = [0, 0]
        with torch.inference_mode():
            for t in range(HYBRID_STEPS):
                tok = tokens[:, t:t + 1]
                want, caches["cpu"] = cpu.decode_step(
                    params_c, caches["cpu"], {"tokens": tok},
                    masks=masks_c if masked else None)
                k5.launches = k1.launches = 0
                got, caches["card"] = gpu.decode_step(
                    params_g, caches["card"], {"tokens": tok.cuda()},
                    masks=masks_g if masked else None)
                counts[0] += k5.launches
                counts[1] += k1.launches
                pairs = [("card~cpu", got.cpu(), want)]
                if twin is not None:
                    other, caches["twin"] = twin.decode_step(
                        shrunk_g, caches["twin"], {"tokens": tok.cuda()})
                    pairs.append(("masked~shrunk card", got.cpu(),
                                  other.cpu()))
                require(bool(torch.isfinite(got).all()),
                        f"hybrid-parity {label}: non-finite logits")
                for key, a, ref_ in pairs:
                    err, rel = max_rel_err(torch, a, ref_)
                    if rel >= worst[key][1]:
                        worst[key] = (err, rel, t)
        for key, (err, rel, t) in worst.items():
            if t < 0:
                continue
            log(f"[hybrid-parity] zamba2 full width, {cfg.num_layers} "
                f"layers, f32, B={b}, {label}, {key}: {HYBRID_STEPS} steps "
                f"over {rows} cache rows (ring from step {rows}); worst step "
                f"{t} max_abs_err={err:.3e} rel={rel:.3e} (tol "
                f"{PARITY_TOL:.0e})")
            require(rel <= PARITY_TOL, f"hybrid-parity {label} {key}: "
                    f"{rel:.3e} over tolerance at step {t}")
        groups = len(gpu.hybrid_groups())
        log(f"[hybrid-parity] {label}: launches decode_attention={counts[0]} "
            f"masked_matmul={counts[1]} (the card model's steps)")
        require(counts == [HYBRID_STEPS * groups, HYBRID_STEPS * 2 *
                           cfg.num_layers if masked else 0],
                f"hybrid-parity {label}: launches K5, K1 {counts}")
        del caches


# ---------------------------------------------------------------------------
# phase 5: the training path on the card against the CPU, float32
# ---------------------------------------------------------------------------

TRAIN_TOL = 1e-4   # f32, relative to max |cpu| per leaf (a gradient or a
                   # round's parameter update): products of 2048 to 50304
                   # terms summed in another order, through 2 layers
# A round's update is a difference of f32 parameters, and FedDU's g0 =
# (w_half - w_end) / (tau lr) divides one by tau lr, so the two devices'
# updates also differ by the parameters' own rounding: each leaf is allowed
# TRAIN_TOL of its max |update| plus ROUND_ULPS spacings of f32 at its
# max |param|.
ROUND_ULPS = 4


def _ratio(err, scale):
    """err / scale, where a zero scale allows only a zero error."""
    return err / scale if scale > 0 else (0.0 if err == 0 else math.inf)


def _leaf_errs(got, want):
    """[(max |got - want|, max |want|)] per leaf of two trees."""
    from repro_torch.utils.tree import tree_leaves

    return [(float((g.detach().cpu().double() - w.double()).abs().max()),
             float(w.double().abs().max()))
            for g, w in zip(tree_leaves(got), tree_leaves(want))]


def phase_train_parity(torch) -> None:
    """olmo-1b, then zamba2 (2 layers: one shared-attention group, its FFNs
    through K1-K3), each at full width in f32."""
    for arch, seed in (("olmo-1b", 3), ("zamba2-1.2b", 7)):
        _train_parity(torch, arch, seed)


def _train_parity(torch, arch, seed) -> None:
    import dataclasses

    import numpy as np

    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.core import backend, engine
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models.lm import LM
    from repro_torch.utils.tree import tree_map

    cfg = dataclasses.replace(get_config(arch), num_layers=2,
                              param_dtype="float32", remat="none")
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg, device="cuda")
    params_c = cpu.init(torch.Generator().manual_seed(seed))
    params_g = interop.params_from_jax(params_c, "cuda")
    # layer 0 keeps its first 32 of 64 FFN blocks whole (the kernels skip
    # the other 32); layer 1 keeps FedAP's weight-norm choice at rate 0.5
    kept = cpu.decide_kept(params_c, 0.5)
    kept["mlp"][0] = np.arange(cfg.d_ff // 2)
    fm_c = cpu.filter_masks(params_c, kept)
    fm_g = interop.masks_from_jax(fm_c, "cuda")
    blocks = fm_c["mlp"].reshape(cfg.num_layers, -1, 128).amax(-1)
    rng = np.random.default_rng(5)
    b, s_len = 2, 32
    x = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s_len))
                         .astype(np.int32))
    y = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s_len))
                         .astype(np.int32))
    log(f"[train-parity] {arch} d_model={cfg.d_model} d_ff={cfg.d_ff} "
        f"L={cfg.num_layers} f32, B={b} S={s_len}; "
        f"{int((blocks == 0).sum())}/{blocks.numel()} FFN blocks fully pruned")

    (l_c, _), g_c = engine.value_and_grad_aux(
        lambda p: cpu.loss_and_acc(p, x, y, masks=fm_c), params_c)
    (l_g, _), g_g = engine.value_and_grad_aux(
        lambda p: gpu.loss_and_acc(p, x.cuda(), y.cuda(), masks=fm_g),
        params_g)
    errs = _leaf_errs(g_g, g_c)
    worst = max(e / m if m > 0 else e for e, m in errs)
    log(f"[train-parity] {arch} masked loss card {float(l_g):.6f} cpu "
        f"{float(l_c):.6f}; {len(errs)} gradient leaves, worst error "
        f"{worst:.3e} relative to the leaf's max |grad| (tol {TRAIN_TOL:.0e})")
    require(abs(float(l_g) - float(l_c)) <= TRAIN_TOL * max(1.0, abs(float(l_c))),
            f"train-parity {arch}: masked loss differs")
    require(worst <= TRAIN_TOL,
            f"train-parity {arch}: gradient error {worst:.3e}")
    del g_c, g_g

    # one round: 2 clients x 1 local step and 1 server step, each on B x S
    eng = EngineConfig(lr=3e-3, lr_decay=1.0, use_server_update=True,
                       local_momentum="restart", server_momentum=True,
                       use_masks=True, masked_compute="kernel")

    def toks(*lead):
        t = rng.integers(0, cfg.vocab_size, lead + (s_len + 1,))
        return (torch.from_numpy(t[..., :-1].astype(np.int32)),
                torch.from_numpy(t[..., 1:].astype(np.int32)))

    batch_c = {"client": toks(2, 1, b), "sizes": torch.tensor([8.0, 8.0]),
               "server": toks(1, b), "d_round": torch.tensor(0.3),
               "d_server": torch.tensor(0.02), "n0": torch.tensor(8.0)}
    deltas = {}
    for name, model, params, fm in (("cpu", cpu, params_c, fm_c),
                                    ("card", gpu, params_g, fm_g)):
        dev = "cpu" if name == "cpu" else "cuda"
        state = engine.init_round_state(
            tree_map(torch.clone, params), eng,
            filter_masks=model.filter_masks(params, {}))
        backend.masked_round_state(state, model.param_masks(params, kept),
                                   filter_masks=fm)
        before = tree_map(torch.clone, state["params"])
        grad_fn, la_fn = backend.model_fns(model, eng)
        state, met = engine.round_core(
            eng, grad_fn, la_fn, state,
            tree_map(lambda t: t.to(dev), batch_c))
        deltas[name] = tree_map(lambda a, b_: (a - b_).cpu(), state["params"],
                                before)
        log(f"[train-parity] {arch} one FedDUMAP round on the {name}: "
            f"tau_eff {float(met['tau_eff']):.6f}, server acc "
            f"{float(met['server_acc']):.4f}")
        del state, before
    _round_update_check(torch, f"[train-parity] {arch}", deltas, params_c)


def _round_update_check(torch, tag, deltas, params_c) -> None:
    """The card's round update against the CPU's (``deltas["card"]``,
    ``deltas["cpu"]``, trees on the host), each leaf within TRAIN_TOL of
    its max |update| plus ROUND_ULPS f32 spacings at its max |param|."""
    from repro_torch.utils.tree import tree_leaves

    eps = torch.finfo(torch.float32).eps
    ulp = [eps * float(t.abs().max()) for t in tree_leaves(params_c)]
    errs = _leaf_errs(deltas["card"], deltas["cpu"])
    rel = max(e / m if m > 0 else e for e, m in errs)
    # zamba2's A_log and dt_bias start at 0: no spacing to count there
    ulps = max((e / u for (e, _), u in zip(errs, ulp) if u > 0), default=0)
    worst = max(_ratio(e, TRAIN_TOL * m + ROUND_ULPS * u)
                for (e, m), u in zip(errs, ulp))
    log(f"{tag} round parameter updates ({len(errs)} "
        f"leaves): worst error {rel:.3e} relative to the leaf's max |update|, "
        f"{ulps:.2f} f32 spacings at the leaf's max |param|; worst error / "
        f"allowance ({TRAIN_TOL:.0e} x max |update| + {ROUND_ULPS} spacings) "
        f"= {worst:.3f}")
    require(worst <= 1.0, f"{tag}: round update error {worst:.3f} of its "
            f"allowance")


# ---------------------------------------------------------------------------
# phase 6: FedDUMAP training of olmo-1b and zamba2 at full width on the card
# ---------------------------------------------------------------------------

def phase_training(torch, arch="olmo-1b", num_layers=None) -> dict:
    """A FedDUMAP run of ``arch`` (at ``num_layers``, else all its layers),
    full width, f32.  Returns {kernel name: launches over the plan's
    run}."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.plan import fedap_plan
    from repro_torch.core.pruning import FedAPConfig
    from repro_torch.core.rounds import FederatedTrainer, feddumap_config
    from repro_torch.data.pipeline import build_lm_federated_data
    from repro_torch.data.synthetic import TokenSpec
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.models.lm import LM
    from repro_torch.utils.tree import tree_leaves, tree_size

    cfg = dataclasses.replace(get_config(arch), param_dtype="float32",
                              remat="none")
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    tag = f"[training] {arch.removesuffix('-1.2b')}"
    model = LM(cfg, device="cuda")
    data = build_lm_federated_data(
        num_clients=4, server_fraction=0.25,
        spec=TokenSpec(vocab_size=cfg.vocab_size, num_topics=8, seq_len=129,
                       num_sequences=45))
    fl = feddumap_config(num_clients=4, clients_per_round=2, batch_size=4,
                         server_batch_size=4, local_epochs=1, lr=3e-3,
                         lr_decay=1.0, masked_compute="kernel",
                         fedap=FedAPConfig(align=128, min_rate=0.5,
                                           probe_size=4, participants=2))
    trainer = FederatedTrainer(model, data, fl, device="cuda")
    backend = trainer.backend(use_masks=True)
    kw = backend.sample_kw
    seq = data.client_x.shape[-1]
    grads_per_round = (kw["clients_per_round"] * kw["local_steps"]
                       + kw["server_tau"])
    tokens_per_round = seq * (kw["clients_per_round"] * kw["local_steps"]
                              * kw["batch_size"]
                              + kw["server_tau"] * kw["server_batch"])
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    log(f"{tag} full width f32: {cfg.num_layers} layers, "
        f"{tree_size(params) / 1e9:.3f} B params; n_k="
        f"{data.client_x.shape[1]}, n0={data.server_x.shape[0]}, S={seq}; "
        f"per round {kw['clients_per_round']} clients x {kw['local_steps']} "
        f"local steps of B={kw['batch_size']} + tau={kw['server_tau']} server "
        f"steps of B={kw['server_batch']}: {grads_per_round} gradient "
        f"evaluations, {tokens_per_round} tokens")
    rounds = 4
    plan = fedap_plan(rounds, prune_round=2, mode="mask")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = k1.dx_launches = k1.dw_launches = 0
    t0 = time.perf_counter()
    res = trainer.run(plan, params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"masked_matmul": k1.launches,
                "masked_matmul_dx": k1.dx_launches,
                "masked_matmul_dw": k1.dw_launches}
    del params
    h = res.history
    if arch == "olmo-1b" and num_layers is None:
        # the [mesh] phase holds its world-of-one run to this one
        LOCAL_RUN.update(
            history={k: list(v) for k, v in h.items() if k != "time"},
            params=[t.cpu() for t in tree_leaves(res.params)],
            kept=res.artifacts["prune"]["kept_counts"],
            launches=dict(launches), plan_s=wall, rounds=rounds)
    for r, loss, acc, tau, t in zip(h["round"], h["loss"], h["acc"],
                                    h["tau_eff"], h["time"]):
        log(f"{tag} round {r}: test loss {loss:.6f} acc {acc:.4f} "
            f"tau_eff {tau:.6f} at {t:.3f} s on the host clock")
    art = res.artifacts["prune"]
    fmask = res.state["filter_masks"]["mlp"]
    blocks = fmask.reshape(cfg.num_layers, -1, 128).amax(-1)
    log(f"{tag} prune at round 2: p*={art['p_star']:.6f}, kept "
        f"{art['kept_counts']} of {cfg.d_ff} units per layer, "
        f"{int((blocks == 0).sum())}/{blocks.numel()} FFN column blocks fully "
        f"pruned; plan ran in {wall:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    want = rounds * grads_per_round * 2 * cfg.num_layers
    log(f"{tag} launches masked_matmul={launches['masked_matmul']} "
        f"dx={launches['masked_matmul_dx']} dw={launches['masked_matmul_dw']}"
        f" (expected {rounds} rounds x {grads_per_round} gradient evaluations"
        f" x 2 products x {cfg.num_layers} layers = {want}: "
        f"{want // rounds} each a round)")
    require(all(n == want for n in launches.values()),
            f"{tag}: kernel launches {launches}, expected {want} each")
    require(len(h["loss"]) == rounds and all(
        math.isfinite(v) for k in ("loss", "acc", "tau_eff") for v in h[k]),
        f"{tag}: history not finite")
    kept = art["kept_counts"]["mlp"]
    require(kept < cfg.d_ff and bool(
        (fmask.sum(1) == kept).all()), f"{tag}: the prune was not applied")

    # steady-state rounds on the pruned state: two timed on the host clock,
    # one under the profiler
    state = res.state
    t0 = time.perf_counter()
    state, _ = backend.run_rounds(state, rounds, 2)
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / 2
    log(f"{tag} steady state: {round_s:.3f} s/round -> "
        f"{1 / round_s:.3f} rounds/s, {tokens_per_round / round_s:.1f} "
        f"tokens/s trained")
    if arch == "olmo-1b" and num_layers is None:
        LOCAL_RUN["steady_s"] = round_s
    _profile_round(torch, backend, state, rounds + 2, round_s,
                   tag.replace("[training]", "training"))
    del res, state, trainer, backend
    return launches


def _profile_round(torch, backend, state, t, round_s, label) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        backend.run_rounds(state, t, 1)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and e.self_device_time_total > 0]
    if not kernels:
        log(f"[profile] {label}: device time not measured (the profiler "
            f"saw no CUDA kernels)")
        return None
    dev_s = sum(e.self_device_time_total for e in kernels) / 1e6
    busy = 100 * dev_s / round_s
    log(f"[profile] {label}: round {round_s:.3f} s on the host clock, "
        f"kernels {dev_s:.3f} s on the device -> busy {busy:.1f}%, idle "
        f"{100 - busy:.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile] {label}:   {e.self_device_time_total / 1e6:8.4f} "
            f"s/round  {e.count:5d}/round  {e.key[:90]}")


# ---------------------------------------------------------------------------
# phase 7: serving olmo-1b at full width on the card
# ---------------------------------------------------------------------------

def phase_serving(torch) -> dict:
    """Returns {kernel name: launches over the three modes' runs}."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.models.lm import LM
    from repro_torch.serving import DecodeEngine, ServeConfig, load_servable
    from repro_torch.utils.tree import tree_size

    cfg = get_config("olmo-1b")
    model = LM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    kept = model.decide_kept(params, 0.5)
    n_params = tree_size(params)
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
    kernel_ms = {}
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
        if mode == "masked":    # the mesh phase's serving run matches it
            SERVING_RUN.update(done=[(c.uid, c.tokens.tolist(), c.status)
                                     for c in done], steps=eng.steps,
                               launches={"decode_attention": n5,
                                         "masked_matmul": n1},
                               prompts=prompts, scfg=scfg)
        kernel_ms[mode] = _profile_wave(torch, mode, sv, scfg, prompts)
        if mode == "masked":
            _sync_free_wave(torch, sv, scfg, prompts)
        del sv, eng
    same = np.mean([np.mean(a == b) for a, b in zip(tokens_by_mode["masked"],
                                                   tokens_by_mode["shrunk"])])
    log(f"[serving] masked and shrunk agree on {100 * same:.1f}% of tokens "
        f"(bf16 rounding differs between the two products)")
    for mode, ms in kernel_ms.items():
        log(f"[profile] kernel time per step: {mode} "
            + ("not measured" if ms is None else f"{ms:.3f} ms")
            + (f" ({100 * (ms / kernel_ms['dense'] - 1):+.1f}% against dense)"
               if ms is not None and kernel_ms["dense"] and mode != "dense"
               else ""))
    return launches


def _eager_programs(eng):
    """``eng`` with its admit and wave programs made eager: the bodies its
    captures hold, run op by op (keys still counted)."""
    from repro_torch.core.programs import Program

    eng._admit_program = Program(eng._admit_body, name="admit",
                                 device=eng.device, capture=False)
    eng._wave_program = Program(eng._wave_body, name="wave",
                                device=eng.device, capture=False)
    return eng


def _eager_rounds(backend):
    """``backend`` with its round program made eager (keys still
    counted)."""
    from repro_torch.core.programs import Program

    backend.chunk = Program(backend._round_body, name="round",
                            device=backend.device, capture=False)
    return backend


def _capture_wave(eng):
    """Capture ``eng``'s wave program now (a program captures at its second
    call), so that the next wave is a replay: a capture synchronizes."""
    eng._wave_program.lower(eng._state, eng._params, eng._masks)
    return eng


def _full_engine(torch, sv, scfg, prompts, eager=False):
    """An engine with every slot admitted and one wave run, its wave then
    captured unless ``eager``."""
    from repro_torch.serving import DecodeEngine

    eng = DecodeEngine(sv.model, sv.params, scfg, masks=sv.masks,
                       device="cuda")
    if eager:
        _eager_programs(eng)
    for p in prompts[: scfg.slots]:
        eng.submit(p)
    eng.step_wave()
    if not eager:
        _capture_wave(eng)
    torch.cuda.synchronize()
    return eng


def _profile_wave(torch, mode, sv, scfg, prompts):
    """Where a decode step's time goes: the host-clock time of one eager
    wave (no profiler), and the device time of the kernels of another eager
    wave under torch.profiler — their ratio is the eager wave's busy share
    (the captured wave's is in the [capture] lines).  Returns the kernel ms
    per step, or None where the profiler saw no kernels."""
    from torch.profiler import ProfilerActivity, profile

    eng = _full_engine(torch, sv, scfg, prompts, eager=True)
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
        return None
    busy = 100 * dev_ms / wall_ms
    n = scfg.steps_per_wave
    log(f"[profile] {mode}: wave {wall_ms:.3f} ms/step on the host clock, "
        f"kernels {dev_ms:.3f} ms/step on the device -> busy {busy:.1f}%, "
        f"idle {100 - busy:.1f}%; {sum(e.count for e in kernels) / n:.0f} "
        f"kernel launches a step")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    own = [e for e in ranked[6:] if "decode_" in e.key or "masked_" in e.key]
    for e in ranked[:6] + own:
        log(f"[profile] {mode}:   {e.self_device_time_total / 1e3 / n:8.4f} "
            f"ms/step  {e.count // n:4d}/step  {e.key[:90]}")
    return dev_ms


def _sync_free_wave(torch, sv, scfg, prompts) -> None:
    """One eager wave and one replay of the captured wave under sync-debug
    "error": any host sync inside the decode steps raises.  (The capture
    itself synchronizes on entry, so the engine captures first.)"""
    for eager in (True, False):
        eng = _full_engine(torch, sv, scfg, prompts, eager=eager)
        replays = eng._wave_program.replays
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._wave()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        require(eager or eng._wave_program.replays == replays + 1,
                "the checked wave was not a replay")
    log(f"[serving] one eager wave and one captured replay "
        f"({scfg.steps_per_wave} steps each) ran under "
        f"set_sync_debug_mode('error') without a host sync")


# ---------------------------------------------------------------------------
# phase 9: the captured programs (CUDA graphs) against their eager bodies
# ---------------------------------------------------------------------------

CAPTURE_TURNS = 2           # waves an engine runs in a timed turn
CAPTURE_ROUNDS = 3          # rounds each backend runs before the turns
CAPTURE_OLMO_LAYERS = 8     # olmo-1b's captured round: two states must fit


def _graph_ms(torch, run) -> float:
    """Device ms of ``run()`` (one replay) between two CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _capture_serving(torch, label, sv, scfg, prompts) -> dict:
    """The engine with captured programs against the same engine with its
    eager bodies: completions token for token, K1 and K5 launches equal,
    program counts {"admit": 1, "wave": 1}, replays clean under sync-debug
    "error", ms/step of waves in turns, the device's busy share (one
    replay's device time over each path's host-clock time) and peaks.
    Returns {kernel: launches} of the captured engine's run (its counts
    are set to 0 just before it)."""
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.serving import DecodeEngine

    tag = f"[capture] {label}"
    runs = {}
    for captured in (False, True):
        eng = DecodeEngine(sv.model, sv.params, scfg, masks=sv.masks,
                           device="cuda")
        if not captured:
            _eager_programs(eng)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        k5.launches = k1.launches = 0
        t0 = time.perf_counter()
        done = eng.run(prompts)
        torch.cuda.synchronize()
        runs[captured] = dict(
            done=[(c.uid, c.tokens.tolist(), c.status) for c in done],
            launches=(k5.launches, k1.launches), steps=eng.steps,
            wall=time.perf_counter() - t0, counts=eng.program_counts(),
            replays=eng._wave_program.replays,
            peak=torch.cuda.max_memory_reserved() / 2**30)
        del eng
    e, c = runs[False], runs[True]
    log(f"{tag}: {len(prompts)} requests, {c['steps']} steps: captured "
        f"completions {'equal' if c['done'] == e['done'] else 'DIFFER'} "
        f"token for token to the eager body's; launches K5/K1 captured "
        f"{c['launches']} eager {e['launches']}; program_counts "
        f"{c['counts']}, {c['replays']} wave replays (the first wave eager, "
        f"the second captured); whole run "
        f"{e['wall']:.3f} s eager, {c['wall']:.3f} s captured (capture "
        f"included); peak reserved {e['peak']:.2f} GiB eager, "
        f"{c['peak']:.2f} captured; {CARD}")
    require(c["done"] == e["done"] and c["steps"] == e["steps"],
            f"{tag}: captured completions differ from the eager body's")
    require(c["launches"] == e["launches"],
            f"{tag}: K5/K1 launches {c['launches']} against {e['launches']}")
    require(c["counts"] == {"admit": 1, "wave": 1}
            and c["replays"] == c["steps"] // scfg.steps_per_wave - 1,
            f"{tag}: programs {c['counts']}, {c['replays']} replays")

    engines = {eager: _full_engine(torch, sv, scfg, prompts, eager=eager)
               for eager in (True, False)}
    eng = engines[False]
    replays = eng._wave_program.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._wave()
        eng._wave()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    require(eng._wave_program.replays == replays + 2,
            f"{tag}: the sync-checked waves were not replays")
    ms = {True: [], False: []}
    for eager in (True, False, False, True):
        e = engines[eager]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CAPTURE_TURNS):
            e.step_wave()
        torch.cuda.synchronize()
        ms[eager].append(1e3 * (time.perf_counter() - t0)
                         / (CAPTURE_TURNS * scfg.steps_per_wave))
    dev = _graph_ms(torch, eng._wave) / scfg.steps_per_wave
    me, mc = sum(ms[True]) / 2, sum(ms[False]) / 2
    log(f"{tag}: two replays under set_sync_debug_mode('error') without a "
        f"host sync; ms/step in turns (eager, captured, captured, eager; "
        f"{CAPTURE_TURNS} waves of {scfg.steps_per_wave} steps each): eager "
        f"{me:.3f} {[round(t, 3) for t in ms[True]]}, captured {mc:.3f} "
        f"{[round(t, 3) for t in ms[False]]} ({me / mc:.2f}x); a replay's "
        f"device time {dev:.3f} ms/step -> busy {100 * dev / me:.1f}% "
        f"eager, {100 * dev / mc:.1f}% captured; {CARD}")
    del engines, eng
    gc.collect()                # the captured engines' graphs and pools
    torch.cuda.empty_cache()
    return dict(zip(("decode_attention", "masked_matmul"), c["launches"]))


def _capture_rounds(torch, label, make_backend, params) -> None:
    """Two backends drawing from generators seeded alike, one with the
    round program captured (the default) and one eager, CAPTURE_ROUNDS
    rounds each from one start: states and metrics bitwise equal, every
    captured round after the first a replay; then rounds timed in turns
    (eager, captured, captured, eager), the device's busy share (one
    replay's device time over each path's host-clock time) and peaks."""
    from repro_torch.core.backend import deterministic_cudnn
    from repro_torch.utils.tree import tree_leaves

    tag = f"[capture] {label}"
    backends, states, mets, peak = {}, {}, {}, {}
    for eager in (False, True):
        be = make_backend()
        if eager:
            _eager_rounds(be)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with deterministic_cudnn():     # as the plan executor runs rounds
            st, m = be.run_rounds(be.init_state(params), 0, CAPTURE_ROUNDS)
        torch.cuda.synchronize()
        peak[eager] = (torch.cuda.max_memory_allocated() / 2**30,
                       torch.cuda.max_memory_reserved() / 2**30)
        backends[eager], states[eager], mets[eager] = be, st, m
    cap, eag = backends[False], backends[True]
    diff = [i for i, (a, b) in enumerate(zip(tree_leaves(states[False]),
                                             tree_leaves(states[True])))
            if not torch.equal(a, b)]
    same_m = all(torch.equal(a[k], b[k]) for a, b in
                 zip(mets[False], mets[True]) for k in a)
    ids = {id(a[k]) for a in mets[False] for k in a}
    log(f"{tag}: {CAPTURE_ROUNDS} rounds captured against eager from one "
        f"start and one draw: {len(tree_leaves(states[False]))} state "
        f"tensors, {len(diff)} differ; metrics "
        f"{'bitwise equal' if same_m else 'DIFFER'}; {cap.chunk.replays} "
        f"replays (round 1 eager, round 2 captured), "
        f"{cap.chunk.captures} capture; peak allocated / "
        f"reserved {peak[True][0]:.2f} / {peak[True][1]:.2f} GiB eager, "
        f"{peak[False][0]:.2f} / {peak[False][1]:.2f} captured; {CARD}")
    if diff:
        leaves = list(zip(tree_leaves(states[False]),
                          tree_leaves(states[True])))
        worst = max(float((a.float() - b.float()).abs().max())
                    / max(float(b.float().abs().max()), 1e-30)
                    for a, b in (leaves[i] for i in diff))
        log(f"{tag}: largest difference over a leaf's max {worst:.3e}")
    require(not diff and same_m, f"{tag}: the captured rounds differ from "
            f"the eager ones (state leaves {diff})")
    require(cap.chunk.replays == CAPTURE_ROUNDS - 1
            and cap.chunk._cache_size() == cap.chunk.captures == 1
            and len(ids) == 3 * CAPTURE_ROUNDS,
            f"{tag}: {cap.chunk.replays} replays, "
            f"{cap.chunk.captures} captures, {len(ids)} metric tensors")
    secs = {True: [], False: []}
    for eager in (True, False, False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with deterministic_cudnn():
            backends[eager].run_rounds(states[eager], CAPTURE_ROUNDS, 1)
        torch.cuda.synchronize()
        secs[eager].append(time.perf_counter() - t0)
    capture = next(iter(cap.chunk._cache.values()))
    dev = _graph_ms(torch, lambda: capture.graph.replay()) / 1e3
    se, sc = sum(secs[True]) / 2, sum(secs[False]) / 2
    log(f"{tag}: s/round in turns (eager, captured, captured, eager): eager "
        f"{se:.4f} {[round(x, 4) for x in secs[True]]}, captured {sc:.4f} "
        f"{[round(x, 4) for x in secs[False]]} ({se / sc:.2f}x); a replay's "
        f"device time {dev:.4f} s -> busy {100 * dev / se:.1f}% eager, "
        f"{100 * dev / sc:.1f}% captured; {CARD}")
    del backends, states, mets, cap, eag, capture
    gc.collect()                # the captured backend's graph and its pool
    torch.cuda.empty_cache()


def _eager_step(step):
    """A ``launch.steps.TrainStep`` with its step program made eager."""
    from repro_torch.core.programs import Program

    step.program = Program(step.body, name="fl_step", device="cuda",
                           capture=False)
    return step


def _ab_rounds(torch, tag, make, names=("eager", "captured")) -> dict:
    """Two round paths from one start, CAPTURE_ROUNDS rounds each:
    ``make(name)`` gives (state, step(state, r) -> (state, metrics),
    program()).  States and metrics must be bitwise equal, and K1-K3
    launches equal; then one round of each in turns (a, b, b, a) on the
    host clock, a replay's device time (CUDA events) as the busy share of
    each path, and each path's peaks.  Returns {name: (state, program)}."""
    from repro_torch.core.backend import deterministic_cudnn
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.utils.tree import tree_leaves, tree_map

    runs = {}
    for name in names:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, step, program = make(name)
        n0 = _k123(k1)
        mets = []
        with deterministic_cudnn():
            for r in range(CAPTURE_ROUNDS):
                state, met = step(state, r)
                mets.append(tree_map(torch.clone, met))
        torch.cuda.synchronize()
        runs[name] = dict(
            state=state, step=step, program=program, mets=mets,
            launches={k: v - n0[k] for k, v in _k123(k1).items()},
            peak=(torch.cuda.max_memory_allocated() / 2**30,
                  torch.cuda.max_memory_reserved() / 2**30))
    a, b = (runs[n] for n in names)
    leaves = list(zip(tree_leaves(a["state"]), tree_leaves(b["state"])))
    diff = [i for i, (x, y) in enumerate(leaves) if not torch.equal(x, y)]
    same_m = all(torch.equal(x[k], y[k]) for x, y in
                 zip(a["mets"], b["mets"]) for k in x)
    log(f"{tag}: {CAPTURE_ROUNDS} rounds {names[1]} against {names[0]} from "
        f"one start: {len(leaves)} state tensors, {len(diff)} differ; "
        f"metrics {'bitwise equal' if same_m else 'DIFFER'}; launches "
        f"K1/K2/K3 {names[1]} {b['launches']} {names[0]} {a['launches']}; "
        f"peak allocated / reserved {a['peak'][0]:.2f} / {a['peak'][1]:.2f} "
        f"GiB {names[0]}, {b['peak'][0]:.2f} / {b['peak'][1]:.2f} "
        f"{names[1]}; {CARD}")
    require(not diff and same_m, f"{tag}: {names[1]} differs from "
            f"{names[0]} (state leaves {diff})")
    require(a["launches"] == b["launches"],
            f"{tag}: K1-K3 launches {b['launches']} against {a['launches']}")
    secs = {n: [] for n in names}
    for name in (names[0], names[1], names[1], names[0]):
        run = runs[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with deterministic_cudnn():
            run["state"], _ = run["step"](run["state"], 0)
        torch.cuda.synchronize()
        secs[name].append(time.perf_counter() - t0)
    parts = []
    for name in names:
        caps = [c for c in runs[name]["program"]()._cache.values()
                if c is not None]
        if caps:
            dev = _graph_ms(torch, caps[0].graph.replay) / 1e3
            parts.append(f"{name}'s replay {dev:.4f} s on the device -> busy "
                         + ", ".join(f"{100 * dev / (sum(secs[n]) / 2):.1f}% "
                                     f"of {n}" for n in names))
    log(f"{tag}: s/round in turns ({', '.join((*names, *names[::-1]))}): "
        + ", ".join(f"{n} {sum(secs[n]) / 2:.4f} "
                    f"{[round(x, 4) for x in secs[n]]}" for n in names)
        + f"; {'; '.join(parts)}; {CARD}")
    return {n: (runs[n]["state"], runs[n]["program"]()) for n in names}


def _capture_round_step(torch, trainer, params) -> None:
    """``FederatedTrainer.round_step`` (the backend's round program on
    explicit batches) captured against its eager body: olmo-1b at
    CAPTURE_OLMO_LAYERS layers, kernel mode, masks on, on batches drawn
    once from a seed-0 generator."""
    from repro_torch.core.backend import LocalBackend
    from repro_torch.core.rounds import FederatedTrainer
    from repro_torch.utils.tree import tree_map

    src = LocalBackend(trainer.model, trainer.data, trainer.cfg,
                       use_masks=True, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(0))
    batches = [tree_map(torch.clone, src.round_batch(t))
               for t in range(CAPTURE_ROUNDS)]
    del src

    def make(name):
        tr = FederatedTrainer(trainer.model, trainer.data, trainer.cfg,
                              device="cuda")
        be = tr.backend(use_masks=True)
        if name == "eager":
            _eager_rounds(be)
        return (be.init_state(params),
                lambda st, r: tr.round_step(st, batches[r]),
                lambda: be.chunk)

    got = _ab_rounds(torch, f"[capture] olmo-1b round_step "
                     f"({CAPTURE_OLMO_LAYERS} layers, f32, kernel masks)",
                     make)
    prog = got["captured"][1]
    require(prog._cache_size() == prog.captures == 1,
            f"round_step: {prog._cache_size()} keys, {prog.captures} "
            f"captures")
    del got, prog, batches
    gc.collect()                # the captured program's graph and its pool
    torch.cuda.empty_cache()


def _capture_train_step(torch) -> None:
    """whisper-small's batch-dict ``train_step`` (f32, full width and depth,
    WHISPER_STEP) captured against its eager body, on the
    ``fl_batch_specs`` batches of seeds 20, 21, 22."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.models.api import build_model
    from repro_torch.utils.tree import tree_map

    c, b_c, seq = WHISPER_STEP
    cfg = dataclasses.replace(get_config("whisper-small"),
                              param_dtype="float32")
    run = steps.FLRunConfig(lr=3e-3, local_steps=1, server_tau=1,
                            server_batch=b_c)
    shape = InputShape("whisper-steps", seq, c * b_c, "train")
    model = build_model(cfg, device="cuda")
    init_state, _ = steps.make_fl_train_step(cfg, run, c, model=model)
    start = init_state(torch.Generator(device="cuda").manual_seed(0))
    batches = [steps.fl_batch_specs(cfg, shape, c, run, abstract=False,
                                    seed=20 + r)
               for r in range(CAPTURE_ROUNDS)]

    def make(name):
        _, ts = steps.make_fl_train_step(cfg, run, c, model=model)
        if name == "eager":
            _eager_step(ts)

        def step(st, r):
            st, tau = ts(st, batches[r])
            return st, {"tau_eff": tau}

        return tree_map(torch.clone, start), step, lambda: ts.program

    got = _ab_rounds(torch, f"[capture] whisper-small train_step (f32, "
                     f"{cfg.encoder.num_layers} + {cfg.num_layers} layers)",
                     make)
    prog = got["captured"][1]
    require(prog._cache_size() == prog.captures == 1,
            f"whisper train_step: {prog._cache_size()} keys, "
            f"{prog.captures} captures")
    del got, prog, start, model
    gc.collect()                # the captured program's graph and its pool
    torch.cuda.empty_cache()


def _capture_mesh_round(torch, trainer, params) -> None:
    """The mesh backend's captured round (the NCCL world of one of the mesh
    phase) against the local backend's captured round: olmo-1b at
    CAPTURE_OLMO_LAYERS layers, kernel mode, masks on, generators seeded
    alike; bitwise, each one key and one capture, the mesh's all-reduces a
    round counted on replay."""
    from repro_torch.core.backend import LocalBackend, MeshBackend

    require(bool(MESH), "capture: the mesh phase's world is missing")
    backends = {}

    def make(name):
        cls = MeshBackend if name == "mesh" else LocalBackend
        kw = {"mesh": MESH[0]} if name == "mesh" else {}
        be = backends[name] = cls(
            trainer.model, trainer.data, trainer.cfg, use_masks=True,
            device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(0), **kw)
        return (be.init_state(params),
                lambda st, r: (st, be.run_rounds(st, r, 1)[1][0]),
                lambda: be.chunk)

    got = _ab_rounds(torch, f"[capture] olmo-1b mesh round at a world of "
                     f"one against the local round, both captured "
                     f"({CAPTURE_OLMO_LAYERS} layers, f32, kernel masks)",
                     make, names=("local", "mesh"))
    be = backends["mesh"]
    _mesh_data_check(torch, be, "captured round")
    n = CAPTURE_ROUNDS + 2
    want = n * (1 + be.sample_kw["server_tau"])
    log(f"[capture] mesh round: {be.reductions} all-reduces over {n} rounds "
        f"(expected {want}: one per _reduce call and dtype, counted on "
        f"replay), {1e3 * be.reduce_seconds:.3f} ms of host time in the "
        f"eager calls (a replay runs no Python); {CARD}")
    require(all(p._cache_size() == p.captures == 1
                for _, p in got.values()) and be.reductions == want,
            f"mesh round: keys/captures "
            f"{[(p._cache_size(), p.captures) for _, p in got.values()]}, "
            f"{be.reductions} all-reduces (expected {want})")
    del got, backends, be
    gc.collect()                # both backends' graphs and their pools
    torch.cuda.empty_cache()


def phase_capture(torch) -> dict:
    """The reference's compiled programs as CUDA graphs: olmo-1b's
    DecodeEngine (dense, masked@0.5, shrunk@0.5 at the serving phase's
    settings), SimpleCNN's FedDUMAP round at the paper protocol and
    olmo-1b's kernel-mode round (CAPTURE_OLMO_LAYERS layers, f32), then
    ``FederatedTrainer.round_step`` on that world and whisper-small's
    batch-dict ``train_step``, each against its eager body, and the mesh
    round at the mesh phase's NCCL world of one against the local captured
    round; then ``analysis.compile_budget.check`` over the local, mesh and
    serving scenarios on the card.  (The lockstep steps' captures are held
    against their eager bodies in the zamba2, xlstm and whisper phases.)
    Returns {kernel name: launches} of the captured engines' runs."""
    import numpy as np

    from repro_torch import experiments
    from repro_torch.analysis import compile_budget
    from repro_torch.configs import get_config
    from repro_torch.core.backend import LocalBackend
    from repro_torch.core.pruning import FedAPConfig
    from repro_torch.core.rounds import feddumap_config
    from repro_torch.data.pipeline import build_federated_data
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.models.lm import LM
    from repro_torch.serving import ServeConfig, load_servable

    launches = {"decode_attention": 0, "masked_matmul": 0}
    cfg = get_config("olmo-1b")
    model = LM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))  # lint: generator-ok (every stream of this phase is seed 0 on purpose: each model is its phase's seed-0 init, and the captured and eager backends must draw alike)
    source = {"params": params, "kept": model.decide_kept(params, 0.5),
              "mode": "mask", "model_config": cfg}
    scfg = ServeConfig(slots=8, cache_len=512, max_prompt=64,
                       max_new_tokens=64, steps_per_wave=8)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(1, 65)))
               .astype(np.int32) for _ in range(16)]
    for mode in ("dense", "masked", "shrunk"):
        src = source if mode != "dense" else {**source, "kept": None}
        sv = load_servable(src, mode, device="cuda")
        for name, n in _capture_serving(torch, f"olmo-1b {mode}", sv, scfg,
                                        prompts).items():
            launches[name] += n
        del sv
    del params, source, src, model
    torch.cuda.empty_cache()

    data = build_federated_data(
        num_clients=experiments.NUM_CLIENTS, server_fraction=0.05,
        device_pool=experiments.DEVICE_POOL, spec=experiments.SPEC, seed=0)
    fl = feddumap_config(**experiments.COMMON, seed=0,
                         fedap=FedAPConfig(probe_size=32, participants=6))
    cnn = experiments.make_model("cnn", "cuda")
    _capture_rounds(
        torch, f"SimpleCNN FedDUMAP round (paper protocol: {fl.clients_per_round}"
        f" clients x {fl.local_epochs} epochs, masks on)",
        lambda: LocalBackend(cnn, data, fl, use_masks=True, device="cuda",
                             generator=torch.Generator(
                                 device="cuda").manual_seed(0)),
        cnn.init(torch.Generator(device="cuda").manual_seed(0)))

    trainer = _olmo_trainer(torch, num_layers=CAPTURE_OLMO_LAYERS)
    params = trainer.model.init(
        torch.Generator(device="cuda").manual_seed(0))
    n = {k: getattr(k1, k) for k in ("launches", "dx_launches",
                                     "dw_launches")}
    _capture_rounds(
        torch, f"olmo-1b kernel-mode round ({CAPTURE_OLMO_LAYERS} layers, "
        f"f32)",
        lambda: LocalBackend(trainer.model, trainer.data, trainer.cfg,
                             use_masks=True, device="cuda",
                             generator=torch.Generator(
                                 device="cuda").manual_seed(0)),
        params)
    log(f"[capture] olmo-1b rounds: K1/K2/K3 launched "
        f"{ {k: getattr(k1, k) - v for k, v in n.items()} } over both "
        f"backends' {2 * (CAPTURE_ROUNDS + 2)} rounds (the timed replay "
        f"runs no wrapper); {CARD}")
    gc.collect()
    torch.cuda.empty_cache()
    _capture_round_step(torch, trainer, params)
    _capture_mesh_round(torch, trainer, params)
    del trainer, params
    torch.cuda.empty_cache()
    _capture_train_step(torch)

    t0 = time.perf_counter()
    todo = compile_budget.scenarios()
    errors = compile_budget.check(scenario_list=todo, device="cuda")
    for e in errors:
        log(f"[capture] compile_budget FAIL {e}")
    log(f"[capture] compile_budget.check(device='cuda'): {len(todo)} local, "
        f"mesh (the NCCL world of one) and serving scenarios, "
        f"{len(errors)} violation(s) in {time.perf_counter() - t0:.1f} s; "
        f"{CARD}")
    require(not errors, "compile budget exceeded on the card")
    return launches


# zamba2 serving: 8 sequences, prompts of 64 tokens, 32 new, 512 cache rows;
# prefill runs a token a step (67-91 ms eager), so the prompt sets the
# phase's time.  The captured-against-eager requests: 32 prompt tokens and
# 16 new (two requests of 48 eager steps a mode).
HYBRID_SERVE = dict(batch=8, prompt=64, new=32, cache_len=512)
HYBRID_AB = (32, 16)


def phase_serving_hybrid(torch) -> dict:
    """zamba2-1.2b at full width and depth (38 layers), bf16, random weights
    from a seeded generator, served through ``load_servable(...,
    attn_impl="pallas")`` and ``lockstep_decode`` (the reference serves the
    hybrid with its lockstep loop; its engine refuses it) in dense,
    masked@0.5 and shrunk@0.5 modes, with each kernel's launch count checked
    against the steps (K5 once per shared-attention group, K1 twice per
    layer when masked), a profiled window of steps and a short run under
    ``torch.cuda.set_sync_debug_mode("error")``.  Returns {kernel name:
    launches over the three timed runs}."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.models.lm import LM
    from repro_torch.serving import load_servable, lockstep_decode
    from repro_torch.utils.tree import tree_size

    b, p_len, n_new, cache_len = (HYBRID_SERVE[k] for k in
                                  ("batch", "prompt", "new", "cache_len"))
    cfg = get_config("zamba2-1.2b")
    model = LM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    source = {"params": params, "kept": model.decide_kept(params, 0.5),
              "mode": "mask", "model_config": cfg}
    groups = len(model.hybrid_groups())
    log(f"[serving] zamba2-1.2b full width: {cfg.num_layers} layers in "
        f"{groups} groups, {tree_size(params) / 1e9:.3f} B params, "
        f"{cfg.param_dtype}; B={b}, prompts of {p_len} tokens, {n_new} new, "
        f"{cache_len} cache rows")
    del model, params
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, p_len)).astype(np.int32))
    launches = {"decode_attention": 0, "masked_matmul": 0}
    tokens = {}
    for mode in ("dense", "masked", "shrunk"):
        src = source if mode != "dense" else {**source, "kept": None}
        sv = load_servable(src, mode, attn_impl="pallas", device="cuda")
        lockstep_decode(sv.model, sv.params, prompt[:, :4], 4,
                        masks=sv.masks, cache_len=cache_len)      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k5.launches = k1.launches = 0
        timings = {}
        t0 = time.perf_counter()
        got, steps = lockstep_decode(sv.model, sv.params, prompt, n_new,
                                     masks=sv.masks, cache_len=cache_len,
                                     timings=timings)
        wall = time.perf_counter() - t0
        n5, n1 = k5.launches, k1.launches
        pre, dec = timings["prefill_s"], timings["decode_s"]
        log(f"[serving] zamba2 {mode}: {steps} decode steps in {wall:.3f} s "
            f"(prefill {pre:.3f} s, {1e3 * pre / p_len:.3f} ms/step; decode "
            f"{dec:.3f} s, {1e3 * dec / n_new:.3f} ms/step) -> "
            f"{b * n_new / dec:.1f} tokens/s generated, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"decode_attention={n5} ({n5 / steps:g}/step) masked_matmul={n1} "
            f"({n1 / steps:g}/step)")
        require(steps == p_len + n_new and tuple(got.shape) == (b, n_new)
                and int(got.min()) >= 0 and int(got.max()) < cfg.vocab_size,
                f"serving zamba2 {mode}: malformed tokens")
        require(n5 == steps * groups, f"serving zamba2 {mode}: "
                f"decode_attention launched {n5} times, expected {steps} "
                f"steps x {groups} groups")
        want1 = steps * 2 * cfg.num_layers if mode == "masked" else 0
        require(n1 == want1, f"serving zamba2 {mode}: masked_matmul launched "
                f"{n1} times, expected {want1}")
        launches["decode_attention"] += n5
        launches["masked_matmul"] += n1
        tokens[mode] = got
        _profile_lockstep(torch, f"zamba2 {mode}", sv, prompt, cache_len)
        _sync_free_lockstep(torch, f"zamba2 {mode}", sv, prompt, cache_len)
        if mode != "shrunk":
            a, n = HYBRID_AB
            _capture_lockstep(torch, f"zamba2 {mode}", sv, prompt[:, :a], n,
                              cache_len)
        del sv
    same = (tokens["masked"] == tokens["shrunk"]).float()
    log(f"[serving] zamba2 masked and shrunk agree on "
        f"{100 * float(same.mean()):.1f}% of tokens, "
        f"{100 * float(same[:, 0].mean()):.1f}% of the first (bf16 rounding "
        f"differs between the two products, and a greedy stream that "
        f"differs once goes its own way; [hybrid-parity] holds the two in "
        f"f32)")
    return launches


WINDOW = (2, 2)     # prefill and decode steps of a profiled or checked window
LOCKSTEP_TURN = (4, 4)  # prefill and decode steps of a timed turn


def _eager_lockstep(session):
    """``session`` with its step program made eager: the body its capture
    holds, run op by op (keys still counted)."""
    from repro_torch.core.programs import Program

    session._program = Program(session._step_body, name="lockstep",
                               device=session.model.device, capture=False)
    return session


def _lockstep_session(torch, sv, prompt, cache_len, enc=None):
    """A session over a fresh cache of ``prompt``'s batch, its step captured
    by one request of the first WINDOW prompt tokens, then reset (an encdec
    cache's cross K/V written from the frames ``enc``): the steps it runs
    next are replays.  Returns (session, the window's prompt on the
    card)."""
    from repro_torch.serving import LockstepSession

    session = LockstepSession.new(sv.model, sv.params, prompt.shape[0],
                                  cache_len, masks=sv.masks)
    p = prompt[:, :WINDOW[0]].to("cuda", torch.int32)
    session.decode(p, WINDOW[1], enc_embeds=enc)
    _reset(torch, session, enc)
    torch.cuda.synchronize()
    return session, p


def _reset(torch, session, enc) -> None:
    """``session``'s cache back to its start, an encdec cache's cross K/V
    written from the frames ``enc``."""
    session.reset()
    if enc is not None:
        with torch.inference_mode():
            session.model.prefill_cross(session.params, session.cache,
                                        {"enc_embeds": enc})


def _profile_lockstep(torch, tag, sv, prompt, cache_len, enc=None) -> None:
    """The host-clock time of a window of captured lockstep steps (replays,
    no profiler) against the device time of the kernels of another under
    torch.profiler: their ratio is the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    n = sum(WINDOW)
    session, p = _lockstep_session(torch, sv, prompt, cache_len, enc)
    t0 = time.perf_counter()
    session.run(p, WINDOW[1])
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    _reset(torch, session, enc)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        session.run(p, WINDOW[1])
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and e.self_device_time_total > 0]
    if not kernels:
        log(f"[profile] {tag}: {wall_ms:.3f} ms/step on the host clock "
            f"(captured); device time not measured (the profiler saw no "
            f"CUDA kernels)")
        return
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    busy = 100 * dev_ms / wall_ms
    log(f"[profile] {tag}: captured steps (graph replays) {wall_ms:.3f} "
        f"ms/step on the host clock, kernels {dev_ms:.3f} ms/step on the "
        f"device -> busy {busy:.1f}%, idle {100 - busy:.1f}%; launches "
        f"{sum(e.count for e in kernels) // n}/step; {CARD}")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    own = [e for e in ranked[8:] if "decode_" in e.key or "masked_" in e.key]
    for e in ranked[:8] + own:
        per_step = e.self_device_time_total / 1e3 / n
        log(f"[profile] {tag}:   {per_step:8.4f} ms/step  "
            f"{e.count // n:4d}/step  {e.key[:90]}")


def _sync_free_lockstep(torch, tag, sv, prompt, cache_len, enc=None) -> None:
    """A window of captured lockstep steps (replays, the prompt columns
    copied in and the tokens out) under sync-debug "error": any host sync
    raises.  (A capture synchronizes, so the session captures first.)"""
    session, p = _lockstep_session(torch, sv, prompt, cache_len, enc)
    replays = session._program.replays
    torch.cuda.set_sync_debug_mode("error")
    try:
        session.run(p, WINDOW[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    require(session._program.replays == replays + sum(WINDOW),
            f"{tag}: the sync-checked steps were not replays")
    log(f"[serving] {tag}: {sum(WINDOW)} captured steps (replays) ran under "
        f"set_sync_debug_mode('error') without a host sync")


def _capture_lockstep(torch, tag, sv, prompt, n_new, cache_len,
                      enc=None) -> None:
    """The captured lockstep step against its eager body: two requests of
    ``prompt`` and ``n_new`` tokens on each session, the tokens token for
    token and the K5/K1 launches equal, the captured session's
    ``program_counts()`` {"step": 1} with every step after its first a
    replay; then ms/step of LOCKSTEP_TURN windows in turns (eager,
    captured, captured, eager), a replay's device time (CUDA events) as the
    busy share of each, and each session's peak memory."""
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.serving import LockstepSession

    tag = f"[capture] {tag} lockstep"
    b, steps = prompt.shape[0], prompt.shape[1] + n_new
    pd = prompt.to("cuda", torch.int32)
    runs, sessions = {}, {}
    for captured in (False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        session = LockstepSession.new(sv.model, sv.params, b, cache_len,
                                      masks=sv.masks)
        if not captured:
            _eager_lockstep(session)
        k5.launches = k1.launches = 0
        t0 = time.perf_counter()
        toks = [session.decode(pd, n_new, enc_embeds=enc).cpu()
                for _ in range(2)]
        torch.cuda.synchronize()
        runs[captured] = dict(
            toks=toks, launches=(k5.launches, k1.launches),
            wall=time.perf_counter() - t0, counts=session.program_counts(),
            captures=session._program.captures,
            replays=session._program.replays,
            peak=torch.cuda.max_memory_reserved() / 2**30)
        sessions[captured] = session
    e, c = runs[False], runs[True]
    same = all(torch.equal(x, y) for x, y in zip(c["toks"], e["toks"]))
    log(f"{tag}: 2 requests of {b} x ({prompt.shape[1]} + {n_new}) steps: "
        f"captured tokens {'equal' if same else 'DIFFER'} token for token "
        f"to the eager body's; launches K5/K1 captured {c['launches']} eager "
        f"{e['launches']}; program_counts {c['counts']}, {c['captures']} "
        f"capture, {c['replays']} replays; both requests {e['wall']:.3f} s "
        f"eager, {c['wall']:.3f} s captured (capture included); peak "
        f"reserved {e['peak']:.2f} GiB eager, {c['peak']:.2f} captured; "
        f"{CARD}")
    require(same, f"{tag}: captured tokens differ from the eager body's")
    require(c["launches"] == e["launches"],
            f"{tag}: K5/K1 launches {c['launches']} against {e['launches']}")
    require(c["counts"] == {"step": 1} and c["captures"] == 1
            and c["replays"] == 2 * steps - 1,
            f"{tag}: programs {c['counts']}, {c['captures']} captures, "
            f"{c['replays']} replays")

    turn = pd[:, :LOCKSTEP_TURN[0]]
    ms = {True: [], False: []}
    for eager in (True, False, False, True):
        s_ = sessions[not eager]
        _reset(torch, s_, enc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s_.run(turn, LOCKSTEP_TURN[1])
        torch.cuda.synchronize()
        ms[eager].append(1e3 * (time.perf_counter() - t0)
                         / sum(LOCKSTEP_TURN))
    capture = next(iter(sessions[True]._program._cache.values()))
    n = sum(LOCKSTEP_TURN)      # back to back, as a turn's replays run
    dev = _graph_ms(torch, lambda: [capture.graph.replay()
                                    for _ in range(n)]) / n
    me, mc = sum(ms[True]) / 2, sum(ms[False]) / 2
    log(f"{tag}: ms/step in turns (eager, captured, captured, eager; "
        f"{LOCKSTEP_TURN[0]} prompt + {LOCKSTEP_TURN[1]} decode steps each):"
        f" eager {me:.3f} {[round(t, 3) for t in ms[True]]}, captured "
        f"{mc:.3f} {[round(t, 3) for t in ms[False]]} ({me / mc:.2f}x); {n} "
        f"replays' device time {dev:.3f} ms/step -> busy "
        f"{100 * dev / me:.1f}% eager, {100 * dev / mc:.1f}% captured; "
        f"{CARD}")
    del sessions, capture
    gc.collect()                # the captured session's graph and its pool
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 8: the scoring path's kernels against its plain path, on the card
# ---------------------------------------------------------------------------

# f32 logits, relative to max(1, max |xla|).  olmo-1b (2 layers): K4 sums
# in another order than the plain attention, 1e-4.  zamba2-1.2b (12 layers):
# 3e-4, 2.5x the largest of three H100 readings (1.12e-4, 1.15e-4,
# 1.22e-4), because this random-weight model amplifies f32 rounding: one
# rounding (2^-24, random sign) of every embedding entry alone moves the
# plain path's logits by ~1e-4, a floor the phase prints.  The per-layer
# witness below has no such amplification and is held at the kernels' own
# limits: one Mamba2 mixer (K6, 2e-4) and the shared attention block (K4,
# 2e-5), full width, f32, pallas against xla on the same input.
SCORE_PARITY_TOL = {"olmo-1b": 1e-4, "zamba2-1.2b": 3e-4}
LAYER_TOL = {"apply_mamba2": 2e-4, "attention_block": 2e-5}


def _layer_witness(torch, cfg, model, params, tokens) -> None:
    """Layer 0's Mamba2 mixer (as initialised, and with slow-decay dt_bias
    from -7 to -3 over the heads, whose state spans 20 to 1000 steps) and
    the shared attention block at ``cfg.sliding_window``, each run with
    ``impl="pallas"`` and ``"xla"`` on the model's own normed embeddings."""
    from repro_torch.models import layers as L

    def first(tree):
        return {k: v[0] for k, v in tree.items()}

    emb = params["embed"][tokens]
    b, s_len = tokens.shape
    mamba = first(params["layers"]["mamba"])
    slow = {**mamba, "dt_bias": torch.linspace(
        -7.0, -3.0, model._meta["nh"], device="cuda")}
    h_m = L.apply_norm(first(params["layers"]["norm_m"]), emb, cfg.norm)
    shared = params["shared_attn"]
    h_a = L.apply_norm(shared["norm"], emb, cfg.norm)
    pos = L.default_positions(b, s_len, cfg.rope, device="cuda")
    cases = [("apply_mamba2", "layer 0", lambda impl: L.apply_mamba2(
                  mamba, h_m, model._meta, cfg, impl=impl)),
             ("apply_mamba2", "layer 0 slow-decay", lambda impl:
                  L.apply_mamba2(slow, h_m, model._meta, cfg, impl=impl)),
             ("attention_block", f"shared, window {cfg.sliding_window}",
              lambda impl: L.attention_block(
                  shared["attn"], h_a, pos, cfg, window=cfg.sliding_window,
                  attn_impl=impl))]
    for name, label, run in cases:
        with torch.no_grad():
            got, want = run("pallas"), run("xla")
        err, rel = max_rel_err(torch, got, want)
        tol = LAYER_TOL[name]
        log(f"[score-parity] {name} {label}, full width f32 B={b} "
            f"S={s_len}: pallas against xla max_abs_err={err:.3e} "
            f"rel={rel:.3e} (tol {tol:.0e})")
        require(bool(torch.isfinite(got).all()),
                f"score-parity {name} {label}: non-finite output")
        require(rel <= tol, f"score-parity {name} {label}: {rel:.3e} over "
                f"tolerance")
        del got, want


def phase_score_parity(torch) -> None:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import ssd_scan as k6
    from repro_torch.models.lm import LM

    cases = (("zamba2-1.2b", 12, 1, 8192), ("olmo-1b", 2, 2, 2048))
    for arch, n_layers, b, s_len in cases:
        cfg = dataclasses.replace(get_config(arch), num_layers=n_layers,
                                  param_dtype="float32")
        pallas = LM(cfg, attn_impl="pallas", device="cuda")
        xla = LM(cfg, attn_impl="xla", device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(4)
        params = pallas.init(gen)
        tokens = torch.randint(0, cfg.vocab_size, (b, s_len), device="cuda",
                               generator=gen)
        k4.launches = k6.launches = 0
        with torch.no_grad():
            got = pallas.apply(params, {"tokens": tokens})
            n4, n6 = k4.launches, k6.launches
            want = xla.apply(params, {"tokens": tokens})
            sign = torch.randint(0, 2, params["embed"].shape, device="cuda",
                                 generator=gen) * 2.0 - 1.0
            nudged = {**params, "embed": params["embed"]
                      * (1.0 + 2.0 ** -24 * sign)}
            floor = max_rel_err(torch, xla.apply(nudged, {"tokens": tokens}),
                                want)[1]
        del nudged, sign
        err, rel = max_rel_err(torch, got, want)
        tol = SCORE_PARITY_TOL[arch]
        groups = len(pallas.hybrid_groups()) if pallas.hybrid else n_layers
        log(f"[score-parity] {arch} full width, {n_layers} layers, f32, "
            f"B={b} S={s_len}: pallas (K4 x{n4}, K6 x{n6}) against xla logits "
            f"max_abs_err={err:.3e} rel={rel:.3e} (tol {tol:.0e}); one f32 "
            f"rounding of the embeddings moves the xla logits by {floor:.3e}")
        require(bool(torch.isfinite(got).all()), f"score-parity {arch}: "
                f"non-finite logits")
        require(rel <= tol, f"score-parity {arch}: {rel:.3e} over tolerance")
        require(n4 == groups and n6 == (n_layers if pallas.hybrid else 0),
                f"score-parity {arch}: launches K4 {n4}, K6 {n6}")
        del got, want
        if pallas.hybrid:
            _layer_witness(torch, cfg, pallas, params, tokens)
        del params


# ---------------------------------------------------------------------------
# phase 9: full-sequence scoring through attn_impl="pallas" on the card
# ---------------------------------------------------------------------------

def phase_scoring(torch) -> dict:
    """Returns {kernel name: launches over the timed scoring forwards}."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.kernels import ssd_scan as k6
    from repro_torch.models.lm import LM
    from repro_torch.serving import load_servable
    from repro_torch.utils.tree import tree_size

    launches = {"flash_attention": 0, "ssd_scan": 0, "masked_matmul": 0}
    losses = {}
    rng = np.random.default_rng(0)
    for arch, b, s_len, modes in (("olmo-1b", 4, 2048,
                                   ("dense", "masked", "shrunk")),
                                  ("zamba2-1.2b", 1, 8192, ("dense",))):
        cfg = get_config(arch)
        model = LM(cfg, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        kept = model.decide_kept(params, 0.5) if len(modes) > 1 else None
        log(f"[scoring] {arch} full width: {cfg.num_layers} layers, "
            f"{tree_size(params) / 1e9:.3f} B params, {cfg.param_dtype}; "
            f"B={b} x S={s_len} tokens per forward")
        seq = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (b, s_len + 1)).astype(np.int64))
        x, y = seq[:, :-1].cuda(), seq[:, 1:].cuda()
        source = {"params": params, "kept": kept, "mode": "mask",
                  "model_config": cfg}
        del model
        for mode in modes:
            sv = load_servable(source, mode, attn_impl="pallas",
                               device="cuda")
            groups = (len(sv.model.hybrid_groups()) if sv.model.hybrid
                      else cfg.num_layers)
            want = {"flash_attention": groups,
                    "ssd_scan": cfg.num_layers if sv.model.hybrid else 0,
                    "masked_matmul": 2 * cfg.num_layers if mode == "masked"
                    else 0}

            def forward():
                return sv.model.loss_and_acc(sv.params, x, y, masks=sv.masks)

            with torch.no_grad():
                forward()                                      # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                k4.launches = k6.launches = k1.launches = 0
                t0 = time.perf_counter()
                loss, acc = forward()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = {"flash_attention": k4.launches,
                       "ssd_scan": k6.launches, "masked_matmul": k1.launches}
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                log(f"[scoring] {arch} {mode}: loss {float(loss):.6f} acc "
                    f"{float(acc):.6f}; {b * s_len} tokens in {wall:.4f} s "
                    f"-> {b * s_len / wall:.1f} tokens/s, peak {peak:.2f} GiB;"
                    f" launches flash_attention={got['flash_attention']} "
                    f"ssd_scan={got['ssd_scan']} "
                    f"masked_matmul={got['masked_matmul']} (expected "
                    f"{want['flash_attention']}, {want['ssd_scan']}, "
                    f"{want['masked_matmul']})")
                require(got == want, f"scoring {arch} {mode}: launches {got}, "
                        f"expected {want}")
                require(math.isfinite(float(loss)) and 0.0 < float(loss)
                        < 2 * math.log(cfg.vocab_size) and
                        0.0 <= float(acc) <= 1.0,
                        f"scoring {arch} {mode}: loss {float(loss)}, acc "
                        f"{float(acc)}")
                for name, n in got.items():
                    launches[name] += n
                losses[(arch, mode)] = float(loss)
                _profile_forward(torch, f"{arch} {mode}", forward, wall)
                if (arch, mode) == ("olmo-1b", "masked"):
                    _cost_olmo(torch, sv, x, y, wall)
            del sv
        del params, source
    # masked and shrunk score the same pruned model (bf16 products differ)
    lm, ls = losses[("olmo-1b", "masked")], losses[("olmo-1b", "shrunk")]
    log(f"[scoring] olmo-1b masked and shrunk losses differ by "
        f"{abs(lm - ls):.3e} (tol 2e-2 relative)")
    require(abs(lm - ls) <= 2e-2 * abs(ls), "scoring: masked and shrunk "
            "olmo-1b losses disagree")
    return launches


def _counted_twice(torch, label, run, meta_run, kernels):
    """``run()`` counted on the card and ``meta_run()`` on the meta device
    (each warmed once first: the rope tables are cached per device), with
    the kernels' launch counters reset around the card's count; the two
    totals must be equal and each kernel's counted calls its launches.
    Returns the card's totals."""
    from repro_torch.launch.cost import CostCounter

    run()
    meta_run()
    torch.cuda.synchronize()
    for mod, attr in kernels.values():
        setattr(mod, attr, 0)
    with CostCounter() as card:
        run()
    torch.cuda.synchronize()
    launched = {k: getattr(mod, attr) for k, (mod, attr) in kernels.items()}
    with CostCounter() as meta:
        meta_run()
    got, want = card.totals.as_dict(), meta.totals.as_dict()
    calls = {k: v["calls"] for k, v in got["kernel_work"].items()}
    log(f"[cost] {label}: counted on the card {got['flops']:.6e} flops "
        f"({got['product_flops']:.6e} in products, the rest the kernels' "
        f"work), {got['bytes']:.6e} bytes; on the meta device "
        f"{want['flops']:.6e} flops, {want['bytes']:.6e} bytes: "
        f"{'equal' if got == want else 'DIFFERENT'}; kernel calls {calls}, "
        f"launches {launched}")
    require(got == want, f"cost {label}: the card's count {got} differs from"
            f" the meta device's {want}")
    require(calls == {k: n for k, n in launched.items() if n},
            f"cost {label}: counted kernel calls {calls}, launches "
            f"{launched}")
    return card.totals


def _cost_olmo(torch, sv, x, y, wall) -> None:
    """The counter on olmo-1b's masked bf16 scoring forward (4 x 2048,
    attn_impl="pallas": K4 and K1) and on one masked decode step at the
    serving phase's shape (K5 and K1), each equal to its count on the meta
    device; the forward's counted FLOPs over its measured time as TFLOP/s
    and as a share of the bf16 peak."""
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.utils.tree import tree_map

    meta = sv.model.on_meta()

    def to_meta(tree):
        return tree_map(lambda t: t.to("meta"), tree)

    params_m, masks_m = to_meta(sv.params), to_meta(sv.masks)
    x_m, y_m = x.to("meta"), y.to("meta")
    tot = _counted_twice(
        torch, "olmo-1b masked scoring forward (4 x 2048)",
        lambda: sv.model.loss_and_acc(sv.params, x, y, masks=sv.masks),
        lambda: meta.loss_and_acc(params_m, x_m, y_m, masks=masks_m),
        {"flash_attention": (k4, "launches"),
         "masked_matmul": (k1, "launches")})
    rate = tot.flops / wall
    log(f"[cost] olmo-1b masked scoring: {tot.flops:.6e} counted flops in "
        f"the timed forward's {wall:.4f} s -> {rate / 1e12:.1f} TFLOP/s, "
        f"{100 * rate / PEAK_FLOPS['bfloat16']:.1f}% of 989 TFLOP/s (bf16 "
        f"dense peak); {CARD}")
    cache = sv.model.init_cache(8, 512)
    cache["index"] = torch.zeros(8, dtype=torch.int32, device="cuda")
    tok = {"tokens": torch.zeros((8, 1), dtype=torch.int32, device="cuda")}
    cache_m, tok_m = to_meta(cache), to_meta(tok)
    with torch.inference_mode():
        _counted_twice(
            torch, "olmo-1b masked decode step (8 slots x 512 rows)",
            lambda: sv.model.decode_step(sv.params, cache, tok,
                                         masks=sv.masks),
            lambda: meta.decode_step(params_m, cache_m, tok_m,
                                     masks=masks_m),
            {"decode_attention": (k5, "launches"),
             "masked_matmul": (k1, "launches")})
    log(f"[cost] {CARD}")


def _profile_forward(torch, label, forward, wall) -> None:
    """The device time of one scoring forward's kernels under
    torch.profiler, against the host-clock time of an unprofiled one: the
    eight largest, then the port's own kernels below them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and e.self_device_time_total > 0]
    if not kernels:
        log(f"[profile] scoring {label}: device time not measured (the "
            f"profiler saw no CUDA kernels)")
        return
    dev_s = sum(e.self_device_time_total for e in kernels) / 1e6
    busy = 100 * dev_s / wall
    log(f"[profile] scoring {label}: forward {wall:.4f} s on the host clock, "
        f"kernels {dev_s:.4f} s on the device -> busy {busy:.1f}%, idle "
        f"{100 - busy:.1f}%")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    ours = ("ssd_", "flash_attention", "masked_")    # the port's kernels
    for e in ranked[:8] + [e for e in ranked[8:]
                           if any(k in e.key for k in ours)]:
        log(f"[profile] scoring {label}:   "
            f"{e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:90]}")


# ---------------------------------------------------------------------------
# phases 11-12: the paper's CNNs (no TPU kernel lies on their path)
# ---------------------------------------------------------------------------

CNN_TOL = 1e-4      # f32, TF32 off: logits relative to max(1, max |cpu|),
                    # each gradient leaf relative to its max |cpu|; cuDNN
                    # and the CPU's convolutions sum 27 to 4608 terms a
                    # product in other orders (and other algorithms).
# A ReLU input within ~1e-6 of 0 can take the other side of 0 on the card
# than on the CPU; such a unit then passes its gradient on one device and
# not the other, which moves a gradient element by that position's whole
# contribution (VGG11's first layer alone holds 2 M units a batch of 32).
# Where the feature maps show such flips, the float32 gradients are held as
# the whole tree's relative L2 error, within CNN_TOL_FLIPS (H100 80GB HBM3,
# 700 W: VGG11 6.4e-4 with 1 flip, ResNet18 4.2e-5 with 3; the worst leaf
# 5.2e-3 and 1.7e-3 of its max, printed), and the same gradients are held
# in float64 on both devices, leaf by leaf, where no unit sits that close
# to 0.
CNN_TOL_FLIPS = 5e-3
CNN_TOL64 = 1e-9
CNN_MODELS = (("SimpleCNN", {"num_classes": 10}, (16, 16, 3)),
              ("VGG11", {"num_classes": 10}, (32, 32, 3)),
              ("ResNet18", {"num_classes": 100}, (32, 32, 3)))


def _cnn_pair(torch, cls, kw, shape, seed):
    """One paper CNN on the CPU and on the card from the same params."""
    from repro_torch.models import cnn
    from repro_torch.utils.tree import tree_map

    cpu = getattr(cnn, cls)(image_shape=shape, device="cpu", **kw)
    gpu = getattr(cnn, cls)(image_shape=shape, device="cuda", **kw)
    params_c = cpu.init(torch.Generator().manual_seed(seed))
    return cpu, gpu, params_c, tree_map(lambda t: t.cuda(), params_c)


def phase_cnn_parity(torch) -> None:
    """Card against CPU in f32 at full width: each paper CNN's logits and
    gradients on a batch of 32, SimpleCNN's HRank scores over a probe of 32
    (the kept sets at rate 0.5 must be equal), and one FedDUMAP round of
    SimpleCNN with a mask prune."""
    import numpy as np

    from repro_torch.core import engine
    from repro_torch.utils.tree import tree_leaves, tree_size

    rng = np.random.default_rng(11)
    for i, (cls, kw, shape) in enumerate(CNN_MODELS):
        cpu, gpu, params_c, params_g = _cnn_pair(torch, cls, kw, shape, i)
        x = torch.from_numpy(rng.standard_normal((32,) + shape)
                             .astype(np.float32))
        y = torch.from_numpy(rng.integers(0, kw["num_classes"], 32)
                             .astype(np.int32))
        with torch.no_grad():
            logits_g, maps_g = gpu.apply(params_g, x.cuda(), collect=True)
            logits_c, maps_c = cpu.apply(params_c, x, collect=True)
            err, rel = max_rel_err(torch, logits_g.cpu(), logits_c)
            flips = sum(int(((maps_g[k].cpu() > 0) != (maps_c[k] > 0)).sum())
                        for k in maps_c)
            units = sum(t.numel() for t in maps_c.values())
        del logits_g, maps_g, maps_c
        (l_c, _), g_c = engine.value_and_grad_aux(
            lambda p: cpu.loss_and_acc(p, x, y), params_c)
        (l_g, _), g_g = engine.value_and_grad_aux(
            lambda p: gpu.loss_and_acc(p, x.cuda(), y.cuda()), params_g)
        errs = _leaf_errs(g_g, g_c)
        worst = max(_ratio(e, m) for e, m in errs)
        diff2 = sum(float((g.cpu() - w).square().sum())
                    for g, w in zip(tree_leaves(g_g), tree_leaves(g_c)))
        norm2 = sum(float(w.square().sum()) for w in tree_leaves(g_c))
        l2 = math.sqrt(diff2 / norm2)
        log(f"[cnn-parity] {cls} {shape[0]}x{shape[1]}x{shape[2]} "
            f"{tree_size(params_c):,} params, B=32: logits max_abs_err "
            f"{err:.3e} rel {rel:.3e}; loss card {float(l_g):.6f} cpu "
            f"{float(l_c):.6f}; ReLU units on the other side of 0: {flips} "
            f"of {units:,}; {len(errs)} gradient leaves, worst error "
            f"{worst:.3e} of the leaf's max |grad|, tree relative L2 "
            f"{l2:.3e} (tol: "
            + (f"the tree {CNN_TOL_FLIPS:.0e})" if flips
               else f"each leaf {CNN_TOL:.0e})"))
        require(rel <= CNN_TOL, f"cnn-parity {cls}: logits {rel:.3e}")
        require(abs(float(l_g) - float(l_c)) <= CNN_TOL * max(
            1.0, abs(float(l_c))), f"cnn-parity {cls}: loss differs")
        if flips:
            require(l2 <= CNN_TOL_FLIPS, f"cnn-parity {cls}: gradient tree "
                    f"relative L2 {l2:.3e} with {flips} ReLU flips")
            _cnn_grad_parity64(torch, cls, cpu, gpu, params_c, x, y)
        else:
            require(worst <= CNN_TOL, f"cnn-parity {cls}: gradient "
                    f"{worst:.3e} of a leaf's max")
        if cls == "SimpleCNN":
            _cnn_hrank_parity(torch, cpu, gpu, params_c, params_g, rng, shape)
            _cnn_round_parity(torch, cpu, gpu, params_c, params_g, rng, shape)
        del params_c, params_g, g_c, g_g


def _cnn_grad_parity64(torch, cls, cpu, gpu, params_c, x, y) -> None:
    """The gradients of one batch in float64 on the card and the CPU, each
    leaf within CNN_TOL64 of its max |grad|."""
    from repro_torch.core import engine
    from repro_torch.utils.tree import tree_map

    p_c = tree_map(lambda t: t.double(), params_c)
    p_g = tree_map(lambda t: t.double().cuda(), params_c)
    x64 = x.double()
    _, g_c = engine.value_and_grad_aux(
        lambda p: cpu.loss_and_acc(p, x64, y), p_c)
    _, g_g = engine.value_and_grad_aux(
        lambda p: gpu.loss_and_acc(p, x64.cuda(), y.cuda()), p_g)
    worst = max(_ratio(e, m) for e, m in _leaf_errs(g_g, g_c))
    log(f"[cnn-parity] {cls} float64 gradients card~cpu: worst error "
        f"{worst:.3e} of the leaf's max |grad| (tol {CNN_TOL64:.0e})")
    require(worst <= CNN_TOL64, f"cnn-parity {cls}: float64 gradient "
            f"{worst:.3e}")


def _cnn_hrank_parity(torch, cpu, gpu, params_c, params_g, rng, shape):
    """HRank ranks (float32 singular values: cuSOLVER against LAPACK)
    counted per sample, and the kept filters at rate 0.5."""
    import numpy as np

    from repro_torch.core import pruning

    probe = torch.from_numpy(rng.standard_normal((32,) + shape)
                             .astype(np.float32))
    with torch.no_grad():
        fm_c = cpu.feature_maps(params_c, probe)
        fm_g = gpu.feature_maps(params_g, probe.cuda())
    for l in cpu.prune_spec(params_c).layers:
        s_c = pruning.feature_map_scores(fm_c[l.name])
        s_g = pruning.feature_map_scores(fm_g[l.name]).cpu()
        diff = int((s_c != s_g).sum())
        kept_c = pruning.select_filters(pruning.feature_map_ranks(fm_c[l.name]),
                                        0.5)
        kept_g = pruning.select_filters(pruning.feature_map_ranks(fm_g[l.name]),
                                        0.5)
        same = bool(np.array_equal(kept_c, kept_g))
        log(f"[cnn-parity] SimpleCNN HRank {l.name}: {diff} of "
            f"{s_c.numel()} per-sample ranks differ card~cpu (max "
            f"{int((s_c - s_g).abs().max())}); mean rank "
            f"{float(s_c.mean()):.3f}; kept sets at rate 0.5 "
            f"{'equal' if same else 'DIFFER'} ({len(kept_c)} of "
            f"{s_c.shape[1]})")
        require(same, f"cnn-parity: HRank kept sets of {l.name} differ")


def _cnn_round_parity(torch, cpu, gpu, params_c, params_g, rng, shape):
    """One FedDUMAP round (2 clients x 2 local steps of B=10 with restart
    momentum, 2 server steps of 32, server momentum) on a state masked by
    an HRank prune at rate 0.5, card against CPU."""
    import numpy as np

    from repro_torch.core import backend, engine, pruning
    from repro_torch.core.engine import EngineConfig
    from repro_torch.utils.tree import tree_leaves, tree_map

    eng = EngineConfig(lr=0.1, lr_decay=0.99, use_server_update=True,
                       local_momentum="restart", server_momentum=True,
                       use_masks=True)
    spec = cpu.prune_spec(params_c)
    probe = torch.from_numpy(rng.standard_normal((32,) + shape)
                             .astype(np.float32))
    with torch.no_grad():
        fm = cpu.feature_maps(params_c, probe)
    kept = {l.name: pruning.select_filters(
        pruning.feature_map_ranks(fm[l.name]), 0.5) for l in spec.layers}

    def imgs(*lead):
        return (torch.from_numpy(rng.standard_normal(lead + shape)
                                 .astype(np.float32)),
                torch.from_numpy(rng.integers(0, 10, lead).astype(np.int32)))

    batch = {"client": imgs(2, 2, 10), "sizes": torch.tensor([400.0, 400.0]),
             "server": imgs(2, 32), "d_round": torch.tensor(0.4),
             "d_server": torch.tensor(0.01), "n0": torch.tensor(2000.0)}
    eps = torch.finfo(torch.float32).eps
    ulp = [eps * float(t.abs().max()) for t in tree_leaves(params_c)]
    deltas = {}
    for name, model, params in (("cpu", cpu, params_c), ("card", gpu,
                                                        params_g)):
        dev = "cpu" if name == "cpu" else "cuda"
        state = engine.init_round_state(tree_map(torch.clone, params), eng)
        backend.masked_round_state(state,
                                   backend.param_masks_for(model, params,
                                                           kept))
        before = tree_map(torch.clone, state["params"])
        grad_fn, la_fn = backend.model_fns(model, eng)
        state, met = engine.round_core(eng, grad_fn, la_fn, state, tree_map(
            lambda t: t.to(dev), batch))
        deltas[name] = tree_map(lambda a, b_: (a - b_).cpu(), state["params"],
                                before)
        log(f"[cnn-parity] SimpleCNN one FedDUMAP round (mask prune at 0.5,"
            f" kept {[len(v) for v in kept.values()]}) on the {name}: "
            f"tau_eff {float(met['tau_eff']):.6f}, server acc "
            f"{float(met['server_acc']):.4f}")
    errs = _leaf_errs(deltas["card"], deltas["cpu"])
    worst = max(_ratio(e, TRAIN_TOL * m + ROUND_ULPS * u)
                for (e, m), u in zip(errs, ulp))
    log(f"[cnn-parity] SimpleCNN round updates ({len(errs)} leaves): worst "
        f"error / allowance ({TRAIN_TOL:.0e} x max |update| + {ROUND_ULPS} "
        f"spacings) = {worst:.3f}")
    require(worst <= 1.0, f"cnn-parity: round update error {worst:.3f} of "
            f"its allowance")


# The paper protocol's runs.  VGG11 (no normalisation) at the paper's lr
# 0.1 reaches NaN within its first round, in the JAX reference as in the
# port (tools/cnn_lr_witness.py; FedDU's server step is tau_eff ~55 times
# lr), so it trains at 0.01.  At the paper's FedAP config the eigen-gap
# rule gives SimpleCNN p* = 0 (nothing pruned): the mask run keeps that
# config and prints it as a finding, and every other run takes the
# quickstart's compression floor, min_rate 0.3, and must prune.
# each round is timed alone, so a run needs no round before its prune to
# measure s/round.  Local epochs: 1 of the paper's 5 (the rounds are
# host-bound and the script's clock is short; s/round scales with E)
CNN_LOCAL_EPOCHS = 1
CNN_RUNS = (
    dict(model="SimpleCNN", shape=(16, 16, 3), rounds=2, prune_round=1,
         mode="shrink", min_rate=0.3),
    dict(model="SimpleCNN", shape=(16, 16, 3), rounds=2, prune_round=1,
         mode="mask"),
    dict(model="SimpleCNN", shape=(16, 16, 3), rounds=3, prune_round=1,
         mode="mask", shrink_round=2, min_rate=0.3),
    dict(model="VGG11", shape=(32, 32, 3), rounds=2, prune_round=1,
         mode="shrink", lr=0.01, min_rate=0.3),
)


def phase_training_cnn(torch) -> dict:
    """The paper protocol on the card: ``SyntheticSpec()`` data (50,000
    training images), 100 clients by label shards, 400 samples each, 2,000
    server samples; FedDUMAP with 10 clients a round, E =
    CNN_LOCAL_EPOCHS (the paper's 5 cut to 1), B = 10, lr
    decayed 0.99; FedAP with a probe of 32 and 6 participants (CNN_RUNS
    says where a run departs from that).  Returns
    {kernel name: launches}: none, since no paper CNN reaches a kernel."""
    import numpy as np

    from repro_torch.core import pruning
    from repro_torch.core.plan import fedap_plan
    from repro_torch.core.pruning import FedAPConfig
    from repro_torch.core.rounds import FederatedTrainer, feddumap_config
    from repro_torch.data.pipeline import build_federated_data
    from repro_torch.data.synthetic import SyntheticSpec
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.models import cnn
    from repro_torch.utils.tree import tree_size

    worlds = {}
    kept_by_run = {}
    launches = {"masked_matmul": 0}
    for run in CNN_RUNS:
        cls, shape, rounds = run["model"], run["shape"], run["rounds"]
        prune_round, mode = run["prune_round"], run["mode"]
        shrink_round, lr = run.get("shrink_round"), run.get("lr", 0.1)
        if shape not in worlds:
            t0 = time.perf_counter()
            worlds[shape] = build_federated_data(
                spec=SyntheticSpec(image_shape=shape))
            log(f"[training cnn] world {shape}: {worlds[shape].client_x.shape}"
                f" client images, {worlds[shape].server_x.shape[0]} server, "
                f"{worlds[shape].test_x.shape[0]} test; built in "
                f"{time.perf_counter() - t0:.1f} s on the host")
        data = worlds[shape]
        fl = feddumap_config(clients_per_round=10,
                             local_epochs=CNN_LOCAL_EPOCHS,
                             batch_size=10, lr=lr, lr_decay=0.99,
                             fedap=FedAPConfig(
                                 probe_size=32, participants=6,
                                 min_rate=run.get("min_rate", 0.0)))
        model = getattr(cnn, cls)(image_shape=shape, device="cuda")
        trainer = FederatedTrainer(model, data, fl, device="cuda")
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        plan = fedap_plan(rounds, prune_round=prune_round, mode=mode,
                          shrink_round=shrink_round)
        form = mode + (f"-then-shrink@{shrink_round}" if shrink_round else "")
        tag = f"[training cnn] {cls} {form}"
        backend = trainer.backend(use_masks=plan.uses_masks)
        kw = backend.sample_kw
        local = kw["clients_per_round"] * kw["local_steps"] * kw["batch_size"]
        steps = (kw["clients_per_round"] * kw["local_steps"]
                 + kw["server_tau"])
        log(f"{tag}: {tree_size(params):,} params, lr {lr}, FedAP min_rate "
            f"{fl.fedap.min_rate}, {rounds} rounds, prune at {prune_round}; "
            f"a round is {steps} gradient "
            f"evaluations ({kw['clients_per_round']} clients x "
            f"{kw['local_steps']} local steps of B={kw['batch_size']} + "
            f"tau={kw['server_tau']} server steps of B={kw['server_batch']}),"
            f" {local} local samples")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k1.launches = k1.dx_launches = k1.dw_launches = 0
        t0 = time.perf_counter()
        with _RoundClock(torch) as clock:   # each round alone, synced
            res = trainer.run(plan, params=params)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_k1 = k1.launches + k1.dx_launches + k1.dw_launches
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        h = res.history
        state = res.state
        secs = {r: sec for r, sec, _ in clock.rows}
        later = [r for r in secs if r > 1]      # round 1 holds the warm-up
        round_s = statistics.median(secs[r] for r in later)
        how = f"median of rounds {later}, each timed alone"
        for r, loss, acc, tau in zip(h["round"], h["loss"], h["acc"],
                                     h["tau_eff"]):
            log(f"{tag} round {r}: test loss {loss:.6f} acc {acc:.4f} "
                f"tau_eff {tau:.6f}, {secs[r]:.3f} s")
        art = res.artifacts["prune"]
        before = art.get("params_before", params)
        after = res.params
        if mode == "mask" and not shrink_round:
            after = pruning.shrink_params(after, model.prune_spec(after),
                                          art["kept"])
        log(f"{tag}: {round_s:.3f} s/round on the host clock ({how}) -> "
            f"{local / round_s:.1f} local samples/s; plan {wall:.3f} s; peak "
            f"{peak:.3f} GiB")
        note = (" (the kept filters; the masked model still computes all)"
                if after is not res.params else "")
        log(f"{tag}: FedAP p*={art['p_star']:.6f}, layer rates "
            f"{ {k: round(v, 4) for k, v in art['layer_rates'].items()} }, "
            f"kept {art['kept_counts']}; params {tree_size(before):,} -> "
            f"{tree_size(after):,}, MFLOPs/example "
            f"{model.flops_per_example(before) / 1e6:.3f} -> "
            f"{model.flops_per_example(after) / 1e6:.3f}{note}")
        log(f"{tag}: masked_matmul (K1-K3) launches {n_k1}: no paper CNN "
            f"reaches the kernel (SimpleCNN never prunes fc1, LeNet5's "
            f"120/84 widths are not multiples of 128, VGG11 and ResNet18 have "
            f"no masked dense layer), and masked_compute='params' passes no "
            f"masks to the model")
        require(n_k1 == 0, f"{tag}: masked_matmul launched {n_k1} times")
        require(len(h["loss"]) == rounds and all(
            math.isfinite(v) for k in ("loss", "acc", "tau_eff")
            for v in h[k]), f"{tag}: history not finite")
        widths = {l.name: before[l.name]["w"].shape[0]
                  for l in model.prune_spec(before).layers}
        pruned = sum(widths.values()) - sum(art["kept_counts"].values())
        if fl.fedap.min_rate:
            require(pruned > 0, f"{tag}: min_rate {fl.fedap.min_rate} "
                    f"pruned no filter")
        else:
            log(f"{tag}: finding: at the paper's FedAP config (min_rate 0) "
                f"the eigen-gap rule gives p*={art['p_star']:.6f}, "
                f"{pruned} of {sum(widths.values())} filters pruned")
        require(all(c == max(widths[k] - math.floor(
            art["layer_rates"][k] * widths[k]), 1)
            for k, c in art["kept_counts"].items()),
            f"{tag}: kept counts {art['kept_counts']} are not the layer "
            f"rates' d - floor(rate d)")
        if mode == "shrink" or shrink_round:
            require(all(res.params[k]["w"].shape[0] == c
                        for k, c in art["kept_counts"].items()),
                    f"{tag}: the model was not shrunk")
        kept_by_run[form, cls] = art["kept"]
        _profile_one_client(torch, backend, state, rounds + 1,
                            f"training cnn {cls} {form}")
        launches["masked_matmul"] += n_k1
        del res, state, trainer, backend, params, before, after
    same = all(np.array_equal(kept_by_run["shrink", "SimpleCNN"][k], v)
               for k, v in kept_by_run["mask-then-shrink@2",
                                       "SimpleCNN"].items())
    log(f"[training cnn] SimpleCNN's shrink and mask-then-shrink runs kept "
        f"{'the same' if same else 'different'} filters at round 1 (same "
        f"params, draws and min_rate; cuDNN's weight gradients sum in no "
        f"fixed order)")
    return launches


PROFILE_LOCAL_STEPS = 10    # a quarter of a paper client's local epoch
                            # (400 / B=10)


def _profile_one_client(torch, backend, state, t, label):
    """The device busy share of a round cut to its first client's first
    PROFILE_LOCAL_STEPS local steps, then every server step,
    unprofiled on the host clock and then under torch.profiler recording
    device work only: a whole paper round launches ~2 x 10^5 kernels, and
    the profiler spends ~13x the round's own time on them.  Returns the
    busy percentage, or None where the profiler saw no kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine

    batch = backend.round_batch(t)
    batch["client"] = tuple(a[:1, :PROFILE_LOCAL_STEPS]
                            for a in batch["client"])
    for k in ("sizes", "sel", "active"):
        if k in batch:
            batch[k] = batch[k][:1]
    steps = batch["client"][0].shape[1] + batch["server"][0].shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.round_core(backend.eng, backend.grad_fn, backend.la_fn, state,
                      batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.round_core(backend.eng, backend.grad_fn, backend.la_fn, state,
                          batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"
               and e.self_device_time_total > 0]
    if not kernels:
        log(f"[profile] {label}: device time not measured (the profiler "
            f"saw no CUDA kernels)")
        return None
    dev_s = sum(e.self_device_time_total for e in kernels) / 1e6
    n = sum(e.count for e in kernels)
    busy = 100 * dev_s / wall
    log(f"[profile] {label}: a round of 1 client, {PROFILE_LOCAL_STEPS} "
        f"local steps ({steps} gradient "
        f"evaluations) takes {wall:.3f} s on the host clock and {dev_s:.3f} s"
        f" of kernels ({n} launches, {n / steps:.1f} a step, "
        f"{1e6 * wall / n:.1f} us of host time each) -> busy {busy:.1f}%, "
        f"idle {100 - busy:.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[profile] {label}:   {e.self_device_time_total / 1e6:8.4f} s "
            f"{e.count:6d}x  {e.key[:90]}")
    return busy


# ---------------------------------------------------------------------------
# phases 13-14: the paper's evaluation (no TPU kernel lies on its path)
# ---------------------------------------------------------------------------

PAPER_CLIENTS = (3, 3)      # paper-parity batches: 3 clients x 3 local steps
PAPER_ALPHA = 0.01          # FedDyn's alpha (FedDynConfig's default)


def _paper_state_errs(card, cpu, start, ulp_base=None):
    """Each leaf's error (card against CPU) over its allowance: TRAIN_TOL
    of the leaf's max |update| (the CPU's state minus ``start``, the
    round's start) plus ROUND_ULPS spacings of f32 at the leaf's max
    |start|, or at ``ulp_base`` when given."""
    from repro_torch.utils.tree import tree_leaves

    eps = 2.0 ** -23
    out = []
    for g, w, b in zip(tree_leaves(card), tree_leaves(cpu),
                       tree_leaves(start)):
        g, w, b = (t.detach().cpu().double() for t in (g, w, b))
        base = float(b.abs().max()) if ulp_base is None else ulp_base
        out.append(_ratio(float((g - w).abs().max()),
                          TRAIN_TOL * float((w - b).abs().max())
                          + ROUND_ULPS * eps * base))
    return out


def _tree_sub(a, b):
    from repro_torch.utils.tree import tree_map

    return tree_map(lambda x, y: x.detach().cpu().double()
                    - y.detach().cpu().double(), a, b)


def phase_paper_parity(torch) -> None:
    """The paper's client algorithms and baseline hooks, card against CPU
    in f32 (TF32 off) from the same params and batches: SimpleCNN at the
    protocol's width (10x10x3 images, 32/64/64 filters, FC 64): one FedProx
    round, two FedDyn rounds with client dropout (one client dropped, then
    all of them: that round must leave the client state and momentum
    bitwise unchanged on the card and move the params by exactly FedDyn's
    server correction -h/alpha), and the FedDF and FedKT distillation
    hooks.  Held as cnn-parity holds a round: each leaf of params,
    server_m and FedDyn's h within TRAIN_TOL of its max change since the
    first round's start plus ROUND_ULPS spacings; where that fails and
    ReLU inputs of the first local step flip sides between the devices,
    the change's relative L2 within CNN_TOL_FLIPS and that step's
    gradients in float64 within CNN_TOL64."""
    import numpy as np

    from repro_torch.core import backend, baselines, engine
    from repro_torch.core.engine import FedDynConfig, FedProxConfig
    from repro_torch.core.rounds import engine_config
    from repro_torch.experiments import SPEC
    from repro_torch.utils.tree import tree_leaves, tree_map

    shape = SPEC.image_shape
    cpu, gpu, params_c, params_g = _cnn_pair(torch, "SimpleCNN",
                                             {"num_classes": 10}, shape, 21)
    rng = np.random.default_rng(23)
    clients, steps = PAPER_CLIENTS

    def imgs(*lead):
        return (torch.from_numpy(rng.standard_normal(lead + shape)
                                 .astype(np.float32)),
                torch.from_numpy(rng.integers(0, 10, lead).astype(np.int32)))

    def batch(sel, active=None):
        b = {"client": imgs(clients, steps, 10),
             "sizes": torch.full((clients,), 100.0),
             "server": imgs(2, 32), "d_round": torch.tensor(0.4),
             "d_server": torch.tensor(0.01), "n0": torch.tensor(500.0),
             "sel": torch.tensor(sel, dtype=torch.int32)}
        if active is not None:
            b["active"] = torch.tensor(active, dtype=torch.float32)
        return b

    runs = {
        "fedprox": (baselines.fedprox_config(
            fedprox=FedProxConfig(mu=0.01)), [batch([4, 17, 90])]),
        "feddyn": (baselines.feddyn_config(
            feddyn=FedDynConfig(alpha=PAPER_ALPHA)),
            [batch([4, 17, 90], [1, 0, 1]), batch([17, 3, 55], [0, 0, 0])]),
    }
    for name, (fl, batches) in runs.items():
        eng = engine_config(fl)
        states, befores = {}, {}
        for dev, model, params in (("cpu", cpu, params_c),
                                   ("cuda", gpu, params_g)):
            st = engine.init_round_state(tree_map(torch.clone, params), eng,
                                         num_clients=100)
            grad_fn, la_fn = backend.model_fns(model, eng)
            for r, b in enumerate(batches):
                befores[dev, r] = tree_map(torch.clone, st)
                st, met = engine.round_core(eng, grad_fn, la_fn, st, tree_map(
                    lambda t: t.to(dev), b))
                states[dev, r] = tree_map(torch.clone, st)
        # the devices share only the first round's start: each round's
        # state is held against its whole change since then
        start = befores["cpu", 0]
        for r, b in enumerate(batches):
            card, host = states["cuda", r], states["cpu", r]
            keys = ["params", "server_m"] + (["client_state"]
                                             if name == "feddyn" else [])
            # h = -alpha (theta_k - anchor): a difference of params, so
            # its rounding allowance is alpha spacings at the params' size
            p_max = max(float(t.abs().max())
                        for t in tree_leaves(start["params"]))
            worst = {k: max(_paper_state_errs(
                card[k], host[k], start[k],
                PAPER_ALPHA * p_max if k == "client_state" else None))
                for k in keys}
            drop = ("" if "active" not in b else
                    f", active {b['active'].int().tolist()}")
            log(f"[paper-parity] SimpleCNN {shape[0]}x{shape[1]}x{shape[2]} "
                f"{name} round {r + 1} ({clients} clients x {steps} local "
                f"steps of B=10{drop}): worst error / allowance "
                f"{ {k: round(v, 4) for k, v in worst.items()} }")
            if max(worst.values()) > 1.0:
                _paper_flip_fallback(torch, name, cpu, gpu, start, b, card,
                                     host)
            if "active" in b and not float(b["active"].sum()):
                _paper_all_dropped(torch, befores["cuda", r], card)
    _paper_hooks(torch, cpu, gpu, params_c, params_g)


def _paper_all_dropped(torch, before, after) -> None:
    """An all-dropped FedDyn round on the card: the aggregation returns the
    broadcast point, so the params move by exactly -h_shared/alpha (the
    reference's server correction, computed here by the same ops) and the
    momentum and client state stay as they were, bit for bit."""
    from repro_torch.utils.tree import tree_leaves, tree_map

    hs = before["client_state"]["shared"]["h"]
    want = tree_map(lambda p, h: (p.float() - h / PAPER_ALPHA).to(p.dtype),
                    before["params"], hs)
    same = {k: all(torch.equal(a, b) for a, b in zip(
        tree_leaves(after[k]), tree_leaves(before[k])))
        for k in ("server_m", "client_state")}
    params_ok = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(after["params"]), tree_leaves(want)))
    moved = max(float(h.abs().max()) for h in tree_leaves(hs)) / PAPER_ALPHA
    log(f"[paper-parity] all-dropped FedDyn round on the card: server_m and "
        f"client state bitwise unchanged {same}; params == start - "
        f"h_shared/alpha bitwise: {params_ok} (max |h_shared/alpha| "
        f"{moved:.3e})")
    require(all(same.values()) and params_ok,
            "paper-parity: the all-dropped round changed the state")


def _paper_flip_fallback(torch, name, cpu, gpu, start, b, card, host):
    """cnn-parity's fallback: ReLU flips in the first local step's forward
    (card against CPU), the params' change's relative L2, and that step's
    gradients in float64."""
    from repro_torch.utils.tree import tree_leaves, tree_map

    x, y = b["client"][0][0, 0], b["client"][1][0, 0]
    p = start["params"]
    with torch.no_grad():
        _, maps_c = cpu.apply(p, x, collect=True)
        _, maps_g = gpu.apply(tree_map(lambda t: t.cuda(), p), x.cuda(),
                              collect=True)
    flips = sum(int(((maps_g[k].cpu() > 0) != (maps_c[k] > 0)).sum())
                for k in maps_c)
    d_card = _tree_sub(card["params"], start["params"])
    d_cpu = _tree_sub(host["params"], start["params"])
    diff2 = sum(float((a - b_).square().sum())
                for a, b_ in zip(tree_leaves(d_card), tree_leaves(d_cpu)))
    norm2 = sum(float(b_.square().sum()) for b_ in tree_leaves(d_cpu))
    l2 = math.sqrt(diff2 / norm2) if norm2 else math.inf
    log(f"[paper-parity] {name}: over the f32 allowance; ReLU units on the "
        f"other side of 0 in the first step: {flips}; update relative L2 "
        f"{l2:.3e} (tol {CNN_TOL_FLIPS:.0e})")
    require(flips > 0 and l2 <= CNN_TOL_FLIPS,
            f"paper-parity {name}: round update off without a ReLU flip")
    _cnn_grad_parity64(torch, "SimpleCNN", cpu, gpu, p, x, y)


def _paper_hooks(torch, cpu, gpu, params_c, params_g) -> None:
    """FedDF and FedKT server phases (10 steps of 32 server images, lr
    0.01: the paper runs' settings) from the same params and seed on the
    card and the CPU, held as a round is (each leaf's spacing allowance at
    the params' largest magnitude: FedDF's teacher is the student's own
    start, where its KL has a zero gradient, so its update is rounding
    noise on both devices, and a zero-initialised bias has no magnitude
    of its own), with cnn-parity's fallback where ReLU inputs flip."""
    import numpy as np

    from repro_torch.core import baselines
    from repro_torch.data.pipeline import build_federated_data
    from repro_torch.experiments import SPEC
    from repro_torch.utils.tree import tree_leaves

    data = build_federated_data(num_clients=10, device_pool=2000, spec=SPEC)
    steps, batch, seed = 10, 32, 3
    for mode in ("feddf", "fedkt"):
        out = {}
        for dev, model, params in (("cpu", cpu, params_c),
                                   ("cuda", gpu, params_g)):
            hook = baselines.make_distillation_round_end(
                model, data, mode=mode, steps=steps, batch=batch, seed=seed)
            out[dev] = hook(None, 1, params)
        p_max = max(float(t.abs().max()) for t in tree_leaves(params_c))
        worst = max(_paper_state_errs(out["cuda"], out["cpu"], params_c,
                                      p_max))
        moved = max(e for e, _ in _leaf_errs(out["cpu"], params_c))
        log(f"[paper-parity] {mode} hook ({steps} steps of B={batch}): max "
            f"|update| {moved:.3e}; card~cpu worst error / allowance "
            f"{worst:.4f}")
        if worst > 1.0:
            # the hook's own draws: np.random.default_rng(seed) per hook
            sx = np.asarray(data.server_x)
            idx = np.random.default_rng(seed).integers(0, sx.shape[0],
                                                       steps * batch)
            xs = torch.from_numpy(sx[idx].reshape(steps, batch,
                                                  *sx.shape[1:]))
            _paper_hook_fallback(torch, mode, cpu, gpu, params_c, xs,
                                 out["cuda"], out["cpu"])


def _paper_hook_fallback(torch, mode, cpu, gpu, params_c, xs, card, host):
    """cnn-parity's fallback for a distillation hook over its f32
    allowance: ReLU units on the other side of 0 (card against CPU) in the
    student's forward at the start over the hook's batches, the update
    tree's relative L2 within CNN_TOL_FLIPS, and (FedKT: a cross entropy
    to the teacher's labels, the model's own loss) the first step's
    gradients in float64 within CNN_TOL64."""
    from repro_torch.utils.tree import tree_leaves, tree_map

    params_g = tree_map(lambda t: t.cuda(), params_c)
    flips = 0
    with torch.no_grad():
        for x in xs:
            _, maps_c = cpu.apply(params_c, x, collect=True)
            _, maps_g = gpu.apply(params_g, x.cuda(), collect=True)
            flips += sum(int(((maps_g[k].cpu() > 0) != (maps_c[k] > 0))
                             .sum()) for k in maps_c)
        labels = cpu.apply(params_c, xs[0]).argmax(-1)
    d_card, d_cpu = _tree_sub(card, params_c), _tree_sub(host, params_c)
    diff2 = sum(float((a - b).square().sum())
                for a, b in zip(tree_leaves(d_card), tree_leaves(d_cpu)))
    norm2 = sum(float(b.square().sum()) for b in tree_leaves(d_cpu))
    l2 = math.sqrt(diff2 / norm2) if norm2 else math.inf
    log(f"[paper-parity] {mode} hook: over the f32 allowance; ReLU units on "
        f"the other side of 0 over its batches: {flips}; update relative L2 "
        f"{l2:.3e} (tol {CNN_TOL_FLIPS:.0e})")
    require(flips > 0 and l2 <= CNN_TOL_FLIPS,
            f"paper-parity: {mode} hook differs without a ReLU flip")
    if mode == "fedkt":
        _cnn_grad_parity64(torch, "SimpleCNN", cpu, gpu, params_c, xs[0],
                           labels)


PAPER_ROUNDS, PAPER_PRUNE, PAPER_EVAL = 2, 1, 2


class _RoundClock:
    """Wraps ``LocalBackend.run_rounds`` so that each round runs alone and
    is timed between two device syncs; records (round, seconds, FedDyn's
    max |h| after it, the round's active count)."""

    def __init__(self, torch):
        from repro_torch.core.backend import LocalBackend

        self.torch, self.cls = torch, LocalBackend
        self.inner = LocalBackend.run_rounds
        self.rows: list = []

    def __enter__(self):
        clock = self

        def run_rounds(backend, state, t, n):
            mets = []
            for r in range(t, t + n):
                clock.torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = clock.inner(backend, state, r, 1)
                clock.torch.cuda.synchronize()
                clock.rows.append((r + 1, time.perf_counter() - t0,
                                   _max_h(state)))
                mets += m
            return state, mets

        self.cls.run_rounds = run_rounds
        return self

    def __exit__(self, *exc):
        self.cls.run_rounds = self.inner
        return False


def _max_h(state):
    from repro_torch.utils.tree import tree_leaves

    if "client_state" not in state or not state["client_state"]["shared"]:
        return None
    return max(float(h.abs().max())
               for h in tree_leaves(state["client_state"]["per_client"]))


def phase_paper(torch) -> dict:
    """The paper's evaluation on the card through ``repro_torch.
    experiments``: ``run_one`` for each of the 16 ``suite_main`` algorithms
    at the paper protocol (10x10x3 synthetic CIFAR, 100 clients over a
    10,000-image pool, 10 a round, E = 5, B = 10, lr 0.1 decayed 0.99,
    p = 0.05) cut to PAPER_ROUNDS rounds with the prune or hook at round
    PAPER_PRUNE and an Eval every PAPER_EVAL, then the heterogeneity grid's
    smoke cells (FedAvg, FedProx and FedDyn at dropout 0.25, 16 clients,
    2 rounds).  One line a run: s/round (the median of the rounds after the
    first; hooks, prunes and Evals fall between rounds and are not in it),
    local samples/s, the busy share of a round cut to one client, peak
    memory, final accuracy, MFLOPs before and after, p* and kept counts.
    Returns {}: no kernel of K1-K6 is on the path (K1-K3 counted 0)."""
    import shutil

    from repro_torch import experiments
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.utils.tree import tree_size

    out = os.path.join(ROOT, "build", "chip_smoke_paper")
    shutil.rmtree(out, ignore_errors=True)
    seen: list = []
    trainer_cls = experiments.FederatedTrainer

    class Recording(trainer_cls):
        def run(self, plan, **kw):
            res = super().run(plan, **kw)
            seen.append((self, res))
            return res

    unpruned = tree_size(experiments.make_model("cnn").init(
        torch.Generator(device="cuda").manual_seed(0)))
    k1.launches = k1.dx_launches = k1.dw_launches = 0
    peaks: list = []
    experiments.FederatedTrainer = Recording
    try:
        for i, algo in enumerate(experiments.MAIN_ALGOS):
            with _RoundClock(torch) as clock:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                rec = experiments.run_one(
                    f"main_cnn_{algo}", algo=algo, rounds=PAPER_ROUNDS,
                    prune_round=PAPER_PRUNE, out_dir=out, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            peaks.append(peak)
            trainer, res = seen.pop()
            # the requires read the final state before the profiled round
            # of _paper_line trains on it
            _paper_requires(torch, algo, trainer, res, rec, unpruned)
            _paper_line(torch, f"main {algo}", trainer, res, clock.rows,
                        wall, rec, peak)
            del trainer, res
        with _RoundClock(torch) as clock:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            cells = experiments.suite_scenario_matrix("smoke", out_dir=out,
                                                      device="cuda")
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            peaks.append(peak)
    finally:
        experiments.FederatedTrainer = trainer_cls
    per = len(clock.rows) // len(cells)
    for j, cell in enumerate(cells):
        trainer, res = seen[j]
        rows = clock.rows[j * per:(j + 1) * per]
        require(all(math.isfinite(v) for v in res.history["loss"]),
                f"paper grid {cell['algo']}: loss not finite")
        _paper_line(torch, f"grid {cell['algo']} drop {cell['dropout_rate']}",
                    trainer, res, rows, cell["wall_s"], cell, peak)
        if cell["algo"] == "feddyn":
            h1 = rows[0][2]
            log(f"[paper] grid feddyn: max |h| after round 1 {h1:.3e}, "
                f"after round 2 {rows[1][2]:.3e}")
            require(h1 > 0, "paper grid feddyn: h is zero after round 1")
    log(f"[paper] grid smoke: {len(cells)} cells in {wall:.1f} s; the "
        f"peak above is the grid's, over its cells")
    log(f"[paper] peak device memory over the phase's runs "
        f"{max(peaks):.3f} GiB (each run resets the counter: the [memory] "
        f"line below is the grid's alone)")
    n_k1 = k1.launches + k1.dx_launches + k1.dw_launches
    log(f"[paper] masked_matmul (K1-K3) launches {n_k1}: the paper's runs "
        f"use masked_compute='params' and no model of theirs reaches the "
        f"kernel")
    require(n_k1 == 0, f"paper: masked_matmul launched {n_k1} times")
    return {}


def _paper_line(torch, label, trainer, res, rows, wall, rec, peak) -> None:
    """One line for one run (and its profiled one-client round)."""
    from repro_torch.core.backend import sim_sample_kw

    kw = sim_sample_kw(trainer.cfg, trainer.data)
    local = kw["clients_per_round"] * kw["local_steps"] * kw["batch_size"]
    times = [s for _, s, _ in rows]
    round_s = statistics.median(times[1:]) if len(times) > 1 else times[0]
    busy = _profile_one_client(torch, trainer.backend(), res.state,
                               len(times) + 1, f"paper {label}")
    fedap = rec.get("fedap") or {}
    counts = fedap.get("kept_counts") or {
        k: int(v["w"].shape[0]) for k, v in res.params.items()
        if k.startswith("conv")}
    mf = (f"MFLOPs/example {rec['mflops_before']:.3f} -> "
          f"{rec['mflops_after']:.3f}, " if "mflops_before" in rec else "")
    log(f"[paper] {label}: {round_s:.3f} s/round (rounds "
        f"{[round(t, 3) for t in times]}; plan {wall:.1f} s with its Evals,"
        f" hooks and prunes) -> {local / round_s:.1f} local samples/s; busy "
        + (f"{busy:.1f}%" if busy is not None else "not measured")
        + f"; peak {peak:.3f} GiB; final acc {rec['final_acc']:.4f}; {mf}"
        f"p* {fedap.get('p_star', 'n/a')}, kept {counts}; "
        f"{int(trainer.data.client_x.shape[0])} clients x "
        f"{int(trainer.data.client_x.shape[1])} samples")


def _paper_requires(torch, algo, trainer, res, rec, unpruned) -> None:
    import numpy as np

    from repro_torch.utils.tree import tree_leaves, tree_size

    h = rec["history"]
    require(all(math.isfinite(v) for k in ("loss", "acc", "tau_eff")
                for v in h[k]), f"paper {algo}: history not finite")
    if algo in ("imc", "prunefl"):
        zeros = sum(int((t == 0).sum()) for t in tree_leaves(res.params))
        total = tree_size(res.params)
        log(f"[paper] {algo}: {zeros:,} of {total:,} weights at zero "
            f"({100 * zeros / total:.1f}%)")
        require(zeros >= 0.4 * total, f"paper {algo}: only {zeros} of "
                f"{total} weights are zero")
    if algo == "hrank":
        size = tree_size(res.params)
        log(f"[paper] hrank: params {unpruned:,} -> {size:,}")
        require(size < unpruned, "paper hrank: the model was not shrunk")
    if algo == "datasharing":
        from repro_torch import experiments

        n_k = experiments.DEVICE_POOL // experiments.NUM_CLIENTS
        x = trainer.data.client_x
        server = {row.tobytes() for row in np.asarray(trainer.data.server_x)}
        added = x[:, n_k:].reshape(-1, *x.shape[2:])
        log(f"[paper] datasharing: {x.shape[0]} clients x {x.shape[1]} "
            f"samples ({x.shape[1] - n_k} server images appended to each)")
        require(x.shape[1] > n_k and all(a.tobytes() in server
                                         for a in added),
                "paper datasharing: clients did not get the server data")
    if algo == "hybridfl":
        from repro_torch import experiments

        n = int(trainer.backend().device_data()["client_x"].shape[0])
        log(f"[paper] hybridfl: {n} clients sampled from "
            f"(num_clients {trainer.cfg.num_clients})")
        require(n == trainer.cfg.num_clients == trainer.data.sizes.shape[0]
                and n == experiments.NUM_CLIENTS + 1,
                "paper hybridfl: the server is not one more client")
    if algo in ("fedap", "fedduap", "feddumap") and \
            not rec["fedap"]["p_star"]:
        log(f"[paper] {algo}: finding: at the paper's FedAP config p* is 0 "
            f"at round {PAPER_PRUNE}: nothing is pruned")


# ---------------------------------------------------------------------------
# phase 15: reliability — the health guard, kill and resume, serving faults
# ---------------------------------------------------------------------------

def phase_reliability(torch) -> dict:
    """The guard at olmo-1b's full width (parity with the surviving-client
    round, skip_round bitwise, the guard's cost a round), kill and resume
    of olmo-1b (2 layers, full width) and of the paper's FedDUMAP SimpleCNN
    run, each after its own determinism check, and a NaNLogits serving
    wave with no host sync.  Returns {kernel name: launches} over the
    phase (K1-K3 in the kernel-mode rounds, K5 in the waves)."""
    import shutil

    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import masked_matmul as k1

    root = os.path.join(ROOT, "build", "chip_smoke_reliability")
    shutil.rmtree(root, ignore_errors=True)
    k1.launches = k1.dx_launches = k1.dw_launches = 0
    k5.launches = 0
    try:
        _guard_olmo(torch)
        _resume_olmo(torch, root)
        _resume_cnn(torch, root)
        _nan_logits_wave(torch)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"masked_matmul": k1.launches, "masked_matmul_dx": k1.dx_launches,
            "masked_matmul_dw": k1.dw_launches,
            "decode_attention": k5.launches}


def _olmo_trainer(torch, num_layers=None, faults=(), backend="local",
                  mesh=None):
    """phase_training's olmo-1b FedDUMAP trainer (f32, kernel mode) on
    ``backend``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.pruning import FedAPConfig
    from repro_torch.core.rounds import FederatedTrainer, feddumap_config
    from repro_torch.data.pipeline import build_lm_federated_data
    from repro_torch.data.synthetic import TokenSpec
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config("olmo-1b"), param_dtype="float32",
                              remat="none")
    if num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    data = build_lm_federated_data(
        num_clients=4, server_fraction=0.25,
        spec=TokenSpec(vocab_size=cfg.vocab_size, num_topics=8, seq_len=129,
                       num_sequences=45))
    fl = feddumap_config(num_clients=4, clients_per_round=2, batch_size=4,
                         server_batch_size=4, local_epochs=1, lr=3e-3,
                         lr_decay=1.0, masked_compute="kernel", faults=faults,
                         fedap=FedAPConfig(align=128, min_rate=0.5,
                                           probe_size=4, participants=2))
    return FederatedTrainer(LM(cfg, device="cuda"), data, fl, device="cuda",
                            backend=backend, mesh=mesh)


def _gib(n) -> float:
    return n / 2 ** 30


def _guard_olmo(torch) -> None:
    """One FedDUMAP round of olmo-1b (16 layers, f32, kernel mode) from one
    state: guard off; reject_client with NaNGrad on the second selected
    client, held to the unguarded round with that client inactive (the
    train-parity allowance); skip_round with the same fault, which must
    leave params, server_m and masks bitwise as they were.  Off, reject
    and skip run twice in turns for the guard's cost a round."""
    import dataclasses

    from repro_torch.core import engine
    from repro_torch.reliability import NaNGrad
    from repro_torch.utils.tree import tree_leaves, tree_map

    from repro_torch.kernels import masked_matmul as k1

    tag = "[reliability] guard olmo-1b"
    counts0 = (k1.launches, k1.dx_launches, k1.dw_launches)
    trainer = _olmo_trainer(torch)
    backend = trainer.backend(use_masks=True)
    kw = backend.sample_kw
    grads = kw["clients_per_round"] * kw["local_steps"] + kw["server_tau"]
    n_layers = trainer.model.cfg.num_layers
    state0 = backend.init_state(trainer.model.init(
        torch.Generator(device="cuda").manual_seed(0)))
    batch = backend.round_batch(0)
    victim = int(batch["sel"][1])
    fault = NaNGrad(client=victim, round=0)
    cfgs = {"off": backend.eng,
            "reject_client": dataclasses.replace(
                backend.eng, guard="reject_client", faults=(fault,)),
            "skip_round": dataclasses.replace(
                backend.eng, guard="skip_round", faults=(fault,))}
    log(f"{tag}: {n_layers} layers f32, kernel mode, {kw['clients_per_round']}"
        f" clients a round (sel {batch['sel'].tolist()}), NaNGrad on client "
        f"{victim} (slot 1) at round 0")

    def one_round(cfg, b):
        st = tree_map(torch.clone, state0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st, met = engine.round_core(cfg, backend.grad_fn, backend.la_fn, st,
                                    b)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return st, met, dt, torch.cuda.max_memory_allocated(), base

    oracle, met_o, *_ = one_round(
        cfgs["off"], dict(batch, active=torch.tensor([1.0, 0.0],
                                                     device="cuda")))
    want = oracle["params"]
    del oracle
    eps = torch.finfo(torch.float32).eps
    times = {k: [] for k in cfgs}
    peaks = {}
    for turn in range(2):
        for mode, cfg in cfgs.items():
            st, met, dt, peak, base = one_round(cfg, batch)
            times[mode].append(dt)
            peaks[mode] = (peak, base)
            health = float(met["health"])
            if mode == "reject_client":
                worst = max(_ratio(
                    float((g - w).abs().max()),
                    TRAIN_TOL * float((w - s).abs().max())
                    + ROUND_ULPS * eps * float(s.abs().max()))
                    for g, w, s in zip(tree_leaves(st["params"]),
                                       tree_leaves(want),
                                       tree_leaves(state0["params"])))
                tau, tau_o = float(met["tau_eff"]), float(met_o["tau_eff"])
                if turn == 0:
                    log(f"{tag} reject_client: health {health:.0f}; params "
                        f"against the round with client {victim} inactive: "
                        f"worst error / allowance ({TRAIN_TOL:.0e} x max "
                        f"|update| + {ROUND_ULPS} spacings) = {worst:.3f}; "
                        f"tau_eff {tau:.6f} against {tau_o:.6f}")
                require(health == 1.0 and worst <= 1.0 and
                        abs(tau - tau_o) <= TRAIN_TOL * max(1.0, abs(tau_o)),
                        f"guard: reject_client is not the surviving-client "
                        f"round (health {health}, error {worst:.3f})")
            elif mode == "skip_round":
                same = all(torch.equal(a, b) for k in ("params", "server_m",
                                                       "masks")
                           for a, b in zip(tree_leaves(st[k]),
                                           tree_leaves(state0[k])))
                rnd = float(st["round"]) - float(state0["round"])
                if turn == 0:
                    log(f"{tag} skip_round: health {health:.0f}, tau_eff "
                        f"{float(met['tau_eff'])}; params, server_m and "
                        f"masks bitwise the round start's: {same}; round "
                        f"+{rnd:.0f}")
                require(same and rnd == 1.0 and health == 1.0 and
                        float(met["tau_eff"]) == 0.0,
                        "guard: skip_round moved the state")
            else:
                require(health == 0.0, f"guard off: health {health}")
            del st, met
    off = statistics.mean(times["off"])
    for mode, ts in times.items():
        peak, base = peaks[mode]
        s = statistics.mean(ts)
        log(f"{tag} {mode}: {s:.3f} s/round (rounds "
            f"{[round(t, 3) for t in ts]}, taken in turns)"
            + (f", {100 * (s / off - 1):+.1f}% against off"
               if mode != "off" else "")
            + f"; peak {_gib(peak):.2f} GiB, {_gib(peak - base):.2f} GiB "
            f"above the round's start")
    n = (2 * len(cfgs) + 1) * grads * 2 * n_layers
    got = [a - b for a, b in zip((k1.launches, k1.dx_launches,
                                  k1.dw_launches), counts0)]
    log(f"{tag}: launches K1 {got[0]}, K2 {got[1]}, K3 {got[2]} (expected "
        f"{2 * len(cfgs) + 1} rounds x {grads} gradient evaluations x 2 "
        f"products x {n_layers} layers = {n} each)")
    require(got == [n] * 3, f"guard: K1-K3 launches {got}, expected {n}")
    del state0, want, trainer, backend


class _CheckpointIO:
    """Times and sizes every run checkpoint written and loaded inside the
    block (``reliability.checkpoint`` save/load, patched)."""

    def __init__(self):
        from repro_torch.reliability import checkpoint as ck

        self.ck = ck
        self.writes: list = []
        self.loads: list = []

    def __enter__(self):
        ck, save, load = self.ck, self.ck.save_checkpoint, \
            self.ck.load_checkpoint
        self.inner = (save, load)

        def timed_save(directory, payload):
            t0 = time.perf_counter()
            step = save(directory, payload)
            nbytes = sum(f.stat().st_size for f in step.iterdir())
            self.writes.append((time.perf_counter() - t0, nbytes))
            return step

        def timed_load(path):
            t0 = time.perf_counter()
            out = load(path)
            self.loads.append(time.perf_counter() - t0)
            return out

        ck.save_checkpoint, ck.load_checkpoint = timed_save, timed_load
        return self

    def __exit__(self, *exc):
        self.ck.save_checkpoint, self.ck.load_checkpoint = self.inner
        return False


def _same_run(torch, a, b) -> list:
    """What differs between two runs ((trainer, RunResult) pairs): history
    columns but time, param leaves (by max |difference|), generator state."""
    from repro_torch.utils.tree import tree_leaves

    (ta, ra), (tb, rb) = a, b
    diff = []
    for k, col in ra.history.items():
        other = rb.history.get(k)
        if k != "time" and col != other:
            i = next((i for i, (x, y) in enumerate(zip(col, other or []))
                      if x != y), min(len(col), len(other or [])))
            diff.append(f"history[{k!r}] from entry {i}")
    la, lb = tree_leaves(ra.params), tree_leaves(rb.params)
    if [x.shape for x in la] != [x.shape for x in lb]:
        return diff + ["param shapes"]
    for i, (x, y) in enumerate(zip(la, lb)):
        if not torch.equal(x, y):
            diff.append(f"param leaf {i} {tuple(x.shape)} (max |diff| "
                        f"{float((x.float() - y.float()).abs().max()):.3e})")
    if not torch.equal(ta.generator.get_state(), tb.generator.get_state()):
        diff.append("generator state")
    return diff


def _kill_and_resume(torch, tag, make_trainer, events, ckpt) -> None:
    """The plan run twice uninterrupted (the card's determinism check),
    then with KillAfterChunk(2) and a checkpoint every chunk, resumed from
    disk in a fresh trainer: history (but time), params and the generator
    state must equal the uninterrupted run's bitwise."""
    from repro_torch.core.plan import TrainPlan
    from repro_torch.reliability import KillAfterChunk, SimulatedCrash

    runs, walls = [], []
    for _ in range(2):
        tr = make_trainer(())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tr.run(TrainPlan(*events))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        runs.append((tr, res))
    from repro_torch.utils.tree import tree_size

    diff = _same_run(torch, runs[0], runs[1])
    log(f"{tag} determinism: two uninterrupted runs of the plan "
        f"({walls[0]:.2f} s, {walls[1]:.2f} s; {tree_size(res.params):,} "
        f"params at the end) are "
        + ("bitwise equal (history but time, params, generator state)"
           if not diff else f"NOT equal: {'; '.join(diff[:6])}"))
    require(not diff, f"{tag}: the plan is not deterministic on the card")
    del runs[1]
    with _CheckpointIO() as io:
        killed = make_trainer((KillAfterChunk(2),))
        t0 = time.perf_counter()
        try:
            killed.run(TrainPlan(*events, checkpoint_every=1,
                                 checkpoint_dir=ckpt))
            crashed = False
        except SimulatedCrash:
            crashed = True
        t_kill = time.perf_counter() - t0
        require(crashed, f"{tag}: KillAfterChunk(2) did not fire")
        del killed
        fresh = make_trainer(())
        t0 = time.perf_counter()
        res = fresh.resume(ckpt)
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t0
    diff = _same_run(torch, runs[0], (fresh, res))
    (w_s, nbytes), *_ = io.writes
    log(f"{tag} checkpoint: snapshots of {[b for _, b in io.writes]} bytes "
        f"(the first {_gib(nbytes):.3f} GiB), written in "
        f"{[round(s, 3) for s, _ in io.writes]} s (the first at "
        f"{_gib(nbytes) / w_s:.3f} GiB/s: device to host, npz, fsync); "
        f"loaded in {[round(s, 3) for s in io.loads]} s (warm: written just "
        f"before); killed run {t_kill:.2f} s, resumed run {t_resume:.2f} s")
    log(f"{tag} kill after chunk 2 and resume: "
        + ("bitwise equal to the uninterrupted run (history but time, "
           "params, generator state)" if not diff
           else f"NOT equal: {'; '.join(diff[:6])}"))
    require(not diff, f"{tag}: the resumed run differs")
    require(len(io.writes) == 3 and len(io.loads) == 1,
            f"{tag}: {len(io.writes)} checkpoints written, "
            f"{len(io.loads)} loaded (expected 3 and 1)")


def _resume_olmo(torch, root) -> None:
    from repro_torch.core.plan import Eval, Prune, Scan

    tag = "[reliability] resume olmo-1b"
    events = (Scan(1), Eval(), Prune(mode="mask"), Scan(1), Eval(), Scan(1))
    log(f"{tag}: 2 layers at full width, f32, kernel mode; plan {events}")
    _kill_and_resume(torch, tag,
                     lambda faults: _olmo_trainer(torch, 2, faults),
                     events, os.path.join(root, "olmo"))


CNN_RESUME = dict(clients_per_round=2, local_epochs=1)   # of the paper
                    # protocol's 10 clients x 5 epochs a round


def _resume_cnn(torch, root, backend="local", mesh=None,
                tag="[reliability] resume SimpleCNN") -> None:
    """The paper protocol's FedDUMAP SimpleCNN run (``experiments``) cut to
    CNN_RESUME a round, its FedAP at min_rate 0.3 so the shrink prunes, on
    ``backend``."""
    from repro_torch import experiments
    from repro_torch.core.plan import Eval, Prune, Scan
    from repro_torch.core.pruning import FedAPConfig
    from repro_torch.core.rounds import FederatedTrainer, feddumap_config
    from repro_torch.data.pipeline import build_federated_data

    data = build_federated_data(
        num_clients=experiments.NUM_CLIENTS, server_fraction=0.05,
        device_pool=experiments.DEVICE_POOL, spec=experiments.SPEC, seed=0)
    events = (Scan(1), Eval(), Prune(mode="shrink"), Scan(1), Eval(),
              Scan(1))
    common = dict(experiments.COMMON, **CNN_RESUME)
    log(f"{tag}: the paper protocol ({experiments.SPEC.image_shape}, "
        f"{experiments.NUM_CLIENTS} clients over {experiments.DEVICE_POOL} "
        f"images, {common}), FedAP probe 32 / 6 participants / min_rate "
        f"0.3, backend {backend!r}; plan {events}")

    def make(faults):
        cfg = feddumap_config(**common, seed=0, faults=faults,
                              fedap=FedAPConfig(probe_size=32,
                                                participants=6,
                                                min_rate=0.3))
        return FederatedTrainer(experiments.make_model("cnn", "cuda"), data,
                                cfg, device="cuda", backend=backend,
                                mesh=mesh)

    _kill_and_resume(torch, tag, make, events, os.path.join(root, "cnn"))


def _nan_logits_wave(torch) -> None:
    """olmo-1b (16 layers, bf16) through DecodeEngine with NaNLogits on
    slot 1 after its third token, every wave under sync-debug "error":
    slot 1's request ends with status "error" and the fault-free run's
    first three tokens, every other request with the fault-free tokens."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.reliability import NaNLogits
    from repro_torch.serving import DecodeEngine, ServeConfig

    tag = "[reliability] serving olmo-1b"
    cfg = get_config("olmo-1b")
    model = LM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    scfg = ServeConfig(slots=8, cache_len=64, max_prompt=16,
                       max_new_tokens=8, steps_per_wave=24)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(1, 17)))
               .astype(np.int32) for _ in range(scfg.slots)]
    clean = DecodeEngine(model, params, scfg, device="cuda").run(prompts)
    eng = DecodeEngine(model, params, scfg, device="cuda",
                       faults=(NaNLogits(slot=1, n_out=3),))
    eng.lower_wave()    # the capture (which synchronizes) before any wave
    inner = eng._wave

    def checked_wave():
        torch.cuda.set_sync_debug_mode("error")
        try:
            inner()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    eng._wave = checked_wave
    got = eng.run(prompts)
    require(eng._wave_program.replays == eng.steps // scfg.steps_per_wave,
            f"{tag}: {eng._wave_program.replays} of the waves were replays")
    status = [c.status for c in got]
    log(f"{tag}: {len(got)} requests, NaNLogits(slot=1, n_out=3), every wave "
        f"under set_sync_debug_mode('error'): status {status}; uid 1 emitted "
        f"{len(got[1].tokens)} tokens before its retirement")
    require([c.uid for c in got] == [c.uid for c in clean] and
            status == ["ok"] + ["error"] + ["ok"] * (len(got) - 2),
            f"serving fault: statuses {status}")
    require(np.array_equal(got[1].tokens, clean[1].tokens[:3]),
            "serving fault: slot 1 did not keep its first three tokens")
    require(all(np.array_equal(a.tokens, b.tokens)
                for i, (a, b) in enumerate(zip(got, clean)) if i != 1),
            "serving fault: a co-batched request changed")
    log(f"{tag}: the other {len(got) - 1} requests' tokens equal the "
        f"fault-free run's")


# ---------------------------------------------------------------------------
# phases 16-17: the xlstm ssm family (no TPU kernel lies on its path)
# ---------------------------------------------------------------------------

# f32, TF32 off, card against CPU at the reduced 4-layer model.  Logits and
# each decode state tensor: relative to max(1, max |cpu|).  The exponential
# gates amplify f32 rounding through the layers: on the CPU the port and
# the JAX package differ by up to 1.6e-5 of the logits' max (7.8e-5 at 5.1)
# and 7.4e-5 of a gradient leaf's max (tests/test_torch_xlstm.py, which
# holds them at 1e-4 and 2e-4).  Two f32 computations of another order
# differ by as much again, so: logits 1e-4, gradient leaves 4e-4 of their
# max |cpu|; a round's update takes train-parity's allowance.
XLSTM_TOL = 1e-4
XLSTM_GRAD_TOL = 4e-4
XLSTM_STEPS = 64
# bf16: one block on the same bf16 input within two bf16 steps of max(1,
# max |cpu|) (cuBLAS and the CPU round each product's f32 sum to bf16 on
# their own); through the LM the roundings compound, so the card's bf16
# logits must lie within XLSTM_BF16_RATIO x the CPU bf16 logits' RMS
# distance from the f32 logits of the same bf16 params.
XLSTM_BF16_BLOCK_TOL = 2 * TOL["bfloat16"]
XLSTM_BF16_RATIO = 1.25


def _rms(torch, t) -> float:
    return float(t.double().square().mean().sqrt())


def phase_xlstm_parity(torch) -> None:
    """xlstm-125m reduced to 4 layers (three mLSTM blocks, one sLSTM), d =
    256, f32: the forward's logits at B = 2 x S = 128 (two scan chunks), 64
    teacher-forced decode steps (logits and every state tensor), the loss
    gradient and one FedDUM round from one state on the same batches, card
    against CPU; then bf16 blocks, forward and decode."""
    import dataclasses

    import numpy as np

    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.core import backend, engine
    from repro_torch.core.engine import EngineConfig
    from repro_torch.models import layers
    from repro_torch.models.lm import LM
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("xlstm-125m").reduced(num_layers=4)
    cpu, gpu = LM(cfg, device="cpu"), LM(cfg, device="cuda")
    params_c = cpu.init(torch.Generator().manual_seed(11))
    params_g = interop.params_from_jax(params_c, "cuda")
    rng = np.random.default_rng(12)
    b, s_len = 2, 128
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s_len + 1))
                           .astype(np.int32))
    x, y = seq[:, :-1], seq[:, 1:]
    log(f"[xlstm-parity] xlstm-125m reduced: {cfg.num_layers} layers "
        f"(sLSTM at {[i for i in range(cfg.num_layers) if cpu._is_slstm(i)]})"
        f", d_model={cfg.d_model}, f32, B={b} S={s_len}")
    with torch.no_grad():
        want = cpu.apply(params_c, {"tokens": x})
        got = gpu.apply(params_g, {"tokens": x.cuda()})
    err, rel = max_rel_err(torch, got.cpu(), want)
    log(f"[xlstm-parity] forward logits: max_abs_err={err:.3e} rel={rel:.3e}"
        f" (tol {XLSTM_TOL:.0e})")
    require(bool(torch.isfinite(got).all()) and rel <= XLSTM_TOL,
            f"xlstm-parity forward: {rel:.3e}")

    caches = {"cpu": cpu.init_cache(b, XLSTM_STEPS),
              "card": gpu.init_cache(b, XLSTM_STEPS)}
    worst = 0.0
    with torch.inference_mode():
        for t in range(XLSTM_STEPS):
            tok = x[:, t:t + 1]
            lc, caches["cpu"] = cpu.decode_step(params_c, caches["cpu"],
                                                {"tokens": tok})
            lg, caches["card"] = gpu.decode_step(params_g, caches["card"],
                                                 {"tokens": tok.cuda()})
            worst = max(worst, max_rel_err(torch, lg.cpu(), lc)[1])
    states = [max_rel_err(torch, g.cpu(), c)[1] for g, c in zip(
        tree_leaves(caches["card"])[1:], tree_leaves(caches["cpu"])[1:])]
    log(f"[xlstm-parity] {XLSTM_STEPS} decode steps: worst logits rel "
        f"{worst:.3e}, worst of {len(states)} state tensors rel "
        f"{max(states):.3e} (tol {XLSTM_TOL:.0e})")
    require(worst <= XLSTM_TOL and max(states) <= XLSTM_TOL,
            "xlstm-parity decode differs")
    require(int(caches["card"]["index"]) == XLSTM_STEPS,
            "xlstm-parity: cache index")

    (l_c, _), g_c = engine.value_and_grad_aux(
        lambda p: cpu.loss_and_acc(p, x, y), params_c)
    (l_g, _), g_g = engine.value_and_grad_aux(
        lambda p: gpu.loss_and_acc(p, x.cuda(), y.cuda()), params_g)
    errs = _leaf_errs(g_g, g_c)
    worst = max(e / m if m > 0 else e for e, m in errs)
    log(f"[xlstm-parity] loss card {float(l_g):.6f} cpu {float(l_c):.6f}; "
        f"{len(errs)} gradient leaves, worst error {worst:.3e} relative to "
        f"the leaf's max |grad| (tol {XLSTM_GRAD_TOL:.0e})")
    require(abs(float(l_g) - float(l_c)) <= XLSTM_TOL * float(l_c),
            "xlstm-parity: loss differs")
    require(worst <= XLSTM_GRAD_TOL, f"xlstm-parity gradient {worst:.3e}")
    del g_c, g_g

    # one FedDUM round: 2 clients x 1 local step and 1 server step
    eng = EngineConfig(lr=3e-3, lr_decay=1.0, use_server_update=True,
                       local_momentum="restart", server_momentum=True)

    def toks(*lead):
        t = rng.integers(0, cfg.vocab_size, lead + (33,))
        return (torch.from_numpy(t[..., :-1].astype(np.int32)),
                torch.from_numpy(t[..., 1:].astype(np.int32)))

    batch_c = {"client": toks(2, 1, b), "sizes": torch.tensor([8.0, 8.0]),
               "server": toks(1, b), "d_round": torch.tensor(0.3),
               "d_server": torch.tensor(0.02), "n0": torch.tensor(8.0)}
    deltas = {}
    for name, model, params in (("cpu", cpu, params_c),
                                ("card", gpu, params_g)):
        dev = "cpu" if name == "cpu" else "cuda"
        state = engine.init_round_state(tree_map(torch.clone, params), eng)
        before = tree_map(torch.clone, state["params"])
        grad_fn, la_fn = backend.model_fns(model, eng)
        state, met = engine.round_core(
            eng, grad_fn, la_fn, state,
            tree_map(lambda t: t.to(dev), batch_c))
        deltas[name] = tree_map(lambda a, b_: (a - b_).cpu(), state["params"],
                                before)
        log(f"[xlstm-parity] one FedDUM round on the {name}: tau_eff "
            f"{float(met['tau_eff']):.6f}, server acc "
            f"{float(met['server_acc']):.4f}")
        del state, before
    _round_update_check(torch, "[xlstm-parity]", deltas, params_c)

    # bf16: the blocks on one input, then the LM against its f32 logits
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    cpu16, gpu16 = LM(cfg16, device="cpu"), LM(cfg16, device="cuda")
    p16_c = cpu16.init(torch.Generator().manual_seed(13))  # lint: generator-ok (the bf16 model: a fixed input of its own)
    p16_g = interop.params_from_jax(p16_c, "cuda")
    h = torch.randn((b, s_len, cfg.d_model), generator=torch.Generator()
                    .manual_seed(14)).to(torch.bfloat16)
    meta = layers.mlstm_meta(cfg)
    with torch.no_grad():
        for name, fn in (("l0", layers.apply_mlstm), ("l3", layers.apply_slstm)):
            want = fn(p16_c["blocks"][name]["cell"], h, meta, cfg16)
            got = fn(p16_g["blocks"][name]["cell"], h.cuda(), meta, cfg16)
            err, rel = max_rel_err(torch, got.cpu(), want)
            log(f"[xlstm-parity] bf16 {fn.__name__} (layer {name}): "
                f"max_abs_err={err:.3e} rel={rel:.3e} (tol "
                f"{XLSTM_BF16_BLOCK_TOL:.2e})")
            require(got.dtype == torch.bfloat16 and rel <= XLSTM_BF16_BLOCK_TOL,
                    f"xlstm-parity bf16 {fn.__name__}: {rel:.3e}")
    p32 = tree_map(lambda t: t.float(), p16_c)
    toks_ = x[:, :XLSTM_STEPS]
    with torch.inference_mode():
        out = {"exact": (cpu.apply(p32, {"tokens": x}), []),
               "cpu": (cpu16.apply(p16_c, {"tokens": x}).float(), []),
               "card": (gpu16.apply(p16_g, {"tokens": x.cuda()}).float()
                        .cpu(), [])}
        runs = {"exact": (cpu, p32, "cpu"), "cpu": (cpu16, p16_c, "cpu"),
                "card": (gpu16, p16_g, "cuda")}
        for key, (model, params, dev) in runs.items():
            cache = model.init_cache(b, XLSTM_STEPS)
            for t in range(XLSTM_STEPS):
                logits, cache = model.decode_step(
                    params, cache, {"tokens": toks_[:, t:t + 1].to(dev)})
                out[key][1].append(logits.float().cpu())
    for i, what in enumerate(("forward", f"{XLSTM_STEPS} decode steps")):
        exact = out["exact"][i] if i == 0 else torch.cat(out["exact"][1])
        d_cpu, d_card = (_rms(torch, (out[k][i] if i == 0 else
                                      torch.cat(out[k][1])) - exact)
                         for k in ("cpu", "card"))
        log(f"[xlstm-parity] bf16 {what}: RMS distance from the f32 logits "
            f"card {d_card:.4e}, cpu {d_cpu:.4e} (card within "
            f"{XLSTM_BF16_RATIO} x cpu)")
        require(d_card <= XLSTM_BF16_RATIO * d_cpu,
                f"xlstm-parity bf16 {what}: card {d_card:.4e} cpu {d_cpu:.4e}")


XLSTM_SCORE = (4, 2048)                         # B x S per forward
# the profiled forward's S: the profiler costs ~0.6 ms a launch, and a
# forward at S = 2048 launches ~150k kernels (the sLSTM's loop over S)
XLSTM_PROFILE_S = 256
XLSTM_SERVE = dict(batch=8, prompt=64, new=64)
# each example script's arguments (none: its defaults) and a line it must
# print; the LM training driver runs at its defaults (the local backend)
# and on the mesh backend
XLSTM_EXAMPLES = (("serve_decode_torch.py", (),
                   r"arch=olmo-1b \(reduced, dense\)"),
                  ("fl_llm_train_torch.py", (), r"round +20  loss "),
                  ("fl_llm_train_torch.py", ("--rounds", "2", "--backend",
                                             "mesh"), r"round +2  loss "))


def phase_xlstm(torch) -> dict:
    """xlstm-125m at full width and depth (12 layers: 9 mLSTM, 3 sLSTM),
    seeded weights: bf16 scoring through ``load_servable(...,
    attn_impl="pallas")`` -> ``loss_and_acc`` at B = 4 x S = 2048, bf16
    serving through ``lockstep_decode`` (8 prompts of 64 tokens, 64 new) with
    a profiled window and one under sync-debug "error", f32 FedDUM training
    at S = 128 (the training phase's config without FedAP: one round and an
    Eval, then two timed rounds), then the two LM example scripts as
    subprocesses (XLSTM_EXAMPLES).  No TPU kernel lies on the family's path:
    returns {}."""
    import dataclasses
    import re

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.plan import TrainPlan
    from repro_torch.core.rounds import FederatedTrainer, feddumap_config
    from repro_torch.data.pipeline import build_lm_federated_data
    from repro_torch.data.synthetic import TokenSpec
    from repro_torch.models.lm import LM
    from repro_torch.serving import load_servable, lockstep_decode
    from repro_torch.utils.tree import tree_size

    cfg = get_config("xlstm-125m")
    model = LM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    kinds = ["s" if model._is_slstm(i) else "m" for i in range(cfg.num_layers)]
    log(f"[xlstm] xlstm-125m full width: {cfg.num_layers} layers "
        f"({kinds.count('m')} mLSTM, {kinds.count('s')} sLSTM), d_model="
        f"{cfg.d_model}, {tree_size(params) / 1e6:.3f} M params, "
        f"{cfg.param_dtype}")
    sv = load_servable({"params": params, "kept": None, "mode": None,
                        "model_config": cfg}, "dense", attn_impl="pallas",
                       device="cuda")
    del model, params
    rng = np.random.default_rng(0)

    # scoring: one timed forward, and a shorter one timed and profiled
    t_part = time.perf_counter()
    b, s_len = XLSTM_SCORE
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s_len + 1))
                           .astype(np.int64)).cuda()
    x, y = seq[:, :-1], seq[:, 1:]

    def forward(s=s_len):
        return sv.model.loss_and_acc(sv.params, x[:, :s], y[:, :s])

    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, acc = forward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"[scoring] xlstm-125m dense: loss {float(loss):.6f} acc "
            f"{float(acc):.6f}; {b * s_len} tokens in {wall:.4f} s -> "
            f"{b * s_len / wall:.1f} tokens/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        require(math.isfinite(float(loss)) and 0.0 < float(loss)
                < 2 * math.log(cfg.vocab_size) and 0.0 <= float(acc) <= 1.0,
                f"scoring xlstm: loss {float(loss)}, acc {float(acc)}")
        t0 = time.perf_counter()
        forward(XLSTM_PROFILE_S)
        torch.cuda.synchronize()
        short = time.perf_counter() - t0
        _profile_forward(torch, f"xlstm-125m dense (B={b} x S="
                         f"{XLSTM_PROFILE_S})", lambda: forward(
                             XLSTM_PROFILE_S), short)
    del x, y, seq
    log(f"[xlstm] scoring part: {time.perf_counter() - t_part:.1f} s")

    # serving: the lockstep loop
    t_part = time.perf_counter()
    bs, p_len, n_new = (XLSTM_SERVE[k] for k in ("batch", "prompt", "new"))
    cache_len = p_len + n_new
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (bs, p_len))
                              .astype(np.int32))
    lockstep_decode(sv.model, sv.params, prompt[:, :4], 4)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    got, steps = lockstep_decode(sv.model, sv.params, prompt, n_new,
                                 timings=timings)
    pre, dec = timings["prefill_s"], timings["decode_s"]
    log(f"[serving] xlstm-125m: B={bs}, {steps} decode steps (prefill "
        f"{pre:.3f} s, {1e3 * pre / p_len:.3f} ms/step; decode {dec:.3f} s, "
        f"{1e3 * dec / n_new:.3f} ms/step) -> {bs * n_new / dec:.1f} "
        f"tokens/s generated, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(steps == p_len + n_new and tuple(got.shape) == (bs, n_new)
            and int(got.min()) >= 0 and int(got.max()) < cfg.vocab_size,
            "serving xlstm: malformed tokens")
    _profile_lockstep(torch, "xlstm-125m", sv, prompt, cache_len)
    _sync_free_lockstep(torch, "xlstm-125m", sv, prompt, cache_len)
    _capture_lockstep(torch, "xlstm-125m", sv, prompt, n_new, cache_len)
    del sv
    log(f"[xlstm] serving part: {time.perf_counter() - t_part:.1f} s")

    # training: FedDUM in f32 at S = 128
    t_part = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    model = LM(cfg32, device="cuda")
    data = build_lm_federated_data(
        num_clients=4, server_fraction=0.25,
        spec=TokenSpec(vocab_size=cfg.vocab_size, num_topics=8, seq_len=129,
                       num_sequences=45))
    fl = feddumap_config(num_clients=4, clients_per_round=2, batch_size=4,
                         server_batch_size=4, local_epochs=1, lr=3e-3,
                         lr_decay=1.0)
    trainer = FederatedTrainer(model, data, fl, device="cuda")
    backend = trainer.backend()
    kw = backend.sample_kw
    seq_len = data.client_x.shape[-1]
    tokens_per_round = seq_len * (kw["clients_per_round"] * kw["local_steps"]
                                  * kw["batch_size"]
                                  + kw["server_tau"] * kw["server_batch"])
    params = model.init(torch.Generator(device="cuda").manual_seed(0))  # lint: generator-ok (the training run: a fixed input of its own)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = trainer.run(TrainPlan.standard(1), params=params)
    del params
    state = res.state
    t0 = time.perf_counter()
    state, _ = backend.run_rounds(state, 1, 2)
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / 2
    loss, acc = backend.evaluate(state)
    h = res.history
    log(f"[training] xlstm-125m f32: S={seq_len}, per round "
        f"{kw['clients_per_round']} clients x {kw['local_steps']} local steps "
        f"of B={kw['batch_size']} + tau={kw['server_tau']} server steps of "
        f"B={kw['server_batch']}, {tokens_per_round} tokens; round 1 test "
        f"loss {h['loss'][0]:.6f} acc {h['acc'][0]:.4f} tau_eff "
        f"{h['tau_eff'][0]:.6f}; after round 3 loss {float(loss):.6f} acc "
        f"{float(acc):.4f}; steady state {round_s:.3f} s/round -> "
        f"{tokens_per_round / round_s:.1f} tokens/s trained, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(all(math.isfinite(v) for k in ("loss", "acc", "tau_eff")
                for v in h[k]) and math.isfinite(float(loss)),
            "training xlstm: history not finite")
    del res, state, trainer, backend, model
    log(f"[xlstm] training part: {time.perf_counter() - t_part:.1f} s")

    # the two LM example scripts (the training one on the mesh backend, a
    # world of one over NCCL in its own process)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for script, args, first in XLSTM_EXAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable,
                               os.path.join(ROOT, "examples", script),
                               *args],
                              cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=300)
        lines = proc.stdout.strip().splitlines()
        for line in lines[-4:]:
            log(f"[xlstm] {script}: {line}")
        log(f"[xlstm] {script} {' '.join(args)} exited {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s")
        require(proc.returncode == 0, f"{script} failed:\n{proc.stderr}")
        require(any(re.match(first, line) for line in lines),
                f"{script}: no line matches {first!r}")
    return {}


MOE_TOL = 1e-4      # f32 card against CPU: logits relative to max(1, max
                    # |cpu|), the loss relative to itself (PARITY_TOL's)
MOE_LAYER_TOL = 1e-5    # one apply_moe: y and both aux losses
MOE_STEPS = 8           # teacher-forced decode steps of the parity check


def _moe_parity_cfgs():
    """The parity configs: arctic-480b and llama4-maverick reduced (2
    layers, d 256, 4 experts), with their own head layouts (56 and 40 heads
    of 128 padded to 64 and 48 over 8 kv heads: G = 8 and G = 6), f32."""
    from repro_torch.configs import get_config

    return [get_config(arch).reduced(num_heads=h, num_kv_heads=8,
                                     head_dim=128)
            for arch, h in (("arctic-480b", 56),
                            ("llama4-maverick-400b-a17b", 40))]


def phase_moe_parity(torch) -> None:
    """The moe family card against CPU in f32 (TF32 off) from the same
    params: one ``apply_moe`` (y and both auxiliary losses), the forward's
    logits through plain attention and through K4, the loss with its aux
    and every gradient leaf (the router's through the gate scale and the
    losses), and teacher-forced decode steps from per-slot fill levels
    (K5 at G = 8 and 6); then fedap_lm at rate 0.5 on a 16-expert arctic on
    the card: its kept experts equal the CPU's, and a leaf-at-a-time prune
    (``take_experts``, what the moe phase does) equals it bitwise."""
    import dataclasses

    import numpy as np

    from repro_torch import interop
    from repro_torch.core import engine, pruning_lm
    from repro_torch.models import layers
    from repro_torch.models.lm import LM
    from repro_torch.utils.tree import tree_map

    rng = np.random.default_rng(21)
    cfgs = _moe_parity_cfgs()
    for cfg in cfgs:
        name = cfg.name
        cpu = LM(cfg, device="cpu")
        gpu, gpu_k4 = (LM(cfg, device="cuda", attn_impl=impl)
                       for impl in ("xla", "pallas"))
        params_c = cpu.init(torch.Generator().manual_seed(22))
        params_g = interop.params_from_jax(params_c, "cuda")
        b, s_len = 2, 64
        seq = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (b, s_len + 1)).astype(np.int32))
        x, y = seq[:, :-1], seq[:, 1:]
        log(f"[moe-parity] {name} reduced: {cfg.num_layers} layers, d_model="
            f"{cfg.d_model}, {cfg.padded_num_heads} heads (of "
            f"{cfg.num_heads}) over {cfg.padded_num_kv_heads} kv heads of "
            f"{cfg.resolved_head_dim}, {cfg.moe.num_experts} experts top-"
            f"{cfg.moe.top_k}, f32, B={b} S={s_len}")

        h = torch.randn((b, s_len, cfg.d_model),
                        generator=torch.Generator().manual_seed(23))  # lint: generator-ok (the layer input: a fixed input of its own)
        layer_c = tree_map(lambda t: t[0], params_c["layers"]["moe"])
        layer_g = interop.params_from_jax(layer_c, "cuda")
        with torch.no_grad():
            yc, aux_c = layers.apply_moe(layer_c, h, cfg)
            yg, aux_g = layers.apply_moe(layer_g, h.cuda(), cfg)
        errs = [max_rel_err(torch, yg.cpu(), yc)[1]] + [
            abs(float(aux_g[k]) - float(aux_c[k])) / abs(float(aux_c[k]))
            for k in ("load_balance", "router_z")]
        log(f"[moe-parity] {name} apply_moe: y rel {errs[0]:.3e}, "
            f"load_balance {float(aux_g['load_balance']):.6e} rel "
            f"{errs[1]:.3e}, router_z {float(aux_g['router_z']):.6e} rel "
            f"{errs[2]:.3e} (tol {MOE_LAYER_TOL:.0e})")
        require(max(errs) <= MOE_LAYER_TOL, f"moe-parity {name} apply_moe")

        with torch.no_grad():
            want = cpu.apply(params_c, {"tokens": x})
            for model, what in ((gpu, "plain attention"), (gpu_k4, "K4")):
                got = model.apply(params_g, {"tokens": x.cuda()})
                err, rel = max_rel_err(torch, got.cpu(), want)
                log(f"[moe-parity] {name} forward logits ({what}): "
                    f"max_abs_err={err:.3e} rel={rel:.3e} (tol "
                    f"{MOE_TOL:.0e})")
                require(bool(torch.isfinite(got).all()) and rel <= MOE_TOL,
                        f"moe-parity {name} forward ({what}): {rel:.3e}")

        (l_c, _), g_c = engine.value_and_grad_aux(
            lambda p: cpu.loss_and_acc(p, x, y), params_c)
        (l_g, _), g_g = engine.value_and_grad_aux(
            lambda p: gpu.loss_and_acc(p, x.cuda(), y.cuda()), params_g)
        errs = _leaf_errs(g_g, g_c)
        worst = max(e / m if m > 0 else e for e, m in errs)
        router = float(g_g["layers"]["moe"]["router"].abs().max())
        log(f"[moe-parity] {name} loss (with aux) card {float(l_g):.6f} cpu "
            f"{float(l_c):.6f}; {len(errs)} gradient leaves, worst error "
            f"{worst:.3e} relative to the leaf's max |grad| (tol "
            f"{TRAIN_TOL:.0e}); router max |grad| {router:.3e}")
        require(abs(float(l_g) - float(l_c)) <= MOE_TOL * float(l_c),
                f"moe-parity {name}: loss differs")
        require(worst <= TRAIN_TOL and router > 0,
                f"moe-parity {name} gradient {worst:.3e}")
        del g_c, g_g

        start = np.array([0, 5, 17, 3], np.int32)         # fill levels
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (start.size, MOE_STEPS)).astype(np.int32))
        caches = {"cpu": cpu.init_cache(start.size, 32),
                  "card": gpu.init_cache(start.size, 32)}
        caches["cpu"]["index"] = torch.from_numpy(start)
        caches["card"]["index"] = torch.from_numpy(start).cuda()
        worst = 0.0
        with torch.inference_mode():
            for t in range(MOE_STEPS):
                lc, caches["cpu"] = cpu.decode_step(
                    params_c, caches["cpu"], {"tokens": toks[:, t:t + 1]})
                lg, caches["card"] = gpu.decode_step(
                    params_g, caches["card"],
                    {"tokens": toks[:, t:t + 1].cuda()})
                worst = max(worst, max_rel_err(torch, lg.cpu(), lc)[1])
        log(f"[moe-parity] {name} {MOE_STEPS} decode steps from fill levels "
            f"{start.tolist()}: worst logits rel {worst:.3e} (tol "
            f"{MOE_TOL:.0e})")
        require(worst <= MOE_TOL, f"moe-parity {name} decode: {worst:.3e}")
        del params_c, params_g, caches

    cfg = dataclasses.replace(cfgs[0], moe=dataclasses.replace(
        cfgs[0].moe, num_experts=16))
    params = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(24))
    want, cfg_half, info = pruning_lm.fedap_lm(params, cfg, 0.5)
    cpu_half, _, _ = pruning_lm.fedap_lm(
        interop.params_from_jax(params, "cpu"), cfg, 0.5)
    idx = pruning_lm.expert_kept_indices(
        params, cfg, 0.5, min_keep=pruning_lm.fedap_min_keep(cfg))
    moe = dict(params["layers"]["moe"])
    for leaf in pruning_lm.EXPERT_AXIS:
        moe[leaf] = pruning_lm.take_experts(moe.pop(leaf), leaf, idx)
    same = all(torch.equal(moe[k], want["layers"]["moe"][k])
               for k in pruning_lm.EXPERT_AXIS)
    same_cpu = torch.equal(want["layers"]["moe"]["router"].cpu(),
                           cpu_half["layers"]["moe"]["router"])
    log(f"[moe-parity] fedap_lm(0.5) on {cfg.moe.num_experts} experts: kept "
        f"{info['kept']} ({idx.tolist()}); the CPU keeps the same: "
        f"{same_cpu}; leaf-at-a-time prune bitwise equal: {same}")
    require(cfg_half.moe.num_experts == 8 and same and same_cpu,
            "moe-parity: expert pruning differs")


MOE_SERVE = dict(slots=8, cache_len=512, max_prompt=64, max_new_tokens=64,
                 steps_per_wave=8)                # olmo-1b's serving phase
MOE_SCORE = (4, 2048)                             # B x S per forward
MOE_LAYERS = 2                                    # of arctic-480b's 35


def _moe_train_cfg():
    """arctic-480b's structure cut to train in f32 on one card: 4 layers,
    d 2048, 14 heads padded to 16 over 2 kv heads of 128, 16 experts of
    1216 (top-2, capacity 1.25) plus the dense residual FFN of 1216."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config("arctic-480b")
    return dataclasses.replace(
        cfg, num_layers=4, d_model=2048, num_heads=14, num_kv_heads=2,
        head_dim=128, d_ff=1216, param_dtype="float32", remat="none",
        moe=dataclasses.replace(cfg.moe, num_experts=16, expert_d_ff=1216,
                                dense_d_ff=1216))


def phase_moe(torch) -> dict:
    """arctic-480b at full width (d 7168, 56 heads padded to 64 over 8 kv
    heads, 128 experts of 4864 top-2 plus the dense residual FFN, vocab
    32000) cut to 2 of its 35 layers, bf16, seeded weights: scoring through
    ``load_servable(attn_impl="pallas")`` at B = 4 x S = 2048 (K4 2 a
    forward) and serving through ``DecodeEngine`` at olmo-1b's settings (K5
    2 a step, a profiled wave, one under sync-debug "error"), first
    ``dense``, then ``experts@0.5``: ``fedap_lm(params, cfg, 0.5)``'s
    model, 64 of 128 experts, gathered a leaf at a time with each dense
    leaf let go (the dense model and a fresh half stack do not fit the card
    together); then f32 FedDUM training of arctic's structure cut to fit
    (:func:`_moe_train_cfg`) at S = 128, two runs of one round from one
    state bitwise equal, then timed rounds.  Returns {kernel name:
    launches over the timed scoring forwards and serving runs}."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import pruning_lm
    from repro_torch.core.plan import TrainPlan
    from repro_torch.core.rounds import FederatedTrainer, feddumap_config
    from repro_torch.data.pipeline import build_lm_federated_data
    from repro_torch.data.synthetic import TokenSpec
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.models.lm import LM
    from repro_torch.serving import DecodeEngine, ServeConfig, load_servable
    from repro_torch.utils.tree import tree_size

    cfg = dataclasses.replace(get_config("arctic-480b"),
                              num_layers=MOE_LAYERS)
    t_part = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"[moe] arctic-480b full width, {cfg.num_layers} of 35 layers: "
        f"{tree_size(params) / 1e9:.3f} B params, {cfg.param_dtype}, "
        f"{cfg.padded_num_heads} heads over {cfg.padded_num_kv_heads} kv "
        f"heads, {cfg.moe.num_experts} experts of {cfg.moe.expert_d_ff}; "
        f"init {time.perf_counter() - t_part:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(0)
    b, s_len = MOE_SCORE
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s_len + 1))
                           .astype(np.int64)).cuda()
    x, y = seq[:, :-1], seq[:, 1:]
    scfg = ServeConfig(**MOE_SERVE)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(1, 65)))
               .astype(np.int32) for _ in range(16)]
    launches = {"decode_attention": 0, "flash_attention": 0}
    losses = {}
    for mode in ("dense", "experts@0.5"):
        if mode != "dense":
            t0 = time.perf_counter()
            idx = pruning_lm.expert_kept_indices(
                params, cfg, 0.5, min_keep=pruning_lm.fedap_min_keep(cfg))
            experts = cfg.moe.num_experts
            moe = params["layers"]["moe"]
            for leaf in pruning_lm.EXPERT_AXIS:
                moe[leaf] = pruning_lm.take_experts(moe.pop(leaf), leaf, idx)
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, num_experts=int(idx.shape[1])))
            torch.cuda.synchronize()
            log(f"[moe] fedap_lm(0.5): kept {cfg.moe.num_experts} of "
                f"{experts} experts a layer in {time.perf_counter() - t0:.1f} s; "
                f"{tree_size(params) / 1e9:.3f} B params")
        sv = load_servable({"params": params, "kept": None, "mode": None,
                            "model_config": cfg}, "dense", attn_impl="pallas",
                           device="cuda")
        require(sv.model.cfg.moe.num_experts == cfg.moe.num_experts,
                f"moe {mode}: load_servable's expert count")

        def forward():
            return sv.model.loss_and_acc(sv.params, x, y)

        with torch.no_grad():
            forward()                                          # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k4.launches = 0
            t0 = time.perf_counter()
            loss, acc = forward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n4 = k4.launches
            log(f"[scoring] arctic-480b {mode}: loss {float(loss):.6f} acc "
                f"{float(acc):.6f}; {b * s_len} tokens in {wall:.4f} s -> "
                f"{b * s_len / wall:.1f} tokens/s, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                f"launches flash_attention={n4} (expected {cfg.num_layers})")
            require(n4 == cfg.num_layers, f"scoring arctic {mode}: K4 "
                    f"launched {n4} times")
            require(math.isfinite(float(loss)) and 0.0 < float(loss)
                    < 2 * math.log(cfg.vocab_size) and
                    0.0 <= float(acc) <= 1.0,
                    f"scoring arctic {mode}: loss {float(loss)}")
            launches["flash_attention"] += n4
            losses[mode] = float(loss)
            _profile_forward(torch, f"arctic-480b {mode}", forward, wall)

        DecodeEngine(sv.model, sv.params, scfg, device="cuda").run(
            prompts[:2])                                       # warm-up
        eng = DecodeEngine(sv.model, sv.params, scfg, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k5.launches = 0
        t0 = time.perf_counter()
        done = eng.run(prompts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n5 = k5.launches
        n_tok = sum(len(c.tokens) for c in done)
        log(f"[serving] arctic-480b {mode}: {len(done)} requests, {n_tok} "
            f"tokens, {eng.steps} decode steps in {dt:.3f} s -> "
            f"{n_tok / dt:.1f} tokens/s, {1e3 * dt / eng.steps:.3f} ms/step, "
            f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches decode_attention={n5}")
        require(len(done) == len(prompts) and
                all(c.status == "ok" and len(c.tokens) == scfg.max_new_tokens
                    and int(c.tokens.min()) >= 0
                    and int(c.tokens.max()) < cfg.vocab_size for c in done),
                f"serving arctic {mode}: malformed completions")
        require(n5 == eng.steps * cfg.num_layers, f"serving arctic {mode}: "
                f"decode_attention launched {n5} times, expected "
                f"{eng.steps} x {cfg.num_layers}")
        launches["decode_attention"] += n5
        _profile_wave(torch, f"arctic-480b {mode}", sv, scfg, prompts)
        _sync_free_wave(torch, sv, scfg, prompts)
        del sv, eng, done
        torch.cuda.empty_cache()
    log(f"[moe] arctic-480b scoring loss dense {losses['dense']:.6f}, "
        f"experts@0.5 {losses['experts@0.5']:.6f}")
    del params, moe, x, y, seq
    torch.cuda.empty_cache()
    log(f"[moe] scoring and serving part: {time.perf_counter() - t_part:.1f} "
        f"s")

    t_part = time.perf_counter()
    cfg = _moe_train_cfg()
    model = LM(cfg, device="cuda")
    data = build_lm_federated_data(
        num_clients=4, server_fraction=0.25,
        spec=TokenSpec(vocab_size=cfg.vocab_size, num_topics=8, seq_len=129,
                       num_sequences=45))
    fl = feddumap_config(num_clients=4, clients_per_round=2, batch_size=4,
                         server_batch_size=4, local_epochs=1, lr=3e-3,
                         lr_decay=1.0)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))  # lint: generator-ok (the training run: a fixed input of its own)
    runs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        trainer = FederatedTrainer(model, data, fl, device="cuda")
        res = trainer.run(TrainPlan.standard(1), params=params)
        runs.append((trainer, res))
    diff = _same_run(torch, *runs)
    backend = runs[0][0].backend()
    kw = backend.sample_kw
    seq_len = data.client_x.shape[-1]
    tokens_per_round = seq_len * (kw["clients_per_round"] * kw["local_steps"]
                                  * kw["batch_size"]
                                  + kw["server_tau"] * kw["server_batch"])
    h = runs[0][1].history
    log(f"[training] arctic-480b cut to {cfg.num_layers} layers, d_model="
        f"{cfg.d_model}, {cfg.padded_num_heads} heads (of {cfg.num_heads}) "
        f"over {cfg.padded_num_kv_heads}, {cfg.moe.num_experts} experts of "
        f"{cfg.moe.expert_d_ff} + dense {cfg.moe.dense_d_ff}, f32, "
        f"{tree_size(params) / 1e6:.1f} M params: round 1 test loss "
        f"{h['loss'][0]:.6f} acc {h['acc'][0]:.4f} tau_eff "
        f"{h['tau_eff'][0]:.6f}; two runs of the round from one state "
        f"bitwise equal: {not diff} {diff}")
    require(not diff, f"training arctic: two identical runs differ: {diff}")
    require(all(math.isfinite(v) for k in ("loss", "acc", "tau_eff")
                for v in h[k]), "training arctic: history not finite")
    state = runs[1][1].state
    del runs
    t0 = time.perf_counter()
    state, _ = backend.run_rounds(state, 1, 2)
    torch.cuda.synchronize()
    round_s = (time.perf_counter() - t0) / 2
    loss, acc = backend.evaluate(state)
    log(f"[training] arctic-480b f32: S={seq_len}, per round "
        f"{kw['clients_per_round']} clients x {kw['local_steps']} local steps "
        f"of B={kw['batch_size']} + tau={kw['server_tau']} server steps of "
        f"B={kw['server_batch']}, {tokens_per_round} tokens; after round 3 "
        f"loss {float(loss):.6f} acc {float(acc):.4f}; steady state "
        f"{round_s:.3f} s/round -> {tokens_per_round / round_s:.1f} tokens/s "
        f"trained, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(math.isfinite(float(loss)), "training arctic: loss not finite")
    log(f"[moe] training part: {time.perf_counter() - t_part:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# the vlm and encdec families: qwen2-vl-7b and whisper-small
# ---------------------------------------------------------------------------

def _vlm_whisper_kernels(torch, timer, gen) -> dict:
    """The kernels at the vlm and encdec paths' shapes, each against its
    plain version (f32 and bf16; two launches bitwise equal) and timed in
    bf16 beside its bound and one library call:

    * K4 at qwen2-vl's scoring (B=4, S=2048, 28 heads padded to 32 over 4
      kv heads of 128, causal; ``qwen_*`` keys, SDPA with ``enable_gqa``),
      whisper's decoder self-attention (B=8, S=448, 12 heads padded to 16
      over 16 of 64, causal; ``whisper_*``) and its cross-attention (B=8,
      Sq=448 queries over Skv=1500 encoder frames, no mask: 11 kv tiles of
      128 plus 92 keys, 3.5 query tiles; ``cross_*``, SDPA with
      ``is_causal=False``), and the cross case the other way round (Sq=1500
      over Skv=448, untimed);
    * K5 at qwen2-vl's serving (B=8, S=512, 32 heads over 4: G = 8, a
      wave's lengths with stale NaN rows; ``qwen_*``) and whisper's
      lockstep decode (B=8, S=128, 16 over 16, every length index + 1;
      ``whisper_*``);
    * K1 at qwen2-vl's FFN (K=3584, N=18944: 148 column blocks) in bf16 at
      decode (M=8, all kept and half; ``qwen_decode_*``) and at scoring
      (M=8192; ``qwen_scoring_*``), and K1, K2, K3 in f32 at training
      (M=512; K1 ``qwen_train_*``, K2 and K3 ``qwen_*``), beside
      ``torch.matmul``.
    Returns {kernel name: {key: value}} to add to the records."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.kernels import ref

    out = {name: {} for name in ("flash_attention", "decode_attention",
                                 "masked_matmul", "masked_matmul_dx",
                                 "masked_matmul_dw")}
    # tag, B, Sq, Skv, H, KV, hd, causal, timed
    for tag, b, sq, skv, h, kvh, hd, causal, timed in (
            ("qwen", 4, 2048, 2048, 32, 4, 128, True, True),
            ("whisper", 8, 448, 448, 16, 16, 64, True, True),
            ("cross", 8, 448, 1500, 16, 16, 64, False, True),
            ("cross-wide", 2, 1500, 448, 16, 16, 64, False, False)):
        label = (f"{tag} B={b} Sq={sq} Skv={skv} H={h} KV={kvh} hd={hd} "
                 f"{'causal' if causal else 'no mask'}")
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q = torch.randn((b, sq, h, hd), generator=gen,
                            device="cuda").to(dtype)
            k, v = (torch.randn((b, skv, kvh, hd), generator=gen,
                                device="cuda").to(dtype) for _ in range(2))
            got = k4.flash_attention(q, k, v, causal=causal)
            again = k4.flash_attention(q, k, v, causal=causal)
            want = ref.flash_attention_ref(q, k, v, causal=causal)
            err = _k4_check(torch, label, dname, got, want, again)
            del got, again
            if not timed or dtype != torch.bfloat16:
                del want
                continue
            perm = torch.tensor(_gqa_heads(h, kvh), device="cuda")
            qt = q[:, :, perm].transpose(1, 2).contiguous()
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=kvh != h)

            lib = torch.empty_like(q)
            lib[:, :, perm] = sdpa().transpose(1, 2)
            require(max_rel_err(torch, lib, want)[1] <= 2 * BF16_STEP,
                    f"sdpa at {tag} is not the same function")
            del lib, want
            ms, lib_ms = timer.turns(
                lambda: k4.flash_attention(q, k, v, causal=causal), sdpa)
            plain_ms = timer(lambda: ref.flash_attention_ref(
                q, k, v, causal=causal))
            bound, by, flops = _k4_bound(b, sq, skv, h, kvh, hd, causal, None,
                                         q.element_size(), dname)
            log(f"[kernels] flash_attention {tag} {dname}: kernel {ms:.4f} ms"
                f" ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms,"
                f" sdpa{' (enable_gqa)' if kvh != h else ''}"
                f"{'' if causal else ' (is_causal=False)'} {lib_ms:.4f} ms "
                f"({ms / lib_ms:.3f}x), bound {bound:.4f} ms ({by}), "
                f"{100 * bound / ms:.1f}% of it")
            out["flash_attention"].update({
                f"{tag}_max_abs_err": err, f"{tag}_ms": ms,
                f"{tag}_plain_ms": plain_ms, f"{tag}_bound_ms": bound,
                f"{tag}_bound_by": by, f"{tag}_library_ms": lib_ms})
            del q, k, v, qt, kt, vt

    # K5: qwen2-vl's engine (lengths of a wave: prompts of 1-64 tokens plus
    # up to 32 new) and whisper's lockstep loop (every length the same)
    for tag, b, s, kvh, g, hd, lo, hi in (("qwen", 8, 512, 4, 8, 128, 1, 96),
                                          ("whisper", 8, 128, 16, 1, 64, 77,
                                           77)):
        h = g * kvh
        ln = torch.randint(lo, hi + 1, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            q, k, v = _k5_case(torch, gen, b, s, kvh, g, hd, dtype, ln)
            got = k5.decode_attention(q, k, v, ln)
            again = k5.decode_attention(q, k, v, ln)
            want = ref.decode_attention_ref(q, k, v, ln)
            torch.cuda.synchronize()
            err, rel = max_rel_err(torch, got, want)
            log(f"[kernels] decode_attention {tag} B={b} S={s} H={h} KV={kvh}"
                f" G={g} hd={hd} {dname} lengths {int(ln.min())}.."
                f"{int(ln.max())}: max_abs_err={err:.3e} rel={rel:.3e} (tol "
                f"{TOL[dname]:.3e}); two launches bitwise equal: "
                f"{bool(torch.equal(got, again))}")
            require(bool(torch.isfinite(got).all()) and rel <= TOL[dname],
                    f"decode_attention {tag} {dname}: error {rel:.3e}")
            require(torch.equal(got, again), f"decode_attention {tag} "
                    f"{dname}: two launches differ")
            if dtype != torch.bfloat16:
                continue
            perm = torch.tensor(_gqa_heads(h, kvh), device="cuda")
            qt = q[:, :, perm].transpose(1, 2).contiguous()
            kt = k.transpose(1, 2).contiguous().nan_to_num()
            vt = v.transpose(1, 2).contiguous()
            mask = (torch.arange(s, device="cuda")[None, :]
                    < ln[:, None])[:, None, None, :]

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=g > 1)

            lib = torch.empty_like(q)
            lib[:, :, perm] = sdpa().transpose(1, 2)
            require(max_rel_err(torch, lib, want)[1] <= 2 * TOL[dname],
                    f"sdpa at {tag} decode is not the same function")
            ms, lib_ms = timer.turns(
                lambda: k5.decode_attention(q, k, v, ln), sdpa)
            plain_ms = timer(lambda: ref.decode_attention_ref(q, k, v, ln))
            bound = _k5_bound_ms(b, h, kvh, hd, int(ln.sum()),
                                 q.element_size(), dname)
            log(f"[kernels] decode_attention {tag} G={g} {dname}: kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
                f"bound {bound:.4f} ms (bytes), {100 * bound / ms:.1f}% of it")
            out["decode_attention"].update({
                f"{tag}_max_abs_err": err, f"{tag}_ms": ms,
                f"{tag}_plain_ms": plain_ms, f"{tag}_bound_ms": bound,
                f"{tag}_bound_by": "bytes", f"{tag}_library_ms": lib_ms})

    # K1-K3 at qwen2-vl's FFN: up/gate [3584, 18944]
    kdim, n = 3584, 18944
    nb = n // 128
    half = torch.zeros(nb, device="cuda")
    half[torch.randperm(nb, generator=gen, device="cuda")[: nb // 2]] = 1.0
    ones = torch.ones(nb, device="cuda")
    # name, kind, dtype, M, masks, key prefix, plain, library
    cases = (
        ("masked_matmul", "fwd", torch.bfloat16, 8, (("ones", ones),
                                                     ("rate0.5", half)),
         "qwen_decode_"),
        ("masked_matmul", "fwd", torch.bfloat16, SCORE_M, (("ones", ones),),
         "qwen_scoring_"),
        ("masked_matmul", "fwd", torch.float32, TRAIN_M, (("ones", ones),),
         "qwen_train_"),
        ("masked_matmul_dx", "dx", torch.float32, TRAIN_M, (("ones", ones),),
         "qwen_"),
        ("masked_matmul_dw", "dw", torch.float32, TRAIN_M, (("ones", ones),),
         "qwen_"))
    fns = {"fwd": (k1.masked_matmul, ref.masked_matmul_ref,
                   lambda a, b: torch.matmul(a, b)),
           "dx": (k1.masked_matmul_dx, ref.masked_matmul_dx_ref,
                  lambda a, b: torch.matmul(a, b.T)),
           "dw": (k1.masked_matmul_dw, ref.masked_matmul_dw_ref,
                  lambda a, b: torch.matmul(a.T, b))}
    for name, kind, dtype, m, masks, prefix in cases:
        dname = str(dtype).split(".")[-1]
        fn, plain, lib = fns[kind]
        w = (torch.randn((kdim, n), generator=gen, device="cuda")
             / kdim ** 0.5).to(dtype)
        x = torch.randn((m, kdim), generator=gen, device="cuda").to(dtype)
        dy = torch.randn((m, n), generator=gen, device="cuda").to(dtype)
        a, b = {"fwd": (x, w), "dx": (dy, w), "dw": (x, dy)}[kind]
        for label, bm in masks:
            got = fn(a, b, bm)
            want = plain(a, b, bm)
            torch.cuda.synchronize()
            err, rel = max_rel_err(torch, got, want)
            same = bool(torch.equal(got, fn(a, b, bm)))
            log(f"[kernels] {name} qwen2-vl {label} {dname} M={m} K={kdim} "
                f"N={n}: max_abs_err={err:.3e} rel={rel:.3e} (tol "
                f"{TOL[dname]:.3e}); two launches bitwise equal: {same}")
            require(bool(torch.isfinite(got).all()) and rel <= TOL[dname],
                    f"{name} qwen2-vl {label} {dname} M={m}: {rel:.3e}")
            require(same, f"{name} qwen2-vl {label}: two launches differ")
            del got, want
            ms, lib_ms = timer.turns(lambda: fn(a, b, bm), lambda: lib(a, b))
            plain_ms = timer(lambda: plain(a, b, bm))
            kept = int((bm > 0).sum())
            bound, by = _mm_bound(kind, m, kdim, n, kept, a.element_size(),
                                  dname)
            log(f"[kernels] {name} qwen2-vl {dname} M={m} kept {kept}/{nb} "
                f"blocks: kernel {ms:.4f} ms "
                f"({2e-9 * m * kdim * 128 * kept / ms:.1f} TFLOP/s), plain "
                f"{plain_ms:.4f} ms, torch.matmul (all blocks) {lib_ms:.4f} "
                f"ms ({ms / lib_ms:.3f}x), bound {bound:.4f} ms ({by}), "
                f"{100 * bound / ms:.1f}% of it")
            key = prefix if label == "ones" else prefix + "half_"
            out[name].update({
                f"{key}max_abs_err": err, f"{key}ms": ms,
                f"{key}plain_ms": plain_ms, f"{key}bound_ms": bound,
                f"{key}bound_by": by, f"{key}library_ms": lib_ms})
        del w, x, dy, a, b
    return out


def vl_positions(torch, b, text, grid, after, device="cuda"):
    """[3, b, S] M-RoPE ids as Qwen2-VL builds them for ``text`` tokens, a
    ``grid`` (rows, cols) of vision patches, then ``after`` tokens: text
    takes t = h = w = i; the grid, starting at s0, takes t = s0, h = s0 +
    row, w = s0 + col; the text after it resumes at the maximum + 1."""
    gh, gw = grid
    t0 = torch.arange(text)
    rows = torch.arange(gh).repeat_interleave(gw)
    cols = torch.arange(gw).repeat(gh)
    s0 = text
    grid_ids = torch.stack([torch.full_like(rows, s0), s0 + rows, s0 + cols])
    nxt = int(grid_ids.max()) + 1
    tail = torch.arange(nxt, nxt + after)
    pos = torch.cat([t0.expand(3, -1), grid_ids, tail.expand(3, -1)], dim=1)
    return pos[:, None].expand(3, b, -1).to(device=device,
                                            dtype=torch.int32).contiguous()


def _vl_embeds(params, batch):
    """The input embeddings of a :func:`_vl_batch`: the embedding table's
    rows at the text tokens, the patch embeddings where ``loss_mask`` is 0
    (so a gradient reaches ``embed`` through the text)."""
    text = params["embed"][batch["tokens"]]
    return text.masked_scatter((batch["loss_mask"] == 0)[..., None],
                               batch["patches"].to(text.dtype))


def _vl_batch(torch, params, cfg, b, text, grid, after, seed):
    """A scoring batch of ``b`` sequences of text tokens, ``grid`` vision
    patches (seeded embeddings at the embedding table's scale) and text:
    ``embeds``, Qwen2-VL ``positions``, ``labels`` and a ``loss_mask`` that
    is 0 on the patches; ``tokens`` and ``patches`` (which the model does
    not read) rebuild the embeddings (:func:`_vl_embeds`)."""
    n_patch = grid[0] * grid[1]
    s_len = text + n_patch + after
    gen = torch.Generator(device="cuda").manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (b, s_len + 1), generator=gen,
                           device="cuda")
    patches = (torch.randn((b, n_patch, cfg.d_model), generator=gen,
                           device="cuda") / math.sqrt(cfg.d_model))
    loss_mask = torch.ones((b, s_len), device="cuda")
    loss_mask[:, text:text + n_patch] = 0.0
    batch = {"tokens": tokens[:, :-1], "patches": patches,
             "positions": vl_positions(torch, b, text, grid, after),
             "labels": tokens[:, 1:], "loss_mask": loss_mask}
    with torch.no_grad():
        batch["embeds"] = _vl_embeds(params, batch)
    return batch


VL_TOL = 1e-4       # f32 card against CPU (PARITY_TOL's; MOE_TOL's)


def _vlm_parity_cfg():
    """qwen2-vl reduced with its own head layout: 28 heads padded to 32
    over 4 kv heads of 128 (G = 8), 2 layers, d 256, f32."""
    from repro_torch.configs import get_config

    return get_config("qwen2-vl-7b").reduced(num_heads=28, num_kv_heads=4,
                                             head_dim=128)


def phase_vlm_parity(torch) -> None:
    """The vlm family card against CPU in f32 (TF32 off) from the same
    params: the forward's logits from embeds with Qwen2-VL M-RoPE positions
    through plain attention and through K4, the loss over a loss mask and
    every gradient leaf, and teacher-forced decode steps through the embeds
    path from per-slot fill levels (K5 at G = 8)."""
    import numpy as np

    from repro_torch import interop
    from repro_torch.core import engine
    from repro_torch.models.lm import LM

    cfg = _vlm_parity_cfg()
    cpu = LM(cfg, device="cpu")
    gpu, gpu_k4 = (LM(cfg, device="cuda", attn_impl=impl)
                   for impl in ("xla", "pallas"))
    params_c = cpu.init(torch.Generator().manual_seed(31))
    params_g = interop.params_from_jax(params_c, "cuda")
    batch_g = _vl_batch(torch, params_g, cfg, 2, 8, (6, 8), 24, 32)
    batch_c = {k: v.cpu() for k, v in batch_g.items()}
    log(f"[vlm-parity] qwen2-vl-7b reduced: {cfg.num_layers} layers, d_model"
        f"={cfg.d_model}, {cfg.padded_num_heads} heads (of {cfg.num_heads}) "
        f"over {cfg.padded_num_kv_heads} kv heads of "
        f"{cfg.resolved_head_dim}, f32; B=2 x S="
        f"{batch_c['labels'].shape[1]}: 8 text, a 6 x 8 patch grid, 24 text")
    with torch.no_grad():
        want = cpu.apply(params_c, batch_c)
        for model, what in ((gpu, "plain attention"), (gpu_k4, "K4")):
            got = model.apply(params_g, batch_g)
            err, rel = max_rel_err(torch, got.cpu(), want)
            log(f"[vlm-parity] forward logits ({what}): max_abs_err="
                f"{err:.3e} rel={rel:.3e} (tol {VL_TOL:.0e})")
            require(bool(torch.isfinite(got).all()) and rel <= VL_TOL,
                    f"vlm-parity forward ({what}): {rel:.3e}")
    (l_c, _), g_c = engine.value_and_grad_aux(
        lambda p: cpu._loss_acc(p, {**batch_c, "embeds": _vl_embeds(
            p, batch_c)}, None), params_c)
    (l_g, _), g_g = engine.value_and_grad_aux(
        lambda p: gpu._loss_acc(p, {**batch_g, "embeds": _vl_embeds(
            p, batch_g)}, None), params_g)
    errs = _leaf_errs(g_g, g_c)
    worst = max(e / m if m > 0 else e for e, m in errs)
    log(f"[vlm-parity] loss over the text (mask 0 on the patches) card "
        f"{float(l_g):.6f} cpu {float(l_c):.6f}; {len(errs)} gradient "
        f"leaves, worst error {worst:.3e} relative to the leaf's max |grad| "
        f"(tol {TRAIN_TOL:.0e})")
    require(abs(float(l_g) - float(l_c)) <= VL_TOL * float(l_c),
            "vlm-parity: loss differs")
    require(worst <= TRAIN_TOL, f"vlm-parity gradient {worst:.3e}")
    del g_c, g_g

    start = np.array([0, 5], np.int32)
    caches = {"cpu": cpu.init_cache(2, 64), "card": gpu.init_cache(2, 64)}
    caches["cpu"]["index"] = torch.from_numpy(start)
    caches["card"]["index"] = torch.from_numpy(start).cuda()
    worst = 0.0
    steps = 16
    with torch.inference_mode():
        for t in range(steps):
            step = {"embeds": batch_c["embeds"][:, t:t + 1],
                    "positions": batch_c["positions"][:, :, t:t + 1]
                    + torch.from_numpy(start)[None, :, None]}
            lc, caches["cpu"] = cpu.decode_step(params_c, caches["cpu"], step)
            lg, caches["card"] = gpu.decode_step(
                params_g, caches["card"],
                {k: v.cuda() for k, v in step.items()})
            worst = max(worst, max_rel_err(torch, lg.cpu(), lc)[1])
    log(f"[vlm-parity] {steps} decode steps through the embeds path from "
        f"fill levels {start.tolist()} (K5 at G = 8): worst logits rel "
        f"{worst:.3e} (tol {VL_TOL:.0e})")
    require(worst <= VL_TOL, f"vlm-parity decode: {worst:.3e}")


VLM_SCORE = (4, 64, (32, 32), 960)      # B; text, patch grid, text
VLM_SERVE = dict(slots=8, cache_len=512, max_prompt=64, max_new_tokens=32,
                 steps_per_wave=8)
# of qwen2-vl-7b's 28, f32: 4 peaked at 75.2 GiB eagerly; at 3 the captured
# round's graph pool (42.9 GiB) left too little for the FedAP decision
VLM_TRAIN_LAYERS = 2
VLM_PROFILE_STEPS = 2   # steps of the profiled wave (~1900 launches a step)
VLM_XLA_TOL = 1e-2      # bf16 loss, "pallas" against "xla", relative


def phase_vlm(torch) -> dict:
    """qwen2-vl-7b at full width and depth (28 layers, d 3584, 28 heads
    padded to 32 over 4 kv heads of 128, d_ff 18944, vocab 152064), bf16,
    seeded weights, in ``dense``, ``masked@0.5`` and ``shrunk@0.5`` modes:
    scoring through ``load_servable(attn_impl="pallas")`` then
    ``model.loss`` on B = 4 sequences of 64 text tokens, a 32 x 32 grid of
    vision-patch embeddings and 960 text tokens, with Qwen2-VL's M-RoPE
    positions and the loss masked off the patches (K4 28 a forward, K1 56
    masked), the dense loss held against ``attn_impl="xla"``; serving
    through ``DecodeEngine`` (8 prompts of 1-64 tokens, 32 new; K5 28 a
    step, K1 56 masked; a profiled wave of :data:`VLM_PROFILE_STEPS` steps,
    a wave under sync-debug "error");
    its FedDUMAP training in f32, cut to :data:`VLM_TRAIN_LAYERS` layers,
    is the ``training qwen2-vl`` phase (:func:`phase_training`: K1-K3),
    run beside the other training phases on a card with nothing else
    held.  Returns {kernel name: launches}."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.models.lm import LM
    from repro_torch.serving import DecodeEngine, ServeConfig, load_servable
    from repro_torch.utils.tree import tree_size

    cfg = get_config("qwen2-vl-7b")
    t_part = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = LM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    kept = model.decide_kept(params, 0.5)
    torch.cuda.synchronize()
    log(f"[vlm] qwen2-vl-7b full width and depth: {cfg.num_layers} layers, "
        f"{tree_size(params) / 1e9:.3f} B params, {cfg.param_dtype}, "
        f"{cfg.padded_num_heads} heads over {cfg.padded_num_kv_heads} kv heads"
        f" of {cfg.resolved_head_dim}; init {time.perf_counter() - t_part:.1f}"
        f" s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; rate "
        f"0.5 keeps {kept['mlp'].shape[1]} of {cfg.d_ff} FFN units a layer")
    b, text, grid, after = VLM_SCORE
    batch = _vl_batch(torch, params, cfg, b, text, grid, after, 1)
    n_tok = int(batch["loss_mask"].numel())
    source = {"params": params, "kept": kept, "mode": "mask",
              "model_config": cfg}
    del model
    scfg = ServeConfig(**VLM_SERVE)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(1, 65)))
               .astype(np.int32) for _ in range(8)]
    launches = {"flash_attention": 0, "decode_attention": 0,
                "masked_matmul": 0}
    losses = {}
    for mode in ("dense", "masked", "shrunk"):
        src = source if mode != "dense" else {**source, "kept": None}
        sv = load_servable(src, mode, attn_impl="pallas", device="cuda")
        n1_step = 2 * cfg.num_layers if mode == "masked" else 0

        def forward():
            return sv.model.loss(sv.params, batch, masks=sv.masks)

        with torch.no_grad():
            forward()                                          # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            k4.launches = k1.launches = 0
            t0 = time.perf_counter()
            loss = forward()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n4, n1 = k4.launches, k1.launches
            log(f"[scoring] qwen2-vl-7b {mode}: loss {float(loss):.6f} over "
                f"{int(batch['loss_mask'].sum())} text positions; {n_tok} "
                f"tokens ({b} x {text} text + {grid[0]}x{grid[1]} patches + "
                f"{after} text) in {wall:.4f} s -> {n_tok / wall:.1f} "
                f"tokens/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                f" GiB; launches flash_attention={n4} masked_matmul={n1} "
                f"(expected {cfg.num_layers}, {n1_step})")
            require(n4 == cfg.num_layers and n1 == n1_step,
                    f"scoring qwen2-vl {mode}: launches K4 {n4}, K1 {n1}")
            require(math.isfinite(float(loss)) and 0.0 < float(loss)
                    < 2 * math.log(cfg.vocab_size),
                    f"scoring qwen2-vl {mode}: loss {float(loss)}")
            launches["flash_attention"] += n4
            launches["masked_matmul"] += n1
            losses[mode] = float(loss)
            _profile_forward(torch, f"qwen2-vl-7b {mode}", forward, wall)
            if mode == "dense":
                xla = LM(sv.model.cfg, attn_impl="xla", device="cuda")
                plain = float(xla.loss(sv.params, batch))
                log(f"[scoring] qwen2-vl-7b dense: loss through K4 "
                    f"{float(loss):.6f}, through the plain attention "
                    f"{plain:.6f}: relative difference "
                    f"{abs(float(loss) - plain) / plain:.3e} (tol "
                    f"{VLM_XLA_TOL:.0e}, bf16 over {cfg.num_layers} "
                    f"layers)")
                require(abs(float(loss) - plain) <= VLM_XLA_TOL * plain,
                        "scoring qwen2-vl: pallas and xla losses disagree")
                del xla

        _full_engine(torch, sv, scfg, prompts)          # warm-up: one wave
        eng = DecodeEngine(sv.model, sv.params, scfg, masks=sv.masks,
                           device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k5.launches = k1.launches = 0
        t0 = time.perf_counter()
        done = eng.run(prompts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n5, n1 = k5.launches, k1.launches
        gen_tok = sum(len(c.tokens) for c in done)
        log(f"[serving] qwen2-vl-7b {mode}: {len(done)} requests, {gen_tok} "
            f"tokens, {eng.steps} decode steps in {dt:.3f} s -> "
            f"{gen_tok / dt:.1f} tokens/s, {1e3 * dt / eng.steps:.3f} "
            f"ms/step, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
            f"GiB; launches decode_attention={n5} masked_matmul={n1} "
            f"({n5 // max(eng.steps, 1)} and {n1 // max(eng.steps, 1)} a "
            f"step)")
        require(len(done) == len(prompts) and
                all(c.status == "ok" and len(c.tokens) == scfg.max_new_tokens
                    and int(c.tokens.min()) >= 0
                    and int(c.tokens.max()) < cfg.vocab_size for c in done),
                f"serving qwen2-vl {mode}: malformed completions")
        require(n5 == eng.steps * cfg.num_layers and
                n1 == eng.steps * n1_step, f"serving qwen2-vl {mode}: "
                f"launches K5 {n5}, K1 {n1} over {eng.steps} steps")
        launches["decode_attention"] += n5
        launches["masked_matmul"] += n1
        _profile_wave(torch, f"qwen2-vl-7b {mode}", sv, dataclasses.replace(
            scfg, steps_per_wave=VLM_PROFILE_STEPS), prompts)
        _sync_free_wave(torch, sv, scfg, prompts)
        if mode == "dense":
            _capture_serving(torch, "qwen2-vl-7b dense", sv, scfg, prompts)
        del sv, eng, done
        torch.cuda.empty_cache()
    log(f"[vlm] qwen2-vl-7b scoring losses dense {losses['dense']:.6f}, "
        f"masked {losses['masked']:.6f}, shrunk {losses['shrunk']:.6f}; "
        f"masked and shrunk differ by "
        f"{abs(losses['masked'] - losses['shrunk']):.3e} (tol 2e-2 relative)")
    require(abs(losses["masked"] - losses["shrunk"])
            <= 2e-2 * losses["shrunk"], "scoring qwen2-vl: masked and shrunk "
            "losses disagree")
    del params, source, src, batch, forward
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[vlm] scoring and serving part: {time.perf_counter() - t_part:.1f}"
        f" s; {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} reserved")
    return launches


WHISPER_TOL = 1e-4      # f32 card against CPU (PARITY_TOL's)


def _whisper_parity_cfg():
    """whisper-small reduced with its own head layout: 12 heads padded to
    16 with KV alongside (MHA, 16 over 16) of 64; 2 + 2 layers, d 256, 64
    encoder frames, f32."""
    from repro_torch.configs import get_config

    return get_config("whisper-small").reduced(num_heads=12, num_kv_heads=12)


def phase_whisper_parity(torch) -> dict:
    """The encdec family card against CPU in f32 (TF32 off) from the same
    params: the encoder, the logits through plain attention and through K4
    (causal on the decoder, no mask on the cross-attention at Sq = 48,
    Skv = 64: 2 launches a decoder layer, counted), the loss and every
    gradient leaf, the cross K/V of ``prefill_cross`` and teacher-forced
    decode steps (K5 over the self cache)."""
    import numpy as np

    from repro_torch import interop
    from repro_torch.core import engine
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.models.lm import LM

    cfg = _whisper_parity_cfg()
    cpu = LM(cfg, device="cpu")
    gpu, gpu_k4 = (LM(cfg, device="cuda", attn_impl=impl)
                   for impl in ("xla", "pallas"))
    params_c = cpu.init(torch.Generator().manual_seed(41))
    params_g = interop.params_from_jax(params_c, "cuda")
    rng = np.random.default_rng(42)
    b, s_len = 2, 48
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s_len + 1))
                           .astype(np.int64))
    frames = torch.from_numpy(rng.standard_normal(
        (b, cfg.encoder.frames, cfg.d_model)).astype(np.float32))
    batch_c = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
               "enc_embeds": frames}
    batch_g = {k: v.cuda() for k, v in batch_c.items()}
    log(f"[whisper-parity] whisper-small reduced: {cfg.encoder.num_layers} "
        f"encoder + {cfg.num_layers} decoder layers, d_model={cfg.d_model}, "
        f"{cfg.padded_num_heads} heads (of {cfg.num_heads}) over "
        f"{cfg.padded_num_kv_heads} of {cfg.resolved_head_dim}, "
        f"{cfg.encoder.frames} frames, f32; B={b} S={s_len}")
    with torch.no_grad():
        enc_err = max_rel_err(torch, gpu._encode(params_g, batch_g).cpu(),
                              cpu._encode(params_c, batch_c))[1]
        want = cpu.apply(params_c, batch_c)
        log(f"[whisper-parity] encoder output rel {enc_err:.3e} (tol "
            f"{WHISPER_TOL:.0e})")
        require(enc_err <= WHISPER_TOL, f"whisper-parity encoder {enc_err}")
        for model, what in ((gpu, "plain attention"), (gpu_k4, "K4")):
            k4.launches = 0
            got = model.apply(params_g, batch_g)
            torch.cuda.synchronize()
            err, rel = max_rel_err(torch, got.cpu(), want)
            n4 = k4.launches
            want4 = 2 * cfg.num_layers if model is gpu_k4 else 0
            log(f"[whisper-parity] forward logits ({what}): max_abs_err="
                f"{err:.3e} rel={rel:.3e} (tol {WHISPER_TOL:.0e}); K4 "
                f"launches {n4} (expected {want4}: causal and cross a layer)")
            require(bool(torch.isfinite(got).all()) and rel <= WHISPER_TOL
                    and n4 == want4, f"whisper-parity forward ({what})")
    (l_c, _), g_c = engine.value_and_grad_aux(
        lambda p: cpu._loss_acc(p, batch_c, None), params_c)
    (l_g, _), g_g = engine.value_and_grad_aux(
        lambda p: gpu._loss_acc(p, batch_g, None), params_g)
    errs = _leaf_errs(g_g, g_c)
    worst = max(e / m if m > 0 else e for e, m in errs)
    log(f"[whisper-parity] loss card {float(l_g):.6f} cpu {float(l_c):.6f}; "
        f"{len(errs)} gradient leaves, worst error {worst:.3e} relative to "
        f"the leaf's max |grad| (tol {TRAIN_TOL:.0e})")
    require(abs(float(l_g) - float(l_c)) <= WHISPER_TOL * float(l_c),
            "whisper-parity: loss differs")
    require(worst <= TRAIN_TOL, f"whisper-parity gradient {worst:.3e}")
    del g_c, g_g

    caches = {"cpu": cpu.init_cache(b, 32), "card": gpu.init_cache(b, 32)}
    cpu.prefill_cross(params_c, caches["cpu"], batch_c)
    gpu.prefill_cross(params_g, caches["card"], batch_g)
    cross = max(max_rel_err(torch, caches["card"]["cross"][s].cpu(),
                            caches["cpu"]["cross"][s])[1] for s in ("k", "v"))
    worst = 0.0
    with torch.inference_mode():
        for t in range(16):
            lc, caches["cpu"] = cpu.decode_step(
                params_c, caches["cpu"], {"tokens": batch_c["tokens"][:, t:t + 1]})
            lg, caches["card"] = gpu.decode_step(
                params_g, caches["card"],
                {"tokens": batch_g["tokens"][:, t:t + 1]})
            worst = max(worst, max_rel_err(torch, lg.cpu(), lc)[1])
    log(f"[whisper-parity] prefill_cross K/V rel {cross:.3e}; 16 decode "
        f"steps: worst logits rel {worst:.3e} (tol {WHISPER_TOL:.0e})")
    require(cross <= WHISPER_TOL and worst <= WHISPER_TOL,
            f"whisper-parity decode: {cross:.3e}, {worst:.3e}")
    return {}


WHISPER_SCORE = (8, 448)                # B x S of the decoder; 1500 frames
WHISPER_SERVE = dict(batch=8, prompt=4, new=124)    # 128 cache rows
WHISPER_GRAD = (2, 448)                 # B x S of the f32 gradient
WHISPER_XLA_TOL = 1e-2                  # bf16 loss, pallas against xla


def phase_whisper(torch) -> dict:
    """whisper-small at full width and depth (12 encoder and 12 decoder
    layers, d 768, 12 heads padded to 16 over 16 of 64, 1500 frames, vocab
    51865), seeded weights and frames: bf16 scoring through
    ``load_servable(attn_impl="pallas")`` at B = 8 x S = 448 (K4 24 a
    forward: each decoder layer's causal self-attention and its
    cross-attention over the 1500 frames without the mask; the encoder's
    attention is the plain one, as the reference's), the loss held against
    ``attn_impl="xla"``; bf16 ``lockstep_decode`` of 8 sequences, a
    4-token prompt and 124 new tokens after ``prefill_cross`` (K5 12 a
    step), a profiled window and one under sync-debug "error"; an f32 loss
    gradient at full width, finite and bitwise equal over two runs.
    Returns {kernel name: launches}."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.models.lm import LM
    from repro_torch.serving import lockstep_decode, load_servable
    from repro_torch.utils.tree import tree_leaves, tree_size

    cfg = get_config("whisper-small")
    frames_n = cfg.encoder.frames
    params = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    log(f"[whisper] whisper-small full width and depth: "
        f"{cfg.encoder.num_layers} encoder + {cfg.num_layers} decoder layers,"
        f" {tree_size(params) / 1e6:.1f} M params, {cfg.param_dtype}, "
        f"{cfg.padded_num_heads} heads over {cfg.padded_num_kv_heads} of "
        f"{cfg.resolved_head_dim}, {frames_n} frames")
    gen = torch.Generator(device="cuda").manual_seed(1)  # lint: generator-ok (the scoring inputs: a fixed input of its own)
    b, s_len = WHISPER_SCORE
    tokens = torch.randint(0, cfg.vocab_size, (b, s_len + 1), generator=gen,
                           device="cuda")
    frames = torch.randn((b, frames_n, cfg.d_model), generator=gen,
                         device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "enc_embeds": frames}
    sv = load_servable({"params": params, "model_config": cfg}, "dense",
                       attn_impl="pallas", device="cuda")
    launches = {"flash_attention": 0, "decode_attention": 0}

    def forward():
        return sv.model.loss(sv.params, batch)

    with torch.no_grad():
        forward()                                              # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k4.launches = 0
        t0 = time.perf_counter()
        loss = forward()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n4 = k4.launches
        log(f"[scoring] whisper-small: loss {float(loss):.6f}; {b * s_len} "
            f"decoder tokens over {b} x {frames_n} frames in {wall:.4f} s -> "
            f"{b * s_len / wall:.1f} tokens/s, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
            f"flash_attention={n4} (expected {2 * cfg.num_layers}: "
            f"{cfg.num_layers} causal + {cfg.num_layers} cross)")
        require(n4 == 2 * cfg.num_layers, f"scoring whisper: K4 {n4}")
        require(math.isfinite(float(loss)) and 0.0 < float(loss)
                < 2 * math.log(cfg.vocab_size),
                f"scoring whisper: loss {float(loss)}")
        launches["flash_attention"] += n4
        _profile_forward(torch, "whisper-small", forward, wall)
        plain = float(LM(cfg, attn_impl="xla", device="cuda").loss(
            sv.params, batch))
        log(f"[scoring] whisper-small: loss through K4 {float(loss):.6f}, "
            f"through the plain attention {plain:.6f}: relative difference "
            f"{abs(float(loss) - plain) / plain:.3e} (tol "
            f"{WHISPER_XLA_TOL:.0e}, bf16)")
        require(abs(float(loss) - plain) <= WHISPER_XLA_TOL * plain,
                "scoring whisper: pallas and xla losses disagree")

    n_b, n_p, n_new = (WHISPER_SERVE[k] for k in ("batch", "prompt", "new"))
    prompt = torch.randint(0, cfg.vocab_size, (n_b, n_p), generator=gen,
                           device="cuda").cpu()
    enc = torch.randn((n_b, frames_n, cfg.d_model), generator=gen,
                      device="cuda")
    lockstep_decode(sv.model, sv.params, prompt, 4, enc_embeds=enc)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k5.launches = 0
    timings = {}
    gen_tok, steps = lockstep_decode(sv.model, sv.params, prompt, n_new,
                                     enc_embeds=enc, timings=timings)
    n5 = k5.launches
    dec = timings["decode_s"]
    log(f"[serving] whisper-small lockstep: {n_b} sequences, prompt {n_p}, "
        f"{n_new} new ({n_p + n_new} cache rows, cross K/V over {frames_n} "
        f"frames): prefill {1e3 * timings['prefill_s'] / n_p:.3f} ms/step, "
        f"decode {1e3 * dec / n_new:.3f} ms/step -> {n_b * n_new / dec:.1f} "
        f"tokens/s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB;"
        f" launches decode_attention={n5} ({n5 // steps} a step)")
    require(n5 == steps * cfg.num_layers, f"serving whisper: K5 {n5}, "
            f"expected {steps} x {cfg.num_layers}")
    require(tuple(gen_tok.shape) == (n_b, n_new) and int(gen_tok.min()) >= 0
            and int(gen_tok.max()) < cfg.vocab_size,
            "serving whisper: malformed tokens")
    launches["decode_attention"] += n5
    cache_len = n_p + n_new
    _profile_lockstep(torch, "whisper-small", sv, prompt, cache_len, enc=enc)
    _sync_free_lockstep(torch, "whisper-small", sv, prompt, cache_len,
                        enc=enc)
    _capture_lockstep(torch, "whisper-small", sv, prompt, n_new, cache_len,
                      enc=enc)
    del sv, params, batch, frames, enc
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    model = LM(cfg32, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(2))
    b, s_len = WHISPER_GRAD
    gen = torch.Generator(device="cuda").manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (b, s_len + 1), generator=gen,
                           device="cuda")
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "enc_embeds": torch.randn((b, frames_n, cfg.d_model),
                                       generator=gen, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        (loss, _), grads = engine.value_and_grad_aux(
            lambda p: model._loss_acc(p, batch, None), params)
        torch.cuda.synchronize()
        runs.append((float(loss), tree_leaves(grads),
                     time.perf_counter() - t0))
    same = runs[0][0] == runs[1][0] and all(
        torch.equal(a, c) for a, c in zip(runs[0][1], runs[1][1]))
    finite = all(bool(torch.isfinite(g).all()) for g in runs[0][1])
    log(f"[training] whisper-small f32 loss gradient (B={b} x S={s_len}, "
        f"{frames_n} frames): loss {runs[0][0]:.6f}, "
        f"{len(runs[0][1])} leaves, finite {finite}, two runs bitwise "
        f"equal {same}; {runs[1][2]:.3f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(finite and same, "whisper gradient: not finite or not "
            "reproducible")
    return launches


# ---------------------------------------------------------------------------
# phases 24-25: the batch-dict FL step and the mesh backend
# ---------------------------------------------------------------------------

LOCAL_RUN: dict = {}    # the training phase's olmo-1b local run, for [mesh]
STEPS_TOL = 1e-5        # whisper f32 card against CPU, of a leaf's max
REMAT_TOL = 1e-6        # a remat variant's gradient against "none", of a
                        # leaf's max
REMAT_BATCH = (4, 1024)     # B x S of the remat gradients
WHISPER_STEP = (2, 2, 64)   # clients, rows a client step, decoder tokens


def _k123(k1) -> dict:
    return {"masked_matmul": k1.launches, "masked_matmul_dx": k1.dx_launches,
            "masked_matmul_dw": k1.dw_launches}


def _rel_leaf_errs(torch, got, want) -> float:
    """The largest over leaves of max |got - want| / max |want|."""
    from repro_torch.utils.tree import tree_leaves

    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        err = float((g.detach().cpu().double() - w.detach().cpu().double())
                    .abs().max())
        worst = max(worst, _ratio(err, float(w.detach().abs().max())))
    return worst


def phase_steps(torch) -> dict:
    """``launch.steps`` on the card.  olmo-1b at full width and depth (f32,
    the training phase's world and batch shape: 2 clients x 2 local steps
    of B = 4 + 2 server steps, S = 128): one ``make_fl_train_step`` round
    in ``FLRunConfig(use_masks=True, masked_compute="kernel")`` bitwise
    equal to ``FederatedTrainer.round_step`` on the same batch, K1-K3
    counted; ``with_masks`` injecting a FedAP decision (every state tensor
    keeps its storage and shape), then a timed round; ``make_prefill_step``
    and ``make_decode_step`` against ``LM.apply``/``decode_step``.  Then
    whisper-small at full width and depth in f32 trained 2 rounds through
    the step on ``enc_embeds`` + tokens (finite, bitwise repeatable; s/round
    and peak), and at 2 + 2 layers one round card against CPU within
    STEPS_TOL of each leaf's max.  Last, one olmo-1b kernel-mode gradient
    (REMAT_BATCH) with remat none / block / dots: equal losses, gradients
    within REMAT_TOL of a leaf's max, peak, time and K1-K3 launches of each.
    Returns {kernel name: launches} of the step's two rounds."""
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.launch import steps
    from repro_torch.utils.tree import tree_leaves, tree_map

    trainer = _olmo_trainer(torch)
    model, cfg, fl = trainer.model, trainer.model.cfg, trainer.cfg
    kw = trainer.backend(use_masks=True).sample_kw
    c, seq = kw["clients_per_round"], trainer.data.client_x.shape[-1]
    run = steps.FLRunConfig(
        lr=fl.lr, beta_local=fl.feddum.beta_local,
        beta_server=fl.feddum.beta_server, eta_server=fl.feddum.eta_server,
        local_steps=kw["local_steps"], server_tau=kw["server_tau"],
        server_batch=kw["server_batch"], feddu=fl.feddu, use_masks=True,
        masked_compute="kernel")
    init_state, train_step = steps.make_fl_train_step(cfg, run, c,
                                                      model=model)
    batch = steps.fl_batch_specs(
        cfg, InputShape("olmo-steps", seq, c * kw["batch_size"], "train"),
        c, run, abstract=False, seed=5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_state(gen, filter_masks={"mlp": torch.ones(
        (cfg.num_layers, cfg.d_ff), device="cuda")})
    twin = tree_map(torch.clone, state)
    tup = dict(batch, client=(batch["client"]["tokens"],
                              batch["client"]["labels"]),
               server=(batch["server"]["tokens"], batch["server"]["labels"]))
    log(f"[steps] olmo-1b f32 full width ({cfg.num_layers} layers): "
        f"make_fl_train_step(FLRunConfig(use_masks=True, masked_compute="
        f"'kernel')), {c} clients x {run.local_steps} local steps of "
        f"{kw['batch_size']} x {seq} tokens + {run.server_tau} server steps "
        f"of {run.server_batch}; client batch {tuple(batch['client']['tokens'].shape)}")
    launches = {"masked_matmul": 0, "masked_matmul_dx": 0,
                "masked_matmul_dw": 0}
    times = []
    for r in range(2):
        if r == 1:
            kept = model.decide_kept(state["params"], 0.5)
            ptrs = [(t.data_ptr(), tuple(t.shape))
                    for t in tree_leaves(state)]
            state = steps.with_masks(
                state, model.param_masks(state["params"], kept),
                model.filter_masks(state["params"], kept))
            kept_n = {k: int(v.shape[-1]) for k, v in kept.items()}
            same = ptrs == [(t.data_ptr(), tuple(t.shape))
                            for t in tree_leaves(state)]
            log(f"[steps] with_masks: a FedAP decision at rate 0.5 (kept "
                f"{kept_n} of {cfg.d_ff}) injected; every one of "
                f"{len(ptrs)} state tensors kept its storage and shape: "
                f"{same}")
            require(same, "with_masks moved or reshaped a state tensor")
            del twin
        torch.cuda.synchronize()
        k1.launches = k1.dx_launches = k1.dw_launches = 0
        t0 = time.perf_counter()
        state, tau = train_step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = _k123(k1)
        for k, n in got.items():
            launches[k] += n
        want = 6 * 2 * cfg.num_layers
        log(f"[steps] round {r + 1}: tau_eff {float(tau):.6f}, "
            f"{times[-1]:.3f} s; launches K1 {got['masked_matmul']} K2 "
            f"{got['masked_matmul_dx']} K3 {got['masked_matmul_dw']} "
            f"(expected {want} each: 6 gradient evaluations x 2 products x "
            f"{cfg.num_layers} layers)")
        require(all(n == want for n in got.values()),
                f"steps: launches {got}, expected {want} each")
        if r == 0:
            twin, mets = trainer.round_step(twin, tup)
            diff = [i for i, (a, b) in enumerate(zip(tree_leaves(state),
                                                     tree_leaves(twin)))
                    if not torch.equal(a, b)]
            log(f"[steps] make_fl_train_step round against "
                f"FederatedTrainer.round_step on the same batch (tuples): "
                f"{'bitwise equal' if not diff else f'{len(diff)} leaves differ'}"
                f" over {len(tree_leaves(state))} state tensors; tau_eff "
                f"{float(tau):.6f} / {float(mets['tau_eff']):.6f}")
            require(not diff and torch.equal(tau, mets["tau_eff"]),
                    "steps: train_step differs from round_step")
    log(f"[steps] olmo-1b s/round through the step: {times[0]:.3f} (all-ones"
        f" masks, eager: a state's first round), {times[1]:.3f} (masked at "
        f"0.5, the step's capture included; training phase local: "
        f"{LOCAL_RUN.get('steady_s', float('nan')):.3f}); peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(all(math.isfinite(float(t.float().abs().max()))
                for t in tree_leaves(state["params"])), "steps: not finite")

    # the serve steps on the trained params
    params = state["params"]
    del state
    _, prefill = steps.make_prefill_step(cfg)
    _, decode = steps.make_decode_step(cfg)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(6))  # lint: generator-ok (the tokens: a fixed input of its own)
    with torch.no_grad():
        last = prefill(params, {"tokens": tok})
        same_p = torch.equal(last, model.apply(params, {"tokens": tok})[:, -1])
        logits, _ = decode(params, model.init_cache(2, 128),
                           {"tokens": tok[:, :1]})
        want, _ = model.decode_step(params, model.init_cache(2, 128),
                                    {"tokens": tok[:, :1]})
        same_d = torch.equal(logits, want)
    log(f"[steps] make_prefill_step {tuple(last.shape)} equal to "
        f"LM.apply(...)[:, -1]: {same_p}; make_decode_step equal to "
        f"LM.decode_step: {same_d}")
    require(same_p and same_d, "steps: prefill/decode step differs")
    del params, trainer, model

    _whisper_steps(torch)
    _remat_gradients(torch)
    return launches


def _whisper_steps(torch) -> None:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_size

    c, b_c, seq = WHISPER_STEP
    cfg = dataclasses.replace(get_config("whisper-small"),
                              param_dtype="float32")
    run = steps.FLRunConfig(lr=3e-3, local_steps=1, server_tau=1,
                            server_batch=b_c)
    shape = InputShape("whisper-steps", seq, c * b_c, "train")
    init_state, train_step = steps.make_fl_train_step(cfg, run, c)
    batches = [steps.fl_batch_specs(cfg, shape, c, run, abstract=False,
                                    seed=20 + r) for r in range(2)]
    start = init_state(torch.Generator(device="cuda").manual_seed(0))
    tag = "[steps] whisper-small"
    log(f"{tag} f32 full width and depth ({cfg.encoder.num_layers} + "
        f"{cfg.num_layers} layers, {cfg.encoder.frames} frames, "
        f"{tree_size(start['params']) / 1e6:.1f} M params): "
        f"make_fl_train_step, {c} clients x 1 local step of {b_c} x {seq} "
        f"tokens + 1 server step of {b_c}; batch keys "
        f"{sorted(batches[0]['client'])}")
    runs = []
    for _ in range(2):
        st = tree_map(torch.clone, start)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        taus = []
        for b in batches:
            st, tau = train_step(st, b)
            taus.append(float(tau))
        torch.cuda.synchronize()
        runs.append((st, taus, (time.perf_counter() - t0) / len(batches),
                     torch.cuda.max_memory_allocated() / 2 ** 30))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(runs[0][0]),
                                                 tree_leaves(runs[1][0])))
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves(runs[0][0]["params"]))
    log(f"{tag}: 2 rounds, tau_eff {runs[0][1]}, finite {finite}, two runs "
        f"bitwise equal {same}; {runs[0][2]:.3f} / {runs[1][2]:.3f} s/round "
        f"(round 2 each the capture of its run's state), "
        f"peak {runs[1][3]:.2f} GiB")
    require(finite and same, "whisper through the step: not finite or not "
            "repeatable")
    del runs, start, st

    # 2 + 2 layers: one round card against CPU from the same params and batch
    small = dataclasses.replace(cfg, num_layers=2, encoder=dataclasses.replace(
        cfg.encoder, num_layers=2))
    run1 = dataclasses.replace(run, server_batch=1)
    shape1 = dataclasses.replace(shape, global_batch=c)
    init_c, step_c = steps.make_fl_train_step(small, run1, c, device="cpu")
    init_g, step_g = steps.make_fl_train_step(small, run1, c)
    sc = init_c(torch.Generator().manual_seed(3))  # lint: generator-ok (the small model: a fixed input of its own)
    sg = tree_map(lambda t: t.cuda(), sc)
    bc = steps.fl_batch_specs(small, shape1, c, run1, abstract=False,
                              seed=30, device="cpu")
    bg = steps.fl_batch_specs(small, shape1, c, run1, abstract=False,
                              seed=30)
    sc, tc = step_c(sc, bc)
    sg, tg = step_g(sg, bg)
    err = _rel_leaf_errs(torch, sg["params"], sc["params"])
    log(f"{tag} 2 + 2 layers (rows of 1 x {seq} tokens), one round card "
        f"against CPU: params "
        f"{err:.3e} of a leaf's max (tol {STEPS_TOL:.0e}), tau_eff "
        f"{float(tg):.6f} / {float(tc):.6f}")
    require(err <= STEPS_TOL, f"whisper step card vs CPU {err}")


def _remat_gradients(torch) -> None:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config("olmo-1b"), param_dtype="float32",
                              remat="none")
    base = LM(cfg, device="cuda")
    params = base.init(torch.Generator(device="cuda").manual_seed(0))
    masks = base.filter_masks(params, base.decide_kept(params, 0.5))
    b, s = REMAT_BATCH
    tok = torch.randint(0, cfg.vocab_size, (b, s + 1), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(7))  # lint: generator-ok (the tokens: a fixed input of its own)
    x, y = tok[:, :-1], tok[:, 1:]
    ref = None
    rows = {}
    for remat in ("none", "block", "dots"):
        model = LM(dataclasses.replace(cfg, remat=remat), device="cuda")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        k1.launches = k1.dx_launches = k1.dw_launches = 0
        t0 = time.perf_counter()
        with torch.enable_grad():
            q, leaves = engine._detached_leaves(params)
            loss, _ = model.loss_and_acc(q, x, y, masks=masks)
            torch.cuda.synchronize()
            held = (torch.cuda.memory_allocated() - base_mem) / 2 ** 30
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
            del q, leaves
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
        n = _k123(k1)
        if ref is None:
            ref, err = (float(loss), grads), 0.0
        else:
            err = _rel_leaf_errs(torch, grads, ref[1])
        rows[remat] = (float(loss), err, peak, wall, n, held)
        log(f"[steps] remat={remat!r}: olmo-1b f32 kernel-masked (rate 0.5) "
            f"gradient at B={b} x S={s}: loss {float(loss):.6f}, gradients "
            f"{err:.3e} of a leaf's max against 'none', held after the "
            f"forward {held:.2f} GiB, peak {peak:.2f} GiB (both above the "
            f"params), {wall:.3f} s; launches K1 "
            f"{n['masked_matmul']} K2 {n['masked_matmul_dx']} K3 "
            f"{n['masked_matmul_dw']}")
        del grads
    lay = cfg.num_layers
    require(all(r[0] == rows["none"][0] and r[1] <= REMAT_TOL
                for r in rows.values()), f"remat variants differ: {rows}")
    require(rows["none"][4]["masked_matmul"] == 2 * lay
            and rows["block"][4]["masked_matmul"] == 4 * lay
            and rows["dots"][4]["masked_matmul"] == 4 * lay,
            "remat: K1 not recomputed as expected (2 / 4 / 4 a layer)")
    log(f"[steps] remat none / block / dots: held after the forward "
        f"{rows['none'][5]:.2f} / {rows['block'][5]:.2f} / "
        f"{rows['dots'][5]:.2f} GiB, peaks {rows['none'][2]:.2f} / "
        f"{rows['block'][2]:.2f} / {rows['dots'][2]:.2f} GiB; dots between "
        f"the others (held): "
        f"{rows['block'][5] < rows['dots'][5] < rows['none'][5]}; K1 "
        f"recomputed in the backward by block and dots "
        f"({rows['dots'][4]['masked_matmul']} launches, 2 a layer forward)")


EVAL_TURNS = 3              # evaluations in a timed turn


def _eval_programs(torch, label, backends, state) -> None:
    """Each backend's eval program on ``state``'s params: its captured
    replays bitwise the eager body's result (``Program(capture=False)`` on
    the same inputs), the device's reserved memory with the program's
    graph pool and without it (a graph keeps its pool), and ms per
    evaluation of the eager body and of the captured program in turns
    (eager, captured, captured, eager).  Every backend's result must be
    bitwise the first's (at a world of one the sharded eval, the whole
    split's and the local one agree)."""
    from repro_torch.core.programs import Program, key_of

    first = None
    for name, be in backends.items():
        prog = be._eval_program()
        args = be._eval_args(state)
        eager = Program(prog.fn, name="eval", device="cuda", capture=False)
        want = tuple(t.clone() for t in eager(*args))
        got = [be.evaluate(state) for _ in range(3)]
        same = all(torch.equal(a, b) for g in got for a, b in zip(g, want))
        first = want if first is None else first
        agree = all(torch.equal(a, b) for a, b in zip(want, first))
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        with_pool = torch.cuda.memory_reserved()
        caps = prog.captures
        prog._cache.pop(key_of(args))   # this key's capture and its pool
        gc.collect()
        torch.cuda.empty_cache()
        without = torch.cuda.memory_reserved()
        for _ in range(2):          # captured again for the turns
            be.evaluate(state)
        ms = {"eager": [], "captured": []}
        for which in ("eager", "captured", "captured", "eager"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(EVAL_TURNS):
                if which == "eager":
                    eager(*args)
                else:
                    be.evaluate(state)
            torch.cuda.synchronize()
            ms[which].append(1e3 * (time.perf_counter() - t0) / EVAL_TURNS)
        log(f"[eval] {label} {name}: loss {float(want[0]):.6f} acc "
            f"{float(want[1]):.4f}; 3 evaluations through the program "
            f"(eager run, capture, replay) "
            f"{'bitwise equal' if same else 'DIFFER'} to the eager body, "
            f"{'bitwise equal' if agree else 'DIFFERS'} to "
            f"{next(iter(backends))}; {caps} capture(s) of the program; "
            f"reserved "
            f"{_gib(with_pool):.3f} GiB with the eval pool, "
            f"{_gib(without):.3f} GiB without (the pool "
            f"{_gib(with_pool - without):.3f} GiB); ms per eval in turns: "
            f"eager {statistics.mean(ms['eager']):.3f} "
            f"{[round(t, 3) for t in ms['eager']]}, captured "
            f"{statistics.mean(ms['captured']):.3f} "
            f"{[round(t, 3) for t in ms['captured']]}; {CARD}")
        require(same and agree and caps >= 1 and prog.captures >= 1,
                f"eval {label} {name}: the captured eval differs or did not "
                f"capture")
        del got, prog, eager, args


def _mesh_data_check(torch, backend, label) -> None:
    """The mesh backend's dataset is ``device_arrays(mesh=)``'s placement
    (row 0 of the test split kept beside it); at a world of one every
    client stays on this rank and the round fetches nothing."""
    d = backend.device_data()
    log(f"[mesh] {label}: dataset from device_arrays(mesh=, shard_test="
        f"{backend.shard_eval}): client_x {tuple(d['client_x'].shape)} of "
        f"{backend._num_clients} clients on rank {backend.rank} of "
        f"{backend.world}, test_x {tuple(d['test_x'].shape)}; "
        f"reduce-scatters so far {backend.scatters}")
    require("test_x0" in d and backend._owned is None
            and backend.scatters == 0
            and d["client_x"].shape[0] == backend._num_clients,
            f"mesh {label}: not the mesh placement of a world of one")


def phase_mesh(torch) -> dict:
    """``FederatedTrainer(backend="mesh")`` as a world of one over NCCL: the
    training phase's olmo-1b FedDUMAP plan (``fedap_plan(4, prune_round=2,
    mode="mask")``, kernel mode, f32, all 16 layers), its history, final
    params and K1-K3 launches bitwise equal to that phase's local run (its
    digests, not a second local run; both captured, every round after the
    first on a state a graph replay); then MESH_ROUNDS more rounds of the
    mesh on the pruned state (s/round of the replays), and the all-reduce
    count (one per ``_reduce`` call and dtype) and host time a round (a
    profiled round's NCCL kernels).  Then the paper phase's FedDUMAP run (a shrink
    at round 1) through ``experiments.run_one(backend="mesh")``, equal to
    its local record, and a kill and resume of a cut SimpleCNN FedDUMAP
    plan (the reliability phase's, CNN_RESUME) on the mesh backend, bitwise
    equal to the uninterrupted run.  Returns {kernel name: launches} of the
    olmo-1b plan."""
    import shutil

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import experiments
    from repro_torch.core.backend import MeshBackend
    from repro_torch.core.plan import fedap_plan
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils.tree import tree_leaves

    require(bool(LOCAL_RUN), "mesh: the training phase's local run is missing")
    mesh = make_host_mesh()
    MESH[:] = [mesh]
    log(f"[mesh] process group {dist.get_backend()!r}, world "
        f"{dist.get_world_size()}, mesh {mesh.mesh_dim_names} "
        f"{tuple(mesh.shape)} on {mesh.device_type}")
    require(str(dist.get_backend()) == "nccl", "mesh: not NCCL")
    trainer = _olmo_trainer(torch, backend="mesh", mesh=mesh)
    params = trainer.model.init(torch.Generator(device="cuda").manual_seed(0))
    rounds = LOCAL_RUN["rounds"]
    torch.cuda.synchronize()
    k1.launches = k1.dx_launches = k1.dw_launches = 0
    t0 = time.perf_counter()
    res = trainer.run(fedap_plan(rounds, prune_round=2, mode="mask"),
                      params=params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _k123(k1)
    del params
    backend = trainer.backend(use_masks=True)
    hist = {k: list(v) for k, v in res.history.items() if k != "time"}
    same_h = hist == LOCAL_RUN["history"]
    diff = [i for i, (a, b) in enumerate(zip(tree_leaves(res.params),
                                             LOCAL_RUN["params"]))
            if not torch.equal(a.cpu(), b)]
    same_k = res.artifacts["prune"]["kept_counts"] == LOCAL_RUN["kept"]
    log(f"[mesh] olmo-1b world of one (rank {backend.rank} of "
        f"{backend.world}; {rounds} rounds, prune at 2): history "
        f"{'bitwise equal' if same_h else 'DIFFERS'} to the training "
        f"phase's local run, final params "
        f"{'bitwise equal' if not diff else f'{len(diff)} leaves differ'} "
        f"({len(LOCAL_RUN['params'])} leaves), kept {same_k}; launches "
        f"{launches} (local {LOCAL_RUN['launches']}); plan {wall:.3f} s "
        f"(local {LOCAL_RUN['plan_s']:.3f} s)")
    require(same_h and not diff and same_k, "mesh differs from local")
    require(launches == LOCAL_RUN["launches"], "mesh: K1-K3 launches differ")
    local_steady = LOCAL_RUN.get("steady_s", float("nan"))
    LOCAL_RUN.clear()
    _mesh_data_check(torch, backend, "olmo-1b plan")
    _eval_programs(torch, "olmo-1b (16 layers, f32)", {
        "mesh shard_eval=True": backend,
        "mesh shard_eval=False": MeshBackend(
            trainer.model, trainer.data, trainer.cfg, use_masks=True,
            device="cuda", mesh=mesh, shard_eval=False,
            data_cache=trainer._data_cache)}, res.state)

    # steady-state rounds of the mesh's captured round program (replays) on
    # the pruned state; a local backend's captured round beside it would
    # hold a second 16-layer graph pool: the two run in turns at
    # CAPTURE_OLMO_LAYERS layers in [capture]
    state = res.state
    del res
    backend.reductions, backend.reduce_seconds = 0, 0.0
    times = []
    for i in range(MESH_ROUNDS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = backend.run_rounds(state, rounds + i, 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    round_s = statistics.median(times)
    per = backend.reductions / MESH_ROUNDS
    host = backend.reduce_seconds / MESH_ROUNDS
    want = 1 + backend.sample_kw["server_tau"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        backend.run_rounds(state, rounds + MESH_ROUNDS, 1)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    nccl = [e for e in kern if "nccl" in e.key.lower()]
    nccl_s = sum(e.self_device_time_total for e in nccl) / 1e6
    dev_s = sum(e.self_device_time_total for e in kern) / 1e6
    log(f"[mesh] olmo-1b steady state, captured rounds (graph replays): "
        f"mesh {round_s:.3f} s/round {[round(t, 3) for t in times]} against "
        f"the training phase's captured local {local_steady:.3f}; "
        f"all-reduces {per:g} a round (one per _reduce call and dtype, "
        f"counted on replay; expected {want}), host time in the calls "
        f"{host * 1e3:.3f} ms a round (eager calls only: a replay runs no "
        f"Python); a profiled round: {len(nccl)} NCCL kernel kinds, "
        f"{nccl_s * 1e3:.3f} ms on the device of {dev_s:.3f} s of kernels; "
        f"{CARD}")
    require(per == want and backend.chunk.captures == 1,
            f"mesh: {per} all-reduces a round (expected {want}), "
            f"{backend.chunk.captures} captures")
    del state, trainer, backend

    # the paper phase's FedDUMAP run (shrink) through run_one on the mesh
    local_rec = os.path.join(ROOT, "build", "chip_smoke_paper",
                             "main_cnn_feddumap.json")
    with open(local_rec) as f:
        local = json.load(f)
    out = os.path.join(ROOT, "build", "chip_smoke_mesh")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    rec = experiments.run_one("main_cnn_feddumap", algo="feddumap",
                              rounds=PAPER_ROUNDS, prune_round=PAPER_PRUNE,
                              out_dir=out, backend="mesh", device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = all(rec["history"][k] == local["history"][k]
               for k in ("round", "loss", "acc", "tau_eff"))
    same_ap = rec["fedap"] == local["fedap"]
    log(f"[mesh] run_one FedDUMAP SimpleCNN ({PAPER_ROUNDS} rounds, shrink at"
        f" {PAPER_PRUNE}) on the mesh backend: history "
        f"{'bitwise equal' if same else 'DIFFERS'} to the paper phase's "
        f"local record, FedAP {rec['fedap']['kept_counts']} "
        f"{'equal' if same_ap else 'DIFFERS'}; {wall:.2f} s")
    require(same and same_ap, "mesh run_one differs from local")
    _paper_eval(torch, mesh)

    # kill and resume on the mesh backend: the reliability phase's plan
    _resume_cnn(torch, out, backend="mesh", mesh=mesh,
                tag="[mesh] resume SimpleCNN")
    shutil.rmtree(out, ignore_errors=True)
    for name, n in _serving_mesh(torch, mesh).items():
        launches[name] = launches.get(name, 0) + n
    return launches


def _paper_eval(torch, mesh) -> None:
    """The eval programs on the paper protocol's SimpleCNN and its test
    split (seed-0 params): local, and the mesh with ``shard_eval`` on and
    off, sharing one dataset cache."""
    from repro_torch import experiments
    from repro_torch.core.backend import LocalBackend, MeshBackend
    from repro_torch.core.rounds import feddumap_config
    from repro_torch.data.pipeline import build_federated_data

    data = build_federated_data(
        num_clients=experiments.NUM_CLIENTS, server_fraction=0.05,
        device_pool=experiments.DEVICE_POOL, spec=experiments.SPEC, seed=0)
    fl = feddumap_config(**experiments.COMMON, seed=0)
    cnn = experiments.make_model("cnn", "cuda")
    cache: dict = {}
    local = LocalBackend(cnn, data, fl, device="cuda", data_cache=cache)
    state = local.init_state(cnn.init(torch.Generator(
        device="cuda").manual_seed(0)))
    _eval_programs(torch, f"SimpleCNN paper test split "
                   f"({data.test_x.shape[0]} images)", {
                       "local": local,
                       "mesh shard_eval=True": MeshBackend(
                           cnn, data, fl, device="cuda", mesh=mesh,
                           data_cache=cache),
                       "mesh shard_eval=False": MeshBackend(
                           cnn, data, fl, device="cuda", mesh=mesh,
                           shard_eval=False, data_cache=cache)}, state)


SERVING_RUN: dict = {}      # the serving phase's masked olmo-1b run
MESH_TURNS = 3              # waves each engine runs in a turn
MESH_ROUNDS = 3             # timed steady-state rounds of the mesh program
MESH: list = []             # the mesh phase's NCCL world of one, for [capture]


def _serving_mesh(torch, mesh) -> dict:
    """``DecodeEngine(mesh=)`` over the NCCL world of one: the serving
    phase's masked olmo-1b (full width, 16 layers, bf16, the same seeded
    params and keep decision) on its 16 prompts, its completions token for
    token and its K1/K5 launches equal to that phase's mesh-less engine,
    one wave and the gather under sync-debug "error", then waves of both
    engines timed in turns (ms/step).  Returns {kernel: launches}."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.models.lm import LM
    from repro_torch.serving import DecodeEngine, load_servable

    require(bool(SERVING_RUN), "serving mesh: the serving phase's run is "
            "missing")
    cfg = get_config("olmo-1b")
    model = LM(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    sv = load_servable({"params": params,
                        "kept": model.decide_kept(params, 0.5),
                        "mode": "mask", "model_config": cfg}, "masked",
                       device="cuda")
    del params, model
    scfg, prompts = SERVING_RUN["scfg"], SERVING_RUN["prompts"]

    def engine(on_mesh):
        return DecodeEngine(sv.model, sv.params, scfg, masks=sv.masks,
                            mesh=mesh if on_mesh else None, device="cuda")

    engine(True).run(prompts[:2])                       # warm-up
    eng = engine(True)
    torch.cuda.synchronize()
    k5.launches = k1.launches = 0
    t0 = time.perf_counter()
    done = eng.run(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {"decode_attention": k5.launches, "masked_matmul": k1.launches}
    same = [(c.uid, c.tokens.tolist(), c.status) for c in done] \
        == SERVING_RUN["done"]
    log(f"[serving mesh] olmo-1b masked, DecodeEngine(mesh=) on a world of "
        f"{mesh.size()} ({mesh.mesh_dim_names} {tuple(mesh.shape)}, "
        f"slots {eng._lo}..{eng._lo + eng._n - 1} on this rank): "
        f"{len(done)} requests, {eng.steps} decode steps in {wall:.3f} s; "
        f"completions {'equal token for token' if same else 'DIFFER'} to "
        f"the mesh-less engine's; launches {got} (mesh-less "
        f"{SERVING_RUN['launches']}, {SERVING_RUN['steps']} steps)")
    require(same and eng.steps == SERVING_RUN["steps"],
            "serving mesh: completions differ from the mesh-less engine")
    require(got == SERVING_RUN["launches"],
            "serving mesh: K1/K5 launches differ from the mesh-less engine")

    # the wave's all-gather is a node of its graph: replays with no host
    # sync, and the lowered wave records the collective
    from repro_torch.analysis import op_lint

    eng = engine(True)
    for p in prompts[: scfg.slots]:
        eng.submit(p)
    eng.step_wave()
    lowered = eng.lower_wave()
    coll = op_lint.collectives(lowered.ops)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            eng._wave()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    gathered = eng._gathered.clone()
    rows = torch.cat([eng._state["active"][:, None].to(torch.int32),
                      eng._state["n_out"][:, None],
                      eng._state["error"][:, None].to(torch.int32),
                      eng._state["out"]], 1)
    require(eng._wave_program.replays == 2 and lowered.graph is not None,
            "serving mesh: the sync-checked waves were not replays")
    require(coll == ["c10d._allgather_base_"]
            and torch.equal(gathered, rows)
            and eng.program_counts() == {"admit": 1, "wave": 1},
            f"serving mesh: the wave's collectives {coll}, gathered rows "
            f"equal {torch.equal(gathered, rows)}, programs "
            f"{eng.program_counts()}")
    log(f"[serving mesh] two captured waves ({scfg.steps_per_wave} steps "
        f"each, replays) with the all-gather inside ran under "
        f"set_sync_debug_mode('error') without a host sync; the lowered "
        f"wave's collectives {coll}; the gathered [active, n_out, error, "
        f"out] rows equal the slots' state; programs "
        f"{eng.program_counts()}")

    # waves in turns: mesh-less, mesh, mesh, mesh-less (every slot busy)
    engines = {}
    for on_mesh in (False, True):
        engines[on_mesh] = engine(on_mesh)
        for p in prompts[: scfg.slots]:
            engines[on_mesh].submit(p)
        engines[on_mesh].step_wave()
        _capture_wave(engines[on_mesh])     # the turns time replays
    ms = {False: [], True: []}
    for on_mesh in (False, True, True, False):
        e = engines[on_mesh]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_TURNS):
            e.step_wave()
        torch.cuda.synchronize()
        ms[on_mesh].append(1e3 * (time.perf_counter() - t0)
                           / (MESH_TURNS * scfg.steps_per_wave))
    log(f"[serving mesh] waves in turns ({MESH_TURNS} waves of "
        f"{scfg.steps_per_wave} steps each): mesh-less "
        f"{np.mean(ms[False]):.3f} ms/step {[round(t, 3) for t in ms[False]]}"
        f", mesh {np.mean(ms[True]):.3f} ms/step "
        f"{[round(t, 3) for t in ms[True]]}; {CARD}")
    del engines, eng, sv
    return got


PHASE_SECONDS: dict = {}    # phase -> wall seconds, for the [time] lines
# ---------------------------------------------------------------------------
# phase 27: tensor parallelism over the "model" mesh axis
# ---------------------------------------------------------------------------

TP_BATCH = (2, 2, 4, 128)       # clients, local steps, rows a step, tokens
TP_PREFILL = (4, 512)           # B x S of the world-of-one prefill
TP_DECODE_STEPS = 32            # world-of-one decode steps
# each rank's block of one full-width layer: (arch, model ranks)
TP_BLOCKS = (("olmo-1b", 2), ("olmo-1b", 4), ("chatglm3-6b", 2),
             ("chatglm3-6b", 4))
TP_BLOCK_ROWS = (2, 256)        # B x S into a block
# the summed blocks against the whole block, relative L2: f32 sums in
# another order; bf16 rounds each rank's part and the whole alike
TP_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
TP_SHARD = ("deepseek-67b", 4, 2048, 16)    # arch, ranks, prefill S, steps
TP_TIMES: dict = {}     # kernel name -> its times at a shard's shape


def _rel_l2(torch, got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _tp_launches() -> dict:
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import masked_matmul as k1

    return {"masked_matmul": k1.launches, "masked_matmul_dx": k1.dx_launches,
            "masked_matmul_dw": k1.dw_launches, "flash_attention": k4.launches,
            "decode_attention": k5.launches}


def _tp_reset() -> None:
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import masked_matmul as k1

    k1.launches = k1.dx_launches = k1.dw_launches = 0
    k4.launches = k5.launches = 0


def _tp_add(total: dict) -> dict:
    got = _tp_launches()
    for k, n in got.items():
        total[k] = total.get(k, 0) + n
    return got


def phase_tp(torch) -> dict:
    """Tensor parallelism over the ``model`` mesh axis (``LM.shard``, the
    ``mesh=`` steps of ``launch.steps``).  One card holds one rank, and
    NCCL refuses two ranks on one device, so: (1) a world of one over NCCL
    runs the sharded steps bitwise the unsharded ones (olmo-1b at full
    width and depth); (2) each rank's block of one full-width layer runs
    the kernels at its shapes, and the check sums the ranks' parts against
    the whole block; (3) rank 0 of deepseek-67b on a (1, 4) mesh at full
    width and depth runs a prefill and decode steps, its memory and
    collectives held to the dry run's.  Returns {kernel name: launches} of
    (1) and (3)'s sharded runs."""
    launches: dict = {}
    _tp_world_of_one(torch, launches)
    _tp_blocks(torch)
    _tp_shard(torch, launches)
    return launches


def _tp_world_of_one(torch, launches) -> None:
    """olmo-1b, all 16 layers, on a (1, 1) mesh over the NCCL world of one:
    the sharded train step (f32, FedDUMAP in kernel mode, a FedAP decision
    at 0.5 injected after the first round; the first round eager, the
    second captured) against the unsharded step, the sharded prefill (bf16,
    ``attn_impl="pallas"``, TP_PREFILL) and TP_DECODE_STEPS masked decode
    steps against the unsharded ones, every output bitwise."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import build_model
    from repro_torch.utils.tree import tree_leaves

    mesh = make_host_mesh(data=1, model=1)
    base = get_config("olmo-1b")
    cfg = dataclasses.replace(base, param_dtype="float32")
    c, e, b, s = TP_BATCH
    run = steps.FLRunConfig(lr=3e-3, local_steps=e, server_tau=2,
                            server_batch=b, use_masks=True,
                            masked_compute="kernel")
    batch = steps.fl_batch_specs(cfg, InputShape("tp-olmo", s, c * b,
                                                 "train"),
                                 c, run, abstract=False, seed=30)
    log(f"[tp] world of one over {dist.get_backend()!r}: mesh "
        f"{mesh.mesh_dim_names} {tuple(mesh.shape)}; olmo-1b f32 "
        f"{cfg.num_layers} layers, {c} clients x {e} local steps of {b} x "
        f"{s} + 2 server steps of {b}, kernel mode")
    host, times = [], {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    start = gen.get_state()
    for name, m in (("unsharded", None), ("sharded", mesh)):
        model = build_model(cfg, mesh=m)
        init, step = steps.make_fl_train_step(cfg, run, c, model=model,
                                              mesh=m)
        gen.set_state(start)            # both runs from the same draw
        state = init(gen, filter_masks={"mlp": torch.ones(
                         (cfg.num_layers, cfg.d_ff), device="cuda")})
        _tp_reset()
        for r in range(2):
            if r == 1:
                kept = model.decide_kept(state["params"], 0.5)
                state = steps.with_masks(
                    state, model.param_masks(state["params"], kept),
                    model.filter_masks(state["params"], kept))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, tau = step(state, batch)
            torch.cuda.synchronize()
            times[(name, r)] = time.perf_counter() - t0
            leaves = [t.to("cpu", copy=True) for k in ("params", "server_m")
                      for t in tree_leaves(state[k])] + [tau.to("cpu")]
            if name == "unsharded":
                host.append(leaves)
                continue
            diff = sum(not torch.equal(a, b_)
                       for a, b_ in zip(leaves, host[r]))
            log(f"[tp] train step round {r + 1} "
                f"({'eager' if r == 0 else 'captured'}): sharded "
                f"{times[('sharded', r)]:.3f} s, unsharded "
                f"{times[('unsharded', r)]:.3f} s; tau_eff "
                f"{float(tau):.6f}; {len(leaves) - diff} of {len(leaves)} "
                f"params/server_m leaves and tau_eff bitwise equal")
            require(diff == 0, f"tp: the sharded train step's round {r + 1} "
                    f"differs from the unsharded one in {diff} tensors")
        if m is not None:
            got = _tp_add(launches)
            require(step.program.captures == 1, "tp: the sharded step was "
                    "not captured")
            log(f"[tp] sharded train step launches K1 "
                f"{got['masked_matmul']} K2 {got['masked_matmul_dx']} K3 "
                f"{got['masked_matmul_dw']} (two rounds); program keys "
                f"{step.program._cache_size()}, captures "
                f"{step.program.captures}")
        del state, step, init, model
        gc.collect()
        torch.cuda.empty_cache()
    del host

    # the serve steps: bf16, K4 in the prefill, K5 and K1 in decode
    bsz, seq = TP_PREFILL
    model = build_model(base, attn_impl="pallas")
    params = model.init(gen)
    fm = model.filter_masks(params, model.decide_kept(params, 0.5))
    tokens = torch.randint(0, base.vocab_size, (bsz, seq + TP_DECODE_STEPS),
                           device="cuda", generator=gen)
    outs = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        md, prefill = steps.make_prefill_step(base, mesh=m,
                                              attn_impl="pallas")
        _, decode = steps.make_decode_step(base, mesh=m, model=md)
        _tp_reset()
        with torch.no_grad():
            got = [prefill(params, {"tokens": tokens[:, :seq]})]
            cache = md.init_cache(bsz, seq + TP_DECODE_STEPS)
            for i in range(TP_DECODE_STEPS):
                logits, cache = decode(params, cache,
                                       {"tokens": tokens[:, i:i + 1]},
                                       masks=fm)
                got.append(logits)
        torch.cuda.synchronize()
        outs[name] = got + [cache["k"], cache["v"]]
        if m is not None:
            n = _tp_add(launches)
    same = all(torch.equal(a, b_) for a, b_ in zip(outs["sharded"],
                                                 outs["unsharded"]))
    log(f"[tp] sharded prefill (bf16, pallas, {bsz} x {seq}) and "
        f"{TP_DECODE_STEPS} masked decode steps bitwise the unsharded: "
        f"{same}; launches K4 {n['flash_attention']}, K5 "
        f"{n['decode_attention']}, K1 {n['masked_matmul']}")
    require(same, "tp: the sharded serve steps differ from the unsharded")
    L = base.num_layers
    require(n["flash_attention"] == L
            and n["decode_attention"] == L * TP_DECODE_STEPS
            and n["masked_matmul"] == 2 * L * TP_DECODE_STEPS,
            f"tp: serve launches {n}")
    del outs, params, model, cache


def _tp_ranks(torch, cfg, m, group_of_rank):
    """The ``m`` rank models of ``cfg`` on a (1, m) mesh, rank r's group
    ``group_of_rank(r)``, with the plan."""
    from repro_torch.launch.dryrun import ShapeMesh
    from repro_torch.models.lm import LM
    from repro_torch.sharding.specs import make_plan

    plan = make_plan(ShapeMesh({"data": 1, "model": m}), cfg)
    whole = LM(cfg)
    return plan, [whole.shard(plan, {"data": 0, "model": r},
                              group_of_rank(r)) for r in range(m)]


def _tp_block_of(torch, model, tree):
    from repro_torch.sharding.specs import shard_tree

    return shard_tree(tree, model.block_specs(), model._plan, model._coords,
                      axes=model.axes(),
                      kv_heads=model.cfg.padded_num_kv_heads)


def _tp_blocks(torch) -> None:
    """Each rank's block of one full-width layer (TP_BLOCKS), through the
    ``tp`` code with ``RecordingGroup``s (their collectives move nothing:
    each rank's part is computed on the card and the check sums them):
    attention (K4) and the FFN (K1 where a rank's d_ff is 128-aligned) in
    f32 and bf16, the FFN's f32 gradients (K2, K3), and the vocab-parallel
    loss and argmax of the head, whose collectives the ranks run as threads
    (``ThreadGroup``) on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers as L
    from repro_torch.models.lm import LM, _unstack
    from repro_torch.sharding import tp
    from repro_torch.sharding.specs import shard_tree
    from repro_torch.utils.tree import tree_map

    bsz, seq = TP_BLOCK_ROWS
    gen = torch.Generator(device="cuda").manual_seed(3)
    for arch, m in TP_BLOCKS:
        cfg = dataclasses.replace(get_config(arch), num_layers=1,
                                  param_dtype="float32")
        whole = LM(cfg).init(gen)
        layer = _unstack(whole["layers"])[0]
        kept = LM(cfg).decide_kept(whole, 0.5)
        fm = LM(cfg).filter_masks(whole, kept)["mlp"][0]
        plan, ranks = _tp_ranks(torch, cfg, m,
                                lambda r: tp.RecordingGroup(r, m))
        blocks = [_tp_block_of(torch, md, whole) for md in ranks]
        lay = ranks[0].tp
        ff = cfg.d_ff // m if lay.mlp else cfg.d_ff
        pos = L.default_positions(bsz, seq, cfg.rope, device="cuda")
        tag = (f"[tp] {arch} model={m}: {cfg.num_heads // m if lay.heads else cfg.num_heads}"
               f" q / {lay.kv_heads} kv heads a rank ("
               f"{'kv split' if lay.kv else 'kv whole'}), d_ff {ff} a rank "
               f"({'K1' if ff % 128 == 0 else 'the masked plain product'})")
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            x = torch.randn((bsz, seq, cfg.d_model), generator=gen,
                            device="cuda").to(dtype)
            cast = (lambda t: t.to(dtype))
            lw = tree_map(cast, layer)
            want_a = L.attention_block(lw["attn"], x, pos, cfg,
                                       attn_impl="pallas")
            want_f = L.apply_mlp(lw["mlp"], x, cfg.act, fm)
            got_a = got_f = 0
            for md, blk in zip(ranks, blocks):
                lb = tree_map(cast, _unstack(blk["layers"])[0])
                lo = md.tp.group.rank * ff if lay.mlp else 0
                part = L.attention_block(lb["attn"], x, pos, cfg,
                                         attn_impl="pallas", tp=md.tp)
                got_a = got_a + part.float()
                got_f = got_f + L.apply_mlp(lb["mlp"], x, cfg.act,
                                            fm[lo:lo + ff], md.tp).float()
                if md.tp.group.rank == 0:   # K4 and K1 at the rank's shapes
                    e4 = _rel_l2(torch, part, L.attention_block(
                        lb["attn"], x, pos, cfg, attn_impl="xla", tp=md.tp))
                    log(f"[kernels] flash_attention {arch} rank 0 of {m} "
                        f"{dname}: its block's attention against the plain "
                        f"attention, rel L2 {e4:.3e} (limit "
                        f"{TP_TOL[dname]:.0e})")
                    require(e4 <= TP_TOL[dname], f"tp K4 {arch} {m} {dname}: "
                            f"{e4:.3e}")
                    if ff % 128 == 0:
                        x2 = x.reshape(-1, cfg.d_model)
                        wi = lb["mlp"]["wi"].contiguous()   # a block's view
                        bm = fm[lo:lo + ff].reshape(-1, 128).amax(1)
                        err, rel = max_rel_err(
                            torch, ops.masked_matmul_fwd(x2, wi, bm),
                            ref.masked_matmul_ref(x2, wi, bm))
                        log(f"[kernels] masked_matmul {arch} rank 0 of {m} "
                            f"{dname} M={x2.shape[0]} K={cfg.d_model} "
                            f"N={ff}: max_abs_err={err:.3e} rel={rel:.3e} "
                            f"(tol {TOL[dname]:.3e})")
                        require(rel <= TOL[dname], f"tp K1 {arch} {m} "
                                f"{dname}: error {rel:.3e}")
            ea, ef = _rel_l2(torch, got_a, want_a), _rel_l2(torch, got_f,
                                                            want_f)
            log(f"{tag} {dname}: attention (K4) summed over ranks, rel L2 "
                f"{ea:.3e}; FFN (masked at 0.5) rel L2 {ef:.3e} (limit "
                f"{TP_TOL[dname]:.0e})")
            require(ea <= TP_TOL[dname] and ef <= TP_TOL[dname],
                    f"tp blocks {arch} {m} {dname}: over the limit")
        # the FFN's f32 gradients: a rank's leaves against its block of
        # the whole gradient; the input's parts summed
        x = torch.randn((bsz, seq, cfg.d_model), generator=gen,
                        device="cuda")
        dy = torch.randn(x.shape, generator=gen, device="cuda")

        def grads(mlp, mask, lt):
            with torch.enable_grad():
                q = {k: v.detach().requires_grad_(True)
                     for k, v in mlp.items()}
                xi = x.detach().requires_grad_(True)
                y = L.apply_mlp(q, xi, cfg.act, mask, lt)
                gs = torch.autograd.grad((y * dy).sum(), [xi] + [
                    q[k] for k in sorted(q)])
            return gs[0], dict(zip(sorted(q), gs[1:]))

        want_dx, want_g = grads(layer["mlp"], fm, None)
        dx, worst = 0, 0.0
        for md, blk in zip(ranks, blocks):
            lo = md.tp.group.rank * ff if lay.mlp else 0
            gx, g = grads(_unstack(blk["layers"])[0]["mlp"],
                          fm[lo:lo + ff], md.tp)
            dx = dx + gx
            mine = shard_tree({k: v[None] for k, v in want_g.items()},
                              md.block_specs()["layers"]["mlp"], md._plan,
                              md._coords, axes=md.axes()["layers"]["mlp"])
            for k in g:
                worst = max(worst, _rel_l2(torch, g[k], mine[k][0]))
        edx = _rel_l2(torch, dx, want_dx)
        log(f"{tag} f32 FFN gradients: each rank's wi/wg/wo against its "
            f"block of the whole gradient, worst rel L2 {worst:.3e}; the "
            f"input's summed {edx:.3e} (limit {TP_TOL['float32']:.0e})")
        require(worst <= TP_TOL["float32"] and edx <= TP_TOL["float32"],
                f"tp blocks {arch} {m}: gradients over the limit")
        # the vocab-parallel loss and argmax, the ranks as threads
        h = torch.randn((bsz, seq, cfg.d_model), generator=gen,
                        device="cuda")
        labels = torch.randint(0, cfg.vocab_size, (bsz, seq), device="cuda",
                               generator=gen)
        head = "embed" if cfg.tie_embeddings else "unembed"
        parts = [h @ (blk[head].T if cfg.tie_embeddings else blk[head])
                 for blk in blocks]
        logits = torch.cat(parts, -1)
        whole_logits = h @ (whole[head].T if cfg.tie_embeddings
                            else whole[head])
        want_nll = -torch.log_softmax(logits, -1).gather(
            -1, labels[..., None])[..., 0]
        threads = tp.ThreadGroup.ranks(m)
        outs = tp.ThreadGroup.run([
            (lambda r=r: (
                tp.vocab_cross_entropy(parts[r], labels, dataclasses.replace(
                    ranks[r].tp, group=threads[r])),
                tp.vocab_argmax(parts[r], dataclasses.replace(
                    ranks[r].tp, group=threads[r]))))
            for r in range(m)])
        enll = max(_rel_l2(torch, nll, want_nll) for nll, _ in outs)
        same = all(torch.equal(a, logits.argmax(-1)) for _, a in outs)
        el = _rel_l2(torch, logits, whole_logits)
        log(f"{tag}: vocab-parallel loss rel L2 {enll:.3e} (limit "
            f"{TP_TOL['float32']:.0e}) and argmax equal on every rank: "
            f"{same}, against the joined columns (those against the whole "
            f"head: rel L2 {el:.3e})")
        require(enll <= TP_TOL["float32"] and same
                and el <= TP_TOL["float32"], f"tp head {arch} {m}: differs")
        del whole, layer, blocks, ranks, parts, logits, whole_logits
        gc.collect()
        torch.cuda.empty_cache()


def _tp_kernel_times(torch, model, params, cache, x_dec, fm) -> None:
    """K1, K4 and K5 at the rank's shapes of TP_SHARD against their plain
    versions (the check) and timed beside them, the library call and the
    bound (TP_TIMES)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.kernels import masked_matmul as k1
    from repro_torch.kernels import ref

    timer = Timer(torch, reps=10)
    gen = torch.Generator(device="cuda").manual_seed(4)
    cfg = model.cfg
    lay = model.tp
    hq = cfg.num_heads // lay.group.size
    kvh, hd, seq = lay.kv_heads, cfg.resolved_head_dim, TP_SHARD[2]
    dt = torch.bfloat16
    # K4: the prefill's attention at the rank's heads
    q = torch.randn((1, seq, hq, hd), generator=gen, device="cuda").to(dt)
    k = torch.randn((1, seq, kvh, hd), generator=gen, device="cuda").to(dt)
    v = torch.randn((1, seq, kvh, hd), generator=gen, device="cuda").to(dt)
    got = k4.flash_attention(q, k, v, causal=True)
    err4 = _k4_check(torch, f"tp shard {hq} q / {kvh} kv S={seq}",
                     "bfloat16", got, ref.flash_attention_ref(q, k, v))
    order = _gqa_heads(hq, kvh)
    qt = q[:, :, order].transpose(1, 2).contiguous()
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    ms, lib = timer.turns(
        lambda: k4.flash_attention(q, k, v, causal=True),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True))
    plain = timer(lambda: ref.flash_attention_ref(q, k, v))
    bound, by, _ = _k4_bound(1, seq, seq, hq, kvh, hd, True, None, 2,
                             "bfloat16")
    TP_TIMES["flash_attention"] = {
        "tp_shape": f"deepseek-67b rank of 4: B 1 x S {seq}, {hq} q / {kvh} "
                    f"kv heads of {hd}, causal, bf16",
        "tp_ms": ms, "tp_plain_ms": plain, "tp_library_ms": lib,
        "tp_bound_ms": bound, "tp_bound_by": by, "tp_max_abs_err": err4}
    # K5: a decode step's attention over the rank's cache
    lens = torch.full((1,), min(int(cache["index"]), cache["k"].shape[2]),
                      dtype=torch.int32, device="cuda")
    qd = torch.randn((1, 1, hq, hd), generator=gen, device="cuda").to(dt)
    ck, cv = cache["k"][0], cache["v"][0]
    got = k5.decode_attention(qd, ck, cv, lens)
    want = ref.decode_attention_ref(qd, ck, cv, lens)
    torch.cuda.synchronize()
    err5, rel5 = max_rel_err(torch, got, want)
    require(rel5 <= TOL["bfloat16"], f"tp K5 at the shard: {rel5:.3e}")
    qdt = qd[:, :, order].transpose(1, 2).contiguous()
    kdt = ck.transpose(1, 2).contiguous()
    vdt = cv.transpose(1, 2).contiguous()
    mask = (torch.arange(ck.shape[1], device="cuda")
            < lens[:, None])[:, None, None, :]
    ms5, lib5 = timer.turns(
        lambda: k5.decode_attention(qd, ck, cv, lens),
        lambda: F.scaled_dot_product_attention(qdt, kdt, vdt,
                                               attn_mask=mask,
                                               enable_gqa=True))
    plain5 = timer(lambda: ref.decode_attention_ref(qd, ck, cv, lens))
    bound5 = _k5_bound_ms(1, hq, kvh, hd, int(lens.sum()), 2, "bfloat16")
    TP_TIMES["decode_attention"] = {
        "tp_shape": f"deepseek-67b rank of 4: B 1, {hq} q / {kvh} kv heads "
                    f"of {hd}, length {int(lens[0])} of {ck.shape[1]} rows, "
                    f"bf16",
        "tp_ms": ms5, "tp_plain_ms": plain5, "tp_library_ms": lib5,
        "tp_bound_ms": bound5, "tp_bound_by": "bytes",
        "tp_max_abs_err": err5}
    log(f"[kernels] decode_attention tp shard {hq} q / {kvh} kv bf16: "
        f"max_abs_err={err5:.3e} rel={rel5:.3e} (tol {TOL['bfloat16']:.3e})")
    # K1: the decode step's up product (M = 1) at the rank's d_ff
    w = params["layers"]["mlp"]["wi"][0]
    bm = fm["mlp"][0].reshape(-1, 128).amax(1)
    got = k1.masked_matmul(x_dec, w, bm)
    want = ref.masked_matmul_ref(x_dec, w, bm)
    torch.cuda.synchronize()
    err1, rel1 = max_rel_err(torch, got, want)
    require(rel1 <= TOL["bfloat16"], f"tp K1 at the shard: {rel1:.3e}")
    ms1, lib1 = timer.turns(lambda: k1.masked_matmul(x_dec, w, bm),
                            lambda: torch.matmul(x_dec, w))
    plain1 = timer(lambda: ref.masked_matmul_ref(x_dec, w, bm))
    kept = int((bm > 0).sum())
    bound1, by1 = _mm_bound("fwd", x_dec.shape[0], w.shape[0], w.shape[1],
                            kept, 2, "bfloat16")
    TP_TIMES["masked_matmul"] = {
        "tp_shape": f"deepseek-67b rank of 4 at decode: M {x_dec.shape[0]}, "
                    f"K {w.shape[0]}, N {w.shape[1]} (kept {kept} of "
                    f"{bm.numel()} blocks), bf16",
        "tp_ms": ms1, "tp_plain_ms": plain1, "tp_library_ms": lib1,
        "tp_bound_ms": bound1, "tp_bound_by": by1, "tp_max_abs_err": err1}
    log(f"[kernels] masked_matmul tp shard M={x_dec.shape[0]} "
        f"K={w.shape[0]} N={w.shape[1]} bf16: max_abs_err={err1:.3e} "
        f"rel={rel1:.3e} (tol {TOL['bfloat16']:.3e})")
    for name, rec in TP_TIMES.items():
        log(f"[tp] {name} at {rec['tp_shape']}: kernel {rec['tp_ms']:.4f} ms,"
            f" plain {rec['tp_plain_ms']:.4f} ms, library "
            f"{rec['tp_library_ms']:.4f} ms, bound {rec['tp_bound_ms']:.4f} "
            f"ms ({rec['tp_bound_by']}); {CARD}")


def _tp_shard(torch, launches) -> None:
    """Rank 0 of deepseek-67b on a (1, 4) mesh at full width and all its
    layers, bf16, its block drawn on the card from a seeded generator: one
    prefill (K4) and TP_SHARD decode steps (K5, and K1 through all-ones
    filter masks) through the sharded steps, with a ``RecordingGroup`` for
    the ranks that are not there.  The params' bytes against the dry run's
    ``per_device_bytes`` at (1, 4) (within 1%), the recorded collectives
    against the dry run's counts of the same steps on the meta device
    (equal), ms per step and finite outputs."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import dryrun, steps
    from repro_torch.models.api import build_model
    from repro_torch.models.lm import LM
    from repro_torch.utils.tree import tree_leaves

    arch, m, seq, n_dec = TP_SHARD
    cfg = get_config(arch)
    shape = {"data": 1, "model": m}
    mesh = dryrun.ShapeMesh(shape)
    model = build_model(cfg, mesh=mesh, attn_impl="pallas")
    group = model.tp.group
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = model.init(gen)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    init_s = time.perf_counter() - t0
    whole = LM(cfg).on_meta()
    dry = dryrun.per_device_bytes(cfg, whole, shape,
                                  whole.param_shapes())["params"]
    nominal = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"[tp] {arch} rank 0 of {shape}: {cfg.num_layers} layers, "
        f"{nominal / 1e9:.3f} GB of bf16 params drawn in {init_s:.1f} s; "
        f"allocated {held / 1e9:.3f} GB against the dry run's per-device "
        f"{dry / 1e9:.3f} GB ({held / dry - 1:+.4%}); {CARD}")
    require(abs(held / dry - 1) <= 0.01, "tp shard: params' bytes differ "
            "from the dry run's by more than 1%")
    counts = {}
    for kind, sh in (("prefill", InputShape("tp-prefill", seq, 1,
                                            "prefill")),
                     ("decode", InputShape("tp-decode", seq + n_dec + 2, 1,
                                           "decode"))):
        counts[kind] = dryrun.count_step(
            cfg, sh, shape)["counter"].totals.collective_counts
    _, prefill = steps.make_prefill_step(cfg, mesh=mesh, model=model)
    _, decode = steps.make_decode_step(cfg, mesh=mesh, model=model)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq + n_dec + 2),
                           device="cuda", generator=gen)
    fm = model.filter_masks(params, {})

    def recorded(start):
        got: dict = {}
        for kind, _ in group.calls[start:]:
            got[kind] = got.get(kind, 0) + 1
        return got

    with torch.no_grad():
        prefill(params, {"tokens": tokens[:, :seq]})      # warm
        torch.cuda.synchronize()
        _tp_reset()
        mark = len(group.calls)
        t0 = time.perf_counter()
        last = prefill(params, {"tokens": tokens[:, :seq]})
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        got_p = recorded(mark)
        cache = model.init_cache(1, seq + n_dec + 2)
        for t in (cache["k"], cache["v"]):      # a filled context
            t.normal_(generator=gen)
        cache["index"].fill_(seq)
        x_dec = torch.randn((1, cfg.d_model), generator=gen,
                            device="cuda").to(torch.bfloat16)
        for i in range(2):                      # warm
            logits, cache = decode(params, cache, {"tokens": tokens[
                :, seq + i:seq + i + 1]}, masks=fm)
        torch.cuda.synchronize()
        n_p = _tp_add(launches)
        _tp_reset()
        mark = len(group.calls)
        outs = [last]
        t0 = time.perf_counter()
        for i in range(2, n_dec + 2):
            logits, cache = decode(params, cache, {"tokens": tokens[
                :, seq + i:seq + i + 1]}, masks=fm)
            outs.append(logits)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n_dec
        got_d = recorded(mark)
        n_d = _tp_add(launches)
    per_step = {k: v // n_dec for k, v in got_d.items()}
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    log(f"[tp] {arch} rank 0: prefill 1 x {seq} {prefill_ms:.1f} ms (K4 "
        f"{n_p['flash_attention']} a prefill), decode "
        f"{step_ms:.2f} ms a step over {n_dec} steps (K5 "
        f"{n_d['decode_attention'] // n_dec}, K1 "
        f"{n_d['masked_matmul'] // n_dec} a step); {CARD}")
    log(f"[tp] {arch} rank 0 collectives: prefill {got_p} (dry run "
        f"{counts['prefill']}), decode a step {per_step} over {n_dec} "
        f"steps (dry run {counts['decode']}); outputs finite: {finite}")
    require(got_p == counts["prefill"] and per_step == counts["decode"]
            and all(v == per_step[k] * n_dec for k, v in got_d.items()),
            "tp shard: recorded collectives differ from the dry run's")
    require(finite, "tp shard: non-finite outputs")
    L = cfg.num_layers
    require(n_d["decode_attention"] == L * n_dec
            and n_d["masked_matmul"] == 2 * L * n_dec,
            f"tp shard: decode launches {n_d}")
    _tp_kernel_times(torch, model, params, cache, x_dec, fm)
    del params, cache, outs


CARD = ""                   # nvidia-smi's name and power limit of the card


def _phase(torch, name, fn, *args):
    """Run one phase with the device's peak memory and its wall time
    measured around it.  A backend or an engine and its programs form a
    reference cycle, so an earlier phase's CUDA graphs (and their memory
    pools) go when the collector runs: collect first."""
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"[memory] {name}: peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB, {PHASE_SECONDS[name]:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    global CARD
    start = time.perf_counter()
    CARD = phase_device(torch)
    t0 = time.perf_counter()
    phase_build()
    PHASE_SECONDS["build"] = time.perf_counter() - t0
    timer = Timer(torch)
    records = _phase(torch, "kernels", phase_kernels, torch, timer)
    del timer
    _phase(torch, "parity", phase_parity, torch)
    _phase(torch, "hybrid-parity", phase_hybrid_parity, torch)
    _phase(torch, "train-parity", phase_train_parity, torch)
    launches = {}
    for label, path in (
            ("training", lambda: phase_training(torch)),
            ("training zamba2", lambda: phase_training(
                torch, "zamba2-1.2b", num_layers=12)),
            ("training qwen2-vl", lambda: phase_training(
                torch, "qwen2-vl-7b", num_layers=VLM_TRAIN_LAYERS)),
            ("serving", lambda: phase_serving(torch)),
            ("serving zamba2", lambda: phase_serving_hybrid(torch)),
            ("score-parity", lambda: phase_score_parity(torch) or {}),
            ("scoring", lambda: phase_scoring(torch)),
            ("cnn-parity", lambda: phase_cnn_parity(torch) or {}),
            ("training cnn", lambda: phase_training_cnn(torch)),
            ("paper-parity", lambda: phase_paper_parity(torch) or {}),
            ("paper", lambda: phase_paper(torch)),
            ("reliability", lambda: phase_reliability(torch)),
            ("xlstm-parity", lambda: phase_xlstm_parity(torch) or {}),
            ("xlstm", lambda: phase_xlstm(torch)),
            ("moe-parity", lambda: phase_moe_parity(torch) or {}),
            ("moe", lambda: phase_moe(torch)),
            ("vlm-parity", lambda: phase_vlm_parity(torch) or {}),
            ("vlm", lambda: phase_vlm(torch)),
            ("whisper-parity", lambda: phase_whisper_parity(torch)),
            ("whisper", lambda: phase_whisper(torch)),
            ("steps", lambda: phase_steps(torch)),
            ("mesh", lambda: phase_mesh(torch)),
            ("capture", lambda: phase_capture(torch)),
            ("tp", lambda: phase_tp(torch))):
        for name, n in _phase(torch, label, path).items():
            launches[name] = launches.get(name, 0) + n
    import torch.distributed as dist

    if dist.is_initialized():       # the mesh phase's world of one
        dist.destroy_process_group()
    for name, sec in PHASE_SECONDS.items():
        log(f"[time] {name}: {sec:.1f} s")
    log(f"[time] total: {time.perf_counter() - start:.1f} s (limit 1200 s)")
    for name, rec in records.items():
        rec.update(TP_TIMES.get(name, {}))
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
