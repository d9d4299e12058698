"""Invariants of the operations a round or a wave runs: the port's
counterpart of the reference's ``analysis/hlo_lint.py``.

The reference inspects a lowered program's text; the port records the
operations a round or a serving wave dispatches (``launch.cost.
CostCounter(record=True)``) and checks the invariants that have an eager
meaning, on the CPU:

* **No f64 op** in an f32 round: the canonical CNN world (a SimpleCNN
  FedDUMAP round), the same world with ``guard="reject_client"`` (the
  health guard is device data-flow), and the LM world in kernel mode (the
  FFN keep-masks through ``masked_matmul``), as well as in the serving
  wave, dense and masked.
* **No collective** in a ``LocalBackend`` round or a mesh-less wave.
* **No host read** inside a round or a wave: no ``_local_scalar_dense``,
  ``is_nonzero``, ``nonzero`` or ``equal`` recorded between the round's or
  the wave's first and last operation (the card's check is
  ``torch.cuda.set_sync_debug_mode("error")``; this one runs anywhere).
* **No host-made tensor** inside a round or a wave: no ``lift_fresh`` (a
  tensor made from a host value, ``torch.tensor(x)``), which on the card is
  a host-to-device copy that a CUDA graph capture refuses.  The wave is the
  one ``DecodeEngine.lower_wave`` records.
* **The lockstep step** (``LockstepSession.lower_step``) keeps the wave's
  rules (no f64 op, no host read, no host-made tensor, no collective) for
  each family the lockstep loop serves: the hybrid (reduced zamba2, dense
  and masked), ssm (reduced xlstm), encdec (reduced whisper) and vlm
  (reduced qwen2-vl, the one-hot step input).
* **The mesh programs' collectives** at 2 gloo ranks equal the counts
  recorded in ``op_budget.json``, the part the reference's
  ``compile_budget.json`` ``"hlo"`` section plays: a round of the mesh
  backend (the LM world, kernel mode, its clients' data rank-local: the
  fetch of their samples, sizes and label distributions from their owners
  counted with the round's sums), its sharded eval (one all-reduce) and a
  ``DecodeEngine(mesh=)`` wave (one all-gather).  A new collective in one
  of them fails the check.  Re-record after an intended change with
  ``python -m repro_torch.analysis.op_lint --update``.
* **The tensor-parallel steps** (``launch.steps`` over a ``(1, 2)`` mesh of
  the same 2 ranks, the dense test model of ``tests/test_torch_tp.py``:
  2 layers, d 256, H 4 over KV 2, d_ff 512, vocab 512): one kernel-mode
  FedDUMAP round of the train step, the prefill step and a decode step,
  their collectives equal to ``op_budget.json``'s (``tp_step``,
  ``tp_prefill``, ``tp_decode``), and the round free of host reads,
  host-made tensors and f64 ops, as a mesh round is.
"""
from __future__ import annotations

import collections
import json
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

from repro_torch.launch.cost import HOST_READS, CostCounter

# a tensor made from a host value (``torch.tensor``, ``torch.as_tensor``)
HOST_MADE = ("aten.lift_fresh", "aten.lift_fresh_copy")

BUDGET_PATH = pathlib.Path(__file__).with_name("op_budget.json")
MESH_RANKS = 2


# ---------------------------------------------------------------------------
# what a recorded stream violates


def f64_ops(ops: list) -> list[str]:
    """The recorded operations that touch a float64 tensor."""
    return [name for name, dtypes in ops if "float64" in dtypes]


def host_reads(ops: list) -> list[str]:
    return [name for name, _ in ops if name in HOST_READS]


def host_made(ops: list) -> list[str]:
    return [name for name, _ in ops if name in HOST_MADE]


def collectives(ops: list) -> list[str]:
    return [name for name, _ in ops if name.startswith("c10d.")]


def check_stream(label: str, ops: list, *, mesh_less: bool = True
                 ) -> list[str]:
    """Failure messages for one recorded round or wave."""
    errors = []
    if f64_ops(ops):
        errors.append(f"{label}: {len(f64_ops(ops))} f64 op(s) in an f32 "
                      f"program: {sorted(set(f64_ops(ops)))}")
    if host_reads(ops):
        errors.append(f"{label}: host read(s) inside it: "
                      f"{sorted(set(host_reads(ops)))}")
    if host_made(ops):
        errors.append(f"{label}: {len(host_made(ops))} tensor(s) made from a "
                      f"host value inside it (a copy a CUDA graph capture "
                      f"refuses)")
    if mesh_less and collectives(ops):
        errors.append(f"{label}: collectives in a single-device program: "
                      f"{sorted(set(collectives(ops)))}")
    return errors


# ---------------------------------------------------------------------------
# the canonical worlds (the reference's compile_budget.make_world)


def cnn_world(guard: str = "off"):
    """(trainer, params): 8 clients of 8x8x3 synthetic images, a
    (4, 8, 8)-channel SimpleCNN, FedDUMAP."""
    from repro_torch.core.pruning import FedAPConfig
    from repro_torch.core.rounds import FederatedTrainer, feddumap_config
    from repro_torch.data.pipeline import build_federated_data
    from repro_torch.data.synthetic import SyntheticSpec
    from repro_torch.models.cnn import SimpleCNN

    spec = SyntheticSpec(num_classes=10, image_shape=(8, 8, 3),
                         train_size=1700, test_size=100, noise_scale=0.5)
    data = build_federated_data(num_clients=8, server_fraction=0.1,
                                device_pool=640, spec=spec)
    cfg = feddumap_config(num_clients=8, clients_per_round=8,
                          local_epochs=1, batch_size=10, lr=0.05,
                          guard=guard,
                          fedap=FedAPConfig(probe_size=8, participants=7,
                                            min_rate=0.5))
    model = SimpleCNN(num_classes=10, image_shape=(8, 8, 3),
                      channels=(4, 8, 8), fc_width=16, device="cpu")
    trainer = FederatedTrainer(model, data, cfg, device="cpu")
    return trainer, model.init(torch.Generator().manual_seed(0))


def lm_model():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.lm import LM

    return LM(ModelConfig(name="dense-tiny", family="dense", rope="1d",
                          norm="rmsnorm", act="silu", param_dtype="float32",
                          remat="none", num_layers=2, d_model=128,
                          num_heads=4, num_kv_heads=2, d_ff=512,
                          vocab_size=2048), device="cpu")


def lm_world(backend: str = "local"):
    """(trainer, params): 8 clients of topic-sharded 16-token sequences, the
    2-layer d 128 LM with a 128-aligned d_ff 512 FFN, FedDUMAP in kernel
    mode (the masks' products through ``masked_matmul``)."""
    from repro_torch.core.pruning import FedAPConfig
    from repro_torch.core.rounds import FederatedTrainer, feddumap_config
    from repro_torch.data.pipeline import build_lm_federated_data
    from repro_torch.data.synthetic import TokenSpec

    data = build_lm_federated_data(
        num_clients=8, spec=TokenSpec(vocab_size=2048, num_topics=16,
                                      seq_len=17, num_sequences=256))
    cfg = feddumap_config(num_clients=8, clients_per_round=4,
                          local_epochs=1, batch_size=4, server_batch_size=8,
                          lr=3e-3, lr_decay=1.0, masked_compute="kernel",
                          fedap=FedAPConfig(align=128, probe_size=4,
                                            participants=2, min_rate=0.5))
    model = lm_model()
    trainer = FederatedTrainer(model, data, cfg, device="cpu",
                               backend=backend)
    return trainer, model.init(torch.Generator().manual_seed(0))


def record_round(trainer, params, *, use_masks: bool = False) -> list:
    """The operations of round 0's round program (the batch's gather and
    ``round_core``: what the card captures), its indices drawn first,
    outside the record."""
    be = trainer.backend(use_masks=use_masks)
    state = be.init_state(params)
    inputs = be._round_inputs(0)
    with CostCounter(record=True) as c:
        be._round_body(state, inputs)
    return c.ops


def record_wave(*, masked: bool = False) -> list:
    """The operations of one serving wave with every slot admitted."""
    from repro_torch.serving import DecodeEngine, ServeConfig

    model = lm_model()
    params = model.init(torch.Generator().manual_seed(0))
    masks = None
    if masked:
        masks = model.filter_masks(params, model.decide_kept(params, 0.5))
    eng = DecodeEngine(model, params,
                       ServeConfig(slots=2, cache_len=12, max_prompt=4,
                                   max_new_tokens=4, steps_per_wave=2),
                       masks=masks, device="cpu")
    for p in ([3, 1], [5, 9, 2]):
        eng.submit(np.asarray(p, np.int32))
    eng.step_wave()
    return eng.lower_wave().ops


LOCKSTEP_ARCHS = (("zamba2-1.2b", False), ("zamba2-1.2b", True),
                  ("xlstm-125m", False), ("whisper-small", False),
                  ("qwen2-vl-7b", False))


def record_lockstep(arch: str, *, masked: bool = False) -> list:
    """The operations of one lockstep step of ``arch`` reduced (2 layers,
    f32; xlstm at 4 layers, its sLSTM block included) after two prompt
    steps, with every FFN masked at 0.5 when ``masked``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.serving.lockstep import LockstepSession

    kw = {"num_layers": 4} if arch.startswith("xlstm") else {}
    cfg = dataclasses.replace(get_config(arch).reduced(**kw),
                              param_dtype="float32")
    model = LM(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    masks = None
    if masked:
        masks = model.filter_masks(params, model.decide_kept(params, 0.5))
    session = LockstepSession.new(model, params, 2, 8, masks=masks)
    prompt = torch.tensor([[3, 1], [5, 9]], dtype=torch.int32)
    enc = None
    if cfg.family == "encdec":
        enc = torch.randn((2, cfg.encoder.frames, cfg.d_model),
                          generator=gen)
    session.decode(prompt, 1, enc_embeds=enc)
    return session.lower_step().ops


# ---------------------------------------------------------------------------
# the mesh round at MESH_RANKS gloo ranks


def _counts(ops: list) -> dict:
    return dict(collections.Counter(collectives(ops)))


def mesh_round_collectives() -> dict:
    """{kind: count} of the collectives of one LM-world round on the mesh
    backend (run on every rank of a process group with MESH_RANKS
    ranks)."""
    trainer, params = lm_world(backend="mesh")
    return _counts(record_round(trainer, params))


def mesh_collectives() -> dict:
    """{program: {kind: count}} of the mesh programs on every rank of a
    process group with MESH_RANKS ranks: a round (as
    :func:`mesh_round_collectives`), the LM world's sharded eval body, and
    one wave of a ``DecodeEngine(mesh=)`` over the ranks (a slot each)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import DecodeEngine, ServeConfig

    trainer, params = lm_world(backend="mesh")
    out = {"mesh_round": _counts(record_round(trainer, params))}
    be = trainer.backend()
    with CostCounter(record=True) as c:
        be._sharded_eval_body(*be._eval_args({"params": params}))
    out["mesh_eval"] = _counts(c.ops)
    model = lm_model()
    eng = DecodeEngine(model, model.init(torch.Generator().manual_seed(0)),
                       ServeConfig(slots=MESH_RANKS, cache_len=12,
                                   max_prompt=4, max_new_tokens=4,
                                   steps_per_wave=2),
                       mesh=make_host_mesh(device="cpu"), device="cpu")
    for p in ([3, 1], [5, 9, 2]):
        eng.submit(np.asarray(p, np.int32))
    eng.step_wave()
    out["mesh_wave"] = _counts(eng.lower_wave().ops)
    return out


def _rank(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        counts = mesh_collectives()
        counts.update(tp_collectives())
        if rank == 0:
            with open(out, "w") as f:
                json.dump(counts, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_mesh_programs(timeout: float = 240.0) -> dict:
    """:func:`mesh_collectives` at MESH_RANKS spawned gloo ranks that meet
    over a ``FileStore`` in a temporary directory; rank 0's counts."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "out")
        ctx = mp.start_processes(_rank, args=(MESH_RANKS, store, out),
                                 nprocs=MESH_RANKS, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the {MESH_RANKS} ranks did not "
                                       f"finish in {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        with open(out) as f:
            return json.load(f)


TP_PROGRAMS = ("tp_step", "tp_prefill", "tp_decode")


def tp_config():
    """The dense test model of the tensor-parallel checks."""
    from repro_torch.configs import get_config

    return get_config("olmo-1b").reduced(num_heads=4, num_kv_heads=2,
                                         d_ff=512)


def record_tp() -> dict:
    """{program: recorded ops} of the tensor-parallel steps on a ``(1,
    MESH_RANKS)`` mesh over every rank of the process group: one round of
    the kernel-mode FedDUMAP step (2 clients x 2 local steps of 2 x 16
    tokens, 2 server steps of 2), a prefill of 2 x 16 and a decode step."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core.engine import init_round_state
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh

    cfg = tp_config()
    mesh = make_host_mesh(data=1, model=MESH_RANKS, device="cpu")
    run = steps.FLRunConfig(lr=3e-3, local_steps=2, server_tau=2,
                            server_batch=2, use_masks=True,
                            masked_compute="kernel")
    _, step = steps.make_fl_train_step(cfg, run, 2, device="cpu", mesh=mesh)
    model, prefill = steps.make_prefill_step(cfg, device="cpu", mesh=mesh)
    _, decode = steps.make_decode_step(cfg, device="cpu", mesh=mesh)
    params = model.init(torch.Generator().manual_seed(0))
    state = init_round_state(params, step.eng,
                             filter_masks=model.filter_masks(params, {}))
    batch = step.local(steps.fl_batch_specs(
        cfg, InputShape("tp", 16, 4, "train"), 2, run, abstract=False,
        seed=4, device="cpu"))
    out = {}
    with CostCounter(record=True) as c:
        step.body(state, batch)
    out["tp_step"] = c.ops
    tokens = torch.zeros((2, 16), dtype=torch.int64)
    with torch.no_grad():
        with CostCounter(record=True) as c:
            prefill(params, {"tokens": tokens})
        out["tp_prefill"] = c.ops
        cache = model.init_cache(2, 16)
        with CostCounter(record=True) as c:
            decode(params, cache, {"tokens": tokens[:, :1]})
        out["tp_decode"] = c.ops
    return out


def tp_collectives() -> dict:
    """{program: {kind: count}} of :func:`record_tp`, plus ``"lint"``: the
    round's violations of the mesh round's rules."""
    ops = record_tp()
    out = {k: _counts(v) for k, v in ops.items()}
    out["lint"] = check_stream("tensor-parallel step", ops["tp_step"],
                               mesh_less=False)
    return out


def load_budget() -> dict:
    return json.loads(BUDGET_PATH.read_text())


MESH_PROGRAMS = ("mesh_round", "mesh_eval", "mesh_wave")


def check_mesh_budget(counts: dict, budget: dict | None = None, *,
                      program: str = "mesh_round") -> list[str]:
    """Failure messages for one mesh program's collectives ``counts``
    against its record in the budget."""
    budget = load_budget() if budget is None else budget
    want = budget[program]["collectives"]
    if counts != want:
        return [f"{program} at {MESH_RANKS} ranks: collectives {counts}, "
                f"the recorded budget says {want} — an unbudgeted "
                f"collective is on the program's critical path"]
    return []


# ---------------------------------------------------------------------------


def check(*, mesh: bool = True) -> list[str]:
    """Every invariant; failure messages (empty: clean).  ``mesh=False``
    skips the spawned mesh round."""
    errors = []
    trainer, params = cnn_world()
    errors += check_stream("CNN round", record_round(trainer, params))
    trainer, params = cnn_world(guard="reject_client")
    errors += check_stream("guarded CNN round",
                           record_round(trainer, params))
    trainer, params = lm_world()
    errors += check_stream("LM round (kernel masks)",
                           record_round(trainer, params, use_masks=True))
    for label, masked in (("serving wave", False),
                          ("serving wave (masked)", True)):
        errors += check_stream(label, record_wave(masked=masked))
    for arch, masked in LOCKSTEP_ARCHS:
        label = f"lockstep step {arch}{' (masked)' if masked else ''}"
        errors += check_stream(label, record_lockstep(arch, masked=masked))
    if mesh:
        got = spawn_mesh_programs()
        for program in MESH_PROGRAMS + TP_PROGRAMS:
            errors += check_mesh_budget(got[program], program=program)
        errors += got["lint"]
    return errors


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="repro_torch.analysis.op_lint",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--update", action="store_true",
                    help="re-record the mesh programs' collectives into "
                         "op_budget.json")
    args = ap.parse_args(argv)
    if args.update:
        budget = load_budget()
        got = spawn_mesh_programs()
        for program in MESH_PROGRAMS + TP_PROGRAMS:
            budget[program] = {"ranks": MESH_RANKS,
                               "collectives": got[program]}
        BUDGET_PATH.write_text(json.dumps(budget, indent=2) + "\n")
        print(f"recorded: "
              f"{ {k: budget[k] for k in MESH_PROGRAMS + TP_PROGRAMS} }")
        return 0
    errors = check()
    for e in errors:
        print(f"FAIL {e}")
    print(f"repro_torch.analysis.op_lint: {len(errors)} violation(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
