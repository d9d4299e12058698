"""Ranks of a ``torch.distributed`` gloo world for the mesh backend's tests.

:func:`run_world` spawns ``world`` processes (``torch.multiprocessing``'s
"spawn") that meet over a ``FileStore`` in the test's temporary directory,
each with one torch thread; every rank runs :func:`rank_main`, and rank 0's
results come back through a file.  Each join has a timeout, so a hung rank
fails the test instead of the suite.

The worlds the tests build are here too, so the parent and the ranks build
them alike: a softmax-regression client world with explicit round batches
(drawn with numpy), a small LM world with ragged FedAP probes, and (for
:func:`data_main`) a softmax world whose rounds the trainer draws from a
dataset each rank stores only its block of, and a SimpleCNN with a
101-row test split.  This module imports torch, numpy and the port only.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.engine import FedDynConfig, FedProxConfig
from repro_torch.core.rounds import FederatedTrainer, FLConfig
from repro_torch.data.pipeline import FederatedData
from repro_torch.reliability.faults import NaNGrad
from repro_torch.utils.tree import tree_leaves

DIM, CLASSES, N_TOTAL, STEPS, BATCH, TAU, ROUNDS = 6, 4, 8, 2, 5, 3, 3
MODES = {
    "fedavg": dict(use_server_update=False, local_momentum="none",
                   server_momentum=False),
    "feddu": dict(use_server_update=True, local_momentum="none",
                  server_momentum=False),
    "server_momentum": dict(use_server_update=True, local_momentum="none",
                            server_momentum=True),
    "device_momentum": dict(use_server_update=True, local_momentum="restart",
                            server_momentum=False),
    "feddum": dict(use_server_update=True, local_momentum="restart",
                   server_momentum=True),
    "fedda": dict(use_server_update=True, local_momentum="communicated",
                  server_momentum=True),
}
# case -> (mode, extra FLConfig fields, dropout, guard)
CASES = {m: (m, {}, False, False) for m in MODES}
CASES.update({
    "fedprox": ("feddum", dict(algorithm="fedprox",
                               fedprox=FedProxConfig(mu=0.05)), False, False),
    "feddyn": ("feddum", dict(algorithm="feddyn",
                              feddyn=FedDynConfig(alpha=0.05)), False, False),
    "dropout": ("feddum", dict(dropout_rate=0.25), True, False),
    "guard": ("feddum", dict(guard="reject_client"), False, True),
})
# the dropout rows: round 1 drops every client (the round is a no-op)
ACTIVES = np.asarray([[1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 0, 1]], np.float32)


class Softmax:
    """Softmax regression on the simulation model contract."""

    def __init__(self, seed=7):
        self.seed = seed

    def init(self, generator=None):
        rng = np.random.default_rng(self.seed)
        return {"w": torch.as_tensor(
                    (0.1 * rng.standard_normal((DIM, CLASSES)))
                    .astype(np.float32)),
                "b": torch.zeros(CLASSES)}

    def loss_and_acc(self, params, x, y):
        logits = x @ params["w"] + params["b"]
        logp = torch.log_softmax(logits, -1)
        loss = -torch.gather(logp, -1, y.long()[..., None]).mean()
        return loss, (logits.argmax(-1) == y).float().mean()


def softmax_world(clients: int, sbatch: int, *, test: int = 9, seed=42):
    """(data, rounds): a dataset sized for the trainer (sizes, client
    count, test split) and ``ROUNDS`` explicit round batches of
    ``clients`` clients, every one with a ``sel``."""
    rng = np.random.default_rng(seed)
    sizes = rng.uniform(10.0, 50.0, N_TOTAL).astype(np.float32)
    data = FederatedData(
        client_x=np.zeros((N_TOTAL, STEPS * BATCH, DIM), np.float32),
        client_y=np.zeros((N_TOTAL, STEPS * BATCH), np.int64),
        sizes=sizes,
        client_dists=np.full((N_TOTAL, CLASSES), 0.25, np.float32),
        server_x=np.zeros((TAU * sbatch, DIM), np.float32),
        server_y=np.zeros((TAU * sbatch,), np.int64),
        server_dist=np.full((CLASSES,), 0.25, np.float32),
        test_x=rng.standard_normal((test, DIM)).astype(np.float32),
        test_y=rng.integers(0, CLASSES, test).astype(np.int64))
    rounds = []
    for _ in range(ROUNDS):
        sel = rng.choice(N_TOTAL, clients, replace=False).astype(np.int32)
        rounds.append({
            "client": (rng.standard_normal((clients, STEPS, BATCH, DIM))
                       .astype(np.float32),
                       rng.integers(0, CLASSES, (clients, STEPS, BATCH))
                       .astype(np.int32)),
            "server": (rng.standard_normal((TAU, sbatch, DIM))
                       .astype(np.float32),
                       rng.integers(0, CLASSES, (TAU, sbatch))
                       .astype(np.int32)),
            "sizes": sizes[sel], "sel": sel,
            "d_round": np.float32(0.3), "d_server": np.float32(0.02),
            "n0": np.float32(500.0)})
    return data, rounds


def case_rounds(case: str, rounds: list) -> list:
    if CASES[case][2]:
        return [dict(b, active=ACTIVES[r][: len(b["sel"])])
                for r, b in enumerate(rounds)]
    return rounds


def case_config(case: str, clients: int, sbatch: int) -> FLConfig:
    mode, extra, _, guard = CASES[case]
    faults = ()
    if guard:   # the second selected client's upload is NaN in round 1
        _, rounds = softmax_world(clients, sbatch)
        faults = (NaNGrad(client=int(rounds[1]["sel"][1]), round=1),)
    return FLConfig(num_clients=N_TOTAL, clients_per_round=clients,
                    local_epochs=1, batch_size=BATCH, lr=0.08, lr_decay=0.97,
                    server_batch_size=sbatch, faults=faults,
                    **MODES[mode], **extra)


class MoeSoftmax(Softmax):
    """The same model flagged ``moe``: the mesh backend then keeps each
    server batch whole on every rank, as for the moe family."""

    moe = True


def engine_history(case: str, backend: str, *, clients=4, sbatch=6,
                   model=Softmax, backend_opts=None, programs=None):
    """Per round (params, server_m, tau_eff) of ``case`` on a backend.
    ``programs`` (a dict), when given, receives the round program's key
    count and, on the mesh, the all-reduces of each round."""
    data, rounds = softmax_world(clients, sbatch)
    rounds = case_rounds(case, rounds)
    trainer = FederatedTrainer(model(), data,
                               case_config(case, clients, sbatch),
                               device="cpu", backend=backend,
                               backend_opts=backend_opts)
    be = trainer.backend(batches=lambda t: rounds[t])
    state = be.init_state(model().init())
    hist, reductions = [], []
    for t in range(ROUNDS):
        before = getattr(be, "reductions", 0)
        state, mets = be.run_rounds(state, t, 1)
        reductions.append(getattr(be, "reductions", 0) - before)
        hist.append(({k: v.clone() for k, v in state["params"].items()},
                     {k: v.clone() for k, v in state["server_m"].items()},
                     float(mets[0]["tau_eff"])))
    if programs is not None:
        programs.update(keys=be.chunk._cache_size(), reductions=reductions)
    return hist


def evaluate(backend: str, test: int):
    data, _ = softmax_world(4, 6, test=test)
    trainer = FederatedTrainer(Softmax(), data, case_config("feddum", 4, 6),
                               device="cpu", backend=backend)
    be = trainer.backend()
    loss, acc = be.evaluate(be.init_state(Softmax(seed=3).init()))
    return float(loss), float(acc)


def lm_world():
    """A 2-layer LM and a token dataset whose server pool (5 sequences) is
    smaller than the probe (8): ragged FedAP probes."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.lm import LM

    cfg = ModelConfig(name="dense-tiny", family="dense", num_layers=2,
                      d_model=128, num_heads=4, num_kv_heads=2, d_ff=512,
                      vocab_size=64, param_dtype="float32", remat="none")
    model = LM(cfg, device="cpu")
    rng = np.random.default_rng(0)
    toks = lambda *s: rng.integers(0, 64, s).astype(np.int32)  # noqa: E731
    data = FederatedData(
        client_x=toks(6, 12, 9), client_y=toks(6, 12, 9),
        sizes=np.full(6, 12.0, np.float32),
        client_dists=rng.dirichlet(np.ones(4), 6).astype(np.float32),
        server_x=toks(5, 9), server_y=toks(5, 9),
        server_dist=np.full(4, 0.25, np.float32),
        test_x=toks(4, 9), test_y=toks(4, 9))
    params = model.init(torch.Generator().manual_seed(1))
    init = model.init(torch.Generator().manual_seed(2))
    return model, data, params, init


def sharded_decision(mesh):
    from repro_torch.core import fedap
    from repro_torch.core.pruning import FedAPConfig

    model, data, params, init = lm_world()
    cfg = FedAPConfig(align=128, min_rate=0.0, probe_size=8,
                      participants=3)
    d = fedap.fedap_decision_sharded(model, data, cfg, params,
                                     init_params=init,
                                     rng=np.random.default_rng(0), mesh=mesh)
    return {"p_star": d.p_star, "kept": d.kept}


SERVE = dict(slots=4, cache_len=24, max_prompt=8, max_new_tokens=12,
             steps_per_wave=4)
# case -> (arch, masked) of the mesh engine's 2-rank runs
SERVED = {"dense": ("olmo-1b", False), "masked": ("olmo-1b", True),
          "vlm": ("qwen2-vl-7b", False), "moe": ("arctic-480b", False)}


def serving_world(arch: str):
    """A reduced model of ``arch``, its params and masks (None for moe), and
    ragged prompts, built alike on every rank and in the test process."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    cfg = get_config(arch).reduced()
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    masks = (None if model.moe else
             model.filter_masks(params, model.decide_kept(params, 0.5)))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(rng.integers(1, 9)))
               .astype(np.int32) for _ in range(7)]
    return model, params, masks, prompts


def serve(arch: str, masked: bool, mesh=None):
    """(uid, tokens) of every completion of ``arch``'s engine."""
    from repro_torch.serving import DecodeEngine, ServeConfig

    model, params, masks, prompts = serving_world(arch)
    eng = DecodeEngine(model, params, ServeConfig(**SERVE),
                       masks=masks if masked else None, mesh=mesh,
                       device="cpu")
    done = eng.run(prompts)
    return {"split": (eng._lo, eng._n), "steps": eng.steps,
            "done": [(c.uid, c.tokens.tolist(), c.status) for c in done]}


def serving_mesh(mesh):
    """The mesh engine's completions on this rank, and whether every rank
    returned the same ones."""
    out = {}
    for key, (arch, masked) in SERVED.items():
        got = serve(arch, masked, mesh)
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, got["done"])
        out[key] = dict(got, same_on_ranks=all(e == got["done"]
                                               for e in every))
    return out


def rank_main():
    """Everything a rank of the 2-rank world checks, in one spawn."""
    from repro_torch.analysis import op_lint
    from repro_torch.launch.mesh import make_host_mesh

    out = {"cases": {c: engine_history(c, "mesh") for c in CASES},
           "replicated": engine_history("feddum", "mesh", clients=3,
                                        sbatch=5),
           "whole_server": {
               "moe": engine_history("feddum", "mesh", model=MoeSoftmax),
               "opt": engine_history("feddum", "mesh", backend_opts={
                   "shard_server": False})},
           "eval": evaluate("mesh", 7),
           "decision": sharded_decision(make_host_mesh(device="cpu")),
           "serving": serving_mesh(make_host_mesh(device="cpu")),
           "mesh_round": op_lint.mesh_round_collectives()}
    data, _ = softmax_world(4, 6)
    for key, model in (("split", Softmax), ("moe_split", MoeSoftmax)):
        be = FederatedTrainer(model(), data, case_config("feddyn", 4, 6),
                              device="cpu", backend="mesh").backend()
        out[key] = (be.rank, be.world, tuple(be._shard.clients),
                    be._shard.server_rows, be._shard.server_weight)
    return out


def program_main():
    """The mesh round program at 2 ranks: three softmax cases' histories
    with the program's key count and each round's all-reduces; the LM world
    of ``analysis.op_lint`` (kernel mode) for 3 rounds on the mesh and on
    the local backend; and ``_reduce`` twice on tensors of two dtypes."""
    from repro_torch.analysis import op_lint
    from repro_torch.utils.tree import tree_map

    out = {"cases": {}}
    for case in PROGRAM_CASES:
        programs: dict = {}
        hist = engine_history(case, "mesh", programs=programs)
        out["cases"][case] = (hist, programs)
    lm = {}
    for name in ("mesh", "local"):
        trainer, params = op_lint.lm_world(backend=name)
        be = trainer.backend(use_masks=True)
        state = be.init_state(params)
        rounds = []
        for t in range(3):
            state, mets = be.run_rounds(state, t, 1)
            rounds.append((tree_map(torch.clone, state["params"]),
                           float(mets[0]["tau_eff"])))
        lm[name] = (rounds, be.chunk._cache_size(),
                    getattr(be, "reductions", None))
    out["lm"] = lm
    data, _ = softmax_world(4, 6)
    be = FederatedTrainer(Softmax(), data, case_config("feddum", 4, 6),
                          device="cpu", backend="mesh").backend()
    r = dist.get_rank()
    xs = [torch.full((3,), 1.0 + r), torch.full((2, 2), 2.0 * r,
                                                dtype=torch.bfloat16),
          torch.arange(4.0) + r]
    calls = []
    for _ in range(2):
        be._reduce(xs)
        calls.append(([x.clone() for x in xs], be.reductions,
                      sorted(b.data_ptr() for b in be._buckets.values())))
    out["reduce"] = calls
    return out


# cases of program_main: the plain round, FedDyn's rows (a third
# all-reduce), the guard's totals beside the FedAvg sum
PROGRAM_CASES = ("feddum", "feddyn", "guard")


# ---------------------------------------------------------------------------
# rank-local data: rounds the trainer draws from a dataset each rank stores
# only its block of

DATA_N, DATA_NK, DATA_N0, DATA_TEST = 8, 10, 18, 9
DATA_CASES = {
    "feddumap": dict(MODES["feddum"]),
    "feddyn": dict(MODES["feddum"], algorithm="feddyn",
                   feddyn=FedDynConfig(alpha=0.05)),
    "dropout": dict(MODES["feddum"], dropout_rate=0.25),
}
WORK_DIR = ""   # a directory every rank of the world shares


def data_world(n: int = DATA_N, seed: int = 5) -> FederatedData:
    """``n`` clients of ``DATA_NK`` samples each with uneven sizes and
    label distributions (so the gathered sizes and distributions count), a
    server pool of ``DATA_N0`` and a test split of ``DATA_TEST``."""
    rng = np.random.default_rng(seed)
    return FederatedData(
        client_x=rng.standard_normal((n, DATA_NK, DIM)).astype(np.float32),
        client_y=rng.integers(0, CLASSES, (n, DATA_NK)).astype(np.int64),
        sizes=rng.uniform(10.0, 50.0, n).astype(np.float32),
        client_dists=rng.dirichlet(np.ones(CLASSES), n).astype(np.float32),
        server_x=rng.standard_normal((DATA_N0, DIM)).astype(np.float32),
        server_y=rng.integers(0, CLASSES, DATA_N0).astype(np.int64),
        server_dist=np.full((CLASSES,), 0.25, np.float32),
        test_x=rng.standard_normal((DATA_TEST, DIM)).astype(np.float32),
        test_y=rng.integers(0, CLASSES, DATA_TEST).astype(np.int64))


def data_config(case: str, clients: int = 4, n: int = DATA_N,
                sbatch: int = 6, **kw) -> FLConfig:
    """2 local steps of 5 samples a client, 3 server steps of ``sbatch``."""
    return FLConfig(num_clients=n, clients_per_round=clients,
                    local_epochs=1, batch_size=5, lr=0.08, lr_decay=0.97,
                    server_batch_size=sbatch, **DATA_CASES[case], **kw)


def data_history(case: str, backend: str, *, clients: int = 4,
                 n: int = DATA_N, **kw):
    """Per round (params, server_m, tau_eff, FedDyn's whole h or None) of
    ``case`` on rounds the trainer draws, with the backend's device
    dataset's row counts, its round program's keys and its scatters."""
    data = data_world(n)
    trainer = FederatedTrainer(Softmax(), data, data_config(
        case, clients, n, **kw), device="cpu", backend=backend)
    be = trainer.backend()
    state = be.init_state(Softmax().init())
    hist = []
    for t in range(ROUNDS):
        state, mets = be.run_rounds(state, t, 1)
        whole = be.whole_state(state)
        h = (None if "client_state" not in whole else
             {k: v.clone() for k, v in
              whole["client_state"]["per_client"]["h"].items()})
        hist.append(({k: v.clone() for k, v in state["params"].items()},
                     {k: v.clone() for k, v in state["server_m"].items()},
                     float(mets[0]["tau_eff"]), h))
    d = be.device_data()
    info = {"rows": {k: int(d[k].shape[0]) for k in
                     ("client_x", "client_y", "sizes", "client_dists",
                      "test_x")},
            "keys": be.chunk._cache_size(),
            "scatters": getattr(be, "scatters", 0),
            "h_rows": (None if "client_state" not in state else int(
                state["client_state"]["per_client"]["h"]["w"].shape[0]))}
    return hist, info


def _my_block(d: dict, data: FederatedData) -> bool:
    """This rank's device dataset holds exactly its block of clients (and
    of the test split padded with row-0 copies) and row 0 of the split."""
    from repro_torch.utils.arrays import pad_rows_with_first

    r, w = dist.get_rank(), dist.get_world_size()
    n = data.client_x.shape[0] // w
    rows = slice(r * n, (r + 1) * n)
    test = pad_rows_with_first(data.test_x, -(-data.test_x.shape[0] // w)
                               * w)
    t = test.shape[0] // w
    return (np.array_equal(d["client_x"].numpy(), data.client_x[rows])
            and np.array_equal(d["client_y"].numpy(), data.client_y[rows])
            and np.array_equal(d["sizes"].numpy(), data.sizes[rows])
            and np.array_equal(d["client_dists"].numpy(),
                               data.client_dists[rows])
            and np.array_equal(d["test_x"].numpy(),
                               test[r * t:(r + 1) * t])
            and np.array_equal(d["test_x0"].numpy(), data.test_x[:1]))


def cnn_eval_world():
    """A SimpleCNN of 8x8x3 images over 8 clients, its params, and a
    101-row test split."""
    from repro_torch.data.pipeline import build_federated_data
    from repro_torch.data.synthetic import SyntheticSpec
    from repro_torch.models.cnn import SimpleCNN

    spec = SyntheticSpec(num_classes=10, image_shape=(8, 8, 3),
                         train_size=1200, test_size=101, noise_scale=0.5)
    data = build_federated_data(num_clients=8, server_fraction=0.1,
                                device_pool=640, spec=spec)
    model = SimpleCNN(num_classes=10, image_shape=(8, 8, 3),
                      channels=(4, 8, 8), fc_width=16, device="cpu")
    return model, data, model.init(torch.Generator().manual_seed(3))


def cnn_eval(backend: str, **opts):
    """(loss, acc) of the CNN eval world's test split on a backend, and
    the backend's eval keys."""
    model, data, params = cnn_eval_world()
    cfg = FLConfig(num_clients=8, clients_per_round=4, local_epochs=1,
                   batch_size=10)
    trainer = FederatedTrainer(model, data, cfg, device="cpu",
                               backend=backend, backend_opts=opts or None)
    be = trainer.backend()
    state = be.init_state(params)
    got = [tuple(float(v) for v in be.evaluate(state)) for _ in range(2)]
    return got, _my_block(be.device_data(), data) if opts.get(
        "shard_eval", True) and backend == "mesh" else None


def feddyn_resume():
    """A FedDyn plan killed after its second chunk and resumed from its
    checkpoints, against the uninterrupted run: histories, final whole
    states, and the checkpoint's ``h``."""
    from repro_torch.core.plan import TrainPlan
    from repro_torch.reliability import checkpoint as ckpt
    from repro_torch.reliability.faults import (
        KillAfterChunk,
        SimulatedCrash,
    )

    data = data_world()

    def plan(name):
        return TrainPlan(*TrainPlan.standard(4).events, checkpoint_every=1,
                         checkpoint_dir=os.path.join(WORK_DIR, name))

    def trainer(faults=()):
        return FederatedTrainer(Softmax(), data, data_config(
            "feddyn", faults=faults), device="cpu", backend="mesh")

    whole = trainer().run(plan("whole"), params=Softmax().init())
    try:
        trainer((KillAfterChunk(2),)).run(plan("killed"),
                                          params=Softmax().init())
        crashed = False
    except SimulatedCrash:
        crashed = True
    resumed = trainer().resume(os.path.join(WORK_DIR, "killed"))
    saved = ckpt.load_checkpoint(os.path.join(WORK_DIR, "whole"))
    same = (resumed.history["loss"] == whole.history["loss"] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(resumed.state),
                                          tree_leaves(whole.state))))
    h = saved["state"]["client_state"]["per_client"]["h"]
    return {"crashed": crashed, "same": same,
            "h_rows": {k: int(np.asarray(v).shape[0]) for k, v in h.items()},
            "h_equal": all(np.array_equal(np.asarray(h[k]), v.numpy())
                           for k, v in whole.state["client_state"]
                           ["per_client"]["h"].items())}


def mesh_engine_programs(mesh):
    """The 2-rank dense engine's program counts after serving, and the
    collectives of its lowered wave."""
    from repro_torch.analysis import op_lint
    from repro_torch.serving import DecodeEngine, ServeConfig

    model, params, _, prompts = serving_world("olmo-1b")
    eng = DecodeEngine(model, params, ServeConfig(**SERVE), mesh=mesh,
                       device="cpu")
    done = eng.run(prompts)
    return {"done": [(c.uid, c.tokens.tolist(), c.status) for c in done],
            "programs": eng.program_counts(),
            "wave": op_lint.collectives(eng.lower_wave().ops)}


def data_main():
    """Everything a rank of the rank-local data tests checks, in one
    spawn."""
    from repro_torch.analysis import op_lint
    from repro_torch.launch.mesh import make_host_mesh

    out = {"cases": {c: data_history(c, "mesh") for c in DATA_CASES}}
    out["replicated"] = data_history("feddumap", "mesh", clients=3, n=7,
                                     sbatch=5)
    be = FederatedTrainer(Softmax(), data_world(), data_config("feddyn"),
                          device="cpu", backend="mesh").backend()
    mine = _my_block(be.device_data(), data_world())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    out["blocks"] = every
    evals = {}
    for name, opts in (("sharded", {}), ("whole", {"shard_eval": False})):
        got, block = cnn_eval("mesh", **opts)
        evals[name] = got
        if block is not None:
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, block)
            evals["blocks"] = every
    out["eval"] = evals
    out["resume"] = feddyn_resume()
    out["engine"] = mesh_engine_programs(make_host_mesh(device="cpu"))
    out["budget"] = op_lint.mesh_collectives()
    return out


# ---------------------------------------------------------------------------
# tensor parallelism over the "model" mesh axis: the pod-scale steps of a
# small dense LM, the params a JAX init's (saved by the test as numpy)

# case -> (arch, heads, kv heads): the kv heads split over a 2-way model
# axis, and one kv head kept whole on every rank
TP_CASES = {"kv_split": ("olmo-1b", 4, 2), "kv_whole": ("chatglm3-6b", 4, 1)}
TP_RUN = dict(lr=3e-3, local_steps=2, server_tau=2, server_batch=2,
              use_masks=True, masked_compute="kernel")
TP_CLIENTS, TP_SEQ, TP_DECODE = 2, 16, 8
TP_SHAPES = {"train": ("tp-train", TP_SEQ, 2 * TP_CLIENTS, "train"),
             "prefill": ("tp-prefill", TP_SEQ, 2, "prefill")}


def tp_config(case: str):
    from repro_torch.configs import get_config

    arch, h, kv = TP_CASES[case]
    return get_config(arch).reduced(num_heads=h, num_kv_heads=kv, d_ff=512)


class RankNaN:
    """A device fault: client ``client``'s trained model becomes NaN in the
    block of the ``model`` rank ``rank`` only."""

    def __init__(self, client: int, rank: int, model_rank: int):
        self.client, self.hit = client, rank == model_rank

    def apply_client(self, local, params, sel, round_):
        from repro_torch.utils.tree import tree_map

        if not self.hit:
            return local
        hit = sel == self.client
        return tree_map(lambda t: t.copy_(torch.where(hit, torch.nan, t)),
                        local)


def _whole(model, tree):
    """A param-structured tree of a rank's blocks, gathered whole."""
    from repro_torch.sharding.specs import gather_tree

    return gather_tree(tree, model.block_specs(), model._plan,
                       {"model": model.tp.group}, axes=model.axes(),
                       kv_heads=model.cfg.padded_num_kv_heads)


def tp_train(case: str, mesh, inputs: dict, *, rounds: int = 2,
             guard: bool = False) -> dict:
    """Round 0 of the kernel-mode FedDUMAP step; then (``rounds`` 2) the
    FedAP decision at 0.5 on the sharded params, ``with_masks`` and round
    1.  ``guard``: one round under ``reject_client`` with client 0's model
    NaN in model rank 0's block only.  The params after each round
    gathered whole, and each round's tau_eff and health."""
    import dataclasses

    from repro_torch import interop
    from repro_torch.configs.base import InputShape
    from repro_torch.core import engine
    from repro_torch.launch import steps
    from repro_torch.utils.tree import tree_map

    cfg = tp_config(case)
    run = steps.FLRunConfig(
        **(dict(TP_RUN, use_masks=False, masked_compute="params",
                guard="reject_client") if guard else TP_RUN))
    _, step = steps.make_fl_train_step(cfg, run, TP_CLIENTS, device="cpu",
                                       mesh=mesh)
    model = build_tp(cfg, mesh)
    params = interop.shard_params_from_jax(inputs[case]["params"], model,
                                           device="cpu")
    fm = None if guard else model.filter_masks(params, {})
    state = engine.init_round_state(params, step.eng, filter_masks=fm,
                                    num_clients=TP_CLIENTS)
    if guard:
        step.eng = dataclasses.replace(step.eng, faults=(RankNaN(
            0, 0, model.tp.group.rank),))
    batch = steps.fl_batch_specs(cfg, InputShape(*TP_SHAPES["train"]),
                                 TP_CLIENTS, run, abstract=False, seed=4,
                                 device="cpu")
    out = {"params": [], "tau": [], "health": []}
    for r in range(rounds):
        if r == 1:
            kept = model.decide_kept(state["params"], 0.5)
            whole_p = _whole(model, state["params"])
            plain = build_tp(cfg, None)
            out["kept"] = (kept["mlp"], plain.decide_kept(whole_p,
                                                          0.5)["mlp"])
            state = steps.with_masks(
                state, model.param_masks(state["params"], kept),
                model.filter_masks(state["params"], kept))
            out["masks"] = (_whole(model, state["masks"]),
                            plain.param_masks(whole_p, kept))
            out["filter_masks"] = (
                model.tp.group.all_gather(state["filter_masks"]["mlp"], 1),
                plain.filter_masks(whole_p, kept)["mlp"])
        met = step.body(state, step.local(batch))
        sh = step.shard
        out["shard"] = (None if sh.clients is None else tuple(sh.clients),
                        sh.server_rows is not None, sh.server_weight)
        out["params"].append(_whole(model, tree_map(torch.clone,
                                                    state["params"])))
        out["tau"].append(float(met["tau_eff"]))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, float(met["health"]))
        out["health"].append(every)
    return out


def build_tp(cfg, mesh):
    from repro_torch.models.api import build_model

    return build_model(cfg, device="cpu", mesh=mesh)


def tp_serve(case: str, mesh, inputs: dict) -> dict:
    """The prefill step's whole logits and TP_DECODE greedy decode steps
    (tokens and logits) from the sharded params."""
    from repro_torch import interop
    from repro_torch.launch import steps

    cfg = tp_config(case)
    model, prefill = steps.make_prefill_step(cfg, device="cpu", mesh=mesh)
    _, decode = steps.make_decode_step(cfg, device="cpu", mesh=mesh)
    params = interop.shard_params_from_jax(inputs[case]["params"], model,
                                           device="cpu")
    tokens = torch.from_numpy(inputs["tokens"])
    out = {}
    with torch.no_grad():
        out["prefill"] = prefill(params, {"tokens": tokens})
        cache = model.init_cache(tokens.shape[0], TP_SEQ)
        tok = tokens[:, :1]
        out["tokens"], out["logits"] = [], []
        for _ in range(TP_DECODE):
            logits, cache = decode(params, cache, {"tokens": tok})
            tok = logits[:, -1].argmax(-1, keepdim=True).to(tokens.dtype)
            out["tokens"].append(tok[:, 0])
            out["logits"].append(logits[:, -1])
    return out


def tp_main():
    """Everything a rank of the 2-rank (1, 2) world checks, in one spawn:
    both head placements through the three steps, the guard, and the
    programs' collectives (``analysis.op_lint.tp_collectives``)."""
    from repro_torch.analysis import op_lint
    from repro_torch.launch.mesh import make_host_mesh

    inputs = torch.load(os.path.join(WORK_DIR, "tp_inputs.pt"),
                        weights_only=False)
    mesh = make_host_mesh(data=1, model=2, device="cpu")
    out = {}
    for case in TP_CASES:
        out[case] = {"serve": tp_serve(case, mesh, inputs),
                     "train": tp_train(case, mesh, inputs),
                     "guard": tp_train(case, mesh, inputs, rounds=1,
                                          guard=True)}
    out["collectives"] = op_lint.tp_collectives()
    return out


def tp4_main():
    """One kernel-mode step of each case on a (2, 2) mesh of 4 ranks."""
    from repro_torch.launch.mesh import make_host_mesh

    inputs = torch.load(os.path.join(WORK_DIR, "tp_inputs.pt"),
                        weights_only=False)
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    return {case: tp_train(case, mesh, inputs, rounds=1)
            for case in TP_CASES}


def _child(rank, world, store_path, out_path, main="rank_main"):
    global WORK_DIR
    WORK_DIR = os.path.dirname(store_path)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        out = globals()[main]()
        if rank == 0:
            torch.save(out, out_path)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(tmp_path, world: int = 2, timeout: float = 240.0,
              main: str = "rank_main"):
    """Spawn the ranks, each running ``main`` (a function of this module),
    wait (at most ``timeout`` seconds), return rank 0's results."""
    store, out = str(tmp_path / "store"), str(tmp_path / "out.pt")
    ctx = mp.start_processes(_child, args=(world, store, out, main),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world} ranks did not finish in "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    assert os.path.exists(out)
    return torch.load(out, weights_only=False)
