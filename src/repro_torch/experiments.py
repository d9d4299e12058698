"""The paper's FL experiments on the port (Section 4's evaluation).

Counterpart of the reference's ``benchmarks/paper_experiments.py``: the
paper's protocol on the synthetic CIFAR-10 substitute, 100 devices over a
10,000-image device pool, 10 sampled a round, E = 5, B = 10, lr 0.1
decayed 0.99 a round, server data p of the device pool drawn from the
held-out images, pruning at round 30:

  PYTHONPATH=src python -m repro_torch.experiments --suite main
  PYTHONPATH=src python -m repro_torch.experiments --suite ablations --device cpu

The heterogeneity scenario matrix (client algorithm x Dirichlet skew x
participation and dropout) runs on either backend (``--backend mesh``:
the clients split over the ranks of ``torch.distributed``, a world of one
unless launched by ``torchrun``):

  PYTHONPATH=src python -m repro_torch.experiments --grid smoke

Writes one JSON per run into ``results/paper_torch/`` under the working
directory (the grid writes one ``BENCH_scenario_matrix.json``); a run whose
file exists is skipped.  Records carry the reference's keys plus
``device``.

Seeds: every cell trains on its own seed, derived from ``(base_seed,
cell_index)`` by :func:`cell_seed` with numpy's ``SeedSequence`` (the
reference folds the cell index into a ``jax.random`` key, which the port
cannot run).  The seeds, and the generators' draws behind them, differ
from the reference's in any case, so a port run reproduces a port run,
not the reference's numbers.
"""
from __future__ import annotations

import argparse
import json
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import baselines, niid
from repro_torch.core.engine import FedDynConfig, FedProxConfig
from repro_torch.core.plan import TrainPlan, fedap_plan
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.rounds import FederatedTrainer, FLConfig, feddumap_config
from repro_torch.core.server_update import FedDUConfig
from repro_torch.data.pipeline import build_federated_data
from repro_torch.data.synthetic import SyntheticSpec
from repro_torch.models.cnn import LeNet5, SimpleCNN

OUT = Path("results/paper_torch")

# The paper protocol, scaled to the reference's: 100 clients, 10 a round,
# E = 5, B = 10.
NUM_CLIENTS = 100
ROUNDS = 60
SPEC = SyntheticSpec(num_classes=10, image_shape=(10, 10, 3),
                     train_size=13000, test_size=2000, noise_scale=0.45)
DEVICE_POOL = 10000
COMMON = dict(num_clients=NUM_CLIENTS, clients_per_round=10, local_epochs=5,
              batch_size=10, lr=0.1, lr_decay=0.99)

MAIN_ALGOS = ("fedavg", "feddu", "feddum", "fedap", "fedduap", "feddumap",
              "datasharing", "hybridfl", "serverm", "devicem", "fedda",
              "feddf", "fedkt", "imc", "prunefl", "hrank")


def cell_seed(base_seed: int, cell_index: int) -> int:
    """The per-cell seed: 32 bits of ``SeedSequence((base_seed,
    cell_index))``, so every cell has its own reproducible draws."""
    return int(np.random.SeedSequence((base_seed, cell_index))
               .generate_state(1, np.uint32)[0])


def make_model(name: str, device="cuda"):
    if name == "cnn":
        return SimpleCNN(num_classes=10, image_shape=SPEC.image_shape,
                         device=device)
    if name == "lenet":
        return LeNet5(num_classes=10, image_shape=SPEC.image_shape,
                      device=device)
    raise ValueError(name)


def _json_safe(x):
    if isinstance(x, dict):
        return {str(k): _json_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_safe(v) for v in x]
    if isinstance(x, (np.generic, torch.Tensor)):
        return x.item()
    return x


BACKENDS = ("local", "mesh")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def run_one(tag: str, *, model_name="cnn", algo="fedavg", p=0.05,
            server_niid="iid", rounds=ROUNDS, seed=0, cell_index=None,
            feddu_overrides=None, prune_round=30, static_tau=None,
            backend="local", out_dir: Path = OUT, device="cuda") -> dict:
    """One cell of the paper's tables: ``algo`` on ``model_name`` with
    server data ``p``, ``rounds`` rounds evaluated every 2, pruning (where
    the algorithm prunes) at ``prune_round``.  Returns the record it
    writes to ``out_dir/<tag>.json``."""
    _check_backend(backend)
    dev = _device.resolve(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{tag}.json"
    if path.exists():
        print(f"[skip] {tag}")
        return json.loads(path.read_text())
    t0 = time.time()
    base_seed = seed
    if cell_index is None:
        cell_index = zlib.crc32(tag.encode())
    seed = cell_seed(base_seed, cell_index)
    data = build_federated_data(num_clients=NUM_CLIENTS, server_fraction=p,
                                server_niid=server_niid,
                                device_pool=DEVICE_POOL, spec=SPEC, seed=seed)
    model = make_model(model_name, dev)
    feddu = FedDUConfig(**(feddu_overrides or {}),
                        **({"static_tau_eff": static_tau}
                           if static_tau else {}))
    # Paper-faithful FedAP re-materializes the model (the device-FLOP
    # shrink of Tables 6-9): Prune(mode="shrink").
    apcfg = FedAPConfig(prune_round=prune_round, probe_size=32,
                        participants=6)
    plan = TrainPlan.standard(rounds, eval_every=2)

    if algo == "fedavg":
        cfg = baselines.fedavg_config(**COMMON, seed=seed)
    elif algo == "feddu":
        cfg = baselines.feddu_config(**COMMON, seed=seed, feddu=feddu)
    elif algo == "feddum":
        cfg = feddumap_config(**COMMON, seed=seed, feddu=feddu)
    elif algo == "serverm":
        cfg = baselines.server_momentum_config(**COMMON, seed=seed,
                                               feddu=feddu)
    elif algo == "devicem":
        cfg = baselines.device_momentum_config(**COMMON, seed=seed,
                                               feddu=feddu)
    elif algo == "fedda":
        cfg = baselines.fedda_config(**COMMON, seed=seed, feddu=feddu)
    elif algo == "datasharing":
        data = baselines.apply_data_sharing(data,
                                            np.random.default_rng(seed))
        cfg = baselines.fedavg_config(**COMMON, seed=seed)
    elif algo == "hybridfl":
        data = baselines.apply_hybrid_fl(data)
        cfg = baselines.fedavg_config(
            **{**COMMON, "num_clients": NUM_CLIENTS + 1}, seed=seed)
    elif algo in ("feddf", "fedkt"):
        cfg = baselines.fedavg_config(**COMMON, seed=seed)
        hook = baselines.make_distillation_round_end(
            model, data, mode=algo, steps=10, batch=32, seed=seed)
        plan = TrainPlan.with_callback(rounds, hook, eval_every=2)
    elif algo in ("imc", "prunefl"):
        cfg = baselines.fedavg_config(**COMMON, seed=seed)
        hook = baselines.make_unstructured_pruning_hook(
            rate=0.5, prune_round=prune_round,
            refresh_every=10 if algo == "prunefl" else None)
        plan = TrainPlan.with_callback(rounds, hook, eval_every=2)
    elif algo == "hrank":
        cfg = baselines.fedavg_config(**COMMON, seed=seed)
        hook = baselines.make_hrank_pruning_hook(
            model, data, rate=0.4, prune_round=prune_round, probe=32)
        plan = TrainPlan.with_callback(rounds, hook, eval_every=2)
    elif algo == "fedap":
        cfg = baselines.fedavg_config(**COMMON, seed=seed, fedap=apcfg)
        plan = fedap_plan(rounds, prune_round=prune_round, mode="shrink",
                          eval_every=2)
    elif algo == "fedduap":   # FedDU + FedAP, no momentum
        cfg = baselines.feddu_config(**COMMON, seed=seed, feddu=feddu,
                                     fedap=apcfg)
        plan = fedap_plan(rounds, prune_round=prune_round, mode="shrink",
                          eval_every=2)
    elif algo == "feddumap":  # the full method
        cfg = feddumap_config(**COMMON, seed=seed, feddu=feddu, fedap=apcfg)
        plan = fedap_plan(rounds, prune_round=prune_round, mode="shrink",
                          eval_every=2)
    else:
        raise ValueError(algo)

    trainer = FederatedTrainer(model, data, cfg, device=dev, backend=backend)
    init_params = model.init(torch.Generator(device=dev).manual_seed(seed))
    flops_before = model.flops_per_example(init_params, SPEC.image_shape)
    res = trainer.run(plan, params=init_params)
    params, hist = res.params, res.history
    flops_after = (model.flops_per_example(params, SPEC.image_shape)
                   if algo in ("fedap", "fedduap", "feddumap", "hrank")
                   else flops_before)

    rec = {
        "tag": tag, "algo": algo, "model": model_name, "p": p,
        "server_niid": server_niid, "rounds": rounds, "seed": seed,
        "base_seed": base_seed, "cell_index": cell_index,
        "final_acc": hist["acc"][-1],
        "best_acc": max(hist["acc"]),
        "history": hist,
        "mflops_before": flops_before / 1e6,
        "mflops_after": flops_after / 1e6,
        "wall_s": time.time() - t0,
        "device": str(dev),
    }
    prune_art = res.artifacts.get("prune")
    if prune_art is not None:
        rec["fedap"] = {"p_star": prune_art["p_star"],
                        "layer_rates": prune_art["layer_rates"],
                        "kept_counts": prune_art["kept_counts"]}
    rec = _json_safe(rec)
    path.write_text(json.dumps(rec))
    print(f"[done] {tag}: acc={rec['final_acc']:.3f} "
          f"best={rec['best_acc']:.3f} ({rec['wall_s']:.0f}s)", flush=True)
    return rec


def suite_main(**kw):
    """The paper's Table 10/12 comparison on the CNN model."""
    return [run_one(f"main_cnn_{algo}", algo=algo, p=0.05, **kw)
            for algo in MAIN_ALGOS]


def suite_p_sweep(**kw):
    """Figure 2: FedDU with p in {1%, 5%, 10%}."""
    return [run_one(f"psweep_feddu_p{int(p * 100)}", algo="feddu", p=p, **kw)
            for p in [0.01, 0.05, 0.10]]


def suite_ablations(**kw):
    """Tables 2-5: tau_eff static vs dynamic, f'(acc), C, server non-IID."""
    recs = [run_one(f"abl_static_tau{tau}", algo="feddu",
                    static_tau=float(tau), **kw) for tau in [5, 10, 20]]
    recs.append(run_one("abl_fprime_inv", algo="feddu",
                        feddu_overrides={"f_prime_kind": "inv"}, **kw))
    recs += [run_one(f"abl_C{c}", algo="feddu", feddu_overrides={"C": c},
                     **kw) for c in [0.5, 1.5]]
    recs += [run_one(f"abl_server_{kind}", algo="feddu", server_niid=kind,
                     **kw) for kind in ["iid", "mild", "severe"]]
    return recs


def suite_lenet(**kw):
    return [run_one(f"lenet_{algo}", model_name="lenet", algo=algo, p=0.05,
                    **kw) for algo in ["fedavg", "feddu", "feddumap"]]


# ---------------------------------------------------------------------------
# Heterogeneity scenario matrix: client algorithm x Dirichlet skew x
# participation and dropout, on either backend
# ---------------------------------------------------------------------------

SCEN_CLIENTS = 16
SCEN_SPEC = SyntheticSpec(num_classes=10, image_shape=(8, 8, 3),
                          train_size=2600, test_size=400, noise_scale=0.45)
SCEN_POOL = 2000
SCEN_COMMON = dict(num_clients=SCEN_CLIENTS, local_epochs=1, batch_size=10,
                   lr=0.08, lr_decay=0.98, server_batch_size=16)
SCEN_MU, SCEN_FEDDYN_ALPHA = 0.01, 0.01


def scenario_cells(grid: str):
    """The grid: 3 algorithms x Dirichlet alpha x (clients_per_round,
    dropout_rate).  ``smoke`` is one scenario per algorithm for 2 rounds;
    ``full`` the recorded matrix."""
    algos = ("fedavg", "fedprox", "feddyn")
    if grid == "smoke":
        alphas, participation, rounds = (0.5,), ((4, 0.25),), 2
    elif grid == "full":
        alphas = (0.1, 0.5, 100.0)
        participation = ((8, 0.0), (4, 0.0), (8, 0.25))
        rounds = 8
    else:
        raise ValueError(grid)
    cells = [dict(algo=a, dirichlet_alpha=al, clients_per_round=c,
                  dropout_rate=d)
             for a in algos for al in alphas for c, d in participation]
    return cells, rounds


def _scenario_config(cell: dict, seed: int) -> FLConfig:
    common = dict(SCEN_COMMON, clients_per_round=cell["clients_per_round"],
                  dropout_rate=cell["dropout_rate"], seed=seed)
    if cell["algo"] == "fedavg":
        return baselines.fedavg_config(**common)
    if cell["algo"] == "fedprox":
        return baselines.fedprox_config(
            **common, fedprox=FedProxConfig(mu=SCEN_MU))
    if cell["algo"] == "feddyn":
        return baselines.feddyn_config(
            **common, feddyn=FedDynConfig(alpha=SCEN_FEDDYN_ALPHA))
    raise ValueError(cell["algo"])


def run_scenario_cell(cell: dict, *, rounds: int, backend: str = "local",
                      base_seed: int = 0, cell_index: int = 0,
                      device="cuda") -> dict:
    _check_backend(backend)
    dev = _device.resolve(device)
    seed = cell_seed(base_seed, cell_index)
    data = build_federated_data(
        num_clients=SCEN_CLIENTS, server_fraction=0.1, device_pool=SCEN_POOL,
        spec=SCEN_SPEC, partition="dirichlet",
        dirichlet_alpha=cell["dirichlet_alpha"], seed=seed)
    p_bar = niid.global_distribution(data.client_dists, data.sizes)
    degree = float(niid.non_iid_degree(data.client_dists, p_bar).mean())
    model = SimpleCNN(num_classes=10, image_shape=SCEN_SPEC.image_shape,
                      channels=(4, 8, 8), fc_width=16, device=dev)
    cfg = _scenario_config(cell, seed)
    t0 = time.time()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    res = FederatedTrainer(model, data, cfg, device=dev,
                           backend=backend).run(
        TrainPlan.standard(rounds, eval_every=1), params=params)
    return {**cell, "backend": backend, "rounds": rounds,
            "base_seed": base_seed, "cell_index": cell_index, "seed": seed,
            "mean_niid_degree": degree,
            "final_acc": float(res.history["acc"][-1]),
            "final_loss": float(res.history["loss"][-1]),
            "history": {k: [float(v) for v in vs]
                        for k, vs in res.history.items()},
            "wall_s": time.time() - t0, "device": str(dev)}


def suite_scenario_matrix(grid: str = "smoke", backends=("local",),
                          base_seed: int = 0, out_dir: Path = OUT,
                          device="cuda"):
    for backend in backends:
        _check_backend(backend)
    cells, rounds = scenario_cells(grid)
    recs = []
    for backend in backends:
        for i, cell in enumerate(cells):
            rec = run_scenario_cell(cell, rounds=rounds, backend=backend,
                                    base_seed=base_seed, cell_index=i,
                                    device=device)
            print(f"[grid] {backend} {cell['algo']} "
                  f"alpha={cell['dirichlet_alpha']} "
                  f"C={cell['clients_per_round']} "
                  f"drop={cell['dropout_rate']} "
                  f"d={rec['mean_niid_degree']:.3f} "
                  f"acc={rec['final_acc']:.3f} ({rec['wall_s']:.0f}s)",
                  flush=True)
            recs.append(rec)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "BENCH_scenario_matrix.json"
    path.write_text(json.dumps({"grid": grid, "rounds": rounds,
                                "base_seed": base_seed, "cells": recs},
                               indent=1))
    print(f"[done] scenario matrix -> {path} ({len(recs)} cells)")
    return recs


SUITES = {"main": suite_main, "psweep": suite_p_sweep,
          "ablations": suite_ablations, "lenet": suite_lenet}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", default="all",
                    choices=[*SUITES, "all"])
    ap.add_argument("--grid", default=None, choices=["smoke", "full"],
                    help="run the heterogeneity scenario matrix instead of "
                         "the paper suites")
    ap.add_argument("--backend", default="local", choices=BACKENDS)
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    t0 = time.time()
    kw = dict(device=args.device, out_dir=Path(args.out))
    if args.grid:
        suite_scenario_matrix(args.grid, (args.backend,), args.base_seed,
                              **kw)
    else:
        for name, suite in SUITES.items():
            if args.suite in (name, "all"):
                suite(**kw)
    print(f"total {time.time() - t0:.0f}s")


if __name__ == "__main__":
    main()
