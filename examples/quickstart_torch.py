"""Quickstart on the PyTorch port: FedDUMAP on the paper's CNN.

The port's counterpart of ``examples/quickstart.py``: a small federated
world (20 non-IID clients + shared server data), the paper's CNN trained
with the full method (FedDU dynamic server update + FedDUM two-sided
momentum + FedAP adaptive pruning at round 6) under a TrainPlan, then the
accuracy trajectory and the dynamic tau_eff schedule.

Pruning uses the fixed-shape MASK mode: the FedAP keep-masks are written
into the live round state at the Prune event.  Pass ``--mode shrink`` to
re-materialize a smaller model instead.

  PYTHONPATH=src python examples/quickstart_torch.py               # GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.core.plan import fedap_plan
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_federated_data
from repro_torch.data.synthetic import SyntheticSpec
from repro_torch.models.cnn import SimpleCNN
from repro_torch.utils.tree import tree_leaves, tree_size


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mode", default="mask", choices=("mask", "shrink"))
    args = ap.parse_args()

    spec = SyntheticSpec(num_classes=10, image_shape=(10, 10, 3),
                         train_size=5200, test_size=800, noise_scale=0.5)
    data = build_federated_data(num_clients=20, server_fraction=0.08,
                                device_pool=4000, spec=spec)
    model = SimpleCNN(num_classes=10, image_shape=(10, 10, 3),
                      device=args.device)

    # min_rate: a compression-budget floor; the pure eigen-gap rule can
    # decide "prune nothing" on this easy synthetic task
    fedap = FedAPConfig(prune_round=6, probe_size=16, participants=4,
                        min_rate=0.3)
    cfg = feddumap_config(num_clients=20, clients_per_round=5, local_epochs=2,
                          batch_size=10, lr=0.08, fedap=fedap)
    trainer = FederatedTrainer(model, data, cfg, device=args.device)

    plan = fedap_plan(10, prune_round=fedap.prune_round, mode=args.mode)
    res = trainer.run(plan)

    print("\nround  acc     tau_eff")
    for r, a, t in zip(res.history["round"], res.history["acc"],
                       res.history["tau_eff"]):
        print(f"{r:>5}  {a:.3f}  {t:8.3f}")

    prune = res.artifacts["prune"]
    print(f"\nFedAP: global rate p*={prune['p_star']:.3f}, kept filters "
          f"{prune['kept_counts']}")
    if args.mode == "mask":
        live = sum(int(m.sum()) for m in tree_leaves(res.state["masks"]))
        print(f"masked params {live:,} live of {tree_size(res.params):,} "
              f"(fixed shapes: the masks live in the round state)")
    else:
        before = prune["params_before"]
        print(f"params {tree_size(before):,} -> {tree_size(res.params):,}; "
              f"MFLOPs/example {model.flops_per_example(before) / 1e6:.3f}"
              f" -> {model.flops_per_example(res.params) / 1e6:.3f}")


if __name__ == "__main__":
    main()
