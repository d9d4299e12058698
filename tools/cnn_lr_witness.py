"""Does VGG11 train at the paper's lr 0.1 under FedDUMAP?  One package per
process: the JAX reference (``--impl jax``) or the port (``--impl torch``).

A reduced paper world at 32x32x3: 20 clients of 400 samples each by label
shards (so each client takes the paper's 200 local steps of B = 10 over
E = 5), 2,000 server samples, a test split of 1,000.  FedDUMAP as
``chip_smoke.py``'s ``training cnn`` phase runs it (decay 0.99, restart
local momentum, server momentum, FedDU's dynamic server steps), with
``--clients`` clients a round.  Each ``--lr`` starts from the package's own
init (seed 0) and prints, per round, the test loss and accuracy, tau_eff,
whether every param is finite, and the largest |param|.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/cnn_lr_witness.py --impl jax
    PYTHONPATH=src python tools/cnn_lr_witness.py --impl torch --device cpu
"""
import argparse
import math
import time

import numpy as np

WORLD = dict(num_clients=20, server_fraction=0.25, device_pool=8000)
SPEC = dict(image_shape=(32, 32, 3), train_size=12000, test_size=1000)


def _fl(pkg_cfg, lr, clients):
    return pkg_cfg(num_clients=WORLD["num_clients"],
                   clients_per_round=clients, local_epochs=5, batch_size=10,
                   lr=lr, lr_decay=0.99)


def run_jax(lr, clients, rounds):
    import jax
    import jax.numpy as jnp

    from repro.core.rounds import FederatedTrainer, feddumap_config
    from repro.data.pipeline import build_federated_data
    from repro.data.synthetic import SyntheticSpec
    from repro.models.cnn import VGG11

    data = build_federated_data(spec=SyntheticSpec(**SPEC), **WORLD)
    model = VGG11(image_shape=SPEC["image_shape"])
    res = FederatedTrainer(model, data, _fl(feddumap_config, lr,
                                            clients)).run(rounds)
    leaves = jax.tree.leaves(res.params)
    finite = all(bool(jnp.isfinite(x).all()) for x in leaves)
    big = max(float(jnp.abs(x).max()) for x in leaves)
    return res.history, finite, big


def run_torch(lr, clients, rounds, device):
    import torch

    from repro_torch.core.rounds import FederatedTrainer, feddumap_config
    from repro_torch.data.pipeline import build_federated_data
    from repro_torch.data.synthetic import SyntheticSpec
    from repro_torch.models.cnn import VGG11
    from repro_torch.utils.tree import tree_leaves

    if device == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    data = build_federated_data(spec=SyntheticSpec(**SPEC), **WORLD)
    model = VGG11(image_shape=SPEC["image_shape"], device=device)
    res = FederatedTrainer(model, data, _fl(feddumap_config, lr, clients),
                           device=device).run(rounds)
    leaves = tree_leaves(res.params)
    finite = all(bool(torch.isfinite(x).all()) for x in leaves)
    big = max(float(x.abs().max()) for x in leaves)
    return res.history, finite, big


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=["jax", "torch"], required=True)
    ap.add_argument("--device", default="cuda", help="torch only")
    ap.add_argument("--lr", type=float, nargs="+", default=[0.1, 0.01])
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    for lr in args.lr:
        t0 = time.perf_counter()
        if args.impl == "jax":
            h, finite, big = run_jax(lr, args.clients, args.rounds)
        else:
            h, finite, big = run_torch(lr, args.clients, args.rounds,
                                       args.device)
        for r, loss, acc, tau in zip(h["round"], h["loss"], h["acc"],
                                     h["tau_eff"]):
            print(f"[witness] {args.impl} VGG11 lr {lr} round {r}: test loss "
                  f"{float(loss):.6f} acc {float(acc):.4f} tau_eff "
                  f"{float(tau):.6f}", flush=True)
        print(f"[witness] {args.impl} VGG11 lr {lr}: params finite {finite}, "
              f"max |param| {big:.4g}"
              f"{'' if math.isfinite(big) else ' (not finite)'}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    np.seterr(all="ignore")
    main()
