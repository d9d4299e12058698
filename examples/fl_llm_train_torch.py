"""Federated LM fine-tuning on the PyTorch port: TrainPlan in, RunResult out.

The port's counterpart of ``examples/fl_llm_train.py``.  The transformer LM
runs the same TrainPlan/PlanExecutor stack as the CNN repro:

  * :func:`repro_torch.data.pipeline.build_lm_federated_data` transplants
    the paper's Section-4.1 protocol to a next-token corpus (sequences
    label-shard partitioned by topic over the clients, an IID-controllable
    server pool, a held-out test split);
  * :class:`repro_torch.models.lm.LM` plugs into the executor through the
    simulation-model contract (``loss_and_acc(params, x, y, masks=)``), so
    ``FederatedTrainer`` drives it over the local backend on one device,
    or with ``--backend mesh`` over ``MeshBackend``, the round's clients
    split over the ranks of ``torch.distributed`` (a world of one unless
    launched by ``torchrun``);
  * ``--prune-round K`` schedules FedAP as a ``Prune`` event
    (:func:`repro_torch.core.plan.fedap_plan`): the layer-adaptive decision
    (Fisher eigen-gap rates -> Formula 15 -> a uniform 128-lane-aligned
    FFN-unit selection, ``core.pruning_lm``) is written into the round
    state as keep-masks (the state keeps its tensors and shapes), or
    re-materialises the smaller stack with ``--prune-mode shrink``;
  * ``--masked-compute kernel`` also sends the masked FFN products through
    the differentiable ``MaskedMatmul`` (the ``masked_matmul`` kernels on
    the card, skipping pruned 128-column blocks; their plain versions on
    the CPU).

Examples::

  PYTHONPATH=src python examples/fl_llm_train_torch.py --rounds 20 --scale tiny
  PYTHONPATH=src python examples/fl_llm_train_torch.py --rounds 10 \\
      --prune-round 5 --prune-mode mask --masked-compute kernel
  PYTHONPATH=src python examples/fl_llm_train_torch.py --rounds 2 \\
      --prune-round 1 --clients 4 --device cpu

  torchrun --nproc-per-node 4 examples/fl_llm_train_torch.py \
      --backend mesh --clients-per-round 4

--scale 25m/100m train larger models.  ``--device`` defaults to ``cuda``.
Under ``torchrun`` each rank takes the card of its ``LOCAL_RANK`` and
joins the group from the launcher's environment; rank 0 prints.
"""
import argparse
import os

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import TrainPlan, fedap_plan
from repro_torch.core.pruning import FedAPConfig
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_lm_federated_data
from repro_torch.data.synthetic import TokenSpec
from repro_torch.models.lm import LM

SCALES = {
    "tiny": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                 d_ff=512, vocab_size=2048),
    "25m": dict(num_layers=6, d_model=512, num_heads=8, num_kv_heads=4,
                d_ff=2048, vocab_size=8192),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
                 d_ff=3072, vocab_size=32768),
}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--scale", default="tiny", choices=list(SCALES))
    ap.add_argument("--backend", default="local", choices=("local", "mesh"))
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--clients-per-round", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--sequences", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4, help="per-client batch")
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--prune-round", type=int, default=0,
                    help="0 = no FedAP event")
    ap.add_argument("--prune-mode", default="mask",
                    choices=("mask", "shrink"))
    ap.add_argument("--masked-compute", default="params",
                    choices=("params", "kernel"))
    ap.add_argument("--prune-floor", type=float, default=0.5,
                    help="FedAPConfig.min_rate compression-budget floor")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rank = 0
    if args.backend == "mesh" and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # launched by torchrun: one rank per card, env:// rendezvous
        cuda = torch.device(args.device).type == "cuda"
        if cuda:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl" if cuda else "gloo")
        rank = dist.get_rank()

    mcfg = ModelConfig(name=f"dense-{args.scale}", family="dense",
                       rope="1d", norm="rmsnorm", act="silu",
                       param_dtype="float32", remat="none",
                       **SCALES[args.scale])
    model = LM(mcfg, device=args.device)
    data = build_lm_federated_data(
        num_clients=args.clients,
        spec=TokenSpec(vocab_size=mcfg.vocab_size,
                       num_topics=2 * args.clients,
                       seq_len=args.seq + 1,
                       num_sequences=args.sequences))

    cfg = feddumap_config(
        num_clients=args.clients,
        clients_per_round=args.clients_per_round,
        local_epochs=args.local_epochs,
        batch_size=args.batch,
        server_batch_size=2 * args.batch,
        lr=3e-3, lr_decay=1.0,
        masked_compute=args.masked_compute,
        # the FFN stack prunes at the 128-lane boundary (core.pruning_lm's
        # uniform kept count); the floor guarantees a visible compression
        fedap=FedAPConfig(align=128, min_rate=args.prune_floor,
                          probe_size=8,
                          participants=min(4, args.clients)))
    trainer = FederatedTrainer(model, data, cfg, device=args.device,
                               backend=args.backend)

    if args.prune_round:
        plan = fedap_plan(args.rounds, prune_round=args.prune_round,
                          mode=args.prune_mode, eval_every=args.eval_every)
    else:
        plan = TrainPlan.standard(args.rounds, eval_every=args.eval_every)

    res = trainer.run(plan)
    if rank:
        return
    for r, loss, acc, tau, dt in zip(res.history["round"],
                                     res.history["loss"],
                                     res.history["acc"],
                                     res.history["tau_eff"],
                                     res.history["time"]):
        print(f"round {r:>3}  loss {loss:.4f}  token-acc {acc:.4f}  "
              f"tau_eff {tau:.3f}  ({dt:.0f}s)", flush=True)
    if args.prune_round:
        art = res.artifacts["prune"]
        print(f"FedAP: p*={art['p_star']:.3f}  "
              f"kept={art['kept_counts']}  mode={art['mode']}")


if __name__ == "__main__":
    main()
