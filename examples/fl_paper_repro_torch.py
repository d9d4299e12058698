"""Scenario: the paper's CIFAR-10 protocol end to end on the PyTorch port.

The port's counterpart of ``examples/fl_paper_repro.py``: a thin CLI over
``repro_torch.experiments.run_one``, one cell of the paper's Tables 10/12
on the synthetic CIFAR substitute (100 clients, 10 a round, E=5, B=10,
p=5% server data, prune at round 30), or a whole suite, or the
heterogeneity scenario grid.

  PYTHONPATH=src python examples/fl_paper_repro_torch.py --algo feddumap --rounds 30
  PYTHONPATH=src python examples/fl_paper_repro_torch.py --suite main --device cpu
  PYTHONPATH=src python examples/fl_paper_repro_torch.py --grid smoke
"""
import argparse
from pathlib import Path

from repro_torch import experiments as PE


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--algo", default="feddumap", choices=PE.MAIN_ALGOS)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--p", type=float, default=0.05)
    ap.add_argument("--suite", default=None, choices=sorted(PE.SUITES),
                    help="run a whole suite of the paper's evaluation")
    ap.add_argument("--grid", default=None, choices=["smoke", "full"],
                    help="run the heterogeneity scenario matrix")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/fl_paper_repro_torch")
    args = ap.parse_args()
    out = Path(args.out)
    if args.grid:
        PE.suite_scenario_matrix(args.grid, out_dir=out, device=args.device)
        return
    if args.suite:
        PE.SUITES[args.suite](out_dir=out, device=args.device)
        return
    rec = PE.run_one(f"example_{args.algo}", algo=args.algo, p=args.p,
                     rounds=args.rounds,
                     prune_round=min(args.rounds // 2, 30), out_dir=out,
                     device=args.device)
    accs = rec["history"]["acc"]
    print(f"\n{args.algo}: final acc {rec['final_acc']:.3f}; trajectory "
          f"{[round(a, 3) for a in accs[:: max(1, len(accs) // 8)]]}")
    print(f"device MFLOPs {rec['mflops_before']:.2f} -> "
          f"{rec['mflops_after']:.2f}")


if __name__ == "__main__":
    main()
