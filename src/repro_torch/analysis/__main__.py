"""``python -m repro_torch.analysis`` — the lint, the program budget,
then the recorded-operation invariants, on the CPU; exit 0 == clean.

The counterpart of the reference's ``python -m repro.analysis``: lint ->
compile budget (:mod:`.compile_budget`, the round and serving programs
counted against ``compile_budget.json``) -> ``op_lint`` (whose mesh budget
spawns two gloo ranks).
"""
from __future__ import annotations

import argparse
import pathlib
import sys

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="contract lint + recorded-operation invariants")
    ap.add_argument("--skip-lint", action="store_true")
    ap.add_argument("--skip-budget", action="store_true")
    ap.add_argument("--skip-ops", action="store_true")
    args = ap.parse_args(argv)

    failures = 0
    if not args.skip_lint:
        from repro_torch.analysis import lint

        violations = lint.lint_paths(lint.default_roots(_REPO_ROOT))
        for v in violations:
            print(v)
        print(f"[1/3] lint: {len(violations)} violation(s)")
        failures += len(violations)
    else:
        print("[1/3] lint: skipped")

    if not (args.skip_budget and args.skip_ops):
        import torch

        torch.set_num_threads(1)

    if not args.skip_budget:
        from repro_torch.analysis import compile_budget

        errors = compile_budget.check()
        for e in errors:
            print(f"FAIL {e}")
        print(f"[2/3] compile_budget: {len(errors)} violation(s)")
        failures += len(errors)
    else:
        print("[2/3] compile_budget: skipped")

    if not args.skip_ops:
        from repro_torch.analysis import op_lint

        errors = op_lint.check()
        for e in errors:
            print(f"FAIL {e}")
        print(f"[3/3] op_lint: {len(errors)} violation(s)")
        failures += len(errors)
    else:
        print("[3/3] op_lint: skipped")

    print(f"repro_torch.analysis: {'CLEAN' if not failures else 'FAILED'} "
          f"({failures} total violation(s))")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
