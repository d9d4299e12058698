"""``python -m repro_torch.analysis`` — the lint, then the recorded-
operation invariants, on the CPU; exit 0 == clean.

The counterpart of the reference's ``python -m repro.analysis``, whose
compile-budget checker waits for a captured round or wave (a CUDA graph)
to have something to count.  ``op_lint``'s mesh budget spawns two gloo
ranks.
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
    ap.add_argument("--skip-ops", action="store_true")
    args = ap.parse_args(argv)

    failures = 0
    if not args.skip_lint:
        from repro_torch.analysis import lint

        violations = lint.lint_paths(lint.default_roots(_REPO_ROOT))
        for v in violations:
            print(v)
        print(f"[1/2] lint: {len(violations)} violation(s)")
        failures += len(violations)
    else:
        print("[1/2] lint: skipped")

    if not args.skip_ops:
        import torch

        from repro_torch.analysis import op_lint

        torch.set_num_threads(1)
        errors = op_lint.check()
        for e in errors:
            print(f"FAIL {e}")
        print(f"[2/2] op_lint: {len(errors)} violation(s)")
        failures += len(errors)
    else:
        print("[2/2] op_lint: skipped")

    print(f"repro_torch.analysis: {'CLEAN' if not failures else 'FAILED'} "
          f"({failures} total violation(s))")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
