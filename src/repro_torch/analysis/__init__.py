"""The port's analysis tools: the contract lint (:mod:`.lint`), the
program budget (:mod:`.compile_budget`) and the invariants of a round's and
a wave's recorded operations (:mod:`.op_lint`); ``python -m
repro_torch.analysis`` runs all three."""
