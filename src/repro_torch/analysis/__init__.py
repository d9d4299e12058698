"""The port's analysis tools: the contract lint (:mod:`.lint`) and the
invariants of a round's and a wave's recorded operations
(:mod:`.op_lint`); ``python -m repro_torch.analysis`` runs both."""
