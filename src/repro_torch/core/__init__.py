"""Core: FedAP pruning of the LM and the checkpoint reader."""
