"""Core: the federated round engine, FedDU/FedDUM math, FedAP pruning,
training plans, the plan executor and trainer, and the checkpoint reader."""
