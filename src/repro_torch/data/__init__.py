"""Federated datasets: the synthetic image task and token corpora, non-IID
partitioners and the device-resident container the round engine samples
from."""
