"""Federated datasets: synthetic token corpora, non-IID partitioners and
the device-resident container the round engine samples from."""
