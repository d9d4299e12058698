"""Non-IID partitioners (the paper's Section 4.1 protocol).

The port's copy of the reference's ``data/partition.py``: the paper's
label-shard protocol, the Dirichlet(alpha) partition and the server-data
draw.  Pure numpy: equal seeds give equal partitions in both packages.
"""
from __future__ import annotations

import numpy as np


def label_shard_partition(labels: np.ndarray, num_clients: int,
                          shards_per_client: int = 2, seed: int = 0):
    """Sort by label, split into ``shards_per_client * num_clients`` equal
    shards, deal each client ``shards_per_client`` random shards.  Returns
    one index array per client (equal sizes)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    num_shards = num_clients * shards_per_client
    usable = (len(order) // num_shards) * num_shards
    shards = order[:usable].reshape(num_shards, -1)
    perm = rng.permutation(num_shards)
    return [
        np.concatenate([shards[perm[c * shards_per_client + i]]
                        for i in range(shards_per_client)])
        for c in range(num_clients)
    ]


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        alpha: float = 0.5, seed: int = 0,
                        min_size: int = 8):
    """Dirichlet(alpha) label-proportion partition (smaller alpha = more
    skew), redrawn until every client holds ``min_size`` samples.  Returns
    one sorted index array per client."""
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    while True:
        idx_per_client = [[] for _ in range(num_clients)]
        for c in range(num_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * num_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for cid, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[cid].extend(part.tolist())
        if min(len(ix) for ix in idx_per_client) >= min_size:
            return [np.asarray(sorted(ix)) for ix in idx_per_client]


def server_subset(labels: np.ndarray, pool: np.ndarray, size: int,
                  *, niid_target: str = "iid", seed: int = 0):
    """Draw the server's shared data from the ``pool`` indices.

    niid_target: 'iid' (uniform), 'mild' (half the classes over-represented
    3:1) or 'severe' (only half the classes present) — the paper's Figure 6
    / Table 5 server-data regimes.
    """
    rng = np.random.default_rng(seed)
    y = labels[pool]
    num_classes = int(labels.max()) + 1
    if niid_target == "iid":
        weights = np.ones(num_classes)
    elif niid_target == "mild":
        weights = np.where(np.arange(num_classes) < num_classes // 2, 3.0, 1.0)
    elif niid_target == "severe":
        weights = np.where(np.arange(num_classes) < num_classes // 2, 1.0, 0.0)
    else:
        raise ValueError(niid_target)
    p = weights[y].astype(np.float64)
    p /= p.sum()
    return pool[rng.choice(len(pool), size=size, replace=False, p=p)]
