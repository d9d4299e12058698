"""The federated dataset container and its builders (paper Section 4.1
protocol): the synthetic CIFAR substitute for the paper's CNNs and a
next-token corpus for the LMs.

Counterpart of the reference's ``data/pipeline.py``: the arrays are built
in numpy exactly as the reference builds them (images stay NHWC), and
:meth:`FederatedData.device_arrays` moves them to one device for the round
engine, or places a rank's part of them for the mesh backend.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core import niid
from repro_torch.data import partition as part
from repro_torch.data.synthetic import (
    SyntheticSpec,
    TokenSpec,
    synthetic_classification,
    synthetic_tokens,
)
from repro_torch.utils.arrays import pad_rows_with_first


@dataclasses.dataclass
class FederatedData:
    client_x: np.ndarray      # [N, n_k, ...]  (equal n_k: label-shard protocol)
    client_y: np.ndarray      # [N, n_k, ...]
    sizes: np.ndarray         # [N] float n_k
    client_dists: np.ndarray  # [N, num_classes] P_k
    server_x: np.ndarray      # [n0, ...]
    server_y: np.ndarray      # [n0, ...]
    server_dist: np.ndarray   # [num_classes] P_0
    test_x: np.ndarray
    test_y: np.ndarray

    def device_arrays(self, device="cuda", *, mesh=None,
                      client_axes: tuple = ("data",),
                      shard_test: bool = True) -> dict:
        """The dataset as one dict of tensors on ``device`` (default CUDA,
        which raises when it is missing): the per-client arrays, the server
        pool, the test split, and the derived ``p_bar`` (P_bar over all
        clients) and ``d_server`` (D(P_0)).  Token and label arrays are
        int32.

        With ``mesh`` (a ``DeviceMesh`` over the process group) the dict is
        this rank's part of the mesh backend's placement, as the reference
        places it: ``client_x``, ``client_y``, ``sizes`` and
        ``client_dists`` hold only this rank's block of clients
        (``sharding.fl_specs.client_rows``) where the client count divides
        the ranks of ``client_axes``, and every client otherwise.  With
        ``shard_test`` the test split is padded with copies of row 0 to a
        multiple of those ranks and the rank keeps its block; ``test_x0``
        and ``test_y0`` (row 0, on every rank) are what the sharded eval
        subtracts back out.  ``p_bar`` and ``d_server`` come from the whole
        host arrays before the split; the server pool stays whole."""
        dev = _device.resolve(device)
        dists = torch.as_tensor(self.client_dists, dtype=torch.float32)
        sizes = torch.as_tensor(self.sizes, dtype=torch.float32)
        p_bar = niid.global_distribution(dists, sizes)
        d_server = niid.non_iid_degree(
            torch.as_tensor(self.server_dist, dtype=torch.float32), p_bar)
        rows = test_rows = None
        test_x, test_y = self.test_x, self.test_y
        if mesh is not None:
            from repro_torch.sharding import fl_specs

            plan = fl_specs.client_plan(mesh, client_axes)
            rows = fl_specs.client_rows(plan, client_axes,
                                        self.client_x.shape[0])
            if shard_test:
                ranks = plan.axis_size(client_axes)
                n = test_x.shape[0]
                test_x = pad_rows_with_first(test_x, n + (-n % ranks))
                test_y = pad_rows_with_first(test_y, n + (-n % ranks))
                test_rows = fl_specs.client_rows(plan, client_axes,
                                                 test_x.shape[0])

        def arr(a, dtype=None, block=None):
            a = np.asarray(a)
            if block is not None:
                a = a[block.start:block.stop]
            t = torch.as_tensor(np.ascontiguousarray(a))
            return t.to(device=dev, dtype=dtype or t.dtype)

        out = {
            "client_x": arr(self.client_x, block=rows),
            "client_y": arr(self.client_y, torch.int32, block=rows),
            "sizes": arr(sizes, block=rows),
            "client_dists": arr(dists, block=rows),
            "p_bar": p_bar.to(dev),
            "d_server": d_server.to(dev),
            "server_x": arr(self.server_x),
            "server_y": arr(self.server_y, torch.int32),
            "test_x": arr(test_x, block=test_rows),
            "test_y": arr(test_y, torch.int32, block=test_rows),
        }
        if mesh is not None and shard_test:
            out["test_x0"] = arr(self.test_x[:1])
            out["test_y0"] = arr(self.test_y[:1], torch.int32)
        return out


def _dists(ys: np.ndarray, num_classes: int) -> np.ndarray:
    d = np.stack([np.bincount(y, minlength=num_classes)
                  for y in ys]).astype(np.float32)
    return d / np.clip(d.sum(1, keepdims=True), 1, None)


def build_federated_data(
    *,
    num_clients: int = 100,
    server_fraction: float = 0.05,     # p
    server_niid: str = "iid",          # 'iid' | 'mild' | 'severe' (Fig. 6)
    device_pool: int = 40000,
    spec: SyntheticSpec | None = None,
    partition: str = "label_shard",    # or 'dirichlet'
    dirichlet_alpha: float = 0.5,
    seed: int = 0,
) -> FederatedData:
    """The paper's CIFAR-10 protocol on the synthetic image task:

    * the first ``device_pool`` training images are device data, partitioned
      over ``num_clients`` by label shards (2 each) or Dirichlet(alpha)
      proportions (cut to the smallest client's count: equal n_k);
    * the server draws ``server_fraction * device_pool`` images from the
      remaining training images with a controllable non-IID degree;
    * the held-out test split scores the global model.
    """
    spec = spec or SyntheticSpec()
    train_x, train_y, test_x, test_y = synthetic_classification(spec)
    device_pool = min(device_pool, len(train_x) - 1000)
    dev_x, dev_y = train_x[:device_pool], train_y[:device_pool]
    rest = np.arange(device_pool, len(train_x))

    if partition == "label_shard":
        idxs = part.label_shard_partition(dev_y, num_clients, seed=seed)
    elif partition == "dirichlet":
        idxs = part.dirichlet_partition(dev_y, num_clients,
                                        alpha=dirichlet_alpha, seed=seed)
        m = min(len(ix) for ix in idxs)
        idxs = [ix[:m] for ix in idxs]
    else:
        raise ValueError(partition)

    client_x = np.stack([dev_x[ix] for ix in idxs])
    client_y = np.stack([dev_y[ix] for ix in idxs])

    n0 = max(1, int(server_fraction * device_pool))
    n0 = min(n0, len(rest))
    server_idx = part.server_subset(train_y, rest, n0,
                                    niid_target=server_niid, seed=seed + 7)
    server_y = train_y[server_idx]
    server_dist = np.bincount(server_y, minlength=spec.num_classes
                              ).astype(np.float32)
    server_dist /= server_dist.sum()

    return FederatedData(
        client_x=client_x,
        client_y=client_y,
        sizes=np.full(num_clients, client_x.shape[1], np.float32),
        client_dists=_dists(client_y, spec.num_classes),
        server_x=train_x[server_idx],
        server_y=server_y,
        server_dist=server_dist,
        test_x=test_x,
        test_y=test_y,
    )


def build_lm_federated_data(
    *,
    num_clients: int = 8,
    server_fraction: float = 0.05,     # p
    server_niid: str = "iid",
    test_fraction: float = 0.1,
    spec: TokenSpec | None = None,
    seed: int = 0,
) -> FederatedData:
    """The paper's Section-4.1 federated protocol on a next-token corpus,
    each sequence's topic playing the role of its label:

    * sequences are label-shard partitioned over ``num_clients`` by topic
      (2 topic shards each, equal n_k);
    * the server draws ``server_fraction`` of the device pool from the
      remaining sequences with a controllable topic non-IID degree;
    * ``client_x``/``client_y`` are the [n_k, S-1] int32 next-token pairs
      ``(tokens[:-1], tokens[1:])``.
    """
    spec = spec or TokenSpec()
    toks, topics = synthetic_tokens(spec)
    x, y = np.asarray(toks[:, :-1]), np.asarray(toks[:, 1:])

    n = toks.shape[0]
    n_test = max(1, int(test_fraction * n))
    train_n = n - n_test
    device_pool = max(num_clients, int(0.8 * train_n))
    device_pool = min(device_pool, train_n - 1)
    rest = np.arange(device_pool, train_n)

    idxs = part.label_shard_partition(topics[:device_pool], num_clients,
                                      seed=seed)
    client_ix = np.stack([ix for ix in idxs])

    n0 = max(1, int(server_fraction * device_pool))
    n0 = min(n0, len(rest))
    server_idx = part.server_subset(topics, rest, n0,
                                    niid_target=server_niid, seed=seed + 7)
    server_dist = np.bincount(topics[server_idx],
                              minlength=spec.num_topics).astype(np.float32)
    server_dist /= server_dist.sum()

    return FederatedData(
        client_x=x[client_ix],
        client_y=y[client_ix],
        sizes=np.full(num_clients, client_ix.shape[1], np.float32),
        client_dists=_dists(topics[client_ix], spec.num_topics),
        server_x=x[server_idx],
        server_y=y[server_idx],
        server_dist=server_dist,
        test_x=x[train_n:],
        test_y=y[train_n:],
    )
