"""The port's synthetic image world against the JAX package's: array-equal.

``synthetic_classification``, ``dirichlet_partition`` and
``build_federated_data`` are numpy in both packages, so equal arguments
must give equal arrays, bit for bit: label shards and Dirichlet
partitions, server data of every non-IID degree.  The world is the
quickstart's (20 clients, 10x10x3 images), cut to 3,000 training images;
one case builds the paper's default (16x16x3, 50,000 images, 100 clients).
"""
import dataclasses

import numpy as np
import pytest

from repro.data import partition as jax_partition
from repro.data.pipeline import build_federated_data as jax_build
from repro.data.synthetic import SyntheticSpec as JaxSpec
from repro.data.synthetic import synthetic_classification as jax_synth
from repro_torch.data import partition
from repro_torch.data.pipeline import FederatedData, build_federated_data
from repro_torch.data.synthetic import SyntheticSpec, synthetic_classification
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(num_classes=10, image_shape=(10, 10, 3), train_size=3000,
             test_size=400, noise_scale=0.5)


def _assert_equal_data(got: FederatedData, want) -> None:
    for f in dataclasses.fields(FederatedData):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.parametrize("spec", [SMALL, dict(SMALL, image_shape=(8, 8, 1),
                                               feature_rank=4, seed=3)])
def test_synthetic_classification_is_array_equal(spec):
    got = synthetic_classification(SyntheticSpec(**spec))
    want = jax_synth(JaxSpec(**spec))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (3000, *spec["image_shape"])


def test_default_spec_matches():
    assert dataclasses.asdict(SyntheticSpec()) == dataclasses.asdict(
        JaxSpec())


@pytest.mark.parametrize("alpha,seed", [(0.5, 0), (0.1, 4), (5.0, 1)])
def test_dirichlet_partition_is_array_equal(alpha, seed):
    labels = np.random.default_rng(seed).integers(0, 10, 2000)
    got = partition.dirichlet_partition(labels, 12, alpha=alpha, seed=seed)
    want = jax_partition.dirichlet_partition(labels, 12, alpha=alpha,
                                             seed=seed)
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert min(len(ix) for ix in got) >= 8


@pytest.mark.parametrize("partition_kind", ["label_shard", "dirichlet"])
@pytest.mark.parametrize("server_niid", ["iid", "mild", "severe"])
def test_build_federated_data_is_array_equal(partition_kind, server_niid):
    kw = dict(num_clients=20, server_fraction=0.08, device_pool=2000,
              server_niid=server_niid, partition=partition_kind, seed=2)
    got = build_federated_data(spec=SyntheticSpec(**SMALL), **kw)
    want = jax_build(spec=JaxSpec(**SMALL), **kw)
    _assert_equal_data(got, want)
    assert got.client_x.shape[:2] == got.client_y.shape
    assert got.server_x.shape[0] == 160


def test_paper_default_world_is_array_equal():
    """The paper protocol at its defaults: 100 clients of 400 images
    (16x16x3), 2,000 server images (p = 0.05), 10,000 test images."""
    got, want = build_federated_data(), jax_build()
    _assert_equal_data(got, want)
    assert got.client_x.shape == (100, 400, 16, 16, 3)
    assert got.server_x.shape == (2000, 16, 16, 3)
    assert got.test_x.shape == (10000, 16, 16, 3)


def test_unknown_partition_raises():
    with pytest.raises(ValueError):
        build_federated_data(spec=SyntheticSpec(**SMALL), device_pool=2000,
                             num_clients=20, partition="iid")


def test_device_arrays_hold_images_as_nhwc_float32():
    data = build_federated_data(spec=SyntheticSpec(**SMALL), num_clients=20,
                                device_pool=2000)
    d = data.device_arrays("cpu")
    assert tuple(d["client_x"].shape) == data.client_x.shape
    assert d["client_x"].dtype.is_floating_point
    assert str(d["client_y"].dtype) == "torch.int32"
    np.testing.assert_array_equal(d["server_x"].numpy(), data.server_x)
