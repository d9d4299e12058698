"""Device meshes over ``torch.distributed``.

Counterpart of the reference's ``launch/mesh.py``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, with named dims ``("data", "model")`` (the host mesh) or the
reference's production shapes, 16 x 16 and 2 x 16 x 16 with a ``"pod"``
dim.

With no process group yet, :func:`make_host_mesh` starts a world of one
over an in-process ``HashStore``: NCCL for a CUDA device, gloo for the
CPU; it needs no network and no environment variables.  More ranks come
from the caller's own ``init_process_group`` (``torchrun``, or a
``FileStore`` in tests) before the call.  On a machine with N cards,
``torchrun --nproc-per-node N`` starts N ranks, each taking
``LOCAL_RANK``'s card, and ``make_host_mesh(data=, model=)`` lays them out
(the tensor-parallel steps over ``model``; not run here: one card, and
NCCL refuses two ranks on one device).  A CUDA device over a group without
NCCL, or a CPU device over one without gloo, raises; so does a failed NCCL
start.  Nothing falls back.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import device as _device

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _process_group(dev: torch.device) -> None:
    """The default process group, started as a world of one if there is
    none; raises unless its backend serves ``dev``."""
    want = _BACKENDS[dev.type]
    if not dist.is_initialized():
        kw = {}
        if dev.type == "cuda":
            # eager: a failed NCCL start raises here, not at the first sum
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
        dist.init_process_group(want, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    have = str(dist.get_backend())
    if want not in have:
        raise RuntimeError(
            f"a {dev.type} mesh needs a {want} process group, but the "
            f"default group runs {have!r}")


def make_host_mesh(*, data: int | None = None, model: int = 1,
                   device="cuda") -> DeviceMesh:
    """A ``("data", "model")`` mesh over every rank of the process group
    (a world of one when there is none): ``data`` defaults to
    ``world // model``.  The default substrate of the mesh backend, whose FL
    clients live on ``"data"``."""
    dev = _device.resolve(device)
    _process_group(dev)
    world = dist.get_world_size()
    data = data or world // model
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(dev.type, (data, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False,
                         device="cuda") -> DeviceMesh:
    """The reference's production mesh: 16 x 16 ``("data", "model")``, or 2
    x 16 x 16 ``("pod", "data", "model")``.  Raises unless the process
    group already has exactly that many ranks."""
    dev = _device.resolve(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"the production mesh {shape} needs {need} ranks; "
                         f"the process group has {world}")
    _process_group(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def axis_group(mesh, name: str):
    """The process group of the ranks that share every coordinate of
    ``mesh`` but ``name``'s: this rank's group along that dim
    (``DeviceMesh.get_group``)."""
    return mesh.get_group(name)


def reduce_scatter(out: torch.Tensor, flat: torch.Tensor,
                   group=None) -> None:
    """``out`` = this rank's block of ``flat`` summed over the ranks
    (``reduce_scatter_single``, ``reduce_scatter_tensor`` before torch
    2.13)."""
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, flat, group=group)


def all_gather(out: torch.Tensor, part: torch.Tensor, group=None) -> None:
    """``out`` = every rank's ``part`` in rank order (``all_gather_single``,
    ``all_gather_into_tensor`` before torch 2.13)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, part, group=group)
