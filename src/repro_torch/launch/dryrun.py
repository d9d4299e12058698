"""Dry run: the work of every (arch x input shape) step, counted on the meta
device — the port's counterpart of the reference's ``launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
        --shape train_4k,decode_32k [--mesh pod|multipod|both] \\
        [--out build/dryrun]

The reference lowers and compiles each step for its 16 x 16 (or 2 x 16 x
16) production mesh and reads the partitioned program's cost.  The port
runs eagerly, so it builds the same step (``launch.steps``:
``make_fl_train_step`` over ``fl_batch_specs``, ``make_prefill_step``,
``make_decode_step`` over ``init_cache`` and ``input_specs``) on a model on
the meta device (``LM.on_meta``: shapes and dtypes, no storage, so any
arch at full size) and runs it once under ``launch.cost.CostCounter``.  A
record holds the fields of the reference's that mean something here:

  flops, bytes         the whole step's (every client of the round, as one
                       process runs it; the kernels by their ``work``);
  collective_*         the collectives the step itself ran: none, as one
                       process runs the step (``MeshBackend``'s round
                       reductions are ``analysis.op_lint``'s to count);
  kernel_work          each hand-written kernel's calls, FLOPs and bytes;
  model_flops, useful_flops_ratio   6 N D (2 N D serving) over ``flops``;
  roofline             the step spread over the mesh's cards at the H100's
                       rates (``launch.roofline``), the parameters' dtype;
  per_device_bytes     the params (the round state when training) and the
                       decode cache on one device of each production mesh
                       (16 x 16 and 2 x 16 x 16), under ``sharding.specs``
                       placements; ``axis_sizes`` reads the mesh's shape,
                       so no 256-rank world is needed.

A step that cannot run on the meta device writes ``ok: false`` with its
error.  Records go to ``build/dryrun/`` (git-ignored) by default.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.launch import roofline
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.steps import (FLRunConfig, fl_batch_specs,
                                      make_fl_train_step)
from repro_torch.models.api import build_model, decode_cache_len, input_specs
from repro_torch.sharding import fl_specs, specs
from repro_torch.utils.tree import tree_leaves

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


class ShapeMesh:
    """A production mesh's shape alone: what the placement rules read."""

    def __init__(self, shape: dict):
        self.shape = shape


def sharded_bytes(tensors, spec_tree, plan) -> float:
    """Bytes of one device's shards of ``tensors`` under ``spec_tree``."""
    total = 0.0
    for t, spec in zip(tree_leaves(tensors), tree_leaves(spec_tree)):
        ways = 1
        for part in spec.parts:
            if part is not None:
                ways *= plan.axis_size(part if isinstance(part, tuple)
                                       else (part,))
        total += t.numel() * t.element_size() / ways
    return total


def _meta_model(cfg):
    return build_model(cfg, device="cpu").on_meta()


def dryrun_pair(arch: str, shape_name: str, *, mesh: str = "16x16",
                cfg=None) -> dict:
    """Count one (arch, shape) step on the meta device; the record.
    ``cfg`` replaces the arch's registered config (a reduced one, say)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = INPUT_SHAPES[shape_name]
    plan = specs.make_plan(ShapeMesh(MESHES[mesh]), cfg)
    chips = math.prod(MESHES[mesh].values())
    model = _meta_model(cfg)
    params = cache = state = None
    t0 = time.perf_counter()
    if shape.kind == "train":
        run = FLRunConfig(local_steps=1, server_tau=1)
        clients = max(plan.num_clients, 1)
        init_state, train_step = make_fl_train_step(cfg, run, clients,
                                                    model=model)
        state = init_state(torch.Generator())
        params = state["params"]
        batch = fl_batch_specs(cfg, shape, clients, run, abstract=True)
        with CostCounter() as counter:     # the step program's body
            train_step.body(state, batch)
    else:
        params = model.param_shapes()
        batch = input_specs(cfg, shape, abstract=True)
        with torch.no_grad():
            if shape.kind == "prefill":
                with CostCounter() as counter:
                    model.apply(params, batch)[:, -1, :]
            else:
                window = (cfg.sliding_window if shape.name == "long_500k"
                          else None)
                cache = model.init_cache(shape.global_batch,
                                         decode_cache_len(cfg, shape),
                                         window=window)
                with CostCounter() as counter:
                    model.decode_step(params, cache, batch)
    count_s = time.perf_counter() - t0
    per_device = {}
    for name, shape_of in MESHES.items():
        p = specs.make_plan(ShapeMesh(shape_of), cfg)
        per_device[name] = {"params": sharded_bytes(
            params, specs.param_specs(params, model.axes(), p), p)}
        if state is not None:
            per_device[name]["state"] = sharded_bytes(
                state, fl_specs.fl_state_specs(state, model.axes(), p), p)
        if cache is not None:
            per_device[name]["cache"] = sharded_bytes(
                cache, specs.cache_specs(cache, p, cfg), p)
    tot = counter.totals
    mflops = roofline.model_flops(cfg, shape,
                                  training=shape.kind == "train")
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh, "chips": chips,
        "num_clients": plan.num_clients, "fl_client_axis": cfg.fl_client_axis,
        "count_s": round(count_s, 1),
        **tot.as_dict(),
        "collective_wire_bytes": tot.wire_bytes(chips),
        "roofline": roofline.roofline_terms(
            flops=tot.flops, bytes_accessed=tot.bytes,
            wire_bytes=tot.wire_bytes(chips), chips=chips,
            dtype=cfg.param_dtype),
        "model_flops": mflops,
        "useful_flops_ratio": mflops / tot.flops if tot.flops else None,
        "per_device_bytes": per_device,
        "ok": True,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="pod", help="pod | multipod | both")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    archs = list(ARCH_NAMES) if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = {"pod": ["16x16"], "multipod": ["2x16x16"],
              "both": ["16x16", "2x16x16"]}[args.mesh]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failed = 0
    for arch in archs:
        for shape in shapes:
            for mesh in meshes:
                tag = f"{arch}__{shape}__{mesh}"
                try:
                    rec = dryrun_pair(arch, shape, mesh=mesh)
                    print(f"[ ok ] {tag}: {rec['count_s']} s, flops "
                          f"{rec['flops']:.3e}, bytes {rec['bytes']:.3e}, "
                          f"bottleneck {rec['roofline']['bottleneck']}",
                          flush=True)
                except Exception as e:  # noqa: BLE001 — record and go on
                    failed += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh,
                           "ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL] {tag}: {rec['error']}", flush=True)
                (out / f"{tag}.json").write_text(json.dumps(rec, indent=2))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
