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
  collective_*         the collectives of the step, under the reference's
                       names: ``collective_counts`` and
                       ``collective_bytes_by_kind`` (input bytes per kind)
                       and ``collective_wire_bytes_per_device`` (the bytes a
                       card puts on the wire, ring factors over each
                       group's size).  A dense arch that the port runs
                       tensor-parallel on the mesh (``LM.shard``: olmo-1b
                       and chatglm3-6b on both production meshes) is
                       counted as rank 0's part of the step (``counted``),
                       its collectives recorded by ``sharding.tp.
                       RecordingGroup``s of the mesh's axes; the other
                       archs count the whole step as one process runs it,
                       with no collective, and ``collectives_pending``
                       says what their collectives wait for (FSDP, or
                       their family's slice: ROADMAP queue 1);
  kernel_work          each hand-written kernel's calls, FLOPs and bytes;
  model_flops, useful_flops_ratio   6 N D (2 N D serving) over ``flops``;
  roofline             the step spread over the mesh's cards at the H100's
                       rates (``launch.roofline``), the parameters' dtype
                       (rank 0's part on one card, for a rank's count);
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
from repro_torch.core.engine import init_round_state
from repro_torch.launch.steps import (FLRunConfig, engine_config,
                                      fl_batch_specs,
                                      make_decode_step, make_fl_train_step,
                                      make_prefill_step)
from repro_torch.models.api import build_model, decode_cache_len, input_specs
from repro_torch.sharding import fl_specs, specs
from repro_torch.utils.tree import tree_leaves

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


STEP_RUN = FLRunConfig(local_steps=1, server_tau=1)   # the counted round


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


def _meta_model(cfg, mesh=None):
    return build_model(cfg, device="cpu", mesh=mesh).on_meta()


def tp_pending(cfg, plan) -> str | None:
    """None where the step runs tensor-parallel on ``plan`` (the port's
    ``LM.shard``); else what its collectives wait for."""
    if cfg.family != "dense":
        return (f"the {cfg.family} family's tensor-parallel slice (ROADMAP "
                f"queue 1)")
    if any(plan.axis_size(a) > 1 for a in (plan.fsdp_axes, plan.batch_axes)
           if a):
        return "FSDP over 'data' (ROADMAP queue 1)"
    return None


def count_step(cfg, shape, mesh_shape: dict) -> dict:
    """One step of (cfg, shape) counted on the meta device: the whole step
    as one process runs it, or, where it runs tensor-parallel on a mesh of
    ``mesh_shape``, rank 0's part of it with its collectives recorded
    (``sharding.tp.RecordingGroup``, one per mesh axis group).  Returns
    ``{"counter", "params", "state", "cache", "model", "rank"}``."""
    plan = specs.make_plan(ShapeMesh(mesh_shape), cfg)
    rank = tp_pending(cfg, plan) is None
    mesh = ShapeMesh(mesh_shape) if rank else None
    model = _meta_model(cfg, mesh)
    state = cache = None
    if shape.kind == "train":
        run = STEP_RUN
        clients = max(plan.num_clients, 1)
        init_state, train_step = make_fl_train_step(cfg, run, clients,
                                                    model=model, mesh=mesh)
        state = init_state(torch.Generator())
        params = state["params"]
        batch = train_step.local(fl_batch_specs(cfg, shape, clients, run,
                                                abstract=True))
        with CostCounter() as counter:     # the step program's body
            train_step.body(state, batch)
    else:
        params = model.param_shapes()
        batch = input_specs(cfg, shape, abstract=True)
        with torch.no_grad():
            if shape.kind == "prefill":
                _, prefill = make_prefill_step(cfg, model=model, mesh=mesh)
                with CostCounter() as counter:
                    prefill(params, batch)
            else:
                window = (cfg.sliding_window if shape.name == "long_500k"
                          else None)
                cache = model.init_cache(shape.global_batch,
                                         decode_cache_len(cfg, shape),
                                         window=window)
                _, decode = make_decode_step(cfg, model=model, mesh=mesh)
                with CostCounter() as counter:
                    decode(params, cache, batch)
    return {"counter": counter, "params": params, "state": state,
            "cache": cache, "model": model, "rank": rank}


def dryrun_pair(arch: str, shape_name, *, mesh: str = "16x16",
                cfg=None) -> dict:
    """Count one (arch, shape) step on the meta device; the record.
    ``cfg`` replaces the arch's registered config (a reduced one, say);
    ``shape_name`` may be an ``InputShape``."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    plan = specs.make_plan(ShapeMesh(MESHES[mesh]), cfg)
    chips = math.prod(MESHES[mesh].values())
    t0 = time.perf_counter()
    got = count_step(cfg, shape, MESHES[mesh])
    count_s = time.perf_counter() - t0
    counter, model = got["counter"], got["model"]
    whole = model._whole() if model.tp is not None else model
    params = whole.param_shapes()
    state = cache = None
    if got["state"] is not None:      # the round state at whole shapes
        state = init_round_state(params, engine_config(STEP_RUN),
                                 num_clients=max(plan.num_clients, 1))
    if got["cache"] is not None:
        cache = whole.on_meta().init_cache(
            shape.global_batch, decode_cache_len(cfg, shape),
            window=(cfg.sliding_window if shape.name == "long_500k"
                    else None))
    per_device = {name: per_device_bytes(cfg, whole, shape_of, params,
                                         state, cache, tp=got["rank"])
                  for name, shape_of in MESHES.items()}
    tot = counter.totals
    mflops = roofline.model_flops(cfg, shape,
                                  training=shape.kind == "train")
    if got["rank"]:
        # rank 0's part of the step: the roofline of one card, its own
        # collectives' wire bytes
        wire = tot.collective_wire
        terms = roofline.roofline_terms(
            flops=tot.flops, bytes_accessed=tot.bytes, wire_bytes=wire,
            chips=1, dtype=cfg.param_dtype)
        step_flops = tot.flops * chips
        note = None
    else:
        wire = tot.wire_bytes(chips)
        terms = roofline.roofline_terms(
            flops=tot.flops, bytes_accessed=tot.bytes, wire_bytes=wire,
            chips=chips, dtype=cfg.param_dtype)
        step_flops = tot.flops
        note = tp_pending(cfg, plan)
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh, "chips": chips,
        "num_clients": plan.num_clients, "fl_client_axis": cfg.fl_client_axis,
        "count_s": round(count_s, 1),
        "counted": "rank 0's part" if got["rank"] else "the whole step",
        **tot.as_dict(),
        "collective_bytes_by_kind": dict(tot.collective_bytes),
        "collective_wire_bytes": wire,
        "roofline": terms,
        "model_flops": mflops,
        "useful_flops_ratio": mflops / step_flops if step_flops else None,
        "per_device_bytes": per_device,
        "ok": True,
    }
    if note is not None:
        rec["collectives_pending"] = note
    return rec


def per_device_bytes(cfg, model, mesh_shape: dict, params, state=None,
                     cache=None, *, tp: bool = False) -> dict:
    """The params (and the round state, the decode cache) on one device of
    a mesh of ``mesh_shape`` under ``sharding.specs`` placements, from the
    whole model's meta shapes; ``axis_sizes`` reads the mesh's shape, so no
    world of that size is needed.  ``tp``: the state of the
    tensor-parallel step, whose filter masks follow the params."""
    p = specs.make_plan(ShapeMesh(mesh_shape), cfg)
    out = {"params": sharded_bytes(
        params, specs.param_specs(params, model.axes(), p), p)}
    if state is not None:
        out["state"] = sharded_bytes(state, fl_specs.fl_state_specs(
            state, model.axes(), p,
            filter_axes=model.filter_axes() if tp else None), p)
    if cache is not None:
        out["cache"] = sharded_bytes(cache, specs.cache_specs(cache, p, cfg),
                                     p)
    return out


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
