"""Is the paper's SimpleCNN round deterministic on the card, and what does
deterministic cuDNN cost it?

    python3 tools/cudnn_determinism.py        # on a machine with a GPU

On the paper protocol's FedDUMAP SimpleCNN world (``repro_torch.
experiments``), with ``torch.backends.cudnn.deterministic`` off and then
on: three gradients of one local step compared bitwise (and their largest
difference), and the names of the CUDA kernels of one step under the
profiler (cuDNN's data- and weight-gradient kernels among them).  Then one
round from one state, three times a setting, taken in turns (off, on, on,
off, off, on), each between two device syncs.  Last, ``chip_smoke.py``'s
SimpleCNN kill and resume (two uninterrupted runs that must be bitwise
equal, then killed after chunk 2 and resumed) through the executor, which
holds cuDNN deterministic for the plan.
"""
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch import experiments
    from repro_torch.core.pruning import FedAPConfig
    from repro_torch.core.rounds import FederatedTrainer, feddumap_config
    from repro_torch.data.pipeline import build_federated_data
    from repro_torch.utils.tree import tree_leaves, tree_map

    if not torch.cuda.is_available():
        print("cudnn_determinism: CUDA is not available", file=sys.stderr)
        return 2
    cs.phase_device(torch)
    print("cudnn", torch.backends.cudnn.version(), flush=True)
    data = build_federated_data(
        num_clients=experiments.NUM_CLIENTS, server_fraction=0.05,
        device_pool=experiments.DEVICE_POOL, spec=experiments.SPEC, seed=0)
    cfg = feddumap_config(**experiments.COMMON, seed=0,
                          fedap=FedAPConfig(probe_size=32, participants=6,
                                            min_rate=0.3))
    tr = FederatedTrainer(experiments.make_model("cnn", "cuda"), data, cfg,
                          device="cuda")
    be = tr.backend()
    params = tr.model.init(torch.Generator(device="cuda").manual_seed(0))
    b = be.round_batch(0)
    x, y = b["client"][0][0, 0], b["client"][1][0, 0]
    cudnn = torch.backends.cudnn
    for det in (False, True):
        cudnn.deterministic = det
        grads = [be.grad_fn(params, (x, y)) for _ in range(3)]
        pairs = [(a, g2) for g in grads[1:]
                 for a, g2 in zip(tree_leaves(grads[0]), tree_leaves(g))]
        same = all(torch.equal(a, g2) for a, g2 in pairs)
        worst = max(float((a - g2).abs().max()) for a, g2 in pairs)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            be.grad_fn(params, (x, y))
            torch.cuda.synchronize()
        names = sorted({e.key[:100] for e in prof.key_averages()
                        if e.device_type.name == "CUDA"})
        print(f"deterministic={det}: three gradients of one step equal: "
              f"{same} (max diff {worst:.3e}); kernels:", flush=True)
        for n in names:
            print("   ", n, flush=True)
    state0 = be.init_state(params)
    times = {False: [], True: []}
    for det in (False, True, True, False, False, True):
        cudnn.deterministic = det
        st = tree_map(torch.clone, state0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.run_rounds(st, 0, 1)
        torch.cuda.synchronize()
        times[det].append(time.perf_counter() - t0)
    cudnn.deterministic = False
    print("s/round deterministic off", times[False], "on", times[True],
          flush=True)
    out = os.path.join(ROOT, "build", "cudnn_determinism")
    try:
        cs._resume_cnn(torch, out)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
