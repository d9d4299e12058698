"""The port's work counter and the tools over it: ``launch.cost``,
``launch.roofline``, ``launch.dryrun`` and ``analysis.op_lint``.

* ``CostCounter``'s product FLOPs on a reduced olmo-1b forward
  (``attn_impl="xla"``, no masks) against the reference's
  ``launch.hlo_cost.analyze`` on the jitted JAX forward's optimized HLO:
  within 1% (they agree exactly: both count every ``dot``/``mm`` at 2 flops
  a multiply-add, the attention's full score and value products included,
  and neither counts the elementwise work).
* ``model_flops``/``param_count``/``active_param_count`` equal the
  reference's ``launch.hlo_analysis`` for every arch and input shape.
* One step counts the same on the CPU and on the meta device (a scoring
  forward through K4 and K1, a masked decode step through K5 and K1, a
  kernel-mode gradient through K1-K3); each kernel is counted once, by its
  ``work``, and its plain version's operations not at all.
* ``flash_attention.visible_pairs`` equals ``ref.visible``'s count.
* ``op_lint`` finds an injected f64 op, ``.item()`` and collective, and the
  canonical rounds and waves are clean.
* The dry run on the meta device: olmo-1b, arctic-480b (moe), zamba2-1.2b
  (hybrid) and whisper-small (encdec) at ``decode_32k`` and ``train_4k``,
  their configs cut to 2 layers (the full-size records are ``python -m
  repro_torch.launch.dryrun``'s, in ``PERF.md``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_NAMES as JAX_ARCHS
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import hlo_analysis, hlo_cost
from repro.models.lm import LM as JaxLM
from repro_torch.analysis import op_lint
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.core import engine
from repro_torch.kernels import decode_attention as k5
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import masked_matmul as k1
from repro_torch.kernels import ops, ref
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.cost import CostCounter
from repro_torch.models.lm import LM
from repro_torch.utils.tree import tree_map
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

OLMO = get_config("olmo-1b").reduced(vocab_size=256, d_ff=512)
B, S = 2, 64


def _to_meta(tree):
    return tree_map(lambda t: t.to("meta"), tree)


@pytest.fixture(scope="module")
def olmo():
    model = LM(OLMO, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    masks = model.filter_masks(params, model.decide_kept(params, 0.5))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, OLMO.vocab_size, (B, S + 1)).astype(np.int64))
    return model, params, masks, tokens


def test_product_flops_equal_the_reference_hlo_count(olmo):
    model, params, _, tokens = olmo
    with torch.no_grad(), CostCounter() as c:
        model.apply(params, {"tokens": tokens[:, :-1]})
    jcfg = jax_get_config("olmo-1b").reduced(vocab_size=256, d_ff=512)
    jm = JaxLM(jcfg)
    jparams = jax.jit(jm.init)(jax.random.key(0))
    hlo = jax.jit(lambda p, t: jm.apply(p, {"tokens": t})).lower(
        jparams, jnp.zeros((B, S), jnp.int32)).compile().as_text()
    want = hlo_cost.analyze(hlo).flops
    got = c.totals.product_flops
    assert got == pytest.approx(want, rel=0.01)
    assert c.totals.flops == got          # no kernel on the "xla" path
    assert c.totals.collective_counts == {}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_sizes_and_flops_equal_the_reference(arch):
    assert ARCH_NAMES == tuple(JAX_ARCHS)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert roofline.param_count(cfg) == hlo_analysis.param_count(jcfg)
    assert roofline.active_param_count(cfg) == \
        hlo_analysis.active_param_count(jcfg)
    for name, shape in INPUT_SHAPES.items():
        train = shape.kind == "train"
        assert roofline.model_flops(cfg, shape, training=train) == \
            hlo_analysis.model_flops(jcfg, JAX_SHAPES[name], training=train)


def test_roofline_terms_on_h100_rates():
    t = roofline.roofline_terms(flops=989e12, bytes_accessed=3.35e12 / 2,
                                wire_bytes=0.0, chips=1)
    assert t == {"compute_s": 1.0, "memory_s": 0.5, "collective_s": 0.0,
                 "bottleneck": "compute"}
    assert roofline.roofline_terms(flops=67e12, bytes_accessed=0,
                                   wire_bytes=450e9, chips=2,
                                   dtype="float32")["collective_s"] == 0.5


def _pallas_world(olmo):
    model, params, masks, tokens = olmo
    pallas = LM(OLMO, attn_impl="pallas", device="cpu")
    return pallas, params, masks, tokens[:, :-1], tokens[:, 1:]


def _count_twice(run):
    """The second of two counts (the rope tables are cached per device on
    the first call)."""
    run()
    with CostCounter(record=True) as c:
        run()
    return c


def test_scoring_forward_counts_the_same_on_cpu_and_meta(olmo):
    pallas, params, masks, x, y = _pallas_world(olmo)
    meta = pallas.on_meta()
    pm, mm, xm, ym = (_to_meta(params), _to_meta(masks), x.to("meta"),
                      y.to("meta"))
    with torch.no_grad():
        cpu = _count_twice(lambda: pallas.loss_and_acc(params, x, y,
                                                       masks=masks))
        met = _count_twice(lambda: meta.loss_and_acc(pm, xm, ym, masks=mm))
    assert cpu.totals == met.totals
    assert [o for o in cpu.ops] == [o for o in met.ops]
    L, H, hd = OLMO.num_layers, OLMO.num_heads, OLMO.resolved_head_dim
    work = cpu.totals.as_dict()["kernel_work"]
    assert work["flash_attention"]["calls"] == L
    assert work["masked_matmul"]["calls"] == 2 * L
    pairs = S * (S + 1) // 2
    assert work["flash_attention"]["flops"] == L * 4 * B * H * hd * pairs
    fl, nb = k1.work("fwd", B * S, OLMO.d_model, OLMO.d_ff, 4)
    assert work["masked_matmul"] == {"calls": 2 * L, "flops": 2 * L * fl,
                                     "bytes": 2 * L * nb}
    # K4's plain version's own products are not counted: the xla path's
    # products are the pallas path's plus the full attention products
    # (QK^T and PV over all S x S); both run K1 for the masked FFN
    xla = LM(OLMO, device="cpu")
    with torch.no_grad():
        plain = _count_twice(lambda: xla.loss_and_acc(params, x, y,
                                                      masks=masks))
    full_attn = L * 4 * B * H * S * S * hd
    assert plain.totals.product_flops == \
        cpu.totals.product_flops + full_attn
    assert plain.totals.kernel_calls == {"masked_matmul": 2 * L}


def test_masked_decode_step_counts_the_same_on_cpu_and_meta(olmo):
    model, params, masks, _ = olmo
    cache = model.init_cache(4, 32)
    cache["index"] = torch.tensor([0, 3, 7, 31], dtype=torch.int32)
    tok = {"tokens": torch.zeros((4, 1), dtype=torch.int32)}
    meta = model.on_meta()
    cm, tm, pm, mm = (_to_meta(cache), _to_meta(tok), _to_meta(params),
                      _to_meta(masks))
    with torch.inference_mode():
        cpu = _count_twice(lambda: model.decode_step(params, cache, tok,
                                                     masks=masks))
        met = _count_twice(lambda: meta.decode_step(pm, cm, tm, masks=mm))
    assert cpu.totals == met.totals
    work = cpu.totals.as_dict()["kernel_work"]
    L, H, KV, hd = (OLMO.num_layers, OLMO.num_heads,
                    OLMO.padded_num_kv_heads, OLMO.resolved_head_dim)
    # every S row of every slot: the lengths lie on the device
    assert work["decode_attention"] == {
        "calls": L, "flops": L * 4 * 4 * 32 * H * hd,
        "bytes": L * (4 * (2 * 4 * H * hd + 2 * 4 * 32 * KV * hd) + 4 * 4)}
    assert work["masked_matmul"]["calls"] == 2 * L
    assert cpu.totals.product_flops > 0
    # the same step without inference mode counts the same products
    with torch.no_grad():
        grad_mode = _count_twice(lambda: model.decode_step(
            params, cache, tok, masks=masks))
    assert grad_mode.totals.product_flops == cpu.totals.product_flops


def test_kernel_mode_gradient_counts_k1_k2_k3_once(olmo):
    model, params, masks, tokens = olmo
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    meta = model.on_meta()
    bm, pm, mm = _to_meta(batch), _to_meta(params), _to_meta(masks)

    def grad(m, p, b, fm):
        return engine.grad(lambda q: m.loss(q, b, masks=fm), p)

    cpu = _count_twice(lambda: grad(model, params, batch, masks))
    met = _count_twice(lambda: grad(meta, pm, bm, mm))
    assert cpu.totals == met.totals
    calls = {k: v["calls"]
             for k, v in cpu.totals.as_dict()["kernel_work"].items()}
    L = OLMO.num_layers
    assert calls == {"masked_matmul": 2 * L, "masked_matmul_dx": 2 * L,
                     "masked_matmul_dw": 2 * L}


def test_kernel_calls_equal_the_wrappers_count_without_a_counter(olmo):
    """No counter: the entry points run as before (the module-level
    ``counter`` is None outside a ``CostCounter``)."""
    pallas, params, masks, x, y = _pallas_world(olmo)
    assert ops.counter is None
    with CostCounter():
        assert ops.counter is not None
    assert ops.counter is None
    with torch.no_grad():
        want = pallas.loss_and_acc(params, x, y, masks=masks)
        with CostCounter():
            got = pallas.loss_and_acc(params, x, y, masks=masks)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("sq,skv,causal,window", [
    (64, 64, True, None), (48, 80, True, None), (80, 48, True, None),
    (64, 64, True, 16), (33, 70, False, None), (70, 33, False, 8),
    (1, 1, True, 1)])
def test_visible_pairs_equal_the_mask(sq, skv, causal, window):
    want = int(ref.visible(sq, skv, causal=causal, window=window).sum())
    assert k4.visible_pairs(sq, skv, causal, window) == want


def test_work_formulas():
    """K1 at decode with half the blocks kept, K5 at ragged lengths, K6: the
    bound column's formulas (``chip_smoke.py`` reads them)."""
    assert k1.work("fwd", 8, 2048, 8192, 2, 32) == (
        2 * 8 * 2048 * 4096, 2 * (8 * 2048 + 2048 * 4096 + 8 * 8192) + 256)
    assert k1.work("dx", 512, 2048, 8192, 4, 0) == (
        0, 4 * (512 * 2048) + 256)
    assert k5.work(8, 16, 16, 128, 2, 100) == (
        4 * 100 * 16 * 128, 2 * (2 * 8 * 16 * 128 + 2 * 100 * 16 * 128)
        + 32)
    from repro_torch.kernels import ssd_scan as k6
    assert k6.work(1, 8192, 64, 64, 64, 2) == (
        4 * 8192 * 64 * 64 * 64,
        2 * (2 * 8192 * 64 * 64 + 2 * 8192 * 64 + 8192 * 64) + 12 * 64)


def test_meta_route_gives_empty_outputs_of_the_kernels_shapes():
    m = torch.device("meta")
    x = torch.empty((8, 256), device=m)
    w = torch.empty((256, 384), device=m)
    bm = torch.empty((3,), device=m)
    assert ops.masked_matmul_fwd(x, w, bm).shape == (8, 384)
    assert ops.masked_matmul_dx(torch.empty((8, 384), device=m), w,
                                bm).shape == (8, 256)
    assert ops.masked_matmul_dw(x, torch.empty((8, 384), device=m),
                                bm).shape == (256, 384)
    q = torch.empty((2, 1, 4, 64), dtype=torch.bfloat16, device=m)
    kv = torch.empty((2, 16, 2, 64), dtype=torch.bfloat16, device=m)
    out = ops.decode_attention(q, kv, kv)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert out.device.type == "meta"
    from repro_torch import device as _device
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        _device.resolve("meta")


# ---------------------------------------------------------------------------
# op_lint
# ---------------------------------------------------------------------------

def _record(fn):
    with CostCounter(record=True) as c:
        fn()
    return c.ops


def test_op_lint_catches_injected_faults():
    x = torch.ones(4)
    assert op_lint.check_stream("clean", _record(lambda: x * 2 + 1)) == []
    f64 = op_lint.check_stream("f64", _record(lambda: x.double() * 2))
    assert len(f64) == 1 and "f64" in f64[0]
    read = op_lint.check_stream("read", _record(lambda: (x.sum().item(),
                                                         x.nonzero())))
    assert len(read) == 1 and "_local_scalar_dense" in read[0] \
        and "nonzero" in read[0]
    fresh = not dist.is_initialized()
    if fresh:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        ops_ = _record(lambda: dist.all_reduce(x))
    finally:
        if fresh:
            dist.destroy_process_group()
    coll = op_lint.check_stream("collective", ops_)
    assert len(coll) == 1 and "c10d.allreduce_" in coll[0]
    assert op_lint.check_stream("mesh", ops_, mesh_less=False) == []
    assert op_lint.check_mesh_budget({"c10d.allreduce_": 26})
    assert op_lint.check_mesh_budget(
        op_lint.load_budget()["mesh_round"]["collectives"]) == []


def test_op_lint_canonical_rounds_and_waves_are_clean():
    assert op_lint.check(mesh=False) == []


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["olmo-1b", "arctic-480b", "zamba2-1.2b",
                                  "whisper-small"])
@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_dryrun_on_the_meta_device(arch, shape):
    cfg = get_config(arch).reduced()
    if cfg.ssm is not None:     # the registered chunk: 16 a 4096 sequence
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, chunk=get_config(arch).ssm.chunk))
    rec = dryrun.dryrun_pair(arch, shape, cfg=cfg)
    assert rec["ok"] and rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["chips"] == 256
    # the reduced olmo-1b runs tensor-parallel on the 16-way model axis
    # (its 4 heads stay whole, its d_ff 512 and vocab 512 split: one
    # all-reduce at the embedding and after each FFN, the loss's three, the
    # accuracy's two, each FFN's and the head's input gradient; the client
    # axis's FedAvg sum and server-step sum; the whole logits gathered
    # over model and then over the batch's rows), counted as rank 0's
    # part; the other families keep the whole step and no collective
    L = cfg.num_layers
    want = ({"all-reduce": 4 * L + 14} if shape == "train_4k" else
            {"all-reduce": 1 + L, "all-gather": 2})
    tp = arch == "olmo-1b"
    assert rec["collective_counts"] == (want if tp else {})
    assert ("collectives_pending" in rec) != tp
    assert rec["model_flops"] == roofline.model_flops(
        cfg, INPUT_SHAPES[shape], training=shape == "train_4k")
    assert rec["useful_flops_ratio"] == rec["model_flops"] / (
        rec["flops"] * (rec["chips"] if tp else 1))
    assert rec["roofline"]["bottleneck"] in ("compute", "memory")
    assert set(rec["per_device_bytes"]) == {"16x16", "2x16x16"}
    for dev in rec["per_device_bytes"].values():
        assert 0 < dev["params"] <= roofline.param_count(cfg) * 4
        assert dev.get("cache", 1) > 0 and dev.get("state", 1) > 0
    dev = rec["per_device_bytes"]["16x16"]
    if shape == "decode_32k":   # K5 on every attention's cache
        n = (len(LM(cfg, device="cpu").hybrid_groups())
             if cfg.family == "hybrid" else cfg.num_layers)
        assert rec["kernel_work"]["decode_attention"]["calls"] == n
        assert "cache" in dev and "state" not in dev
    else:
        assert dev["state"] > dev["params"] and "cache" not in dev
        assert rec["num_clients"] == (16 if cfg.fl_client_axis == "data"
                                      else 1)
