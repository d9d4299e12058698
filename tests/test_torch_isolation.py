"""The port stands alone and never runs on the CPU by accident.

* Every ``repro_torch`` module imports with ``jax`` and ``repro`` blocked.
* No source line of the port, of ``chip_smoke.py`` or of the port's
  examples (``examples/*_torch.py``) imports either.
* Entry points default to ``device="cuda"`` and raise on a machine without
  CUDA instead of carrying on on the CPU.
* The kernel dispatch serves only CPU tensors with the plain versions: any
  other device launches the kernel or raises.
"""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import experiments, interop
from repro_torch.configs import get_config
from repro_torch.core import pruning_lm
from repro_torch.core.rounds import FederatedTrainer, feddumap_config
from repro_torch.data.pipeline import build_lm_federated_data
from repro_torch.data.synthetic import TokenSpec
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as k5
from repro_torch.kernels import flash_attention as k4
from repro_torch.kernels import masked_matmul as k1
from repro_torch.kernels import ssd_scan as k6
from repro_torch.configs.base import InputShape
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import steps
from repro_torch.models import api, cnn
from repro_torch.models.lm import LM
from repro_torch.serving import (DecodeEngine, ServeConfig, load_servable,
                                 lockstep_decode)

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
TINY = get_config("olmo-1b").reduced(vocab_size=256, d_ff=256)
MOE = get_config("arctic-480b").reduced(vocab_size=256)
VLM = get_config("qwen2-vl-7b").reduced(vocab_size=256)
WHISPER = get_config("whisper-small").reduced(vocab_size=256)
EXAMPLES = ("fl_paper_repro_torch.py", "quickstart_torch.py",
            "serve_decode_torch.py", "fl_llm_train_torch.py")


def _modules():
    return sorted(".".join(p.relative_to(REPO / "src").with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_every_module_imports_without_jax_or_repro():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for name in {_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_line_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    files = list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"] + [
        REPO / "examples" / name for name in EXAMPLES]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits, hits


def test_importing_builds_nothing():
    """Kernels are compiled at first launch, never at import."""
    assert _build.build_logs() == {}
    assert list(_build.CSRC.glob("*.cu"))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


@pytest.mark.parametrize("entry", ["LM", "DecodeEngine", "load_servable",
                                   "params_from_jax", "LM.apply",
                                   "FederatedTrainer", "device_arrays",
                                   "round_state_from_jax", "hybrid LM",
                                   "SimpleCNN", "ResNet18",
                                   "cnn_params_from_jax", "CNN trainer",
                                   "run_one", "scenario grid",
                                   "fl_paper_repro_torch", "xlstm LM",
                                   "serve_decode_torch",
                                   "fl_llm_train_torch", "moe LM",
                                   "llama4 LM", "moe DecodeEngine",
                                   "moe load_servable",
                                   "serve_decode_torch moe", "vlm LM",
                                   "vlm DecodeEngine", "encdec LM",
                                   "prefill_cross", "lockstep_decode encdec",
                                   "serve_decode_torch whisper",
                                   "build_model", "input_specs",
                                   "make_fl_train_step", "make_prefill_step",
                                   "make_host_mesh", "mesh trainer",
                                   "fl_llm_train_torch mesh"])
def test_default_device_raises_without_cuda(no_cuda, entry):
    params = LM(TINY, device="cpu").init(torch.Generator().manual_seed(0))
    data = build_lm_federated_data(
        num_clients=2, spec=TokenSpec(vocab_size=256, num_topics=4,
                                      seq_len=9, num_sequences=32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "LM":
            LM(TINY)
        elif entry == "hybrid LM":
            LM(get_config("zamba2-1.2b"), attn_impl="pallas")
        elif entry == "LM.apply":
            LM(TINY).apply(params, {"tokens": torch.zeros((1, 4),
                                                          dtype=torch.int32)})
        elif entry == "FederatedTrainer":
            FederatedTrainer(LM(TINY, device="cpu"), data,
                             feddumap_config(num_clients=2,
                                             clients_per_round=1))
        elif entry == "device_arrays":
            data.device_arrays()
        elif entry in ("SimpleCNN", "ResNet18"):
            getattr(cnn, entry)(image_shape=(8, 8, 3))
        elif entry == "cnn_params_from_jax":
            interop.cnn_params_from_jax({"c": {"w": np.zeros((3, 3, 1, 2),
                                                             np.float32)}})
        elif entry == "CNN trainer":
            FederatedTrainer(cnn.SimpleCNN(image_shape=(8, 8, 3),
                                           device="cpu"), data,
                             feddumap_config(num_clients=2,
                                             clients_per_round=1))
        elif entry == "run_one":
            experiments.run_one("default-device", out_dir=REPO / "build")
        elif entry == "scenario grid":
            experiments.suite_scenario_matrix("smoke",
                                              out_dir=REPO / "build")
        elif entry == "xlstm LM":
            LM(get_config("xlstm-125m"))
        elif entry == "moe LM":
            LM(get_config("arctic-480b"), attn_impl="pallas")
        elif entry == "llama4 LM":
            LM(get_config("llama4-maverick-400b-a17b"))
        elif entry in ("moe DecodeEngine", "moe load_servable"):
            moe = LM(MOE, device="cpu")
            mp = moe.init(torch.Generator().manual_seed(0))
            mp, mcfg, _ = pruning_lm.prune_lm_experts(mp, MOE, 0.5)
            if entry == "moe DecodeEngine":
                DecodeEngine(LM(mcfg, device="cpu"), mp,
                             ServeConfig(slots=1, cache_len=8, max_prompt=4,
                                         max_new_tokens=4))
            else:
                load_servable({"params": mp, "model_config": MOE}, "dense")
        elif entry == "vlm LM":
            LM(get_config("qwen2-vl-7b"), attn_impl="pallas")
        elif entry == "vlm DecodeEngine":
            vlm = LM(VLM, device="cpu")
            DecodeEngine(vlm, vlm.init(torch.Generator().manual_seed(0)),
                         ServeConfig(slots=1, cache_len=8, max_prompt=4,
                                     max_new_tokens=4))
        elif entry == "encdec LM":
            LM(get_config("whisper-small"), attn_impl="pallas")
        elif entry in ("prefill_cross", "lockstep_decode encdec"):
            wp = LM(WHISPER, device="cpu").init(
                torch.Generator().manual_seed(0))
            frames = torch.zeros((1, WHISPER.encoder.frames, WHISPER.d_model))
            if entry == "prefill_cross":
                model = LM(WHISPER)
                model.prefill_cross(wp, model.init_cache(1, 8),
                                    {"enc_embeds": frames})
            else:
                lockstep_decode(LM(WHISPER), wp,
                                torch.zeros((1, 2), dtype=torch.int32), 2,
                                enc_embeds=frames)
        elif entry == "build_model":
            api.build_model(TINY)
        elif entry == "input_specs":
            api.input_specs(TINY, InputShape("s", 8, 2, "train"),
                            abstract=False)
        elif entry == "make_fl_train_step":
            steps.make_fl_train_step(TINY, steps.FLRunConfig(), 2)
        elif entry == "make_prefill_step":
            steps.make_prefill_step(TINY)
        elif entry == "make_host_mesh":
            lmesh.make_host_mesh()
        elif entry == "mesh trainer":
            FederatedTrainer(LM(TINY, device="cpu"), data,
                             feddumap_config(num_clients=2,
                                             clients_per_round=1),
                             backend="mesh")
        elif entry in ("fl_paper_repro_torch", "serve_decode_torch",
                       "fl_llm_train_torch", "serve_decode_torch moe",
                       "serve_decode_torch whisper",
                       "fl_llm_train_torch mesh"):
            args = {"fl_paper_repro_torch": ["--rounds", "1", "--out",
                                             str(REPO / "build" / "x")],
                    "serve_decode_torch": ["--arch", "xlstm-125m"],
                    "serve_decode_torch moe": ["--arch", "arctic-480b"],
                    "serve_decode_torch whisper": ["--arch",
                                                   "whisper-small"],
                    "fl_llm_train_torch": ["--rounds", "1"],
                    "fl_llm_train_torch mesh": ["--rounds", "1",
                                                "--backend", "mesh"]}[entry]
            script = entry.split()[0]
            proc = subprocess.run(
                [sys.executable, str(REPO / "examples" / f"{script}.py"),
                 *args],
                cwd=REPO, capture_output=True, text=True, timeout=120,
                env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
                     "CUDA_VISIBLE_DEVICES": ""})
            raise RuntimeError(proc.stderr.strip().splitlines()[-1])
        elif entry == "round_state_from_jax":
            interop.round_state_from_jax({"round": np.zeros((), np.float32)})
        elif entry == "DecodeEngine":
            DecodeEngine(LM(TINY, device="cpu"), params,
                         ServeConfig(slots=1, cache_len=8, max_prompt=4,
                                     max_new_tokens=4))
        elif entry == "load_servable":
            load_servable({"params": params, "model_config": TINY}, "dense")
        else:
            interop.params_from_jax({"w": np.zeros(3, np.float32)})


def test_engine_refuses_a_model_on_another_device():
    model = LM(TINY, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    other = type("OnMeta", (), {"cfg": TINY, "device": torch.device("meta")})
    with pytest.raises(ValueError, match="model lives on"):
        DecodeEngine(other(), params, ServeConfig(slots=1, cache_len=8,
                                                  max_prompt=4,
                                                  max_new_tokens=4),
                     device="cpu")


def test_dispatch_raises_on_a_non_cpu_tensor():
    """A device that is neither CPU, CUDA nor meta finds no kernel and no
    plain version.  A meta tensor (shapes only, for counting a step's work)
    gets an empty meta output of the kernel's shape: nothing is computed."""
    other = type("OnXpu", (), {"device": torch.device("xpu")})()
    for name in ("decode_attention", "masked_matmul", "masked_matmul_dx",
                 "masked_matmul_dw"):
        with pytest.raises(ValueError, match="no kernel for device xpu"):
            ops._route(name, other)
    q = torch.empty((2, 1, 4, 32), device="meta")
    kv = torch.empty((2, 16, 2, 32), device="meta")
    outs = [ops.decode_attention(q, kv, kv),
            ops.masked_matmul(torch.empty((8, 128), device="meta"),
                              torch.empty((128, 256), device="meta"),
                              torch.ones(2, device="meta")),
            ops.masked_matmul_dx(torch.empty((8, 256), device="meta"),
                                 torch.empty((128, 256), device="meta"),
                                 torch.ones(2, device="meta")),
            ops.masked_matmul_dw(torch.empty((8, 128), device="meta"),
                                 torch.empty((8, 256), device="meta"),
                                 torch.ones(2, device="meta"))]
    assert [tuple(o.shape) for o in outs] == [(2, 1, 4, 32), (8, 256),
                                              (8, 128), (128, 256)]
    assert all(o.device.type == "meta" for o in outs)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never compute on the CPU (and count nothing)."""
    counts = lambda: (k5.launches, k1.launches, k1.dx_launches,  # noqa: E731
                      k1.dw_launches)
    before = counts()
    q, kv = torch.zeros(2, 1, 4, 32), torch.zeros(2, 16, 2, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        k5.decode_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA device"):
        k1.masked_matmul(torch.zeros(8, 128), torch.zeros(128, 256),
                         torch.ones(2))
    with pytest.raises(ValueError, match="CUDA device"):
        k1.masked_matmul_dx(torch.zeros(8, 256), torch.zeros(128, 256),
                            torch.ones(2))
    with pytest.raises(ValueError, match="CUDA device"):
        k1.masked_matmul_dw(torch.zeros(8, 128), torch.zeros(8, 256),
                            torch.ones(2))
    assert counts() == before


def _ssd_args(device):
    return (torch.zeros((1, 8, 2, 4), device=device),
            torch.zeros((1, 8, 16), device=device),
            torch.zeros((1, 8, 16), device=device),
            torch.zeros((1, 8, 2), device=device),
            torch.zeros(2, device=device), torch.ones(2, device=device),
            torch.zeros(2, device=device))


def test_full_sequence_dispatch_raises_on_a_non_cpu_tensor():
    """K4 and K6 serve CPU tensors with their plain versions, CUDA tensors
    with their kernels, meta tensors with an empty output of the kernel's
    shape, and nothing else."""
    other = type("OnXpu", (), {"device": torch.device("xpu")})()
    for name in ("flash_attention", "ssd_scan"):
        with pytest.raises(ValueError, match="no kernel for device xpu"):
            ops._route(name, other)
    q = torch.empty((1, 8, 4, 32), device="meta")
    kv = torch.empty((1, 8, 2, 32), device="meta")
    assert ops.flash_attention(q, kv, kv).shape == q.shape
    y = ops.ssd_scan(*_ssd_args("meta"))
    assert y.shape == (1, 8, 2, 4) and y.device.type == "meta"


def test_full_sequence_kernel_wrappers_refuse_cpu_tensors():
    """The K4 and K6 wrappers never compute on the CPU (and count
    nothing)."""
    before = (k4.launches, k6.launches)
    q, kv = torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        k4.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="CUDA device"):
        k6.ssd_scan(*_ssd_args("cpu"))
    assert (k4.launches, k6.launches) == before


def test_every_kernel_source_has_a_signature():
    """Each ``csrc/*.cu`` is built into a library named in SIGNATURES."""
    libs = {lib for lib, _, _ in _build.SIGNATURES.values()}
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == libs
    assert {"flash_attention", "ssd_scan"} <= set(_build.SIGNATURES)
