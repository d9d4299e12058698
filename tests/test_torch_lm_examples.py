"""The port's two LM example scripts, run as a user runs them, on the CPU.

``examples/fl_llm_train_torch.py`` (federated LM training through a
TrainPlan with a FedAP Prune event) and ``examples/serve_decode_torch.py``
(the continuous-batching engine for the dense family, pruned and masked,
and for the moe family; the lockstep loop for the ssm, vlm and encdec
families) each run once in a subprocess with
``--device cpu`` at tiny sizes, and their printed lines are checked: the
lines of the reference's scripts, with finite numbers.
"""
import math
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
NUM = r"([-+]?[0-9]*\.?[0-9]+(?:e[-+]?[0-9]+)?)"


def _run(script, *args) -> list[str]:
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / script), *args,
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip().splitlines()


def _finite(match) -> bool:
    return all(math.isfinite(float(g)) for g in match.groups()
               if re.fullmatch(NUM, g))


def test_fl_llm_train_prints_rounds_and_the_prune():
    lines = _run("fl_llm_train_torch.py", "--scale", "tiny", "--rounds", "2",
                 "--prune-round", "1", "--clients", "4")
    rounds = [re.fullmatch(rf"round +(\d+)  loss {NUM}  token-acc {NUM}  "
                           rf"tau_eff {NUM}  \((\d+)s\)", line)
              for line in lines[:-1]]
    assert rounds and all(m and _finite(m) for m in rounds), lines
    assert int(rounds[-1].group(1)) == 2
    prune = re.fullmatch(rf"FedAP: p\*={NUM}  kept=\{{'mlp': (\d+)\}}  "
                         rf"mode=mask", lines[-1])
    assert prune, lines
    assert 0 < int(prune.group(2)) < 512            # tiny's d_ff


@pytest.mark.parametrize("args,head", [
    (("--arch", "xlstm-125m"),
     r"arch=xlstm-125m \(reduced\) batch=4"),
    (("--arch", "olmo-1b", "--prune-rate", "0.5", "--serve-mode", "masked"),
     r"arch=olmo-1b \(reduced, masked@0\.5\) slots=4 requests=8"),
    (("--arch", "arctic-480b"),
     r"arch=arctic-480b \(reduced, dense\) slots=4 requests=8"),
    (("--arch", "llama4-maverick-400b-a17b"),
     r"arch=llama4-maverick-400b-a17b \(reduced, dense\) slots=4 "
     r"requests=8"),
    (("--arch", "qwen2-vl-7b"),
     r"arch=qwen2-vl-7b \(reduced\) batch=4"),
    (("--arch", "whisper-small"),
     r"arch=whisper-small \(reduced\) batch=4"),
], ids=["xlstm-lockstep", "olmo-masked-engine", "arctic-engine",
        "llama4-engine", "qwen2-vl-lockstep", "whisper-lockstep"])
def test_serve_decode_prints_its_lines(args, head):
    lines = _run("serve_decode_torch.py", *args)
    assert len(lines) == 3 and re.fullmatch(head, lines[0]), lines
    if args[1] in ("xlstm-125m", "qwen2-vl-7b", "whisper-small"):
        rate = re.fullmatch(rf"prefill 16 tok: {NUM}s; decode 32 tok: {NUM}s "
                            rf"\({NUM} tok/s\)", lines[1])
    else:
        rate = re.fullmatch(rf"(\d+) tokens in {NUM}s \({NUM} tok/s "
                            rf"continuous batching\)", lines[1])
        assert rate and int(rate.group(1)) == 8 * 32, lines
    assert rate and _finite(rate), lines
    sample = re.fullmatch(r"sample: \[([0-9, ]+)\]", lines[2])
    assert sample and len(sample.group(1).split(",")) == 16, lines


def test_serve_decode_refuses_a_prune_rate_on_a_moe_arch():
    """As the reference's script: ``--prune-rate`` prunes FFN units, which a
    MoE stack does not have."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "serve_decode_torch.py"),
         "--arch", "arctic-480b", "--prune-rate", "0.5", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 1
    assert "use a dense-family --arch" in proc.stderr


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-small"])
def test_serve_decode_refuses_a_prune_rate_on_the_lockstep_path(arch):
    """``--prune-rate`` prunes the engine's dense FFN stack: the lockstep
    families exit with the same message."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / "serve_decode_torch.py"),
         "--arch", arch, "--prune-rate", "0.5", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 1
    assert "use a dense-family --arch" in proc.stderr
