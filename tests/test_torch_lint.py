"""The port's contract lint (``repro_torch.analysis.lint``): every rule
flagged and clean on small sources, mirroring ``tests/test_analysis.py``'s
classes for the reference's lint; R4 and R5 give the reference's
``lint_source`` violations on the same sources (R5's import-time half on
the source with ``jnp.`` spelled ``torch.``); the port's own tree comes out
clean.
"""
import pathlib

import pytest

from repro.analysis.lint import lint_source as ref_lint_source
from repro_torch.analysis import lint
from repro_torch.analysis.lint import lint_source

REPO = pathlib.Path(__file__).resolve().parents[1]


def rules_of(violations):
    return sorted({v.rule for v in violations})


# ---------------------------------------------------------------------------
# R1 — explicit generators
# ---------------------------------------------------------------------------

class TestR1Generators:
    @pytest.mark.parametrize("call", [
        "torch.manual_seed(0)",
        "torch.randn(3)",
        "torch.rand((2, 3))",
        "torch.randint(0, 5, (3,))",
        "torch.randperm(4)",
        "torch.bernoulli(p)",
        "torch.multinomial(p, 2)",
        "torch.nn.init.normal_(w)",
        "p.normal_()",
        "np.random.randn(3)",
        "np.random.seed(0)",
        "np.random.choice(4, 2)",
    ])
    def test_global_draw_flagged(self, call):
        src = f"""
import numpy as np
import torch

def f(p, w):
    return {call}
"""
        vs = lint_source(src, rules=["R1"])
        assert rules_of(vs) == ["R1"], call

    @pytest.mark.parametrize("call", [
        "torch.randn(3, generator=g)",
        "torch.randint(0, 5, (3,), generator=g)",
        "torch.nn.init.normal_(w, generator=g)",
        "p.normal_(generator=g)",
        "np.random.default_rng(seed).normal(size=3)",
        "np.random.SeedSequence(seed).entropy",
        "torch.Generator().manual_seed(seed)",
    ])
    def test_explicit_generator_clean(self, call):
        src = f"""
import numpy as np
import torch

def f(p, w, g, seed):
    return {call}
"""
        assert lint_source(src, rules=["R1"]) == [], call

    def test_aliased_imports_flagged(self):
        src = """
import numpy as xp
import torch as T
from torch.nn import init

def f(w):
    T.randn(3)
    init.uniform_(w)
    return xp.random.rand(2)
"""
        vs = lint_source(src, rules=["R1"])
        assert [v.line for v in vs] == [7, 8, 9]

    def test_seed_ladder_flagged_and_one_generator_clean(self):
        ladder = """
import torch

def bench(model):
    p = model.init(torch.Generator().manual_seed(0))
    x = torch.randn(3, generator=torch.Generator().manual_seed(1))
    return p, x
"""
        vs = lint_source(ladder, rules=["R1"])
        assert rules_of(vs) == ["R1"] and "seed ladder" in vs[0].message
        assert vs[0].line == 6

        fixed = """
import torch

def bench(model):
    gen = torch.Generator().manual_seed(0)
    p = model.init(gen)
    x = torch.randn(3, generator=gen)
    return p, x
"""
        assert lint_source(fixed, rules=["R1"]) == []

    def test_a_torch_and_a_numpy_seed_are_no_ladder(self):
        src = """
import numpy as np
import torch

def bench(model):
    p = model.init(torch.Generator().manual_seed(0))
    prompts = np.random.default_rng(0).integers(0, 9, 4)
    return p, prompts
"""
        assert lint_source(src, rules=["R1"]) == []

    def test_pragma_suppresses(self):
        src = """
import torch

def f():
    a = torch.Generator().manual_seed(0)
    b = torch.Generator().manual_seed(1)  # lint: generator-ok (fixed)
    return torch.randn(3), a, b  # lint: generator-ok
"""
        assert lint_source(src, rules=["R1"]) == []

    def test_module_level_draw_flagged(self):
        src = """
import numpy as np

NOISE = np.random.rand(4)
"""
        assert rules_of(lint_source(src, rules=["R1"])) == ["R1"]


# ---------------------------------------------------------------------------
# R2 — host reads reachable from a round or a wave
# ---------------------------------------------------------------------------

class TestR2HostReads:
    @pytest.mark.parametrize("read", [".item()", ".cpu()", ".tolist()",
                                      ".numpy()"])
    def test_read_in_round_core_flagged(self, read):
        src = f"""
def round_core(cfg, state, batch):
    return state["w"].sum(){read}
"""
        vs = lint_source(src, rules=["R2"])
        assert rules_of(vs) == ["R2"]
        assert read in vs[0].message

    def test_reachability_through_call_chain(self):
        src = """
def helper(x):
    return float(x.sum())

def run_steps(model, state):
    return helper(state)
"""
        vs = lint_source(src, rules=["R2"])
        assert rules_of(vs) == ["R2"] and "helper" in vs[0].message

    def test_engine_step_is_a_root(self):
        src = """
class DecodeEngine:
    def _step(self, state):
        return bool(state["active"].any())

    def step_wave(self):
        return self._state["active"].cpu()
"""
        vs = lint_source(src, rules=["R2"])
        assert [v.line for v in vs] == [4]    # the wave's own read is fine

    def test_unreachable_host_code_not_flagged(self):
        src = """
def evaluate(state):
    return float(state["loss"].mean())
"""
        assert lint_source(src, rules=["R2"]) == []

    def test_int_of_static_shape_not_flagged(self):
        src = """
def round_core(cfg, state, batch):
    n = int(batch["x"].shape[0])
    return state, float(cfg.lr) * n
"""
        assert lint_source(src, rules=["R2"]) == []

    def test_pragma_suppresses(self):
        src = """
def round_core(cfg, state, batch):
    return state["w"].item()  # lint: host-sync-ok
"""
        assert lint_source(src, rules=["R2"]) == []


# ---------------------------------------------------------------------------
# R3 — branches on tensor values in the round's and the kernels' modules
# ---------------------------------------------------------------------------

class TestR3StaticBranch:
    PATH = "src/repro_torch/kernels/fixture.py"

    def test_branch_on_tensor_value_flagged(self):
        src = """
import torch

def f(x):
    if torch.sum(x) > 0:
        return x
    return -x
"""
        vs = lint_source(src, path=self.PATH, rules=["R3"])
        assert rules_of(vs) == ["R3"]
        assert "static-branch" in vs[0].message

    def test_shape_config_and_metadata_branches_clean(self):
        src = """
def f(x, w, cfg, causal: bool = True, block: int = 128):
    if x.ndim != 2:
        raise ValueError(f"bad rank {x.shape}")
    if cfg.use_masks:
        block = block * 2
    tensors = (x, w)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("contiguous")
    if x.data_ptr() % 16 or x.stride(0) * x.element_size() % 16:
        raise ValueError("aligned")
    if causal and x.shape[0] % block == 0:
        return x
    return -x
"""
        assert lint_source(src, path=self.PATH, rules=["R3"]) == []

    def test_host_function_result_clean(self):
        src = """
def _plan(s: int) -> tuple[int, int]:
    return s, 1

def f(x):
    splits, rows = _plan(x.shape[1])
    if splits > 1:
        return x
    return -x
"""
        assert lint_source(src, path=self.PATH, rules=["R3"]) == []

    def test_iterating_a_tensor_is_not_static(self):
        src = """
def f(x):
    if any(v > 0 for v in x):
        return x
    return -x
"""
        assert rules_of(lint_source(src, path=self.PATH,
                                    rules=["R3"])) == ["R3"]

    def test_pragma_allows_static_branch(self):
        src = """
def f(x, flags):
    if flags[0]:  # lint: static-branch
        return x
    return -x
"""
        assert lint_source(src, path=self.PATH, rules=["R3"]) == []

    def test_out_of_scope_module_not_checked(self):
        src = """
import torch

def f(x):
    if torch.sum(x) > 0:
        return x
    return -x
"""
        assert lint_source(src, path="src/repro_torch/launch/fixture.py",
                           rules=["R3"]) == []


# ---------------------------------------------------------------------------
# R4 / R5, held to the reference's lint on the same sources
# ---------------------------------------------------------------------------

R4_SOURCES = ["""
def kernel(x, block: int = 128):
    assert x.shape[0] % block == 0
    return x
""", """
def kernel(x):
    if x.ndim != 2:
        raise ValueError(x.shape)
    return x
"""]
R5_SOURCES = ["""
def f(x, acc=[]):
    acc.append(x)
    return acc
""", """
def f(x, *, table={}, opts=None):
    return lambda y, seen=set(): (x, y, table, seen)
""", """
def f(x, acc=None):
    return acc or [x]
"""]
IMPORT_TIME = ["""
import jax.numpy as jnp

TABLE = jnp.arange(16)
""", """
import jax.numpy as jnp

TABLE = jnp.arange(16)  # lint: import-time-ok

def f(x):
    return jnp.zeros_like(x)
""", """
import jax.numpy as jnp

class Consts:
    ONES = jnp.ones((3,))
    HALF = jnp.full((2,), 0.5)
"""]


def _lines(vs):
    return [(v.rule, v.line) for v in vs]


class TestR4R5:
    @pytest.mark.parametrize("src", R4_SOURCES)
    @pytest.mark.parametrize("where", ["kernels", "core"])
    def test_r4_equals_the_reference(self, src, where):
        got = lint_source(src, path=f"src/repro_torch/{where}/fixture.py",
                          rules=["R4"])
        want = ref_lint_source(src, path=f"src/repro/{where}/fixture.py",
                               rules=["R4"])
        assert _lines(got) == _lines(want)
        if where == "kernels" and "assert" in src:
            assert got and "ValueError" in got[0].message

    @pytest.mark.parametrize("src", R5_SOURCES)
    def test_mutable_defaults_equal_the_reference(self, src):
        got = lint_source(src, rules=["R5"])
        assert _lines(got) == _lines(ref_lint_source(src, rules=["R5"]))

    @pytest.mark.parametrize("src", IMPORT_TIME)
    def test_import_time_tensors_equal_the_reference(self, src):
        ported = src.replace("import jax.numpy as jnp",
                             "import torch").replace("jnp.", "torch.")
        got = lint_source(ported, rules=["R5"])
        assert _lines(got) == _lines(ref_lint_source(src, rules=["R5"]))
        assert all("import time" in v.message for v in got)


def test_the_port_is_clean():
    """``src/repro_torch``, ``examples/*_torch.py`` and ``chip_smoke.py``:
    no violation (the pragmas each state why, CHANGES.md lists them)."""
    roots = lint.default_roots(REPO)
    assert any(r.endswith("chip_smoke.py") for r in roots)
    assert any(r.endswith("_torch.py") for r in roots)
    violations = lint.lint_paths(roots)
    assert violations == [], "\n".join(map(str, violations))
    assert lint.main(roots) == 0


def test_a_seeded_violation_in_a_copy_is_found(tmp_path):
    """The tree's lint is not vacuous: the engine with a host read in
    ``round_core``'s reach, and a kernel module with an assert."""
    pkg = tmp_path / "src" / "repro_torch"
    (pkg / "core").mkdir(parents=True)
    (pkg / "kernels").mkdir()
    src = (REPO / "src/repro_torch/core/engine.py").read_text()
    (pkg / "core" / "engine.py").write_text(src.replace(
        "def _all_finite(", "def _all_finite_unused(", 1) + """

def _all_finite(tree):
    return bool(tree)
""")
    (pkg / "kernels" / "k.py").write_text("def f(x):\n    assert x\n")
    vs = lint.lint_paths([tmp_path / "src"])
    assert ("R2" in rules_of(vs)) and ("R4" in rules_of(vs))
