"""The port's contract lint (stdlib ``ast`` only): the counterpart of the
reference's ``analysis/lint.py``, its rules mapped to PyTorch.

R1  **Explicit generators.**  No draw from a global random state: no
    ``torch.manual_seed``; no ``torch.rand``/``randn``/``randint``/
    ``randperm``/``normal``/``bernoulli``/``multinomial`` (or their
    ``*_like`` forms), no in-place ``Tensor.normal_``/``uniform_``/... and
    no ``torch.nn.init.*`` without a ``generator=``; no module-level
    ``np.random.<fn>`` draw (``np.random.default_rng(seed)`` and the
    ``Generator``/``SeedSequence`` types are fine).  Two literal seeds in
    one function (``.manual_seed(0)`` and ``.manual_seed(1)``, or
    ``default_rng`` alike) are a "seed ladder": draw both streams from one
    generator.  Escape: ``# lint: generator-ok``.

R2  **No host read inside a round or a wave.**  Functions reachable from
    ``core/engine.py::round_core``, ``serving/engine.py::DecodeEngine._step``
    or ``serving/lockstep.py``'s ``run_steps`` and ``LockstepSession.
    _step_body`` must not call ``.item()``,
    ``.cpu()``, ``.tolist()``, ``.numpy()``, or ``float()``/``int()``/
    ``bool()`` on a non-static value: each waits for the device and copies
    to the host, which stalls the stream and breaks a CUDA-graph capture.
    Reachability is the reference's conservative module-level call graph
    (bare names, ``from m import f`` and ``module.attr`` calls; method
    dispatch is not followed).  Escape: ``# lint: host-sync-ok``.

R3  **No Python branch on a tensor value** in ``core/engine.py``,
    ``core/momentum.py``, ``core/server_update.py`` and ``kernels/*.py``.
    A condition is static when it is built from constants, attribute
    access (config fields, ``.shape``/``.ndim``/``.dtype``/``.device``),
    ``is None``/``in`` tests, scalar-annotated or constant-defaulted
    parameters, and locals assigned from such expressions.  In eager mode
    such a branch is a host read, and it would break a capture.  Escape:
    ``# lint: static-branch``.

R4  **No bare ``assert`` in ``kernels/``**: raise ``ValueError`` naming the
    shapes (asserts vanish under ``python -O``).  No escape.

R5  **No mutable default arguments**, and **no tensor made at import
    time** (``torch.tensor``/``zeros``/``ones``/``empty``/... at module
    level: a module-level tensor picks its device on import, and a CUDA
    one initialises the card).  Escape: ``# lint: import-time-ok``
    (import-time half only).

Pragmas are same-line comments: ``... # lint: static-branch``.  Several
tags may share one comment (``# lint: static-branch host-sync-ok``).

    python -m repro_torch.analysis.lint [paths...]
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Iterable

RULES = ("R1", "R2", "R3", "R4", "R5")

_PRAGMA_TAGS = {
    "generator-ok": "R1",
    "host-sync-ok": "R2",
    "static-branch": "R3",
    "import-time-ok": "R5",
}

# torch functions that draw from the global generator unless given one
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
                "multinomial", "poisson", "rand_like", "randn_like",
                "randint_like"}
# Tensor methods that fill in place from the global generator
_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                  "exponential_", "geometric_", "log_normal_", "cauchy_"}
# np.random names that are not a draw from the module's global state
_NP_OK = {"default_rng", "Generator", "SeedSequence", "PCG64", "BitGenerator",
          "Philox", "SFC64", "MT19937"}
# torch factories that make a tensor (R5 at import time)
_TORCH_FACTORIES = {"tensor", "as_tensor", "from_numpy", "zeros", "ones",
                    "empty", "full", "arange", "linspace", "logspace", "eye",
                    "zeros_like", "ones_like", "empty_like", "full_like",
                    "rand", "randn", "randint", "randperm"}

# Builtins whose result is host-static regardless of arguments.
_STATIC_CALLS = {"len", "isinstance", "hasattr", "callable", "getattr"}
# Builtins that are static iff every argument is static.
_STATIC_IF_ARGS = {"min", "max", "abs", "bool", "int", "float", "str", "tuple",
                   "sorted", "any", "all", "sum", "range", "list", "zip",
                   "reversed", "enumerate"}
# Dotted calls that read host state (static by construction).
_STATIC_DOTTED = {"os.environ.get", "os.getenv", "math.sqrt", "math.ceil",
                  "math.floor", "math.log", "math.prod",
                  "torch.is_grad_enabled", "shutil.which", "os.path.exists",
                  "os.path.join"}
# Tensor methods that read metadata, never a value (static)
_METADATA = {"is_contiguous", "data_ptr", "stride", "element_size", "numel",
             "dim", "size", "is_floating_point", "get_device", "exists"}
_FUNC = "()"    # prefix of a static-names entry naming a host-valued function
_MODULE = "mod:"    # prefix of a static-names entry naming a module alias

# R3 scope: the round's and the kernels' modules.
_R3_MODULE_RE = re.compile(
    r"(^|/)(kernels/[^/]+\.py|core/engine\.py|core/momentum\.py|"
    r"core/server_update\.py)$")
_R4_MODULE_RE = re.compile(r"(^|/)kernels/[^/]+\.py$")
# R2 roots: (module name suffix, qualname)
_R2_ROOTS = ((".core.engine", "round_core"),
             (".serving.engine", "DecodeEngine._step"),
             (".serving.lockstep", "run_steps"),
             (".serving.lockstep", "LockstepSession._step_body"))
_HOST_METHODS = ("item", "cpu", "tolist", "numpy")


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _dotted(node: ast.AST) -> str | None:
    """'torch.nn.init.normal_' for an Attribute/Name chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _pragmas(source: str) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        if "lint:" not in line:
            continue
        _, _, tail = line.partition("lint:")
        tags = {t for t in re.findall(r"[a-z][a-z0-9-]*", tail)
                if t in _PRAGMA_TAGS}
        if tags:
            out[i] = tags
    return out


# ---------------------------------------------------------------------------
# Per-module model


@dataclasses.dataclass
class _Func:
    """One analysis unit: a def (top-level, method, or nested)."""
    qualname: str
    node: ast.FunctionDef
    children: list["_Func"] = dataclasses.field(default_factory=list)

    def own_body_nodes(self) -> Iterable[ast.AST]:
        """Walk the unit's body, stopping at nested defs (own units)."""
        stack: list[ast.AST] = list(self.node.body)
        while stack:
            n = stack.pop()
            yield n
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.extend(ast.iter_child_nodes(n))


@dataclasses.dataclass
class _Module:
    path: str                   # display path
    modname: str | None         # dotted module name (src/ files), else None
    tree: ast.Module
    source: str
    pragmas: dict[int, set[str]]
    funcs: list[_Func] = dataclasses.field(default_factory=list)
    # name -> dotted module for `import x as y` / `from pkg import mod`
    mod_aliases: dict[str, str] = dataclasses.field(default_factory=dict)
    # name -> (dotted module, func name) for `from m import f`
    func_imports: dict[str, tuple[str, str]] = dataclasses.field(
        default_factory=dict)
    top_funcs: dict[str, _Func] = dataclasses.field(default_factory=dict)

    def allowed(self, line: int, rule: str) -> bool:
        return any(_PRAGMA_TAGS.get(t) == rule
                   for t in self.pragmas.get(line, ()))

    def is_alias(self, name: str, module: str) -> bool:
        return name == module or self.mod_aliases.get(name) == module


def _collect_funcs(mod: _Module) -> None:
    def visit(node: ast.AST, prefix: str, into: list[_Func]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                f = _Func(qualname=prefix + child.name, node=child)
                into.append(f)
                visit(child, f.qualname + ".", f.children)
            elif isinstance(child, ast.ClassDef):
                visit(child, prefix + child.name + ".", into)
            elif not isinstance(child, (ast.Lambda,)):
                visit(child, prefix, into)

    visit(mod.tree, "", mod.funcs)
    for f in mod.funcs:
        mod.top_funcs.setdefault(f.node.name, f)


def _collect_imports(mod: _Module) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                mod.mod_aliases[alias.asname or alias.name.split(".")[0]] = (
                    alias.name)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            for alias in node.names:
                bound = alias.asname or alias.name
                # `from pkg import mod` and `from mod import func` are
                # indistinguishable without the file set; record both and
                # let resolution pick whichever exists.
                mod.mod_aliases.setdefault(bound, f"{node.module}.{alias.name}")
                mod.func_imports[bound] = (node.module, alias.name)


def _parse_module(source: str, path: str, modname: str | None) -> _Module:
    mod = _Module(path=path, modname=modname, tree=ast.parse(source),
                  source=source, pragmas=_pragmas(source))
    _collect_funcs(mod)
    _collect_imports(mod)
    return mod


# ---------------------------------------------------------------------------
# Static-expression classifier (shared by R2 and R3)


def _is_static(node: ast.AST, static_names: set[str]) -> bool:
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        return node.id in static_names
    if isinstance(node, ast.Attribute):
        # config fields or tensor metadata (.shape/.ndim/.dtype/.device)
        return True
    if isinstance(node, ast.Subscript):
        return _is_static(node.value, static_names)
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_static(e, static_names) for e in node.elts)
    if isinstance(node, ast.UnaryOp):
        return _is_static(node.operand, static_names)
    if isinstance(node, ast.BinOp):
        return (_is_static(node.left, static_names)
                and _is_static(node.right, static_names))
    if isinstance(node, ast.BoolOp):
        return all(_is_static(v, static_names) for v in node.values)
    if isinstance(node, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in node.ops):
            return True
        return (_is_static(node.left, static_names)
                and all(_is_static(c, static_names) for c in node.comparators))
    if isinstance(node, ast.IfExp):
        return all(_is_static(n, static_names)
                   for n in (node.test, node.body, node.orelse))
    if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp)):
        # the targets walk a literal sequence (of tensors, for their
        # metadata) or a static one; a tensor's rows are values
        inner = set(static_names)
        for gen in node.generators:
            if not (_is_static(gen.iter, inner) or _is_sequence(gen.iter)
                    or (isinstance(gen.iter, ast.Name)
                        and "[]" + gen.iter.id in static_names)):
                return False
            inner |= _target_names(gen.target)
            if not all(_is_static(c, inner) for c in gen.ifs):
                return False
        return _is_static(node.elt, inner)
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Name):
            if fn.id in _STATIC_CALLS or _FUNC + fn.id in static_names:
                return True
            if fn.id in _STATIC_IF_ARGS:
                return all(_is_static(a, static_names) for a in node.args)
            return False
        if isinstance(fn, ast.Attribute) and (
                fn.attr in _METADATA
                or (isinstance(fn.value, ast.Name)
                    and fn.value.id in static_names
                    and _MODULE + fn.value.id not in static_names)):
            # metadata, or a method of a host object (a config, a
            # module-level table: R5 keeps tensors out of those); a
            # module's functions (torch.sum) may well return tensors
            return True
        if isinstance(fn, ast.Call):        # a host function's result
            return _is_static(fn, static_names)
        return _dotted(fn) in _STATIC_DOTTED
    return False


def _is_sequence(node: ast.AST) -> bool:
    """A tuple or list display, or a sum/choice of them."""
    if isinstance(node, (ast.Tuple, ast.List)):
        return True
    if isinstance(node, ast.BinOp):
        return _is_sequence(node.left) and _is_sequence(node.right)
    if isinstance(node, ast.IfExp):
        return _is_sequence(node.body) and _is_sequence(node.orelse)
    return False


def _target_names(target: ast.AST) -> set[str]:
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        return set().union(*(_target_names(e) for e in target.elts))
    return set()


_HOST_RETURNS = ("int", "float", "bool", "str", "tuple[int")


def _host_functions(tree: ast.Module) -> set[str]:
    """Static-names entries for the module's functions annotated to return
    a host scalar (``-> int``, ``-> str``, ``-> tuple[int, ...]``...)."""
    out = set()
    for st in tree.body:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and st.returns is not None \
                and ast.unparse(st.returns).startswith(_HOST_RETURNS):
            out.add(_FUNC + st.name)
    return out


_SCALAR_ANNOTATIONS = ("int", "float", "bool", "str")


def _static_params(fn: ast.FunctionDef) -> set[str]:
    """Parameters known host-static: scalar-annotated or constant-defaulted."""
    a = fn.args
    params = list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
    defaults: dict[str, ast.AST] = {}
    pos = list(a.posonlyargs) + list(a.args)
    for arg, d in zip(reversed(pos), reversed(a.defaults)):
        defaults[arg.arg] = d
    for arg, d in zip(a.kwonlyargs, a.kw_defaults):
        if d is not None:
            defaults[arg.arg] = d
    out = set()
    if a.vararg is not None:    # *args: a tuple (of tensors, maybe)
        out.add("[]" + a.vararg.arg)
    for arg in params:
        if arg.annotation is not None:
            ann = ast.unparse(arg.annotation)
            if any(s in ann for s in _SCALAR_ANNOTATIONS):
                out.add(arg.arg)
                continue
        if isinstance(defaults.get(arg.arg), ast.Constant):
            out.add(arg.arg)
    return out


# ---------------------------------------------------------------------------
# R1 — explicit generators


def _has_generator(call: ast.Call) -> bool:
    return any(k.arg == "generator" for k in call.keywords)


def _draw_message(mod: _Module, call: ast.Call) -> str | None:
    """Why ``call`` draws from a global random state, or None."""
    d = _dotted(call.func) or ""
    parts = d.split(".")
    if len(parts) >= 2 and mod.is_alias(parts[0], "torch"):
        if parts[1:] == ["manual_seed"]:
            return ("`torch.manual_seed` seeds the global generator; pass a "
                    "`torch.Generator` instead")
        if len(parts) == 2 and parts[1] in _TORCH_DRAWS \
                and not _has_generator(call):
            return (f"`{d}` without `generator=` draws from the global "
                    f"generator")
        if parts[1:3] == ["nn", "init"] and not _has_generator(call):
            return (f"`{d}` without `generator=` draws from the global "
                    f"generator")
    if len(parts) >= 2 and parts[-2] == "init" and (
            mod.mod_aliases.get(parts[0], "").endswith("nn.init")
            or mod.mod_aliases.get(parts[0]) == "torch.nn") \
            and not _has_generator(call):
        return f"`{d}` without `generator=` draws from the global generator"
    if len(parts) >= 3 and mod.is_alias(parts[0], "numpy") \
            and parts[1] == "random" and parts[2] not in _NP_OK:
        return (f"`{d}` draws from numpy's global state; use "
                f"`np.random.default_rng(seed)`")
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _INPLACE_DRAWS \
            and not _has_generator(call):
        return (f"`.{call.func.attr}()` without `generator=` draws from the "
                f"global generator")
    return None


def _literal_seed(call: ast.Call) -> str | None:
    """``"torch"`` or ``"numpy"`` for a generator seeded with a literal
    (``.manual_seed(0)``, ``default_rng(0)``), else None."""
    if not (isinstance(call.func, ast.Attribute) and call.args
            and isinstance(call.args[0], ast.Constant)):
        return None
    return {"manual_seed": "torch",
            "default_rng": "numpy"}.get(call.func.attr)


def _check_generators(mod: _Module, fn: _Func | None,
                      out: list[Violation]) -> None:
    nodes = (fn.own_body_nodes() if fn is not None else
             _module_level_nodes(mod.tree.body))
    seeds: dict[str, set[int]] = {"torch": set(), "numpy": set()}
    for n in nodes:
        if not isinstance(n, ast.Call):
            continue
        msg = _draw_message(mod, n)
        if msg and not mod.allowed(n.lineno, "R1"):
            out.append(Violation("R1", mod.path, n.lineno, msg))
        kind = _literal_seed(n)
        if kind:
            seeds[kind].add(n.lineno)
    for kind, lines in seeds.items():
        lines = sorted(lines)
        if fn is None or len(lines) < 2 \
                or any(mod.allowed(s, "R1") for s in lines):
            continue
        out.append(Violation(
            "R1", mod.path, lines[1],
            f"{len(lines)} literal {kind} seeds in one function (first at "
            f"line {lines[0]}): a seed ladder; draw the streams from one "
            f"generator"))


def _module_level_nodes(stmts: list[ast.stmt]) -> Iterable[ast.AST]:
    """Nodes outside every def (class bodies included)."""
    stack: list[ast.AST] = list(stmts)
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


# ---------------------------------------------------------------------------
# R2 — host reads reachable from a round or a wave


def _reachable_units(mods: list[_Module]) -> set[tuple[str, str]]:
    """(path, qualname) of every unit reachable from the R2 roots."""
    by_modname = {m.modname: m for m in mods if m.modname}
    units: dict[tuple[str, str], _Func] = {}
    for m in mods:
        def add(f: _Func) -> None:
            units[(m.path, f.qualname)] = f
            for c in f.children:
                add(c)
        for f in m.funcs:
            add(f)

    edges: dict[tuple[str, str], set[tuple[str, str]]] = {
        k: set() for k in units}
    roots: set[tuple[str, str]] = set()

    def resolve_call(m: _Module, owner: _Func, fnode: ast.AST
                     ) -> tuple[str, str] | None:
        if isinstance(fnode, ast.Name):
            name = fnode.id
            for c in owner.children:
                if c.node.name == name:
                    return (m.path, c.qualname)
            if name in m.top_funcs:
                return (m.path, m.top_funcs[name].qualname)
            if name in m.func_imports:
                src_mod, src_name = m.func_imports[name]
                target = by_modname.get(src_mod)
                if target and src_name in target.top_funcs:
                    return (target.path, target.top_funcs[src_name].qualname)
            return None
        if isinstance(fnode, ast.Attribute) and isinstance(
                fnode.value, ast.Name):
            alias = m.mod_aliases.get(fnode.value.id)
            target = by_modname.get(alias) if alias else None
            if target and fnode.attr in target.top_funcs:
                return (target.path, target.top_funcs[fnode.attr].qualname)
        return None

    for m in mods:
        for key, f in list(units.items()):
            if key[0] != m.path:
                continue
            if any(f.qualname == q and (m.modname is None
                                        or m.modname.endswith(suffix))
                   for suffix, q in _R2_ROOTS):
                roots.add(key)
            for c in f.children:
                edges[key].add((m.path, c.qualname))
            for n in f.own_body_nodes():
                if isinstance(n, ast.Call):
                    tgt = resolve_call(m, f, n.func)
                    if tgt:
                        edges[key].add(tgt)

    seen = set(roots)
    stack = list(roots)
    while stack:
        cur = stack.pop()
        for nxt in edges.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return seen


def _collect_statics(fn: ast.FunctionDef, inherited: set[str]) -> set[str]:
    """Params + locals assigned from static expressions (single forward
    pass; nested defs excluded — they inherit the result)."""
    static = set(inherited) | _static_params(fn)

    def mark(target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            static.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                mark(e)

    def scan(stmts: list[ast.stmt]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, ast.Assign) and _is_static(st.value, static):
                for t in st.targets:
                    mark(t)
            elif isinstance(st, ast.AnnAssign) and st.value is not None \
                    and _is_static(st.value, static):
                mark(st.target)
            for field in ("body", "orelse", "finalbody"):
                b = getattr(st, field, None)
                if b:
                    scan(b)
            for h in getattr(st, "handlers", []):
                scan(h.body)

    scan(fn.body)
    return static


def _check_host_reads(mod: _Module, fn: _Func, inherited: set[str],
                      out: list[Violation]) -> None:
    static = _collect_statics(fn.node, inherited)
    for n in fn.own_body_nodes():
        if not isinstance(n, ast.Call):
            continue
        line = n.lineno
        if mod.allowed(line, "R2"):
            continue
        msg = None
        if isinstance(n.func, ast.Attribute) \
                and n.func.attr in _HOST_METHODS and not n.args:
            msg = (f"`.{n.func.attr}()` reads a device value to the host "
                   f"inside a round or a wave")
        elif isinstance(n.func, ast.Name) and n.func.id in ("float", "int",
                                                            "bool") \
                and n.args and not _is_static(n.args[0], static):
            msg = (f"`{n.func.id}()` of a tensor value reads it to the host "
                   f"inside a round or a wave")
        if msg:
            out.append(Violation(
                "R2", mod.path, line,
                f"{msg} [in `{fn.qualname}`, reachable from a round or a "
                f"wave]"))


# ---------------------------------------------------------------------------
# R3 — branches on tensor values


def _check_branches(mod: _Module, fn: _Func,
                    inherited: set[str], out: list[Violation]) -> None:
    static = set(inherited) | _static_params(fn.node)

    def scan_body(stmts: list[ast.stmt]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue   # nested defs checked as their own units
            if isinstance(st, ast.Assign):
                if _is_static(st.value, static):
                    for t in st.targets:
                        _mark(t)
                elif _is_sequence(st.value):
                    static.update("[]" + n for t in st.targets
                                  for n in _target_names(t))
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                if _is_static(st.value, static):
                    _mark(st.target)
            if isinstance(st, ast.If):
                check_test(st.test)
                scan_body(st.body)
                scan_body(st.orelse)
                continue
            for n in ast.iter_child_nodes(st):
                scan_expr(n)
            if isinstance(st, (ast.For, ast.AsyncFor)) and (
                    _is_static(st.iter, static) or _is_sequence(st.iter)):
                _mark(st.target)
            if isinstance(st, (ast.For, ast.AsyncFor, ast.While,
                               ast.With, ast.AsyncWith, ast.Try)):
                for body in _sub_bodies(st):
                    scan_body(body)

    def _sub_bodies(st: ast.stmt) -> list[list[ast.stmt]]:
        bodies = []
        for field in ("body", "orelse", "finalbody"):
            b = getattr(st, field, None)
            if b:
                bodies.append(b)
        for h in getattr(st, "handlers", []):
            bodies.append(h.body)
        return bodies

    def _mark(target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            static.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                _mark(e)

    def check_test(test: ast.expr) -> None:
        if not _is_static(test, static) and not mod.allowed(test.lineno, "R3"):
            out.append(Violation(
                "R3", mod.path, test.lineno,
                f"`if {ast.unparse(test)}` branches on a value not provably "
                f"static (a tensor's value is a host read); use torch.where, "
                f"or mark with `# lint: static-branch` if it is "
                f"config-static"))

    def scan_expr(node: ast.AST) -> None:
        for n in ast.walk(node):
            if isinstance(n, ast.IfExp) and not _is_static(n.test, static) \
                    and not mod.allowed(n.lineno, "R3"):
                out.append(Violation(
                    "R3", mod.path, n.lineno,
                    f"conditional expression on non-static "
                    f"`{ast.unparse(n.test)}`"))
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return

    scan_body(fn.node.body)
    for child in fn.children:
        _check_branches(mod, child, static, out)


# ---------------------------------------------------------------------------
# R4 / R5


def _check_asserts(mod: _Module, out: list[Violation]) -> None:
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Assert):
            out.append(Violation(
                "R4", mod.path, n.lineno,
                "bare `assert` in kernels/ — raise ValueError naming the "
                "offending shapes/blocks (vanishes under python -O)"))


def _check_defaults_and_import_time(mod: _Module,
                                    out: list[Violation]) -> None:
    for n in ast.walk(mod.tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            defaults = list(n.args.defaults) + [
                d for d in n.args.kw_defaults if d is not None]
            for d in defaults:
                if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                    out.append(Violation(
                        "R5", mod.path, d.lineno,
                        "mutable default argument (shared across calls); "
                        "default to None and construct inside"))

    def module_level(stmts: list[ast.stmt]) -> None:
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(st, ast.ClassDef):
                module_level(st.body)
                continue
            for n in ast.walk(st):
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                    break
                if not isinstance(n, ast.Call):
                    continue
                parts = (_dotted(n.func) or "").split(".")
                if (len(parts) == 2 and mod.is_alias(parts[0], "torch")
                        and parts[1] in _TORCH_FACTORIES
                        and not mod.allowed(n.lineno, "R5")):
                    out.append(Violation(
                        "R5", mod.path, n.lineno,
                        f"`{'.'.join(parts)}` at module import time makes a "
                        f"tensor (and picks its device) on import; build "
                        f"it lazily"))

    module_level(mod.tree.body)


# ---------------------------------------------------------------------------
# Drivers


def _lint_modules(mods: list[_Module],
                  rules: Iterable[str] | None = None) -> list[Violation]:
    rules = set(rules or RULES)
    out: list[Violation] = []
    reachable = _reachable_units(mods) if "R2" in rules else set()

    for m in mods:
        all_units: list[_Func] = []

        def flatten(f: _Func) -> None:
            all_units.append(f)
            for c in f.children:
                flatten(c)
        for f in m.funcs:
            flatten(f)

        module_static = {n.id for st in m.tree.body
                         if isinstance(st, ast.Assign)
                         for n in st.targets if isinstance(n, ast.Name)}
        module_static |= {st.target.id for st in m.tree.body
                          if isinstance(st, ast.AnnAssign)
                          and isinstance(st.target, ast.Name)}
        module_static |= set(m.mod_aliases) | set(m.func_imports)
        module_static |= {_MODULE + a for a in m.mod_aliases}
        module_static |= _host_functions(m.tree)

        if "R1" in rules:
            _check_generators(m, None, out)
            for f in all_units:
                _check_generators(m, f, out)
        if "R2" in rules:
            def sync_walk(f: _Func, inherited: set[str]) -> None:
                if (m.path, f.qualname) in reachable:
                    _check_host_reads(m, f, inherited, out)
                statics = _collect_statics(f.node, inherited)
                for c in f.children:
                    sync_walk(c, statics)
            for f in m.funcs:
                sync_walk(f, module_static)
        if "R3" in rules and _R3_MODULE_RE.search(m.path.replace("\\", "/")):
            for f in m.funcs:
                _check_branches(m, f, module_static, out)
        if "R4" in rules and _R4_MODULE_RE.search(m.path.replace("\\", "/")):
            _check_asserts(m, out)
        if "R5" in rules:
            _check_defaults_and_import_time(m, out)

    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def _modname_for(path: pathlib.Path) -> str:
    """The dotted module name of a file under ``src/``, else its stem."""
    parts = path.resolve().with_suffix("").parts
    if "src" not in parts:
        return parts[-1]
    parts = parts[len(parts) - parts[::-1].index("src"):]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def lint_paths(paths: Iterable[str | pathlib.Path],
               rules: Iterable[str] | None = None) -> list[Violation]:
    """Lint every .py file under the given paths with cross-file R2
    reachability. Returns violations sorted by (path, line)."""
    files: list[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    mods = [_parse_module(f.read_text(), str(f), _modname_for(f))
            for f in files]
    return _lint_modules(mods, rules)


def lint_source(source: str, path: str = "<memory>",
                rules: Iterable[str] | None = None) -> list[Violation]:
    """Lint a single in-memory module (fixture/test entry point).

    R2 reachability is computed within the snippet alone, from its own
    functions named as a root (``round_core``, ``DecodeEngine._step``,
    ``run_steps``); R3/R4 scoping by module path applies, so pass e.g.
    ``path="kernels/foo.py"`` to put the snippet in kernel scope.
    """
    return _lint_modules([_parse_module(source, path, None)], rules)


def default_roots(repo: pathlib.Path) -> list[str]:
    """What the port's lint covers: the package, its example drivers and
    the card's smoke script."""
    roots = [repo / "src" / "repro_torch"]
    roots += sorted((repo / "examples").glob("*_torch.py"))
    roots.append(repo / "chip_smoke.py")
    return [str(p) for p in roots if p.exists()]


def main(argv: list[str] | None = None) -> int:
    import argparse

    repo = pathlib.Path(__file__).resolve().parents[3]
    ap = argparse.ArgumentParser(prog="repro_torch.analysis.lint",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=default_roots(repo))
    ap.add_argument("--rules", default=",".join(RULES),
                    help="comma-separated subset of R1..R5")
    args = ap.parse_args(argv)

    violations = lint_paths(args.paths, rules=args.rules.split(","))
    for v in violations:
        print(v)
    print(f"repro_torch.analysis.lint: {len(violations)} violation(s) "
          f"in {len(args.paths)} root(s)")
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
