"""Keyed programs: the port's counterpart of the reference's compiled
programs (``jax.jit``'s cache; ``core/backend.py``'s ``CompiledEngine``).

A :class:`Program` wraps a function of a fixed tree of tensors and keeps one
capture per key.  The key is the tree's structure and, for every tensor,
its shape, dtype, strides, device and storage (``data_ptr``): a captured
graph addresses the storages it was captured on, so it never replays on
other ones, and a call on new tensors (a shrink's state, a resumed run)
makes a new key.

On a CUDA device the first call for a key runs the function eagerly on the
device's capture stream.  That run is the call's real work, and it makes
everything the kernels keep per stream (the ``decode_attention`` and
``masked_matmul`` workspaces, cuBLAS's and cuDNN's) exist on that stream.
The second call for the key captures the function on the same stream with
``torch.cuda.graph`` (which synchronizes and empties the allocator's cache
first) and replays the graph to do its work; every later call is one
``replay()`` on the caller's stream.  A call returns the capture's static
outputs, which the next replay overwrites.  A key run only once (the state
before a shrink, a two-round plan's first state) so never pays for a
capture: on an H100, a paper-protocol SimpleCNN round's capture took about
two eager rounds of host time (its graph holds ~10^5 kernels).  :meth:`Program.lower`
captures at once.  A capture that fails raises: nothing falls back to the
eager run.

:meth:`Program._cache_size` counts the keys, the programs that ``jax.jit``
would have compiled, on any device.  On the CPU (only where the caller
asked for it), and for a program made with ``capture=False``, every call
runs eagerly.

A replay runs no Python, so the kernel wrappers' launch counters would not
move.  A capture records each counter's change during it (the capture
launches nothing, so the counters are put back) and every replay adds it;
a program's own ``counters`` (``MeshBackend.reductions``) are kept the same
way.
A ``launch.cost.CostCounter`` cannot see inside a replay either: a captured
program refuses to run under an active counter, so nothing is undercounted
(count the eager body instead, as ``DecodeEngine.lower_wave`` does).
"""
from __future__ import annotations

import dataclasses
import inspect
import weakref
from typing import Any, Callable

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import masked_matmul as _mm
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ssd_scan as _ss
from repro_torch.utils.tree import tree_leaves, tree_map

# each kernel wrapper's launch counter: (module, attribute)
COUNTERS = ((_mm, "launches"), (_mm, "dx_launches"), (_mm, "dw_launches"),
            (_fa, "launches"), (_da, "launches"), (_ss, "launches"))

_capture_streams: dict = {}     # device index -> the capture stream


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every program on ``device`` warms up and captures on, so
    that the kernels' per-stream workspaces are shared by all of them."""
    index = torch.device(device).index or 0
    stream = _capture_streams.get(index)
    if stream is None:
        stream = _capture_streams[index] = torch.cuda.Stream(index)
    return stream


def _counts(pairs=COUNTERS) -> tuple:
    return tuple(getattr(obj, name) for obj, name in pairs)


def _add_counts(deltas, pairs=COUNTERS) -> None:
    for (obj, name), d in zip(pairs, deltas):
        setattr(obj, name, getattr(obj, name) + d)


def key_of(tree: Any) -> tuple:
    """What a capture is keyed on: the tree's structure and every tensor's
    shape, dtype, strides, device and storage; other leaves by value."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return ("t", tuple(x.shape), x.dtype, x.stride(), str(x.device),
                    x.data_ptr())
        return ("v", x)

    return (repr(tree_map(lambda x: None, tree)),
            tuple(leaf(x) for x in tree_leaves(tree)))


@dataclasses.dataclass
class Capture:
    """One captured program: its graph, its static outputs (overwritten by
    each replay) and each launch counter's change in one run (then each of
    the program's own counters')."""

    graph: Any
    out: Any
    launches: tuple


def _refuse_cost_counter(name: str) -> None:
    if _ops.counter is not None:
        raise RuntimeError(
            f"program {name!r}: a captured program runs no Python on "
            f"replay, so an active CostCounter would miss its work; count "
            f"the eager body instead (DecodeEngine.lower_wave().ops)")


class Program:
    """``fn(*args)`` kept as one capture per key of ``args`` (see the module
    docstring).  ``device`` is where the tensors live; ``capture=False``
    counts keys and always runs eagerly (the eager bodies ``chip_smoke.py``
    holds the captures against).  ``counters`` are ``(object, attribute)``
    counts that a replay adds as the wrapper counters are added.
    ``capture_error_mode`` goes to ``torch.cuda.graph`` where given
    (``"thread_local"`` lets another thread, NCCL's watchdog, query its
    events while the round is captured)."""

    def __init__(self, fn: Callable, *, name: str, device,
                 capture: bool = True, counters: tuple = (),
                 capture_error_mode: str | None = None):
        # a bound method is held weakly: its object owns this program, and
        # a reference cycle would keep the captures and their memory pools
        # alive after the object is dropped, until the collector runs
        self._fn = (weakref.WeakMethod(fn) if inspect.ismethod(fn)
                    else lambda: fn)
        self.name = name
        self.device = torch.device(device)
        self.capture = capture and self.device.type == "cuda"
        self._cache: dict = {}
        self.replays = 0
        self._counters = COUNTERS + tuple(counters)
        self._graph_kw = ({} if capture_error_mode is None else
                          {"capture_error_mode": capture_error_mode})

    @property
    def fn(self) -> Callable:
        return self._fn()

    def _cache_size(self) -> int:
        """Programs: the keys seen (each captured at its second call)."""
        return len(self._cache)

    @property
    def captures(self) -> int:
        """Keys captured as CUDA graphs so far."""
        return sum(c is not None for c in self._cache.values())

    def __call__(self, *args):
        return self._run(key_of(args), args)

    def bind(self, *args) -> Callable[[], Any]:
        """``lambda: self(*args)`` with the key computed once, for a caller
        that runs the program many times on the same tensors (a lockstep
        step: the key walks every leaf of the params)."""
        key = key_of(args)
        return lambda: self._run(key, args)

    def _run(self, key, args):
        if not self.capture:
            self._cache.setdefault(key, None)
            return self.fn(*args)
        _refuse_cost_counter(self.name)
        if key not in self._cache:
            self._cache[key] = None
            return self._on_capture_stream(args)
        cap = self._cache[key]
        if cap is None:
            cap = self._cache[key] = self._capture(args)
        return self._replay(cap)

    def lower(self, *args, scratch=None) -> Capture | None:
        """The capture for ``args``, made now if there is none yet, without
        running the function on ``args``: where the key has not run, the
        warm-up runs on ``scratch``, a copy of ``args`` (cloned when not
        given).  None where nothing is captured."""
        if not self.capture:
            return None
        _refuse_cost_counter(self.name)
        key = key_of(args)
        if key not in self._cache:
            if scratch is None:
                scratch = tree_map(lambda x: x.clone()
                                   if isinstance(x, torch.Tensor) else x,
                                   args)
            self._on_capture_stream(scratch)
            self._cache[key] = None
        if self._cache[key] is None:
            self._cache[key] = self._capture(args)
        return self._cache[key]

    def _on_capture_stream(self, args):
        stream = capture_stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            out = self.fn(*args)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        return out

    def _capture(self, args) -> Capture:
        graph = torch.cuda.CUDAGraph()
        before = _counts(self._counters)
        with torch.cuda.graph(graph, stream=capture_stream(self.device),
                              **self._graph_kw):
            out = self.fn(*args)
        deltas = tuple(a - b for a, b in zip(_counts(self._counters),
                                             before))
        # the capture launched nothing
        _add_counts((-d for d in deltas), self._counters)
        return Capture(graph, out, deltas)

    def _replay(self, cap: Capture):
        cap.graph.replay()
        _add_counts(cap.launches, self._counters)
        self.replays += 1
        return cap.out


class InputBuffers:
    """Device buffers for a program's inputs, kept across calls: one set
    per tree structure, shapes and dtypes.  ``bufs(tree)`` copies ``tree``
    (tensors on the program's device) into its set and returns the set, so
    every call with inputs of one shape runs the program on the same
    storages (a broadcast view is copied dense)."""

    def __init__(self):
        self._sets: dict = {}

    def __call__(self, tree: Any) -> Any:
        key = repr(tree_map(lambda x: (tuple(x.shape), x.dtype), tree))
        buf = self._sets.get(key)
        if buf is None:
            buf = self._sets[key] = tree_map(
                lambda x: torch.empty(x.shape, dtype=x.dtype,
                                      device=x.device), tree)
        tree_map(lambda b, x: b.copy_(x), buf, tree)
        return buf


def settle(tree: Any, old_leaves: list) -> Any:
    """Put every tensor of ``tree`` back in the storage it started in:
    ``old_leaves`` are its leaves (``tree_leaves``) before a call that may
    have replaced some; a replaced leaf is copied into its old tensor, which
    takes its place again, in the same dicts and lists.  Returns ``tree``
    (a tuple is rebuilt)."""
    it = iter(old_leaves)

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                t[k] = walk(t[k])
            return t
        if isinstance(t, list):
            t[:] = [walk(v) for v in t]
            return t
        if isinstance(t, tuple):
            return tuple(walk(v) for v in t)
        old = next(it)
        if not isinstance(old, torch.Tensor) or t is old:
            return t
        if not (t.data_ptr() == old.data_ptr() and t.shape == old.shape
                and t.stride() == old.stride()):
            old.copy_(t)
        return old

    return walk(tree)
