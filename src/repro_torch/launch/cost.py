"""A step's work, counted from the operations it runs: the port's
counterpart of the reference's ``launch/hlo_cost.py``.

The reference counts a lowered XLA program; the port runs eagerly, so
:class:`CostCounter` is a ``TorchDispatchMode`` that sees every aten and
c10d operation a step dispatches (under autograd, so a backward's products
too) and totals, in the reference's ``CostTotals`` shape:

  * product FLOPs  — ``mm``/``addmm``/``bmm``/``baddbmm`` (``einsum`` and
                     ``matmul`` reach these), ``mv``/``dot``,
                     ``convolution`` and its backward, and scaled-dot-product
                     attention: 2 flops per multiply-add;
  * eager bytes    — the inputs plus the outputs of every operation that is
                     not a view (an in-place one reads and writes its
                     operand once each, an indexed write such as
                     ``index_copy_`` only the rows it writes; allocations
                     of uninitialised memory count nothing): each op of an
                     eager step reads its inputs from device memory and
                     writes its outputs back;
  * collectives    — counts and input bytes per kind (``all-reduce``,
                     ``all-gather``, ...), from the ``c10d`` operations, or
                     reported by a ``sharding.tp.RecordingGroup``, which
                     also adds the bytes each rank puts on the wire over
                     its group's size (``collective_wire``);
  * kernels        — each hand-written kernel's calls, FLOPs and bytes, by
                     name, from its wrapper's ``work(...)``: the kernels
                     launch through ctypes, where the dispatcher cannot see
                     them, so ``kernels.ops`` reports them, and the
                     operations inside a kernel's call (its plain version
                     on the CPU) are not counted again.

``flops`` and ``bytes`` are the products' and the operations' plus the
kernels'.  The same step counts the same on the CPU, on the card and on the
meta device (shapes only, no data: ``LM.on_meta``), so a full-size step is
counted without memory.  ``CostCounter(record=True)`` also keeps every
operation's name and dtypes in order (``analysis.op_lint`` reads them).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops as _ops

_aten = torch.ops.aten

# aten ops whose result has 2 * out.numel() * K flops (K: the contraction)
_PRODUCTS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default, _aten.mv.default, _aten.dot.default}
_SDPA = ("_scaled_dot_product_flash_attention",
         "_scaled_dot_product_efficient_attention",
         "_scaled_dot_product_cudnn_attention",
         "_scaled_dot_product_flash_attention_for_cpu",
         "_scaled_dot_product_attention_math")
# reads of a device value on the host (a sync inside a step)
HOST_READS = ("aten._local_scalar_dense", "aten.is_nonzero", "aten.nonzero",
              "aten.equal")
# c10d op name stem -> the reference's collective kind
_COLLECTIVES = {"allreduce": "all-reduce", "allgather": "all-gather",
                "reduce_scatter": "reduce-scatter", "alltoall": "all-to-all",
                "broadcast": "broadcast", "send": "collective-permute",
                "recv": "collective-permute"}
# in-place writes of indexed rows: the target is touched only there
_INDEXED = ("index_copy_", "index_put_", "_index_put_impl_", "index_add_",
            "scatter_", "scatter_add_", "scatter_reduce_", "masked_scatter_")
# no data moved: allocations of uninitialised memory, a view not marked one
_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view")
# ring factors: bytes each rank puts on the wire per input byte over n ranks
_RING = {"all-reduce": lambda n: 2.0 * (n - 1) / n,
         "all-gather": lambda n: (n - 1) / n,
         "reduce-scatter": lambda n: (n - 1) / n,
         "all-to-all": lambda n: (n - 1) / n}


@dataclasses.dataclass
class CostTotals:
    """A step's counts (the reference's ``CostTotals`` plus the kernels)."""

    product_flops: float = 0.0
    op_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_counts: dict = dataclasses.field(default_factory=dict)
    collective_wire: float = 0.0
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    kernel_flops: dict = dataclasses.field(default_factory=dict)
    kernel_bytes: dict = dataclasses.field(default_factory=dict)

    @property
    def flops(self) -> float:
        return self.product_flops + sum(self.kernel_flops.values())

    @property
    def bytes(self) -> float:
        return self.op_bytes + sum(self.kernel_bytes.values())

    def wire_bytes(self, ranks: int) -> float:
        """Bytes each rank sends for the collectives over ``ranks`` ranks,
        with the ring factors of ``launch/hlo_analysis.py``."""
        if ranks <= 1:
            return 0.0
        return sum(v * _RING.get(k, lambda n: 1.0)(ranks)
                   for k, v in self.collective_bytes.items())

    def as_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "product_flops": self.product_flops,
                "op_bytes": self.op_bytes,
                "collective_counts": dict(self.collective_counts),
                "collective_bytes": dict(self.collective_bytes),
                "collective_wire_bytes_per_device": self.collective_wire,
                "kernel_work": {k: {"calls": self.kernel_calls[k],
                                    "flops": self.kernel_flops[k],
                                    "bytes": self.kernel_bytes[k]}
                                for k in sorted(self.kernel_calls)}}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _numel(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _product_flops(func, args, out) -> float:
    if func in _PRODUCTS:
        a = args[1] if func in (_aten.addmm.default,
                                _aten.baddbmm.default) else args[0]
        return 2.0 * _numel(out) * a.shape[-1]
    name = func._schema.name.split("::")[-1]
    if name == "convolution":
        w = args[1]
        return 2.0 * _numel(out) * (w.numel() // w.shape[0])
    if name == "convolution_backward":
        grad_out, w, mask = args[0], args[2], args[10]
        per = 2.0 * grad_out.numel() * (w.numel() // w.shape[0])
        return per * (int(mask[0]) + int(mask[1]))
    if name in _SDPA:
        q, k = args[0], args[1]         # [B, H, Sq, hd], [B, H, Skv, hd]
        return 4.0 * q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2] \
            * q.shape[3]
    return 0.0


_COMPOSITE: dict = {}


def _composite(func) -> bool:
    """Whether ``func`` has a CompositeImplicitAutograd decomposition."""
    have = _COMPOSITE.get(func)
    if have is None:
        have = _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
    return have


class CostCounter(TorchDispatchMode):
    """Counts the work of what runs under it (see the module docstring);
    ``totals`` holds the counts, ``ops`` (with ``record=True``) each
    operation's ``(name, dtypes)`` in order, a kernel's call as
    ``("kernel:<name>", ())``."""

    def __init__(self, *, record: bool = False):
        super().__init__()
        self.totals = CostTotals()
        self.record = record
        self.ops: list = []
        self._quiet = 0
        self._outer = None
        self._depth = 0     # re-entered to decompose composite ops

    def __enter__(self):
        if not self._depth:
            self._outer, _ops.counter = _ops.counter, self
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            _ops.counter = self._outer
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def kernel(self, name: str, flops: float, nbytes: float):
        """One call of a hand-written kernel: its work from its formula;
        the operations inside the call are not counted."""
        if not self._quiet:
            t = self.totals
            t.kernel_calls[name] = t.kernel_calls.get(name, 0) + 1
            t.kernel_flops[name] = t.kernel_flops.get(name, 0.0) + flops
            t.kernel_bytes[name] = t.kernel_bytes.get(name, 0.0) + nbytes
            if self.record:
                self.ops.append((f"kernel:{name}", ()))
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def collective(self, kind: str, nbytes: float, ranks: int) -> None:
        """One collective that no ``c10d`` operation ran (a recording
        group's): ``nbytes`` of input over a group of ``ranks``."""
        t = self.totals
        t.collective_counts[kind] = t.collective_counts.get(kind, 0) + 1
        t.collective_bytes[kind] = t.collective_bytes.get(kind, 0.0) + nbytes
        if ranks > 1:
            t.collective_wire += nbytes * _RING.get(kind,
                                                    lambda n: 1.0)(ranks)
        if self.record:
            self.ops.append((f"collective:{kind}", ()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # under inference_mode a composite op (matmul, reshape, einsum)
            # arrives whole: count the ops it decomposes into, as autograd
            # decomposes it everywhere else
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if not self._quiet:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        t = self.totals
        ns, _, stem = func._schema.name.partition("::")
        if self.record:
            dtypes = {str(x.dtype).replace("torch.", "")
                      for x in _tensors((args, kwargs, out))}
            self.ops.append((f"{ns}.{stem}", tuple(sorted(dtypes))))
        if ns == "c10d":
            kind = next((v for k, v in _COLLECTIVES.items()
                         if stem.lstrip("_").startswith(k)), stem)
            inputs = args[1] if kind == "all-gather" else args[0]
            t.collective_counts[kind] = t.collective_counts.get(kind, 0) + 1
            t.collective_bytes[kind] = (t.collective_bytes.get(kind, 0.0)
                                        + _nbytes(inputs))
            return
        t.product_flops += _product_flops(func, args, out)
        if func.is_view or stem in _FREE:
            return
        if stem in _INDEXED:    # indices and rows read, the rows written
            t.op_bytes += _nbytes(args[1:]) + max(
                (_nbytes(a) for a in args[1:]), default=0)
            return
        t.op_bytes += _nbytes((args, kwargs)) + _nbytes(out)

