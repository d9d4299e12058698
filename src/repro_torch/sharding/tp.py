"""Tensor parallelism over the ``model`` mesh axis: the collectives that
the reference's GSPMD partitioner inserts, made explicit.

A :class:`TPGroup` (process group, rank, size) carries them; each is a
``torch.autograd.Function`` where a gradient crosses it:

  to_model         identity forward, all-reduce backward: the input of a
                   column-parallel product (q/k/v, the FFN's up/gate, the
                   vocab head), and a replicated weight read by a rank's
                   part of the work only (K/V where the kv heads stay whole);
  from_model       all-reduce forward, identity backward: after a
                   row-parallel product (attention's and the FFN's ``wo``);
  vocab_embed      the rank's rows of the embedding table, zero for a token
                   outside them, all-reduced;
  vocab_cross_entropy  the next-token loss from the rank's vocab columns:
                   all-reduces of the row max, the sum of exponentials and
                   the target logit;
  vocab_argmax     the global argmax, ties to the lowest index (as
                   ``torch.argmax`` and ``jnp.argmax`` break them);
  gather_model     the whole ``[..., V]`` logits, for the serve steps that
                   return them;
  all_true         a 0-d verdict true on every rank (the guard's).

A group of one rank runs each collective (a copy) and the loss and argmax
of the unsharded model, so a world of one is bitwise the unsharded steps.
:class:`RecordingGroup` stands in for a group that is not there: its
collectives move nothing, and each is recorded and reported to the active
``launch.cost.CostCounter`` (the dry run counts one rank's step with it).
:class:`TPLayout` says which of a model's dims the ``model`` axis splits.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.kernels import ops as _ops

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class TPGroup:
    """The ranks of one mesh axis: ``group`` (a process group; None: the
    default one), this rank's index in it and its size."""

    def __init__(self, group=None, rank: int = 0, size: int = 1):
        self.group, self.rank, self.size = group, rank, size

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks, in place; returns it."""
        dist.all_reduce(t, op=_OPS[op], group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` joined along ``dim`` in rank order."""
        from repro_torch.launch.mesh import all_gather

        part = t.movedim(dim, 0).contiguous()
        out = part.new_empty((self.size * part.shape[0],) + part.shape[1:])
        all_gather(out, part, group=self.group)
        return out.movedim(0, dim)


class RecordingGroup(TPGroup):
    """A group of ``size`` ranks that is not there: ``all_reduce`` leaves
    its input as it is (this rank's part), ``all_gather`` repeats it
    ``size`` times.  Each call of a group of more than one rank is kept in
    :attr:`calls` as ``(kind, input bytes)`` and reported to the active
    cost counter (a group of one moves nothing)."""

    def __init__(self, rank: int = 0, size: int = 1):
        super().__init__(None, rank, size)
        self.calls: list = []

    def _note(self, kind: str, t: torch.Tensor) -> None:
        if self.size == 1:
            return
        nbytes = t.numel() * t.element_size()
        self.calls.append((kind, nbytes))
        if _ops.counter is not None:
            _ops.counter.collective(kind, nbytes, self.size)

    def all_reduce(self, t, op="sum"):
        self._note("all-reduce", t)
        return t

    def all_gather(self, t, dim=0):
        self._note("all-gather", t)
        return torch.cat([t] * self.size, dim)


class ThreadGroup(TPGroup):
    """Rank ``rank`` of ``size`` ranks run as threads of one process, that
    meet at each collective (a check's stand-in for a process group: one
    card holds every rank).  Build the ranks with :meth:`ranks`.  Forward
    only on the card: a collective inside a backward would block the
    device's one autograd thread."""

    def __init__(self, shared, rank: int):
        super().__init__(None, rank, shared["size"])
        self._shared = shared

    @classmethod
    def ranks(cls, size: int) -> list:
        import threading

        shared = {"size": size, "slots": [None] * size,
                  "barrier": threading.Barrier(size)}
        return [cls(shared, r) for r in range(size)]

    def _meet(self, t):
        sh = self._shared
        sh["slots"][self.rank] = t
        sh["barrier"].wait()
        parts = list(sh["slots"])
        sh["barrier"].wait()
        return parts

    def all_reduce(self, t, op="sum"):
        parts = self._meet(t.clone())
        fn = {"sum": torch.add, "max": torch.maximum,
              "min": torch.minimum}[op]
        acc = parts[0]
        for p in parts[1:]:
            acc = fn(acc, p)
        return t.copy_(acc)

    def all_gather(self, t, dim=0):
        return torch.cat(self._meet(t), dim)

    @staticmethod
    def run(fns: list) -> list:
        """Each rank's ``fns[r]()`` on a thread of its own; their results in
        rank order (a rank's exception raised here)."""
        import threading

        out, errs = [None] * len(fns), []

        def one(r):
            try:
                out[r] = fns[r]()
            except Exception as e:  # noqa: BLE001 — raised by run()
                errs.append(e)

        threads = [threading.Thread(target=one, args=(r,))
                   for r in range(len(fns))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        if errs:
            raise errs[0]
        if any(th.is_alive() for th in threads):
            raise TimeoutError("a rank's thread did not finish")
        return out


def group_of(mesh, axes: tuple) -> TPGroup:
    """The group of this rank along ``axes`` of ``mesh``: a
    :class:`TPGroup` over a ``DeviceMesh``'s process group (one axis), or
    a :class:`RecordingGroup` at rank 0 for a mesh known only by its shape
    (the dry run's)."""
    from repro_torch.sharding.specs import axis_sizes, mesh_coords

    sizes, coords = axis_sizes(mesh), mesh_coords(mesh)
    rank, size = 0, 1
    for a in axes:
        rank, size = rank * sizes[a] + coords[a], size * sizes[a]
    if not hasattr(mesh, "get_group"):
        return RecordingGroup(rank, size)
    if len(axes) != 1:
        raise ValueError(f"a group over the mesh axes {axes} of sizes "
                         f"{[sizes[a] for a in axes]}: one axis at a time "
                         f"(ROADMAP queue 1)")
    from repro_torch.launch.mesh import axis_group

    return TPGroup(axis_group(mesh, axes[0]), rank, size)


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """Which of a dense model's dims the ``model`` axis splits, over
    ``group``: query ``heads`` (and the ``kv`` heads with them, else K/V
    stay whole on every rank), the FFN's ``mlp`` units and the ``vocab``
    rows of the embedding (columns of the head), this rank's starting at
    ``vocab_start``.  ``kv_heads``: the kv heads a rank holds."""

    group: TPGroup
    heads: bool
    kv: bool
    mlp: bool
    vocab: bool
    vocab_start: int
    kv_heads: int


# ---------------------------------------------------------------------------
# the collectives with their gradients
# ---------------------------------------------------------------------------

class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(
            g.clone(memory_format=torch.contiguous_format)), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_model(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the ranks."""
    return _ToModel.apply(x, group)


def from_model(x: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """The ranks' parts ``x`` summed; the gradient passed to each as it
    is."""
    return _FromModel.apply(x, group)


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor,
                layout: TPLayout) -> torch.Tensor:
    """Rows ``tokens`` of the embedding, from the rank's block of rows
    ``table`` [V / ranks, d] (starting at ``layout.vocab_start``): its own
    rows, zeros for the others' tokens, summed over the ranks."""
    lo, rows = layout.vocab_start, table.shape[0]
    local = tokens.long() - lo
    inside = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)]
    return from_model(torch.where(inside[..., None], x, 0.0).to(x.dtype),
                      layout.group)


def vocab_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                        layout: TPLayout) -> torch.Tensor:
    """The next-token loss ``-log softmax(logits)[label]`` per position, in
    f32, from the rank's vocab columns ``logits`` [..., V / ranks]: the
    row max, the sum of exponentials and the label's logit all-reduced.  A
    group of one computes the unsharded ``log_softmax``."""
    group = layout.group
    lf = logits.float()
    labels = labels.long()
    if group.size == 1:
        logp = torch.log_softmax(lf, dim=-1)
        return -torch.gather(logp, -1, labels[..., None])[..., 0]
    m = group.all_reduce(lf.detach().amax(-1), "max")
    se = from_model(torch.exp(lf - m[..., None]).sum(-1), group)
    local = labels - layout.vocab_start
    inside = (local >= 0) & (local < lf.shape[-1])
    tgt = torch.gather(lf, -1, local.clamp(0, lf.shape[-1] - 1)[..., None])
    tgt = from_model(torch.where(inside, tgt[..., 0], 0.0), group)
    return torch.log(se) + m - tgt


def vocab_argmax(logits: torch.Tensor, layout: TPLayout) -> torch.Tensor:
    """The argmax over the whole vocabulary of the rank's columns
    ``logits`` [..., V / ranks]: the largest value over the ranks, and the
    lowest global index holding it."""
    group = layout.group
    i = logits.argmax(-1)
    if group.size == 1:
        return i
    v = torch.gather(logits, -1, i[..., None])[..., 0].float()
    best = group.all_reduce(v.clone(), "max")
    big = torch.iinfo(torch.int64).max
    cand = torch.where(v == best, i + layout.vocab_start, big)
    return group.all_reduce(cand, "min")


def gather_model(logits: torch.Tensor, layout: TPLayout) -> torch.Tensor:
    """The whole ``[..., V]`` logits from the ranks' columns."""
    return layout.group.all_gather(logits, logits.dim() - 1)


def all_true(ok: torch.Tensor, group: TPGroup) -> torch.Tensor:
    """A 0-d bool, true iff ``ok`` is true on every rank."""
    return group.all_reduce(ok.to(torch.float32).reshape(1), "min")[0] > 0


def packed_all_reduce(tensors: list, group: TPGroup, buckets: dict) -> int:
    """Each tensor summed over ``group``, in place: per dtype, the tensors
    packed into one flat buffer (kept in ``buckets`` per dtype and sizes,
    so a captured program addresses the same one every replay), one
    all-reduce on it, each tensor copied back out.  Returns the number of
    all-reduces."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
        sizes = tuple(t.numel() for t in ts)
        flat = buckets.get((dtype, sizes))
        if flat is None:
            flat = buckets[(dtype, sizes)] = torch.empty(
                sum(sizes), dtype=dtype, device=ts[0].device)
        torch.cat([t.reshape(-1) for t in ts], out=flat)
        group.all_reduce(flat)
        for t, part in zip(ts, flat.split(sizes)):
            t.copy_(part.view(t.shape))
    return len(by_dtype)
