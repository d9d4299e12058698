"""The batch-dict FL step: the paper's round over any model family.

Counterpart of the reference's ``launch/steps.py``.  ``train_step`` is the
same round as the simulation trainer's, :func:`repro_torch.core.engine.
round_core` (``FederatedTrainer.round_step`` runs it from tuple batches; a
test holds the two equal), wired to a model over batch dicts:

    local E steps        per-client restart-SGDM (FedDUM Formula 11);
    aggregate            the FedAvg weighted mean over the clients;
    FedDU server update  tau server SGD steps on the shared batch, scaled by
                         tau_eff (Formulas 6-7);
    FedDUM server SGDM   pseudo-gradient momentum (Formulas 8/12).

A batch dict carries whatever the family reads (``tokens``, ``labels``,
``embeds`` + 3-stream ``positions`` + ``loss_mask`` for vlm,
``enc_embeds`` for encdec), so this is the step that trains every family,
the encdec one included (``FederatedTrainer`` feeds tokens and labels
only).  :func:`loss_and_accuracy` fuses the Formula-7 accuracy gate into
the first server gradient's forward.

State between rounds is ``{params, server_m, [masks], [filter_masks],
[client_state], round}``; clients are stateless.  With ``use_masks`` the
FedAP keep-masks ride in the state, and :func:`with_masks` injects a
decision into the live state: every state tensor keeps its storage and
shape.  The state is updated in place, as ``round_core`` updates it.

Where the reference's callers jit ``train_step``, the port runs it as one
``core.programs.Program`` (:class:`TrainStep`): the batch is copied into
input buffers kept per shapes, and on the card the first round on a state
runs eagerly, the second is captured as a CUDA graph and later rounds of
the same shapes replay it.

``fl_batch_specs`` builds the (arch x shape) train batch over C clients:
meta-device tensors, or seeded arrays equal to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core import programs
from repro_torch.core.engine import (
    EngineConfig,
    FedDynConfig,
    FedProxConfig,
    build_model_fns,
    init_round_state,
    round_core,
)
from repro_torch.core.momentum import FedDUMConfig
from repro_torch.core.server_update import FedDUConfig
from repro_torch.models.api import build_model, input_specs
from repro_torch.models.lm import loss_and_acc_of
from repro_torch.utils.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class FLRunConfig:
    lr: float = 1e-3              # eta' (local) and eta (server SGD)
    beta_local: float = 0.9       # FedDUM Formula 11
    beta_server: float = 0.9      # FedDUM Formula 8
    eta_server: float = 1.0
    local_steps: int = 1          # local iterations per round (E*n_k/B)
    server_tau: int = 1           # server iterations per round
    server_batch: int = 32
    feddu: FedDUConfig = dataclasses.field(default_factory=FedDUConfig)
    use_server_update: bool = True
    use_momentum: bool = True
    # FedAP keep-masks ride in the round state: a prune changes their
    # contents only (with_masks).
    use_masks: bool = False
    # "kernel" also threads filter masks into the model, so masked FFN
    # products run the masked_matmul kernels forward and backward;
    # "params" masks the tree only.
    masked_compute: str = "params"
    algorithm: str = "fedavg"     # fedavg | fedprox | feddyn
    guard: str = "off"            # off | reject_client | skip_round
    fedprox: FedProxConfig = dataclasses.field(default_factory=FedProxConfig)
    feddyn: FedDynConfig = dataclasses.field(default_factory=FedDynConfig)


def token_accuracy(model, params, batch) -> torch.Tensor:
    logits = model.apply(params, batch)
    ok = (logits.argmax(-1) == batch["labels"]).float()
    mask = batch.get("loss_mask")
    if mask is not None:
        return (ok * mask).sum() / mask.sum().clamp_min(1.0)
    return ok.mean()


def loss_and_accuracy(model, params, batch, masks=None):
    """(loss, token accuracy) from one forward: the Formula-7 accuracy gate
    fused into the first server gradient.  ``model.apply_with_aux(params,
    batch[, masks=])`` gives (logits, aux or None); ``masks``
    (masked_compute="kernel" only) goes to it, None keeps the plain call."""
    if masks is None:
        logits, aux = model.apply_with_aux(params, batch)
    else:
        logits, aux = model.apply_with_aux(params, batch, masks=masks)
    return loss_and_acc_of(logits, aux, batch)


def engine_config(run: FLRunConfig) -> EngineConfig:
    """The FLRunConfig -> EngineConfig wiring (held against the simulation
    trainer's FLConfig wiring by the port's tests)."""
    return EngineConfig(
        lr=run.lr, lr_decay=1.0,
        use_server_update=run.use_server_update,
        local_momentum="restart" if run.use_momentum else "none",
        server_momentum=run.use_momentum,
        use_masks=run.use_masks,
        masked_compute=run.masked_compute,
        algorithm=run.algorithm,
        guard=run.guard,
        fedprox=run.fedprox,
        feddyn=run.feddyn,
        feddu=run.feddu,
        feddum=FedDUMConfig(beta_server=run.beta_server,
                            beta_local=run.beta_local,
                            eta_server=run.eta_server))


def make_fl_train_step(cfg: ModelConfig, run: FLRunConfig, num_clients: int,
                       *, model: Any = None, device="cuda"):
    """Returns ``(init_state(generator, filter_masks=None), train_step(state,
    batch) -> (state, tau_eff))``.

    ``model`` overrides ``build_model(cfg, device=device)`` (anything with
    ``init(generator)``, ``loss(params, batch[, masks=])`` and
    ``apply_with_aux(params, batch[, masks=])``).  ``init_state`` draws the
    params from the generator; in kernel mode it needs the model's all-ones
    ``filter_masks``.  ``train_step`` updates ``state`` in place.

    batch:
      client  pytree with leading [C, steps, ...] dims
      server  pytree with leading [tau, ...] dim
      sizes   [C] f32 n_k
      d_round, d_server: 0-d f32 (non-IID degrees, Formula 2)
      n0      0-d f32
      sel     [C] int (FedDyn only: the clients' slots in client_state)
    """
    model = build_model(cfg, device=device) if model is None else model
    eng = engine_config(run)

    def loss_fn(p, b, fm):
        if fm is None:
            return model.loss(p, b)
        return model.loss(p, b, masks=fm)

    def la_base(p, b, fm):
        return loss_and_accuracy(model, p, b, masks=fm)

    grad_fn, la_fn = build_model_fns(eng, loss_fn, la_base)

    def init_state(generator: torch.Generator, filter_masks=None) -> dict:
        return init_round_state(model.init(generator), eng,
                                filter_masks=filter_masks,
                                num_clients=num_clients)

    return init_state, TrainStep(eng, grad_fn, la_fn)


class TrainStep:
    """``train_step(state, batch) -> (state, tau_eff)``: one ``round_core``
    on ``state`` (in place) through the step program :attr:`program` (a
    CUDA graph per state and batch shapes on the card, keys counted on the
    CPU), made at the first call on the device of the state's tensors;
    ``tau_eff`` is a tensor of its own.  :meth:`body` is the program's
    eager body (what ``launch.dryrun`` counts)."""

    def __init__(self, eng: EngineConfig, grad_fn, la_fn):
        self.eng, self.grad_fn, self.la_fn = eng, grad_fn, la_fn
        self._inputs = programs.InputBuffers()
        self.program = None

    def body(self, state: dict, batch: dict) -> dict:
        """One ``round_core`` with every state tensor left in the storage it
        started in; returns the round's metrics."""
        old = tree_leaves(state)
        _, met = round_core(self.eng, self.grad_fn, self.la_fn, state, batch)
        programs.settle(state, old)
        return met

    def __call__(self, state: dict, batch: dict):
        if self.program is None:
            self.program = programs.Program(
                self.body, name="fl_step",
                device=tree_leaves(state["params"])[0].device)
        met = self.program(state, self._inputs(batch))
        return state, met["tau_eff"].clone()


def with_masks(state: dict, masks: Any, filter_masks: Any = None) -> dict:
    """Inject FedAP keep-masks into a running masked round state, in place
    (the batch-dict analogue of ``Prune(mode="mask")``): momentum and
    client state restart, params are masked, and every state tensor keeps
    its storage and shape.  ``filter_masks`` swaps the kernel mode's filter
    masks too (required when the state has a ``filter_masks`` slot)."""
    from repro_torch.core.backend import masked_round_state

    if "masks" not in state:
        raise ValueError("state has no mask slot — build the step with "
                         "FLRunConfig(use_masks=True)")
    if "filter_masks" in state and filter_masks is None:
        raise ValueError(
            "state carries a filter_masks slot (masked_compute='kernel') — "
            "pass filter_masks=model.filter_masks(...) so the kernel path "
            "prunes the same filters the param masks zero")
    if filter_masks is not None and "filter_masks" not in state:
        raise ValueError(
            "filter_masks given but the state has no filter_masks slot — "
            "build the step with FLRunConfig(masked_compute='kernel')")
    return masked_round_state(state, masks, filter_masks=filter_masks)


def make_prefill_step(cfg: ModelConfig, *, device="cuda"):
    """``(model, prefill_step(params, batch) -> next-token logits [B, V])``."""
    model = build_model(cfg, device=device)

    def prefill_step(params, batch):
        return model.apply(params, batch)[:, -1, :]

    return model, prefill_step


def make_decode_step(cfg: ModelConfig, *, device="cuda"):
    """``(model, decode_step(params, cache, batch) -> (logits, cache))``."""
    model = build_model(cfg, device=device)

    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch)

    return model, decode_step


# ---------------------------------------------------------------------------
# FL batch construction for (arch x shape)
# ---------------------------------------------------------------------------

def fl_batch_specs(cfg: ModelConfig, shape: InputShape, num_clients: int,
                   run: FLRunConfig, *, abstract: bool = True, seed: int = 0,
                   device="cuda"):
    """The train-shape batch: the global batch split over C clients, the
    server batch alongside (tau leading dim).  Concrete leaves broadcast one
    draw over the repeated dims (views, as the reference's
    ``broadcast_to``)."""
    c = num_clients
    b_c = max(1, shape.global_batch // c)
    base = input_specs(cfg, shape, abstract=abstract, seed=seed,
                       device=device)
    dev = torch.device("meta") if abstract else next(iter(base.values())).device

    def reshard_client(leaf):
        # [B, ...] -> [C, steps, b_c, ...]
        shp = (c, run.local_steps, b_c) + tuple(leaf.shape[1:])
        return leaf[: c * b_c].reshape((c, 1, b_c) + tuple(leaf.shape[1:])) \
            .expand(shp)

    def reshard_positions(leaf):
        # [P, B, S] -> [C, steps, P, b_c, S]
        p = leaf.shape[0]
        shp = (c, run.local_steps, p, b_c) + tuple(leaf.shape[2:])
        tiled = leaf[:, : c * b_c].reshape((p, c, b_c) + tuple(
            leaf.shape[2:])).transpose(0, 1)[:, None]
        return tiled.expand(shp)

    client = {k: reshard_positions(v) if k == "positions"
              else reshard_client(v) for k, v in base.items()}
    server_base = input_specs(cfg, dataclasses.replace(
        shape, global_batch=run.server_batch), abstract=abstract,
        seed=seed + 1, device=device)
    server = {k: v.expand((run.server_tau,) + tuple(v.shape))
              for k, v in server_base.items()}

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    batch = {
        "client": client,
        "server": server,
        "sizes": torch.ones((c,), dtype=torch.float32, device=dev),
        "d_round": scalar(0.3),
        "d_server": scalar(0.01),
        "n0": scalar(2048.0),
    }
    if run.algorithm == "feddyn":
        # full participation: client k <- slot k of client_state
        batch["sel"] = torch.arange(c, dtype=torch.int32, device=dev)
    return batch
