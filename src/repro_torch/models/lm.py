"""The decoder LM, functional: params are dicts of tensors.

Counterpart of the reference's ``models/lm.py`` for its six families:

* ``dense`` (llama-style decoder: GQA + RoPE 1d/2d + SwiGLU or GELU MLP):
  the full-sequence forward, loss and token accuracy that federated
  training differentiates and scoring evaluates, the decode step and the
  KV cache of serving;
* ``moe`` (arctic-480b with a dense residual FFN, llama4 with a shared
  expert; top-1/2 token-choice routing): the dense family's attention with
  :func:`layers.apply_moe` for the FFN, whose ``load_balance + router_z``
  auxiliary loss every loss adds, as the reference's does;
* ``hybrid`` (zamba2: a Mamba2 backbone with one shared attention block
  applied before each group of ``attn_every`` layers): the full-sequence
  forward, loss and token accuracy, and the decode step over a per-layer
  Mamba2 conv/SSM state and one KV cache per shared-attention application;
* ``ssm`` (xlstm: mLSTM blocks with an sLSTM block every ``slstm_every``-th
  layer, unrolled): the full-sequence forward, loss and token accuracy, and
  the decode step over each layer's recurrent state;
* ``vlm`` (qwen2-vl: the dense family's stack with M-RoPE, whose input is
  ``batch["embeds"]`` [B,S,d] in place of tokens, with 3-stream
  ``batch["positions"]`` [3,B,S]): everything the dense family does;
* ``encdec`` (whisper: a bidirectional encoder over ``batch["enc_embeds"]``
  [B,F,d] plus learned ``enc_pos``, and a causal decoder whose blocks
  cross-attend the encoder's output; both unrolled): the full-sequence
  forward and loss, and decode over a self-attention KV cache and the
  fixed cross K/V that :meth:`LM.prefill_cross` writes once.

Any family takes ``embeds`` in place of tokens and ``positions`` in place of
the default ``arange``, as the reference's do.  The FedAP unit-pruning seam
serves the dense, vlm and hybrid families (the ``ssm`` family has no FFN
stack, the ``moe`` family prunes whole experts,
:func:`repro_torch.core.pruning_lm.fedap_lm`, and the ``encdec`` family's
blocks are not stacked: each refuses it, as the reference does).  Dense,
moe, vlm and hybrid layer params are stacked along a leading ``[L, ...]``
axis as in the reference, so a JAX param tree converts leaf for leaf
(:mod:`repro_torch.interop`).

Params: ``{"embed" [V,d], "unembed" [d,V] (untied only), "norm_out",
"layers": {...}}`` with ``layers = {"attn": {wq, wk, wv, wo}, "norm_a",
"norm_f", "mlp": {wi, wg, wo}}`` (dense; moe holds ``"moe": {router, wi,
wg, wo, [dense], [shared]}`` in place of ``"mlp"``) or ``{"mamba": {in_proj, conv,
A_log, D, dt_bias, norm_scale, out_proj}, "norm_m", "norm_f", "mlp"}`` plus
``"shared_attn": {"attn", "norm"}`` (hybrid); the ssm family holds
``"blocks": {"l<i>": {"cell", "norm"}}`` instead of ``"layers"``, with an
mLSTM cell ``{up, wq, wk, wv, w_if, norm_scale, down}`` or an sLSTM cell
``{w_x, w_h, bias, down}``; the encdec family holds ``"enc_pos" [F,d]``,
``"norm_enc"``, ``"encoder": {"l<i>": {attn, norm_a, mlp, norm_f}}`` and
``"decoder": {"l<i>": {attn, norm_a, xattn, norm_x, mlp, norm_f}}``.

``attn_impl="pallas"`` sends full-sequence attention through the
``flash_attention`` kernel (K4) and the Mamba2 scan through ``ssd_scan``
(K6), both forward only: it scores and evaluates.  ``"xla"`` (the default,
as in the reference) runs their plain, differentiable forms, which is what
training uses.  The ssm family reaches no kernel: its products are plain
matmuls, as in the reference.  Nor does the encdec encoder: its
bidirectional attention is the plain one for either ``attn_impl``, as the
reference's is; the decoder's self- and cross-attention run K4 (causal, and
without the mask at Sq != Skv) under ``"pallas"``.
"""
from __future__ import annotations

import copy
import functools
import math

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import device as _device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.sharding import tp as TP
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "encdec")
REMAT = ("none", "block", "dots")

# remat="dots": the 2-D products (a projection of [B,S,d] activations folds
# into one ``aten.mm``) are saved; everything else in the block, the
# attention's batched products (``aten.bmm``) and every elementwise op, is
# recomputed in the backward.  The counterpart of JAX's
# ``dots_with_no_batch_dims_saveable``.
_SAVED_PRODUCTS = frozenset((torch.ops.aten.mm.default,
                             torch.ops.aten.addmm.default))


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the 2-D products, except inside ``ops.MaskedMatmul``'s forward:
    the masked product (K1) is recomputed, as the reference's policy
    recomputes its ``pallas_call``, which is no ``dot_general``.  On the card
    K1 is a launch the dispatcher never sees; on the CPU its plain version's
    ``aten.mm`` follows the same rule."""
    if op in _SAVED_PRODUCTS and not ops.inside_masked_matmul():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_dots_context = functools.partial(create_selective_checkpoint_contexts,
                                  _dots_policy)

# Logical axis names of each param leaf, by the module that holds it (the
# reference's ``init_*`` axes trees, which its ``sharding/specs.py`` reads).
_ATTN_AXES = {"wq": ("embed", "heads", "head_dim"),
              "wk": ("embed", "kv_heads", "head_dim"),
              "wv": ("embed", "kv_heads", "head_dim"),
              "wo": ("heads", "head_dim", "embed")}
_MLP_AXES = {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
             "wo": ("mlp", "embed")}
_LEAF_AXES = {
    "attn": _ATTN_AXES, "xattn": _ATTN_AXES, "mlp": _MLP_AXES,
    "dense": _MLP_AXES, "shared": _MLP_AXES,
    "moe": {"router": ("embed", None),
            "wi": ("experts", "embed", "expert_mlp"),
            "wg": ("experts", "embed", "expert_mlp"),
            "wo": ("experts", "expert_mlp", "embed")},
    "mamba": {"in_proj": ("embed", "ssm_inner"), "conv": (None, "ssm_inner"),
              "A_log": (None,), "D": (None,), "dt_bias": (None,),
              "norm_scale": ("ssm_inner",), "out_proj": ("ssm_inner", "embed")},
    "mlstm": {"up": ("embed", "mlp"), "wq": ("mlp", "heads", "head_dim"),
              "wk": ("mlp", "heads", "head_dim"),
              "wv": ("mlp", "heads", "head_dim"), "w_if": ("mlp", None),
              "norm_scale": ("mlp",), "down": ("mlp", "embed")},
    "slstm": {"w_x": ("embed", "mlp"), "w_h": ("embed", "mlp"),
              "bias": (None,), "down": ("embed", "embed")},
    "norm": {"scale": ("embed",), "bias": ("embed",)},
    "top": {"embed": ("vocab", "embed"), "unembed": ("embed", "vocab"),
            "enc_pos": (None, "embed")},
}


def _axes_of(tree, module="top", lead=()):
    """The logical-axis tree of a param (sub)tree held by ``module``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            if k.startswith("norm"):
                sub = "norm"
            elif k == "cell":
                sub = "slstm" if "w_x" in v else "mlstm"
            elif k in _LEAF_AXES:
                sub = k
            else:           # containers: layers, encoder/decoder, l<i>, ...
                sub = module
            out[k] = _axes_of(v, sub, lead + (("layers",) if k == "layers"
                                              else ()))
        else:
            table = _LEAF_AXES["norm" if module == "top" and k.startswith(
                "norm") else module]
            out[k] = lead + table[k]
    return out


def _unstack(stacked) -> list:
    """The per-layer trees of a stacked ``[L, ...]`` tree, as views (one
    ``unbind`` per leaf, whose backward stacks the layers' gradients)."""
    leaves = [t.unbind(0) for t in tree_leaves(stacked)]
    return [tree_unflatten(stacked, [leaf[i] for leaf in leaves])
            for i in range(len(leaves[0]))]


def argmax_of(logits, tp=None):
    """The argmax over the vocabulary of ``logits`` [..., V], or, under a
    ``tp`` layout that splits the vocab, of a rank's columns of them
    (:func:`sharding.tp.vocab_argmax`)."""
    if tp is not None and tp.vocab:
        return TP.vocab_argmax(logits, tp)
    return logits.argmax(-1)


def loss_and_acc_of(logits, aux, batch, tp=None, *, with_acc: bool = True):
    """(mean next-token cross-entropy + ``aux``, token accuracy) of
    ``logits`` [B,S,V] against ``batch["labels"]`` [B,S], over
    ``batch["loss_mask"]`` when given (log-softmax in f32); ``aux`` None adds
    nothing.  The one loss of every LM entry point (``LM.loss``,
    ``LM.loss_and_acc``, ``launch.steps.loss_and_accuracy``).  ``tp``: the
    logits are a rank's vocab columns (``sharding.tp``'s vocab-parallel loss
    and argmax); ``with_acc=False`` returns None for the accuracy."""
    labels = batch["labels"].long()
    if tp is not None and tp.vocab:
        nll = TP.vocab_cross_entropy(logits, labels, tp)
    else:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    if mask is None:
        loss = nll.sum() / nll.numel()
    else:
        denom = mask.sum().clamp_min(1.0)
        loss = (nll * mask).sum() / denom
    loss = loss if aux is None else loss + aux
    if not with_acc:
        return loss, None
    ok = (argmax_of(logits, tp) == labels).float()
    acc = ok.mean() if mask is None else (ok * mask).sum() / denom
    return loss, acc


class LM:
    """``init``, ``apply``/``loss``/``loss_and_acc`` and ``init_cache``/
    ``decode_step`` (and ``prefill_cross`` for encdec) of a model of any of
    the six families, on ``device`` (default ``"cuda"``, which raises when
    CUDA is missing)."""

    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "xla",
                 device="cuda"):
        if cfg.family not in FAMILIES:
            raise ValueError(
                f"repro_torch.models.LM runs the {FAMILIES} families, not "
                f"{cfg.family!r} ({cfg.name})")
        if cfg.param_dtype not in DTYPES:
            raise ValueError(f"param_dtype must be one of {sorted(DTYPES)}, "
                             f"got {cfg.param_dtype!r}")
        if attn_impl not in L.ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {L.ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        if cfg.remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got "
                             f"{cfg.remat!r}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.device = _device.resolve(device)
        self.dtype = DTYPES[cfg.param_dtype]
        self.hybrid = cfg.family == "hybrid"
        self.ssm = cfg.family == "ssm"
        self.moe = cfg.family == "moe"
        self.encdec = cfg.family == "encdec"
        self._meta = (L.mamba2_meta(cfg) if self.hybrid
                      else L.mlstm_meta(cfg) if self.ssm else None)
        # a rank's block of the model (:meth:`shard`): its layout, plan and
        # mesh coordinates
        self.tp = None
        self._plan = self._coords = None

    def _is_slstm(self, i: int) -> bool:
        """Whether ssm layer ``i`` is an sLSTM block (every
        ``slstm_every``-th; the others are mLSTM)."""
        return self.ssm and (i + 1) % self.cfg.xlstm.slstm_every == 0

    def _refuse_masks(self, masks) -> None:
        if masks is None:
            return
        if self.moe:
            raise ValueError(
                "masks= is unsupported for MoE stacks: a zeroed router "
                "logit is not -inf, so masked experts would still "
                "receive routed mass — prune experts with "
                "Prune(mode='shrink') (core.pruning_lm.prune_lm_experts)")
        if self.ssm or self.encdec:
            raise ValueError(f"masks= requires a scanned stack, not family "
                             f"{self.cfg.family!r}")

    def hybrid_groups(self) -> list:
        """zamba2 layer groups ``(start, stop)``: the shared attention runs
        before each group of ``attn_every`` Mamba2 layers."""
        k = self.cfg.hybrid.attn_every
        n = self.cfg.num_layers
        return [(a, min(a + k, n)) for a in range(0, n, k)]

    # -- tensor parallelism -----------------------------------------------------
    def shard(self, plan, coords: dict, group) -> "LM":
        """This model over a rank's block of the params: the placements of
        ``sharding.specs.param_specs`` under ``plan``, at mesh coordinates
        ``coords``, with ``group`` (a ``sharding.tp.TPGroup``) the ranks of
        the ``model`` axis.  Query heads take the [g, kv] grouping of
        ``specs.head_index``.  Every method then makes and takes the rank's
        tensors: ``init`` draws its block (the unsharded draws for a group
        of one), ``apply`` and ``decode_step`` give its vocab columns of the
        logits, ``init_cache`` its kv heads (and its rows of a batch the
        plan splits), the losses and FedAP's decision are the whole
        model's.  The dense family only; an FSDP axis wider than one and
        padded heads are refused (ROADMAP queue 1)."""
        from repro_torch.sharding.specs import param_specs

        cfg = self.cfg
        if cfg.family != "dense":
            raise ValueError(
                f"tensor parallelism over the 'model' mesh axis runs the "
                f"dense family; {cfg.name} is {cfg.family!r} (its TP slice "
                f"is queued in ROADMAP queue 1)")
        fsdp = plan.axis_size(plan.fsdp_axes) if plan.fsdp_axes else 1
        if fsdp > 1:
            raise ValueError(
                f"{cfg.name} is FSDP-sharded over {plan.fsdp_axes} ({fsdp} "
                f"ways) on this mesh; FSDP over 'data' is queued in ROADMAP "
                f"queue 1 (a (1, m) mesh runs it tensor-parallel only)")
        if cfg.padded_num_heads != cfg.num_heads:
            raise ValueError(f"{cfg.name}: padded heads under tensor "
                             f"parallelism (ROADMAP queue 1)")
        whole = self.param_shapes()
        sp = param_specs(whole, self.axes(), plan)
        attn = sp["layers"]["attn"]
        heads = attn["wq"].parts[2] is not None
        kv = attn["wk"].parts[2] is not None
        h, kvh = cfg.num_heads, cfg.padded_num_kv_heads
        if heads and not kv and (h // group.size) % kvh:
            raise ValueError(
                f"{cfg.name}: {h} query heads over {group.size} ranks with "
                f"its {kvh} kv heads whole leaves a rank's heads short of the "
                f"[g, kv] grouping (ROADMAP queue 1)")
        vocab = sp["embed"].parts[0] is not None
        out = copy.copy(self)
        out.tp = TP.TPLayout(
            group=group, heads=heads, kv=kv,
            mlp=sp["layers"]["mlp"]["wi"].parts[2] is not None, vocab=vocab,
            vocab_start=(group.rank * (cfg.vocab_size // group.size)
                         if vocab else 0),
            kv_heads=kvh // group.size if kv else kvh)
        out._plan, out._coords = plan, dict(coords)
        return out

    def _whole(self) -> "LM":
        whole = copy.copy(self)
        whole.tp = whole._plan = whole._coords = None
        return whole

    def _rows(self, batch_size: int) -> int:
        """A rank's rows of a batch of ``batch_size``: its block where the
        plan splits the batch (``cache_specs``, ``serve_batch_specs``)."""
        if self._plan is None:
            return batch_size
        axes = self._plan.client_axes + self._plan.batch_axes
        n = self._plan.axis_size(axes) if axes else 1
        return batch_size // n if batch_size % n == 0 else batch_size

    def _init_block(self, generator: torch.Generator) -> dict:
        """A rank's params drawn at its block's shapes with the whole
        model's scales, a layer at a time (no f32 copy of a whole stacked
        leaf forms); the draws are not the unsharded model's."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        s_in = 1.0 / math.sqrt(cfg.d_model)
        scales = {("", "embed"): s_in, ("", "unembed"): s_in,
                  ("attn", "wq"): s_in, ("attn", "wk"): s_in,
                  ("attn", "wv"): s_in,
                  ("attn", "wo"): 1.0 / math.sqrt(cfg.num_heads * hd),
                  ("mlp", "wi"): s_in, ("mlp", "wg"): s_in,
                  ("mlp", "wo"): 1.0 / math.sqrt(cfg.d_ff)}

        def draw(shape, scale):
            out = torch.empty(shape, dtype=self.dtype, device=self.device)
            if out.device.type == "meta":
                return out
            rows = out if out.dim() > 2 else out[None]
            for r in rows:
                r.copy_(torch.randn(r.shape, generator=generator,
                                    dtype=torch.float32,
                                    device=self.device).mul_(scale))
            return out

        def walk(node, parent):
            out = {}
            for k, v in node.items():       # the init's order
                if isinstance(v, dict):
                    out[k] = walk(v, k)
                elif k in ("scale", "bias"):
                    fill = torch.ones if k == "scale" else torch.zeros
                    out[k] = fill(v.shape, dtype=self.dtype,
                                  device=self.device)
                else:
                    out[k] = draw(v.shape, scales[(parent, k)])
            return out

        return walk(self.param_shapes(), "")

    # -- init -----------------------------------------------------------------
    def init(self, generator: torch.Generator) -> dict:
        """Random params drawn from ``generator`` (which must live on this
        model's device): normal with the reference's per-tensor scales (a
        rank's block of a model split over more than one rank:
        :meth:`_init_block`)."""
        if self.tp is not None and self.tp.group.size > 1:
            return self._init_block(generator)
        cfg = self.cfg
        params = {"embed": L._init_normal(
            (cfg.vocab_size, cfg.d_model), 1.0 / math.sqrt(cfg.d_model),
            self.dtype, generator, self.device)}
        if not cfg.tie_embeddings:
            params["unembed"] = L._init_normal(
                (cfg.d_model, cfg.vocab_size), 1.0 / math.sqrt(cfg.d_model),
                self.dtype, generator, self.device)
        params["norm_out"] = L.init_norm(cfg, self.dtype, self.device)
        if self.encdec:
            enc = cfg.encoder
            params["enc_pos"] = L._init_normal(
                (enc.frames, cfg.d_model), 0.02, self.dtype, generator,
                self.device)
            params["norm_enc"] = L.init_norm(cfg, self.dtype, self.device)
            params["encoder"] = {
                f"l{i}": L.init_block(cfg, self.dtype, generator, self.device)
                for i in range(enc.num_layers)}
            params["decoder"] = {
                f"l{i}": L.init_block(cfg, self.dtype, generator, self.device,
                                      cross=True)
                for i in range(cfg.num_layers)}
            return params
        if self.ssm:
            blocks = {}
            for i in range(cfg.num_layers):
                init = L.init_slstm if self._is_slstm(i) else L.init_mlstm
                blocks[f"l{i}"] = {
                    "cell": init(cfg, self.dtype, generator, self.device),
                    "norm": L.init_norm(cfg, self.dtype, self.device)}
            params["blocks"] = blocks
            return params
        if not self.hybrid:
            params["layers"] = L.init_layer_stack(
                cfg, cfg.num_layers, self.dtype, generator, self.device)
            return params
        params["layers"] = L.init_hybrid_stack(cfg, cfg.num_layers, self.dtype,
                                               generator, self.device)
        params["shared_attn"] = {
            "attn": L.init_attention(cfg, self.dtype, generator, self.device),
            "norm": L.init_norm(cfg, self.dtype, self.device)}
        return params

    def on_meta(self) -> "LM":
        """This model on the meta device: every method then makes and takes
        tensors with shapes and dtypes but no storage (any arch, at any
        size); the kernels' wrappers give empty outputs there."""
        meta = copy.copy(self)
        meta.device = torch.device("meta")
        return meta

    def param_shapes(self) -> dict:
        """The param tree on the meta device: every leaf's shape and dtype,
        with no storage (any arch, at any size); a rank's block of it for a
        sharded model (:meth:`shard`)."""
        whole = self._whole().on_meta().init(torch.Generator())
        if self.tp is None:
            return whole
        from repro_torch.sharding.specs import shard_tree

        return shard_tree(whole, self.block_specs(), self._plan,
                          self._coords, axes=_axes_of(whole),
                          kv_heads=self.cfg.padded_num_kv_heads)

    def block_specs(self) -> dict:
        """The ``sharding.specs.Spec`` tree of the whole params under a
        sharded model's plan (what ``shard_tree``/``gather_tree`` take)."""
        from repro_torch.sharding.specs import param_specs

        whole = self._whole().param_shapes()
        return param_specs(whole, _axes_of(whole), self._plan)

    def filter_axes(self) -> dict:
        """The logical axes of the FFN filter masks ``{"mlp": [L, d_ff]}``
        (``sharding.fl_specs.fl_state_specs(filter_axes=)``)."""
        return {"mlp": ("layers", "mlp")}

    def axes(self) -> dict:
        """The logical-axis tree of the params: one tuple of axis names per
        leaf (``"layers"`` first on a stacked leaf), the reference's
        ``LM.axes()``, which ``sharding.specs.param_specs`` maps onto a
        device mesh."""
        return _axes_of(self.param_shapes())

    # -- forward pieces ---------------------------------------------------------
    def _embed_in(self, params, batch):
        """The input embeddings: ``batch["embeds"]`` cast to the param dtype
        when given, else the rows of ``embed`` at ``batch["tokens"]``."""
        if "embeds" in batch:
            return batch["embeds"].to(self.dtype)
        if self.tp is not None and self.tp.vocab:
            return TP.vocab_embed(params["embed"], batch["tokens"], self.tp)
        return params["embed"][batch["tokens"]]

    def _encode(self, params, batch):
        """The encdec encoder over ``batch["enc_embeds"]`` [B,F,d] (F =
        ``cfg.encoder.frames``): plus ``enc_pos``, each block's
        bidirectional attention and FFN (pre-norm residual), then
        ``norm_enc``."""
        cfg = self.cfg
        if "enc_embeds" not in batch:
            raise ValueError(
                f"family 'encdec' ({cfg.name}) reads the encoder's frame "
                f"embeddings from batch['enc_embeds'] [B, "
                f"{cfg.encoder.frames}, {cfg.d_model}]; this batch has only "
                f"{sorted(batch)} (loss_and_acc takes tokens and labels, so "
                f"FederatedTrainer cannot train this family, as the "
                f"reference's cannot; train it on batch dicts through "
                f"launch.steps.make_fl_train_step)")
        x = batch["enc_embeds"].to(self.dtype) + params["enc_pos"][None]
        for i in range(cfg.encoder.num_layers):
            blk = params["encoder"][f"l{i}"]
            h = L.apply_norm(blk["norm_a"], x, cfg.norm)
            x = x + L.encoder_attention(blk["attn"], h)
            h = L.apply_norm(blk["norm_f"], x, cfg.norm)
            x = x + L.apply_mlp(blk["mlp"], h, cfg.act)
        return L.apply_norm(params["norm_enc"], x, cfg.norm)

    @staticmethod
    def _cross_kv(blk, enc):
        """A decoder block's cross K/V [B,F,KV,hd] from the encoder output."""
        return L._heads(enc, blk["xattn"]["wk"]), L._heads(enc,
                                                          blk["xattn"]["wv"])

    def _decode_layers(self, params, x, pos, window, enc):
        """The encdec decoder's blocks over a whole sequence: causal
        self-attention (over ``window``), cross-attention to ``enc`` (no
        window), the FFN."""
        cfg = self.cfg
        for i in range(cfg.num_layers):
            blk = params["decoder"][f"l{i}"]
            h = L.apply_norm(blk["norm_a"], x, cfg.norm)
            x = x + L.attention_block(blk["attn"], h, pos, cfg, window=window,
                                      attn_impl=self.attn_impl)
            h = L.apply_norm(blk["norm_x"], x, cfg.norm)
            x = x + L.attention_block(blk["xattn"], h, pos, cfg,
                                      attn_impl=self.attn_impl,
                                      cross_kv=self._cross_kv(blk, enc))
            h = L.apply_norm(blk["norm_f"], x, cfg.norm)
            x = x + L.apply_mlp(blk["mlp"], h, cfg.act)
        return x

    def _head(self, params, x):
        cfg = self.cfg
        x = L.apply_norm(params.get("norm_out", {}), x, cfg.norm)
        if self.tp is not None and self.tp.vocab:   # a rank's vocab columns
            x = TP.to_model(x, self.tp.group)
        if cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["unembed"]

    def _block(self, layer, x, positions, mask, window):
        """One pre-norm residual block: (x, the layer's auxiliary loss, or
        None for a family without one)."""
        cfg = self.cfg
        if self.hybrid:
            h = L.apply_norm(layer["norm_m"], x, cfg.norm)
            x = x + L.apply_mamba2(layer["mamba"], h, self._meta, cfg,
                                   impl=self.attn_impl)
        else:
            h = L.apply_norm(layer.get("norm_a", {}), x, cfg.norm)
            x = x + L.attention_block(layer["attn"], h, positions, cfg,
                                      window=window, attn_impl=self.attn_impl,
                                      tp=self.tp)
        h = L.apply_norm(layer.get("norm_f", {}), x, cfg.norm)
        if self.moe:
            y, aux = L.apply_moe(layer["moe"], h, cfg)
            return x + y, aux["load_balance"] + aux["router_z"]
        return x + L.apply_mlp(layer["mlp"], h, cfg.act, mask, self.tp), None

    def apply(self, params, batch, *, window="auto", masks=None):
        """Full-sequence logits [B,S,V] for ``batch["tokens"]`` [B,S] or
        ``batch["embeds"]`` [B,S,d] (causal attention over the whole
        sequence; ``batch["positions"]`` [P,B,S] overrides the default
        ``arange`` positions; the encdec family also reads
        ``batch["enc_embeds"]`` [B,F,d]).  ``window`` bounds the
        dense and moe families' attention ("auto" and None: full); the
        hybrid family's shared attention always uses ``cfg.sliding_window``.

        ``masks`` (optional) ``{"mlp": [L, d_ff] 0/1}`` gives each layer its
        FedAP filter keep-mask row: masked units are zeroed at the FFN
        pre-activation (the logits equal the shrunk model's) and the up/gate
        products run the differentiable ``masked_matmul`` kernels, which
        skip fully pruned 128-column blocks forward and backward.  The moe
        family refuses ``masks=``, with the reference's message.

        The stacked ``[L, ...]`` layer params are unbound once, so the
        backward writes each layer's gradient into one stacked tensor.
        ``cfg.remat == "block"`` recomputes each layer in the backward
        (``torch.utils.checkpoint``), launching its forward kernels twice;
        ``"dots"`` checkpoints each layer selectively: the outputs of its
        2-D products are saved and the rest recomputed, the masked product
        (K1) included (:func:`_dots_policy`).
        Only the logits return: the moe family's auxiliary loss is summed by
        :meth:`loss` and :meth:`loss_and_acc`.

        The ssm family runs its unrolled blocks ``x + cell(norm(x))`` and
        the encdec family its encoder and its decoder's blocks; both ignore
        ``remat``, as the reference's branches return before its remat, and
        refuse ``masks=``.
        """
        return self._forward(params, batch, window, masks)[0]

    def apply_with_aux(self, params, batch, *, window="auto", masks=None):
        """``(logits, aux)``: :meth:`apply`'s logits and the layers' summed
        auxiliary loss (the moe family's ``load_balance + router_z``; None
        for the other families), the reference's ``LM.apply`` pair."""
        return self._forward(params, batch, window, masks)

    def _forward(self, params, batch, window, masks):
        """(logits, the layers' summed auxiliary loss or None)."""
        cfg = self.cfg
        self._refuse_masks(masks)
        x = self._embed_in(params, batch)
        b, s = x.shape[0], x.shape[1]
        pos = batch.get("positions")
        if pos is None:
            pos = L.default_positions(b, s, cfg.rope, device=x.device)
        if window == "auto":
            window = None
        if self.encdec:
            enc = self._encode(params, batch)
            return self._head(params, self._decode_layers(
                params, x, pos, window, enc)), None
        if self.ssm:
            for i in range(cfg.num_layers):
                blk = params["blocks"][f"l{i}"]
                h = L.apply_norm(blk["norm"], x, cfg.norm)
                cell = L.apply_slstm if self._is_slstm(i) else L.apply_mlstm
                x = x + cell(blk["cell"], h, self._meta, cfg)
            return self._head(params, x), None
        layers = _unstack(params["layers"])
        rows = (masks["mlp"].unbind(0) if masks is not None
                else (None,) * len(layers))
        total = None

        def block(i, x):
            nonlocal total
            if cfg.remat == "block":
                x, aux = checkpoint(self._block, layers[i], x, pos, rows[i],
                                    window, use_reentrant=False)
            elif cfg.remat == "dots":
                x, aux = checkpoint(self._block, layers[i], x, pos, rows[i],
                                    window, use_reentrant=False,
                                    context_fn=_dots_context)
            else:
                x, aux = self._block(layers[i], x, pos, rows[i], window)
            if aux is not None:
                total = aux if total is None else total + aux
            return x

        if not self.hybrid:
            for i in range(len(layers)):
                x = block(i, x)
            return self._head(params, x), total
        shared = params["shared_attn"]
        for a, stop in self.hybrid_groups():
            h = L.apply_norm(shared["norm"], x, cfg.norm)
            x = x + L.attention_block(shared["attn"], h, pos, cfg,
                                      window=cfg.sliding_window,
                                      attn_impl=self.attn_impl)
            for i in range(a, stop):
                x = block(i, x)
        return self._head(params, x), total

    def loss(self, params, batch, *, window="auto", masks=None):
        """Mean next-token cross-entropy of :meth:`apply` (with its
        ``window``) against ``batch["labels"]`` [B,S], over
        ``batch["loss_mask"]`` when given (log-softmax in f32), plus the moe
        family's summed ``load_balance + router_z`` after the mean."""
        return self._loss_acc(params, batch, masks, window,
                              with_acc=False)[0]

    def loss_and_acc(self, params, x, y, *, masks=None):
        """The federated trainer's model contract: ``(x, y)`` = (tokens [B,S],
        labels [B,S]) -> (loss, token accuracy), from one forward — the
        port's copy of the reference's ``launch.steps.loss_and_accuracy``
        (the loss as :meth:`loss` gives it).  An encdec model raises a
        ``ValueError`` naming the missing ``enc_embeds`` (the reference
        raises ``KeyError``), so ``FederatedTrainer`` cannot train that
        family; ``launch.steps.make_fl_train_step`` trains it on batch
        dicts."""
        return self._loss_acc(params, {"tokens": x, "labels": y}, masks)

    def _loss_acc(self, params, batch, masks, window="auto", *,
                  with_acc: bool = True):
        logits, aux = self._forward(params, batch, window, masks)
        return loss_and_acc_of(logits, aux, batch, self.tp,
                               with_acc=with_acc)

    # -- FedAP seam -------------------------------------------------------------
    def decide_kept(self, params, p_star, *, align=128) -> dict:
        """``{"mlp": [L, keep]}`` kept-unit index rows (host numpy) from the
        aggregate prune rate — weight-norm product scores, a uniform
        ``align``-lane kept count (:mod:`repro_torch.core.pruning_lm`)."""
        from repro_torch.core import pruning_lm

        return {"mlp": pruning_lm.ffn_kept_indices(
            params, self.cfg, float(p_star), align=align, tp=self.tp)}

    def filter_masks(self, params, kept) -> dict:
        """``{"mlp": [L, d_ff] 0/1}`` keep-masks for masked decode."""
        from repro_torch.core import pruning_lm

        return pruning_lm.ffn_filter_masks(params, kept, tp=self.tp)

    def param_masks(self, params, kept) -> dict:
        """Param-structured 0/1 masks (wi/wg columns + wo rows)."""
        from repro_torch.core import pruning_lm

        return pruning_lm.ffn_param_masks(params, kept, tp=self.tp)

    def shrink_params(self, params, kept) -> dict:
        """Gather the kept FFN units (params or any tree of the same
        structure)."""
        from repro_torch.core import pruning_lm

        idx = kept.get("mlp") if kept else None
        return params if idx is None else pruning_lm.shrink_ffn_at(params, idx)

    # -- decode -----------------------------------------------------------------
    def init_cache(self, batch_size: int, cache_len: int, *,
                   window=None) -> dict:
        """Zero decode cache with S = ``cache_len`` attention rows, or
        ``min(cache_len, window)`` when a ``window`` is given (a ring buffer
        once the index passes S); ``"index"`` is a 0-d int32 zero.

        dense and moe: ``{"k", "v": [L, B, S, KV, hd]}``, KV after head
        padding (``cfg.padded_num_kv_heads``).  hybrid: ``{"mamba":
        {"conv": [L, B, W-1, d_in + 2N] (param dtype), "h": [L, B, nh, p, N]
        (f32)}, "shared_attn": {"k", "v": [G, B, S', KV, hd]}}``, one KV cache
        per application of the shared attention (G groups), with S' = S cut
        to ``cfg.sliding_window``.  ssm: ``{"l<i>": (C, N, m)`` (mLSTM) or
        ``(c, n, h, m)`` (sLSTM)``}``, f32 recurrent states whose size does
        not depend on ``cache_len``.  encdec: ``{"self": {"k", "v": [L, B,
        S, KV, hd]}, "cross": {"k", "v": [L, B, F, KV, hd]}}`` (the cross
        K/V zero until :meth:`prefill_cross`).  A sharded model's cache is
        the rank's block (``cache_specs``): its kv heads, and its rows of
        ``batch_size`` where the plan splits the batch."""
        cfg = self.cfg
        rows = cache_len if window is None else min(cache_len, window)
        index = torch.zeros((), dtype=torch.int32, device=self.device)
        batch_size = self._rows(batch_size)
        kvh = cfg.padded_num_kv_heads if self.tp is None else self.tp.kv_heads

        def kv(length):
            shape = (cfg.num_layers, batch_size, length, kvh,
                     cfg.resolved_head_dim)
            return {"k": torch.zeros(shape, dtype=self.dtype,
                                     device=self.device),
                    "v": torch.zeros(shape, dtype=self.dtype,
                                     device=self.device)}

        if self.encdec:
            return {"self": kv(rows), "cross": kv(cfg.encoder.frames),
                    "index": index}
        if self.ssm:
            cache = {"index": index}
            for i in range(cfg.num_layers):
                cache[f"l{i}"] = (
                    L.slstm_init_state(batch_size, cfg.d_model, self.device)
                    if self._is_slstm(i) else
                    L.mlstm_init_state(batch_size, self._meta, self.device))
            return cache
        if self.hybrid:
            rows = min(rows, cfg.sliding_window or rows)
            conv, h = L.mamba2_init_state(batch_size, self._meta, cfg,
                                          self.dtype, self.device)
            lead = (cfg.num_layers,)
            kv = (len(self.hybrid_groups()), batch_size, rows,
                  cfg.padded_num_kv_heads, cfg.resolved_head_dim)
            return {"mamba": {"conv": conv.new_zeros(lead + conv.shape),
                              "h": h.new_zeros(lead + h.shape)},
                    "shared_attn": {
                        "k": torch.zeros(kv, dtype=self.dtype,
                                         device=self.device),
                        "v": torch.zeros(kv, dtype=self.dtype,
                                         device=self.device)},
                    "index": index}
        return {**kv(rows), "index": index}

    def prefill_cross(self, params, cache, batch):
        """encdec only: run the encoder over ``batch["enc_embeds"]`` once and
        write every decoder layer's cross K/V into ``cache["cross"]``, in
        place (no autograd).  Returns the cache."""
        if not self.encdec:
            raise ValueError(f"prefill_cross is the encdec family's, not "
                             f"{self.cfg.family!r}'s")
        with torch.no_grad():
            enc = self._encode(params, batch)
            for i in range(self.cfg.num_layers):
                k, v = self._cross_kv(params["decoder"][f"l{i}"], enc)
                cache["cross"]["k"][i].copy_(k)
                cache["cross"]["v"][i].copy_(v)
        return cache

    def decode_step(self, params, cache, batch, *, masks=None):
        """One-token decode.  ``batch["tokens"]`` [B,1] (or ``"embeds"``
        [B,1,d]; ``"positions"`` [P,B,1] in place of the index's).  Returns
        (logits [B,1,V], cache).

        ``cache["index"]`` is a 0-d tensor (lockstep decode) or an int32 [B]
        tensor (continuous batching: per-slot fill levels, which the rope
        positions, the cache writes and the attended prefix all follow).
        Every cache tensor is updated in place and the returned cache holds
        the same tensors with ``index + 1``.

        ``masks`` (optional) ``{"mlp": [L, d_ff] 0/1}`` routes every layer's
        FFN through the block-skipping masked path; the logits equal the
        shrunk model's.  (The reference's hybrid decode drops ``masks``; on
        a mask-mode checkpoint, whose pruned units are zero, both give the
        same logits.)  The moe family refuses ``masks=``; its FFN is
        :func:`layers.apply_moe` over the step's B tokens (routing couples
        the rows of a batch: each expert takes its top-C of them), its
        auxiliary loss dropped.

        Attention runs the ``decode_attention`` kernel (K5) for either
        ``attn_impl``, as the reference's Pallas path does; there is no
        plain-attention decode on the card.  The hybrid runs the shared
        attention on its group's cache before each group of Mamba2 layers
        (:func:`layers.mamba2_decode`, a plain recurrence: the reference has
        no kernel there).  The ssm family runs each layer's norm and its
        cell's step (:func:`layers.mlstm_decode`, :func:`layers.slstm_decode`,
        plain ops), each state written into its cache tensors; ``masks=`` is
        refused there.  The encdec family runs, per decoder layer, K5 on its
        self cache, :func:`layers.attention_decode_cross` on the cross K/V
        (plain f32 einsums, as the reference's) and the FFN; ``masks=`` is
        refused there too.
        """
        cfg = self.cfg
        self._refuse_masks(masks)
        x = self._embed_in(params, batch)
        idx = cache["index"]
        if self.ssm:
            for i in range(cfg.num_layers):
                blk = params["blocks"][f"l{i}"]
                h = L.apply_norm(blk["norm"], x, cfg.norm)
                step = L.slstm_decode if self._is_slstm(i) else L.mlstm_decode
                x = x + step(blk["cell"], h, cache[f"l{i}"], self._meta, cfg)
            return self._head(params, x), {**cache, "index": idx + 1}
        pos = batch.get("positions")
        if pos is None:
            off = idx if idx.ndim == 0 else idx[None, :, None]
            pos = L.default_positions(x.shape[0], 1, cfg.rope,
                                      device=x.device) + off
        rows = (masks["mlp"].unbind(0) if masks is not None
                else (None,) * cfg.num_layers)
        if self.encdec:
            x = self._encdec_decode(params, cache, x, idx, pos)
        elif self.hybrid:
            x = self._hybrid_decode(params, cache, x, idx, pos, rows)
        else:
            lp = params["layers"]
            for i in range(cfg.num_layers):
                layer = tree_map(lambda t: t[i], lp)
                h = L.apply_norm(layer.get("norm_a", {}), x, cfg.norm)
                x = x + L.attention_decode(layer["attn"], h, cache["k"][i],
                                           cache["v"][i], idx, pos, cfg,
                                           self.tp)
                h = L.apply_norm(layer.get("norm_f", {}), x, cfg.norm)
                if self.moe:
                    x = x + L.apply_moe(layer["moe"], h, cfg)[0]
                else:
                    x = x + L.apply_mlp(layer["mlp"], h, cfg.act, rows[i],
                                        self.tp)
        cache = {**cache, "index": idx + 1}
        return self._head(params, x), cache

    def _encdec_decode(self, params, cache, x, idx, pos):
        """The encdec decoder's layers for one token: self-attention (K5
        over ``cache["self"]`` row ``i``), cross-attention to the fixed
        ``cache["cross"]`` K/V, the FFN."""
        cfg = self.cfg
        sk, sv = cache["self"]["k"], cache["self"]["v"]
        ck, cv = cache["cross"]["k"], cache["cross"]["v"]
        for i in range(cfg.num_layers):
            blk = params["decoder"][f"l{i}"]
            h = L.apply_norm(blk["norm_a"], x, cfg.norm)
            x = x + L.attention_decode(blk["attn"], h, sk[i], sv[i], idx, pos,
                                       cfg)
            h = L.apply_norm(blk["norm_x"], x, cfg.norm)
            x = x + L.attention_decode_cross(blk["xattn"], h, ck[i], cv[i])
            h = L.apply_norm(blk["norm_f"], x, cfg.norm)
            x = x + L.apply_mlp(blk["mlp"], h, cfg.act)
        return x

    def _hybrid_decode(self, params, cache, x, idx, pos, rows):
        """The hybrid's layers for one token: per group, the shared
        attention's norm and K5 over ``cache["shared_attn"]`` row ``gi`` (a
        contiguous [B,S,KV,hd] view), then each Mamba2 layer's norm, mixer
        step and FFN.  The attention window is the cache's row count: the
        new K/V land at slot ``index mod S``."""
        cfg = self.cfg
        shared = params["shared_attn"]
        sk, sv = cache["shared_attn"]["k"], cache["shared_attn"]["v"]
        conv, ssm = cache["mamba"]["conv"], cache["mamba"]["h"]
        layers = _unstack(params["layers"])
        for gi, (a, stop) in enumerate(self.hybrid_groups()):
            h = L.apply_norm(shared["norm"], x, cfg.norm)
            x = x + L.attention_decode(shared["attn"], h, sk[gi], sv[gi], idx,
                                       pos, cfg)
            for i in range(a, stop):
                layer = layers[i]
                h = L.apply_norm(layer["norm_m"], x, cfg.norm)
                x = x + L.mamba2_decode(layer["mamba"], h, (conv[i], ssm[i]),
                                        self._meta, cfg)
                h = L.apply_norm(layer["norm_f"], x, cfg.norm)
                x = x + L.apply_mlp(layer["mlp"], h, cfg.act, rows[i])
        return x
