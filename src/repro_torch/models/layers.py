"""Transformer building blocks, as plain functions on tensors.

Counterpart of the reference's ``models/layers.py`` for the six LM
families: the full-sequence forward of training and scoring (causal
self-attention, the encoder's bidirectional attention and the decoder's
cross-attention), the token-choice MoE FFN, the Mamba2 mixer, the xLSTM
cells, and the decode step of serving.  Layouts follow the reference: ``wq
[d,H,hd]``, ``wk/wv [d,KV,hd]``, ``wo [H,hd,d]`` (H and KV after head
padding), cache ``[B,S,KV,hd]``, FFN ``wi/wg [d,ff]``, ``wo [ff,d]``, MoE
``router [d,E]`` (f32), ``wi/wg [E,d,f]``, ``wo [E,f,d]``, Mamba2 ``in_proj
[d, 2 d_in + 2 N + nh]``, ``conv [W, d_in + 2 N]``, ``out_proj [d_in, d]``,
mLSTM ``up [d,2f]``, ``wq/wk/wv [f,nh,hd]``, ``w_if [f,2nh]``, ``down
[f,d]``, sLSTM ``w_x/w_h [d,4d]``, ``down [d,d]``.  The compute dtype is
the input dtype; norms, rope, softmax, the router, the SSM state and the
xLSTM gates and memories run in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.masked_matmul import BLOCK_N
from repro_torch.sharding import tp as TP


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def apply_norm(params, x, kind: str, eps: float = 1e-5):
    """rmsnorm (scale), layernorm (scale, bias) or nonparam (OLMo: layernorm
    without affine), computed in f32 and cast back."""
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(x.dtype)
    if kind not in ("layernorm", "nonparam"):
        raise ValueError(kind)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if kind == "layernorm":
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings: 1d / GLM-2d / M-RoPE
# ---------------------------------------------------------------------------

def _rotate(x, sin, cos):
    """x [..., dim], rotating interleaved pairs (x[..., ::2], x[..., 1::2])."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape)


def mrope_sections(hd: int) -> list:
    """M-RoPE's split of head_dim into its (t, h, w) sections, the
    reference's ``[hd // 2, hd // 4, hd - hd // 2 - hd // 4]``."""
    return [hd // 2, hd // 4, hd - hd // 2 - hd // 4]


ROPE_STREAMS = {"none": 1, "1d": 1, "2d": 2, "mrope": 3}
_ROPE_TABLES: dict = {}     # (kind, hd, device) -> (freqs, streams)


def _rope_table(kind: str, hd: int, device, base: float = 10000.0):
    """(freqs [hd//2] f32, streams [hd//2] int64): the frequency of each
    rotated pair of head_dim and the position stream that turns it.  Each
    section of width w (1d: all of hd; 2d: two halves; mrope: the
    :func:`mrope_sections`) has the reference's ``1 / base ** (arange(0, w,
    2) / w)``.  Made once per (kind, hd, device), outside inference mode."""
    key = (kind, hd, str(device))
    if key not in _ROPE_TABLES:
        widths = {"1d": [hd], "2d": [hd // 2, hd - hd // 2],
                  "mrope": mrope_sections(hd)}[kind]
        with torch.inference_mode(False):
            freqs = [1.0 / (base ** (torch.arange(
                0, w, 2, dtype=torch.float32, device=device) / w))
                for w in widths]
            streams = [torch.full((w // 2,), i, dtype=torch.int64,
                                  device=device)
                       for i, w in enumerate(widths)]
            _ROPE_TABLES[key] = (torch.cat(freqs), torch.cat(streams))
    return _ROPE_TABLES[key]


def rope_sin_cos(positions, kind: str, hd: int):
    """(sin, cos) [B, S, 1, hd//2] in f32 of the rotation angles at
    ``positions`` [P, B, S] (P as :data:`ROPE_STREAMS`), every pair's angle
    its stream's position times its frequency, computed once for q and k;
    None for ``kind="none"``."""
    if kind == "none":
        return None
    if kind not in ROPE_STREAMS:
        raise ValueError(kind)
    freqs, streams = _rope_table(kind, hd, positions.device)
    pos = positions.float()
    if kind == "1d":
        ang = pos[0][..., None] * freqs
    else:
        ang = pos.index_select(0, streams).permute(1, 2, 0) * freqs
    return torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]


def apply_rope(x, positions, kind: str, sin_cos=None):
    """x [B, S, n, head_dim]; positions [P, B, S] with P=1 (1d), 2 (GLM 2d:
    first half of head_dim by stream 0, second by stream 1) or 3 (M-RoPE:
    the :func:`mrope_sections` of head_dim by the t, h and w streams, each
    section's angles over its own width, its pairs interleaved as in 1d;
    the reference's form, not Hugging Face's rotate-half one).  Every
    section's pairs are rotated in one pass (sections start at even
    offsets, so no pair spans two), with the angles of
    :func:`rope_sin_cos`, or ``sin_cos`` when given."""
    if kind == "none":
        return x
    sin, cos = sin_cos or rope_sin_cos(positions, kind, x.shape[-1])
    return _rotate(x.float(), sin, cos).to(x.dtype)


def default_positions(batch: int, seq: int, kind: str, offset: int = 0, *,
                      device="cpu"):
    """[P, B, S] int32 positions ``arange(seq) + offset`` per rope stream."""
    p = ROPE_STREAMS[kind]
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(p, batch, seq).to(torch.int32)


# ---------------------------------------------------------------------------
# full-sequence attention (training / prefill)
# ---------------------------------------------------------------------------

def _heads(x, w):
    """einsum('bsd,dhk->bshk') as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


_BLOCK_Q = 1024   # query rows per block of the plain attention


def attention(q, k, v, *, causal: bool = True, window=None, q_offset=0):
    """Plain GQA attention, the reference's ``attention_ref``: q [B,Sq,H,hd],
    k/v [B,Skv,KV,hd] -> [B,Sq,H,hd] in q's dtype.  Query head ``h = g * KV +
    kv`` attends kv head ``kv`` (the [g, kv] grouping); key ``s`` is visible
    to query ``t`` (at position ``q_offset + t``) iff ``s <= t`` when
    ``causal`` and ``s > t - window`` when a window is given.  Scores and
    softmax run in f32.  Above ``_BLOCK_Q`` query rows the rows are taken a
    block at a time (the same math per row), to bound the scores' memory as
    the reference's blocked form does."""
    sq = q.shape[1]
    if sq > _BLOCK_Q:
        return torch.cat([
            attention(q[:, i:i + _BLOCK_Q], k, v, causal=causal, window=window,
                      q_offset=q_offset + i)
            for i in range(0, sq, _BLOCK_Q)], dim=1)
    b, _, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, h // kvh, kvh, hd).float()
    scores = torch.einsum("bqgkd,bskd->bgkqs", qg, k.float()) / math.sqrt(hd)
    if causal or window is not None:
        ok = ref.visible(sq, skv, causal=causal, window=window,
                         q_offset=q_offset, device=q.device)
        scores = scores.masked_fill(~ok, -math.inf)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgkqs,bskd->bqgkd", w, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


ATTN_IMPLS = ("xla", "pallas")


def attention_block(params, x, positions, cfg: ModelConfig, *, window=None,
                    attn_impl: str = "xla", cross_kv=None, tp=None):
    """Causal self-attention over a whole sequence: q/k/v projections, rope,
    attention (optionally over a sliding ``window``), the output projection.
    x [B,S,d] -> [B,S,d].  ``attn_impl="xla"`` runs the plain
    :func:`attention` (differentiable); ``"pallas"`` runs the
    ``flash_attention`` kernel (K4), forward only.

    ``cross_kv=(k, v)`` ([B,F,KV,hd] each, from an encoder: the whisper
    decoder's cross-attention) makes it cross-attention: only q is
    projected, nothing is rotated, and every query sees all F keys (no
    causal mask; K4 runs with ``causal=False`` at Sq != Skv).

    Head counts come from the params' shapes.  With padded heads
    (``cfg.pad_heads_to``) the reference tiles K/V up to H, which maps query
    head h to kv head ``h mod KV``: the [g, kv] grouping that both paths here
    apply to GQA K/V directly, so K/V are passed on untiled.

    ``tp`` (a ``sharding.tp.TPLayout`` whose ``heads`` are split): the
    params are a rank's heads, in the [g, kv] grouping over its kv heads
    (``sharding.specs.head_index``), so the attention needs no collective;
    the output projection's parts are summed over the ranks."""
    b, s, _ = x.shape
    x, params = _tp_in(x, params, tp)
    if cross_kv is None:
        sc = rope_sin_cos(positions, cfg.rope, params["wq"].shape[-1])
        q = apply_rope(_heads(x, params["wq"]), positions, cfg.rope, sc)
        k = apply_rope(_heads(x, params["wk"]), positions, cfg.rope, sc)
        v = _heads(x, params["wv"])
        causal = True
    else:
        q = _heads(x, params["wq"])
        k, v = cross_kv
        causal = False
    if attn_impl == "pallas":
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    elif attn_impl == "xla":
        out = attention(q, k, v, causal=causal, window=window)
    else:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    wo = params["wo"]
    return _tp_out(out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1]), tp)


def _tp_in(x, params, tp):
    """A rank's attention input: ``x`` whose gradient sums over the ranks,
    and, where the kv heads stay whole, ``wk``/``wv`` whose gradients do
    (each rank's queries read them)."""
    if tp is None or not tp.heads:
        return x, params
    x = TP.to_model(x, tp.group)
    if not tp.kv:
        params = dict(params, wk=TP.to_model(params["wk"], tp.group),
                      wv=TP.to_model(params["wv"], tp.group))
    return x, params


def _tp_out(y, tp, split: str = "heads"):
    """A row-parallel product's parts summed over the ranks."""
    if tp is None or not getattr(tp, split):
        return y
    return TP.from_model(y, tp.group)


def encoder_attention(params, x):
    """The encoder's bidirectional self-attention, x [B,F,d] -> [B,F,d]:
    q/k/v projections, no rope, plain :func:`attention` with
    ``causal=False``, the output projection.  It runs the plain attention
    whatever the model's ``attn_impl``: the reference's encoder branch
    calls its plain attention directly and never reaches its Pallas
    kernel, so no kernel lies on this path."""
    out = attention(_heads(x, params["wq"]), _heads(x, params["wk"]),
                    _heads(x, params["wv"]), causal=False)
    wo = params["wo"]
    return out.reshape(*x.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


# ---------------------------------------------------------------------------
# attention decode against the KV cache
# ---------------------------------------------------------------------------


def attention_decode(params, x, cache_k, cache_v, cache_index, positions,
                     cfg: ModelConfig, tp=None):
    """One-token decode.  x [B,1,d]; cache [B,S,KV,hd].  Returns the
    attention output [B,1,d] and writes the new K/V into the cache.

    ``cache_index`` is a 0-d tensor (lockstep: every sequence at the same
    depth) or an int32 [B] tensor (continuous batching: one fill level per
    decode slot).  The new K/V land at slot ``index mod S`` and slots
    ``<= index`` are attended (all S once the index passes S), through the
    ``decode_attention`` kernel with ``lengths = index + 1``.

    The cache is written IN PLACE (one ``index_copy_`` of B rows), where the
    reference returns a fresh cache selected with a one-hot ``where``.  A
    frozen slot of the engine writes at its unchanged index, a slot that
    stays invalid.

    ``tp``: a rank's heads and its cache's kv heads (all of them where
    they stay whole), as :func:`attention_block` takes them.
    """
    b = x.shape[0]
    x, params = _tp_in(x, params, tp)
    s_cache, kvh, hd = cache_k.shape[1], cache_k.shape[2], cache_k.shape[3]
    sc = rope_sin_cos(positions, cfg.rope, hd)
    q = apply_rope(_heads(x, params["wq"]), positions, cfg.rope, sc)
    k_new = apply_rope(_heads(x, params["wk"]), positions, cfg.rope, sc)
    v_new = _heads(x, params["wv"])
    idx = cache_index.expand(b) if cache_index.ndim == 0 else cache_index
    rows = torch.arange(b, device=x.device) * s_cache + torch.remainder(
        idx, s_cache).long()
    cache_k.view(b * s_cache, kvh, hd).index_copy_(
        0, rows, k_new.reshape(b, kvh, hd).to(cache_k.dtype))
    cache_v.view(b * s_cache, kvh, hd).index_copy_(
        0, rows, v_new.reshape(b, kvh, hd).to(cache_v.dtype))
    # the reference's lockstep Pallas path attends all S slots even while
    # the cache fills; here both index forms attend the valid prefix only,
    # as its XLA path does
    lengths = (idx + 1).to(torch.int32).contiguous()
    out = ops.decode_attention(q, cache_k, cache_v, lengths)
    h = out.shape[2]
    wo = params["wo"]
    return _tp_out(out.reshape(b, 1, h * hd) @ wo.reshape(h * hd,
                                                          wo.shape[-1]), tp)


def attention_decode_cross(params, x, cross_k, cross_v):
    """One query token against the fixed cross K/V of an encoder: x
    [B,1,d], cross_k/cross_v [B,F,KV,hd] -> [B,1,d].  Plain einsums with
    the scores, softmax and weighted sum in f32 over every frame (the
    reference's ``attention_decode_cross``, which has no kernel either)."""
    b = x.shape[0]
    h, hd = params["wq"].shape[1], params["wq"].shape[2]
    kvh = cross_k.shape[2]
    qg = _heads(x, params["wq"]).reshape(b, h // kvh, kvh, hd).float()
    scores = torch.einsum("bgkd,bskd->bgks", qg,
                          cross_k.float()) / math.sqrt(hd)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgks,bskd->bgkd", w, cross_v.float())
    wo = params["wo"]
    return out.reshape(b, 1, h * hd).to(x.dtype) @ wo.reshape(h * hd,
                                                              wo.shape[-1])


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU), optionally FedAP-masked
# ---------------------------------------------------------------------------

def apply_mlp(params, x, act: str, mask=None, tp=None):
    """Dense FFN (GELU in the tanh form, as ``jax.nn.gelu``).  With ``mask``
    ([d_ff] 0/1) the pruned hidden units are zeroed at the pre-activation
    (silu(0) = gelu(0) = 0 through wo, so the logits equal the shrunk
    model's) and the up/gate products go through :func:`masked_dense`, which
    skips fully pruned 128-column blocks.

    ``tp`` (a ``sharding.tp.TPLayout`` whose ``mlp`` units are split): the
    params and ``mask`` are a rank's units; the input's gradient and the
    output's parts are summed over the ranks."""
    if tp is not None and tp.mlp:
        x = TP.to_model(x, tp.group)
    if mask is None:
        h = x @ params["wi"]
        if act == "silu":
            h = F.silu(x @ params["wg"]) * h
        else:
            h = F.gelu(h, approximate="tanh")
        return _tp_out(h @ params["wo"], tp, "mlp")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    h = masked_dense(x2, params["wi"], mask)
    if act == "silu":
        h = F.silu(masked_dense(x2, params["wg"], mask)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return _tp_out((h @ params["wo"]).reshape(shape), tp, "mlp")


def masked_dense(x, w, mask, b=None):
    """``(x @ w [+ b]) * mask`` for x [M,K], w [K,N], b [N], mask [N] 0/1:
    the bias is added before the mask, as the reference does.

    When K and N are multiples of 128 the product runs the differentiable
    ``masked_matmul`` (K1 forward, K2/K3 backward) with ``block_mask = max``
    of the mask over each 128-column block, so fully pruned blocks are
    skipped in both passes; a partly kept block is computed and re-masked
    elementwise.  Any M is taken as it is.  Unaligned K or N mask
    the plain product.  The mask is applied in the activation dtype (0/1 are
    exact in bf16), so a bf16 stack stays bf16.
    """
    k, n = w.shape
    if k % BLOCK_N == 0 and n % BLOCK_N == 0:
        block_mask = mask.float().reshape(n // BLOCK_N, BLOCK_N).amax(1)
        y = ops.masked_matmul(x.contiguous(), w.contiguous(), block_mask)
    else:
        y = x @ w
    if b is not None:
        y = y + b
    return y * mask.to(y.dtype)


# ---------------------------------------------------------------------------
# MoE (token-choice top-k, capacity-bounded)
# ---------------------------------------------------------------------------

def init_moe(cfg: ModelConfig, n_layers: int, dtype, generator,
             device) -> dict:
    """Stacked [L, ...] MoE params with the reference's scales: ``router
    [L,d,E]`` in f32 whatever the model's dtype, ``wi/wg [L,E,d,f]``, ``wo
    [L,E,f,d]``, and the optional always-on FFNs ``dense`` (arctic's residual
    branch, d_ff ``dense_d_ff``) and ``shared`` (llama4's shared expert, d_ff
    ``expert_d_ff``).  The expert stacks are drawn a matrix at a time."""
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.expert_d_ff
    lead = (n_layers,)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    params = {"router": _init_normal(lead + (d, e), s_in, torch.float32,
                                     generator, device)}
    for name, shape, scale in (("wi", (e, d, f), s_in), ("wg", (e, d, f), s_in),
                               ("wo", (e, f, d), s_out)):
        params[name] = _init_normal_sliced(lead + shape, scale, dtype,
                                           generator, device)
    if m.dense_d_ff:
        params["dense"] = init_mlp(d, m.dense_d_ff, cfg.act, dtype, generator,
                                   device, n_layers)
    if m.shared_expert:
        params["shared"] = init_mlp(d, f, cfg.act, dtype, generator, device,
                                    n_layers)
    return params


def top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis,
    in descending order; among equal values the lower index comes first,
    as ``jax.lax.top_k`` orders them (``torch.topk`` promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(params, x, cfg: ModelConfig):
    """Capacity-bounded token-choice routing, x [B,S,d] -> (y [B,S,d],
    ``{"load_balance", "router_z"}`` 0-d f32 losses), the reference's
    ``apply_moe``.

    The router's logits, softmax and the top-k gate ``[T, E]`` run in f32.
    Each expert takes its top-C tokens by gate, ``C = max(1, min(T, int(T k
    cf / E)))`` with E read from the router's shape (so an expert-pruned
    stack routes over its kept experts); a token picked with a zero gate
    adds exact zeros.  The experts' SwiGLU products are batched matmuls in
    the activations' dtype, scaled by the gate and scatter-added back in
    that dtype (``index_add``: at most ``top_k`` non-zero terms meet in a
    row, so the sum does not depend on their order).  Overflowing tokens
    are dropped; the residual path carries them.  The reference computes
    the experts in ``einsum``, outside any kernel: so does the port."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    router = params["router"]
    e = router.shape[-1]
    logits = xt.float() @ router                                  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = top_k(probs, m.top_k)                            # [T, k]
    gate = torch.zeros_like(probs).scatter(1, topi, topv)         # [T, E]
    cap = max(1, min(t, int(t * m.top_k * m.capacity_factor / e)))
    sel_gate, sel_idx = top_k(gate.T, cap)                        # [E, C]
    xe = xt[sel_idx]                                              # [E, C, d]
    h = torch.bmm(xe, params["wi"])
    h = F.silu(torch.bmm(xe, params["wg"])) * h
    ye = torch.bmm(h, params["wo"]) * sel_gate[..., None].to(xe.dtype)
    y = torch.zeros((t, d), dtype=ye.dtype, device=x.device).index_add(
        0, sel_idx.reshape(-1), ye.reshape(-1, d))
    me = probs.mean(0)
    ce = (gate > 0).float().mean(0)
    aux = {"load_balance": e * (me * ce).sum() * m.load_balance_loss,
           "router_z": torch.logsumexp(logits, dim=-1).square().mean()
           * m.router_z_loss}
    y = y.reshape(b, s, d)
    if "shared" in params:
        y = y + apply_mlp(params["shared"], x, cfg.act)
    if "dense" in params:
        y = y + apply_mlp(params["dense"], x, cfg.act)
    return y.to(x.dtype), aux


def _init_normal(shape, scale, dtype, generator, device):
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def _init_normal_sliced(shape, scale, dtype, generator, device):
    """:func:`_init_normal` drawn one trailing ``[a, b]`` matrix at a time
    into a tensor of ``dtype``: no f32 copy of the whole tensor forms (an
    arctic-480b expert stack is 17.8 GB in bf16, 35.7 GB in f32).  The draws
    differ from one draw of the whole tensor, and are as seeded."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.device.type == "meta":       # shapes only (LM.param_shapes)
        return out
    flat = out.view(-1, *shape[-2:])
    for i in range(flat.shape[0]):
        flat[i].copy_(torch.randn(shape[-2:], generator=generator,
                                  dtype=torch.float32, device=device)
                      .mul_(scale))
    return out


def init_attention(cfg: ModelConfig, dtype, generator, device,
                   n_layers=None) -> dict:
    """Attention params ``{wq, wk, wv, wo}`` (stacked ``[L, ...]`` when
    ``n_layers`` is given), drawn from ``generator``.

    With ``cfg.pad_heads_to`` the head count is padded up to its multiple
    (``cfg.padded_num_heads``), and KV with it where KV no longer divides
    the padded count (``cfg.padded_num_kv_heads``).  The padded heads' ``wo``
    rows are zero, as the reference's are; their ``wq`` columns are drawn,
    so those rows take a gradient, as there."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.padded_num_heads, cfg.padded_num_kv_heads
    lead = () if n_layers is None else (n_layers,)
    s = 1.0 / math.sqrt(d)

    def normal(shape, scale):
        return _init_normal(lead + shape, scale, dtype, generator, device)

    wq, wk, wv = normal((d, h, hd), s), normal((d, kv, hd), s), \
        normal((d, kv, hd), s)
    wo = normal((h, hd, d), 1.0 / math.sqrt(cfg.num_heads * hd))
    wo[..., cfg.num_heads:, :, :] = 0
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


def init_mlp(d_model: int, d_ff: int, act: str, dtype, generator, device,
             n_layers=None) -> dict:
    """FFN params ``{wi, [wg], wo}`` (stacked ``[L, ...]`` when ``n_layers``
    is given); ``wg`` only for ``act="silu"``."""
    lead = () if n_layers is None else (n_layers,)
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    mlp = {"wi": _init_normal(lead + (d_model, d_ff), s_in, dtype, generator,
                              device)}
    if act == "silu":
        mlp["wg"] = _init_normal(lead + (d_model, d_ff), s_in, dtype,
                                 generator, device)
    mlp["wo"] = _init_normal(lead + (d_ff, d_model), s_out, dtype, generator,
                             device)
    return mlp


def init_layer_stack(cfg: ModelConfig, n_layers: int, dtype, generator,
                     device) -> dict:
    """Stacked [L, ...] params of ``n_layers`` dense blocks (attention, two
    norms, FFN) or moe blocks (the FFN a :func:`init_moe` stack), drawn from
    ``generator``."""
    attn = init_attention(cfg, dtype, generator, device, n_layers)
    stack = {"attn": attn, "norm_a": init_norm(cfg, dtype, device, n_layers)}
    if cfg.family == "moe":
        stack["moe"] = init_moe(cfg, n_layers, dtype, generator, device)
    else:
        stack["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.act, dtype,
                                generator, device, n_layers)
    stack["norm_f"] = init_norm(cfg, dtype, device, n_layers)
    return stack


def init_block(cfg: ModelConfig, dtype, generator, device, *,
               cross: bool = False) -> dict:
    """One unstacked encoder (or, with ``cross``, decoder) block of the
    encdec family: ``{"attn", "norm_a", ["xattn", "norm_x"], "mlp",
    "norm_f"}``, the cross-attention's heads padded as the self-attention's
    are."""
    block = {"attn": init_attention(cfg, dtype, generator, device),
             "norm_a": init_norm(cfg, dtype, device)}
    if cross:
        block["xattn"] = init_attention(cfg, dtype, generator, device)
        block["norm_x"] = init_norm(cfg, dtype, device)
    block["mlp"] = init_mlp(cfg.d_model, cfg.d_ff, cfg.act, dtype, generator,
                            device)
    block["norm_f"] = init_norm(cfg, dtype, device)
    return block


def init_hybrid_stack(cfg: ModelConfig, n_layers: int, dtype, generator,
                      device) -> dict:
    """Stacked [L, ...] params of ``n_layers`` zamba2 blocks (Mamba2 mixer,
    two norms, FFN), drawn from ``generator``."""
    return {"mamba": init_mamba2(cfg, n_layers, dtype, generator, device),
            "norm_m": init_norm(cfg, dtype, device, n_layers),
            "mlp": init_mlp(cfg.d_model, cfg.d_ff, cfg.act, dtype, generator,
                            device, n_layers),
            "norm_f": init_norm(cfg, dtype, device, n_layers)}


def init_norm(cfg: ModelConfig, dtype, device, n_layers=None) -> dict:
    lead = () if n_layers is None else (n_layers,)
    shape = lead + (cfg.d_model,)
    if cfg.norm == "rmsnorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        return {"scale": torch.ones(shape, dtype=dtype, device=device),
                "bias": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.norm == "nonparam":
        return {}
    raise ValueError(cfg.norm)


# ---------------------------------------------------------------------------
# Mamba2 (SSD) mixer
# ---------------------------------------------------------------------------

def mamba2_meta(cfg: ModelConfig) -> dict:
    """Shapes of the Mamba2 mixer: inner width ``d_in``, ``nh`` heads of
    ``p`` channels, state size ``n``."""
    m = cfg.ssm
    d_in = m.expand * cfg.d_model
    nh = m.num_ssm_heads or max(1, d_in // 64)
    return {"d_in": d_in, "nh": nh, "p": d_in // nh, "n": m.state_dim}


def init_mamba2(cfg: ModelConfig, n_layers: int, dtype, generator,
                device) -> dict:
    """Stacked [L, ...] Mamba2 params with the reference's scales; A_log,
    D and dt_bias are float32 whatever the model's dtype, as there."""
    meta = mamba2_meta(cfg)
    d, d_in, nh, n = cfg.d_model, meta["d_in"], meta["nh"], meta["n"]
    lead = (n_layers,)

    def full(value, shape, dt):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        # fused input projection: [z | x | B | C | dt]
        "in_proj": _init_normal(lead + (d, 2 * d_in + 2 * n + nh),
                                1.0 / math.sqrt(d), dtype, generator, device),
        "conv": _init_normal(lead + (cfg.ssm.conv_width, d_in + 2 * n), 0.5,
                             dtype, generator, device),
        "A_log": full(0.0, (nh,), torch.float32),
        "D": full(1.0, (nh,), torch.float32),
        "dt_bias": full(0.0, (nh,), torch.float32),
        "norm_scale": full(1.0, (d_in,), dtype),
        "out_proj": _init_normal(lead + (d_in, d), 1.0 / math.sqrt(d_in),
                                 dtype, generator, device),
    }


def _ssd_chunk_scan(x, bmat, cmat, dt, a_log, d, dt_bias, chunk: int):
    """The chunked SSD scan in plain tensors, the reference's XLA path:
    x [B,S,nh,p], bmat/cmat [B,S,N], dt [B,S,nh] -> y [B,S,nh,p] in x's
    dtype, S a multiple of ``chunk``.  Per chunk: the intra-chunk term
    ``(C B^T o decay) @ (dt x)`` with the causal mask inside the exp, the
    carried state's ``exp(cum) C H``, and the state update; the log-decay
    is ``log(clip(a, 1e-20))`` as there.  (The carried term multiplies
    ``exp(cum)`` after the ``C . H`` product, which the reference forms
    before it: the same value without a [B, chunk, nh, p, N] temporary.)"""
    bsz, s, nh, p = x.shape
    n = bmat.shape[-1]
    dtv = ref.softplus(dt.float() + dt_bias)
    a = torch.exp(-dtv * torch.exp(a_log))
    nc = s // chunk
    xs = (x.float() * dtv[..., None]).reshape(bsz, nc, chunk, nh, p)
    bm = bmat.float().reshape(bsz, nc, chunk, n)
    cm = cmat.float().reshape(bsz, nc, chunk, n)
    al = torch.log(a.clamp_min(1e-20)).reshape(bsz, nc, chunk, nh)
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    h = torch.zeros((bsz, nh, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        cum = al[:, c].cumsum(1)                                  # [B,L,nh]
        total = cum[:, -1]                                        # [B,nh]
        diff = cum[:, :, None, :] - cum[:, None, :, :]            # [B,i,j,nh]
        decay = torch.exp(torch.where(tril, diff, -1e30))
        inner = torch.einsum("bin,bjn->bij", cm[:, c], bm[:, c])
        y_intra = torch.einsum("bijh,bjhp->bihp", inner[..., None] * decay,
                               xs[:, c])
        y_carry = torch.einsum("bin,bhpn->bihp", cm[:, c], h) \
            * torch.exp(cum)[..., None]
        decay_end = torch.exp(total[:, None, :] - cum)            # [B,L,nh]
        h = h * torch.exp(total)[..., None, None] + torch.einsum(
            "bjhp,bjn->bhpn", xs[:, c] * decay_end[..., None], bm[:, c])
        ys.append(y_intra + y_carry)
    y = torch.stack(ys, 1).reshape(bsz, s, nh, p)
    return (y + x.float() * d[:, None]).to(x.dtype)


def apply_mamba2(params, x, meta: dict, cfg: ModelConfig, *,
                 impl: str = "xla"):
    """The Mamba2/SSD mixer, x [B,S,d] -> [B,S,d]: the fused ``in_proj``
    split into z | x | B | C | dt, a causal depthwise conv with silu over
    [x | B | C], the SSD scan (``impl="xla"``: :func:`_ssd_chunk_scan`;
    ``"pallas"``: the ``ssd_scan`` kernel, K6, forward only) at the
    reference's chunk (``min(chunk, S)``, else the gcd with S), and the
    gated RMSNorm before ``out_proj``."""
    m = cfg.ssm
    d_in, nh, p, n = meta["d_in"], meta["nh"], meta["p"], meta["n"]
    bsz, s, _ = x.shape
    proj = x @ params["in_proj"]
    z, xi, bmat, cmat, dt = torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)
    conv_in = torch.cat([xi, bmat, cmat], dim=-1)                 # [B,S,C]
    w = params["conv"]                                            # [W, C]
    pad = F.pad(conv_in, (0, 0, m.conv_width - 1, 0))
    conv = sum(pad[:, i:i + s] * w[i] for i in range(m.conv_width))
    xi, bmat, cmat = torch.split(F.silu(conv), [d_in, n, n], dim=-1)
    xi = xi.reshape(bsz, s, nh, p)
    chunk = min(m.chunk, s)
    if s % chunk:
        chunk = math.gcd(s, chunk)
    if impl == "pallas":
        y = ops.ssd_scan(xi, bmat, cmat, dt, params["A_log"], params["D"],
                         params["dt_bias"], chunk=chunk)
    elif impl == "xla":
        y = _ssd_chunk_scan(xi, bmat, cmat, dt, params["A_log"], params["D"],
                            params["dt_bias"], chunk)
    else:
        raise ValueError(f"impl must be one of {ATTN_IMPLS}, got {impl!r}")
    y = y.reshape(bsz, s, d_in)
    y = apply_norm({"scale": params["norm_scale"]}, y * F.silu(z), "rmsnorm")
    return y @ params["out_proj"]


def mamba2_init_state(batch: int, meta: dict, cfg: ModelConfig, dtype,
                      device) -> tuple:
    """Zero decode state of one Mamba2 layer: the conv buffer ``[B, W-1,
    d_in + 2N]`` (the last W-1 conv inputs) in ``dtype`` and the SSM state
    ``[B, nh, p, N]`` in f32."""
    d_in, nh, p, n = meta["d_in"], meta["nh"], meta["p"], meta["n"]
    return (torch.zeros((batch, cfg.ssm.conv_width - 1, d_in + 2 * n),
                        dtype=dtype, device=device),
            torch.zeros((batch, nh, p, n), dtype=torch.float32,
                        device=device))


def mamba2_decode(params, x, state, meta: dict, cfg: ModelConfig):
    """One-token Mamba2 recurrence, x [B,1,d] -> [B,1,d].  ``state`` is
    ``(conv_buf [B,W-1,d_in+2N], h [B,nh,p,N])`` (:func:`mamba2_init_state`)
    and is updated IN PLACE, where the reference returns a new state.

    The reference's arithmetic: ``in_proj`` split into z | x | B | C | dt,
    the depthwise conv over the window ``[conv_buf | x B C]`` as one
    reduction over W, silu; ``dt = softplus(dt + dt_bias)`` and ``a =
    exp(-dt exp(A_log))`` in f32; ``h = a h + dt x B^T`` and ``y = C h +
    D x`` in f32, cast to x's dtype; the gated RMSNorm and ``out_proj``.
    The conv buffer takes the window's last W-1 rows from the new window
    (a shift of the buffer onto itself would be an overlapping copy)."""
    d_in, nh, p, n = meta["d_in"], meta["nh"], meta["p"], meta["n"]
    conv_buf, h = state
    bsz = x.shape[0]
    proj = x @ params["in_proj"]
    z, xi, bmat, cmat, dt = torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)
    window = torch.cat([conv_buf, torch.cat([xi, bmat, cmat], dim=-1)], dim=1)
    conv = F.silu(torch.einsum("bwc,wc->bc", window, params["conv"]))
    conv_buf.copy_(window[:, 1:])
    xi, bmat, cmat = torch.split(conv, [d_in, n, n], dim=-1)
    xf = xi.float().reshape(bsz, nh, p)
    dtv = ref.softplus(dt[:, 0].float() + params["dt_bias"])          # [B,nh]
    a = torch.exp(-dtv * torch.exp(params["A_log"]))                  # [B,nh]
    h.mul_(a[..., None, None]).add_(
        (xf * dtv[..., None])[..., None] * bmat.float()[:, None, None, :])
    y = torch.einsum("bn,bhpn->bhp", cmat.float(), h)
    y = (y + xf * params["D"][:, None]).to(x.dtype).reshape(bsz, 1, d_in)
    y = apply_norm({"scale": params["norm_scale"]}, y * F.silu(z), "rmsnorm")
    return y @ params["out_proj"]


# ---------------------------------------------------------------------------
# xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory)
# ---------------------------------------------------------------------------

MLSTM_CHUNK = 64    # the reference's chunk of the mLSTM scan (min(64, S))


def mlstm_meta(cfg: ModelConfig) -> dict:
    """Shapes of the mLSTM cell: inner width ``f = proj_factor * d`` in
    ``nh`` heads of ``hd``."""
    f = int(cfg.xlstm.proj_factor * cfg.d_model)
    return {"f": f, "nh": cfg.num_heads, "hd": f // cfg.num_heads}


def init_mlstm(cfg: ModelConfig, dtype, generator, device) -> dict:
    """mLSTM params in the reference's layouts: ``up [d, 2f]`` (``[x_inner |
    z]``), ``wq/wk/wv [f, nh, hd]``, the gate projection ``w_if [f, 2nh]``
    (``[i | f]``, float32 whatever the model's dtype), ``norm_scale [f]``
    and ``down [f, d]``."""
    meta = mlstm_meta(cfg)
    d, f, nh, hd = cfg.d_model, meta["f"], meta["nh"], meta["hd"]

    def normal(shape, scale, dt=dtype):
        return _init_normal(shape, scale, dt, generator, device)

    s_f = 1.0 / math.sqrt(f)
    return {"up": normal((d, 2 * f), 1.0 / math.sqrt(d)),
            "wq": normal((f, nh, hd), s_f), "wk": normal((f, nh, hd), s_f),
            "wv": normal((f, nh, hd), s_f),
            "w_if": normal((f, 2 * nh), s_f, torch.float32),
            "norm_scale": torch.ones((f,), dtype=dtype, device=device),
            "down": normal((f, d), s_f)}


def _mlstm_scan(q, k, v, i_gate, f_gate, chunk: int):
    """The chunked mLSTM, the reference's ``_mlstm_scan``: per head ``C_t =
    f_t C_{t-1} + i_t k_t v_t^T``, ``y_t = q_t C_t / max(|q_t n_t|,
    exp(-m_t))`` with the log-space stabiliser ``m`` (sigmoid forget gate,
    exp input gate).  q, k, v [B,S,nh,hd]; gates [B,S,nh] -> y [B,S,nh,hd]
    in q's dtype; S a multiple of ``chunk``.

    Per chunk: the intra-chunk term ``(q k^T / sqrt(hd) o w) v`` with the
    causal mask inside the exp, the carried memory's ``q C`` and ``q N``
    scaled from the running max, and the memory update.  The reference's
    three-operand einsums are taken as a product and a batched matmul
    (``(scores w) @ v``, ``(k g)^T @ v``), which never forms a
    [B, chunk, nh, hd, hd] temporary."""
    b, s, nh, hd = q.shape
    nc = s // chunk
    scale = math.sqrt(hd)
    lf = F.logsigmoid(f_gate.float()).reshape(b, nc, chunk, nh)
    li = i_gate.float().reshape(b, nc, chunk, nh)

    def chunks(t):                       # [B,S,nh,hd] -> [B,nc,nh,chunk,hd]
        return t.float().reshape(b, nc, chunk, nh, hd).transpose(2, 3)

    qc, kc, vc = chunks(q), chunks(k), chunks(v)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()[None, :, :, None]
    c_mem = q.new_zeros((b, nh, hd, hd), dtype=torch.float32)
    n_mem = q.new_zeros((b, nh, hd), dtype=torch.float32)
    m_run = q.new_full((b, nh), -1e30, dtype=torch.float32)
    ys = []
    for c in range(nc):
        lfx, lix = lf[:, c], li[:, c]                             # [B,L,nh]
        qx, kx, vx = qc[:, c], kc[:, c], vc[:, c]                 # [B,nh,L,hd]
        cumf = torch.cumsum(lfx, dim=1)
        total = cumf[:, -1]                                       # [B,nh]
        log_g = lix + (total[:, None] - cumf)                     # j -> end
        m_new = torch.maximum(m_run + total, torch.amax(log_g, dim=1))
        d_ij = cumf[:, :, None, :] - cumf[:, None, :, :] + lix[:, None, :, :]
        m_i = torch.maximum(
            m_run[:, None] + cumf,
            torch.amax(torch.where(mask, d_ij, -math.inf), dim=2))  # [B,L,nh]
        w_ij = torch.exp(torch.where(mask, d_ij - m_i[:, :, None, :], -1e30))
        w_hij = w_ij.permute(0, 3, 1, 2)                          # [B,nh,i,j]
        scores = (qx @ kx.transpose(-1, -2)) / scale              # [B,nh,i,j]
        sw = scores * w_hij
        y_intra = sw @ vx                                         # [B,nh,L,hd]
        carry_scale = torch.exp(m_run[:, None] + cumf - m_i).transpose(1, 2)
        y_carry = (qx @ c_mem) / scale * carry_scale[..., None]
        n_i = (qx @ n_mem[..., None])[..., 0] / scale * carry_scale \
            + sw.sum(-1)                                          # [B,nh,L]
        denom = torch.maximum(n_i.abs(), torch.exp(-m_i).transpose(1, 2))
        ys.append((y_intra + y_carry) / denom[..., None])
        g = torch.exp(log_g - m_new[:, None]).transpose(1, 2)     # [B,nh,L]
        decay = torch.exp(m_run + total - m_new)                  # [B,nh]
        kg = kx * g[..., None]
        c_mem = c_mem * decay[..., None, None] + kg.transpose(-1, -2) @ vx
        n_mem = n_mem * decay[..., None] + kg.sum(2)
        m_run = m_new
    y = torch.stack(ys, 1)                                     # [B,nc,nh,L,hd]
    return y.transpose(2, 3).reshape(b, s, nh, hd).to(q.dtype)


def _mlstm_qkv_gates(params, x):
    """The mLSTM's projections of x [B,S,d]: q, k, v [B,S,nh,hd] in x's
    dtype, the gates ``xi.float() @ w_if`` [B,S,2nh] in f32 and z."""
    xi, z = (x @ params["up"]).chunk(2, dim=-1)
    q, k, v = (_heads(xi, params[n]) for n in ("wq", "wk", "wv"))
    return q, k, v, xi.float() @ params["w_if"], z


def _mlstm_out(params, y, z):
    """The gated RMSNorm ``rmsnorm(y * silu(z))`` and ``down``."""
    y = apply_norm({"scale": params["norm_scale"]}, y * F.silu(z), "rmsnorm")
    return y @ params["down"]


def apply_mlstm(params, x, meta: dict, cfg: ModelConfig,
                chunk: int = MLSTM_CHUNK):
    """The mLSTM cell over a sequence, x [B,S,d] -> [B,S,d]: ``up`` split
    into x_inner | z, q/k/v from x_inner, the i | f gates in f32, the scan
    at ``min(chunk, S)``, the gated RMSNorm and ``down``.  An S above the
    chunk that is not a multiple of it is refused, where the reference's
    reshape fails."""
    bsz, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"apply_mlstm: sequence length {s} is not a "
                         f"multiple of the scan's chunk {chunk}")
    q, k, v, gates, z = _mlstm_qkv_gates(params, x)
    i_gate, f_gate = gates.chunk(2, dim=-1)
    y = _mlstm_scan(q, k, v, i_gate, f_gate, chunk)
    return _mlstm_out(params, y.reshape(bsz, s, meta["f"]), z)


def mlstm_init_state(batch: int, meta: dict, device) -> tuple:
    """Fresh mLSTM decode state ``(C [B,nh,hd,hd], N [B,nh,hd], m [B,nh])``,
    all f32: C and N zero, the stabiliser m at -1e30."""
    nh, hd = meta["nh"], meta["hd"]
    return (torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, nh, hd), dtype=torch.float32, device=device),
            torch.full((batch, nh), -1e30, dtype=torch.float32,
                       device=device))


def mlstm_decode(params, x, state, meta: dict, cfg: ModelConfig):
    """One-token mLSTM step, x [B,1,d] -> [B,1,d]; ``state`` (C, N, m)
    (:func:`mlstm_init_state`) is updated IN PLACE, where the reference
    returns a new one.  As there, C and N take the unscaled k and only the
    read-out ``q C`` and ``q N`` are divided by sqrt(hd)."""
    f, nh, hd = meta["f"], meta["nh"], meta["hd"]
    c_mem, n_mem, m_run = state
    q, k, v, gates, z = _mlstm_qkv_gates(params, x)
    q, k, v = (t[:, 0].float() for t in (q, k, v))                # [B,nh,hd]
    li, lf = gates[:, 0].chunk(2, dim=-1)                         # [B,nh]
    lf = F.logsigmoid(lf)
    m_new = torch.maximum(m_run + lf, li)
    decay = torch.exp(m_run + lf - m_new)
    ki = k * torch.exp(li - m_new)[..., None]
    c_mem.mul_(decay[..., None, None]).add_(ki[..., :, None] * v[..., None, :])
    n_mem.mul_(decay[..., None]).add_(ki)
    m_run.copy_(m_new)
    scale = math.sqrt(hd)
    y = (q[..., None, :] @ c_mem)[..., 0, :] / scale              # [B,nh,hd]
    n = (q * n_mem).sum(-1) / scale
    y = y / torch.maximum(n.abs(), torch.exp(-m_new))[..., None]
    return _mlstm_out(params, y.reshape(x.shape[0], 1, f).to(x.dtype), z)


def init_slstm(cfg: ModelConfig, dtype, generator, device) -> dict:
    """sLSTM params in the reference's layouts: input and recurrent weights
    ``w_x``, ``w_h`` [d, 4d] (gates i, f, z, o), ``bias [4d]`` (float32, 0)
    and ``down [d, d]``."""
    d = cfg.d_model
    s = 1.0 / math.sqrt(d)

    def normal(shape):
        return _init_normal(shape, s, dtype, generator, device)

    return {"w_x": normal((d, 4 * d)), "w_h": normal((d, 4 * d)),
            "bias": torch.zeros((4 * d,), dtype=torch.float32, device=device),
            "down": normal((d, d))}


def _slstm_cell(params, x_t, state) -> tuple:
    """One sLSTM step with exponential gating and the stabiliser, the
    reference's ``_slstm_cell``: x_t [B,d]; ``state`` (c, n, h, m), each
    [B,d] f32.  The recurrent h is cast to the params' dtype for its
    product; the pre-activation is taken in f32 with the bias.  Returns the
    new state."""
    c, n, h, m = state
    pre = (x_t @ params["w_x"] + h.to(x_t.dtype) @ params["w_h"]).float() \
        + params["bias"]
    i_, f_, z_, o_ = pre.chunk(4, dim=-1)
    lf = F.logsigmoid(f_)
    m_new = torch.maximum(lf + m, i_)
    i_g = torch.exp(i_ - m_new)
    f_g = torch.exp(lf + m - m_new)
    c = f_g * c + i_g * torch.tanh(z_)
    n = f_g * n + i_g
    # torch.maximum, not clamp: at n == 1 (the first step, whenever i >= f)
    # its gradient splits evenly, as jnp.maximum's does
    h_new = torch.sigmoid(o_) * c / torch.maximum(n, n.new_ones(()))
    return c, n, h_new, m_new


def slstm_init_state(batch: int, d: int, device) -> tuple:
    """Fresh sLSTM decode state ``(c, n, h, m)``, each [B,d] f32 zeros (m
    too, as in the reference)."""
    return tuple(torch.zeros((batch, d), dtype=torch.float32, device=device)
                 for _ in range(4))


def apply_slstm(params, x, meta: dict, cfg: ModelConfig):
    """The sLSTM over a sequence, x [B,S,d] -> [B,S,d]: the cell a step at a
    time from a zero state (a plain loop over S: the reference has no
    kernel here), then ``down`` on the hidden states in x's dtype."""
    bsz, s, d = x.shape
    state = slstm_init_state(bsz, d, x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(params, x[:, t], state)
        hs.append(state[2])
    return torch.stack(hs, 1).to(x.dtype) @ params["down"]


def slstm_decode(params, x, state, meta: dict, cfg: ModelConfig):
    """One-token sLSTM step, x [B,1,d] -> [B,1,d]; ``state`` (c, n, h, m)
    is updated IN PLACE."""
    new = _slstm_cell(params, x[:, 0], state)
    for dst, src in zip(state, new):
        dst.copy_(src)
    return state[2][:, None].to(x.dtype) @ params["down"]
