"""Transformer building blocks, as plain functions on tensors.

Counterpart of the reference's ``models/layers.py``, limited to what the
dense and hybrid families need: the full-sequence forward of training and
scoring, the Mamba2 mixer, and the decode step of serving.  Layouts follow
the reference: ``wq [d,H,hd]``, ``wk/wv [d,KV,hd]``, ``wo [H,hd,d]``,
cache ``[B,S,KV,hd]``, FFN ``wi/wg [d,ff]``, ``wo [ff,d]``, Mamba2
``in_proj [d, 2 d_in + 2 N + nh]``, ``conv [W, d_in + 2 N]``,
``out_proj [d_in, d]``.  The compute dtype is the input dtype; norms, rope,
softmax and the SSM state run in f32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.masked_matmul import BLOCK_N


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
# rotary embeddings: 1d / GLM-2d
# ---------------------------------------------------------------------------

def _rope_angles(positions, dim: int, base: float = 10000.0):
    """positions [..., S] -> (sin, cos) [..., S, dim//2] in f32."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    freqs = 1.0 / (base ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def _rotate(x, sin, cos):
    """x [..., dim], rotating interleaved pairs (x[..., ::2], x[..., 1::2])."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(x.shape)


def apply_rope(x, positions, kind: str):
    """x [B, S, n, head_dim]; positions [P, B, S] with P=1 (1d) or 2 (GLM
    2d: first half of head_dim by stream 0, second by stream 1)."""
    if kind == "none":
        return x
    hd = x.shape[-1]
    xf = x.float()
    if kind == "1d":
        sin, cos = _rope_angles(positions[0], hd)
        out = _rotate(xf, sin[:, :, None, :], cos[:, :, None, :])
    elif kind == "2d":
        h = hd // 2
        s0, c0 = _rope_angles(positions[0], h)
        s1, c1 = _rope_angles(positions[1], h)
        out = torch.cat([
            _rotate(xf[..., :h], s0[:, :, None, :], c0[:, :, None, :]),
            _rotate(xf[..., h:], s1[:, :, None, :], c1[:, :, None, :]),
        ], dim=-1)
    elif kind == "mrope":
        raise ValueError("rope='mrope' (qwen2-vl) is not ported yet")
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


def default_positions(batch: int, seq: int, kind: str, offset: int = 0, *,
                      device="cpu"):
    """[P, B, S] int32 positions ``arange(seq) + offset`` per rope stream."""
    p = {"none": 1, "1d": 1, "2d": 2, "mrope": 3}[kind]
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
                    attn_impl: str = "xla"):
    """Causal self-attention over a whole sequence: q/k/v projections, rope,
    attention (optionally over a sliding ``window``), the output projection.
    x [B,S,d] -> [B,S,d].  ``attn_impl="xla"`` runs the plain
    :func:`attention` (differentiable); ``"pallas"`` runs the
    ``flash_attention`` kernel (K4), forward only."""
    b, s, _ = x.shape
    q = apply_rope(_heads(x, params["wq"]), positions, cfg.rope)
    k = apply_rope(_heads(x, params["wk"]), positions, cfg.rope)
    v = _heads(x, params["wv"])
    if attn_impl == "pallas":
        out = ops.flash_attention(q, k, v, causal=True, window=window)
    elif attn_impl == "xla":
        out = attention(q, k, v, causal=True, window=window)
    else:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    wo = params["wo"]
    return out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


# ---------------------------------------------------------------------------
# attention decode against the KV cache
# ---------------------------------------------------------------------------


def attention_decode(params, x, cache_k, cache_v, cache_index, positions,
                     cfg: ModelConfig):
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
    """
    b = x.shape[0]
    s_cache, kvh, hd = cache_k.shape[1], cache_k.shape[2], cache_k.shape[3]
    q = apply_rope(_heads(x, params["wq"]), positions, cfg.rope)
    k_new = apply_rope(_heads(x, params["wk"]), positions, cfg.rope)
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
    return out.reshape(b, 1, h * hd) @ wo.reshape(h * hd, wo.shape[-1])


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU), optionally FedAP-masked
# ---------------------------------------------------------------------------

def apply_mlp(params, x, act: str, mask=None):
    """Dense FFN (GELU in the tanh form, as ``jax.nn.gelu``).  With ``mask``
    ([d_ff] 0/1) the pruned hidden units are zeroed at the pre-activation
    (silu(0) = gelu(0) = 0 through wo, so the logits equal the shrunk
    model's) and the up/gate products go through :func:`masked_dense`, which
    skips fully pruned 128-column blocks."""
    if mask is None:
        h = x @ params["wi"]
        if act == "silu":
            h = F.silu(x @ params["wg"]) * h
        else:
            h = F.gelu(h, approximate="tanh")
        return h @ params["wo"]
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    h = masked_dense(x2, params["wi"], mask)
    if act == "silu":
        h = F.silu(masked_dense(x2, params["wg"], mask)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return (h @ params["wo"]).reshape(shape)


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


def _init_normal(shape, scale, dtype, generator, device):
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def init_attention(cfg: ModelConfig, dtype, generator, device,
                   n_layers=None) -> dict:
    """Attention params ``{wq, wk, wv, wo}`` (stacked ``[L, ...]`` when
    ``n_layers`` is given), drawn from ``generator``."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    if cfg.pad_heads_to and h % cfg.pad_heads_to:
        raise ValueError("pad_heads_to is not ported yet")
    lead = () if n_layers is None else (n_layers,)
    s = 1.0 / math.sqrt(d)

    def normal(shape, scale):
        return _init_normal(lead + shape, scale, dtype, generator, device)

    return {"wq": normal((d, h, hd), s), "wk": normal((d, kv, hd), s),
            "wv": normal((d, kv, hd), s),
            "wo": normal((h, hd, d), 1.0 / math.sqrt(h * hd))}


def init_mlp_stack(cfg: ModelConfig, n_layers: int, dtype, generator,
                   device) -> dict:
    """Stacked [L, ...] FFN params ``{wi, [wg], wo}``."""
    d = cfg.d_model
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(cfg.d_ff)
    mlp = {"wi": _init_normal((n_layers, d, cfg.d_ff), s_in, dtype,
                              generator, device)}
    if cfg.act == "silu":
        mlp["wg"] = _init_normal((n_layers, d, cfg.d_ff), s_in, dtype,
                                 generator, device)
    mlp["wo"] = _init_normal((n_layers, cfg.d_ff, d), s_out, dtype,
                             generator, device)
    return mlp


def init_layer_stack(cfg: ModelConfig, n_layers: int, dtype, generator,
                     device) -> dict:
    """Stacked [L, ...] params of ``n_layers`` dense blocks (attention, two
    norms, FFN), drawn from ``generator``."""
    attn = init_attention(cfg, dtype, generator, device, n_layers)
    return {"attn": attn, "norm_a": init_norm(cfg, dtype, device, n_layers),
            "mlp": init_mlp_stack(cfg, n_layers, dtype, generator, device),
            "norm_f": init_norm(cfg, dtype, device, n_layers)}


def init_hybrid_stack(cfg: ModelConfig, n_layers: int, dtype, generator,
                      device) -> dict:
    """Stacked [L, ...] params of ``n_layers`` zamba2 blocks (Mamba2 mixer,
    two norms, FFN), drawn from ``generator``."""
    return {"mamba": init_mamba2(cfg, n_layers, dtype, generator, device),
            "norm_m": init_norm(cfg, dtype, device, n_layers),
            "mlp": init_mlp_stack(cfg, n_layers, dtype, generator, device),
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
