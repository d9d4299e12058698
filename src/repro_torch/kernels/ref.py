"""Plain PyTorch versions of the kernels (the CPU path and the card-side
yardstick each CUDA kernel is held against)."""
from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k, v, lengths=None):
    """q [B,1,H,hd], cache k/v [B,S,KV,hd] -> [B,1,H,hd].

    Query head ``h = g * KV + kv`` attends kv head ``kv`` (the reference's
    [g, kv] grouping).  ``lengths`` (int [B]), when given, limits sequence
    ``b`` to its first ``lengths[b]`` cache slots; without it every slot is
    attended.  Softmax runs in f32.  Slots past ``lengths[b]`` never reach
    the output, not even a non-finite stale value, and a length of 0 gives
    0 — the semantics of the Pallas and CUDA kernels (the reference's
    ``decode_attention_ref`` agrees for every length >= 1 with finite
    caches).
    """
    b, _, h, hd = q.shape
    s_len, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, g, kvh, hd).float()
    scores = torch.einsum("bgkd,bskd->bgks", qg, k.float()) / math.sqrt(hd)
    if lengths is None:
        valid = torch.ones((b, s_len), dtype=torch.bool, device=q.device)
    else:
        valid = (torch.arange(s_len, device=q.device)[None, :]
                 < lengths.to(q.device)[:, None])                    # [B, S]
    scores = scores.masked_fill(~valid[:, None, None, :], -math.inf)
    m = scores.amax(-1, keepdim=True).clamp_min(-1e30)   # no valid slot: -1e30
    p = torch.exp(scores - m)
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    vv = torch.where(valid[:, :, None, None], v.float(), 0.0)
    out = torch.einsum("bgks,bskd->bgkd", p, vv) / denom
    return out.reshape(b, 1, h, hd).to(q.dtype)


def masked_matmul_ref(x, w, block_mask, *, block_n: int = 128):
    """``x @ w`` in f32 with the column blocks whose ``block_mask`` entry is
    not > 0 written as zeros, cast to ``x.dtype``.  Equals the reference's
    ``masked_matmul_ref`` for 0/1 masks and the Pallas kernel for any
    mask."""
    keep = torch.repeat_interleave(block_mask.to(x.device) > 0, block_n)
    out = x.float() @ w.float()
    return torch.where(keep[None, :], out, 0.0).to(x.dtype)


def _keep_columns(block_mask, n: int, device, block_n: int = 128):
    """[n] bool: True on the columns of the kept 128-column blocks."""
    keep = torch.repeat_interleave(block_mask.to(device) > 0, block_n)
    if keep.numel() != n:
        raise ValueError(f"block_mask covers {keep.numel()} columns, not {n}")
    return keep


def masked_matmul_dx_ref(dy, w, block_mask, *, block_n: int = 128):
    """``dx = dy @ w.T`` in f32 over the kept column blocks of ``w`` only
    (the pruned blocks of the contraction are never read), cast to
    ``dy.dtype``.  dy [M,N], w [K,N] -> [M,K]."""
    keep = _keep_columns(block_mask, w.shape[1], dy.device, block_n)
    return (dy.float()[:, keep] @ w.float()[:, keep].T).to(dy.dtype)


def masked_matmul_dw_ref(x, dy, block_mask, *, block_n: int = 128):
    """``dw = x.T @ dy`` in f32 with the pruned column blocks written as
    exact zeros, cast to ``x.dtype``.  x [M,K], dy [M,N] -> [K,N]."""
    keep = _keep_columns(block_mask, dy.shape[1], x.device, block_n)
    out = torch.zeros((x.shape[1], dy.shape[1]), dtype=torch.float32,
                      device=x.device)
    out[:, keep] = x.float().T @ dy.float()[:, keep]
    return out.to(x.dtype)


def visible(sq: int, skv: int, *, causal: bool, window=None, q_offset: int = 0,
            device="cpu"):
    """[sq, skv] bool: key ``kpos`` is visible to query ``qpos = q_offset +
    row`` iff ``kpos <= qpos`` (when ``causal``) and ``kpos > qpos - window``
    (when a window is given); positions count from 0 on both sides."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return ok


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q [B,Sq,H,hd], k/v [B,Skv,KV,hd] -> [B,Sq,H,hd] in q's type.

    Query head ``h = g * KV + kv`` attends kv head ``kv`` (the [g, kv]
    grouping), scores scaled by 1/sqrt(hd), softmax in f32 over the keys
    :func:`visible` to each query.  A query row that sees no key gives 0,
    not NaN (the Pallas and CUDA kernels' ``max(l, 1e-30)``); every other
    row equals the reference's ``flash_attention_ref``.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, h // kvh, kvh, hd).float()
    scores = torch.einsum("bqgkd,bskd->bgkqs", qg, k.float())
    scores.mul_(1.0 / math.sqrt(hd))
    ok = visible(sq, skv, causal=causal, window=window, device=q.device)
    scores.masked_fill_(~ok, -math.inf)
    m = scores.amax(-1, keepdim=True).clamp_min(-1e30)   # no key: -1e30
    p = scores.sub_(m).exp_()
    p.div_(p.sum(-1, keepdim=True).clamp_min(1e-30))
    out = torch.einsum("bgkqs,bskd->bqgkd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def softplus(z):
    """``jax.nn.softplus`` (log(1 + e^z) without overflow), elementwise."""
    return z.clamp_min(0) + torch.log1p(torch.exp(-z.abs()))


def ssd_scan_ref(x, bmat, cmat, dt, a_log, d, dt_bias):
    """The Mamba2 SSD recurrence, one step at a time (the definition):
    x [B,S,nh,p], bmat/cmat [B,S,N], dt [B,S,nh], a_log/d/dt_bias [nh] f32
    -> y [B,S,nh,p] in x's type.  Per head, with dtv = softplus(dt + bias)
    and a = exp(-dtv exp(a_log)): H_t = a_t H_{t-1} + (dtv_t x_t) B_t^T,
    y_t = C_t H_t + D x_t, the state H [p, N] in f32 from zero."""
    bsz, s, nh, p = x.shape
    n = bmat.shape[-1]
    dtv = softplus(dt.float() + dt_bias.float())
    a = torch.exp(-dtv * torch.exp(a_log.float()))
    xf = x.float()
    bf, cf = bmat.float(), cmat.float()
    h = torch.zeros((bsz, nh, p, n), dtype=torch.float32, device=x.device)
    ys = torch.empty((bsz, s, nh, p), dtype=torch.float32, device=x.device)
    for t in range(s):
        xt = xf[:, t] * dtv[:, t, :, None]                       # [B, nh, p]
        h = h * a[:, t, :, None, None] + xt[..., None] * bf[:, t, None, None, :]
        ys[:, t] = torch.einsum("bn,bhpn->bhp", cf[:, t], h)
    y = ys + xf * d.float()[:, None]
    return y.to(x.dtype)
