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
