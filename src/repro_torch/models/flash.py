"""Memory-linear attention of the port (``repro.models.flash``): train
mode and prefills of at least ``BLOCKWISE_THRESHOLD`` tokens attend
blockwise with an online softmax, as the reference does there.

The reference writes this in jnp (``lax.scan`` over tiles), not in
Pallas, so the port writes it in torch operations.  Two points carry
over:

* a custom backward (:class:`FlashAttention`, FlashAttention-2's
  residuals): the forward saves only the output and each row's
  log-sum-exp, and the backward recomputes every tile's probabilities
  from them, so neither pass holds the T x S scores;
* structural masks: causal and window masks come from the block offsets
  (positions are implicitly ``arange``, true of every train and prefill
  call); raggedness comes in through ``kv_valid [B, S]``.

A tile that the causal or window mask empties entirely is skipped: in
the reference it adds exact zeros (its running max and sum stay as they
were), so skipping it changes no value.  A query row with no valid key
gets 0, as in :func:`models.layers.attend`.

A row's live tiles, and the backward's, iterate by
``core.cost_hooks.trips``: all of a row's tiles but a partial last block
have one shape, so the dry run runs two of them and weights the second.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.cost_hooks import trips

NEG_INF = -1e30
BLOCK = 512


def _struct_mask(qs: int, qe: int, ks: int, ke: int,
                 window: Optional[int], causal: bool,
                 device) -> torch.Tensor:
    """[qe - qs, ke - ks] mask of the tile from its offsets."""
    rows = torch.arange(qs, qe, device=device)[:, None]
    cols = torch.arange(ks, ke, device=device)[None, :]
    m = torch.ones((qe - qs, ke - ks), dtype=torch.bool, device=device)
    if causal:
        m = m & (cols <= rows)
    if window is not None:
        m = m & (rows - cols < window)
    return m


def _tile_live(qs: int, qe: int, ks: int, ke: int,
               window: Optional[int], causal: bool) -> bool:
    """Whether any (query, key) pair of the tile survives the structural
    mask."""
    if causal and ks > qe - 1:
        return False
    return window is None or qs - (ke - 1) < window


def _tiles(t: int, s: int, q_block: int, kv_block: int,
           window: Optional[int], causal: bool):
    """(qs, qe, ks, ke) of every live tile, kv-block-major."""
    return [(qs, min(qs + q_block, t), ks, min(ks + kv_block, s))
            for ks in range(0, s, kv_block) for qs in range(0, t, q_block)
            if _tile_live(qs, min(qs + q_block, t), ks,
                          min(ks + kv_block, s), window, causal)]


def _tile_mask(kv_valid, qs, qe, ks, ke, window, causal, device):
    """[B or 1, 1, 1, q, k] mask of a tile for the [B, KV, G, q, k]
    scores."""
    m = _struct_mask(qs, qe, ks, ke, window, causal, device)[None]
    if kv_valid is not None:
        m = m & kv_valid[:, None, ks:ke]
    return m[:, None, None]


def _forward(q, k, v, kv_valid, window, causal, q_block, kv_block):
    """q [B,T,KV,G,D]; k, v [B,S,KV,D] -> (out [B,T,KV,G,D] in q's
    dtype, lse [B,T,KV,G] fp32)."""
    b, t, kvh, g, d = q.shape
    s = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((b, t, kvh, g, d), dtype=torch.float32, device=q.device)
    lse = torch.zeros((b, t, kvh, g), dtype=torch.float32, device=q.device)
    for qs in range(0, t, q_block):
        qe = min(qs + q_block, t)
        qi = qf[:, qs:qe]
        m = torch.full((b, kvh, g, qe - qs), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kvh, g, qe - qs, d), device=q.device)
        live = [ks for ks in range(0, s, kv_block)
                if _tile_live(qs, qe, ks, min(ks + kv_block, s), window,
                              causal)]
        for j in trips(len(live)):
            ks = live[j]
            ke = min(ks + kv_block, s)
            msk = _tile_mask(kv_valid, qs, qe, ks, ke, window, causal,
                             q.device)
            sc = torch.einsum("bqkgd,bskd->bkgqs", qi, kf[:, ks:ke]) * scale
            sc = torch.where(msk, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp(m - m_new)
            pr = torch.where(msk, torch.exp(sc - m_new[..., None]), 0.0)
            l = l * alpha + pr.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", pr, vf[:, ks:ke])
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        out[:, qs:qe] = (acc / l_safe[..., None]).permute(0, 3, 1, 2, 4)
        lse[:, qs:qe] = (m + torch.log(l_safe)).permute(0, 3, 1, 2)
    return out.to(q.dtype), lse


def _backward(q, k, v, kv_valid, out, lse, dout, window, causal,
              q_block, kv_block):
    """Gradients (dq, dk, dv) recomputed tile by tile from ``lse``."""
    b, t, kvh, g, d = q.shape
    s = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    delta = (dof * out.float()).sum(-1)                       # [B,T,KV,G]
    lse_t = lse.permute(0, 2, 3, 1)                           # [B,KV,G,T]
    delta_t = delta.permute(0, 2, 3, 1)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    tiles = _tiles(t, s, q_block, kv_block, window, causal)
    for j in trips(len(tiles)):
        qs, qe, ks, ke = tiles[j]
        msk = _tile_mask(kv_valid, qs, qe, ks, ke, window, causal, q.device)
        qi, doi = qf[:, qs:qe], dof[:, qs:qe]
        kj, vj = kf[:, ks:ke], vf[:, ks:ke]
        sc = torch.einsum("bqkgd,bskd->bkgqs", qi, kj) * scale
        pr = torch.where(msk, torch.exp(sc - lse_t[..., qs:qe, None]), 0.0)
        dpr = torch.einsum("bqkgd,bskd->bkgqs", doi, vj)
        ds = pr * (dpr - delta_t[..., qs:qe, None]) * scale
        dv[:, ks:ke] += torch.einsum("bkgqs,bqkgd->bskd", pr, doi)
        dk[:, ks:ke] += torch.einsum("bkgqs,bqkgd->bskd", ds, qi)
        dq[:, qs:qe] += torch.einsum("bkgqs,bskd->bqkgd", ds, kj)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Blockwise attention whose backward recomputes the tiles from the
    saved log-sum-exp (the reference's ``flash_attention`` custom VJP).
    ``q [B,T,KV,G,D]``, ``k``/``v [B,S,KV,D]``, ``kv_valid [B,S]`` bool
    or None."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, window, causal, q_block, kv_block):
        out, lse = _forward(q, k, v, kv_valid, window, causal, q_block,
                            kv_block)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.opts = (window, causal, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, kv_valid, out, lse, dout, *ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 kv_valid: Optional[torch.Tensor] = None,
                 window: Optional[int] = None, causal: bool = True,
                 q_block: int = BLOCK, kv_block: int = BLOCK) -> torch.Tensor:
    """The blockwise twin of :func:`models.layers.attend` over ``arange``
    positions: q [B,T,H,D]; k, v [B,S,KV,D]; ``kv_valid [B,S]`` bool (None:
    every key valid)."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    out = FlashAttention.apply(q.reshape(b, t, kvh, h // kvh, d), k, v,
                               kv_valid, window, causal, q_block, kv_block)
    return out.reshape(b, t, h, d)
