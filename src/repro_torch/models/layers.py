"""Transformer layers of the port: RMSNorm, half-split RoPE, GQA
projections, masked attention, SwiGLU MLP.

Plain functions on tensors over the reference's parameter layouts
(``repro.models.layers``): ``wq [d, H, D]``, ``wo [H, D, d]``, norms as
offsets from 1.  The einsums of the reference are written as matrix
products over the flattened head axes, which is the same contraction.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[B, T, 1, D/2]`` of ``positions [B, T]``; computed
    once per forward and shared by every layer's q and k."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions.float()[..., None, None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor]
               ) -> torch.Tensor:
    """Rotate ``x [B, T, H, D]`` by :func:`rope_angles` (half-split
    layout: the first and second halves of D form the pairs)."""
    cos, sin = rope
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("btd,dhk->bthk")`` as one matrix product."""
    b, t, d = x.shape
    return (x.reshape(b * t, d) @ w.reshape(d, -1)).reshape(
        b, t, w.shape[1], w.shape[2])


def qkv_project(p: dict, x: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> q [B,T,H,D], k/v [B,T,KV,D], RoPE applied."""
    q = apply_rope(_proj(x, p["wq"]), rope)
    k = apply_rope(_proj(x, p["wk"]), rope)
    v = _proj(x, p["wv"])
    return q, k, v


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           q_pos: torch.Tensor, kv_pos: torch.Tensor,
           kv_valid: torch.Tensor, window: Optional[int] = None,
           causal: bool = True) -> torch.Tensor:
    """Masked GQA attention that materializes the scores (prefill and
    the CPU reference path).  q [B,T,H,D]; k,v [B,S,KV,D]; q_pos [B,T];
    kv_pos [B,S]; kv_valid [B,S] bool.  A query row with no valid key
    gets 0, like the reference's ``attend`` and the paged kernel."""
    b, t, h, d = q.shape
    kv_heads = k.shape[2]
    qr = q.reshape(b, t, kv_heads, h // kv_heads, d).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qr, k.float()) / math.sqrt(d)
    mask = kv_valid[:, None, :]                                   # [B,1,S]
    if causal:
        mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])   # [B,T,S]
    else:
        mask = mask.expand(b, t, k.shape[1])
    if window is not None:
        mask = mask & (q_pos[:, :, None] - kv_pos[:, None, :] < window)
    m = mask[:, None, None]                                       # [B,1,1,T,S]
    probs = torch.softmax(scores.masked_fill(~m, NEG_INF), dim=-1)
    probs = torch.where(m.any(-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def attn_output(p: dict, out: torch.Tensor) -> torch.Tensor:
    """``einsum("bthk,hkd->btd")`` as one matrix product."""
    b, t, h, hd = out.shape
    wo = p["wo"]
    return (out.reshape(b * t, h * hd) @ wo.reshape(h * hd, -1)).reshape(
        b, t, -1)


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    gate = torch.nn.functional.silu(x @ p["w_gate"])
    return (gate * (x @ p["w_up"])) @ p["w_down"]
