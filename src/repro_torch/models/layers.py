"""Transformer layers of the port: RMSNorm, half-split RoPE (and
M-RoPE), GQA
projections (with the optional qkv bias and qk norm), masked attention,
SwiGLU MLP.

Plain functions on tensors over the reference's parameter layouts
(``repro.models.layers``): ``wq [d, H, D]``, ``wo [H, D, d]``, norms as
offsets from 1.  The einsums of the reference are written as matrix
products over the flattened head axes, which is the same contraction.

On a serving mesh the functions take this rank's shards (the query
heads with their ``bq`` rows, the KV heads and ``bk``/``bv`` where they
split, the MLP width); :func:`attn_output` and :func:`mlp_apply` end in
the all-reduce over *model* when given the plan whose shards they
contract (``core/tp.py``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.core.tp import all_reduce_model

NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[Tuple[int, int, int]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[B, T, 1, D/2]`` of ``positions``; computed once per
    forward and shared by every layer's q and k.

    ``positions [B, T]``: 1-D RoPE.  ``positions [B, T, 3]`` (M-RoPE,
    with ``mrope_sections``): the temporal, height and width streams;
    frequency ``j`` of the D/2 takes the stream of the section it falls
    in (the first ``sections[0]`` frequencies the temporal one, and so
    on).  A text token carries the same value in all three streams, so
    ``[B, T]`` positions are the 1-D path, bit for bit, as the
    reference's broadcast to three equal streams is."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    if positions.dim() == 3:
        assert mrope_sections is not None and sum(mrope_sections) == half, (
            mrope_sections, half)
        stream = [i for i, n in enumerate(mrope_sections) for _ in range(n)]
        pos = positions.float()[..., stream]                  # [B, T, D/2]
        angles = pos[..., None, :] * freqs
    else:
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


def head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("btd,dhk->bthk")`` as one matrix product."""
    b, t, d = x.shape
    return (x.reshape(b * t, d) @ w.reshape(d, -1)).reshape(
        b, t, w.shape[1], w.shape[2])


def qkv_project(p: dict, cfg: ModelConfig, x: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, T, d] -> q [B,T,H,D], k/v [B,T,KV,D]: the projections, then
    the bias (``qkv_bias``), then the per-head RMSNorm (``qk_norm``),
    then RoPE on q and k, in the reference's order."""
    q, k, v = (head_proj(x, p[w]) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(q, rope), apply_rope(k, rope), v


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


def attn_output(p: dict, out: torch.Tensor, reduce_plan=None) -> torch.Tensor:
    """``einsum("bthk,hkd->btd")`` as one matrix product; with
    ``reduce_plan`` (heads split over *model*) a partial sum, all-reduced
    over *model*."""
    b, t, h, hd = out.shape
    wo = p["wo"]
    y = (out.reshape(b * t, h * hd) @ wo.reshape(h * hd, -1)).reshape(
        b, t, -1)
    return y if reduce_plan is None else all_reduce_model(y, reduce_plan)


def mlp_apply(p: dict, x: torch.Tensor, reduce_plan=None) -> torch.Tensor:
    """SwiGLU; with ``reduce_plan`` (the width split over *model*) the
    down projection's partial sum, all-reduced over *model*."""
    gate = torch.nn.functional.silu(x @ p["w_gate"])
    y = (gate * (x @ p["w_up"])) @ p["w_down"]
    return y if reduce_plan is None else all_reduce_model(y, reduce_plan)
