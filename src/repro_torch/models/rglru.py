"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin;
``repro.models.rglru``).  [arXiv:2402.19427]

Recurrence, per channel:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_i x_t + b_i)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

* prefill / train: :func:`rglru_scan`.  The reference runs
  ``jax.lax.associative_scan``; torch has none, so this is a log-depth
  Hillis-Steele scan over the (a, b) pairs of the affine maps: ceil(log2
  S) rounds, each composing every step with the one ``2^k`` before it.  It
  groups the products differently from the reference's scan, so the two
  agree to fp32 rounding, not bit for bit.
* decode / verify: :func:`rglru_step_scan`, the sequential recurrence.

Both take an ``update_mask``: a masked step is the identity (a = 1, input
term 0), for the speculative commit and ragged prefill.  The full
residual block: x -> conv1d(w=4) -> RG-LRU, gated by GeLU(W_gate x) (the
tanh form, jax's default), then W_out; under a mask the conv cache is
recomputed at the accepted prefix.

Plain PyTorch: the reference has no Pallas kernel here.  Every state
returned is a new tensor (the round's snapshot keeps the old one).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.models.ssm import causal_conv1d

_C = 8.0


def rglru_shapes(cfg: ModelConfig, normal, zeros, ones) -> dict:
    """One RG-LRU block's parameters (the reference's ``rglru_specs``),
    built by the caller's leaf makers: the recurrence and input gates at
    stddev 0.02, ``conv_w [W, lru]`` at 0.5, ``lam`` (Lambda) ones."""
    d, w, cw = cfg.d_model, cfg.rglru.lru_width, cfg.rglru.conv_width
    lru, sq = ("lru",), ("lru", "lru")
    return {"w_x": normal(d, w, axes=("embed", "lru")),
            "w_gate": normal(d, w, axes=("embed", "lru")),
            "w_out": normal(w, d, axes=("lru", "embed")),
            "conv_w": normal(cw, w, scale=0.5, axes=("conv", "lru")),
            "conv_b": zeros(w, axes=lru),
            "w_a": normal(w, w, scale=0.02, axes=sq), "b_a": zeros(w, axes=lru),
            "w_i": normal(w, w, scale=0.02, axes=sq), "b_i": zeros(w, axes=lru),
            "lam": ones(w, axes=lru)}


def _gates(p: dict, x: torch.Tensor, update_mask: Optional[torch.Tensor]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of the affine recurrence h_t = a_t h + b_t, fp32."""
    r = torch.sigmoid(x @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(x @ p["w_i"] + p["b_i"])
    log_a = -_C * F.softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    gated_x = (i * x).float()
    multiplier = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = multiplier * gated_x
    if update_mask is not None:
        m = update_mask[..., None] > 0
        a = torch.where(m, a, 1.0)
        b = torch.where(m, b, 0.0)
    return a, b


def rglru_scan(p: dict, x: torch.Tensor, h0: Optional[torch.Tensor] = None,
               update_mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,W] -> (h_all [B,S,W], h_final [B,W] fp32) by a log-depth
    (Hillis-Steele) scan; ``h0`` enters as a virtual step 0 (a = 1,
    b = h0), as in the reference."""
    a, b = _gates(p, x, update_mask)
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None].float(), b], dim=1)
    s = a.shape[1]
    off = 1
    while off < s:
        # compose step t with step t - off: (a1, b1) then (a2, b2) is
        # (a1 a2, a2 b1 + b2)
        a_prev, b_prev = a[:, :s - off], b[:, :s - off]
        a_cur, b_cur = a[:, off:], b[:, off:]
        b = torch.cat([b[:, :off], a_cur * b_prev + b_cur], dim=1)
        a = torch.cat([a[:, :off], a_prev * a_cur], dim=1)
        off *= 2
    if h0 is not None:
        b = b[:, 1:]
    return b.to(x.dtype), b[:, -1]


def rglru_step_scan(p: dict, x: torch.Tensor, h0: torch.Tensor,
                    update_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential form for decode/verify (small T)."""
    a, b = _gates(p, x, update_mask)
    h = h0.float()
    hs = []
    for j in range(x.shape[1]):
        h = a[:, j] * h + b[:, j]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), h


def rglru_block(p: dict, cfg: ModelConfig, u: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None,
                update_mask: Optional[torch.Tensor] = None,
                sequential: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The Griffin recurrent block.  u [B,S,d] -> y [B,S,d].  state:
    ``{"lru": [B,W] fp32, "conv": [B,cw-1,W]}`` (None: stateless
    train)."""
    gate = F.gelu(u @ p["w_gate"], approximate="tanh")
    x = u @ p["w_x"]
    conv_cache = state["conv"] if state is not None else None
    xc, new_conv = causal_conv1d(x, p["conv_w"], p["conv_b"], conv_cache)
    h0 = state["lru"] if state is not None else None
    if sequential:
        if h0 is None:
            h0 = x.new_zeros((x.shape[0], x.shape[-1]), dtype=torch.float32)
        hs, hf = rglru_step_scan(p, xc, h0, update_mask)
    else:
        hs, hf = rglru_scan(p, xc, h0, update_mask)
    y = (hs * gate) @ p["w_out"]
    if state is None:
        return y, None
    if update_mask is not None:
        w = p["conv_w"].shape[0]
        hist = torch.cat([conv_cache.to(x.dtype), x], dim=1)
        n_acc = update_mask.sum(dim=1).long()
        idx = n_acc[:, None] + torch.arange(w - 1, device=u.device)[None]
        new_conv = torch.gather(hist, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    return y, {"lru": hf, "conv": new_conv}
