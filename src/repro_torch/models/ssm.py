"""Mamba-2 (SSD, state-space duality) mixer of the port
(``repro.models.ssm``).  [arXiv:2405.21060]

Plain PyTorch: the reference runs these in jnp and ``lax.scan``, not in
Pallas, so there is no kernel to port.  Two forms, as in the reference:

* :func:`ssd_chunked` — the matmul ("attention-dual") form for train and
  prefill: the intra-chunk quadratic term plus the inter-chunk state carry
  (a Python loop over the chunks), with ``h0`` continuation and the last
  chunk zero-padded;
* :func:`ssd_recurrent` — the token recurrence for decode and verify (a
  Python loop over the short token axis).

A per-step ``update_mask`` turns masked steps into exact identities on
the state (``dt = 0``: decay 1, no input) in both forms; that is how the
speculative round commits only the accepted tokens (the masked
re-advance, DESIGN.md §4) and how a right-padded prefill stops at each
row's prompt.  :func:`mamba_mixer` also recomputes the conv cache at the
accepted prefix under a mask.

State: ``ssd [B, H, P, N]`` fp32 (heads, head dim, state), conv cache
``[B, W-1, conv_dim]``.  Every state this module returns is a new tensor:
the round keeps the pre-round cache as its commit snapshot.

On a serving mesh (``heads``, ``plan``) the mixer runs this rank's SSD
heads: ``wz``, ``gnorm`` and ``out_proj`` hold their columns (rows),
``wxbc``/``conv_w``/``conv_b`` their x columns and all of B and C
(``core.tp.MeshPlan.xbc_columns``), ``wdt``, ``dt_bias``, ``A_log`` and
``D`` are whole and cut here; the gated norm's sum of squares and
``out_proj``'s product are all-reduced over *model*, and the state holds
the local heads (``ssd [B, H/m, P, N]``, ``conv [B, W-1, di/m + 2N]``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.core.tp import all_reduce_model
from repro_torch.models.layers import rmsnorm


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, SSD heads, conv channels, state size)."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    num_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.state_size
    return d_inner, num_heads, conv_dim, s.state_size


def ssm_shapes(cfg: ModelConfig, normal, zeros, ones) -> dict:
    """One Mamba-2 mixer's parameters (the reference's ``ssm_specs``),
    built by the caller's ``normal(*shape, scale=None, axes)`` /
    ``zeros`` / ``ones`` leaf makers (``axes``: the reference's logical
    axis names): ``wxbc`` projects x | B | C jointly (they are
    convolved together), ``conv_w [W, conv_dim]`` at stddev 0.5."""
    d = cfg.d_model
    di, h, dc, _ = ssm_dims(cfg)
    return {"wz": normal(d, di, axes=("embed", "mlp")),
            "wxbc": normal(d, dc, axes=("embed", "mlp")),
            "wdt": normal(d, h, axes=("embed", None)),
            "dt_bias": zeros(h, axes=(None,)), "A_log": ones(h, axes=(None,)),
            "D": ones(h, axes=(None,)),
            "conv_w": normal(cfg.ssm.conv_width, dc, scale=0.5,
                             axes=("conv", "mlp")),
            "conv_b": zeros(dc, axes=("mlp",)),
            "gnorm": zeros(di, axes=("mlp",)),
            "out_proj": normal(di, d, axes=("mlp", "embed"))}


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  cache: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv: x [B,S,C], w [W,C].  Returns (y, new
    cache), the cache holding the trailing W-1 inputs."""
    width = w.shape[0]
    if cache is None:
        cache = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([cache.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = w[0] * xp[:, 0:s]
    for i in range(1, width):
        y = y + w[i] * xp[:, i:i + s]
    new_cache = xp[:, xp.shape[1] - (width - 1):] if width > 1 else cache
    return y + b, new_cache


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., q] -> [..., q, q]: [i, j] = sum_{k=j+1..i} a_k below the
    diagonal, -inf above it."""
    cs = torch.cumsum(a, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    q = a.shape[-1]
    tri = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return ss.masked_fill(~tri, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  x [b,s,h,p], dt [b,s,h] (after softplus), A [h]
    (< 0), B, C [b,s,n] (one group).  Returns (y [b,s,h,p], h_final
    [b,h,p,n] fp32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    xd = (x * dt[..., None]).float()                          # dt-scaled input
    a = (dt * A).float()                                      # [b,sp,h]
    xc = xd.reshape(b, nc, chunk, h, p)
    ac = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)       # [b,h,nc,q]
    Bc = B.reshape(b, nc, chunk, n).float()
    Cc = C.reshape(b, nc, chunk, n).float()

    a_cs = torch.cumsum(ac, dim=-1)                           # [b,h,nc,q]
    L = torch.exp(_segsum(ac))                                # [b,h,nc,q,q]
    # intra-chunk (quadratic, attention-dual) term
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y_diag = torch.einsum("bcqk,bhcqk,bckhp->bcqhp", cb, L, xc)
    # per-chunk input -> state contribution
    decay_in = torch.exp(a_cs[..., -1:] - a_cs)               # [b,h,nc,q]
    chunk_states = torch.einsum("bcqn,bhcq,bcqhp->bchpn", Bc, decay_in, xc)
    chunk_decay = torch.exp(a_cs[..., -1])                    # [b,h,nc]
    out_decay = torch.exp(a_cs)                               # [b,h,nc,q]

    hprev = (x.new_zeros((b, h, p, n), dtype=torch.float32) if h0 is None
             else h0.float())
    y_offs = []
    for c in range(nc):
        y_offs.append(torch.einsum("bqn,bhpn,bhq->bqhp", Cc[:, c], hprev,
                                   out_decay[:, :, c]))
        hprev = chunk_decay[:, :, c, None, None] * hprev + chunk_states[:, c]
    y_off = torch.stack(y_offs, dim=1)                        # [b,nc,q,h,p]
    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), hprev


def ssd_recurrent(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, h0: torch.Tensor,
                  update_mask: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-recurrent SSD for decode/verify.  x [b,t,h,p], dt [b,t,h],
    B, C [b,t,n], h0 [b,h,p,n].  Steps whose ``update_mask [b,t]`` is 0
    leave the state untouched (dt := 0)."""
    if update_mask is not None:
        dt = dt * update_mask[..., None]
    af = torch.exp(dt * A)                                    # [b,t,h]
    xf, Bf, Cf = x.float(), B.float(), C.float()
    hs = h0.float()
    ys = []
    for j in range(x.shape[1]):
        # h' = a h + (dt x) B^T ; y = C h'
        upd = (xf[:, j] * dt[:, j, :, None])[..., None] * Bf[:, j, None, None, :]
        hs = af[:, j, :, None, None] * hs + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, j], hs))
    return torch.stack(ys, dim=1).to(x.dtype), hs


def _gated_norm(y: torch.Tensor, scale: torch.Tensor, eps: float,
                width: int, plan) -> torch.Tensor:
    """RMSNorm of ``y [..., width / m]`` over the whole ``width``: this
    rank's sum of squares all-reduced over *model*."""
    if plan is None:
        return rmsnorm(y, scale, eps)
    yf = y.float()
    ss = all_reduce_model(yf.square().sum(-1, keepdim=True), plan)
    return (yf * torch.rsqrt(ss / width + eps)
            * (1.0 + scale.float())).to(y.dtype)


def mamba_mixer(p: dict, cfg: ModelConfig, u: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None,
                update_mask: Optional[torch.Tensor] = None,
                use_chunked: bool = True, heads: Optional[slice] = None,
                plan=None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The Mamba-2 block (the caller adds the pre-norm residual).
    u [B,S,d] -> y [B,S,d].  ``state`` carries ``{"ssd": [B,H,P,N],
    "conv": [B,W-1,conv_dim]}`` across calls (None: stateless train).
    ``heads``: the SSD heads this rank runs, ``plan`` its mesh (module
    docstring); None on one card."""
    s = cfg.ssm
    di_all, _, _, n = ssm_dims(cfg)
    di, dc = p["wz"].shape[-1], p["wxbc"].shape[-1]
    h = di // s.head_dim
    bsz, t, d = u.shape
    flat = u.reshape(bsz * t, d)
    z = (flat @ p["wz"]).reshape(bsz, t, di)
    xbc_in = (flat @ p["wxbc"]).reshape(bsz, t, dc)
    dt_raw = (flat @ p["wdt"]).reshape(bsz, t, -1)
    dt_bias, a_log, d_skip = p["dt_bias"], p["A_log"], p["D"]
    if heads is not None:
        dt_raw, dt_bias, a_log, d_skip = (
            dt_raw[..., heads], dt_bias[heads], a_log[heads], d_skip[heads])
    else:
        plan = None

    conv_cache = state["conv"] if state is not None else None
    xbc, new_conv = causal_conv1d(xbc_in, p["conv_w"], p["conv_b"], conv_cache)
    xbc = F.silu(xbc)
    x, B, C = torch.split(xbc, [di, n, n], dim=-1)
    x = x.reshape(bsz, t, h, s.head_dim)

    dt = F.softplus(dt_raw.float() + dt_bias.float())
    if update_mask is not None:
        # masked steps are exact identities on the state in BOTH forms
        dt = dt * update_mask[..., None]
    A = -torch.exp(a_log.float())

    h0 = state["ssd"] if state is not None else None
    if use_chunked:
        y, hf = ssd_chunked(x, dt, A, B, C, s.chunk_size, h0)
    else:
        if h0 is None:
            h0 = u.new_zeros((bsz, h, s.head_dim, n), dtype=torch.float32)
        y, hf = ssd_recurrent(x, dt, A, B, C, h0, None)

    y = y + d_skip.to(y.dtype)[:, None] * x                   # skip
    y = y.reshape(bsz, t, di)
    y = _gated_norm(y * F.silu(z), p["gnorm"], cfg.norm_eps, di_all, plan)
    out = (y.reshape(bsz * t, di) @ p["out_proj"]).reshape(bsz, t, d)
    out = all_reduce_model(out, plan) if plan is not None else out
    if state is None:
        return out, None
    if update_mask is not None:
        # the conv cache freezes past the accepted prefix too: the window
        # ending at each row's accepted count, from the unmasked inputs
        w = p["conv_w"].shape[0]
        hist = torch.cat([conv_cache.to(xbc_in.dtype), xbc_in], dim=1)
        n_acc = update_mask.sum(dim=1).long()                 # [B]
        idx = n_acc[:, None] + torch.arange(w - 1, device=u.device)[None]
        new_conv = torch.gather(hist, 1, idx[..., None].expand(-1, -1, dc))
    return out, {"ssd": hf, "conv": new_conv}
