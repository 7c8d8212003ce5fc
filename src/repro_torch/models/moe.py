"""The mixture-of-experts block of the port (``repro.models.moe``): a
top-k router and capacity-based dispatch to stacked experts.

Each expert takes at most ``capacity(n)`` of the ``n = B * T`` tokens of
a call, in token order; the rest are dropped.  The capacity counts every
row of the call, padded and inactive rows included, so a row's output
depends on its batch: callers must pass the reference's rows.

The reference writes its dispatch buffer with one scatter in which the
dropped (token, slot) pairs of an expert that overflows write the empty
sentinel ``n`` to that expert's last slot, ``cap - 1``, after the kept
pair of that slot: the kept token there is dispatched as the zero row
and its contribution is lost.  The port computes that same function,
with no duplicate-index write whose order the card would leave open:
the kept pairs are placed (each on a slot of its own), then the last
slot of every expert whose count exceeds ``cap`` is set to ``n``.  The
combine sums each token's ``k`` contributions in slot order ``j = 0 ..
k-1`` from zero, as the reference's sequential scatter-add does, so the
card and the CPU add in one order.

On a serving mesh (:func:`moe_apply_mesh`) experts replicate and each
expert's width splits over *model* (``w_gate``/``w_up`` columns,
``w_down`` rows), so a rank's experts give partial sums, all-reduced
over *model*.  The capacity couples the rows of a call, so a rank whose
ring rows split over *data* first gathers the call's rows and routes all
``n`` tokens, as one card does, then keeps its own rows.

Top-k uses a stable descending sort, so of two equal probabilities the
lower expert index comes first, as ``jax.lax.top_k`` keeps it.  Nothing
here reads a device value on the host: the capacity is a function of
the shapes alone.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import tp as tp_lib
from repro_torch.core.config import MoEConfig


def capacity(num_tokens: int, cfg: MoEConfig, factor: float = 1.25) -> int:
    """Tokens an expert takes in a call of ``num_tokens`` tokens: the
    reference's ``_capacity`` (x 1.25, rounded up to a multiple of 8, at
    most ``num_tokens``)."""
    cap = int(num_tokens * cfg.top_k * factor / cfg.num_experts) + 1
    cap = (cap + 7) // 8 * 8
    return min(cap, num_tokens)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_apply(p: dict, cfg: MoEConfig, x: torch.Tensor,
              shardings: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, T, d] -> (y [B, T, d], aux): ``load_balance_loss`` (Switch),
    ``router_z_loss``, ``expert_fraction [E]`` (top-1 share of each
    expert) and ``dropped_fraction`` (of the (token, slot) pairs).
    ``shardings`` (the dry run's ``launch.sharding.moe_shardings``) are
    passed on to the DTensor form (``core/dtensor_ops.py``), which a
    DTensor ``x`` selects; a plain tensor never reads them."""
    if hasattr(x, "device_mesh"):
        from repro_torch.core.dtensor_ops import moe_apply_sharded
        return moe_apply_sharded(p, cfg, x, shardings, _moe_local)
    return _moe_local(p, cfg, x)


def moe_apply_mesh(p: dict, cfg: MoEConfig, x: torch.Tensor, plan,
                   rows: Optional[Tuple[int, int]] = None, split: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`moe_apply` on a serving mesh's rank (``plan``): ``x`` holds
    the rows [lo, hi) = ``rows`` of the call where its rows split over
    *data* (else all of them); ``split``: each expert's width splits over
    *model* (``HeadLayout.mlp``).  Routing and dispatch run on every row
    of the call, so every (token, slot) pair lands where one card puts
    it, and the dropped pairs are the same; returns this rank's rows."""
    if rows is not None:
        x = tp_lib.gather_rows(x, plan)
    y, aux = _moe_local(p, cfg, x)
    if split:
        y = tp_lib.all_reduce_model(y, plan)
    if rows is not None:
        y = y[rows[0]:rows[1]]
    return y, aux


def _moe_local(p: dict, cfg: MoEConfig, x: torch.Tensor,
               experts: Optional[Tuple[int, int]] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`moe_apply` on one device's tensors.  ``experts`` (the dry
    run's expert parallelism, on stand-ins only): the device holds the
    weights of experts [lo, hi) and runs their dispatch rows alone."""
    b, t, d = x.shape
    n = b * t
    e, k = cfg.num_experts, cfg.top_k
    dev = x.device
    xf = x.reshape(n, d)

    logits = xf.float() @ p["router"].float()                    # [n, e]
    probs = torch.softmax(logits, dim=-1)
    top_probs, top_idx = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
    top_probs, top_idx = top_probs[:, :k], top_idx[:, :k]        # [n, k]
    top_probs = top_probs / top_probs.sum(-1, keepdim=True).clamp(min=1e-9)

    me = probs.mean(0)
    ce = _one_hot(top_idx[:, 0], e, torch.float32).mean(0)
    aux = {"load_balance_loss": e * (me * ce).sum(),
           "router_z_loss": torch.logsumexp(logits, dim=-1).square().mean(),
           "expert_fraction": ce}

    # ---- dispatch: each (token, slot) pair's place in its expert ---------
    cap = capacity(n, cfg)
    flat_expert = top_idx.reshape(-1)                            # [n*k]
    flat_token = torch.arange(n, device=dev)[:, None].expand(n, k).reshape(-1)
    eh = _one_hot(flat_expert, e, torch.int32)                   # [n*k, e]
    pos = torch.cumsum(eh, 0, dtype=torch.int32) - eh            # exclusive
    slot = pos.gather(1, flat_expert[:, None])[:, 0].long()
    keep = slot < cap
    # kept pairs on their own slots; the dropped ones all write the
    # sentinel n to a spare column, which is cut off
    col = torch.where(keep, slot, cap)
    buf = torch.full((e, cap + 1), n, dtype=torch.long, device=dev)
    buf.view(-1).index_put_((flat_expert * (cap + 1) + col,),
                            torch.where(keep, flat_token, n))
    buf = buf[:, :cap]
    # the reference's overflow quirk: slot cap-1 of an expert that
    # overflows holds the sentinel
    over = eh.sum(0) > cap                                       # [e]
    buf[:, cap - 1] = torch.where(over, n, buf[:, cap - 1])
    if experts is not None:
        buf = buf[experts[0]:experts[1]]
    token_pad = torch.cat([xf, xf.new_zeros((1, d))], 0)
    xe = token_pad[buf]                                          # [e, cap, d]

    # ---- the experts: batched products over the stacked weights ---------
    gate = torch.nn.functional.silu(torch.bmm(xe, p["w_gate"]))
    up = torch.bmm(xe, p["w_up"])
    ye = torch.bmm(gate * up, p["w_down"])                       # [e, cap, d]

    # ---- combine: each token's k contributions in slot order ------------
    w = torch.where(keep, top_probs.reshape(-1), 0.0).to(ye.dtype)
    contrib = (ye[flat_expert, slot.clamp(max=cap - 1)]
               * w[:, None]).reshape(n, k, d)
    out = torch.zeros((n, d), dtype=ye.dtype, device=dev)
    for j in range(k):
        out = out + contrib[:, j]
    aux["dropped_fraction"] = 1.0 - keep.float().mean()
    return out.reshape(b, t, d).to(x.dtype), aux
