"""AdamW with a cosine schedule and global-norm clipping, written out in
the reference's order (``repro.training.optimizer``): clip by the global
norm, then ``step + 1``, then the float32 learning rate, then per leaf
the moments, the bias corrections ``b ** step`` and a weight decay on
every leaf (norm scales and the embedding included).

Functional like the reference: :func:`adamw_update` returns new
parameters and a new state and mutates nothing it is given.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.config import OptimizerConfig
from repro_torch.models.weights import Params, map_params, param_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: Params
    nu: Params


def init_adamw(params: Params) -> AdamWState:
    z = map_params(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    device = param_leaves(params)[0][1].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=z, nu=map_params(torch.clone, z))


def lr_schedule(step, cfg: OptimizerConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to 10% of peak, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares over the leaves, summed in leaf order."""
    return torch.sqrt(sum(leaf.float().square().sum()
                          for _, leaf in param_leaves(tree)))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return map_params(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: AdamWState,
                 cfg: OptimizerConfig
                 ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(step, cfg)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1, bc2 = 1 - b1 ** stepf, 1 - b2 ** stepf

    def upd(p, g, m, v):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        # a list, not a tuple: map_params walks into tuples
        return [(p.float() - lr * delta).to(p.dtype), m, v]

    out = map_params(upd, params, grads, state.mu, state.nu)

    def pick(j):
        return map_params(lambda o: o[j], out)

    return pick(0), AdamWState(step, pick(1), pick(2)), {
        "grad_norm": gnorm, "lr": lr}
