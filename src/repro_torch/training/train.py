"""Training of the port (``repro.training.train``): the loss, one
optimizer step, and the loop that trains a model for a number of steps.

Gradients come from autograd over the train-mode :func:`forward`.
Parameters stay a nested dict of plain tensors: each step makes
gradient-tracking leaves of them, and :func:`adamw_update` returns new
ones.  Gradient accumulation over ``microbatches`` is a loop that sums
the gradients in float32 and divides by their count, as the reference's
``lax.scan`` does.  The step runs no kernel of ``csrc/``: train-mode
attention is the plain masked ``attend`` below 2048 tokens and the
blockwise ``flash_attend`` from there, as in the reference.  Every
family trains: the recurrent ones' gradients come from autograd through
the SSD chunked form and the RG-LRU scan; a vlm batch may come as
``embeds``, and an audio batch needs ``encoder_embeds``.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import ModelConfig, OptimizerConfig, TrainConfig
from repro_torch.core.sampling import mask_vocab
from repro_torch.core.cost_hooks import fill_skipped, trips
from repro_torch.core.dtensor_ops import (cross_entropy_sharded, shard_as,
                                          split_microbatches)
from repro_torch.models.transformer import forward
from repro_torch.models.weights import (Params, init_params, param_leaves,
                                        resolve_device, unflatten_params)
from repro_torch.training.optimizer import (AdamWState, adamw_update,
                                            init_adamw)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy over the unpadded vocabulary (the
    padded rows masked to -1e30 before the log-sum-exp); with ``mask``,
    the mean over the masked-in positions.  DTensor logits (the dry run)
    go to the vocab-parallel form
    (``core.dtensor_ops.cross_entropy_sharded``), which never gathers
    the [B, S, V] logits."""
    if hasattr(logits, "device_mesh"):
        return cross_entropy_sharded(logits, labels, vocab_size, mask,
                                     cross_entropy)
    logits = mask_vocab(logits, vocab_size).float()
    lse = torch.logsumexp(logits, dim=-1)
    tok_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    ll = tok_logit - lse
    if mask is not None:
        mask = mask.to(ll.dtype)
        return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return -ll.mean()


def loss_fn(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, remat: bool = False,
            embeds: Optional[torch.Tensor] = None,
            encoder_embeds: Optional[torch.Tensor] = None,
            act_sharding=None, logits_sharding=None, attn_sharding=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross entropy, plus for the MoE family the router's load-balance
    loss x ``load_balance_weight`` and its z-loss x 1e-3, as in the
    reference; returns (loss, detached metrics).  ``embeds`` replace the
    token embeddings (a vlm's patch embeddings); ``encoder_embeds`` are
    an audio model's encoder frames, without which it raises
    ``AssertionError`` as the reference does.  A family the port does
    not know raises ``NotImplementedError`` (:func:`forward`).  The
    sharding hooks (the dry run's; no-ops on plain tensors):
    ``act_sharding`` and ``attn_sharding`` go to :func:`forward`,
    ``logits_sharding`` holds the [B, S, V] logits to (batch, None,
    model), so that the vocabulary stays split into the loss."""
    logits, _, aux = forward(params, cfg, tokens, mode="train", remat=remat,
                             embeds=embeds, encoder_embeds=encoder_embeds,
                             with_aux=True, act_sharding=act_sharding,
                             attn_sharding=attn_sharding)
    logits = shard_as(logits, logits_sharding)
    loss = cross_entropy(logits, labels, cfg.vocab_size)
    metrics = {"ce_loss": loss.detach()}
    if cfg.family == "moe":
        lb = aux["load_balance_loss"] * cfg.moe.load_balance_weight
        zl = aux["router_z_loss"] * 1e-3
        loss = loss + lb + zl
        metrics.update(load_balance=lb.detach(), router_z=zl.detach(),
                       dropped=aux["dropped_fraction"].detach())
    metrics["loss"] = loss.detach()
    return loss, metrics


def _grads(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           labels: torch.Tensor, remat: bool,
           embeds: Optional[torch.Tensor] = None,
           encoder_embeds: Optional[torch.Tensor] = None, hooks=None):
    """(gradients in leaf order, metrics) of one batch."""
    live = [(k, p.detach().requires_grad_()) for k, p in param_leaves(params)]
    loss, metrics = loss_fn(unflatten_params(live), cfg, tokens, labels, remat,
                            embeds, encoder_embeds, **(hooks or {}))
    return torch.autograd.grad(loss, [p for _, p in live]), metrics


def train_step(params: Params, opt_state: AdamWState, tokens: torch.Tensor,
               labels: torch.Tensor, *, cfg: ModelConfig,
               opt_cfg: OptimizerConfig, remat: bool = True,
               embeds: Optional[torch.Tensor] = None,
               encoder_embeds: Optional[torch.Tensor] = None,
               microbatches: int = 1, act_sharding=None, attn_sharding=None,
               logits_sharding=None, microbatch_sharding=None
               ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One optimizer step; returns (params, state, metrics) and leaves
    its arguments as they were.  ``embeds`` / ``encoder_embeds``: as
    :func:`loss_fn` takes them.  ``microbatches > 1`` splits the batch
    (and the embeddings with it) into that many consecutive row groups
    and averages their gradients and metrics; the groups iterate by
    ``core.cost_hooks.trips``.  The sharding hooks are the dry run's
    (``launch/steps.py``): ``act_sharding``, ``attn_sharding`` and
    ``logits_sharding`` as :func:`loss_fn` takes them, and
    ``microbatch_sharding(ndim)``, the layout of the [m, B/m, ...]
    microbatches, with which a DTensor batch splits on each device's
    shard (``core.dtensor_ops.split_microbatches``)."""
    keys = [k for k, _ in param_leaves(params)]
    hooks = dict(act_sharding=act_sharding, attn_sharding=attn_sharding,
                 logits_sharding=logits_sharding)
    if microbatches <= 1:
        grads, metrics = _grads(params, cfg, tokens, labels, remat, embeds,
                                encoder_embeds, hooks)
    else:
        m, b = microbatches, labels.shape[0]
        if b % m:
            raise ValueError(f"batch {b} does not split into {m} microbatches")

        def split(x):
            if x is None:
                return [None] * m
            if microbatch_sharding is None:
                return list(x.reshape(m, b // m, *x.shape[1:]))
            return split_microbatches(x, m, microbatch_sharding)
        acc, per = None, [None] * m
        parts = list(zip(split(tokens), split(labels), split(embeds),
                         split(encoder_embeds)))
        for i in trips(m):
            t_i, l_i, e_i, x_i = parts[i]
            g, per[i] = _grads(params, cfg, t_i, l_i, remat, e_i, x_i, hooks)
            g = [gi.float() for gi in g]
            acc = g if acc is None else [a + gi for a, gi in zip(acc, g)]
        per = fill_skipped(per)
        grads = [a / m for a in acc]
        metrics = {k: torch.stack([p[k] for p in per]).mean(0) for k in per[0]}
    grads = unflatten_params(zip(keys, grads))
    params, opt_state, opt_m = adamw_update(params, grads, opt_state, opt_cfg)
    metrics.update(opt_m)
    return params, opt_state, metrics


def train_loop(cfg: ModelConfig, train_cfg: TrainConfig,
               batches: Iterator, *, seed: int = 0,
               dtype=torch.float32, log_every: int = 20,
               num_steps: Optional[int] = None,
               params: Optional[Params] = None,
               verbose: bool = True, device="cuda"
               ) -> Tuple[Params, Dict[str, float]]:
    """Train for ``num_steps`` (default: the schedule's total) on
    ``batches`` of numpy (tokens [B, S], labels [B, S]), from
    ``init_params(cfg, seed)`` unless ``params`` is given, on
    ``device``.  Returns the params and the reference's metrics:
    ``steps``, ``wall_s`` and the last logged step's ``loss``,
    ``ce_loss``, ``grad_norm`` and ``lr``."""
    device = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed=seed, device=device, dtype=dtype)
    opt_state = init_adamw(params)
    n = num_steps or train_cfg.optimizer.total_steps
    t0 = time.monotonic()
    last = {}
    for i, (toks, labs) in enumerate(batches):
        if i >= n:
            break
        params, opt_state, m = train_step(
            params, opt_state, torch.from_numpy(np.asarray(toks)).to(device),
            torch.from_numpy(np.asarray(labs)).to(device), cfg=cfg,
            opt_cfg=train_cfg.optimizer, remat=train_cfg.remat)
        if i % log_every == 0 or i == n - 1:
            last = {k: float(v) for k, v in m.items()}
            if verbose:
                print(f"  step {i:4d} loss={last['loss']:.4f} "
                      f"lr={last['lr']:.2e} gnorm={last['grad_norm']:.2f}")
    wall = time.monotonic() - t0
    return params, {"steps": min(i + 1, n), "wall_s": wall, **last}
