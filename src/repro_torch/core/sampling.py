"""Sampling utilities and the port's counter-based RNG.

The reference threads ``jax.random`` keys folded with (request seed,
round ordinal, purpose, position) (``spec_decode.row_keys``).  The port
keeps that identity — every draw is a pure function of
``(base seed, request seed, round, purpose, position)`` — but derives
the bits from a counter-based integer hash evaluated on the tensors'
own device, so a stream never depends on batch composition, bucket
width, or host dispatch order.  It cannot reproduce ``jax.random``'s
bits: greedy (temperature 0) streams are what the port holds equal to
the reference.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``x * c`` for x < 2^32 held in int64, without
    overflowing int64 (the product is split at 16 bits)."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche hash (lowbias32 constants) on int64 lanes."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def counter_uniform(base_seed: int, seed: torch.Tensor, round_idx: torch.Tensor,
                    purpose: int,
                    position: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Uniform floats in [0, 1) keyed by (base seed, per-row request seed
    ``seed [B]``, per-row round ordinal ``round_idx [B]``, purpose tag,
    position).  ``position`` is an int or a tensor broadcastable against
    ``[B, ...]`` (e.g. ``arange(K)[None]`` for one draw per position)."""
    h = _mix(torch.full_like(seed, base_seed & _M32, dtype=torch.int64)
             ^ 0x9E3779B9)
    h = _mix(h ^ seed.to(torch.int64))
    h = _mix(h ^ round_idx.to(torch.int64))
    h = _mix(h ^ (purpose & _M32))
    if isinstance(position, torch.Tensor) and position.dim() > 1:
        # [B] -> [B, 1, ...] against positions [B|1, n, ...]
        h = h.reshape(h.shape + (1,) * (position.dim() - 1))
    h = _mix(h ^ position)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def mask_vocab(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mask padded vocabulary entries (the embedding is padded)."""
    v = logits.shape[-1]
    if v == vocab_size:
        return logits
    keep = torch.arange(v, device=logits.device) < vocab_size
    return torch.where(keep, logits, -1e30)


def probs_from_logits(logits: torch.Tensor, temperature: float,
                      vocab_size: Optional[int] = None) -> torch.Tensor:
    """Temperature-adjusted probabilities; temperature 0 -> one-hot argmax."""
    if vocab_size is not None:
        logits = mask_vocab(logits, vocab_size)
    logits = logits.float()
    if temperature <= 0.0:
        # one-hot by comparison: F.one_hot validates its input on the host
        idx = torch.arange(logits.shape[-1], device=logits.device)
        return (idx == logits.argmax(-1, keepdim=True)).float()
    return torch.softmax(logits / temperature, dim=-1)


def sample_from_probs(u: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw from ``probs [..., V]`` with uniforms ``u [...]``;
    exact (the argmax) for one-hot inputs."""
    cdf = probs.float().cumsum(-1)
    target = (u * cdf[..., -1]).unsqueeze(-1)
    idx = torch.searchsorted(cdf.contiguous(), target.contiguous(), right=True)
    return idx[..., 0].clamp(max=probs.shape[-1] - 1)


def sample_token(u: torch.Tensor, logits: torch.Tensor, temperature: float,
                 vocab_size: Optional[int] = None) -> torch.Tensor:
    """Greedy argmax at temperature 0, else a draw with uniforms ``u``."""
    if vocab_size is not None:
        logits = mask_vocab(logits, vocab_size)
    if temperature <= 0.0:
        return logits.argmax(-1)
    return sample_from_probs(u, torch.softmax(logits.float() / temperature, -1))
