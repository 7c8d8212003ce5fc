"""Batched ragged rejection sampling (``repro.core.rejection``).

Index convention for one round (sequence-local): inputs t_0 = pending
token, t_1..t_K = draft tokens; target logits P[:, j] = p(. | t_0..t_j)
(j = 0..K); draft logits Q[:, j] (j = 0..K-1); draft token d_{j+1} was
sampled from Q[:, j].  Acceptance of d_{j+1} tests against P[:, j]; on
total acceptance the bonus token comes from P[:, K]; on the first
rejection at j the recovery token comes from norm(max(P[:, j] - Q[:, j],
0)).  The uniforms are supplied by the caller (identity-threaded:
``u_accept [B, K]`` one per row and position, ``u_next [B]`` one per
row), so the sampler itself holds no RNG state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.sampling import probs_from_logits, sample_from_probs


class RejectionResult(NamedTuple):
    accept_mask: torch.Tensor     # [B, K] bool — accepted draft positions
    num_accepted: torch.Tensor    # [B] int32 — length of accepted prefix
    next_token: torch.Tensor      # [B] int32 — bonus or recovery token
    emitted: torch.Tensor         # [B, K+1] int32 — accepted drafts + next
    num_emitted: torch.Tensor     # [B] = num_accepted + 1


def rejection_sample(draft_tokens: torch.Tensor, draft_logits: torch.Tensor,
                     target_logits: torch.Tensor, draft_len: torch.Tensor, *,
                     temperature: float, vocab_size: int, pad_id: int,
                     u_accept: torch.Tensor,
                     u_next: torch.Tensor) -> RejectionResult:
    """draft_tokens [B,K]; draft_logits [B,K,V]; target_logits [B,K+1,V];
    draft_len [B] (0..K, ragged)."""
    b, k = draft_tokens.shape
    dev = draft_tokens.device
    p = probs_from_logits(target_logits, temperature, vocab_size)   # [B,K+1,V]
    q = probs_from_logits(draft_logits, temperature, vocab_size)    # [B,K,V]
    valid = torch.arange(k, device=dev)[None, :] < draft_len[:, None]
    bi = torch.arange(b, device=dev)

    if k > 0:
        tok = draft_tokens.long()[..., None]
        p_tok = torch.gather(p[:, :k], -1, tok)[..., 0]
        q_tok = torch.gather(q, -1, tok)[..., 0]
        ratio = p_tok / q_tok.clamp(min=1e-30)
        accept = (u_accept < ratio.clamp(max=1.0)) & valid
        prefix = torch.cumprod(accept.to(torch.int32), dim=1)
        num_accepted = prefix.sum(1).to(torch.int32)
        accept_mask = prefix.bool()
    else:
        accept_mask = torch.zeros((b, 0), dtype=torch.bool, device=dev)
        num_accepted = torch.zeros((b,), dtype=torch.int32, device=dev)

    all_accepted = num_accepted >= draft_len
    n_acc = num_accepted.long()
    p_j = p[bi, n_acc.clamp(max=k)]                                   # [B,V]
    if k > 0:
        j = n_acc.clamp(max=max(k - 1, 0))
        residual = (p[bi, j] - q[bi, j]).clamp(min=0.0)
        rsum = residual.sum(-1, keepdim=True)
        # p == q exactly leaves no residual mass: fall back to p
        residual = torch.where(rsum > 1e-30, residual / rsum.clamp(min=1e-30),
                               p[bi, j])
        next_dist = torch.where(all_accepted[:, None], p_j, residual)
    else:
        next_dist = p_j
    if temperature <= 0.0:
        next_token = next_dist.argmax(-1).to(torch.int32)
    else:
        next_token = sample_from_probs(u_next, next_dist).to(torch.int32)

    out = torch.full((b, k + 1), pad_id, dtype=torch.int32, device=dev)
    if k > 0:
        keep = torch.arange(k, device=dev)[None, :] < num_accepted[:, None]
        out[:, :k] = torch.where(keep, draft_tokens.to(torch.int32), pad_id)
    out[bi, n_acc] = next_token
    return RejectionResult(accept_mask=accept_mask, num_accepted=num_accepted,
                           next_token=next_token, emitted=out,
                           num_emitted=num_accepted + 1)
