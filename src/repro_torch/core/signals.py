"""Post-hoc diagnostic signals for DSDE (paper §3.1; ``repro.core.signals``).

* ``kld_per_position``  — KL(target ‖ draft) at each proposed position,
  computed by the fused KLD kernel on CUDA (its plain version on CPU).
* ``draft_entropy``     — entropy of the draft distribution (AdaEDL's
  forward-looking signal).
* ``weighted_mean/var`` — Eq. (5)–(7): ``alpha_i = delta^(i-1)``, i=1 the
  most recent step.
* ``KLDHistory``        — per-sequence ring buffer of per-step mean KLDs
  feeding the short (N=10) and long (N=30) WVIR windows (Fig. 5).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.kld_accept import kld_accept_signals


def kld_per_position(target_logits: torch.Tensor, draft_logits: torch.Tensor,
                     tokens: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL(p_target ‖ q_draft) per position, floored at 0 and 0 where
    ``valid`` is False.  target/draft logits [B, T, V]; tokens [B, T]
    int32 (the kernel also returns p(tok)/q(tok), unused here)."""
    kld = kld_accept_signals(target_logits, draft_logits, tokens)[0]
    if valid is not None:
        kld = torch.where(valid, kld, 0.0)
    return kld


def draft_entropy(draft_logits: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the draft distribution per position, over the
    fp32 log-softmax of the last axis: [B, T, V] -> [B, T]."""
    lq = torch.log_softmax(draft_logits.float(), dim=-1)
    return -(lq.exp() * lq).sum(-1)


def decay_weights(n: int, delta: float, device=None) -> torch.Tensor:
    """alpha_i = delta^(i-1), i=1 most recent; returned oldest-first."""
    i = torch.arange(n, 0, -1, dtype=torch.float32, device=device)
    return delta ** (i - 1.0)


def weighted_var(x: torch.Tensor, weights: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Eq. (7) over the last axis."""
    w = weights * valid.float()
    wsum = w.sum(-1).clamp(min=1e-9)
    mu = (x * w).sum(-1) / wsum
    return (w * (x - mu[..., None]).square()).sum(-1) / wsum


class KLDHistory(NamedTuple):
    """Ring buffer of per-step mean KLD values, one row per sequence:
    ``buf [B, N_long]``, ``count [B]`` valid entries (saturating),
    ``head [B]`` next write slot."""
    buf: torch.Tensor
    count: torch.Tensor
    head: torch.Tensor

    @staticmethod
    def init(batch: int, n_long: int = 30, device="cpu") -> "KLDHistory":
        return KLDHistory(
            buf=torch.zeros((batch, n_long), dtype=torch.float32, device=device),
            count=torch.zeros((batch,), dtype=torch.int32, device=device),
            head=torch.zeros((batch,), dtype=torch.int32, device=device))

    def push(self, value: torch.Tensor,
             active: Optional[torch.Tensor] = None) -> "KLDHistory":
        """Append one per-step value [B]; ``active`` gates rows that did
        not take a step this round."""
        b, n = self.buf.shape
        new_buf = self.buf.clone()
        new_buf[torch.arange(b, device=self.buf.device), self.head.long()] = value.float()
        new_count = (self.count + 1).clamp(max=n)
        new_head = (self.head + 1) % n
        if active is not None:
            new_buf = torch.where(active[:, None], new_buf, self.buf)
            new_count = torch.where(active, new_count, self.count)
            new_head = torch.where(active, new_head, self.head)
        return KLDHistory(new_buf, new_count.to(torch.int32),
                          new_head.to(torch.int32))

    def chronological(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Last ``n`` entries, oldest-first: (values [B, n], valid [B, n])."""
        n_long = self.buf.shape[1]
        dev = self.buf.device
        offs = torch.arange(-n, 0, device=dev)
        idx = (self.head.long()[:, None] + offs[None, :]) % n_long
        vals = torch.gather(self.buf, 1, idx)
        age = torch.arange(n, 0, -1, device=dev)[None, :]   # newest has age 1
        return vals, age <= self.count[:, None]


def wvir(history: KLDHistory, short_n: int, long_n: int, delta: float,
         eps: float = 1e-9) -> torch.Tensor:
    """Eq. (4): Weighted Variance Intensity Ratio per sequence [B]; 1
    (neutral) until the history holds ``short_n`` entries."""
    dev = history.buf.device
    vs, valid_s = history.chronological(short_n)
    vl, valid_l = history.chronological(long_n)
    var_s = weighted_var(vs, decay_weights(short_n, delta, dev), valid_s)
    var_l = weighted_var(vl, decay_weights(long_n, delta, dev), valid_l)
    ratio = var_s / var_l.clamp(min=eps)
    return torch.where(history.count >= short_n, ratio, 1.0)
