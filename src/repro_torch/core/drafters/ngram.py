"""Prompt-lookup n-gram drafter (``repro.core.drafters.ngram``): zero
draft params, zero draft KV.

``NGramDrafter`` proposes by replaying the sequence's own text: the most
recent earlier occurrence of the trailing ``ngram_n``-gram in the
(prompt + emitted) prefix, and the tokens that followed it.  Its whole
per-sequence state is an int32 history buffer, so the scheduler gives
the draft mirror's block budget back to the target pool.

The proposal distribution handed to rejection sampling is the point mass
on the proposed token (one-hot logits, ``0`` / ``-1e30``), so
speculative sampling stays exact at every temperature.  The policy's
divergence signal is the finite surrogate ``-log p_target(token)``; the
fused KLD kernel is not on this drafter's path, as in the reference.

The suffix match runs on the CUDA kernel for CUDA tensors and on its
plain version on the CPU (:func:`repro_torch.kernels.ngram_match
.ngram_propose_history`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.drafters.base import DraftProposal, Drafter, register_drafter
from repro_torch.kernels.ngram_match import ngram_propose_history
from repro_torch.models.weights import VOCAB_PAD_MULTIPLE

NEG = -1e30


@register_drafter("ngram")
@dataclasses.dataclass(frozen=True)
class NGramDrafter(Drafter):
    """Suffix-match lookup over the sequence's own generated prefix."""

    # uses_draft_model / mirrors_kv / step_cost: base defaults (False /
    # False / 0.0): a table lookup is free next to a verification

    def init_cache(self, batch, max_len, paged=None, dtype=torch.float32,
                   device="cpu", kv_quant="none"):
        # token history, NOT a KV cache: ``length`` counts committed
        # tokens, mirroring the target cache's commit arithmetic
        i32 = dict(dtype=torch.int32, device=device)
        return {"tokens": torch.zeros((batch, max_len), **i32),
                "length": torch.zeros((batch,), **i32)}

    def prefill(self, params_d, cache, idx, tokens, prompt_lens,
                table_rows=None, max_len=None):
        # full-row writes: no stale text from a slot's previous occupant
        buf = cache["tokens"].clone()
        rows = torch.zeros((tokens.shape[0], buf.shape[1]), dtype=torch.int32,
                           device=buf.device)
        rows[:, :tokens.shape[1]] = tokens
        buf[idx] = rows
        length = cache["length"].clone()
        length[idx] = prompt_lens.to(torch.int32)
        return {"tokens": buf, "length": length}

    def propose(self, params_d, draft_cache, pending, k, sl_i, policy,
                step_u, live, *, params_t=None, target_cache=None):
        buf = draft_cache["tokens"]
        # the proposal conditions on committed history + the pending
        # token at ``length`` where it fits; the lookup reads it there
        # without writing the buffer
        toks, cnt = ngram_propose_history(buf, draft_cache["length"],
                                          pending.to(torch.int32),
                                          n=self.spec.ngram_n, k=k)
        # one-hot over the target's padded vocabulary
        v = self.cfg_t.padded_vocab(VOCAB_PAD_MULTIPLE)
        vocab = torch.arange(v, device=buf.device)
        logits = torch.where(vocab == toks[..., None].long(), 0.0, NEG)
        return DraftProposal(tokens=toks, logits=logits, cache=draft_cache,
                             eff_sl=cnt)

    def commit(self, tokens, snapshot, drafted, n_committed):
        buf, ln = snapshot["tokens"], snapshot["length"]
        b, h = buf.shape
        t = tokens.shape[1]
        pos = ln[:, None] + torch.arange(t, device=buf.device)[None]
        keep = (torch.arange(t, device=buf.device)[None]
                < n_committed[:, None]) & (pos < h)
        # dropped writes land in a spare column that is cut off after
        tgt = torch.where(keep, pos, h).long()
        wide = torch.cat([buf, torch.zeros((b, 1), dtype=buf.dtype,
                                           device=buf.device)], 1)
        wide.scatter_(1, tgt, tokens.to(torch.int32))
        return {"tokens": wide[:, :h].contiguous(),
                "length": ln + n_committed.to(torch.int32)}

    def reset_rows(self, cache, rows):
        return {"tokens": torch.where(rows[:, None], 0, cache["tokens"]),
                "length": torch.where(rows, 0, cache["length"])}

    def observation_kld(self, target_logits, draft_logits, tokens, valid):
        # one-hot q makes KL(p||q) infinite; use the target's surprise of
        # the proposal, -log p(token) = KL(q||p) for a point-mass q
        lp = torch.log_softmax(target_logits.float(), dim=-1)
        lp_tok = torch.gather(lp, -1, tokens.long()[..., None])[..., 0]
        return torch.where(valid, -lp_tok, 0.0)
