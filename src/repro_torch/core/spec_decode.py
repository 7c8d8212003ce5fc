"""One speculative-decoding round (``repro.core.spec_decode``), on the
dense ring or the block-paged pool alike.

  1. propose      — the drafter (``ModelDrafter``: K+1 single-token draft
                    decode steps against its mirrored pool;
                    ``NGramDrafter``: one suffix-match lookup;
                    ``SelfDrafter``: the target's leading layers over a
                    leading-layer view of the target cache);
  2. verification — ONE target forward over [pending, d_1..d_K];
  3. rejection    — exact batched ragged rejection sampling;
  4. post-hoc     — KL per proposed position (the fused KLD kernel on
                    CUDA) -> policy.observe;
  5. commit       — both caches advance by 1 + n_accepted (length
                    arithmetic: the pools already hold the K/V; a
                    recurrent model re-advances its state from the
                    pre-round snapshot over the verified tokens, the
                    rejected steps masked);
  6. termination  — EOS / token budget truncation, ``done`` raised
                    device-side;
  7. predict      — policy.predict (+ SL_cap) for the next round.

RNG is identity-threaded: every draw is keyed by (base seed, request
seed, the request's own round ordinal, purpose, position) through
:func:`repro_torch.core.sampling.counter_uniform`.

On a serving mesh (``plan``, a ``core.tp.MeshPlan``) the drafter's and
the target's forwards return their logits whole over the vocabulary and
the rows (``models/transformer.py``), so steps 3-7 (rejection, the KLD
kernel on the whole vocabulary, the policy) run on the same values on
every rank and the round's outputs are replicated.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig, SpecDecodeConfig
from repro_torch.core.drafters import Drafter, build_drafter
from repro_torch.core.policies import PolicyObservation, build_policy
from repro_torch.core.rejection import rejection_sample
from repro_torch.core.sampling import counter_uniform
from repro_torch.models import cache as cache_lib
from repro_torch.models.transformer import commit, forward
from repro_torch.models.weights import resolve_device

# RNG purpose tags: one per independent random decision a request makes
PURPOSE_DRAFT = 0
PURPOSE_ACCEPT = 1
PURPOSE_RECOVER = 2
PURPOSE_PREFILL = 3


class RoundState(NamedTuple):
    """Carried across rounds by the serving engine.  ``base_seed`` is the
    constant RNG base, ``seed [B]`` binds each slot to its occupant
    request and ``round_idx [B]`` counts the occupant's own rounds."""
    target_cache: dict
    draft_cache: Any
    policy_state: Any
    pending: torch.Tensor        # [B] last emitted token, not yet in caches
    sl_next: torch.Tensor        # [B] per-sequence SL for the next round
    base_seed: int
    seed: torch.Tensor           # [B] int32
    round_idx: torch.Tensor      # [B] int32
    done: torch.Tensor           # [B] bool — slot terminated itself
    tokens_budget: torch.Tensor  # [B] int32 — tokens the slot may still emit
    eos_id: torch.Tensor         # [B] int32 — per-slot EOS (-1 = none)


class RoundOutput(NamedTuple):
    emitted: torch.Tensor        # [B, K+1] new tokens (pad beyond num_emitted)
    num_emitted: torch.Tensor    # [B]
    num_accepted: torch.Tensor   # [B]
    num_proposed: torch.Tensor   # [B]
    finished: torch.Tensor       # [B] bool — slot terminated THIS round
    live: torch.Tensor           # [B] bool — slot did real work this round
    telemetry: Dict[str, torch.Tensor]


def _match_vocab(dl: torch.Tensor, v: int) -> torch.Tensor:
    """Pad (with -1e30) or slice the proposal logits to the target's
    padded-vocab width."""
    dv = dl.shape[-1]
    if dv == v:
        return dl
    if dv < v:
        return torch.nn.functional.pad(dl, (0, v - dv), value=-1e30)
    return dl[..., :v]


def spec_decode_round_impl(params_t, params_d, cfg_t: ModelConfig,
                           drafter: Drafter, spec: SpecDecodeConfig, k: int,
                           state: RoundState, active: torch.Tensor,
                           plan=None) -> Tuple[RoundState, RoundOutput]:
    """One speculative round with draft bucket ``k``; ``active [B]``
    masks occupied slots (intersected with ``~state.done``); ``plan``:
    the serving mesh's, None on one card."""
    assert drafter.spec == spec, (
        "drafter was built from a different SpecDecodeConfig than the round")
    policy = build_policy(spec)
    b = state.pending.shape[0]
    dev = state.pending.device
    pad_id = cfg_t.vocab_size

    def uniforms(purpose, position=0):
        return counter_uniform(state.base_seed, state.seed, state.round_idx,
                               purpose, position)

    live = active & ~state.done
    sl_i = state.sl_next.clamp(max=k) * live.to(torch.int32)

    # --- 1. propose ---------------------------------------------------------
    if k > 0:
        prop = drafter.propose(params_d, state.draft_cache, state.pending, k,
                               sl_i, policy,
                               lambda j: uniforms(PURPOSE_DRAFT, j), live,
                               params_t=params_t,
                               target_cache=state.target_cache, plan=plan)
        sl_i = torch.minimum(sl_i, prop.eff_sl)
        draft_tokens, drafted_cache = prop.tokens, prop.cache
    else:
        draft_tokens = torch.zeros((b, 0), dtype=torch.int32, device=dev)
        drafted_cache = state.draft_cache

    pos = torch.arange(k, device=dev)[None, :]
    proposed = pos < sl_i[:, None]
    safe_drafts = torch.where(proposed, draft_tokens,
                              pad_id).to(torch.int32)

    # --- 2. verification ----------------------------------------------------
    verify_tokens = torch.cat([state.pending[:, None].to(torch.int32),
                               safe_drafts], dim=1)                 # [B, K+1]
    verify_wm = ((torch.arange(k + 1, device=dev)[None] <= sl_i[:, None])
                 & live[:, None])
    t_logits, t_cache_v = forward(params_t, cfg_t, verify_tokens,
                                  cache=state.target_cache, mode="decode",
                                  write_mask=verify_wm, plan=plan)

    # --- 3. rejection sampling ----------------------------------------------
    if k > 0:
        dl = _match_vocab(prop.logits, t_logits.shape[-1])
    else:
        dl = torch.zeros((b, 0, t_logits.shape[-1]), device=dev)
    rej = rejection_sample(
        safe_drafts, dl, t_logits, sl_i, temperature=spec.temperature,
        vocab_size=cfg_t.vocab_size, pad_id=pad_id,
        u_accept=uniforms(PURPOSE_ACCEPT, torch.arange(k, device=dev)[None]),
        u_next=uniforms(PURPOSE_RECOVER))

    # --- 4. post-hoc signals --------------------------------------------------
    if k > 0:
        kld = drafter.observation_kld(t_logits[:, :k], dl, safe_drafts,
                                      proposed)
    else:
        kld = torch.zeros((b, 0), device=dev)
    obs = PolicyObservation(kld=kld, proposed_valid=proposed,
                            num_accepted=rej.num_accepted, num_proposed=sl_i,
                            active=live)
    new_pstate = policy.observe(state.policy_state, obs)

    # --- 5. commit ------------------------------------------------------------
    n_committed = (1 + rej.num_accepted) * live.to(torch.int32)
    t_cache = commit(params_t, cfg_t, verify_tokens, state.target_cache,
                     t_cache_v, n_committed, plan)
    d_cache = (drafter.commit(params_d, verify_tokens, state.draft_cache,
                              drafted_cache, n_committed, plan=plan)
               if k > 0 else state.draft_cache)

    # --- 6. device-side termination -------------------------------------------
    n_raw = rej.num_emitted
    pos1 = torch.arange(k + 1, device=dev)[None, :]
    in_raw = pos1 < n_raw[:, None]
    is_eos = ((rej.emitted == state.eos_id[:, None]) & in_raw
              & (state.eos_id >= 0)[:, None])
    eos_cut = torch.where(is_eos.any(1),
                          is_eos.float().argmax(1).to(torch.int32) + 1,
                          k + 2)                                 # > any n_raw
    n_emit = torch.minimum(n_raw, torch.minimum(eos_cut, state.tokens_budget))
    n_emit = torch.where(live, n_emit, 0).to(torch.int32)
    finished = live & ((n_emit == eos_cut) | (n_emit == state.tokens_budget))
    new_budget = (state.tokens_budget - n_emit).clamp(min=0)

    # --- 7. predict next SL ----------------------------------------------------
    sl_next, new_pstate, telemetry = policy.predict(new_pstate, live)

    new_state = state._replace(
        target_cache=t_cache, draft_cache=d_cache, policy_state=new_pstate,
        pending=torch.where(live, rej.next_token, state.pending.to(torch.int32)),
        sl_next=sl_next, round_idx=state.round_idx + live.to(torch.int32),
        done=state.done | finished, tokens_budget=new_budget.to(torch.int32))
    out = RoundOutput(
        emitted=torch.where(live[:, None] & (pos1 < n_emit[:, None]),
                            rej.emitted, pad_id),
        num_emitted=n_emit,
        num_accepted=rej.num_accepted * live.to(torch.int32),
        num_proposed=sl_i, finished=finished, live=live, telemetry=telemetry)
    return new_state, out


# PyTorch runs eagerly: the round needs no separate compiled entry point
spec_decode_round = spec_decode_round_impl


def init_round_state(cfg_t: ModelConfig, cfg_d: Optional[ModelConfig],
                     spec: SpecDecodeConfig, batch: int, max_len: int,
                     paged: Optional[Tuple[int, int]] = None,
                     base_seed: int = 0, drafter: Optional[Drafter] = None,
                     dtype=torch.float32, device="cuda",
                     kv_quant: str = "none",
                     enc_len: Optional[int] = None, plan=None) -> RoundState:
    """Fresh round state on ``device``: the target's cache — a dense ring
    (``paged=None``) or the block-paged pool (``paged=(num_blocks,
    block_size)``, stored as ``kv_quant`` says) — plus the drafter's
    cache in the same layout (a mirrored pool inherits the storage
    mode).  ``enc_len``: an audio target ring's cross slots, for a round
    driver that fills ``cross_k``/``cross_v``/``enc_valid`` from
    :func:`models.transformer.encode` (the drafter's cache keeps one
    empty slot, as the reference's does).  The termination fields
    default to "never terminate" (the engine sets them per slot at
    prefill).  ``plan``: the caches hold this rank's shards (a serving
    mesh's layouts, ``models/cache.py``); everything else is whole."""
    if kv_quant not in cache_lib.KV_QUANT_MODES:
        raise ValueError(f"unknown kv_quant mode {kv_quant!r}")
    if kv_quant != "none" and paged is None:
        raise ValueError("kv_quant requires the block-paged cache "
                         "(pass paged=(num_blocks, block_size))")
    device = resolve_device(device)
    policy = build_policy(spec)
    if drafter is None:
        drafter = build_drafter(spec, cfg_t, cfg_d)
    i32 = dict(dtype=torch.int32, device=device)
    if paged is None:
        t_cache = cache_lib.cache_struct(cfg_t, batch, max_len, dtype, device,
                                         enc_len=enc_len, plan=plan)
    else:
        t_cache = cache_lib.paged_cache_struct(cfg_t, batch, max_len,
                                               *paged, dtype, device,
                                               kv_quant=kv_quant, plan=plan)
    return RoundState(
        target_cache=t_cache,
        draft_cache=drafter.init_cache(batch, max_len, paged, dtype, device,
                                       kv_quant=kv_quant, plan=plan),
        policy_state=policy.init_state(batch, device),
        pending=torch.zeros((batch,), **i32),
        sl_next=policy.initial_sl(batch, device),
        base_seed=int(base_seed),
        seed=torch.arange(batch, **i32),
        round_idx=torch.zeros((batch,), **i32),
        done=torch.zeros((batch,), dtype=torch.bool, device=device),
        tokens_budget=torch.full((batch,), 2 ** 30, **i32),
        eos_id=torch.full((batch,), -1, **i32))
