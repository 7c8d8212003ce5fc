"""DSDE serving engine of the port (``repro.serving.engine``): plan →
dispatch → collect over the speculative round, on the block-paged pool,
with the synchronous schedule.

* :class:`LookaheadScheduler` — queue/slot admission and the block
  allocator (grow on demand, preempt when the pool runs dry);
* ``spec_decode_round`` — one speculative round with device-side
  termination;
* batched prefill — every admission wave prefills as one multi-row call
  per model, straight into the allocated blocks.

``ServingEngine(...).run(requests)`` is the entry point.  It runs on
``device="cuda"`` unless the caller passes ``device="cpu"``; asking for
CUDA where there is none raises.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prefill as prefill_lib
from repro_torch.core import spec_decode as sd
from repro_torch.core.config import ModelConfig, ServingConfig, SpecDecodeConfig
from repro_torch.core.drafters import build_drafter
from repro_torch.core.policies import build_policy
from repro_torch.core.sampling import counter_uniform, sample_token
from repro_torch.models import cache as cache_lib
from repro_torch.models.weights import Params, map_params, resolve_device
from repro_torch.serving.latency_model import RoundLatencyModel
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import LookaheadScheduler


class _DispatchRecord:
    """What ``collect`` needs of one dispatched round: the bucket, the
    (request, slot) occupancy the round saw, its outputs,
    the post-round SL predictions, and the dispatch time."""

    __slots__ = ("k", "rows", "out", "sl_next", "t_dispatch",
                 "prefill_tokens")

    def __init__(self, k, rows, out, sl_next, t_dispatch, prefill_tokens):
        self.k = k
        self.rows = rows
        self.out = out
        self.sl_next = sl_next
        self.t_dispatch = t_dispatch
        self.prefill_tokens = prefill_tokens


class ServingEngine:
    def __init__(self, params_target: Params, cfg_target: ModelConfig,
                 params_draft: Optional[Params],
                 cfg_draft: Optional[ModelConfig],
                 spec: SpecDecodeConfig, serving: ServingConfig,
                 seed: int = 0, device="cuda"):
        """``params_*`` are parameter trees (``models/weights.py``); they
        are moved to ``device`` if they live elsewhere.  The port serves
        the block-paged pool, fp32 or int8 (``serving.kv_quant``), with
        the synchronous schedule."""
        self.device = resolve_device(device)
        drafter = build_drafter(spec, cfg_target, cfg_draft)
        if drafter.uses_draft_model() and (params_draft is None
                                           or cfg_draft is None):
            raise ValueError(f"drafter {spec.drafter!r} needs draft-model "
                             "params/config")
        # only a drafter that mirrors the pool stores KV of its own
        pooled = [cfg_target] + ([cfg_draft] if drafter.mirrors_kv() else [])
        for cfg in pooled:
            if not cache_lib.supports_paged(cfg):
                raise ValueError(f"family {cfg.family!r} has no paged layout")
        self.kv_quant = serving.kv_quant
        if self.kv_quant not in cache_lib.KV_QUANT_MODES:
            raise ValueError(f"unknown kv_quant mode {self.kv_quant!r}")
        if self.kv_quant != "none" and not all(
                cache_lib.supports_kv_quant(cfg) for cfg in pooled):
            raise ValueError(f"kv_quant={self.kv_quant!r} but family pair "
                             f"({cfg_target.family}, "
                             f"{cfg_draft.family if cfg_draft else None}) "
                             "has no quantized paged layout")
        to_dev = lambda t: t.to(self.device)   # noqa: E731
        self.pt = map_params(to_dev, params_target)
        self.pd = (map_params(to_dev, params_draft)
                   if params_draft is not None else None)
        self.cfg_t, self.cfg_d = cfg_target, cfg_draft
        self.drafter = drafter
        self.spec = spec
        self.policy = build_policy(spec)
        self.serving = serving
        self.scheduler = LookaheadScheduler(
            serving, spec, policy=self.policy, kv_mirror=drafter.mirrors_kv(),
            block_bytes=cache_lib.kv_block_bytes(
                cfg_target, serving.kv_block_size, self.kv_quant))
        self.latency_model = RoundLatencyModel()   # round-cost telemetry
        self.seed = seed
        b = serving.max_batch_size
        self.state = sd.init_round_state(
            cfg_target, cfg_draft, spec, b, serving.max_seq_len,
            paged=(self.scheduler.kv_blocks_total(), serving.kv_block_size),
            base_seed=seed, drafter=drafter, device=self.device,
            kv_quant=self.kv_quant)
        # host mirror of state.sl_next, refreshed once per collect
        self._sl_next_host = np.full((b,), self.policy.initial_sl_value(),
                                     np.int32)
        self._finished_at_prefill: List[Request] = []
        self._prefill_tokens_pending = 0
        self.rounds = 0
        self.draft_steps = 0            # padded bucket steps (k+1)
        self.draft_steps_effective = 0  # max per-seq proposals + 1
        self.emitted_total = 0
        self.round_log: List[Dict[str, float]] = []

    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    # ----------------------------------------------------------- block plane
    def _table_row(self, req: Request) -> np.ndarray:
        row = np.full((self.serving.blocks_per_seq(),), -1, np.int32)
        row[:len(req.block_ids)] = req.block_ids
        return row

    def _sync_block_tables(self, rows: List[Tuple[int, np.ndarray]],
                           fresh_ids: List[int]) -> None:
        """Mirror host allocator decisions into both device caches, in
        place: reset ``kv_pos`` of freshly allocated blocks and rewrite
        the affected block-table rows."""
        if not rows and not fresh_ids:
            return
        caches = [self.state.target_cache]
        if self.drafter.mirrors_kv():
            caches.append(self.state.draft_cache)
        for c in caches:
            if fresh_ids:
                cache_lib.reset_blocks(c["kv_pos"], fresh_ids)
            for slot, row in rows:
                c["block_table"][slot] = torch.as_tensor(row, device=self.device)

    def _plan_blocks(self) -> None:
        """Grow every running sequence to ``committed +
        policy.lookahead(SL_i)``, preempting the youngest when the pool
        runs dry."""
        la = self.scheduler.lookahead_slots()
        slot_of = {id(r): r.slot for r in self.scheduler.running}
        fresh_ids: List[int] = []
        rows: List[Tuple[int, np.ndarray]] = []
        for req in sorted(self.scheduler.running, key=lambda r: r.admit_seq):
            if req.slot is None:        # preempted by an earlier grow
                continue
            new_blocks, preempted = self.scheduler.ensure_capacity(
                req, req.cache_len + int(la[req.slot]))
            if new_blocks:
                fresh_ids += new_blocks
                rows.append((req.slot, self._table_row(req)))
            for victim in preempted:
                rows.append((slot_of[id(victim)],
                             np.full((self.serving.blocks_per_seq(),), -1,
                                     np.int32)))
        self._sync_block_tables(rows, fresh_ids)

    # --------------------------------------------------------------- prefill
    def _emit_token(self, req: Request, tok: int, now: float) -> None:
        """The single host-side token-delivery point."""
        req.output.append(tok)
        self.emitted_total += 1
        if req.first_token_time is None:
            req.first_token_time = now

    def _admit(self) -> None:
        admitted = self.scheduler.admit()
        if admitted:
            self._prefill_group(admitted)

    def _prefill_group(self, reqs: List[Request]) -> None:
        """One multi-row prefill per model for the admission wave: fresh
        requests sample their first token from the prefill logits, a
        readmitted (preempted) request recomputes prompt + output and
        keeps its last emitted token as the pending token."""
        dev = self.device
        r = len(reqs)
        prefixes = [req.prefill_tokens() for req in reqs]
        width = max(len(p) for p in prefixes)
        toks = np.zeros((r, width), np.int32)
        for i, p in enumerate(prefixes):
            toks[i, :len(p)] = p
        plens = np.array([len(p) for p in prefixes], np.int32)
        readmit = np.array([bool(req.output) for req in reqs])
        budgets = np.array([req.max_new_tokens - (len(req.output) or 1)
                            for req in reqs], np.int32)
        eos = np.array([-1 if req.eos_token_id is None else req.eos_token_id
                        for req in reqs], np.int32)
        pend_host = np.array([req.output[-1] if req.output else 0
                              for req in reqs], np.int32)
        slots = [req.slot for req in reqs]
        for req, n in zip(reqs, plens):
            req.cache_len = int(n)
        self._prefill_tokens_pending += int(plens.sum())
        rows_np = np.stack([self._table_row(req) for req in reqs])
        self._sync_block_tables(list(zip(slots, rows_np)),
                                [b for req in reqs for b in req.block_ids])
        st = self.state
        idx = torch.as_tensor(slots, dtype=torch.long, device=dev)
        toks_t = torch.as_tensor(toks, device=dev)
        plen_t = torch.as_tensor(plens, device=dev)
        rows_t = torch.as_tensor(rows_np, device=dev)
        tc = st.target_cache
        view, last = prefill_lib.prefill_paged_rows(
            self.pt, self.cfg_t, tc["k"], tc["v"], tc["kv_pos"], rows_t,
            toks_t, plen_t, tc.get("k_scale"), tc.get("v_scale"))
        tc = prefill_lib.scatter_paged_rows(tc, view, idx)
        rows_mask = torch.zeros((self.serving.max_batch_size,),
                                dtype=torch.bool, device=dev)
        rows_mask[idx] = True
        # a token-history drafter takes the full prefix (prompt + output
        # on a readmit); a mirroring one prefills its own pool
        dc = self.drafter.reset_rows(st.draft_cache, rows_mask)
        dc = self.drafter.prefill(self.pd, dc, idx, toks_t, plen_t, rows_t)
        # first token of a fresh request: keyed by the request's identity
        # alone, so it does not depend on admission grouping
        ids = torch.as_tensor([req.request_id for req in reqs],
                              dtype=torch.int32, device=dev)
        u = counter_uniform(self.seed, ids, torch.zeros_like(ids),
                            sd.PURPOSE_PREFILL)
        sampled = sample_token(u, last, self.spec.temperature,
                               self.cfg_t.vocab_size).to(torch.int32)
        readmit_t = torch.as_tensor(readmit, device=dev)
        eos_t = torch.as_tensor(eos, device=dev)
        budgets_t = torch.as_tensor(budgets, device=dev)
        pend = torch.where(readmit_t, torch.as_tensor(pend_host, device=dev),
                           sampled)
        # a first token that is already EOS (or a 1-token budget) marks
        # the slot done device-side
        done0 = ((pend == eos_t) & (eos_t >= 0)) | (budgets_t <= 0)
        sl0 = self.policy.initial_sl_value()
        # the scheduler's mirror must see the fresh requests' initial SL
        # before this round's block planning
        self._sl_next_host[np.asarray(slots)] = sl0
        self.scheduler.update_predictions(self._sl_next_host)

        def put(t: torch.Tensor, v) -> torch.Tensor:
            t = t.clone()
            t[idx] = v
            return t

        self.state = st._replace(
            target_cache=tc, draft_cache=dc,
            policy_state=self.policy.reset_rows(st.policy_state, rows_mask),
            pending=put(st.pending, pend), sl_next=put(st.sl_next, sl0),
            seed=put(st.seed, ids),
            round_idx=put(st.round_idx, torch.as_tensor(
                [req.rounds for req in reqs], dtype=torch.int32, device=dev)),
            done=put(st.done, done0), tokens_budget=put(st.tokens_budget,
                                                        budgets_t),
            eos_id=put(st.eos_id, eos_t))
        pend_np = pend.cpu().numpy()
        now = time.monotonic()
        for i, req in enumerate(reqs):
            if readmit[i]:
                continue
            tok = int(pend_np[i])
            self._emit_token(req, tok, now)
            if ((req.eos_token_id is not None and tok == req.eos_token_id)
                    or len(req.output) >= req.max_new_tokens):
                req.state = RequestState.FINISHED
                req.finish_time = now
                self.scheduler.release(req)
                self._finished_at_prefill.append(req)

    # ------------------------------------------------------------- the phases
    def plan(self) -> None:
        """Admission + prefill, then block growth for the next round."""
        self._admit()
        if self.scheduler.running:
            self._plan_blocks()

    def dispatch(self) -> Optional[_DispatchRecord]:
        """Run one speculative round over the occupied slots."""
        if not self.scheduler.running:
            return None
        rows = [(r, r.slot) for r in self.scheduler.running]
        active = torch.as_tensor(self.scheduler.active_mask, device=self.device)
        k = self.policy.pick_bucket(
            self.scheduler.host_context(self._sl_next_host))
        t_dispatch = time.monotonic()
        self.state, out = sd.spec_decode_round(
            self.pt, self.pd, self.cfg_t, self.drafter, self.spec, k,
            self.state, active)
        self.rounds += 1
        self.draft_steps += (k + 1) if k > 0 else 0
        rec = _DispatchRecord(k, rows, out, self.state.sl_next, t_dispatch,
                              self._prefill_tokens_pending)
        self._prefill_tokens_pending = 0
        return rec

    def collect(self, rec: _DispatchRecord) -> List[Request]:
        """Reconcile a round on the host: distribute tokens, apply
        terminal states, refresh the SL mirror, return the speculative
        tail blocks."""
        t0 = time.monotonic()
        o = rec.out
        emitted, n_emit, n_acc, n_prop, fin, live, sl_next = (
            x.cpu().numpy() for x in (o.emitted, o.num_emitted,
                                      o.num_accepted, o.num_proposed,
                                      o.finished, o.live, rec.sl_next))
        host_blocked = time.monotonic() - t0
        for req, slot in rec.rows:
            if self.scheduler.slots[slot] is req:
                self._sl_next_host[slot] = sl_next[slot]
        self.scheduler.update_predictions(self._sl_next_host)
        now = time.monotonic()
        finished: List[Request] = []
        shrunk: List[Tuple[int, np.ndarray]] = []
        for req, slot in rec.rows:
            if req.done:
                continue
            if live[slot]:
                req.cache_len += 1 + int(n_acc[slot])
                req.rounds += 1
                req.accepted_tokens += int(n_acc[slot])
                req.proposed_tokens += int(n_prop[slot])
                for t in emitted[slot, :n_emit[slot]].tolist():
                    if t != self.cfg_t.vocab_size:       # pad sentinel
                        self._emit_token(req, int(t), now)
                if fin[slot]:
                    req.state = RequestState.FINISHED
                    req.finish_time = now
            if req.done:
                self.scheduler.release(req)
                finished.append(req)
            elif req.slot is not None and self.scheduler.shrink_to(
                    req, req.cache_len):
                # the device row must drop freed entries now: a freed block
                # can be reallocated to another sequence at the next admission
                shrunk.append((req.slot, self._table_row(req)))
        self._sync_block_tables(shrunk, [])
        log = {"k": rec.k, "emitted": float(n_emit[live].sum()),
               "accepted": float(n_acc[live].sum()),
               "proposed": float(n_prop[live].sum())}
        eff_steps = 0
        if rec.k > 0 and live.any():
            eff_steps = int(n_prop[live].max()) + 1
            self.draft_steps_effective += eff_steps
        log["draft_cost_effective"] = eff_steps * self.drafter.step_cost()
        log["lookahead"] = float(self.scheduler.lookahead_slots()[
            self.scheduler.active_mask].sum())
        log["kv_blocks_in_use"] = float(self.scheduler.kv_blocks_in_use())
        log["kv_pool_utilization"] = (log["kv_blocks_in_use"]
                                      / max(self.scheduler.kv_blocks_total(), 1))
        log["host_blocked_s"] = host_blocked
        log["wall_s"] = time.monotonic() - rec.t_dispatch
        b_eff = len(rec.rows)
        log["b_eff"] = float(b_eff)
        log["prefill_tokens"] = float(rec.prefill_tokens)
        log["t_round_pred_s"] = self.latency_model.predict_round_s(
            rec.k, b_eff, rec.prefill_tokens)
        self.latency_model.observe(log["wall_s"], rec.k, b_eff,
                                   rec.prefill_tokens)
        self.round_log.append(log)
        return finished

    def step(self) -> List[Request]:
        """Plan, dispatch, collect.  Returns requests that reached a
        terminal state this step (finished or rejected)."""
        self.plan()
        done = self._finished_at_prefill + self.scheduler.pop_rejected()
        self._finished_at_prefill = []
        if not self.scheduler.running:
            return done
        return done + self.collect(self.dispatch())

    def run(self, requests: Sequence[Request],
            max_rounds: Optional[int] = None) -> Dict[str, float]:
        t0 = time.monotonic()
        for r in requests:
            self.submit(r)
        done: List[Request] = []
        while self.scheduler.has_work():
            done += self.step()
            if max_rounds is not None and self.rounds >= max_rounds:
                break
        return self.summary(done, time.monotonic() - t0)

    def summary(self, done: Sequence[Request], wall: float) -> Dict[str, float]:
        fin = [r for r in done if r.state == RequestState.FINISHED]
        rej = [r for r in done if r.state == RequestState.REJECTED]
        lat = [r.latency() for r in fin if r.latency() is not None]
        ttft = [r.ttft() for r in fin if r.ttft() is not None]

        def mean(xs):
            return float(np.mean(xs)) if xs else float("nan")

        return {
            **self.latency_model.summary_fields(),
            "device": str(self.device),
            "wall_time_s": wall,
            "requests_finished": len(fin),
            "requests_rejected": len(rej),
            "preemptions": self.scheduler.preempted_total,
            "tokens_emitted": self.emitted_total,
            "rounds": self.rounds,
            "drafter": self.spec.drafter,
            "draft_step_cost": self.drafter.step_cost(),
            "draft_steps": self.draft_steps,
            "draft_steps_effective": self.draft_steps_effective,
            "block_efficiency": mean([r.block_efficiency() for r in fin]),
            "batch_tokens_per_round": self.emitted_total / max(self.rounds, 1),
            "throughput_tok_s": self.emitted_total / max(wall, 1e-9),
            "mean_latency_s": mean(lat),
            "ttft_mean_s": mean(ttft),
            "host_blocked_s": float(sum(r["host_blocked_s"]
                                        for r in self.round_log)),
            "mean_acceptance": mean([r.acceptance_rate() for r in fin]),
            "kv_blocks_peak": float(max((r["kv_blocks_in_use"]
                                         for r in self.round_log), default=0.0)),
            "kv_pool_blocks": float(self.scheduler.kv_blocks_total()),
            "kv_quant": self.kv_quant,
            "kv_block_bytes": float(self.scheduler.kv_block_bytes()),
            "kv_pool_bytes": float(self.scheduler.kv_bytes_total()),
        }
