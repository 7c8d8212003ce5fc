"""DSDE serving engine of the port (``repro.serving.engine``): plan →
dispatch → collect over the speculative round.

* :class:`LookaheadScheduler` — queue/slot admission and, on the
  block-paged pool (``ServingConfig.paged_kv``), the block allocator
  (grow on demand, preempt when the pool runs dry); the default dense
  ring holds one row per slot;
* ``spec_decode_round`` — one speculative round with device-side
  termination;
* batched prefill — every admission wave prefills one multi-row call per
  model per prompt bucket (the reference's power-of-two buckets, so a
  ring keeps the same tokens as the reference's), into fresh ring rows
  or straight into the allocated blocks.

Two schedules share every phase:

* synchronous (default) — ``step()`` = plan, dispatch, collect;
* pipelined (``ServingConfig.pipelined``) — round N+1 is dispatched
  before round N is collected, so the host reconciles one round behind
  while the device runs.  Dispatch starts copies of the round's outputs
  into host memory, stream-ordered right behind the round (pinned
  buffers, ``non_blocking``, one CUDA event), and ``collect`` waits on
  that event alone: nothing it reads can be overwritten by a later
  round.  Greedy streams equal the synchronous engine's.

``ServingEngine(...).run(requests)`` is the entry point.  It runs on
``device="cuda"`` unless the caller passes ``device="cpu"``; asking for
CUDA where there is none raises.
"""
from __future__ import annotations

import dataclasses
import math
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


def _bucket(n: int, minimum: int = 16, cap: Optional[int] = None) -> int:
    """The reference's power-of-two prompt bucket, clamped to the KV
    budget."""
    b = max(minimum, 1 << math.ceil(math.log2(max(n, 1))))
    if cap is not None:
        b = min(b, cap)
        assert n <= b, f"prompt of {n} tokens exceeds the KV budget {cap}"
    return b


class _DispatchRecord:
    """What ``collect`` needs of one dispatched round, captured at
    dispatch: the bucket, the (request, slot, preemptions) occupancy the
    round saw, the first tokens of the admission waves riding it
    (``admits``: fresh requests, their rows in ``pends``, their
    preemption counts), host copies of the round's outputs (``out``, a
    :class:`RoundOutput` of host tensors), of the post-round SL
    predictions (``sl_next``) and of the waves' first tokens
    (``pends``), the CUDA event that marks those copies done (None on
    the CPU), and the dispatch time."""

    __slots__ = ("k", "rows", "admits", "out", "sl_next", "pends", "ready",
                 "t_dispatch", "prefill_tokens")

    def __init__(self, k, rows, admits, out, sl_next, pends, ready,
                 t_dispatch, prefill_tokens):
        self.k = k
        self.rows = rows
        self.admits = admits
        self.out = out
        self.sl_next = sl_next
        self.pends = pends
        self.ready = ready
        self.t_dispatch = t_dispatch
        self.prefill_tokens = prefill_tokens


class ServingEngine:
    def __init__(self, params_target: Params, cfg_target: ModelConfig,
                 params_draft: Optional[Params],
                 cfg_draft: Optional[ModelConfig],
                 spec: SpecDecodeConfig, serving: ServingConfig,
                 seed: int = 0, device="cuda",
                 latency_model: Optional[RoundLatencyModel] = None):
        """``params_*`` are parameter trees (``models/weights.py``); they
        are moved to ``device`` if they live elsewhere.  The KV layout is
        the dense ring or, with ``serving.paged_kv``, the block-paged
        pool, fp32 or int8 (``serving.kv_quant``); the schedule is
        synchronous or pipelined (``serving.pipelined``).

        ``latency_model``: a pre-seeded :class:`RoundLatencyModel` (e.g.
        warm-started from a calibration sweep's round log), or None for a
        fresh one.  The engine feeds it one sample per collected round
        and installs it on the scheduler, where the ``slo`` policy's
        bucket pick and the admission gate read it."""
        self.device = resolve_device(device)
        drafter = build_drafter(spec, cfg_target, cfg_draft)
        if drafter.uses_draft_model() and (params_draft is None
                                           or cfg_draft is None):
            raise ValueError(f"drafter {spec.drafter!r} needs draft-model "
                             "params/config")
        # a goodput cost left at None comes from the drafter's own step
        # cost, before any policy is built: the resolved spec is the one
        # every later part sees
        if spec.goodput_draft_cost is None:
            spec = dataclasses.replace(spec,
                                       goodput_draft_cost=drafter.step_cost())
            drafter = build_drafter(spec, cfg_target, cfg_draft)
        self.paged = serving.paged_kv
        # only a drafter that mirrors the pool stores KV of its own
        pooled = [cfg_target] + ([cfg_draft] if drafter.mirrors_kv() else [])
        for cfg in pooled:
            if self.paged and not cache_lib.supports_paged(cfg):
                raise ValueError(f"family {cfg.family!r} has no paged layout")
        self.kv_quant = serving.kv_quant
        if self.kv_quant not in cache_lib.KV_QUANT_MODES:
            raise ValueError(f"unknown kv_quant mode {self.kv_quant!r}")
        if self.kv_quant != "none" and not self.paged:
            raise ValueError("kv_quant requires paged_kv=True")
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
            block_bytes=(cache_lib.kv_block_bytes(
                cfg_target, serving.kv_block_size, self.kv_quant)
                if self.paged else 0))
        self.latency_model = (latency_model if latency_model is not None
                              else RoundLatencyModel())
        self.scheduler.latency_model = self.latency_model
        self.seed = seed
        b = serving.max_batch_size
        self.state = sd.init_round_state(
            cfg_target, cfg_draft, spec, b, serving.max_seq_len,
            paged=((self.scheduler.kv_blocks_total(), serving.kv_block_size)
                   if self.paged else None),
            base_seed=seed, drafter=drafter, device=self.device,
            kv_quant=self.kv_quant)
        # host mirror of state.sl_next, refreshed once per collect; ONE
        # ROUND STALE at a pipelined dispatch (block planning adds slack)
        self._sl_next_host = np.full((b,), self.policy.initial_sl_value(),
                                     np.int32)
        self._finished_at_prefill: List[Request] = []
        self._prefill_tokens_pending = 0
        # pipeline bookkeeping: the round dispatched and not yet
        # collected, the admission waves whose first tokens ride the next
        # dispatch (requests, pend tokens [R] on the device, their rows,
        # their preemption counts), and the bucket chosen at plan time
        self._inflight: Optional[_DispatchRecord] = None
        self._pending_admits: List[Tuple[List[Request], torch.Tensor,
                                         List[int], List[int]]] = []
        self._planned_k: Optional[int] = None
        self.rounds = 0
        self.draft_steps = 0            # padded bucket steps (k+1)
        self.draft_steps_effective = 0  # max per-seq proposals + 1
        self.emitted_total = 0
        self.round_log: List[Dict[str, float]] = []

    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)

    # --------------------------------------------------------- host <-> device
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device without a host wait: through a
        pinned buffer with a ``non_blocking`` copy on CUDA (a pageable
        copy would wait for the whole stream, the round in flight
        included)."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _host_copies(self, tensors: Sequence[torch.Tensor]
                     ) -> Tuple[List[torch.Tensor], Optional[torch.cuda.Event]]:
        """Copies of device tensors in host memory, taken in stream order
        right behind the work that produced them: on CUDA ``non_blocking``
        copies into pinned buffers and one event that marks them done; on
        the CPU plain copies."""
        if self.device.type != "cuda":
            return [t.clone() for t in tensors], None
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

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
        if fresh_ids:
            ids = self._to_device(np.asarray(fresh_ids, np.int64))
        if rows:
            slots = self._to_device(np.asarray([s for s, _ in rows], np.int64))
            table = self._to_device(np.stack([row for _, row in rows]))
        for c in caches:
            if fresh_ids:
                cache_lib.reset_blocks(c["kv_pos"], ids)
            if rows:
                c["block_table"][slots] = table

    def _plan_blocks(self) -> None:
        """Grow every running sequence to cover the next round's write
        extent, preempting the youngest when the pool runs dry.

        Synchronous: exactly ``committed + policy.lookahead(SL_i)``.
        Pipelined: the host mirrors are one round stale, so the bound is
        ``cache_len + (1 + K_inflight) + (1 + K_next)`` (the largest
        commit the uncollected round can apply, plus the next round's
        widest write), capped at ``max_seq_len``; stale information can
        only over-allocate, and the tail returns at the next shrink."""
        pipelined = self.serving.pipelined
        la = None if pipelined else self.scheduler.lookahead_slots()
        k_next = self._planned_k or 0
        inflight = ({id(r) for r, _, _ in self._inflight.rows}
                    if self._inflight is not None else set())
        slot_of = {id(r): r.slot for r in self.scheduler.running}
        fresh_ids: List[int] = []
        rows: List[Tuple[int, np.ndarray]] = []
        for req in sorted(self.scheduler.running, key=lambda r: r.admit_seq):
            if req.slot is None:        # preempted by an earlier grow
                continue
            if pipelined:
                slack = (1 + self._inflight.k) if id(req) in inflight else 0
                need = min(req.cache_len + slack + k_next + 1,
                           self.serving.max_seq_len)
            else:
                need = req.cache_len + int(la[req.slot])
            new_blocks, preempted = self.scheduler.ensure_capacity(req, need)
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

    def _commit_first_tokens(self, items: List[Tuple[Request, int]],
                             now: float) -> List[Request]:
        """Emit prefill-sampled first tokens and apply the EOS /
        ``max_new_tokens`` checks (the host mirror of the device-side
        ``done`` set at prefill)."""
        finished = []
        for req, tok in items:
            self._emit_token(req, tok, now)
            if ((req.eos_token_id is not None and tok == req.eos_token_id)
                    or len(req.output) >= req.max_new_tokens):
                req.state = RequestState.FINISHED
                req.finish_time = now
                finished.append(req)
        return finished

    def _admit(self) -> None:
        """Admission, then one prefill group per prompt bucket."""
        groups: Dict[int, List[Request]] = {}
        admitted = self.scheduler.admit()
        now = time.monotonic()
        for req in admitted:
            if req.first_dispatch_time is None:
                req.first_dispatch_time = now
            b = _bucket(len(req.prefill_tokens()), cap=self.serving.max_seq_len)
            groups.setdefault(b, []).append(req)
        for bucket in sorted(groups):
            self._prefill_group(groups[bucket], bucket)

    def _prefill_group(self, reqs: List[Request], bucket: int) -> None:
        """One multi-row prefill per model for a same-bucket group, padded
        to the bucket: fresh requests sample their first token from the
        prefill logits, a readmitted (preempted) request recomputes
        prompt + output and keeps its last emitted token as the pending
        token.  Under the pipelined schedule the fresh first tokens stay
        on the device and ride the next dispatch record."""
        dev = self.device
        r = len(reqs)
        prefixes = [req.prefill_tokens() for req in reqs]
        toks = np.zeros((r, bucket), np.int32)
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
        idx = self._to_device(np.asarray(slots, np.int64))
        toks_t = self._to_device(toks)
        plen_t = self._to_device(plens)
        rows_t = None
        if self.paged:
            rows_np = np.stack([self._table_row(req) for req in reqs])
            self._sync_block_tables(list(zip(slots, rows_np)),
                                    [b for req in reqs for b in req.block_ids])
            rows_t = self._to_device(rows_np)
            tc = self.state.target_cache
            view, last = prefill_lib.prefill_paged_rows(
                self.pt, self.cfg_t, tc["k"], tc["v"], tc["kv_pos"], rows_t,
                toks_t, plen_t, tc.get("k_scale"), tc.get("v_scale"))
            tc = prefill_lib.scatter_paged_rows(tc, view, idx)
        else:
            rows, last = prefill_lib.prefill_rows(
                self.pt, self.cfg_t, toks_t, plen_t, self.serving.max_seq_len)
            tc = prefill_lib.set_slots(self.state.target_cache, rows, idx)
        st = self.state
        rows_mask = torch.zeros((self.serving.max_batch_size,),
                                dtype=torch.bool, device=dev)
        rows_mask[idx] = True
        # a token-history drafter takes the full prefix (prompt + output
        # on a readmit); a model drafter prefills its own cache
        dc = self.drafter.reset_rows(st.draft_cache, rows_mask)
        dc = self.drafter.prefill(self.pd, dc, idx, toks_t, plen_t, rows_t,
                                  max_len=self.serving.max_seq_len)
        # first token of a fresh request: keyed by the request's identity
        # alone, so it does not depend on admission grouping
        ids = self._to_device(np.asarray([req.request_id for req in reqs],
                                         np.int32))
        u = counter_uniform(self.seed, ids, torch.zeros_like(ids),
                            sd.PURPOSE_PREFILL)
        sampled = sample_token(u, last, self.spec.temperature,
                               self.cfg_t.vocab_size).to(torch.int32)
        readmit_t = self._to_device(readmit)
        eos_t = self._to_device(eos)
        budgets_t = self._to_device(budgets)
        pend = torch.where(readmit_t, self._to_device(pend_host), sampled)
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
            round_idx=put(st.round_idx, self._to_device(np.asarray(
                [req.rounds for req in reqs], np.int32))),
            done=put(st.done, done0), tokens_budget=put(st.tokens_budget,
                                                        budgets_t),
            eos_id=put(st.eos_id, eos_t))
        fresh = [(i, req) for i, req in enumerate(reqs) if not readmit[i]]
        if not fresh:
            return
        if self.serving.pipelined:
            # the tokens reach the host with the next round's outputs; the
            # preemption count pins the prefill a token came from (a
            # request evicted before that round dispatched drops it)
            self._pending_admits.append(
                ([req for _, req in fresh], pend, [i for i, _ in fresh],
                 [req.preemptions for _, req in fresh]))
            return
        pend_np = pend.cpu().numpy()
        for req in self._commit_first_tokens(
                [(req, int(pend_np[i])) for i, req in fresh],
                time.monotonic()):
            self.scheduler.release(req)
            self._finished_at_prefill.append(req)

    # ------------------------------------------------------------- the phases
    def plan(self) -> None:
        """Admission + prefill, the pipelined bucket choice, then block
        growth for the next round (paged)."""
        self._admit()
        self._planned_k = None
        if not self.scheduler.running:
            return
        if self.serving.pipelined:
            self._planned_k = self._pick_bucket_pipelined()
        if self.paged:
            before = self.scheduler.preempted_total
            self._plan_blocks()
            if (self.serving.pipelined and self.scheduler.running
                    and self.scheduler.preempted_total != before):
                # an evicted slot must not size the bucket: re-pick over
                # the survivors (a smaller K only shrinks the write
                # extents the growth above already covers)
                self._planned_k = self._pick_bucket_pipelined()

    def _pick_bucket_pipelined(self) -> int:
        """Greedy rounds pick from the one-round-stale SL mirror (a
        clipped window cannot change argmax streams); rounds at
        temperature > 0 take the policy's max bucket, so a stale pick
        never clips the window a sampled stream depends on."""
        if self.spec.temperature > 0.0:
            return self.policy.max_bucket()
        return self.policy.pick_bucket(self._host_context())

    def _host_context(self):
        """The policy hooks' view of the round: the scheduler's per-slot
        state, the SL mirror, the latency model and the round ordinal."""
        return self.scheduler.host_context(self._sl_next_host,
                                           round_ordinal=self.rounds)

    def dispatch(self) -> Optional[_DispatchRecord]:
        """Enqueue one speculative round over the occupied slots and
        start the host copies of what ``collect`` reads.  Never waits
        for the device."""
        if not self.scheduler.running:
            assert not self._pending_admits
            return None
        rows = [(r, r.slot, r.preemptions) for r in self.scheduler.running]
        active = self._to_device(self.scheduler.active_mask)
        k = (self._planned_k if self._planned_k is not None
             else self.policy.pick_bucket(self._host_context()))
        self._planned_k = None
        t_dispatch = time.monotonic()
        self.state, out = sd.spec_decode_round(
            self.pt, self.pd, self.cfg_t, self.drafter, self.spec, k,
            self.state, active)
        self.rounds += 1
        self.draft_steps += (k + 1) if k > 0 else 0
        admits = self._pending_admits
        host, ready = self._host_copies(
            [out.emitted, out.num_emitted, out.num_accepted, out.num_proposed,
             out.finished, out.live, self.state.sl_next]
            + [pend for _, pend, _, _ in admits])
        rec = _DispatchRecord(
            k, rows, [(reqs, idx, pcs) for reqs, _, idx, pcs in admits],
            sd.RoundOutput(*host[:6], telemetry={}), host[6], host[7:],
            ready, t_dispatch, self._prefill_tokens_pending)
        self._prefill_tokens_pending = 0
        self._pending_admits = []
        self._inflight = rec
        return rec

    def collect(self, rec: _DispatchRecord) -> List[Request]:
        """Reconcile a dispatched round on the host: wait for its copies,
        distribute tokens, apply terminal states, refresh the SL mirror,
        return the speculative tail blocks.  Under the pipelined schedule
        this runs while the next round is in flight, so the slot table
        may already differ from the one the round saw."""
        t0 = time.monotonic()
        if rec.ready is not None:
            rec.ready.synchronize()
        o = rec.out
        emitted, n_emit, n_acc, n_prop, fin, live = (
            x.numpy() for x in (o.emitted, o.num_emitted, o.num_accepted,
                                o.num_proposed, o.finished, o.live))
        sl_next = rec.sl_next.numpy()
        host_blocked = time.monotonic() - t0
        # refresh the SL mirror only for slots still owned by the request
        # the round ran (a slot readmitted since carries its new
        # occupant's initial SL)
        for req, slot, _ in rec.rows:
            if self.scheduler.slots[slot] is req:
                self._sl_next_host[slot] = sl_next[slot]
        self.scheduler.update_predictions(self._sl_next_host)
        now = time.monotonic()
        finished: List[Request] = []
        # (a) first tokens of the admission waves riding this round.  A
        # request preempted before the round dispatched (not in its rows)
        # drops its token: the readmission samples its own.  One that
        # finishes here after a later preemption leaves the queue.
        in_rows = {id(r) for r, _, _ in rec.rows}
        for (reqs, idxs, pcounts), pend in zip(rec.admits, rec.pends):
            pend = pend.numpy()
            items = [(req, int(pend[i]), pc)
                     for req, i, pc in zip(reqs, idxs, pcounts)
                     if id(req) in in_rows]
            for req in self._commit_first_tokens(
                    [(r, t) for r, t, _ in items], now):
                pc = next(p for r, _, p in items if r is req)
                if req.preemptions != pc or req.slot is None:
                    self.scheduler.drop_from_queue(req)
                else:
                    self.scheduler.release(req)
                finished.append(req)
        # (b) per-slot reconciliation against the dispatch-time occupancy
        inflight_k = (self._inflight.k if (self._inflight is not None
                                           and self._inflight is not rec)
                      else None)
        shrunk: List[Tuple[int, np.ndarray]] = []
        for req, slot, pcount in rec.rows:
            if req.done:
                continue
            # preempted (or readmitted elsewhere) since dispatch: its
            # tokens are real, but its slot-side state was reset
            displaced = req.preemptions != pcount or req.slot != slot
            if live[slot]:
                if not displaced:
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
                if displaced:
                    self.scheduler.drop_from_queue(req)
                else:
                    self.scheduler.release(req)
                finished.append(req)
            elif not displaced and self.paged and req.slot is not None:
                # the device row must drop freed entries now: a freed
                # block can be reallocated at the next admission.  A round
                # in flight keeps its write extent resident.
                keep = (req.cache_len if inflight_k is None
                        else min(req.cache_len + inflight_k + 1,
                                 self.serving.max_seq_len))
                if self.scheduler.shrink_to(req, keep):
                    shrunk.append((req.slot, self._table_row(req)))
        self._sync_block_tables(shrunk, [])
        log = {"k": rec.k, "drafter": self.spec.drafter,
               "emitted": float(n_emit[live].sum()),
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
        # the mirrored draft pool holds the target's in-use block set; a
        # model-free drafter holds none
        log["draft_kv_blocks_in_use"] = (log["kv_blocks_in_use"]
                                         if self.drafter.mirrors_kv() else 0.0)
        log["host_blocked_s"] = host_blocked
        # with a successor in flight the round's cadence is dispatch to
        # dispatch (pipelined walls sum to the run's); else dispatch to
        # the end of reconciliation
        if self._inflight is not None and self._inflight is not rec:
            log["wall_s"] = self._inflight.t_dispatch - rec.t_dispatch
        else:
            log["wall_s"] = time.monotonic() - rec.t_dispatch
        b_eff = len(rec.rows)
        log["b_eff"] = float(b_eff)
        log["prefill_tokens"] = float(rec.prefill_tokens)
        log["t_round_pred_s"] = self.latency_model.predict_round_s(
            rec.k, b_eff, rec.prefill_tokens)
        self.latency_model.observe(log["wall_s"], rec.k, b_eff,
                                   rec.prefill_tokens)
        self.round_log.append(log)
        if self._inflight is rec:
            self._inflight = None
        return finished

    def step(self) -> List[Request]:
        """Synchronous lockstep: plan, dispatch, collect.  Returns requests
        that reached a terminal state this step (finished or rejected)."""
        self.plan()
        done = self._finished_at_prefill + self.scheduler.pop_rejected()
        self._finished_at_prefill = []
        if not self.scheduler.running:
            return done
        return done + self.collect(self.dispatch())

    def has_pending_work(self) -> bool:
        """Queued or running requests, or a dispatched round not yet
        collected."""
        return self.scheduler.has_work() or self._inflight is not None

    def pump(self) -> List[Request]:
        """One iteration of the serving loop: a lockstep ``step()``, or
        under the pipelined schedule plan + dispatch round N+1, then
        collect round N while N+1 runs.  After the last one,
        :meth:`drain`."""
        if not self.serving.pipelined:
            return self.step() if self.scheduler.has_work() else []
        self.plan()
        done = self.scheduler.pop_rejected()
        prev = self._inflight
        self.dispatch()
        if prev is not None:
            done += self.collect(prev)
        return done

    def drain(self) -> List[Request]:
        """Collect the round still in flight after the last ``pump()``."""
        if self._inflight is not None:
            return self.collect(self._inflight)
        return []

    def run(self, requests: Sequence[Request],
            max_rounds: Optional[int] = None) -> Dict[str, float]:
        t0 = time.monotonic()
        for r in requests:
            self.submit(r)
        done: List[Request] = []
        while self.has_pending_work():
            done += self.pump()
            if max_rounds is not None and self.rounds >= max_rounds:
                break
        done += self.drain()
        return self.summary(done, time.monotonic() - t0)

    def summary(self, done: Sequence[Request], wall: float) -> Dict[str, float]:
        """Run-level metrics over a set of terminal requests: the
        reference's summary without its prefix-cache fields (that
        feature comes with its slice)."""
        fin = [r for r in done if r.state == RequestState.FINISHED]
        rej = [r for r in done if r.state == RequestState.REJECTED]
        lat = [r.latency() for r in fin if r.latency() is not None]
        ttft = [r.ttft() for r in fin if r.ttft() is not None]
        qw = [r.queue_wait() for r in fin if r.queue_wait() is not None]
        log = self.round_log
        blocked = float(sum(r["host_blocked_s"] for r in log))

        def mean(xs):
            return float(np.mean(xs)) if xs else float("nan")

        def p95(xs):
            return float(np.percentile(xs, 95)) if xs else float("nan")

        # SLO accounting: attainment over every terminal request (a
        # rejected one never attains); goodput counts the tokens of the
        # requests that met their own deadline, so with no deadline it
        # equals throughput
        attained = [r for r in done if r.slo_attained()]
        return {
            **self.latency_model.summary_fields(),
            "slo_requests_attained": len(attained),
            "slo_attained_frac": len(attained) / max(len(done), 1),
            "slo_goodput_tok_s": (sum(len(r.output) for r in attained)
                                  / max(wall, 1e-9)),
            "slo_predicted_violations": float(
                self.scheduler.slo_predicted_violations),
            "slo_deferrals": float(self.scheduler.slo_deferrals_total),
            "device": str(self.device),
            "wall_time_s": wall,
            "requests_finished": len(fin),
            "requests_rejected": len(rej),
            "preemptions": self.scheduler.preempted_total,
            "tokens_emitted": self.emitted_total,
            "rounds": self.rounds,
            "drafter": self.spec.drafter,
            "draft_step_cost": self.drafter.step_cost(),
            "draft_cost_effective": float(sum(r["draft_cost_effective"]
                                              for r in log)),
            "draft_kv_blocks_peak": float(max(
                (r["draft_kv_blocks_in_use"] for r in log), default=0.0)),
            "draft_steps": self.draft_steps,
            "draft_steps_effective": self.draft_steps_effective,
            "block_efficiency": mean([r.block_efficiency() for r in fin]),
            "batch_tokens_per_round": self.emitted_total / max(self.rounds, 1),
            "throughput_tok_s": self.emitted_total / max(wall, 1e-9),
            "mean_latency_s": mean(lat),
            "p95_latency_s": p95(lat),
            "ttft_mean_s": mean(ttft),
            "ttft_p95_s": p95(ttft),
            "queue_wait_mean_s": mean(qw),
            "host_blocked_s": blocked,
            "host_blocked_per_round_s": blocked / max(len(log), 1),
            "mean_acceptance": mean([r.acceptance_rate() for r in fin]),
            "kv_blocks_peak": float(max((r["kv_blocks_in_use"] for r in log),
                                        default=0.0)),
            "kv_pool_blocks": float(self.scheduler.kv_blocks_total()),
            "kv_quant": self.kv_quant,
            "kv_block_bytes": float(self.scheduler.kv_block_bytes()),
            "kv_pool_bytes": float(self.scheduler.kv_bytes_total()),
            # resident KV bytes summed over rounds: a proxy for the bytes
            # the verify passes stream from the pool
            "kv_bytes_swept": float(sum(r["kv_blocks_in_use"] for r in log))
                              * float(self.scheduler.kv_block_bytes()),
            "kv_pool_utilization_mean": (
                float(np.mean([r["kv_pool_utilization"] for r in log]))
                if log else 0.0),
            "kv_pool_utilization_peak": float(max(
                (r["kv_pool_utilization"] for r in log), default=0.0)),
        }
