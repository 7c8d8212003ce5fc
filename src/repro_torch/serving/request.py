"""Request lifecycle for the serving engine: a copy of
``repro.serving.request`` cut to the fields the port's engine uses (the
prefix-cache and streaming fields come with their slices)."""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    # oversize at admission: can never fit prompt + max_new_tokens +
    # the policy's worst-case lookahead inside max_seq_len.  Terminal;
    # surfaced from ``ServingEngine.step`` and counted in the run summary.
    REJECTED = "rejected"


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: List[int]
    max_new_tokens: int = 128
    eos_token_id: Optional[int] = None
    # --- SLO fields (DESIGN.md §15) -----------------------------------------
    # completion deadline in seconds from arrival (None = no deadline):
    # the ``slo`` policy and the scheduler's admission gate read it
    slo_deadline_s: Optional[float] = None
    # admission tie-break under SLO deferral: a head predicted to miss
    # its deadline yields only to later FRESH arrivals of same-or-higher
    # priority
    priority: int = 0
    # --- runtime fields -----------------------------------------------------
    state: RequestState = RequestState.QUEUED
    output: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    arrival_time: float = dataclasses.field(default_factory=time.monotonic)
    # first admission out of the queue (never overwritten on a
    # preemption readmit: queue wait is an arrival-side metric)
    admit_time: Optional[float] = None
    # when the request's prefill was enqueued on the device (the host
    # observes its first token up to a round later when pipelined)
    first_dispatch_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    rounds: int = 0                    # target verifications consumed
    accepted_tokens: int = 0
    proposed_tokens: int = 0
    # flagged once by the admission gate when even the best case misses
    # the deadline (``LookaheadScheduler.pop_slo_risk``), and how often
    # admission rotated the request behind feasible fresh work (at most
    # ``ServingConfig.slo_defer_limit``: never starved)
    slo_predicted_violation: bool = False
    slo_deferrals: int = 0
    # --- paged-KV fields ----------------------------------------------------
    block_ids: List[int] = dataclasses.field(default_factory=list)
    cache_len: int = 0                 # committed tokens in the KV cache
    preemptions: int = 0               # evict-and-requeue count
    admit_seq: int = -1                # admission order (LIFO preemption key)

    @property
    def done(self) -> bool:
        return self.state in (RequestState.FINISHED, RequestState.REJECTED)

    def prefill_tokens(self) -> List[int]:
        """Tokens to prefill on (re)admission.  A preempted request is
        recomputed from prompt + already-emitted output; its last emitted
        token is the pending token, not yet in any cache."""
        if self.output:
            return self.prompt + self.output[:-1]
        return self.prompt

    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    def deadline_remaining_s(self, now: Optional[float] = None
                             ) -> Optional[float]:
        """Seconds until the completion deadline lapses (negative once
        past it), or None when no deadline is set."""
        if self.slo_deadline_s is None:
            return None
        now = time.monotonic() if now is None else now
        return (self.arrival_time + self.slo_deadline_s) - now

    def slo_attained(self, slo_ttft_s: Optional[float] = None,
                     slo_tpot_s: Optional[float] = None) -> Optional[bool]:
        """None until finished; a rejected request never attains.  A
        finished one attains iff it clears every bound that applies: the
        caller's TTFT / TPOT bounds (an unmeasured TTFT counts 0.0, an
        unmeasured TPOT passes) and its own ``slo_deadline_s``.  With no
        deadline and no bounds every finished request attains."""
        if self.state is RequestState.REJECTED:
            return False
        if self.state is not RequestState.FINISHED:
            return None
        if slo_ttft_s is not None and (self.ttft() or 0.0) > slo_ttft_s:
            return False
        if slo_tpot_s is not None:
            tpot = self.tpot()
            if tpot is not None and tpot > slo_tpot_s:
                return False
        if self.slo_deadline_s is not None:
            lat = self.latency()
            if lat is None or lat > self.slo_deadline_s:
                return False
        return True

    def queue_wait(self) -> Optional[float]:
        """Arrival -> first admission (scheduler wait, paper §5 framing)."""
        if self.admit_time is None:
            return None
        return self.admit_time - self.arrival_time

    def ttft(self) -> Optional[float]:
        """Arrival -> first token observed by the host."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def tpot(self) -> Optional[float]:
        """Time per output token after the first: first token observed
        -> finish, over the remaining tokens.  None until finished or
        for single-token outputs."""
        if (self.finish_time is None or self.first_token_time is None
                or len(self.output) < 2):
            return None
        return ((self.finish_time - self.first_token_time)
                / (len(self.output) - 1))

    def block_efficiency(self) -> float:
        """Tokens emitted per target verification (paper's BE metric)."""
        return len(self.output) / max(self.rounds, 1)

    def acceptance_rate(self) -> float:
        return self.accepted_tokens / max(self.proposed_tokens, 1)
