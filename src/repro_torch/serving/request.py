"""Request lifecycle for the serving engine: a copy of
``repro.serving.request`` cut to the fields the port's engine uses (the
prefix-cache, SLO and streaming fields come with their slices)."""
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
    # --- runtime fields -----------------------------------------------------
    state: RequestState = RequestState.QUEUED
    output: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    arrival_time: float = dataclasses.field(default_factory=time.monotonic)
    # first admission out of the queue (never overwritten on a
    # preemption readmit: queue wait is an arrival-side metric)
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    rounds: int = 0                    # target verifications consumed
    accepted_tokens: int = 0
    proposed_tokens: int = 0
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

    def block_efficiency(self) -> float:
        """Tokens emitted per target verification (paper's BE metric)."""
        return len(self.output) / max(self.rounds, 1)

    def acceptance_rate(self) -> float:
        return self.accepted_tokens / max(self.proposed_tokens, 1)
