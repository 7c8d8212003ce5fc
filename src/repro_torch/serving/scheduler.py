"""Look-ahead scheduler (paper §3.2; ``repro.serving.scheduler``
without the prefix cache).  Two KV layouts:

* **dense** (``paged_kv=False``) — one ring row per slot: admission is
  by free slot and the worst-case fit alone; there is no allocator, no
  growth and no preemption;
* **paged** (``paged_kv=True``) — :class:`BlockAllocator` keeps a free
  list over the shared KV block pool.  A block id names the same slot
  of the target AND the draft pool (the tables mirror), so one decision
  covers the speculative pair.  Admission charges the prefill's blocks;
  each round the engine grows every sequence to its next write extent
  (:meth:`ensure_capacity`), preempting the youngest running request
  (evict + requeue at the front, recompute on readmit) when the pool
  runs dry; after the round the speculative tail returns to the pool
  (:meth:`shrink_to`).

:class:`LookaheadScheduler` holds the waiting queue and the slot table.
A request whose worst case cannot fit ``max_seq_len`` is ``REJECTED``.
The SLO admission gate (DESIGN.md §15) surfaces, and at most
``slo_defer_limit`` times defers, a fresh request whose best-case
completion under the engine's latency model already misses its
deadline; it never rejects or drops one.
"""
from __future__ import annotations

import collections
import math
import time
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.core.config import ServingConfig, SpecDecodeConfig
from repro_torch.core.policies import HostRoundContext, SpecPolicy, build_policy
from repro_torch.serving.request import Request, RequestState


class BlockAllocator:
    """LIFO free list over ``num_blocks`` pool blocks."""

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        # seeded so the first allocations come out in ascending id order
        self._free = list(range(num_blocks - 1, -1, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.num_blocks - self.n_free

    def blocks_for(self, n_tokens: int) -> int:
        return max(0, -(-n_tokens // self.block_size))

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks, or None (and no state change) if the pool is short."""
        if n > len(self._free):
            return None
        if n <= 0:
            return []
        out = self._free[-n:][::-1]
        del self._free[-n:]
        return out

    def free(self, blocks: List[int]) -> None:
        self._free.extend(blocks)
        assert len(self._free) <= self.num_blocks, "double free"


class LookaheadScheduler:
    def __init__(self, serving: ServingConfig, spec: SpecDecodeConfig,
                 policy: Optional[SpecPolicy] = None, kv_mirror: bool = True,
                 block_bytes: int = 0):
        """``kv_mirror``: whether the drafter holds a paged KV pool that
        mirrors the target's block ids (``Drafter.mirrors_kv``).
        ``ServingConfig.num_kv_blocks`` budgets such a mirrored pair; a
        drafter with no draft KV gives the mirror's budget back, so the
        target pool doubles.  ``block_bytes``: bytes one pool block costs
        in the serving storage mode (``cache.kv_block_bytes``), for the
        byte telemetry only; admission counts blocks."""
        self.serving = serving
        self.spec = spec
        self.policy = policy if policy is not None else build_policy(spec)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * serving.max_batch_size
        self.allocator: Optional[BlockAllocator] = None
        if serving.paged_kv:
            self.allocator = BlockAllocator(
                serving.pool_blocks() * (1 if kv_mirror else 2),
                serving.kv_block_size)
            # the pool must hold one max-length sequence outright, so
            # LIFO preemption always converges
            if (self.allocator.num_blocks * serving.kv_block_size
                    < serving.max_seq_len):
                raise ValueError("KV pool smaller than one max-length "
                                 "sequence: preemption could never free "
                                 "enough blocks")
        self.block_bytes = block_bytes
        # latest per-slot SL predictions (host mirror, engine-refreshed)
        self.sl_pred = np.full((serving.max_batch_size,),
                               self.policy.initial_sl_value(), np.int32)
        self._rejected: List[Request] = []
        self._admit_seq = 0
        self.preempted_total = 0
        # SLO admission: the engine installs its RoundLatencyModel here;
        # without one (or before it is ready) admission is deadline-blind
        self.latency_model: Optional[Any] = None
        self._slo_risk: List[Request] = []
        self.slo_predicted_violations = 0
        self.slo_deferrals_total = 0

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def update_predictions(self, sl_next: np.ndarray) -> None:
        self.sl_pred = np.array(sl_next)

    def host_context(self, sl_next: Optional[np.ndarray] = None,
                     round_ordinal: int = 0,
                     now: Optional[float] = None) -> HostRoundContext:
        """The round's host-side view for the policy hooks, from state
        the scheduler owns (no device sync): per-slot deadline remaining
        (+inf where there is none) and token budgets (0 for empty
        slots), and the engine's latency model."""
        sl = self.sl_pred if sl_next is None else np.asarray(sl_next)
        b = self.serving.max_batch_size
        deadlines = np.full((b,), np.inf)
        tokens_rem = np.zeros((b,), np.int64)
        if any(r is not None and r.slo_deadline_s is not None
               for r in self.slots):
            now = time.monotonic() if now is None else now
        for i, r in enumerate(self.slots):
            if r is None:
                continue
            tokens_rem[i] = max(r.max_new_tokens - len(r.output), 0)
            if r.slo_deadline_s is not None:
                deadlines[i] = (r.arrival_time + r.slo_deadline_s) - now
        return HostRoundContext(
            sl_next=sl, active=self.active_mask,
            deadline_remaining_s=deadlines, tokens_remaining=tokens_rem,
            latency_model=self.latency_model, round_ordinal=round_ordinal)

    def lookahead_slots(self, sl_next: Optional[np.ndarray] = None
                        ) -> np.ndarray:
        return self.policy.lookahead(self.host_context(sl_next))

    def _fits(self, req: Request) -> bool:
        # the policy's WORST-case round footprint must fit: a dynamic
        # policy admitted at its initial SL can later predict its max
        need = (len(req.prompt) + req.max_new_tokens
                + self.policy.max_lookahead())
        return need <= self.serving.max_seq_len

    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def _is_readmit(self, req: Request) -> bool:
        """A queued request that has run before (evict-and-requeue)."""
        return req.preemptions > 0 or req.admit_time is not None

    def assert_readmit_fifo(self) -> None:
        """Starvation guard: preempted readmits form a contiguous prefix
        of the queue, ahead of every fresh arrival.  It holds by
        construction (``submit`` appends, ``preempt`` appends left,
        requests leave from the front); the assert pins it."""
        seen_fresh = False
        for r in self.queue:
            if self._is_readmit(r):
                assert not seen_fresh, (
                    "readmit queued behind a fresh arrival — starvation")
            else:
                seen_fresh = True

    # ------------------------------------------------------- SLO admission
    def predict_completion_s(self, req: Request) -> Optional[float]:
        """Best-case predicted wall seconds for ``req`` to finish once
        admitted: its prefill plus ``ceil(tokens_remaining / (K+1))``
        rounds at the policy's typical bucket against the live batch
        (every draft position accepted, so a feasible request is never
        gated on a pessimistic guess).  None without a ready model."""
        lm = self.latency_model
        if lm is None or not lm.ready():
            return None
        k = int(min(max(self.policy.initial_sl_value(), self.spec.sl_min)
                    if self.policy.uses_draft() else 0,
                    self.policy.max_bucket()))
        b_eff = min(len(self.running) + 1, self.serving.max_batch_size)
        tokens = max(req.max_new_tokens - len(req.output), 1)
        rounds = math.ceil(tokens / float(k + 1))
        return (lm.predict_prefill_s(len(req.prefill_tokens()))
                + rounds * lm.predict_round_s(k, b_eff))

    def _surface_slo_risk(self, req: Request) -> None:
        if not req.slo_predicted_violation:
            req.slo_predicted_violation = True
            self.slo_predicted_violations += 1
            self._slo_risk.append(req)

    def _slo_feasible_behind(self, head: Request, now: float) -> bool:
        """Is there a later FRESH request (same or higher priority)
        predicted to attain its deadline?  Only then is deferring the
        head worth anything."""
        for r in list(self.queue)[1:]:
            if self._is_readmit(r) or r.priority < head.priority:
                continue
            if r.slo_deadline_s is None:
                return True
            t = self.predict_completion_s(r)
            if t is None or now + t <= r.arrival_time + r.slo_deadline_s:
                return True
        return False

    def pop_slo_risk(self) -> List[Request]:
        """Requests newly flagged as predicted SLO violations, each
        surfaced once (the flag stays on the request)."""
        out, self._slo_risk = self._slo_risk, []
        return out

    def admit(self) -> List[Request]:
        """Move queued requests into free slots in strict queue order.
        Paged: each is charged ``ceil(prefill_len / block_size)`` blocks,
        and a request the pool cannot cover stays queued (round-time
        preemption resolves sustained pressure).  Oversize requests
        become ``REJECTED`` (drained by :meth:`pop_rejected`).

        SLO gate: a fresh head with a deadline whose best-case predicted
        completion already misses it is surfaced (:meth:`pop_slo_risk`)
        and, at most ``slo_defer_limit`` times and only when a feasible
        same-or-higher-priority fresh arrival waits behind it, rotated to
        the back.  Readmits are never deferred; without deadlines or a
        ready latency model the gate is inert.  ``now`` is read once per
        call."""
        if __debug__:
            self.assert_readmit_fifo()
        admitted = []
        free = collections.deque(self.free_slots())
        deferred_ids: set = set()
        now = None
        while free and self.queue:
            req = self.queue[0]
            if (req.slo_deadline_s is not None
                    and not self._is_readmit(req)
                    and self.latency_model is not None
                    and self.latency_model.ready()):
                now = time.monotonic() if now is None else now
                t_pred = self.predict_completion_s(req)
                if (t_pred is not None and
                        now + t_pred > req.arrival_time + req.slo_deadline_s):
                    self._surface_slo_risk(req)
                    if (id(req) not in deferred_ids
                            and req.slo_deferrals < self.serving.slo_defer_limit
                            and self._slo_feasible_behind(req, now)):
                        self.queue.popleft()
                        self.queue.append(req)
                        req.slo_deferrals += 1
                        self.slo_deferrals_total += 1
                        deferred_ids.add(id(req))
                        continue
            if not self._fits(req):
                self.queue.popleft()
                req.state = RequestState.REJECTED
                req.finish_time = time.monotonic()
                self._rejected.append(req)
                continue
            if self.allocator is not None:
                blocks = self.allocator.alloc(
                    self.allocator.blocks_for(len(req.prefill_tokens())))
                if blocks is None:
                    break           # pool dry: keep queued, stop here
                req.block_ids = blocks
            self.queue.popleft()
            i = free.popleft()
            req.slot = i
            req.state = RequestState.RUNNING
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            if req.admit_time is None:       # readmits keep the first wait
                req.admit_time = time.monotonic()
            self.slots[i] = req
            admitted.append(req)
        return admitted

    def pop_rejected(self) -> List[Request]:
        out, self._rejected = self._rejected, []
        return out

    def drop_from_queue(self, req: Request) -> None:
        """Remove a queued request that reached a terminal state while
        waiting: under the pipelined schedule a request preempted at
        plan time can FINISH when the round it was still part of is
        collected, and must not be readmitted."""
        try:
            self.queue.remove(req)
        except ValueError:
            pass

    # ---------------------------------------------------------- block budget
    def ensure_capacity(self, req: Request, n_tokens: int
                        ) -> Tuple[List[int], List[Request]]:
        """Grow ``req`` to cover ``n_tokens`` KV slots, preempting the
        youngest other running requests while the pool is dry.  Returns
        (newly allocated block ids, preempted requests)."""
        need = self.allocator.blocks_for(n_tokens) - len(req.block_ids)
        if need <= 0:
            return [], []
        preempted: List[Request] = []
        while True:
            blocks = self.allocator.alloc(need)
            if blocks is not None:
                req.block_ids.extend(blocks)
                return blocks, preempted
            victim = self._pick_victim(exclude=req)
            assert victim is not None, (
                "pool exhausted with nothing to preempt — the single-"
                "sequence pool guarantee makes this unreachable")
            self.preempt(victim)
            preempted.append(victim)

    def _pick_victim(self, exclude: Request) -> Optional[Request]:
        running = [r for r in self.slots if r is not None and r is not exclude]
        if not running:
            return None
        return max(running, key=lambda r: r.admit_seq)   # LIFO: youngest

    def preempt(self, req: Request) -> None:
        """Evict-and-requeue at the FRONT: free every block; the request
        readmits first and recomputes prompt + emitted output."""
        self.allocator.free(req.block_ids)
        req.block_ids = []
        self.slots[req.slot] = None
        req.slot = None
        req.cache_len = 0
        req.state = RequestState.QUEUED
        req.preemptions += 1
        self.preempted_total += 1
        self.queue.appendleft(req)

    def shrink_to(self, req: Request, n_tokens: int) -> List[int]:
        """Return the blocks beyond ``n_tokens`` committed slots."""
        keep = self.allocator.blocks_for(n_tokens)
        freed = req.block_ids[keep:]
        if freed:
            del req.block_ids[keep:]
            self.allocator.free(freed)
        return freed

    def release(self, req: Request) -> None:
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
        if self.allocator is not None and req.block_ids:
            self.allocator.free(req.block_ids)
            req.block_ids = []

    # ------------------------------------------------------------- telemetry
    @property
    def active_mask(self) -> np.ndarray:
        return np.array([r is not None for r in self.slots], bool)

    @property
    def running(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def kv_blocks_in_use(self) -> int:
        """Blocks charged against the pool (paged), or the dense-row
        equivalent (occupied slots x blocks per row), as the reference
        reports it."""
        if self.allocator is not None:
            return self.allocator.n_used
        return int(self.active_mask.sum()) * self.serving.blocks_per_seq()

    def kv_blocks_total(self) -> int:
        if self.allocator is not None:
            return self.allocator.num_blocks
        return self.serving.max_batch_size * self.serving.blocks_per_seq()

    def kv_block_bytes(self) -> int:
        return self.block_bytes

    def kv_bytes_total(self) -> int:
        """Pool footprint in bytes under the serving storage mode."""
        return self.kv_blocks_total() * self.block_bytes

    def kv_bytes_in_use(self) -> int:
        return self.kv_blocks_in_use() * self.block_bytes

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)
