"""Look-ahead scheduler (paper §3.2; ``repro.serving.scheduler``).  Two
KV layouts:

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
  (:meth:`shrink_to`).  With prefix caching (DESIGN.md §12) the
  allocator is refcounted: admission maps the cached full blocks of a
  request's prefix into its table, and a committed full block is
  published for later requests (:meth:`LookaheadScheduler.register_prefix`).

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
    """Refcounted free list over ``num_blocks`` pool blocks, with the
    prefix cache's structures on top (DESIGN.md §12):

    * ``refcount[b]`` — block tables referencing block ``b``.
      :meth:`alloc` hands out blocks at 1, :meth:`acquire` maps resident
      blocks into one more table, :meth:`free` decrefs; a block leaves
      circulation only when its last reference drops.
    * a chained-hash index over committed FULL blocks: a registered
      block stores ``(parent_hash, tokens)`` under the hash of that
      pair, so a prefix match walks the chain; the stored tokens are
      compared on lookup, so a hash collision is a miss, never a wrong
      block.
    * an LRU evictable list: registered blocks at refcount 0 stay warm
      (matchable, revived by :meth:`acquire`) and are reclaimed
      oldest-first only when :meth:`alloc` finds the free list short.

    Invariant (:meth:`check_invariants`): free, evictable and referenced
    blocks partition the pool."""

    def __init__(self, num_blocks: int, block_size: int):
        assert num_blocks > 0 and block_size > 0
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO, seeded so the first allocations come out in ascending order
        self._free = list(range(num_blocks - 1, -1, -1))
        self.refcount = [0] * num_blocks
        # chain hash -> block id; block id -> (parent hash, tokens, hash)
        self._index: dict = {}
        self._meta: dict = {}
        # warm unreferenced registered blocks, oldest first
        self._evictable: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict())
        self.evictions = 0

    @property
    def n_free(self) -> int:
        """Allocatable blocks: free plus warm evictable."""
        return len(self._free) + len(self._evictable)

    @property
    def n_used(self) -> int:
        """Blocks referenced by at least one block table."""
        return self.num_blocks - self.n_free

    @property
    def n_cached(self) -> int:
        """Warm unreferenced blocks held for prefix reuse."""
        return len(self._evictable)

    def blocks_for(self, n_tokens: int) -> int:
        return max(0, -(-n_tokens // self.block_size))

    # ------------------------------------------------------------ hash chain
    @staticmethod
    def _chain_hash(parent_hash: Optional[int],
                    tokens: Tuple[int, ...]) -> int:
        # Python's hash of an int tuple is deterministic within a
        # process, which is all a host-side index needs
        return hash((parent_hash, tokens))

    def match_prefix(self, tokens) -> Tuple[List[int], Optional[int], int]:
        """The longest cached prefix of ``tokens`` in full blocks:
        ``(block_ids, last_chain_hash, covered_tokens)``.  Takes no
        references (:meth:`acquire` does, once admission is certain)."""
        ids: List[int] = []
        parent: Optional[int] = None
        bs = self.block_size
        for i in range(len(tokens) // bs):
            chunk = tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
            h = self._chain_hash(parent, chunk)
            bid = self._index.get(h)
            if bid is None:
                break
            meta = self._meta[bid]
            if meta[0] != parent or meta[1] != chunk:
                break                       # collision: a miss
            ids.append(bid)
            parent = h
        return ids, parent, len(ids) * bs

    def register(self, block_id: int, parent_hash: Optional[int],
                 tokens: Tuple[int, ...]) -> int:
        """Publish a committed full block under its chain hash.  First
        writer wins: a hash already indexed keeps its block, and the
        caller's copy stays private.  Returns the chain hash either way
        (the next block's parent)."""
        assert self.refcount[block_id] > 0, "registering an unowned block"
        h = self._chain_hash(parent_hash, tokens)
        if h not in self._index and block_id not in self._meta:
            self._index[h] = block_id
            self._meta[block_id] = (parent_hash, tokens, h)
        return h

    def _unregister(self, block_id: int) -> None:
        meta = self._meta.pop(block_id, None)
        if meta is not None and self._index.get(meta[2]) == block_id:
            del self._index[meta[2]]

    # ------------------------------------------------------------ lifecycle
    def alloc(self, n: int) -> Optional[List[int]]:
        """n private blocks at refcount 1, or None (and no state change)
        if free + evictable cannot cover them.  Warm blocks are evicted,
        oldest first, only when the free list is short."""
        if n > len(self._free) + len(self._evictable):
            return None
        if n <= 0:
            return []
        while len(self._free) < n:
            bid, _ = self._evictable.popitem(last=False)
            self._unregister(bid)
            self._free.append(bid)
            self.evictions += 1
        out = self._free[-n:][::-1]
        del self._free[-n:]
        for b in out:
            assert self.refcount[b] == 0
            self.refcount[b] = 1
        return out

    def acquire(self, blocks: List[int]) -> None:
        """Map resident blocks into one more block table (incref),
        reviving warm ones in place."""
        for b in blocks:
            if self.refcount[b] == 0:
                self._evictable.pop(b)      # registered and warm
            self.refcount[b] += 1

    def free(self, blocks: List[int]) -> None:
        """Decref.  At refcount 0 a registered block goes warm (the
        recent end of the LRU list), an unregistered one to the free
        list."""
        for b in blocks:
            assert self.refcount[b] > 0, "double free"
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                meta = self._meta.get(b)
                if meta is not None and self._index.get(meta[2]) == b:
                    self._evictable[b] = None
                else:
                    self._unregister(b)
                    self._free.append(b)
        assert len(self._free) + len(self._evictable) <= self.num_blocks

    def fork_cow(self, block_id: int) -> Optional[int]:
        """Copy-on-write split: a private destination block, and this
        table's reference on the shared source dropped.  Returns the
        destination (the caller copies the block on the device), or None
        if the pool cannot cover it.  The caller's reference keeps the
        source safe from the eviction inside :meth:`alloc`."""
        dst = self.alloc(1)
        if dst is None:
            return None
        self.free([block_id])
        return dst[0]

    def check_invariants(self) -> None:
        """Free, warm and referenced blocks partition the pool, and every
        warm block is reachable from the index."""
        free = set(self._free)
        warm = set(self._evictable)
        ref = {b for b in range(self.num_blocks) if self.refcount[b] > 0}
        assert len(free) == len(self._free), "duplicate ids on free list"
        assert not (free & ref), "block simultaneously free and referenced"
        assert not (warm & ref), "block simultaneously warm and referenced"
        assert not (free & warm), "block simultaneously free and warm"
        assert len(free) + len(warm) + len(ref) == self.num_blocks
        for b in warm:
            meta = self._meta.get(b)
            assert meta is not None and self._index.get(meta[2]) == b, (
                "evictable block not reachable from the hash index")


class LookaheadScheduler:
    def __init__(self, serving: ServingConfig, spec: SpecDecodeConfig,
                 policy: Optional[SpecPolicy] = None, kv_mirror: bool = True,
                 prefix_cache: Optional[bool] = None, block_bytes: int = 0):
        """``kv_mirror``: whether the drafter holds a paged KV pool that
        mirrors the target's block ids (``Drafter.mirrors_kv``).
        ``ServingConfig.num_kv_blocks`` budgets such a mirrored pair; a
        drafter with no draft KV gives the mirror's budget back, so the
        target pool doubles.  ``block_bytes``: bytes one pool block costs
        in the serving storage mode (``cache.kv_block_bytes``), for the
        byte telemetry only; admission counts blocks.  ``prefix_cache``
        overrides ``serving.prefix_caching``: the engine passes the flag
        it keeps after gating on the model families."""
        self.serving = serving
        self.spec = spec
        self.policy = policy if policy is not None else build_policy(spec)
        self.queue: collections.deque[Request] = collections.deque()
        self.slots: List[Optional[Request]] = [None] * serving.max_batch_size
        self.allocator: Optional[BlockAllocator] = None
        self.prefix_cache = bool(serving.prefix_caching if prefix_cache is None
                                 else prefix_cache) and serving.paged_kv
        if serving.paged_kv:
            self.allocator = BlockAllocator(
                serving.pool_blocks() * (1 if kv_mirror else 2),
                serving.kv_block_size)
            # without prefix caching the pool must hold one max-length
            # sequence outright, so LIFO preemption always converges; with
            # it, _fits rejects a request that could never be resident and
            # ensure_capacity self-preempts (warm readmit through the cache)
            if (not self.prefix_cache
                    and self.allocator.num_blocks * serving.kv_block_size
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
        # the host clock every admission and SLO reading takes; on a
        # serving mesh the engine installs rank 0's (``core.tp.host_clock``)
        self.clock = time.monotonic
        self._slo_risk: List[Request] = []
        self.slo_predicted_violations = 0
        self.slo_deferrals_total = 0
        # lifetime prefix-cache telemetry (the engine logs per-round deltas)
        self.prefix_hit_blocks_total = 0
        self.cow_copies_total = 0
        self.prefix_tokens_total = 0
        self.prefix_hit_tokens_total = 0

    def _caching(self) -> bool:
        # prefix_cache implies paged_kv, which is when the allocator exists
        return self.prefix_cache

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
            now = self.clock() if now is None else now
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

    def _fits(self, req: Request, covered_blocks: int = 0) -> bool:
        # the policy's WORST-case round footprint must fit: a dynamic
        # policy admitted at its initial SL can later predict its max
        need = (len(req.prompt) + req.max_new_tokens
                + self.policy.max_lookahead())
        if need > self.serving.max_seq_len:
            return False
        if self.allocator is not None:
            # a request whose worst-case residency never fits the pool
            # would preempt-requeue forever; cached coverage is already
            # resident, so only the uncovered blocks are charged (without
            # prefix caching the pool holds max_seq_len, so this never
            # rejects)
            uncovered = self.allocator.blocks_for(need) - covered_blocks
            if uncovered > self.allocator.num_blocks:
                return False
        return True

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
        less the full blocks of its prefix the cache already holds, and
        a request the pool cannot cover stays queued (round-time
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
                now = self.clock() if now is None else now
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
            toks = req.prefill_tokens()
            plen = len(toks)
            covered_ids: List[int] = []
            last_hash: Optional[int] = None
            covered = 0
            if self._caching():
                covered_ids, last_hash, covered = (
                    self.allocator.match_prefix(toks))
            if not self._fits(req, covered_blocks=len(covered_ids)):
                self._reject_head(req)
                continue
            if self.allocator is not None:
                if covered == plen:
                    # a full block-aligned hit: the first new token needs
                    # the logits at plen - 1, so that one token is
                    # recomputed into a COW copy of the last shared block
                    shared = covered_ids[:-1]
                    start = plen - 1
                else:
                    shared = covered_ids
                    start = covered
                need = self.allocator.blocks_for(plen) - len(shared)
                # pin EVERY matched block before alloc, which reclaims
                # warm blocks under pressure: the match, the COW source
                # included, must survive it.  The engine drops the COW
                # source's pin once the device copy is enqueued
                # (release_cow_sources); stream order keeps the copy ahead
                # of any later owner's writes.
                self.allocator.acquire(covered_ids)
                fresh = self.allocator.alloc(need)
                if fresh is None:
                    self.allocator.free(covered_ids)
                    if not any(r is not None for r in self.slots):
                        # nothing runs, so nothing will free more blocks:
                        # even a drained pool cannot hold this prefix
                        self._reject_head(req)
                        continue
                    break           # pool dry: keep queued, stop here
                req.block_ids = shared + fresh
                req.fresh_block_ids = list(fresh)
                req.prefill_start = start
                if covered == plen:
                    req.cow_pairs = [(covered_ids[-1], fresh[0])]
                    req.chain_hash = self.allocator._meta[covered_ids[-1]][0]
                else:
                    req.cow_pairs = []
                    req.chain_hash = last_hash
                req.hashed_blocks = len(shared)
                req.prefix_tokens_total += plen
                req.prefix_hit_tokens_total += start
                self.prefix_hit_blocks_total += len(shared)
                self.cow_copies_total += len(req.cow_pairs)
                self.prefix_tokens_total += plen
                self.prefix_hit_tokens_total += start
            self.queue.popleft()
            i = free.popleft()
            req.slot = i
            req.state = RequestState.RUNNING
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
            if req.admit_time is None:       # readmits keep the first wait
                req.admit_time = self.clock()
            self.slots[i] = req
            admitted.append(req)
        return admitted

    def _reject_head(self, req: Request) -> None:
        self.queue.popleft()
        req.state = RequestState.REJECTED
        req.finish_time = self.clock()
        self._rejected.append(req)

    def register_prefix(self, req: Request) -> None:
        """Publish ``req``'s newly committed full blocks in the hash index
        (after its prefill is enqueued and after each collected round).
        A registered block is full and below ``cache_len``, so in-flight
        speculative writes (at or past the committed boundary) never
        touch a shared block, under the pipelined schedule too."""
        if not self._caching() or req.slot is None:
            return
        bs = self.allocator.block_size
        toks = req.prompt + req.output
        full = min(min(req.cache_len, len(toks)) // bs, len(req.block_ids))
        while req.hashed_blocks < full:
            i = req.hashed_blocks
            chunk = tuple(int(t) for t in toks[i * bs:(i + 1) * bs])
            req.chain_hash = self.allocator.register(
                req.block_ids[i], req.chain_hash, chunk)
            req.hashed_blocks += 1

    def release_cow_sources(self, req: Request) -> None:
        """Drop the admission pins on ``req``'s copy-on-write sources, once
        the device copy is enqueued (stream order then keeps the copy
        ahead of any later owner's writes)."""
        if self._caching() and req.cow_pairs:
            self.allocator.free([src for src, _ in req.cow_pairs])

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
            if victim is None:
                # reachable only under prefix caching (a request admitted
                # on its uncovered suffix): preempt the requester itself;
                # its registered blocks stay warm, so its readmit resumes
                # through the cache and recomputes at most a partial block
                assert self.prefix_cache, (
                    "pool exhausted with nothing to preempt — the single-"
                    "sequence pool guarantee makes this unreachable")
                self.preempt(req)
                preempted.append(req)
                return [], preempted
            self.preempt(victim)
            preempted.append(victim)

    def _pick_victim(self, exclude: Request) -> Optional[Request]:
        running = [r for r in self.slots if r is not None and r is not exclude]
        if not running:
            return None
        return max(running, key=lambda r: r.admit_seq)   # LIFO: youngest

    def preempt(self, req: Request) -> None:
        """Evict-and-requeue at the FRONT: decref every block; the request
        readmits first and recomputes prompt + emitted output (under
        prefix caching its registered blocks stay warm, so the recompute
        usually shrinks to a tail over at most one partial block)."""
        self.allocator.free(req.block_ids)
        req.block_ids = []
        self.slots[req.slot] = None
        req.slot = None
        req.cache_len = 0
        req.prefill_start = 0
        req.fresh_block_ids = []
        req.cow_pairs = []
        req.hashed_blocks = 0
        req.chain_hash = None
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

    def kv_blocks_cached(self) -> int:
        """Warm unreferenced blocks on the evictable LRU list."""
        if self.allocator is not None:
            return self.allocator.n_cached
        return 0

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)
