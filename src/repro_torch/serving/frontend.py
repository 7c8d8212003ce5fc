"""Continuous-batching serving front-end of the port
(``repro.serving.frontend``, DESIGN.md §14).

``ServingEngine.run()`` executes a pre-built request list; this module
is the ingestion path in front of it: an arrival-stamped submission
queue, a driver loop that admits newly-arrived requests *between*
rounds while the device keeps working (the pipelined
plan/dispatch/collect from DESIGN.md §7 — admission overlaps device
execution for free), and per-token streaming from round reconciliation
to per-request consumers.

Threading model — one driver, many submitters:

* the engine is NOT thread-safe and is touched only by the driver
  (either the caller of :meth:`ServingFrontend.run_until_drained` or
  the thread :meth:`start` spawns);
* :meth:`submit` is thread-safe: it builds the :class:`Request`
  (stamping ``arrival_time`` at call time), wires its streaming
  callback, and parks it on a thread-safe ingress queue the driver
  drains before every ``pump()``;
* each submission returns a :class:`StreamHandle` whose event queue is
  fed from the driver thread at host-reconciliation time and consumed
  from any other thread (the HTTP layer bridges it into asyncio via
  ``run_in_executor``).

Exactness bar (tests/test_torch_frontend.py): the same request set submitted
up front (all arrivals before the first pump) and driven to drain
replays ``run()``'s admit/dispatch/collect sequence verbatim —
``pump()`` IS ``run()``'s loop body — so token streams are
byte-identical to a direct ``run()`` call.  Streams are additionally
schedule-invariant (identity-threaded RNG + device-side termination,
DESIGN.md §7/§9), which is what makes mid-run admission change *when*
tokens arrive but never *which* tokens a request gets.

On a ``(data, model)`` serving mesh (an engine built with ``mesh=``)
every rank builds a front-end over its engine, and only rank 0's takes
submissions: it alone has the ingress queue, the stream handles and
:meth:`ServingFrontend.summary`.  Each driver iteration rank 0
broadcasts the requests it admits (their fields and its arrival stamp,
in FIFO order) and whether it stops (``core.tp.broadcast_objects``);
every other rank runs :meth:`ServingFrontend.follow`, which submits
exactly those requests and pumps as rank 0 does, so every rank's engine
sees the same calls in the same order.  Every control-group collective
(these broadcasts and the engine's clock readings) runs on the driver
thread of each rank; the HTTP thread and ``summary()`` make none.  While
idle, rank 0 waits on its ingress and the others inside the broadcast,
which rank 0 renews every ``IDLE_BEAT_S`` seconds so that an idle
follower stays within the control group's timeout.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch.distributed as dist

from repro_torch.core import tp
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request, RequestState

# the fields of a Request that rank 0 broadcasts at admission
ADMIT_FIELDS = ("request_id", "prompt", "max_new_tokens", "eos_token_id",
                "slo_deadline_s", "priority", "arrival_time")
# longest wait of an idle mesh's followers between two broadcasts (well
# inside the control group's timeout, 30 minutes by default)
IDLE_BEAT_S = 60.0


class StreamHandle:
    """Consumer end of one request's token stream.

    The driver thread pushes ``("token", id)`` events as tokens are
    host-reconciled (in order, exactly once per emitted token) and one
    terminal ``("done", finish_reason)`` event — ``"stop"`` (EOS),
    ``"length"`` (budget), or ``"rejected"`` (infeasible at admission).
    Consume with :meth:`events` / iteration / :meth:`result` from any
    thread."""

    def __init__(self, request: Request):
        self.request = request
        self._events: "queue.SimpleQueue[Tuple[str, object]]" = (
            queue.SimpleQueue())
        self.finish_reason: Optional[str] = None
        self._drained = False

    # ------------------------------------------------------- driver side
    def _push_token(self, tok: int) -> None:
        self._events.put(("token", tok))

    def _push_done(self, reason: str) -> None:
        self.finish_reason = reason
        self._events.put(("done", reason))

    # ----------------------------------------------------- consumer side
    def events(self, timeout: Optional[float] = None):
        """Yield ``("token", id)`` events until the terminal
        ``("done", reason)`` event (yielded last).  ``timeout`` bounds
        the wait for EACH event; expiry raises ``TimeoutError``."""
        if self._drained:
            return
        while True:
            try:
                kind, val = self._events.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(
                    f"no stream event within {timeout}s for request "
                    f"{self.request.request_id}")
            yield kind, val
            if kind == "done":
                self._drained = True
                return

    def __iter__(self):
        """Token ids only, in stream order, ending at the terminal."""
        for kind, val in self.events():
            if kind == "token":
                yield val

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[List[int], Optional[str]]:
        """Block until the stream terminates; returns
        ``(tokens, finish_reason)``.  The token list is rebuilt from the
        events, so it equals ``request.output`` by the exactly-once
        contract."""
        toks = [v for k, v in self.events(timeout=timeout) if k == "token"]
        return toks, self.finish_reason


class ServingFrontend:
    """Arrival queue + driver loop + streaming over a ServingEngine.

    Two driving modes share one iteration body (:meth:`_drive_once` =
    ingest, pump, deliver terminals):

    * :meth:`run_until_drained` — the caller IS the driver; used by the
      replay harness and the exactness tests (single-threaded,
      deterministic).
    * :meth:`start` / :meth:`stop` — a daemon driver thread; used by
      the HTTP server and paced (timed-arrival) load generation, where
      submitters race the driver by design.  The engine's CUDA work, its
      events and pinned buffers then all belong to that thread (on the
      default stream, which every host thread shares).

    On a mesh the ranks other than 0 run :meth:`follow` instead.
    """

    def __init__(self, engine: ServingEngine):
        self.engine = engine
        # a mesh of more than one rank: rank 0 leads, the others follow
        self._mesh = (engine.mesh_plan if tp.spans_ranks(engine.mesh_plan)
                      else None)
        self.leader = self._mesh is None or dist.get_rank() == 0
        self._released = False
        self._last_beat = time.monotonic()
        self._ingress: "queue.SimpleQueue[Tuple[Request, StreamHandle]]" = (
            queue.SimpleQueue())
        self._handles: Dict[int, StreamHandle] = {}
        self._done: List[Request] = []
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._t0 = time.monotonic()
        # per-pump telemetry: (t_rel, ingress_depth, sched_queue, running)
        self.queue_depth_log: List[Tuple[float, int, int, int]] = []

    # ------------------------------------------------------------ ingestion
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 128,
               eos_token_id: Optional[int] = None,
               request_id: Optional[int] = None,
               slo_deadline_s: Optional[float] = None,
               priority: int = 0) -> StreamHandle:
        """Thread-safe submission; stamps ``arrival_time`` NOW and
        returns the stream handle.  ``request_id`` defaults to a
        monotonic counter; callers replaying a trace pass the trace's
        ids so the identity-threaded RNG (DESIGN.md §9) reproduces the
        exact stochastic streams of any other schedule.
        ``slo_deadline_s`` / ``priority`` thread straight onto the
        Request (DESIGN.md §15); left at their defaults the request is
        untouched by every SLO path."""
        self._check_open()
        if request_id is None:
            with self._id_lock:
                request_id = self._next_id
                self._next_id += 1
        else:
            with self._id_lock:
                self._next_id = max(self._next_id, request_id + 1)
        req = Request(request_id=request_id, prompt=list(prompt),
                      max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id,
                      slo_deadline_s=slo_deadline_s, priority=priority)
        handle = StreamHandle(req)
        req.on_token = lambda r, t: handle._push_token(t)
        self._ingress.put((req, handle))
        return handle

    def submit_request(self, req: Request) -> StreamHandle:
        """Submission path for pre-built Requests (trace replay): wires
        the stream callback, keeps the request's own arrival stamp."""
        self._check_open()
        handle = StreamHandle(req)
        req.on_token = lambda r, t: handle._push_token(t)
        self._ingress.put((req, handle))
        return handle

    def _check_open(self) -> None:
        if self._stop.is_set():
            raise RuntimeError("front-end is stopped")
        self._check_leader()

    def _check_leader(self) -> None:
        if not self.leader:
            raise RuntimeError("a mesh rank other than 0 takes no "
                               "submissions: it runs follow()")
        if self._released:
            raise RuntimeError("the mesh's other ranks have stopped "
                               "following")

    def _ingest(self, first: Optional[Tuple[Request, StreamHandle]] = None
                ) -> int:
        """Drain the ingress queue (after ``first``, an item already taken
        off it) into the engine (driver thread only).  FIFO, so submission
        order IS scheduler-queue order — the replay exactness argument
        needs nothing more.  On a mesh the followers get the same requests
        first (:meth:`_announce`)."""
        items = [] if first is None else [first]
        while True:
            try:
                items.append(self._ingress.get_nowait())
            except queue.Empty:
                break
        self._announce([req for req, _ in items])
        for req, handle in items:
            self._handles[req.request_id] = handle
            self.engine.submit(req)
        return len(items)

    def _announce(self, reqs: List[Request], stop: bool = False) -> None:
        """Rank 0's admitted requests and stop flag to every follower
        (one broadcast; nothing off a mesh)."""
        if self._mesh is None:
            return
        msg = ([{f: getattr(r, f) for f in ADMIT_FIELDS} for r in reqs],
               stop)
        tp.broadcast_objects([msg], self._mesh)
        self._last_beat = time.monotonic()

    def _release_followers(self) -> None:
        """Tell the followers to drain and return (once)."""
        if self._mesh is not None and not self._released:
            self._released = True
            self._announce([], stop=True)

    def follow(self) -> List[Request]:
        """The driver of a mesh rank other than 0: each of rank 0's
        driver iterations, receive the requests it admitted, submit them
        in its order with its arrival stamps, and pump if it pumps (the
        same host state decides); after its stop, drain and return the
        terminal requests.  A rank that never hears from rank 0 fails on
        the control group's timeout."""
        if self.leader:
            raise RuntimeError("rank 0 drives the mesh; follow() is for "
                               "the other ranks")
        done: List[Request] = []
        while True:
            reqs, stop = tp.broadcast_objects([None], self._mesh)[0]
            for fields in reqs:
                self.engine.submit(Request(**fields))
            if stop:
                break
            if self.engine.has_pending_work():
                done += self.engine.pump()
        done += self.engine.drain()
        self._done += done
        return done

    # --------------------------------------------------------------- driving
    def _deliver_terminals(self, done: List[Request]) -> None:
        for req in done:
            self._done.append(req)
            handle = self._handles.pop(req.request_id, None)
            if handle is not None:
                reason = (req.finish_reason()
                          if req.state is RequestState.FINISHED
                          else "rejected")
                handle._push_done(reason or "length")

    def _drive_once(self, first: Optional[Tuple[Request, StreamHandle]]
                    = None) -> List[Request]:
        """One driver iteration: admit arrivals (``first``: one already
        taken off the ingress), run one ``pump()`` (round N+1 dispatches
        while round N reconciles — token events fire from inside the
        pump), deliver terminal events."""
        self._ingest(first)
        sched = self.engine.scheduler
        self.queue_depth_log.append((
            time.monotonic() - self._t0, self._ingress.qsize(),
            len(sched.queue), len(sched.running)))
        if not self.engine.has_pending_work():
            return []
        done = self.engine.pump()
        self._deliver_terminals(done)
        return done

    def run_until_drained(self) -> List[Request]:
        """Drive everything currently (or concurrently) submitted to
        terminal state; returns the terminal requests in completion
        order.  Single-threaded: the caller is the driver (on a mesh, the
        followers keep following until :meth:`stop`)."""
        self._check_leader()
        out: List[Request] = []
        while True:
            if (self._ingress.qsize() == 0
                    and not self.engine.has_pending_work()):
                break
            out += self._drive_once()
        drained = self.engine.drain()
        self._deliver_terminals(drained)
        return out + drained

    def _loop(self) -> None:
        while not self._stop.is_set():
            first = None
            if (self._ingress.qsize() == 0
                    and not self.engine.has_pending_work()):
                # idle: block briefly on the ingress rather than spin
                try:
                    first = self._ingress.get(timeout=0.005)
                except queue.Empty:
                    if (self._mesh is not None and time.monotonic()
                            - self._last_beat > IDLE_BEAT_S):
                        self._announce([])
                    continue
            self._drive_once(first)
        self._release_followers()
        self._deliver_terminals(self.engine.drain())

    def start(self) -> "ServingFrontend":
        """Spawn the daemon driver thread (idempotent)."""
        self._check_leader()
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="serving-frontend", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop the driver thread; in-flight work is drained (the last
        dispatched round is reconciled) but queued work is abandoned.  On
        a mesh the followers drain and return too (from the caller's
        thread where no driver thread runs: the replay's driver)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        elif self.leader:
            self._release_followers()

    def wait_idle(self, timeout: float = 60.0) -> bool:
        """Block until no submitted work remains anywhere in the
        front-end or engine (threaded mode).  True on idle, False on
        timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if (self._ingress.qsize() == 0 and not self._handles
                    and not self.engine.has_pending_work()):
                return True
            time.sleep(0.002)
        return False

    # ------------------------------------------------------------- telemetry
    @property
    def finished(self) -> List[Request]:
        """Every terminal request this front-end delivered, in completion
        order."""
        return list(self._done)

    def summary(self) -> Dict[str, float]:
        """Engine run-summary over every terminal request this front-end
        delivered, plus front-end queue-depth telemetry."""
        out = self.engine.summary(self._done, time.monotonic() - self._t0)
        depths = [q + s for _, q, s, _ in self.queue_depth_log]
        out["queue_depth_mean"] = (float(sum(depths)) / len(depths)
                                   if depths else 0.0)
        out["queue_depth_peak"] = float(max(depths, default=0))
        return out
