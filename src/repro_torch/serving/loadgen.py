"""Trace-replay load generation for the port's serving front-end: a copy
of the reference's ``benchmarks/loadgen.py`` (DESIGN.md §14) over
``repro_torch.serving.frontend``.

A *trace* is a deterministic, seeded, JSON-serializable request set with
arrival offsets, the reproducibility unit of every saturation number.
Format (``version`` 2):

    {"version": 2, "seed": 0, "process": "poisson", "rate_rps": 4.0,
     "requests": [{"request_id": 0, "arrival_s": 0.0,
                   "prompt": [...], "max_new_tokens": 12,
                   "dataset": "code",
                   "slo_deadline_s": 3.5, "priority": 0}, ...]}

``slo_deadline_s`` (completion deadline, seconds from arrival) and
``priority`` are optional per request: version-1 traces (no SLO fields)
still load, with deadlines None, and :func:`make_trace` emits version 1
unless deadlines are requested (DESIGN.md §15).  The same arguments give
the reference's JSON byte for byte, so a trace replays the same workload
through either package.

Arrival processes (both seeded):

* ``poisson``: exponential interarrivals at ``rate_rps``;
* ``bursty``: Gamma interarrivals with shape ``BURST_SHAPE`` < 1 and the
  same mean, i.e. the same offered load with coefficient of variation
  1/sqrt(shape) = 2: arrivals clump into on-off bursts that stress
  admission and preemption far harder than Poisson at equal rate.

Prompt/output heterogeneity comes from the corpus mix
(``workloads.DATASETS``): each request's dataset, prompt length and
``max_new_tokens`` are drawn from the trace seed.

:func:`replay` drives a trace through a running :class:`ServingFrontend`
at its (optionally time-scaled) arrival times; :func:`replay_at_zero`
submits everything up front and drains single-threaded, the mode whose
streams are byte-identical to ``ServingEngine.run()``.
"""
from __future__ import annotations

import json
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import workloads
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving.request import Request, RequestState

BURST_SHAPE = 0.25            # Gamma shape: CV = 2 at equal mean rate

# per-dataset (prompt_len_lo, hi), (max_new_lo, hi): code-like traffic
# is short-prompt/short-output, news-like is long-prompt/long-output
MIX: Dict[str, Tuple[Tuple[int, int], Tuple[int, int]]] = {
    "code": ((8, 16), (8, 16)),
    "qa": ((12, 24), (8, 24)),
    "news": ((24, 48), (16, 32)),
    "dialogue": ((8, 32), (8, 32)),
}


def make_trace(n_requests: int, rate_rps: float, process: str = "poisson",
               seed: int = 0, max_new_cap: Optional[int] = None,
               deadline: Optional[Tuple[float, float]] = None) -> Dict:
    """Deterministic trace: same args, same trace, on any machine.

    Requests and arrivals come from SEPARATE rng streams, both derived
    from ``seed``: the request set depends only on ``(n_requests, seed,
    max_new_cap)``, so every point of a saturation ladder serves the
    same workload and only the arrival pattern varies.

    ``deadline=(base_s, per_token_s)`` stamps each request with a
    completion deadline ``base_s + per_token_s * max_new_tokens`` and
    makes the trace version 2; None keeps the version-1 format."""
    if process not in ("poisson", "bursty"):
        raise ValueError(f"unknown arrival process {process!r}")
    rng = np.random.RandomState(seed)
    rng_arr = np.random.RandomState(
        (seed + zlib.crc32(process.encode())) % 2**31)
    if process == "poisson":
        gaps = rng_arr.exponential(1.0 / rate_rps, size=n_requests)
    else:
        gaps = rng_arr.gamma(BURST_SHAPE, 1.0 / (rate_rps * BURST_SHAPE),
                             size=n_requests)
    arrivals = np.cumsum(gaps)
    arrivals[0] = 0.0                       # the trace starts at its head
    names = list(MIX)
    reqs = []
    for i in range(n_requests):
        name = names[rng.randint(len(names))]
        (plo, phi), (nlo, nhi) = MIX[name]
        plen = int(rng.randint(plo, phi + 1))
        max_new = int(rng.randint(nlo, nhi + 1))
        if max_new_cap is not None:
            max_new = min(max_new, max_new_cap)
        prompt = workloads.dataset(name).prompts(1, plen,
                                                 seed=seed * 100003 + i)[0]
        rec = {"request_id": i, "arrival_s": float(arrivals[i]),
               "prompt": [int(t) for t in prompt],
               "max_new_tokens": max_new, "dataset": name}
        if deadline is not None:
            base_s, per_token_s = deadline
            rec["slo_deadline_s"] = float(base_s + per_token_s * max_new)
            rec["priority"] = 0
        reqs.append(rec)
    return {"version": 2 if deadline is not None else 1, "seed": seed,
            "process": process, "rate_rps": rate_rps, "requests": reqs}


def save_trace(trace: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(trace, f)


def load_trace(path: str) -> Dict:
    with open(path) as f:
        trace = json.load(f)
    if trace.get("version") not in (1, 2):
        raise ValueError(f"unknown trace version {trace.get('version')!r}")
    return trace


def _trace_request(r: Dict) -> Request:
    return Request(r["request_id"], prompt=list(r["prompt"]),
                   max_new_tokens=r["max_new_tokens"],
                   slo_deadline_s=r.get("slo_deadline_s"),
                   priority=int(r.get("priority", 0)))


def trace_requests(trace: Dict) -> List[Request]:
    """The trace as engine Requests (ids from the trace, so identity-
    threaded sampling reproduces stochastic streams exactly); version-1
    requests get deadline None."""
    return [_trace_request(r) for r in trace["requests"]]


def replay(frontend: ServingFrontend, trace: Dict,
           time_scale: float = 1.0, settle_s: float = 120.0) -> Dict:
    """Open-loop replay: submit each request when its (scaled) arrival
    time comes due, against the front-end's already-running driver
    thread, then wait for drain.  Returns the point's :func:`report`."""
    t0 = time.monotonic()
    handles = []
    for r in trace["requests"]:
        delay = t0 + r["arrival_s"] * time_scale - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        req = _trace_request(r)
        req.arrival_time = time.monotonic()   # deadline clock starts NOW
        handles.append(frontend.submit_request(req))
    if not frontend.wait_idle(timeout=settle_s):
        raise RuntimeError(f"replay did not drain within {settle_s} s")
    wall = time.monotonic() - t0
    return report(frontend, [h.request for h in handles], wall,
                  offered_rps=trace["rate_rps"] / time_scale)


def replay_at_zero(frontend: ServingFrontend, trace: Dict) -> Dict:
    """All arrivals at time 0, single-threaded drain: the replay mode
    that is byte-identical to a direct ``run()`` call (the requests:
    ``frontend.finished``)."""
    t0 = time.monotonic()
    reqs = trace_requests(trace)
    for r in reqs:
        frontend.submit_request(r)
    frontend.run_until_drained()
    return report(frontend, reqs, time.monotonic() - t0,
                  offered_rps=float("inf"))


def report(frontend: ServingFrontend, reqs: List[Request], wall: float,
           offered_rps: float, slo_ttft_s: float = 2.5,
           slo_tpot_s: float = 0.5) -> Dict:
    """Per-load-point serving report: TTFT/TPOT p50/p99, queue depth,
    and goodput: output tokens/s counting ONLY SLO-attaining requests
    (TTFT and TPOT within bound, plus each request's own
    ``slo_deadline_s`` when the trace carries one:
    ``Request.slo_attained``)."""
    fin = [r for r in reqs if r.state is RequestState.FINISHED]
    out = {"offered_rps": float(offered_rps), "wall_s": float(wall),
           "requests": len(reqs), "requests_finished": len(fin),
           "requests_rejected": sum(
               r.state is RequestState.REJECTED for r in reqs),
           "tokens_emitted": int(sum(len(r.output) for r in fin)),
           "preemptions": int(sum(r.preemptions for r in reqs))}
    out.update(workloads.dist_stats([r.ttft() for r in fin], "ttft_s"))
    out.update(workloads.dist_stats([r.tpot() for r in fin], "tpot_s"))
    out.update(workloads.dist_stats([r.queue_wait() for r in fin],
                                    "queue_wait_s"))
    depths = [q + s for _, q, s, _ in frontend.queue_depth_log]
    out.update(workloads.dist_stats(depths, "queue_depth", ps=(99,)))
    out["queue_depth_peak"] = float(max(depths, default=0))
    out["throughput_tok_s"] = out["tokens_emitted"] / max(wall, 1e-9)
    good = [r for r in fin if r.slo_attained(slo_ttft_s, slo_tpot_s)]
    out["slo_attained_frac"] = len(good) / max(len(fin), 1)
    out["goodput_tok_s"] = (sum(len(r.output) for r in good)
                            / max(wall, 1e-9))
    return out
