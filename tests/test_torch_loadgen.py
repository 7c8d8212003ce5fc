"""The port's trace load generation (``repro_torch.serving.loadgen``) held
to the reference's ``benchmarks/loadgen.py`` in one process: the same
arguments give the same trace JSON, byte for byte; the requests carry
the trace's fields; ``report`` computes the reference's numbers from the
same request timings; and ``replay_at_zero`` on the reference's untrained
pair emits the reference's greedy streams and ``run()``'s, with the
reference's report keys."""
import json
import os
import sys
import time

import pytest

import _workload_refs as refs
from _jax_caches import once_per_run, one_torch_thread, release_jax_caches  # noqa: F401  (autouse)
from repro.serving.request import Request as RefRequest
from repro.serving.request import RequestState as RefState
from repro_torch import workloads
from repro_torch.models.weights import from_reference
from repro_torch.serving import loadgen
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving.request import Request, RequestState

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from benchmarks import loadgen as ref_loadgen  # noqa: E402

GRID = [(process, deadline, cap, seed)
        for process in ("poisson", "bursty")
        for deadline in (None, (0.5, 0.02))
        for cap in (None, 8)
        for seed in (0, 1, 13)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return once_per_run(tmp_path_factory, "loadgen_refs", refs.replay)


@pytest.fixture(scope="module")
def engine(ref):
    """A factory of ``examples.stream_serving``'s engine over the
    reference's untrained pair."""
    pt, pd = (from_reference(p, device="cpu") for p in ref["params"])
    from repro_torch.examples.stream_serving import make_engine
    return lambda: make_engine(workloads.target_config(),
                           workloads.draft_config(), pt, pd, "cpu")


def test_constants_equal_reference():
    assert loadgen.BURST_SHAPE == ref_loadgen.BURST_SHAPE
    assert loadgen.MIX == ref_loadgen.MIX
    assert list(loadgen.MIX) == list(ref_loadgen.MIX)


@pytest.mark.parametrize("process,deadline,cap,seed", GRID)
def test_make_trace_equals_reference(process, deadline, cap, seed):
    kw = dict(rate_rps=4.0, process=process, seed=seed, max_new_cap=cap,
              deadline=deadline)
    assert (json.dumps(loadgen.make_trace(12, **kw))
            == json.dumps(ref_loadgen.make_trace(12, **kw)))


def test_make_trace_refuses_unknown_process():
    with pytest.raises(ValueError):
        loadgen.make_trace(3, rate_rps=1.0, process="uniform")


@pytest.mark.parametrize("deadline", [None, (0.5, 0.02)])
def test_save_load_round_trip(tmp_path, deadline):
    """Each package loads the other's file, and the requests carry the
    trace's ids, budgets and (version 2) deadlines."""
    trace = loadgen.make_trace(6, rate_rps=2.0, process="bursty", seed=5,
                               deadline=deadline)
    path = str(tmp_path / "trace.json")
    loadgen.save_trace(trace, path)
    assert ref_loadgen.load_trace(path) == trace
    ref_loadgen.save_trace(trace, path)
    assert loadgen.load_trace(path) == trace
    got = loadgen.trace_requests(loadgen.load_trace(path))
    want = ref_loadgen.trace_requests(trace)
    assert [(r.request_id, r.prompt, r.max_new_tokens, r.slo_deadline_s,
             r.priority) for r in got] == [
        (r.request_id, r.prompt, r.max_new_tokens, r.slo_deadline_s,
         r.priority) for r in want]
    assert trace["version"] == (1 if deadline is None else 2)


def test_load_trace_refuses_unknown_version(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"version": 3, "requests": []}))
    with pytest.raises(ValueError):
        loadgen.load_trace(str(path))


class _Depths:
    """A front-end stand-in: ``report`` reads only its depth log."""

    def __init__(self, log):
        self.queue_depth_log = log


def test_report_equals_reference():
    """The same request timings give the reference's report, SLO
    attainment and goodput included."""
    t0 = 100.0
    # (output length, arrival, admit, first token, finish, deadline, state)
    rows = [(5, 0.0, 0.1, 0.3, 1.0, None, "finished"),
            (8, 0.2, 0.2, 3.0, 3.9, None, "finished"),     # TTFT over 2.5
            (2, 0.5, 0.9, 1.0, 2.5, None, "finished"),     # TPOT over 0.5
            (6, 0.7, 0.8, 0.9, 1.5, 0.5, "finished"),      # deadline missed
            (1, 1.0, 1.1, 1.2, 1.2, None, "finished"),     # one token
            (0, 1.5, None, None, None, None, "rejected")]
    log = [(0.1, 2, 1, 3), (0.5, 0, 4, 4), (1.0, 1, 0, 2)]

    def requests(cls, state):
        out = []
        for i, (n, arr, adm, first, fin, dl, st) in enumerate(rows):
            r = cls(i, prompt=[1, 2, 3], max_new_tokens=8, slo_deadline_s=dl)
            r.output = list(range(n))
            r.arrival_time = t0 + arr
            r.admit_time = None if adm is None else t0 + adm
            r.first_token_time = None if first is None else t0 + first
            r.finish_time = None if fin is None else t0 + fin
            r.state = getattr(state, st.upper())
            r.preemptions = i % 2
            out.append(r)
        return out

    got = loadgen.report(_Depths(log), requests(Request, RequestState), 4.0,
                         offered_rps=2.0)
    want = ref_loadgen.report(_Depths(log), requests(RefRequest, RefState),
                              4.0, offered_rps=2.0)
    assert got == want
    assert 0.0 < got["slo_attained_frac"] < 1.0


def test_replay_at_zero_matches_reference_and_run(ref, engine):
    want_report, want_streams = ref["replay_at_zero"]
    trace = loadgen.make_trace(refs.TRACE_N, **refs.TRACE_KW)
    run = loadgen.trace_requests(trace)
    engine().run(run)
    fe = ServingFrontend(engine())
    got = loadgen.replay_at_zero(fe, trace)
    streams = [r.output for r in sorted(fe.finished,
                                        key=lambda r: r.request_id)]
    assert streams == want_streams
    assert streams == [r.output for r in run]
    assert list(got) == list(want_report)
    for k in ("requests", "requests_finished", "requests_rejected",
              "tokens_emitted", "preemptions"):
        assert got[k] == want_report[k], k
    assert got["offered_rps"] == float("inf")


def test_replay_open_loop_streams_equal_run(engine):
    """The threaded open-loop replay at a compressed clock: greedy streams
    are schedule-invariant, so they equal ``run()``'s, and the report
    counts every request and token."""
    trace = loadgen.make_trace(refs.TRACE_N, **refs.TRACE_KW)
    run = loadgen.trace_requests(trace)
    engine().run(run)
    fe = ServingFrontend(engine()).start()
    try:
        t0 = time.monotonic()
        point = loadgen.replay(fe, trace, time_scale=0.05, settle_s=60.0)
        assert time.monotonic() - t0 < 60.0
    finally:
        fe.stop()
    streams = [r.output for r in sorted(fe.finished,
                                        key=lambda r: r.request_id)]
    assert streams == [r.output for r in run]
    assert point["requests_finished"] == refs.TRACE_N
    assert point["offered_rps"] == pytest.approx(
        trace["rate_rps"] / 0.05)
    assert point["tokens_emitted"] == sum(len(r.output) for r in run)
    assert point["queue_depth_peak"] >= 0.0
