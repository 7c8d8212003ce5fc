"""The port's serving front-end (``repro_torch.serving.frontend``) and
its streaming contract, held to the port's own ``run()`` and to the
reference's streams.

Replay at arrival time 0 (everything submitted before the first pump)
replays ``run()``'s admit/dispatch/collect sequence, so the streams are
byte-identical; greedy streams are schedule-invariant, so staggered
arrivals and the threaded driver give the same bytes too.  Every
reconciled token fires ``on_token`` once, in order; a readmit's
recompute fires nothing."""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.core.config import ServingConfig, SpecDecodeConfig
from repro.models.module import init_params
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine
from repro.serving.frontend import ServingFrontend
from repro.serving.request import Request
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.models.weights import from_reference
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.frontend import ServingFrontend as TFrontend
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.request import RequestState
from repro_torch.serving.scheduler import LookaheadScheduler as TScheduler
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def small_pair():
    cfg = get_config("smollm-135m").reduced()
    pt = init_params(model_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
    noise = init_params(model_specs(cfg), jax.random.PRNGKey(7), jnp.float32)
    pd = jax.tree_util.tree_map(lambda a, b: a + 0.05 * b, pt, noise)
    conv = lambda p: from_reference(jax.tree_util.tree_map(np.asarray, p),
                                    device="cpu")
    return cfg, pt, pd, t_get_config("smollm-135m").reduced(), conv(pt), conv(pd)


def _serving(paged, pipelined, bs, nblocks, caching):
    return dict(max_batch_size=2, max_seq_len=128, paged_kv=paged,
                kv_block_size=bs, num_kv_blocks=nblocks, pipelined=pipelined,
                prefix_caching=caching)


def _engine(pair, *, policy="dsde", drafter="model", paged=True,
            pipelined=True, bs=16, nblocks=None, caching=False):
    _, _, _, tcfg, tpt, tpd = pair
    model = drafter == "model"
    return TEngine(tpt, tcfg, tpd if model else None, tcfg if model else None,
                   TSpec(policy=policy, drafter=drafter),
                   TServing(**_serving(paged, pipelined, bs, nblocks,
                                       caching)), seed=0, device="cpu")


def _ref_engine(pair, *, policy="dsde", drafter="model", paged=True,
                pipelined=True, bs=16, nblocks=None, caching=False):
    cfg, pt, pd = pair[:3]
    model = drafter == "model"
    return ServingEngine(pt, cfg, pd if model else None, cfg if model else None,
                         SpecDecodeConfig(policy=policy, drafter=drafter,
                                          temperature=0.0),
                         ServingConfig(**_serving(paged, pipelined, bs,
                                                  nblocks, caching)), seed=0)


def _prompts(vocab, sizes=(7, 12, 5), seed=11):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist() for n in sizes]


def _reqs(prompts, max_new=8, eos=None, cls=TRequest):
    return [cls(i, prompt=list(p), max_new_tokens=max_new, eos_token_id=eos)
            for i, p in enumerate(prompts)]


# ---------------------------------------------------------------------------
# Replay exactness: the front-end at arrival time 0 == run() == reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,drafter", [("dsde", "model"),
                                            ("static", "ngram"),
                                            ("goodput", "self")])
def test_replay_at_zero_matches_run_and_reference(small_pair, policy,
                                                  drafter):
    """Paged + pipelined: the port's front-end replay of an all-at-once
    submission equals the port's run() and the reference front-end's
    replay, and the stream events carry the same bytes."""
    prompts = _prompts(small_pair[3].vocab_size)
    kw = dict(policy=policy, drafter=drafter)
    run = _reqs(prompts)
    _engine(small_pair, **kw).run(run)
    fe = TFrontend(_engine(small_pair, **kw))
    handles = [fe.submit_request(r) for r in _reqs(prompts)]
    fe.run_until_drained()
    ref_fe = ServingFrontend(_ref_engine(small_pair, **kw))
    ref = [ref_fe.submit_request(r) for r in _reqs(prompts, cls=Request)]
    ref_fe.run_until_drained()
    streams = [h.request.output for h in handles]
    assert streams == [r.output for r in run]
    assert streams == [h.request.output for h in ref]
    for h, want in zip(handles, streams):
        assert h.result(timeout=0) == (want, "length")


def test_replay_at_zero_with_prefix_caching(small_pair):
    """The front-end over a warm prefix cache: the second wave shares the
    first's head, and the replay still equals run()."""
    vocab = small_pair[3].vocab_size
    head = _prompts(vocab, sizes=(32,), seed=3)[0]
    prompts = [head + p for p in _prompts(vocab, sizes=(5, 3, 7, 2))]
    kw = dict(caching=True)
    run = _reqs(prompts)
    m = _engine(small_pair, **kw).run(run)
    assert m["prefix_cache_hit_blocks"] > 0
    fe = TFrontend(_engine(small_pair, **kw))
    handles = [fe.submit_request(r) for r in _reqs(prompts)]
    fe.run_until_drained()
    assert [h.request.output for h in handles] == [r.output for r in run]
    assert fe.summary()["prefix_cache_hit_blocks"] == m["prefix_cache_hit_blocks"]


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
def test_staggered_arrivals_same_streams(small_pair, pipelined):
    prompts = _prompts(small_pair[3].vocab_size, sizes=(7, 12, 5, 9))
    ref = _reqs(prompts)
    _engine(small_pair, pipelined=pipelined).run(ref)
    fe = TFrontend(_engine(small_pair, pipelined=pipelined))
    reqs = _reqs(prompts)
    for r in reqs[:2]:
        fe.submit_request(r)
    for _ in range(2):
        fe._drive_once()
    for r in reqs[2:]:
        fe.submit_request(r)
    fe.run_until_drained()
    assert [r.output for r in reqs] == [r.output for r in ref]
    assert all(r.state == RequestState.FINISHED for r in reqs)


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
def test_threaded_driver_delivers_all_streams(small_pair, pipelined):
    """start()/stop(): concurrent submitters against the live driver
    thread; every stream terminates with run()'s bytes."""
    prompts = _prompts(small_pair[3].vocab_size, sizes=(7, 12, 5, 9, 6))
    ref = _reqs(prompts, max_new=6)
    _engine(small_pair, pipelined=pipelined).run(ref)
    fe = TFrontend(_engine(small_pair, pipelined=pipelined)).start()
    handles = [None] * len(prompts)

    def submit(i):
        time.sleep(0.01 * i)
        handles[i] = fe.submit_request(
            TRequest(i, prompt=list(prompts[i]), max_new_tokens=6))

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert fe.wait_idle(timeout=120)
    fe.stop()
    results = [h.result(timeout=5) for h in handles]
    assert [toks for toks, _ in results] == [r.output for r in ref]
    assert all(reason == "length" for _, reason in results)
    with pytest.raises(RuntimeError, match="stopped"):
        fe.submit([1, 2, 3])


def test_submit_assigns_ids_and_summary(small_pair):
    fe = TFrontend(_engine(small_pair))
    a = fe.submit([3, 4, 5], max_new_tokens=4)
    b = fe.submit([6, 7], max_new_tokens=4, request_id=10)
    c = fe.submit([8, 9], max_new_tokens=4)
    assert [h.request.request_id for h in (a, b, c)] == [0, 10, 11]
    fe.run_until_drained()
    m = fe.summary()
    assert m["requests_finished"] == 3 and m["tokens_emitted"] == 12
    assert m["queue_depth_peak"] >= 1 and m["queue_depth_mean"] > 0
    assert [len(list(h)) for h in (a, b, c)] == [4, 4, 4]


# ---------------------------------------------------------------------------
# The streaming callback
# ---------------------------------------------------------------------------

def _watch(reqs):
    seen = {r.request_id: [] for r in reqs}
    for r in reqs:
        r.on_token = lambda rq, t: seen[rq.request_id].append(t)
    return seen


def test_tokens_in_order_exactly_once(small_pair):
    reqs = _reqs(_prompts(small_pair[3].vocab_size, sizes=(7, 12, 5, 9)),
                 max_new=10)
    seen = _watch(reqs)
    _engine(small_pair).run(reqs)
    for r in reqs:
        assert seen[r.request_id] == r.output and len(r.output) == 10


def test_eos_truncation_never_over_delivers(small_pair):
    """An EOS taken from a stream stops that stream mid-way: the callback
    stops at it, and the finish reasons equal the reference's."""
    prompts = _prompts(small_pair[3].vocab_size, sizes=(7, 12))
    first = _reqs(prompts, max_new=12)
    _engine(small_pair).run(first)
    eos = first[0].output[5]
    reqs = _reqs(prompts, max_new=12, eos=eos)
    seen = _watch(reqs)
    _engine(small_pair).run(reqs)
    ref = _reqs(prompts, max_new=12, eos=eos, cls=Request)
    _ref_engine(small_pair).run(ref)
    assert [r.output for r in reqs] == [r.output for r in ref]
    assert ([r.finish_reason() for r in reqs]
            == [r.finish_reason() for r in ref])
    assert reqs[0].finish_reason() == "stop"
    for r in reqs:
        assert seen[r.request_id] == r.output
        if eos in r.output:
            assert r.output.index(eos) == len(r.output) - 1


def test_callback_fires_for_finished_in_pipelined_window(small_pair):
    prompts = _prompts(small_pair[3].vocab_size, sizes=(7, 5, 9, 6, 8))
    fe = TFrontend(_engine(small_pair, pipelined=True))
    handles = [fe.submit_request(r) for r in _reqs(prompts, max_new=4)]
    fe.run_until_drained()
    for h in handles:
        toks, reason = h.result(timeout=0)
        assert toks == h.request.output and len(toks) == 4
        assert reason == "length"


@pytest.mark.parametrize("caching", [False, True], ids=["cold", "warm"])
def test_readmitted_request_streams_each_token_once(small_pair, caching):
    """Forced preemption: a readmit's recompute re-delivers nothing, with
    or without the prefix cache."""
    prompts = _prompts(small_pair[3].vocab_size, sizes=(30, 25, 20), seed=5)
    reqs = _reqs(prompts, max_new=40)
    seen = _watch(reqs)
    m = _engine(small_pair, bs=8, nblocks=16, caching=caching).run(reqs)
    assert m["preemptions"] >= 1
    for r in reqs:
        assert seen[r.request_id] == r.output and len(r.output) == 40


# ---------------------------------------------------------------------------
# Scheduler: the readmit FIFO guard
# ---------------------------------------------------------------------------

def _sched(batch=2):
    return TScheduler(TServing(max_batch_size=batch, max_seq_len=128,
                               paged_kv=True, kv_block_size=16),
                      TSpec(policy="static"))


def test_readmits_keep_fifo_priority_over_fresh():
    sched = _sched()
    old = [TRequest(i, prompt=[1] * 4, max_new_tokens=4) for i in range(2)]
    for r in old:
        sched.submit(r)
    assert [r.request_id for r in sched.admit()] == [0, 1]
    for i in range(10, 13):
        sched.submit(TRequest(i, prompt=[2] * 4, max_new_tokens=4))
    sched.preempt(old[1])
    sched.preempt(old[0])
    sched.assert_readmit_fifo()
    assert [r.request_id for r in sched.queue] == [0, 1, 10, 11, 12]
    assert [r.request_id for r in sched.admit()] == [0, 1]


def test_starvation_guard_detects_violation():
    sched = _sched(batch=1)
    victim = TRequest(0, prompt=[1] * 4, max_new_tokens=4)
    sched.submit(victim)
    sched.admit()
    sched.submit(TRequest(1, prompt=[2] * 4, max_new_tokens=4))
    sched.allocator.free(victim.block_ids)
    victim.block_ids = []
    sched.slots[victim.slot] = None
    victim.slot = None
    victim.state = RequestState.QUEUED
    victim.preemptions += 1
    sched.queue.append(victim)              # behind the fresh arrival
    with pytest.raises(AssertionError, match="starvation"):
        sched.assert_readmit_fifo()


# ---------------------------------------------------------------------------
# Summaries and request metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
def test_summary_run_vs_pump_loop(small_pair, pipelined):
    prompts = _prompts(small_pair[3].vocab_size)
    m_run = _engine(small_pair, pipelined=pipelined).run(_reqs(prompts))
    eng = _engine(small_pair, pipelined=pipelined)
    t0 = time.monotonic()
    for r in _reqs(prompts):
        eng.submit(r)
    done = []
    while eng.has_pending_work():
        done += eng.pump()
    done += eng.drain()
    m_ext = eng.summary(done, time.monotonic() - t0)
    assert set(m_run) == set(m_ext)
    for k in ("requests_finished", "requests_rejected", "preemptions",
              "tokens_emitted", "rounds", "drafter", "draft_steps",
              "draft_steps_effective", "block_efficiency", "mean_acceptance",
              "kv_blocks_peak", "kv_pool_bytes", "kv_bytes_swept",
              "prefix_cache_hit_blocks", "prefix_cache_hit_rate",
              "cow_copies", "prefix_cache_evictions"):
        assert m_run[k] == m_ext[k], k
    assert m_ext["ttft_mean_s"] > 0 and m_ext["queue_wait_mean_s"] >= 0


def test_tpot_and_finish_reason_match_reference():
    """Request.tpot and Request.finish_reason on the same stamps and
    outputs as the reference's Request."""
    cases = [dict(output=[5, 6, 7, 8], eos=None, fin=10.0, first=4.0),
             dict(output=[5, 6, 9], eos=9, fin=3.5, first=1.0),
             dict(output=[9], eos=9, fin=2.0, first=2.0),
             dict(output=[5, 6], eos=9, fin=None, first=1.0)]
    for c in cases:
        got = []
        for cls in (Request, TRequest):
            r = cls(0, prompt=[1, 2], max_new_tokens=4, eos_token_id=c["eos"])
            r.output = list(c["output"])
            r.arrival_time, r.first_token_time = 0.5, c["first"]
            r.finish_time = c["fin"]
            if c["fin"] is not None:
                r.state = type(r.state).FINISHED
            got.append((r.tpot(), r.finish_reason(), r.ttft(),
                        r.prefix_hit_rate()))
        assert got[0] == got[1], c
    assert TRequest(9, prompt=[1, 2]).finish_reason() is None


def test_engine_tpot_after_run(small_pair):
    reqs = _reqs(_prompts(small_pair[3].vocab_size, sizes=(7,)), max_new=6)
    _engine(small_pair).run(reqs)
    r = reqs[0]
    assert r.finish_reason() == "length"
    assert r.tpot() is not None and r.tpot() >= 0 and r.ttft() is not None
