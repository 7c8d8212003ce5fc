"""The port's dense ring engine and pipelined schedule against the
reference's.

Greedy streams of the port's dense engine are byte-identical to the
reference's dense engine (dsde/static/autoregressive x model drafter, the
n-gram drafter, a windowed model whose ring wraps).  Inside the port the
pipelined schedule (round N+1 dispatched before round N is collected)
emits the synchronous streams on both layouts, at temperature 1.0 too,
under forced preemption, and at the termination edges the reference's
``tests/test_pipeline.py`` pins; dense == paged.  ``collect`` reads host
copies taken at dispatch, which the aliasing test holds it to.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core.config import ServingConfig, SpecDecodeConfig
from repro.models.module import init_params
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine
from repro.serving.request import Request
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import spec_decode as t_sd
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.models.transformer import forward as t_forward
from repro_torch.models.weights import from_reference
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.request import RequestState
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)
from test_torch_engine import _assert_summary_matches

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


def _prompts(vocab, seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist() for n in lens]


def _port(sp, prompts, policy="dsde", *, drafter="model", window=None,
          max_new=16, eos=None, batch=2, max_seq=128, temperature=0.0,
          seed=0, ngram_n=1, **serving):
    """One port engine run (``serving``: pipelined, paged_kv,
    kv_block_size, num_kv_blocks)."""
    tcfg, tpt, tpd = sp[3:]
    tcfg = dataclasses.replace(tcfg, attention_window=window)
    model = drafter == "model"
    eng = TEngine(tpt, tcfg, tpd if model else None, tcfg if model else None,
                  TSpec(policy=policy, drafter=drafter, ngram_n=ngram_n,
                        temperature=temperature),
                  TServing(max_batch_size=batch, max_seq_len=max_seq,
                           **serving), seed=seed, device="cpu")
    reqs = [TRequest(i, prompt=p, max_new_tokens=max_new, eos_token_id=eos)
            for i, p in enumerate(prompts)]
    m = eng.run(reqs)
    return [r.output for r in reqs], m, reqs, eng


_REF_RUNS = {}


def _ref(sp, prompts, policy="dsde", *, drafter="model", window=None,
         max_new=16, ngram_n=1):
    """The reference's dense synchronous engine (memoized per module:
    each configuration compiles its own round programs)."""
    key = (tuple(map(tuple, prompts)), policy, drafter, window, max_new,
           ngram_n)
    if key not in _REF_RUNS:
        cfg, pt, pd = sp[:3]
        cfg = dataclasses.replace(cfg, attention_window=window)
        model = drafter == "model"
        eng = ServingEngine(pt, cfg, pd if model else None,
                            cfg if model else None,
                            SpecDecodeConfig(policy=policy, drafter=drafter,
                                             ngram_n=ngram_n),
                            ServingConfig(max_batch_size=2, max_seq_len=128),
                            seed=0)
        reqs = [Request(i, prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        m = eng.run(reqs)
        _REF_RUNS[key] = ([r.output for r in reqs], m, eng)
    return _REF_RUNS[key]


# ---------------------------------------------------------------------------
# dense ring engine == the reference's; pipelined == sync; dense == paged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["dsde", "static", "autoregressive"])
def test_streams_match_reference_both_layouts_both_schedules(small_pair,
                                                             policy):
    prompts = _prompts(small_pair[0].vocab_size, 11, (7, 12, 5))
    want, rm, reng = _ref(small_pair, prompts, policy)
    assert all(len(o) == 16 for o in want)
    for paged in (False, True):
        for pipelined in (False, True):
            out, m, reqs, eng = _port(small_pair, prompts, policy,
                                      paged_kv=paged, pipelined=pipelined)
            assert out == want, (paged, pipelined)
            assert all(r.state == RequestState.FINISHED for r in reqs)
            assert m["tokens_emitted"] == rm["tokens_emitted"]
            if not pipelined:
                for key in ("rounds", "draft_steps", "draft_steps_effective"):
                    assert m[key] == rm[key], (key, paged)
                assert ([r["k"] for r in eng.round_log]
                        == [r["k"] for r in reng.round_log])
            if not paged:
                # the ring has no pool: blocks read as dense rows, 0 bytes
                for key in ("kv_pool_blocks", "kv_pool_bytes", "preemptions"):
                    assert m[key] == rm[key], key
                assert m["kv_blocks_peak"] == max(
                    r["kv_blocks_in_use"] for r in reng.round_log)
            # the summary's fields: all of the synchronous dense run's
            # equal to the reference's (whose engine is the dense
            # synchronous one); on the pool or under pipelining, those
            # that depend on neither the layout nor the schedule's rounds
            counts = ["tokens_emitted", "requests_finished",
                      "requests_rejected", "drafter", "draft_step_cost",
                      "kv_quant"]
            ratios = []
            if not pipelined:
                counts += ["rounds", "draft_steps", "draft_steps_effective"]
                ratios += ["block_efficiency", "mean_acceptance",
                           "batch_tokens_per_round", "draft_cost_effective"]
            if not paged:
                counts += ["kv_pool_blocks", "kv_block_bytes",
                           "kv_pool_bytes", "kv_bytes_swept", "preemptions"]
            if paged or pipelined:
                _assert_summary_matches(m, rm, counts, ratios)
            else:
                _assert_summary_matches(m, rm)


def test_ngram_dense_streams_match_reference(small_pair):
    """The n-gram drafter on the dense layout (1-gram lookup: the seeded
    random target repeats no longer n-gram at this width)."""
    prompts = _prompts(small_pair[0].vocab_size, 12, (7, 12, 5))
    want, rm, reng = _ref(small_pair, prompts, drafter="ngram")
    assert sum(r["proposed"] for r in reng.round_log) > 0
    for pipelined in (False, True):
        out, m, _, eng = _port(small_pair, prompts, drafter="ngram",
                               pipelined=pipelined)
        assert out == want, pipelined
        assert (sum(r["proposed"] for r in eng.round_log)
                == sum(r["proposed"] for r in reng.round_log))


def test_windowed_ring_wraps_and_matches_reference(small_pair):
    """Window 64: the ring is 80 slots.  The 70-token prompt pads to the
    128 bucket, so the ring keeps only the wave's last 80 columns, and
    with 40 new tokens its row runs the ring past W.  (The static policy
    keeps the reference to one round program for this model.)"""
    prompts = _prompts(small_pair[0].vocab_size, 13, (20, 70, 9))
    want, _, _ = _ref(small_pair, prompts, "static", window=64, max_new=40)
    for pipelined in (False, True):
        out, _, reqs, eng = _port(small_pair, prompts, "static", window=64,
                                  max_new=40, pipelined=pipelined)
        assert out == want, pipelined
        assert reqs[1].cache_len > 100                        # wrapped
        assert eng.state.target_cache["kv_pos"].shape[1] == 80


def test_pipelined_exact_under_forced_preemption(small_pair):
    """Pool pressure in the pipelined window: growth planned from stale
    mirrors evicts and requeues, and recompute-on-readmit reproduces the
    dense stream, including the tokens of the round the victim was part
    of when it was evicted."""
    prompts = _prompts(small_pair[0].vocab_size, 5, (30, 25, 20))
    want, _, _ = _ref(small_pair, prompts, max_new=40)
    dense, _, _, _ = _port(small_pair, prompts, max_new=40, kv_block_size=8)
    pipe, m, _, _ = _port(small_pair, prompts, max_new=40, paged_kv=True,
                          pipelined=True, kv_block_size=8, num_kv_blocks=16)
    assert m["preemptions"] >= 1
    assert m["requests_finished"] == 3
    assert dense == pipe == want


@pytest.mark.parametrize("drafter", ["model", "ngram"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("policy", ["static", "dsde"])
def test_pipelined_matches_sync_at_temperature(small_pair, policy, paged,
                                               drafter):
    """Temperature 1.0: every draw is keyed by (request, its own round,
    purpose, position), and a pipelined round runs at the policy's max
    bucket, so the sampled streams do not depend on the schedule (3
    requests over 2 slots: slot reuse included)."""
    prompts = _prompts(small_pair[0].vocab_size, 23, (7, 12, 5))
    outs = [_port(small_pair, prompts, policy, drafter=drafter,
                  temperature=1.0, max_new=10, seed=3, paged_kv=paged,
                  pipelined=pipelined)[0] for pipelined in (False, True)]
    assert outs[0] == outs[1]
    assert all(len(o) == 10 for o in outs[0])


# ---------------------------------------------------------------------------
# device-side termination edges (the reference's tests/test_pipeline.py)
# ---------------------------------------------------------------------------

def _round_boundaries(eng):
    """Cumulative emitted-token count after each round of a batch-1 run,
    offset by the prefill token."""
    cum, out = 1, []
    for r in eng.round_log:
        cum += int(r["emitted"])
        out.append(cum)
    return out


def _greedy_rollout(params, cfg, prompt, n):
    toks = list(prompt)
    for _ in range(n):
        logits, _ = t_forward(params, cfg, torch.tensor([toks]), mode="train")
        toks.append(int(logits[0, -1, :cfg.vocab_size].argmax()))
    return toks[len(prompt):]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_eos_exactly_on_round_boundary(small_pair, paged):
    prompt = list(range(2, 10))
    base, _, _, eng = _port(small_pair, [prompt], "static", max_new=32,
                            batch=1, paged_kv=paged)
    stream = base[0]
    pick = None
    for cum in _round_boundaries(eng):
        p = cum - 1
        if 0 < p < len(stream) and stream[p] not in stream[:p]:
            pick = p
            break
    assert pick is not None, "no usable boundary in this rollout"
    for pipelined in (False, True):
        got, _, reqs, _ = _port(small_pair, [prompt], "static", max_new=32,
                                batch=1, eos=stream[pick], paged_kv=paged,
                                pipelined=pipelined)
        assert got[0] == stream[:pick + 1], pipelined
        assert reqs[0].state == RequestState.FINISHED


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_max_new_tokens_truncates_mid_round(small_pair, paged):
    prompt = list(range(3, 11))
    base, _, _, eng = _port(small_pair, [prompt], "static", max_new=32,
                            batch=1, paged_kv=paged)
    bounds = _round_boundaries(eng)
    pick = next((b - 1 for b, prev in zip(bounds, [1] + bounds)
                 if b - prev >= 2 and b - 1 > 1), None)
    assert pick is not None, "no multi-token round in this rollout"
    for pipelined in (False, True):
        got, m, reqs, _ = _port(small_pair, [prompt], "static", max_new=pick,
                                batch=1, paged_kv=paged, pipelined=pipelined)
        assert got[0] == base[0][:pick], pipelined
        assert reqs[0].state == RequestState.FINISHED
        assert m["tokens_emitted"] == pick


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_finished_slot_readmitted_in_pipelined_window(small_pair, paged):
    """More requests than slots, tiny budgets: each finish frees a slot
    that is readmitted while the round still carrying the finished row
    is in flight."""
    prompts = _prompts(small_pair[0].vocab_size, 2, (6,) * 6)
    sync, ms, _, _ = _port(small_pair, prompts, max_new=5, paged_kv=paged)
    pipe, mp, reqs, _ = _port(small_pair, prompts, max_new=5, paged_kv=paged,
                              pipelined=True)
    assert sync == pipe
    assert mp["requests_finished"] == 6
    assert all(len(r.output) == 5 for r in reqs)
    assert ms["rounds"] >= 3 and mp["rounds"] >= ms["rounds"]


def test_preempted_finished_at_first_token_never_readmitted(small_pair):
    """A request that finishes at its prefill-sampled first token but is
    preempted before that token is collected leaves the requeue at
    collect (a release would no-op on the empty slot and the FINISHED
    request would come back as a dead row, hanging ``run()``)."""
    tcfg, tpt = small_pair[3], small_pair[4]
    a = TRequest(0, prompt=list(range(1, 102)), max_new_tokens=12)  # 7 blocks
    b = TRequest(1, prompt=list(range(1, 9)), max_new_tokens=1)     # 1 block
    eng = TEngine(tpt, tcfg, small_pair[5], tcfg, TSpec(policy="dsde"),
                  TServing(max_batch_size=2, max_seq_len=128, paged_kv=True,
                           kv_block_size=16, num_kv_blocks=8, pipelined=True),
                  device="cpu")
    m = eng.run([a, b], max_rounds=40)
    assert b.preemptions >= 1
    assert m["requests_finished"] == 2
    assert b.state == RequestState.FINISHED
    assert b.output == _greedy_rollout(tpt, tcfg, b.prompt, 1)
    assert a.state == RequestState.FINISHED and len(a.output) == 12
    assert not eng.has_pending_work()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_eos_as_first_token_finishes_device_side(small_pair, paged):
    tcfg, tpt = small_pair[3], small_pair[4]
    prompt = list(range(2, 10))
    first = _greedy_rollout(tpt, tcfg, prompt, 1)[0]
    for pipelined in (False, True):
        for kw in (dict(eos=first, max_new=32), dict(max_new=1)):
            got, _, reqs, _ = _port(small_pair, [prompt], "static", batch=1,
                                    paged_kv=paged, pipelined=pipelined, **kw)
            assert got[0] == [first], (pipelined, kw)
            assert reqs[0].state == RequestState.FINISHED


# ---------------------------------------------------------------------------
# collect reads what dispatch copied
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_collect_reads_the_dispatch_time_copies(small_pair, monkeypatch,
                                                paged):
    """On the card round N+1 runs while the host collects round N; if
    ``collect`` read round N's device tensors, a later in-place write
    could change them first.  The CPU has no overlap, so this test makes
    the overwrite happen: after every dispatch it scribbles over the
    previous round's output tensors and its ``sl_next`` (dead by then:
    the new round has consumed them), before ``collect`` of that round
    runs.  Streams and per-round logs must still equal the synchronous
    run's, and the per-round logs those of an undisturbed pipelined
    run."""
    prompts = _prompts(small_pair[0].vocab_size, 11, (7, 12, 5, 9))
    sync = _port(small_pair, prompts, paged_kv=paged)[0]
    clean = _port(small_pair, prompts, paged_kv=paged, pipelined=True)[3]
    rounds = []
    real_round = t_sd.spec_decode_round

    def round_spy(*args):
        state, out = real_round(*args)
        rounds.append([out.emitted, out.num_emitted, out.num_accepted,
                       out.num_proposed, out.finished, out.live,
                       state.sl_next])
        return state, out

    monkeypatch.setattr(t_sd, "spec_decode_round", round_spy)
    real_dispatch = TEngine.dispatch
    collected = []

    def dispatch(self):
        rec = real_dispatch(self)
        if rec is not None and len(rounds) >= 2:
            for x in rounds[-2]:       # round N, dispatched before N+1
                x.fill_(True if x.dtype == torch.bool else 7)
        return rec

    real_collect = TEngine.collect

    def collect(self, rec):
        collected.append((len(rounds), rec.k))
        return real_collect(self, rec)

    monkeypatch.setattr(TEngine, "dispatch", dispatch)
    monkeypatch.setattr(TEngine, "collect", collect)
    pipe, m, _, eng = _port(small_pair, prompts, paged_kv=paged,
                            pipelined=True)
    assert pipe == sync
    # every collect but the drain's ran after the next round's dispatch
    assert all(n >= i + 2 for i, (n, _) in enumerate(collected[:-1]))
    assert m["rounds"] == len(rounds) >= 5
    keys = ("k", "emitted", "accepted", "proposed", "kv_blocks_in_use")
    assert ([[r[k] for k in keys] for r in eng.round_log]
            == [[r[k] for k in keys] for r in clean.round_log])
