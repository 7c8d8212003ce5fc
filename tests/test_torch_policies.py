"""The port's remaining policies (adaedl, goodput, slo with its admission
gate) and the self drafter against the reference: policy state, masks,
SL picks, the latency model and the gate's decisions on the same seeded
inputs, then greedy streams and run summaries of the reference engine
at reduced width."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import signals as r_signals
from repro.core.config import ServingConfig, SpecDecodeConfig
from repro.core.drafters import available_drafters as r_available_drafters
from repro.core.drafters import build_drafter as r_build_drafter
from repro.core.policies import HostRoundContext as RCtx
from repro.core.policies import PolicyObservation as RObs
from repro.core.policies import available_policies as r_available_policies
from repro.core.policies import build_policy as r_build_policy
from repro.core.policies import goodput as r_goodput
from repro.core.policies.slo import batch_tightness_s as r_tightness
from repro.models.module import init_params
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine
from repro.serving.latency_model import RoundLatencyModel as RLM
from repro.serving.request import Request
from repro.serving.request import RequestState as RState
from repro.serving.scheduler import LookaheadScheduler
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import signals as t_signals
from repro_torch.core.config import ModelConfig as TModel
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.core.drafters import available_drafters as t_available_drafters
from repro_torch.core.drafters import build_drafter as t_build_drafter
from repro_torch.core.policies import HostRoundContext as TCtx
from repro_torch.core.policies import PolicyObservation as TObs
from repro_torch.core.policies import available_policies as t_available_policies
from repro_torch.core.policies import build_policy as t_build_policy
from repro_torch.core.policies import goodput as t_goodput
from repro_torch.core.policies.slo import batch_tightness_s as t_tightness
from repro_torch.models.weights import from_reference
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.latency_model import RoundLatencyModel as TLM
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.request import RequestState as TState
from repro_torch.serving.scheduler import LookaheadScheduler as TScheduler
from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401  (autouse)
from test_torch_engine import _assert_summary_matches

jax.config.update("jax_platform_name", "cpu")

ATOL = 1e-6


def _leaves(x):
    """Tensors of a (nested) tuple / NamedTuple state, in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for part in x for t in _leaves(part)]


def _assert_state_equal(t_state, r_state):
    tl, rl = _leaves(t_state), jax.tree_util.tree_leaves(r_state)
    assert len(tl) == len(rl)
    for t, r in zip(tl, rl):
        r = np.asarray(r)
        assert t.shape == r.shape
        if r.dtype.kind in "bi":
            np.testing.assert_array_equal(t.numpy(), r)
        else:
            np.testing.assert_allclose(t.numpy(), r, rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

def test_registries_equal_reference():
    assert t_available_policies() == r_available_policies() == (
        "adaedl", "autoregressive", "dsde", "goodput", "slo", "static")
    assert t_available_drafters() == r_available_drafters() == (
        "model", "ngram", "self")


# ---------------------------------------------------------------------------
# device-side policy hooks on seeded observations
# ---------------------------------------------------------------------------

def _observations(seed, b, k, rounds):
    rng = np.random.RandomState(seed)
    for _ in range(rounds):
        num_prop = rng.randint(0, k + 1, size=b).astype(np.int32)
        valid = np.arange(k)[None] < num_prop[:, None]
        kld = np.where(valid, rng.exponential(0.7, size=(b, k)),
                       0.0).astype(np.float32)
        num_acc = np.array([rng.randint(0, p + 1) for p in num_prop],
                           np.int32)
        active = rng.rand(b) > 0.2
        yield kld, valid, num_acc, num_prop, active


@pytest.mark.parametrize("name,kw", [
    ("adaedl", {}),
    ("goodput", {}),                                   # fallback cost 0.08
    ("goodput", {"use_sl_cap": False, "goodput_draft_cost": 0.02}),
    ("goodput", {"goodput_ema": 0.5, "goodput_init_acc": 0.95,
                 "sl_min": 1, "sl_max": 16}),
], ids=["adaedl", "goodput", "goodput-nocap", "goodput-wide"])
def test_policy_hooks_match_reference(name, kw):
    b, k = 6, 7
    rpol = r_build_policy(SpecDecodeConfig(policy=name, **kw))
    tpol = t_build_policy(TSpec(policy=name, **kw))
    assert tpol.initial_sl_value() == rpol.initial_sl_value()
    assert tpol.max_lookahead() == rpol.max_lookahead()
    assert tpol.max_bucket() == rpol.max_bucket()
    rs, ts = rpol.init_state(b), tpol.init_state(b)
    _assert_state_equal(ts, rs)
    for kld, valid, acc, prop, active in _observations(3, b, k, 6):
        rs = rpol.observe(rs, RObs(jnp.asarray(kld), jnp.asarray(valid),
                                   jnp.asarray(acc), jnp.asarray(prop),
                                   jnp.asarray(active)))
        ts = tpol.observe(ts, TObs(*(torch.from_numpy(x) for x in
                                     (kld, valid, acc, prop, active))))
        _assert_state_equal(ts, rs)
        rsl, rs, rtel = rpol.predict(rs, jnp.asarray(active))
        tsl, ts, ttel = tpol.predict(ts, torch.from_numpy(active))
        np.testing.assert_array_equal(tsl.numpy(), np.asarray(rsl))
        assert tsl.dtype == torch.int32
        assert set(ttel) == set(rtel)
        for key in rtel:
            np.testing.assert_allclose(ttel[key].numpy(),
                                       np.asarray(rtel[key]), atol=ATOL)
        _assert_state_equal(ts, rs)
    rows = np.array([True, False, True, False, False, True])
    _assert_state_equal(tpol.reset_rows(ts, torch.from_numpy(rows)),
                        rpol.reset_rows(rs, jnp.asarray(rows)))


def _draft_logits(seed, b=24, v=640):
    """Rows at logit scales from near-uniform to near-one-hot, so the
    entropies span the AdaEDL bound's threshold."""
    rng = np.random.RandomState(seed)
    scale = np.geomspace(0.1, 40.0, b)[:, None]
    return (rng.randn(b, v) * scale).astype(np.float32)


def test_draft_entropy_and_keep_mask_match_reference():
    x = _draft_logits(5)
    rh = np.asarray(r_signals.draft_entropy(jnp.asarray(x)[:, None]))[:, 0]
    th = t_signals.draft_entropy(torch.from_numpy(x)[:, None])[:, 0].numpy()
    # a 640-term fp32 sum: the two reductions add in different orders,
    # a few ulps of entropies up to 6.5 nats
    np.testing.assert_allclose(th, rh, atol=ATOL, rtol=1e-6)
    for threshold in (0.01, 0.1, 0.5):
        spec = dict(policy="adaedl", adaedl_threshold=threshold)
        rk = np.asarray(r_build_policy(SpecDecodeConfig(**spec))
                        .draft_keep(jnp.asarray(x)))
        tk = t_build_policy(TSpec(**spec)).draft_keep(
            torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(tk, rk)
        assert 0 < rk.sum() < len(rk)        # both outcomes present


# ---------------------------------------------------------------------------
# goodput's k-grid argmax, device (torch / jnp) and host (numpy)
# ---------------------------------------------------------------------------

GOODPUT_GRIDS = [dict(goodput_draft_cost=c, sl_min=lo, sl_max=hi)
                 for c in (0.0, 1e-4, 0.08, 0.3, 1.0)
                 for lo, hi in ((2, 10), (1, 16))]


@pytest.mark.parametrize("kw", GOODPUT_GRIDS,
                         ids=lambda kw: "c{goodput_draft_cost}-k{sl_min}-"
                                        "{sl_max}".format(**kw))
def test_goodput_sl_matches_reference_at_seeded_and_edge_acceptance(kw):
    rng = np.random.RandomState(17)
    # the clip bounds and values past them, where the curve is flattest
    # (near-ties between adjacent k), and seeded values between
    acc = np.concatenate([[0.0, 5e-4, 1e-3, 1.1e-3, 0.5, 0.7, 0.998, 0.999,
                           0.9995, 1.0], rng.uniform(0, 1, 500),
                          rng.uniform(0.99, 1.0, 100),
                          rng.uniform(0.0, 0.01, 100)]).astype(np.float32)
    rspec, tspec = SpecDecodeConfig(**kw), TSpec(**kw)
    rks, rg = r_goodput._goodput_curve(rspec, jnp.asarray(acc), jnp)
    tks, tg = t_goodput._goodput_curve(tspec, torch.from_numpy(acc), torch)
    np.testing.assert_array_equal(tks.numpy(), np.asarray(rks))
    np.testing.assert_allclose(tg.numpy(), np.asarray(rg), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        tks[torch.argmax(tg, dim=-1)].numpy(),
        np.asarray(rks[jnp.argmax(rg, axis=-1)]))
    # the host path is the same numpy code: bit-equal curve and SL
    for a in (0.0, 1e-3, 0.5, 0.7, 0.999, 1.0):
        _, rh = r_goodput._goodput_curve(rspec, np.array([a], np.float32), np)
        _, th = t_goodput._goodput_curve(tspec, np.array([a], np.float32), np)
        assert th.dtype == rh.dtype and np.array_equal(th, rh)
    for a in (0.05, 0.7, 0.999):
        s = dict(kw, goodput_init_acc=a)
        assert (t_goodput._initial_sl_host(TSpec(**s))
                == r_goodput._initial_sl_host(SpecDecodeConfig(**s)))


def test_argmax_takes_the_first_maximum_in_both_array_modules():
    """Ties in the goodput curve resolve to the smallest k in the port
    (torch) as in the reference (jnp) and on the host (numpy)."""
    g = np.array([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0],
                  [0.0, 1.0, 2.0, 2.0]], np.float32)
    want = [1, 0, 2]
    assert torch.argmax(torch.from_numpy(g), dim=-1).tolist() == want
    assert np.asarray(jnp.argmax(jnp.asarray(g), axis=-1)).tolist() == want
    assert np.argmax(g, axis=-1).tolist() == want
    assert t_goodput.resolved_draft_cost(TSpec()) == \
        r_goodput.resolved_draft_cost(SpecDecodeConfig()) == \
        t_goodput.FALLBACK_DRAFT_COST
    assert t_goodput.resolved_draft_cost(TSpec(goodput_draft_cost=0.3)) == 0.3


# ---------------------------------------------------------------------------
# host side: contexts, tightness, the slo pick, the latency model
# ---------------------------------------------------------------------------

TRUE_THETA = np.array([2e-3, 1e-5, 5e-4, 2e-4])


def _synthetic_rounds(n, seed, theta=TRUE_THETA, noise=1e-5):
    rng = np.random.RandomState(seed)
    recs = []
    for _ in range(n):
        k, b = int(rng.randint(0, 9)), int(rng.randint(1, 9))
        pf = float(rng.randint(0, 3) * rng.randint(0, 65))
        wall = (1.0 * theta[0] + pf * theta[1] + k * theta[2]
                + (k + 1) * b * theta[3] + rng.randn() * noise)
        recs.append({"wall_s": max(wall, 0.0), "k": k, "b_eff": b,
                     "prefill_tokens": pf})
    return recs


def _contexts(seed, n=40, b=5):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        sl = rng.randint(0, 11, size=b)
        active = rng.rand(b) > 0.25
        dl = rng.choice([np.inf, -0.5, 0.0, 1e-4, 0.02, 0.3, 2.0, 60.0],
                        size=b) * rng.uniform(0.5, 1.5, size=b)
        tok = rng.randint(0, 40, size=b)
        yield sl, active, dl, tok


def test_host_context_and_batch_tightness_match_reference():
    for sl, active, dl, tok in _contexts(23):
        for deadlines, tokens in ((dl, tok), (dl, None), (None, None)):
            r = RCtx(sl_next=sl, active=active, deadline_remaining_s=deadlines,
                     tokens_remaining=tokens)
            t = TCtx(sl_next=sl, active=active, deadline_remaining_s=deadlines,
                     tokens_remaining=tokens)
            assert t.has_deadlines() == r.has_deadlines()
            assert t.tightest_deadline_s() == r.tightest_deadline_s()
            for k in range(0, 11):
                assert t_tightness(t, k) == r_tightness(r, k)
    t = TCtx.from_arrays(np.array([3, 5]))
    assert t.active.all() and not t.has_deadlines()
    assert t.round_ordinal == 0 and t.latency_model is None


def _fitted_pair(recs):
    rlm, tlm = RLM(), TLM()
    assert tlm.warm_start_from_rounds(recs) == rlm.warm_start_from_rounds(recs)
    return rlm, tlm


def test_latency_model_matches_reference():
    recs = _synthetic_rounds(64, seed=1)
    rlm, tlm = _fitted_pair(recs + [{"foo": 1}, {"wall_s": 0.1}])
    assert tlm.rounds_fit == rlm.rounds_fit == 64
    np.testing.assert_allclose(tlm.theta, rlm.theta, rtol=0, atol=ATOL)
    np.testing.assert_allclose(tlm.P, rlm.P, rtol=1e-9)
    assert tlm.rmse_s() == pytest.approx(rlm.rmse_s(), abs=ATOL)
    assert tlm.ready() and rlm.ready()
    for tokens in (0, 7, 300):
        assert tlm.predict_prefill_s(tokens) == pytest.approx(
            rlm.predict_prefill_s(tokens), abs=ATOL)
    for k, b, pf in ((0, 1, 0.0), (5, 3, 40.0), (10, 8, 0.0)):
        assert tlm.predict_round_s(k, b, pf) == pytest.approx(
            rlm.predict_round_s(k, b, pf), abs=ATOL)
    # online updates continue from the calibration, equally
    for r in _synthetic_rounds(5, seed=2):
        e1 = tlm.observe(r["wall_s"], r["k"], r["b_eff"], r["prefill_tokens"])
        e2 = rlm.observe(r["wall_s"], r["k"], r["b_eff"], r["prefill_tokens"])
        assert e1 == pytest.approx(e2, abs=ATOL)
    assert tlm.summary_fields().keys() == rlm.summary_fields().keys()
    for key, v in rlm.summary_fields().items():
        assert tlm.summary_fields()[key] == pytest.approx(v, abs=ATOL)
    # the readiness gate, record by record
    rlm, tlm = RLM(min_rounds=8), TLM(min_rounds=8)
    assert tlm.warm_start_from_rounds([]) == 0
    for r in _synthetic_rounds(9, seed=3):
        assert tlm.ready() == rlm.ready()
        rlm.observe(r["wall_s"], r["k"], r["b_eff"], r["prefill_tokens"])
        tlm.observe(r["wall_s"], r["k"], r["b_eff"], r["prefill_tokens"])
    assert tlm.ready() and tlm.min_rounds == 8


def test_slo_pick_bucket_matches_reference():
    """A fitted model (round cost 0.01 s a draft position), tight, loose,
    lapsed and absent deadlines; an unfitted model leaves DSDE's pick."""
    rng = np.random.RandomState(3)
    recs = []
    for _ in range(32):
        k, b = int(rng.randint(0, 9)), int(rng.randint(1, 5))
        recs.append({"wall_s": 0.01 * k + 0.002 * b, "k": k, "b_eff": b,
                     "prefill_tokens": 0.0})
    rlm, tlm = _fitted_pair(recs)
    kw = dict(policy="slo", sl_min=1)
    rpol, tpol = r_build_policy(SpecDecodeConfig(**kw)), t_build_policy(TSpec(**kw))
    picks = set()
    for sl, active, dl, tok in _contexts(29, n=60):
        for deadlines in (dl, None):
            for (rm, tm) in ((rlm, tlm), (RLM(), TLM())):
                r_ctx = RCtx(sl_next=sl, active=active,
                             deadline_remaining_s=deadlines,
                             tokens_remaining=tok, latency_model=rm)
                t_ctx = TCtx(sl_next=sl, active=active,
                             deadline_remaining_s=deadlines,
                             tokens_remaining=tok, latency_model=tm)
                k = tpol.pick_bucket(t_ctx)
                assert k == rpol.pick_bucket(r_ctx)
                picks.add((deadlines is None, rm is rlm,
                           k < rpol.pick_bucket(RCtx(sl_next=sl,
                                                     active=active))))
    # the fitted model with deadlines shrank some picks and left others
    assert (False, True, True) in picks and (False, True, False) in picks
    # never shrinks without deadlines or with a cold model
    assert (True, True, True) not in picks and (False, False, True) not in picks


def test_positional_form_warns_and_equals_the_context_form():
    pol = t_build_policy(TSpec(policy="dsde"))
    sl, act = np.array([3, 7, 2]), np.array([True, False, True])
    with pytest.warns(DeprecationWarning):
        k = pol.pick_bucket(sl, act)  # speclint: disable=JX008 (shim test)
    assert k == pol.pick_bucket(TCtx.from_arrays(sl, act)) == 3
    with pytest.warns(DeprecationWarning):
        la = pol.lookahead(sl)  # speclint: disable=JX008 (shim test)
    np.testing.assert_array_equal(la, pol.lookahead(TCtx.from_arrays(sl)))
    with pytest.raises(TypeError):
        pol.pick_bucket(TCtx.from_arrays(sl), act)  # speclint: disable=JX008 (shim test)


# ---------------------------------------------------------------------------
# requests and the admission gate
# ---------------------------------------------------------------------------

def test_request_slo_methods_match_reference():
    for cls, state in ((Request, RState), (TRequest, TState)):
        r = cls(0, prompt=[1], max_new_tokens=4, slo_deadline_s=1.0)
        assert r.slo_attained() is None
        assert r.deadline_remaining_s(now=r.arrival_time + 0.25) == 0.75
        r.state = state.FINISHED
        r.first_token_time = r.arrival_time + 0.1
        r.output = [5, 6, 7]
        r.finish_time = r.arrival_time + 0.5
        assert r.slo_attained() is True
        assert r.tpot() == pytest.approx(0.2)
        assert r.slo_attained(slo_tpot_s=0.1) is False
        assert r.slo_attained(slo_ttft_s=0.05) is False
        r.finish_time = r.arrival_time + 2.0
        assert r.slo_attained() is False
        free = cls(1, prompt=[1])
        assert free.deadline_remaining_s() is None
        free.state = state.REJECTED
        assert free.slo_attained() is False


def _gate_lm(lm_cls, round_cost):
    lm = lm_cls()
    lm.warm_start_from_rounds([{"wall_s": round_cost, "k": k % 4,
                                "b_eff": 1 + k % 2, "prefill_tokens": 0.0}
                               for k in range(16)])
    return lm


# (request id, deadline or None, priority, readmit) queues, batch size,
# defer limit, round cost: the reference's gate cases (tests/test_slo.py)
# and a seeded mixed queue
GATE_CASES = {
    "defer-then-admit": ([(0, 0.05, 0, False), (1, None, 0, False)], 2, 4, 10.0),
    "limit-0": ([(0, 0.05, 0, False), (1, None, 0, False)], 1, 0, 10.0),
    "priority": ([(2, 0.05, 1, False), (3, None, 0, False)], 1, 4, 10.0),
    "no-model": ([(0, 0.05, 0, False), (1, None, 0, False)], 2, 4, None),
    "mixed": ([(i, d, p, ra) for i, (d, p, ra) in enumerate(
        [(None, 0, True), (0.05, 0, True), (0.05, 0, False), (60.0, 1, False),
         (0.05, 2, False), (None, 0, False), (0.05, 0, False),
         (60.0, 0, False), (0.05, 1, False), (None, 2, False)])], 3, 2, 0.05),
}


def _gate_run(case, sched_cls, req_cls, spec_cls, serving_cls, lm_cls):
    queue, batch, limit, cost = GATE_CASES[case]
    sched = sched_cls(serving_cls(max_batch_size=batch, max_seq_len=64,
                                  slo_defer_limit=limit),
                      spec_cls(policy="dsde"))
    if cost is not None:
        sched.latency_model = _gate_lm(lm_cls, cost)
    reqs = {}
    for rid, deadline, prio, readmit in queue:
        r = req_cls(rid, prompt=[1] * 4, max_new_tokens=16,
                    slo_deadline_s=deadline, priority=prio)
        if readmit:
            r.preemptions = 1
        reqs[rid] = r
        sched.submit(r)
    waves = []
    while sched.queue:
        admitted = sched.admit()
        waves.append([r.request_id for r in admitted])
        for r in admitted:             # free the slots for the next wave
            sched.release(r)
    return (waves, [r.request_id for r in sched.pop_slo_risk()],
            {i: (r.slo_predicted_violation, r.slo_deferrals)
             for i, r in reqs.items()},
            sched.slo_predicted_violations, sched.slo_deferrals_total,
            [r.request_id for r in sched.pop_rejected()],
            sched.predict_completion_s(reqs[queue[0][0]]) is None)


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_admission_gate_matches_reference(case):
    want = _gate_run(case, LookaheadScheduler, Request, SpecDecodeConfig,
                     ServingConfig, RLM)
    got = _gate_run(case, TScheduler, TRequest, TSpec, TServing, TLM)
    assert got == want
    if case == "defer-then-admit":
        assert got[0] == [[1, 0]] and got[3:5] == (1, 1)
    if case == "mixed":
        # deferrals, a readmit never gated, and a wave of flagged
        # requests admitted in order once nothing feasible waits
        assert got[4] > 0 and not got[2][1][0]
        assert any(all(got[2][i][0] for i in wave) for wave in got[0])


def test_readmit_fifo_assert_matches_reference():
    for sched_cls, req_cls, serving_cls, spec_cls in (
            (LookaheadScheduler, Request, ServingConfig, SpecDecodeConfig),
            (TScheduler, TRequest, TServing, TSpec)):
        sched = sched_cls(serving_cls(max_batch_size=1, max_seq_len=64),
                          spec_cls())
        fresh, readmit = req_cls(0, prompt=[1]), req_cls(1, prompt=[1])
        readmit.preemptions = 1
        sched.submit(fresh)
        sched.submit(readmit)
        with pytest.raises(AssertionError, match="starvation"):
            sched.admit()


def test_scheduler_host_context_matches_reference():
    now = 1000.0
    ctxs = []
    for sched_cls, req_cls, serving_cls, spec_cls, lm in (
            (LookaheadScheduler, Request, ServingConfig, SpecDecodeConfig,
             RLM()), (TScheduler, TRequest, TServing, TSpec, TLM())):
        sched = sched_cls(serving_cls(max_batch_size=4, max_seq_len=64),
                          spec_cls(policy="slo"))
        sched.latency_model = lm
        for i, dl in enumerate((None, 2.5, 0.5)):
            r = req_cls(i, prompt=[1, 2], max_new_tokens=10 + i,
                        slo_deadline_s=dl, arrival_time=now - 1.0)
            r.output = [7] * i
            sched.submit(r)
        sched.admit()
        ctxs.append(sched.host_context(np.array([2, 3, 4, 5]),
                                       round_ordinal=7, now=now))
    r, t = ctxs
    for key in ("sl_next", "active", "deadline_remaining_s",
                "tokens_remaining"):
        np.testing.assert_array_equal(getattr(t, key), getattr(r, key))
    assert t.round_ordinal == r.round_ordinal == 7
    assert isinstance(t.latency_model, TLM)


# ---------------------------------------------------------------------------
# the self drafter's construction and cost
# ---------------------------------------------------------------------------

def test_self_drafter_cost_and_config_errors_match_reference():
    rcfg = get_config("smollm-135m")
    tcfg = t_get_config("smollm-135m")
    for n in (1, 4, 29):
        r = r_build_drafter(SpecDecodeConfig(drafter="self",
                                             self_draft_layers=n), rcfg)
        t = t_build_drafter(TSpec(drafter="self", self_draft_layers=n), tcfg)
        assert t.step_cost() == pytest.approx(r.step_cost(), rel=1e-12)
        assert 0.0 < t.step_cost() < 1.0
        assert not t.uses_draft_model() and not t.mirrors_kv()
    for n in (0, tcfg.num_layers):
        for build, spec_cls, cfg in ((r_build_drafter, SpecDecodeConfig, rcfg),
                                     (t_build_drafter, TSpec, tcfg)):
            with pytest.raises(ValueError, match="self_draft_layers"):
                build(spec_cls(drafter="self", self_draft_layers=n), cfg)
    ssm = TModel(name="x", family="ssm", num_layers=2, d_model=64,
                 num_heads=2, num_kv_heads=2, d_ff=128, vocab_size=64)
    with pytest.raises(ValueError, match="family"):
        t_build_drafter(TSpec(drafter="self"), ssm)


# ---------------------------------------------------------------------------
# the engine at reduced width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """The reference's seeded pair at reduced width, carried across.  The
    draft's tied embedding is scaled x 8 so its distributions are sharp
    enough that the AdaEDL bound stops drafts partway (at x 1 every
    draft stops at step 0)."""
    cfg = get_config("smollm-135m").reduced()
    pt = init_params(model_specs(cfg), jax.random.PRNGKey(1), jnp.float32)
    noise = init_params(model_specs(cfg), jax.random.PRNGKey(7), jnp.float32)
    pd = jax.tree_util.tree_map(lambda a, b: a + 0.05 * b, pt, noise)
    pd = dict(pd, embed=pd["embed"] * 8.0)
    conv = lambda p: from_reference(jax.tree_util.tree_map(np.asarray, p),
                                    device="cpu")
    return cfg, pt, pd, t_get_config("smollm-135m").reduced(), conv(pt), conv(pd)


def _prompts(vocab, seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist() for n in lens]


def _port(pair, prompts, max_new, spec, **serving):
    """The port's run: (streams, summary, engine, per-round [k, SL after,
    proposals of each live row])."""
    _, _, _, tcfg, tpt, tpd = pair
    model = spec.get("drafter", "model") == "model"
    eng = TEngine(tpt, tcfg, tpd if model else None, tcfg if model else None,
                  TSpec(**spec), TServing(**serving), device="cpu")
    log, collect = [], eng.collect

    def record(rec):
        live = rec.out.live.numpy()
        log.append((rec.k, rec.sl_next.tolist(),
                    rec.out.num_proposed.numpy()[live].tolist()))
        return collect(rec)
    eng.collect = record
    reqs = [TRequest(i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    m = eng.run(reqs)
    return [r.output for r in reqs], m, eng, log


def _ref(pair, prompts, max_new, spec, **serving):
    cfg, pt, pd, _, _, _ = pair
    model = spec.get("drafter", "model") == "model"
    eng = ServingEngine(pt, cfg, pd if model else None,
                        cfg if model else None, SpecDecodeConfig(**spec),
                        ServingConfig(**serving))
    log, collect = [], eng.collect

    def record(rec):
        log.append(np.asarray(rec.sl_next).tolist())
        return collect(rec)
    eng.collect = record
    reqs = [Request(i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    m = eng.run(reqs)
    return [r.output for r in reqs], m, eng, log


POOL = dict(max_batch_size=2, max_seq_len=128, paged_kv=True)

# name: (spec, serving, prompt lengths, new tokens)
ENGINE_CASES = {
    "adaedl": (dict(policy="adaedl", adaedl_threshold=0.01), POOL,
               (7, 12, 5), 16),
    "goodput": (dict(policy="goodput"), POOL, (7, 12, 5), 16),
    "slo": (dict(policy="slo"), POOL, (7, 12, 5), 16),
    "goodput-ngram-int8": (dict(policy="goodput", drafter="ngram", ngram_n=1),
                           dict(POOL, kv_quant="int8"), (7, 12, 5), 16),
    # the self drafter keeps no draft KV, so the pool of 4 blocks doubles
    # to 8: one 64-token sequence, and two running ones preempt
    "self-pool-preempt": (dict(drafter="self"),
                          dict(POOL, max_seq_len=64, kv_block_size=8,
                               num_kv_blocks=4), (20, 18, 15), 24),
    "self-ring": (dict(drafter="self"), dict(max_batch_size=2, max_seq_len=128),
                  (7, 12, 5), 16),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_streams_and_summary_match_reference(pair, case):
    spec, serving, lens, max_new = ENGINE_CASES[case]
    prompts = _prompts(pair[0].vocab_size, 11, lens)
    out, m, eng, log = _port(pair, prompts, max_new, spec, **serving)
    rout, rm, reng, rlog = _ref(pair, prompts, max_new, spec, **serving)
    assert out == rout
    assert all(len(o) == max_new for o in out)
    assert [sl for _, sl, _ in log] == rlog
    assert [r["k"] for r in eng.round_log] == [r["k"] for r in reng.round_log]
    assert eng.spec.goodput_draft_cost == reng.spec.goodput_draft_cost == \
        eng.drafter.step_cost()
    _assert_summary_matches(m, rm)
    assert m["slo_attained_frac"] == 1.0 and m["slo_deferrals"] == 0
    assert m["latency_model_rounds_fit"] == m["rounds"]
    proposals = [p for _, _, ps in log for p in ps]
    if case == "adaedl":
        # the early stop cut some drafts partway through the bucket
        assert any(0 < p < 7 for p in proposals)
        assert {k for k, _, _ in log} == {7}
    if case.startswith("self"):
        assert m["draft_kv_blocks_peak"] == 0 and sum(proposals) > 0
    if case == "self-pool-preempt":
        assert m["preemptions"] >= 1


def test_int8_self_draft_raises_as_the_reference_does(pair):
    """The reference slices K/V but not the int8 pool's per-layer scales:
    its first round raises ValueError.  The port raises the same type
    when the engine is built."""
    cfg, pt, _, tcfg, tpt, _ = pair
    serving = dict(POOL, kv_quant="int8")
    eng = ServingEngine(pt, cfg, None, None, SpecDecodeConfig(drafter="self"),
                        ServingConfig(**serving))
    with pytest.raises(ValueError):
        eng.run([Request(0, prompt=[1, 2, 3, 4, 5], max_new_tokens=4)])
    with pytest.raises(ValueError, match="scales"):
        TEngine(tpt, tcfg, None, None, TSpec(drafter="self"),
                TServing(**serving), device="cpu")


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
@pytest.mark.parametrize("drafter", ["model", "ngram", "self"])
def test_slo_equals_dsde_without_deadlines(pair, drafter, pipelined):
    prompts = _prompts(pair[0].vocab_size, 7, (6, 9, 6))
    runs = {}
    for policy in ("dsde", "slo"):
        spec = dict(policy=policy, drafter=drafter,
                    ngram_n=1 if drafter == "ngram" else 3)
        runs[policy] = _port(pair, prompts, 10, spec, max_batch_size=2,
                             max_seq_len=128, pipelined=pipelined)
    (out, m, eng, log), (sout, sm, seng, slog) = runs["dsde"], runs["slo"]
    assert sout == out and slog == log
    assert [r["k"] for r in seng.round_log] == [r["k"] for r in eng.round_log]
    assert sm["slo_predicted_violations"] == sm["slo_deferrals"] == 0


def test_slo_engine_with_deadlines_and_an_injected_model(pair):
    """Deadlines and a warm-started model injected through the engine:
    the scheduler reads the same model, the hopeless requests are
    surfaced, every request finishes, and the tokens are the ones the
    deadline-free run emits (greedy streams do not depend on K)."""
    prompts = _prompts(pair[0].vocab_size, 7, (6, 9, 6, 8))
    want = _port(pair, prompts, 10, dict(policy="slo"), **POOL)[0]
    _, _, _, tcfg, tpt, tpd = pair
    lm = TLM()
    lm.warm_start_from_rounds(_synthetic_rounds(16, seed=4, theta=np.array(
        [0.5, 0.0, 0.05, 0.01])))
    eng = TEngine(tpt, tcfg, tpd, tcfg, TSpec(policy="slo"),
                  TServing(**POOL), device="cpu", latency_model=lm)
    assert eng.scheduler.latency_model is lm is eng.latency_model
    reqs = [TRequest(i, prompt=p, max_new_tokens=10,
                     slo_deadline_s=(0.05 if i % 2 else 60.0))
            for i, p in enumerate(prompts)]
    m = eng.run(reqs)
    assert [r.output for r in reqs] == want
    assert m["requests_finished"] == 4
    assert m["slo_predicted_violations"] == 2
    assert m["slo_requests_attained"] <= 2
    assert all(r.first_dispatch_time is not None for r in reqs)
    assert m["latency_model_rounds_fit"] == 16 + m["rounds"]
