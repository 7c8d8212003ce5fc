"""The port's serving engine against the reference's: greedy token
streams byte-identical on the paged pool (sync schedule, model drafter),
per-round SL predictions equal, including under forced preemption, and
the run summary's fields equal to the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config
from repro.core.config import ServingConfig, SpecDecodeConfig
from repro.models.module import init_params
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine
from repro.serving.request import Request
from repro_torch.configs import get_config as t_get_config
from repro_torch.core.config import ServingConfig as TServing
from repro_torch.core.config import SpecDecodeConfig as TSpec
from repro_torch.models.weights import from_reference
from repro_torch.serving.engine import ServingEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from _jax_caches import release_jax_caches  # noqa: F401  (autouse)

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


# the reference's summary keys whose features the port does not have yet:
# the prefix cache (ROADMAP A4)
LATER_KEYS = ("prefix_cache_", "cow_copies")
# timing fields, and the latency model's fit of them: only present and
# finite
TIMING_KEYS = ("wall_time_s", "throughput_tok_s", "mean_latency_s",
               "p95_latency_s", "ttft_mean_s", "ttft_p95_s",
               "queue_wait_mean_s", "host_blocked_s",
               "host_blocked_per_round_s", "slo_goodput_tok_s",
               "latency_model_c0", "latency_model_c_prefill",
               "latency_model_c_draft", "latency_model_c_verify",
               "latency_model_rounds_fit", "latency_model_rmse_s")
# counts, blocks and bytes: equal
COUNT_KEYS = ("rounds", "tokens_emitted", "requests_finished",
              "requests_rejected", "preemptions", "draft_steps",
              "draft_steps_effective", "drafter", "draft_step_cost",
              "kv_quant", "kv_blocks_peak", "kv_pool_blocks",
              "kv_block_bytes", "kv_pool_bytes", "kv_bytes_swept",
              "draft_kv_blocks_peak", "slo_requests_attained",
              "slo_predicted_violations", "slo_deferrals")
# ratios: within 1e-9
RATIO_KEYS = ("kv_pool_utilization_mean", "kv_pool_utilization_peak",
              "draft_cost_effective", "block_efficiency", "mean_acceptance",
              "batch_tokens_per_round", "slo_attained_frac")


def _assert_summary_matches(m, rm, counts=COUNT_KEYS, ratios=RATIO_KEYS):
    """The port's run summary ``m`` against the reference's ``rm``: every
    reference key but the later features' is there, ``counts`` equal,
    ``ratios`` within 1e-9, timing fields finite."""
    missing = sorted(k for k in rm if k not in m and not k.startswith(LATER_KEYS))
    assert not missing, missing
    for key in counts:
        assert m[key] == rm[key], (key, m[key], rm[key])
    for key in ratios:
        assert abs(m[key] - rm[key]) <= 1e-9, (key, m[key], rm[key])
    for key in TIMING_KEYS:
        assert np.isfinite(m[key]), (key, m[key])


def _record_sl(eng):
    """Per-round post-round SL predictions, captured at collect."""
    log, orig = [], eng.collect

    def collect(rec):
        log.append(np.asarray(rec.sl_next).tolist())
        return orig(rec)
    eng.collect = collect
    return log


def _serve(small_pair, policy, prompts, *, max_new=16, bs=16, nblocks=None,
           temperature=0.0, port_only=False, seed=0):
    cfg, pt, pd, tcfg, tpt, tpd = small_pair
    kw = dict(max_batch_size=2, max_seq_len=128, paged_kv=True,
              kv_block_size=bs, num_kv_blocks=nblocks)
    teng = TEngine(tpt, tcfg, tpd, tcfg,
                   TSpec(policy=policy, temperature=temperature),
                   TServing(**kw), seed=seed, device="cpu")
    tsl = _record_sl(teng)
    treqs = [TRequest(i, prompt=p, max_new_tokens=max_new)
             for i, p in enumerate(prompts)]
    tm = teng.run(treqs)
    port = ([r.output for r in treqs], tm, tsl, teng)
    if port_only:
        return port
    eng = ServingEngine(pt, cfg, pd, cfg, SpecDecodeConfig(policy=policy),
                        ServingConfig(**kw), seed=seed)
    sl = _record_sl(eng)
    reqs = [Request(i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    m = eng.run(reqs)
    return port, ([r.output for r in reqs], m, sl, eng)


def _prompts(cfg, seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in lens]


@pytest.mark.parametrize("policy", ["dsde", "static", "autoregressive"])
def test_greedy_streams_match_reference(small_pair, policy):
    prompts = _prompts(small_pair[0], 11, (7, 12, 5))
    (tout, tm, tsl, teng), (out, m, sl, eng) = _serve(small_pair, policy,
                                                      prompts)
    assert tout == out
    assert all(len(o) == 16 for o in tout)
    assert tsl == sl                    # the per-round SL sequence
    assert [r["k"] for r in teng.round_log] == [r["k"] for r in eng.round_log]
    for key in ("rounds", "tokens_emitted", "requests_finished",
                "draft_steps", "draft_steps_effective"):
        assert tm[key] == m[key], key
    _assert_summary_matches(tm, m)
    assert tm["draft_kv_blocks_peak"] == tm["kv_blocks_peak"] > 0
    assert tm["queue_wait_mean_s"] >= 0
    # the round log's fields too (kv_blocks_cached: the prefix cache's)
    missing = {k for k in eng.round_log[0] if k not in teng.round_log[0]
               and not k.startswith(LATER_KEYS)}
    assert missing == {"kv_blocks_cached"}, missing


def test_greedy_streams_match_reference_under_preemption(small_pair):
    """Pool pressure forces evict-and-requeue; recompute-on-readmit
    reproduces the reference's streams token for token."""
    prompts = _prompts(small_pair[0], 5, (30, 25, 20))
    (tout, tm, tsl, _), (out, m, sl, _) = _serve(
        small_pair, "dsde", prompts, max_new=40, bs=8, nblocks=16)
    assert tm["preemptions"] >= 1
    assert tm["preemptions"] == m["preemptions"]
    assert tm["requests_finished"] == 3
    assert tout == out
    assert tsl == sl


def test_sampled_streams_reproducible_from_seed(small_pair):
    """Temperature > 0: the identity-threaded counter RNG makes a run a
    pure function of its seed inside the port (the reference's threefry
    bits are not reproducible in torch)."""
    prompts = _prompts(small_pair[0], 3, (6, 9, 4))
    a = _serve(small_pair, "dsde", prompts, temperature=1.0, port_only=True)
    b = _serve(small_pair, "dsde", prompts, temperature=1.0, port_only=True)
    c = _serve(small_pair, "dsde", prompts, temperature=1.0, port_only=True,
               seed=1)
    assert a[0] == b[0]
    assert a[0] != c[0]
    vocab = small_pair[3].vocab_size
    assert all(0 <= t < vocab for o in a[0] for t in o)
