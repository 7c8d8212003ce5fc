"""The reference's workload results on its untrained pair, each computed
once a test run (``_jax_caches.once_per_run``): for
``test_torch_workloads.py`` (:func:`serves`) ``benchmarks/common.serve``
over the dense ring and the paged pool and
``table3_latency_speedup.static_opt`` on the mixed prompts; for
``test_torch_loadgen.py`` (:func:`replay`) ``benchmarks/loadgen
.replay_at_zero`` on a bursty trace through the front-end
``examples/stream_serving.py`` builds.  The pair's params come back as
numpy trees, which ``models.weights.from_reference`` carries into the
port."""
import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from benchmarks import common, loadgen  # noqa: E402
from benchmarks.table3_latency_speedup import static_opt  # noqa: E402
from repro.core.config import ServingConfig, SpecDecodeConfig  # noqa: E402
from repro.serving.engine import ServingEngine  # noqa: E402
from repro.serving.frontend import ServingFrontend  # noqa: E402

# (policy, paged) of the greedy serve parity; small enough that the
# reference's compiles dominate
SERVES = [(policy, paged) for policy in ("dsde", "adaedl", "static")
          for paged in (False, True)]
SERVE_KW = dict(static_sl=4, max_new=10, batch=4, max_seq_len=128)
TRACE_KW = dict(rate_rps=4.0, process="bursty", seed=13, max_new_cap=6)
TRACE_N = 5
SUMMARY_KEYS = ("rounds", "draft_steps", "draft_steps_effective",
                "tokens_emitted", "mean_acceptance", "block_efficiency")


def serve_prompts():
    return (common.dataset("code").prompts(2, 12, seed=1)
            + common.dataset("dialogue").prompts(2, 12, seed=2))


def mixed_prompts():
    """table3's ``_mixed_prompts`` at one prompt a corpus."""
    out = []
    for name in common.DATASETS:
        out += common.dataset(name).prompts(1, 16, seed=3)
    return out


def frontend_engine(cfg_t, cfg_d, pt, pd):
    """``examples/stream_serving.py``'s engine: dsde, paged, pipelined."""
    return ServingEngine(pt, cfg_t, pd, cfg_d,
                         SpecDecodeConfig(policy="dsde", sf_normalize=True),
                         ServingConfig(max_batch_size=4, max_seq_len=256,
                                       paged_kv=True, kv_block_size=16,
                                       pipelined=True), seed=0)


def _summary(m):
    return {k: m[k] for k in SUMMARY_KEYS}


def _pair():
    cfg_t, cfg_d, pt, pd, ratio = common.untrained_pair()
    out = {"params": (jax.tree_util.tree_map(np.asarray, pt),
                      jax.tree_util.tree_map(np.asarray, pd)),
           "ratio": ratio}
    return (cfg_t, cfg_d, pt, pd, ratio), out


def serves():
    (cfg_t, cfg_d, pt, pd, ratio), out = _pair()
    out["serves"] = {}
    for policy, paged in SERVES:
        m, reqs, _ = common.serve(cfg_t, cfg_d, pt, pd, serve_prompts(),
                                  policy=policy, paged=paged, **SERVE_KW)
        out["serves"][policy, paged] = (_summary(m),
                                        [r.output for r in reqs],
                                        common.latency_units(m, ratio))
    sl, lu, m = static_opt(cfg_t, cfg_d, pt, pd, mixed_prompts(), ratio, 0.0)
    out["static_opt"] = (sl, lu, _summary(m))
    return out


def replay():
    (cfg_t, cfg_d, pt, pd, _), out = _pair()
    trace = loadgen.make_trace(TRACE_N, **TRACE_KW)
    fe = ServingFrontend(frontend_engine(cfg_t, cfg_d, pt, pd))
    rep = loadgen.replay_at_zero(fe, trace)
    out["replay_at_zero"] = (rep, [r.output for r in sorted(
        fe._done, key=lambda r: r.request_id)])
    return out
