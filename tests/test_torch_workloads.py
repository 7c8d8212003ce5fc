"""The port's paper-pipeline workloads (``repro_torch.workloads``) held to
the reference's ``benchmarks/common.py`` in one process: corpora and
configs equal, the pairs' cache, and greedy serves of the reference's
untrained pair (carried across with ``models.weights.from_reference``)
that emit the reference's streams, counters (exact) and rates (1e-6
relative)."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import _workload_refs as refs
from _jax_caches import once_per_run, one_torch_thread, release_jax_caches  # noqa: F401  (autouse)
from repro_torch import workloads
from repro_torch.models.weights import from_reference, param_leaves

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from benchmarks import common  # noqa: E402

RTOL = 1e-6
EXACT = ("rounds", "draft_steps", "draft_steps_effective", "tokens_emitted")
RATES = ("mean_acceptance", "block_efficiency")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return once_per_run(tmp_path_factory, "workload_refs", refs.serves)


@pytest.fixture(scope="module")
def pair(ref):
    pt, pd = (from_reference(p, device="cpu") for p in ref["params"])
    return workloads.target_config(), workloads.draft_config(), pt, pd


def _hold(summary, want):
    for k in EXACT:
        assert summary[k] == want[k], k
    for k in RATES:
        assert summary[k] == pytest.approx(want[k], rel=RTOL), k


# ---------------------------------------------------------------------------
# corpora and configs: equal to the reference's
# ---------------------------------------------------------------------------

def test_constants_equal_reference():
    assert workloads.VOCAB == common.VOCAB
    assert workloads.DATASETS == common.DATASETS
    assert list(workloads.DATASETS) == list(common.DATASETS)


@pytest.mark.parametrize("name", list(common.DATASETS))
def test_dataset_prompts_equal_reference(name):
    got, want = workloads.dataset(name), common.dataset(name)
    assert (got.seed, got.peakedness) == (want.seed, want.peakedness)
    for n, length, seed in ((3, 16, 0), (2, 12, 42), (1, 48, 1300)):
        assert (got.prompts(n, length, seed=seed)
                == want.prompts(n, length, seed=seed))


def test_mixed_stream_equal_reference():
    got = workloads.mixed_stream(total_per=2000)
    want = common.mixed_stream(total_per=2000)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("which", ["target", "draft", "draft-weak"])
def test_configs_equal_reference(which):
    if which == "target":
        got, want = workloads.target_config(), common.target_config()
    else:
        weak = which == "draft-weak"
        got, want = (workloads.draft_config(weak), common.draft_config(weak))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# the pairs and their cache
# ---------------------------------------------------------------------------

def test_train_cached_round_trip_and_retrain_on_mismatch(tmp_path,
                                                         monkeypatch, capsys):
    """A 3-step training is saved and restored without its stream being
    made again; a cached checkpoint of another architecture is trained
    over, as the reference does."""
    monkeypatch.setattr(workloads, "CACHE_DIR", str(tmp_path))
    stream = workloads.mixed_stream(total_per=400)
    made = []

    def data():
        made.append(1)
        return stream

    cfg = workloads.draft_config(weak=True)
    first = workloads._train_cached("t", cfg, data, 3, seed=4, device="cpu")
    assert made == [1]
    assert "[pair] trained t: steps=3 loss=" in capsys.readouterr().out
    again = workloads._train_cached("t", cfg, data, 3, seed=4, device="cpu")
    assert made == [1]
    for (k, a), (_, b) in zip(param_leaves(first), param_leaves(again)):
        assert torch.equal(a, b), k
    other = workloads.draft_config(weak=False)
    third = workloads._train_cached("t", other, data, 3, seed=4, device="cpu")
    assert made == [1, 1]
    assert third["embed"].shape[1] == other.d_model
    assert "[pair] trained t" in capsys.readouterr().out


def test_untrained_pair_and_regimes():
    cfg_t, cfg_d, pt, pd, ratio = workloads.untrained_pair(device="cpu")
    assert (cfg_t, cfg_d, ratio) == (workloads.target_config(),
                                     workloads.draft_config(), 0.1)
    assert pt["embed"].device.type == "cpu"
    with pytest.raises(ValueError):
        workloads.build_pair("vicuna", device="cpu")


# ---------------------------------------------------------------------------
# greedy serves of the reference's untrained pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,paged", refs.SERVES)
def test_serve_matches_reference(ref, pair, policy, paged):
    want, streams, lu = ref["serves"][policy, paged]
    m, reqs, eng = workloads.serve(*pair, refs.serve_prompts(), policy=policy,
                                   paged=paged, device="cpu", **refs.SERVE_KW)
    assert [r.output for r in reqs] == streams
    _hold(m, want)
    assert workloads.latency_units(m, ref["ratio"]) == pytest.approx(
        lu, rel=RTOL)
    assert eng.spec.sf_normalize


def test_serve_model_free_drafter_drops_the_draft(pair):
    _, _, eng = workloads.serve(*pair, refs.serve_prompts()[:1],
                                drafter="ngram", max_new=4, device="cpu")
    assert eng.pd is None and eng.cfg_d is None


def test_static_opt_matches_reference(ref, pair):
    sl, lu, want = ref["static_opt"]
    got = workloads.static_opt(*pair, refs.mixed_prompts(), ref["ratio"],
                               0.0, device="cpu")
    assert got[0] == sl
    assert got[1] == pytest.approx(lu, rel=RTOL)
    _hold(got[2], want)


@pytest.mark.parametrize("values,ps", [
    ([0.3, None, 1.2, 0.7, 2.5], (50, 99)),
    ([], (50, 99)),
    ([None, None], (99,)),
    (list(np.linspace(0.0, 1.0, 17)), (50, 90, 99)),
])
def test_dist_stats_equal_reference(values, ps):
    assert (workloads.dist_stats(values, "x", ps=ps)
            == common.dist_stats(values, "x", ps=ps))


@pytest.mark.parametrize("metrics", [
    {"rounds": 9, "draft_steps": 72, "draft_steps_effective": 9},
    {"rounds": 31, "draft_steps": 120},
])
def test_latency_units_equal_reference(metrics):
    for ratio in (0.014, 0.074, 0.1):
        assert (workloads.latency_units(metrics, ratio)
                == common.latency_units(metrics, ratio))
