"""The port's serving engine on a ``(data, model)`` mesh (``core/tp.py``,
``launch/sharding.py``'s ``serve`` rules) against the reference
(``tests/test_serving_mesh.py``, whose identity runs need forced XLA
host devices).

Greedy speculative decoding is exact, so a meshed engine must emit the
target's greedy rollout for every policy x drafter, both KV layouts, both
schedules, the int8 pool and under forced preemption.  Each mesh (1x4,
2x2) is one world of spawned ranks on the CPU, meeting over a gloo
``FileStore`` (``tests/_mesh_worker.py``, one torch thread a rank), that
runs every case of the mesh and returns each rank's streams; the
reference's rollouts are computed here meanwhile (its ``forward`` under
``jax.jit``, one call a token).  The layout checks: the rule tables
against the reference's, the placement of params and state, a rank's KV
group when query heads split over KV heads that replicate (H 8 / KV 2 on
1x4), pools bitwise equal across data ranks, and a skewed clock on one
rank under the ``slo`` policy with deadlines.

The front door on the mesh: prefix caching (a block-aligned head shared
across waves, a partial hit, a full repeat that forks a block
copy-on-write, a cold outlier; forced preemption) against the
reference's one-card prefix-cached engine, computed here meanwhile, and
the rollout; the ``ServingFrontend`` (rank 0 leads, the other ranks
follow it) in replay and under its driver thread, and one streaming and
one non-streaming HTTP completion on rank 0, each equal to ``run()``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.config import ServingConfig as RServing
from repro.core.config import SpecDecodeConfig as RSpec
from repro.launch import sharding as ref_sharding
from repro.launch.mesh import make_mesh_from_shape as ref_mesh
from repro.models.module import init_params as ref_init_params
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine as REngine
from repro.serving.request import Request as RRequest

from repro_torch.configs import get_config
from repro_torch.core.config import ServingConfig, SpecDecodeConfig
from repro_torch.core.drafters import available_drafters
from repro_torch.core.policies import available_policies
from repro_torch.core.tp import MeshPlan, head_layout, serve_rules
from repro_torch.launch import sharding
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.weights import (from_reference, init_params,
                                        param_leaves, param_shapes,
                                        shard_params)
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.request import Request
from _jax_caches import (one_torch_thread, once_per_run,  # noqa: F401
                         release_jax_caches)

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
MESHES = ("1x4", "2x2")
ALL_POLICIES = tuple(available_policies())
ALL_DRAFTERS = tuple(available_drafters())
CELLS = ((False, False), (False, True), (True, False), (True, True))
# the uneven-KV shape: query heads split 2 a rank, KV heads replicate
HAZARD = {"num_heads": 8, "num_kv_heads": 2, "head_dim": 32}
# the cache's copy of the hazard shape's 2 KV heads, each stored twice
PAD = {"kv_head_pad": 4}
SKEW_S = 1000.0
WORLD_TIMEOUT_S = 600

# the prefix cache's waves (``tests/test_torch_prefix_cache.py``'s, ids
# below the reduced vocabulary): the first seeds a 40-token head, the
# second hits it (a continuation, the head's two full blocks alone, which
# forks the last one copy-on-write, a cold outlier); PREEMPT_WAVE's
# shared 24-token head under a pool of 16 blocks of 8
_RNG = np.random.RandomState(11)
SHARED = _RNG.randint(0, 500, size=40).tolist()
WAVES = ([SHARED + _RNG.randint(0, 500, size=6).tolist()],
         [SHARED + _RNG.randint(0, 500, size=5).tolist(), SHARED[:32],
          _RNG.randint(0, 500, size=9).tolist()])
PREEMPT_WAVE = [SHARED[:24] + _RNG.randint(0, 500, size=n).tolist()
                for n in (6, 3, 1)]
# the front-end's requests: one wave sharing a 32-token head
FRONT = [SHARED[:32] + _RNG.randint(0, 500, size=n).tolist()
         for n in (5, 9, 3, 7)]
HTTP_PROMPT = SHARED[:16] + _RNG.randint(0, 500, size=8).tolist()
# warm serve -> its settings (each also run unmeshed in the 1x4 world)
WARM = {"warm-model": dict(paged=True, caching=True, batches=WAVES),
        "warm-ngram-int8": dict(paged=True, caching=True, batches=WAVES,
                                drafter="ngram", kv_quant="int8"),
        "warm-preempt": dict(paged=True, caching=True,
                             batches=(PREEMPT_WAVE,), max_new=40, bs=8,
                             nblocks=16)}
# the fp32 warm serves' rollouts (``runs``' reference keys)
WARM_ROLLOUTS = {"warm-model": "waves", "warm-preempt": "preempt-wave"}
FRONT_MODES = {"replay": dict(mode="replay"),
               "threaded-sync": dict(mode="threaded"),
               "threaded-pipe": dict(mode="threaded", pipelined=True,
                                     skew={"1": SKEW_S})}


def _prompts(vocab, sizes=(7, 12, 5), seed=11):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, size=n).tolist() for n in sizes]


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(cfg, key_t, key_n):
    pt = ref_init_params(model_specs(cfg), jax.random.PRNGKey(key_t),
                         jnp.float32)
    noise = ref_init_params(model_specs(cfg), jax.random.PRNGKey(key_n),
                            jnp.float32)
    return pt, jax.tree_util.tree_map(lambda a, b: a + 0.05 * b, pt, noise)


def make_train_logits(cfg):
    """The reference's train-mode forward of ``cfg``, jitted: logits."""
    return jax.jit(lambda p, t: ref_forward(p, cfg, t, mode="train")[0])


def _rollouts(params, cfg, prompts, n):
    """The target's greedy rollout of each prompt (the reference test's
    ``greedy_rollout``, its forward jitted).  Every call runs at one
    length, the longest row's (right-padded: the forward is causal, so
    the padding changes no logit before it), so that one program
    serves them all."""
    fwd = make_train_logits(cfg)
    width = max(len(p) for p in prompts) + n
    out = []
    for prompt in prompts:
        toks = list(prompt)
        for _ in range(n):
            logits = fwd(params, jnp.asarray([toks + [0] * (width - len(toks))],
                                             jnp.int32))
            toks.append(int(jnp.argmax(logits[0, len(toks) - 1,
                                              :cfg.vocab_size])))
        out.append(toks[len(prompt):])
    return out


def _matrix_mesh(policy, drafter, i):
    """The reference's alternation: each (layout, schedule) cell of a
    policy x drafter on 1x4 or 2x2."""
    return MESHES[(ALL_POLICIES.index(policy) + ALL_DRAFTERS.index(drafter)
                   + i) % 2]


def _cases(mesh, prompts, preempt, skew_prompts):
    cases = []
    for policy in ALL_POLICIES:
        for drafter in ALL_DRAFTERS:
            for i, (paged, pipe) in enumerate(CELLS):
                if _matrix_mesh(policy, drafter, i) == mesh:
                    cases.append(dict(name=f"matrix-{policy}-{drafter}-{i}",
                                      policy=policy, drafter=drafter,
                                      paged=paged, pipelined=pipe,
                                      prompts=prompts))
    for i, (paged, pipe) in enumerate(CELLS):
        cases.append(dict(name=f"cross-{i}", paged=paged, pipelined=pipe,
                          prompts=prompts))
    cases.append(dict(name="preempt", paged=True, pipelined=True,
                      prompts=preempt, max_new=40, bs=8, nblocks=16))
    for drafter in ("model", "ngram"):
        int8 = dict(drafter=drafter, paged=True, kv_quant="int8",
                    prompts=prompts)
        cases.append(dict(name=f"int8-{drafter}", digest=True, **int8))
        cases.append(dict(name=f"int8-{drafter}-unmeshed", unmeshed=True,
                          **int8))
    cases.append(dict(name="pool-digest", paged=True, prompts=prompts,
                      digest=True))
    for paged in (False, True):
        cases.append(dict(name=f"forward-{paged}", kind="forward",
                          batch=2, paged=paged,
                          tokens=[p[:5] for p in prompts[:2]]))
        cases.append(dict(name=f"hazard-serve-{paged}", config="hazard",
                          target="hz", draft="hzd", paged=paged,
                          prompts=prompts))
        cases.append(dict(name=f"hazard-forward-{paged}", kind="forward",
                          config="hazard", target="hz", batch=2, paged=paged,
                          tokens=[p[:5] for p in prompts[:2]]))
        cases.append(dict(name=f"hazard-pad-forward-{paged}", kind="forward",
                          config="hazard-pad", target="hz", batch=2,
                          paged=paged, tokens=[p[:5] for p in prompts[:2]]))
    cases.append(dict(name="hazard-layout", kind="layout", config="hazard",
                      batch=4))
    cases.append(dict(name="place", policy="static", batch=4, paged=True,
                      prompts=prompts, shapes=True))
    cases.append(dict(name="place-ngram", policy="static", drafter="ngram",
                      batch=4, prompts=prompts, shapes=True))
    cases.append(dict(name="skew", policy="slo", prompts=skew_prompts,
                      deadlines=[0.05 if i % 2 else 60.0
                                 for i in range(len(skew_prompts))],
                      skew={"1": SKEW_S}))
    for name, kw in WARM.items():
        cases.append(dict(name=name, digest=True, **kw))
        if mesh == "1x4":         # one world serves the one-card twins
            cases.append(dict(name=f"{name}-unmeshed", unmeshed=True, **kw))
    if mesh == "1x4":             # the uneven-KV layout is 1x4's
        cases.append(dict(name="warm-hazard", config="hazard", target="hz",
                          draft="hzd", **WARM["warm-model"]))
    cases.append(dict(name="front-run", paged=True, caching=True,
                      prompts=FRONT))
    for name, kw in FRONT_MODES.items():
        cases.append(dict(name=f"front-{name}", kind="frontend", paged=True,
                          caching=True, prompts=FRONT, **kw))
    cases.append(dict(name="http", kind="http", paged=True, caching=True,
                      pipelined=True, prompt=HTTP_PROMPT))
    return cases


def _ref_warm(params, cfg, name):
    """The reference's one-card prefix-cached engine over a warm serve's
    waves (greedy): its streams and prefix-cache totals."""
    kw = WARM[name]
    model = kw.get("drafter", "model") == "model"
    eng = REngine(params["pt"], cfg, params["pd"] if model else None,
                  cfg if model else None,
                  RSpec(drafter=kw.get("drafter", "model"), temperature=0.0),
                  RServing(max_batch_size=2, max_seq_len=128, paged_kv=True,
                           kv_block_size=kw.get("bs", 16),
                           num_kv_blocks=kw.get("nblocks"),
                           kv_quant=kw.get("kv_quant", "none"),
                           prefix_caching=True), seed=0)
    reqs = []
    for j, batch in enumerate(kw["batches"]):
        rs = [RRequest(100 * j + i, prompt=list(p),
                       max_new_tokens=kw.get("max_new", 10))
              for i, p in enumerate(batch)]
        m = eng.run(rs)
        reqs += rs
    return {"streams": [r.output for r in reqs],
            "prefix": {"hit_blocks": m["prefix_cache_hit_blocks"],
                       "cow_copies": m["cow_copies"],
                       "hit_rate": m["prefix_cache_hit_rate"],
                       "tokens": eng.scheduler.prefix_tokens_total,
                       "hit_tokens": eng.scheduler.prefix_hit_tokens_total},
            "preemptions": m["preemptions"]}


def _start_world(mesh, job, tmp: Path):
    d, m = (int(x) for x in mesh.split("x"))
    n = d * m
    tmp.mkdir(parents=True, exist_ok=True)
    torch.save(job, tmp / "job.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    for r in range(n):
        err = open(tmp / f"err{r}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_mesh_worker.py"), str(r),
             str(n), str(tmp / "store"), str(tmp / "job.pt"),
             str(tmp / f"out{r}.pt")], env=env, stdout=err, stderr=err), err))
    return procs


def _finish_world(procs, tmp: Path):
    """Every rank's results, in rank order; a rank that fails (or a world
    past its time limit) stops the others and raises with its log."""
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        while any(p.poll() is None for p, _ in procs):
            bad = [r for r, (p, _) in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                raise RuntimeError(
                    f"mesh rank(s) {bad or 'timeout'} failed:\n" +
                    "\n".join((tmp / f"err{r}.txt").read_text()[-3000:]
                              for r in (bad or range(len(procs)))))
            time.sleep(0.2)
        bad = [r for r, (p, _) in enumerate(procs) if p.returncode]
        if bad:
            raise RuntimeError(
                f"mesh rank(s) {bad} failed:\n" +
                "\n".join((tmp / f"err{r}.txt").read_text()[-3000:]
                          for r in bad))
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    return [torch.load(tmp / f"out{r}.pt", weights_only=False)
            for r in range(len(procs))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results ({mesh: [rank results]}) and the reference's
    rollouts, computed while the worlds run, once for the whole test run
    (``once_per_run``)."""
    def compute():
        rcfg = ref_get_config("smollm-135m").reduced()
        hcfg = dataclasses.replace(rcfg, **HAZARD)
        pt, pd = _pair(rcfg, 1, 7)
        hz, hzd = _pair(hcfg, 3, 9)
        prompts = _prompts(rcfg.vocab_size)
        preempt = _prompts(rcfg.vocab_size, (30, 25, 20), seed=5)
        skew_prompts = prompts + prompts
        params = {"pt": _numpy(pt), "pd": _numpy(pd), "hz": _numpy(hz),
                  "hzd": _numpy(hzd)}
        base = tmp_path_factory.mktemp("mesh")
        started = {}
        for mesh in MESHES:
            job = dict(mesh=mesh, configs={"small": {}, "hazard": HAZARD,
                                           "hazard-pad": dict(HAZARD, **PAD)},
                       params=params,
                       cases=_cases(mesh, prompts, preempt, skew_prompts))
            started[mesh] = _start_world(mesh, job, base / mesh)
        try:
            ref = {"short": _rollouts(pt, rcfg, prompts, 10),
                   "preempt": _rollouts(pt, rcfg, preempt, 40),
                   "hazard": _rollouts(hz, hcfg, prompts, 10)}
            ref["skew"] = ref["short"] * 2
            waves = [p for w in WAVES for p in w]
            ref["waves"] = _rollouts(pt, rcfg, waves, 10)
            ref["hazard-waves"] = _rollouts(hz, hcfg, waves, 10)
            ref["preempt-wave"] = _rollouts(pt, rcfg, PREEMPT_WAVE, 40)
            ref["front"] = _rollouts(pt, rcfg, FRONT, 10)
            ref["http"] = _rollouts(pt, rcfg, [HTTP_PROMPT], 10)[0]
            ref["engine"] = {name: _ref_warm(params, rcfg, name)
                             for name in WARM}
            fwd = {}
            for name, (p, c) in {"small": (pt, rcfg),
                                 "hazard": (hz, hcfg)}.items():
                toks = jnp.asarray([q[:5] for q in prompts[:2]], jnp.int32)
                fwd[name] = np.asarray(
                    ref_forward(p, c, toks, mode="train")[0])
            ref["forward"] = fwd
        finally:
            results = {mesh: _finish_world(procs, base / mesh)
                       for mesh, procs in started.items()}
        return results, ref, params
    return once_per_run(tmp_path_factory, "torch-serving-mesh-runs", compute)


def _streams(results, mesh, name):
    """The case's streams, required equal on every rank (each rank runs
    the same host loop; a rank that parted would have deadlocked or
    emitted other tokens)."""
    per_rank = [r[name]["streams"] for r in results[mesh]]
    assert all(s == per_rank[0] for s in per_rank), (mesh, name, per_rank)
    return per_rank[0]


# ---------------------------------------------------------------------------
# Rule tables (no world)
# ---------------------------------------------------------------------------

class _FakeMesh:
    """The reference test's 2 x 4 stand-in: its rule functions read the
    axis names and the device grid's shape alone."""
    axis_names = ("data", "model")

    class devices:
        shape = (2, 4)


FAKE = MeshShape(("data", "model"), (2, 4))
ONE = MeshShape(("data", "model"), (1, 1))


def _norm(spec) -> tuple:
    """A spec with ``('data',)`` and ``'data'`` equal (jax 0.9.0 keeps
    the latter) and trailing Nones trimmed."""
    out = []
    for part in tuple(spec):
        if isinstance(part, tuple):
            part = (None if not part else part[0] if len(part) == 1
                    else tuple(part))
        out.append(part)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def test_serve_rules_and_kv_guard_match_reference():
    rmesh = ref_mesh((1, 1), ("data", "model"))
    for port_mesh, r_mesh, batch in ((ONE, rmesh, 8), (FAKE, _FakeMesh, 8),
                                     (FAKE, _FakeMesh, 7)):
        rules = sharding.serve_rules(port_mesh, batch)
        rr = ref_sharding.serve_rules(r_mesh, batch)
        assert dataclasses.asdict(rules) == {
            k: (tuple(v) if isinstance(v, (tuple, list)) else v)
            for k, v in dataclasses.asdict(rr).items()}
    assert sharding.serve_rules(FAKE, 7).batch == ()
    rules = sharding.serve_rules(ONE, 8)
    assert rules.embed is None and rules.cache_seq is None
    assert rules.batch == ("data",)
    rr = ref_sharding.serve_rules(rmesh, 8)
    for n in (1, 2, 3, 4, 8):
        assert (sharding.kv_head_axis(n, FAKE, rules)
                == ref_sharding.kv_head_axis(n, _FakeMesh, rr))
    assert sharding.kv_head_axis(2, FAKE, rules) is None
    assert sharding.kv_head_axis(8, FAKE, rules) == "model"


def _caches(np_mod):
    z = np_mod.zeros
    return {
        "paged": {"k": z((2, 8, 4, 1, 8)), "v": z((2, 8, 4, 1, 8)),
                  "kv_pos": z((8, 4), np.int32),
                  "block_table": z((4, 8), np.int32),
                  "length": z((4,), np.int32)},
        "int8": {"k": z((2, 8, 4, 4, 8), np.int8),
                 "v": z((2, 8, 4, 4, 8), np.int8),
                 "k_scale": z((2, 8, 4, 4)), "v_scale": z((2, 8, 4, 4)),
                 "kv_pos": z((8, 4), np.int32),
                 "block_table": z((4, 8), np.int32),
                 "length": z((4,), np.int32)},
        "dense": {"k": z((2, 4, 32, 1, 8)), "v": z((2, 4, 32, 1, 8)),
                  "kv_pos": z((4, 32), np.int32),
                  "length": z((4,), np.int32)},
        "ngram": {"tokens": z((4, 64), np.int32),
                  "length": z((4,), np.int32)},
        "ssm": {"ssd": z((2, 4, 8, 16, 32)), "conv": z((2, 4, 3, 576)),
                "length": z((4,), np.int32)},
        "hybrid-pool": {"k": z((1, 8, 4, 1, 8)), "v": z((1, 8, 4, 1, 8)),
                        "kv_pos": z((8, 4), np.int32),
                        "block_table": z((4, 8), np.int32),
                        "length": z((4,), np.int32),
                        "lru": z((2, 4, 64)), "conv": z((2, 4, 3, 64))},
        "hybrid-ring": {"k": z((1, 4, 32, 1, 8)), "v": z((1, 4, 32, 1, 8)),
                        "kv_pos": z((4, 32), np.int32),
                        "length": z((4,), np.int32),
                        "lru": z((2, 4, 64)), "conv": z((2, 4, 3, 64))},
        "audio": {"k": z((2, 4, 32, 4, 8)), "v": z((2, 4, 32, 4, 8)),
                  "kv_pos": z((4, 32), np.int32),
                  "length": z((4,), np.int32),
                  "cross_k": z((2, 4, 1, 4, 8)), "cross_v": z((2, 4, 1, 4, 8)),
                  "enc_valid": z((4, 1), bool)}}


@pytest.mark.parametrize("kind", ["paged", "int8", "dense", "ngram", "ssm",
                                  "hybrid-pool", "hybrid-ring", "audio"])
def test_serve_cache_shardings_match_reference(kind):
    """The port's table gives the reference's specs on a jax 1 x 1 mesh,
    and the reference test's layout contract on a 2 x 4 mesh: pools keep
    the block axis whole, control leaves replicate, dense rows, recurrent
    rows (on a hybrid pool too), cross K/V and the n-gram history split
    over data, KV heads over model where they divide."""
    rmesh = ref_mesh((1, 1), ("data", "model"))
    port = _caches(np)[kind]
    ref = _caches(jnp)[kind]
    got = {k: _norm(v.spec) for k, v in sharding.serve_cache_shardings(
        port, ONE, sharding.serve_rules(ONE, 4)).items()}
    want = {k: _norm(v.spec) for k, v in ref_sharding.serve_cache_shardings(
        ref, rmesh, ref_sharding.serve_rules(rmesh, 4)).items()}
    assert got == want
    sh = {k: _norm(v.spec) for k, v in sharding.serve_cache_shardings(
        port, FAKE, sharding.serve_rules(FAKE, 4)).items()}
    for leaf in ("kv_pos", "block_table", "length", "enc_valid"):
        assert sh.get(leaf, ()) == ()
    for leaf in ("ssd", "lru", "conv"):
        if leaf in port:
            assert sh[leaf] == (None, "data"), leaf
    if kind in ("paged", "hybrid-pool"):
        assert sh["k"] == ()                      # 1 KV head: replicated
    elif kind == "int8":
        assert sh["k"] == (None, None, None, "model")
        assert sh["k_scale"] == (None, None, None, "model")
    elif kind in ("dense", "hybrid-ring"):
        assert sh["k"] == (None, "data")
    elif kind == "audio":
        for leaf in ("k", "cross_k", "cross_v"):
            assert sh[leaf] == (None, "data", None, "model"), leaf
    elif kind == "ngram":
        assert sh["tokens"] == ("data",)


def test_round_state_shardings_cover_state():
    """The declared tree matches a RoundState leaf for leaf (an engine's,
    meshed or not: the tables read whole shapes)."""
    cfg = get_config("smollm-135m").reduced()
    p = init_params(cfg, seed=0, device="cpu")
    eng = ServingEngine(p, cfg, p, cfg, SpecDecodeConfig(),
                        ServingConfig(max_batch_size=2, max_seq_len=64),
                        device="cpu")
    sh = sharding.round_state_shardings(eng.state, FAKE,
                                        sharding.serve_rules(FAKE, 2))

    def leaves(state, spec):
        if isinstance(state, dict):
            assert set(state) == set(spec)
            return sum(leaves(state[k], spec[k]) for k in state)
        if isinstance(state, (tuple, list)):
            assert type(spec) is type(state) and len(spec) == len(state)
            return sum(leaves(a, b) for a, b in zip(state, spec))
        if state is None:
            assert spec is None
            return 0
        assert isinstance(spec, sharding.NamedSharding), (state, spec)
        return 1
    assert leaves(eng.state, sh) > 15
    assert _norm(sh.target_cache["k"].spec) == (None, "data")
    assert all(_norm(getattr(sh, f).spec) == () for f in
               ("pending", "sl_next", "seed", "round_idx", "done",
                "tokens_budget", "eos_id"))


@pytest.mark.parametrize("mesh", MESHES)
def test_param_shardings_match_reference_and_shards(mesh):
    """Under the serve rules the port's param table equals the
    reference's (tensor parallel over model, never data),
    ``init_params(plan=)`` draws exactly ``shard_params``'s shards, and
    each shard has the table's local shape."""
    cfg = get_config("smollm-135m").reduced()
    d, m = (int(x) for x in mesh.split("x"))
    ms = MeshShape(("data", "model"), (d, m))
    rules = serve_rules(ms, 4)
    plan = MeshPlan(ms, rules)
    table = dict(param_leaves(sharding.param_shardings(param_shapes(cfg), ms,
                                                       rules)))
    specs = {path: _norm(sh.spec) for path, sh in table.items()}
    axes = {a for s in specs.values() for a in s if a is not None}
    assert axes == {"model"}
    assert specs[("layers", "attn", "wq")] == (None, None, "model")
    assert specs[("layers", "attn", "wk")] == ()       # 1 KV head
    whole = init_params(cfg, seed=2, device="cpu")
    for rank in range(d * m):
        plan.data_rank, plan.model_rank = divmod(rank, m)
        drawn = dict(param_leaves(init_params(cfg, seed=2, device="cpu",
                                              plan=plan)))
        cut = dict(param_leaves(shard_params(whole, cfg, plan)))
        assert drawn.keys() == cut.keys() == table.keys()
        for k in drawn:
            assert torch.equal(drawn[k], cut[k]), (rank, k)
            assert tuple(cut[k].shape) == table[k].local_shape(
                tuple(dict(param_leaves(whole))[k].shape)), (rank, k)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("config", ["small", "hazard"])
def test_engine_caches_hold_the_tables_local_shapes(mesh, config):
    """The engine's caches (ring, fp32 pool, int8 pool with its scales,
    n-gram history) hold the local shapes of ``serve_cache_shardings``,
    the reference's layout, but for the KV-group cut: where query heads
    split over KV heads that replicate (H 8 / KV 2 on 1x4) the table
    keeps every KV head on a rank and the engine's cache the one its
    query heads read."""
    from repro_torch.core.drafters.ngram import NGramDrafter
    from repro_torch.models import cache as cache_lib
    cfg = get_config("smollm-135m").reduced()
    if config == "hazard":
        cfg = dataclasses.replace(cfg, **HAZARD)
    d, m = (int(x) for x in mesh.split("x"))
    ms = MeshShape(("data", "model"), (d, m))
    rules = serve_rules(ms, 4)
    plan = MeshPlan(ms, rules)
    ngram = NGramDrafter(SpecDecodeConfig(drafter="ngram"), cfg, None)
    builds = (
        lambda p: cache_lib.cache_struct(cfg, 4, 64, plan=p),
        lambda p: cache_lib.paged_cache_struct(cfg, 4, 64, 8, 16, plan=p),
        lambda p: cache_lib.paged_cache_struct(cfg, 4, 64, 8, 16,
                                               kv_quant="int8", plan=p),
        lambda p: ngram.init_cache(4, 64, plan=p))
    cut = 0
    for build in builds:
        whole, local = build(None), build(plan)
        table = sharding.serve_cache_shardings(whole, ms, rules)
        assert whole.keys() == local.keys() == table.keys()
        for k, t in whole.items():
            want = table[k].local_shape(tuple(t.shape))
            got = tuple(local[k].shape)
            if got != want:
                assert k in ("k", "v", "k_scale", "v_scale"), k
                assert got[:3] + got[4:] == want[:3] + want[4:]
                assert got[3] == plan.layout(cfg).cache_heads < want[3]
                cut += 1
    assert cut == (8 if (config, mesh) == ("hazard", "1x4") else 0)


def test_head_layout_of_the_uneven_kv_shape():
    """H 8 / KV 2 on a model axis of 4: KV heads replicate, query heads
    split 2 a rank, and rank r keeps KV head r // 2, the one its query
    heads read (padded to 4 in the cache: padded head r); a model axis
    of one splits nothing; heads that do not nest raise."""
    for m in range(4):
        lay = head_layout(m, 4, 8, 2, None, 512, 512)
        assert lay.heads and lay.cache_heads == 1
        assert lay.real_kv == slice(m // 2, m // 2 + 1)
        assert lay.cache_kv is None
    for m in range(4):      # padded to 4: rank r stores padded head r
        lay = head_layout(m, 4, 8, 2, 4, 512, 512)
        assert lay.heads and lay.cache_heads == 1
        assert lay.real_kv == slice(m // 2, m // 2 + 1)
        assert lay.cache_kv == slice(m % 2, m % 2 + 1)
    lay = head_layout(0, 1, 9, 3, None, 1536, 49280)   # 1 x 1: one card's
    assert not (lay.heads or lay.mlp or lay.vocab) and lay.cache_heads == 3
    lay = head_layout(1, 3, 9, 3, None, 1536, 49280)
    assert lay.cache_heads == 1 and lay.real_kv is None and not lay.vocab
    with pytest.raises(ValueError, match="KV heads"):
        head_layout(0, 3, 12, 4, None, 512, 512)


def test_prefix_caching_on_a_mesh_gated_like_one_card():
    """A meshed engine takes prefix caching where one card does: on the
    pool of an attention-only stack (an MoE target here), not on the
    dense ring, nor for a stack with recurrent state (the hybrid)."""
    plan = MeshPlan(FAKE, serve_rules(FAKE, 2))

    def engine(arch, paged, layers=None):
        cfg = get_config(arch).reduced()
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        p = init_params(cfg, seed=0, device="cpu")
        return ServingEngine(p, cfg, None, None,
                             SpecDecodeConfig(drafter="ngram"),
                             ServingConfig(max_batch_size=2, max_seq_len=64,
                                           paged_kv=paged,
                                           prefix_caching=True),
                             device="cpu", mesh=plan)
    eng = engine("granite-moe-3b-a800m", True)
    assert eng.prefix_caching and eng.scheduler.prefix_cache
    assert eng.mesh_plan is plan
    assert not engine("granite-moe-3b-a800m", False).prefix_caching
    assert not engine("recurrentgemma-2b", True, layers=4).prefix_caching


# ---------------------------------------------------------------------------
# Streams (the worlds)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipe"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_single_device_engine_matches_rollout(runs, paged, pipelined):
    """Anchor: the unmeshed port engine emits the same rollout."""
    _, ref, params = runs
    cfg = get_config("smollm-135m").reduced()
    conv = lambda k: from_reference(params[k], device="cpu")  # noqa: E731
    eng = ServingEngine(conv("pt"), cfg, conv("pd"), cfg, SpecDecodeConfig(),
                        ServingConfig(max_batch_size=2, max_seq_len=128,
                                      paged_kv=paged, pipelined=pipelined),
                        device="cpu")
    prompts = _prompts(cfg.vocab_size)
    reqs = [Request(i, prompt=p, max_new_tokens=10)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    assert [r.output for r in reqs] == ref["short"]


@pytest.mark.parametrize("drafter", ALL_DRAFTERS)
@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_mesh_identity_policy_drafter_matrix(runs, policy, drafter):
    results, ref, _ = runs
    for i in range(len(CELLS)):
        mesh = _matrix_mesh(policy, drafter, i)
        name = f"matrix-{policy}-{drafter}-{i}"
        assert results[mesh][0][name]["finished"] == 3, (mesh, name)
        assert _streams(results, mesh, name) == ref["short"], (mesh, name)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("cell", range(len(CELLS)),
                         ids=["dense-sync", "dense-pipe", "paged-sync",
                              "paged-pipe"])
def test_mesh_identity_full_cross_dsde_model(runs, mesh, cell):
    results, ref, _ = runs
    assert _streams(results, mesh, f"cross-{cell}") == ref["short"]


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_exact_under_forced_preemption(runs, mesh):
    """Pool pressure on a meshed engine: eviction wipes the victim's
    table row on every rank, readmission reprefills."""
    results, ref, _ = runs
    out = results[mesh][0]["preempt"]
    assert out["preemptions"] >= 1 and out["finished"] == 3
    assert _streams(results, mesh, "preempt") == ref["preempt"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("drafter", ["model", "ngram"])
def test_mesh_int8_pool(runs, mesh, drafter):
    """The int8 pool rounds K/V, so its streams are the unmeshed int8
    engine's (which ``tests/test_torch_kv_quant.py`` holds to the
    reference's int8 engine), not the fp32 rollout."""
    results, _, _ = runs
    assert _streams(results, mesh, f"int8-{drafter}") == \
        _streams(results, mesh, f"int8-{drafter}-unmeshed")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_meshed_forward_logits_match_reference(runs, mesh, paged):
    """Prefill and one decode step on the mesh against the reference's
    train-mode logits (atol 1e-4), the same bits on every rank; the
    hazard shape also with its KV heads padded in the cache (train mode
    has no cache, so its logits are the unpadded shape's)."""
    results, ref, _ = runs
    for cfg_name, case in (("small", f"forward-{paged}"),
                           ("hazard", f"hazard-forward-{paged}"),
                           ("hazard", f"hazard-pad-forward-{paged}")):
        outs = [r[case] for r in results[mesh]]
        for o in outs[1:]:
            assert np.array_equal(o["prefill"], outs[0]["prefill"])
            assert np.array_equal(o["decode"], outs[0]["decode"])
        want = ref["forward"][cfg_name]
        np.testing.assert_allclose(outs[0]["prefill"], want[:, :-1],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(outs[0]["decode"], want[:, -1:],
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("mesh", MESHES)
def test_uneven_kv_heads_serve_their_group(runs, mesh):
    """H 8 / KV 2: on 1x4 each rank keeps the KV head its two query heads
    read (ranks 0-1 head 0, ranks 2-3 head 1), on 2x2 both KV heads
    split; streams on the ring and the pool equal the rollout."""
    results, ref, _ = runs
    m = int(mesh.split("x")[1])
    for r, res in enumerate(results[mesh]):
        lay = res["hazard-layout"]
        mr = lay["model_rank"]
        assert mr == r % m and lay["wq"][2] == 8 // m
        assert lay["ring_k"][3] == lay["pool_k"][3] == 1
        if m == 4:
            assert lay["layout"]["real_kv"] == slice(mr // 2, mr // 2 + 1)
            assert lay["wk"][2] == 2                  # KV projections whole
    for paged in (False, True):
        assert _streams(results, mesh, f"hazard-serve-{paged}") \
            == ref["hazard"], paged


def test_pools_bitwise_equal_across_data_ranks(runs):
    """2x2: ranks (0, m) and (1, m) hold the same pool bytes (block
    tables address any block, so every data rank's pool is whole)."""
    results, _, _ = runs
    ranks = results["2x2"]
    for case in ("pool-digest", "int8-model", "int8-ngram"):
        for m in range(2):
            assert ranks[m][case]["pool_digest"] == \
                ranks[2 + m][case]["pool_digest"], (case, m)


def test_engine_places_params_and_state_on_mesh(runs):
    """2x2, batch 4 (the reference's placement test): params tensor
    parallel over model (halves of the query heads, MLP and vocab; the
    one KV head whole), the pool's block axis whole and its one KV head
    whole, tables and the [B] control leaves whole, the draft mirror laid
    out as the target pool; with the n-gram drafter the dense target
    ring and the token history split their rows over data."""
    results, _, _ = runs
    cfg = get_config("smollm-135m").reduced()
    vp = cfg.padded_vocab(128)
    for res in results["2x2"]:
        sh = res["place"]["shapes"]
        assert sh["pt"]["embed"] == (vp // 2, cfg.d_model)
        assert tuple(sh["pt"]["layers"]["attn"]["wq"]) == (
            cfg.num_layers, cfg.d_model, cfg.num_heads // 2, cfg.head_dim)
        assert tuple(sh["pt"]["layers"]["attn"]["wk"]) == (
            cfg.num_layers, cfg.d_model, 1, cfg.head_dim)
        assert tuple(sh["pt"]["layers"]["mlp"]["w_down"]) == (
            cfg.num_layers, cfg.d_ff // 2, cfg.d_model)
        tc = sh["target_cache"]
        assert tc["k"][3] == 1 and tc["k"][1] == tc["kv_pos"][0]
        assert tc["block_table"][0] == 4
        assert all(tuple(v) == (4,) for v in sh["control"].values())
        assert sh["draft_cache"]["k"] == tc["k"]
        ng = res["place-ngram"]["shapes"]
        assert ng["draft_cache"]["tokens"][0] == 2
        assert ng["draft_cache"]["length"] == (4,)
        assert ng["target_cache"]["k"][1] == 2
        assert ng["target_cache"]["kv_pos"][0] == 4
        assert res["place"]["finished"] == 3


def test_skewed_clock_on_one_rank_serves_alike(runs):
    """Rank 1's clock runs 1000 s ahead.  Every reading the engine and
    scheduler take is rank 0's, so under ``slo`` with deadlines every
    rank admits the same requests into the same slots, counts the same
    predicted violations, and emits the rollout."""
    results, ref, _ = runs
    for mesh in MESHES:
        ranks = [r["skew"] for r in results[mesh]]
        for key in ("admit_order", "slots", "slo_predicted_violations",
                    "slo_deferrals", "rounds"):
            assert all(r[key] == ranks[0][key] for r in ranks), (mesh, key)
        assert _streams(results, mesh, "skew") == ref["skew"]
        assert ranks[0]["counts"]["broadcast"] > 0


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", list(WARM))
def test_mesh_warm_serves_match_reference(runs, mesh, name):
    """Prefix caching on the mesh: every rank's streams, hit blocks, COW
    copies and prefix-token counts equal the reference's one-card
    prefix-cached engine and the port's own one-card engine, the fp32
    streams also the target's rollout; the aligned repeat forks a block,
    and the preempting serve preempts."""
    results, ref, _ = runs
    got = _streams(results, mesh, name)
    one = results["1x4"][0][f"{name}-unmeshed"]
    want = ref["engine"][name]
    assert got == one["streams"] == want["streams"]
    if name in WARM_ROLLOUTS:
        assert got == ref[WARM_ROLLOUTS[name]]
    for r in results[mesh]:
        assert r[name]["prefix"] == one["prefix"] == want["prefix"], name
        assert r[name]["preemptions"] == one["preemptions"]
    assert want["prefix"]["hit_blocks"] > 0
    if name == "warm-preempt":
        assert want["preemptions"] >= 1
    else:
        assert want["prefix"]["cow_copies"] >= 1


def test_mesh_warm_serve_of_the_uneven_kv_shape(runs):
    """H 8 / KV 2 on 1x4, where each rank keeps the KV head its query
    heads read: the warm waves' copy-on-write forks and tail prefills on
    the rank's own KV head emit the rollout, with the small shape's
    hits."""
    results, ref, _ = runs
    assert _streams(results, "1x4", "warm-hazard") == ref["hazard-waves"]
    assert results["1x4"][0]["warm-hazard"]["prefix"] == \
        results["1x4"][0]["warm-model"]["prefix"]


def test_warm_pools_bitwise_equal_across_data_ranks(runs):
    """2x2: after the warm serves (forks, tail prefills, preemption)
    ranks (0, m) and (1, m) hold the same pool bytes."""
    ranks = runs[0]["2x2"]
    for case in WARM:
        for m in range(2):
            assert ranks[m][case]["pool_digest"] == \
                ranks[2 + m][case]["pool_digest"], (case, m)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_dispatch_reads_nothing_on_the_host(runs, mesh):
    """Every rank's ``dispatch`` of the warm serves and the front-end's
    makes no host read of a tensor (the calls that would synchronise a
    card)."""
    results, _, _ = runs
    for r in results[mesh]:
        for case in list(WARM) + [f"front-{m}" for m in FRONT_MODES]:
            assert r[case]["dispatch_reads"] == 0, (mesh, case)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", list(FRONT_MODES))
def test_mesh_frontend_equals_run(runs, mesh, mode):
    """Rank 0's front-end (replay at arrival 0; its driver thread with
    staggered arrivals, synchronous and pipelined, rank 1's clock 1000 s
    ahead in the latter) emits the meshed ``run()``'s streams and the
    rollout, each token once and in order; every follower served the same
    streams, and the cache was hit (in replay as ``run()`` hit it;
    staggered arrivals hit blocks that one admission wave does not)."""
    results, ref, _ = runs
    name = f"front-{mode}"
    lead = results[mesh][0][name]
    run = results[mesh][0]["front-run"]
    assert lead["leader"] and lead["once_in_order"]
    assert lead["streams"] == run["streams"] == ref["front"]
    assert set(lead["finish_reasons"]) == {"length"}
    assert lead["summary"]["requests_finished"] == len(FRONT)
    hits = lead["summary"]["prefix_cache_hit_blocks"]
    assert hits > 0
    if mode == "replay":
        assert hits == run["prefix"]["hit_blocks"]
    for r in results[mesh][1:]:
        assert not r[name]["leader"]
        assert r[name]["streams"] == ref["front"], (mesh, mode)
    assert lead["counts"]["broadcast"] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_http_completions_equal_run(runs, mesh):
    """One non-streaming and one streaming completion through the HTTP
    server on rank 0 of the mesh equal the prompt's rollout."""
    results, ref, _ = runs
    out = results[mesh][0]["http"]
    assert out["leader"] and out["finish_reason"] == "length"
    assert out["plain"] == out["streamed"] == ref["http"]
    assert all(not r["http"]["leader"] for r in results[mesh][1:])


def test_launcher_serves_a_mesh_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 ... --demo --mesh 1x2 --device cpu``
    (gloo) exits 0, rank 0 printing the summary."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--standalone", "-m", "repro_torch.launch.serve",
         "--arch", "smollm-135m", "--demo", "--mesh", "1x2", "--device",
         "cpu", "--requests", "4", "--max-new", "8"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if "'mesh': '1x2'" in ln]
    assert len(lines) == 1 and "'requests_finished': 4" in lines[0]


@pytest.mark.parametrize("mode", [["--http-smoke"],
                                  ["--demo", "--prefix-share", "0.5"]],
                         ids=["http-smoke", "prefix-share"])
def test_launcher_serves_the_front_door_on_a_mesh(tmp_path, mode):
    """``torchrun --nproc-per-node 2 ... --mesh 1x2 --device cpu`` with
    ``--http-smoke`` (rank 0's server and front-end, rank 1 following;
    rank 0 prints the smoke test's JSON) and with ``--demo
    --prefix-share 0.5`` (the cache hit) exits 0 on every rank."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--standalone", "-m", "repro_torch.launch.serve",
         "--arch", "smollm-135m", "--mesh", "1x2", "--device", "cpu",
         *mode], env=env, cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    if mode[0] == "--http-smoke":
        lines = [ln for ln in out.stdout.splitlines()
                 if '"mesh": "1x2"' in ln]
        assert len(lines) == 1
        res = json.loads(lines[0])
        assert res["streamed_tokens"] == res["non_streaming_tokens"]
        assert len(res["streamed_tokens"]) == 8
        assert res["summary"]["requests_finished"] == 2
    else:
        lines = [ln for ln in out.stdout.splitlines()
                 if "'mesh': '1x2'" in ln]
        assert len(lines) == 1 and "'requests_finished': 8" in lines[0]
        hits = float(lines[0].split("'prefix_cache_hit_blocks': ")[1]
                     .split(",")[0])
        assert hits > 0
