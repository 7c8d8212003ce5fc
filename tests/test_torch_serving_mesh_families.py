"""Every non-dense family on the port's ``(data, model)`` serving mesh
(``core/tp.py``), against the reference's single-device engine.

MoE (granite-moe), Mamba-2 (mamba2-130m), the RG-LRU hybrid
(recurrentgemma-2b at 4 layers: one (rec, rec, attn) group and a
recurrent tail), vlm (qwen2-vl-2b, its qkv biases drawn at random so
that their head cut matters) and audio (seamless-m4t-medium, served with
the reference engine's empty encoder context) at reduced width, each with
its own reduced ``draft()``; the MoE and vlm targets on the pool also
with prefix caching (two waves sharing a head, one fork copy-on-write).  One 2x2 world serves every family and one
1x4 world MoE and Mamba-2, whose model cuts differ most at 4 shards
(``tests/_mesh_worker.py``, one torch thread a rank); the reference's
streams (dsde x model, sync) and logits are computed meanwhile, most of
the streams by two processes of this file (``python
tests/test_torch_serving_mesh_families.py NAMES OUT``, ``REF_SPLIT``),
which draw their reference params themselves.

Greedy speculative decoding is exact, so every meshed stream must equal
the reference engine's.  An MoE call's expert capacity couples its rows:
on the 2x2 ring each data rank holds one row, gathers the call's rows
and routes all of them, and at least one call must drop a (token, slot)
pair for that coupling to be tested.  The rule tables hold each family's
parameter cut to the reference's ``param_shardings`` but for the two cuts
of the port's own (ROADMAP C): the Mamba-2 mixer's x | B | C leaves keep
this rank's x columns and all of B and C, and the RG-LRU block
replicates.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.config import ServingConfig as RServing
from repro.core.config import SpecDecodeConfig as RSpec
from repro.launch import sharding as ref_sharding
from repro.models import cache as ref_cache
from repro.models import module as ref_module
from repro.models.module import init_params as ref_init
from repro.models.transformer import build_cross_cache as ref_cross
from repro.models.transformer import commit as ref_commit
from repro.models.transformer import encode as ref_encode
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import model_specs
from repro.serving.engine import ServingEngine as REngine
from repro.serving.request import Request as RRequest

from repro_torch.configs import get_config
from repro_torch.core.config import ServingConfig, SpecDecodeConfig
from repro_torch.core.tp import MeshPlan, serve_rules
from repro_torch.launch import sharding
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import cache as cache_lib
from repro_torch.models.weights import (XBC_LEAVES, init_params,
                                        param_leaves, param_shapes,
                                        serve_cut, shard_params)
from repro_torch.serving.engine import ServingEngine
from _jax_caches import (one_torch_thread, once_per_run,  # noqa: F401
                         release_jax_caches)
from test_torch_serving_mesh import (WORLD_TIMEOUT_S, _finish_world, _norm,
                                     _start_world)

jax.config.update("jax_platform_name", "cpu")

# family -> (arch, overrides of its reduced config)
FAMILIES = {"moe": ("granite-moe-3b-a800m", {}),
            "ssm": ("mamba2-130m", {}),
            "hybrid": ("recurrentgemma-2b", {"num_layers": 4}),
            "vlm": ("qwen2-vl-2b", {}),
            "audio": ("seamless-m4t-medium", {})}
# serve -> (family, paged, drafter): the reference engine's streams
SERVES = {"moe-ring": ("moe", False, "model"),
          "moe-pool": ("moe", True, "model"),
          "ssm-ring": ("ssm", False, "model"),
          "ssm-ngram": ("ssm", False, "ngram"),
          "hybrid-pool": ("hybrid", True, "model"),
          "hybrid-ring": ("hybrid", False, "model"),
          "vlm-pool": ("vlm", True, "model"),
          "audio-ring": ("audio", False, "model")}
# mesh -> its serves (``hybrid-ring-pipe``: the ring, pipelined)
MESH_SERVES = {"2x2": tuple(SERVES) + ("hybrid-ring-pipe",),
               "1x4": ("moe-ring", "moe-pool", "ssm-ring")}
# warm serve -> family: prefix caching on the pool (dsde x model, sync,
# over WAVES), in the 2x2 world
WARM_SERVES = {"moe-pool-warm": "moe", "vlm-pool-warm": "vlm"}
# the reference engines' serves, split between this process (the first)
# and two of this file (each engine compiles its rounds and prefills:
# 9-15 s on one core)
REF_SPLIT = (("moe-ring", "ssm-ring"),
             ("hybrid-pool", "hybrid-ring", "vlm-pool", "moe-pool-warm"),
             ("audio-ring", "moe-pool", "ssm-ngram", "vlm-pool-warm"))
# mesh -> its forward cases: (family, paged)
MESH_FORWARDS = {"2x2": (("moe", False), ("moe", True), ("ssm", False),
                         ("hybrid", False), ("hybrid", True),
                         ("vlm", True), ("audio", False)),
                 "1x4": (("moe", False), ("ssm", False))}
NEW, BS, MAXLEN, ENC_LEN = 12, 16, 128, 6
ATOL = 1e-4


def _ref_cfg(family, draft=False):
    arch, over = FAMILIES[family]
    cfg = ref_get_config(arch).reduced()
    return cfg.draft() if draft else dataclasses.replace(cfg, **over)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_params(family):
    """(target, draft) reference params as numpy trees: the target from
    key 1 (a vlm's qkv biases drawn at random), the draft from key 2."""
    pt = _numpy(ref_init(model_specs(_ref_cfg(family)), jax.random.PRNGKey(1),
                         jnp.float32))
    if family == "vlm":
        rng = np.random.RandomState(1)
        for name in ("bq", "bk", "bv"):
            a = pt["layers"]["attn"][name]
            pt["layers"]["attn"][name] = (0.3 * rng.randn(*a.shape)
                                          ).astype(np.float32)
    pd = _numpy(ref_init(model_specs(_ref_cfg(family, True)),
                         jax.random.PRNGKey(2), jnp.float32))
    return pt, pd


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, 512, size=n).tolist() for n in (9, 14, 6)]


def _tokens():
    return [p[:5] for p in _prompts()[:2]]


def _waves():
    """A warm serve's two waves: the first seeds a 32-token head (two
    blocks), the second hits it (a continuation, the head alone, whose
    last block forks copy-on-write, a cold outlier)."""
    rng = np.random.RandomState(13)
    head = rng.randint(0, 512, size=32).tolist()
    return ([head + rng.randint(0, 512, size=6).tolist()],
            [head + rng.randint(0, 512, size=5).tolist(), list(head),
             rng.randint(0, 512, size=9).tolist()])


def _family(name):
    return WARM_SERVES.get(name) or SERVES[name][0]


# a reference config whose ``source`` is this marker commits through
# :func:`_masked_ref_commit` (the reference processes install it)
MASKED = "commit re-advance write-masked"


def _masked_ref_commit(params, cfg, tokens, snapshot, verified, n_committed):
    """The reference's ``commit`` with its re-advance's K/V writes kept to
    the accepted positions (the port's rule), for configs marked
    :data:`MASKED`; the reference's own otherwise.  The reference writes
    all T positions: on the hybrid pool a slot freed by a finished
    request keeps its table row, and its re-advance writes through it
    into blocks given since to another request (ROADMAP C;
    ``tests/test_torch_recurrent.py`` holds the same)."""
    if cfg.source != MASKED:
        return ref_commit(params, cfg, tokens, snapshot, verified,
                          n_committed)
    new_len = snapshot["length"] + n_committed.astype(jnp.int32)
    acc = jnp.arange(tokens.shape[1])[None] < n_committed[:, None]
    _, adv, _ = ref_forward(params, cfg, tokens, cache=snapshot,
                            mode="decode", update_mask=acc.astype(jnp.float32),
                            write_mask=acc)
    return ref_cache.commit_length(adv, new_len)


def _ref_streams(family, paged, drafter, pt, pd):
    """The reference engine's greedy streams (dsde, sync, batch 2); a
    hybrid pool's commits write-masked (:data:`MASKED`)."""
    from repro.core import spec_decode as ref_sd
    from repro.core.drafters import model as ref_dm
    model = drafter == "model"
    mark = dict(source=MASKED) if family == "hybrid" and paged else {}
    saved = ref_sd.commit, ref_dm.commit_model
    ref_sd.commit = ref_dm.commit_model = _masked_ref_commit
    eng = REngine(pt, dataclasses.replace(_ref_cfg(family), **mark),
                  pd if model else None,
                  (dataclasses.replace(_ref_cfg(family, True), **mark)
                   if model else None),
                  RSpec(drafter=drafter, ngram_n=1),
                  RServing(max_batch_size=2, max_seq_len=MAXLEN,
                           paged_kv=paged, kv_block_size=BS))
    reqs = [RRequest(i, prompt=p, max_new_tokens=NEW)
            for i, p in enumerate(_prompts())]
    try:
        eng.run(reqs)
    finally:
        ref_sd.commit, ref_dm.commit_model = saved
    return [r.output for r in reqs]


def _ref_warm(family, pt, pd):
    """The reference engine's prefix-cached serve of :func:`_waves` (dsde
    x model, sync, batch 2, the pool): streams and prefix-cache totals."""
    eng = REngine(pt, _ref_cfg(family), pd, _ref_cfg(family, True),
                  RSpec(drafter="model"),
                  RServing(max_batch_size=2, max_seq_len=MAXLEN,
                           paged_kv=True, kv_block_size=BS,
                           prefix_caching=True))
    reqs = []
    for j, wave in enumerate(_waves()):
        rs = [RRequest(100 * j + i, prompt=list(p), max_new_tokens=NEW)
              for i, p in enumerate(wave)]
        m = eng.run(rs)
        reqs += rs
    return {"streams": [r.output for r in reqs],
            "prefix": {"hit_blocks": m["prefix_cache_hit_blocks"],
                       "cow_copies": m["cow_copies"],
                       "hit_rate": m["prefix_cache_hit_rate"],
                       "tokens": eng.scheduler.prefix_tokens_total,
                       "hit_tokens": eng.scheduler.prefix_hit_tokens_total}}


def _ref_result(name, pt, pd):
    """A reference serve of ``name``: :func:`_ref_warm` for a warm serve,
    else :func:`_ref_streams`."""
    if name in WARM_SERVES:
        return _ref_warm(WARM_SERVES[name], pt, pd)
    return _ref_streams(*SERVES[name], pt, pd)


def _audio_context(pt):
    """Seeded frames, the reference's encoder output over them and its
    cross K/V ``[L, B, S, KV, D]`` (numpy)."""
    cfg = _ref_cfg("audio")
    frames = (np.random.RandomState(7).randn(2, ENC_LEN, cfg.d_model) * 0.3
              ).astype(np.float32)
    renc = ref_encode(pt, cfg, jnp.asarray(frames))
    rk, rv = ref_cross(pt, cfg, renc)
    return {"frames": frames, "renc": np.asarray(renc), "rk": np.asarray(rk),
            "rv": np.asarray(rv)}


# the reference's forward, jitted: one program a call shape
REF_FORWARD_JIT = jax.jit(ref_forward, static_argnames=("cfg", "mode"))


def _ref_logits(family, pt, ctx=None):
    """The reference's prefill over the first 4 tokens and one decode
    step on its dense ring (each call jitted): (prefill logits, decode
    logits)."""
    cfg = _ref_cfg(family)
    fwd = REF_FORWARD_JIT
    toks = jnp.asarray(_tokens(), jnp.int32)
    cache = ref_cache.cache_struct(cfg, 2, MAXLEN, jnp.float32,
                                   enc_len=ENC_LEN if ctx else None)
    if ctx:
        cache = dict(cache, cross_k=jnp.asarray(ctx["rk"]),
                     cross_v=jnp.asarray(ctx["rv"]),
                     enc_valid=jnp.ones((2, ENC_LEN), bool))
    lp, cache, _ = fwd(pt, cfg=cfg, tokens=toks[:, :-1], cache=cache,
                       mode="prefill")
    cache = dict(cache, length=jnp.full((2,), toks.shape[1] - 1, jnp.int32))
    ld, _, _ = fwd(pt, cfg=cfg, tokens=toks[:, -1:], cache=cache,
                   mode="decode")
    return np.asarray(lp), np.asarray(ld)


def _cases(mesh, ctx):
    cases = []
    for name in MESH_SERVES[mesh]:
        family, paged, drafter = SERVES[name.replace("-pipe", "")]
        cases.append(dict(name=name, config=family, draft_config=family + "-d",
                          target=family, draft=family + "-d", paged=paged,
                          drafter=drafter, ngram_n=1, prompts=_prompts(),
                          max_new=NEW, bs=BS, max_seq=MAXLEN,
                          pipelined=name.endswith("-pipe"),
                          drops=family == "moe",
                          digest=name == "hybrid-pool"))
    if mesh == "2x2":
        for name, family in WARM_SERVES.items():
            cases.append(dict(name=name, config=family,
                              draft_config=family + "-d", target=family,
                              draft=family + "-d", paged=True, caching=True,
                              batches=_waves(), max_new=NEW, bs=BS,
                              max_seq=MAXLEN, digest=True))
    for family, paged in MESH_FORWARDS[mesh]:
        cases.append(dict(name=f"forward-{family}-{paged}", kind="forward",
                          config=family, target=family, batch=2, paged=paged,
                          tokens=_tokens(),
                          **(ctx if family == "audio" else {})))
    return cases


def _start_reference(names, tmp: Path):
    """One process of this file computing the reference engine's streams
    of the serves ``names``."""
    tmp.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).parents[1] / "src"))
    log = open(tmp / "log.txt", "w")
    return (subprocess.Popen([sys.executable, __file__, ",".join(names),
                              str(tmp / "out.pt")], env=env, stdout=log,
                             stderr=log), log)


def _finish_reference(started, tmp: Path, deadline: float) -> dict:
    proc, log = started
    try:
        proc.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    finally:
        log.close()
    if proc.returncode:
        raise RuntimeError("reference streams failed:\n"
                           + (tmp / "log.txt").read_text()[-3000:])
    return torch.load(tmp / "out.pt", weights_only=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results ({mesh: [rank results]}), the reference's
    streams and logits, computed while the worlds run, once for the whole
    test run (``once_per_run``)."""
    def compute():
        base = tmp_path_factory.mktemp("mesh-families")
        others = [_start_reference(names, base / f"ref{i}")
                  for i, names in enumerate(REF_SPLIT[1:])]
        params, configs = {}, {}
        for family, (arch, over) in FAMILIES.items():
            params[family], params[family + "-d"] = _ref_params(family)
            configs[family] = dict(arch=arch, **over)
            configs[family + "-d"] = dict(draft_of=arch)
        ctx = _audio_context(params["audio"])
        started = {}
        for mesh in MESH_SERVES:
            job = dict(mesh=mesh, configs=configs, params=params,
                       cases=_cases(mesh, ctx))
            started[mesh] = _start_world(mesh, job, base / mesh)
        deadline = time.monotonic() + WORLD_TIMEOUT_S
        try:
            logits = {family: _ref_logits(
                family, params[family], ctx if family == "audio" else None)
                for family in FAMILIES}
            ref = {name: _ref_result(name, params[_family(name)],
                                     params[_family(name) + "-d"])
                   for name in REF_SPLIT[0]}
            for i, other in enumerate(others):
                ref.update(_finish_reference(other, base / f"ref{i}",
                                             deadline))
        finally:
            for proc, log in others:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()
            results = {mesh: _finish_world(procs, base / mesh)
                       for mesh, procs in started.items()}
        return results, ref, logits, ctx
    return once_per_run(tmp_path_factory, "torch-serving-mesh-families-runs",
                        compute)


def _streams(results, mesh, name):
    """The case's streams, required equal on every rank."""
    per_rank = [r[name]["streams"] for r in results[mesh]]
    assert all(s == per_rank[0] for s in per_rank), (mesh, name, per_rank)
    return per_rank[0]


# ---------------------------------------------------------------------------
# Streams (the worlds)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,name", [(m, n) for m, names in
                                       MESH_SERVES.items() for n in names
                                       if not n.endswith("-pipe")])
def test_meshed_streams_equal_the_reference_engines(runs, mesh, name):
    results, ref, _, _ = runs
    assert results[mesh][0][name]["finished"] == 3, (mesh, name)
    assert _streams(results, mesh, name) == ref[name], (mesh, name)


@pytest.mark.parametrize("mesh", list(MESH_SERVES))
def test_moe_ring_drops_pairs_in_some_calls(runs, mesh):
    """The coupling is exercised: some call of the MoE ring serve drops a
    (token, slot) pair (on 2x2 each data rank holds one of the two rows,
    so its routing needs the gathered call), on every rank alike."""
    results, _, _, _ = runs
    drops = [r["moe-ring"]["drops"] for r in results[mesh]]
    assert all(d == drops[0] for d in drops)
    assert drops[0]["dropping"] >= 1 and drops[0]["calls"] > 0


def test_hybrid_ring_pipelined_equals_sync(runs):
    results, ref, _, _ = runs
    assert _streams(results, "2x2", "hybrid-ring-pipe") == \
        _streams(results, "2x2", "hybrid-ring") == ref["hybrid-ring"]


@pytest.mark.parametrize("name", list(WARM_SERVES))
def test_meshed_warm_serves_equal_the_reference_engines(runs, name):
    """Prefix caching on the 2x2 mesh for the MoE and vlm targets on the
    pool: every rank's streams, hit blocks, COW copies (at least one)
    and prefix-token counts equal the reference engine's; the pools are
    bitwise equal across data ranks."""
    results, ref, _, _ = runs
    ranks = results["2x2"]
    assert _streams(results, "2x2", name) == ref[name]["streams"]
    for r in ranks:
        assert r[name]["prefix"] == ref[name]["prefix"], name
    assert ref[name]["prefix"]["hit_blocks"] > 0
    assert ref[name]["prefix"]["cow_copies"] >= 1
    for m in range(2):
        assert ranks[m][name]["pool_digest"] == \
            ranks[2 + m][name]["pool_digest"], (name, m)


def test_hybrid_pool_bitwise_equal_across_data_ranks(runs):
    """2x2: ranks (0, m) and (1, m) hold the same pool bytes; each data
    rank runs its own rows through the RG-LRU layers and gathers every
    row before the local-attention layer that writes the pool."""
    ranks = runs[0]["2x2"]
    for m in range(2):
        assert ranks[m]["hybrid-pool"]["pool_digest"] == \
            ranks[2 + m]["hybrid-pool"]["pool_digest"], m


@pytest.mark.parametrize("mesh,family,paged", [
    (m, f, p) for m, cases in MESH_FORWARDS.items() for f, p in cases])
def test_meshed_forward_logits_match_reference(runs, mesh, family, paged):
    """Prefill and one decode step on the mesh against the reference's
    on its dense ring (atol 1e-4), the same bits on every rank; an audio
    rank's ``encode`` and ``build_cross_cache`` on its shards against the
    reference's (atol 1e-4), decoding over the reference's cross K/V."""
    results, _, logits, ctx = runs
    outs = [r[f"forward-{family}-{paged}"] for r in results[mesh]]
    for o in outs[1:]:
        assert np.array_equal(o["prefill"], outs[0]["prefill"])
        assert np.array_equal(o["decode"], outs[0]["decode"])
    lp, ld = logits[family]
    np.testing.assert_allclose(outs[0]["prefill"], lp, atol=ATOL, rtol=0)
    np.testing.assert_allclose(outs[0]["decode"], ld, atol=ATOL, rtol=0)
    if family == "audio":
        d = int(mesh.split("x")[0])
        for r, o in enumerate(outs):
            rows = slice(r // (4 // d) * 2 // d, (r // (4 // d) + 1) * 2 // d)
            np.testing.assert_allclose(o["enc"], ctx["renc"][rows],
                                       atol=ATOL, rtol=0)
            np.testing.assert_allclose(o["cross_k"], o["cross_k_ref"],
                                       atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# Rule tables (no world)
# ---------------------------------------------------------------------------

class _FakeMesh:
    """A 2 x 2 or 1 x 4 stand-in for the reference's rule functions,
    which read the axis names and the device grid's shape alone."""
    axis_names = ("data", "model")

    def __init__(self, d, m):
        self.devices = type("D", (), {"shape": (d, m)})


class _Spec:
    """A reference spec as a leaf (a bare tuple would read as a subtree)."""
    def __init__(self, mesh, spec):
        self.spec = _norm(spec)


def _ref_param_specs(cfg, fake):
    """The reference's ``param_shardings`` specs on a fake mesh (its
    NamedSharding stood in by :class:`_Spec`), by key path."""
    with mock.patch.object(ref_module, "NamedSharding", _Spec):
        tree = ref_module.param_shardings(
            model_specs(cfg), fake, ref_sharding.serve_rules(fake, 4))
    return {path: leaf.spec for path, leaf in param_leaves(_tuples(tree))}


def _tuples(tree):
    """A reference tree with its lists as tuples (the port's trees)."""
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_tuples(v) for v in tree)
    return tree


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_param_cut_matches_reference_table(family, mesh, width):
    """Each leaf's cut equals the reference's ``param_shardings`` spec
    under the serve rules, with two exceptions of the port's own: the
    Mamba-2 mixer's x | B | C leaves (``wxbc``, ``conv_w``, ``conv_b``)
    keep this rank's x columns and all of B and C where the reference
    cuts the joint axis into contiguous ranges, and the RG-LRU leaves
    (the reference maps ``lru`` to *model*) replicate."""
    arch, over = FAMILIES[family]
    rcfg = ref_get_config(arch)
    cfg = get_config(arch)
    if width == "reduced":
        rcfg = dataclasses.replace(rcfg.reduced(), **over)
        cfg = dataclasses.replace(cfg.reduced(), **over)
    d, m = (int(x) for x in mesh.split("x"))
    ms = MeshShape(("data", "model"), (d, m))
    ref = _ref_param_specs(rcfg, _FakeMesh(d, m))
    shapes = dict(param_leaves(param_shapes(cfg)))
    assert ref.keys() == shapes.keys()
    excepted = 0
    for rank in range(d * m):
        plan = MeshPlan(ms, serve_rules(ms, 4))
        plan.data_rank, plan.model_rank = divmod(rank, m)
        for path, leaf in shapes.items():
            spec, cols = serve_cut(cfg, plan, path[-1], leaf)
            if family == "ssm" and path[-1] in XBC_LEAVES:
                di = cfg.ssm.expand * cfg.d_model
                n2 = 2 * cfg.ssm.state_size
                assert ref[path][-1] == "model" and spec == ()
                hl = di // m
                assert cols.tolist() == (list(range(plan.model_rank * hl,
                                                    (plan.model_rank + 1) * hl))
                                         + list(range(di, di + n2)))
                excepted += 1
            elif "lru" in leaf.axes:
                assert "model" in ref[path] and spec == () and cols is None
                excepted += 1
            else:
                assert cols is None and spec == ref[path], (path, spec,
                                                            ref[path])
    groups, tail = divmod(cfg.num_layers, 3)
    want = {"ssm": 3, "hybrid": 10 * (min(groups, 1) + tail)}.get(
        family, 0) * d * m
    assert excepted == want


@pytest.mark.parametrize("family", list(FAMILIES))
def test_seeded_shards_equal_cut_shards(family):
    """``init_params(plan=)`` draws exactly ``shard_params``'s cut of the
    whole draw on every rank of 2x2 (the x | B | C columns too)."""
    arch, over = FAMILIES[family]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    ms = MeshShape(("data", "model"), (2, 2))
    plan = MeshPlan(ms, serve_rules(ms, 4))
    whole = init_params(cfg, seed=2, device="cpu")
    for rank in range(4):
        plan.data_rank, plan.model_rank = divmod(rank, 2)
        drawn = dict(param_leaves(init_params(cfg, seed=2, device="cpu",
                                              plan=plan)))
        cut = dict(param_leaves(shard_params(whole, cfg, plan)))
        assert drawn.keys() == cut.keys()
        for k in drawn:
            assert torch.equal(drawn[k], cut[k]), (rank, k)


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_caches_hold_the_tables_local_shapes(family, mesh):
    """The engine's target and draft caches (the ring, and the pool where
    the family has one) hold the local shapes of the reference's
    ``serve_cache_shardings`` (recurrent rows and cross K/V over *data*,
    KV heads over *model* where they divide) but for the Mamba-2 state,
    whose SSD heads (``ssd``) and x channels (``conv``) this rank holds
    alone."""
    arch, over = FAMILIES[family]
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    d, m = (int(x) for x in mesh.split("x"))
    ms = MeshShape(("data", "model"), (d, m))
    plan = MeshPlan(ms, serve_rules(ms, 4))
    builds = [lambda p, c: cache_lib.cache_struct(c, 4, 64, plan=p)]
    if cache_lib.supports_paged(cfg):
        builds.append(lambda p, c: cache_lib.paged_cache_struct(
            c, 4, 64, 8, 16, plan=p))
    cut = 0
    for c in (cfg, cfg.draft()):
        for build in builds:
            whole, local = build(None, c), build(plan, c)
            table = sharding.serve_cache_shardings(whole, ms,
                                                   serve_rules(ms, 4))
            assert whole.keys() == local.keys() == table.keys()
            for k, t in whole.items():
                want = table[k].local_shape(tuple(t.shape))
                got = tuple(local[k].shape)
                if got != want:
                    assert c.family == "ssm" and k in ("ssd", "conv"), k
                    ax = 2 if k == "ssd" else 3
                    di = c.ssm.expand * c.d_model
                    keep = (di // c.ssm.head_dim // m if k == "ssd"
                            else di // m + 2 * c.ssm.state_size)
                    assert got[ax] == keep < want[ax]
                    assert got[:ax] + got[ax + 1:] == want[:ax] + want[ax + 1:]
                    cut += 1
    assert cut == (4 if family == "ssm" else 0)


def test_every_family_builds_a_meshed_engine():
    """A meshed engine of each family (and its own draft) comes up on a
    plan with no process group: no family refuses the mesh."""
    ms = MeshShape(("data", "model"), (1, 1))
    for family, (arch, over) in FAMILIES.items():
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        p = init_params(cfg, seed=0, device="cpu")
        pd = init_params(cfg.draft(), seed=0, device="cpu")
        eng = ServingEngine(p, cfg, pd, cfg.draft(), SpecDecodeConfig(),
                            ServingConfig(max_batch_size=2, max_seq_len=64),
                            device="cpu", mesh=MeshPlan(ms, serve_rules(ms, 2)))
        assert eng.mesh_plan is not None, family


if __name__ == "__main__":
    # python tests/test_torch_serving_mesh_families.py NAMES OUT: the
    # reference engine's streams of the serves NAMES (comma-separated;
    # ``_start_reference``)
    names = sys.argv[1].split(",")
    params = {f: _ref_params(f) for f in dict.fromkeys(
        _family(name) for name in names)}
    torch.save({name: _ref_result(name, *params[_family(name)])
                for name in names}, sys.argv[2])
