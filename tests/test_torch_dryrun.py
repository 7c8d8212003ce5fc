"""The port's dry run (``repro_torch.launch``) against the reference's
(``repro.launch``): the rule tables, the model-FLOPs count, the trip
counts of the cost counter, the FLOPs of the lowered steps, and the
production combination smollm-135m x decode_32k on the 16 x 16 mesh.

The reference's rule tables are built on a stand-in mesh (axis names and
sizes, as ``tests/test_serving_mesh.py`` does), with its ``NamedSharding``
replaced by a holder of the spec: the specs are compared, normalised so
that ``('data',)`` and ``'data'`` (the jax 0.9.0 quirk behind the known
``test_serve_cache_shardings_layout_contract`` failure) and ``()`` and
None are equal.
"""
import dataclasses
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.config import INPUT_SHAPES as REF_SHAPES
from repro.core.config import InputShape as RefShape
from repro.launch import sharding as ref_sharding
from repro.launch import steps as ref_steps
from repro.launch.hlo_cost import HLOCost
from repro.models import cache as ref_cache
from repro.models import module as ref_module
from repro.models.transformer import model_specs as ref_model_specs

from repro_torch.configs import get_config, list_archs
from repro_torch.core.config import INPUT_SHAPES, InputShape
from repro_torch.core import cost_hooks
from repro_torch.launch import dryrun, op_cost, steps
from repro_torch.launch.mesh import (MeshShape, fake_world,
                                     make_mesh_from_shape, production_shape)
from repro_torch.launch.sharding import cache_shardings, leaf_spec, make_rules
from repro_torch.models import cache as cache_lib
from repro_torch.models.weights import param_leaves, param_shapes

from _jax_caches import one_torch_thread, release_jax_caches  # noqa: F401

MESHES = (False, True)            # 16 x 16, 2 x 16 x 16


class _RefMesh:
    """The reference's rule functions read ``axis_names`` and
    ``devices.shape`` alone."""

    def __init__(self, ms: MeshShape):
        self.axis_names = ms.axis_names
        self.devices = np.empty(ms.shape, dtype=object)


class _Held:
    """The reference's ``NamedSharding(mesh, spec)``: its spec (a leaf)."""

    def __init__(self, mesh, spec):
        self.spec = spec


def _norm(spec) -> tuple:
    out = []
    for part in tuple(spec):
        if isinstance(part, tuple):
            part = (None if not part else part[0] if len(part) == 1
                    else tuple(part))
        out.append(part)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.fixture
def held_shardings(monkeypatch):
    monkeypatch.setattr(ref_sharding, "NamedSharding", _Held)
    monkeypatch.setattr(ref_module, "NamedSharding", _Held)


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, _Held))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            _norm(v.spec) for path, v in flat}


def _max_len(shape) -> int:
    return shape.seq_len if shape.kind == "decode" else shape.seq_len + 16


ARCHS = list_archs()


@pytest.mark.parametrize("multi_pod", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rule_tables_match_reference(arch, multi_pod, held_shardings):
    """make_rules, param_shardings and cache_shardings give the
    reference's specs for every arch x shape on both meshes."""
    ms = production_shape(multi_pod)
    rmesh = _RefMesh(ms)
    for name, shape in INPUT_SHAPES.items():
        rshape = REF_SHAPES[name]
        rules = make_rules(ms, shape)
        rrules = ref_sharding.make_rules(rmesh, rshape)
        assert dataclasses.asdict(rules) == {
            k: (tuple(v) if isinstance(v, (tuple, list)) else v)
            for k, v in dataclasses.asdict(rrules).items()}
        cfg = steps.adapt_config(get_config(arch), shape)
        rcfg = ref_steps.adapt_config(ref_get_config(arch), rshape)
        port = {path: _norm(leaf_spec(leaf, ms, rules)) for path, leaf in
                param_leaves(param_shapes(cfg, steps.VOCAB_PAD))}
        ref = _ref_leaves(ref_module.param_shardings(
            ref_model_specs(rcfg, ref_steps.VOCAB_PAD), rmesh, rrules))
        assert port == ref, (name, {k: (port.get(k), ref.get(k))
                                    for k in set(port) | set(ref)
                                    if port.get(k) != ref.get(k)})
        b, n = shape.global_batch, _max_len(shape)
        enc = steps._enc_len(shape) if cfg.family == "audio" else None
        pc = cache_lib.cache_struct(cfg, b, n, torch.bfloat16, device="meta",
                                    enc_len=enc)
        rc = ref_cache.cache_struct(rcfg, b, n, jnp.bfloat16, enc_len=enc,
                                    abstract=True)
        assert {k: tuple(v.shape) for k, v in pc.items()} == \
            {k: tuple(v.shape) for k, v in rc.items()}
        got = {k: _norm(v.spec) for k, v in cache_shardings(pc, ms,
                                                            rules).items()}
        want = {k: _norm(v.spec) for k, v in ref_sharding.cache_shardings(
            rc, rmesh, rrules).items()}
        assert got == want, name


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        assert steps.model_flops(get_config(arch), shape) == \
            ref_steps.model_flops(ref_get_config(arch), REF_SHAPES[name])


# ---------------------------------------------------------------------------
# the counter's trip counts (the reference's hlo_cost cases)
# ---------------------------------------------------------------------------

def _matmuls(n: int, dim: int = 128):
    a = torch.empty(dim, dim)
    for _ in cost_hooks.trips(n):
        a = a @ a


def test_counter_trip_count():
    with op_cost.OpCounter() as c:
        _matmuls(7)
    assert c.flops == 7 * 2 * 128 ** 3


def test_counter_nested_trips():
    with op_cost.OpCounter() as c:
        a = torch.empty(64, 64)
        for _ in cost_hooks.trips(4):
            for _ in cost_hooks.trips(3):
                a = a @ a
    assert c.flops == 12 * 2 * 64 ** 3
    assert c.ops == 12


def test_counter_bytes_scale_with_trip_count():
    with op_cost.OpCounter() as c5:
        _matmuls(5)
    with op_cost.OpCounter() as c10:
        _matmuls(10)
    assert c10.bytes == 2 * c5.bytes == 10 * 3 * 128 * 128 * 4


def _one_card(arch, shape, weighted=True, layers=None, **kw):
    cfg = get_config(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    with dryrun._quiet(), fake_world(1):
        mesh = make_mesh_from_shape((1, 1), ("data", "model"))
        rules = make_rules(mesh, shape)
        return dryrun.measure(steps.adapt_config(cfg, shape), shape, mesh,
                              rules, weighted=weighted, **kw)


@pytest.mark.parametrize("arch,kind", [("granite-8b", "train_4k"),
                                       ("granite-8b", "decode_32k"),
                                       ("mamba2-130m", "train_4k")])
def test_weighted_count_equals_unrolled(arch, kind):
    """A reduced config of 5 layers and 4 microbatches: the weighted
    counter runs 2 of each and weights the second; every count but the
    op bookkeeping comes out as the fully unrolled run's."""
    shape = INPUT_SHAPES[kind]
    kw = dict(layers=5, batch=8, seq_len=32)
    w = _one_card(arch, shape, True, **kw)
    u = _one_card(arch, shape, False, **kw)
    assert w["flops"] == u["flops"] > 0
    assert w["bytes"] == u["bytes"]
    assert w["kernel_calls"] == u["kernel_calls"]
    assert w["collectives"] == u["collectives"]
    assert w["memory"]["argument_bytes"] == u["memory"]["argument_bytes"]
    assert w["memory"]["peak_bytes"] == pytest.approx(
        u["memory"]["peak_bytes"], rel=0.02)


# ---------------------------------------------------------------------------
# FLOPs of the steps against the reference's lowered programs (1 x 1)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("granite-8b", "granite-moe-3b-a800m", "mamba2-130m",
                "recurrentgemma-2b", "qwen2-vl-2b", "seamless-m4t-medium")
KINDS = {"train": ("train", 2, 32, ()), "prefill": ("prefill", 2, 48, ()),
         "decode": ("decode", 2, 64, ()),
         "verify": ("decode", 2, 64, ("verify",))}


def _ref_flops(arch, kind, batch, seq, opts) -> float:
    rshape = RefShape("small", seq, batch, kind)
    # jax 0.9's make_mesh types its axes Explicit, under which the
    # reference's steps (written for GSPMD's auto sharding) do not lower
    mesh = jax.sharding.Mesh(
        np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    # the FSDP rule (embed over data) makes the reference's train step
    # build a spec with 'data' twice on one device, which jax refuses
    # (DuplicateSpecError); on one device it changes no FLOP
    rules = dataclasses.replace(ref_sharding.make_rules(mesh, rshape),
                                embed=None)
    cfg = ref_get_config(arch).reduced()
    step, args, donate = ref_steps.make_step_and_specs(
        cfg, rshape, mesh, rules, opts=frozenset(opts))
    with mesh:
        hlo = jax.jit(step, donate_argnums=donate).lower(*args).compile()
    return HLOCost(hlo.as_text()).entry_cost()["flops"]


@pytest.mark.parametrize("which", list(KINDS))
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_step_flops_match_reference_hlo(arch, which):
    kind, batch, seq, opts = KINDS[which]
    want = _ref_flops(arch, kind, batch, seq, opts)
    shape = InputShape("small", seq, batch, kind)
    cfg = steps.adapt_config(get_config(arch).reduced(), shape)
    with dryrun._quiet(), fake_world(1):
        mesh = make_mesh_from_shape((1, 1), ("data", "model"))
        got = dryrun.measure(cfg, shape, mesh, make_rules(mesh, shape),
                             opts=frozenset(opts))["flops"]
    assert got == pytest.approx(want, rel=0.02), (got, want)


# ---------------------------------------------------------------------------
# the production mesh
# ---------------------------------------------------------------------------

def _shard_bytes(shape, spec, sizes, itemsize) -> int:
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    n = 1
    for d, p in zip(shape, parts):
        names = () if p is None else (p if isinstance(p, tuple) else (p,))
        n *= d // math.prod(sizes[a] for a in names)
    return n * itemsize


def test_production_decode_on_the_full_mesh(held_shardings):
    """smollm-135m x decode_32k on 16 x 16: under a minute, no real
    tensor over 1 MB, and per-device argument bytes equal to the shards
    of the reference's leaves under its shardings."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        rec = dryrun.dryrun_one("smollm-135m", "decode_32k", verbose=False)
    assert time.monotonic() - t0 < 60
    assert rec["status"] == "ok" and rec["devices"] == 256
    biggest = max((e.cpu_memory_usage for e in prof.events()), default=0)
    assert biggest < 2 ** 20, biggest

    ms = production_shape()
    sizes = dict(zip(ms.axis_names, ms.shape))
    rmesh = _RefMesh(ms)
    rshape = REF_SHAPES["decode_32k"]
    rules = ref_sharding.make_rules(rmesh, rshape)
    cfg = ref_get_config("smollm-135m")
    specs = ref_model_specs(cfg, ref_steps.VOCAB_PAD)
    held = ref_module.param_shardings(specs, rmesh, rules)
    leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, ref_module.Spec))
    hl = jax.tree_util.tree_leaves(held, is_leaf=lambda x: isinstance(x, _Held))
    want = sum(_shard_bytes(s.shape, h.spec, sizes, 2)
               for s, h in zip(leaves, hl))
    rc = ref_cache.cache_struct(cfg, rshape.global_batch, rshape.seq_len,
                                jnp.bfloat16, abstract=True)
    csh = ref_sharding.cache_shardings(rc, rmesh, rules)
    want += sum(_shard_bytes(v.shape, csh[k].spec, sizes,
                             jnp.dtype(v.dtype).itemsize)
                for k, v in rc.items())
    want += _shard_bytes((rshape.global_batch, 1), (tuple(rules.batch),),
                         sizes, 4)
    assert rec["memory"]["argument_bytes"] == want


def test_serving_tp_decode_collectives():
    """A dense decode on a (1, 4) mesh, heads and KV heads divisible by
    4, the ring unsplit along its slots: per layer two all-reduces of
    B x T x d (after wo and w_down), plus the vocab-parallel embedding's
    one, and one gather of the vocab-sharded last-position logits."""
    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              num_heads=8, num_kv_heads=4, head_dim=32,
                              num_layers=3)
    shape = InputShape("small", 64, 4, "decode")
    with dryrun._quiet(), fake_world(4):
        mesh = make_mesh_from_shape((1, 4), ("data", "model"))
        rules = make_rules(mesh, shape, cache_seq_axis=None)
        rec = dryrun.measure(cfg, shape, mesh, rules)
    b, t, d = 4, 1, cfg.d_model
    vp = cfg.padded_vocab(steps.VOCAB_PAD)
    assert rec["collectives"]["all-reduce"] == (2 * 3 + 1) * b * t * d * 2
    assert rec["collectives"]["all-gather"] == b * vp * 4
    assert rec["collectives"]["reduce-scatter"] == 0
    assert rec["collectives"]["all-to-all"] == 0
    assert rec["kernel_calls"] == {"ragged_verify_attention": 3}


@pytest.mark.parametrize("kind,opts", [("decode_32k", ()),
                                       ("decode_32k", ("verify",)),
                                       ("prefill_32k", ()),
                                       ("train_4k", ())])
def test_one_card_prediction_matches_a_real_run(kind, opts):
    """The one-card check of chip_smoke.py on the CPU at the reduced
    width: the 1 x 1 dry run's FLOPs equal FlopCounterMode's count of
    the same step run on real tensors (here the kernels' plain versions
    run, and their FLOPs are the shape-only formula's), its argument
    bytes the real tensors' bytes."""
    from torch.utils.flop_counter import FlopCounterMode
    rec, step = dryrun.one_card("smollm-135m", kind, batch=2, seq_len=32,
                                opts=frozenset(opts), reduced=True)
    args = steps.concrete_args(get_config("smollm-135m").reduced(),
                               INPUT_SHAPES[kind], batch=2, seq_len=32,
                               device="cpu", opts=frozenset(opts))
    seen = {}
    for t in jax.tree_util.tree_leaves(args):
        if isinstance(t, torch.Tensor):
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    assert rec["memory"]["argument_bytes"] == sum(seen.values())
    with FlopCounterMode(display=False) as fc:
        step(*args)
    assert fc.get_total_flops() == rec["flops"]
    calls = 1 if kind == "decode_32k" else 0
    assert rec["kernel_calls"] == ({"ragged_verify_attention": 2 * calls}
                                   if calls else {})


def _on_1x4(cfg, shape, **rules_kw):
    with dryrun._quiet(), fake_world(4):
        mesh = make_mesh_from_shape((1, 4), ("data", "model"))
        return dryrun.measure(cfg, shape, mesh,
                              make_rules(mesh, shape, **rules_kw))


def test_expert_parallel_runs_each_device_s_experts(monkeypatch):
    """--expert-parallel on (1, 4): each device holds one of the four
    experts whole and runs its dispatch rows alone; its expert FLOPs
    equal tensor parallelism's (four experts at a quarter of d_ff) and
    no expert weight is gathered."""
    from repro_torch.models import moe
    seen = []
    orig = moe._moe_local

    def spy(p, cfg, x, experts=None):
        seen.append((experts, tuple(p["w_gate"].shape)))
        return orig(p, cfg, x, experts)
    monkeypatch.setattr(moe, "_moe_local", spy)
    cfg = get_config("granite-moe-3b-a800m").reduced()
    shape = InputShape("small", 32, 4, "decode")
    tp = _on_1x4(cfg, shape)
    tp_seen, seen[:] = list(seen), []
    ep = _on_1x4(cfg, shape, expert_parallel=True)
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_d_ff
    assert tp_seen[0] == (None, (e, d, f // 4))
    assert seen[0] == ((0, 1), (1, d, f))
    assert ep["flops"] == tp["flops"] and ep["collectives"] == \
        tp["collectives"]


def test_sequence_split_cross_cache_merges_partials():
    """An encoder-decoder's decode on (1, 4), its cached cross K/V split
    along the frames over the model axis: the cross attention merges
    per-device partials (an all-reduce of [B, T, H, D + 2] fp32 a layer)
    instead of gathering the cache."""
    cfg = dataclasses.replace(get_config("seamless-m4t-medium").reduced(),
                              num_layers=3)
    shape = InputShape("small", 64, 4, "decode")
    rec = _on_1x4(cfg, shape)
    h, d = cfg.num_heads, cfg.resolved_head_dim
    cache_bytes = 2 * 3 * 4 * 64 * cfg.num_kv_heads * d * 2
    assert rec["collectives"]["all-gather"] < cache_bytes / 4
    # the self-attention ring's merge and the cross attention's, a layer
    assert rec["collectives"]["all-reduce"] >= 2 * 3 * 4.0 * 4 * 1 * h * (d + 2)


@pytest.mark.parametrize("form", ["embed", "cross_entropy", "attend", "moe",
                                  "ring_write"])
def test_stand_in_forms_refuse_real_tensors(form):
    """The forms that cost a step without computing it (a vocabulary or
    expert shard indexed from row 0, split keys' partials not merged, a
    slot-sharded ring write cut to size) raise on real tensors, outside
    the dry run's counter, instead of returning wrong values."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core import dtensor_ops
    if form == "ring_write":
        with pytest.raises(RuntimeError, match="dry run"):
            cache_lib._shard_rows(torch.arange(8), torch.zeros(2, 3, 1, 1))
        return
    with dryrun._quiet(), fake_world(4):
        mesh = make_mesh_from_shape((1, 4), ("data", "model"))

        def dt(x, *pl):
            return DTensor.from_local(x, mesh, pl, run_check=False)
        rep = dt(torch.zeros(2, 3, 4, 8), Replicate(), Replicate())
        with pytest.raises(RuntimeError, match="dry run"):
            if form == "embed":
                dtensor_ops.embed_sharded(
                    dt(torch.zeros(8, 16), Replicate(), Shard(0)),
                    dt(torch.zeros(2, 3, dtype=torch.int32), Replicate(),
                       Replicate()))
            elif form == "cross_entropy":
                dtensor_ops.cross_entropy_sharded(
                    dt(torch.zeros(2, 3, 8), Replicate(), Shard(2)),
                    torch.zeros(2, 3, dtype=torch.int32), 32, None,
                    lambda *a: None)
            elif form == "attend":
                dtensor_ops.attend_sharded(lambda q, k, v: q, rep, rep, rep)
            else:
                dtensor_ops.moe_apply_sharded({}, None, rep, None,
                                              lambda *a: None)
