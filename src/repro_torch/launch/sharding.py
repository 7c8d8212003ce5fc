"""Per-(workload x mesh) sharding rules of the port
(``repro.launch.sharding``): MaxText-style logical axes mapped to mesh
axes, then to DTensor placements.

The layouts (the reference's DESIGN.md §5):

* train    — FSDP: ``embed`` over *data*, ``mlp/heads/vocab`` over
             *model*, batch over (pod, data), sequence-parallel residual
             stream (seq over *model* between blocks);
* prefill  — serving TP: weights over *model* only (replicated over
             data), batch over (pod, data);
* decode   — serving TP; KV cache batch-sharded over (pod, data), its
             sequence axis over *model*;
* long decode (batch 1) — batch unshardable; caches replicated over data.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dim, None (replicated), a mesh axis name, or a tuple of names
(the dim split over all of them, the first outermost), trailing Nones
trimmed (:func:`canonical_spec`).  :class:`NamedSharding` pairs a spec
with its mesh; its :attr:`~NamedSharding.placements` are the DTensor
form (``Shard(dim)`` or ``Replicate()`` per mesh axis).  The rule
functions read only the mesh's axis names and sizes, so they take a
``DeviceMesh`` or a ``launch.mesh.MeshShape``.

The serving engine's rule set (the reference's ``serve_rules``,
``kv_head_axis``, ``serve_cache_shardings``, ``round_state_shardings``)
states the reference's layout of the live data plane on a ``(data,
model)`` mesh, leaf by leaf; the tests hold these tables to the
reference's.  The engine runs on plain local shards
(:class:`~repro_torch.core.tp.MeshPlan`): its parameters are cut by the
same guarded specs (:func:`leaf_spec`) but for the RG-LRU block, which
replicates, and the Mamba-2 mixer's x | B | C leaves, which keep a
rank's x columns and all of B and C (``models.weights.serve_cut``); its
caches hold the cache table's local shapes but for the KV-group cut of
``core.tp.HeadLayout`` (where query heads split over KV heads that
replicate, a rank keeps only the KV heads its query heads read) and the
Mamba-2 state, which holds the rank's SSD heads (ROADMAP C).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.config import InputShape, ShardingConfig
from repro_torch.core.tp import (axis_sizes, batch_axes, canonical_spec,
                                 guarded_spec)
from repro_torch.core.tp import serve_rules  # noqa: F401  (re-exported)
from repro_torch.core.tp import spec_names as _names
from repro_torch.models.weights import (Params, Spec, logical_to_pspec,
                                        map_params)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``);
    a leaf, not a tuple, so that parameter trees of them map leafwise."""
    mesh: Any
    spec: Tuple

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh axis: ``Shard(d)`` for the
        tensor dim ``d`` that the axis splits, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        sizes = axis_sizes(self.mesh)
        dim_of = {n: d for d, part in enumerate(self.spec)
                  if part is not None for n in _names(part)}
        # a split over an axis of one device is none (and DTensor would
        # refuse views across it)
        return tuple(Shard(dim_of[n]) if n in dim_of and sizes[n] > 1
                     else Replicate() for n in sizes)

    def placements_for(self, shape: Tuple[int, ...]) -> tuple:
        """The placements of this spec on a tensor of ``shape``, each dim
        that its mesh axes do not divide replicated (:func:`guarded_spec`;
        ``core.dtensor_ops.shard_as`` reads this)."""
        return NamedSharding(self.mesh, guarded_spec(
            shape, self.spec, self.mesh)).placements

    def local_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The shard of a tensor of ``shape`` each device holds."""
        sizes = axis_sizes(self.mesh)
        parts = tuple(self.spec) + (None,) * (len(shape) - len(self.spec))
        return tuple(d if p is None else
                     d // math.prod(sizes[n] for n in _names(p))
                     for d, p in zip(shape, parts))


def make_rules(mesh, shape: InputShape, *, expert_parallel: bool = False,
               cache_seq_axis: Optional[str] = "model") -> ShardingConfig:
    train = shape.kind == "train"
    return ShardingConfig(
        batch=batch_axes(mesh, shape.global_batch),
        heads="model",
        mlp="model",
        vocab="model",
        embed="data" if train and "data" in axis_sizes(mesh) else None,
        # KV caches are sequence-sharded: kv_heads rarely divide the
        # model axis, and the cache dominates decode/prefill memory
        cache_seq=cache_seq_axis if shape.kind in ("decode", "prefill")
        else None,
        experts="model" if expert_parallel else None,
        seq="model" if train else None,
    )


# ---------------------------------------------------------------------------
# Cache shardings
# ---------------------------------------------------------------------------

_CACHE_AXES = {
    # leaf name -> logical axes per dim
    "length": ("batch",),
    "kv_pos": ("batch", "cache_seq"),
    "k": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "v": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "cross_k": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "cross_v": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
    "enc_valid": ("batch", "cache_seq"),
    "ssd": ("layers", "batch", "heads", "head_dim", "state"),
    "conv": ("layers", "batch", "conv", "mlp"),
    "lru": ("layers", "batch", "mlp"),
}


def cache_shardings(cache: dict, mesh, rules: ShardingConfig) -> dict:
    """``{leaf name: NamedSharding}`` of a dense-ring cache (tensors or
    anything with a ``shape``), each mesh axis used at most once per
    leaf (e.g. MHA caches where kv_heads and cache_seq both map to
    'model': the sequence axis, first, keeps it)."""
    return {k: NamedSharding(mesh, guarded_spec(
        tuple(v.shape), logical_to_pspec(_CACHE_AXES[k], rules), mesh))
        for k, v in cache.items()}


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_sharding(mesh, rules: ShardingConfig, ndim: int) -> NamedSharding:
    spec = [tuple(rules.batch) if rules.batch else None] + [None] * (ndim - 1)
    return NamedSharding(mesh, canonical_spec(*spec))


def activation_sharding(mesh, rules: ShardingConfig
                        ) -> Optional[NamedSharding]:
    """[B, S, d] residual-stream constraint used in train mode."""
    if rules.seq is None:
        return None
    return NamedSharding(
        mesh, canonical_spec(tuple(rules.batch) if rules.batch else None,
                             rules.seq, None))


def attn_head_sharding(mesh, rules: ShardingConfig):
    """([B, T, H, D] NamedSharding, head-axis size) for the TP constraint
    pinned on q/k/v inside the attention sublayer."""
    if rules.heads is None:
        return None
    return (NamedSharding(
        mesh, canonical_spec(tuple(rules.batch) if rules.batch else None,
                             None, rules.heads, None)),
        axis_sizes(mesh)[rules.heads])


def moe_shardings(mesh, rules: ShardingConfig):
    """Dispatch-buffer constraints for moe_apply: capacity dim over the
    batch axes, token dim likewise (the dry run's; the serving engine's
    MoE layer runs on local shards, ``models.moe.moe_apply_mesh``)."""
    b = tuple(rules.batch) if rules.batch else None
    if b is None:
        return None
    return {"cap": NamedSharding(mesh, canonical_spec(None, b, None)),
            "tok": NamedSharding(mesh, canonical_spec(b, None))}


# ---------------------------------------------------------------------------
# Serving mesh (DESIGN.md §5): the ServingEngine's live data plane
# ---------------------------------------------------------------------------

def _axes_size(mesh, names) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[n] for n in _names(names))


def kv_head_axis(n_kv_heads: int, mesh, rules: ShardingConfig
                 ) -> Optional[str]:
    """Uneven-KV-head guard: GQA miniatures carry 1-2 (padded) KV heads,
    which rarely divide the model axis, so such caches REPLICATE their
    head dim (vLLM's KV-head replication) instead of sharding it."""
    if rules.heads is None or rules.heads not in axis_sizes(mesh):
        return None
    return (rules.heads if n_kv_heads % _axes_size(mesh, rules.heads) == 0
            else None)


def serve_cache_shardings(cache: dict, mesh, rules: ShardingConfig) -> dict:
    """``{leaf name: NamedSharding}`` of a *serving* cache (dense rows,
    paged pools, per-row prefill groups, or a drafter's token history),
    keyed by leaf name and WHOLE shape: the reference's layout, whose
    local shapes the engine's caches hold but for the KV-group cut
    (module docstring).  Layout contract (DESIGN.md §5):

    * KV buffers: head dim over *model* (uneven counts replicate); dense
      rows also split batch over *data*; paged POOLS keep the block axis
      whole — any sequence's table may address any block;
    * int8 pool scales follow their value pool's head split;
    * recurrent rows (ssd/lru/conv) and the n-gram token history: batch
      over *data*;
    * every int32 control leaf (length, kv_pos maps, block tables,
      enc_valid): replicated — the host rewrites those rows piecemeal
      each round and every shard needs the full table to address the
      shared pool."""
    paged = "block_table" in cache
    data = tuple(rules.batch) if rules.batch else None

    def bp(dim: int):
        if data is None or dim % _axes_size(mesh, data) != 0:
            return None
        return data

    def one(name: str, leaf) -> NamedSharding:
        s = tuple(leaf.shape)
        if name in ("k", "v", "cross_k", "cross_v"):
            kvp = kv_head_axis(s[3], mesh, rules)
            if paged:            # pool [L, n_blocks, bs, KV, D]
                return NamedSharding(mesh, canonical_spec(None, None, None,
                                                          kvp))
            return NamedSharding(mesh, canonical_spec(None, bp(s[1]), None,
                                                      kvp))
        if name in ("k_scale", "v_scale"):   # [L, n_blocks, bs, KV]
            kvp = kv_head_axis(s[3], mesh, rules)
            return NamedSharding(mesh, canonical_spec(None, None, None, kvp))
        if name in ("ssd", "lru", "conv"):   # [L, B, ...] per-slot rows
            return NamedSharding(mesh, canonical_spec(None, bp(s[1])))
        if name == "tokens":                 # n-gram history [B, H]
            return NamedSharding(mesh, canonical_spec(bp(s[0])))
        return NamedSharding(mesh, ())
    return {k: one(k, v) for k, v in cache.items()}


def round_state_shardings(state, mesh, rules: ShardingConfig):
    """A ``core.spec_decode.RoundState`` of NamedShardings: the caches
    through :func:`serve_cache_shardings`; every [B] control leaf
    (pending / sl_next / seed / round_idx / done / tokens_budget /
    eos_id), the base seed and the policy state replicated — they are
    tiny, the host rewrites them per admission, and replication keeps
    the bucket pick and the engine's per-slot updates identical on every
    rank."""
    rep = replicated(mesh)

    def rep_tree(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: rep_tree(v) for k, v in tree.items()}
        if hasattr(tree, "_fields"):
            return type(tree)(*(rep_tree(v) for v in tree))
        if isinstance(tree, (tuple, list)):
            return type(tree)(rep_tree(v) for v in tree)
        return rep

    def cache_sh(tree):
        if isinstance(tree, dict):
            return serve_cache_shardings(tree, mesh, rules)
        return rep_tree(tree)

    return state._replace(
        target_cache=cache_sh(state.target_cache),
        draft_cache=cache_sh(state.draft_cache),
        policy_state=rep_tree(state.policy_state), base_seed=rep,
        pending=rep, sl_next=rep, seed=rep, round_idx=rep, done=rep,
        tokens_budget=rep, eos_id=rep)


def sharded_empty(shape: Tuple[int, ...], dtype, sharding: NamedSharding,
                  device):
    """A DTensor of global ``shape`` laid out by ``sharding`` whose local
    shard is an uninitialised tensor (a fake one inside a
    ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    local = torch.empty(sharding.local_shape(tuple(shape)), dtype=dtype,
                        device=device)
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def leaf_spec(leaf: Spec, mesh, rules):
    """The spec of one ``models.weights.param_shapes`` leaf on ``mesh`` under
    ``rules``, with the reference's divisibility guard: a logical axis is
    sharded only where the dim divides the mesh axes' size and no
    earlier dim of the leaf took them; otherwise the dim is replicated
    (9 heads over 16 model shards)."""
    return guarded_spec(leaf.shape, logical_to_pspec(leaf.axes, rules), mesh)


def param_shardings(shapes, mesh, rules):
    """:class:`NamedSharding` (spec and DTensor placements) of every leaf
    of a ``models.weights.param_shapes`` tree (:func:`leaf_spec`)."""
    return map_params(lambda leaf: NamedSharding(
        mesh, leaf_spec(leaf, mesh, rules)), shapes)


def abstract_params(shapes, dtype=torch.bfloat16, shardings=None,
                    device="cpu") -> Params:
    """Stand-ins of a ``models.weights.param_shapes`` tree that hold no memory:
    fake tensors of ``dtype`` on ``device``, or with ``shardings`` (a
    tree of ``NamedSharding``) DTensors over fake local shards.  Call
    inside a ``FakeTensorMode`` (``launch.op_cost.OpCounter``)."""
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is None:
        raise RuntimeError("abstract_params needs an active FakeTensorMode")
    if shardings is None:
        return map_params(lambda leaf: torch.empty(
            leaf.shape, dtype=dtype, device=device), shapes)
    return map_params(lambda leaf, sh: sharded_empty(
        leaf.shape, dtype, sh, device), shapes, shardings)
