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

The serve rule set of the reference (``serve_rules``, ``kv_head_axis``,
``serve_cache_shardings``, ``round_state_shardings``, ``ServeMeshPlan``)
belongs to the engine's mesh path, ROADMAP A10, and is not here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.config import InputShape, ShardingConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.weights import (Params, Spec, logical_to_pspec,
                                        map_params)


def canonical_spec(*parts) -> Tuple:
    """THE spec constructor: trims trailing ``None`` dims so equal
    layouts are equal tuples (the reference's rule JX003)."""
    out = list(parts)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _names(part) -> Tuple[str, ...]:
    return part if isinstance(part, tuple) else (part,)


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


def guarded_spec(shape: Tuple[int, ...], pspec: Tuple, mesh) -> Tuple:
    """``pspec`` with each dim that its mesh axes do not divide, or that
    reuses a mesh axis an earlier dim took, replicated (the reference's
    divisibility guard: 9 heads over 16 model shards replicate)."""
    sizes = axis_sizes(mesh)
    parts = tuple(pspec) + (None,) * (len(shape) - len(pspec))
    fixed, used = [], set()
    for dim, part in zip(shape, parts):
        if part is None:
            fixed.append(None)
            continue
        names = _names(part)
        if dim % math.prod(sizes[n] for n in names) or used & set(names):
            fixed.append(None)
            continue
        used.update(names)
        fixed.append(part)
    return canonical_spec(*fixed)


def _batch_axes(mesh, global_batch: int) -> Tuple[str, ...]:
    """Largest prefix of (pod, data) whose product divides the batch."""
    sizes = axis_sizes(mesh)
    chosen, prod = [], 1
    for a in ("pod", "data"):
        if a in sizes and global_batch % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    return tuple(chosen)


def make_rules(mesh, shape: InputShape, *, expert_parallel: bool = False,
               cache_seq_axis: Optional[str] = "model") -> ShardingConfig:
    train = shape.kind == "train"
    return ShardingConfig(
        batch=_batch_axes(mesh, shape.global_batch),
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
    batch axes, token dim likewise."""
    b = tuple(rules.batch) if rules.batch else None
    if b is None:
        return None
    return {"cap": NamedSharding(mesh, canonical_spec(None, b, None)),
            "tok": NamedSharding(mesh, canonical_spec(b, None))}


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
