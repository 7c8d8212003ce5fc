"""Tensor and data parallelism of the serving engine on a ``(data,
model)`` mesh (the reference's DESIGN.md §5 ``serve`` rule set), on
plain local tensors.

The engine runs SPMD: every rank runs the same host loop (scheduler,
allocator, policy) over the same requests, and only the device data
differs.  Parameters and caches are plain tensors that hold this rank's
shard (:class:`MeshPlan`), so the kernels see local tensors as on one
card.  A few named collectives run where a sharded product ends:

* :func:`all_reduce_model` — the row-parallel sum after ``attn_output``,
  the MLP's or the MoE experts' down projection and the Mamba-2 mixer's
  ``out_proj`` (and its gated norm's sum of squares), where the query
  heads, the width or the SSD heads split over *model*;
* :func:`embed_lookup` — the vocab-parallel lookup: each rank's rows of
  the table, zero for the tokens outside its range, then summed;
* :func:`gather_vocab` / :func:`gather_rows` — logits whole over the
  vocabulary (*model*) and over the rows a data rank ran (*data*), so
  that sampling, rejection, the KLD signal and the policy run on the same
  values on every rank; an MoE layer's input rows before routing, and a
  hybrid pool's rows before a local-attention layer;
* :func:`host_clock` / :func:`broadcast_host` — rank 0's clock reading
  (or any host float), broadcast over the CPU control group, so every
  rank's admission, SLO gate and latency model decide alike;
  :func:`broadcast_objects` — rank 0's host objects (the front-end's
  admitted requests) over the same group.

Each is a no-op without a plan or over a group of one rank (a 1 x 1
mesh launches none).  :data:`COUNTS` counts the collectives launched.  The dry run's DTensor forms (``core/dtensor_ops.py``) are a
separate path: they count a step's work on stand-ins.

Also here, below ``launch/`` so that the engine can build its plan: the
spec helpers of ``launch/sharding.py`` (:func:`canonical_spec`,
:func:`guarded_spec`, :func:`axis_sizes`) and the ``serve`` rules
(:func:`serve_rules`).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.config import ModelConfig, ShardingConfig

# collectives launched since the last reset (the chip check reads them
# per round): the round's device collectives and the host broadcasts
COUNTS = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}


# ---------------------------------------------------------------------------
# specs (shared with launch/sharding.py)
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``launch.mesh.MeshShape`` or a
    ``DeviceMesh``."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def canonical_spec(*parts) -> Tuple:
    """THE spec constructor: trims trailing ``None`` dims so equal
    layouts are equal tuples (the reference's rule JX003)."""
    out = list(parts)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_names(part) -> Tuple[str, ...]:
    """The mesh axes one spec entry names."""
    return part if isinstance(part, tuple) else (part,)


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
        names = spec_names(part)
        if dim % math.prod(sizes[n] for n in names) or used & set(names):
            fixed.append(None)
            continue
        used.update(names)
        fixed.append(part)
    return canonical_spec(*fixed)


def batch_axes(mesh, global_batch: int) -> Tuple[str, ...]:
    """Largest prefix of (pod, data) whose product divides the batch."""
    sizes = axis_sizes(mesh)
    chosen, prod = [], 1
    for a in ("pod", "data"):
        if a in sizes and global_batch % (prod * sizes[a]) == 0:
            chosen.append(a)
            prod *= sizes[a]
    return tuple(chosen)


def serve_rules(mesh, global_batch: int) -> ShardingConfig:
    """The ``serve`` rule set: tensor-parallel params over *model*
    (replicated over data), batch slots over *data* (when the batch
    divides), KV heads over *model* under the uneven guard, and
    ``cache_seq`` unsharded — the paged pool's block axis must stay whole
    because block tables address ANY pool block."""
    return ShardingConfig(
        batch=batch_axes(mesh, global_batch),
        heads="model", mlp="model", vocab="model",
        embed=None, cache_seq=None, experts=None, seq=None)


# ---------------------------------------------------------------------------
# the plan: this rank's place on the mesh and its shards
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadLayout:
    """What one rank holds of a model config under the ``serve`` rules.

    ``heads``/``mlp``/``vocab``: whether the query heads (``wq``, ``wo``,
    ``bq``), the MLP width and the padded vocabulary split over *model*;
    where they split the product that contracts them ends in
    :func:`all_reduce_model` (heads, MLP) or :func:`gather_vocab`.
    ``vocab_lo``: the first table row this rank holds.

    KV heads split only where *model* divides them; otherwise they
    replicate, and a rank whose query heads split keeps the KV group its
    query heads read (``cache_kv``), so the kernels' local mapping, query
    head i to KV head i // (H_local / KV_local), holds.  ``real_kv``: the
    slice of the freshly projected real KV heads its attention reads
    (prefill, before ``kv_head_pad``); ``cache_kv``: the slice of the
    padded heads its cache stores; None where it keeps all it computed.
    ``cache_heads``: the KV heads of its cache.

    ``mlp`` reads the family's split width: the MLP's ``d_ff``, an MoE
    expert's ``expert_d_ff`` (experts replicate under the ``serve``
    rules, each expert's width splits).  ``ssd``: the Mamba-2 mixer's
    SSD heads this rank runs, where *model* divides them (None: the mixer
    replicates); its projections, conv, norm and ``out_proj`` split with
    them (``models/ssm.py``).  The RG-LRU block replicates: the serving
    mesh maps no ``lru`` axis (:meth:`MeshPlan.param_spec`)."""
    heads: bool
    mlp: bool
    vocab: bool
    vocab_lo: int
    real_kv: Optional[slice]
    cache_kv: Optional[slice]
    cache_heads: int
    ssd: Optional[slice] = None


def _nests(q_lo: int, hl: int, group: int, kv_lo: int, kvl: int) -> bool:
    """Whether local query head i reads KV head (q_lo + i) // group ==
    kv_lo + i // (hl / kvl) for every i (the kernels' mapping)."""
    if kvl == 0 or hl % kvl:
        return False
    g = hl // kvl
    return all((q_lo + i) // group - kv_lo == i // g for i in range(hl))


@functools.lru_cache(maxsize=None)
def head_layout(m: int, size: int, h: int, kv: int, pad: Optional[int],
                f: int, vp: int, ssd: int = 0) -> HeadLayout:
    """:class:`HeadLayout` of model rank ``m`` of ``size`` for ``h`` query
    heads over ``kv`` real KV heads (``pad``: ``kv_head_pad``), MLP (or
    expert) width ``f``, padded vocabulary ``vp`` and ``ssd`` SSD heads
    (0: no Mamba-2 mixer).  Raises ValueError where a rank's query heads
    would read KV heads the kernels cannot map."""
    e = pad or kv
    # an axis of one rank splits nothing: the layout is one card's
    heads, kv_split = (size > 1 and h % size == 0,
                       size > 1 and kv % size == 0)
    hl = h // size if heads else h
    q_lo = m * hl if heads else 0
    f_lo, f_hi = ((m * kv // size, (m + 1) * kv // size) if kv_split
                  else (0, kv))
    g_real = h // kv
    r_lo, r_hi = q_lo // g_real, (q_lo + hl - 1) // g_real + 1
    r = e // kv
    g_pad = h // e
    if e % size == 0:
        c_lo, c_hi = m * e // size, (m + 1) * e // size
    elif heads:
        c_lo, c_hi = q_lo // g_pad, (q_lo + hl - 1) // g_pad + 1
    else:
        c_lo, c_hi = 0, e
    if not (_nests(q_lo, hl, g_real, r_lo, r_hi - r_lo)
            and _nests(q_lo, hl, g_pad, c_lo, c_hi - c_lo)):
        raise ValueError(
            f"query heads {q_lo}..{q_lo + hl - 1} of {h} over {kv} KV heads "
            f"(stored as {e}) on a model axis of {size}: the rank's query "
            "heads do not read whole KV heads in the kernels' order")
    real = (None if (r_lo, r_hi) == (f_lo, f_hi)
            else slice(r_lo - f_lo, r_hi - f_lo))
    cache = (None if (c_lo, c_hi) == (r_lo * r, r_hi * r)
             else slice(c_lo - r_lo * r, c_hi - r_lo * r))
    vocab = size > 1 and vp % size == 0
    split_ssd = size > 1 and ssd > 0 and ssd % size == 0
    return HeadLayout(heads=heads, mlp=size > 1 and f % size == 0,
                      vocab=vocab,
                      vocab_lo=m * vp // size if vocab else 0,
                      real_kv=real, cache_kv=cache, cache_heads=c_hi - c_lo,
                      ssd=(slice(m * ssd // size, (m + 1) * ssd // size)
                           if split_ssd else None))


class MeshPlan:
    """This rank's place on a ``(data, model)`` serving mesh and its
    shards under the ``serve`` rules (:func:`serve_rules` for the
    engine's global batch).

    ``mesh``: a ``DeviceMesh`` over the initialised process group, whose
    ``model`` and ``data`` groups the collectives use (a
    ``launch.mesh.MeshShape`` builds a plan of rank 0 with no groups, for
    the rule tables alone).  ``control_group``: the CPU (gloo) group that
    carries host control data, None for the default group.

    Layouts (DESIGN.md §5): parameters split over *model* where the
    dims divide (:meth:`param_spec`, ``models.weights.serve_cut``); a
    block pool keeps its block axis whole, so block tables, ``kv_pos``,
    ``length``, the ``[B]`` control leaves and the policy state are whole
    on every rank; a dense ring, recurrent rows (a hybrid pool's too) and
    the n-gram history split their rows over *data* where the batch
    divides (:meth:`ring_rows`).  The rows of a forward run whole on the
    pool, with activations replicated over *data* (but through a hybrid
    pool's RG-LRU layers); on a split ring each data rank runs its own
    rows and :func:`gather_rows` joins the logits."""

    def __init__(self, mesh, rules: ShardingConfig, control_group=None):
        self.mesh = mesh
        self.rules = rules
        sizes = axis_sizes(mesh)
        self.model_size = sizes.get("model", 1)
        self.data_size = sizes.get("data", 1)
        self.control_group = control_group
        if hasattr(mesh, "get_group"):
            self.model_group = mesh.get_group("model")
            self.data_group = mesh.get_group("data")
            self.model_rank = mesh.get_local_rank("model")
            self.data_rank = mesh.get_local_rank("data")
        else:
            self.model_group = self.data_group = None
            self.model_rank = self.data_rank = 0

    @classmethod
    def for_mesh(cls, mesh, global_batch: int):
        """The plan of ``mesh`` (a ``DeviceMesh``) under :func:`serve_rules`
        for a ``global_batch``-slot engine, with the process group's CPU
        control group (:func:`control_group`)."""
        return cls(mesh, serve_rules(mesh, global_batch), control_group())

    @property
    def shape(self) -> str:
        return f"{self.data_size}x{self.model_size}"

    def layout(self, cfg: ModelConfig) -> HeadLayout:
        """:func:`head_layout` of ``cfg`` on this rank, with each family's
        split width: the MLP's, an MoE expert's, the SSD heads."""
        from repro_torch.models.weights import VOCAB_PAD_MULTIPLE
        f = cfg.moe.expert_d_ff if cfg.family == "moe" else cfg.d_ff
        ssd = (cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
               if cfg.family == "ssm" else 0)
        return head_layout(self.model_rank, self.model_size,
                           cfg.q_head_pad or cfg.num_heads, cfg.num_kv_heads,
                           cfg.kv_head_pad, f,
                           cfg.padded_vocab(VOCAB_PAD_MULTIPLE), ssd)

    def _coord(self, part) -> Tuple[int, int]:
        """(index, count) of this rank's shard along the mesh axes of one
        spec entry (the first axis outermost)."""
        idx, count = 0, 1
        for name in spec_names(part):
            size = {"model": self.model_size, "data": self.data_size}[name]
            rank = {"model": self.model_rank, "data": self.data_rank}[name]
            idx, count = idx * size + rank, count * size
        return idx, count

    def param_spec(self, shape: Tuple[int, ...], axes) -> Tuple:
        """The guarded spec of a parameter of ``shape`` with logical
        ``axes`` under this plan's rules (``launch.sharding.leaf_spec``),
        but with no ``lru`` axis: the RG-LRU block replicates, so its
        state stays whole over *model* as the ``serve`` cache table keeps
        it (the reference's table maps ``lru`` to *model*; ROADMAP C)."""
        from repro_torch.models.weights import logical_to_pspec
        axes = tuple(None if a == "lru" else a for a in axes)
        return guarded_spec(shape, logical_to_pspec(axes, self.rules),
                            self.mesh)

    def xbc_columns(self, cfg: ModelConfig) -> Optional[torch.Tensor]:
        """The columns of a Mamba-2 mixer's joint x | B | C axis (``wxbc``,
        ``conv_w``, ``conv_b``) that this rank keeps: its SSD heads' x
        columns and all of B and C (a contiguous cut would split across
        their boundaries); None where the mixer replicates."""
        ssd = self.layout(cfg).ssd
        if ssd is None:
            return None
        di = cfg.ssm.expand * cfg.d_model
        p = cfg.ssm.head_dim
        return torch.cat([torch.arange(ssd.start * p, ssd.stop * p),
                          torch.arange(di, di + 2 * cfg.ssm.state_size)])

    def local_slice(self, x: torch.Tensor, spec: Tuple,
                    cols: Optional[torch.Tensor] = None) -> torch.Tensor:
        """This rank's shard of the whole tensor ``x`` under ``spec`` (or,
        with ``cols``, its last dim's columns ``cols``), a tensor of its
        own (``x`` can be freed)."""
        if cols is not None:
            return x.index_select(-1, cols.to(x.device))
        whole = x
        for dim, part in enumerate(spec):
            if part is None:
                continue
            idx, count = self._coord(part)
            n = x.shape[dim] // count
            x = x.narrow(dim, idx * n, n)
        return x if x is whole else x.clone()

    def local_shape(self, shape: Tuple[int, ...], spec: Tuple
                    ) -> Tuple[int, ...]:
        parts = tuple(spec) + (None,) * (len(shape) - len(spec))
        return tuple(d if p is None else d // self._coord(p)[1]
                     for d, p in zip(shape, parts))

    def ring_rows(self, batch: int) -> Optional[Tuple[int, int]]:
        """This data rank's rows [lo, hi) of a ``batch``-row dense ring or
        token history, or None where its rows stay whole (no *data*
        split in the rules, or the batch does not divide)."""
        if "data" not in self.rules.batch or batch % self.data_size:
            return None
        n = batch // self.data_size
        return self.data_rank * n, (self.data_rank + 1) * n

    def own_rows(self, slots: Sequence[int], batch: int
                 ) -> Optional[Tuple[List[int], List[int]]]:
        """(group rows, local rows) of the admission group landing in
        ``slots`` that this data rank holds of a split ``batch``-row ring
        or history; None where the rows stay whole (host lists: the
        engine knows the slots, so a scatter needs no device read)."""
        rows = self.ring_rows(batch)
        if rows is None:
            return None
        lo, hi = rows
        own = [(i, s - lo) for i, s in enumerate(slots) if lo <= s < hi]
        return [i for i, _ in own], [s for _, s in own]


def split_rows(cache: dict, plan: Optional[MeshPlan],
               key: Optional[str] = None, axis: int = 1
               ) -> Optional[Tuple[int, int]]:
    """The rows [lo, hi) of a data-split ring, recurrent state or history
    that this rank holds, read off the cache: ``cache[key]`` holds fewer
    rows (along ``axis``) than the whole ``length``; None where they are
    whole.  ``key`` None: a ring's first per-row leaf (``k``, else the
    recurrent ``ssd`` or ``lru``), a pool's recurrent rows (its ``k`` is
    the block pool)."""
    if plan is None:
        return None
    if key is None:
        keys = ("lru",) if "block_table" in cache else ("k", "ssd", "lru")
        key = next((k for k in keys if k in cache), None)
    if key not in cache:
        return None
    n = cache[key].shape[axis]
    if n == cache["length"].shape[0]:
        return None
    lo = plan.data_rank * n
    return lo, lo + n


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce_model(x: torch.Tensor, plan: Optional[MeshPlan]
                     ) -> torch.Tensor:
    """The sum of ``x`` over the *model* group, in place (a row-parallel
    product's partial sums)."""
    if plan is None or plan.model_group is None or plan.model_size == 1:
        return x
    x = x.contiguous()
    COUNTS["all_reduce"] += 1
    dist.all_reduce(x, group=plan.model_group)
    return x


def _all_gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    COUNTS["all_gather"] += 1
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def gather_vocab(logits: torch.Tensor, plan: Optional[MeshPlan]
                 ) -> torch.Tensor:
    """``[..., V_local]`` logits whole over the vocabulary (*model*)."""
    if plan is None or plan.model_group is None or plan.model_size == 1:
        return logits
    return _all_gather(logits, plan.model_group, plan.model_size, -1)


def gather_rows(x: torch.Tensor, plan: Optional[MeshPlan]) -> torch.Tensor:
    """A data rank's rows ``[B_local, ...]`` joined over *data* into
    ``[B, ...]``."""
    if plan is None or plan.data_group is None or plan.data_size == 1:
        return x
    return _all_gather(x, plan.data_group, plan.data_size, 0)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, lo: int,
                 plan: Optional[MeshPlan]) -> torch.Tensor:
    """Rows of a vocab-split table whose rank holds rows [lo, lo + n):
    each rank gathers the tokens in its range, zero elsewhere, and the
    sum over *model* has exactly one nonzero term per token."""
    n = table.shape[0]
    t = tokens.long() - lo
    ok = (t >= 0) & (t < n)
    x = torch.where(ok[..., None], table[t.clamp(0, n - 1)], 0.0)
    return all_reduce_model(x, plan)


def spans_ranks(plan: Optional[MeshPlan]) -> bool:
    """Whether ``plan`` places this process on a mesh of more than one
    rank of a process group (the host collectives below run only then)."""
    return (plan is not None and plan.model_group is not None
            and plan.model_size * plan.data_size > 1)


def broadcast_host(value: float, plan: Optional[MeshPlan]) -> float:
    """Rank 0's ``value`` on every rank, over the CPU control group (a
    host tensor: no device stream is touched)."""
    if not spans_ranks(plan):
        return value
    t = torch.tensor([value], dtype=torch.float64)
    COUNTS["broadcast"] += 1
    dist.broadcast(t, src=0, group=plan.control_group)
    return float(t[0])


def broadcast_objects(objs: list, plan: Optional[MeshPlan]) -> list:
    """Rank 0's list of picklable host objects on every rank, in place,
    over the CPU control group (``objs``: rank 0's list; every other rank
    passes a list of the same length, whose entries are replaced).  The
    front-end's admitted requests and stop flag travel so.  A rank that
    never gets rank 0's list fails on the group's timeout."""
    if not spans_ranks(plan):
        return objs
    COUNTS["broadcast"] += 1
    dist.broadcast_object_list(objs, src=0, group=plan.control_group)
    return objs


def host_clock(plan: Optional[MeshPlan]) -> float:
    """``time.monotonic()``, on a mesh rank 0's reading."""
    return broadcast_host(time.monotonic(), plan)


_CONTROL: list = []


def control_group():
    """The CPU control group of the current process group: None (the
    default group) when that is gloo, else a gloo group over every rank,
    made once per process group (a collective call: every rank makes it
    in the same order)."""
    if dist.get_backend() == "gloo":
        return None
    world = dist.group.WORLD
    if not _CONTROL or _CONTROL[0] is not world:
        _CONTROL[:] = [world, dist.new_group(backend="gloo")]
    return _CONTROL[1]


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
